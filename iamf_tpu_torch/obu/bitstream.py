"""Bitstream reader for IA-OBU parsing (host side).

Mirrors the semantics of the reference reader (bitstream.c):
  - `bits(n)`: MSB-first bit extraction (bs_get32b, bitstream.c:66-94)
  - aligned u8/u16/u32 big-endian reads (bs_getA8b/16b/32b, bitstream.c:113-133)
  - `leb128()`: byte-aligned LEB128, at most 8 bytes (bs_getAleb128, :137-160)
  - `tell()` counts a partially consumed byte as consumed (bs_tell, :181)
  - `read_string()` NUL-terminated with 128-byte clamp (bs_readString, :170-180)

This is host-side descriptor parsing only (<1% of runtime); audio frame
payloads are passed through as buffers to the codec layer.
"""

from __future__ import annotations

STRING_SIZE = 128


class BitReader:
    __slots__ = ("data", "size", "byte_pos", "bit_pos")

    def __init__(self, data: bytes | bytearray | memoryview):
        self.data = bytes(data)
        self.size = len(self.data)
        self.byte_pos = 0
        self.bit_pos = 0  # 0..7 within current byte, MSB first

    # -- bit-level --------------------------------------------------------

    def bits(self, n: int) -> int:
        """Read n bits MSB-first (n <= 64)."""
        ret = 0
        remaining = n
        while remaining > 0:
            if self.byte_pos >= self.size:
                # Past-the-end reads yield zero bits, like the reference's
                # zero-padded bs_getLastA32b.
                ret <<= remaining
                self.bit_pos += remaining
                self.byte_pos += self.bit_pos // 8
                self.bit_pos %= 8
                return ret
            cur = self.data[self.byte_pos]
            avail = 8 - self.bit_pos
            take = min(avail, remaining)
            shift = avail - take
            ret = (ret << take) | ((cur >> shift) & ((1 << take) - 1))
            self.bit_pos += take
            if self.bit_pos == 8:
                self.bit_pos = 0
                self.byte_pos += 1
            remaining -= take
        return ret

    def skip_bits(self, n: int) -> None:
        self.bit_pos += n
        self.byte_pos += self.bit_pos // 8
        self.bit_pos %= 8

    def align(self) -> None:
        if self.bit_pos:
            self.bit_pos = 0
            self.byte_pos += 1

    # -- aligned byte-level ----------------------------------------------

    def u8(self) -> int:
        self.align()
        v = self.data[self.byte_pos]
        self.byte_pos += 1
        return v

    def u16(self) -> int:
        return (self.u8() << 8) | self.u8()

    def s16(self) -> int:
        v = self.u16()
        return v - 0x10000 if v & 0x8000 else v

    def u32(self) -> int:
        return (self.u16() << 16) | self.u16()

    def leb128(self) -> int:
        """Byte-aligned LEB128, little-endian 7-bit groups, max 8 bytes."""
        self.align()
        if self.byte_pos >= self.size:
            return 0
        ret = 0
        i = 0
        while i < 8:
            if self.byte_pos + i >= self.size:
                break
            byte = self.data[self.byte_pos + i]
            ret |= (byte & 0x7F) << (i * 7)
            if not byte & 0x80:
                break
            i += 1
        self.byte_pos += i + 1
        return ret

    def read_bytes(self, n: int) -> bytes:
        self.align()
        v = self.data[self.byte_pos : self.byte_pos + n]
        self.byte_pos += n
        return v

    def skip_bytes(self, n: int) -> None:
        self.align()
        self.byte_pos += n

    def read_string(self, max_len: int = STRING_SIZE) -> str:
        """NUL-terminated string; advances past the NUL, clamps the copy."""
        self.align()
        end = self.data.find(b"\x00", self.byte_pos)
        if end < 0:
            end = self.size
        raw = self.data[self.byte_pos : end]
        self.byte_pos = end + 1
        if len(raw) >= max_len:
            raw = raw[: max_len - 1]
        return raw.decode("utf-8", errors="replace")

    def tell(self) -> int:
        """Bytes consumed; a partially consumed byte counts as consumed."""
        return self.byte_pos + 1 if self.bit_pos else self.byte_pos

    def remaining(self) -> int:
        return self.size - self.tell()


def write_leb128(value: int) -> bytes:
    """Encode an unsigned integer as LEB128 (for the stream builder/tests)."""
    out = bytearray()
    while True:
        byte = value & 0x7F
        value >>= 7
        if value:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


# Scalar PCM sample readers (reference bitstream.c:185-239). Note: the
# reference's reads24be swaps the top two bytes (bitstream.c:210-214 uses
# readu16le); we implement the *correct* big-endian read here and the PCM
# codec exposes a compat switch if bug-for-bug parity is ever needed.

def reads16le(data: bytes, off: int) -> int:
    v = data[off] | (data[off + 1] << 8)
    return v - 0x10000 if v & 0x8000 else v


def reads16be(data: bytes, off: int) -> int:
    v = (data[off] << 8) | data[off + 1]
    return v - 0x10000 if v & 0x8000 else v


def reads24le(data: bytes, off: int) -> int:
    v = data[off] | (data[off + 1] << 8) | (data[off + 2] << 16)
    return v - 0x1000000 if v & 0x800000 else v


def reads24be(data: bytes, off: int) -> int:
    v = (data[off] << 16) | (data[off + 1] << 8) | data[off + 2]
    return v - 0x1000000 if v & 0x800000 else v


def reads32le(data: bytes, off: int) -> int:
    v = data[off] | (data[off + 1] << 8) | (data[off + 2] << 16) | (data[off + 3] << 24)
    return v - 0x100000000 if v & 0x80000000 else v


def reads32be(data: bytes, off: int) -> int:
    v = (data[off] << 24) | (data[off + 1] << 16) | (data[off + 2] << 8) | data[off + 3]
    return v - 0x100000000 if v & 0x80000000 else v
