"""Taps of the native CELT decoder on an Opus IAMF stream: the inputs and
the expected outputs of the device entropy stages (K11-K13).

The shared native library (native/lib/libiamf_native.so) records, while it
decodes a CELT packet,
  - every PVQ leaf it decodes (the leaf tap, level 2): (n, k, index, gain,
    spread, blocks) and the first 32 coefficients of the leaf vector after
    normalization and rotation;
  - the band walk as op records of 16 u32 fields (the band emit), which
    band_pack.pack_frame flattens;
  - the band tap: the frame's normalized spectrum X [C, 8 * 100] (at
    LM = 3) and its collapse masks, before anti-collapse.

``CBandTap``, ``_lib`` and ``_leaf_read`` are copies of the helpers of the
same names in the JAX package's tests (tests/test_band_replay.py), and
``substream_packets`` is its per-substream packet walk, on this package's
OBU parser. ``tap_stream`` decodes each substream's packets one by one
with its own native decoder and returns one ``TappedFrame`` a CELT frame.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import os

import numpy as np

from ..obu import parser

LIB = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native", "lib", "libiamf_native.so")
LEAF_X = 32      # coefficients a leaf the tap keeps (LeafTap::XW)
LEAF_CAP = 1 << 16
EMIT_CAP = 1 << 16


class CBandTap(ctypes.Structure):
    _fields_ = [
        ("valid", ctypes.c_int),
        ("start", ctypes.c_int), ("end", ctypes.c_int),
        ("shortBlocks", ctypes.c_int), ("spread", ctypes.c_int),
        ("dual_stereo", ctypes.c_int), ("intensity", ctypes.c_int),
        ("LM", ctypes.c_int), ("codedBands", ctypes.c_int),
        ("total_bits", ctypes.c_int), ("balance", ctypes.c_int),
        ("C", ctypes.c_int), ("len", ctypes.c_int),
        ("pulses", ctypes.c_int * 21), ("tf_res", ctypes.c_int * 21),
        ("ec_offs", ctypes.c_uint), ("ec_rng", ctypes.c_uint),
        ("ec_val", ctypes.c_uint), ("ec_ext", ctypes.c_uint),
        ("ec_end_offs", ctypes.c_uint), ("ec_end_window", ctypes.c_uint),
        ("ec_nend_bits", ctypes.c_int), ("ec_nbits_total", ctypes.c_int),
        ("ec_rem", ctypes.c_int),
        ("buf", ctypes.c_ubyte * 4000),
        ("X", ctypes.c_float * (2 * 800)),
        ("collapse", ctypes.c_ubyte * 42),
        ("seed_in", ctypes.c_uint), ("seed_out", ctypes.c_uint),
        ("oldBandE", ctypes.c_float * 42),
        ("oldLogE", ctypes.c_float * 42),
        ("oldLogE2", ctypes.c_float * 42),
        ("anti_collapse_on", ctypes.c_int),
        ("X_post_ac", ctypes.c_float * (2 * 800)),
        ("rng_at_ac", ctypes.c_uint),
        ("freq_tap", ctypes.c_float * 960),
        ("out_syn_tap", ctypes.c_float * 1080),
        ("decode_mem_tap", (ctypes.c_float * 2168) * 2),
        ("preemph_tap", ctypes.c_float * 2),
    ]


def _lib():
    lib = ctypes.CDLL(LIB)
    lib.iamf_opus_decoder_create.restype = ctypes.c_void_p
    lib.iamf_opus_decoder_create.argtypes = [ctypes.c_int]
    lib.iamf_opus_decoder_destroy.argtypes = [ctypes.c_void_p]
    lib.iamf_opus_decode_float.restype = ctypes.c_int
    lib.iamf_opus_decode_float.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int]
    lib.iamf_band_tap_ptr.restype = ctypes.POINTER(CBandTap)
    lib.iamf_band_emit_read.restype = ctypes.c_longlong
    lib.iamf_band_emit_read.argtypes = [
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_longlong, ctypes.c_int]
    lib.iamf_band_emit_enable.argtypes = [ctypes.c_int]
    lib.iamf_leaf_tap_read2.restype = ctypes.c_longlong
    lib.iamf_leaf_tap_set.argtypes = [ctypes.c_int]
    return lib


def _leaf_read(lib, cap: int = LEAF_CAP):
    """The leaves tapped since the last read, and a reset of the tap:
    (n, k, idx, gain, spread, blocks, x [count, 32]); cap = 0 only
    resets."""
    n = np.zeros(cap, np.int32)
    k = np.zeros(cap, np.int32)
    idx = np.zeros(cap, np.uint32)
    gain = np.zeros(cap, np.float32)
    spread = np.zeros(cap, np.int32)
    blocks = np.zeros(cap, np.int32)
    x = np.zeros((cap, LEAF_X), np.float32)
    ip = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))
    fp = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    up = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))
    c = int(lib.iamf_leaf_tap_read2(ip(n), ip(k), up(idx), fp(gain),
                                    ip(spread), ip(blocks), fp(x),
                                    ctypes.c_longlong(cap), 1))
    return n[:c], k[:c], idx[:c], gain[:c], spread[:c], blocks[:c], x[:c]


def substream_packets(data: bytes):
    """{substream id: [packet, ...]} in stream order, and [(substream id,
    channels), ...] of the first audio element (coupled substreams first,
    two channels each)."""
    body = data[parser.find_sequence_header(data):]
    recs = parser.split_records(body)
    frames: dict[int, list] = {}
    el = None
    for i in range(len(recs)):
        if recs[i, 7] >= 0:
            frames.setdefault(int(recs[i, 7]), []).append(
                bytes(body[recs[i, 3]:recs[i, 3] + recs[i, 4]]))
        elif recs[i, 0] == 1 and el is None:
            el = parser.parse_audio_element(parser.split_obu(
                body, int(recs[i, 2])))
    coupled = el.channels_config.layers[0].nb_coupled_substreams
    subs = [(sid, 2 if si < coupled else 1)
            for si, sid in enumerate(el.substream_ids)]
    return frames, subs


@dataclasses.dataclass
class TappedFrame:
    """One CELT frame as the native decoder saw it."""
    substream: int
    channels: int        # the decoder's (the frame's C is tap_C)
    recs: np.ndarray     # [count, 16] u32 band-emit records
    leaves: tuple        # (n, k, idx, gain, spread, blocks, x [L, 32])
    X: np.ndarray        # [tap_C, M * 100] f32, the band tap's spectrum
    collapse: np.ndarray  # [tap_C, 21] u8, the tap's collapse masks (the
    #                       bands the frame codes; the others are stale)
    seed_out: int        # the emitted end-of-frame seed (record op 8)
    LM: int
    transient: bool
    tap_C: int


def tap_stream(data: bytes) -> list[TappedFrame]:
    """Decode every substream of an Opus IAMF stream packet by packet
    through the native library with the leaf tap, the band emit and the
    band tap on; one TappedFrame a CELT frame that emitted band records.
    The taps are switched off again on return."""
    frames, subs = substream_packets(data)
    old = os.environ.get("IAMF_BAND_TAP")
    os.environ["IAMF_BAND_TAP"] = "1"  # read by the decoder at every frame
    lib = _lib()
    lib.iamf_leaf_tap_set(2)
    out = []
    try:
        tapp = lib.iamf_band_tap_ptr()
        lib.iamf_band_emit_enable(1)
        pcm = np.zeros(2 * 2880, np.float32)
        emit = np.zeros((EMIT_CAP, 16), np.uint32)
        ep = emit.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))
        for sid, ch in subs:
            dec = lib.iamf_opus_decoder_create(ch)
            try:
                for pkt in frames.get(sid, []):
                    lib.iamf_band_emit_read(ep, ctypes.c_longlong(EMIT_CAP), 1)
                    _leaf_read(lib, 0)
                    r = lib.iamf_opus_decode_float(
                        dec, pkt, len(pkt),
                        pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                        2880)
                    if r <= 0:
                        raise RuntimeError(f"native Opus decode failed: {r}")
                    cnt = int(lib.iamf_band_emit_read(
                        ep, ctypes.c_longlong(EMIT_CAP), 1))
                    if cnt == 0:
                        continue
                    leaves = _leaf_read(lib)
                    tap = tapp.contents
                    nb = int((1 << tap.LM) * 100)
                    end = emit[cnt - 1]
                    if end[0] != 8:
                        raise RuntimeError("band emit: no end record")
                    out.append(TappedFrame(
                        substream=sid, channels=ch, recs=emit[:cnt].copy(),
                        leaves=leaves,
                        X=np.ctypeslib.as_array(tap.X)[:tap.C * nb].reshape(
                            tap.C, nb).copy(),
                        collapse=np.ctypeslib.as_array(tap.collapse)[
                            :21 * tap.C].reshape(21, tap.C).T.copy(),
                        seed_out=int(end[1]), LM=int(tap.LM),
                        transient=bool(tap.shortBlocks), tap_C=int(tap.C)))
            finally:
                lib.iamf_opus_decoder_destroy(dec)
    finally:
        lib.iamf_band_emit_enable(0)
        lib.iamf_leaf_tap_set(0)
        if old is None:
            os.environ.pop("IAMF_BAND_TAP", None)
        else:
            os.environ["IAMF_BAND_TAP"] = old
    return out


def all_leaves(frames: list[TappedFrame]) -> tuple:
    """Every frame's leaves joined in decode order: (n, k, idx, gain,
    spread, blocks, x [L, 32])."""
    return tuple(np.concatenate([f.leaves[j] for f in frames])
                 for j in range(7))


@functools.lru_cache(maxsize=None)
def _u_table() -> np.ndarray:
    from ..codecs.opus import device_cwrsi

    return device_cwrsi.u_table().astype(np.uint64)


def v_count(n: int, k: int) -> int:
    """V(n, k) = U(n, k) + U(n, k + 1), from device_cwrsi's u32 table, at
    most 2^32: the number of indices of a leaf of n dimensions and k
    pulses."""
    t = _u_table()
    v = int(t[max(n, k), min(n, k)]) + int(t[max(n, k + 1), min(n, k + 1)])
    return min(v, 1 << 32)


def random_leaves(rng: np.random.Generator, count: int) -> tuple:
    """(n, k, idx) of `count` synthetic leaves for K11: n from the 48 kHz
    band-size census, k in [1, 128], the index uniform in [0, V(n, k))."""
    ns = rng.choice([2, 3, 4, 6, 8, 12, 16, 18, 22, 24, 32, 44, 48, 64,
                     88, 96], size=count)
    ks = rng.integers(1, 129, size=count)
    idx = np.empty(count, np.uint32)
    for j in range(count):
        idx[j] = rng.integers(0, max(v_count(int(ns[j]), int(ks[j])), 1))
    return ns.astype(np.int32), ks.astype(np.int32), idx


def edge_leaves() -> tuple:
    """(n, k, idx) of K11's edges: n in (2, 3, 4, 96), k in (1, 2, 127,
    128), index 0, 1, V - 1 and V / 2."""
    cases = []
    for n in (2, 3, 4, 96):
        for k in (1, 2, 127, 128):
            v = v_count(n, k)
            cases += [(n, k, i) for i in (0, 1, v - 1, v // 2) if 0 <= i < v]
    c = np.array(cases, np.int64)
    return c[:, 0].astype(np.int32), c[:, 1].astype(np.int32), \
        c[:, 2].astype(np.uint32)
