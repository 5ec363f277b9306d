"""Opus host decoder and the entropy export for the device CELT synthesis.

The host half of iamf_tpu/codecs/opus/decoder.py, copied: the ctypes
wrapper over the native CELT decoder (``OpusDecoder``, registered for
codecs/base.open_decoder), its ``SpectrumMeta`` mirror and the postfilter
tap gains. The reference's ``OpusDecoder.decode_spectrum_batch`` imports
the JAX synthesis module for three layout constants; here it is the
module function ``decode_spectrum_batch``, which takes them from
codecs/opus/synth.py; its arguments and native calls are the same. Both
read the reference's threading switches: IAMF_OPUS_SERIAL set runs the
substreams one after the other, IAMF_OPUS_THREADS=n > 0 sizes the codec's
substream pool. Unlike the reference's, the serial ``OpusDecoder.decode``
also runs a unit's substreams on that pool, where the unit is CELT-only:
hybrid, SILK and lost packets stay on the calling thread, whose history a
native hybrid decode reads (ROADMAP.md §1); the output is the same either
way. ``DeviceOpusStream`` is the reference's ``TPUOpusStream``:
the entropy export feeding the device synthesis (codecs/opus/synth.py, K1
and K2) one call per block of temporal units.

IAMF opus decoder_conf (big-endian, IAMF spec §"Opus Specific"):
  version(u8) channels(u8) pre_skip(u16) input_sample_rate(u32)
  output_gain(s16) mapping_family(u8)
"""

from __future__ import annotations

import concurrent.futures as cf
import ctypes
import os
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np
import torch

from ...constants import Codec
from ...device import resolve_device
from ...utils import trace
from ..base import CodecDecoder, register
from .synth import (MINPERIOD, N_PARAMS, celt_synth, init_carry,
                    pack_params, packed_width, synthesize_packed)

_TABLES = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "data", "opus_tables.npz")
_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))),
    "native",
)
_LIB_PATH = os.path.join(_NATIVE_DIR, "lib", "libiamf_native.so")

_lib = None


def _load_native():
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        try:
            subprocess.run(
                ["make", "-C", _NATIVE_DIR], check=True, capture_output=True
            )
        except (subprocess.CalledProcessError, FileNotFoundError) as e:
            raise NotImplementedError(f"native opus lib unavailable: {e}")
    _lib = ctypes.CDLL(_LIB_PATH)
    _lib.iamf_opus_decoder_create.restype = ctypes.c_void_p
    _lib.iamf_opus_decoder_create.argtypes = [ctypes.c_int]
    _lib.iamf_opus_decoder_destroy.argtypes = [ctypes.c_void_p]
    _lib.iamf_opus_decode_float.restype = ctypes.c_int
    _lib.iamf_opus_decode_float.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,
    ]
    _lib.iamf_opus_decode_spectrum_batch2.restype = ctypes.c_int
    _lib.iamf_opus_decode_spectrum_batch2.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(SpectrumMeta),
    ]
    _lib.iamf_opus_decode_spectrum_batch3.restype = ctypes.c_int
    _lib.iamf_opus_decode_spectrum_batch3.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
        ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.POINTER(SpectrumMeta),
    ]
    _lib.iamf_opus_decode_float_batch.restype = ctypes.c_int
    _lib.iamf_opus_decode_float_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
        ctypes.c_int, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
    ]
    return _lib


class SpectrumMeta(ctypes.Structure):
    """Mirror of SpectrumMeta in native/src/opus/opus_dec.cc."""

    _fields_ = [
        ("samples", ctypes.c_int),
        ("transient", ctypes.c_int),
        ("pf_period_old", ctypes.c_int),
        ("pf_gain_old", ctypes.c_float),
        ("pf_tapset_old", ctypes.c_int),
        ("pf_period", ctypes.c_int),
        ("pf_gain", ctypes.c_float),
        ("pf_tapset", ctypes.c_int),
        ("pf_period_new", ctypes.c_int),
        ("pf_gain_new", ctypes.c_float),
        ("pf_tapset_new", ctypes.c_int),
    ]


# column index of each meta field in the [B, 11] int32/float32 view —
# derived from the struct so a field addition/reorder breaks loudly
# instead of silently mis-mapping gains/periods
_META_COL = {name: i for i, (name, _t) in enumerate(SpectrumMeta._fields_)}
assert ctypes.sizeof(SpectrumMeta) == 4 * len(SpectrumMeta._fields_)


@register(Codec.OPUS)
class OpusDecoder(CodecDecoder):
    def __init__(self, decoder_conf, streams, coupled_streams, frame_size):
        super().__init__(decoder_conf, streams, coupled_streams, frame_size)
        self.version = decoder_conf[0]
        self.pre_skip = int.from_bytes(decoder_conf[2:4], "big")
        self.sample_rate = int.from_bytes(decoder_conf[4:8], "big") or 48000
        lib = _load_native()
        self._decoders = []
        for i in range(streams):
            ch = 2 if i < coupled_streams else 1
            self._decoders.append((lib.iamf_opus_decoder_create(ch), ch))
        self.delay = 0  # reference reports no codec delay for opus
        self._max = frame_size * 6
        self._pool = None  # lazy per-instance substream thread pool
        # decode() has met a unit that is not CELT-only: every later unit
        # stays on the calling thread
        self._on_caller = False

    def __del__(self):
        try:
            if getattr(self, "_pool", None) is not None:
                self._pool.shutdown(wait=False)
            lib = _load_native()
            for ptr, _ in getattr(self, "_decoders", []):
                lib.iamf_opus_decoder_destroy(ptr)
        except Exception:
            pass

    def decode(self, packets: Sequence[Optional[bytes]]) -> np.ndarray:
        """One temporal unit's packets, one a substream (None: lost) ->
        planar float32 [channels, samples].

        A unit whose packets are all present and CELT-only goes to the
        substream pool: the calling thread decodes substream 0 while the
        pool decodes the others, and the results are joined in substream
        order. Each substream has its own codec state, and a CELT decode
        reads no scratch it has not written, so the output is the same as
        one substream after the other. Every other unit (hybrid, SILK, a
        lost packet) runs one substream after the other on the calling
        thread, and so does every later unit of this decoder: the native
        hybrid band walk folds from per-thread scratch that it has not
        written (ROADMAP.md §1), so a hybrid decode keeps the calling
        thread's history, as the JAX package's serial decoder does. The
        calling thread also runs every unit under IAMF_OPUS_SERIAL, with
        one substream, or where the pool has one thread
        (IAMF_OPUS_THREADS=1, the serving setting)."""
        lib = _load_native()
        if self._pools(packets):
            trace.count("opus.serial_units_pooled", 1)
            pool = self.substream_pool()
            rest = [pool.submit(self._decode_substream, lib, i, packets[i])
                    for i in range(1, len(self._decoders))]
            try:
                first = self._decode_substream(lib, 0, packets[0])
            finally:
                # no substream's state may be in use when the call returns
                cf.wait(rest)
            outs = [first] + [f.result() for f in rest]
        else:
            trace.count("opus.serial_units_caller", 1)
            outs = [self._decode_substream(lib, i, packets[i])
                    for i in range(len(self._decoders))]
        return np.concatenate(outs, axis=0).astype(np.float32)

    def _pools(self, packets) -> bool:
        """Whether decode() sends this unit to the substream pool; a unit
        that is not CELT-only keeps this decoder on the calling thread."""
        if self._on_caller:
            return False
        if not all(p and p[0] >> 3 >= 16 for p in packets):
            self._on_caller = True
            return False
        return (len(self._decoders) > 1
                and not os.environ.get("IAMF_OPUS_SERIAL")
                and self.substream_pool()._max_workers > 1)

    def _decode_substream(self, lib, i: int, pkt) -> np.ndarray:
        """Substream i's native float decode of pkt (None: lost) -> planar
        [ch, samples]."""
        ptr, ch = self._decoders[i]
        buf = np.zeros(self._max * ch, dtype=np.float32)
        if pkt is None:
            # lost packet: native energy-fade concealment (repeat the
            # last frame at -6 dB/loss; the framework analogue of the
            # reference's AAC_CONCEAL_METHOD=1 fade,
            # aac_multistream_decoder.c:224)
            r = lib.iamf_opus_decode_float(
                ptr, None, 0,
                buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                self._max,
            )
        else:
            r = lib.iamf_opus_decode_float(
                ptr, bytes(pkt), len(pkt),
                buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                self._max,
            )
        if r < 0:
            raise ValueError(f"opus decode failed ({r})")
        return buf[: r * ch].reshape(r, ch).T  # planar

    def classify_packets(self, packets_per_substream, frame_size):
        """Scan the TOC bytes of every packet (cheap: one byte each) and
        pick the decode split for this element:

        - ("celt", N, k): CELT-only stream (configs 16-31) at opus frame
          size N (120/240/480/960); k = frame_size // N opus frames per
          IAMF temporal unit -> device spectrum synthesis.
        - ("hybrid", N, k): hybrid (configs 12-15, N 480/960): SILK half
          host-decoded (bit-exact), CELT bands 17+ on device.
        - ("host", frame_size, 1): SILK-only (configs 0-11), mixed-mode/
          mixed-size streams (their transition redundancy needs host celt
          synthesis state), or lost packets -> full host decode (still the
          from-scratch native decoder; the device runs the pipeline).

        Mirrors the reference's single hot loop accepting any TOC
        (opus_multistream2_decoder.c:125-165) with a static split for the
        compiled device program.
        """
        modes, sizes = set(), set()
        celt_sizes = (120, 240, 480, 960)
        for pkts in packets_per_substream:
            for p in pkts:
                if p is None or len(p) == 0:
                    return ("host", frame_size, 1)
                config = bytes(p[:1])[0] >> 3
                if config >= 16:
                    modes.add("celt")
                    sizes.add(celt_sizes[config & 3])
                elif config >= 12:
                    modes.add("hybrid")
                    sizes.add(960 if config & 1 else 480)
                else:
                    return ("host", frame_size, 1)
        if len(modes) != 1 or len(sizes) != 1:
            return ("host", frame_size, 1)
        n = sizes.pop()
        if frame_size % n:
            return ("host", frame_size, 1)
        return (modes.pop(), n, frame_size // n)

    def substream_pool(self) -> cf.ThreadPoolExecutor:
        """The codec's substream threads, made at first use and shared by
        decode_batch and decode_spectrum_batch: IAMF_OPUS_THREADS=n > 0
        threads (aggregate serving sets 1, where N decoders with a pool of
        the host's cores each would oversubscribe it N-fold), else one a
        substream up to the host's cores."""
        if self._pool is None:
            n = int(os.environ.get("IAMF_OPUS_THREADS", "0"))
            self._pool = cf.ThreadPoolExecutor(
                n if n > 0 else min(len(self._decoders), os.cpu_count() or 2))
        return self._pool

    def decode_batch(self, packets_per_substream, frame_size):
        """Host decode path for the batched pipeline (SILK-only and
        mixed-mode streams): full native float decode of every packet —
        transition redundancy, PLC, soft clip included — in one GIL-free
        native stretch per substream, returning [B, L, T] planar float.
        The device still runs the whole decode pipeline (demix, render,
        mix, limiter) on the result."""
        lib = _load_native()
        B = len(packets_per_substream[0])
        L = sum(ch for _, ch in self._decoders)
        out = np.zeros((B, L, frame_size), np.float32)
        lanes = np.cumsum([0] + [ch for _, ch in self._decoders])

        def run_substream(i):
            ptr, ch = self._decoders[i]
            pkts = packets_per_substream[i]
            sl = slice(lanes[i], lanes[i + 1])
            # contiguous runs between lost packets decode in single native
            # calls; None packets conceal via the per-packet PLC entry
            b = 0
            while b < B:
                if pkts[b] is None:
                    tmp = np.zeros(frame_size * ch * 6, np.float32)
                    r = lib.iamf_opus_decode_float(
                        ptr, None, 0,
                        tmp.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                        frame_size * 6)
                    if r < 0:
                        raise ValueError(f"opus PLC failed ({r})")
                    out[b, sl] = tmp[:frame_size * ch].reshape(
                        frame_size, ch).T
                    b += 1
                    continue
                e = b
                while e < B and pkts[e] is not None:
                    e += 1
                blob = b"".join(bytes(p) for p in pkts[b:e])
                sizes = np.array([len(p) for p in pkts[b:e]], np.int32)
                seg = np.empty((e - b, frame_size, ch), np.float32)
                r = lib.iamf_opus_decode_float_batch(
                    ptr, blob,
                    sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
                    e - b,
                    seg.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                    frame_size)
                if r < 0:
                    raise ValueError(f"opus decode failed ({r})")
                out[b:e, sl] = seg.transpose(0, 2, 1)
                b = e

        if len(self._decoders) > 1 and B > 1:
            list(self.substream_pool().map(run_substream,
                                           range(len(self._decoders))))
        else:
            for i in range(len(self._decoders)):
                run_substream(i)
        return out


class FreshThreads:
    """An executor's ``map`` that runs each item on a thread of its own,
    started for it: a native decode on it starts from zeroed thread-local
    scratch (decode_spectrum_batch's hybrid case)."""

    def map(self, fn, items):
        items = list(items)
        out = [None] * len(items)
        errs = []

        def run(i):
            try:
                out[i] = fn(items[i])
            except BaseException as e:  # re-raised in the caller
                errs.append(e)

        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(items))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errs:
            raise errs[0]
        return out


_GAINS = None


def _gains_table():
    """Postfilter tap gains per tapset (celt.c `gains`), rows of 3."""
    global _GAINS
    if _GAINS is None:
        z = np.load(_TABLES)
        _GAINS = np.asarray(z["gains"], np.float32).reshape(3, 3)
    return _GAINS


def decode_spectrum_batch(codec, frames, n: int = 960, k: int = 1,
                          hybrid: bool = False) -> dict:
    """Entropy-decode a batch of temporal units to spectra for the device
    synthesis (OpusDecoder.decode_spectrum_batch of the reference).

    frames: [B] lists of per-substream packets; each packet carries k Opus
    frames of n samples (OpusDecoder.classify_packets). Returns a dict
    whose ``buf`` is the [B·k, L, packed_width(n, hybrid)] float32 buffer
    with the spectra (and a hybrid frame's SILK pcm, columns n + 13 on) in
    place (the caller packs the 13 per-frame parameters into columns
    [n, n + 13) with synth.pack_params), the parameter arrays,
    ``postfilter`` and ``min_period`` (the smallest comb period with a
    nonzero gain)."""
    lib = _load_native()
    gains_tab = _gains_table()
    B = len(frames)
    R = B * k
    decoders = codec._decoders
    L = sum(ch for _, ch in decoders)
    buf = np.zeros((R, L, packed_width(n, hybrid)), np.float32)
    transient = np.zeros((R, L), bool)
    t_old = np.full((R, L), MINPERIOD, np.int32)
    t_cur = np.full((R, L), MINPERIOD, np.int32)
    t_new = np.full((R, L), MINPERIOD, np.int32)
    g_old = np.zeros((R, L, 3), np.float32)
    g_cur = np.zeros((R, L, 3), np.float32)
    g_new = np.zeros((R, L, 3), np.float32)
    lanes = np.cumsum([0] + [ch for _, ch in decoders])
    W = buf.shape[2]

    def run_substream(i):
        # one GIL-free native stretch per substream over all B packets;
        # the spectra land straight in this substream's lane rows of buf
        ptr, _ch = decoders[i]
        pkts = [frames[b][i] for b in range(B)]
        if any(p is None for p in pkts):
            raise ValueError("missing opus sub packet")
        blob = b"".join(bytes(p) for p in pkts)
        sizes = np.array([len(p) for p in pkts], np.int32)
        metas = (SpectrumMeta * R)()
        fbase = int(buf.ctypes.data + 4 * int(lanes[i]) * W)
        # a hybrid frame's SILK pcm goes after its 13 parameter columns
        sbase = fbase + 4 * (n + N_PARAMS) if hybrid else None
        r = lib.iamf_opus_decode_spectrum_batch3(
            ptr, blob, sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            B, k, L * W, W, fbase, sbase, metas)
        if r < 0:
            raise ValueError(
                f"opus spectrum decode failed ({r}) at batch packet "
                f"{metas[0].samples} of substream {i}")
        sl = slice(lanes[i], lanes[i + 1])
        m = np.frombuffer(memoryview(metas), dtype=np.int32).reshape(
            R, len(SpectrumMeta._fields_))
        mf = m.view(np.float32)
        c = _META_COL
        transient[:, sl] = (m[:, c["transient"]] != 0)[:, None]
        t_old[:, sl] = np.maximum(m[:, c["pf_period_old"]], MINPERIOD)[:, None]
        t_cur[:, sl] = np.maximum(m[:, c["pf_period"]], MINPERIOD)[:, None]
        t_new[:, sl] = np.maximum(m[:, c["pf_period_new"]], MINPERIOD)[:, None]
        g_old[:, sl] = (mf[:, c["pf_gain_old"], None]
                        * gains_tab[m[:, c["pf_tapset_old"]]])[:, None, :]
        g_cur[:, sl] = (mf[:, c["pf_gain"], None]
                        * gains_tab[m[:, c["pf_tapset"]]])[:, None, :]
        g_new[:, sl] = (mf[:, c["pf_gain_new"], None]
                        * gains_tab[m[:, c["pf_tapset_new"]]])[:, None, :]

    parallel = len(decoders) > 1 and B > 1
    # IAMF_OPUS_SERIAL set: one substream after the other (profiling on
    # one thread, contention diagnosis); the output does not change
    serial = bool(os.environ.get("IAMF_OPUS_SERIAL"))
    if hybrid:
        # The native hybrid band walk folds from scratch it has not written
        # (it lacks libopus's special_hybrid_folding) and keeps that scratch
        # per thread, so on a reused thread its output depends on what the
        # thread decoded before. New threads start it at zero: one a
        # substream where the reference runs them in parallel (under
        # IAMF_OPUS_SERIAL each ends before the next starts: one thread for
        # them all would change the output), else one for them all, one
        # after the other, as the reference runs them.
        if parallel and not serial:
            FreshThreads().map(run_substream, range(len(decoders)))
        elif parallel:
            for i in range(len(decoders)):
                FreshThreads().map(run_substream, [i])
        else:
            FreshThreads().map(
                lambda _: [run_substream(i) for i in range(len(decoders))],
                [0])
    elif parallel and not serial:
        # substream codec states are independent: they share the pool
        list(codec.substream_pool().map(run_substream, range(len(decoders))))
    else:
        for i in range(len(decoders)):
            run_substream(i)
    active = np.concatenate(
        [np.where(np.any(g != 0, -1), t, 1 << 30).ravel()
         for t, g in ((t_old, g_old), (t_cur, g_cur), (t_new, g_new))])
    min_period = int(active.min()) if active.size else 1 << 30
    return dict(buf=buf, transient=transient,
                t_old=t_old, t_cur=t_cur, t_new=t_new,
                g_old=g_old, g_cur=g_cur, g_new=g_new,
                postfilter=min_period < (1 << 30), min_period=min_period)


class DeviceOpusStream:
    """Opus multistream decode with the CELT synthesis on the device; the
    counterpart of TPUOpusStream, iamf_tpu/codecs/opus/decoder.py:407.

    Each call entropy-decodes a block of temporal units on the host
    (decode_spectrum_batch) and synthesises it in one synthesize_packed
    call (K1, then K2, on a CUDA device; their plain twins on the CPU).
    The synthesis carry (TDAC tail, comb history, de-emphasis memory)
    runs from one call to the next, also where the frame size changes:
    the constants are per frame size, the carry is not. K2 takes any comb
    period, so no chunk is picked."""

    def __init__(self, decoder_conf, streams, coupled_streams, frame_size,
                 device="cuda"):
        self.device = resolve_device(device)
        self.dec = OpusDecoder(decoder_conf, streams, coupled_streams,
                               frame_size)
        self.lanes = sum(ch for _, ch in self.dec._decoders)
        self.carry = init_carry(self.lanes, self.device)

    def decode_frames(self, frames, n: int = 960, k: int = 1,
                      hybrid: bool = False) -> np.ndarray:
        """frames: [B] lists of per-substream packets, each of k Opus
        frames of n samples (hybrid: CELT bands over host SILK) -> PCM
        [B·k, L, n] float32 at s16 granularity."""
        if not frames:
            return np.zeros((0, self.lanes, n), np.float32)
        d = decode_spectrum_batch(self.dec, frames, n=n, k=k, hybrid=hybrid)
        buf = d["buf"]
        buf[..., n:n + N_PARAMS] = pack_params(d)
        pcm, self.carry = synthesize_packed(
            celt_synth(self.device, n), torch.from_numpy(buf).to(self.device),
            self.carry, n, hybrid)
        return pcm.cpu().numpy()
