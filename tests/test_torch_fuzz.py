"""Robustness of the port against the JAX package on damaged input: the
port's counterpart of tests/test_fuzz.py.

Random bytes, truncations and bit flips of PCM, scalable, ambisonics,
two-element and Opus-sample streams go through both packages' decoders,
the frame-serial IAMFDecoder and the batched BatchedStreamDecoder (the
port's on the CPU, device="cpu"). On every case the two must agree: where
one raises, the other raises an exception of the same class (by name:
each package has its own IAMFError), at the same call; where they decode,
each call consumes the same bytes and the PCM is of the same shape and
within 1 LSB (the repo's bar for two decoders of one stream). A case
that ends without an exception may decode nothing in both. The serial
loop is bounded to 64 calls, so a decoder that consumes nothing cannot
hang it.

Where the serial PCM differs by more than 1 LSB, the JAX decode is
repeated in a subprocess whose XLA emits no fused multiply-add
(XLA_FLAGS=--xla_cpu_max_isa=AVX), and the port must agree with that
decode to the same bar. XLA:CPU contracts a * b + c into an FMA where the
CPU has one; the reference C code and the port (twin and K3, built with
--fmad=false) round the product and the sum apart. The JAX serial
limiter's gain walk (iamf_tpu/dsp/limiter.py process_block, a jitted
scan) is where this shows: its state drifts by an ulp or two
(tests/test_torch_limiter.py, ROADMAP.md section 3), and on a damaged
stream that drives the limiter hard (a bit-flipped Opus sample, peak 1.6
at the limiter) a retrigger that one rounding takes and the other does
not moves the PCM by 3 LSB. Without the FMA the two decodes agree within
1 LSB.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

import vectors
from iamf_tpu import api as japi
from iamf_tpu.constants import ChannelLayout
from iamf_tpu.core.batch_decoder import BatchedStreamDecoder as JaxBatched
from iamf_tpu_torch import api as papi
from iamf_tpu_torch.core.batch_decoder import BatchedStreamDecoder

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(ROOT, "iamf_tpu", "data", "sample_opus_714.iamf")


def _serial(dec, stream, units=64):
    """configure + decode call by call: [("configure", used) or
    ("decode", consumed, pcm) or (call, exception class name), ...]."""
    dec.set_sound_system(0)
    try:
        pos = dec.configure(stream)
    except Exception as e:  # noqa: BLE001 - the class is what is compared
        return [("configure", type(e).__name__)]
    events = [("configure", pos)]
    for _ in range(units):
        if pos >= len(stream):
            break
        try:
            consumed, pcm = dec.decode(stream[pos:])
        except Exception as e:  # noqa: BLE001
            events.append(("decode", type(e).__name__))
            break
        events.append(("decode", consumed, pcm))
        if consumed <= 0:
            break
        pos += consumed
    return events


def _same_pcm(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and (
        a.size == 0
        or int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max()) <= 1)


NO_FMA_DECODE = r"""
import pickle, sys
sys.path[:0] = [sys.argv[1], sys.argv[1] + "/tests"]
from iamf_tpu import api
from test_torch_fuzz import _serial
stream = open(sys.argv[2], "rb").read()
pickle.dump(_serial(api.IAMFDecoder(), stream, int(sys.argv[3])),
            open(sys.argv[2] + ".events", "wb"))
"""
_no_fma = {}


def _jax_serial_without_fma(stream, units, tmp_dir):
    """The JAX serial decode of `stream` in a process whose XLA emits no
    FMA (cached by stream)."""
    key = (hash(stream), units)
    if key not in _no_fma:
        path = os.path.join(tmp_dir, f"case{len(_no_fma)}.iamf")
        with open(path, "wb") as f:
            f.write(stream)
        env = dict(os.environ, XLA_FLAGS="--xla_cpu_max_isa=AVX",
                   JAX_PLATFORMS="cpu")
        r = subprocess.run([sys.executable, "-c", NO_FMA_DECODE, ROOT, path,
                            str(units)], env=env, capture_output=True,
                           text=True, timeout=600)
        assert r.returncode == 0, r.stderr[-3000:]
        with open(path + ".events", "rb") as f:
            _no_fma[key] = pickle.load(f)
    return _no_fma[key]


def _differ(got, want):
    if len(want) != len(got):
        return f"{len(got)} calls against {len(want)}: {got[-1][:2]} vs " \
               f"{want[-1][:2]}"
    for i, (g, w) in enumerate(zip(got, want)):
        if g[:2] != w[:2] or (len(g) == 3 and not _same_pcm(g[2], w[2])):
            return f"call {i}: {g[:2]} vs {w[:2]}"
    return None


def _agree_serial(stream, tmp_dir, units=64):
    want = _serial(japi.IAMFDecoder(), stream, units)
    got = _serial(papi.IAMFDecoder(device="cpu"), stream, units)
    msg = _differ(got, want)
    if msg is None or len(got) != len(want) or any(
            g[:2] != w[:2] for g, w in zip(got, want)):
        return msg
    return _differ(got, _jax_serial_without_fma(stream, units, tmp_dir))


def _agree_batched(stream, **kw):
    def run(make):
        try:
            return ("ok", make().decode_all())
        except Exception as e:  # noqa: BLE001
            return ("raise", type(e).__name__)

    want = run(lambda: JaxBatched(stream, **kw))
    got = run(lambda: BatchedStreamDecoder(stream, device="cpu", **kw))
    if got[0] != want[0] or (got[0] == "raise" and got[1] != want[1]):
        return f"{got[0]} {got[1] if got[0] == 'raise' else ''} vs " \
               f"{want[0]} {want[1] if want[0] == 'raise' else ''}"
    if got[0] == "ok" and not _same_pcm(got[1], want[1]):
        return f"PCM {np.shape(got[1])} vs {np.shape(want[1])}"
    return None


def _flips(stream, rng, count, bits):
    """`count` copies of stream with 1..bits (or exactly `bits` when
    given as a tuple) random bit flips each."""
    out = []
    for _ in range(count):
        b = bytearray(stream)
        nb = bits[0] if isinstance(bits, tuple) else int(
            rng.integers(1, bits + 1))
        for _ in range(nb):
            i = int(rng.integers(0, len(b)))
            b[i] ^= 1 << int(rng.integers(0, 8))
        out.append(bytes(b))
    return out


def _stereo():
    return vectors.build_pcm_layout_stream(ChannelLayout.STEREO,
                                           n_frames=4)[0]


SERIAL = {
    "random_bytes": lambda rng: [
        bytes(rng.integers(0, 256, n, dtype=np.uint8))
        for n in (1, 7, 64, 1024, 9000) for _ in range(3)],
    "truncated_pcm": lambda rng: [
        _stereo()[:cut] for cut in sorted(
            {1, 5, 20, 60, len(_stereo()) // 3, len(_stereo()) // 2,
             len(_stereo()) - 3, *rng.integers(1, len(_stereo()), 9)})],
    "bitflip_pcm": lambda rng: _flips(_stereo(), rng, 40, (3,)),
    "bitflip_scalable": lambda rng: _flips(
        vectors.build_scalable_pcm_stream(n_frames=3)[0], rng, 30, 4),
    "bitflip_ambisonics": lambda rng: _flips(
        vectors.build_ambisonics_pcm_stream(order=1, n_frames=3)[0], rng,
        30, 4),
    "bitflip_two_element": lambda rng: _flips(
        vectors.build_two_element_stream(n_frames=3)[0], rng, 30, 4),
    "bitflip_opus_sample": lambda rng: _flips(
        open(SAMPLE, "rb").read(), rng, 30, 4),
}


@pytest.mark.parametrize("kind", list(SERIAL))
def test_serial_decoders_agree(kind, tmp_path):
    rng = np.random.default_rng(sorted(SERIAL).index(kind))
    cases = SERIAL[kind](rng)
    # the Opus sample decodes its CELT frames on the host: 6 units a case
    units = 6 if kind == "bitflip_opus_sample" else 64
    bad = {i: msg for i, s in enumerate(cases)
           if (msg := _agree_serial(s, tmp_path, units)) is not None}
    assert not bad, f"{len(bad)} of {len(cases)} cases differ: {bad}"


BATCHED = {
    "bitflip_pcm": lambda: vectors.build_pcm_layout_stream(
        ChannelLayout.L510, n_frames=4)[0],
    "bitflip_scalable": lambda: vectors.build_scalable_pcm_stream(
        n_frames=3)[0],
    "bitflip_two_element": lambda: vectors.build_two_element_stream(
        n_frames=3)[0],
}


@pytest.mark.parametrize("kind", list(BATCHED))
def test_batched_decoders_agree(kind):
    rng = np.random.default_rng(100 + sorted(BATCHED).index(kind))
    cases = _flips(BATCHED[kind](), rng, 30, 4)
    bad = {i: msg for i, s in enumerate(cases)
           if (msg := _agree_batched(s, sound_system=1, batch_frames=2))
           is not None}
    assert not bad, f"{len(bad)} of {len(cases)} cases differ: {bad}"


def test_limiter_fma_case(tmp_path):
    """The case the suite found: a 4-bit flip of the Opus sample drives
    the serial limiter (peak 1.6 at its input), where the JAX package's
    decode with XLA's FMA contraction and the port's are 3 LSB apart at
    the fifth call. Without the FMA, the JAX decode and the port's agree
    bit for bit."""
    rng = np.random.default_rng(sorted(SERIAL).index("bitflip_opus_sample"))
    stream = SERIAL["bitflip_opus_sample"](rng)[28]
    got = _serial(papi.IAMFDecoder(device="cpu"), stream, 6)
    want = _jax_serial_without_fma(stream, 6, tmp_path)
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        assert g[:2] == w[:2]
        if len(g) == 3:
            assert np.array_equal(np.asarray(g[2]), np.asarray(w[2]))
