"""Content and bounds shared by the port's CPU tests of the general Opus
operating points (tests/test_torch_opus_modes*.py) and its card tests
(tests/test_torch_cuda.py). Imports neither JAX nor the JAX package.

The content is the Opus sample re-TOCed (streams.retoc_opus_stream: each
packet's payload under a new TOC byte) and a stereo stream of 480- or
240-sample IAMF frames around its substream 0 (streams.
build_opus_stereo_stream).

The re-TOCed CELT and hybrid content is loud past s16: its payloads decode
to garbage band energies, spectra up to ~1.4e7 and IMDCT outputs up to
~7e7, where a float32 ulp is 4-8 and two float32 matmuls of different
summation order part by tens (the JAX einsum is 43 from float64 there, the
port's twin 34). The s16 clip hides most of it, but where the comb and the
de-emphasis bring such values back in range by cancellation an output
sample can move by several LSB. On that content the bar is <= 1 LSB on all
but LOUD_FRACTION of the samples, and <= LOUD_LSB on those (measured on
the CPU against the JAX batched decoder: at most 2 of 180,576 samples over
1 LSB, at most 7 LSB); on the sample's own operating point and the SILK and
mixed variants it is <= 1 LSB.
"""

import functools
import os

import numpy as np

from iamf_tpu_torch.codecs.opus import synth
from iamf_tpu_torch.codecs.opus.decoder import _gains_table
from iamf_tpu_torch.tools import streams

SAMPLE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "iamf_tpu", "data", "sample_opus_714.iamf")
VARIANTS = sorted(streams.OPUS_VARIANTS)
# variant -> (stats path, opus_cfg or None)
EXPECT = {
    "celt480x2": ("opus_device_celt", (480, 2, False)),
    "celt240x4": ("opus_device_celt", (240, 4, False)),
    "celt120x8": ("opus_device_celt", (120, 8, False)),
    "hybrid960": ("opus_device_hybrid", (960, 1, True)),
    "hybrid480x2": ("opus_device_hybrid", (480, 2, True)),
    "silk960": ("opus_host_pipeline", None),
    "mixed": ("opus_host_pipeline", None),
}


@functools.lru_cache(maxsize=None)
def sample() -> bytes:
    return open(SAMPLE, "rb").read()


@functools.lru_cache(maxsize=None)
def stream(name: str) -> bytes:
    """A variant of the sample, or "stereo480" / "stereo240"."""
    if name.startswith("stereo"):
        return streams.build_opus_stereo_stream(sample(), int(name[6:]))
    return streams.retoc_opus_stream(sample(), name)


# --- synthesis twins ---------------------------------------------------------

def synth_buffers(B, L, n, hybrid, calls=2, seed=0):
    """Packed rows for `calls` consecutive calls: spectra randn·300, a third
    of the rows transient, periods 15..1024 and gains from the tap table
    that change between frames, SILK randn·2000."""
    rng = np.random.RandomState(seed)
    taps = _gains_table()
    per = rng.randint(15, 1025, size=L)
    g = np.zeros((L, 3), np.float32)
    bufs = []
    for _ in range(calls):
        buf = np.zeros((B, L, synth.packed_width(n, hybrid)), np.float32)
        buf[..., :n] = rng.randn(B, L, n) * 300.0
        buf[..., n + synth.PK_TRANSIENT] = rng.rand(B, L) < 1 / 3
        if hybrid:
            buf[..., n + synth.N_PARAMS:] = rng.randn(B, L, n) * 2000.0
        for b in range(B):
            new_per = np.where(rng.rand(L) < 0.5, per,
                               rng.randint(15, 1025, size=L))
            new_g = (np.float32(0.09375) * rng.randint(0, 9, size=L))[
                :, None] * taps[rng.randint(0, 3, size=L)]
            buf[b, :, n + synth.PK_T_OLD] = per
            buf[b, :, n + synth.PK_T_CUR] = per
            buf[b, :, n + synth.PK_T_NEW] = new_per
            buf[b, :, n + synth.PK_G_OLD:n + synth.PK_G_OLD + 3] = g
            buf[b, :, n + synth.PK_G_CUR:n + synth.PK_G_CUR + 3] = g
            buf[b, :, n + synth.PK_G_NEW:n + synth.PK_G_NEW + 3] = new_g
            per, g = new_per, new_g
        bufs.append(buf)
    return bufs


LOUD_FRACTION = 1e-4  # samples allowed over 1 LSB on the loud content
LOUD_LSB = 16  # their bound: two float32 ulps at the IMDCT peak (~7e7)


def assert_lsb(got, want, loud=False):
    """<= 1 LSB everywhere, or on loud content (the module's note) on all
    but LOUD_FRACTION of the samples, and <= LOUD_LSB on those."""
    assert got.shape == want.shape and got.dtype == want.dtype
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert d.size
    if not loud:
        assert d.max() <= 1, f"{d.max()} LSB"
        return
    over = int((d > 1).sum())
    assert over <= LOUD_FRACTION * d.size and d.max() <= LOUD_LSB, (
        f"{over} samples over 1 LSB, {d.max()} LSB")
