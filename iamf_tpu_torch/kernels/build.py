"""Build and bind the hand-written CUDA kernels (iamf_tpu_torch/csrc/*.cu).

The sources compile with nvcc, one process per source started together,
and link into ONE shared library with a plain C interface, loaded through
ctypes: no PyTorch headers, so a build takes seconds. The library is built at first use into iamf_tpu_torch/build/
(ignored by git), under a name keyed on a hash of the sources and flags,
so an edited source rebuilds and an unchanged one is reused.

Every C entry takes the current CUDA stream as its last argument,
launches on it, allocates nothing and returns ``cudaGetLastError()``;
``Kernel.__call__`` passes tensors as device pointers, appends the stream
and raises when the error is non-zero. ``--fmad=false`` keeps nvcc from
contracting ``a*b + c`` into an FMA, so the comb and limiter recurrences
round exactly as the reference's separate multiply and add do; K1 names
its roundings (``__fadd_rn``, ``__fmul_rn``), and its tensor-core
``wgmma`` is not affected.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "build"
NVCC_FLAGS = (  # the first two are the target, passed to the link too
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "--fmad=false",
)

_lib = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "iamf_tpu_torch: nvcc not found (PATH or /usr/local/cuda/bin); "
            "the CUDA kernels are built from iamf_tpu_torch/csrc at first use")
    return path


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD / f"libiamf_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> tuple[Path, float]:
    """Compile csrc/*.cu unless the keyed library exists: one nvcc per
    source, all started together (the sources share no device code), then
    one link. Returns (path, seconds spent compiling and linking)."""
    out = library_path()
    if out.exists():
        return out, 0.0
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    stem = f"{out.stem}.{os.getpid()}"
    srcs = sources()
    objs = [BUILD / f"{stem}.{s.stem}.o" for s in srcs]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []), "-c",
         "-o", str(o), str(s)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for s, o in zip(srcs, objs)]
    logs = [p.communicate()[0] for p in procs]
    try:
        bad = [f"{s.name} ({p.returncode}):\n{log}"
               for s, p, log in zip(srcs, procs, logs) if p.returncode]
        if bad:
            raise RuntimeError("nvcc failed on " + "\n".join(bad))
        tmp = out.with_name(f"{stem}.tmp.so")
        r = subprocess.run(
            [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
             *map(str, objs)], capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({r.returncode}):\n{r.stdout}\n{r.stderr}")
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    secs = time.perf_counter() - t0
    if verbose:
        print("".join(logs) + r.stdout + r.stderr)
    os.replace(tmp, out)
    return out, secs


def load():
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        lib.iamf_cuda_error_string.argtypes = [ctypes.c_int]
        lib.iamf_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


P = ctypes.c_void_p
I = ctypes.c_int
U = ctypes.c_uint32
F = ctypes.c_float


class Kernel:
    """One C entry of the kernel library, with its launch counter.

    ``argtypes`` lists the entry's arguments without the trailing stream.
    ``launches`` grows by one each time the entry is called (one call may
    make several device launches: the phases of one kernel).
    ``plain_on_cuda`` counts calls of the kernel's plain PyTorch twin made
    with CUDA tensors; the decode path never makes one, and chip_smoke.py
    checks that it stays 0 there."""

    def __init__(self, symbol: str, argtypes: list):
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self.plain_on_cuda = 0
        self._fn = None

    def __call__(self, *args) -> None:
        """Launch on the current stream of the tensors' device. Tensor
        arguments go as device pointers; each must be on that CUDA device."""
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        dev = tensors[0].device
        if any(t.device != dev for t in tensors) or dev.type != "cuda":
            raise ValueError(f"{self.symbol}: every tensor must be on one "
                             f"CUDA device, got "
                             f"{sorted({str(t.device) for t in tensors})}")
        if self._fn is None:
            lib = load()
            fn = getattr(lib, self.symbol)
            fn.argtypes = [*self.argtypes, P]
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a
                         for a in args),
                       torch.cuda.current_stream(dev).cuda_stream)
        if err:
            msg = load().iamf_cuda_error_string(err).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {err} ({msg})")
        self.launches += 1

    def note_plain(self, t: torch.Tensor) -> None:
        if t.is_cuda:
            self.plain_on_cuda += 1

    def reset(self) -> None:
        self.launches = 0
        self.plain_on_cuda = 0
