"""What the perf/ scripts share: chip_smoke.py with another tree's kernels,
a kernel library built from a changed copy of one kernel source, and the
comparison of two trees' saved outputs.

A tree is a directory holding its own iamf_tpu_torch (e.g. a `git archive`
of the parent commit unpacked under the ignored _chip/); its label is the
directory's name. Builds and saved outputs go to the ignored perf/build/.
"""

from __future__ import annotations

import os
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
BUILD = HERE / "build"


def smoke(tree: str | None = None):
    """This checkout's chip_smoke.py as a module, with `tree`'s
    iamf_tpu_torch (by default this checkout's) first on sys.path."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke  # puts ROOT first on sys.path

    if tree:
        sys.path.insert(0, os.path.abspath(tree))
    return chip_smoke


def label(tree: str | None) -> str:
    return os.path.basename(os.path.abspath(tree or ROOT))


_CSRC: dict = {}  # a build module's own csrc, before use_source moved it


def csrc(build):
    """The kernel sources of `build`'s tree (use_source points build.CSRC
    at a copy)."""
    return _CSRC.setdefault(build.__file__, build.CSRC)


def use_source(build, kernel, name: str, file: str, text: str):
    """Build `text` (a version of csrc/`file`) with the other kernel
    sources and headers of `build`'s tree (as the tree has them, not as
    an earlier call changed them) into its own library and make `kernel`
    launch from it; returns the library's path."""
    import ctypes
    import shutil

    d = BUILD / name.replace(" ", "_")
    d.mkdir(parents=True, exist_ok=True)
    for p in csrc(build).glob("*.cu*"):
        shutil.copy(p, d)
    (d / file).write_text(text)
    build.CSRC, build.BUILD = d, d
    build._lib = None
    path = build.build()[0]
    lib = ctypes.CDLL(str(path))
    lib.iamf_cuda_error_string.argtypes = [ctypes.c_int]
    lib.iamf_cuda_error_string.restype = ctypes.c_char_p
    build._lib = lib
    kernel._fn = None
    return path


def save(out: dict, stem: str, tree: str | None) -> None:
    """Keep a tree's outputs {key: tensor or [tensors]} for compare."""
    import torch

    BUILD.mkdir(exist_ok=True)
    torch.save(out, BUILD / f"{stem}_{label(tree)}.pt")


def compare(stem: str, a: str, b: str, describe=None) -> None:
    """Print, for each key saved by labels a and b, torch.equal and the
    max |diff| of each tensor (or describe(key, diffs) of them)."""
    import torch

    oa, ob = (torch.load(BUILD / f"{stem}_{n}.pt") for n in (a, b))
    for k in oa:
        ta, tb = ([t] if isinstance(t, torch.Tensor) else t
                  for t in (oa[k], ob[k]))
        same = all(torch.equal(p, q) for p, q in zip(ta, tb))
        diffs = [float((p - q).abs().max()) for p, q in zip(ta, tb)]
        what = (describe(k, diffs) if describe
                else ", ".join(f"{d:.3e}" for d in diffs))
        print(f"{k}: {a} vs {b}: equal {same}, max|diff| {what}")
