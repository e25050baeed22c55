"""Builds the port's CUDA kernels at first use and loads them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface (no PyTorch headers, so a build takes
seconds).  Libraries go to ``build/kernels/`` at the root of the checkout,
named by a hash of the sources and flags, so an edited source is rebuilt and
an unchanged one is reused.  ``build_all`` starts one ``nvcc`` per source,
all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}


def refuse_grad(name: str, *tensors) -> None:
    """A kernel's output is filled through ctypes and has no ``grad_fn``:
    where autograd would record a graph through an input, a direct call
    would silently cut it, so it raises.  The kernels' autograd Functions
    (``kernels.ops``) call the wrappers with grad mode off."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires grad but the kernel's output would "
            f"carry none; call it through kernels.ops, whose autograd "
            f"Function recomputes the backward")


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or at /usr/local/cuda/bin; "
                           "the port's CUDA kernels are built on the machine "
                           "with the card")
    return path


def sources() -> Dict[str, Path]:
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def _target(src: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [src, *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.read_bytes())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Build the named kernels (default: all) in parallel.

    Returns, per kernel, the ``-Xptxas -v`` report of its build (registers,
    shared memory, spills), kept beside the library so that a cached build
    reports it too.  Raises ``RuntimeError`` with the compiler's output when
    a build fails.
    """
    srcs = sources()
    todo = list(srcs) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, report = {}, {}
    for name in todo:
        target = _target(srcs[name])
        if target.exists():
            log = target.with_suffix(".log")
            report[name] = log.read_text() if log.exists() else "cached"
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(srcs[name])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, target)
    for name, (proc, tmp, target) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {srcs[name]}:\n{out}")
        target.with_suffix(".log").write_text(out)
        os.replace(tmp, target)   # atomic: a concurrent loader sees all or nothing
        report[name] = out
    return report


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    if name not in _libs:
        build_all([name])
        _libs[name] = ctypes.CDLL(str(_target(sources()[name])))
    return _libs[name]
