"""Build the CUDA kernels of ``tpuseg_torch/csrc`` at first use and bind them.

The sources are compiled by ``nvcc`` into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds) and loaded with
``ctypes``. The library lands in ``build/tpuseg_torch/`` at the root of the
checkout, named by a hash of the sources and flags, so an edited source is
rebuilt and an unchanged one is loaded as it is. ``nvcc``'s ptxas report
(registers, shared memory, spills) is kept beside it as ``<name>.log``.

Nothing here runs at import time: the tests import every module on a host
without ``nvcc`` or a GPU.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpuseg_torch"
SOURCES = ("ocr_attention.cu", "bottleneck_fused.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points -> argtypes; every one returns a cudaError_t as int
SIGNATURES = {
    # q, key, val, out, batch, n, num_keys, d, scale, is_bf16, stream
    "tpuseg_ocr_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P),
    # x, w1, b1, w2, b2, w3, b3, out, batch, h, w, c, m, stream
    "tpuseg_bottleneck": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                          _P),
    # c, m -> dynamic shared memory bytes of one block
    "tpuseg_bottleneck_smem_bytes": (_I, _I),
}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: tpuseg_torch's CUDA kernels are built from "
            "tpuseg_torch/csrc with the CUDA toolkit's nvcc (sm_90a)")
    return path


def build() -> Path:
    """Compile the kernels unless a library of the same sources exists."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    so = BUILD_DIR / f"libtpuseg_kernels_{h.hexdigest()[:16]}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(CSRC / s) for s in SOURCES)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed with code {res.returncode}:\n"
                           f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    so.with_suffix(".log").write_text(res.stdout + res.stderr)
    os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    return so


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built kernel library, with every entry point's argtypes set."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
