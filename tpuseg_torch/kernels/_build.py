"""Build the CUDA kernels of ``tpuseg_torch/csrc`` at first use and bind them.

Each source is compiled by its own ``nvcc``, all started together, and the
objects are linked into one shared library with a plain C interface (no
PyTorch headers, so a build takes seconds), loaded with ``ctypes``. The library lands in ``build/tpuseg_torch/`` at the root of the
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
import time
from pathlib import Path

from tpuseg_torch.utils.profiling import count

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpuseg_torch"
SOURCES = ("ocr_attention.cu", "bottleneck_fused.cu",
           "bottleneck_fused_any.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points -> argtypes; every one returns a cudaError_t as int
SIGNATURES = {
    # q, key, val, out, batch, n, num_keys, d, scale, is_bf16, stream
    "tpuseg_ocr_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P),
    # x, packed parameter block, out, batch, h, w, stream
    "tpuseg_bottleneck": (_P, _P, _P, _I, _I, _I, _P),
    # -> bytes of the packed parameter block
    "tpuseg_bottleneck_param_bytes": (),
    # host pointers: w1, b1, w2, b2, w3, b3 -> the parameter block
    "tpuseg_bottleneck_pack": (_P, _P, _P, _P, _P, _P, _P),
    # x, packed parameter block, its bytes, out, batch, h, w, c, m, stream
    "tpuseg_bottleneck_any": (_P, _P, _I, _P, _I, _I, _I, _I, _I, _P),
    # c, m -> bytes of the packed parameter block
    "tpuseg_bottleneck_any_param_bytes": (_I, _I),
    # host pointers: w1, b1, w2, b2, w3, b3, c, m -> the parameter block
    "tpuseg_bottleneck_any_pack": (_P, _P, _P, _P, _P, _P, _I, _I, _P),
    # c, m, batch, h, w -> int[7]: resident, consumers, tiles a round,
    # x stages, w stages, smem, MP
    "tpuseg_bottleneck_any_plan": (_I, _I, _I, _I, _I, _P),
}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: tpuseg_torch's CUDA kernels are built from "
            "tpuseg_torch/csrc with the CUDA toolkit's nvcc (sm_90a)")
    return path


def build() -> Path:
    """Compile the kernels unless a library of the same sources exists (a
    build counts in the counters ``kernel.builds`` and
    ``kernel.build_s``)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    so = BUILD_DIR / f"libtpuseg_kernels_{h.hexdigest()[:16]}.so"
    if so.exists():
        return so
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{so.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{Path(s).stem}.o" for s in SOURCES]
    compiles = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True))
                for cmd in ([nvcc, *NVCC_FLAGS, "-c", "-o", str(o),
                             str(CSRC / s)] for s, o in zip(SOURCES, objs))]
    done = [(cmd, proc.communicate()[0], proc.returncode)
            for cmd, proc in compiles]  # every nvcc has ended
    log = [_finish(*d) for d in done]
    tmp = so.with_name(f"{tag}.tmp.so")
    cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
    res = subprocess.run(cmd, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    log.append(_finish(cmd, res.stdout, res.returncode))
    for o in objs:
        o.unlink()
    so.with_suffix(".log").write_text("".join(log))
    os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    count("kernel.builds")
    count("kernel.build_s", time.perf_counter() - t0)
    return so


def _finish(cmd: list, output: str, code: int) -> str:
    """nvcc's output, or raise if it failed."""
    if code != 0:
        raise RuntimeError(f"nvcc failed with code {code}:\n"
                           f"{' '.join(cmd)}\n{output}")
    return output


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
