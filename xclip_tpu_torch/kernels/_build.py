"""Build and load the hand-written CUDA kernels in `xclip_tpu_torch/csrc/`.

All `csrc/*.cu` files are compiled by `nvcc` for `sm_90a` into ONE shared
library with a plain C interface, loaded with `ctypes`. The library lives
in `build/xclip_tpu_torch/` beside the package's checkout and its name
carries a hash of the sources and flags, so an edited source rebuilds and
an unchanged one is built once. Nothing here runs at import time: a
machine without `nvcc` can import the package and run the plain versions.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "xclip_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: name -> argtypes (all return int: a cudaError_t, or a size)
_SIGNATURES = {
    "xclip_ff_block_fwd": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                           _I, _I, _I, _F, _P],
    "xclip_attention_block_fwd": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                  _P, _I, _I, _I, _I, _F, _I, _I, _F, _P],
    "xclip_attention_block_max_n": [_I],
}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels of xclip_tpu_torch "
                           "are built on a machine with the CUDA toolkit")
    return path


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    cus, headers = _sources()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cus + headers:
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    return BUILD_DIR / f"libxclip_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it exists; returns its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cus, _ = _sources()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, cus)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: concurrent builds agree
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    """Raise for a nonzero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what} failed with cudaError_t {err}")
