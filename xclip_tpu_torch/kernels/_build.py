"""Build and load the hand-written CUDA kernels in `xclip_tpu_torch/csrc/`.

Each `csrc/*.cu` file is compiled by its own `nvcc` for `sm_90a`, all of
them at once, and the objects are linked into ONE shared library with a
plain C interface, loaded with `ctypes`. The library lives
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
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C entry points: name -> argtypes. Each returns an int (a cudaError_t, or
# a sequence length) except the workspace queries and the launch
# counters, which return a byte count or a count (_RESTYPES).
_SIGNATURES = {
    "xclip_ff_block_fwd": [_I, *[_P] * 14, _L, _I, _I, _I, _F, _P],
    "xclip_ff_block_bwd_workspace": [_I, _I, _I, _I],
    "xclip_ff_block_bwd_p1": [_I, *[_P] * 18, _I, _I, _I, _P],
    "xclip_ff_block_bwd_p1_h": [_I, *[_P] * 16, _I, _I, _I, _P],
    "xclip_geglu_ln_fwd": [_I, _P, _P, _P, _I, _I, _F, _P],
    "xclip_geglu_ln_bwd_workspace": [_I, _I],
    "xclip_geglu_ln_bwd": [_I, *[_P] * 6, _I, _I, _F, _P],
    "xclip_ff_block_bwd_p2": [_I, *[_P] * 7, _I, _I, _I, _P],
    "xclip_ff_block_bwd_recompute_workspace": [_I] * 5,
    "xclip_ff_block_bwd_recompute": [_I, *[_P] * 7, _L, *[_P] * 6, _I, _I,
                                     _I, _I, _F, _I, _P],
    "xclip_attention_block_fwd": [_I, *[_P] * 14, _L, *[_I] * 5, _F, _I, _I,
                                  _F, _P],
    "xclip_attention_block_bwd_workspace": [_I] * 6,
    "xclip_attention_block_bwd": [_I, *[_P] * 19, *[_I] * 5, _F, _I, _I, _P],
    "xclip_attention_block_bwd_recompute_workspace": [_I] * 7,
    "xclip_attention_block_bwd_recompute": [_I, *[_P] * 10, _L, *[_P] * 6,
                                            *[_I] * 5, _F, _I, _I, _F, _I,
                                            _P],
    "xclip_attention_block_max_n": [_I],
    "xclip_attention_block_bwd_max_n": [_I],
    "xclip_attention_bwd_blocks": [_I, _I, _I],
    "xclip_attention_fwd_blocks": [_I, _I],
    "xclip_mega_core_fwd": [_I, *[_P] * 4, *[_I] * 4, _F, _I, _I, _P],
    "xclip_mega_core_bwd": [_I, *[_P] * 8, *[_I] * 4, _F, _I, _I, _P],
    "xclip_lse_fwd": [*[_P] * 4, *[_I] * 6, _P],
    "xclip_lse_bwd": [*[_P] * 8, *[_I] * 8, _P],
    "xclip_attention_core_fwd": [_I, *[_P] * 4, *[_I] * 4, _F, _I, _I, _P],
    "xclip_attention_core_bwd": [_I, *[_P] * 7, *[_I] * 4, _F, _I, _I, _P],
    "xclip_flash_fwd": [_I, *[_P] * 6, _I, _I, _I, _I, _P],
    "xclip_flash_bwd": [_I, *[_P] * 11, _I, _I, _I, _I, _P],
    "xclip_flash_fwd_blocks": [_I],
    "xclip_flash_bwd_blocks": [_I, _I],
    "xclip_mm": [_I, _I, _I, _I, *[_P] * 6, _I, _I, _I, _I, _I, _P],
    "xclip_mm_split": [_I] * 5,
    "xclip_mm_launches": [_I, _I, _I],
    "xclip_geglu_bwd_rows": [_I, _I, *[_P] * 6, _I, _I, _F, *[_P] * 5],
    "xclip_ln_bwd_rows": [_I, _I, _I, _I, *[_P] * 8, _I, _I, *[_P] * 7],
    "xclip_ln_fwd_rows": [_I, _I, _I, *[_P] * 4, _I, _I, _F, *[_P] * 4],
    "xclip_reduce_parts": [_I, _P, _P, _I, _L, _I, _P],
    "xclip_sum_launches": [_P, _P, _P, _I, _I],
    "xclip_rows_launches": [_I, _I],
}
_RESTYPES = {name: ctypes.c_longlong for name in _SIGNATURES
             if name.endswith(("_workspace", "_launches"))}


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


def _run_all(commands):
    """Run the commands at once; raise with the output of any that fails."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in commands]
    failed = []
    for cmd, proc in zip(commands, procs):
        output = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)} ({proc.returncode}):\n{output}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def build() -> Path:
    """Compile the library unless it exists; returns its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cus, _ = _sources()
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [str(Path(tmp) / f"{cu.stem}.o") for cu in cus]
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(cu)]
                  for cu, obj in zip(cus, objs)])
        lib = str(Path(tmp) / "lib.so")
        _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", lib, *objs]])
        os.replace(lib, out)  # atomic: concurrent builds agree
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _RESTYPES.get(name, ctypes.c_int)
    return lib


def check(err: int, what: str) -> None:
    """Raise for a nonzero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what} failed with cudaError_t {err}")
