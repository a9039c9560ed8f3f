"""ctypes wrapper of the C++ BPE merge loop (`fast_bpe.cpp`).

The shared library is built with g++ (or `$CXX`) at first use into
`build/xclip_tpu_torch/` beside the package's checkout, never inside the
package; its name carries a hash of the source, the compiler and the
flags, so an edited source rebuilds and an unchanged one is built once.
Concurrent builds (test workers, loader processes) take a file lock and
write to a temporary name moved into place. A failed build raises with the
compiler's output: nothing falls back to the Python loop behind the
caller's back (`SimpleTokenizer(use_native=False)` selects it).
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import List

SOURCE = Path(__file__).resolve().parent / "fast_bpe.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "xclip_tpu_torch"
FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]


def compiler() -> str:
    return os.environ.get("CXX", "g++")


def library_path(build_dir=None) -> Path:
    digest = hashlib.sha256(" ".join([compiler(), *FLAGS]).encode())
    digest.update(SOURCE.read_bytes())
    name = f"libfastbpe_{digest.hexdigest()[:16]}.so"
    return Path(build_dir or BUILD_DIR) / name


def build(build_dir=None) -> Path:
    """Compile the library unless it exists; returns its path. Raises
    RuntimeError with the compiler's output if the build fails."""
    out = library_path(build_dir)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.parent / "fastbpe.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)   # released when the file closes
        if out.exists():                    # built while this one waited
            return out
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
        os.close(fd)
        try:
            cmd = [compiler(), *FLAGS, str(SOURCE), "-o", tmp]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True)
            except OSError as e:
                raise RuntimeError(f"{' '.join(cmd)} could not run: {e}") \
                    from e
            if proc.returncode != 0:
                raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode})"
                                   f":\n{proc.stderr}")
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded library, built at first use."""
    lib = ctypes.CDLL(str(build()))
    lib.fastbpe_create.restype = ctypes.c_void_p
    lib.fastbpe_create.argtypes = [ctypes.c_char_p]
    lib.fastbpe_destroy.restype = None
    lib.fastbpe_destroy.argtypes = [ctypes.c_void_p]
    lib.fastbpe_encode.restype = ctypes.c_int32
    lib.fastbpe_encode.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32]
    return lib


class FastBPE:
    """The merge loop and vocabulary lookup of one merges file: a caption's
    byte-mapped pre-tokens in (`SimpleTokenizer.encode`), its ids out."""

    def __init__(self, merges_path: str):
        self._lib = library()
        self._handle = self._lib.fastbpe_create(os.fsencode(merges_path))
        if not self._handle:
            raise RuntimeError(f"fastbpe_create failed for {merges_path}")

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.fastbpe_destroy(handle)
            self._handle = None

    def encode(self, pretokens: List[str]) -> List[int]:
        if not pretokens:
            return []
        payload = "\n".join(pretokens).encode("utf-8")
        # every id takes at least one symbol of its pre-token
        cap = sum(len(p) for p in pretokens)
        buf = (ctypes.c_int32 * cap)()
        n = self._lib.fastbpe_encode(self._handle, payload, buf, cap)
        if n < 0:
            raise RuntimeError("fastbpe_encode: more ids than symbols")
        return buf[:n]
