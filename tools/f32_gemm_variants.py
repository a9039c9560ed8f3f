#!/usr/bin/env python3
"""The fp32 product kernel's slice depth, ring, register budget and
unrolling, as shipped and against their alternatives, on one NVIDIA card.

    python3 tools/f32_gemm_variants.py [--parent DIR] [variant ...]

`csrc/gemm_f32.cu` fixes the kernel's k-slice depth (kF32BK, 16), its ring
(4 slices, 3 where both operands are transposed on the way in), its
register budget (two blocks of 256 threads an SM: 128 registers a
thread) and the unrolling of a slice's k steps (all 16). Each variant is
an edited copy of `csrc/` under `build/f32_variants/`, of which
gemm_f32.cu, gemm_sm90.cu (the xclip_mm entry) and rows.cu are compiled
(ptxas -v: registers and spills of each instance printed) into a library
of its own. With `--parent DIR` (a checkout unpacked there, e.g. `git
archive HEAD | tar -x -C DIR`) that checkout's whole library is built too
and its fp32 product path timed beside them (its own split-k ranges).
Each library is checked against `matmul.mm_plain` for every class
(chip_smoke.py's phase 19 rule: 1e-4 of each output's largest
magnitude), then timed (CUDA events) in turns, forward then backward
through the list, on the first call of every class at chip_smoke's
F32_ROWS, beside torch.mm in fp32. Needs a card and nvcc; prints the card
and its power limit first.
"""

import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path
from unittest import mock

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from xclip_tpu_torch.kernels import _build  # noqa: E402

SOURCE = "gemm_f32.cu"
SOURCES = ("gemm_f32.cu", "gemm_sm90.cu", "rows.cu")
VARIANTS = _build.BUILD_DIR.parent / "f32_variants"
KLOOP = "#pragma unroll\n    for (int kk = 0; kk < kF32BK; ++kk) {"
# (variant, [(shipped text, its replacement)])
EDITS = {
    "shipped": [],
    "bk8": [("constexpr int kF32BK = 16;", "constexpr int kF32BK = 8;")],
    "ring3": [("static constexpr int stages = a_k || b_k ? 4 : 3;",
               "static constexpr int stages = 3;")],
    "one-block": [("__launch_bounds__(kF32Threads, 2)",
                   "__launch_bounds__(kF32Threads, 1)")],
    # the slice's 16 k steps unrolled 4 or 8 at a time (a shorter loop
    # body for the instruction cache)
    "unroll4": [(KLOOP, KLOOP.replace("unroll", "unroll 4"))],
    "unroll8": [(KLOOP, KLOOP.replace("unroll", "unroll 8"))],
}


def variant_csrc(name):
    """The variant's csrc: a copy of the shipped sources, edited."""
    csrc = VARIANTS / name / "csrc"
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(_build.CSRC, csrc)
    f = csrc / SOURCE
    text = f.read_text()
    for old, new in EDITS[name]:
        if text.count(old) != 1:
            raise SystemExit(f"{name}: expected one {old!r} in {SOURCE}")
        text = text.replace(old, new)
    f.write_text(text)
    return csrc


def typed(lib):
    for name in ("xclip_mm", "xclip_mm_split"):
        getattr(lib, name).argtypes = _build._SIGNATURES[name]
        getattr(lib, name).restype = ctypes.c_int
    return lib


def build_all(names):
    """{variant: library}, every variant's sources compiled at once; prints
    each fp32 instance's registers and spills."""
    csrcs = {name: variant_csrc(name) for name in names}
    procs = {(name, src): subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
         str(csrc.parent / f"{Path(src).stem}.o"), str(csrc / src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, csrc in csrcs.items() for src in SOURCES}
    for (name, src), proc in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{name} {src}: nvcc failed\n{out}")
        if src != SOURCE:
            continue
        kernel = None
        for line in out.splitlines():
            m = re.search(r"entry function '\S*gemm_f32_kernelILi(\d)ELb(\d)"
                          r"ELb(\d)ELb(\d)E", line)
            if m:
                kernel = "epi {} ta {} tb {} vec {}".format(*m.groups())
                spill = "?"
            m = re.search(r"(\d+) bytes spill stores", line)
            if m and kernel:
                spill = m.group(1)
            m = re.search(r"Used (\d+) registers", line)
            if m and kernel:
                print(f"{name:10s} {kernel}: {m.group(1)} registers, {spill} "
                      "bytes spilled", flush=True)
                kernel = None
    libs = {}
    for name, csrc in csrcs.items():
        lib = csrc.parent / "lib.so"
        subprocess.run([_build._nvcc(), *_build.ARCH_FLAGS, "-shared", "-o",
                        str(lib), *(str(csrc.parent / f"{Path(s).stem}.o")
                                    for s in SOURCES)], check=True)
        libs[name] = typed(ctypes.CDLL(str(lib)))
    return libs


def split_by(lib, ops):
    """`ops` with `lib`'s split-k ranges."""
    m, n, k = ops["m"], ops["n"], ops["k"]
    return dict(ops, k_split=lib.xclip_mm_split(0, m, n, k, 0)
                if ops["ta"] else None)


def run(lib, ops):
    """The product on `lib`'s fp32 kernel (`ops` split by `lib`)."""
    with mock.patch.object(_build, "library", lambda: lib):
        return cs.run_mm(ops)


def main(args):
    if not torch.cuda.is_available():
        raise SystemExit("f32_gemm_variants: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    parent = None
    if args[:1] == ["--parent"]:
        parent, args = Path(args[1]).resolve(), args[2:]
    names = args or list(EDITS)
    libs = build_all(names)
    if parent is not None:
        libs["parent"] = cs.parent_library(parent)
    gen = torch.Generator(device="cuda").manual_seed(19)
    shapes = [cs.product_operands(gen, cls, rows, dt=torch.float32)
              for cls in cs.PRODUCT_CLASSES for rows in cs.F32_ROWS]
    split = {(name, i): split_by(lib, ops) for name, lib in libs.items()
             for i, ops in enumerate(shapes)}
    for name, lib in libs.items():
        for i, ops in enumerate(shapes):
            ops = split[name, i]
            cs.compare_products(f"{name} {ops['tag']}",
                                cs.as_tuple(run(lib, ops)),
                                cs.as_tuple(cs.run_mm(ops, plain=True)),
                                ops["names"])
    order = [*libs, *reversed(libs)]
    times = {}
    for name in order:
        for i, ops in enumerate(shapes):
            ms = cs.cuda_ms(lambda: run(libs[name], split[name, i]), reps=5,
                            iters=3)
            times.setdefault((name, ops["tag"]), []).append(ms)
    for ops in shapes:
        lib_ms, what = cs.library_ms(ops)
        flops = cs.product_cost(ops)[1]
        print(f"{ops['tag']}: torch {what} {lib_ms:.4f} ms "
              f"({flops / lib_ms / 1e9:.1f} TFLOP/s)", flush=True)
        for name in libs:
            ts = times[name, ops["tag"]]
            best = min(ts)
            print(f"  {name:10s} " + " ".join(f"{t:.4f}" for t in ts)
                  + f" ms: {flops / best / 1e9:.1f} TFLOP/s, "
                  f"{best / lib_ms:.2f}x torch", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
