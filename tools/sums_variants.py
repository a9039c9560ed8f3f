#!/usr/bin/env python3
"""The ordered sums and K5's forward as shipped and against their
alternatives, on one NVIDIA card.

    python3 tools/sums_variants.py [--parent DIR] [variant ...]

(every variant when none is named; see EDITS and K5_SPANS).

`csrc/common.cuh` fixes the ordered sums' two regimes: the slab kernel
(kSumThreads threads, a ring of kSumRing stages fed by cp.async, slabs of
16, 8 or 4 columns, the widest that gives 132 blocks) below kSumWideMin
columns, the wide kernel (kSumWideBlocks blocks an SM, a 16-byte vector
of its out a thread, kSumBatch parts loaded evict-first before their
adds) from there. The variants force one
slab width, change the ring's depth or the block, send every sum to the
wide kernel, or change the wide kernel's batch, blocks or cache policy;
each is an edited copy of `csrc/` under `build/`, of which only `rows.cu`
is built (one nvcc each, every variant at once) into a small library.
K5's forward is timed at the ranges of `fwd_plan` (one 128-column tile a
range at R = C = 2048) and at ranges of 2, 4 and 16 tiles, on the shipped
library. With `--parent DIR` (a checkout unpacked there, e.g. `git
archive HEAD | tar -x -C DIR`) the parent's `xclip_reduce_parts` (fp32
sums only) and `xclip_lse_fwd` are built from DIR and timed beside them.

Each sum is checked bit for bit against the plain ordered sum and between
two launches at every shape of chip_smoke.py's SUM_SHAPES (the dg sums at
a 24,576-row chunk's 384 partials), K5's forward within 1e-4 of its plain
version, then everything is timed on the device (the profiler's kernel
durations, chip_smoke.device_ms: the sums take a few µs, which CUDA
events would spend on the host's launch; each call on its own cold copy
of the partials, chip_smoke.cold_sets) in three turns, the second in
reverse order, beside part.sum(0) and torch.logsumexp(x @ y.T).
Needs a card and nvcc; prints the card and its power limit first, and each
variant's registers a thread (`nvcc -Xptxas -v`).
"""

import ctypes
import itertools
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from xclip_tpu_torch.kernels import _build  # noqa: E402
from xclip_tpu_torch.kernels import fused_infonce as k5  # noqa: E402
from xclip_tpu_torch.kernels import rows as rk  # noqa: E402
from xclip_tpu_torch.kernels._common import stream_ptr  # noqa: E402

COMMON = "common.cuh"
SLAB_16 = "    if ((n + 15) / 16 >= kSumMinBlocks)"
SLAB_8 = "    else if ((n + 7) / 8 >= kSumMinBlocks)"
RING = "constexpr int kSumRing = {};"
THREADS = "constexpr int kSumThreads = {};"
BATCH = "constexpr int kSumBatch = {};"
BLOCKS = "constexpr int kSumWideBlocks = {};"
WIDE_MIN = "constexpr long kSumWideMin = 8L * kGemmSMs * 64;"
COLUMNS = "constexpr int kSumWideColumns = 16 / sizeof(Tout);"
LOAD_CS = "__ldcs("

# (variant, [(file, shipped text, its replacement, count)])
EDITS = {
    "shipped": [],
    "slab-4": [(COMMON, SLAB_16, "    if (false)", 1),
               (COMMON, SLAB_8, "    else if (false)", 1)],
    "slab-8": [(COMMON, SLAB_16, "    if (false)", 1),
               (COMMON, SLAB_8, "    else if (true)", 1)],
    "slab-16": [(COMMON, SLAB_16, "    if (true)", 1)],
    "ring-4": [(COMMON, RING.format(8), RING.format(4), 1)],
    "ring-12": [(COMMON, RING.format(8), RING.format(12), 1)],
    "slab-128-threads": [(COMMON, THREADS.format(256), THREADS.format(128),
                          1)],
    "slab-512-threads-ring-4": [
        (COMMON, THREADS.format(256), THREADS.format(512), 1),
        (COMMON, RING.format(8), RING.format(4), 1)],
    "all-wide": [(COMMON, WIDE_MIN, "constexpr long kSumWideMin = 0;", 1)],
    "wide-batch-4": [(COMMON, BATCH.format(12), BATCH.format(4), 1)],
    "wide-32-bytes": [(COMMON, COLUMNS, COLUMNS.replace("16 /", "32 /"),
                       1)],
    "wide-blocks-8": [(COMMON, BLOCKS.format(4), BLOCKS.format(8), 1)],
    "wide-cached": [(COMMON, LOAD_CS, "__ldg(", 3)],
}
K5_SPANS = (None, 2 * k5.TILE, 4 * k5.TILE, 16 * k5.TILE)  # None: fwd_plan
K5_SHAPE = (2048, 2048, 512)
VARIANTS = _build.BUILD_DIR / "sums_variants"


def variant_csrc(name):
    """The variant's copy of csrc/, edited."""
    csrc = VARIANTS / name / "csrc"
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(_build.CSRC, csrc)
    for file, old, new, count in EDITS[name]:
        f = csrc / file
        text = f.read_text()
        if text.count(old) != count:
            raise SystemExit(f"{name}: expected {count} of {old!r} in {file}")
        f.write_text(text.replace(old, new))
    return csrc


def build_all(names, parent):
    """{variant: (library, {kernel: registers})}: rows.cu of each variant
    (and the shipped and parent's fused_infonce.cu) compiled at once
    (ptxas -v), then linked."""
    jobs = {}
    for name in names:
        srcs = ["rows.cu", "fused_infonce.cu"] if name == "shipped" else [
            "rows.cu"]
        jobs[name] = (variant_csrc(name), srcs)
    if parent is not None:
        csrc = VARIANTS / "parent" / "csrc"
        shutil.rmtree(csrc, ignore_errors=True)
        shutil.copytree(parent / "xclip_tpu_torch" / "csrc", csrc)
        jobs["parent"] = (csrc, ["rows.cu", "fused_infonce.cu"])
    procs = {}
    for name, (csrc, srcs) in jobs.items():
        for src in srcs:
            obj = csrc.parent / f"{Path(src).stem}.o"
            procs[(name, src)] = subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
                 "-o", str(obj), str(csrc / src)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
    regs = {name: {} for name in jobs}
    for (name, src), proc in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{name} {src}: nvcc failed\n{out}")
        kernel = None
        for line in out.splitlines():
            m = re.search(r"entry function '(\S+)'", line)
            if m:
                kernel = re.search(
                    r"(reduce_parts_slab_kernel|reduce_parts_wide_kernel|"
                    r"k5_gemm_kernel|lse_merge_kernel|lse_fwd_kernel)"
                    r"(?:I(.*?)E)?", m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m and kernel:
                regs[name][f"{kernel.group(1)} {kernel.group(2) or ''}"] = (
                    int(m.group(1)))
                kernel = None
    libs = {}
    for name, (csrc, srcs) in jobs.items():
        lib = csrc.parent / "lib.so"
        subprocess.run([_build._nvcc(), *_build.ARCH_FLAGS, "-shared", "-o",
                        str(lib), *(str(csrc.parent / f"{Path(s).stem}.o")
                                    for s in srcs)], check=True)
        libs[name] = ctypes.CDLL(str(lib))
    return libs, regs


P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def sum_call(name, lib, part, out, acc):
    """A closure that runs the variant's ordered sum of `part` into `out`
    (acc 0: out's dtype, 2: added to out); None where the parent's entry
    (fp32 out only) cannot."""
    st = stream_ptr(part.device)
    fn = lib.xclip_reduce_parts
    if name == "parent":
        if out.dtype != torch.float32:
            return None
        fn.argtypes = [P, P, I, L, I, P]
        return lambda: fn(part.data_ptr(), out.data_ptr(), part.shape[0],
                          out.numel(), int(acc == 2), st)
    fn.argtypes = [I, P, P, I, L, I, P]
    code = 1 if out.dtype == torch.bfloat16 else 0
    return lambda: fn(code, part.data_ptr(), out.data_ptr(), part.shape[0],
                      out.numel(), acc, st)


def lse_call(name, lib, x, y, lse, span):
    """A closure that runs the variant's K5 forward (the shipped library at
    `span` columns a range, or the parent's)."""
    (R, d), C = x.shape, y.shape[0]
    st = stream_ptr(x.device)
    fn = lib.xclip_lse_fwd
    if name == "parent":
        fn.argtypes = [P, P, P, I, I, I, I, I, P]
        return lambda: fn(x.data_ptr(), y.data_ptr(), lse.data_ptr(), R, C, d,
                          0, 1, st)
    fn.argtypes = [P, P, P, P, I, I, I, I, I, I, P]
    span = span or k5.fwd_plan(R, C)
    ml = torch.empty(2 * -(-C // span) * R, device=x.device)
    return lambda: fn(x.data_ptr(), y.data_ptr(), lse.data_ptr(),
                      ml.data_ptr(), R, C, d, span, 0, 1, st)


def launch(what, fn):
    err = fn()
    if err:
        raise SystemExit(f"{what}: cudaError_t {err}")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("sums_variants: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    args = sys.argv[1:]
    parent = None
    if args[:1] == ["--parent"]:
        parent, args = Path(args[1]).resolve(), args[2:]
    names = args or list(EDITS)
    unknown = set(names) - set(EDITS)
    if unknown or "shipped" not in names:
        raise SystemExit(f"sums_variants: no variant {sorted(unknown)}, or "
                         "no 'shipped'")
    libs, regs = build_all(names, parent)
    for name, r in regs.items():
        print(f"registers {name}: " + ", ".join(
            f"{k} {v}" for k, v in sorted(r.items())), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(13)
    # the sums: (tag, part, running sum, acc), checked bit for bit
    cases = []
    for key, _, parts, n, acc, _ in cs.SUM_SHAPES:
        parts = rk.blocks(24_576) if parts == "R" else parts
        part, run = cs.rand(gen, parts, n), cs.rand(gen, n)
        want = (rk.reduce_parts(part.cpu(), run.cpu()) if acc == 2 else
                rk.reduce_parts(part.cpu(), dtype=torch.bfloat16
                                if acc == 0 else torch.float32)).cuda()
        cases.append((f"{key} ({parts} x {n}, acc {acc})", part, run, acc,
                      want))
    # each timed call sums its own cold copy of the partials and of the
    # running sum (chip_smoke.cold_sets: every byte from HBM)
    sets = {id(part): cs.cold_sets(part, run, cap=1 << 30)
            for _, part, run, *_ in cases}

    def in_turn(fns):
        it = itertools.cycle(fns)
        return lambda: next(it)()

    timed = {}
    names_all = [*names, *(["parent"] if parent else [])]
    for name in names_all:
        for tag, part, run, acc, want in cases:
            outs = [run.clone() if acc == 2 else torch.empty_like(want)
                    for _ in range(2)]
            fns = [sum_call(name, libs[name], part, o, acc) for o in outs]
            if fns[0] is None:
                continue
            for fn in fns:
                launch(f"{name} {tag}", fn)
            torch.cuda.synchronize()
            if not all(torch.equal(o, want) for o in outs):
                raise SystemExit(f"{name} {tag}: not the plain ordered "
                                 "sum's bits in both launches")
            timed[(name, tag)] = in_turn([
                sum_call(name, libs[name], p,
                         r if acc == 2 else torch.empty_like(want), acc)
                for p, r in sets[id(part)]])
    R, C, d = K5_SHAPE
    x = torch.nn.functional.normalize(cs.rand(gen, R, d), dim=-1) * 14.0
    y = torch.nn.functional.normalize(cs.rand(gen, C, d), dim=-1)
    want = k5.streaming_lse_fwd_plain(x, y, 0, True)
    k5_runs = [("shipped", s) for s in K5_SPANS] + (
        [("parent", None)] if parent else [])
    for name, span in k5_runs:
        lse = torch.empty(R, device="cuda")
        fn = lse_call(name, libs[name], x, y, lse, span)
        launch(f"{name} K5 span {span}", fn)
        first = lse.clone()
        launch(f"{name} K5 span {span}", fn)
        torch.cuda.synchronize()
        cs.compare(f"{name} K5 forward {K5_SHAPE} DCL, span {span}", lse,
                   want, 1e-4)
        if not torch.equal(first, lse):
            raise SystemExit(f"{name} K5 span {span}: two launches differ")
        tag = f"K5 forward {K5_SHAPE} DCL, " + (
            "span plan" if span is None else f"span {span}")
        timed[(name, tag)] = fn
    order = [*timed, *reversed(timed), *timed]
    times = {}
    for turn, key in enumerate(order):
        ms = cs.device_ms(timed[key], 10)
        times.setdefault(key, []).append(ms)
        print(f"turn {turn // len(timed)} {key[0]:16s} {key[1]}: {ms:.4f} ms",
              flush=True)
    for (name, tag), ts in times.items():
        print(f"mean {name:16s} {tag}: {sum(ts) / len(ts):.4f} ms")
    for tag, part, *_ in cases:
        lib = in_turn([lambda p=p: p.sum(0) for p, _ in sets[id(part)]])
        print(f"library part.sum(0) {tag}: {cs.device_ms(lib, 10):.4f} ms")
    print(f"library torch.logsumexp(x @ y.T, -1) {K5_SHAPE} (no DCL mask): "
          f"{cs.device_ms(lambda: torch.logsumexp(x @ y.T, -1)):.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
