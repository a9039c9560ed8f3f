#!/usr/bin/env python3
"""The fp32 attention core backward's register tile, blocks an SM,
exponential and unrolling, as shipped and against their alternatives, on
one NVIDIA card.

    python3 tools/f32_attention_variants.py [--parent DIR] [variant ...]

`csrc/attention_core.cuh` fixes the fp32 backward's register tile (4 x 4
sums of each 64 x 64 product a thread, 256 threads: `kBwdTN` 4), the dk/dv
kernel's p and ds tiles (one tile for both, seven tiles a block, two blocks
an SM: `kBwdPTiles` 1), its exponential (ex2.approx: `kBwdEx2` true), the
unrolling of a product's depth (two halves of 8 unrolled steps) and the dq
kernel's register budget (two blocks an SM). The variants: "tile-4x8" (4
x 8 sums a thread, 128 threads), "one-block" (p and ds in a tile each, one
dk/dv block an SM), "expf", "unroll-hi" (the whole depth unrolled) and
"dq-one-block". Each is an edited copy of `csrc/` under
`build/f32_attention_variants/`, of which attention_block.cu and
attention_megablock.cu are compiled with ptxas -v (the backward kernels'
registers and spills printed) and linked with the shipped gemm_f32.cu,
gemm_sm90.cu and rows.cu (built once); the occupancy calculator gives each
kernel's blocks an SM, and cuobjdump its instruction mix. With `--parent
DIR` (a checkout unpacked there, e.g. `git archive HEAD | tar -x -C DIR`)
that checkout's library is built too and its fp32 backward timed beside
them. Each library is checked against the plain versions under
chip_smoke.py's phase 12 rule (fp32: 1e-4 of each output's largest
magnitude, 1e-3 relative Frobenius; two launches bit for bit), then timed
(CUDA events) in turns, through the list and back, at the megablock core's
(256, 257) with the text tower's key pads, one SimSiam pass's (256, 33) and
K6's (256, 256) causal with key pads (chip_smoke.py's shapes), beside the
plain version, SDPA in fp32 and the 67 TFLOP/s bound, and the shipped
backward's dq and dk/dv kernels apart (the profiler's device times); the
variants also at (16, 1024) with whole masked tiles and a dead element
(checked, not timed). Needs a card and nvcc; prints the card and its power
limit first.
"""

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
from xclip_tpu_torch.kernels import attention_block as core  # noqa: E402
from xclip_tpu_torch.kernels import attention_megablock as mega  # noqa: E402

SOURCE = "attention_core.cuh"
OWN = ("attention_block.cu", "attention_megablock.cu")  # built per variant
SHARED = ("gemm_f32.cu", "gemm_sm90.cu", "rows.cu")     # built once
VARIANTS = _build.BUILD_DIR.parent / "f32_attention_variants"
# (variant, [(shipped text, its replacement)])
DQ_BOUNDS = "__global__ void __launch_bounds__(kBwdThreads, 2)"
EDITS = {
    "shipped": [],
    "tile-4x8": [("constexpr int kBwdTN = 4;", "constexpr int kBwdTN = 8;")],
    "one-block": [("constexpr int kBwdPTiles = 1;",
                   "constexpr int kBwdPTiles = 2;")],
    "expf": [("constexpr bool kBwdEx2 = true;",
              "constexpr bool kBwdEx2 = false;")],
    # the depth's two halves unrolled too (a longer loop body); the dq
    # kernel at one block an SM (its registers unbounded)
    "unroll-hi": [("#pragma unroll 1\n  for (int hi = 0; hi < 2; ++hi) {",
                   "#pragma unroll\n  for (int hi = 0; hi < 2; ++hi) {")],
    "dq-one-block": [(DQ_BOUNDS, DQ_BOUNDS.replace(", 2)", ", 1)"))],
}
F32 = torch.float32


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


def nvcc_c(src, obj, verbose=False):
    return subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS,
         *(["-Xptxas", "-v"] if verbose else []), "-c", "-o", str(obj),
         str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def resources(name, src, out):
    """Print the registers and spills ptxas reports for the fp32
    backward's kernels."""
    kernel = None
    for line in out.splitlines():
        m = re.search(r"entry function '\S*(attention_bwd_(?:dq|dkv)_kernel)"
                      r"ILb(\d)E", line)
        if m:
            kernel = f"{m.group(1)}<LSE={m.group(2)}>"
            spill = "?"
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and kernel:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            print(f"{name:10s} {src} {kernel}: {m.group(1)} registers, "
                  f"{spill} bytes spilled", flush=True)
            kernel = None


def sass_mix(name, lib):
    """Print the instruction mix cuobjdump reads from the library's fp32
    backward kernels: instructions in all, FFMA, shared loads (LDS), generic
    loads (LD), local spill traffic (LDL, STL) and barriers (BAR)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True).stdout
    counts, kernel = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : \S*(attention_bwd_(?:dq|dkv)_kernel)"
                      r"ILb(\d)E", line)
        if m:
            kernel = f"{m.group(1)}<LSE={m.group(2)}>"
            counts[kernel] = {}
            continue
        if "Function :" in line:
            kernel = None
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)",
                      line)
        if m and kernel:
            op = m.group(1)
            counts[kernel][op] = counts[kernel].get(op, 0) + 1
    for kernel, c in counts.items():
        print(f"{name:12s} {kernel}: {sum(c.values())} instructions, "
              + ", ".join(f"{op} {c.get(op, 0)}" for op in
                          ("FFMA", "LDS", "LD", "LDL", "STL", "BAR")),
              flush=True)


def build_all(names):
    """{variant: library}: the shared sources once, each variant's own
    sources, all at once."""
    common = VARIANTS / "common"
    common.mkdir(parents=True, exist_ok=True)
    procs = {("common", s): nvcc_c(_build.CSRC / s,
                                   common / f"{Path(s).stem}.o")
             for s in SHARED}
    csrcs = {name: variant_csrc(name) for name in names}
    procs.update({(name, s): nvcc_c(csrc / s,
                                    csrc.parent / f"{Path(s).stem}.o", True)
                  for name, csrc in csrcs.items() for s in OWN})
    for (name, src), proc in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{name} {src}: nvcc failed\n{out}")
        if name != "common":
            resources(name, src, out)
    libs = {}
    for name, csrc in csrcs.items():
        lib = csrc.parent / "lib.so"
        subprocess.run([_build._nvcc(), *_build.ARCH_FLAGS, "-shared", "-o",
                        str(lib),
                        *(str(csrc.parent / f"{Path(s).stem}.o")
                          for s in OWN),
                        *(str(common / f"{Path(s).stem}.o") for s in SHARED)],
                       check=True)
        libs[name] = cs.typed_library(lib)
        sass_mix(name, lib)
        blocks = [libs[name].xclip_attention_bwd_blocks(lse, which)
                  for lse in (1, 0) for which in (0, 1)]
        print(f"{name:10s} blocks an SM (occupancy calculator): K6 dq "
              f"{blocks[0]}, dk/dv {blocks[1]}; megablock dq {blocks[2]}, "
              f"dk/dv {blocks[3]}", flush=True)
    return libs


def holes_mask(g, b, n):
    """Key pads (lengths n/2..n), whole masked 64-key tiles between valid
    keys in every other element, a leading masked tile in the next, and
    the last element all masked (dead rows)."""
    mask = cs.key_mask(torch.randint(n // 2, n + 1, (b,), generator=g,
                                     device="cuda").tolist(), n)
    mask[0::4, 128:256] = False
    mask[1::4, :64] = False
    mask[-1] = False
    return mask


def cases():
    """{label: (kind, b, n, static arguments, qkv, mask, cotangent, the
    plain forward's outputs, timed)}: the megablock's core with its fp32
    dattn and (attnout, sm), K6 with its do and (out, lse)."""
    lgen = torch.Generator().manual_seed(6)
    pads = (torch.randint(4, 257, (256,), generator=lgen) + 1).tolist()
    g = torch.Generator(device="cuda").manual_seed(19)
    out = {}
    for label, kind, b, n, causal, dead, mask, timed in (
            ("megablock (256, 257) key-pad", "mega", 256, 257, False, True,
             cs.key_mask(pads, 257), True),
            ("megablock (256, 33) SimSiam pass", "mega", 256, 33, False,
             False, cs.key_mask([33] * 256, 33), True),
            ("K6 (256, 256) causal key-pad", "k6", 256, 256, True, True,
             cs.key_mask(torch.randint(1, 257, (256,), generator=g,
                                       device="cuda").tolist(), 256), True),
            ("megablock (16, 1024) holes, dead", "mega", 16, 1024, False,
             True, holes_mask(g, 16, 1024), False),
            ("K6 (16, 1024) causal holes, dead", "k6", 16, 1024, True, True,
             holes_mask(g, 16, 1024), False)):
        scale = 64 ** -0.5 if kind == "mega" else 0.125
        static = (8, 64, scale, causal, dead)
        qkv = cs.rand(g, b, n, 3 * 512)
        cot = cs.rand(g, b, n, 512)
        plain_fwd = (mega.mega_core_fwd_plain if kind == "mega"
                     else core.attention_core_fwd_plain)
        out[label] = (kind, b, n, static, qkv, mask, cot,
                      plain_fwd(qkv, mask, *static), timed)
    return out


def bwd(case, plain=False):
    kind, _, _, static, qkv, mask, cot, fwd, _ = case
    if kind == "mega":
        fn = mega.mega_core_bwd_plain if plain else mega.mega_core_bwd
        return fn(qkv, mask, cot, *fwd, *static)
    fn = core.attention_core_bwd_plain if plain else core.attention_core_bwd
    return fn(qkv, mask, *fwd, cot, *static)


def run(lib, case):
    with mock.patch.object(_build, "library", lambda: lib):
        return bwd(case)


def split_ms(lib, case, calls=5):
    """{kernel: device ms a call} of the backward's dq and dk/dv kernels on
    `lib`, from the profiler over `calls` calls."""
    names = ("attention_bwd_dq_kernel", "attention_bwd_dkv_kernel")
    run(lib, case)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            run(lib, case)
        torch.cuda.synchronize()
    ms = dict.fromkeys(names, 0.0)
    for e in cs.device_events(prof):
        for name in names:
            if name in e.name:
                ms[name] += (e.time_range.end - e.time_range.start) / 1e3
    return {name: t / calls for name, t in ms.items()}


def main(args):
    if not torch.cuda.is_available():
        raise SystemExit("f32_attention_variants: needs a CUDA card")
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
    shapes = cases()
    for label, case in shapes.items():
        want = bwd(case, plain=True)
        for name, lib in libs.items():
            if name == "parent" and not case[-1]:
                continue   # an older fp32 backward may stop at 640
            got = run(lib, case)
            if not torch.equal(got, run(lib, case)):
                raise SystemExit(f"{name} {label}: two launches differ")
            cs.compare_elementwise(f"{name} {label}", ("dqkv",), (got,),
                                   (want,), F32)
            del got
        del want
    timed = {label: case for label, case in shapes.items() if case[-1]}
    times = {}
    for name in [*libs, *reversed(libs)]:
        for label, case in timed.items():
            ms = cs.cuda_ms(lambda: run(libs[name], case), reps=5, iters=3)
            times.setdefault((name, label), []).append(ms)
    for label, case in timed.items():
        kind, b, n, static, qkv, mask, cot, fwd, _ = case
        causal = static[3]
        lengths = mask.sum(-1).tolist()
        pairs = 8 * cs.valid_pairs(lengths, n, causal)
        keys = 8 * cs.used_keys(lengths, n)
        cost = (cs.mega_core_cost("bwd", b * n * 8, keys, pairs, b * n, 4)
                if kind == "mega" else
                cs.core_cost("bwd", b * n * 8, keys, pairs, b * n, 4))
        b_ms, b_by = cs.bound(*cost, cs.FP32_PEAK)
        q, k, v = (cs._heads_of(qkv, i) for i in range(3))
        sdpa = cs.sdpa_ms(q, k, v, mask, causal, static[2],
                          cs._heads_of(cot, 0))[1]
        plain = cs.cuda_ms(lambda: bwd(case, plain=True), reps=3, iters=1)
        print(f"{label}: bound {b_ms:.4f} ms ({b_by}), sdpa fp32 backward "
              f"{sdpa:.4f} ms, plain {plain:.4f} ms", flush=True)
        for name in libs:
            ts = times[name, label]
            best = min(ts)
            print(f"  {name:12s} " + " ".join(f"{t:.4f}" for t in ts)
                  + f" ms: {b_ms / best:.3f} of the bound, "
                  f"{best / sdpa:.2f}x sdpa", flush=True)
        if "shipped" in libs:
            split = split_ms(libs["shipped"], case)
            print("  shipped by kernel (profiler): " + ", ".join(
                f"{k} {v:.4f} ms" for k, v in split.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
