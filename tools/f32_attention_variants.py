#!/usr/bin/env python3
"""The fp32 attention core's forward and backward (the megablock's, K6's,
and K7's fp32 forward and backward in their own mode) as shipped and
against their alternatives, on one NVIDIA card.

    python3 tools/f32_attention_variants.py [--parent DIR] [variant ...]

`csrc/attention_core.cuh` fixes the kernels' register tile (4 x 4 sums of
each 64 x 64 product a thread, 256 threads: `kBwdTN` 4), the dk/dv
kernel's p and ds tiles (one tile for both, seven tiles a block, two blocks
an SM: `kBwdPTiles` 1), the backward's exponential (ex2.approx: `kBwdEx2`
true), the unrolling of a product's depth (two halves of 8 unrolled
steps), the dq kernel's register budget (two blocks an SM); the forward
always takes a row's 16 threads in one warp (its running max and sum by
shuffles) and ex2.approx. At heads of 128 a block is two 256-thread
halves, a 64-column half each (16 warps an SM). The variants: "tile-4x8" (4 x 8 sums a thread,
128 threads, forward and backward), "one-block" (p and ds in a tile each,
one dk/dv block an SM), "expf" (the backward's exponential), "unroll-hi"
(the whole depth unrolled), "dq-one-block", "fwd-exchange" (the
forward's rows over two warps, as the backward's, their max and sum
exchanged through shared memory: two more block barriers a key tile;
`tools/fwd_exchange.patch`), "fwd-expf" (the forward's exponential,
`tools/fwd_expf.patch`), and at heads of 128 "nh2-one-block" (the
design this one replaced: 256 threads holding both halves' sums, one
block and 8 warps an SM; `tools/nh2_one_block.patch`) and "nh2-cluster"
(the forward as a cluster of two 256-thread blocks, a column half each,
the partial scores read through distributed shared memory, two blocks
an SM; the backward as shipped; `tools/nh2_cluster.patch`) and
"nh2-rows" (the backward's two inner block barriers a tile as named
barriers of the four warps holding the same rows, the dk/dv kernel's
row terms double-buffered; `tools/nh2_rows.patch`). Each is an edited copy of `csrc/`
under `build/f32_attention_variants/`, of which attention_block.cu,
attention_megablock.cu and flash_attention.cu are compiled with ptxas -v
(the fp32 kernels' registers and spills printed) and linked with the
shipped gemm_f32.cu, gemm_sm90.cu and rows.cu (built once); the occupancy
calculator gives each kernel's blocks and warps an SM at heads of 64 and
128, and cuobjdump its instruction mix. With `--parent DIR` (a checkout unpacked there, e.g. `git archive
HEAD | tar -x -C DIR`; one whose fp32 K7 dq kernel computes Δ, as this
checkout's wrappers expect) that checkout's library is built too and its
fp32 kernels timed beside them. Each library is checked against the plain versions
under chip_smoke.py's phase 12 rule (fp32: 1e-4 of each output's largest
magnitude, 1e-3 relative Frobenius; two launches bit for bit), then timed
(CUDA events) in turns, through the list and back, at the megablock
core's (256, 257) with the text tower's key pads, one SimSiam pass's (256,
33), K6's (256, 256) causal with key pads and K7's at phase 12's text
shape (256, 8, 256, 64) causal with key pads (forward and backward),
beside the plain version, SDPA in fp32 and the 67 TFLOP/s bound, and the
shipped kernels apart (the profiler's device times); the same at
chip_smoke.py phase 21's shapes with heads of 128: the megablock core's
(256, 257, 4 x 128) and K6's (256, 256, 4 x 128) causal with key pads,
K7's (64, 8, 256, 128) causal with its key pads; the variants also at
(16, 1024) and (4, 2048) with whole masked tiles and a dead element,
K7's at (2, 8, 2304), and at heads of 128 K6's (16, 1024) and K7's (2,
8, 2304) so (checked, not timed). Needs a card and nvcc; prints
the card and its power limit first.

The "fwd-exchange" variant applies `tools/fwd_exchange.patch`,
written against the sources as they stood before the kernels took
heads of 128 (one 64-column tile a head): on today's sources the
tool stops there, naming the hunk it cannot find.
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
sys.path.insert(0, str(ROOT / "tools"))
import chip_smoke as cs  # noqa: E402
from rows_variants import hunks  # noqa: E402
from xclip_tpu_torch.kernels import _build  # noqa: E402
from xclip_tpu_torch.kernels import attention_block as core  # noqa: E402
from xclip_tpu_torch.kernels import attention_megablock as mega  # noqa: E402
from xclip_tpu_torch.kernels import flash_attention as flash  # noqa: E402

SOURCE = "attention_core.cuh"
OWN = ("attention_block.cu", "attention_megablock.cu",
       "flash_attention.cu")                            # built per variant
SHARED = ("gemm_f32.cu", "gemm_sm90.cu", "rows.cu")     # built once
VARIANTS = _build.BUILD_DIR.parent / "f32_attention_variants"
TOOLS = Path(__file__).resolve().parent
# (variant, [(shipped text, its replacement)], applied in order)
DQ_BOUNDS = ("__launch_bounds__(kThreads<NH>, kBlocks<NH>)\n"
             "attention_bwd_dq_kernel")
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
    "dq-one-block": [(DQ_BOUNDS, DQ_BOUNDS.replace("kBlocks<NH>", "1"))],
    "fwd-exchange": hunks(TOOLS / "fwd_exchange.patch"),
    "fwd-expf": hunks(TOOLS / "fwd_expf.patch"),
    # heads of 128 as one 256-thread block holding both halves' sums, one
    # block (8 warps) an SM
    "nh2-one-block": hunks(TOOLS / "nh2_one_block.patch"),
    # the forward at heads of 128 as a cluster of two 256-thread blocks, a
    # column half each, the partial scores exchanged through distributed
    # shared memory (two blocks an SM)
    "nh2-cluster": hunks(TOOLS / "nh2_cluster.patch"),
    # the backward's inner block barriers at heads of 128 as named barriers
    # of the four warps holding the same rows (the dk/dv kernel's row terms
    # double-buffered)
    "nh2-rows": hunks(TOOLS / "nh2_rows.patch"),
}
F32 = torch.float32
# the kernels' mangled names: mode (0 megablock, 1 K6, 2 K7) and NH
KERNELS = r"(attention_(?:fwd|bwd_dq|bwd_dkv)_kernel)ILi(\d)ELi(\d)E"


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
    """Print the registers and spills ptxas reports for the fp32 core's
    kernels (the template argument: the mode, 0 megablock, 1 K6, 2 K7)."""
    kernel = None
    for line in out.splitlines():
        m = re.search(r"entry function '\S*" + KERNELS, line)
        if m:
            kernel = f"{m.group(1)}<{m.group(2)}, {m.group(3)}>"
            spill = "?"
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and kernel:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            print(f"{name:12s} {src} {kernel}: {m.group(1)} registers, "
                  f"{spill} bytes spilled", flush=True)
            kernel = None


def sass_mix(name, lib):
    """Print the instruction mix cuobjdump reads from the library's fp32
    core kernels: instructions in all, FFMA, shared loads (LDS), generic
    loads (LD), local spill traffic (LDL, STL) and barriers (BAR)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True).stdout
    counts, kernel = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : \S*" + KERNELS, line)
        if m:
            kernel = f"{m.group(1)}<{m.group(2)}, {m.group(3)}>"
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
        occupancy(name, libs[name])
    return libs


def occupancy(name, lib):
    """Print the fp32 kernels' blocks and warps an SM (the occupancy
    calculator's, for the build's registers and shared memory) at heads of
    64 and 128, in each mode: a block is 256 threads a 64-column half (the
    one-block variant's 256 at either width)."""
    for d in (64, 128):
        warps = 8 if name == "nh2-one-block" else 8 * (d // 64)
        blocks = [(lib.xclip_attention_fwd_blocks(0, mode, d, 0),
                   *(lib.xclip_attention_bwd_blocks(0, mode, which, d, 0)
                     for which in (0, 1))) for mode in (1, 0)]
        blocks.append((lib.xclip_flash_fwd_blocks(d),
                       *(lib.xclip_flash_bwd_blocks(which, d)
                         for which in (0, 1))))
        print(f"{name:12s} heads of {d}, blocks (warps) an SM: " + "; ".join(
            f"{mode} forward {f} ({f * warps}), dq {q} ({q * warps}), "
            f"dk/dv {kv} ({kv * warps})" for mode, (f, q, kv) in
            zip(("K6", "megablock", "K7"), blocks)), flush=True)


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


class Case:
    """One shape: kind "mega" (the megablock's core, its fp32 dattn and
    (attnout, sm)), "k6" (its do and (out, lse)) or "k7" (K7's kernels on
    the (b·h, n, d) tensors its wrapper hands them, q pre-scaled), `heads`
    heads of d (hd 512); `fwd` the plain forward's outputs."""

    def __init__(self, label, kind, b, n, causal, dead, mask, timed, g,
                 d=64):
        self.label, self.kind, self.b, self.n = label, kind, b, n
        self.causal, self.mask, self.timed = causal, mask, timed
        self.d, self.heads = d, 512 // d
        if kind == "k7":
            self.heads = 8
            q, k, v, do = (cs.rand(g, b, 8, n, d) for _ in range(4))
            self.heads4 = (q * d ** -0.5, k, v, do)
            (q, k, v, do), self.mask_bh = flash.pad_flat(self.heads4, mask)
            self.flat = (q, k, v, do)
            self.fwd = flash.flash_attention_fwd_plain(q, k, v, self.mask_bh,
                                                       causal)
            return
        self.static = (self.heads, d, d ** -0.5, causal, dead)
        self.qkv = cs.rand(g, b, n, 3 * 512)
        self.cot = cs.rand(g, b, n, 512)
        self.fwd = self.forward(plain=True)

    def forward(self, plain=False):
        if self.kind == "k7":
            fn = (flash.flash_attention_fwd_plain if plain
                  else flash.flash_attention_fwd)
            return fn(*self.flat[:3], self.mask_bh, self.causal)
        if self.kind == "mega":
            fn = mega.mega_core_fwd_plain if plain else mega.mega_core_fwd
        else:
            fn = (core.attention_core_fwd_plain if plain
                  else core.attention_core_fwd)
        return fn(self.qkv, self.mask, *self.static)

    def backward(self, plain=False):
        if self.kind == "k7":
            q, k, v, do = self.flat
            fn = (flash.flash_attention_bwd_plain if plain
                  else flash.flash_attention_bwd)
            return fn(q, k, v, self.mask_bh, *self.fwd, do, self.causal)
        if self.kind == "mega":
            fn = mega.mega_core_bwd_plain if plain else mega.mega_core_bwd
            return fn(self.qkv, self.mask, self.cot, *self.fwd, *self.static)
        fn = core.attention_core_bwd_plain if plain else core.attention_core_bwd
        return fn(self.qkv, self.mask, *self.fwd, self.cot, *self.static)

    def names(self, which):
        if which == "fwd":
            return (("attnout", "sm") if self.kind == "mega"
                    else ("out", "lse"))
        return ("dq", "dk", "dv") if self.kind == "k7" else ("dqkv",)

    def cost(self, which):
        lengths = self.mask.sum(-1).tolist()
        h = self.heads
        if self.kind == "k7":
            lengths_bh = [L for L in lengths for _ in range(h)]
            return cs.flash_cost(which, self.b * h, self.n, lengths_bh,
                                 self.causal, 4, width=self.d)
        pairs = h * cs.valid_pairs(lengths, self.n, self.causal)
        keys = h * cs.used_keys(lengths, self.n)
        fn = cs.mega_core_cost if self.kind == "mega" else cs.core_cost
        return fn(which, self.b * self.n * h, keys, pairs, self.b * self.n, 4,
                  width=self.d)

    def sdpa(self):
        """SDPA fp32 (forward, backward) ms on the same q, k, v and mask."""
        if self.kind == "k7":
            q, k, v, do = self.heads4
            return cs.sdpa_ms(q, k, v, self.mask, self.causal, 1.0, do)[:2]
        b, n, h, d = self.b, self.n, self.heads, self.d
        q, k, v, do = (t[..., i * 512:(i + 1) * 512].reshape(
            b, n, h, d).transpose(1, 2) for t, i in (
                (self.qkv, 0), (self.qkv, 1), (self.qkv, 2), (self.cot, 0)))
        return cs.sdpa_ms(q, k, v, self.mask, self.causal, self.static[2],
                          do)[:2]


def cases():
    """The shapes: the megablock's core at the text tower's (256, 257) with
    key pads and at one SimSiam pass's (256, 33), K6's (256, 256) causal
    with key pads, K7's at (256, 8, 256) causal with key pads (timed); the
    megablock's and K6's at (16, 1024) and (4, 2048), K7's at (2, 2304),
    with holes and a dead element (checked). At heads of 128 (timed),
    chip_smoke.py's phase 21 shapes: the megablock's core at (256, 257, 4
    x 128) and K6's at (256, 256, 4 x 128) causal, key pads, and K7's at
    (b·h 512, n 256, 128) causal with its key pads; K6's and K7's with
    holes and a dead element (checked)."""
    lgen = torch.Generator().manual_seed(6)
    pads = (torch.randint(4, 257, (256,), generator=lgen) + 1).tolist()
    g = torch.Generator(device="cuda").manual_seed(19)

    def lengths(b, n, low=1):
        return torch.randint(low, n + 1, (b,), generator=g,
                             device="cuda").tolist()

    out = []
    for label, kind, b, n, causal, dead, mask, timed in (
            ("megablock (256, 257) key-pad", "mega", 256, 257, False, True,
             cs.key_mask(pads, 257), True),
            ("megablock (256, 33) SimSiam pass", "mega", 256, 33, False,
             False, cs.key_mask([33] * 256, 33), True),
            ("K6 (256, 256) causal key-pad", "k6", 256, 256, True, True,
             cs.key_mask(lengths(256, 256), 256), True),
            ("K7 (256, 8, 256, 64) causal key-pad", "k7", 256, 256, True,
             False, cs.key_mask(lengths(256, 256, 128), 256), True),
            ("megablock (16, 1024) holes, dead", "mega", 16, 1024, False,
             True, holes_mask(g, 16, 1024), False),
            ("K6 (16, 1024) causal holes, dead", "k6", 16, 1024, True, True,
             holes_mask(g, 16, 1024), False),
            ("megablock (4, 2048) holes, dead", "mega", 4, 2048, False,
             True, holes_mask(g, 4, 2048), False),
            ("K6 (4, 2048) causal holes, dead", "k6", 4, 2048, True, True,
             holes_mask(g, 4, 2048), False),
            ("K7 (2, 8, 2304, 64) causal holes, dead", "k7", 2, 2304, True,
             False, holes_mask(g, 2, 2304), False)):
        out.append(Case(label, kind, b, n, causal, dead, mask, timed, g))
    k7_lengths = [128 + (37 * i) % 129 for i in range(64)]   # phase 21's
    for label, kind, b, n, causal, dead, mask, timed in (
            ("megablock (256, 257, 4x128) key-pad", "mega", 256, 257, False,
             True, cs.key_mask(lengths(256, 257), 257), True),
            ("K6 (256, 256, 4x128) causal key-pad", "k6", 256, 256, True,
             True, cs.key_mask(lengths(256, 256), 256), True),
            ("K7 (64, 8, 256, 128) causal key-pad", "k7", 64, 256, True,
             False, cs.key_mask(k7_lengths, 256), True),
            ("K6 (16, 1024, 4x128) causal holes, dead", "k6", 16, 1024, True,
             True, holes_mask(g, 16, 1024), False),
            ("K7 (2, 8, 2304, 128) causal holes, dead", "k7", 2, 2304, True,
             False, holes_mask(g, 2, 2304), False)):
        out.append(Case(label, kind, b, n, causal, dead, mask, timed, g,
                        d=128))
    return out


def run(lib, fn):
    with mock.patch.object(_build, "library", lambda: lib):
        return fn()


def check(name, lib, case):
    """The case's forward and backward on `lib` against the plain versions,
    two launches of each bit for bit."""
    for which, fn in (("fwd", case.forward), ("bwd", case.backward)):
        got = cs.as_tuple(run(lib, fn))
        again = cs.as_tuple(run(lib, fn))
        if not all(map(torch.equal, got, again)):
            raise SystemExit(f"{name} {case.label} {which}: two launches "
                             "differ")
        want = cs.as_tuple(case.forward(plain=True) if which == "fwd"
                           else case.backward(plain=True))
        cs.compare_elementwise(f"{name} {case.label} {which}",
                               case.names(which), got, want, F32)
        del got, again, want


def split_ms(lib, fn, names, calls=5):
    """{kernel: device ms a call} of `names` run by `fn` on `lib`, from the
    profiler over `calls` calls."""
    run(lib, fn)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            run(lib, fn)
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
    for case in shapes:
        for name, lib in libs.items():
            check(name, lib, case)
    timed = [c for c in shapes if c.timed]
    # (case, which): the call timed on a library
    calls = [(case, which) for case in timed for which in ("fwd", "bwd")]

    def call(name, case, which):
        fn = case.forward if which == "fwd" else case.backward
        return lambda: run(libs[name], fn)

    times = {}
    for name in [*libs, *reversed(libs)]:
        for case, which in calls:
            ms = cs.cuda_ms(call(name, case, which), reps=5, iters=3)
            times.setdefault((name, case.label, which), []).append(ms)
    for case in timed:
        sdpa = case.sdpa()
        for which in ("fwd", "bwd"):
            b_ms, b_by = cs.bound(*case.cost(which), cs.FP32_PEAK)
            one = sdpa[0 if which == "fwd" else 1]
            plain = cs.cuda_ms(
                (lambda: case.forward(plain=True)) if which == "fwd" else
                (lambda: case.backward(plain=True)), reps=3, iters=1)
            print(f"{case.label} {which}: bound {b_ms:.4f} ms ({b_by}), "
                  f"sdpa fp32 {one:.4f} ms, plain {plain:.4f} ms",
                  flush=True)
            for name in libs:
                ts = times[name, case.label, which]
                best = min(ts)
                print(f"  {name:12s} " + " ".join(f"{t:.4f}" for t in ts)
                      + f" ms: {b_ms / best:.3f} of the bound, "
                      f"{best / one:.2f}x sdpa", flush=True)
            if "shipped" in libs:
                kernels = (("attention_fwd_kernel",) if which == "fwd" else
                           ("attention_bwd_dq_kernel",
                            "attention_bwd_dkv_kernel"))
                split = split_ms(
                    libs["shipped"],
                    case.forward if which == "fwd" else case.backward,
                    kernels)
                print("  shipped by kernel (profiler): " + ", ".join(
                    f"{k} {v:.4f} ms" for k, v in split.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
