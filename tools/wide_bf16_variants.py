#!/usr/bin/env python3
"""The bf16 attention kernels at heads of 128, each design beside the
others and the parent's, on one NVIDIA card.

    python3 tools/wide_bf16_variants.py [--parent DIR] [variant ...]

`csrc/attention_block_sm90.cuh` runs K6 and the megablock's attention core
in bf16. At heads of 128 (`NH` = 2) the forward and the dq kernel run on
wgmma (one warpgroup a 64-row block, TMA-fed) and the dk/dv kernel on four
warps of mma.sync, the megablock's with one buffer of do and of T(dattn)
(its notes give the design). Each variant is an edited copy of `csrc/`
built into its own directory under `build/` (all at once, a process
each): "shipped" as the sources stand; "rows128", the forward on blocks
of two warpgroups (128 query rows) sharing each staged key tile;
"fwd-pairs", the forward on 8-warp mma.sync blocks whose warp pairs share
16 rows and exchange partial scores (`tools/nh2_fwd_pairs.patch`);
"dkv-pairs", K6's and the megablock's dk/dv on 8-warp blocks whose warp
pairs share 16 keys (`tools/nh2_dkv_pairs.patch`); "first-tile", key tile
0 loaded by TMA before the mask words are read (`tools/nh2_first_tile.patch`).
With `--parent DIR` (a checkout of another commit) its
`xclip_tpu_torch/csrc/` is built and timed beside them as "parent", bound
to the entry points the timed wrappers call.

Each variant prints the blocks and warps an SM of its bf16 kernels at 128
(not the parent's: its entry points took fp32 only), then is checked
against the plain versions under chip_smoke.py's phase 12 rule (outputs,
statistics and dqkv; two forward and two backward launches bit for bit
equal) and timed in turns (in order, reversed, in order; CUDA events, the
backward's dq and dk/dv kernels apart on the profiler's device clock) at
phase 21's shapes: K6 (256, 256, 4 x 128) causal with key pads uniform in
1..n, the megablock's core (256, 257, 4 x 128) with key pads and with
full-length captions; at the 64-wide shapes K6 (256, 256, 8 x 64) and the
megablock's (256, 257, 8 x 64), whose kernels the designs leave alone;
and bf16 K7 at (b*h 512, 256, 128) causal. SDPA bf16 is timed once a
shape. Needs a card and nvcc; prints the card and its power limit first
(about nine minutes for the five variants and a parent).
"""

import argparse
import shutil
import subprocess
import sys
from pathlib import Path

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

SOURCE = "attention_block_sm90.cuh"
TOOLS = Path(__file__).resolve().parent
ROWS = "constexpr int K6_WG_ROWS = {};"
# (variant, [(shipped text, its replacement, occurrences)])
EDITS = {
    "shipped": [],
    "rows128": [(ROWS.format(64), ROWS.format(128), 1)],
    "fwd-pairs": [(old, new, 1)
                  for old, new in hunks(TOOLS / "nh2_fwd_pairs.patch")],
    "dkv-pairs": [(old, new, 1)
                  for old, new in hunks(TOOLS / "nh2_dkv_pairs.patch")],
    "first-tile": [(old, new, 1)
                   for old, new in hunks(TOOLS / "nh2_first_tile.patch")],
}
# the entry points the timed wrappers call: all an older checkout's library
# must have
CALLED = ("xclip_mega_core_fwd", "xclip_mega_core_bwd",
          "xclip_attention_core_fwd", "xclip_attention_core_bwd",
          "xclip_attention_block_max_n", "xclip_attention_block_bwd_max_n",
          "xclip_flash_fwd", "xclip_flash_bwd")
SIGNATURES = _build._SIGNATURES


def variant_dirs(name):
    """(csrc, build directory) of a variant: the shipped sources, or an
    edited copy of them."""
    if not EDITS[name]:
        return _build.CSRC, _build.BUILD_DIR
    base = _build.BUILD_DIR / "variants" / f"wide-{name}"
    csrc = base / "csrc"
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(_build.CSRC, csrc)
    f = csrc / SOURCE
    text = f.read_text()
    for old, new, count in EDITS[name]:
        if text.count(old) != count:
            raise SystemExit(f"{name}: expected {count} x {old!r} in {SOURCE}")
        text = text.replace(old, new)
    f.write_text(text)
    return csrc, base


def build_all(dirs):
    """Build every variant's library at once, a process each."""
    code = ("import sys; from pathlib import Path; "
            "from xclip_tpu_torch.kernels import _build; "
            "_build.CSRC, _build.BUILD_DIR = Path(sys.argv[1]), "
            "Path(sys.argv[2]); _build.build()")
    procs = {name: subprocess.Popen([sys.executable, "-c", code, str(c),
                                     str(b)], cwd=ROOT)
             for name, (c, b) in dirs.items()}
    for name, p in procs.items():
        if p.wait():
            raise SystemExit(f"{name}: the build failed")


def use(dirs, entries=None):
    """Load a variant's library, binding `entries` (every entry point if
    None) from a table of its own."""
    _build.CSRC, _build.BUILD_DIR = dirs
    _build._SIGNATURES = {name: SIGNATURES[name]
                          for name in (entries or SIGNATURES)}
    _build.library.cache_clear()
    return _build.library()


def residency(lib):
    """'kernel blocks (warps)' of the bf16 kernels at heads of 128."""
    out = []
    for mode, fam in ((1, "K6"), (0, "megablock")):
        for which, kind in ((-1, "forward"), (0, "dq"), (1, "dk/dv")):
            args = ((1, mode, 128) if which < 0 else (1, mode, which, 128))
            fn = (lib.xclip_attention_fwd_blocks if which < 0
                  else lib.xclip_attention_bwd_blocks)
            out.append(f"{fam} {kind} {fn(*args, 0)} ({fn(*args, 1)})")
    return ", ".join(out)


def cases():
    """{name: (forward, backward, plain forward, plain backward, output
    names, sdpa)} at the shapes the module docstring lists."""
    gen = torch.Generator(device="cuda").manual_seed(25)
    out = {}
    for fam, n, heads, d, causal, full in (
            ("K6", 256, 4, 128, True, False),
            ("megablock", 257, 4, 128, False, False),
            ("megablock", 257, 4, 128, False, True),
            ("K6", 256, 8, 64, True, False),
            ("megablock", 257, 8, 64, False, False)):
        b, hd, scale = 256, heads * d, d ** -0.5
        lengths = ([n] * b if full else torch.randint(
            1, n + 1, (b,), generator=gen, device="cuda").tolist())
        mask = cs.key_mask(lengths, n)
        qkv = cs.rand(gen, b, n, 3 * hd, dtype=torch.bfloat16)
        static = (heads, d, scale, causal, True)
        if fam == "K6":
            cot = cs.rand(gen, b, n, hd, dtype=torch.bfloat16)
            fwd, bwd = core.attention_core_fwd, core.attention_core_bwd
            fwd_p, bwd_p = (core.attention_core_fwd_plain,
                            core.attention_core_bwd_plain)
            names = ("out", "lse")
        else:
            cot = cs.rand(gen, b, n, hd)
            fwd, bwd = mega.mega_core_fwd, mega.mega_core_bwd
            fwd_p, bwd_p = mega.mega_core_fwd_plain, mega.mega_core_bwd_plain
            names = ("attnout", "sm")
        want = fwd_p(qkv, mask, *static)
        bargs = ((qkv, mask, cot, *want) if fam == "megablock"
                 else (qkv, mask, *want, cot))
        q, k, v = (qkv[..., i * hd:(i + 1) * hd].reshape(
            b, n, heads, d).transpose(1, 2) for i in range(3))
        sdpa = cs.sdpa_ms(q, k, v, mask, causal, scale, cot.to(
            torch.bfloat16).reshape(b, n, heads, d).transpose(1, 2))
        label = (f"{fam} ({b}, {n}, {heads}x{d})"
                 f"{' causal' if causal else ''}"
                 f"{' full-length' if full else ' key-pad'}")
        out[label] = (
            lambda f=fwd, a=(qkv, mask, *static): f(*a),
            lambda f=bwd, a=(*bargs, *static): f(*a),
            lambda f=fwd_p, a=(qkv, mask, *static): f(*a),
            lambda f=bwd_p, a=(*bargs, *static): f(*a), names, sdpa)
    bh, n, h, d = 512, 256, 8, 128
    lengths = [n // 2 + (37 * i) % (n // 2 + 1) for i in range(bh // h)]
    mask = cs.key_mask([L for L in lengths for _ in range(h)], n)
    q, k, v, do = (cs.rand(gen, bh, n, d, scale=d ** -0.25 if i < 2 else 1.0,
                           dtype=torch.bfloat16) for i in range(4))
    want = flash.flash_attention_fwd_plain(q, k, v, mask, True)
    bargs = (q, k, v, mask, *want, do, True)
    four = [t.reshape(bh // h, h, n, d) for t in (q, k, v, do)]
    sdpa = cs.sdpa_ms(*four[:3], cs.key_mask(lengths, n), True, 1.0, four[3])
    out[f"K7 (b*h {bh}, {n}, {d}) causal"] = (
        lambda: flash.flash_attention_fwd(q, k, v, mask, True),
        lambda: flash.flash_attention_bwd(*bargs),
        lambda: flash.flash_attention_fwd_plain(q, k, v, mask, True),
        lambda: flash.flash_attention_bwd_plain(*bargs), ("out", "lse"), sdpa)
    return out


def check(name, shapes):
    """Each shape's outputs against the plain versions; two launches of
    each direction bit for bit equal."""
    for label, (fwd, bwd, fwd_p, bwd_p, names, _) in shapes.items():
        got = fwd()
        if not all(map(torch.equal, got, fwd())):
            raise SystemExit(f"{name} {label}: two forward launches differ")
        cs.compare_elementwise(f"{name} {label}", names, got, fwd_p(),
                               torch.bfloat16)
        got = bwd()
        again = bwd()
        if isinstance(got, tuple):  # K7: (dq, dk, dv)
            same, want, gnames = (all(map(torch.equal, got, again)), bwd_p(),
                                  ("dq", "dk", "dv"))
        else:
            same, got, want, gnames = (torch.equal(got, again), (got,),
                                       (bwd_p(),), ("dqkv",))
        if not same:
            raise SystemExit(f"{name} {label}: two backward launches differ")
        cs.compare_elementwise(f"{name} {label}", gnames, got, want,
                               torch.bfloat16)
        del got, again, want


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--parent", type=Path,
                        help="a checkout whose csrc/ runs as 'parent'")
    parser.add_argument("variants", nargs="*",
                        help=f"the variants to run, of {list(EDITS)} "
                        "(default: all)")
    args = parser.parse_args()
    if set(args.variants) - set(EDITS):
        parser.error(f"variants are {list(EDITS)}")
    if not torch.cuda.is_available():
        raise SystemExit("wide_bf16_variants: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    names = args.variants or list(EDITS)
    variants = {name: variant_dirs(name) for name in names}
    if args.parent:
        base = _build.BUILD_DIR / "variants" / "wide-parent"
        shutil.rmtree(base, ignore_errors=True)
        shutil.copytree(args.parent / "xclip_tpu_torch" / "csrc",
                        base / "csrc")
        variants["parent"] = (base / "csrc", base)
    build_all(variants)
    order = [*names, *reversed(names), *names]
    if args.parent:
        order = ["parent", *order, "parent"]
    shapes = cases()
    for label, case in shapes.items():
        print(f"sdpa bf16 {label}: forward {case[5][0]:.4f} ms, backward "
              f"{case[5][1]:.4f} ms", flush=True)
    for name, dirs in variants.items():
        lib = use(dirs, CALLED if name == "parent" else None)
        if name != "parent":
            print(f"{name}: blocks (warps) an SM at heads of 128: "
                  f"{residency(lib)}", flush=True)
        check(name, shapes)
    times = {}
    for turn, name in enumerate(order):
        use(variants[name], CALLED if name == "parent" else None)
        for label, (fwd, bwd, *_rest) in shapes.items():
            f_ms = cs.cuda_ms(fwd, reps=7, iters=10)
            b_ms = cs.cuda_ms(bwd, reps=7, iters=10)
            dq, dkv = cs.backward_split(bwd)
            times.setdefault((name, label), []).append((f_ms, b_ms, dq, dkv))
            print(f"turn {turn} {name:8s} {label}: forward {f_ms:.4f} ms, "
                  f"backward {b_ms:.4f} ms (dq {dq:.4f}, dk/dv {dkv:.4f} "
                  "device)", flush=True)
    for (name, label), ts in times.items():
        mean = [sum(t[i] for t in ts) / len(ts) for i in range(4)]
        best = [min(t[i] for t in ts) for i in range(4)]
        sdpa = shapes[label][5]
        print(f"mean {name:8s} {label}: forward {mean[0]:.4f} ms "
              f"({mean[0] / sdpa[0]:.2f}x sdpa; best {best[0]:.4f}), "
              f"backward {mean[1]:.4f} ms ({mean[1] / sdpa[1]:.2f}x sdpa; "
              f"best {best[1]:.4f}), dq {mean[2]:.4f}, dk/dv {mean[3]:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
