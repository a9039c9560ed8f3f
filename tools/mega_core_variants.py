#!/usr/bin/env python3
"""The bf16 attention core's design choices, as shipped and against their
alternatives, on one NVIDIA card.

    python3 tools/mega_core_variants.py [--parent DIR]

`csrc/attention_block_sm90.cuh` runs the megablock's attention core and K6.
Its forward takes two passes over the key tiles; e^x is 2^(x log2 e) on
ex2.approx and p / l is p times a reciprocal taken once a row or tile
column, in the forward and the backward; the dk/dv kernel runs three
blocks an SM and passes its A operands and p, ds one 16-wide slice at a
time. Builds the port's kernels as shipped and with each alternative: a
forward that holds a block's fp32 score rows whole in registers up to 320
keys, one q . kᵀ and one exp a score (`tools/held_rows.patch`, one
instance per tile count); the same with the held scores in shared memory
(one column of floats a thread); expf and the division; the dk/dv kernel
with whole 64-wide operands; and at two blocks an SM. Each variant is an
edited copy of `csrc/` built into its own directory under `build/`. Each
is checked against the plain versions under chip_smoke.py's phase 12 rule
(forward outputs and dqkv; two backward launches bit for bit equal), then
timed (CUDA events) in turns (the variants in order, reversed, in order)
at four shapes: the megablock's core at (256, 257, 8 x 64) with the text
tower's key pads and with full-length captions, at the vision tower's
(256, 32), and K6 at (256, 256, 8 x 64) causal with key pads uniform in
1..n (phase 12's shape). With `--parent DIR` (a checkout of another
commit) its `xclip_tpu_torch/csrc/` is built and timed beside them as the
variant "parent", bound to the entry points the timed wrappers call. Needs
a card and nvcc; prints the card and its power limit first.

The "held-rows" and "held-smem" variants apply `tools/held_rows.patch`,
written against the sources as they stood before the kernels took
heads of 128 (one 64-column tile a head): on today's sources the
tool stops there, naming the hunk it cannot find.
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

SOURCE = "attention_block_sm90.cuh"
HELD = [(old, new, 1) for old, new in
        hunks(Path(__file__).resolve().parent / "held_rows.patch")]
SLICED_PRODUCTS = """#pragma unroll
          for (int hh = 0; hh < NH; ++hh)
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const int o = hh * K6_TILE;
              uint32_t a[4];
              load_a_k(a, ks + o, warp * 16, k);
              mma_abt_k(s, a, k, qt + o, ncut);  // sᵀ = k . qᵀ
              load_a_k(a, vs + o, warp * 16, k);
              mma_abt_k(dp, a, k, dot + o, ncut);  // dpᵀ = v . doᵀ
            }
"""
WHOLE_PRODUCTS = """#pragma unroll
          for (int hh = 0; hh < NH; ++hh) {
            const int o = hh * K6_TILE;
            uint32_t a[4][4];
            load_a(a, ks + o, warp * 16);
            mma_abt(s, a, qt + o, ncut);
            load_a(a, vs + o, warp * 16);
            mma_abt(dp, a, dot + o, ncut);
          }
"""
SLICED_HEAD = """#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (k >= ns) break;
#pragma unroll
          for (int c = 2 * k; c < 2 * k + 2; ++c)"""
WHOLE_HEAD = """        {
#pragma unroll
          for (int c = 0; c < 8; ++c)"""
SLICED_TAIL = """          uint32_t a[4];
          pack_a_k(a, s, k);  // dv += T(p)ᵀ . do
#pragma unroll
          for (int hh = 0; hh < NH; ++hh)
            mma_ab_k(dv[hh], a, k,
                     (MEGA ? dov + buf * T : dot) + hh * K6_TILE);
          pack_a_k(a, dp, k);  // dk += T(ds)ᵀ . q
#pragma unroll
          for (int hh = 0; hh < NH; ++hh)
            mma_ab_k(dk[hh], a, k, qt + hh * K6_TILE);
        }
"""
WHOLE_TAIL = """        }
        uint32_t a[4][4];
        pack_a(a, s);
#pragma unroll
        for (int hh = 0; hh < NH; ++hh)
          mma_ab(dv[hh], a, (MEGA ? dov + buf * T : dot) + hh * K6_TILE, ns);
        pack_a(a, dp);
#pragma unroll
        for (int hh = 0; hh < NH; ++hh)
          mma_ab(dk[hh], a, qt + hh * K6_TILE, ns);
"""
DKV = "__launch_bounds__(K6_THREADS, NH == 1 ? {} : 2)\nk6_bwd_dkv_kernel("
# the held scores in shared memory: a column of T * 32 floats a thread
# after the mask words, and as many blocks an SM as shared memory holds
HELD_REGS = """struct K6Held {
  float v[T][8][4];
  __device__ __forceinline__ float& operator()(int t, int c, int e) {
    return v[t][c][e];
  }
};"""
HELD_SMEM = """struct K6Held {
  float* col;
  __device__ __forceinline__ float& operator()(int t, int c, int e) {
    return col[((t * 8 + c) * 4 + e) * K6_THREADS];
  }
};"""
HELD_DECL = "  K6Held<T> held;"
HELD_SMEM_DECL = ("  K6Held<T> held{reinterpret_cast<float*>(bits + "
                  "K6_HELD_TILES) + threadIdx.x};")
HELD_BYTES = "K6_TILE * sizeof(bf16) + K6_HELD_TILES * 8;"
HELD_SMEM_BYTES = ("K6_TILE * sizeof(bf16) + K6_HELD_TILES * 8 +\n"
                   "         tiles * 32 * K6_THREADS * sizeof(float);")
HELD_BLOCKS = "  return tiles <= 2 ? 4 : tiles == 3 ? 3 : 2;"
HELD_SMEM_BLOCKS = ("  return 232448 / k6_held_smem(tiles) > 4 ? 4\n"
                    "         : 232448 / k6_held_smem(tiles) < 1 ? 1\n"
                    "         : (int)(232448 / k6_held_smem(tiles));")
EX2 = """  asm("ex2.approx.ftz.f32 %0, %1;"
      : "=f"(y)
      : "f"(fmaf(x, K6_LOG2E, -m * K6_LOG2E)));
"""
# (variant, [(shipped text, its replacement, occurrences)])
EDITS = {
    "shipped": [],
    "held-rows": HELD,
    "held-smem": [*HELD, (HELD_REGS, HELD_SMEM, 1),
                  (HELD_DECL, HELD_SMEM_DECL, 1),
                  (HELD_BYTES, HELD_SMEM_BYTES, 1),
                  (HELD_BLOCKS, HELD_SMEM_BLOCKS, 1)],
    "expf-div": [(EX2, "  y = expf(x - m);\n", 1),
                 ("  return p * linv;", "  return p / l;", 1)],
    "dkv-whole": [(SLICED_PRODUCTS, WHOLE_PRODUCTS, 1),
                  (SLICED_HEAD, WHOLE_HEAD, 1),
                  (SLICED_TAIL, WHOLE_TAIL, 1)],
    "dkv-two-blocks": [(DKV.format(3), DKV.format(2), 1)],
}
ORDER = [*EDITS, *reversed(EDITS), *EDITS]
SCALE = 64 ** -0.5
K6_CASE = "K6 (256, 256) causal key-pad"


def variant_dirs(name):
    """(csrc, build directory) of a variant: the shipped sources, or an
    edited copy of them."""
    if not EDITS[name]:
        return _build.CSRC, _build.BUILD_DIR
    base = _build.BUILD_DIR / "variants" / name
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


SIGNATURES = _build._SIGNATURES
# the entry points the timed wrappers call: all an older checkout's library
# must have
CALLED = ("xclip_mega_core_fwd", "xclip_mega_core_bwd",
          "xclip_attention_core_fwd", "xclip_attention_core_bwd",
          "xclip_attention_block_max_n", "xclip_attention_block_bwd_max_n")


def use(dirs, entries=None):
    """Load a variant's library, binding `entries` (every entry point if
    None) from a table of its own."""
    _build.CSRC, _build.BUILD_DIR = dirs
    _build._SIGNATURES = {name: SIGNATURES[name]
                          for name in (entries or SIGNATURES)}
    _build.library.cache_clear()
    _build.library()


def mega_inputs(b, n, lengths, maybe_dead, seed):
    """qkv, mask, fp32 dattn, the static arguments and the plain forward's
    (attnout, sm) of the megablock's core at (b, n, 8 x 64)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = cs.rand(g, b, n, 3 * 512, dtype=torch.bfloat16)
    mask = cs.key_mask(lengths, n)
    dattn = cs.rand(g, b, n, 512)
    static = (8, 64, SCALE, False, maybe_dead)
    return qkv, mask, dattn, static, mega.mega_core_fwd_plain(qkv, mask,
                                                              *static)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--parent", type=Path,
                        help="a checkout whose csrc/ runs as 'parent'")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("mega_core_variants: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    variants = {name: variant_dirs(name) for name in EDITS}
    order = ORDER
    if args.parent:
        base = _build.BUILD_DIR / "variants" / "parent"
        shutil.rmtree(base, ignore_errors=True)
        shutil.copytree(args.parent / "xclip_tpu_torch" / "csrc",
                        base / "csrc")
        variants["parent"] = (base / "csrc", base)
        order = ["parent", *ORDER, "parent"]
    lgen = torch.Generator().manual_seed(6)
    pads = (torch.randint(4, 257, (256,), generator=lgen) + 1).tolist()
    cases = {
        "megablock (256, 257) key-pad": mega_inputs(256, 257, pads, True, 6),
        "megablock (256, 257) full-length": mega_inputs(256, 257, [257] * 256,
                                                        True, 7),
        "megablock (256, 32) vision": mega_inputs(256, 32, [32] * 256, False,
                                                  9)}
    g = torch.Generator(device="cuda").manual_seed(12)
    k6_lengths = torch.randint(1, 257, (256,), generator=g,
                               device="cuda").tolist()
    k6_mask = cs.key_mask(k6_lengths, 256)
    k6_qkv = cs.rand(g, 256, 256, 3 * 512, dtype=torch.bfloat16)
    k6_do = cs.rand(g, 256, 256, 512, dtype=torch.bfloat16)
    kstatic = (8, 64, 0.125, True, True)
    k6_fwd = core.attention_core_fwd_plain(k6_qkv, k6_mask, *kstatic)

    def fwd(case, plain=False):
        if case == K6_CASE:
            fn = (core.attention_core_fwd_plain if plain
                  else core.attention_core_fwd)
            return fn(k6_qkv, k6_mask, *kstatic)
        qkv, mask, _, static, _ = cases[case]
        fn = mega.mega_core_fwd_plain if plain else mega.mega_core_fwd
        return fn(qkv, mask, *static)

    def bwd(case, plain=False):
        if case == K6_CASE:
            fn = (core.attention_core_bwd_plain if plain
                  else core.attention_core_bwd)
            return fn(k6_qkv, k6_mask, *k6_fwd, k6_do, *kstatic)
        qkv, mask, dattn, static, want = cases[case]
        fn = mega.mega_core_bwd_plain if plain else mega.mega_core_bwd
        return fn(qkv, mask, dattn, *want, *static)

    names = [*cases, K6_CASE]
    for name, dirs in variants.items():
        use(dirs, CALLED if name == "parent" else None)
        for case in names:
            outs = ("out", "lse") if case == K6_CASE else ("attnout", "sm")
            cs.compare_elementwise(f"{name} {case}", outs, fwd(case),
                                   fwd(case, plain=True), torch.bfloat16)
            got = bwd(case)
            if not torch.equal(got, bwd(case)):
                raise SystemExit(f"{name} {case}: two backward launches "
                                 "differ")
            cs.compare_elementwise(f"{name} {case}", ("dqkv",), (got,),
                                   (bwd(case, plain=True),), torch.bfloat16)
            del got
    times = {}
    for turn, name in enumerate(order):
        use(variants[name], CALLED if name == "parent" else None)
        for case in names:
            f_ms = cs.cuda_ms(lambda: fwd(case), reps=7, iters=10)
            b_ms = cs.cuda_ms(lambda: bwd(case), reps=7, iters=10)
            times.setdefault((name, case), []).append((f_ms, b_ms))
            print(f"turn {turn} {name:14s} {case}: forward {f_ms:.4f} ms, "
                  f"backward {b_ms:.4f} ms", flush=True)
    for (name, case), ts in times.items():
        print(f"mean {name:14s} {case}: forward "
              f"{sum(t[0] for t in ts) / len(ts):.4f} ms, backward "
              f"{sum(t[1] for t in ts) / len(ts):.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
