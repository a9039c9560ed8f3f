#!/usr/bin/env python3
"""The dk/dv kernel's register layout, as shipped and against its
alternatives, on one NVIDIA card.

    python3 tools/mega_core_variants.py

`csrc/attention_block_sm90.cuh`'s dk/dv kernel runs three blocks an SM
(launch bounds `(K6_THREADS, 3)`, 168 registers) and, to stay within them,
passes its A operands one 16-wide depth slice at a time and feeds p and ds
into the dv and dk products 16 queries at a time. Builds the port's
kernels three times: as shipped; with whole 64-wide operands (the layout
before, which `ptxas -v` shows spilling in the megablock's mode); and at
two blocks an SM. Each variant is an edited copy of `csrc/` built into its
own directory under `build/`. Each is checked against the plain versions
under chip_smoke.py's phase 12 tolerances, then timed (CUDA events) in
turns (A B C C B A A B C): the megablock's attention core backward at
(256, 257, 8 x 64) with the text tower's key pads and with full-length
captions, and K6's backward at (256, 256, 8 x 64) causal with key pads
uniform in 1..n (phase 12's shape). Needs a card and nvcc; prints the
card and its power limit first.
"""

import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from xclip_tpu_torch.kernels import _build  # noqa: E402
from xclip_tpu_torch.kernels import attention_block as core  # noqa: E402
from xclip_tpu_torch.kernels import attention_megablock as mega  # noqa: E402

SOURCE = "attention_block_sm90.cuh"
SLICED_PRODUCTS = """#pragma unroll
        for (int k = 0; k < 4; ++k) {
          uint32_t a[4];
          load_a_k(a, ks, warp * 16, k);
          mma_abt_k(s, a, k, qt);  // sᵀ = k . qᵀ
          load_a_k(a, vs, warp * 16, k);
          mma_abt_k(dp, a, k, dot);  // dpᵀ = v . doᵀ
        }
"""
WHOLE_PRODUCTS = """        {
          uint32_t a[4][4];
          load_a(a, ks, warp * 16);
          mma_abt(s, a, qt);
          load_a(a, vs, warp * 16);
          mma_abt(dp, a, dot);
        }
"""
SLICED_HEAD = """#pragma unroll
        for (int k = 0; k < 4; ++k) {
#pragma unroll
          for (int c = 2 * k; c < 2 * k + 2; ++c)"""
WHOLE_HEAD = """        {
#pragma unroll
          for (int c = 0; c < 8; ++c)"""
SLICED_TAIL = """          uint32_t a[4];
          pack_a_k(a, s, k);  // dv += T(p)ᵀ . do
          mma_ab_k(dv, a, k, MEGA ? dov + buf * K6_TILE : dot);
          pack_a_k(a, dp, k);  // dk += T(ds)ᵀ . q
          mma_ab_k(dk, a, k, qt);
        }
"""
WHOLE_TAIL = """        }
        uint32_t a[4][4];
        pack_a(a, s);
        mma_ab(dv, a, MEGA ? dov + buf * K6_TILE : dot);
        pack_a(a, dp);
        mma_ab(dk, a, qt);
"""
DKV = "__launch_bounds__(K6_THREADS, {})\nk6_bwd_dkv_kernel("
# (variant, [(shipped text, its replacement, occurrences)])
EDITS = {
    "shipped": [],
    "whole-operands": [(SLICED_PRODUCTS, WHOLE_PRODUCTS, 1),
                       (SLICED_HEAD, WHOLE_HEAD, 1),
                       (SLICED_TAIL, WHOLE_TAIL, 1)],
    "two-blocks": [(DKV.format(3), DKV.format(2), 1)],
}
ORDER = ["shipped", "whole-operands", "two-blocks", "two-blocks",
         "whole-operands", "shipped", "shipped", "whole-operands",
         "two-blocks"]
SCALE = 64 ** -0.5


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


def use(dirs):
    _build.CSRC, _build.BUILD_DIR = dirs
    _build.library.cache_clear()
    _build.library()


def mega_inputs(lengths, seed):
    """qkv, mask, fp32 dattn and the plain forward's (attnout, sm) at
    (256, 257, 8 x 64)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = cs.rand(g, 256, 257, 3 * 512, dtype=torch.bfloat16)
    mask = cs.key_mask(lengths, 257)
    dattn = cs.rand(g, 256, 257, 512)
    static = (8, 64, SCALE, False, True)
    return qkv, mask, dattn, mega.mega_core_fwd_plain(qkv, mask, *static)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("mega_core_variants: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    variants = {name: variant_dirs(name) for name in EDITS}
    lgen = torch.Generator().manual_seed(6)
    pads = (torch.randint(4, 257, (256,), generator=lgen) + 1).tolist()
    mstatic = (8, 64, SCALE, False, True)
    cases = {"megablock text key-pad": mega_inputs(pads, 6),
             "megablock text full-length": mega_inputs([257] * 256, 7)}
    g = torch.Generator(device="cuda").manual_seed(12)
    k6_lengths = torch.randint(1, 257, (256,), generator=g,
                               device="cuda").tolist()
    k6_mask = cs.key_mask(k6_lengths, 256)
    k6_qkv = cs.rand(g, 256, 256, 3 * 512, dtype=torch.bfloat16)
    k6_do = cs.rand(g, 256, 256, 512, dtype=torch.bfloat16)
    kstatic = (8, 64, 0.125, True, True)
    k6_out, k6_lse = core.attention_core_fwd_plain(k6_qkv, k6_mask, *kstatic)

    def run(case):
        if case == "K6 (256, 256) causal key-pad":
            return core.attention_core_bwd(k6_qkv, k6_mask, k6_out, k6_lse,
                                           k6_do, *kstatic)
        qkv, mask, dattn, fwd = cases[case]
        return mega.mega_core_bwd(qkv, mask, dattn, *fwd, *mstatic)

    def plain(case):
        if case == "K6 (256, 256) causal key-pad":
            return core.attention_core_bwd_plain(k6_qkv, k6_mask, k6_out,
                                                 k6_lse, k6_do, *kstatic)
        qkv, mask, dattn, fwd = cases[case]
        return mega.mega_core_bwd_plain(qkv, mask, dattn, *fwd, *mstatic)

    names = [*cases, "K6 (256, 256) causal key-pad"]
    for name, dirs in variants.items():
        use(dirs)
        for case in names:
            cs.compare_elementwise(f"{name} {case}", ("dqkv",), (run(case),),
                                   (plain(case),), torch.bfloat16)
    times = {}
    for turn, name in enumerate(ORDER):
        use(variants[name])
        for case in names:
            ms = cs.cuda_ms(lambda: run(case), reps=7, iters=10)
            times.setdefault((name, case), []).append(ms)
            print(f"turn {turn} {name:13s} {case}: backward {ms:.4f} ms",
                  flush=True)
    for (name, case), ts in times.items():
        print(f"mean {name:13s} {case}: backward "
              f"{sum(ts) / len(ts):.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
