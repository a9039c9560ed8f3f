#!/usr/bin/env python3
"""The bf16 product kernel's ring depth, staging buffer and tile width, as
shipped and against its alternatives, on one NVIDIA card.

    python3 tools/gemm_variants.py

`csrc/gemm_sm90.cuh` fixes the kernel's tile (128 rows by kGemmBN
columns) and, within the 227 KB of shared memory a block can have, its
ring of kGemmStages 64-deep k slices (48 KB each at 256 columns) and each
consumer warpgroup's epilogue staging buffer of kGemmStagingPanels 8 KB
panels. Builds the port's kernels three times: as shipped (4 stages, 16
KB staging); 3 stages and 32 KB staging (half the epilogue rounds, a
shallower ring); and 128-wide tiles (4 stages of 32 KB, 16 KB staging).
Each variant is an edited copy of `csrc/` built into its own directory
under `build/`. Each is checked against `matmul.mm_plain` for every class
at a ragged row count (chip_smoke.py's phase 19 tolerances), then timed
(CUDA events) in turns (A B C C B A A B C) on the b = 2048 step's product
classes at 65,792 rows. Needs a card and nvcc; prints the card and its
power limit first.
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
from xclip_tpu_torch.kernels import matmul  # noqa: E402

SOURCE = "gemm_sm90.cuh"
STAGES = "constexpr int kGemmStages = {};"
PANELS = "constexpr int kGemmStagingPanels = {};"
WIDTH = "constexpr int kGemmBN = {};"
# (variant, [(shipped text, its replacement)])
EDITS = {
    "shipped": [],
    "3-stages-32KB": [(STAGES.format(4), STAGES.format(3)),
                      (PANELS.format(2), PANELS.format(4))],
    "128-wide": [(WIDTH.format(256), WIDTH.format(128))],
}
ORDER = [*EDITS, *reversed(EDITS), *EDITS]


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
    for old, new in EDITS[name]:
        if text.count(old) != 1:
            raise SystemExit(f"{name}: expected one {old!r} in {SOURCE}")
        text = text.replace(old, new)
    f.write_text(text)
    return csrc, base


def use(dirs):
    _build.CSRC, _build.BUILD_DIR = dirs
    _build.library.cache_clear()
    _build.library()


def main():
    if not torch.cuda.is_available():
        raise SystemExit("gemm_variants: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    variants = {name: variant_dirs(name) for name in EDITS}
    gen = torch.Generator(device="cuda").manual_seed(19)
    checks = [cs.product_operands(gen, cls, 65_792 + 37)
              for cls in cs.PRODUCT_CLASSES]
    timed = [cs.product_operands(gen, cls, 65_792)
             for cls in cs.PRODUCT_CLASSES]
    for name, dirs in variants.items():
        use(dirs)
        for ops in checks:
            cs.compare_products(f"{name} {ops['tag']}",
                                cs.as_tuple(cs.run_mm(ops)),
                                cs.as_tuple(cs.run_mm(ops, plain=True)),
                                ops["names"])
    times = {}
    for turn, name in enumerate(ORDER):
        use(variants[name])
        for ops in timed:
            ms = cs.cuda_ms(lambda: cs.run_mm(ops), reps=7, iters=5)
            times.setdefault((name, ops["tag"]), []).append(ms)
            print(f"turn {turn} {name:14s} {ops['tag']}: {ms:.4f} ms",
                  flush=True)
    for (name, tag), ts in times.items():
        print(f"mean {name:14s} {tag}: {sum(ts) / len(ts):.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
