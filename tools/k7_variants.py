#!/usr/bin/env python3
"""K7's bf16 design choices against their alternatives, on one NVIDIA card.

    python3 tools/k7_variants.py

Builds the port's kernels three times: as shipped
(`xclip_tpu_torch/csrc/flash_attention_sm90.cuh`: under causal the forward
and dq take a row's query tiles last first, the heaviest first; e^x is
taken as 2^(x log2 e)), with the query tiles first first, and with expf.
Each variant is an edited copy of `csrc/` built into its own directory
under `build/`. Each is checked against the plain versions under
chip_smoke.py's phase 12 tolerances, then K7 forward and backward are
timed (CUDA events) at the text tower's shape (b·h 2048, n 256) and at
(2, 8, 8192), causal, key pads uniform in n/2..n, in turns (A B C C B A A
B C), and one shipped forward and backward are profiled into their three
kernels. Needs a card and nvcc; prints the card and its power limit
first.
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
from xclip_tpu_torch.kernels import flash_attention as flash  # noqa: E402

SOURCE = "flash_attention_sm90.cuh"
# (variant, [(shipped text, its replacement, occurrences)])
EDITS = {
    "shipped": [],
    "first-first": [("const K7Block blk(tiles, causal);",
                     "const K7Block blk(tiles, false);", 2)],
    "expf": [("return exp2f(x * 1.4426950408889634f);",
              "return expf(x);", 1)],
}
ORDER = ["shipped", "first-first", "expf", "expf", "first-first", "shipped",
         "shipped", "first-first", "expf"]


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


def inputs(b, h, n, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    lengths = torch.randint(n // 2, n + 1, (b,), generator=g,
                            device="cuda").tolist()
    q, k, v, do = (cs.rand(g, b, h, n, 64, dtype=torch.bfloat16)
                   for _ in range(4))
    q = (q.float() * 0.125).to(torch.bfloat16)
    return flash.pad_flat((q, k, v, do), cs.key_mask(lengths, n))


def main():
    if not torch.cuda.is_available():
        raise SystemExit("k7_variants: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    variants = {name: variant_dirs(name) for name in EDITS}
    shapes = {"text (256, 8, 256)": inputs(256, 8, 256, 1),
              "long (2, 8, 8192)": inputs(2, 8, 8192, 2)}
    for name, dirs in variants.items():
        use(dirs)
        for sname, (flat, mask) in shapes.items():
            out, lse = flash.flash_attention_fwd_plain(*flat[:3], mask, True)
            want = (out, lse, *flash.flash_attention_bwd_plain(
                *flat[:3], mask, out, lse, flat[3], True))
            got = (*flash.flash_attention_fwd(*flat[:3], mask, True),
                   *flash.flash_attention_bwd(*flat[:3], mask, out, lse,
                                              flat[3], True))
            cs.compare_elementwise(f"{name} {sname}",
                                   ("out", "lse", "dq", "dk", "dv"), got,
                                   want, torch.bfloat16)
            del want, got
    times = {}
    for turn, name in enumerate(ORDER):
        use(variants[name])
        for sname, (flat, mask) in shapes.items():
            out, lse = flash.flash_attention_fwd(*flat[:3], mask, True)
            fwd = cs.cuda_ms(lambda: flash.flash_attention_fwd(
                *flat[:3], mask, True), reps=7, iters=10)
            bwd = cs.cuda_ms(lambda: flash.flash_attention_bwd(
                *flat[:3], mask, out, lse, flat[3], True), reps=7, iters=10)
            times.setdefault((name, sname), []).append((fwd, bwd))
            print(f"turn {turn} {name:11s} {sname}: forward {fwd:.4f} ms, "
                  f"backward {bwd:.4f} ms", flush=True)
    for (name, sname), ts in times.items():
        print(f"mean {name:11s} {sname}: forward "
              f"{sum(t[0] for t in ts) / len(ts):.4f} ms, backward "
              f"{sum(t[1] for t in ts) / len(ts):.4f} ms")

    from torch.profiler import ProfilerActivity, profile
    use(variants["shipped"])
    for sname, (flat, mask) in shapes.items():
        out, lse = flash.flash_attention_fwd(*flat[:3], mask, True)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                flash.flash_attention_fwd(*flat[:3], mask, True)
                flash.flash_attention_bwd(*flat[:3], mask, out, lse, flat[3],
                                          True)
            torch.cuda.synchronize()
        for ev in prof.key_averages():
            if "k7_" in ev.key and ev.device_time_total:
                name = ev.key.split("::")[-1].split("(")[0]
                print(f"profile shipped {sname}: {name} "
                      f"{ev.device_time_total / ev.count / 1e3:.4f} ms a "
                      f"launch ({ev.count} launches)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
