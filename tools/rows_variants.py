#!/usr/bin/env python3
"""The LayerNorm-backward and GEGLU-backward row kernels as shipped and
against their alternatives, on one NVIDIA card.

    python3 tools/rows_variants.py

`csrc/row_kernels.cuh` fixes the block (64 rows; kRowThreads threads,
kRowThreadsRecompute in the recompute mode) and the blocks an SM the
registers must allow (kRowMinBlocks); a block keeps rows in flight in
registers, each row's loads issued before the previous row's sums are
reduced. Builds the port's kernels once per variant: as shipped (512
threads in the recompute mode, two row groups at the flagship's inner
width, 256 elsewhere); a two-step and a three-step ring of rows in shared
memory fed by bulk copies in place of the registers (`tools/rows_ring.patch`,
kRowStages steps; rows of whole 16-byte words only); 256 threads in the
recompute mode; 512 in every mode; three blocks an SM. Each variant is an
edited copy of `csrc/` built into its own directory under `build/`. Each is checked against the plain versions
(chip_smoke.py's phase 20 tolerances) at its shapes plus 37 ragged rows,
bf16, then timed (CUDA events) in three turns, the second in reverse
order, on every mode at chip_smoke.py's phase 20 shapes (the recompute
mode at the b = 2048 step's 24,576-row chunk and at 65,792 rows). Needs a
card and nvcc; prints the card and its power limit first, and each
variant's registers a thread (`nvcc -Xptxas -v` on csrc/rows.cu).
"""

import os
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
from xclip_tpu_torch.kernels import attention_megablock as mega  # noqa: E402
from xclip_tpu_torch.kernels import fused_ff_block as ffb  # noqa: E402

SOURCE = "row_kernels.cuh"
RING = Path(__file__).resolve().parent / "rows_ring.patch"
THREADS = "constexpr int kRowThreads = {};"
RECOMPUTE = "constexpr int kRowThreadsRecompute = {};"
STAGES = "constexpr int kRowStages = {};"
BLOCKS = "constexpr int kRowMinBlocks = {};"


def hunks(patch):
    """[(old text, new text)] of each hunk of a unified diff, by content
    (its line numbers ignored)."""
    out, old, new = [], None, None
    for line in patch.read_text().splitlines(keepends=True):
        if line.startswith("@@"):
            if old is not None:
                out.append(("".join(old), "".join(new)))
            old, new = [], []
        elif old is None or line.startswith("\\"):
            continue
        elif line[0] in " -":
            old.append(line[1:])
            if line[0] == " ":
                new.append(line[1:])
        elif line[0] == "+":
            new.append(line[1:])
    if old is not None:
        out.append(("".join(old), "".join(new)))
    return out


# (variant, [(shipped text, its replacement)], applied in order)
EDITS = {
    "shipped": [],
    "ring-2": hunks(RING),
    "ring-3": [*hunks(RING), (STAGES.format(2), STAGES.format(3))],
    "recompute-256": [(RECOMPUTE.format(512), RECOMPUTE.format(256))],
    "all-512": [(THREADS.format(256), THREADS.format(512))],
    "3-blocks": [(BLOCKS.format(1), BLOCKS.format(3))],
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


def registers(variants):
    """{variant: {kernel instance: registers a thread}} of each variant's
    csrc/rows.cu as ptxas reports them (one nvcc a variant, all at once)."""
    procs = {name: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
         os.devnull, str(csrc / "rows.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for name, (csrc, _) in variants.items()}
    out = {}
    for name, proc in procs.items():
        regs, kernel = {}, None
        for line in proc.communicate()[0].splitlines():
            m = re.search(r"entry function '(\S+)'", line)
            if m:
                kernel = re.search(r"(ln_bwd|geglu_bwd)_rows_kernelI(.*?)Li(\d)"
                                   r"ELi(\d)E", m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m and kernel:
                regs[f"{kernel.group(1)} {kernel.group(2)} mode "
                     f"{kernel.group(3)} V {kernel.group(4)}"] = int(m.group(1))
                kernel = None
        out[name] = regs
    return out


def use(dirs):
    _build.CSRC, _build.BUILD_DIR = dirs
    _build.library.cache_clear()
    _build.library()


def main():
    if not torch.cuda.is_available():
        raise SystemExit("rows_variants: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    variants = {name: variant_dirs(name) for name in EDITS}
    for name, regs in registers(variants).items():
        print(f"registers {name}: " + ", ".join(
            f"{k} {v}" for k, v in sorted(regs.items()) if k.endswith("V 1")),
              flush=True)
    dt = torch.bfloat16
    step_rows = {"ff_bwd": (lambda s: s[1] - s[0])(
                     ffb.bwd_recompute_spans(2048 * 257, 512, 2048, dt)[0]),
                 "mega_bwd": (lambda s: (s[1] - s[0]) * 257)(
                     mega.bwd_recompute_spans(2048, 257, 512, 8, dt,
                                              False)[0])}
    gen = torch.Generator(device="cuda").manual_seed(20)
    checks, timed = [], []
    for key, _, kernel, mode, _, shapes in cs.ROW_KERNELS:
        for form, rows, d in shapes:
            rows = step_rows[form] if rows == "R" else rows
            for extra, into in ((37, checks), (0, timed)):
                args, kw = cs.row_inputs(gen, kernel, mode, form, rows + extra,
                                         d, dt)
                into.append((f"{key} ({rows + extra} x {d}, {form})", kernel,
                             mode, args, kw))
    for name, dirs in variants.items():
        use(dirs)
        for tag, kernel, mode, args, kw in checks:
            got = cs.run_rows(kernel, args, kw)
            want = cs.run_rows(kernel, args, kw, plain=True)
            trio = [(n, g, w) for n, g, w in zip(
                cs.ROW_OUTPUTS[(kernel, mode)], got, want) if w is not None]
            cs.compare_products(f"{name} {tag}", *(
                [t[j] for t in trio] for j in (1, 2, 0)))
            del got, want, trio
        torch.cuda.empty_cache()
    del checks
    torch.cuda.empty_cache()
    times = {}
    for turn, name in enumerate(ORDER):
        use(variants[name])
        for tag, kernel, mode, args, kw in timed:
            ms = cs.cuda_ms(lambda: cs.run_rows(kernel, args, kw), reps=7,
                            iters=5)
            times.setdefault((name, tag), []).append(ms)
            print(f"turn {turn} {name:20s} {tag}: {ms:.4f} ms", flush=True)
    for (name, tag), ts in times.items():
        print(f"mean {name:20s} {tag}: {sum(ts) / len(ts):.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
