#!/usr/bin/env python3
"""The FF recompute backward kernel by kernel, its ordered dg sums among
them, on one NVIDIA card.

    python3 tools/ff_bwd_sums.py

Profiles (torch.profiler) `ff_block_bwd_recompute` on one row chunk of
the b = 2048 step's text tower (24,576 rows) and on 8,192 rows, bf16, dim
512, inner 2048, and prints one call's device kernels in launch order,
each with its median time over five calls. Then, for the two dg sums (the
`reduce_parts*` kernel launch after the GEGLU backward rows, which sums
their 64-row partials of inner width, and the one after the LayerNorm
backward rows, of dim width), the time per partial. At 8,192 rows the
row kernels' 128 blocks run in one wave; at 24,576 rows their 384 blocks
take more than one wave when a block fills an SM. It calls only wrappers
that every checkout since the memory-lean slice has, so it also times an
older checkout: copy it into that checkout's tools/ and run it there.
Needs a card and nvcc; prints the card and its power limit first.
"""

import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from xclip_tpu_torch.kernels import fused_ff_block as ffb  # noqa: E402

CALLS = 5
DIM, INNER = 512, 2048


def short(name):
    """A kernel's name without its return type and namespaces, its
    template arguments cut to 40 characters."""
    name = re.sub(r"^void ", "", name)
    name = re.sub(r"\(anonymous namespace\)::|xclip::", "", name)
    base, _, rest = name.partition("<")
    return base + (f"<{rest[:40]}" if rest else "")


def sequence(rows, seed):
    """[(kernel name, median µs)] of one ff_block_bwd_recompute call on
    `rows` rows, in launch order."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    args = cs.ff_inputs(gen, rows, torch.bfloat16, DIM, INNER)
    _, stats = ffb.ff_block_fwd_stats(*args)
    do = cs.rand(gen, rows, DIM, dtype=torch.bfloat16)
    for _ in range(3):
        ffb.ff_block_bwd_recompute(*args, do, stats)
    torch.cuda.synchronize()
    for _ in range(2):  # the first profile only warms the profiler up
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(CALLS):
                ffb.ff_block_bwd_recompute(*args, do, stats)
            torch.cuda.synchronize()
    events = sorted(cs.device_events(prof), key=lambda e: e.time_range.start)
    per = len(events) // CALLS
    if per * CALLS != len(events):
        raise SystemExit(f"{len(events)} device events in {CALLS} calls")
    out = []
    for i in range(per):
        calls = events[i::per]
        names = {e.name for e in calls}
        if len(names) != 1:
            raise SystemExit(f"kernel {i} differs between calls: {names}")
        out.append((calls[0].name, statistics.median(
            e.time_range.end - e.time_range.start for e in calls)))
    del args, stats, do
    torch.cuda.empty_cache()
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("ff_bwd_sums: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    for rows, seed in ((24_576, 1), (8_192, 2)):
        seq = sequence(rows, seed)
        parts = -(-rows // 64)
        print(f"{rows} rows: {sum(t for _, t in seq):.1f} us in "
              f"{len(seq)} kernels", flush=True)
        for i, (name, us) in enumerate(seq):
            print(f"  {i:2d} {us:9.2f} us  {short(name)}", flush=True)
        for i in range(1, len(seq)):
            name, us = seq[i]
            before = seq[i - 1][0]
            if "reduce_parts" not in name:
                continue
            for rows_kernel, width in (("geglu_bwd_rows", INNER),
                                       ("ln_bwd_rows", DIM)):
                if rows_kernel in before:
                    print(f"{rows} rows: dg sum after {rows_kernel} "
                          f"({parts} partials x {width}): {us:.2f} us, "
                          f"{1e3 * us / parts:.1f} ns a partial",
                          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
