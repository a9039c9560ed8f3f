#!/usr/bin/env python3
"""The attention megablock's rows at the flagship's text and vision
shapes, on one NVIDIA card.

    python3 tools/megablock_rows.py

Times K-MEGA, K2 (forward, backward) and K3 (forward and recompute
backward, stats and qkv modes) with CUDA events (chip_smoke.cuda_ms),
bf16, 8 x 64 heads, dim 512, at the text tower's (256, 257) with
chip_smoke.texts' caption lengths (4..256, and CLS) and at the vision
tower's (256, 32) in training (32 kept patches, no pads); chip_smoke.py's
phases 2, 6 and 9 hold the kernels to their plain versions. It calls only
wrappers that every checkout since the memory-lean slice has, so it also
times an older checkout: copy it into that checkout's tools/ and run it
there. Needs a card and nvcc; prints the card and its power limit first.
"""

import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from xclip_tpu_torch.kernels import attention_megablock as mega  # noqa: E402


def rows(label, b, n, lengths, maybe_dead, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    args = cs.mega_inputs(g, b, n, 512, 8, torch.bfloat16, lengths)
    static = (8, 64, 64 ** -0.5, False, maybe_dead)
    do = cs.rand(g, b, n, 512, dtype=torch.bfloat16)
    _, stored = mega.attention_block_fwd_stored(*args, *static)
    times = {}
    with torch.no_grad():
        times["K-MEGA"] = cs.cuda_ms(lambda: mega.attention_block(*args,
                                                                  *static))
    times["K2 forward"] = cs.cuda_ms(
        lambda: mega.attention_block_fwd_stored(*args, *static))
    times["K2 backward"] = cs.cuda_ms(
        lambda: mega.attention_block_bwd(*args, do, stored, *static))
    for keep in (False, True):
        mode = "qkv" if keep else "stats"
        _, sm, ln_stats, qkv = mega.attention_block_fwd_stats(*args, *static,
                                                              keep)
        times[f"K3 {mode} forward"] = cs.cuda_ms(
            lambda: mega.attention_block_fwd_stats(*args, *static, keep))
        times[f"K3 {mode} backward"] = cs.cuda_ms(
            lambda: mega.attention_block_bwd_recompute(
                *args, do, sm, ln_stats, *static, qkv=qkv))
    for name, ms in times.items():
        print(f"{label} {name}: {ms:.3f} ms", flush=True)
    del args, do, stored
    torch.cuda.empty_cache()


def main():
    if not torch.cuda.is_available():
        raise SystemExit("megablock_rows: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    lgen = torch.Generator().manual_seed(6)
    lengths = (torch.randint(4, 257, (256,), generator=lgen) + 1).tolist()
    rows("text (256, 257, 512)", 256, 257, lengths, True, 1)
    rows("vision (256, 32, 512)", 256, 32, [32] * 256, False, 2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
