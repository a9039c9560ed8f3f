#!/usr/bin/env python3
"""Time the flagship train step on the stored kernel routes at b = 256,
bf16 (`chip_smoke.py` phase 8's weights, batch and draws), in the checkout
this file sits in, on the card:

    python3 tools/stored_step.py [--rounds R] [--steps N]

Builds the checkout's kernels, runs 3 warm-up steps, then R rounds of N
steps, each round between CUDA events; prints one JSON line: the card
(name and power limit, as nvidia-smi gives them), the checkout, and
pairs/s of each round. It runs unchanged in an older checkout (copy it
into that checkout's tools/), so that two trees can be timed in turns in
one call (parent, change, change, parent). The step is host-bound (idle
share ~0.45-0.50 in phase 8), so compare only runs of one call.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--rounds", type=int, default=5)
    parser.add_argument("--steps", type=int, default=10)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from xclip_tpu_torch import CLIP
    from xclip_tpu_torch.kernels import _build
    from xclip_tpu_torch.train import default_optimizer, make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.library()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    b = 256
    gen = torch.Generator(device="cuda").manual_seed(8)
    text = cs.texts(gen, b)
    images = cs.rand(gen, b, 3, 256, 256, dtype=torch.bfloat16)
    model = CLIP(**cs.FLAGSHIP, **cs.KERNEL_ROUTES,
                 param_dtype=torch.bfloat16, compute_dtype="bfloat16",
                 device="cuda", seed=0)
    step = make_train_step(model, default_optimizer(model.parameters(),
                                                    learning_rate=1e-4))
    i = 0

    def run():
        nonlocal i
        i += 1
        return step(text, images, generator=torch.Generator(
            device="cuda").manual_seed(100 + i))

    for _ in range(3):
        run()
    rates = []
    for _ in range(args.rounds):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.steps):
            run()
        end.record()
        torch.cuda.synchronize()
        rates.append(b * args.steps * 1e3 / start.elapsed_time(end))
    print(json.dumps({"card": card, "checkout": str(ROOT),
                      "pairs_per_s": rates}))


if __name__ == "__main__":
    main()
