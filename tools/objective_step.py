#!/usr/bin/env python3
"""Phase 23's full-objective step alone, on the stored and the
memory-lean routes, with the device time of its fp32 kernels, on one
NVIDIA card.

    python3 tools/objective_step.py

The reference README's full configuration (chip_smoke.OBJECTIVE_FLAGS:
MLM, SimSiam, DCL, the extra heads, sim-reg, K5) on the flagship at
b = 256, bf16, with chip_smoke's phase 23 inputs: 2 warm-up and 5 timed
steps a route (pairs/s from CUDA events), then three profiled steps, each
after one that warms the profiler up: the median device busy ms and idle
share, and the device ms of the fp32 product kernel and of the fp32
attention core (csrc/attention_core.cuh) by kernel name. The SimSiam
passes take fp32 views (JAX's default_augment), so their products run on
the fp32 kernel. Runs unchanged in an older checkout (copy it into that
checkout's tools/), whose fp32 kernels may carry older names (both are
matched): to compare two commits on one card, run it in each, in the order parent,
change, change, parent. Prints the card and its power limit first.
"""

import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402

# the fp32 kernels by the names the profiler gives them; mm_fma_kernel is
# the fp32 product kernel of checkouts before csrc/gemm_f32.cu,
# attention_fma_kernel the fp32 core's forward before attention_fwd_kernel
FP32_KERNELS = {"fp32 products": ("gemm_f32_kernel", "mm_fma_kernel"),
                "fp32 attention core": ("attention_fwd_kernel",
                                        "attention_fma_kernel",
                                        "attention_bwd_dq_kernel",
                                        "attention_bwd_dkv_kernel")}


def main(b=256, warm=2, timed=5, profiles=3):
    if not torch.cuda.is_available():
        raise SystemExit("objective_step: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    from xclip_tpu_torch import CLIP
    from xclip_tpu_torch.objectives.augment import default_augment
    from xclip_tpu_torch.train import default_optimizer, make_train_step
    gen = cs.step_gen(23)
    text, aug_text = cs.texts(gen, b), cs.texts(gen, b)
    images = cs.rand(gen, b, 3, 256, 256, dtype=torch.bfloat16)
    aug_images = default_augment(images, 256, generator=gen).bfloat16()
    for label, routes in (("stored", cs.STORED_BOTH),
                          ("lean", cs.LEAN_BOTH)):
        model = CLIP(**{**cs.FLAGSHIP, **cs.OBJECTIVE_FLAGS}, **routes,
                     param_dtype=torch.bfloat16, compute_dtype="bfloat16",
                     device="cuda", seed=0)
        step = make_train_step(model, default_optimizer(model.parameters(),
                                                        learning_rate=1e-4))

        def run(i):
            return step(text, images, generator=cs.step_gen(100 + i),
                        aug_text=aug_text, aug_image=aug_images)

        ms, _, peak, losses = cs.timed_steps(run, warm, timed, {})
        if not torch.isfinite(losses).all():
            raise SystemExit(f"objective_step: {label}: a loss is not "
                             f"finite: {losses.tolist()}")
        samples = []
        for p in range(profiles):
            (idle, busy, _), (total, rows) = cs.profile_step(
                run, warm + timed + 2 * p)
            kinds = {kind: sum(t for t, _, name in rows
                               if any(k in name for k in names))
                     for kind, names in FP32_KERNELS.items()}
            samples.append((idle, busy, kinds))
        idle = statistics.median(s[0] for s in samples)
        busy = statistics.median(s[1] for s in samples)
        kinds = {kind: statistics.median(s[2][kind] for s in samples)
                 for kind in FP32_KERNELS}
        print(f"{label}: {b * 1e3 / ms:.1f} pairs/s ({ms:.2f} ms per step), "
              f"peak {peak:.2f} GiB, device busy {busy:.2f} ms, idle share "
              f"{idle:.4f} (medians of {profiles} profiled steps), "
              + ", ".join(f"{kind} {t:.2f} ms" for kind, t in kinds.items())
              + ", losses " + " ".join(f"{x:.4f}" for x in losses.tolist()),
              flush=True)
        del model, step
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
