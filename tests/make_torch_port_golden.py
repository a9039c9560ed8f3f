"""Write `tests/data/torch_port_golden.npz`: the JAX package's outputs for a
tiny CLIP on numpy-seeded weights, for the PyTorch port to be held to on a
machine without JAX (`tests/test_torch_golden.py` on the CPU, phase 3 of
`chip_smoke.py` on the GPU).

    JAX_PLATFORMS=cpu python tests/make_torch_port_golden.py

The file holds the config, the weight seed, the inputs and the outputs
(scores, latents, the first rows of both encodings); the weights are
rebuilt from the seed with `xclip_tpu_torch.convert.numpy_params`.
"""

import json
import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import xclip_tpu  # noqa: E402
from xclip_tpu_torch.convert import numpy_params  # noqa: E402

OUT = Path(__file__).resolve().parent / "data" / "torch_port_golden.npz"
# dim and inner multiples of 64 and dim_head 64, so the CUDA kernels take it
CONFIG = dict(dim_text=64, dim_image=64, dim_latent=64, num_text_tokens=100,
              text_enc_depth=2, text_seq_len=16, text_heads=2,
              visual_enc_depth=2, visual_heads=2, visual_image_size=32,
              visual_patch_size=16, attn_impl="fused",
              visual_attn_impl="xla", ff_impl="block_stored")
SEED = 11


def main():
    jax.config.update("jax_default_matmul_precision", "highest")
    npr = np.random.RandomState(SEED + 1)
    text = npr.randint(1, 100, (4, 16))
    for i in range(4):
        text[i, 16 - 4 * i:] = 0          # padded captions of mixed lengths
    images = npr.randn(4, 3, 32, 32).astype(np.float32)
    clip = xclip_tpu.CLIP(**CONFIG)
    params = jax.tree.map(jnp.asarray, numpy_params(CONFIG, SEED))
    jt, ji = jnp.asarray(text), jnp.asarray(images)
    sims = clip(jt, ji, params=params)
    tl, il = clip(jt, ji, return_latents=True, params=params)
    et, ei = clip(jt, ji, return_encodings=True, params=params)
    np.savez_compressed(
        OUT, config=json.dumps(CONFIG), seed=SEED, text=text, images=images,
        sims=np.asarray(sims), text_latents=np.asarray(tl),
        image_latents=np.asarray(il), enc_text_head=np.asarray(et[:, :3]),
        enc_image_head=np.asarray(ei[:, :3]))
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
