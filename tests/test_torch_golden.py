"""The port on the CPU against committed JAX outputs
(`tests/data/torch_port_golden.npz`, written by
`tests/make_torch_port_golden.py`): the same check that `chip_smoke.py`
makes on the GPU, where there is no JAX. fp32, 1e-4 absolute."""

import json
from pathlib import Path

import numpy as np
import torch

import xclip_tpu_torch
from xclip_tpu_torch.convert import load_jax_params, numpy_params

GOLDEN = Path(__file__).resolve().parent / "data" / "torch_port_golden.npz"


def test_port_matches_jax_golden():
    g = np.load(GOLDEN)
    config = json.loads(str(g["config"]))
    clip = xclip_tpu_torch.CLIP(**config)
    load_jax_params(clip, numpy_params(config, int(g["seed"])))
    text, images = torch.from_numpy(g["text"]), torch.from_numpy(g["images"])
    got = {"sims": clip(text, images)}
    got["text_latents"], got["image_latents"] = clip(text, images,
                                                     return_latents=True)
    et, ei = clip(text, images, return_encodings=True)
    got["enc_text_head"], got["enc_image_head"] = et[:, :3], ei[:, :3]
    for name, value in got.items():
        np.testing.assert_allclose(value.numpy(), g[name], atol=1e-4, rtol=0,
                                   err_msg=name)
