"""The port on the CPU against committed JAX outputs
(`tests/data/torch_port_golden.npz`; for the rotary causal-EOS text tower
on the 'fused' (K6) and 'flash' (K7) routes,
`tests/data/torch_port_golden_rotary.npz`; for `ff_impl='fused'` (K8) and
the stored-h FF block under XCLIP_FF_STORE=h (K1-h),
`tests/data/torch_port_golden_ff.npz`; for every objective that combines,
`tests/data/torch_port_golden_objectives.npz`; written by
`tests/make_torch_port_golden.py`): the same checks that `chip_smoke.py`
makes on the GPU (phases 3, 7, 10, 13, 17 and 23), where there is no JAX. fp32;
outputs 1e-4 absolute; one train step (stored routes, then memory-lean
routes) loss 1e-5, gradients rtol 1e-3 with atol 1e-5 times the leaf's
largest magnitude, parameters after the step 2e-6 (a few ulps of the O(1)
weights, the step moves each by about 1e-4)."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import xclip_tpu_torch
from xclip_tpu_torch.convert import load_jax_params, numpy_params, to_jax_tree
from xclip_tpu_torch.train import default_optimizer, make_train_step
import torch_one_thread  # noqa: F401

GOLDEN = Path(__file__).resolve().parent / "data" / "torch_port_golden.npz"
GOLDEN_ROTARY = GOLDEN.with_name("torch_port_golden_rotary.npz")
GOLDEN_FF = GOLDEN.with_name("torch_port_golden_ff.npz")
GOLDEN_OBJECTIVES = GOLDEN.with_name("torch_port_golden_objectives.npz")


def _check_outputs(golden, prefix=""):
    g = np.load(golden)
    config = json.loads(str(g[f"{prefix}config"]))
    clip = xclip_tpu_torch.CLIP(**config, device="cpu")
    load_jax_params(clip, numpy_params(config, int(g["seed"])))
    text = torch.from_numpy(g["text"])
    images = torch.from_numpy(g["images"]).float()
    got = {"sims": clip(text, images)}
    got["text_latents"], got["image_latents"] = clip(text, images,
                                                     return_latents=True)
    et, ei = clip(text, images, return_encodings=True)
    got["enc_text_head"], got["enc_image_head"] = et[:, :3], ei[:, :3]
    for name, value in got.items():
        np.testing.assert_allclose(value.numpy(), g[f"{prefix}{name}"],
                                   atol=1e-4, rtol=0, err_msg=name)


def test_port_matches_jax_golden():
    _check_outputs(GOLDEN)


@pytest.mark.parametrize("route", ["fused", "flash"])
def test_rotary_port_matches_jax_golden(route):
    _check_outputs(GOLDEN_ROTARY, f"{route}_")


def test_fused_ff_port_matches_jax_golden():
    _check_outputs(GOLDEN_FF, "fused_")


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _check_train_step(config_key, prefix, golden=GOLDEN, monkeypatch=None):
    g = np.load(golden)
    if f"{prefix}env" in g.files:     # the environment JAX's step saw
        for k, v in json.loads(str(g[f"{prefix}env"])).items():
            monkeypatch.setenv(k, v)
    config = json.loads(str(g[config_key]))
    clip = xclip_tpu_torch.CLIP(**config, device="cpu")
    load_jax_params(clip, numpy_params(config, int(g["seed"])))
    opt = default_optimizer(clip.parameters(),
                            **json.loads(str(g["train_optimizer"])))
    metrics = make_train_step(clip, opt)(
        torch.from_numpy(g["train_text"]),
        torch.from_numpy(g["train_images"]).float(),
        keep_idx=torch.from_numpy(g["train_keep_idx"]))
    np.testing.assert_allclose(metrics["loss"].item(),
                               g[f"{prefix}train_loss"], atol=1e-5)
    np.testing.assert_allclose(metrics["grad_norm"].item(),
                               g[f"{prefix}train_grad_norm"], rtol=1e-5)
    grads = dict(_flat(to_jax_tree(clip, grads=True)))
    params = dict(_flat(to_jax_tree(clip)))
    assert {f"{prefix}grad/{k}" for k in grads} == {
        k for k in g.files if k.startswith(f"{prefix}grad/")}
    for name, got in grads.items():
        want = g[f"{prefix}grad/{name}"]
        np.testing.assert_allclose(
            got, want, rtol=1e-3,
            atol=1e-5 * max(1.0, float(np.abs(want).max())), err_msg=name)
    for name, got in params.items():
        np.testing.assert_allclose(got, g[f"{prefix}param1/{name}"], rtol=0,
                                   atol=2e-6, err_msg=name)


def test_train_step_matches_jax_golden():
    _check_train_step("config", "")


def test_lean_train_step_matches_jax_golden():
    """The memory-lean routes (K3 both towers, the recompute FF block, the
    streaming-LSE InfoNCE) from the same weights and batch."""
    _check_train_step("lean_config", "lean_")


@pytest.mark.parametrize("route", ["fused", "flash"])
def test_rotary_train_step_matches_jax_golden(route):
    """The rotary causal-EOS text tower's train step on K6 or K7, one
    caption without EOS in the batch."""
    _check_train_step(f"{route}_config", f"{route}_", GOLDEN_ROTARY)


@pytest.mark.parametrize("route", ["fused", "stored_h"])
def test_ff_train_step_matches_jax_golden(route, monkeypatch):
    """ff_impl='fused' (K8 in both towers), and the kernel routes with
    XCLIP_FF_STORE=h (K1-h), from the same weights and batch."""
    _check_train_step(f"{route}_config", f"{route}_", GOLDEN_FF, monkeypatch)


def test_objectives_step_matches_jax_golden():
    """The tiny CLIP with every objective that combines (MLM, SimSiam,
    sim-reg, DCL, the extra heads, K5's loss; an augmented text and image
    view) on the kernel routes, given JAX's draws: the loss and every
    metric 1e-5, every gradient 1e-3 relative, one step's parameters 2e-6
    and its BatchNorm statistics 1e-6 absolute with 1e-5 relative."""
    from xclip_tpu_torch.objectives.ssl import SimSiam
    g = np.load(GOLDEN_OBJECTIVES)
    config = json.loads(str(g["config"]))
    ssl = SimSiam(**json.loads(str(g["ssl"])))
    clip = xclip_tpu_torch.CLIP(**config, visual_ssl=ssl, device="cpu")
    load_jax_params(clip, numpy_params({**config, "visual_ssl": ssl},
                                       int(g["seed"])))
    t = {k: torch.from_numpy(g[k]) for k in ("text", "images", "aug_text",
                                             "aug_images", "keep_idx")}
    draws = dict(
        keep_idx=t["keep_idx"],
        mlm_draws={k[4:]: torch.from_numpy(g[k]) for k in g.files
                   if k.startswith("mlm/")},
        ssl_draws={"augment": json.loads(str(g["ssl_augment"])),
                   "keep_idx": [torch.from_numpy(g[f"ssl_keep_idx/{i}"])
                                for i in range(4)]})
    opt = default_optimizer(clip.parameters(),
                            **json.loads(str(g["train_optimizer"])))
    metrics = make_train_step(clip, opt)(
        t["text"], t["images"], aug_text=t["aug_text"],
        aug_image=t["aug_images"], **draws)
    for k in ("loss", "cl_loss", "text_ssl_loss", "image_ssl_loss",
              "multiview_cl_loss", "sim_reg_loss", "temperature"):
        np.testing.assert_allclose(metrics[k].item(), g[f"metric/{k}"],
                                   atol=1e-5, err_msg=k)
    np.testing.assert_allclose(metrics["grad_norm"].item(),
                               g["train_grad_norm"], rtol=1e-5)
    for name, got in _flat(to_jax_tree(clip, grads=True)):
        want = g[f"grad/{name}"]
        np.testing.assert_allclose(
            got, want, rtol=1e-3,
            atol=1e-5 * max(1.0, float(np.abs(want).max())), err_msg=name)
    for name, got in _flat(to_jax_tree(clip)):
        bn = name.endswith(("/mean", "/var"))
        np.testing.assert_allclose(got, g[f"param1/{name}"],
                                   rtol=1e-5 if bn else 0,
                                   atol=1e-6 if bn else 2e-6, err_msg=name)
