"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper runs its kernel's plain version, so these hold the
plain versions (the kernels' cast order written in PyTorch) to
`xclip_tpu.kernels.fused_ff_block.ff_block` and
`xclip_tpu.kernels.attention_megablock.attention_block`, which run in
Pallas interpret mode here. Inputs come from a numpy seed and go to both.
Tolerances: fp32 1e-4 absolute (summation order only); bf16 two storage
ulps at the outputs' magnitude (|out| < 8, ulp 2^-5), since both sides
round at the same places and only summation order can flip a rounding.

`test_torch_cuda.py` holds the CUDA kernels to the plain versions on a GPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xclip_tpu.kernels.attention_megablock import attention_block as jax_mega
from xclip_tpu.kernels.fused_ff_block import ff_block as jax_ff_block
from xclip_tpu_torch.kernels import attention_megablock as mega
from xclip_tpu_torch.kernels import fused_ff_block as ffb

from torch_port_inputs import BF16_ATOL, to_np, to_torch, ff_args as _ff_args, \
    mega_args as _mega_args
import torch_one_thread  # noqa: F401


def _jax(args, dtype):
    return [jnp.asarray(a, dtype=dtype) if a.dtype != bool else jnp.asarray(a)
            for a in args]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ff_block_plain_matches_pallas(dtype):
    args = _ff_args()
    want = to_np(jax_ff_block(*_jax(args, jnp.dtype(dtype))))
    got = to_np(ffb.ff_block(*to_torch(args, getattr(torch, dtype))))
    atol = 1e-4 if dtype == "float32" else BF16_ATOL
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def test_ff_block_cpu_wrapper_is_plain_and_uncounted():
    args = to_torch(_ff_args(R=7), torch.float32)
    before = ffb.ff_block.launches
    torch.testing.assert_close(ffb.ff_block(*args), ffb.ff_block_plain(*args),
                               rtol=0, atol=0)
    assert ffb.ff_block.launches == before


def test_ff_block_leading_dims():
    """(b, n, d) input: the same rows as the flattened (b·n, d) call."""
    args = to_torch(_ff_args(R=12), torch.float32)
    out3 = ffb.ff_block(args[0].reshape(3, 4, -1), *args[1:])
    torch.testing.assert_close(out3.reshape(12, -1), ffb.ff_block(*args),
                               rtol=0, atol=0)


def test_wrappers_refuse_grad():
    args = to_torch(_ff_args(R=4), torch.float32)
    args[2].requires_grad_(True)
    with pytest.raises(NotImplementedError, match="no backward"):
        ffb.ff_block(*args)
    with torch.no_grad():
        ffb.ff_block(*args)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mask_kind", ["none", "keypad", "dead"])
def test_attention_block_plain_matches_pallas(causal, mask_kind):
    args = _mega_args(mask_kind=mask_kind)
    maybe_dead = mask_kind != "none"
    static = (2, 64, 64 ** -0.5, causal)
    want = to_np(jax_mega(*_jax(args, jnp.float32), *static, None, maybe_dead))
    got = to_np(mega.attention_block(*to_torch(args, torch.float32), *static,
                                   maybe_dead))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_attention_block_plain_matches_pallas_bf16():
    args = _mega_args(mask_kind="keypad")
    static = (2, 64, 64 ** -0.5, False)
    want = to_np(jax_mega(*_jax(args, jnp.bfloat16), *static, None, True))
    got = to_np(mega.attention_block(*to_torch(args, torch.bfloat16), *static,
                                   True))
    np.testing.assert_allclose(got, want, atol=BF16_ATOL, rtol=0)


def test_attention_dead_rows_are_uniform():
    """A row with no valid key averages v over every key (the XLA route's
    softmax of constant scores), so all its heads' outputs agree with the
    uniform mean computed directly."""
    x, g_pre, w_qkv, w_out, g_out, mask = to_torch(
        _mega_args(mask_kind="dead"), torch.float32)
    out = mega.attention_block(x, g_pre, w_qkv, w_out, g_out, mask, 2, 64,
                               0.125, False, True)
    from xclip_tpu_torch.kernels._common import ln_fp32
    xn = ln_fp32(x[1], g_pre, 1e-5)[0]
    v = (xn @ w_qkv)[:, 256:]
    attn = v.mean(dim=0, keepdim=True).expand_as(v)
    want = ln_fp32(attn @ w_out, g_out, 1e-5)[0] + x[1]
    torch.testing.assert_close(out[1], want, atol=1e-4, rtol=0)
