"""The port's CUDA kernels against their plain versions, on a GPU.

Every test here needs a CUDA device and nvcc and skips elsewhere; the
module imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(`--noconftest`: the suite's conftest configures JAX). fp32 is compared at
1e-4 absolute with TF32 off; bf16 at two storage ulps.
"""

import pytest
import torch

from xclip_tpu_torch.kernels import attention_megablock as mega
from xclip_tpu_torch.kernels import fused_ff_block as ffb

from torch_port_inputs import BF16_ATOL, to_torch, ff_args, mega_args


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the kernels run only on "
                    "the card; python3 chip_smoke.py runs them there)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,dim,inner", [(130, 128, 256), (77, 64, 128)])
def test_ff_block_kernel_matches_plain(cuda_device, dtype, rows, dim, inner):
    args = to_torch(ff_args(R=rows, D=dim, I=inner), getattr(torch, dtype),
                    cuda_device)
    before = ffb.ff_block.launches
    got = ffb.ff_block(*args)
    assert ffb.ff_block.launches == before + 1
    want = ffb.ff_block_plain(*args)
    atol = 1e-4 if dtype == "float32" else BF16_ATOL
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mask_kind", ["none", "keypad", "dead"])
@pytest.mark.parametrize("n,dim,heads", [(70, 128, 2), (33, 64, 1)])
def test_attention_block_kernel_matches_plain(cuda_device, dtype, causal,
                                              mask_kind, n, dim, heads):
    args = to_torch(mega_args(n=n, dim=dim, heads=heads, mask_kind=mask_kind),
                    getattr(torch, dtype), cuda_device)
    static = (heads, 64, 0.125, causal, mask_kind != "none")
    before = mega.attention_block.launches
    got = mega.attention_block(*args, *static)
    assert mega.attention_block.launches == before + 1
    want = mega.attention_block_plain(*args, *static)
    atol = 1e-4 if dtype == "float32" else BF16_ATOL
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)
