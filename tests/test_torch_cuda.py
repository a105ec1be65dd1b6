"""The port's CUDA kernel on the card: EmuGEMM-I against its plain
version, bit for bit, and the dispatcher's routing of CUDA tensors.

These tests need an NVIDIA GPU and nvcc; they skip elsewhere. This file
imports no jax, so it runs where only torch is installed:

    python -m pytest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from _torch_util import cuda_device  # noqa: F401
from repro_torch.core import scheme1
from repro_torch.kernels import dispatch, ozaki1

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [3, 4, 6])
def test_kernel_bit_identical_to_plain_on_card(cuda_device, dtype, p):
    g = torch.Generator(device=cuda_device).manual_seed(p)
    for (m, k, n, batch, trans) in [(4, 2048, 2048, None, False),
                                    (37, 1000, 77, None, True),
                                    (16, 128, 80, 64, False)]:
        lead = () if batch is None else (batch,)
        a = torch.randn(lead + (m, k), generator=g, device=cuda_device)
        b = (torch.randn(lead + (n, k), generator=g,
                         device=cuda_device).transpose(-1, -2) if trans
             else torch.randn(lead + (k, n), generator=g, device=cuda_device))
        a, b = a.to(dtype), b.to(dtype)
        mu, nu = scheme1.pow2_scale(a, -1), scheme1.pow2_scale(b, -2)
        out = ozaki1.fused_matmul_scheme1(a, b, mu, nu, p, 7, dtype)
        ref = ozaki1.fused_matmul_plain(a, b, mu, nu, p, 7, dtype)
        torch.cuda.synchronize()
        assert torch.equal(out, ref), (m, k, n, batch)


def test_cuda_tensors_launch_the_kernel(cuda_device):
    a = torch.randn(37, 300, device=cuda_device, dtype=torch.bfloat16)
    b = torch.randn(300, 70, device=cuda_device, dtype=torch.bfloat16)
    ozaki1.COUNTS.reset()
    out = dispatch.emulated_matmul(a, b, cfg="ozaki1-p4")
    ref = dispatch.emulated_matmul(a, b, cfg="ozaki1-p4", backend="torch")
    assert ozaki1.COUNTS.launches_2d == 1
    assert ozaki1.COUNTS.plain_cuda_calls == 1      # the explicit reference
    assert torch.equal(out, ref)


def test_kernel_refuses_what_it_was_not_built_for(cuda_device):
    a = torch.randn(8, 16, device=cuda_device, dtype=torch.float64)
    mu = scheme1.pow2_scale(a, -1)
    with pytest.raises(NotImplementedError):
        ozaki1.fused_matmul_scheme1(a, a.T, mu, mu.T, 4, 7, torch.float64)
    b = torch.randn(8, 16, device=cuda_device)
    s = scheme1.pow2_scale(b, -1)
    with pytest.raises(NotImplementedError):
        ozaki1.fused_matmul_scheme1(b, b.T, s, s.T, 9, 7, torch.float32)
