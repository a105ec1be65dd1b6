"""The port's CUDA kernels on the card: EmuGEMM-I in its three launch
forms and the prepared-weight decomposition (K2, K2r) against their plain
versions, bit for bit, the dispatcher's routing of CUDA tensors, and a
cached train step that launches them.

These tests need an NVIDIA GPU and nvcc; they skip elsewhere. This file
imports no jax, so it runs where only torch is installed:

    python -m pytest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from _torch_util import cuda_device  # noqa: F401
from repro_torch.core import scheme1
from repro_torch.kernels import decompose, dispatch, ozaki1

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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [3, 4, 6])
def test_prepared_kernels_bit_identical_to_plain_on_card(cuda_device, dtype,
                                                          p):
    g = torch.Generator(device=cuda_device).manual_seed(p)
    for (k, n, trans) in [(256, 512, False), (100, 70, False),
                          (128, 1000, True)]:
        b = (torch.randn(n, k, generator=g, device=cuda_device).T if trans
             else torch.randn(k, n, generator=g, device=cuda_device))
        b = b.to(dtype)
        nu, tau = scheme1.pow2_scale(b, -2), scheme1.pow2_scale(b, -1).T
        fwd, twin = decompose.decompose_interleave_pair(b, nu, tau, p, 7, 6)
        rfwd, rtwin = decompose.decompose_pair_plain(b, nu, tau, p, 7, 6)
        rhs = decompose.decompose_interleave_rhs(b, nu, p, 7)
        a = torch.randn(37, k, generator=g, device=cuda_device).to(dtype)
        mu = scheme1.pow2_scale(a, -1)
        out = ozaki1.fused_matmul_mixed(a, fwd, mu, nu, p, 7, dtype)
        ref = ozaki1.fused_matmul_mixed_plain(a, fwd, mu, nu, p, 7, dtype)
        torch.cuda.synchronize()
        assert torch.equal(fwd, rfwd) and torch.equal(twin, rtwin), (k, n)
        assert torch.equal(rhs, rfwd), (k, n)
        assert torch.equal(out, ref), (k, n)
        # The mixed form equals the 2-D form that carves B itself.
        assert torch.equal(out, ozaki1.fused_matmul_scheme1(
            a, b, mu, nu, p, 7, dtype))


def test_cached_train_step_launches_the_prepared_kernels(cuda_device):
    from repro_torch import api, configs
    from repro_torch.data import make_batch_iterator
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import steps as S
    from repro_torch.models.common import GemmPolicy
    arch = configs.get_smoke_config("olmo-1b")
    state = S.init_state(arch, 0, cuda_device)
    step = S.make_train_step(arch, policy=GemmPolicy(
        default=api.precision("ozaki1-p4+cached")))
    _, batch = next(make_batch_iterator(arch, ShapeSpec("t", 32, 2,
                                                        "train")))
    ozaki1.COUNTS.reset()
    decompose.COUNTS.reset()
    _, metrics = step(state, batch)
    assert torch.isfinite(metrics["loss"])
    assert decompose.COUNTS.launches_pair > 0
    assert ozaki1.COUNTS.launches_mixed > 0
    assert ozaki1.COUNTS.launches_2d > 0 and ozaki1.COUNTS.launches_batched > 0
    assert ozaki1.COUNTS.plain_cuda_calls == 0
    assert decompose.COUNTS.plain_cuda_calls == 0
