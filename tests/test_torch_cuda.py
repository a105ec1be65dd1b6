"""The port's CUDA kernels on the card: EmuGEMM-I in its four launch
forms, the decomposition (K2, K2r, K11), the int8 GEMM (K9), fused
attention (K10), EmuGEMM-II in its
four launch forms (K5g with a float and with a residue rhs, K6, K5;
float32, bfloat16 and float64) and its complex 3M kernels (K7g, K7)
against their plain versions, bit for bit, the dispatcher's routing of
CUDA tensors (complex 4M included), and train steps that launch them
(a hoisted microbatch step among them).

These tests need an NVIDIA GPU and nvcc; they skip elsewhere. This file
imports no jax, so it runs where only torch is installed:

    python -m pytest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from _torch_util import cuda_device  # noqa: F401
from repro_torch.core import complex3m, scheme1, scheme2
from repro_torch.core.precision import (DEFAULT_MODULI, EmulationConfig,
                                        default_moduli)
from repro_torch.kernels import (decompose, dispatch, ops, ozaki1, ozaki2,
                                 ozaki3m)

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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [4, 6, 8, 16])
def test_scheme2_kernel_bit_identical_to_plain_on_card(cuda_device, dtype, p):
    """K5g (2-D), K6 (batched, plain strides and transposed views) and K5
    (residues) against their plain versions."""
    g = torch.Generator(device=cuda_device).manual_seed(p)
    moduli = default_moduli(p)
    for (m, k, n, batch, trans) in [(100, 200, 77, None, False),
                                    (64, 96, 80, None, True),
                                    (16, 128, 80, 64, False),
                                    (128, 128, 128, 16, True)]:
        lead = () if batch is None else (batch,)
        a = torch.randn(lead + (m, k), generator=g, device=cuda_device)
        b = (torch.randn(lead + (n, k), generator=g,
                         device=cuda_device).transpose(-1, -2) if trans
             else torch.randn(lead + (k, n), generator=g, device=cuda_device))
        a, b = a.to(dtype), b.to(dtype)
        mu, nu = scheme2.scales(a, b, moduli)
        out = ozaki2.fused_matmul_scheme2(a, b, mu, nu, moduli, dtype)
        ref = ozaki2.fused_matmul_scheme2_plain(a, b, mu, nu, moduli, dtype)
        torch.cuda.synchronize()
        assert torch.equal(out, ref), (m, k, n, batch, trans)
    a_res = torch.randint(-128, 128, (p, 100, 200), generator=g,
                          device=cuda_device, dtype=torch.int8)
    b_res = torch.randint(-128, 128, (p, 77, 200), generator=g,
                          device=cuda_device, dtype=torch.int8)
    b_res = b_res.transpose(-1, -2)
    out = ozaki2.fused_residue_matmul(a_res, b_res, moduli)
    ref = ozaki2.fused_residue_matmul_plain(a_res, b_res, moduli)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


def test_scheme2_routes_agree_and_refuse_on_card(cuda_device):
    a = torch.randn(64, 128, device=cuda_device)
    b = torch.randn(128, 96, device=cuda_device)
    ozaki2.COUNTS.reset()
    fused = dispatch.emulated_matmul(a, b, cfg="ozaki2-m6")
    via_residues = ops.fused_scheme2_matmul(a, b, "ozaki2-m6")
    assert torch.equal(fused, via_residues)
    assert ozaki2.COUNTS.launches_2d == 1
    assert ozaki2.COUNTS.launches_residues == 1
    assert ozaki2.COUNTS.plain_cuda_calls == 0
    # float64 operands come in pairs, and never with a bf16 output.
    a64, b64 = a.double(), b.double()
    with pytest.raises(NotImplementedError):
        ozaki2.fused_matmul_scheme2(a64, b64,
                                    *scheme2.scales(a64, b64, default_moduli(6)),
                                    default_moduli(6), torch.bfloat16)


def test_emu_train_step_launches_scheme2(cuda_device):
    from repro_torch import configs
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import make_batch_iterator
    from repro_torch.launch import steps as S
    arch = configs.get_smoke_config("olmo-1b-emu")
    state = S.init_state(arch, 0, cuda_device)
    step = S.make_train_step(arch)          # the config's gemm_sites
    _, batch = next(make_batch_iterator(arch, ShapeSpec("t", 32, 2,
                                                        "train")))
    ozaki1.COUNTS.reset()
    ozaki2.COUNTS.reset()
    _, metrics = step(state, batch)
    assert torch.isfinite(metrics["loss"])
    assert ozaki2.COUNTS.launches_batched > 0
    assert ozaki1.COUNTS.launches_mixed > 0
    assert ozaki2.COUNTS.plain_cuda_calls == 0
    assert ozaki1.COUNTS.plain_cuda_calls == 0


def _eq19(g, shape, dtype, dev):
    """Paper Eq. 19 matrices drawn in the working type (a complex one has
    two such parts), so float64 carries all 53 mantissa bits."""
    part = (torch.float64 if dtype in (torch.float64, torch.complex128)
            else torch.float32)

    def draw():
        return (torch.rand(shape, generator=g, device=dev, dtype=part)
                - 0.5) * torch.exp(2 * torch.randn(shape, generator=g,
                                                   device=dev, dtype=part))
    return torch.complex(draw(), draw()) if dtype.is_complex else draw()


@pytest.mark.parametrize("p", [8, 12, 16])
def test_scheme2_float64_bit_identical_to_plain_on_card(cuda_device, p):
    """EmuGEMM-II in float64: K5g (2-D; float64 out, float32 out, and
    float32 operands to a float64 out), K6 (batched, transposed views) and
    the residue route of ops.fused_scheme2_matmul."""
    g = torch.Generator(device=cuda_device).manual_seed(100 + p)
    moduli = default_moduli(p)
    f64 = torch.float64
    for (m, k, n, batch, trans) in [(200, 136, 72, None, False),
                                    (64, 96, 80, None, True),
                                    (16, 128, 80, 8, True)]:
        lead = () if batch is None else (batch,)
        a = _eq19(g, lead + (m, k), f64, cuda_device)
        b = (_eq19(g, lead + (n, k), f64, cuda_device).transpose(-1, -2)
             if trans else _eq19(g, lead + (k, n), f64, cuda_device))
        for x, y, out_t in ((a, b, f64), (a, b, torch.float32),
                            (a.float(), b.float(), f64)):
            mu, nu = scheme2.scales(x, y, moduli)
            out = ozaki2.fused_matmul_scheme2(x, y, mu, nu, moduli, out_t)
            ref = ozaki2.fused_matmul_scheme2_plain(x, y, mu, nu, moduli,
                                                    out_t)
            torch.cuda.synchronize()
            assert out.dtype == out_t
            assert torch.equal(out, ref), (m, k, n, batch, x.dtype, out_t)
    a, b = _eq19(g, (100, 200), f64, cuda_device), _eq19(g, (200, 77), f64,
                                                         cuda_device)
    ozaki2.COUNTS.reset()
    fused = dispatch.emulated_matmul(a, b, cfg=f"ozaki2-m{p}")
    routed = ops.fused_scheme2_matmul(a, b, f"ozaki2-m{p}", out_dtype=f64)
    assert fused.dtype == f64 and torch.equal(fused, routed)
    assert (ozaki2.COUNTS.launches_2d, ozaki2.COUNTS.launches_residues,
            ozaki2.COUNTS.plain_cuda_calls) == (1, 1, 0)


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("p", [4, 8, 12, 16])
def test_3m_kernels_bit_identical_to_plain_on_card(cuda_device, dtype, p):
    """K7g against complex3m.scaled_matmul (ragged, a transposed view,
    complex @ real and real @ complex, rows of tiny magnitude whose
    1 / (mu * nu) is subnormal), and K7 against its plain version."""
    g = torch.Generator(device=cuda_device).manual_seed(200 + p)
    moduli = default_moduli(p)
    part = torch.float64 if dtype == torch.complex128 else torch.float32
    a = _eq19(g, (200, 136), dtype, cuda_device)
    a[:3] *= 2.0 ** -120 if part == torch.float32 else 2.0 ** -1000
    b = _eq19(g, (136, 72), dtype, cuda_device)
    bt = _eq19(g, (72, 136), dtype, cuda_device).T
    cases = [(a, b), (a, bt), (a, b.real.contiguous()), (a.real.contiguous(), b),
             (a[:64, :96], b[:96, :64])]
    for out_t in (part, torch.float32 if part == torch.float64
                  else torch.float64):
        for x, y in cases:
            mu, nu = complex3m.scales(x, y, moduli)
            out = ozaki3m.fused_matmul_3m(x, y, mu, nu, moduli, out_t)
            ref = ozaki3m.fused_matmul_3m_plain(x, y, mu, nu, moduli, out_t)
            torch.cuda.synchronize()
            assert out.dtype == ref.dtype
            assert torch.equal(out, ref), (tuple(x.shape), x.dtype, y.dtype,
                                           out_t)
    for (m, k, n) in [(100, 200, 77), (128, 128, 128)]:
        a3 = torch.randint(-128, 128, (p, 3, m, k), generator=g,
                           device=cuda_device, dtype=torch.int8)
        b3 = torch.randint(-128, 128, (p, 3, k, n), generator=g,
                           device=cuda_device, dtype=torch.int8)
        out = ozaki3m.fused_3m_residue_matmul(a3, b3, moduli)
        ref = ozaki3m.fused_3m_residue_matmul_plain(a3, b3, moduli)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(out, ref)), (m, k, n)


def test_complex_routes_on_card(cuda_device):
    """The front doors launch K7g (and ops.fused_3m_matmul K7) with no
    plain version on CUDA; complex64 under ozaki1 is four EmuGEMM-I
    launches equal to matmul_complex_4m; what the port does not run
    raises instead of falling back."""
    from repro_torch import api
    g = torch.Generator(device=cuda_device).manual_seed(7)
    a = _eq19(g, (96, 160), torch.complex128, cuda_device)
    b = _eq19(g, (160, 40), torch.complex128, cuda_device)
    ozaki3m.COUNTS.reset()
    out = api.einsum("mk,kn->mn", a, b, precision="ozaki2-m12")
    direct = ozaki3m.fused_matmul_3m(
        a, b, *complex3m.scales(a, b, default_moduli(12)),
        default_moduli(12), torch.float64)
    routed = ops.fused_3m_matmul(a, b, "ozaki2-m12")
    assert out.dtype == torch.complex128
    assert torch.equal(out, direct) and torch.equal(out, routed)
    assert (ozaki3m.COUNTS.launches_2d, ozaki3m.COUNTS.launches_residues,
            ozaki3m.COUNTS.plain_cuda_calls) == (2, 1, 0)
    # A complex batch runs one 2-D launch per element.
    za = a[:64].reshape(2, 32, 160)
    zb = b[:, :32].reshape(160, 2, 16).permute(1, 0, 2)
    batched = api.einsum("bmk,bkn->bmn", za, zb, precision="ozaki2-m12")
    assert ozaki3m.COUNTS.launches_2d == 4
    assert torch.equal(batched[1], api.einsum(
        "mk,kn->mn", za[1], zb[1], precision="ozaki2-m12"))
    a64, b64 = a.to(torch.complex64), b.to(torch.complex64)
    ozaki1.COUNTS.reset()
    out = api.einsum("mk,kn->mn", a64, b64, precision="ozaki1-p4")
    assert ozaki1.COUNTS.launches_2d == 4
    assert ozaki1.COUNTS.plain_cuda_calls == 0
    assert torch.equal(out, dispatch.emulated_matmul(a64, b64, cfg="ozaki1-p4",
                                                     backend="torch"))
    with pytest.raises(NotImplementedError, match="complex128"):
        dispatch.emulated_matmul(a, b, cfg="ozaki1-p4")
    cfg17 = EmulationConfig(scheme="ozaki2", p=17,
                            moduli=DEFAULT_MODULI + (181,))
    with pytest.raises(NotImplementedError, match="at most 16 moduli"):
        dispatch.emulated_matmul(a, b, cfg=cfg17)
    with pytest.raises(NotImplementedError, match="forward only"):
        api.einsum("mk,kn->mn", a.requires_grad_(), b, precision="ozaki2-m8")


# ---------------------------------------------------------------------------
# EmuGEMM-II's prepared form (K5g with a residue rhs) and the hoisted step.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
@pytest.mark.parametrize("p", [6, 8, 16])
def test_scheme2_prepared_bit_identical_to_plain_on_card(cuda_device, dtype,
                                                         p):
    """The prepared form against its plain version, and against the 2-D
    form on the same operands, aligned, ragged and with a transposed
    lhs."""
    from repro_torch.kernels import prepared
    g = torch.Generator(device=cuda_device).manual_seed(p)
    cfg = EmulationConfig(scheme="ozaki2", p=p)
    for m, k, n, trans in [(256, 512, 384, False), (100, 200, 77, False),
                           (33, 130, 50, True)]:
        a = (torch.randn((k, m) if trans else (m, k), generator=g,
                         device=cuda_device, dtype=torch.float64) * 3)
        a = (a.T if trans else a).to(dtype)
        b = torch.randn(k, n, generator=g, device=cuda_device,
                        dtype=torch.float64).to(dtype)
        prep = prepared.prepare_rhs(b, cfg)
        assert prep.layout == "fused"
        mu = scheme2._pow2_int_scale(a, -1, prep.budget_bits)
        ozaki2.COUNTS.reset()
        out = ozaki2.fused_matmul_scheme2_prepared(
            a, prep.residues, mu, prep.scale, prep.moduli, dtype, n)
        assert ozaki2.COUNTS.launches_prepared == 1
        ref = ozaki2.fused_matmul_scheme2_prepared_plain(
            a, prep.residues, mu, prep.scale, prep.moduli, dtype, n)
        torch.cuda.synchronize()
        assert torch.equal(out, ref), (m, k, n, trans)
        assert torch.equal(prepared.matmul_prepared(a, prep, dtype),
                           dispatch.emulated_matmul(a, b, cfg=cfg)), (m, k, n)


def test_hoisted_step_launches_the_prepared_form(cuda_device):
    """A microbatches=2 step under ozaki2-m6+cached prepares each weight
    once and launches the prepared form for every dense forward and dA,
    with no plain version on CUDA."""
    import dataclasses
    from repro_torch import api, configs
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import make_batch_iterator
    from repro_torch.launch import steps as S
    from repro_torch.models.common import GemmPolicy
    arch = configs.get_smoke_config("olmo-1b")
    arch = dataclasses.replace(arch, train=dataclasses.replace(
        arch.train, microbatches=2))
    state = S.init_state(arch, 0, cuda_device)
    step = S.make_train_step(arch, policy=GemmPolicy(
        default=api.precision("ozaki2-m6+cached")))
    _, batch = next(make_batch_iterator(arch, ShapeSpec("t", 32, 4,
                                                        "train")))
    ozaki2.COUNTS.reset()
    _, metrics = step(state, batch)
    assert torch.isfinite(metrics["loss"])
    layers = arch.model.n_layers
    # 7 dense weights a layer: forward, recompute and dA per microbatch;
    # the tied head: forward and dA per microbatch.
    assert ozaki2.COUNTS.launches_prepared == 2 * (21 * layers + 2)
    assert ozaki2.COUNTS.launches_2d == 2 * (7 * layers + 1)   # dB
    assert ozaki2.COUNTS.plain_cuda_calls == 0


# ---------------------------------------------------------------------------
# The library kernels: K11, K8, K9, K10.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [3, 4, 6])
def test_library_scheme1_kernels_bit_identical_on_card(cuda_device, dtype, p):
    """K11 and K8 against their plain versions; K11 + K2r -> K8 and the
    'xla' route of ops.fused_scheme1_matmul against K1 (the 'kernel'
    route), bit for bit."""
    g = torch.Generator(device=cuda_device).manual_seed(p)
    for (m, k, n) in [(256, 2048, 512), (37, 1000, 77), (1, 33, 5)]:
        a = torch.randn(m, k, generator=g, device=cuda_device).to(dtype)
        b = torch.randn(k, n, generator=g, device=cuda_device).to(dtype)
        mu, nu = scheme1.pow2_scale(a, 1), scheme1.pow2_scale(b, 0)
        decompose.COUNTS.reset()
        ozaki1.COUNTS.reset()
        a_hat = decompose.decompose_interleave(a, mu, p, 7)
        b_hat = decompose.decompose_interleave_rhs(b, nu, p, 7)
        out = ozaki1.fused_matmul_interleaved(a_hat, b_hat, mu, nu, p, 7,
                                              dtype)
        assert decompose.COUNTS.launches_lhs == 1
        assert ozaki1.COUNTS.launches_interleaved == 1
        assert torch.equal(a_hat, decompose.decompose_lhs_plain(a, mu, p, 7))
        assert torch.equal(out, ozaki1.fused_matmul_interleaved_plain(
            a_hat, b_hat, mu, nu, p, 7, dtype)), (m, k, n)
        assert torch.equal(out, ozaki1.fused_matmul_scheme1(
            a, b, mu, nu, p, 7, dtype)), (m, k, n)
        routes = [ops.fused_scheme1_matmul(
            a, b, EmulationConfig(scheme="ozaki1", p=p, decomp=d),
            out_dtype=dtype) for d in ("xla", "kernel")]
        torch.cuda.synchronize()
        assert torch.equal(routes[0], routes[1]), (m, k, n)


def test_int8_matmul_bit_identical_on_card(cuda_device):
    from repro_torch.kernels import matmul_int8
    g = torch.Generator(device=cuda_device).manual_seed(9)
    for (m, k, n) in [(512, 1024, 768), (37, 1000, 77), (130, 4096, 200),
                      (1, 7, 3)]:
        a = torch.randint(-128, 128, (m, k), generator=g, device=cuda_device,
                          dtype=torch.int8)
        b = torch.randint(-128, 128, (k, n), generator=g, device=cuda_device,
                          dtype=torch.int8)
        matmul_int8.COUNTS.reset()
        out = matmul_int8.int8_matmul(a, b)
        assert matmul_int8.COUNTS.launches == 1
        ref = matmul_int8.int8_matmul_plain(a, b)
        torch.cuda.synchronize()
        assert torch.equal(out, ref), (m, k, n)
    # A transposed rhs view is read through a contiguous copy.
    bt = torch.randint(-128, 128, (77, 1000), generator=g, device=cuda_device,
                       dtype=torch.int8)
    a = torch.randint(-128, 128, (37, 1000), generator=g, device=cuda_device,
                      dtype=torch.int8)
    assert torch.equal(matmul_int8.int8_matmul(a, bt.T),
                       matmul_int8.int8_matmul_plain(a, bt.T))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_flash_attention_on_card(cuda_device, dtype, tol, d):
    from repro_torch.kernels import flash_attn
    g = torch.Generator(device=cuda_device).manual_seed(d)
    cases = [(2, 4, 4, 256, 256, True, None), (1, 8, 2, 200, 200, True, None),
             (1, 4, 1, 128, 512, False, None), (1, 2, 2, 300, 300, False, 64),
             (1, 2, 1, 128, 64, True, 32)]       # rows 95.. see no key
    for (b, h, kvh, sq, sk, causal, window) in cases:
        q = torch.randn(b, h, sq, d, generator=g, device=cuda_device).to(dtype)
        k = torch.randn(b, kvh, sk, d, generator=g,
                        device=cuda_device).to(dtype)
        v = torch.randn(b, kvh, sk, d, generator=g,
                        device=cuda_device).to(dtype)
        flash_attn.COUNTS.reset()
        out = flash_attn.flash_attention(q, k, v, causal=causal,
                                         window=window, bq=sq, bk=sk)
        assert flash_attn.COUNTS.launches == 1
        ref = flash_attn.flash_attention_plain(q, k, v, causal, window)
        torch.cuda.synchronize()
        assert out.dtype == dtype and out.shape == q.shape
        torch.testing.assert_close(out.float(), ref.float(), rtol=tol,
                                   atol=tol)


def test_library_kernels_refuse_what_they_were_not_built_for(cuda_device):
    from repro_torch.kernels import flash_attn
    a = torch.randn(8, 16, device=cuda_device, dtype=torch.float64)
    with pytest.raises(NotImplementedError):
        ops.fused_scheme1_matmul(a, a.T)
    with pytest.raises(NotImplementedError):
        decompose.decompose_interleave(a, scheme1.pow2_scale(a, 1), 4, 7)
    q = torch.randn(1, 2, 64, 48, device=cuda_device)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        flash_attn.flash_attention(q, q, q)
    q = torch.randn(1, 2, 64, 64, device=cuda_device, dtype=torch.float16)
    with pytest.raises(NotImplementedError):
        flash_attn.flash_attention(q, q, q)
    x = torch.zeros(8, 64, device=cuda_device, dtype=torch.int8)
    mu = torch.ones(8, 1, device=cuda_device)
    with pytest.raises(ValueError):         # 64 is not p * Kp for p = 3
        ozaki1.fused_matmul_interleaved(x, x.T.contiguous(), mu, mu.T, 3, 7)
