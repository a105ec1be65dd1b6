"""The port's CUDA kernels on the card: EmuGEMM-I in its four launch
forms, the decomposition (K2, K2r, K11), the int8 GEMM (K9), fused
attention (K10: the bf16 wgmma kernel, the float32 3xTF32 wgmma kernel
and its pre-pass, the float32 FFMA kernel at D = 256), EmuGEMM-II in its
three fused launch forms (K5g with a float rhs, K6, K5; float32 and
bfloat16), the plane route of DGEMM and ZGEMM, 2-D and batched (the
encode kernels and the plane GEMM: float64 K5g and K6, K7g), the plane
route of the prepared form (K5g with a residue rhs: float32, bfloat16 and
float64) and the complex residue kernel K7 against their plain versions,
bit for bit (attention within its bars), the dispatcher's routing of
CUDA tensors (complex 4M included), and train steps that launch them
(a hoisted microbatch step among them).

These tests need an NVIDIA GPU and nvcc; they skip elsewhere. This file
imports no jax, so it runs where only torch is installed:

    python -m pytest -m cuda tests/test_torch_cuda.py
"""

import dataclasses

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
    float32 operands to a float64 out), K6 (batched, transposed views;
    float64 operands on the plane route, float32 operands to a float64
    out on the fused kernel) and the residue route of
    ops.fused_scheme2_matmul."""
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
    assert (ozaki2.COUNTS.launches_encode, ozaki2.COUNTS.launches_planes,
            ozaki2.COUNTS.launches_2d, ozaki2.COUNTS.launches_residues,
            ozaki2.COUNTS.plain_cuda_calls) == (2, 1, 0, 1, 0)


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


@pytest.mark.parametrize("p", [4, 8, 16])
def test_plane_encode_kernels_bit_identical_to_plain_on_card(cuda_device, p):
    """The encode kernels of the plane route against their plain versions:
    float64 (A and a transposed B^T view), complex64 and complex128 (A,
    B^T, a real operand of a complex product), ragged and K <= 8."""
    g = torch.Generator(device=cuda_device).manual_seed(300 + p)
    moduli = default_moduli(p)
    for (m, k, n) in [(200, 136, 72), (9, 5, 11), (300, 1000, 520)]:
        a = _eq19(g, (m, k), torch.float64, cuda_device)
        b = _eq19(g, (n, k), torch.float64, cuda_device).T
        mu, nu = scheme2.scales(a, b, moduli)
        for x, s in ((a, mu), (b.T, nu.T)):
            out = ozaki2.encode_planes(x, s, moduli)
            ref = ozaki2.encode_planes_plain(x, s, moduli)
            torch.cuda.synchronize()
            assert torch.equal(out, ref), (tuple(x.shape), x.stride())
        for dtype in (torch.complex64, torch.complex128):
            za = _eq19(g, (m, k), dtype, cuda_device)
            zb = _eq19(g, (n, k), dtype, cuda_device).T
            zmu, znu = complex3m.scales(za, zb, moduli)
            for x, s in ((za, zmu), (zb.T, znu.T),
                         (za.real.contiguous(), zmu)):
                out = ozaki3m.encode_planes_3m(x, s, moduli)
                ref = ozaki3m.encode_planes_3m_plain(x, s, moduli)
                torch.cuda.synchronize()
                assert torch.equal(out, ref), (tuple(x.shape), x.dtype)


@pytest.mark.parametrize("p", [8, 12, 16])
def test_plane_routes_bit_identical_to_plain_on_card(cuda_device, p):
    """The DGEMM and ZGEMM routes (encodes + plane GEMM) against their
    plain versions at the scientific phase's 1024^3 and a shape that is
    ragged in every tile (M, N and K past 128, 256 and 128)."""
    g = torch.Generator(device=cuda_device).manual_seed(400 + p)
    moduli = default_moduli(p)
    for (m, k, n) in [(1024, 1024, 1024), (300, 1000, 520)]:
        for dtype in (torch.float64, torch.complex128):
            a = _eq19(g, (m, k), dtype, cuda_device)
            b = _eq19(g, (k, n), dtype, cuda_device)
            if dtype == torch.float64:
                mu, nu = scheme2.scales(a, b, moduli)
                out = ozaki2.fused_matmul_scheme2(a, b, mu, nu, moduli,
                                                  torch.float64)
                ref = ozaki2.fused_matmul_scheme2_plain(a, b, mu, nu,
                                                        moduli, torch.float64)
            else:
                mu, nu = complex3m.scales(a, b, moduli)
                out = ozaki3m.fused_matmul_3m(a, b, mu, nu, moduli,
                                              torch.float64)
                ref = ozaki3m.fused_matmul_3m_plain(a, b, mu, nu, moduli,
                                                    torch.float64)
            torch.cuda.synchronize()
            assert torch.equal(out, ref), (m, k, n, dtype)


def test_plane_route_reduces_inside_long_k_on_card(cuda_device):
    """K = 131200 runs past the 1023 K tiles (130944 rows of K at m = 256)
    after which the plane GEMM reduces its accumulators mod m: still the
    plain version's bits."""
    g = torch.Generator(device=cuda_device).manual_seed(500)
    moduli = default_moduli(16)
    a = _eq19(g, (64, 131200), torch.float64, cuda_device)
    b = _eq19(g, (131200, 64), torch.float64, cuda_device)
    mu = scheme2._pow2_int_scale(a, -1, 52)
    nu = scheme2._pow2_int_scale(b, -2, 52)
    out = ozaki2.fused_matmul_scheme2(a, b, mu, nu, moduli, torch.float64)
    ref = ozaki2.fused_matmul_scheme2_plain(a, b, mu, nu, moduli,
                                            torch.float64)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


@pytest.mark.parametrize("p", [8, 12, 16])
def test_batched_plane_routes_bit_identical_to_plain_on_card(cuda_device, p):
    """The batched plane route (the batch as the kernels' batch
    coordinate) against its plain version, bit for bit: float64 and
    complex128, ragged M, N and K in every element, B transposed, the
    scientific phase's 8 x 512^3, and Bt = 1 against the 2-D route."""
    g = torch.Generator(device=cuda_device).manual_seed(450 + p)
    moduli = default_moduli(p)
    for (bt, m, k, n, trans) in [(3, 200, 136, 72, False),
                                 (5, 37, 300, 260, True),
                                 (8, 512, 512, 512, False),
                                 (1, 300, 1000, 520, False)]:
        for dtype in (torch.float64, torch.complex128):
            a = _eq19(g, (bt, m, k), dtype, cuda_device)
            b = (_eq19(g, (bt, n, k), dtype, cuda_device).transpose(1, 2)
                 if trans else _eq19(g, (bt, k, n), dtype, cuda_device))
            if dtype == torch.float64:
                mu, nu = scheme2.scales(a, b, moduli)
                run, plain = (ozaki2.fused_matmul_scheme2,
                              ozaki2.fused_matmul_scheme2_plain)
            else:
                mu, nu = complex3m.scales(a, b, moduli)
                run, plain = (ozaki3m.fused_matmul_3m,
                              ozaki3m.fused_matmul_3m_plain)
            out = run(a, b, mu, nu, moduli, torch.float64)
            torch.cuda.synchronize()
            assert torch.equal(out, plain(a, b, mu, nu, moduli,
                                          torch.float64)), (bt, m, k, n)
            if bt == 1:
                assert torch.equal(out[0], run(a[0], b[0], mu[0], nu[0],
                                               moduli, torch.float64))
            # Both tile widths of the plane GEMM give the same bits.
            encode = (ozaki2.encode_planes if dtype == torch.float64
                      else ozaki3m.encode_planes_3m)
            ap = encode(a, mu, moduli)
            bp = encode(b.transpose(1, 2), nu.transpose(1, 2), moduli)
            if dtype == torch.float64:
                ap, bp = ap[:, None], bp[:, None]
            for tile_n in (128, 256):
                other = torch.empty_like(out)
                ozaki2.launch_planes(ap, bp, mu, nu, moduli, other,
                                     tile_n=tile_n)
                torch.cuda.synchronize()
                assert torch.equal(other, out), (bt, m, k, n, tile_n)


def test_float64_2d_takes_the_plane_route_and_batches_do_not(cuda_device):
    """A float64 2-D call launches two encodes and one plane GEMM and not
    the fused kernel; so does a float64 batch (the batch is the plane
    route's batch coordinate), while a batch of float32 operands with a
    float64 output still launches the fused kernel's batched form."""
    g = torch.Generator(device=cuda_device).manual_seed(600)
    moduli = default_moduli(12)
    a = _eq19(g, (100, 200), torch.float64, cuda_device)
    b = _eq19(g, (200, 77), torch.float64, cuda_device)
    mu, nu = scheme2.scales(a, b, moduli)
    ozaki2.COUNTS.reset()
    ozaki2.fused_matmul_scheme2(a, b, mu, nu, moduli, torch.float64)
    assert (ozaki2.COUNTS.launches_encode, ozaki2.COUNTS.launches_planes,
            ozaki2.COUNTS.launches_2d, ozaki2.COUNTS.launches_batched) == (
                2, 1, 0, 0)
    ozaki2.COUNTS.reset()
    out = ozaki2.fused_matmul_scheme2(a[None], b[None], mu[None], nu[None],
                                      moduli, torch.float64)
    assert (ozaki2.COUNTS.launches_encode, ozaki2.COUNTS.launches_planes,
            ozaki2.COUNTS.launches_2d, ozaki2.COUNTS.launches_batched) == (
                2, 1, 0, 0)
    assert torch.equal(out[0], ozaki2.fused_matmul_scheme2(
        a, b, mu, nu, moduli, torch.float64))
    x, y = a.float()[None], b.float()[None]
    xmu, ynu = scheme2.scales(x, y, moduli)
    ozaki2.COUNTS.reset()
    ozaki2.fused_matmul_scheme2(x, y, xmu, ynu, moduli, torch.float64)
    assert (ozaki2.COUNTS.launches_encode, ozaki2.COUNTS.launches_planes,
            ozaki2.COUNTS.launches_batched) == (0, 0, 1)
    assert ozaki2.COUNTS.plain_cuda_calls == 0


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
    assert (ozaki3m.COUNTS.launches_encode, ozaki3m.COUNTS.launches_planes,
            ozaki3m.COUNTS.launches_residues,
            ozaki3m.COUNTS.plain_cuda_calls) == (4, 2, 1, 0)
    # A complex batch runs one batched plane route: 2 encodes + 1 GEMM.
    za = a[:64].reshape(2, 32, 160)
    zb = b[:, :32].reshape(160, 2, 16).permute(1, 0, 2)
    batched = api.einsum("bmk,bkn->bmn", za, zb, precision="ozaki2-m12")
    assert (ozaki3m.COUNTS.launches_encode,
            ozaki3m.COUNTS.launches_planes) == (6, 3)
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
    """The prepared form on the plane route (one lhs encode and one plane
    GEMM against the weight's planes, themselves one encode launch)
    against its plain version on the reference-layout stack, and against
    the 2-D form on the same operands: aligned, ragged, a transposed lhs,
    K <= 8, and a weight prepared from a transposed view."""
    from repro_torch.kernels import prepared
    g = torch.Generator(device=cuda_device).manual_seed(p)
    cfg = EmulationConfig(scheme="ozaki2", p=p)
    for m, k, n, trans in [(256, 512, 384, False), (100, 200, 77, False),
                           (33, 130, 50, True), (20, 7, 33, False)]:
        a = (torch.randn((k, m) if trans else (m, k), generator=g,
                         device=cuda_device, dtype=torch.float64) * 3)
        a = (a.T if trans else a).to(dtype)
        b = torch.randn(k, n, generator=g, device=cuda_device,
                        dtype=torch.float64).to(dtype)
        for w in (b, b.T.contiguous().T):
            ozaki2.COUNTS.reset()
            prep = prepared.prepare_rhs(w, cfg)
            assert prep.layout == "planes"
            assert prep.residues.shape == (p, n, ozaki2.plane_k(k))
            assert ozaki2.COUNTS.launches_encode == 1
            mu = scheme2._pow2_int_scale(a, -1, prep.budget_bits)
            out = ozaki2.fused_matmul_scheme2_prepared(
                a, prep.residues, mu, prep.scale, prep.moduli, dtype, n)
            assert (ozaki2.COUNTS.launches_prepared,
                    ozaki2.COUNTS.launches_encode,
                    ozaki2.COUNTS.launches_planes,
                    ozaki2.COUNTS.launches_2d) == (1, 2, 1, 0)
            ref = ozaki2.fused_matmul_scheme2_prepared_plain(
                a, prep.stacked(), mu, prep.scale, prep.moduli, dtype, n)
            torch.cuda.synchronize()
            assert torch.equal(out, ref), (m, k, n, trans)
            assert torch.equal(prepared.matmul_prepared(a, prep, dtype),
                               dispatch.emulated_matmul(a, b, cfg=cfg)), (
                                   m, k, n)


@pytest.mark.parametrize("p", [6, 16])
def test_prepared_plane_kernels_bit_identical_to_plain_on_card(cuda_device,
                                                               p):
    """The real float32 and bf16 instances of the encode kernel (signed
    values, subnormal rows, K <= 8, transposed views) and of the plane
    GEMM (float32 scales of a float32 / bf16 pair, into float32, bf16 and
    float64) against their plain versions, and the twin of a prep."""
    from repro_torch.kernels import prepared
    g = torch.Generator(device=cuda_device).manual_seed(700 + p)
    moduli = default_moduli(p)
    for (m, k, n) in [(512, 2048, 2048), (300, 1000, 520), (9, 5, 11)]:
        for ta in (torch.float32, torch.bfloat16):
            a = torch.randn(m, k, generator=g, device=cuda_device) * 4
            a[:2] *= 2.0 ** -130                     # subnormal rows
            a = a.to(ta)
            bt = torch.randn(n, k, generator=g, device=cuda_device).to(ta)
            for x in (a, bt, bt.T.contiguous().T):
                s = scheme2._pow2_int_scale(x, -1, scheme2.MANTISSA[ta])
                out = ozaki2.encode_planes(x, s, moduli)
                torch.cuda.synchronize()
                assert torch.equal(out, ozaki2.encode_planes_plain(
                    x, s, moduli)), (tuple(x.shape), ta)
            for tb in (torch.float32, torch.bfloat16):
                b = bt.to(tb)
                mu = scheme2._pow2_int_scale(a, -1, 8)
                nu = scheme2._pow2_int_scale(b, -1, 8)
                ap, bp = (ozaki2.encode_planes(x, s, moduli)
                          for x, s in ((a, mu), (b, nu)))
                for out_t in (torch.float32, torch.bfloat16, torch.float64):
                    out = ozaki2.plane_matmul(ap, bp, mu, nu.T, moduli, out_t)
                    ref = ozaki2.plane_matmul_plain(ap, bp, mu, nu.T, moduli,
                                                    out_t)
                    torch.cuda.synchronize()
                    assert torch.equal(out, ref), (m, k, n, ta, tb, out_t)
    cfg = EmulationConfig(scheme="ozaki2", p=p, bwd_p=4)
    w = torch.randn(300, 200, generator=g, device=cuda_device)
    prep = prepared.prepare_rhs(w, cfg, with_twin=True)
    cpu = prepared.prepare_rhs(w.cpu(), dataclasses.replace(cfg,
                                                            backend="cuda"),
                               with_twin=True)
    for x, y in ((prep, cpu), (prep.twin, cpu.twin)):
        assert x.layout == y.layout == "planes"
        assert torch.equal(x.residues.cpu(), y.residues)
        assert torch.equal(x.scale.cpu(), y.scale)


def test_hoisted_step_launches_the_prepared_form(cuda_device):
    """A microbatches=2 step under ozaki2-m6+cached prepares each weight
    once and launches the prepared form for every dense forward and dA,
    with no plain version on CUDA."""
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
    assert ozaki2.COUNTS.launches_planes == ozaki2.COUNTS.launches_prepared
    # An lhs encode per prepared call; a weight and its twin encoded once
    # a step, the head once a microbatch.
    assert ozaki2.COUNTS.launches_encode == (
        ozaki2.COUNTS.launches_prepared + 2 * (7 * layers + 2))
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
        split = flash_attn.instance(dtype, d).kernel == "wgmma-3xtf32"
        assert (flash_attn.COUNTS.launches,
                flash_attn.COUNTS.launches_split) == (1, int(split))
        ref = flash_attn.flash_attention_plain(q, k, v, causal, window)
        torch.cuda.synchronize()
        assert out.dtype == dtype and out.shape == q.shape
        torch.testing.assert_close(out.float(), ref.float(), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("d", [32, 64, 128])
def test_flash_3xtf32_edges_on_card(cuda_device, d):
    """The float32 3xTF32 kernel at the bf16 kernel's edges, within 2e-5
    of the plain version, and its pre-pass bit for bit with its plain
    version (v^T's permuted keys and zeros past Sk included)."""
    from repro_torch.kernels import flash_attn
    assert flash_attn.instance(torch.float32, d).kernel == "wgmma-3xtf32"
    g = torch.Generator(device=cuda_device).manual_seed(2000 + d)
    cases = [(1, 2, 2, 100, 333, True, None), (1, 4, 2, 333, 100, True, None),
             (1, 2, 2, 1, 77, False, None), (2, 4, 1, 257, 257, True, 96),
             (1, 6, 3, 200, 200, False, 130), (1, 4, 1, 1100, 1100, True, None),
             (1, 2, 2, 128, 1, True, None)]
    for (b, h, kvh, sq, sk, causal, window) in cases:
        q, k, v = (torch.randn(b, n, s, d, generator=g, device=cuda_device)
                   for n, s in ((h, sq), (kvh, sk), (kvh, sk)))
        parts = flash_attn.split_3xtf32(q, k, v)
        plain = flash_attn.split_3xtf32_plain(q, k, v)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(parts, plain)), (sq, sk)
        flash_attn.COUNTS.reset()
        out = flash_attn.flash_attention(q, k, v, causal=causal,
                                         window=window, bq=sq, bk=sk)
        assert (flash_attn.COUNTS.launches,
                flash_attn.COUNTS.launches_split) == (1, 1)
        ref = flash_attn.flash_attention_plain(q, k, v, causal, window)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_flash_wgmma_edges_on_card(cuda_device, d):
    """The bf16 wgmma kernel at its edges, within 2e-2 of the plain
    version: Sk past a 64- and 128-key tile edge, Sq > Sk under a causal
    mask, one query row, a window inside and across tiles with GQA, MQA
    over many q tiles (heaviest first), one key."""
    from repro_torch.kernels import flash_attn
    assert flash_attn.instance(torch.bfloat16, d).kernel == "wgmma"
    g = torch.Generator(device=cuda_device).manual_seed(1000 + d)
    cases = [(1, 2, 2, 100, 333, True, None), (1, 4, 2, 333, 100, True, None),
             (1, 2, 2, 1, 77, False, None), (2, 4, 1, 257, 257, True, 96),
             (1, 6, 3, 200, 200, False, 130), (1, 4, 1, 1100, 1100, True, None),
             (1, 2, 2, 128, 1, True, None)]
    for (b, h, kvh, sq, sk, causal, window) in cases:
        q, k, v = (torch.randn(b, n, s, d, generator=g,
                               device=cuda_device).to(torch.bfloat16)
                   for n, s in ((h, sq), (kvh, sk), (kvh, sk)))
        flash_attn.COUNTS.reset()
        out = flash_attn.flash_attention(q, k, v, causal=causal,
                                         window=window, bq=sq, bk=sk)
        assert flash_attn.COUNTS.launches == 1
        ref = flash_attn.flash_attention_plain(q, k, v, causal, window)
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2,
                                   atol=2e-2)


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
