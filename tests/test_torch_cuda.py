"""The port's CUDA kernels on the card: EmuGEMM-I (its plane route: the
encode and the plane GEMM of the 2-D and mixed routes, and the relayout of
the interleaved form's route; its batched kernel), the decomposition (K2,
K2r, K11), the int8 GEMM (K9, the plane GEMM's int32 instance), fused attention (K10: the bf16 wgmma
kernel, the float32 3xTF32 wgmma kernel and its pre-pass, the float32 FFMA kernel at D = 256), EmuGEMM-II's
plane route (the encode kernels and the plane GEMM) for every product of
float operands, 2-D and batched (K5g and K6
with a float rhs: float32, bfloat16 in any pairing and float64; K7g), and
for the prepared form (K5g with a residue rhs: float32, bfloat16 and
float64), and its residue forms K5 and K7 (the relayout and the residue
plane GEMM) against their plain versions,
bit for bit (attention within its bars), the dispatcher's routing of
CUDA tensors (complex 4M included), and train steps that launch them
(a hoisted microbatch step among them); the prefill / decode path at 4
query heads a KV head on both backends, K3 against granite-3-8b's
prepared head, and K4 at deepseek-v3-671b's expert stacks, K1 at MLA's
latent decompression and deepseek-v3's smoke model on both backends.

These tests need an NVIDIA GPU and nvcc; they skip elsewhere. This file
imports no jax, so it runs where only torch is installed. The instances
of Scheme I in float64, at p = 9..16 and with a float16 output are held
against their plain versions at the end (``test_scheme1_wide_*``):

    python -m pytest -m cuda tests/test_torch_cuda.py
"""

import dataclasses
import math

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
    """float16 operands (the backends widen them first) and p past 16."""
    a = torch.randn(8, 16, device=cuda_device, dtype=torch.float16)
    mu = scheme1.pow2_scale(a, -1)
    with pytest.raises(NotImplementedError):
        ozaki1.fused_matmul_scheme1(a, a.T, mu, mu.T, 4, 7, torch.float16)
    b = torch.randn(8, 16, device=cuda_device)
    s = scheme1.pow2_scale(b, -1)
    with pytest.raises(NotImplementedError):
        ozaki1.fused_matmul_scheme1(b, b.T, s, s.T, 17, 7, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [1, 3, 4, 8])
def test_plane_route_bit_identical_to_plain_on_card(cuda_device, dtype, p):
    """The encode against encode_planes_plain, the plane GEMM (both tile
    heights) against plane_matmul_plain, and the 2-D route's launches."""
    g = torch.Generator(device=cuda_device).manual_seed(p)
    for (m, k, n, trans) in [(4, 2048, 2048, False), (64, 1000, 77, True),
                             (300, 2048, 520, False), (37, 100, 29, True)]:
        a = torch.randn(m, k, generator=g, device=cuda_device).to(dtype)
        b = (torch.randn(n, k, generator=g, device=cuda_device).T if trans
             else torch.randn(k, n, generator=g, device=cuda_device))
        b = b.to(dtype)
        mu, nu = scheme1.pow2_scale(a, -1), scheme1.pow2_scale(b, -2)
        ozaki1.COUNTS.reset()
        pa = ozaki1.encode_planes(a, mu, p, 6)
        pb = ozaki1.encode_planes(b.T, nu.T, p, 6)
        assert (ozaki1.COUNTS.launches_encode, ozaki1.COUNTS.plain_cuda_calls
                ) == (2, 0)
        assert torch.equal(pa, ozaki1.encode_planes_plain(a, mu, p, 6))
        assert torch.equal(pb, ozaki1.encode_planes_plain(b.T, nu.T, p, 6))
        ref = ozaki1.plane_matmul_plain(pa, pb, mu, nu, p, 6, dtype)
        for tile_m in (64, 128):
            out = torch.empty((m, n), dtype=dtype, device=cuda_device)
            ozaki1.launch_planes(pa, pb, mu, nu, p, 6, out, tile_m=tile_m)
            torch.cuda.synchronize()
            assert torch.equal(out, ref), (m, k, n, tile_m)
        ozaki1.COUNTS.reset()
        out = ozaki1.fused_matmul_scheme1(a, b, mu, nu, p, 6, dtype)
        assert (ozaki1.COUNTS.launches_2d, ozaki1.COUNTS.launches_encode,
                ozaki1.COUNTS.launches_planes) == (1, 2, 1)
        assert torch.equal(out, ozaki1.fused_matmul_plain(a, b, mu, nu, p, 6,
                                                          dtype))


def test_plane_gemm_wraps_int32_on_card(cuda_device):
    """A diagonal of slice products past 2^31 wraps as the plain version's
    int32 accumulators do."""
    k, p = 50688, 4
    pa = torch.full((p, 64, ozaki1.plane_k(k)), 127, dtype=torch.int8,
                    device=cuda_device)
    pa[:, :, k:] = 0
    pb = pa[:, :32].contiguous()
    mu = torch.ones(64, 1, device=cuda_device)
    nu = torch.ones(1, 32, device=cuda_device)
    out = ozaki1.plane_matmul(pa, pb, mu, nu, p, 7, torch.float32)
    ref = ozaki1.plane_matmul_plain(pa, pb, mu, nu, p, 7, torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


def _batched_operands(g, dev, dtype, batch, m, k, n, layout):
    """A (batch, m, k) and B (batch, k, n) in one of the batched kernel's
    operand layouts: 'contiguous'; 'ck' (B a transposed K-contiguous view
    of a (batch, n, k) cache); 'cv' (B the N-contiguous rows of a
    (batch, k, n) cache); 'sliced' (both sliced out of larger buffers, so
    that each batch stride exceeds rows x row stride)."""
    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)
    if layout == "sliced":
        a = randn(batch, m + 3, k + 5)[:, 1:m + 1, 2:k + 2]
        b = randn(batch, k + 2, n + 7)[:, 1:k + 1, 3:n + 3]
    else:
        a = randn(batch, m, k)
        b = randn(batch, n, k).transpose(1, 2) if layout == "ck" else \
            randn(batch, k, n)
    return a, b


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [1, 3, 4, 6, 8])
def test_batched_kernel_bit_identical_to_plain_on_card(cuda_device, dtype, p):
    """The batched kernel, one launch a call, against fused_matmul_plain
    at serving's attn_qk / attn_av shapes (mixed and decode), ragged
    shapes and every operand layout, in both output types."""
    g = torch.Generator(device=cuda_device).manual_seed(p)
    cases = [(64, 16, 128, 80, "ck"), (64, 16, 80, 128, "cv"),
             (64, 1, 128, 80, "ck"), (64, 1, 80, 128, "cv"),
             (3, 17, 1, 77, "contiguous"), (3, 17, 129, 77, "sliced"),
             (3, 17, 1000, 77, "ck"), (2, 100, 300, 65, "cv")]
    for batch, m, k, n, layout in cases:
        a, b = _batched_operands(g, cuda_device, dtype, batch, m, k, n,
                                 layout)
        mu, nu = scheme1.pow2_scale(a, -1), scheme1.pow2_scale(b, -2)
        for out_dtype in (dtype, torch.float32):
            ozaki1.COUNTS.reset()
            out = ozaki1.fused_matmul_scheme1(a, b, mu, nu, p, 7, out_dtype)
            assert (ozaki1.COUNTS.launches_batched,
                    ozaki1.COUNTS.plain_cuda_calls) == (1, 0)
            ref = ozaki1.fused_matmul_plain(a, b, mu, nu, p, 7, out_dtype)
            torch.cuda.synchronize()
            assert torch.equal(out, ref), (batch, m, k, n, layout, out_dtype)


def test_batched_kernel_wraps_int32_on_card(cuda_device):
    """A batched product whose top diagonal passes 2^31 wraps as the plain
    version's int32 accumulators do (both tile heights)."""
    k, p = 50688, 4
    a = torch.full((2, 40, k), 1 - 2 ** -24, device=cuda_device)
    b = torch.full((2, k, 70), 1 - 2 ** -24, device=cuda_device)
    mu, nu = scheme1.pow2_scale(a, -1), scheme1.pow2_scale(b, -2)
    ref = ozaki1.fused_matmul_plain(a, b, mu, nu, p, 7, torch.float32)
    for tile_n in (16, 32):
        out = ozaki1.launch_batched(a, b, mu, nu, p, 7, torch.float32,
                                    tile_n=tile_n)
        torch.cuda.synchronize()
        assert torch.equal(out, ref), tile_n


@pytest.mark.parametrize("p", [1, 4, 8])
def test_interleaved_relayout_and_route_on_card(cuda_device, p):
    """K8's route: each relayout against relayout_interleaved_plain, the
    route (2 relayouts + 1 plane GEMM) against
    fused_matmul_interleaved_plain, bit for bit."""
    g = torch.Generator(device=cuda_device).manual_seed(p)
    for (m, k, n) in [(256, 2048, 512), (37, 1000, 77), (1, 33, 5),
                      (130, 96, 258)]:
        a = torch.randn(m, k, generator=g, device=cuda_device)
        b = torch.randn(k, n, generator=g, device=cuda_device)
        mu, nu = scheme1.pow2_scale(a, 1), scheme1.pow2_scale(b, 0)
        a_hat = decompose.decompose_interleave(a, mu, p, 7)
        b_hat = decompose.decompose_interleave_rhs(b, nu, p, 7)
        for x, operand in ((a_hat, "a"), (b_hat, "b")):
            assert torch.equal(ozaki1.relayout_interleaved(x, p, operand),
                               ozaki1.relayout_interleaved_plain(x, p,
                                                                 operand))
        ozaki1.COUNTS.reset()
        out = ozaki1.fused_matmul_interleaved(a_hat, b_hat, mu, nu, p, 7,
                                              torch.bfloat16)
        c = ozaki1.COUNTS
        assert (c.launches_interleaved, c.launches_relayout, c.launches_planes,
                c.plain_cuda_calls) == (1, 2, 1, 0)
        ref = ozaki1.fused_matmul_interleaved_plain(a_hat, b_hat, mu, nu, p,
                                                    7, torch.bfloat16)
        torch.cuda.synchronize()
        assert torch.equal(out, ref), (m, k, n)


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
        planes = ozaki1.encode_planes(b.T, nu.T, p, 7)
        a = torch.randn(37, k, generator=g, device=cuda_device).to(dtype)
        mu = scheme1.pow2_scale(a, -1)
        out = ozaki1.fused_matmul_mixed(a, planes, mu, nu, p, 7, dtype)
        ref = ozaki1.fused_matmul_mixed_plain(a, fwd, mu, nu, p, 7, dtype)
        torch.cuda.synchronize()
        assert torch.equal(fwd, rfwd) and torch.equal(twin, rtwin), (k, n)
        assert torch.equal(rhs, rfwd), (k, n)
        assert torch.equal(out, ref), (k, n)
        # The mixed route equals the 2-D route that encodes B itself.
        assert torch.equal(out, ozaki1.fused_matmul_scheme1(
            a, b, mu, nu, p, 7, dtype))


def test_scheme1_prep_on_card_holds_the_planes(cuda_device):
    """A Scheme-I prep of a CUDA weight is the 'planes' layout, one encode
    a weight and one for its twin, equal to the plain encode on the CPU."""
    from repro_torch.kernels import prepared
    g = torch.Generator(device=cuda_device).manual_seed(11)
    cfg = EmulationConfig(scheme="ozaki1", p=4, bwd_p=3)
    w = torch.randn(300, 200, generator=g, device=cuda_device)
    ozaki1.COUNTS.reset()
    prep = prepared.prepare_rhs(w, cfg, with_twin=True)
    assert ozaki1.COUNTS.launches_encode == 2
    cpu = prepared.prepare_rhs(w.cpu(), dataclasses.replace(cfg,
                                                            backend="cuda"),
                               with_twin=True)
    for x, y in ((prep, cpu), (prep.twin, cpu.twin)):
        assert x.layout == y.layout == "planes"
        assert torch.equal(x.slices.cpu(), y.slices)
        assert torch.equal(x.scale.cpu(), y.scale)


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
    # The weights' planes and their twins: two encodes a prepared weight.
    assert ozaki1.COUNTS.launches_encode > 0
    assert decompose.COUNTS.launches_pair == 0
    assert ozaki1.COUNTS.launches_mixed > 0
    assert ozaki1.COUNTS.launches_2d > 0 and ozaki1.COUNTS.launches_batched > 0
    assert ozaki1.COUNTS.plain_cuda_calls == 0
    assert decompose.COUNTS.plain_cuda_calls == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [4, 6, 8, 16])
def test_scheme2_kernel_bit_identical_to_plain_on_card(cuda_device, dtype, p):
    """K5g (2-D), K6 (batched, plain strides and transposed views), each
    two encodes and one plane GEMM, and K5 (residues) against their plain
    versions."""
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
        ozaki2.COUNTS.reset()
        out = ozaki2.fused_matmul_scheme2(a, b, mu, nu, moduli, dtype)
        assert (ozaki2.COUNTS.launches_encode,
                ozaki2.COUNTS.launches_planes) == (2, 1)
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
    assert (ozaki2.COUNTS.launches_encode, ozaki2.COUNTS.launches_planes) == (
        2, 1)
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
    assert ozaki2.COUNTS.launches_planes == ozaki2.COUNTS.launches_batched
    assert ozaki2.COUNTS.launches_encode == 2 * ozaki2.COUNTS.launches_batched
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
    float32 operands to a float64 out), K6 (batched, transposed views),
    all on the plane route, and the residue route of
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
            ozaki2.COUNTS.plain_cuda_calls) == (2, 1, 1, 1, 0)


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
    """Every float-rhs call is a front-door call of its form and launches
    two encodes and one plane GEMM: a float64 2-D call, a float64 batch
    (the batch is the plane route's batch coordinate) and a batch of
    float32 operands with a float64 output."""
    g = torch.Generator(device=cuda_device).manual_seed(600)
    moduli = default_moduli(12)
    a = _eq19(g, (100, 200), torch.float64, cuda_device)
    b = _eq19(g, (200, 77), torch.float64, cuda_device)
    mu, nu = scheme2.scales(a, b, moduli)
    ozaki2.COUNTS.reset()
    ozaki2.fused_matmul_scheme2(a, b, mu, nu, moduli, torch.float64)
    assert (ozaki2.COUNTS.launches_encode, ozaki2.COUNTS.launches_planes,
            ozaki2.COUNTS.launches_2d, ozaki2.COUNTS.launches_batched) == (
                2, 1, 1, 0)
    ozaki2.COUNTS.reset()
    out = ozaki2.fused_matmul_scheme2(a[None], b[None], mu[None], nu[None],
                                      moduli, torch.float64)
    assert (ozaki2.COUNTS.launches_encode, ozaki2.COUNTS.launches_planes,
            ozaki2.COUNTS.launches_2d, ozaki2.COUNTS.launches_batched) == (
                2, 1, 0, 1)
    assert torch.equal(out[0], ozaki2.fused_matmul_scheme2(
        a, b, mu, nu, moduli, torch.float64))
    x, y = a.float()[None], b.float()[None]
    xmu, ynu = scheme2.scales(x, y, moduli)
    ozaki2.COUNTS.reset()
    ozaki2.fused_matmul_scheme2(x, y, xmu, ynu, moduli, torch.float64)
    assert (ozaki2.COUNTS.launches_encode, ozaki2.COUNTS.launches_planes,
            ozaki2.COUNTS.launches_batched) == (2, 1, 1)
    assert ozaki2.COUNTS.plain_cuda_calls == 0


@pytest.mark.parametrize("p", [1, 4, 6, 16])
def test_scheme2_float_plane_route_on_card(cuda_device, p):
    """K5g and K6 on float32 / bf16 operands on the plane route against
    the plain versions, bit for bit: every operand pairing and output
    type on dB's shape (A = X^T read through its strides, K = 512),
    ragged and K <= 8 shapes, a batch read with both operands transposed
    (attention's backward) and a batch whose rhs has batch stride 0 (an
    expanded view); each encode alone against its plain version on a
    transposed operand; each call two encodes and one plane GEMM."""
    g = torch.Generator(device=cuda_device).manual_seed(700 + p)
    moduli = default_moduli(p)
    bf, f32 = torch.bfloat16, torch.float32

    def draw(shape, dtype, transposed=False):
        x = _eq19(g, shape[:-2] + shape[-2:][::-1] if transposed else shape,
                  f32, cuda_device).to(dtype)
        return x.transpose(-1, -2) if transposed else x

    cases = [((), 300, 512, 520, True, False), ((), 37, 70, 29, True, True),
             ((), 9, 5, 11, False, False), ((6,), 40, 128, 72, True, True)]
    for lead, m, k, n, ta, tb in cases:
        for ta_t, tb_t in ((f32, f32), (bf, bf), (f32, bf), (bf, f32)):
            a = draw(lead + (m, k), ta_t, ta)
            b = draw(lead + (k, n), tb_t, tb)
            mu, nu = scheme2.scales(a, b, moduli)
            for x, s in ((a, mu), (b.transpose(-1, -2), nu.transpose(-1, -2))):
                out = ozaki2.encode_planes(x, s, moduli)
                torch.cuda.synchronize()
                assert torch.equal(out, ozaki2.encode_planes_plain(
                    x, s, moduli)), (tuple(x.shape), x.stride(), x.dtype)
            for out_t in (f32, bf, torch.float64):
                ozaki2.COUNTS.reset()
                out = ozaki2.fused_matmul_scheme2(a, b, mu, nu, moduli, out_t)
                c = ozaki2.COUNTS
                assert (c.launches_2d + c.launches_batched, c.launches_encode,
                        c.launches_planes) == (1, 2, 1)
                ref = ozaki2.fused_matmul_scheme2_plain(a, b, mu, nu, moduli,
                                                        out_t)
                torch.cuda.synchronize()
                assert out.dtype == out_t
                assert torch.equal(out, ref), (lead, m, k, n, ta_t, tb_t,
                                               out_t)
    a = draw((4, 16, 128), bf)
    b = draw((1, 128, 64), bf).expand(4, 128, 64)
    mu, nu = scheme2.scales(a, b, moduli)
    ozaki2.COUNTS.reset()
    out = ozaki2.fused_matmul_scheme2(a, b, mu, nu, moduli, bf)
    c = ozaki2.COUNTS
    assert (c.launches_batched, c.launches_encode, c.launches_planes,
            c.plain_cuda_calls) == (1, 2, 1, 0)
    torch.cuda.synchronize()
    assert torch.equal(out, ozaki2.fused_matmul_scheme2_plain(
        a, b, mu, nu, moduli, bf))


def test_complex_routes_on_card(cuda_device):
    """The front doors launch K7g (and ops.fused_3m_matmul K7) with no
    plain version on CUDA; complex64 under ozaki1 is four EmuGEMM-I
    launches equal to matmul_complex_4m (complex128 too, of float64
    parts); what the port does not run raises instead of falling back."""
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
    ozaki1.COUNTS.reset()
    out = dispatch.emulated_matmul(a, b, cfg="ozaki1-p4")   # complex128: 4M
    assert (ozaki1.COUNTS.launches_2d, ozaki1.COUNTS.plain_cuda_calls) == (4, 0)
    assert torch.equal(out, dispatch.emulated_matmul(a, b, cfg="ozaki1-p4",
                                                     backend="torch"))
    cfg17 = EmulationConfig(scheme="ozaki2", p=17,
                            moduli=DEFAULT_MODULI + (181,))
    with pytest.raises(NotImplementedError, match="at most 16 moduli"):
        dispatch.emulated_matmul(a, b, cfg=cfg17)
    # A differentiated complex product: conj of the reference's VJP of
    # conj(g), through the kernels.
    x = a.clone().requires_grad_()
    gc = _eq19(g, (96, 40), torch.complex128, cuda_device)
    api.einsum("mk,kn->mn", x, b, precision="ozaki2-m8").backward(gc)
    assert torch.equal(x.grad, api.einsum(
        "mk,kn->mn", gc.conj_physical(), b.T, precision="ozaki2-m8").conj())


# ---------------------------------------------------------------------------
# EmuGEMM-II's prepared form (K5g with a residue rhs) and the hoisted step.
# ---------------------------------------------------------------------------

# (p, 3, M, K) phase stacks and (p, M, K) residues in layouts the residue
# route reads in place or lays out first.
RESIDUE_MODULI = {1: (255,), 6: (3, 5, 7, 11, 13, 256), 16: default_moduli(16)}


def _residue_operands(g, dev, p, lead, m, k, n):
    """(label, a, b) int8 residues (p, *lead, M, K) @ (p, *lead, K, N),
    full-range: contiguous; B as the transposed view of B^T's residues;
    an A whose modulus / phase strides are not the contiguous ones; a
    base one byte off."""
    def res(*shape):
        return torch.randint(-128, 128, shape, generator=g, device=dev,
                             dtype=torch.int8)
    a, b = res(p, *lead, m, k), res(p, *lead, k, n)
    perm = (1, 2, 0, 3) if lead else (1, 0, 2)
    a_perm = res(m, p, *lead, k).permute(*perm)
    a_off = res(p * math.prod(lead) * m * k + 1)[1:].view(p, *lead, m, k)
    return [("contiguous", a, b),
            ("B^T view", a, res(p, *lead, n, k).transpose(-1, -2)),
            ("strided A", a_perm, b), ("offset A", a_off, b)]


@pytest.mark.parametrize("p", [1, 6, 16])
def test_residue_route_bit_identical_to_plain_on_card(cuda_device, p):
    """K5 and K7 on the residue route (relayouts where a tensor map cannot
    read an operand, then one residue plane GEMM) against their plain
    versions, bit for bit, and the pieces against theirs (the relayout
    alone on every case's A and B^T, the zero residues past K included)."""
    g = torch.Generator(device=cuda_device).manual_seed(900 + p)
    moduli = RESIDUE_MODULI[p]
    for m, k, n in [(1, 1, 1), (17, 15, 129), (129, 127, 300), (300, 129, 17),
                    (128, 4096, 256)]:
        for lbl, a, b in _residue_operands(g, cuda_device, p, (), m, k, n):
            ozaki2.COUNTS.reset()
            out = ozaki2.fused_residue_matmul(a, b, moduli)
            relaid = ozaki2.COUNTS.launches_relayout
            want = sum(ozaki2.tma_strides(x.shape, x.stride(),
                                          x.data_ptr()) is None
                       for x in (a, b.transpose(-1, -2)))
            assert (ozaki2.COUNTS.launches_residues, relaid) == (1, want)
            ref = ozaki2.fused_residue_matmul_plain(a, b, moduli)
            torch.cuda.synchronize()
            assert torch.equal(out, ref), (lbl, m, k, n)
            for x in (a, b.transpose(-1, -2)):
                assert torch.equal(ozaki2.relayout_planes(x),
                                   ozaki2.relayout_planes_plain(x)), (
                    "relayout", lbl, m, k, n)
        for lbl, a3, b3 in _residue_operands(g, cuda_device, p, (3,), m, k, n):
            ozaki3m.COUNTS.reset()
            out = ozaki3m.fused_3m_residue_matmul(a3, b3, moduli)
            assert ozaki3m.COUNTS.launches_residues == 1
            ref = ozaki3m.fused_3m_residue_matmul_plain(a3, b3, moduli)
            torch.cuda.synchronize()
            assert all(torch.equal(x, y) for x, y in zip(out, ref)), (lbl, m,
                                                                     k, n)
            for x in (a3, b3.transpose(-1, -2)):
                assert torch.equal(ozaki2.relayout_planes(x),
                                   ozaki2.relayout_planes_plain(x)), (
                    "relayout 3m", lbl, m, k, n)
    a = torch.randint(-128, 128, (p, 3, 100, 200), generator=g,
                      device=cuda_device, dtype=torch.int8)
    b_t = torch.randint(-128, 128, (p, 3, 77, 200), generator=g,
                        device=cuda_device, dtype=torch.int8)
    pa, pb = ozaki2.relayout_planes(a), ozaki2.relayout_planes(b_t)
    torch.cuda.synchronize()
    assert torch.equal(pa, ozaki2.relayout_planes_plain(a))
    assert torch.equal(ozaki2.residue_planes(pa[:, 0], pb[:, 0], moduli),
                       ozaki2.residue_planes_plain(pa[:, 0], pb[:, 0], moduli))
    for x, y in zip(ozaki3m.residue_planes_3m(pa, pb, moduli),
                    ozaki3m.residue_planes_3m_plain(pa, pb, moduli)):
        assert torch.equal(x, y)
    assert ozaki2.COUNTS.plain_cuda_calls > 0      # the references above


def test_residue_route_wraps_int32_on_card(cuda_device):
    """All -128 over K = 131200, mod 255: each int32 sum wraps, and the
    route wraps as the plain version (and the reference) does."""
    a = torch.full((1, 128, 131200), -128, dtype=torch.int8,
                   device=cuda_device)
    b = torch.full((1, 131200, 128), -128, dtype=torch.int8,
                   device=cuda_device)
    out = ozaki2.fused_residue_matmul(a, b, (255,))
    ref = ozaki2.fused_residue_matmul_plain(a, b, (255,))
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    assert (ref != (131200 * 2 ** 14 + 127) % 255 - 127).all()


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
    c = ozaki2.COUNTS
    assert c.launches_prepared == 2 * (21 * layers + 2)
    assert c.launches_2d == 2 * (7 * layers + 1)   # dB
    assert c.launches_batched > 0                  # attention
    # A plane GEMM a call; an lhs encode per prepared call, two per
    # float-rhs call; a weight and its twin encoded once a step, the head
    # once a microbatch.
    float_rhs = c.launches_2d + c.launches_batched
    assert c.launches_planes == c.launches_prepared + float_rhs
    assert c.launches_encode == (c.launches_prepared + 2 * float_rhs
                                 + 2 * (7 * layers + 2))
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
    """K9 on the plane GEMM's int32 instance against its plain version, bit
    for bit, with its launches counted: one plane GEMM a call and one
    relayout for each operand the tensor map cannot read in place (B as it
    arrives, N-contiguous; A where its base or row stride is not 16-byte
    aligned); a transposed view of an aligned (N, K) buffer is read in
    place; an int32 sum that wraps."""
    from repro_torch.kernels import matmul_int8
    g = torch.Generator(device=cuda_device).manual_seed(9)

    def i8(*shape):
        return torch.randint(-128, 128, shape, generator=g,
                             device=cuda_device, dtype=torch.int8)
    wide = i8(37, 1025)
    cases = [(i8(512, 1024), i8(1024, 768), 1), (i8(37, 1000), i8(1000, 77), 2),
             (i8(130, 4096), i8(4096, 200), 1), (i8(1, 7), i8(7, 3), 1),
             (i8(37, 1000), i8(77, 1000).T, 2),   # both misaligned
             (i8(37, 1024), i8(77, 1024).T, 0),   # B^T read in place
             (wide[:, 1:], i8(1024, 64), 2),      # A's base misaligned
             (i8(1000, 3000), i8(3000, 777), 2)]
    for a, b, relayouts in cases:
        matmul_int8.COUNTS.reset()
        out = matmul_int8.int8_matmul(a, b)
        c = matmul_int8.COUNTS
        assert (c.launches, c.launches_relayout, c.plain_cuda_calls) == (
            1, relayouts, 0), (tuple(a.shape), tuple(b.shape))
        ref = matmul_int8.int8_matmul_plain(a, b)
        torch.cuda.synchronize()
        assert torch.equal(out, ref), (tuple(a.shape), tuple(b.shape))
    # 131200 * (-128)^2 passes 2^31: the int32 sum wraps, as the
    # reference's does.
    a = torch.full((128, 131200), -128, dtype=torch.int8, device=cuda_device)
    out = matmul_int8.int8_matmul(a, a.T.contiguous())
    torch.cuda.synchronize()
    assert torch.equal(out, matmul_int8.int8_matmul_plain(a, a.T))
    assert int(out[0, 0]) == 131200 * 128 * 128 - 2 ** 32


def _decompose_operand(g, k, n, layout, dtype, dev):
    """A (K, N) operand: contiguous, the transposed view of an (N, K)
    table (emb.T), or columns 1..N of a wider buffer (strided, base
    misaligned)."""
    if layout == "emb.T":
        return torch.randn(n, k, generator=g, device=dev).to(dtype).T
    if layout == "strided":
        return torch.randn(k, n + 3, generator=g, device=dev).to(dtype)[:, 1:n + 1]
    return torch.randn(k, n, generator=g, device=dev).to(dtype)


@pytest.mark.parametrize("p", [1, 2, 3, 4, 5, 6, 7, 8])
def test_decomposition_bit_identical_on_card(cuda_device, p):
    """K2, K2r and K11 against their plain versions, bit for bit: ragged K
    and N around the kernel's 64 tile and the 32 interleave, contiguous,
    emb.T-style and strided operands, float32 and bf16, beta 1 and 7, and
    scales of 2^127, whose reciprocal is subnormal."""
    g = torch.Generator(device=cuda_device).manual_seed(700 + p)
    dims = [(1, 1), (31, 33), (33, 31), (127, 129), (129, 127), (1000, 1000)]
    for dtype in (torch.float32, torch.bfloat16):
        for beta in (1, 7):
            for k, n in dims:
                for layout in ("rows", "emb.T", "strided"):
                    b = _decompose_operand(g, k, n, layout, dtype, cuda_device)
                    scales = [(scheme1.pow2_scale(b, -2),
                               scheme1.pow2_scale(b, -1).T)]
                    if (k, n) == (127, 129):    # 1 / 2^127 is subnormal
                        b = (b.float() * 2.0 ** 120).to(dtype)
                        big = torch.tensor(2.0 ** 127, device=cuda_device)
                        scales = [(big.expand(1, n), big.expand(1, k))]
                    for nu, tau in scales:
                        what = (k, n, layout, dtype, beta)
                        decompose.COUNTS.reset()
                        fwd, twin = decompose.decompose_interleave_pair(
                            b, nu, tau, p, beta, 8 - beta)
                        rhs = decompose.decompose_interleave_rhs(b, nu, p,
                                                                 beta)
                        mu = tau.T
                        lhs = decompose.decompose_interleave(b, mu, p, beta)
                        c = decompose.COUNTS
                        assert (c.launches_pair, c.launches_rhs,
                                c.launches_lhs, c.plain_cuda_calls) == (
                                    1, 1, 1, 0), what
                        rf, rt = decompose.decompose_pair_plain(
                            b, nu, tau, p, beta, 8 - beta)
                        torch.cuda.synchronize()
                        assert torch.equal(fwd, rf), what
                        assert torch.equal(twin, rt), what
                        assert torch.equal(rhs, decompose.decompose_rhs_plain(
                            b, nu, p, beta)), what
                        assert torch.equal(lhs, decompose.decompose_lhs_plain(
                            b, mu, p, beta)), what


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2),
                                       (torch.float16, 2.5e-3)])
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


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2),
                                       (torch.float16, 2.5e-3)])
@pytest.mark.parametrize("d", [8, 40, 80, 120, 136, 192, 248])
def test_flash_attention_any_head_dim_on_card(cuda_device, dtype, tol, d):
    """A head dim without an instance of its own runs on the next one:
    the tensor maps read only D columns (the rest arrive as zeros) and
    the kernels store only D; within the bars of the plain version, the
    3xTF32 pre-pass bit for bit with its plain version (v^T's D rows),
    every output finite, and o's row stride D. Ragged D and D > 256 raise
    on the card too, before any launch."""
    from repro_torch.kernels import flash_attn
    g = torch.Generator(device=cuda_device).manual_seed(3000 + d)
    for (b, h, kvh, sq, sk, causal, window) in [
            (1, 4, 2, 200, 200, True, None), (1, 2, 2, 100, 333, False, None),
            (2, 4, 1, 257, 257, True, 96)]:
        q, k, v = (torch.randn(b, n, s, d, generator=g, device=cuda_device)
                   .to(dtype) for n, s in ((h, sq), (kvh, sk), (kvh, sk)))
        kernel = flash_attn.instance(dtype, d).kernel
        if kernel == "wgmma-3xtf32":
            parts = flash_attn.split_3xtf32(q, k, v)
            plain = flash_attn.split_3xtf32_plain(q, k, v)
            torch.cuda.synchronize()
            assert all(torch.equal(x, y) for x, y in zip(parts, plain))
        flash_attn.COUNTS.reset()
        out = flash_attn.flash_attention(q, k, v, causal=causal,
                                         window=window, bq=sq, bk=sk)
        assert flash_attn.COUNTS.launches == 1
        ref = flash_attn.flash_attention_plain(q, k, v, causal, window)
        torch.cuda.synchronize()
        assert out.dtype == dtype and out.shape == q.shape
        assert out.stride()[-2] == d and bool(torch.isfinite(out).all())
        torch.testing.assert_close(out.float(), ref.float(), rtol=tol,
                                   atol=tol)
    for bad in (44, 264):
        x = torch.randn(1, 2, 64, bad, device=cuda_device).to(dtype)
        flash_attn.COUNTS.reset()
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            flash_attn.flash_attention(x, x, x)
        assert flash_attn.COUNTS.launches == 0


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
    a = torch.randn(8, 16, device=cuda_device, dtype=torch.float16)
    with pytest.raises(NotImplementedError):
        decompose.decompose_interleave(a, scheme1.pow2_scale(a, 1), 4, 7)
    x = a.double()
    with pytest.raises(NotImplementedError):
        decompose.decompose_interleave(x, scheme1.pow2_scale(x, 1), 17, 7)
    q = torch.randn(1, 2, 64, 44, device=cuda_device)     # ragged D
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        flash_attn.flash_attention(q, q, q)
    q = torch.randn(1, 2, 64, 64, device=cuda_device, dtype=torch.float64)
    with pytest.raises(NotImplementedError):
        flash_attn.flash_attention(q, q, q)
    x = torch.zeros(8, 64, device=cuda_device, dtype=torch.int8)
    mu = torch.ones(8, 1, device=cuda_device)
    with pytest.raises(ValueError):         # 64 is not p * Kp for p = 3
        ozaki1.fused_matmul_interleaved(x, x.T.contiguous(), mu, mu.T, 3, 7)


@pytest.mark.parametrize("m", [1, 4, 48])
def test_prepared_head_k3_on_card(cuda_device, m):
    """The served logits GEMM of granite-3-8b: a (m, 4096) bf16 lhs
    against the head's planes (4096 x 49664, one encode when prepared)
    is one mixed call (an lhs encode + one plane GEMM), equal bit for bit
    to the unprepared product on the 'torch' backend (plain versions)."""
    from repro_torch.kernels import prepared
    g = torch.Generator(device=cuda_device).manual_seed(m)
    cfg = EmulationConfig(scheme="ozaki1", p=4)
    head = (0.02 * torch.randn(4096, 49664, generator=g,
                               device=cuda_device)).to(torch.bfloat16)
    ozaki1.COUNTS.reset()
    prep = prepared.prepare_rhs(head, cfg)
    assert prep.layout == "planes" and ozaki1.COUNTS.launches_encode == 1
    a = torch.randn(m, 4096, generator=g, device=cuda_device,
                    dtype=torch.bfloat16)
    ozaki1.COUNTS.reset()
    out = prepared.matmul_prepared(a, prep, torch.float32)
    assert (ozaki1.COUNTS.launches_mixed, ozaki1.COUNTS.launches_encode,
            ozaki1.COUNTS.launches_planes) == (1, 1, 1)
    ref = dispatch.emulated_matmul(a, head, cfg=cfg, out_dtype=torch.float32,
                                   backend="torch")
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


@pytest.mark.parametrize("spec", ["ozaki1-p4", "ozaki1-p4+cached"])
def test_gqa_prefill_and_decode_cuda_equals_torch_on_card(cuda_device, spec):
    """deepseek-coder-33b's smoke widths, 8 query heads over 2 KV heads
    (g = 4): forward_prefill and three forward_decode steps on the
    'cuda' backend equal the 'torch' backend's, bit for bit; the cached
    spec prepares the untied head and streams it through the mixed form."""
    from repro_torch import api, configs
    from repro_torch.kernels import prepared
    from repro_torch.models import model as M
    from repro_torch.models.common import GemmPolicy
    arch = configs.get_smoke_config("deepseek-coder-33b")
    mcfg = arch.model
    assert mcfg.n_heads // mcfg.n_kv_heads == 4
    params = M.init_params(mcfg, seed=0, device=cuda_device)
    toks = torch.randint(0, mcfg.vocab, (3, 11), device=cuda_device,
                         generator=torch.Generator(device=cuda_device)
                         .manual_seed(1), dtype=torch.int32)
    logits = {}
    for backend in ("cuda", "torch"):
        policy = GemmPolicy(default=api.precision(spec, backend=backend))
        p = (prepared.prepare_params(params, policy)
             if policy.default.cache_weights else params)
        ozaki1.COUNTS.reset()
        with torch.no_grad():
            out, cache = M.forward_prefill(p, mcfg, {"tokens": toks}, 16,
                                           policy)
            seq = [out]
            tok = torch.argmax(out[:, :, :mcfg.vocab], -1).to(torch.int32)
            for pos in range(11, 14):
                out, cache = M.forward_decode(p, mcfg, tok, pos, cache,
                                              policy)
                seq.append(out)
                tok = torch.argmax(out[:, :, :mcfg.vocab], -1).to(torch.int32)
        torch.cuda.synchronize()
        logits[backend] = torch.cat(seq, 1)
        if backend == "cuda":
            assert ozaki1.COUNTS.plain_cuda_calls == 0
            assert ozaki1.COUNTS.launches_batched > 0
            assert ozaki1.COUNTS.launches_mixed == (
                4 if policy.default.cache_weights else 0)
    assert torch.equal(logits["cuda"], logits["torch"])


# ---------------------------------------------------------------------------
# Scheme I in float64, at p = 9..16 and with a float16 output.
# ---------------------------------------------------------------------------

def _same_bits(out, ref):
    """Equal bits, NaN where NaN (a float16 shift-reduce makes inf - inf;
    the NaN's sign bit is the hardware's)."""
    nan = ref.isnan()
    return (out.dtype == ref.dtype and torch.equal(out.isnan(), nan)
            and torch.equal(out.masked_fill(nan, 0), ref.masked_fill(nan, 0)))


_WIDE = [(torch.float64, 8, torch.float64), (torch.float64, 12, torch.float64),
         (torch.float64, 16, torch.float64), (torch.float64, 12, torch.float32),
         (torch.float32, 9, torch.float32), (torch.float32, 16, torch.float64),
         (torch.bfloat16, 10, torch.bfloat16), (torch.float32, 4, torch.float16),
         (torch.bfloat16, 16, torch.float16)]


@pytest.mark.parametrize("dtype,p,out_t", _WIDE)
def test_scheme1_wide_plane_route_on_card(cuda_device, dtype, p, out_t):
    """The encode (float64 carved in float64 with float64 scales, p up to
    16) and the plane GEMM (float64 output on its 64-column tile, float16
    output, both tile heights) against their plain versions."""
    g = torch.Generator(device=cuda_device).manual_seed(900 + p)
    for (m, k, n, trans) in [(4, 2048, 520, False), (64, 1000, 77, True),
                             (300, 384, 130, False), (37, 100, 29, True)]:
        a = _eq19(g, (m, k), torch.float64, cuda_device).to(dtype)
        b = (_eq19(g, (n, k), torch.float64, cuda_device).T if trans
             else _eq19(g, (k, n), torch.float64, cuda_device)).to(dtype)
        mu, nu = scheme1.pow2_scale(a, -1), scheme1.pow2_scale(b, -2)
        beta = 7 if k < 1000 else 6
        ozaki1.COUNTS.reset()
        pa = ozaki1.encode_planes(a, mu, p, beta)
        pb = ozaki1.encode_planes(b.T, nu.T, p, beta)
        assert torch.equal(pa, ozaki1.encode_planes_plain(a, mu, p, beta))
        assert torch.equal(pb, ozaki1.encode_planes_plain(b.T, nu.T, p,
                                                          beta))
        ref = ozaki1.plane_matmul_plain(pa, pb, mu, nu, p, beta, out_t)
        for tile_m in (64, 128):
            out = torch.empty((m, n), dtype=out_t, device=cuda_device)
            ozaki1.launch_planes(pa, pb, mu, nu, p, beta, out, tile_m=tile_m)
            torch.cuda.synchronize()
            assert _same_bits(out, ref), (m, k, n, tile_m)
        ozaki1.COUNTS.reset()
        out = ozaki1.fused_matmul_scheme1(a, b, mu, nu, p, beta, out_t)
        assert (ozaki1.COUNTS.launches_2d, ozaki1.COUNTS.launches_encode,
                ozaki1.COUNTS.launches_planes,
                ozaki1.COUNTS.plain_cuda_calls) == (1, 2, 1, 0)
        assert _same_bits(out, ozaki1.fused_matmul_plain(a, b, mu, nu, p,
                                                         beta, out_t))


@pytest.mark.parametrize("dtype,p,out_t", _WIDE)
def test_scheme1_wide_batched_on_card(cuda_device, dtype, p, out_t):
    """The batched kernel (K4) in float64, at p > 8 (16-row tiles, one
    shared buffer) and to float16, one launch a call, against
    fused_matmul_plain in every operand layout; a pair without a batched
    instance (float32 to float64) runs the plane route per element."""
    g = torch.Generator(device=cuda_device).manual_seed(950 + p)
    cases = [(8, 64, 512, 96, "contiguous"), (64, 16, 128, 80, "ck"),
             (64, 1, 80, 128, "cv"), (3, 17, 129, 77, "sliced"),
             (2, 100, 300, 65, "cv")]
    batched = (dtype, out_t) in ozaki1._BATCHED_PAIRS
    for batch, m, k, n, layout in cases:
        a, b = _batched_operands(g, cuda_device, torch.float64, batch, m, k,
                                 n, layout)
        a, b = a.to(dtype), b.to(dtype)
        mu, nu = scheme1.pow2_scale(a, -1), scheme1.pow2_scale(b, -2)
        ref = ozaki1.fused_matmul_plain(a, b, mu, nu, p, 7, out_t)
        ozaki1.COUNTS.reset()
        out = ozaki1.fused_matmul_scheme1(a, b, mu, nu, p, 7, out_t)
        torch.cuda.synchronize()
        assert (ozaki1.COUNTS.launches_batched, ozaki1.COUNTS.launches_planes,
                ozaki1.COUNTS.plain_cuda_calls) == (
                    1, 0 if batched else batch, 0)
        assert _same_bits(out, ref), (batch, m, k, n, layout)
        if batched and p <= 8:
            for tile_n in (16, 32):
                out = ozaki1.launch_batched(a, b, mu, nu, p, 7, out_t,
                                            tile_n=tile_n)
                torch.cuda.synchronize()
                assert _same_bits(out, ref), (batch, m, k, n, tile_n)


@pytest.mark.parametrize("p", [9, 12, 16])
def test_scheme1_wide_decomposition_on_card(cuda_device, p):
    """K2, K2r and K11 in float64 with float64 scales (2^1023 among them,
    whose reciprocal is subnormal) and in float32 / bf16 at p > 8, then
    K8's relayouts and route on them, against the plain versions."""
    g = torch.Generator(device=cuda_device).manual_seed(980 + p)
    for dtype in (torch.float64, torch.float32, torch.bfloat16):
        for k, n in [(31, 33), (129, 127), (1000, 300)]:
            for layout in ("rows", "emb.T", "strided"):
                b = _decompose_operand(g, k, n, layout, torch.float64,
                                       cuda_device).to(dtype)
                scales = [(scheme1.pow2_scale(b, -2),
                           scheme1.pow2_scale(b, -1).T)]
                if dtype == torch.float64 and (k, n) == (129, 127):
                    b = b * 2.0 ** 1000
                    big = torch.tensor(2.0 ** 1023, device=cuda_device,
                                       dtype=torch.float64)
                    scales = [(big.expand(1, n), big.expand(1, k))]
                for nu, tau in scales:
                    what = (k, n, layout, dtype)
                    fwd, twin = decompose.decompose_interleave_pair(
                        b, nu, tau, p, 7, 6)
                    rf, rt = decompose.decompose_pair_plain(b, nu, tau, p, 7,
                                                            6)
                    rhs = decompose.decompose_interleave_rhs(b, nu, p, 7)
                    lhs = decompose.decompose_interleave(b, tau.T, p, 7)
                    torch.cuda.synchronize()
                    assert torch.equal(fwd, rf) and torch.equal(twin, rt), what
                    assert torch.equal(rhs, decompose.decompose_rhs_plain(
                        b, nu, p, 7)), what
                    assert torch.equal(lhs, decompose.decompose_lhs_plain(
                        b, tau.T, p, 7)), what
        a = _eq19(g, (130, 300), torch.float64, cuda_device).to(dtype)
        b = _eq19(g, (300, 258), torch.float64, cuda_device).to(dtype)
        mu, nu = scheme1.pow2_scale(a, 1), scheme1.pow2_scale(b, 0)
        a_hat = decompose.decompose_interleave(a, mu, p, 7)
        b_hat = decompose.decompose_interleave_rhs(b, nu, p, 7)
        for x, operand in ((a_hat, "a"), (b_hat, "b")):
            assert torch.equal(ozaki1.relayout_interleaved(x, p, operand),
                               ozaki1.relayout_interleaved_plain(x, p,
                                                                 operand))
        out_t = torch.float64 if dtype == torch.float64 else torch.float32
        out = ozaki1.fused_matmul_interleaved(a_hat, b_hat, mu, nu, p, 7,
                                              out_t)
        ref = ozaki1.fused_matmul_interleaved_plain(a_hat, b_hat, mu, nu, p,
                                                    7, out_t)
        torch.cuda.synchronize()
        assert torch.equal(out, ref), dtype
        assert torch.equal(out, ozaki1.fused_matmul_plain(a, b, mu, nu, p, 7,
                                                          out_t))


def test_scheme1_wide_front_doors_on_card(cuda_device):
    """The front doors on the card equal the 'torch' backend: float64 at
    p = 12 (2-D, batched, ops both decomps), float16 under ozaki1-p4
    (widened, float16 out), complex128 under ozaki1-p8 (4M of float64
    parts: 8 encodes + 4 plane GEMMs), a float64 prepared weight with its
    twin at p = 12, and float16 under ozaki2 (2 encodes + 1 plane GEMM)."""
    from repro_torch import api
    from repro_torch.core import emulated
    from repro_torch.kernels import prepared
    g = torch.Generator(device=cuda_device).manual_seed(99)
    f64 = torch.float64
    a = _eq19(g, (100, 300), f64, cuda_device)
    b = _eq19(g, (300, 70), f64, cuda_device)
    for spec, x, y in (("ozaki1-p12", a, b),
                       ("ozaki1-p4", a.half(), b.half()),
                       ("ozaki1-p8", _eq19(g, (40, 96), torch.complex128,
                                           cuda_device),
                        _eq19(g, (96, 24), torch.complex128, cuda_device))):
        ozaki1.COUNTS.reset()
        out = api.einsum("mk,kn->mn", x, y, precision=spec)
        c = ozaki1.COUNTS
        launches = (c.launches_2d, c.launches_encode, c.launches_planes,
                    c.plain_cuda_calls)
        assert launches == ((4, 8, 4, 0) if x.is_complex() else (1, 2, 1, 0))
        ref = api.einsum("mk,kn->mn", x, y, precision=spec, backend="torch")
        assert out.dtype == ref.dtype == (x.dtype if x.is_complex()
                                          else torch.promote_types(x.dtype,
                                                                   y.dtype))
        assert _same_bits(torch.view_as_real(out) if out.is_complex()
                          else out, torch.view_as_real(ref)
                          if ref.is_complex() else ref), spec
    a3 = _eq19(g, (4, 33, 200), f64, cuda_device)
    b3 = _eq19(g, (4, 200, 65), f64, cuda_device)
    ozaki1.COUNTS.reset()
    out = api.einsum("bmk,bkn->bmn", a3, b3, precision="ozaki1-p12")
    assert ozaki1.COUNTS.launches_batched == 1
    assert torch.equal(out, api.einsum("bmk,bkn->bmn", a3, b3,
                                       precision="ozaki1-p12",
                                       backend="torch"))
    cfg = EmulationConfig(scheme="ozaki1", p=12)
    routes = [ops.fused_scheme1_matmul(a, b, dataclasses.replace(
        cfg, decomp=d), out_dtype=f64) for d in ("kernel", "xla")]
    assert torch.equal(routes[0], routes[1])
    assert torch.equal(routes[0], api.einsum("mk,kn->mn", a, b,
                                             precision="ozaki1-p12"))
    w = _eq19(g, (300, 70), f64, cuda_device)
    prep = prepared.prepare_rhs(w, cfg, with_twin=True)
    assert prep.layout == "planes" and prep.scale.dtype == f64
    ref_prep = prepared.prepare_rhs(w.cpu(), dataclasses.replace(
        cfg, backend="cuda"), with_twin=True)
    assert torch.equal(prep.slices.cpu(), ref_prep.slices)
    assert torch.equal(prep.twin.slices.cpu(), ref_prep.twin.slices)
    out = emulated.emulated_dot_prepared(a, w, prep, cfg)
    assert torch.equal(out, api.einsum("mk,kn->mn", a, w,
                                       precision="ozaki1-p12"))
    g2 = _eq19(g, (100, 70), f64, cuda_device)
    da = prepared.matmul_prepared(g2, prep.twin, f64)
    assert torch.equal(da, api.einsum("mk,kn->mn", g2, w.T,
                                      precision="ozaki1-p12"))
    h = a.half()
    ozaki2.COUNTS.reset()
    out = api.einsum("mk,kn->mn", h, h.T, precision="ozaki2-m8",
                     out_dtype=torch.float32)
    c = ozaki2.COUNTS
    assert (c.launches_2d, c.launches_encode, c.launches_planes,
            c.plain_cuda_calls) == (1, 2, 1, 0)
    assert torch.equal(out, api.einsum("mk,kn->mn", h, h.T,
                                       precision="ozaki2-m8",
                                       out_dtype=torch.float32,
                                       backend="torch"))


# ---------------------------------------------------------------------------
# Scheme II with float16 operands (K5g, K6, K5g's prepared form) and the
# int8 KV cache.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p", [6, 16])
def test_scheme2_float16_instances_bit_identical_on_card(cuda_device, p):
    """The float16 encode (subnormal-only rows, rows below 2^-5, a float16
    rhs that overflows at a float32 lhs's budget, transposed views) and
    the plane GEMM's float16 scale reads and float16 output, 2-D and
    batched, in every pairing with float32 and bf16, and the prepared
    form with a float16 lhs, against their plain versions."""
    from repro_torch.kernels import prepared
    g = torch.Generator(device=cuda_device).manual_seed(900 + p)
    moduli = default_moduli(p)
    f16, f32, bf = torch.float16, torch.float32, torch.bfloat16
    for lead, (m, k, n) in [((), (300, 1000, 520)), ((), (9, 5, 11)),
                            ((3,), (37, 70, 29))]:
        a = torch.randn(lead + (m, k), generator=g, device=cuda_device) * 4
        a[..., 1, :] *= 2.0 ** -26
        a[..., 2, :] *= 2.0 ** -16
        bt = torch.randn(lead + (n, k), generator=g, device=cuda_device) * 4
        for ta, tb in ((f16, f16), (f16, f32), (f32, f16), (bf, f16),
                       (f16, bf)):
            x, y = a.to(ta), bt.to(tb).transpose(-1, -2)
            for xx in (x, x.transpose(-1, -2).contiguous().transpose(-1, -2)):
                mu, nu = scheme2.scales(xx, y, moduli)
                for out_t in (f32, f16, bf):
                    ozaki2.COUNTS.reset()
                    out = ozaki2.fused_matmul_scheme2(xx, y, mu, nu, moduli,
                                                      out_t)
                    ref = ozaki2.fused_matmul_scheme2_plain(xx, y, mu, nu,
                                                            moduli, out_t)
                    torch.cuda.synchronize()
                    assert _same_bits(out, ref), (lead, m, k, n, ta, tb,
                                                  out_t)
                    assert (ozaki2.COUNTS.launches_encode,
                            ozaki2.COUNTS.launches_planes) == (2, 1)
    cfg = EmulationConfig(scheme="ozaki2", p=p)
    w = torch.randn(1000, 520, generator=g, device=cuda_device).half()
    prep = prepared.prepare_rhs(w, cfg)
    assert prep.layout == "planes" and prep.scale.dtype == f16
    x = (torch.randn(300, 1000, generator=g, device=cuda_device) * 4).half()
    out = prepared.matmul_prepared(x, prep, f32)
    assert torch.equal(out, ozaki2.fused_matmul_scheme2_prepared_plain(
        x, prep.stacked(), scheme2._pow2_int_scale(x, -1, prep.budget_bits),
        prep.scale, moduli, f32, 520))
    assert torch.equal(out, ozaki2.fused_matmul_scheme2(
        x, w, *scheme2.scales(x, w, moduli), moduli, f32))


def test_int8_kv_cache_on_card(cuda_device):
    """quantize_kv on the card equals it on the CPU bit for bit; a smoke
    qwen1.5-32b with the int8 cache prefills and decodes on both
    backends under ozaki1-p4 with equal logits and caches."""
    from repro_torch import api, configs
    from repro_torch.models import attention, model as M
    from repro_torch.models.common import GemmPolicy
    g = torch.Generator(device=cuda_device).manual_seed(5)
    x = (torch.randn(4, 48, 40, 128, generator=g, device=cuda_device)
         * 3).to(torch.bfloat16)
    x[0, 0] = 0
    q, s = attention.quantize_kv(x)
    qc, sc = attention.quantize_kv(x.cpu())
    assert torch.equal(q.cpu(), qc) and torch.equal(s.cpu(), sc)
    arch = configs.get_smoke_config("qwen1.5-32b")
    mcfg = dataclasses.replace(arch.model, kv_cache_dtype="int8")
    params = M.init_params(mcfg, 0, cuda_device)
    toks = torch.randint(0, mcfg.vocab, (2, 9), generator=g,
                         device=cuda_device, dtype=torch.int32)
    out = {}
    for backend in ("cuda", "torch"):
        policy = GemmPolicy(default=api.precision("ozaki1-p4",
                                                  backend=backend))
        logits, cache = M.forward_prefill(params, mcfg, {"tokens": toks}, 16,
                                          policy)
        logits2, cache = M.forward_decode(params, mcfg, toks[:, :1], 9,
                                          cache, policy)
        out[backend] = (logits, logits2, cache["layers"]["b0"])
    assert out["cuda"][2]["k"].dtype == torch.int8
    assert torch.equal(out["cuda"][0], out["torch"][0])
    assert torch.equal(out["cuda"][1], out["torch"][1])
    for name, leaf in out["cuda"][2].items():
        assert torch.equal(leaf, out["torch"][2][name]), name


@pytest.mark.parametrize("dtype,shape", [
    (torch.float32, (4, 3072, 128, 1)),      # mamba2's ssd_state, N = 1
    (torch.float32, (3, 17, 40, 1)),
    (torch.bfloat16, (32, 1024, 80, 1024)),  # hubert's attn_qk, K = 80
    (torch.bfloat16, (32, 1024, 1024, 80)),  # its attn_av, N = 80
    (torch.bfloat16, (4, 10, 256, 2048))])   # recurrentgemma's decode qk
def test_batched_kernel_at_the_zoo_shapes(cuda_device, dtype, shape):
    """K4 bit for bit against its plain version, one launch a call, at
    shapes the zoo's paths give it: one output column (the SSD decode's
    state read, float32) and a head dim of 80 (a partial 64-column tile
    in either operand), also through the einsum front door."""
    from repro_torch import api
    batch, m, k, n = shape
    g = torch.Generator(device=cuda_device).manual_seed(m + n)
    a = torch.randn(batch, m, k, generator=g, device=cuda_device).to(dtype)
    b = torch.randn(batch, k, n, generator=g, device=cuda_device).to(dtype)
    mu, nu = scheme1.pow2_scale(a, -1), scheme1.pow2_scale(b, -2)
    ozaki1.COUNTS.reset()
    out = ozaki1.fused_matmul_scheme1(a, b, mu, nu, 4, 7, torch.float32)
    assert ozaki1.COUNTS.launches_batched == 1
    ref = ozaki1.fused_matmul_plain(a, b, mu, nu, 4, 7, torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    if n == 1:
        heads = 8 if m % 8 == 0 else 1
        state = a.reshape(batch, heads, m // heads, k)
        got = api.einsum("bhpn,bn->bhp", state, b[..., 0],
                         precision="ozaki1-p4")
        want = api.einsum("bhpn,bn->bhp", state, b[..., 0],
                          precision=api.precision("ozaki1-p4",
                                                  backend="torch"))
        assert torch.equal(got, want)


@pytest.mark.parametrize("int8", [False, True])
def test_ring_buffer_decode_past_the_window_on_card(cuda_device, int8):
    """recurrentgemma-2b's smoke config (window 32, a (rec, rec, attn)
    group and a (rec, rec) tail) on the card against the CPU port on the
    same float32 weights: a 40-token prompt (the ring rotates) and 30
    decodes of seeded ids (it wraps), native, logits within 1e-4 of their
    max (with the float cache: an int8 cache rounds k and v to a step of
    max|row| / 127, so a float32 ulp between the devices can move a value
    a whole step); then under ozaki1-p4 the 'cuda' and 'torch' backends
    on the card, bit for bit, with and without the int8 cache."""
    from repro_torch import api, configs
    from repro_torch.models import model as M
    from repro_torch.models.common import GemmPolicy
    from repro_torch.utils.tree import tree_map
    mcfg = configs.get_smoke_config("recurrentgemma-2b").model
    mcfg = dataclasses.replace(
        mcfg, kv_cache_dtype="int8" if int8 else "auto")
    params = M.init_params(mcfg, 0, cuda_device)
    g = torch.Generator().manual_seed(11)
    toks = torch.randint(0, mcfg.vocab, (2, 70), generator=g,
                         dtype=torch.int32)

    def run(params, policy, device):
        toks_d = toks.to(device)
        logits, cache = M.forward_prefill(params, mcfg,
                                          {"tokens": toks_d[:, :40]}, 72,
                                          policy)
        outs = [logits.float().cpu()]
        for i in range(30):
            logits, cache = M.forward_decode(params, mcfg,
                                             toks_d[:, 40 + i:41 + i],
                                             40 + i, cache, policy)
            outs.append(logits.float().cpu())
        assert cache["layers"]["b2"]["k"].shape[2] == 32
        return torch.stack(outs)

    native = GemmPolicy(default=api.precision("native"))
    with torch.inference_mode():
        if not int8:
            card = run(params, native, cuda_device)
            host = run(tree_map(lambda x: x.cpu(), params), native, "cpu")
            assert (card - host).abs().max() <= 1e-4 * host.abs().max()
        out = {b: run(params, GemmPolicy(default=api.precision(
            "ozaki1-p4", backend=b)), cuda_device) for b in ("cuda", "torch")}
    assert torch.equal(out["cuda"], out["torch"])


@pytest.mark.parametrize("rows,k,n", [(64, 7168, 2048), (4, 7168, 2048),
                                      (64, 2048, 7168)])
def test_batched_kernel_at_deepseek_v3_expert_stacks(cuda_device, rows, k, n):
    """K4 at deepseek-v3-671b's moe_expert shapes: 256 experts, K = 7168
    (gate, up) and 2048 (down), at a mixed step's 64 rows and a decode
    step's 4, bf16 in, one launch a call, bit for bit against its plain
    version (drawn, and held, 32 experts at a time: the stack is 7.5 GB
    in bf16, and the plain version's float64 slice products of the whole
    of it would not fit)."""
    g = torch.Generator(device=cuda_device).manual_seed(rows + k)
    a = torch.randn(256, rows, k, generator=g, device=cuda_device).to(
        torch.bfloat16)
    b = torch.empty(256, k, n, dtype=torch.bfloat16, device=cuda_device)
    for i in range(0, 256, 32):
        b[i:i + 32] = torch.randn(32, k, n, generator=g,
                                  device=cuda_device) * k ** -0.5
    mu, nu = scheme1.pow2_scale(a, -1), scheme1.pow2_scale(b, -2)
    ozaki1.COUNTS.reset()
    out = ozaki1.fused_matmul_scheme1(a, b, mu, nu, 4, 7, torch.bfloat16)
    assert ozaki1.COUNTS.launches_batched == 1
    for i in range(0, 256, 32):
        e = slice(i, i + 32)
        ref = ozaki1.fused_matmul_plain(a[e], b[e], mu[e], nu[e], 4, 7,
                                        torch.bfloat16)
        assert torch.equal(out[e], ref), i


def test_mla_latent_and_deepseek_v3_smoke_on_card(cuda_device):
    """K1 at MLA's 'mla_latent' decompression (K = 512 against W_UK, a
    strided view of wkv_b: 128 heads x 128) bit for bit against its plain
    version, one 2-D call; then deepseek-v3-671b's smoke config (MLA,
    sigmoid routing with a nonzero router_bias, MTP) under ozaki1-p4 on
    the 'cuda' and 'torch' backends on the card: forward_train's logits
    and MTP logits, a prefill and three decodes, bit for bit."""
    from repro_torch import api, configs
    from repro_torch.models import model as M
    from repro_torch.models.common import GemmPolicy, policy_einsum
    g = torch.Generator(device=cuda_device).manual_seed(512)
    cj = torch.randn(4, 16, 512, generator=g, device=cuda_device).to(
        torch.bfloat16)
    wkv_b = (torch.randn(512, 128 * 256, generator=g, device=cuda_device)
             / 512 ** 0.5).to(torch.bfloat16)
    w_uk = wkv_b.reshape(512, 128, 256)[..., :128]
    outs = {}
    for backend in ("cuda", "torch"):
        ozaki1.COUNTS.reset()
        outs[backend] = policy_einsum(
            "blc,chd->blhd", cj, w_uk, GemmPolicy(default=api.precision(
                "ozaki1-p4", backend=backend)), "mla_latent")
        if backend == "cuda":
            assert ozaki1.COUNTS.launches_2d == 1
    torch.cuda.synchronize()
    assert outs["cuda"].shape == (4, 16, 128, 128)
    assert torch.equal(outs["cuda"], outs["torch"])

    mcfg = configs.get_smoke_config("deepseek-v3-671b").model
    params = M.init_params(mcfg, 0, cuda_device)
    params["layers"]["b0"]["moe"]["router_bias"].uniform_(-0.3, 0.3,
                                                          generator=g)
    toks = torch.randint(0, mcfg.vocab, (2, 40), generator=g,
                         device=cuda_device, dtype=torch.int32)
    res = {}
    for backend in ("cuda", "torch"):
        pol = GemmPolicy(default=api.precision("ozaki1-p4", backend=backend))
        with torch.inference_mode():
            logits, mtp, _ = M.forward_train(params, mcfg,
                                             {"tokens": toks[:, :32]}, pol,
                                             remat=False)
            pre, cache = M.forward_prefill(params, mcfg,
                                           {"tokens": toks[:, :32]}, 40, pol)
            steps = [pre]
            for i in range(3):
                out, cache = M.forward_decode(params, mcfg,
                                              toks[:, 32 + i:33 + i],
                                              32 + i, cache, pol)
                steps.append(out)
        res[backend] = (logits, mtp, torch.cat(steps, 1))
    for a, b in zip(res["cuda"], res["torch"]):
        assert torch.isfinite(a).all() and torch.equal(a, b)


# ---------------------------------------------------------------------------
# The guard and the telemetry on the card.
# ---------------------------------------------------------------------------

def test_guard_on_card(cuda_device):
    """A guarded 2-D call is one K1 launch and the unguarded bits; NaN /
    Inf lanes are masked exactly where torch.matmul is non-finite; a
    guarded call against a prepared weight is one K3 launch; a guarded
    batched call is one K4 launch and one counted verification per
    element, and no K1."""
    import math as m_
    from repro_torch import guard
    from repro_torch.kernels import prepared
    g = torch.Generator(device=cuda_device).manual_seed(31)
    a = torch.randn(64, 512, generator=g, device=cuda_device).bfloat16()
    b = torch.randn(512, 384, generator=g, device=cuda_device).bfloat16()
    guard.stats_clear()
    ozaki1.COUNTS.reset()
    out = dispatch.emulated_matmul(a, b, cfg="ozaki1-p4+guard")
    assert ozaki1.COUNTS.launches_2d == 1
    assert torch.equal(out, dispatch.emulated_matmul(a, b, cfg="ozaki1-p4"))
    s = guard.stats()
    assert (s.calls, s.verified, s.trips) == (1, 1, 0)
    a2, b2 = a.clone(), b.clone()
    a2[3, 5], b2[7, 9] = m_.nan, -m_.inf
    out = dispatch.emulated_matmul(a2, b2, cfg="ozaki1-p4+guard")
    native = torch.matmul(a2.float(), b2.float())
    torch.cuda.synchronize()
    assert torch.equal(torch.isnan(out), ~torch.isfinite(native))
    prep = prepared.prepare_rhs(b, EmulationConfig(scheme="ozaki1", p=4))
    ozaki1.COUNTS.reset()
    guard.stats_clear()
    out = dispatch.emulated_matmul(a, prep, cfg="ozaki1-p4+guard")
    assert ozaki1.COUNTS.launches_mixed == 1
    assert torch.equal(out, dispatch.emulated_matmul(a, prep, cfg="ozaki1-p4"))
    assert guard.stats().verified == 1
    a3 = torch.randn(6, 32, 128, generator=g, device=cuda_device).bfloat16()
    b3 = torch.randn(6, 128, 48, generator=g, device=cuda_device).bfloat16()
    ozaki1.COUNTS.reset()
    guard.stats_clear()
    out = dispatch.emulated_matmul_batched(a3, b3, cfg="ozaki1-p4+guard")
    assert (ozaki1.COUNTS.launches_2d, ozaki1.COUNTS.launches_batched) \
        == (0, 1)
    assert (guard.stats().calls, guard.stats().trips) == (6, 0)
    assert torch.equal(out, dispatch.emulated_matmul_batched(
        a3, b3, cfg="ozaki1-p4"))


def test_guard_smoke_and_telemetry_on_card(cuda_device, capsys):
    """``python -m repro_torch.guard.smoke``'s checks on the card; with
    telemetry enabled, the emulated calls recorded equal the kernels'
    launch counts, and the verification runs in full float32 whatever the
    process's TF32 setting."""
    from repro_torch import telemetry
    from repro_torch.guard import smoke, verify
    assert smoke.main([]) == 0
    assert "smoke OK on cuda" in capsys.readouterr().out
    dev = cuda_device
    g = torch.Generator(device=dev).manual_seed(32)
    a = torch.randn(64, 256, generator=g, device=dev)
    b = torch.randn(256, 128, generator=g, device=dev)
    with telemetry.recording():
        calls0 = telemetry.REGISTRY.total("repro_emulated_calls_total")
        ozaki1.COUNTS.reset()
        dispatch.emulated_matmul(a, b, cfg="ozaki1-p4")
        dispatch.emulated_matmul_batched(a.reshape(2, 32, 256),
                                         b.expand(2, 256, 128).contiguous(),
                                         cfg="ozaki1-p4")
        calls = telemetry.REGISTRY.total("repro_emulated_calls_total") - calls0
    assert calls == ozaki1.COUNTS.launches_2d + ozaki1.COUNTS.launches_batched \
        == 2
    c = a @ b
    prev = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        tf32 = verify.verify_gemm(a, b, c, cfg="ozaki1-p4")
        assert torch.get_float32_matmul_precision() == "high"
        torch.set_float32_matmul_precision("highest")
        full = verify.verify_gemm(a, b, c, cfg="ozaki1-p4")
    finally:
        torch.set_float32_matmul_precision(prev)
    assert torch.equal(tf32.err, full.err)
