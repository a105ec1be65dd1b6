"""Scheme II with float16 operands against the JAX reference, bit for bit.

The reference keeps a float16 operand in float16 (``gpu._float_or_f32``),
caps the shared budget at the lhs type's nmant + 1 = 11 bits, integerizes
trunc(x * mu) in float16 with float16 power-of-two scales clamped at
2^15, and divides by mu * nu formed in the output type. The port does
the same: ``scheme2.matmul`` (the 'torch' backend), and the plane route's
plain versions (``ozaki2.encode_planes_plain`` then ``plane_matmul_plain``:
what the 'cuda' backend's kernels compute, held to these on the card in
tests/test_torch_cuda.py) against the reference's fused GPU lowerings in
interpret mode. Pairings with float32 and bf16 take each operand in its
own type with the budget of the lhs; the operands hold a row whose
magnitudes are all float16-subnormal (its scale clamps at 2^15) and a
row below 2^-5 (which loses bits to the clamp in both packages).

Two faults of the reference are kept, bit for bit (ROADMAP.md § 3 R9):
a float16 output forms mu * nu in float16, which is inf from 2^16 on, so
most of its elements are 0, inf or NaN; and a float16 rhs integerized at
a float32 lhs's budget above 16 bits rounds to inf, which converts
saturating and then wraps in the residue's + m // 2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_util import t
from conftest import conditioned
from repro.core import scheme2 as jscheme2
from repro.core.precision import (EmulationConfig as JConfig,
                                  scheme2_budget as jbudget)
from repro.kernels.backends import gpu as jgpu
from repro.kernels.common import Blocks as JBlocks
from repro_torch import api
from repro_torch.core import scheme2
from repro_torch.core.precision import EmulationConfig, default_moduli
from repro_torch.kernels import ozaki2, prepared

TYPES = {"float16": (torch.float16, jnp.float16),
         "float32": (torch.float32, jnp.float32),
         "bfloat16": (torch.bfloat16, jnp.bfloat16),
         "float64": (torch.float64, jnp.float64)}
M, K, N = 13, 40, 11


def _same(x: torch.Tensor, y) -> None:
    """Bitwise equality, type included (NaN payloads too)."""
    y = np.asarray(y)
    assert str(x.dtype).split(".")[-1] == str(y.dtype), (x.dtype, y.dtype)
    size = x.element_size()
    xs = x.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[size])
    np.testing.assert_array_equal(xs.numpy(), y.view(f"i{size}"))


def _operands(seed, name_a, name_b, batch=()):
    """Seeded Eq. 19 operands (jax, torch) of A and B, each in its type:
    A's row 2 float16-subnormal only, its row 5 below 2^-5; B's column 3
    below 2^-5."""
    rng = np.random.default_rng(seed)
    a = conditioned(rng, batch + (M, K))
    b = conditioned(rng, batch + (K, N))
    a[..., 2, :] *= 2.0 ** -26
    a[..., 5, :] *= 2.0 ** -16
    b[..., :, 3] *= 2.0 ** -16
    out = []
    for x, name in ((a, name_a), (b, name_b)):
        tt, jt = TYPES[name]
        jx = jnp.asarray(x).astype(jt)
        out += [jx, t(np.asarray(jx.astype(jnp.float32)), tt)]
    return out


def _route(ta, tb, mu, nu, moduli, out_dtype):
    """The 'cuda' backend's plane route in its plain versions."""
    return ozaki2.plane_matmul_plain(
        ozaki2.encode_planes_plain(ta, mu, moduli),
        ozaki2.encode_planes_plain(tb.transpose(-1, -2),
                                   nu.transpose(-1, -2), moduli),
        mu, nu, moduli, out_dtype)


def _reference_kernel(ja, jb, mu, nu, moduli, out_name):
    """The reference's fused GPU lowering in interpret mode (2-D or
    batched), at blocks equal to the problem (one tile, one K step)."""
    fn = (jgpu.fused_matmul_scheme2 if ja.ndim == 2
          else jgpu.fused_matmul_scheme2_batched)
    return np.asarray(fn(ja, jb, jnp.asarray(mu.float().numpy()).astype(
        ja.dtype), jnp.asarray(nu.float().numpy()).astype(jb.dtype), moduli,
        JBlocks(M, N, K), out_dtype=TYPES[out_name][1]))


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view({2: torch.int16, 4: torch.int32}[x.element_size()])


# (lhs, rhs, out or None for the promoted type, moduli count)
CASES = [("float16", "float16", None, 6), ("float16", "float16", "float32", 16),
         ("float16", "float32", "bfloat16", 8),
         ("float32", "float16", None, 3), ("float32", "float16", None, 8),
         ("bfloat16", "float16", None, 8)]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_matmul_matches_reference(case):
    """``scheme2.matmul`` == the reference's, for float16 with itself,
    float32 and bf16 in either position, to float16, float32 and bf16;
    the float32 lhs at m = 8 (a 19-bit budget) overflows its float16
    rhs in both packages (R9)."""
    na, nb, out, p = case
    ja, ta, jb, tb = _operands(10 + p, na, nb)
    jcfg, tcfg = JConfig(scheme="ozaki2", p=p), EmulationConfig(
        scheme="ozaki2", p=p)
    ref = jax.jit(lambda x, y: jscheme2.matmul(
        x, y, jcfg, None if out is None else TYPES[out][1]))(ja, jb)
    got = scheme2.matmul(ta, tb, tcfg, None if out is None
                         else TYPES[out][0])
    _same(got, ref)
    if out is None and nb == "float16":
        assert got.dtype == torch.promote_types(ta.dtype, tb.dtype)
    if (na, nb, out) == ("float16", "float16", None):
        # R9: mu * nu formed in float16 is inf from 2^16 on, so at rows
        # and columns of magnitude about 1 (mu = nu = 2^10) most elements
        # are 0, inf or NaN, in the reference and in the port alike; the
        # float32 output of the same operands is finite.
        assert got.dtype == torch.float16
        assert (~torch.isfinite(got)).float().mean() > 0.5
        assert torch.isfinite(scheme2.matmul(ta, tb, tcfg,
                                             torch.float32)).all()


def test_float64_output_matches_reference_under_x64():
    """float16 operands to a float64 output: float64 double-double, as the
    reference's with x64."""
    ja, ta, jb, tb = _operands(20, "float16", "float16")
    with jax.enable_x64(True):
        ref = np.asarray(jax.jit(lambda x, y: jscheme2.matmul(
            x, y, JConfig(scheme="ozaki2", p=8), jnp.float64))(ja, jb))
    _same(scheme2.matmul(ta, tb, EmulationConfig(scheme="ozaki2", p=8),
                         torch.float64), ref)


@pytest.mark.parametrize("p", [3, 6, 16])
def test_budget_is_capped_at_eleven_bits(p):
    """The shared budget of a float16 lhs is min(scheme2_budget, 11), and
    its scales are the reference's: a subnormal-only row clamps at 2^15."""
    moduli = default_moduli(p)
    for k in (16, 40, 4096):
        assert scheme2.budget_bits(moduli, k, torch.float16) == min(
            jbudget(moduli, k), 11)
    want = scheme2.budget_bits(moduli, K, torch.float16)
    ja, ta, _, _ = _operands(30, "float16", "float16")
    mu = scheme2._pow2_int_scale(ta, -1, want)
    assert mu.dtype == torch.float16
    _same(mu, jscheme2._pow2_int_scale(ja, 1, want))
    assert float(mu[2, 0]) == 2.0 ** 15


@pytest.mark.parametrize("pair,out", [
    (("float16", "float16"), "float32"), (("float16", "float16"), "float16"),
    (("float16", "bfloat16"), "float32")])
def test_plane_route_matches_reference_kernel(pair, out):
    """The plain encode and plane GEMM == the reference's fused 2-D GPU
    kernel (K5g) in interpret mode, and == the front door's plain version."""
    moduli = default_moduli(6)
    ja, ta, jb, tb = _operands(40, *pair)
    mu, nu = scheme2.scales(ta, tb, moduli)
    got = _route(ta, tb, mu, nu, moduli, TYPES[out][0])
    _same(got, _reference_kernel(ja, jb, mu, nu, moduli, out))
    assert torch.equal(_bits(got), _bits(ozaki2.fused_matmul_scheme2(
        ta, tb, mu, nu, moduli, TYPES[out][0])))


def test_batched_plane_route_matches_reference_kernel():
    """A float16 batch (K6): the batched planes and plane GEMM == the
    reference's batched fused GPU kernel in interpret mode."""
    moduli = default_moduli(6)
    ja, ta, jb, tb = _operands(50, "float16", "float16", batch=(3,))
    mu, nu = scheme2.scales(ta, tb, moduli)
    got = _route(ta, tb, mu, nu, moduli, torch.float32)
    _same(got, _reference_kernel(ja, jb, mu, nu, moduli, "float32"))


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_front_door_takes_float16(backend):
    """``api.einsum`` under ozaki2 on either backend (CPU tensors) no
    longer raises: 2-D and batched, equal to ``scheme2.matmul``."""
    _, ta, _, tb = _operands(60, "float16", "float16")
    _, ta3, _, tb3 = _operands(61, "float16", "float16", batch=(2,))
    cfg = EmulationConfig(scheme="ozaki2", p=6)
    out = api.einsum("mk,kn->mn", ta, tb, precision="ozaki2-m6",
                     backend=backend, out_dtype=torch.float32)
    assert torch.equal(out, scheme2.matmul(ta, tb, cfg, torch.float32))
    out3 = api.einsum("bmk,bkn->bmn", ta3, tb3, precision="ozaki2-m6",
                      backend=backend, out_dtype=torch.float32)
    assert torch.equal(out3, scheme2.matmul(ta3, tb3, cfg, torch.float32))


@pytest.mark.parametrize("backend,lhs", [("cuda", "float16"),
                                         ("torch", "float16"),
                                         ("cuda", "float32")])
def test_prepared_float16_weight_equals_unprepared(backend, lhs):
    """A float16 weight prepared once ('planes' on the 'cuda' backend's
    layout, 'stacked' on the 'torch' one) and consumed by a float16 lhs
    (K5g's ``b_res`` form) equals the unprepared product; so does a
    float32 lhs at its own (wider) budget."""
    moduli_cfg = EmulationConfig(scheme="ozaki2", p=6, backend=backend)
    _, ta, _, tb = _operands(70, lhs, "float16")
    prep = prepared.prepare_rhs(tb, moduli_cfg)
    assert isinstance(prep, prepared.PreparedResidues)
    assert prep.layout == ("planes" if backend == "cuda" else "stacked")
    assert prep.scale.dtype == torch.float16
    got = prepared.matmul_prepared(ta, prep, torch.float32)
    ref = scheme2.matmul(ta, tb, moduli_cfg, torch.float32)
    if lhs == "float16":
        assert torch.equal(got, ref)
    else:
        # The prep's budget is the weight's (11): the float32 lhs takes it.
        mu = scheme2._pow2_int_scale(ta, -1, prep.budget_bits)
        assert torch.equal(got, scheme2.scaled_matmul(
            ta, tb, mu, prep.scale[:, :N], default_moduli(6),
            torch.float32))
