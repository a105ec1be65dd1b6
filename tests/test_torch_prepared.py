"""The port's prepared weights and differentiable emulated GEMMs against
the reference (repro_torch.kernels.{decompose,prepared}, core.emulated vs
repro.kernels.prepared, repro.core.emulated).

The reference's Pallas kernels run in interpret mode here, as its own
tests run them on the CPU; the port's wrappers run their plain versions
on CPU tensors. The two packages interleave at their own granularity (the
kernel's K tile), so prepared operands are compared through ``stacked()``.
Slices, scales and float32 results must be bit-identical: the emulation
interior is exact integer arithmetic and both packages round the same
float ops in the same order. A bfloat16 result may differ by one bf16
ulp, as the two frameworks may round a bf16 epilogue op at other places
(ROADMAP.md H8).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_util import bits, t
from repro.core import emulated as jemulated
from repro.core.precision import EmulationConfig as JCfg
from repro.kernels import prepared as jprepared
from repro_torch.core import emulated as temulated, scheme1
from repro_torch.core.precision import EmulationConfig as TCfg
from repro_torch.kernels import decompose, ozaki1, prepared as tprepared

SHAPES = [(128, 256), (100, 72)]          # aligned, ragged (K, N)


def _conditioned(seed, shape, phi=2.0):
    rng = np.random.default_rng(seed)
    return ((rng.random(shape) - 0.5)
            * np.exp(phi * rng.standard_normal(shape))).astype(np.float32)


def _both(x: np.ndarray, dtype: str):
    return (jnp.asarray(x).astype(dtype), t(x).to(getattr(torch, dtype)))


def _cfgs(p, bwd_p=0, cached=True):
    kw = dict(scheme="ozaki1", p=p, bwd_p=bwd_p, cache_weights=cached)
    return JCfg(**kw), TCfg(**kw)


# ---------------------------------------------------------------------------
# Layout helpers and the plain versions of K2 / K2r.
# ---------------------------------------------------------------------------

def test_interleave_round_trip_matches_reference():
    from repro.core import scheme1 as jscheme1
    x = np.random.default_rng(0).integers(-127, 128, (3, 64, 7)).astype(np.int8)
    ref = np.asarray(jscheme1.interleave_k(jnp.asarray(x), "b", 32))
    out = scheme1.interleave_k(t(x), "b", 32)
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(scheme1.deinterleave_k(out, 3, "b", 32).numpy(), x)


@pytest.mark.parametrize("p", [3, 4, 6])
def test_pair_plain_is_rhs_plain_twice(p):
    b = t(_conditioned(p, (70, 45), phi=3.0))
    nu, tau = scheme1.pow2_scale(b, -2), scheme1.pow2_scale(b, -1).T
    fwd, twin = decompose.decompose_pair_plain(b, nu, tau, p, 7, 5)
    assert fwd.shape == (p * 96, 45) and twin.shape == (p * 64, 70)
    assert torch.equal(fwd, decompose.decompose_rhs_plain(b, nu, p, 7))
    assert torch.equal(twin, decompose.decompose_rhs_plain(b.T, tau, p, 5))


# ---------------------------------------------------------------------------
# prepare_rhs against the reference's (pair kernel / two rhs kernels).
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p,bwd_p", [(3, 0), (4, 0), (6, 0), (4, 3)])
@pytest.mark.parametrize("k,n", SHAPES)
def test_prepare_rhs_matches_reference(dtype, p, bwd_p, k, n):
    jb, tb = _both(_conditioned(k * n + p, (k, n), phi=3.0), dtype)
    jcfg, tcfg = _cfgs(p, bwd_p)
    jp = jprepared.prepare_rhs(jb, jcfg, with_twin=True)
    tp = tprepared.prepare_rhs(tb, tcfg, with_twin=True)
    assert (tp.p, tp.beta, tp.k, tp.n) == (jp.p, jp.beta, jp.k, jp.n)
    assert (tp.twin.p, tp.twin.beta) == (jp.twin.p, jp.twin.beta)
    assert tp.twin.p == (bwd_p or p)
    for ours, ref, rows, cols in ((tp, jp, k, n), (tp.twin, jp.twin, n, k)):
        st = ours.stacked()
        np.testing.assert_array_equal(st[:, :rows, :cols].numpy(),
                                      np.asarray(ref.stacked())[:, :rows,
                                                                :cols])
        assert not st[:, rows:].any()          # zero-filled ragged rows
        np.testing.assert_array_equal(
            bits(ours.scale[:, :cols]),
            bits(np.asarray(ref.scale.astype(jnp.float32))[:, :cols]))


def test_prepared_reconstruct_is_within_the_residual():
    b = _conditioned(3, (100, 72))
    prep = tprepared.prepare_rhs(t(b), TCfg(scheme="ozaki1", p=3))
    err = np.abs(prep.reconstruct().numpy() - b)
    assert (err <= prep.scale.numpy() * 2.0 ** (-prep.beta * prep.p)).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p", [3, 4, 6])
@pytest.mark.parametrize("k,n", SHAPES)
def test_matmul_prepared_matches_reference(dtype, p, k, n):
    jb, tb = _both(_conditioned(p, (k, n)), dtype)
    ja, ta = _both(_conditioned(p + 1, (37, k)), dtype)
    jcfg, tcfg = _cfgs(p)
    out_dtype = getattr(jnp, dtype)
    ref = np.asarray(jprepared.matmul_prepared(
        ja, jprepared.prepare_rhs(jb, jcfg), out_dtype=out_dtype)
        .astype(jnp.float32))
    tp = tprepared.prepare_rhs(tb, tcfg)
    out = tprepared.matmul_prepared(ta, tp, out_dtype=getattr(torch, dtype))
    if dtype == "float32":
        np.testing.assert_array_equal(bits(out), bits(ref))
    else:                                   # within 1 bf16 ulp
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
        assert (np.abs(out.float().numpy() - ref) <= ulp).all()
    # The mixed kernel's plain version equals the unprepared product.
    ref_t = ozaki1.fused_matmul_plain(ta, tb, scheme1.pow2_scale(ta, -1),
                                      scheme1.pow2_scale(tb, -2), p,
                                      tp.beta, getattr(torch, dtype))
    assert torch.equal(out, ref_t)


def test_prepared_refuses_other_granularities_and_schemes():
    b = t(_conditioned(0, (64, 32)))
    prep = tprepared.prepare_rhs(b, TCfg(scheme="ozaki1", p=4))
    from repro_torch.kernels.common import Blocks
    bad = dataclasses.replace(prep, blocks=Blocks(64, 64, 16))
    with pytest.raises(ValueError, match="granularity"):
        tprepared.matmul_prepared(t(_conditioned(1, (4, 64))), bad)
    # The ozaki2 refusals that remain: a PreparedResidues rhs under
    # ozaki1, a complex weight, a 3-D weight.
    res = tprepared.prepare_rhs(b, TCfg(scheme="ozaki2", p=4))
    with pytest.raises(ValueError, match="PreparedResidues"):
        tprepared.prepare_rhs(res, TCfg(scheme="ozaki1", p=4))
    with pytest.raises(ValueError, match="real-valued"):
        tprepared.prepare_rhs(torch.complex(b, b), TCfg(scheme="ozaki2", p=4))
    with pytest.raises(ValueError, match="2-D"):
        tprepared.prepare_rhs(b[None], TCfg(scheme="ozaki2", p=4))


# ---------------------------------------------------------------------------
# The autograd Functions against jax.vjp of the reference's custom VJPs.
# ---------------------------------------------------------------------------

def _torch_vjp(fn, a, b, g):
    ta = t(a).requires_grad_(True)
    tb = t(b).requires_grad_(True)
    out = fn(ta, tb)
    out.backward(t(g))
    return out.detach(), ta.grad, tb.grad


def _vjp_pair(jfn, tfn, a, b, g):
    jout, vjp = jax.vjp(jfn, jnp.asarray(a), jnp.asarray(b))
    return (jout, *vjp(jnp.asarray(g))), _torch_vjp(tfn, a, b, g)


@pytest.mark.parametrize("spec", [dict(p=4), dict(p=4, cache_weights=True),
                                  dict(p=4, bwd_p=3),
                                  dict(p=4, bwd_p=3, cache_weights=True)])
def test_emulated_dot_vjp_matches_reference(spec):
    jcfg, tcfg = JCfg(scheme="ozaki1", **spec), TCfg(scheme="ozaki1", **spec)
    a = _conditioned(0, (2, 24, 40))
    b = _conditioned(1, (40, 56))
    g = _conditioned(2, (2, 24, 56))
    ref, ours = _vjp_pair(lambda x, y: jemulated.emulated_dot(x, y, jcfg),
                          lambda x, y: temulated.emulated_dot(x, y, tcfg),
                          a, b, g)
    for r, o in zip(ref, ours):
        np.testing.assert_array_equal(bits(o), bits(np.asarray(r)))
    # Cached and uncached give the same bits inside the port.
    plain = _torch_vjp(lambda x, y: temulated.emulated_dot(
        x, y, dataclasses.replace(tcfg, cache_weights=False)), a, b, g)
    for r, o in zip(ours, plain):
        assert torch.equal(r, o)


def test_emulated_dot_batched_vjp_matches_reference():
    jcfg, tcfg = JCfg(scheme="ozaki1", p=4), TCfg(scheme="ozaki1", p=4)
    a = _conditioned(3, (3, 16, 24))
    b = _conditioned(4, (3, 24, 20))
    g = _conditioned(5, (3, 16, 20))
    ref, ours = _vjp_pair(
        lambda x, y: jemulated.emulated_dot_batched(x, y, jcfg),
        lambda x, y: temulated.emulated_dot_batched(x, y, tcfg), a, b, g)
    for r, o in zip(ref, ours):
        np.testing.assert_array_equal(bits(o), bits(np.asarray(r)))


def test_only_a_differentiated_cached_call_prepares(monkeypatch):
    """As in the reference, only a differentiated call takes the cached
    route; the plain forward gives the same bits."""
    calls = []
    real = tprepared.prepare_rhs
    monkeypatch.setattr(tprepared, "prepare_rhs",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    tcfg = TCfg(scheme="ozaki1", p=4, cache_weights=True)
    a, b = t(_conditioned(0, (8, 40))), t(_conditioned(1, (40, 24)))
    out = temulated.emulated_dot(a, b, tcfg)
    assert not calls
    diff = temulated.emulated_dot(a.requires_grad_(True), b, tcfg)
    assert len(calls) == 1 and torch.equal(out, diff.detach())
