"""The 'planes' layout of the port's Scheme-II prepared weights (the 'cuda'
backend's: the (p, N, Kp) K-contiguous int8 planes of B^T that the plane
route of EmuGEMM-II's prepared form streams) against the reference
(repro.kernels.prepared, repro.core.scheme2).

The preps are built with ``backend="cuda"`` on CPU tensors, so the
encode and the prepared form run their plain versions
(``ozaki2.encode_planes_plain``, ``ozaki2.plane_matmul_plain``), which the
kernels are held to bit for bit on the card. Read through
``PreparedResidues.stacked()``, the planes and scales must equal the
reference's residue stack bit for bit; every product must equal the
reference's, and the 'stacked' plain version on the same residues.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_util import bits, t
from conftest import conditioned
from repro.core import scheme2 as jscheme2
from repro.core.precision import EmulationConfig as JCfg
from repro.kernels import prepared as jprepared
from repro_torch.core import scheme2
from repro_torch.core.precision import EmulationConfig as TCfg, default_moduli
from repro_torch.kernels import dispatch, ozaki2, prepared as tprepared

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _both(x: np.ndarray, dtype: str):
    tt, jt = DTYPES[dtype]
    jx = jnp.asarray(x).astype(jt)
    return jx, t(np.asarray(jx.astype(jnp.float32)), tt)


def _planes_cfg(p, **kw):
    return (JCfg(scheme="ozaki2", p=p, impl="xla", **kw),
            TCfg(scheme="ozaki2", p=p, backend="cuda", **kw))


def _same_planes(tp, jp):
    """Planes of the right shape, equal to the reference's stack through
    the reference-layout view."""
    assert tp.layout == "planes"
    assert tp.residues.shape == (tp.p, tp.n, ozaki2.plane_k(tp.k))
    assert (tp.moduli, tp.budget_bits, tp.k, tp.n, tp.padded_k,
            tp.padded_n) == (tuple(jp.moduli), jp.budget_bits, jp.k, jp.n,
                             jp.padded_k, jp.padded_n)
    np.testing.assert_array_equal(tp.stacked().numpy(),
                                  np.asarray(jp.residues))
    np.testing.assert_array_equal(bits(tp.scale), bits(jp.scale))
    # Past K the planes hold zero residues.
    assert not tp.residues[..., tp.k:].any()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("p", [4, 6, 16])
@pytest.mark.parametrize("k,n", [(128, 256), (100, 72), (5, 40)])
def test_planes_prep_matches_reference(dtype, p, k, n):
    """A 'cuda' prep's planes and its twin's equal the reference's
    ``prepare_rhs`` stacks; the weight reconstructs as the reference's."""
    jcfg, tcfg = _planes_cfg(p)
    jb, tb = _both(conditioned(np.random.default_rng(p + k + n), (k, n)),
                   dtype)
    jp = jprepared.prepare_rhs(jb, jcfg, with_twin=True)
    tp = tprepared.prepare_rhs(tb, tcfg, with_twin=True)
    _same_planes(tp, jp)
    _same_planes(tp.twin, jp.twin)
    assert tp.twin.residues.shape == (p, k, ozaki2.plane_k(n))
    np.testing.assert_array_equal(tp.reconstruct().numpy(),
                                  np.asarray(jp.reconstruct()))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_planes_twin_bwd_p_keeps_the_leading_moduli(dtype):
    jcfg, tcfg = _planes_cfg(6, bwd_p=3)
    jb, tb = _both(conditioned(np.random.default_rng(11), (100, 72)), dtype)
    jp = jprepared.prepare_rhs(jb, jcfg, with_twin=True)
    tp = tprepared.prepare_rhs(tb, tcfg, with_twin=True)
    assert tp.twin.moduli == tp.moduli[:3] and tp.twin.residues.shape[0] == 3
    _same_planes(tp, jp)
    _same_planes(tp.twin, jp.twin)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("p", [4, 6, 16])
@pytest.mark.parametrize("rows,k", [(37, 200), (16, 8), (3, 1)])
def test_encode_planes_plain_matches_reference_residues(dtype, p, rows, k):
    """The encode's plain version on a real float32 or bf16 operand (signed
    values, K <= 8 among them) equals the reference's
    ``balanced_residues(trunc(x * s))``, padded with zero residues to the
    plane GEMM's K tile."""
    moduli = default_moduli(p)
    jx, tx = _both(conditioned(np.random.default_rng(rows + k + p),
                               (rows, k)), dtype)
    budget = scheme2.budget_bits(moduli, k, tx.dtype)
    js = jscheme2._pow2_int_scale(jx, axis=1, budget_bits=budget)
    ts = scheme2._pow2_int_scale(tx, -1, budget)
    np.testing.assert_array_equal(bits(ts), bits(js))
    want = jscheme2.balanced_residues(jnp.trunc(jx * js), moduli)
    want = np.pad(np.asarray(want),
                  ((0, 0), (0, 0), (0, ozaki2.plane_k(k) - k)))
    got = ozaki2.encode_planes_plain(tx, ts, moduli)
    assert got.dtype == torch.int8 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got < 0).any()                   # balanced: negative residues


def test_encode_planes_plain_subnormal_rows():
    """H1: a row of float32 subnormals integerizes to zeros under the
    flushed CPU arithmetic XLA:CPU uses (the scale is clamped below the
    type's overflow point), as in the reference."""
    moduli = default_moduli(6)
    x = conditioned(np.random.default_rng(3), (4, 64))
    x[1] = np.float32(1e-40) * np.sign(x[1])
    jx, tx = jnp.asarray(x), t(x)
    old = torch.set_flush_denormal(True)
    try:
        ts = scheme2._pow2_int_scale(tx, -1, 24)
        got = ozaki2.encode_planes_plain(tx, ts, moduli)
    finally:
        torch.set_flush_denormal(old)
    js = jscheme2._pow2_int_scale(jx, axis=1, budget_bits=24)
    want = np.asarray(jscheme2.balanced_residues(jnp.trunc(jx * js), moduli))
    np.testing.assert_array_equal(got[..., :64].numpy(), want)
    assert not got[:, 1].any()


@pytest.mark.parametrize("a_type,w_type,out", [
    ("float32", "bfloat16", torch.float32), ("bfloat16", "float32",
                                              torch.bfloat16),
    ("float32", "float32", torch.bfloat16), ("bfloat16", "bfloat16",
                                             torch.float64),
    ("float32", "bfloat16", torch.float64)])
def test_planes_mixed_types_match_stacked_plain(a_type, w_type, out):
    """A float32 or bf16 lhs against the planes of a weight of the other
    type, into every output type: the plane route's plain versions equal
    the 'stacked' plain version on the reference-layout view and the
    unprepared product, bit for bit (the scales, powers of two, divide
    in the output type as ``scheme2.unscale`` does)."""
    rng = np.random.default_rng(21)
    _, ta = _both(conditioned(rng, (33, 130)), a_type)
    _, tb = _both(conditioned(rng, (130, 50)), w_type)
    cfg = TCfg(scheme="ozaki2", p=6, backend="cuda")
    prep = tprepared.prepare_rhs(tb, cfg)
    mu = scheme2._pow2_int_scale(ta, -1, min(prep.budget_bits,
                                              scheme2.MANTISSA[ta.dtype]))
    got = ozaki2.fused_matmul_scheme2_prepared(
        ta, prep.residues, mu, prep.scale, prep.moduli, out, prep.n)
    want = ozaki2.fused_matmul_scheme2_prepared_plain(
        ta, prep.stacked(), mu, prep.scale, prep.moduli, out, prep.n)
    assert got.dtype == out and got.shape == (33, 50)
    assert torch.equal(got, want)
    assert torch.equal(tprepared.matmul_prepared(ta, prep, out), got)
    if a_type == w_type:
        assert torch.equal(got, dispatch.emulated_matmul(
            ta, tb, cfg=dataclasses.replace(cfg, backend="torch"),
            out_dtype=out))


def test_planes_of_a_transposed_view():
    """The tied head is prepared from emb.T, a strided view: the encode
    reads it through its strides, and its planes equal those of a
    contiguous copy, which the reference's stack confirms."""
    rng = np.random.default_rng(8)
    emb = t(conditioned(rng, (90, 48)))                 # (V, d)
    cfg = TCfg(scheme="ozaki2", p=6, backend="cuda")
    view = tprepared.prepare_rhs(emb.T, cfg, with_twin=True)
    copy = tprepared.prepare_rhs(emb.T.contiguous(), cfg, with_twin=True)
    for x, y in ((view, copy), (view.twin, copy.twin)):
        assert torch.equal(x.residues, y.residues)
        assert torch.equal(x.scale, y.scale)
    jp = jprepared.prepare_rhs(jnp.asarray(np.asarray(emb).T),
                               JCfg(scheme="ozaki2", p=6, impl="xla"),
                               with_twin=True)
    _same_planes(view, jp)
    _same_planes(view.twin, jp.twin)


def test_planes_refuse_what_the_route_does_not_take():
    """The prepared form takes only planes of the logical N whose K tile
    matches the lhs."""
    rng = np.random.default_rng(4)
    prep = tprepared.prepare_rhs(t(conditioned(rng, (64, 24))),
                                 TCfg(scheme="ozaki2", p=4, backend="cuda"))
    a = t(conditioned(rng, (5, 64)))
    mu = scheme2._pow2_int_scale(a, -1, prep.budget_bits)
    with pytest.raises(ValueError, match="prepared"):
        ozaki2.fused_matmul_scheme2_prepared(
            a, prep.residues, mu, prep.scale, prep.moduli, torch.float32, 20)
    with pytest.raises(ValueError, match="prepared"):
        ozaki2.fused_matmul_scheme2_prepared(
            a, prep.stacked(), mu, prep.scale, prep.moduli, torch.float32, 24)
