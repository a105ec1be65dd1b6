"""The port's Scheme-II prepared weights against the reference
(repro_torch.kernels.prepared.{prepare_rhs, matmul_prepared_scheme2,
prepare_params}, core.emulated under ``ozaki2...+cached``, vs
repro.kernels.prepared, repro.core.emulated).

The same seeded numpy inputs go through both packages. The residue
stacks, scales, budgets and twins must be bit-identical, and so must
every product: the emulation interior is exact integer arithmetic, and
both packages round the same float ops in the same order. The plain
version of EmuGEMM-II's prepared form (what the 'cuda' backend's wrapper
runs on a CPU tensor) is held against the reference's fused GPU lowering
with a residue rhs (``gpu.fused_matmul_scheme2`` with ``b_res``) in
interpret mode, as the reference's own tests run it on the CPU, and
against its 'stacked' XLA expansion. float64 runs under
``jax.enable_x64(True)``, the context manager only.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_util import bits, t
from conftest import conditioned
from repro.core import emulated as jemulated, scheme2 as jscheme2
from repro.core.precision import EmulationConfig as JCfg
from repro.kernels import dispatch as jdispatch, prepared as jprepared
from repro.kernels.backends import gpu as jgpu
from repro.models.common import GemmPolicy as JPolicy
from repro_torch.core import emulated as temulated
from repro_torch.core.precision import EmulationConfig as TCfg
from repro_torch.kernels import dispatch, ozaki2, prepared as tprepared
from repro_torch.models.common import GemmPolicy as TPolicy

MODULI_COUNTS = [4, 6, 8, 16]
SHAPES = [(128, 256), (100, 72)]          # aligned, ragged (K, N)
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _same(x, y):
    """Bitwise equality of a torch tensor and a jax array (floats through
    float32 or float64, exact; ints as values)."""
    y = np.asarray(y if not hasattr(y, "dtype") or y.dtype != jnp.bfloat16
                   else jnp.asarray(y).astype(jnp.float32))
    if x.is_floating_point():
        if x.dtype == torch.float64:
            np.testing.assert_array_equal(x.numpy().view(np.int64),
                                          y.astype(np.float64).view(np.int64))
        else:
            np.testing.assert_array_equal(bits(x), bits(y))
    else:
        np.testing.assert_array_equal(x.numpy(), y)


def _both(x: np.ndarray, dtype: str):
    tt, jt = DTYPES[dtype]
    jx = jnp.asarray(x).astype(jt)
    return jx, t(np.asarray(jx.astype(jnp.float32)), tt)


def _cfgs(p, **kw):
    return (JCfg(scheme="ozaki2", p=p, **kw),
            TCfg(scheme="ozaki2", p=p, **kw))


def _same_prep(tp, jp):
    """A port prep (either layout, read through ``stacked()``, the
    reference's (p, K16, N16) layout) against the reference's."""
    assert isinstance(tp, tprepared.PreparedResidues)
    assert (tp.moduli, tp.budget_bits, tp.k, tp.n, tp.p, tp.padded_k,
            tp.padded_n) == (tuple(jp.moduli), jp.budget_bits, jp.k, jp.n,
                             jp.p, jp.padded_k, jp.padded_n)
    assert tp.residues.dtype == torch.int8
    _same(tp.stacked(), jp.residues)
    _same(tp.scale, jp.scale)


# ---------------------------------------------------------------------------
# The encode: prepare_rhs under ozaki2.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("p", MODULI_COUNTS)
@pytest.mark.parametrize("k,n", SHAPES)
def test_prepare_rhs_matches_reference(dtype, p, k, n):
    jcfg, tcfg = _cfgs(p, impl="xla")
    jb, tb = _both(conditioned(np.random.default_rng(p + k), (k, n)), dtype)
    jp = jprepared.prepare_rhs(jb, jcfg, with_twin=True)
    tp = tprepared.prepare_rhs(tb, tcfg, with_twin=True)
    assert tp.layout == jp.layout == "stacked"
    _same_prep(tp, jp)
    _same_prep(tp.twin, jp.twin)
    # The stack reconstructs the weight within the integerization step.
    np.testing.assert_array_equal(tp.reconstruct().numpy(),
                                  np.asarray(jp.reconstruct()))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_prepare_rhs_bwd_p_keeps_the_leading_moduli(dtype):
    jcfg, tcfg = _cfgs(6, bwd_p=3, impl="xla")
    jb, tb = _both(conditioned(np.random.default_rng(1), (100, 72)), dtype)
    jp = jprepared.prepare_rhs(jb, jcfg, with_twin=True)
    tp = tprepared.prepare_rhs(tb, tcfg, with_twin=True)
    assert tp.twin.moduli == tp.moduli[:3]
    _same_prep(tp, jp)
    _same_prep(tp.twin, jp.twin)


@pytest.mark.parametrize("p", [8, 16])
def test_prepare_rhs_float64_matches_reference(p):
    rng = np.random.default_rng(p)
    b = conditioned(rng, (100, 72), dtype=np.float64)
    a = conditioned(rng, (24, 100), dtype=np.float64)
    jcfg, tcfg = _cfgs(p, impl="xla")
    with jax.enable_x64(True):
        jp = jprepared.prepare_rhs(jnp.asarray(b), jcfg, with_twin=True)
        tp = tprepared.prepare_rhs(t(b), tcfg, with_twin=True)
        _same_prep(tp, jp)
        _same_prep(tp.twin, jp.twin)
        ref = jprepared.matmul_prepared(jnp.asarray(a), jp,
                                        out_dtype=jnp.float64)
        _same(tprepared.matmul_prepared(t(a), tp, out_dtype=torch.float64),
              ref)


def test_layout_follows_impl_and_backend():
    b = t(conditioned(np.random.default_rng(2), (64, 48)))
    assert tprepared.prepare_rhs(b, TCfg(scheme="ozaki2", p=4)).layout == \
        "stacked"                      # a CPU tensor resolves to 'torch'
    assert tprepared.prepare_rhs(b, TCfg(scheme="ozaki2", p=4,
                                         backend="cuda")).layout == "planes"
    assert tprepared.prepare_rhs(b, TCfg(scheme="ozaki2", p=4, impl="xla",
                                         backend="cuda")).layout == "stacked"


def test_ozaki2_refusals_that_remain():
    """A PreparedResidues rhs under ozaki1, a PreparedOperand under
    ozaki2, a complex weight and a 3-D weight are refused, as in the
    reference."""
    rng = np.random.default_rng(3)
    b = t(conditioned(rng, (64, 32)))
    res = tprepared.prepare_rhs(b, TCfg(scheme="ozaki2", p=4))
    op = tprepared.prepare_rhs(b, TCfg(scheme="ozaki1", p=4))
    with pytest.raises(ValueError, match="Scheme-II"):
        tprepared.prepare_rhs(res, TCfg(scheme="ozaki1", p=4))
    with pytest.raises(ValueError, match="Scheme-I"):
        tprepared.prepare_rhs(op, TCfg(scheme="ozaki2", p=4))
    a = t(conditioned(rng, (8, 64)))
    with pytest.raises(ValueError, match="Scheme-II"):
        dispatch.emulated_matmul(a, res, cfg="ozaki1-p4")
    with pytest.raises(ValueError, match="Scheme-I"):
        dispatch.emulated_matmul(a, op, cfg="ozaki2-m4")
    with pytest.raises(ValueError, match="real-valued"):
        tprepared.prepare_rhs(torch.complex(b, b), TCfg(scheme="ozaki2", p=4))
    with pytest.raises(ValueError, match="2-D"):
        tprepared.prepare_rhs(b[None], TCfg(scheme="ozaki2", p=4))
    with pytest.raises(ValueError, match="real-valued"):
        tprepared.matmul_prepared(torch.complex(a, a), res)
    # The 'cuda' backend takes at most 16 moduli, as the 2-D form does;
    # 'torch' runs more.
    from repro_torch.core.precision import DEFAULT_MODULI
    cfg = TCfg(scheme="ozaki2", p=17, moduli=DEFAULT_MODULI + (181,))
    wide = tprepared.prepare_rhs(b, dataclasses.replace(cfg, backend="cuda"))
    with pytest.raises(NotImplementedError, match="at most 16 moduli"):
        tprepared.matmul_prepared(a, wide)
    assert torch.equal(
        tprepared.matmul_prepared(a, tprepared.prepare_rhs(b, cfg)),
        dispatch.emulated_matmul(a, b, cfg=cfg, backend="torch"))


# ---------------------------------------------------------------------------
# The prepared form's plain version against the reference's kernel.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("p", [4, 6])
@pytest.mark.parametrize("mkn", [(64, 96, 80), (100, 200, 77)])
def test_prepared_plain_matches_reference_gpu_kernel(mkn, p, dtype):
    """K5g with ``b_res``: the 'cuda' backend's wrapper (its plain version
    on CPU tensors) against the reference's fused GPU lowering with a
    residue rhs in interpret mode, aligned and ragged; then against the
    reference's 'stacked' expansion of the same stack."""
    m, k, n = mkn
    rng = np.random.default_rng(p + m)
    ja, ta = _both(conditioned(rng, (m, k)), dtype)
    jb, tb = _both(conditioned(rng, (k, n)), dtype)
    jcfg, tcfg = _cfgs(p, backend="gpu")
    jp = jprepared.prepare_rhs(jb, jcfg)
    tp = tprepared.prepare_rhs(tb, dataclasses.replace(tcfg, backend="cuda"))
    assert (jp.layout, tp.layout) == ("fused", "planes")
    _same_prep(tp, jp)
    out_j, out_t = DTYPES[dtype][1], DTYPES[dtype][0]
    ref = jprepared.matmul_prepared(ja, jp, out_dtype=out_j)
    # The reference's kernel itself, on the operands padded to its tiles.
    mp, kp, np_ = -(-m // 16) * 16, jp.padded_k, jp.padded_n
    blocks = jdispatch.select_blocks(mp, np_, kp, p, out_bytes=out_t.itemsize,
                                     backend="gpu", scheme="ozaki2")
    assert blocks is not None and blocks.aligned(mp, np_, kp)
    ja_pad = jnp.pad(ja, ((0, mp - m), (0, kp - k)))
    mu = jscheme2._pow2_int_scale(ja_pad, axis=1, budget_bits=min(
        jp.budget_bits, jnp.finfo(ja.dtype).nmant + 1))
    kernel = jgpu.fused_matmul_scheme2(ja_pad, jp.residues, mu, jp.scale,
                                       jp.moduli, blocks, out_dtype=out_j)
    _same(t(np.asarray(kernel[:m, :n].astype(jnp.float32))), ref)
    before = ozaki2.COUNTS.plain_cuda_calls
    out = tprepared.matmul_prepared(ta, tp, out_dtype=out_t)
    assert ozaki2.COUNTS.plain_cuda_calls == before
    _same(out, ref)
    stacked = jprepared.matmul_prepared(
        ja, dataclasses.replace(jp, layout="stacked"), out_dtype=out_j)
    _same(out, stacked)
    # ... and the unprepared product: both operands share one type.
    assert torch.equal(out, dispatch.emulated_matmul(ta, tb,
                                                     cfg=f"ozaki2-m{p}"))


def test_prepared_form_plain_reads_padded_planes():
    """The prepared form on a weight's planes (K padded to the plane
    GEMM's K tile, N logical) equals the stacked plain version on the
    16-padded stack and a padded lhs, sliced to the logical N: zero
    residues change no bit."""
    rng = np.random.default_rng(9)
    tp = tprepared.prepare_rhs(t(conditioned(rng, (50, 30))),
                               TCfg(scheme="ozaki2", p=6, backend="cuda"))
    assert tp.residues.shape == (6, 30, ozaki2.PLANE_K)
    assert tp.stacked().shape == (6, 64, 32)
    a = t(conditioned(rng, (7, 50)))
    mu = torch.ones(7, 1)
    out = ozaki2.fused_matmul_scheme2_prepared(a, tp.residues, mu, tp.scale,
                                               tp.moduli, torch.float32, 30)
    a_pad = torch.nn.functional.pad(a, (0, 14))
    full = ozaki2.fused_matmul_scheme2_prepared_plain(
        a_pad, tp.stacked(), mu, tp.scale, tp.moduli, torch.float32)
    assert out.shape == (7, 30) and torch.equal(out, full[:, :30])


# ---------------------------------------------------------------------------
# The cached VJP and prepare_params.
# ---------------------------------------------------------------------------

def _vjp(fn, a, b, g, dtype):
    ta = a.clone().requires_grad_(True)
    tb = b.clone().requires_grad_(True)
    out = fn(ta, tb)
    out.backward(g)
    return out.detach(), ta.grad, tb.grad


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("spec", [dict(p=6), dict(p=6, bwd_p=4)])
def test_cached_vjp_matches_reference_and_uncached(spec, dtype):
    """``emulated_dot`` under ozaki2+cached: forward, dA (from the twin)
    and dB equal the reference's custom VJP and the port's uncached
    call, bit for bit."""
    rng = np.random.default_rng(len(spec))
    ja, ta = _both(conditioned(rng, (2, 24, 40)), dtype)
    jb, tb = _both(conditioned(rng, (40, 56)), dtype)
    jg, tg = _both(conditioned(rng, (2, 24, 56)), dtype)
    jcfg = JCfg(scheme="ozaki2", cache_weights=True, impl="xla", **spec)
    tcfg = TCfg(scheme="ozaki2", cache_weights=True, **spec)
    jout, vjp = jax.vjp(lambda x, y: jemulated.emulated_dot(x, y, jcfg),
                        ja, jb)
    ref = (jout, *vjp(jg))
    ours = _vjp(lambda x, y: temulated.emulated_dot(x, y, tcfg), ta, tb, tg,
                dtype)
    for r, o in zip(ref, ours):
        _same(o, r)
    plain = _vjp(lambda x, y: temulated.emulated_dot(
        x, y, dataclasses.replace(tcfg, cache_weights=False)), ta, tb, tg,
        dtype)
    for r, o in zip(ours, plain):
        assert torch.equal(r, o)


def test_emulated_dot_prepared_matches_the_per_call_cache():
    """The once-per-step route (a prep built beforehand) gives the per-call
    cache's forward and gradients, and no gradient to the prep."""
    rng = np.random.default_rng(5)
    a, b = t(conditioned(rng, (3, 16, 40))), t(conditioned(rng, (40, 24)))
    g = t(conditioned(rng, (3, 16, 24)))
    cfg = TCfg(scheme="ozaki2", p=6, cache_weights=True)
    prep = tprepared.prepare_rhs(b, cfg, with_twin=True)
    hoisted = _vjp(lambda x, y: temulated.emulated_dot_prepared(x, y, prep,
                                                                cfg),
                   a, b, g, "float32")
    per_call = _vjp(lambda x, y: temulated.emulated_dot(x, y, cfg), a, b, g,
                    "float32")
    for h, c in zip(hoisted, per_call):
        assert torch.equal(h, c)
    assert not prep.residues.requires_grad and prep.residues.grad is None


def test_prepare_params_matches_reference():
    """Mirrors the reference's test_prepare_params_wraps_ozaki2_projections
    and its R4: 2-D dense leaves are prepared, einsum-consumed and 3-D
    layer stacks are not (so olmo-1b prepares no leaf)."""
    rng = np.random.default_rng(36)
    params = {"ffn": {"wi": conditioned(rng, (64, 128))},
              "mixer": {"w_r": conditioned(rng, (64, 64))},
              "layers": {"wi": conditioned(rng, (2, 64, 128))}}
    jout = jprepared.prepare_params(
        jax.tree.map(jnp.asarray, params),
        JPolicy(default=JCfg(scheme="ozaki2", p=4, impl="xla")))
    tout = tprepared.prepare_params(
        {k: {n: t(x) for n, x in v.items()} for k, v in params.items()},
        TPolicy(default=TCfg(scheme="ozaki2", p=4)))
    _same_prep(tout["ffn"]["wi"], jout["ffn"]["wi"])
    assert isinstance(tout["mixer"]["w_r"], torch.Tensor)
    assert isinstance(tout["layers"]["wi"], torch.Tensor)
    from repro_torch import configs as tconfigs
    from repro_torch.launch import steps as TS
    arch = tconfigs.get_smoke_config("olmo-1b")
    olmo = TS.init_state(arch, 0, "cpu")["params"]
    same = tprepared.prepare_params(olmo, TPolicy(
        default=TCfg(scheme="ozaki2", p=6, cache_weights=True)))
    from repro_torch.utils.tree import tree_flatten
    assert all(x is tree_flatten(olmo)[k]
               for k, x in tree_flatten(same).items())


def test_front_doors_take_a_prepared_rhs():
    """dot_general and einsum consume a PreparedResidues rhs in its (K, N)
    layout, with the reference's scheme checks."""
    from repro_torch import api as tapi
    rng = np.random.default_rng(7)
    x, b = t(conditioned(rng, (2, 40, 5))), t(conditioned(rng, (40, 24)))
    prep = tprepared.prepare_rhs(b, TCfg(scheme="ozaki2", p=6))
    want = dispatch.emulated_matmul(x.movedim(1, -1).reshape(-1, 40), b,
                                    cfg="ozaki2-m6").reshape(2, 5, 24)
    got = tapi.dot_general(x, prep, (((1,), (0,)), ((), ())),
                           precision="ozaki2-m6")
    assert torch.equal(got, want)
    got = tapi.einsum("bks,kn->bns", x, prep, precision="ozaki2-m6")
    assert torch.equal(got, want.transpose(1, 2))
    with pytest.raises(ValueError, match="Scheme-II"):
        tapi.dot_general(x, prep, (((1,), (0,)), ((), ())),
                         precision="ozaki1-p4")
    with pytest.raises(ValueError, match="native"):
        tapi.einsum("bks,kn->bsn", x, prep, precision="native")
    with pytest.raises(ValueError, match="'...k,kn->...n'"):
        tapi.einsum("bks,nk->bsn", x, prep, precision="ozaki2-m6")
