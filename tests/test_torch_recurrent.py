"""The port's recurrent mixers (models/rglru.py, models/ssd.py) and the
ring-buffer window cache (models/attention.py) against the reference,
module by module, from the same parameters and inputs (numpy, seeded).

Tolerances, float32: the RG-LRU scan is a log-depth doubling scan in the
port and ``jax.lax.associative_scan`` in the reference, which group the
same products differently, so they agree to 2e-6 relative to the
output's magnitude, not bit for bit; it is also held to a step loop. The
SSD's cumsums, exps and einsums are XLA's and torch's (same formulas:
``_segsum`` as a difference of cumsums), within 1e-5. A block's outputs
agree within 1e-5 * max|out|, under 'native' and 'ozaki1-p4' (whose
GEMMs are the same bits in both packages on equal operands). Each
block's prefill -> decode equals its own full forward within 1e-5
(float32 rounding of the two evaluation orders). The window cache's
prefill (a prompt past the window) and decodes (wrapping the ring) give
the reference's outputs and cache rows, also with the int8 cache.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_util import t
from repro import api as japi
from repro.configs.base import RGLRUConfig as JRCfg, SSDConfig as JSCfg
from repro.kernels import dispatch as jdispatch
from repro.models import attention as JA, rglru as JR, ssd as JS
from repro.models.common import GemmPolicy as JPolicy
from repro_torch import api as tapi, convert
from repro_torch.configs.base import RGLRUConfig, SSDConfig
from repro_torch.models import attention as TA, rglru as TR, ssd as TS
from repro_torch.models.common import GemmPolicy as TPolicy

D = 32
RCFG = dict(lru_width=48, conv_kernel=4)
SCFG = dict(d_state=8, head_dim=8, expand=2, conv_kernel=4, chunk=16)


def _pols(spec):
    return (jdispatch.resolve_policy(JPolicy(default=japi.precision(spec))),
            TPolicy(default=tapi.precision(spec)))


def _tree(jtree):
    return convert._to_torch(jax.tree.map(np.asarray, jtree), "cpu")


def _close(got, ref, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= tol * max(np.abs(ref).max(), 1.0), err


def _x(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


# ---------------------------------------------------------------------------
# RG-LRU.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,with_h0", [(1, True), (37, False), (64, True)])
def test_rglru_scan_matches_reference_and_step_loop(s, with_h0):
    rng = np.random.default_rng(s)
    a = (rng.random((2, s, 5)) * 0.9 + 0.05).astype(np.float32)
    u = _x(rng, 2, s, 5)
    h0 = _x(rng, 2, 5) if with_h0 else None
    got = TR.rglru_scan(t(a), t(u), None if h0 is None else t(h0))
    ref = jax.jit(JR.rglru_scan)(jnp.asarray(a), jnp.asarray(u),
                                 None if h0 is None else jnp.asarray(h0))
    _close(got, ref, 2e-6)
    h = np.zeros((2, 5), np.float64) if h0 is None else h0.astype(np.float64)
    for i in range(s):
        h = a[:, i] * h + u[:, i]
        np.testing.assert_allclose(got[:, i].numpy(), h, rtol=1e-5,
                                   atol=1e-5)


def _rglru_setup(dtype=np.float32):
    cfg = JRCfg(**RCFG)
    jp = JR.init_rglru(jax.random.PRNGKey(3), D, cfg, jnp.float32)
    return cfg, RGLRUConfig(**RCFG), jp, _tree(jp)


@pytest.mark.parametrize("spec", ["native", "ozaki1-p4"])
def test_rglru_block_train_prefill_decode_match_reference(spec):
    jcfg, tcfg, jp, tp = _rglru_setup()
    jpol, tpol = _pols(spec)
    rng = np.random.default_rng(1)
    x = _x(rng, 2, 20, D)

    def ref(p, x):              # one compile for every reference call
        outs = [JR.rglru_block_train(p, jcfg, x, jpol)]
        y, c = JR.rglru_block_prefill(p, jcfg, x[:, :17], jpol)
        outs.append((y, c))
        for i in range(17, 20):
            y, c = JR.rglru_block_decode(p, jcfg, x[:, i:i + 1], c, jpol)
            outs.append((y, c))
        return outs

    jtrain, *jsteps = jax.jit(ref)(jp, jnp.asarray(x))
    _close(TR.rglru_block_train(tp, tcfg, t(x), tpol), jtrain, 1e-5)
    ty, tc = TR.rglru_block_prefill(tp, tcfg, t(x[:, :17]), tpol)
    _close(ty, jsteps[0][0], 1e-5)
    assert tc["h"].dtype == torch.float32
    for i, (jy, jc) in zip(range(17, 20), jsteps[1:]):
        ty, tc = TR.rglru_block_decode(tp, tcfg, t(x[:, i:i + 1]), tc, tpol)
        _close(ty, jy, 1e-5)
        for k in ("h", "conv"):
            _close(tc[k], jc[k], 1e-5)


def test_rglru_prefill_then_decode_equals_full_forward():
    _, tcfg, _, tp = _rglru_setup()
    pol = TPolicy(default=tapi.precision("native"))
    x = t(_x(np.random.default_rng(2), 2, 24, D))
    full = TR.rglru_block_train(tp, tcfg, x, pol)
    y, c = TR.rglru_block_prefill(tp, tcfg, x[:, :16], pol)
    outs = [y]
    for i in range(16, 24):
        y, c = TR.rglru_block_decode(tp, tcfg, x[:, i:i + 1], c, pol)
        outs.append(y)
    _close(torch.cat(outs, 1), full.numpy(), 1e-5)


def test_rglru_init_layout_and_dtypes():
    jcfg, tcfg, jp, _ = _rglru_setup()
    ours = TR.init_rglru(torch.Generator().manual_seed(0), D, tcfg,
                         torch.bfloat16, "cpu", lead=(3,))
    ref = jax.eval_shape(lambda: JR.init_rglru(jax.random.PRNGKey(0), D,
                                               jcfg, jnp.bfloat16))
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in ours.items()} == {
        k: ((3,) + v.shape, "torch." + str(v.dtype)) for k, v in ref.items()}
    u = torch.exp(-torch.nn.functional.softplus(ours["lam"]))
    assert ((u > 0.9 - 1e-5) & (u < 0.999 + 1e-5)).all()
    cache = TR.init_rglru_cache(tcfg, D, 2, torch.bfloat16, "cpu")
    jc = JR.init_rglru_cache(jcfg, D, 2, jnp.bfloat16)
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in cache.items()} == {
        k: (v.shape, "torch." + str(v.dtype)) for k, v in jc.items()}


# ---------------------------------------------------------------------------
# SSD.
# ---------------------------------------------------------------------------

def test_segsum_matches_reference():
    x = _x(np.random.default_rng(4), 3, 2, 16, scale=0.3)
    got, ref = TS._segsum(t(x)), np.asarray(JS._segsum(jnp.asarray(x)))
    assert np.array_equal(np.isneginf(got.numpy()), np.isneginf(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got.numpy()[fin], ref[fin], atol=1e-6)


@pytest.mark.parametrize("s,chunk,with_h0", [(40, 16, False), (32, 8, True),
                                             (5, 16, True)])
def test_ssd_chunked_matches_reference(s, chunk, with_h0):
    """Ragged S pads to a whole chunk with dt = 0 steps, as the
    reference does; the final state equals its too."""
    rng = np.random.default_rng(s)
    b, h, p, n = 2, 3, 4, 8
    xh, bm, cm = _x(rng, b, s, h, p), _x(rng, b, s, n), _x(rng, b, s, n)
    dt = (rng.random((b, s, h)) * 0.1 + 0.01).astype(np.float32)
    a = -(rng.random(h) + 0.5).astype(np.float32)
    d_skip = rng.random(h).astype(np.float32)
    h0 = _x(rng, b, h, p, n) if with_h0 else None
    args = (xh, dt, a, bm, cm, d_skip)
    ty, tf = TS.ssd_chunked(*map(t, args), chunk,
                            None if h0 is None else t(h0))
    jy, jf = jax.jit(JS.ssd_chunked, static_argnums=6)(
        *map(jnp.asarray, args), chunk,
        None if h0 is None else jnp.asarray(h0))
    _close(ty, jy, 1e-5)
    _close(tf, jf, 1e-5)


def _ssd_setup():
    jcfg = JSCfg(**SCFG)
    jp = JS.init_ssd(jax.random.PRNGKey(5), D, jcfg, jnp.float32)
    return jcfg, SSDConfig(**SCFG), jp, _tree(jp)


@pytest.mark.parametrize("spec", ["native", "ozaki1-p4"])
def test_ssd_block_train_prefill_decode_match_reference(spec):
    """Under ozaki1-p4 the decode's state read (site 'ssd_state',
    ``bhpn,bn->bhp``) is the batched Scheme-I product with one output
    column: held bit for bit on the same state."""
    jcfg, tcfg, jp, tp = _ssd_setup()
    jpol, tpol = _pols(spec)
    rng = np.random.default_rng(6)
    x = _x(rng, 2, 37, D)
    cm = _x(rng, 2, 8)

    def ref(p, x, cm):          # one compile for every reference call
        outs = [JS.ssd_block_train(p, D, jcfg, x, jpol)]
        y, c = JS.ssd_block_prefill(p, D, jcfg, x[:, :34], jpol)
        outs.append((y, c))
        for i in range(34, 37):
            y, c = JS.ssd_block_decode(p, D, jcfg, x[:, i:i + 1], c, jpol)
            outs.append((y, c))
        return outs, JS.policy_einsum("bhpn,bn->bhp", c["ssm"], cm, jpol,
                                      "ssd_state")

    (jtrain, *jsteps), ref_state = jax.jit(ref)(jp, jnp.asarray(x),
                                                jnp.asarray(cm))
    _close(TS.ssd_block_train(tp, D, tcfg, t(x), tpol), jtrain, 1e-5)
    ty, tc = TS.ssd_block_prefill(tp, D, tcfg, t(x[:, :34]), tpol)
    _close(ty, jsteps[0][0], 1e-5)
    assert tc["ssm"].dtype == torch.float32
    for i, (jy, jc) in zip(range(34, 37), jsteps[1:]):
        ty, tc = TS.ssd_block_decode(tp, D, tcfg, t(x[:, i:i + 1]), tc, tpol)
        _close(ty, jy, 1e-5)
        for k in ("ssm", "conv"):
            _close(tc[k], jc[k], 1e-5)
    got = TS.policy_einsum("bhpn,bn->bhp", t(np.asarray(jc["ssm"])), t(cm),
                           tpol, "ssd_state")
    ref = ref_state
    if spec == "native":
        _close(got, ref, 1e-6)
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_ssd_prefill_then_decode_equals_full_forward():
    _, tcfg, _, tp = _ssd_setup()
    pol = TPolicy(default=tapi.precision("native"))
    x = t(_x(np.random.default_rng(7), 2, 24, D))
    full = TS.ssd_block_train(tp, D, tcfg, x, pol)
    y, c = TS.ssd_block_prefill(tp, D, tcfg, x[:, :18], pol)
    outs = [y]
    for i in range(18, 24):
        y, c = TS.ssd_block_decode(tp, D, tcfg, x[:, i:i + 1], c, pol)
        outs.append(y)
    _close(torch.cat(outs, 1), full.numpy(), 1e-5)


def test_ssd_init_layout_and_dtypes():
    jcfg, tcfg, _, _ = _ssd_setup()
    ours = TS.init_ssd(torch.Generator().manual_seed(0), D, tcfg,
                       torch.bfloat16, "cpu", lead=(2,))
    ref = jax.eval_shape(lambda: JS.init_ssd(jax.random.PRNGKey(0), D,
                                             jcfg, jnp.bfloat16))
    flat = lambda tree, pre="": {  # noqa: E731
        pre + k: v for k, v in tree.items() if not isinstance(v, dict)} | {
        pre + k + "/" + k2: v2 for k, v in tree.items()
        if isinstance(v, dict) for k2, v2 in v.items()}
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in
            flat(ours).items()} == {
        k: ((2,) + v.shape, "torch." + str(v.dtype))
        for k, v in flat(ref).items()}
    assert (TS.d_inner(D, tcfg), TS.n_heads(D, tcfg)) == (
        JS.d_inner(D, jcfg), JS.n_heads(D, jcfg))
    cache = TS.init_ssd_cache(tcfg, D, 2, torch.bfloat16, "cpu")
    jc = JS.init_ssd_cache(jcfg, D, 2, jnp.bfloat16)
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in cache.items()} == {
        k: (v.shape, "torch." + str(v.dtype)) for k, v in jc.items()}


# ---------------------------------------------------------------------------
# The ring-buffer window cache.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("int8", [False, True])
def test_window_ring_prefill_and_decode_match_reference(int8):
    """A 13-token prompt into an 8-row ring (window 8): the prefill keeps
    its last 8 rows rolled so that position p sits at slot p % 8; then 6
    decodes wrap the ring. Outputs within 1e-5, the cache rows as the
    reference's (int8 values bit for bit, their scales to 1e-5)."""
    jcfg = JA.AttnConfig(d_model=D, n_heads=4, n_kv_heads=2, head_dim=8,
                         window=8, q_chunk=8, kv_chunk=8, cache_int8=int8)
    tcfg = TA.AttnConfig(**{f.name: getattr(jcfg, f.name) for f in
                            dataclasses.fields(TA.AttnConfig)})
    jp = JA.init_attention(jax.random.PRNGKey(8), jcfg)
    tp = _tree(jp)
    jpol, tpol = _pols("native")
    rng = np.random.default_rng(9)
    x = _x(rng, 2, 19, D)
    pos = np.broadcast_to(np.arange(13, dtype=np.int32), (2, 13))

    def ref(p, x, pos):         # one compile for every reference call
        y, c = JA.attention_prefill(p, jcfg, x[:, :13], pos, jpol, 32)
        outs = [(y, c)]
        for i in range(13, 19):
            y, c = JA.attention_decode(p, jcfg, x[:, i:i + 1], jnp.int32(i),
                                       c, jpol)
            outs.append((y, c))
        return outs

    jouts = jax.jit(ref)(jp, jnp.asarray(x), jnp.asarray(pos))
    tcache = TA.init_cache(tcfg, 2, 32, torch.float32, "cpu")
    assert tcache["k"].shape[1] == 8
    ty, tcache = TA.attention_prefill(tp, tcfg, t(x[:, :13]), t(pos), tpol,
                                      tcache)
    jy, jcache = jouts[0]

    def same_cache():
        for k, v in jcache.items():
            if v.dtype == jnp.int8:
                np.testing.assert_array_equal(tcache[k].numpy(),
                                              np.asarray(v))
            else:
                _close(tcache[k], v, 1e-5)

    _close(ty, jy, 1e-5)
    same_cache()
    for i, (jy, jcache) in zip(range(13, 19), jouts[1:]):
        ty, tcache = TA.attention_decode(tp, tcfg, t(x[:, i:i + 1]), i,
                                         tcache, tpol)
        _close(ty, jy, 1e-5)
        same_cache()
