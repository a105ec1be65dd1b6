"""The port's olmo-1b serving step against the reference
(repro_torch.models.model.forward_step vs repro.models.model.forward_step)
on the smoke config, from the same parameters (repro_torch.convert).

Logits agree within 1e-4 * max|logits| under 'native' and 'ozaki1-p4':
the emulated GEMMs are bit-identical on equal inputs, and what differs
is float32 ulps of XLA's and torch's softmax, rope, norm and native
matmul, which the emulation carries forward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_util import t
from repro import api as japi, configs as jconfigs
from repro.kernels import dispatch as jdispatch
from repro.models import model as JM
from repro.models.common import GemmPolicy as JPolicy
from repro_torch import api as tapi, configs as tconfigs, convert
from repro_torch.models import model as TM
from repro_torch.models.common import GemmPolicy as TPolicy

B, C, L = 3, 8, 32


@pytest.fixture(scope="module")
def setup():
    jarch = jconfigs.get_smoke_config("olmo-1b")
    tarch = tconfigs.get_smoke_config("olmo-1b")
    jparams = JM.init_params(jax.random.PRNGKey(0), jarch.model)
    tree = jax.tree.map(np.asarray, jparams)
    tparams = convert.params_from_jax(tree, tarch.model, device="cpu")
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 500, (B, C)).astype(np.int32)
    start = np.array([0, 5, 20], np.int32)
    n_new = np.array([8, 1, 3], np.int32)
    jcache = JM.init_cache(jarch.model, B, L)
    hist = {k: (0.5 * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in jcache["layers"]["b0"].items()}
    return jarch, tarch, jparams, tparams, tokens, start, n_new, hist


@pytest.mark.parametrize("spec", ["native", "ozaki1-p4"])
def test_forward_step_logits_match_reference(setup, spec):
    jarch, tarch, jparams, tparams, tokens, start, n_new, hist = setup
    jpol = jdispatch.resolve_policy(JPolicy(default=japi.precision(spec)))
    jcache = {"layers": {"b0": {k: jnp.asarray(v) for k, v in hist.items()}}}
    jlog, jout = JM.forward_step(jparams, jarch.model, jnp.asarray(tokens),
                                 jnp.asarray(start), jnp.asarray(n_new),
                                 jcache, jpol)
    tcache = {"layers": {"b0": {k: t(v) for k, v in hist.items()}}}
    tpol = TPolicy(default=tapi.precision(spec))
    tlog, tout = TM.forward_step(tparams, tarch.model, t(tokens), t(start),
                                 t(n_new), tcache, tpol)
    jlog = np.asarray(jlog)
    assert tlog.shape == jlog.shape
    tol = 1e-4 * np.abs(jlog).max()
    assert np.abs(tlog.numpy() - jlog).max() <= tol
    # The valid fresh KV slots were written alike. Slots of padding
    # columns are garbage the engine sends to its scratch page; the port
    # computes them from zeroed value rows (attention.py, R5).
    for k in ("k", "v"):
        for lane in range(B):
            end = start[lane] + n_new[lane]
            np.testing.assert_allclose(
                tout["layers"]["b0"][k][:, lane, :end].numpy(),
                np.asarray(jout["layers"]["b0"][k])[:, lane, :end],
                atol=1e-5, rtol=1e-5)


def test_split_layers_and_layout(setup):
    _, tarch, _, tparams, *_ = setup
    tree = {k: v for k, v in tparams.items()}
    split = convert.params_from_jax(
        {"emb": tree["emb"].numpy(), "ln_f": {},
         "layers": {"b0": {"ln1": {}, "ln2": {},
                           "mixer": {k: v.numpy() for k, v in
                                     tree["layers"]["b0"]["mixer"].items()},
                           "ffn": {k: v.numpy() for k, v in
                                   tree["layers"]["b0"]["ffn"].items()}}}},
        tarch.model, device="cpu", split_layers=True)
    assert len(split["blocks"]) == tarch.model.n_layers
    assert torch.equal(split["blocks"][1]["mixer"]["wq"],
                       tparams["layers"]["b0"]["mixer"]["wq"][1])
    m = tarch.model
    assert tparams["emb"].shape == (512, m.d_model)
    assert tparams["layers"]["b0"]["ffn"]["wi_gate"].shape == \
        (m.n_layers, m.d_model, m.d_ff)


def test_init_params_layout_and_determinism():
    arch = tconfigs.get_smoke_config("olmo-1b")
    a = TM.init_params(arch.model, seed=3, device="cpu")
    b = TM.init_params(arch.model, seed=3, device="cpu")
    assert torch.equal(a["layers"]["b0"]["mixer"]["wo"],
                       b["layers"]["b0"]["mixer"]["wo"])
    jshapes = jax.eval_shape(
        lambda: JM.init_params(jax.random.PRNGKey(0),
                               jconfigs.get_smoke_config("olmo-1b").model))
    tshapes = jax.tree.map(lambda x: tuple(x.shape), a)
    assert tshapes == jax.tree.map(lambda x: tuple(x.shape), jshapes)


def test_outside_the_slice_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tconfigs.get_config("mamba2-780m")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tconfigs.get_config("olmo-1b-emu")
