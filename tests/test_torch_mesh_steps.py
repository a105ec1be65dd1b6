"""The port's meshes through the engines, the step factories and the CLIs
(``launch.mesh``, ``launch.steps``, ``serving``, ``launch.train`` /
``launch.serve``, ``checkpoint``), in gloo worlds of 2 CPU ranks.

* Tensor parallel, mesh (1, 2): olmo-1b's smoke serve through the
  continuous and the lockstep engine, and granite-3-8b's under
  ``ozaki1-p4+cached`` (each rank's head tile prepared where it lives),
  give the one-rank tokens exactly; three train steps give the one-rank
  first loss exactly (the forward's column products are bit for bit),
  the others within 1e-6, and parameter changes within 1e-2 of each
  leaf's largest change (the input gradients are sums over the ranks).
* Data parallel, mesh (2, 1): each rank's steps on its own half of the
  batch, averaged, against the reference's unsharded steps on the whole
  batch (built without a mesh, R1; ``native``, jitted): losses within
  1e-5 relative, parameter changes within 1e-2 of each leaf's largest
  change. The warmup's first learning rate is 0, so three steps move the
  parameters twice, by about 1e-5; the changes agree to about 3e-3 of
  that (one float32 step of the parameters).
* A guard on mesh (1, 2) with a fault injected into rank 1's tiles
  only: the ranks agree on every verdict, so a tripped tile escalates on
  both ranks and the engine replays the step on both (the one-rank
  tokens); a strict serve fails the same requests on both; strict
  Trainer steps retry on both and end where clean ones do.
* The CLIs: ``launch.train --model-parallel 2`` and ``--model-parallel
  1`` on two ranks, a checkpoint of mesh (2, 1) restored onto (1, 2)
  (``restore(shardings=)``: each rank's tiles of the saved state), and
  ``launch.serve`` on ``make_host_mesh()``, the data-parallel (2, 1),
  giving the one-rank CLI's tokens.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_mesh as TM
from _torch_util import one_torch_thread  # noqa: F401
from repro import configs as jconfigs
from repro.launch import steps as JS
from repro.models import model as JM
from repro.models.common import GemmPolicy as JPolicy
from repro.optim import optimizers as jopt
from repro_torch import configs as tconfigs
from repro_torch.configs.base import ShapeSpec
from repro_torch.data import make_batch_iterator
from repro_torch.launch import serve as serve_cli


@pytest.fixture(scope="module")
def tp_world():
    return TM.run_world(TM.mesh_serve_train_rank, 2)


@pytest.fixture(scope="module")
def jparams():
    arch = jconfigs.get_smoke_config("olmo-1b")
    return jax.tree.map(np.asarray,
                        JM.init_params(jax.random.PRNGKey(3), arch.model))


@pytest.fixture(scope="module")
def cli_world(tmp_path_factory, jparams):
    return TM.run_world(TM.mesh_cli_rank, 2,
                        str(tmp_path_factory.mktemp("mesh")), jparams)


@pytest.fixture(scope="module")
def guard_world(tmp_path_factory):
    return TM.run_world(TM.mesh_guard_rank, 2,
                        str(tmp_path_factory.mktemp("guard")))


@pytest.mark.parametrize("case,arch_id,spec,lockstep", [
    ("olmo", "olmo-1b", "ozaki1-p4", False),
    ("olmo_lockstep", "olmo-1b", "ozaki1-p4", True),
    ("granite_cached", "granite-3-8b", "ozaki1-p4+cached", False)])
def test_tensor_parallel_serve_gives_one_rank_tokens(
        tp_world, one_torch_thread, case, arch_id, spec, lockstep):
    want, prepared = TM.serve_tokens(arch_id, spec, None, lockstep)
    for out in tp_world:
        got, got_prepared = out[case]
        assert got == want and got_prepared == prepared
    assert prepared == (case == "granite_cached")


def test_tensor_parallel_train_steps(tp_world, one_torch_thread):
    from repro_torch.launch import steps as S
    from repro_torch.utils.tree import tree_flatten
    losses, params = TM.train_losses(None)
    start = {k: v.float().numpy() for k, v in tree_flatten(S.init_state(
        tconfigs.get_smoke_config("olmo-1b"), 0, "cpu")["params"]).items()}
    for out in tp_world:
        got_losses, got = out["train"]
        assert got_losses[0] == losses[0]
        np.testing.assert_allclose(got_losses, losses, rtol=1e-6)
        assert set(got) == set(params)
        gaps = TM.update_gap(got, params, start)
        assert max(gaps.values()) < 1e-2, gaps
    # Both ranks hold the same whole state.
    for k, v in tp_world[0]["train"][1].items():
        np.testing.assert_array_equal(v, tp_world[1]["train"][1][k])


def test_data_parallel_step_matches_reference_unsharded(cli_world, jparams):
    jarch = jconfigs.get_smoke_config("olmo-1b")
    tarch = tconfigs.get_smoke_config("olmo-1b")
    shape = ShapeSpec(*TM.TRAIN_SHAPE)
    halves = [make_batch_iterator(tarch, shape, 0, r, 2) for r in range(2)]
    loss_fn = JS.make_loss_fn(jarch, JPolicy(default=None))
    vg = jax.jit(jax.value_and_grad(loss_fn))
    p = jax.tree.map(jnp.asarray, jparams)
    opt = jopt.adamw_init(p)
    losses = []
    for _ in range(TM.TRAIN_STEPS):
        parts = [next(it)[1] for it in halves]
        batch = {k: jnp.asarray(np.concatenate([b[k] for b in parts]))
                 for k in parts[0]}
        loss, g = vg(p, batch)
        g, _ = jopt.clip_by_global_norm(g, 1.0)
        lr = jopt.warmup_cosine(opt["step"], jarch.train.learning_rate)
        p, opt = jopt.adamw_update(g, opt, p, lr)
        losses.append(float(loss))
    def flat(tree):
        return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                         for k in kp): np.asarray(v)
                for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    for out in cli_world:
        got_losses, got = out["dp"]
        np.testing.assert_allclose(got_losses, losses, rtol=1e-5)
        gaps = TM.update_gap(got, flat(p), flat(jparams))
        assert set(gaps) == set(got) and max(gaps.values()) < 1e-2, gaps


def test_train_cli_model_parallel_and_elastic_restore(cli_world):
    for out in cli_world:
        assert len(out["train_mp2"]) == 2 and len(out["train_dp2"]) == 2
        assert all(np.isfinite(out["train_mp2"] + out["train_dp2"]))
        # The (2, 1) checkpoint, restored onto (1, 2): each rank's tiles.
        assert out["restored_equal"]
    smoke = tconfigs.get_smoke_config("olmo-1b").model
    width = smoke.n_heads * smoke.resolved_head_dim
    assert cli_world[0]["restored_tiled"][-1] == width // 2
    # Both ranks of the tensor-parallel run saw the same losses.
    assert cli_world[0]["train_mp2"] == cli_world[1]["train_mp2"]


def test_serve_cli_on_the_host_mesh_gives_one_rank_tokens(cli_world,
                                                          one_torch_thread):
    want = serve_cli.main(["--arch", "olmo-1b", "--smoke", "--requests",
                           "2", "--prompt-len", "6", "--gen", "3",
                           "--gemm", "ozaki1-p4", "--device", "cpu"])
    for out in cli_world:
        assert out["serve"] == want


def test_guard_on_a_mesh_agrees_when_one_rank_tile_trips(guard_world,
                                                          one_torch_thread):
    r0, r1 = guard_world
    # '+guard': rank 1's one faulted weight stack trips its tile; both
    # ranks count the trip, escalate, recover and replay the step, which
    # gives the one-rank serve's tokens.
    want = TM.guarded_serve("ozaki1-p4+guard", None)
    assert want[3]["trips"] == 0
    for out in guard_world:
        toks, status, trips, counts = out["ozaki1-p4+guard"]
        assert (toks, status) == (want[0], want[1])
        # The replay runs clean: no request is charged the trip.
        assert counts["trips"] >= 1 and counts["recoveries"] >= 1
        assert trips == want[2]
    assert r0["ozaki1-p4+guard"] == r1["ozaki1-p4+guard"]
    # '+guard:strict' with every stack of rank 1 faulted: both ranks raise
    # at the same call and fail the same requests.
    strict = r0["ozaki1-p4+guard:strict"]
    assert strict == r1["ozaki1-p4+guard:strict"]
    assert "failed" in strict[1]
    # Strict Trainer steps: rank 1's first ladder runs out, both ranks
    # retry the step together and end with the clean run's state.
    for out in guard_world:
        clean_loss, clean_retries, clean_params = out["train_clean"]
        loss, retries, params = out["train_fault"]
        assert clean_retries == [0, 0] and retries == [1, 0]
        assert loss == clean_loss
        for k, v in clean_params.items():
            np.testing.assert_array_equal(params[k], v, err_msg=k)
    assert r0["train_fault"][0] == r1["train_fault"][0]
