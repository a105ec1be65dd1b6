"""Helpers of the port's multi-rank tests (tests/test_torch_shard_gemm.py,
tests/test_torch_mesh_steps.py).

* :func:`run_world` runs ``fn(rank, world, *args)`` in ``world`` spawned
  processes joined into a gloo process group on CPU tensors, and returns
  each rank's (picklable) result.
* :func:`reference_results` runs the reference's parallel code once in a
  subprocess with 8 host devices (``XLA_FLAGS`` must be set before jax
  starts) and loads what it saved. Its mesh is built as
  ``jax.sharding.Mesh`` directly, never through ``jax.make_mesh`` (R1).
* :data:`CASES` are the products both sides compute, their operands
  drawn from numpy seeds.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import traceback
import zlib

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (name, spec, lead shape, K, N, dtype, meshes): sharded_matmul on a
# 2-D lhs, sharded_dense on a 3-D one. N = 31 splits no model axis (a row
# partition), N = 32 every one (column); a model axis of 1 leaves the rows
# to the data axes (batch). The reference's sharded_dense traces its
# custom VJP (about 10 s a mesh here), so it runs on one mesh a case.
MESHES = ((1, 2), (2, 1), (1, 4), (2, 2), (2, 4))
CASES = (
    ("mm_f32", "ozaki1-p4", (8,), 64, 32, "float32",
     ((2, 1), (1, 4), (2, 2), (2, 4))),
    ("mm_row", "ozaki1-p4", (8,), 64, 31, "float32",
     ((1, 2), (1, 4), (2, 4))),
    ("mm_bf16", "ozaki1-p4", (8,), 64, 32, "bfloat16", ((1, 4),)),
    ("mm_s2", "ozaki2-m6", (8,), 64, 32, "float32", ((1, 4),)),
    ("dense_col", "ozaki1-p4", (2, 4), 64, 32, "float32", ((2, 2),)),
    ("dense_row", "ozaki1-p4", (2, 4), 64, 31, "float32", ((1, 2),)),
)
PARTITIONS = ((8, 64, 32), (8, 64, 31), (3, 64, 32), (3, 63, 31),
              (8, 63, 30))
PSUM_N = (2, 4, 8)


def operands(name: str, lead, k: int, n: int, dtype: str):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    a = ((rng.random(tuple(lead) + (k,)) - 0.5)
         * np.exp(2.0 * rng.standard_normal(tuple(lead) + (k,))))
    b = ((rng.random((k, n)) - 0.5) * np.exp(2.0 * rng.standard_normal((k, n))))
    return a.astype(np.float32), b.astype(np.float32)


def psum_inputs(n: int) -> np.ndarray:
    rng = np.random.default_rng(100 + n)
    x = rng.standard_normal((n, 37)) * 2.0 ** rng.integers(-12, 12)
    return x.astype(np.float32)


# ---------------------------------------------------------------------------
# The reference, in a subprocess of 8 host devices.
# ---------------------------------------------------------------------------

def _reference_main(out_path: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from repro import api
    from repro.kernels import prepared
    from repro.parallel import compress, shard_gemm

    def mesh_of(shape):
        n = shape[0] * shape[1]
        return Mesh(np.array(jax.devices()[:n]).reshape(shape),
                    ("data", "model"))

    out = {}
    for name, spec, lead, k, n, dtype, meshes in CASES:
        a, b = operands(name, lead, k, n, dtype)
        cfg = api.precision(spec)
        a_j = jnp.asarray(a).astype(dtype)
        b_j = jnp.asarray(b).astype(dtype)
        for shape in meshes:
            mesh = mesh_of(shape)
            if len(lead) == 1:
                got = shard_gemm.sharded_matmul(a_j, b_j, cfg, mesh)
            else:
                got = shard_gemm.sharded_dense(a_j, b_j, cfg, mesh)
            key = f"{name}@{shape[0]}x{shape[1]}"
            if got is not None:
                out[key] = np.asarray(got.astype(jnp.float32))
    # A bare prepared rhs, localized column-parallel, and its refusals.
    a, b = operands("prep", (2, 4), 64, 256, "float32")
    cfg = api.precision("ozaki1-p4")
    prep = prepared.prepare_rhs(jnp.asarray(b), cfg)
    for shape in ((1, 2), (2, 2)):
        got = shard_gemm.sharded_dense(jnp.asarray(a), prep, cfg,
                                       mesh_of(shape))
        out[f"prep@{shape[0]}x{shape[1]}"] = np.asarray(got)
    _, b30 = operands("prep30", (2, 4), 64, 30, "float32")
    refused = shard_gemm.sharded_dense(
        jnp.asarray(a), prepared.prepare_rhs(jnp.asarray(b30), cfg), cfg,
        mesh_of((1, 4)))
    out["refused_n_indivisible"] = np.asarray(refused is None)
    pinned = prepared.prepare_rhs(jnp.asarray(b), cfg, mesh=mesh_of((1, 4)))
    refused = shard_gemm.sharded_dense(jnp.asarray(a), pinned, cfg,
                                       mesh_of((1, 2)))
    out["refused_mesh_mismatch"] = np.asarray(refused is None)
    for lead, k, n in PARTITIONS:
        for shape in MESHES:
            part = shard_gemm.gemm_partition(lead, k, n, mesh_of(shape))
            out[f"part_{lead}_{k}_{n}@{shape[0]}x{shape[1]}"] = np.asarray(
                "none" if part is None else
                f"{part.kind}|{part.batch_axes}|{part.model_axis}")
    for n in PSUM_N:
        x = jnp.asarray(psum_inputs(n))
        out[f"psum{n}"] = np.asarray(jax.jit(jax.vmap(
            lambda v: compress.compressed_psum(v, "d", n),
            axis_name="d"))(x))
    np.savez(out_path, **out)


def reference_results() -> dict:
    """The reference's results of every case (one subprocess)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ref.npz")
        env = dict(os.environ, XLA_FLAGS=(
            "--xla_force_host_platform_device_count=8"),
            JAX_PLATFORMS="cpu",
            PYTHONPATH=os.path.join(ROOT, "src") + os.pathsep
            + os.path.join(ROOT, "tests"))
        code = ("import _torch_mesh, sys; "
                "_torch_mesh._reference_main(sys.argv[1])")
        proc = subprocess.run([sys.executable, "-c", code, path], cwd=ROOT,
                              env=env, capture_output=True, text=True,
                              timeout=600)
        assert proc.returncode == 0, proc.stderr[-4000:]
        with np.load(path, allow_pickle=True) as data:
            return {k: data[k] for k in data.files}


# ---------------------------------------------------------------------------
# gloo worlds of CPU ranks.
# ---------------------------------------------------------------------------

def _entry(rank, world, store_path, queue, fn, args):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", store=dist.FileStore(store_path,
                                                             world),
                                rank=rank, world_size=world)
        result = fn(rank, world, *args)
        queue.put((rank, "ok", result))
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        queue.put((rank, "error", traceback.format_exc()))
        raise


def run_world(fn, world: int, *args, timeout: float = 300.0) -> list:
    """[fn(rank, world, *args) for each rank], each in its own spawned
    process of one gloo group; a world that has not answered in
    ``timeout`` seconds (ranks that wait on each other) fails."""
    import multiprocessing as mp
    import queue as queue_mod
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_entry,
                             args=(r, world, store, queue, fn, args))
                 for r in range(world)]
        for p in procs:
            p.start()
        results = {}
        for _ in range(world):
            try:
                rank, status, value = queue.get(timeout=timeout)
            except queue_mod.Empty:
                status, value = "hung", f"no answer in {timeout} s"
                rank = sorted(set(range(world)) - set(results))
            if status != "ok":
                for p in procs:
                    p.kill()
                raise AssertionError(f"rank {rank} failed:\n{value}")
            results[rank] = value
        for p in procs:
            p.join(timeout)
            assert p.exitcode == 0, f"a rank exited with {p.exitcode}"
    return [results[r] for r in range(world)]


# ---------------------------------------------------------------------------
# Rank programs (module-level, so that a spawned rank can import them).
# ---------------------------------------------------------------------------

def shard_gemm_rank(rank, world, meshes):
    """Every case of :data:`CASES` on each of ``meshes`` (live, over this
    world), the row partials, the localized prepared rhs and its
    refusals, compressed_psum over the world, and the two gather routes
    against each other."""
    import torch
    from repro_torch import api
    from repro_torch.kernels import dispatch, prepared
    from repro_torch.launch.mesh import axis_index, make_live_mesh
    from repro_torch.parallel import comm, compress, shard_gemm
    live = {shape: make_live_mesh(shape, ("data", "model"))
            for shape in meshes}
    out = {}
    for name, spec, lead, k, n, dtype, _ in CASES:
        a, b = operands(name, lead, k, n, dtype)
        at = torch.from_numpy(a).to(getattr(torch, dtype))
        bt = torch.from_numpy(b).to(getattr(torch, dtype))
        cfg = api.precision(spec)
        for shape, mesh in live.items():
            key = f"{name}@{shape[0]}x{shape[1]}"
            fn = (shard_gemm.sharded_matmul if len(lead) == 1
                  else shard_gemm.sharded_dense)
            got = fn(at, bt, cfg, mesh)
            out[key] = None if got is None else got.float().numpy()
            if name == "mm_row" and shape[1] > 1:
                step = k // shape[1]
                idx = axis_index(mesh, "model")
                pinned = shard_gemm._pin_row_cfg(cfg, k)
                out["partial_" + key] = dispatch.emulated_matmul(
                    at[:, idx * step:(idx + 1) * step],
                    bt[idx * step:(idx + 1) * step], cfg=pinned).numpy()
    a, b = operands("prep", (2, 4), 64, 256, "float32")
    cfg = api.precision("ozaki1-p4")
    prep = prepared.prepare_rhs(torch.from_numpy(b), cfg)
    _, b30 = operands("prep30", (2, 4), 64, 30, "float32")
    for shape, mesh in live.items():
        key = f"{shape[0]}x{shape[1]}"
        got = shard_gemm.sharded_dense(torch.from_numpy(a), prep, cfg, mesh)
        out["prep@" + key] = None if got is None else got.numpy()
        prep30 = prepared.prepare_rhs(torch.from_numpy(b30), cfg)
        out["n_indivisible@" + key] = shard_gemm.sharded_dense(
            torch.from_numpy(a), prep30, cfg, mesh) is None
        other = next(m for s, m in live.items() if s != shape)
        pinned = prepared.prepare_rhs(torch.from_numpy(b), cfg, mesh=other)
        out["mesh_mismatch@" + key] = shard_gemm.sharded_dense(
            torch.from_numpy(a), pinned, cfg, mesh) is None
    flat = live[(1, world)]
    x = torch.from_numpy(psum_inputs(world)[rank])
    out["psum"] = compress.compressed_psum(x, (flat, "model"), world).numpy()
    t = torch.randn(3, 5, generator=torch.Generator().manual_seed(rank))
    t[0, 0] = -0.0
    gathered = comm.gather_raw(t, 1, flat, "model")
    route = comm.byte_route
    comm.byte_route = lambda *_: True          # the gloo-on-CUDA route
    try:
        by_bytes = comm.gather_raw(t, 1, flat, "model")
    finally:
        comm.byte_route = route
    out["gather_equal"] = bool(np.array_equal(
        gathered.numpy().view(np.int32), by_bytes.numpy().view(np.int32)))
    return out


SERVE_ARGS = dict(max_seq=16, max_lanes=2, chunk=4)


def serve_trace(vocab: int, n: int = 3):
    from repro_torch.serving import Request
    rng = np.random.default_rng(5)
    return [Request(prompt=rng.integers(0, vocab, 6).tolist(),
                    max_new_tokens=4) for _ in range(n)]


def serve_tokens(arch_id: str, spec: str, mesh, lockstep: bool = False):
    """A smoke serve's tokens on ``mesh`` (None: one rank)."""
    from repro_torch import api, configs
    from repro_torch.models.common import GemmPolicy
    from repro_torch.serving import ContinuousEngine, LockstepEngine
    arch = configs.get_smoke_config(arch_id)
    policy = GemmPolicy(default=api.precision(spec))
    if lockstep:
        eng = LockstepEngine(arch, mesh, 16, policy, device="cpu")
        prompts = np.random.default_rng(6).integers(
            0, arch.model.vocab, (2, 6)).astype(np.int32)
        return eng.generate(prompts, 4).tolist(), eng.prepared
    eng = ContinuousEngine(arch, mesh, policy=policy, device="cpu",
                           **SERVE_ARGS)
    trace = serve_trace(arch.model.vocab)
    res = eng.run(trace)
    return [res[r.rid].tokens for r in trace], eng.prepared


TRAIN_SHAPE = ("smoke", 16, 4, "train")
# Three steps: the warmup's learning rate is 0 at the first, so the last
# loss is taken after a nonzero update and the parameters moved twice.
TRAIN_STEPS = 3


def update_gap(got: dict, want: dict, start: dict) -> dict:
    """{leaf: the largest difference of two runs' parameter changes from
    ``start``, over the largest change of ``want``'s}: a relative error
    of the update itself, which a tolerance on the parameters (about 1,
    moved by about the learning rate) cannot see."""
    out = {}
    for k, w in want.items():
        d_want = w.astype(np.float64) - start[k]
        d_got = got[k].astype(np.float64) - start[k]
        out[k] = float(np.abs(d_got - d_want).max() / np.abs(d_want).max())
    return out


def train_losses(mesh, steps: int = TRAIN_STEPS, spec: str = "ozaki1-p4",
                 params=None, host=(0, 1)):
    """(losses, the whole params after ``steps`` train steps) of olmo-1b's
    smoke config on ``mesh`` (None: one rank), as numpy."""
    from repro_torch import api, configs
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import make_batch_iterator
    from repro_torch.launch import steps as S
    from repro_torch.models.common import GemmPolicy
    from repro_torch.optim import make_optimizer
    from repro_torch.parallel import sharding as shd
    from repro_torch.utils.tree import tree_flatten
    arch = configs.get_smoke_config("olmo-1b")
    shape = ShapeSpec(*TRAIN_SHAPE)
    step = S.make_train_step(arch, mesh, shape,
                             GemmPolicy(default=api.precision(spec)))
    tiled = mesh is not None and dict(zip(mesh.mesh_dim_names,
                                          mesh.shape))["model"] > 1
    if params is None:
        state = S.init_state(arch, 0, "cpu", mesh)
    else:
        p = shd.tile_params(params, mesh) if tiled else params
        state = {"params": p,
                 "opt": make_optimizer(arch.train.optimizer)[0](p)}
    it = make_batch_iterator(arch, shape, 0, *host)
    losses = []
    for _ in range(steps):
        state, metrics = step(state, next(it)[1])
        losses.append(float(metrics["loss"]))
    whole = state["params"]
    if tiled:
        whole = shd.unshard_tree(
            whole, S.tile_state_specs(arch, mesh)["params"], mesh)
    return losses, {k: v.float().numpy()
                    for k, v in tree_flatten(whole).items()}


def mesh_serve_train_rank(rank, world):
    """Tensor parallel over 2 ranks, mesh (1, 2): the engines' tokens and
    two train steps."""
    from repro_torch.launch.mesh import make_live_mesh
    mesh = make_live_mesh((1, 2), ("data", "model"))
    return {"olmo": serve_tokens("olmo-1b", "ozaki1-p4", mesh),
            "olmo_lockstep": serve_tokens("olmo-1b", "ozaki1-p4", mesh,
                                          lockstep=True),
            "granite_cached": serve_tokens("granite-3-8b",
                                           "ozaki1-p4+cached", mesh),
            "train": train_losses(mesh)}


def mesh_cli_rank(rank, world, tmp, params):
    """The CLIs over 2 ranks, a data-parallel step from ``params`` (whole,
    numpy), and a checkpoint of mesh (2, 1) restored onto (1, 2)."""
    import os
    import torch
    from repro_torch import configs, convert
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch import serve, steps as S, train
    from repro_torch.launch.mesh import make_live_mesh
    from repro_torch.parallel import sharding as shd
    from repro_torch.utils.tree import tree_flatten
    out = {}
    dp = make_live_mesh((2, 1), ("data", "model"))
    arch = configs.get_smoke_config("olmo-1b")
    tparams = convert.params_from_jax(params, arch.model, device="cpu")
    out["dp"] = train_losses(dp, spec="native", params=tparams,
                             host=(rank, 2))
    common = ["--arch", "olmo-1b", "--smoke", "--steps", "2", "--batch",
              "2", "--seq", "16", "--gemm", "ozaki1-p4", "--device", "cpu",
              "--ckpt-every", "1"]
    out["train_mp2"] = [m["loss"] for m in train.main(
        common + ["--model-parallel", "2", "--ckpt-dir",
                  os.path.join(tmp, "mp2")])]
    out["train_dp2"] = [m["loss"] for m in train.main(
        common + ["--ckpt-dir", os.path.join(tmp, "dp2")])]
    mgr = CheckpointManager(os.path.join(tmp, "dp2"))
    step = mgr.latest_step()
    whole = mgr.restore(step)
    tp = make_live_mesh((1, 2), ("data", "model"))
    moved = mgr.restore(step, shardings=S.named(S.tile_state_specs(arch, tp),
                                                tp))
    want = shd.tile_params(whole["params"], tp)
    out["restored_equal"] = all(
        torch.equal(v, tree_flatten(want)[k])
        for k, v in tree_flatten(moved["params"]).items())
    out["restored_tiled"] = tuple(
        moved["params"]["layers"]["b0"]["mixer"]["wq"].shape)
    out["serve"] = serve.main(["--arch", "olmo-1b", "--smoke", "--requests",
                               "2", "--prompt-len", "6", "--gen", "3",
                               "--gemm", "ozaki1-p4", "--device", "cpu"])
    return out


# A fault in one rank's tiles: the ranks must agree on every guard verdict.
GUARD_FAULT = dict(kind="bitflip_slice", bit=6, operand="b")


def _faulted(rank: int, count: int):
    """``guard.inject`` armed for ``count`` weight stacks on rank 1 only."""
    import contextlib
    from repro_torch import guard
    if rank != 1:
        return contextlib.nullcontext()
    return guard.inject(**GUARD_FAULT, count=count)


def guarded_serve(spec: str, mesh, rank: int = 0, count: int = 0):
    """olmo-1b's smoke serve under a guarded ``spec`` on ``mesh`` (None:
    one rank), with ``count`` faulted weight stacks on rank 1: (tokens,
    statuses, each request's guard trips, the engine's guard delta of its
    last step, the guard counters)."""
    from repro_torch import api, configs, guard
    from repro_torch.models.common import GemmPolicy
    from repro_torch.serving import ContinuousEngine
    arch = configs.get_smoke_config("olmo-1b")
    guard.stats_clear()
    eng = ContinuousEngine(arch, mesh, policy=GemmPolicy(
        default=api.precision(spec)), device="cpu", guard_backoff=0.0,
        **SERVE_ARGS)
    trace = serve_trace(arch.model.vocab)
    with _faulted(rank, count):
        res = eng.run(trace)
    st = guard.stats()
    return ([res[r.rid].tokens for r in trace],
            [res[r.rid].status for r in trace],
            [res[r.rid].guard_trips for r in trace],
            {f: getattr(st, f) for f in ("trips", "escalations",
                                          "recoveries", "native_fallbacks")})


def guarded_train(mesh, tmp: str, rank: int = 0, count: int = 0):
    """Two Trainer steps of olmo-1b's smoke config under
    ``ozaki1-p4+guard:strict`` on ``mesh``, with ``count`` faulted weight
    stacks on rank 1: (losses, retries, the whole params)."""
    from repro_torch import api, configs
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import make_batch_iterator
    from repro_torch.launch import steps as S
    from repro_torch.models.common import GemmPolicy
    from repro_torch.parallel import sharding as shd
    from repro_torch.runtime import Trainer
    from repro_torch.utils.tree import tree_flatten
    arch = configs.get_smoke_config("olmo-1b")
    shape = ShapeSpec(*TRAIN_SHAPE)
    step = S.make_train_step(arch, mesh, shape, GemmPolicy(
        default=api.precision("ozaki1-p4+guard:strict")))
    trainer = Trainer(
        step_fn=step, init_state_fn=lambda: S.init_state(arch, 0, "cpu",
                                                         mesh),
        batch_iterator=make_batch_iterator(arch, shape, 0),
        ckpt_dir=tmp, state_shardings=S.named(S.tile_state_specs(arch, mesh),
                                              mesh),
        device="cpu", ckpt_every=100, guard_backoff=0.0)
    try:
        with _faulted(rank, count):
            log = trainer.run(2)
    finally:
        trainer.close()
    whole = shd.unshard_tree(trainer.state["params"],
                             S.tile_state_specs(arch, mesh)["params"], mesh)
    return ([m["loss"] for m in log], [m["guard_retries"] for m in log],
            {k: v.float().numpy() for k, v in tree_flatten(whole).items()})


def mesh_guard_rank(rank, world, tmp):
    """Mesh (1, 2) under a guard, with faults in rank 1's tiles only: a
    serve whose one faulted stack trips and recovers, a strict serve whose
    every rung on rank 1 is faulted, and strict Trainer steps whose first
    ladder is exhausted on rank 1; each also without the fault."""
    import os
    from repro_torch.launch.mesh import make_live_mesh
    mesh = make_live_mesh((1, 2), ("data", "model"))
    out = {}
    for spec, count in (("ozaki1-p4+guard", 1),
                        ("ozaki1-p4+guard:strict", 10 ** 6)):
        out[spec] = guarded_serve(spec, mesh, rank, count)
    out["train_clean"] = guarded_train(mesh, os.path.join(tmp, "clean"))
    # Three stacks: the requested config's, the re-planned rung's and the
    # reference expansion's, so that rank 1's first ladder runs out.
    out["train_fault"] = guarded_train(mesh, os.path.join(tmp, "fault"),
                                       rank, 3)
    return out
