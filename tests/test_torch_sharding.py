"""The port's sharding rules, mesh helpers and dry run against the
reference's, on device-free meshes at full width.

For every registry id, the port's ``param_pspecs``, ``opt_pspecs``
(AdamW and Adafactor), ``grad_pspecs`` and ``cache_pspecs`` over
``launch.steps.abstract_params`` (meta tensors) equal the reference's
over its ``abstract_params`` (``jax.eval_shape``), leaf by leaf, on the
meshes (16, 16), (2, 16, 16), (2, 4) and (1, 8), with fsdp and zero2 on
and off and ``attn_sp`` where the arch asks for it; so do ``batch_specs``
and ``input_specs``. The dry run's ``params``, ``model_flops_global`` and
per-device argument bytes equal the reference's numbers, the bytes read
from the reference's specs through ``NamedSharding.shard_shape``.
"""

import math

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as JP

from repro import configs as jconfigs
from repro.launch import mesh as jmesh, steps as JS
from repro.optim import make_optimizer as j_make_optimizer
from repro.parallel import sharding as jshd
from repro.utils import roofline as jroof
from repro_torch import configs as tconfigs
from repro_torch.launch import dryrun, mesh as tmesh, steps as TS
from repro_torch.optim import make_optimizer as t_make_optimizer
from repro_torch.parallel import sharding as tshd

MESHES = (((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((2, 4), ("data", "model")),
          ((1, 8), ("data", "model")))

_ABSTRACT: dict = {}


def _abstract(arch_id):
    """(reference params, port params) of one id, built once."""
    if arch_id not in _ABSTRACT:
        _ABSTRACT[arch_id] = (
            JS.abstract_params(jconfigs.get_config(arch_id)),
            TS.abstract_params(tconfigs.get_config(arch_id)))
    return _ABSTRACT[arch_id]


def _ref_flat(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    out = {}
    for kp, leaf in flat:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in kp)
        out[key] = tuple(leaf) if isinstance(leaf, JP) else leaf
    return out


def _port_flat(tree):
    return {"/".join(path): tuple(leaf) if isinstance(
        leaf, tshd.PartitionSpec) else leaf
        for path, leaf in tshd._flatten_with_path(tree)}


def _same(port, ref, what):
    p, r = _port_flat(port), _ref_flat(ref)
    assert set(p) == set(r), (what, sorted(set(p) ^ set(r))[:6])
    bad = {k: (p[k], r[k]) for k in p if p[k] != r[k]}
    assert not bad, (what, list(bad.items())[:4])


@pytest.mark.parametrize("arch_id", jconfigs.ARCH_IDS)
def test_param_opt_grad_cache_specs_match_reference(arch_id):
    jarch, tarch = jconfigs.get_config(arch_id), tconfigs.get_config(arch_id)
    jparams, tparams = _abstract(arch_id)
    sps = (False, True) if tarch.model.attn_sharding == "sp" else (False,)
    jopts = {n: jax.eval_shape(j_make_optimizer(n)[0], jparams)
             for n in ("adamw", "adafactor")}
    topts = {n: t_make_optimizer(n)[0](tparams)
             for n in ("adamw", "adafactor")}
    jcache = JS.abstract_cache(jarch, 32, 64) if jarch.model.causal else None
    tcache = TS.abstract_cache(tarch, 32, 64) if tarch.model.causal else None
    for shape, axes in MESHES:
        jm = jmesh.make_abstract_mesh(shape, axes)
        tm = tmesh.make_abstract_mesh(shape, axes)
        for fsdp in (False, True):
            for sp in sps:
                what = (arch_id, shape, fsdp, sp)
                jp = jshd.param_pspecs(jparams, jm, fsdp=fsdp, attn_sp=sp)
                tp = tshd.param_pspecs(tparams, tm, fsdp=fsdp, attn_sp=sp)
                _same(tp, jp, what + ("params",))
                for zero2 in (False, True):
                    _same(tshd.grad_pspecs(tparams, tp, tm, zero2),
                          jshd.grad_pspecs(jparams, jp, jm, zero2),
                          what + ("grads", zero2))
                    for name in ("adamw", "adafactor"):
                        _same(tshd.opt_pspecs(topts[name], tp, tm, zero2),
                              jshd.opt_pspecs(jopts[name], jp, jm, zero2),
                              what + (name, zero2))
        if tcache is not None:
            _same(tshd.cache_pspecs(tcache, tm),
                  jshd.cache_pspecs(jcache, jm), (arch_id, shape, "cache"))


@pytest.mark.parametrize("arch_id", jconfigs.ARCH_IDS)
def test_batch_and_input_specs_match_reference(arch_id):
    jarch, tarch = jconfigs.get_config(arch_id), tconfigs.get_config(arch_id)
    for shape in tarch.shapes():
        jin, tin = jarch.input_specs(shape), tarch.input_specs(shape)
        assert set(jin) == set(tin)
        for k in jin:
            assert tuple(tin[k].shape) == tuple(jin[k].shape)
            assert tin[k].device.type == "meta"
            assert str(tin[k].dtype).split(".")[-1] == str(jin[k].dtype)
        for mshape, axes in MESHES:
            _same(TS.batch_specs(tarch, shape, tmesh.make_abstract_mesh(
                mshape, axes)), JS.batch_specs(
                jarch, shape, jmesh.make_abstract_mesh(mshape, axes)),
                (arch_id, shape.name, mshape))


def _ref_bytes(tree, specs, mesh):
    total = 0
    flat_t = _ref_flat(tree)
    for key, spec in _ref_flat(specs).items():
        leaf = flat_t[key]
        shard = NamedSharding(mesh, JP(*spec)).shard_shape(leaf.shape)
        total += math.prod(shard) * np.dtype(leaf.dtype).itemsize
    return total


@pytest.mark.parametrize("arch_id", ["olmo-1b", "deepseek-v3-671b"])
def test_dryrun_records_match_reference_numbers(arch_id):
    jarch = jconfigs.get_config(arch_id)
    jparams, _ = _abstract(arch_id)
    n_params = sum(math.prod(p.shape) for p in jax.tree.leaves(jparams))
    n_routed = jroof.routed_param_count(jparams)
    for shape in jarch.shapes():
        if shape.kind == "prefill":
            continue
        for multi in (False, True):
            rec = dryrun.run_cell(arch_id, shape, multi, "ozaki1-p4")
            jm = jmesh.make_abstract_mesh(
                (2, 16, 16) if multi else (16, 16),
                ("pod", "data", "model") if multi else ("data", "model"))
            assert rec["params"] == n_params
            assert rec["model_flops_global"] == jroof.model_flops(
                jarch, shape, n_params, n_routed)
            p_specs = jshd.param_pspecs(
                jparams, jm, fsdp=jarch.train.fsdp,
                attn_sp=jarch.model.attn_sharding == "sp")
            want = _ref_bytes(jparams, p_specs, jm)
            if shape.kind == "train":
                opt = JS.abstract_opt(jarch, jparams)
                want += _ref_bytes(opt, jshd.opt_pspecs(
                    opt, p_specs, jm, zero2=jarch.train.zero2), jm)
            else:
                cache = JS.abstract_cache(jarch, shape.global_batch,
                                          shape.seq_len)
                want += _ref_bytes(cache, jshd.cache_pspecs(cache, jm), jm)
            want += _ref_bytes(jarch.input_specs(shape),
                               JS.batch_specs(jarch, shape, jm), jm)
            assert rec["memory"]["argument_bytes"] == want, (shape.name,
                                                              multi)
            assert rec["compile_s"] is None and rec["hlo"] is None
            assert rec["roofline"]["bottleneck"] in ("compute", "memory",
                                                     "collective")


def test_partition_spec_and_placements():
    """The port's PartitionSpec normalises a one-name tuple as the
    reference's installed one does (R3), and maps to DTensor placements
    in mesh-dimension order."""
    from torch.distributed.tensor import Replicate, Shard
    for parts in ((("data",), None), (("pod", "data"), "model"), (), (None,)):
        assert tuple(tshd.PartitionSpec(*parts)) == tuple(JP(*parts))
    mesh = tmesh.make_abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    assert tshd.to_placements(tshd.P(("pod", "data"), None, "model"),
                              mesh) == (Shard(0), Shard(0), Shard(2))
    assert tshd.to_placements(tshd.P(None, "model"), mesh) == (
        Replicate(), Replicate(), Shard(1))


def test_host_and_production_meshes():
    """Without a process group the host mesh is the one-device (1, 1)
    mesh, which needs none; asking it for model parallelism is an error.
    The production meshes are the reference's geometries, device-free."""
    import torch.distributed as dist
    assert not dist.is_initialized()
    one = tmesh.make_host_mesh()
    assert one.shape == {"data": 1, "model": 1} and one.size == 1
    assert not tmesh.is_live(one)
    with pytest.raises(ValueError, match="ranks"):
        tmesh.make_host_mesh(2)
    assert tmesh.make_production_mesh().shape == {"data": 16, "model": 16}
    multi = tmesh.make_production_mesh(multi_pod=True)
    assert tuple(multi.axis_names) == ("pod", "data", "model")
    assert multi.size == 512
    assert tmesh.rank_device("cpu") == torch.device("cpu")
