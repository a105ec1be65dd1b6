"""The port's tensor-parallel GEMM and compressed reduction
(``repro_torch.parallel.shard_gemm`` / ``compress``) against the
reference's own parallel code.

The reference's results come from one subprocess with 8 host devices
(``_torch_mesh.reference_results``: ``sharded_matmul`` / ``sharded_dense``
column, row and batch outputs, the localized prepared rhs and its
refusals, ``gemm_partition``'s choices, ``compressed_psum`` under
``jax.vmap(axis_name=...)``). The port's come from gloo worlds of 2 and 4
CPU ranks (``_torch_mesh.run_world``). Tolerances: a column or batch
partition is bit for bit the reference's; a row partition at 2 ranks is
bit for bit the sum of the two pinned-beta partials computed on one rank
(and the reference's, whose sum of two is the same), at 4 ranks each
partial is bit for bit and the sum within 1e-6 of the output's largest
magnitude; ``compressed_psum`` is bit for bit, on every rank.
"""

import dataclasses

import numpy as np
import pytest
import torch

import _torch_mesh as TM
from repro_torch import api as tapi, configs as tconfigs
from repro_torch.core.precision import EmulationConfig
from repro_torch.kernels import dispatch, prepared
from repro_torch.launch.mesh import make_abstract_mesh
from repro_torch.parallel import compress, shard_gemm, sharding as shd


@pytest.fixture(scope="module")
def ref():
    return TM.reference_results()


@pytest.fixture(scope="module")
def world2():
    return TM.run_world(TM.shard_gemm_rank, 2, ((1, 2), (2, 1)))


@pytest.fixture(scope="module")
def world4():
    return TM.run_world(TM.shard_gemm_rank, 4, ((1, 4), (2, 2)))


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def _cases(world_meshes):
    for name, _, _, _, _, _, meshes in TM.CASES:
        for shape in meshes:
            if shape in world_meshes:
                yield name, shape


@pytest.mark.parametrize("world", [2, 4])
def test_column_and_batch_partitions_are_the_reference_bit_for_bit(
        ref, world2, world4, world):
    ranks = world2 if world == 2 else world4
    meshes = ((1, 2), (2, 1)) if world == 2 else ((1, 4), (2, 2))
    seen = 0
    for name, shape in _cases(meshes):
        if "row" in name:
            continue
        key = f"{name}@{shape[0]}x{shape[1]}"
        for out in ranks:
            np.testing.assert_array_equal(_bits(out[key]), _bits(ref[key]),
                                          err_msg=key)
        seen += 1
    assert seen
    # The result does not depend on the mesh: the 8-rank mesh too.
    np.testing.assert_array_equal(_bits(world4[0]["mm_f32@1x4"]),
                                  _bits(ref["mm_f32@2x4"]))


def test_row_partition_at_two_ranks_sums_the_pinned_partials(ref, world2):
    name, k = "mm_row", 64
    a, b = TM.operands(name, (8,), k, 31, "float32")
    cfg = shard_gemm._pin_row_cfg(tapi.precision("ozaki1-p4"), k)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    parts = [dispatch.emulated_matmul(at[:, i * 32:(i + 1) * 32],
                                      bt[i * 32:(i + 1) * 32], cfg=cfg)
             for i in range(2)]
    for rank, out in enumerate(world2):
        np.testing.assert_array_equal(_bits(out["partial_mm_row@1x2"]),
                                      _bits(parts[rank]))
        np.testing.assert_array_equal(_bits(out["mm_row@1x2"]),
                                      _bits(parts[0] + parts[1]))
        np.testing.assert_array_equal(_bits(out["mm_row@1x2"]),
                                      _bits(ref["mm_row@1x2"]))
    # The dense form (a 3-D lhs) likewise.
    np.testing.assert_array_equal(_bits(world2[0]["dense_row@1x2"]),
                                  _bits(ref["dense_row@1x2"]))


def test_row_partition_at_four_ranks(ref, world4):
    a, b = TM.operands("mm_row", (8,), 64, 31, "float32")
    cfg = shard_gemm._pin_row_cfg(tapi.precision("ozaki1-p4"), 64)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    parts = [dispatch.emulated_matmul(at[:, i * 16:(i + 1) * 16],
                                      bt[i * 16:(i + 1) * 16], cfg=cfg)
             for i in range(4)]
    total = sum(p.double() for p in parts).numpy()
    for rank, out in enumerate(world4):
        np.testing.assert_array_equal(_bits(out["partial_mm_row@1x4"]),
                                      _bits(parts[rank]))
        got = out["mm_row@1x4"]
        np.testing.assert_array_equal(_bits(got), _bits(world4[0][
            "mm_row@1x4"]))                     # the same bits everywhere
        scale = np.abs(total).max()
        assert np.abs(got - total).max() <= 1e-6 * scale
        for key in ("mm_row@1x4", "mm_row@2x4"):
            assert np.abs(got - ref[key]).max() <= 1e-6 * scale


def test_localized_prepared_rhs_and_refusals(ref, world2, world4):
    for out, key in ((world2[1], "1x2"), (world4[3], "2x2")):
        np.testing.assert_array_equal(_bits(out["prep@" + key]),
                                      _bits(ref["prep@" + key]))
    assert bool(ref["refused_n_indivisible"])
    assert bool(ref["refused_mesh_mismatch"])
    for out in world4:      # 30 columns: not whole 128-column blocks
        assert out["n_indivisible@1x4"] and out["n_indivisible@2x2"]
    for out in world2 + world4:
        assert all(v for k, v in out.items() if k.startswith("mesh_mismatch"))


def test_compressed_psum_is_the_reference_bit_for_bit(ref, world2, world4):
    for n, ranks in ((2, world2), (4, world4)):
        for out in ranks:
            np.testing.assert_array_equal(_bits(out["psum"]),
                                          _bits(ref[f"psum{n}"][0]))
    # n = 8: the one-process integer sum of the residues (the plain
    # version), against the reference's 8-member vmap.
    x = torch.from_numpy(TM.psum_inputs(8))
    moduli = compress.default_moduli(6)
    scale = compress._scale(x.abs().max(), compress._budget(moduli, 8))
    res = [compress.residues_of(x[i], scale, moduli) for i in range(8)]
    sums = [sum(r[j] for r in res) for j in range(len(moduli))]
    got = compress.reconstruct(sums, scale, moduli).numpy()
    for member in ref["psum8"]:
        np.testing.assert_array_equal(_bits(got), _bits(member))


def test_compressed_scale_follows_xla_near_powers_of_two():
    """The scale's float32 log2 / exp2 are XLA's, not the exact ones: an
    amax just above a power of two, and integer exponents where XLA's
    exp2 is dozens of ulps from 2^n."""
    import jax.numpy as jnp
    amax = np.float32(2.0 ** -20) * np.float32(1 + 2 ** -23)
    for budget in (5, 20, 30):
        got = compress._scale(torch.tensor(amax), budget)
        want = jnp.exp2(budget - 1 - jnp.ceil(jnp.log2(jnp.float32(amax))))
        assert _bits(got) == _bits(want), budget


def test_gather_routes_agree(world2, world4):
    assert all(out["gather_equal"] for out in world2 + world4)


def test_gemm_partition_matches_reference(ref):
    for lead, k, n in TM.PARTITIONS:
        for shape in TM.MESHES:
            part = shard_gemm.gemm_partition(
                lead, k, n, make_abstract_mesh(shape, ("data", "model")))
            got = ("none" if part is None else
                   f"{part.kind}|{part.batch_axes}|{part.model_axis}")
            assert got == str(ref[f"part_{lead}_{k}_{n}@{shape[0]}x"
                                  f"{shape[1]}"]), (lead, k, n, shape)


class _Rank:
    """A live-looking mesh of one model axis, seen from rank ``idx``."""

    def __init__(self, tp, idx):
        self.shape = {"data": 1, "model": tp}
        self.idx = idx

    def get_group(self, name):
        raise AssertionError("no collective expected")

    def get_local_rank(self, name):
        return self.idx if name == "model" else 0


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("scheme", ["ozaki1-p4", "ozaki2-m6"])
def test_localize_prepared_slices_each_layout(backend, scheme):
    """A rank's localized prepared rhs (the 'planes' layout of the cuda
    backend, built here on CPU tensors; 'interleaved' / 'stacked' of the
    torch backend) is the prepared rhs of its columns, and consuming it
    gives its columns of the product, bit for bit."""
    rng = np.random.default_rng(3)
    b = torch.from_numpy(rng.standard_normal((48, 256)).astype(np.float32))
    a = torch.from_numpy(rng.standard_normal((5, 48)).astype(np.float32))
    cfg = dataclasses.replace(tapi.precision(scheme), backend=backend)
    whole = prepared.prepare_rhs(b, cfg)
    for idx in range(2):
        local = shard_gemm._localize_prepared(whole, _Rank(2, idx))
        own = prepared.prepare_rhs(b[:, idx * 128:(idx + 1) * 128], cfg)
        assert local.n == 128 and local.twin is None
        for field in local.TENSORS:
            assert torch.equal(getattr(local, field), getattr(own, field))
        if backend == "torch":        # the cuda layout runs on the card
            got = prepared.matmul_prepared(a, local)
            assert torch.equal(got, prepared.matmul_prepared(a, whole)[
                :, idx * 128:(idx + 1) * 128])


def test_tile_layout_and_dispatch_mesh_helpers():
    mesh = make_abstract_mesh((2, 4), ("data", "model"))
    assert shd.tile_kind(64, 32, mesh) == "column"
    assert shd.tile_kind(64, 30, mesh) == "row"
    assert shd.tile_kind(62, 32, mesh) is None
    assert dispatch._mesh_devices(mesh) == 8
    assert dispatch._mesh_shape_tuple(mesh) == (("data", 2), ("model", 4))
    assert not dispatch._shardable_mesh(mesh)
    params = {"layers": {"b0": {"mixer": {
        "wq": torch.empty(3, 64, 32, device="meta"),
        "wo": torch.empty(3, 64, 30, device="meta")}}},
        "ln": torch.empty(64, device="meta")}
    specs = shd.tile_pspecs(params, mesh)
    assert tuple(specs["layers"]["b0"]["mixer"]["wq"]) == (None, None,
                                                           "model")
    assert tuple(specs["layers"]["b0"]["mixer"]["wo"]) == (None, "model",
                                                           None)
    tiles = shd.shard_tree(params, specs, mesh)
    assert tiles["layers"]["b0"]["mixer"]["wq"].shape == (3, 64, 8)
    assert tiles["layers"]["b0"]["mixer"]["wo"].shape == (3, 16, 30)
    assert tiles["ln"].shape == (64,)
    # A device-free mesh of several devices clamps emulated sites to the
    # reference expansion, as the reference's resolve_policy does.
    from repro_torch.models.common import GemmPolicy
    pol = dispatch.resolve_policy(GemmPolicy(
        default=tapi.precision("ozaki1-p4")), mesh)
    assert pol.default.impl == "xla" and pol.mesh is None
    one = make_abstract_mesh((1, 1), ("data", "model"))
    base = GemmPolicy(default=EmulationConfig(scheme="ozaki1", p=4))
    assert dispatch.resolve_policy(base, one) == base


@pytest.mark.parametrize("arch_id", tconfigs.ARCH_IDS)
def test_rank_params_are_the_tiles_of_the_whole_draw(arch_id):
    """``init_rank_params`` draws a rank's tiles alone, one 2-D matrix at
    a time; they are the tiles of ``init_params``'s whole tree
    (``sharding.tile_params``) bit for bit, on every rank of 2 and 4."""
    from repro_torch.models import model as TMod
    from repro_torch.utils.tree import tree_flatten
    mcfg = tconfigs.get_smoke_config(arch_id).model
    whole = TMod.init_params(mcfg, 5, "cpu")
    for tp in (2, 4):
        for idx in range(tp):
            want = tree_flatten(shd.tile_params(whole, _Rank(tp, idx)))
            got = tree_flatten(TMod.init_rank_params(mcfg, 5, "cpu",
                                                     _Rank(tp, idx)))
            assert set(got) == set(want)
            for k, v in want.items():
                assert torch.equal(got[k], v), (tp, idx, k)
