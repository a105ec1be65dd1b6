"""The port's dispatcher and einsum front door against the reference
(repro_torch.kernels.dispatch / repro_torch.api vs repro.kernels.dispatch /
repro.api): 2-D and strided-batched emulated GEMMs and the two attention
contractions are bit-identical on float32 operands; backend resolution,
the block cache and the refusals outside the slice."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_util import bits, t
from conftest import conditioned
from repro import api as japi
from repro.kernels import dispatch as jdispatch
from repro_torch import api as tapi
from repro_torch.core.precision import EmulationConfig
from repro_torch.kernels import backends, dispatch
from repro_torch.models.common import GemmPolicy


@pytest.mark.parametrize("p", [3, 4, 6])
@pytest.mark.parametrize("mkn", [(16, 64, 32), (5, 70, 33)])
def test_emulated_matmul_bit_identical(p, mkn):
    m, k, n = mkn
    rng = np.random.default_rng(p)
    a, b = conditioned(rng, (m, k)), conditioned(rng, (k, n))
    spec = f"ozaki1-p{p}"
    ref = jdispatch.emulated_matmul(jnp.asarray(a), jnp.asarray(b),
                                    cfg=spec, backend="xla")
    out = dispatch.emulated_matmul(t(a), t(b), cfg=spec)
    np.testing.assert_array_equal(bits(out), bits(ref))


@pytest.mark.parametrize("p", [3, 4])
def test_emulated_matmul_batched_bit_identical(p):
    rng = np.random.default_rng(7)
    a, b = conditioned(rng, (2, 3, 9, 40)), conditioned(rng, (2, 3, 40, 11))
    spec = f"ozaki1-p{p}"
    ref = jdispatch.emulated_matmul_batched(jnp.asarray(a), jnp.asarray(b),
                                            cfg=spec, backend="xla")
    out = dispatch.emulated_matmul_batched(t(a), t(b), cfg=spec)
    assert out.shape == (2, 3, 9, 11)
    np.testing.assert_array_equal(bits(out), bits(ref))


@pytest.mark.parametrize("eq,shapes", [
    ("bqkgd,bjkd->bkgqj", ((2, 5, 3, 2, 16), (2, 24, 3, 16))),
    ("bkgqj,bjkd->bkgqd", ((2, 3, 2, 5, 24), (2, 24, 3, 16))),
    ("mk,kn->mn", ((7, 20), (20, 9))),
])
def test_attention_einsums_bit_identical_to_reference(eq, shapes):
    rng = np.random.default_rng(len(eq))
    x, y = (conditioned(rng, s) for s in shapes)
    ref = japi.einsum(eq, jnp.asarray(x), jnp.asarray(y),
                      precision="ozaki1-p4+xla")
    out = tapi.einsum(eq, t(x), t(y), precision="ozaki1-p4")
    assert tuple(out.shape) == ref.shape
    np.testing.assert_array_equal(bits(out), bits(ref))


def test_native_einsum_matches_torch():
    rng = np.random.default_rng(0)
    x, y = t(conditioned(rng, (2, 5, 3, 2, 16))), \
        t(conditioned(rng, (2, 24, 3, 16)))
    out = tapi.einsum("bqkgd,bjkd->bkgqj", x, y, precision="native")
    torch.testing.assert_close(out, torch.einsum("bqkgd,bjkd->bkgqj", x, y))


# The reference's einsum forms beyond the canonical core (the cases of
# tests/test_api.py): (subscripts, lhs shape, rhs shape).
EINSUM_FORMS = [
    ("ij,jk", (16, 24), (24, 8)),                       # implicit output
    ("ij,jk->k", (16, 24), (24, 8)),                    # presum of i
    ("...k,kn->...n", (2, 3, 32), (32, 16)),            # ellipsis
    ("...ij,...jk->...ik", (2, 3, 5, 16), (2, 3, 16, 4)),
    ("bij,bjk->bik", (1, 4, 8), (3, 8, 5)),             # size-1 batch
    ("ij,jk->ik", (4, 1), (8, 5)),                      # size-1 K
    ("ij,kl->jl", (3, 10), (5, 7)),                     # presum both
    ("i,j->ij", (9,), (11,)),                           # outer, K = 1
]


@pytest.mark.parametrize("eq,sa,sb", EINSUM_FORMS,
                         ids=[f[0] for f in EINSUM_FORMS])
def test_einsum_outside_the_canonical_core_raises(eq, sa, sb):
    """What the port used to refuse (an implicit output, a label summed
    out of one operand, ellipses, size-1 broadcasting) now runs as the
    reference's does, bit for bit against ``repro.einsum`` under +xla."""
    rng = np.random.default_rng(len(eq) + len(sa))
    x, y = conditioned(rng, sa), conditioned(rng, sb)
    ref = japi.einsum(eq, jnp.asarray(x), jnp.asarray(y),
                      precision="ozaki1-p4+xla")
    out = tapi.einsum(eq, t(x), t(y), precision="ozaki1-p4")
    assert tuple(out.shape) == ref.shape
    np.testing.assert_array_equal(bits(out), bits(ref))


@pytest.mark.parametrize("eq,sa", [("...k,kn->...n", (2, 3, 32)),
                                   ("kb,kn->bn", (32, 4)),
                                   ("bsk,kn->bn", (2, 3, 32))])
def test_einsum_prepared_rhs_forms_bit_identical(eq, sa):
    """A prepared rhs in '...k,kn->...n'-shaped subscripts, a free lhs
    axis pre-summed, against the reference's prepared einsum."""
    from repro.kernels import prepared as jprepared
    from repro_torch.kernels import prepared as tprepared
    rng = np.random.default_rng(11)
    x, w = conditioned(rng, sa), conditioned(rng, (32, 16))
    jprep = jprepared.prepare_rhs(jnp.asarray(w), japi.precision("ozaki1-p4"))
    ref = japi.einsum(eq, jnp.asarray(x), jprep, precision="ozaki1-p4")
    tprep = tprepared.prepare_rhs(t(w), tapi.precision("ozaki1-p4"))
    out = tapi.einsum(eq, t(x), tprep, precision="ozaki1-p4")
    assert tuple(out.shape) == ref.shape
    np.testing.assert_array_equal(bits(out), bits(ref))
    with pytest.raises(ValueError, match="prepared rhs"):
        tapi.einsum("bn,kn->bk", t(conditioned(rng, (4, 16))), tprep,
                    precision="ozaki1-p4")


def test_deprecated_shims_warn_and_equal_their_targets():
    from repro_torch.core import emulated, scheme1
    from repro_torch.models.common import dense, parse_gemm_spec
    rng = np.random.default_rng(5)
    a, b = t(conditioned(rng, (7, 40))), t(conditioned(rng, (40, 9)))
    cfg = tapi.precision("ozaki1-p4")
    with pytest.warns(DeprecationWarning):
        out = dispatch.maybe_emulated_matmul(a, b, cfg)
    assert torch.equal(out, dispatch.auto_fused_matmul(a, b, cfg))
    assert torch.equal(scheme1.fused_matmul(a, b, cfg),
                       dispatch.emulated_matmul(a, b, cfg=cfg))
    assert torch.equal(scheme1.fused_matmul(a, b, tapi.precision("ozaki2-m4")),
                       dispatch.emulated_matmul(a, b, cfg=cfg))
    assert torch.equal(emulated.emulated_einsum_proj(a, b, cfg),
                       emulated.emulated_dot(a, b, cfg))
    with pytest.warns(DeprecationWarning):
        spec = parse_gemm_spec("ozaki1-p4-cached")
    assert spec == EmulationConfig(scheme="ozaki1", p=4, impl="xla",
                                   cache_weights=True)
    assert torch.equal(dense(a, b, GemmPolicy(default=spec), "ffn"),
                       emulated.emulated_dot(a, b, spec))
    with pytest.warns(DeprecationWarning), pytest.raises(ValueError):
        parse_gemm_spec("ozaki2-p6-cached")


@pytest.mark.parametrize("eq", ["ii,ij->j", "ij,jk,kl->il"])
def test_einsum_refuses_what_the_reference_refuses(eq):
    """An in-operand repeat and three operands raise ValueError in both
    packages."""
    x = torch.ones(3, 3)
    with pytest.raises(ValueError):
        japi.einsum(eq, jnp.ones((3, 3)), jnp.ones((3, 3)),
                    precision="ozaki1-p4")
    with pytest.raises(ValueError):
        tapi.einsum(eq, x, x, precision="ozaki1-p4")


def test_backend_resolution_precedence(monkeypatch):
    monkeypatch.delenv(backends.ENV_VAR, raising=False)
    cpu, gpu = torch.device("cpu"), torch.device("cuda")
    assert backends.resolve_backend_name(device=cpu) == "torch"
    assert backends.resolve_backend_name(device=gpu) == "cuda"
    cfg = EmulationConfig(scheme="ozaki1", backend="cuda")
    assert backends.resolve_backend_name(cfg=cfg, device=cpu) == "cuda"
    monkeypatch.setenv(backends.ENV_VAR, "torch")
    assert backends.resolve_backend_name(cfg=cfg, device=gpu) == "torch"
    assert backends.resolve_backend_name("cuda", cfg, gpu) == "cuda"
    with pytest.raises(KeyError):
        backends.resolve_backend_name("tpu")


def test_cuda_backend_on_cpu_tensors_runs_the_plain_version():
    rng = np.random.default_rng(2)
    a, b = t(conditioned(rng, (6, 30))), t(conditioned(rng, (30, 10)))
    via_cuda = dispatch.emulated_matmul(a, b, cfg="ozaki1-p4", backend="cuda")
    via_torch = dispatch.emulated_matmul(a, b, cfg="ozaki1-p4", backend="torch")
    assert torch.equal(via_cuda, via_torch)


def test_block_cache_counts_per_backend():
    dispatch.block_cache_clear()
    a, b = torch.ones(4, 8), torch.ones(8, 8)
    for _ in range(3):
        dispatch.plan_emulated(a, b, EmulationConfig(scheme="ozaki1"),
                               backend="cuda")
    info = dispatch.block_cache_info("cuda")
    assert (info.hits, info.misses, info.currsize) == (2, 1, 1)
    plan = dispatch.plan_emulated(a, b, EmulationConfig(scheme="ozaki1"),
                                  backend="cuda")
    assert plan.blocks == backends.get_backend("cuda").choose_blocks(4, 8, 8, 4)
    dispatch.block_cache_clear("cuda")
    assert dispatch.block_cache_info().currsize == 0


@pytest.mark.parametrize("spec,err", [("ozaki1-p4@xla", KeyError),
                                      ("ozaki1-p4@tpu", KeyError)])
def test_outside_the_slice_raises(spec, err):
    """The reference's backend names are not the port's ('cuda' and
    'torch'): nothing falls back silently. ('+guard' runs since the guard
    was ported: tests/test_torch_guard.py.)"""
    with pytest.raises(err):
        dispatch.emulated_matmul(torch.ones(4, 8), torch.ones(8, 4), cfg=spec)


def test_ozaki2_cached_spec_runs():
    """'ozaki2-m6+cached' is in the slice: a plain GEMM under it gives the
    bits of 'ozaki2-m6' (``+cached`` only changes a differentiated call),
    and a policy holding it resolves."""
    a, b = torch.randn(4, 8), torch.randn(8, 4)
    assert torch.equal(dispatch.emulated_matmul(a, b, cfg="ozaki2-m6+cached"),
                       dispatch.emulated_matmul(a, b, cfg="ozaki2-m6"))
    dispatch.resolve_policy(GemmPolicy(
        default=EmulationConfig.parse("ozaki2-m6+cached")))


def test_native_and_complex():
    """Native is a plain matmul (complex stays complex); complex64 runs as
    Scheme I's 4M and Scheme II's 3M (their parity with the reference:
    tests/test_torch_complex3m.py); complex128 under Scheme I runs 4M of
    float64 parts."""
    from repro_torch.core import complex3m, scheme1
    a, b = torch.randn(4, 8), torch.randn(8, 3)
    torch.testing.assert_close(
        dispatch.emulated_matmul(a, b, cfg="native"), a @ b)
    ac = torch.complex(a, a.flip(0))
    bc = torch.complex(b, b.flip(1))
    torch.testing.assert_close(
        dispatch.emulated_matmul(ac, bc, cfg="native"), ac @ bc)
    assert torch.equal(
        dispatch.emulated_matmul(ac, bc, cfg="ozaki1-p4"),
        scheme1.matmul_complex_4m(ac, bc, EmulationConfig(scheme="ozaki1")))
    assert torch.equal(
        dispatch.emulated_matmul(ac, bc, cfg="ozaki2-m6"),
        complex3m.matmul(ac, bc, EmulationConfig(scheme="ozaki2", p=6)))
    z, zb = ac.to(torch.complex128), bc.to(torch.complex128)
    out = dispatch.emulated_matmul(z, zb, cfg="ozaki1-p4")
    assert out.dtype == torch.complex128
    assert torch.equal(out, scheme1.matmul_complex_4m(
        z, zb, EmulationConfig(scheme="ozaki1")))
