"""EmuGEMM-II's residue forms on the port's residue route, against the
JAX reference, bit for bit: K5 (``ozaki2.fused_residue_matmul``) and K7
(``ozaki3m.fused_3m_residue_matmul``) are a relayout of each operand that
a tensor map cannot read in place (``ozaki2.relayout_planes``) and one
residue plane GEMM (``ozaki2.residue_planes``,
``ozaki3m.residue_planes_3m``). Their plain versions, composed, are held
against today's plain versions of the two forms and against the
reference's Pallas kernels in interpret mode (at the Pallas blocks'
aligned shapes; ragged shapes against the plain versions alone), on
full-range int8 residues for moduli from 3 to 256, an int32 sum that
wraps among them. The wrapper's choice between reading an operand in
place and laying it out first is a pure function of its strides, K and
base alignment (``ozaki2.tma_strides``), tested here as such. The CUDA
kernels are held to these plain versions on the card in
tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_util import t
from repro.kernels import ozaki2 as jozaki2, ozaki3m as jozaki3m
from repro_torch.core.precision import default_moduli
from repro_torch.kernels import ozaki2, ozaki3m

# p in {1, 6, 16}: the default moduli (256 down), and sets with moduli
# below 16, on which full-range residues are far outside the balanced
# range.
MODULI = {"m1": default_moduli(1), "m6": default_moduli(6),
          "m16": default_moduli(16), "small6": (3, 5, 7, 11, 13, 256),
          "small1": (2,)}


def _res(rng, shape):
    return rng.integers(-128, 128, shape).astype(np.int8)


# The operand as the residue route hands it to the plane GEMM: itself, or
# its relaid planes (the plain version on CPU tensors).
_k_major = ozaki2._k_major


def _same(x: torch.Tensor, y) -> None:
    x, y = x.numpy(), np.asarray(y)
    assert x.dtype == y.dtype == np.int8
    np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("moduli", ["m1", "m6", "m16", "small6"])
def test_residue_route_matches_reference_kernel(moduli):
    """K5 and K7 at the Pallas blocks' aligned shapes: relayout (B^T) +
    the residue plane GEMM == today's plain versions == the reference's
    kernels in interpret mode."""
    moduli = MODULI[moduli]
    p = len(moduli)
    rng = np.random.default_rng(p)
    a, b = _res(rng, (p, 128, 256)), _res(rng, (p, 256, 128))
    ref = jozaki2.fused_residue_matmul(jnp.asarray(a), jnp.asarray(b), moduli)
    ta, tb = t(a), t(b)
    routed = ozaki2.residue_planes_plain(
        _k_major(ta), _k_major(tb.transpose(-1, -2)), moduli)
    _same(routed, ref)
    _same(ozaki2.fused_residue_matmul_plain(ta, tb, moduli), ref)
    _same(ozaki2.fused_residue_matmul(ta, tb, moduli), ref)
    a3, b3 = _res(rng, (p, 3, 128, 128)), _res(rng, (p, 3, 128, 256))
    ref3 = jozaki3m.fused_3m_residue_matmul(jnp.asarray(a3), jnp.asarray(b3),
                                            moduli)
    ta3, tb3 = t(a3), t(b3)
    routed3 = ozaki3m.residue_planes_3m_plain(
        _k_major(ta3), _k_major(tb3.transpose(-1, -2)), moduli)
    for x, y, z in zip(routed3,
                       ozaki3m.fused_3m_residue_matmul_plain(ta3, tb3, moduli),
                       ref3):
        _same(x, z)
        _same(y, z)


@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (17, 15, 129), (129, 127, 17),
                                   (300, 129, 1), (5, 16, 300)])
@pytest.mark.parametrize("moduli", ["small1", "small6", "m16"])
def test_residue_route_ragged_matches_plain(m, k, n, moduli):
    """Ragged shapes, K below and past one K tile: the composed plain
    pieces == today's plain versions, for a contiguous B, a B read in
    place as the transposed view of B^T's residues, and a phase stack
    whose modulus and phase strides are not the contiguous ones."""
    moduli = MODULI[moduli]
    p = len(moduli)
    rng = np.random.default_rng(m * k + n)
    a, b = t(_res(rng, (p, m, k))), t(_res(rng, (p, k, n)))
    b_view = t(np.ascontiguousarray(b.numpy().transpose(0, 2, 1))
               ).transpose(-1, -2)
    want = ozaki2.fused_residue_matmul_plain(a, b, moduli)
    for rhs in (b, b_view):
        got = ozaki2.residue_planes_plain(
            _k_major(a), _k_major(rhs.transpose(-1, -2)), moduli)
        assert torch.equal(got, want)
        assert torch.equal(ozaki2.fused_residue_matmul(a, rhs, moduli), want)
    # (M, p, 3, K) storage seen as (p, 3, M, K): phase stride K, modulus
    # stride 3K, row stride 3pK.
    a3 = t(_res(rng, (m, p, 3, k))).permute(1, 2, 0, 3)
    b3 = t(_res(rng, (p, 3, k, n)))
    want3 = ozaki3m.fused_3m_residue_matmul_plain(a3, b3, moduli)
    got3 = ozaki3m.residue_planes_3m_plain(
        _k_major(a3), _k_major(b3.transpose(-1, -2)), moduli)
    for x, y, z in zip(got3, want3,
                       ozaki3m.fused_3m_residue_matmul(a3, b3, moduli)):
        assert torch.equal(x, y) and torch.equal(z, y)


def test_wrapping_sum_matches_reference_kernel():
    """All -128 over K = 131200: each sum, 131200 * 2^14, wraps int32, and
    mod 255 the wrapped sum differs from the exact one (2^32 = 1 mod 255).
    The route wraps as the reference's kernel does."""
    moduli = (255,)
    k = 131200
    a = np.full((1, 128, k), -128, np.int8)
    b = np.full((1, k, 128), -128, np.int8)
    ref = np.asarray(jozaki2.fused_residue_matmul(jnp.asarray(a),
                                                  jnp.asarray(b), moduli))
    exact = (k * 2 ** 14 + 127) % 255 - 127
    assert (ref != exact).all()
    ta, tb = t(a), t(b)
    _same(ozaki2.residue_planes_plain(
        _k_major(ta), _k_major(tb.transpose(-1, -2)), moduli), ref)
    _same(ozaki2.fused_residue_matmul_plain(ta, tb, moduli), ref)


def test_relayout_plain_pads_k_with_zero_residues():
    rng = np.random.default_rng(0)
    x = t(_res(rng, (3, 2, 70, 200))).transpose(-1, -2)    # (3, 2, 200, 70)
    planes = ozaki2.relayout_planes_plain(x)
    assert planes.shape == (3, 2, 200, ozaki2.plane_k(70))
    assert planes.is_contiguous()
    assert torch.equal(planes[..., :70], x)
    assert not planes[..., 70:].any()
    assert torch.equal(ozaki2.relayout_planes(x[:, 0]), planes[:, 0])
    assert torch.equal(ozaki2.relayout_planes(x), planes)


# shape (p, T, R, K), strides, base -> (s_p, s_t, s_r) or None
STRIDE_CASES = [
    # contiguous, K a multiple of 16: read in place
    ((16, 1, 4096, 4096), (4096 ** 2, 4096 ** 2, 4096, 1), 0,
     (4096 ** 2, 4096 ** 2, 4096)),
    ((6, 3, 100, 256), (76800, 25600, 256, 1), 256, (76800, 25600, 256)),
    # B^T's residues seen through B's transposed view: read in place
    ((6, 1, 77, 208), (77 * 208, 77 * 208, 208, 1), 4096,
     (77 * 208, 77 * 208, 208)),
    # K not a multiple of 16: the row stride is not, so relaid
    ((6, 1, 100, 200), (20000, 20000, 200, 1), 0, None),
    ((6, 1, 100, 127), (12700, 12700, 127, 1), 0, None),
    # B as it arrives, N-contiguous: K is not unit-stride
    ((6, 1, 77, 256), (19712, 19712, 1, 77), 0, None),
    # a base one byte off
    ((6, 1, 128, 128), (16384, 16384, 128, 1), 1, None),
    ((6, 1, 128, 128), (16384, 16384, 128, 1), 8, None),
    # non-contiguous phase and modulus strides that are multiples of 16
    ((4, 3, 64, 32), (96, 32, 384, 1), 0, (96, 32, 384)),
    ((4, 3, 64, 32), (97, 32, 388, 1), 0, None),
    # a stride of 0 (an expanded operand) is never read in place
    ((4, 1, 64, 32), (0, 2048, 32, 1), 0, None),
    # size-1 axes: their strides (and K's when K = 1) do not matter
    ((1, 1, 1, 1), (7, 5, 3, 9), 0, (16, 16, 16)),
    ((1, 1, 300, 1), (300, 300, 1, 1), 0, None),
    ((1, 1, 300, 1), (4800, 4800, 16, 5), 0, (4800, 4800, 16)),
    ((1, 1, 5, 40), (1, 1, 48, 1), 0, (240, 240, 48)),
]


@pytest.mark.parametrize("shape,strides,base,want", STRIDE_CASES)
def test_read_in_place_decision(shape, strides, base, want):
    """``tma_strides`` as a pure function of the strides, K and the base:
    the byte strides a tensor map reads the residues through, or None
    (laid out first)."""
    assert ozaki2.tma_strides(shape, strides, base) == want
