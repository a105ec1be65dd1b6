"""K9's route on the plane GEMM, as plain versions of its pieces, against
the reference: the relayout's plain version at p = 1 with a logical K
(``ozaki1.relayout_interleaved_plain``: A's rows, and B (K, N) transposed
into the plane of B^T, zeros past K up to the plane GEMM's K tile), fed to
the plane GEMM's int32 instance (``matmul_int8.int8_planes_plain``), and
the read-in-place decision (``matmul_int8.tma_ld``) as a pure function.

The reference's Pallas kernel runs in interpret mode here, as its own tests
run it on the CPU; ragged shapes and a wrapping int32 sum are held against
a numpy int64 product wrapped to int32. Inputs come from seeded numpy.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_util import t
from repro.kernels import matmul_int8 as jmatmul_int8
from repro_torch.kernels import matmul_int8, ozaki1


def _int8(seed, shape, lo=-128):
    return np.random.default_rng(seed).integers(lo, 128, shape).astype(
        np.int8)


def _wrapped(a8, b8):
    """The exact product, wrapped to int32 as the reference's adds do."""
    prod = a8.astype(np.int64) @ b8.astype(np.int64)
    return ((prod + 2 ** 31) % 2 ** 32 - 2 ** 31).astype(np.int32)


def _route(a8, b8):
    """The route's plain pieces: each operand's plane, then the int32
    plane GEMM."""
    pa = ozaki1.relayout_interleaved_plain(t(a8), 1, "a")
    pb = ozaki1.relayout_interleaved_plain(t(b8), 1, "b")
    return matmul_int8.int8_planes_plain(pa, pb)


@pytest.mark.parametrize("k", [1, 31, 33, 777, 1000])
def test_relayout_plain_at_p1_takes_a_logical_k(k):
    a8, b8 = _int8(k, (5, k)), _int8(k + 1, (k, 7))
    kp = ozaki1.plane_k(k)
    for x, operand, rows in ((a8, "a", a8), (b8, "b", b8.T)):
        planes = ozaki1.relayout_interleaved_plain(t(x), 1, operand)
        assert planes.shape == (1, rows.shape[0], kp) and planes.is_contiguous()
        np.testing.assert_array_equal(planes[0, :, :k].numpy(), rows)
        assert not planes[0, :, k:].any()
    np.testing.assert_array_equal(_route(a8, b8).numpy(), _wrapped(a8, b8))


@pytest.mark.parametrize("m,n,k", [(128, 128, 128), (256, 128, 256)])
def test_int8_route_plain_matches_reference(m, n, k):
    a8, b8 = _int8(m + k, (m, k)), _int8(n + k, (k, n))
    ref = np.asarray(jmatmul_int8.int8_matmul(jnp.asarray(a8),
                                              jnp.asarray(b8)))
    out = _route(a8, b8)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(
        matmul_int8.int8_matmul(t(a8), t(b8)).numpy(), ref)


@pytest.mark.parametrize("m,k,n", [(1, 7, 3), (37, 1000, 77),
                                   (100, 3000, 77), (130, 129, 200)])
def test_int8_route_plain_exact_on_ragged_shapes(m, k, n):
    a8, b8 = _int8(m, (m, k)), _int8(n, (k, n))
    ref = _wrapped(a8, b8)
    np.testing.assert_array_equal(_route(a8, b8).numpy(), ref)
    np.testing.assert_array_equal(
        matmul_int8.int8_matmul(t(a8), t(b8)).numpy(), ref)


def test_int8_route_plain_wraps_int32():
    # 131200 * (-128)^2 passes 2^31.
    a8 = np.full((2, 131200), -128, np.int8)
    b8 = np.full((131200, 3), -128, np.int8)
    ref = _wrapped(a8, b8)
    assert ref[0, 0] == 131200 * 128 * 128 - 2 ** 32
    np.testing.assert_array_equal(_route(a8, b8).numpy(), ref)
    np.testing.assert_array_equal(
        matmul_int8.int8_matmul(t(a8), t(b8)).numpy(), ref)


def test_tma_ld_reads_aligned_k_contiguous_rows_in_place():
    x = torch.zeros(64, 96, dtype=torch.int8)
    assert matmul_int8.tma_ld(x) == 96
    assert matmul_int8.tma_ld(x[:, :40]) == 96          # row stride, not K
    assert matmul_int8.tma_ld(x[:, 1:]) is None         # base misaligned
    assert matmul_int8.tma_ld(x[:, :40].T) is None      # N-contiguous
    assert matmul_int8.tma_ld(torch.zeros(8, 100, dtype=torch.int8)) is None
    assert matmul_int8.tma_ld(x[:1, :7]) == 16          # one row: any stride
    bt = torch.zeros(77, 1024, dtype=torch.int8)        # B = bt.T
    assert matmul_int8.tma_ld(bt.T.T) == 1024
