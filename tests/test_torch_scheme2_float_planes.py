"""EmuGEMM-II's float-rhs forms on float32 and bfloat16 operands (K5g 2-D,
K6 batched) on the plane route, through its plain versions, against the
JAX reference, bit for bit.

The route is an encode of A, an encode of B^T and one plane GEMM
(csrc/emugemm2_planes.cu). Its plain versions are
``ozaki2.encode_planes_plain`` (the balanced residues of trunc(x * s) in
the operand's type, K-contiguous, padded with zero residues to the plane
GEMM's K tile) and ``ozaki2.plane_matmul_plain`` (one exact product per
modulus, its reduction, the CRT, then / (mu * nu)). Together they are
held against the reference's fused GPU lowerings in interpret mode
(``gpu.fused_matmul_scheme2``, ``gpu.fused_matmul_scheme2_batched``): float32
and bfloat16 in every pairing, float32, bfloat16 and float64 outputs, p in
{1, 4, 6, 16}, ragged M, N and K (K <= 8 too), A read transposed (dB's
X^T), B read transposed, and a batch read with both transposed, as
attention's backward reads it. A float64 output is compared inside
``jax.enable_x64(True)``, the context manager only (tests share worker
processes). The kernels themselves are held to these plain versions on
the card in tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_util import t
from conftest import conditioned
from repro.core import scheme2 as jscheme2
from repro.kernels.backends import gpu as jgpu
from repro.kernels.common import Blocks as JBlocks
from repro_torch.core import scheme2
from repro_torch.core.precision import default_moduli
from repro_torch.kernels import ozaki2

TYPES = {"float32": (torch.float32, jnp.float32),
         "bfloat16": (torch.bfloat16, jnp.bfloat16),
         "float64": (torch.float64, jnp.float64)}
PAIRS = [("float32", "float32"), ("bfloat16", "bfloat16"),
         ("float32", "bfloat16"), ("bfloat16", "float32")]
MODULI_COUNTS = [1, 4, 6, 16]
# (M, K, N): ragged, and K <= 8 (H12).
SHAPES = {"ragged": (37, 70, 29), "K<=8": (9, 5, 11)}


def _same(x: torch.Tensor, y) -> None:
    """Bitwise equality of a tensor and a jax or numpy array, type
    included (floats through their bit patterns, ints as values)."""
    y = np.asarray(y)
    assert str(x.dtype).split(".")[-1] == str(y.dtype), (x.dtype, y.dtype)
    if x.is_floating_point():
        size = x.element_size()
        xs = x.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[size])
        xs, ys = xs.numpy(), y.view(f"i{size}")
    else:
        xs, ys = x.numpy(), y
    np.testing.assert_array_equal(xs, ys)


def _operand(rng, shape, name, transposed=False):
    """A seeded Eq. 19 operand in type ``name`` for both packages: (jax
    array, torch tensor), the same values; ``transposed`` makes the torch
    one the transposed view of a contiguous tensor, as dB's X^T is."""
    tt, jt = TYPES[name]
    x = np.asarray(jnp.asarray(conditioned(rng, shape)).astype(jt)
                   .astype(jnp.float32))
    jx = jnp.asarray(x).astype(jt)
    if transposed:
        tx = t(np.ascontiguousarray(np.swapaxes(x, -1, -2)), tt)
        return jx, tx.transpose(-1, -2)
    return jx, t(x, tt)


def _reference(ja, jb, mu, nu, moduli, out_name):
    """The reference's fused GPU lowering in interpret mode, 2-D or
    batched, at blocks equal to the problem (one tile, one K step)."""
    *_, m, k = ja.shape
    n = jb.shape[-1]
    fn = (jgpu.fused_matmul_scheme2 if ja.ndim == 2
          else jgpu.fused_matmul_scheme2_batched)
    with jax.enable_x64(out_name == "float64"):
        return np.asarray(fn(ja, jb, jnp.asarray(_np(mu)).astype(ja.dtype),
                             jnp.asarray(_np(nu)).astype(jb.dtype), moduli,
                             JBlocks(m, n, k),
                             out_dtype=TYPES[out_name][1]))


def _np(x: torch.Tensor) -> np.ndarray:
    return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()


def _route(ta, tb, mu, nu, moduli, out_dtype):
    """The plane route's plain versions: encode A and B^T, then the plane
    GEMM."""
    return ozaki2.plane_matmul_plain(
        ozaki2.encode_planes_plain(ta, mu, moduli),
        ozaki2.encode_planes_plain(tb.transpose(-1, -2),
                                   nu.transpose(-1, -2), moduli),
        mu, nu, moduli, out_dtype)


@pytest.mark.parametrize("case", ["A transposed", "B^T", "K<=8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p", [4, 16])
def test_encode_planes_plain_matches_reference(p, dtype, case):
    """The planes of A with its row scales, read through a transposed
    view (dB's X^T), and of B^T with B's column scales, against the
    reference's trunc and balanced residues in the operand's type."""
    m, k, _ = SHAPES["K<=8" if case == "K<=8" else "ragged"]
    moduli = default_moduli(p)
    rng = np.random.default_rng(100 + p)
    if case == "B^T":       # B (k, m), its columns scaled, read as B^T
        jb, tb = _operand(rng, (k, m), dtype)
        scale = scheme2.scales(tb.T, tb, moduli)[1]
        jref = jnp.swapaxes(jscheme2.balanced_residues(
            jnp.trunc(jb * jnp.asarray(_np(scale)).astype(jb.dtype)),
            moduli), 1, 2)
        tx, scale = tb.T, scale.T
    else:
        jx, tx = _operand(rng, (m, k), dtype, transposed=case != "K<=8")
        scale = scheme2.scales(tx, tx.T, moduli)[0]
        jref = jscheme2.balanced_residues(
            jnp.trunc(jx * jnp.asarray(_np(scale)).astype(jx.dtype)),
            moduli)
    ozaki2.COUNTS.reset()
    planes = ozaki2.encode_planes(tx, scale, moduli)
    assert ozaki2.COUNTS.launches_encode == 0
    assert planes.shape == (p, tx.shape[0], ozaki2.PLANE_K)
    kk = tx.shape[1]
    _same(planes[..., :kk], np.asarray(jref).astype(np.int8))
    assert not planes[..., kk:].any()
    assert torch.equal(planes, ozaki2.encode_planes_plain(tx, scale, moduli))


@pytest.mark.parametrize("out", ["float32", "bfloat16", "float64"])
@pytest.mark.parametrize("pair", PAIRS, ids="@".join)
@pytest.mark.parametrize("p", MODULI_COUNTS)
def test_plane_route_matches_reference_gpu_kernel(p, pair, out):
    """Planes of A (read transposed, as dB's X^T) and of B^T -> the plane
    GEMM's plain version equals the reference's fused GPU kernel in
    interpret mode, for every operand pairing and output type, and the
    front door's plain version."""
    m, k, n = SHAPES["ragged"]
    moduli = default_moduli(p)
    rng = np.random.default_rng(200 + p)
    ja, ta = _operand(rng, (m, k), pair[0], transposed=True)
    jb, tb = _operand(rng, (k, n), pair[1])
    mu, nu = scheme2.scales(ta, tb, moduli)
    out_t = TYPES[out][0]
    got = _route(ta, tb, mu, nu, moduli, out_t)
    _same(got, _reference(ja, jb, mu, nu, moduli, out))
    assert torch.equal(got, ozaki2.fused_matmul_scheme2(ta, tb, mu, nu,
                                                        moduli, out_t))


@pytest.mark.parametrize("case", ["ragged", "K<=8", "B transposed",
                                  "both transposed"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plane_route_shapes_match_reference_gpu_kernel(dtype, case):
    """Ragged M, N and K, K <= 8, and operands read through transposed
    views, at m = 6 (olmo-1b-emu's attn_qk and the hoisted step's)."""
    m, k, n = SHAPES["K<=8" if case == "K<=8" else "ragged"]
    moduli = default_moduli(6)
    rng = np.random.default_rng(300 + len(case))
    ja, ta = _operand(rng, (m, k), dtype,
                      transposed=case == "both transposed")
    jb, tb = _operand(rng, (k, n), dtype, transposed="transposed" in case)
    mu, nu = scheme2.scales(ta, tb, moduli)
    got = _route(ta, tb, mu, nu, moduli, TYPES[dtype][0])
    _same(got, _reference(ja, jb, mu, nu, moduli, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p", [4, 16])
def test_batched_plane_route_matches_reference_gpu_kernel(p, dtype):
    """A batch read with both operands transposed, as attention's backward
    reads them (dA = g b^T, dB = a^T g): the batched planes are each
    element's 2-D planes, and the plane GEMM's plain version equals the
    reference's batched fused GPU kernel in interpret mode."""
    bt, m, k, n = 3, 37, 70, 29
    moduli = default_moduli(p)
    rng = np.random.default_rng(400 + p)
    ja, ta = _operand(rng, (bt, m, k), dtype, transposed=True)
    jb, tb = _operand(rng, (bt, k, n), dtype, transposed=True)
    mu, nu = scheme2.scales(ta, tb, moduli)
    a_planes = ozaki2.encode_planes(ta, mu, moduli)
    b_planes = ozaki2.encode_planes(tb.transpose(1, 2), nu.transpose(1, 2),
                                    moduli)
    assert a_planes.shape == (p, bt, m, ozaki2.PLANE_K)
    assert b_planes.shape == (p, bt, n, ozaki2.PLANE_K)
    for e in range(bt):
        assert torch.equal(a_planes[:, e],
                           ozaki2.encode_planes(ta[e], mu[e], moduli))
    got = ozaki2.plane_matmul(a_planes, b_planes, mu, nu, moduli,
                              TYPES[dtype][0])
    _same(got, _reference(ja, jb, mu, nu, moduli, dtype))
    assert torch.equal(got, ozaki2.fused_matmul_scheme2(
        ta, tb, mu, nu, moduli, TYPES[dtype][0]))


def test_float_rhs_front_door_counts_no_launch_on_cpu():
    """On CPU tensors the float-rhs form, 2-D and batched, takes its plain
    version: no front-door call, encode or plane GEMM is counted, and no
    plain call as one made on CUDA; its result is the plane route's."""
    moduli = default_moduli(6)
    rng = np.random.default_rng(500)
    _, a = _operand(rng, (20, 30), "bfloat16", transposed=True)
    _, b = _operand(rng, (30, 10), "float32")
    _, a3 = _operand(rng, (2, 20, 30), "float32")
    _, b3 = _operand(rng, (2, 30, 10), "bfloat16", transposed=True)
    ozaki2.COUNTS.reset()
    for x, y in ((a, b), (a3, b3)):
        mu, nu = scheme2.scales(x, y, moduli)
        for out_t in (torch.float32, torch.bfloat16, torch.float64):
            out = ozaki2.fused_matmul_scheme2(x, y, mu, nu, moduli, out_t)
            assert out.dtype == out_t
            assert torch.equal(out, _route(x, y, mu, nu, moduli, out_t))
    c = ozaki2.COUNTS
    assert (c.launches_2d, c.launches_batched, c.launches_encode,
            c.launches_planes, c.plain_cuda_calls) == (0, 0, 0, 0, 0)
