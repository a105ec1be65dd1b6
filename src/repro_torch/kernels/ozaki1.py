"""EmuGEMM-I (``csrc/emugemm1_planes.cu``, its plane route and the
interleaved form's relayout, and ``csrc/emugemm1_batched.cu``, the batched
form): wrappers, plain versions and launch counts.

``fused_matmul_scheme1`` takes (M, K) @ (K, N) or, strided over a batch,
(B, M, K) @ (B, K, N) operands in float32, bfloat16 or float64 with their
power-of-two scales mu (..., M, 1) and nu (..., 1, N) (float32; float64
for float64 operands, :func:`scale_dtype`), and returns the Scheme-I
product, p in 1..16, in ``out_dtype`` (float32, bfloat16, float16 or
float64; a float16 operand is widened to float32 by the caller, as the
reference's ``_widen`` does). On a CPU tensor it runs the plain
version, ``repro_torch.core.scheme1`` (the same slicing, exact integer
slice products and shift-reduce, as separate torch ops). On CUDA tensors a
2-D product takes the plane route (two encodes and one plane GEMM) and a
batched one the fused batched kernel, one launch a call
(:func:`launch_batched`: each K chunk carved in the kernel into shared
memory, the triangular schedule on int8 wgmma, the shift-reduce in the
epilogue).

The plane route: :func:`encode_planes` writes an (R, K) operand's p
carved slices once, scaled by its power-of-two row scale, as K-contiguous
int8 planes (p, R, Kp), K padded with zero slices to ``PLANE_K`` (B enters
as B^T with nu^T); :func:`plane_matmul` is a TMA-fed wgmma int8 GEMM over
the p(p+1)/2 slice pairs, diagonal by diagonal, with the shift-reduce and
the scales in its epilogue. Their plain versions are
:func:`encode_planes_plain` and :func:`plane_matmul_plain`; together they
are ``fused_matmul_plain``.

``fused_matmul_mixed`` is the plane route of a prepared weight: the lhs is
encoded and multiplied against the (p, N, Kp) planes of the weight's B^T
(``kernels.prepared``, layout 'planes'). ``fused_matmul_mixed_plain`` is
the same function on the 'interleaved' layout of the 'torch' backend: the
p int8 planes interleaved on K at granularity ``decompose.TILE``.

``fused_matmul_interleaved`` is the interleaved form: both operands are
already sliced and interleaved at ``decompose.TILE`` (A-hat (M, p * Kp)
from ``decompose.decompose_interleave``, B-hat (p * Kp, N) from
``decompose.decompose_interleave_rhs`` or ``scheme1.interleave_k``), so
nothing is carved and mu and nu enter in the epilogue only. On CUDA
tensors it is two relayouts (:func:`relayout_interleaved`: A-hat into the
planes (p, M, Kp'), B-hat into B^T's (p, N, Kp'), Kp' = ``plane_k(Kp)``)
and one plane GEMM. Its plain version deinterleaves both and runs the
slice products and shift-reduce, as the reference's oracle
``ref.scheme1_interleaved``; :func:`relayout_interleaved_plain` then
:func:`plane_matmul_plain` is the same function. Unlike the reference,
which needs M, N and K aligned to its blocks and interleaves at its
``bk``, M and N are taken as they are and the granularity is
``decompose.TILE`` (the bits are the same at any granularity). At p = 1
the relayout also writes the int8 GEMM's operand planes
(``kernels.matmul_int8``, with a logical K).

The kernels replace the Pallas kernels ``repro.kernels.ozaki1.
fused_matmul_prologue`` and ``repro.kernels.backends.gpu.
fused_matmul_scheme1`` (2-D launch: the plane route),
``fused_matmul_scheme1_batched`` (the batched kernel),
``repro.kernels.ozaki1.fused_matmul_mixed`` (the plane route of a
prepared weight) and ``fused_matmul_interleaved`` (relayouts and the
plane GEMM).
"""

from __future__ import annotations

import ctypes
import dataclasses
from functools import lru_cache

import torch
import torch.nn.functional as F

from repro_torch.core import scheme1

# The operand types the kernels carve, the most slices, and the kernels'
# type codes of operands and outputs (csrc/scheme1_common.cuh).
_KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.float64)
MAX_P = 16
TYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2,
             torch.float16: 3}
# The plane route's K tile, to which planes are padded, and its output
# tile columns (64 for a float64 output).
PLANE_K = 128
PLANE_N = 128
# The batched kernel's (operand, output) instances; another pair runs the
# plane route per batch element.
_BATCHED_PAIRS = frozenset(
    [(t, o) for t in (torch.float32, torch.bfloat16)
     for o in (torch.float32, torch.bfloat16, torch.float16)]
    + [(torch.float64, torch.float64)])
# The encode's grid carries row blocks of 64 on gridDim.y.
MAX_ROWS = 65535 * 64


@dataclasses.dataclass
class LaunchCounts:
    """Calls of each form (2-D, mixed and interleaved: the plane route's
    front doors; batched: one kernel launch a call), launches of the plane
    route's kernels (encodes, relayouts, plane GEMMs), and calls of the
    plain versions on CUDA tensors (which the model paths must never
    make)."""
    launches_2d: int = 0
    launches_batched: int = 0
    launches_mixed: int = 0
    launches_interleaved: int = 0
    launches_encode: int = 0
    launches_relayout: int = 0
    launches_planes: int = 0
    plain_cuda_calls: int = 0

    def reset(self) -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, 0)


COUNTS = LaunchCounts()


def scale_dtype(dtype: torch.dtype) -> torch.dtype:
    """The power-of-two scales' type of an operand type, as
    ``scheme1.pow2_scale`` gives them: float64 for float64, else
    float32."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def fused_matmul_plain(a: torch.Tensor, b: torch.Tensor, mu: torch.Tensor,
                       nu: torch.Tensor, p: int, beta: int,
                       out_dtype: torch.dtype) -> torch.Tensor:
    """The kernel's function in plain torch ops (CPU or CUDA)."""
    if a.is_cuda:
        COUNTS.plain_cuda_calls += 1
    a_sl = scheme1.carve_stack(scheme1.widen(a) / mu, p, beta)
    b_sl = scheme1.carve_stack(scheme1.widen(b) / nu, p, beta)
    accs = scheme1.triangular_accumulators(a_sl, b_sl, p)
    return scheme1.shift_reduce(accs, beta, mu, nu, out_dtype)


def fused_matmul_mixed_plain(a: torch.Tensor, b_hat: torch.Tensor,
                             mu: torch.Tensor, nu: torch.Tensor, p: int,
                             beta: int, out_dtype: torch.dtype
                             ) -> torch.Tensor:
    """The mixed form's function in plain torch ops (CPU or CUDA), on the
    'interleaved' layout: ``b_hat`` (p * Kp, N) interleaved on K at
    ``decompose.TILE``."""
    from repro_torch.kernels.decompose import TILE
    if a.is_cuda:
        COUNTS.plain_cuda_calls += 1
    k = a.shape[-1]
    b_sl = scheme1.deinterleave_k(b_hat, p, "b", TILE)[:, :k]
    a_sl = scheme1.carve_stack(scheme1.widen(a) / mu, p, beta)
    accs = scheme1.triangular_accumulators(a_sl, b_sl, p)
    return scheme1.shift_reduce(accs, beta, mu, nu, out_dtype)


def fused_matmul_interleaved_plain(a_hat: torch.Tensor, b_hat: torch.Tensor,
                                   mu: torch.Tensor, nu: torch.Tensor, p: int,
                                   beta: int, out_dtype: torch.dtype
                                   ) -> torch.Tensor:
    """The interleaved form's function in plain torch ops (CPU or CUDA)."""
    from repro_torch.kernels.decompose import TILE
    if a_hat.is_cuda:
        COUNTS.plain_cuda_calls += 1
    a_sl = scheme1.deinterleave_k(a_hat, p, "a", TILE)
    b_sl = scheme1.deinterleave_k(b_hat, p, "b", TILE)
    accs = scheme1.triangular_accumulators(a_sl, b_sl, p)
    return scheme1.shift_reduce(accs, beta, mu, nu, out_dtype)


def plane_k(k: int) -> int:
    """K padded to the plane GEMM's K tile."""
    return -(-k // PLANE_K) * PLANE_K


def encode_planes_plain(x: torch.Tensor, scale: torch.Tensor, p: int,
                        beta: int) -> torch.Tensor:
    """The encode kernel's function in plain torch ops (CPU or CUDA): the
    p carved slices of an (R, K) operand over its row scales (R, 1), as
    (p, R, Kp) int8 planes padded with zero slices along K."""
    if x.is_cuda:
        COUNTS.plain_cuda_calls += 1
    k = x.shape[-1]
    r = F.pad(scheme1.widen(x) / scale, (0, plane_k(k) - k))
    return torch.stack(scheme1.carve(r, p, beta))


def plane_matmul_plain(a_planes: torch.Tensor, b_planes: torch.Tensor,
                       mu: torch.Tensor, nu: torch.Tensor, p: int, beta: int,
                       out_dtype: torch.dtype) -> torch.Tensor:
    """The plane GEMM's function in plain torch ops (CPU or CUDA): the
    planes (p, M, Kp) of A and (p, N, Kp) of B^T, the triangular slice
    products (zero slices past K add nothing), the shift-reduce, then
    mu and nu."""
    if a_planes.is_cuda:
        COUNTS.plain_cuda_calls += 1
    accs = scheme1.triangular_accumulators(
        a_planes, b_planes.transpose(-1, -2), p)
    return scheme1.shift_reduce(accs, beta, mu, nu, out_dtype)


def relayout_interleaved_plain(x_hat: torch.Tensor, p: int,
                               operand: str) -> torch.Tensor:
    """The relayout kernel's function in plain torch ops (CPU or CUDA):
    A-hat (R, p * Kp) (``operand`` 'a') or B-hat (p * Kp, R) ('b'),
    interleaved on K at ``decompose.TILE``, as the plane GEMM's
    K-contiguous planes (p, R, plane_k(Kp)), zero slices past Kp (B-hat
    transposed: the planes of B^T). At p = 1 the layout is the operand
    itself and Kp any K (the int8 GEMM's relayout)."""
    from repro_torch.kernels.decompose import TILE
    if x_hat.is_cuda:
        COUNTS.plain_cuda_calls += 1
    planes = (x_hat[None] if p == 1
              else scheme1.deinterleave_k(x_hat, p, operand, TILE))
    if operand == "b":
        planes = planes.transpose(-1, -2)
    k = planes.shape[-1]
    return F.pad(planes, (0, plane_k(k) - k)).contiguous()


@lru_cache(maxsize=None)
def _bind_encode(lib: ctypes.CDLL):
    if lib.emugemm1_plane_k() != PLANE_K:
        raise RuntimeError(f"emugemm1_planes.cu's K tile is "
                           f"{lib.emugemm1_plane_k()}, the wrapper pads to "
                           f"{PLANE_K}")
    fn = lib.emugemm1_encode
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                   + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@lru_cache(maxsize=None)
def _bind_relayout(lib: ctypes.CDLL):
    from repro_torch.kernels.decompose import TILE
    if lib.emugemm1_interleave() != TILE:
        raise RuntimeError(f"emugemm1_planes.cu's relayout reads the "
                           f"interleave at {lib.emugemm1_interleave()}, the "
                           f"layout is at {TILE}")
    fn = lib.emugemm1_relayout
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                   + [ctypes.c_longlong] + [ctypes.c_int] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@lru_cache(maxsize=None)
def _bind_batched(lib: ctypes.CDLL):
    fn = lib.emugemm1_batched
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 6 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@lru_cache(maxsize=None)
def _bind_planes(lib: ctypes.CDLL):
    fn = lib.emugemm1_planes
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check_p(p):
    if not 1 <= p <= MAX_P:
        raise NotImplementedError(f"emugemm1 is compiled for p in 1..{MAX_P}, "
                                  f"got p={p}")


def _check_out(out_dtype):
    if out_dtype not in TYPE_CODE:
        raise NotImplementedError(f"emugemm1: out_dtype {out_dtype} (float32, "
                                  "bfloat16, float16 or float64)")


def _check_p_beta(p, beta):
    _check_p(p)
    if not 1 <= beta <= 7:
        raise ValueError(f"emugemm1: beta={beta} outside 1..7")


def _check(a, b, mu, nu, p, beta, out_dtype):
    if not (a.is_cuda and b.is_cuda and mu.is_cuda and nu.is_cuda):
        raise ValueError("emugemm1: all operands must be CUDA tensors")
    if len({a.device, b.device, mu.device, nu.device}) != 1:
        raise ValueError("emugemm1: operands on different devices")
    if a.dtype not in _KERNEL_DTYPES or b.dtype != a.dtype:
        raise NotImplementedError(
            f"emugemm1 takes float32, bfloat16 or float64 operands of one "
            f"type, got {a.dtype} @ {b.dtype} (a float16 operand is widened "
            "to float32 by the caller)")
    _check_out(out_dtype)
    scale = scale_dtype(a.dtype)
    if mu.dtype != scale or nu.dtype != scale:
        raise ValueError(f"emugemm1: the scales of {a.dtype} operands must be "
                         f"{scale}, got {mu.dtype} and {nu.dtype}")
    _check_p_beta(p, beta)


def batched_tile_n(m: int, p: int = 1) -> int:
    """The batched kernel's rows of C a block: 16 (wgmma n16) for
    attention's M <= 16 in serving, and at p > 8 (whose instances hold 16
    diagonals' accumulators), else 32."""
    return 16 if m <= 16 or p > 8 else 32


def launch_batched(a3, b3, mu3, nu3, p, beta, out_dtype, tile_n=None):
    """Launch the batched kernel on (B, M, K) @ (B, K, N) float views (any
    strides) with their scales (B, M, 1) and (B, 1, N): one launch,
    (B, M, N) ``out_dtype``; ``tile_n`` sets the tile's rows of C instead
    of :func:`batched_tile_n` (for timing the tiles apart)."""
    from repro_torch.kernels import build
    batch, m, k = a3.shape
    n = b3.shape[-1]
    mu3, nu3 = mu3.contiguous(), nu3.contiguous()
    out = torch.empty((batch, m, n), dtype=out_dtype, device=a3.device)
    rc = _bind_batched(build.load("emugemm1_batched"))(
        a3.data_ptr(), b3.data_ptr(), mu3.data_ptr(), nu3.data_ptr(),
        out.data_ptr(), batch, m, n, k, *a3.stride(), *b3.stride(),
        TYPE_CODE[a3.dtype], TYPE_CODE[out_dtype], p, beta,
        tile_n or batched_tile_n(m, p),
        torch.cuda.current_stream(a3.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"emugemm1 batched launch failed (code {rc}) for "
                           f"{(batch, m, k, n)} p={p}")
    return out


def plane_tile_m(m: int) -> int:
    """The plane GEMM's output tile rows: 64 (one consumer warpgroup) for
    serving's M <= 64, else 128."""
    return 64 if m <= 64 else 128


def launch_encode(x, scale, p, beta):
    """Launch the encode kernel on an (R, K) float view with row scales
    (R, 1) of ``scale_dtype(x.dtype)``: planes (p, R, Kp) int8."""
    from repro_torch.kernels import build
    r, k = x.shape
    planes = torch.empty((p, r, plane_k(k)), dtype=torch.int8,
                         device=x.device)
    scale = scale.contiguous()
    rc = _bind_encode(build.load("emugemm1_planes"))(
        x.data_ptr(), scale.data_ptr(), planes.data_ptr(), r, k,
        planes.shape[-1], x.stride(0), x.stride(1), TYPE_CODE[x.dtype], p,
        beta, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"emugemm1 encode failed (code {rc}) for "
                           f"{tuple(x.shape)} {x.dtype} p={p}")
    return planes


def launch_planes(a_planes, b_planes, mu, nu, p, beta, out, epilogue=True,
                  tile_m=None):
    """Launch the plane GEMM on planes (p, M, Kp) and (p, N, Kp) with
    float32 or float64 scales mu (M, 1) and nu (1, N) into ``out`` (M, N);
    ``epilogue=False`` stops after the mainloop, which leaves ``out``
    unwritten (for timing the two apart); ``tile_m`` sets the tile rows
    instead of :func:`plane_tile_m` (for timing the tiles apart).

    The epilogue takes its scales in float64 for a float64 output and in
    float32 otherwise: they are converted here as the plain version's
    ``scale.to(out_dtype)`` converts them (a float32 power of two is exact
    in float64, and the kernel rounds a float32 one to bf16 or float16 as
    torch rounds a float64 one)."""
    from repro_torch.kernels import build
    _, m, kp = a_planes.shape
    n = b_planes.shape[1]
    scale = scale_dtype(out.dtype)
    mu, nu = mu.to(scale).contiguous(), nu.to(scale).contiguous()
    rc = _bind_planes(build.load("emugemm1_planes"))(
        a_planes.data_ptr(), b_planes.data_ptr(), mu.data_ptr(),
        nu.data_ptr(), out.data_ptr(), m, n, kp, TYPE_CODE[out.dtype], p,
        beta, tile_m or plane_tile_m(m), int(epilogue),
        torch.cuda.current_stream(a_planes.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"emugemm1 plane GEMM failed (code {rc}) for "
                           f"{(m, kp, n)} p={p}")
    return out


def launch_relayout(x_hat, p, operand):
    """Launch the relayout kernel on an int8 A-hat (R, p * Kp)
    (``operand`` 'a') or B-hat (p * Kp, R) ('b'), unit stride along its
    rows, any row stride: planes (p, R, Kp'); at p = 1 Kp is any K (the
    int8 GEMM's operands)."""
    from repro_torch.kernels import build
    rhs = operand == "b"
    r, kp = (x_hat.shape[1], x_hat.shape[0] // p) if rhs else (
        x_hat.shape[0], x_hat.shape[1] // p)
    planes = torch.empty((p, r, plane_k(kp)), dtype=torch.int8,
                         device=x_hat.device)
    rc = _bind_relayout(build.load("emugemm1_planes"))(
        x_hat.data_ptr(), planes.data_ptr(), r, kp, planes.shape[-1],
        x_hat.stride(0), p, int(rhs),
        torch.cuda.current_stream(x_hat.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"emugemm1 relayout failed (code {rc}) for "
                           f"{operand}-hat {tuple(x_hat.shape)} p={p}")
    return planes


def relayout_interleaved(x_hat: torch.Tensor, p: int,
                         operand: str) -> torch.Tensor:
    """A-hat (R, p * Kp) (``operand`` 'a') or B-hat (p * Kp, R) ('b'),
    contiguous int8 interleaved on K at ``decompose.TILE`` -> the plane
    GEMM's planes (p, R, plane_k(Kp)) (those of B^T for B-hat).

    CPU tensors take the plain version; CUDA tensors launch the relayout
    kernel or raise.
    """
    from repro_torch.kernels.decompose import TILE
    if x_hat.device.type == "cpu":
        return relayout_interleaved_plain(x_hat, p, operand)
    _check_p(p)
    rhs = operand == "b"
    pk, r = (x_hat.shape if rhs else x_hat.shape[::-1]) if x_hat.dim() == 2 \
        else (0, 0)
    # B-hat's grid carries its column tiles of 128 on gridDim.y.
    if (operand not in ("a", "b") or not x_hat.is_cuda
            or x_hat.dtype != torch.int8 or not x_hat.is_contiguous()
            or pk == 0 or pk % (p * TILE)
            or not 0 < r <= (65535 * PLANE_K if rhs else 2 ** 31 - 1)):
        raise ValueError(f"emugemm1 relayout: {operand}-hat "
                         f"{tuple(x_hat.shape)} {x_hat.dtype} on "
                         f"{x_hat.device} (expected contiguous int8, {p} * Kp "
                         f"along K, Kp a multiple of {TILE})")
    planes = launch_relayout(x_hat, p, operand)
    COUNTS.launches_relayout += 1
    return planes


def encode_planes(x: torch.Tensor, scale: torch.Tensor, p: int,
                  beta: int) -> torch.Tensor:
    """A float32, bfloat16 or float64 (R, K) operand (any strides) with its
    power-of-two row scales (R, 1) (float32; float64 for a float64
    operand) -> its (p, R, Kp) int8 slice planes (B enters as B^T with
    nu^T).

    CPU tensors take the plain version; CUDA tensors launch the encode
    kernel or raise.
    """
    if x.device.type == "cpu":
        return encode_planes_plain(x, scale, p, beta)
    if (x.dim() != 2 or x.dtype not in _KERNEL_DTYPES or not x.is_cuda
            or scale.dtype != scale_dtype(x.dtype)
            or tuple(scale.shape) != (x.shape[0], 1)
            or scale.device != x.device or x.shape[-1] == 0
            or not 0 < x.shape[0] <= MAX_ROWS):
        raise ValueError(f"emugemm1 encode: {tuple(x.shape)} {x.dtype} on "
                         f"{x.device}, scale {tuple(scale.shape)} "
                         f"{scale.dtype}")
    _check_p_beta(p, beta)
    planes = launch_encode(x, scale, p, beta)
    COUNTS.launches_encode += 1
    return planes


def plane_matmul(a_planes: torch.Tensor, b_planes: torch.Tensor,
                 mu: torch.Tensor, nu: torch.Tensor, p: int, beta: int,
                 out_dtype: torch.dtype) -> torch.Tensor:
    """The planes (p, M, Kp) of A and (p, N, Kp) of B^T with float32 or
    float64 scales mu (M, 1) and nu (1, N) -> (M, N) float32, bfloat16,
    float16 or float64.

    CPU tensors take the plain version; CUDA tensors launch the plane
    GEMM or raise.
    """
    if a_planes.device.type == "cpu":
        return plane_matmul_plain(a_planes, b_planes, mu, nu, p, beta,
                                  out_dtype)
    pa, m, kp = a_planes.shape
    n = b_planes.shape[1]
    if (tuple(b_planes.shape) != (pa, n, kp) or pa != p or kp % PLANE_K
            or not a_planes.is_contiguous() or not b_planes.is_contiguous()
            or {a_planes.dtype, b_planes.dtype} != {torch.int8}
            or tuple(mu.shape) != (m, 1) or tuple(nu.shape) != (1, n)
            or not {mu.dtype, nu.dtype} <= {torch.float32, torch.float64}
            or out_dtype not in TYPE_CODE or m * n == 0
            or len({x.device for x in (a_planes, b_planes, mu, nu)}) != 1):
        raise ValueError(f"emugemm1 plane GEMM: {tuple(a_planes.shape)} "
                         f"{a_planes.dtype} @ {tuple(b_planes.shape)} "
                         f"{b_planes.dtype}, mu {tuple(mu.shape)} {mu.dtype}, "
                         f"nu {tuple(nu.shape)} {nu.dtype}, p={p} -> "
                         f"{out_dtype}")
    _check_p_beta(p, beta)
    out = torch.empty((m, n), dtype=out_dtype, device=a_planes.device)
    launch_planes(a_planes, b_planes, mu, nu, p, beta, out)
    COUNTS.launches_planes += 1
    return out


def fused_matmul_scheme1(a: torch.Tensor, b: torch.Tensor, mu: torch.Tensor,
                         nu: torch.Tensor, p: int, beta: int,
                         out_dtype: torch.dtype) -> torch.Tensor:
    """(M, K) @ (K, N) with scales (M, 1) / (1, N) -> (M, N), or the
    strided-batched (B, M, K) @ (B, K, N) -> (B, M, N) form.

    CPU tensors take the plain version; CUDA tensors launch the kernels
    (2-D: two encodes and one plane GEMM; batched: one launch of the
    batched kernel) or raise.
    """
    if a.device.type == "cpu":
        return fused_matmul_plain(a, b, mu, nu, p, beta, out_dtype)
    _check(a, b, mu, nu, p, beta, out_dtype)
    if a.dim() == 2 and b.dim() == 2:
        (m, k), n = a.shape, b.shape[-1]
        if b.shape[0] != k or mu.shape != (m, 1) or nu.shape != (1, n):
            raise ValueError(f"emugemm1: shapes {tuple(a.shape)} @ "
                             f"{tuple(b.shape)}, mu {tuple(mu.shape)}, "
                             f"nu {tuple(nu.shape)}")
        if m * n == 0 or k == 0:
            out = torch.zeros((m, n), dtype=out_dtype, device=a.device)
        else:
            out = plane_matmul(encode_planes(a, mu, p, beta),
                               encode_planes(b.T, nu.T, p, beta), mu, nu, p,
                               beta, out_dtype)
        COUNTS.launches_2d += 1
        return out
    if a.dim() == 3 and b.dim() == 3:
        (batch, m, k), n = a.shape, b.shape[-1]
        if (b.shape[:2] != (batch, k) or mu.shape != (batch, m, 1)
                or nu.shape != (batch, 1, n)):
            raise ValueError(f"emugemm1: shapes {tuple(a.shape)} @ "
                             f"{tuple(b.shape)}, mu {tuple(mu.shape)}, "
                             f"nu {tuple(nu.shape)}")
        if batch * m * n == 0 or k == 0:
            out = torch.zeros((batch, m, n), dtype=out_dtype, device=a.device)
        elif (a.dtype, out_dtype) in _BATCHED_PAIRS:
            out = launch_batched(a, b, mu, nu, p, beta, out_dtype)
        else:
            # No batched instance for this (operand, output) pair: the
            # plane route per element.
            out = torch.stack([
                plane_matmul(encode_planes(a[i], mu[i], p, beta),
                             encode_planes(b[i].T, nu[i].T, p, beta), mu[i],
                             nu[i], p, beta, out_dtype)
                for i in range(batch)])
        COUNTS.launches_batched += 1
        return out
    raise ValueError(f"emugemm1: operands must both be 2-D or both 3-D, got "
                     f"{tuple(a.shape)} @ {tuple(b.shape)}")


def fused_matmul_mixed(a: torch.Tensor, b_planes: torch.Tensor,
                       mu: torch.Tensor, nu: torch.Tensor, p: int, beta: int,
                       out_dtype: torch.dtype) -> torch.Tensor:
    """(M, K) float @ a prepared weight's (p, N, Kp) int8 planes (those of
    its B^T, Kp = plane_k(K)), with scales mu (M, 1) (of the lhs's type,
    :func:`scale_dtype`) and nu (1, N) (of the weight's) -> (M, N)
    ``out_dtype``.

    The plane route: one encode of the lhs (:func:`encode_planes`) and one
    plane GEMM (:func:`plane_matmul`), each of which takes its plain
    version on CPU tensors; CUDA tensors launch both kernels or raise.
    """
    m, k = a.shape
    n = b_planes.shape[1] if b_planes.dim() == 3 else -1
    if a.is_cuda:
        _check(a, a, mu, mu, p, beta, out_dtype)
    if (b_planes.dtype != torch.int8
            or nu.dtype not in (torch.float32, torch.float64)
            or tuple(b_planes.shape) != (p, n, plane_k(k))
            or b_planes.device != a.device
            or tuple(mu.shape) != (m, 1) or tuple(nu.shape) != (1, n)):
        raise ValueError(f"emugemm1 mixed: a {tuple(a.shape)}, prepared "
                         f"{tuple(b_planes.shape)} {b_planes.dtype} (expected "
                         f"int8 ({p}, N, {plane_k(k)})), mu "
                         f"{tuple(mu.shape)}, nu {tuple(nu.shape)}")
    if m * n == 0 or k == 0:
        return torch.zeros((m, n), dtype=out_dtype, device=a.device)
    out = plane_matmul(encode_planes(a, mu, p, beta), b_planes, mu, nu, p,
                       beta, out_dtype)
    if a.is_cuda:
        COUNTS.launches_mixed += 1
    return out


def fused_matmul_interleaved(a_hat: torch.Tensor, b_hat: torch.Tensor,
                             mu: torch.Tensor, nu: torch.Tensor, p: int,
                             beta: int, out_dtype: torch.dtype = torch.float32
                             ) -> torch.Tensor:
    """A-hat (M, p * Kp) int8 @ B-hat (p * Kp, N) int8, both interleaved on
    K at granularity ``decompose.TILE``, with scales mu (M, 1) and nu
    (1, N) -> (M, N) ``out_dtype``.

    CPU tensors take the plain version; CUDA tensors launch the route (a
    relayout of each operand into planes and one plane GEMM) or raise.
    """
    from repro_torch.kernels.decompose import TILE
    if a_hat.device.type == "cpu":
        return fused_matmul_interleaved_plain(a_hat, b_hat, mu, nu, p, beta,
                                              out_dtype)
    if not (a_hat.is_cuda and b_hat.is_cuda and mu.is_cuda and nu.is_cuda):
        raise ValueError("emugemm1: all operands must be CUDA tensors")
    if len({a_hat.device, b_hat.device, mu.device, nu.device}) != 1:
        raise ValueError("emugemm1: operands on different devices")
    _check_out(out_dtype)
    _check_p_beta(p, beta)
    if a_hat.dim() != 2 or b_hat.dim() != 2:
        raise ValueError(f"emugemm1 interleaved: A-hat {tuple(a_hat.shape)} "
                         f"and B-hat {tuple(b_hat.shape)} must be 2-D")
    (m, pk), n = a_hat.shape, b_hat.shape[1]
    if (a_hat.dtype != torch.int8
            or b_hat.dtype != torch.int8 or b_hat.shape[0] != pk
            or pk % (p * TILE) or not a_hat.is_contiguous()
            or not b_hat.is_contiguous()
            or not {mu.dtype, nu.dtype} <= {torch.float32, torch.float64}
            or tuple(mu.shape) != (m, 1) or tuple(nu.shape) != (1, n)):
        raise ValueError(
            f"emugemm1 interleaved: A-hat {tuple(a_hat.shape)} {a_hat.dtype}, "
            f"B-hat {tuple(b_hat.shape)} {b_hat.dtype} (expected contiguous "
            f"int8 (M, {p} * Kp) and ({p} * Kp, N), Kp a multiple of {TILE}),"
            f" mu {tuple(mu.shape)} {mu.dtype}, nu {tuple(nu.shape)} "
            f"{nu.dtype} (float32 or float64 (M, 1), (1, N))")
    if m * n == 0 or pk == 0:
        out = torch.zeros((m, n), dtype=out_dtype, device=a_hat.device)
    else:
        out = plane_matmul(relayout_interleaved(a_hat, p, "a"),
                           relayout_interleaved(b_hat, p, "b"), mu, nu, p,
                           beta, out_dtype)
    COUNTS.launches_interleaved += 1
    return out
