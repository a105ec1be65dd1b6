"""The int8 GEMM (K9) on EmuGEMM-I's plane GEMM: wrapper, plain versions
and launch counts.

:func:`int8_matmul` is (M, K) int8 @ (K, N) int8 -> (M, N) int32, exact,
the int32 sums wrapping as the reference's do: the "native INT8" baseline
that a naive emulation composes p(p+1)/2 launches of (paper Fig. 4). On a
CPU tensor it runs the plain version, a float64 product (every partial sum
an integer below 2^53, so exact in any order) cast to int64 and wrapped to
int32. ``torch._int_mm`` is a library call, used nowhere here.

On CUDA tensors it is the plane GEMM of ``csrc/emugemm1_planes.cu`` at
p = 1 with an int32 output (``emugemm1_int8``: a TMA-fed int8 wgmma GEMM
whose epilogue stores the raw accumulator), A and B^T each a single
K-contiguous plane. An operand whose rows are K-contiguous with a 16-byte
aligned base and row stride is read in place (:func:`tma_ld`); otherwise
one relayout (``ozaki1.launch_relayout`` at p = 1, with the operand's K as
its logical K) writes its (1, R, Kpp) plane first: B (K, N) row-major
always, A only where it is misaligned or arrives transposed. B passed as
the transposed view of a K-contiguous (N, K) buffer is read in place. The
plain versions of the route's pieces are ``ozaki1.
relayout_interleaved_plain`` at p = 1 and :func:`int8_planes_plain`.

The kernel replaces the Pallas kernel ``repro.kernels.matmul_int8.
int8_matmul``. Unlike the reference, which asks for shapes aligned to its
blocks (128 on the TPU), M, N and K are taken as they are, and the tiles
are the plane GEMM's own.
"""

from __future__ import annotations

import ctypes
import dataclasses
from functools import lru_cache

import torch

from repro_torch.kernels import ozaki1


@dataclasses.dataclass
class LaunchCounts:
    """Launches of the int8 plane GEMM (one a call), of the relayouts
    that write an operand's plane first, and calls of the plain versions
    on CUDA tensors."""
    launches: int = 0
    launches_relayout: int = 0
    plain_cuda_calls: int = 0

    def reset(self) -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, 0)


COUNTS = LaunchCounts()


def int8_matmul_plain(a8: torch.Tensor, b8: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain torch ops (CPU or CUDA)."""
    if a8.is_cuda:
        COUNTS.plain_cuda_calls += 1
    prod = a8.to(torch.float64) @ b8.to(torch.float64)
    return prod.to(torch.int64).to(torch.int32)


def int8_planes_plain(a_planes: torch.Tensor,
                      b_planes: torch.Tensor) -> torch.Tensor:
    """The plane GEMM's int32 instance in plain torch ops (CPU or CUDA):
    the single planes (1, M, Kp) of A and (1, N, Kp) of B^T (zeros past K
    add nothing) -> (M, N) int32, wrapped."""
    if a_planes.is_cuda:
        COUNTS.plain_cuda_calls += 1
    prod = a_planes[0].to(torch.float64) @ b_planes[0].to(torch.float64).T
    return prod.to(torch.int64).to(torch.int32)


def tma_ld(x: torch.Tensor) -> int | None:
    """The row stride (bytes) with which the plane GEMM's tensor map reads
    the (R, K) int8 view ``x`` in place, or None where a relayout has to
    write its plane first: the rows K-contiguous, the base and the row
    stride 16-byte aligned (any stride serves a single row)."""
    r, k = x.shape
    if k > 1 and x.stride(1) != 1:
        return None
    ld = x.stride(0) if r > 1 else -(-k // 16) * 16
    if ld < k or ld % 16 or x.data_ptr() % 16:
        return None
    return ld


def operand_plane(x: torch.Tensor) -> tuple[torch.Tensor, int, int]:
    """The (R, K) int8 CUDA view ``x`` (A, or B^T) as the plane GEMM reads
    it: (tensor, row stride in bytes, relayouts launched). In place where
    :func:`tma_ld` allows; else one relayout at p = 1 into a (1, R, Kpp)
    plane, of ``x``'s K-contiguous rows or, where R is the unit-stride
    axis, of ``x.T`` transposed; other strides are copied contiguous
    first."""
    ld = tma_ld(x)
    if ld is not None:
        return x, ld, 0
    r, k = x.shape
    if x.stride(1) == 1 or k == 1:
        plane = ozaki1.launch_relayout(x, 1, "a")[0]
    elif x.stride(0) == 1 or r == 1:
        if r > 65535 * ozaki1.PLANE_K:        # the relayout's grid.y
            raise ValueError(f"int8_matmul: {r} rows past the relayout's "
                             "grid")
        plane = ozaki1.launch_relayout(x.T, 1, "b")[0]
    else:
        return operand_plane(x.contiguous())
    return plane, plane.shape[-1], 1


@lru_cache(maxsize=None)
def _bind(lib: ctypes.CDLL):
    fn = lib.emugemm1_int8
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                   + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def tile(m: int) -> tuple[int, int]:
    """The plane GEMM's output tile for M rows: (64, 128) for M <= 64,
    else (128, 256)."""
    return (64, 128) if m <= 64 else (128, 256)


def launch(a: torch.Tensor, lda: int, bt: torch.Tensor, ldb: int, k: int,
           out: torch.Tensor, epilogue: bool = True,
           tile_mn: tuple[int, int] | None = None) -> torch.Tensor:
    """Launch the int8 plane GEMM on A (M, K) and B^T (N, K) as
    :func:`operand_plane` gives them, into ``out`` (M, N) int32;
    ``epilogue=False`` stops after the mainloop, which leaves ``out``
    unwritten (for timing the two apart); ``tile_mn`` sets the output
    tile instead of :func:`tile`, (128, 256) or (64, 128) (for timing
    the tiles apart)."""
    from repro_torch.kernels import build
    m, n = out.shape
    rc = _bind(build.load("emugemm1_planes"))(
        a.data_ptr(), bt.data_ptr(), out.data_ptr(), m, n, k, lda, ldb,
        *(tile_mn or tile(m)), int(epilogue),
        torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"int8_matmul launch failed (code {rc}) for "
                           f"{(m, k, n)}")
    return out


def int8_matmul(a8: torch.Tensor, b8: torch.Tensor,
                blocks=None) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32, exact.

    ``blocks`` is the reference's tile choice; the kernel has the plane
    GEMM's tiles, so only None is taken. CPU tensors take the plain
    version; CUDA tensors launch the route (a relayout of each operand
    that the tensor map cannot read in place, and one plane GEMM) or
    raise.
    """
    if blocks is not None:
        raise ValueError(f"int8_matmul: the kernel has the plane GEMM's "
                         f"tiles and takes blocks=None, got {blocks}")
    if (a8.dim() != 2 or b8.dim() != 2 or a8.dtype != torch.int8
            or b8.dtype != torch.int8 or a8.shape[1] != b8.shape[0]):
        raise ValueError(f"int8_matmul: {tuple(a8.shape)} {a8.dtype} @ "
                         f"{tuple(b8.shape)} {b8.dtype}, expected int8 "
                         "(M, K) @ (K, N)")
    if a8.device.type == "cpu":
        return int8_matmul_plain(a8, b8)
    if not (a8.is_cuda and b8.is_cuda) or a8.device != b8.device:
        raise ValueError("int8_matmul: both operands must be on one CUDA "
                         "device")
    (m, k), n = a8.shape, b8.shape[1]
    out = torch.empty((m, n), dtype=torch.int32, device=a8.device)
    if out.numel() == 0:
        return out
    if k == 0:
        return out.zero_()
    a, lda, ra = operand_plane(a8)
    bt, ldb, rb = operand_plane(b8.T)
    launch(a, lda, bt, ldb, k, out)
    COUNTS.launches += 1
    COUNTS.launches_relayout += ra + rb
    return out

