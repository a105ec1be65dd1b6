"""The plain tiled int8 GEMM (``csrc/matmul_int8.cu``): wrapper, plain
version and launch count.

:func:`int8_matmul` is (M, K) int8 @ (K, N) int8 -> (M, N) int32, exact,
the int32 sums wrapping as the reference's do: the "native INT8" baseline
that a naive emulation composes p(p+1)/2 launches of (paper Fig. 4). On a
CUDA tensor it launches the kernel; on a CPU tensor it runs the plain
version, a float64 product (every partial sum an integer below 2^53, so
exact in any order) cast to int64 and wrapped to int32. ``torch._int_mm``
is a library call, used nowhere here.

The kernel replaces the Pallas kernel ``repro.kernels.matmul_int8.
int8_matmul``. Unlike the reference, which asks for shapes aligned to its
blocks (128 on the TPU), M, N and K are taken as they are, and the tiles
are the kernel's own.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch


@dataclasses.dataclass
class LaunchCounts:
    """Launches of the kernel, and calls of the plain version on CUDA
    tensors."""
    launches: int = 0
    plain_cuda_calls: int = 0

    def reset(self) -> None:
        self.launches = self.plain_cuda_calls = 0


COUNTS = LaunchCounts()


def int8_matmul_plain(a8: torch.Tensor, b8: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain torch ops (CPU or CUDA)."""
    if a8.is_cuda:
        COUNTS.plain_cuda_calls += 1
    prod = a8.to(torch.float64) @ b8.to(torch.float64)
    return prod.to(torch.int64).to(torch.int32)


def int8_matmul(a8: torch.Tensor, b8: torch.Tensor,
                blocks=None) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32, exact.

    ``blocks`` is the reference's tile choice; the kernel has one tile
    of its own, so only None is taken. CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise.
    """
    from repro_torch.kernels import build
    if blocks is not None:
        raise ValueError(f"int8_matmul: the kernel has one fixed tile and "
                         f"takes blocks=None, got {blocks}")
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
    a8 = a8 if a8.stride(1) == 1 else a8.contiguous()
    b8 = b8 if b8.stride(1) == 1 else b8.contiguous()
    (m, k), n = a8.shape, b8.shape[1]
    out = torch.empty((m, n), dtype=torch.int32, device=a8.device)
    if out.numel() == 0:
        return out
    if k == 0:
        return out.zero_()
    fn = build.load("matmul_int8").int8_matmul
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                   + [ctypes.c_longlong] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(a8.device).cuda_stream
    rc = fn(a8.data_ptr(), b8.data_ptr(), out.data_ptr(), m, n, k,
            a8.stride(0), b8.stride(0), stream)
    if rc != 0:
        raise RuntimeError(f"int8_matmul launch failed (code {rc}) for "
                           f"{(m, k, n)}")
    COUNTS.launches += 1
    return out
