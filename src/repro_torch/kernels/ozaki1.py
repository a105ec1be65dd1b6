"""The fused EmuGEMM-I kernel (``csrc/emugemm1.cu``): wrappers, plain
versions and launch counts.

``fused_matmul_scheme1`` takes (M, K) @ (K, N) or, strided over a batch,
(B, M, K) @ (B, K, N) operands in float32 or bfloat16 with their
power-of-two scales mu (..., M, 1) and nu (..., 1, N), and returns the
Scheme-I product in ``out_dtype``. On a CUDA tensor it launches the
kernel; on a CPU tensor it runs the plain version, which is
``repro_torch.core.scheme1`` — the same slicing, exact integer slice
products and shift-reduce, as separate torch ops.

``fused_matmul_mixed`` is the kernel's third launch form: the lhs is
carved in the kernel as above, and the rhs is a prepared weight, the p
int8 planes interleaved on K at granularity ``decompose.TILE`` (the
kernel's K tile) that ``repro_torch.kernels.decompose`` writes. Its plain
version deinterleaves them and runs the same slice products and
shift-reduce.

``fused_matmul_interleaved`` is the fourth launch form: both operands
are already sliced and interleaved at ``decompose.TILE`` (A-hat
(M, p * Kp) from ``decompose.decompose_interleave``, B-hat (p * Kp, N)
from ``decompose.decompose_interleave_rhs`` or ``scheme1.interleave_k``),
so the kernel carves nothing and applies mu and nu in the epilogue
only. Its plain version deinterleaves both and runs the slice products
and shift-reduce, as the reference's oracle ``ref.scheme1_interleaved``.
Unlike the reference, which needs M, N and K aligned to its blocks and
interleaves at its ``bk``, M and N are taken as they are and the
granularity is the kernel's K tile (the bits are the same at any
granularity).

The kernel replaces the Pallas kernels ``repro.kernels.ozaki1.
fused_matmul_prologue`` and ``repro.kernels.backends.gpu.
fused_matmul_scheme1`` (2-D launch), ``fused_matmul_scheme1_batched``
(batched launch), ``repro.kernels.ozaki1.fused_matmul_mixed`` (mixed
launch) and ``fused_matmul_interleaved`` (interleaved launch).
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.core import scheme1

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
MAX_P = 8


@dataclasses.dataclass
class LaunchCounts:
    """Launches of the kernel in each form, and calls of the plain
    version on CUDA tensors (which the serving path must never make)."""
    launches_2d: int = 0
    launches_batched: int = 0
    launches_mixed: int = 0
    launches_interleaved: int = 0
    plain_cuda_calls: int = 0

    def reset(self) -> None:
        self.launches_2d = self.launches_batched = self.launches_mixed = 0
        self.launches_interleaved = self.plain_cuda_calls = 0


COUNTS = LaunchCounts()


def fused_matmul_plain(a: torch.Tensor, b: torch.Tensor, mu: torch.Tensor,
                       nu: torch.Tensor, p: int, beta: int,
                       out_dtype: torch.dtype) -> torch.Tensor:
    """The kernel's function in plain torch ops (CPU or CUDA)."""
    if a.is_cuda:
        COUNTS.plain_cuda_calls += 1
    a_sl = scheme1.carve(scheme1.widen(a) / mu, p, beta)
    b_sl = scheme1.carve(scheme1.widen(b) / nu, p, beta)
    accs = scheme1.triangular_accumulators(a_sl, b_sl, p)
    return scheme1.shift_reduce(accs, beta, mu, nu, out_dtype)


def fused_matmul_mixed_plain(a: torch.Tensor, b_hat: torch.Tensor,
                             mu: torch.Tensor, nu: torch.Tensor, p: int,
                             beta: int, out_dtype: torch.dtype
                             ) -> torch.Tensor:
    """The mixed form's function in plain torch ops (CPU or CUDA)."""
    from repro_torch.kernels.decompose import TILE
    if a.is_cuda:
        COUNTS.plain_cuda_calls += 1
    k = a.shape[-1]
    b_sl = scheme1.deinterleave_k(b_hat, p, "b", TILE)[:, :k]
    a_sl = scheme1.carve(scheme1.widen(a) / mu, p, beta)
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


def _bind(lib: ctypes.CDLL):
    fn = lib.emugemm1
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 6 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _bind_prepared(lib: ctypes.CDLL, interleaved: bool = False):
    """The mixed form's entry point, or with ``interleaved`` the
    interleaved form's; both read planes interleaved at the K tile."""
    from repro_torch.kernels.decompose import TILE
    if lib.emugemm1_bk() != TILE:
        raise RuntimeError(f"emugemm1.cu's K tile is {lib.emugemm1_bk()}, "
                           f"the prepared layout interleaves at {TILE}")
    if interleaved:
        fn = lib.emugemm1_interleaved
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                       + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
    else:
        fn = lib.emugemm1_mixed
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                       + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(a, b, mu, nu, p, beta, out_dtype):
    if not (a.is_cuda and b.is_cuda and mu.is_cuda and nu.is_cuda):
        raise ValueError("emugemm1: all operands must be CUDA tensors")
    if len({a.device, b.device, mu.device, nu.device}) != 1:
        raise ValueError("emugemm1: operands on different devices")
    if a.dtype not in _KERNEL_DTYPES or b.dtype != a.dtype:
        raise NotImplementedError(
            f"emugemm1 takes float32 or bfloat16 operands of one type, got "
            f"{a.dtype} @ {b.dtype} (float64 is not on this slice's path; "
            "ROADMAP.md § 1)")
    if out_dtype not in _KERNEL_DTYPES:
        raise NotImplementedError(f"emugemm1: out_dtype {out_dtype}")
    if mu.dtype != torch.float32 or nu.dtype != torch.float32:
        raise ValueError("emugemm1: scales must be float32")
    if not 1 <= p <= MAX_P:
        raise NotImplementedError(f"emugemm1 is compiled for p in 1..{MAX_P}, "
                                  f"got p={p}")
    if not 1 <= beta <= 7:
        raise ValueError(f"emugemm1: beta={beta} outside 1..7")


def _launch(a3, b3, mu3, nu3, p, beta, out_dtype):
    from repro_torch.kernels import build
    batch, m, k = a3.shape
    n = b3.shape[-1]
    if b3.shape[:2] != (batch, k) or mu3.shape != (batch, m, 1) \
            or nu3.shape != (batch, 1, n):
        raise ValueError(f"emugemm1: shapes {tuple(a3.shape)} @ "
                         f"{tuple(b3.shape)}, mu {tuple(mu3.shape)}, "
                         f"nu {tuple(nu3.shape)}")
    mu3, nu3 = mu3.contiguous(), nu3.contiguous()
    out = torch.empty((batch, m, n), dtype=out_dtype, device=a3.device)
    if out.numel() == 0 or k == 0:
        return out.zero_()
    fn = _bind(build.load("emugemm1"))
    stream = torch.cuda.current_stream(a3.device).cuda_stream
    rc = fn(a3.data_ptr(), b3.data_ptr(), mu3.data_ptr(), nu3.data_ptr(),
            out.data_ptr(), batch, m, n, k,
            a3.stride(0), a3.stride(1), a3.stride(2),
            b3.stride(0), b3.stride(1), b3.stride(2),
            int(a3.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
            p, beta, stream)
    if rc != 0:
        raise RuntimeError(f"emugemm1 launch failed (code {rc}) for "
                           f"{(batch, m, k, n)} p={p}")
    return out


def fused_matmul_scheme1(a: torch.Tensor, b: torch.Tensor, mu: torch.Tensor,
                         nu: torch.Tensor, p: int, beta: int,
                         out_dtype: torch.dtype) -> torch.Tensor:
    """(M, K) @ (K, N) with scales (M, 1) / (1, N) -> (M, N), or the
    strided-batched (B, M, K) @ (B, K, N) -> (B, M, N) form.

    CPU tensors take the plain version; CUDA tensors launch the
    kernel or raise.
    """
    if a.device.type == "cpu":
        return fused_matmul_plain(a, b, mu, nu, p, beta, out_dtype)
    _check(a, b, mu, nu, p, beta, out_dtype)
    if a.dim() == 2 and b.dim() == 2:
        out = _launch(a[None], b[None], mu[None], nu[None], p, beta,
                      out_dtype)[0]
        COUNTS.launches_2d += 1
        return out
    if a.dim() == 3 and b.dim() == 3:
        out = _launch(a, b, mu, nu, p, beta, out_dtype)
        COUNTS.launches_batched += 1
        return out
    raise ValueError(f"emugemm1: operands must both be 2-D or both 3-D, got "
                     f"{tuple(a.shape)} @ {tuple(b.shape)}")


def fused_matmul_mixed(a: torch.Tensor, b_hat: torch.Tensor,
                       mu: torch.Tensor, nu: torch.Tensor, p: int, beta: int,
                       out_dtype: torch.dtype) -> torch.Tensor:
    """(M, K) float @ prepared (p * Kp, N) int8 planes, with scales
    mu (M, 1) and nu (1, N) -> (M, N) ``out_dtype``.

    ``b_hat`` is interleaved on K at granularity ``decompose.TILE``
    with Kp = K rounded up to it. CPU tensors take the plain version;
    CUDA tensors launch the kernel's mixed form or raise.
    """
    from repro_torch.kernels import build
    from repro_torch.kernels.decompose import round_up
    if a.device.type == "cpu":
        return fused_matmul_mixed_plain(a, b_hat, mu, nu, p, beta, out_dtype)
    _check(a, a, mu, nu, p, beta, out_dtype)
    m, k = a.shape
    n = b_hat.shape[-1]
    if (b_hat.dim() != 2 or b_hat.dtype != torch.int8
            or b_hat.device != a.device or not b_hat.is_contiguous()
            or b_hat.shape[0] != p * round_up(k)
            or mu.shape != (m, 1) or nu.shape != (1, n)):
        raise ValueError(f"emugemm1 mixed: a {tuple(a.shape)}, prepared "
                         f"{tuple(b_hat.shape)} {b_hat.dtype} (expected a "
                         f"contiguous int8 ({p} * {round_up(k)}, N)), mu "
                         f"{tuple(mu.shape)}, nu {tuple(nu.shape)}")
    mu, nu = mu.contiguous(), nu.contiguous()
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if out.numel() == 0 or k == 0:
        return out.zero_()
    fn = _bind_prepared(build.load("emugemm1"))
    stream = torch.cuda.current_stream(a.device).cuda_stream
    rc = fn(a.data_ptr(), b_hat.data_ptr(), mu.data_ptr(), nu.data_ptr(),
            out.data_ptr(), m, n, k, a.stride(0), a.stride(1),
            b_hat.stride(0), int(a.dtype == torch.bfloat16),
            int(out_dtype == torch.bfloat16), p, beta, stream)
    if rc != 0:
        raise RuntimeError(f"emugemm1 mixed launch failed (code {rc}) for "
                           f"{(m, k, n)} p={p}")
    COUNTS.launches_mixed += 1
    return out


def fused_matmul_interleaved(a_hat: torch.Tensor, b_hat: torch.Tensor,
                             mu: torch.Tensor, nu: torch.Tensor, p: int,
                             beta: int, out_dtype: torch.dtype = torch.float32
                             ) -> torch.Tensor:
    """A-hat (M, p * Kp) int8 @ B-hat (p * Kp, N) int8, both interleaved on
    K at granularity ``decompose.TILE``, with scales mu (M, 1) and nu
    (1, N) -> (M, N) ``out_dtype``.

    CPU tensors take the plain version; CUDA tensors launch the kernel's
    interleaved form or raise.
    """
    from repro_torch.kernels import build
    from repro_torch.kernels.decompose import TILE
    if a_hat.device.type == "cpu":
        return fused_matmul_interleaved_plain(a_hat, b_hat, mu, nu, p, beta,
                                              out_dtype)
    if not (a_hat.is_cuda and b_hat.is_cuda and mu.is_cuda and nu.is_cuda):
        raise ValueError("emugemm1: all operands must be CUDA tensors")
    if len({a_hat.device, b_hat.device, mu.device, nu.device}) != 1:
        raise ValueError("emugemm1: operands on different devices")
    if out_dtype not in _KERNEL_DTYPES:
        raise NotImplementedError(f"emugemm1: out_dtype {out_dtype}")
    if not 1 <= p <= MAX_P:
        raise NotImplementedError(f"emugemm1 is compiled for p in 1..{MAX_P}, "
                                  f"got p={p}")
    if not 1 <= beta <= 7:
        raise ValueError(f"emugemm1: beta={beta} outside 1..7")
    if a_hat.dim() != 2 or b_hat.dim() != 2:
        raise ValueError(f"emugemm1 interleaved: A-hat {tuple(a_hat.shape)} "
                         f"and B-hat {tuple(b_hat.shape)} must be 2-D")
    (m, pk), n = a_hat.shape, b_hat.shape[1]
    if (a_hat.dtype != torch.int8
            or b_hat.dtype != torch.int8 or b_hat.shape[0] != pk
            or pk % (p * TILE) or not a_hat.is_contiguous()
            or not b_hat.is_contiguous() or mu.dtype != torch.float32
            or nu.dtype != torch.float32 or tuple(mu.shape) != (m, 1)
            or tuple(nu.shape) != (1, n)):
        raise ValueError(
            f"emugemm1 interleaved: A-hat {tuple(a_hat.shape)} {a_hat.dtype}, "
            f"B-hat {tuple(b_hat.shape)} {b_hat.dtype} (expected contiguous "
            f"int8 (M, {p} * Kp) and ({p} * Kp, N), Kp a multiple of {TILE}),"
            f" mu {tuple(mu.shape)} {mu.dtype}, nu {tuple(nu.shape)} "
            f"{nu.dtype} (float32 (M, 1), (1, N))")
    mu, nu = mu.contiguous(), nu.contiguous()
    out = torch.empty((m, n), dtype=out_dtype, device=a_hat.device)
    if out.numel() == 0 or pk == 0:
        return out.zero_()
    fn = _bind_prepared(build.load("emugemm1"), interleaved=True)
    stream = torch.cuda.current_stream(a_hat.device).cuda_stream
    rc = fn(a_hat.data_ptr(), b_hat.data_ptr(), mu.data_ptr(), nu.data_ptr(),
            out.data_ptr(), m, n, pk // p, a_hat.stride(0), b_hat.stride(0),
            int(out_dtype == torch.bfloat16), p, beta, stream)
    if rc != 0:
        raise RuntimeError(f"emugemm1 interleaved launch failed (code {rc}) "
                           f"for {(m, pk // p, n)} p={p}")
    COUNTS.launches_interleaved += 1
    return out
