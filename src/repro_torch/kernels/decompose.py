"""Scheme-I decomposition kernels (``csrc/decompose.cu``): wrappers,
plain versions and launch counts.

* :func:`decompose_interleave_pair` (K2) — one read of B (K, N) gives the
  forward layout (p * Kp, N), scaled by nu, and the K-transposed twin
  (p * Np, K) of B^T, scaled by tau, each interleaved on its contraction
  axis at granularity :data:`TILE`;
* :func:`decompose_interleave_rhs` (K2r) — the forward layout alone;
* :func:`decompose_interleave` (K11) — the lhs layout: one read of A
  (M, K) over mu gives A-hat (M, p * Kp), the slices of each K chunk in
  consecutive column groups (the kernel's lhs form).

Kp and Np are K and N rounded up to :data:`TILE`; the rows past K (and
past N in the twin), and the columns past K of A-hat, hold zero slices.
On a CUDA tensor a wrapper launches the kernel; on a CPU tensor it runs
the plain version, ``scheme1.carve`` then ``scheme1.interleave_k``. The
scales and beta come from the caller, as in the reference; unlike the
reference, which asks for K and M aligned to its blocks and interleaves
at its ``bk``, every shape is taken and the granularity is :data:`TILE`.

The kernel replaces the Pallas kernels ``repro.kernels.decompose.
decompose_interleave_pair``, ``decompose_interleave_rhs`` and
``decompose_interleave``.
"""

from __future__ import annotations

import ctypes
import dataclasses
from functools import lru_cache

import torch
import torch.nn.functional as F

from repro_torch.core import scheme1

# The interleave granularity of both layouts: the tile of csrc/decompose.cu,
# which the interleaved form's relayout (csrc/emugemm1_planes.cu) reads.
TILE = 32
MAX_P = 8
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


@dataclasses.dataclass
class LaunchCounts:
    """Launches of each form, and calls of the plain versions on CUDA
    tensors (which the training path must never make)."""
    launches_pair: int = 0
    launches_rhs: int = 0
    launches_lhs: int = 0
    plain_cuda_calls: int = 0

    def reset(self) -> None:
        self.launches_pair = self.launches_rhs = self.launches_lhs = 0
        self.plain_cuda_calls = 0


COUNTS = LaunchCounts()


def round_up(x: int, mult: int = TILE) -> int:
    return -(-x // mult) * mult


def _interleaved(r: torch.Tensor, p: int, beta: int) -> torch.Tensor:
    """Carve ``r`` (K, N), already scaled, and interleave on K, with the
    rows up to the next TILE as zero slices."""
    k = r.shape[0]
    r = F.pad(r, (0, 0, 0, round_up(k) - k))
    return scheme1.interleave_k(torch.stack(scheme1.carve(r, p, beta)), "b",
                                TILE)


def decompose_rhs_plain(b, nu, p, beta):
    """K2r's function in plain torch ops (CPU or CUDA)."""
    if b.is_cuda:
        COUNTS.plain_cuda_calls += 1
    return _interleaved(scheme1.widen(b) / nu, p, beta)


def decompose_lhs_plain(a, mu, p, beta):
    """K11's function in plain torch ops (CPU or CUDA)."""
    if a.is_cuda:
        COUNTS.plain_cuda_calls += 1
    k = a.shape[1]
    r = F.pad(scheme1.widen(a) / mu, (0, round_up(k) - k))
    return scheme1.interleave_k(torch.stack(scheme1.carve(r, p, beta)), "a",
                                TILE)


def decompose_pair_plain(b, nu, tau, p, beta_f, beta_b):
    """K2's function in plain torch ops (CPU or CUDA)."""
    if b.is_cuda:
        COUNTS.plain_cuda_calls += 1
    w = scheme1.widen(b)
    return (_interleaved(w / nu, p, beta_f),
            _interleaved(w.T / tau, p, beta_b))


@lru_cache(maxsize=None)
def _bind(lib: ctypes.CDLL, lhs: bool = False):
    """The rhs/pair entry point, or with ``lhs`` the lhs form's."""
    if lib.decompose_tile() != TILE:
        raise RuntimeError(f"decompose.cu tiles by {lib.decompose_tile()}, "
                           f"the wrapper expects {TILE}")
    if lhs:
        fn = lib.decompose_interleave_lhs
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                       + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
    else:
        fn = lib.decompose_interleave
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
                       + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check_operand(x, p):
    if x.dim() != 2 or not x.is_cuda:
        raise ValueError(f"decompose: the operand must be a 2-D CUDA tensor, "
                         f"got {tuple(x.shape)} on {x.device}")
    if x.dtype not in _KERNEL_DTYPES:
        raise NotImplementedError(f"decompose takes float32 or bfloat16, got "
                                  f"{x.dtype}")
    if not 1 <= p <= MAX_P:
        raise NotImplementedError(f"decompose is compiled for p in "
                                  f"1..{MAX_P}, got p={p}")


def _launch(b, nu, tau, p, beta_f, beta_b):
    from repro_torch.kernels import build
    _check_operand(b, p)
    k, n = b.shape
    scales = [(nu, (1, n), beta_f)] + ([] if tau is None
                                       else [(tau, (1, k), beta_b)])
    for s, shape, beta in scales:
        if (s.device != b.device or s.dtype != torch.float32
                or tuple(s.shape) != shape):
            raise ValueError(f"decompose: scale {tuple(s.shape)} {s.dtype} "
                             f"on {s.device}, expected float32 {shape}")
        if not 1 <= beta <= 7:
            raise ValueError(f"decompose: beta={beta} outside 1..7")
    nu = nu.contiguous()
    fwd = torch.empty((p * round_up(k), n), dtype=torch.int8, device=b.device)
    twin = None
    if tau is not None:
        tau = tau.contiguous()
        twin = torch.empty((p * round_up(n), k), dtype=torch.int8,
                           device=b.device)
    fn = _bind(build.load("decompose"))
    stream = torch.cuda.current_stream(b.device).cuda_stream
    rc = fn(b.data_ptr(), nu.data_ptr(),
            None if tau is None else tau.data_ptr(), fwd.data_ptr(),
            None if twin is None else twin.data_ptr(), k, n,
            b.stride(0), b.stride(1), int(b.dtype == torch.bfloat16), p,
            beta_f, beta_b if tau is not None else 0, stream)
    if rc != 0:
        raise RuntimeError(f"decompose launch failed (code {rc}) for "
                           f"{(k, n)} p={p}")
    return fwd, twin


def decompose_interleave_rhs(b: torch.Tensor, nu: torch.Tensor, p: int,
                             beta: int) -> torch.Tensor:
    """b (K, N) float, nu (1, N) float32 -> (p * Kp, N) int8.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    or raise.
    """
    if b.device.type == "cpu":
        return decompose_rhs_plain(b, nu, p, beta)
    fwd, _ = _launch(b, nu, None, p, beta, 0)
    COUNTS.launches_rhs += 1
    return fwd


def decompose_interleave_pair(b: torch.Tensor, nu: torch.Tensor,
                              tau: torch.Tensor, p: int, beta_f: int,
                              beta_b: int):
    """b (K, N) float, nu (1, N), tau (1, K) float32 ->
    (forward (p * Kp, N), twin (p * Np, K)) int8, from one read of b.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    or raise.
    """
    if b.device.type == "cpu":
        return decompose_pair_plain(b, nu, tau, p, beta_f, beta_b)
    out = _launch(b, nu, tau, p, beta_f, beta_b)
    COUNTS.launches_pair += 1
    return out


def decompose_interleave(a: torch.Tensor, mu: torch.Tensor, p: int,
                         beta: int) -> torch.Tensor:
    """a (M, K) float, mu (M, 1) float32 -> A-hat (M, p * Kp) int8.

    CPU tensors take the plain version; CUDA tensors launch the kernel's
    lhs form or raise.
    """
    from repro_torch.kernels import build
    if a.device.type == "cpu":
        return decompose_lhs_plain(a, mu, p, beta)
    _check_operand(a, p)
    m, k = a.shape
    if (mu.device != a.device or mu.dtype != torch.float32
            or tuple(mu.shape) != (m, 1)):
        raise ValueError(f"decompose: scale {tuple(mu.shape)} {mu.dtype} on "
                         f"{mu.device}, expected float32 {(m, 1)}")
    if not 1 <= beta <= 7:
        raise ValueError(f"decompose: beta={beta} outside 1..7")
    mu = mu.contiguous()
    out = torch.empty((m, p * round_up(k)), dtype=torch.int8, device=a.device)
    if out.numel() == 0:
        return out
    fn = _bind(build.load("decompose"), lhs=True)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    rc = fn(a.data_ptr(), mu.data_ptr(), out.data_ptr(), m, k, a.stride(0),
            a.stride(1), int(a.dtype == torch.bfloat16), p, beta, stream)
    if rc != 0:
        raise RuntimeError(f"decompose lhs launch failed (code {rc}) for "
                           f"{(m, k)} p={p}")
    COUNTS.launches_lhs += 1
    return out
