"""The fused complex 3M kernels of EmuGEMM-II (``csrc/emugemm3m.cu``):
wrappers, plain versions and launch counts.

* :func:`fused_matmul_3m` (K7g) takes a complex (or real) (M, K) @ (K, N)
  with float32 or float64 parts, the power-of-two scales mu (M, 1) and nu
  (1, N) that the real and imaginary parts share, and returns the complex
  Scheme-II product with parts of ``out_dtype`` (float32 or float64): the
  parts are integerized and carved, with the re-balanced residues of their
  sum, in the prologue, three int8 GEMMs run per modulus, and the 3M
  combination, two CRTs and the scaling by 1 / (mu * nu) run in the
  epilogue. The wrapper reads a complex operand's parts in place from its
  interleaved storage (``torch.view_as_real``) and the kernel writes the
  complex result's storage, so nothing is copied. Its plain version is
  ``repro_torch.core.complex3m.scaled_matmul``.
* :func:`fused_3m_residue_matmul` (K7) takes the (p, 3, M, K) and
  (p, 3, K, N) int8 phase stacks [re, im, re+im] of balanced residues and
  returns (c_re, c_im), each (p, M, N) balanced int8: per modulus the
  three products and their 3M combination. Its plain version is the
  reference's oracle ``repro.kernels.ref.scheme2_3m``, in torch.

On a CUDA tensor a wrapper launches its kernel or raises; on a CPU tensor
it runs the plain version. The kernels replace the Pallas kernels
``repro.kernels.backends.gpu.fused_matmul_3m`` (K7g) and
``repro.kernels.ozaki3m.fused_3m_residue_matmul`` (K7).
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.core import complex3m, scheme2
from repro_torch.kernels.ozaki2 import _INT_P, _crt_args, check_moduli

_PART_DTYPES = (torch.float32, torch.float64)


@dataclasses.dataclass
class LaunchCounts:
    """Launches of each kernel, and calls of the plain versions on CUDA
    tensors (which the library paths must never make)."""
    launches_2d: int = 0
    launches_residues: int = 0
    plain_cuda_calls: int = 0

    def reset(self) -> None:
        self.launches_2d = self.launches_residues = self.plain_cuda_calls = 0


COUNTS = LaunchCounts()


def fused_matmul_3m_plain(a, b, mu, nu, moduli, out_dtype):
    """K7g's function in plain torch ops (CPU or CUDA)."""
    if a.is_cuda:
        COUNTS.plain_cuda_calls += 1
    return complex3m.scaled_matmul(a, b, mu, nu, moduli, out_dtype)


def fused_3m_residue_matmul_plain(a3, b3, moduli):
    """K7's function in plain torch ops (CPU or CUDA): per modulus the
    three residue products, balanced, and their 3M combination."""
    if a3.is_cuda:
        COUNTS.plain_cuda_calls += 1
    c_re, c_im = [], []
    for l, m in enumerate(int(m) for m in moduli):
        t1, t2, t3 = (complex3m._balanced(
            scheme2.residue_gemms(a3[l, t], b3[l, t]), m).to(torch.int32)
            for t in range(3))
        c_re.append(complex3m._balanced(t1 - t2, m))
        c_im.append(complex3m._balanced(t3 - t1 - t2, m))
    return torch.stack(c_re), torch.stack(c_im)


def _bind(lib: ctypes.CDLL):
    fn = lib.emugemm3m
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
                   + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 3
                   + [_INT_P] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _bind_residues(lib: ctypes.CDLL):
    fn = lib.emugemm3m_residues
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                   + [ctypes.c_longlong] * 8 + [ctypes.c_int] + [_INT_P]
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _parts_view(x: torch.Tensor):
    """(real part, imaginary part or None) as strided views of x's own
    storage: a complex tensor's parts interleave, so both share the
    strides of ``view_as_real(x)[..., 0]``."""
    if not x.is_complex():
        return x, None
    r = torch.view_as_real(x.resolve_conj())
    return r[..., 0], r[..., 1]


def fused_matmul_3m(a: torch.Tensor, b: torch.Tensor, mu: torch.Tensor,
                    nu: torch.Tensor, moduli,
                    out_dtype: torch.dtype) -> torch.Tensor:
    """Complex (M, K) @ (K, N), either operand complex or real, with the
    shared scales mu (M, 1) and nu (1, N) -> complex (M, N) with parts of
    ``out_dtype``.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    or raise.
    """
    from repro_torch.kernels import build
    moduli = tuple(int(m) for m in moduli)
    if a.device.type == "cpu":
        return fused_matmul_3m_plain(a, b, mu, nu, moduli, out_dtype)
    ar, ai = _parts_view(a)
    br, bi = _parts_view(b)
    xs = (a, b, mu, nu)
    if not all(x.is_cuda for x in xs) or len({x.device for x in xs}) != 1:
        raise ValueError("emugemm3m: all operands must be CUDA tensors on "
                         "one device")
    if (ar.dtype not in _PART_DTYPES or br.dtype != ar.dtype
            or mu.dtype != ar.dtype or nu.dtype != ar.dtype
            or out_dtype not in _PART_DTYPES):
        raise NotImplementedError(
            f"emugemm3m takes operands whose parts are both float32 or both "
            f"float64, scales in that type and a float32 or float64 output; "
            f"got {a.dtype} @ {b.dtype}, mu {mu.dtype}, nu {nu.dtype} -> "
            f"{out_dtype}")
    check_moduli(moduli)
    if ar.dim() != 2 or br.dim() != 2:
        raise ValueError(f"emugemm3m is 2-D; got {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    m, k = ar.shape
    n = br.shape[-1]
    if br.shape[0] != k or mu.shape != (m, 1) or nu.shape != (1, n):
        raise ValueError(f"emugemm3m: shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}, mu {tuple(mu.shape)}, nu "
                         f"{tuple(nu.shape)}")
    cplx = torch.complex128 if out_dtype == torch.float64 else torch.complex64
    out = torch.empty((m, n), dtype=cplx, device=a.device)
    if out.numel() == 0 or k == 0:
        return out.zero_()
    mu, nu = mu.contiguous(), nu.contiguous()
    fn = _bind(build.load("emugemm3m"))
    mods, inv = _crt_args(moduli)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    rc = fn(ar.data_ptr(), ai.data_ptr() if ai is not None else None,
            br.data_ptr(), bi.data_ptr() if bi is not None else None,
            mu.data_ptr(), nu.data_ptr(), torch.view_as_real(out).data_ptr(),
            m, n, k, ar.stride(0), ar.stride(1), br.stride(0), br.stride(1),
            int(ar.dtype == torch.float64), int(out_dtype == torch.float64),
            len(moduli), mods, inv, stream)
    if rc != 0:
        raise RuntimeError(f"emugemm3m launch failed (code {rc}) for "
                           f"{(m, k, n)} moduli={moduli}")
    COUNTS.launches_2d += 1
    return out


def fused_3m_residue_matmul(a3: torch.Tensor, b3: torch.Tensor, moduli):
    """(p, 3, M, K) @ (p, 3, K, N) int8 phase stacks [re, im, re+im] ->
    (c_re, c_im), each (p, M, N) balanced int8.

    CPU tensors take the plain version; CUDA tensors launch the kernel's
    residue form or raise.
    """
    from repro_torch.kernels import build
    moduli = tuple(int(m) for m in moduli)
    if a3.device.type == "cpu":
        return fused_3m_residue_matmul_plain(a3, b3, moduli)
    p, three, m, k = a3.shape
    n = b3.shape[-1]
    if (three != 3 or b3.dim() != 4 or b3.shape[:3] != (p, 3, k)
            or p != len(moduli) or a3.dtype != torch.int8
            or b3.dtype != torch.int8 or not b3.is_cuda
            or b3.device != a3.device):
        raise ValueError(f"emugemm3m residues: {tuple(a3.shape)} {a3.dtype}"
                         f" @ {tuple(b3.shape)} {b3.dtype} on {b3.device}, "
                         f"{len(moduli)} moduli")
    check_moduli(moduli)
    c_re = torch.empty((p, m, n), dtype=torch.int8, device=a3.device)
    c_im = torch.empty_like(c_re)
    if c_re.numel() == 0 or k == 0:
        return c_re.zero_(), c_im.zero_()
    fn = _bind_residues(build.load("emugemm3m"))
    mods, _ = _crt_args(moduli)
    stream = torch.cuda.current_stream(a3.device).cuda_stream
    rc = fn(a3.data_ptr(), b3.data_ptr(), c_re.data_ptr(), c_im.data_ptr(),
            m, n, k, *a3.stride(), *b3.stride(), p, mods, stream)
    if rc != 0:
        raise RuntimeError(f"emugemm3m residue launch failed (code {rc}) for "
                           f"{(p, m, k, n)}")
    COUNTS.launches_residues += 1
    return c_re, c_im
