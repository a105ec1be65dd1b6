"""The complex 3M kernels of EmuGEMM-II (the plane route of
``csrc/emugemm2_planes.cu`` for K7g, ``csrc/emugemm3m.cu`` for K7):
wrappers, plain versions and launch counts.

* :func:`fused_matmul_3m` (K7g) takes a complex (or real) (M, K) @ (K, N),
  or a batch of them, (Bt, M, K) @ (Bt, K, N), with float32 or float64
  parts, the power-of-two scales mu ([Bt,] M, 1) and nu ([Bt,] 1, N) that
  the real and imaginary parts share, and returns the complex Scheme-II
  product with parts of ``out_dtype`` (float32 or float64). It runs the
  plane route of ``csrc/emugemm2_planes.cu``, the batch as its batch
  coordinate: two launches of :func:`encode_planes_3m`, which integerizes
  each operand once and writes the phase residues [re, im, bal(re + im)]
  of every modulus as K-contiguous int8 planes (p, 3, [Bt,] R, Kp) (B as
  B^T), and one of
  :func:`plane_matmul_3m`, three TMA-fed wgmma int8 GEMMs per modulus,
  each reduced and combined into C_re and C_im mod m, with the two CRTs
  and the scaling by 1 / (mu * nu) in its epilogue. The encode reads a
  complex operand's parts in place from its interleaved storage
  (``torch.view_as_real``) and the GEMM writes the complex result's
  storage. Its plain version is ``repro_torch.core.complex3m.
  scaled_matmul``, which :func:`encode_planes_3m_plain` and
  :func:`plane_matmul_3m_plain` compose.
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
from repro_torch.kernels.ozaki2 import (MAX_BATCH, PLANE_K, _INT_P,
                                        _crt_args, check_moduli,
                                        launch_encode, launch_planes, plane_k)

_PART_DTYPES = (torch.float32, torch.float64)


@dataclasses.dataclass
class LaunchCounts:
    """Launches of each kernel, and calls of the plain versions on CUDA
    tensors (which the library paths must never make)."""
    launches_encode: int = 0
    launches_planes: int = 0
    launches_residues: int = 0
    plain_cuda_calls: int = 0

    def reset(self) -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, 0)


COUNTS = LaunchCounts()


def fused_matmul_3m_plain(a, b, mu, nu, moduli, out_dtype):
    """K7g's function in plain torch ops (CPU or CUDA)."""
    if a.is_cuda:
        COUNTS.plain_cuda_calls += 1
    return complex3m.scaled_matmul(a, b, mu, nu, moduli, out_dtype)


def encode_planes_3m_plain(x, scale, moduli):
    """The 3M encode's function in plain torch ops (CPU or CUDA): the
    phase residues (p, 3, [Bt,] R, Kp) of an ([Bt,] R, K) operand, complex
    or real, with its row scales ([Bt,] R, 1), padded with zero residues
    along K."""
    if x.is_cuda:
        COUNTS.plain_cuda_calls += 1
    k = x.shape[-1]
    return torch.nn.functional.pad(
        complex3m.phase_residues(x, scale, moduli), (0, plane_k(k) - k))


def plane_matmul_3m_plain(a3, b3, mu, nu, moduli, out_dtype):
    """The 3M plane GEMM's function in plain torch ops (CPU or CUDA): the
    phase planes (p, 3, [Bt,] M, Kp) of A and (p, 3, [Bt,] N, Kp) of B^T,
    the three products per modulus and their combination, the CRTs, then
    * 1 / (mu * nu)."""
    if a3.is_cuda:
        COUNTS.plain_cuda_calls += 1
    return complex3m.residue_matmul(a3, b3.transpose(-1, -2), mu, nu, moduli,
                                    out_dtype)


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


def encode_planes_3m(x: torch.Tensor, scale: torch.Tensor,
                     moduli) -> torch.Tensor:
    """An ([Bt,] R, K) operand, complex or real, with float32 or float64
    parts and its row scales ([Bt,] R, 1) in the part type -> its
    (p, 3, [Bt,] R, Kp) int8 phase planes (B enters as B^T with nu^T).

    CPU tensors take the plain version; CUDA tensors launch the encode
    kernel or raise.
    """
    moduli = tuple(int(m) for m in moduli)
    if x.device.type == "cpu":
        return encode_planes_3m_plain(x, scale, moduli)
    xr, xi = _parts_view(x)
    if (xr.dim() not in (2, 3) or xr.dtype not in _PART_DTYPES
            or not x.is_cuda or scale.dtype != xr.dtype
            or scale.shape != (*xr.shape[:-1], 1)
            or scale.device != x.device or xr.shape[-1] == 0
            or (xr.dim() == 3 and not 0 < xr.shape[0] <= MAX_BATCH)):
        raise ValueError(f"emugemm2 3M encode: {tuple(x.shape)} {x.dtype} "
                         f"on {x.device}, scale {tuple(scale.shape)} "
                         f"{scale.dtype}")
    check_moduli(moduli)
    planes = launch_encode(xr, xi, scale, moduli, 3)
    COUNTS.launches_encode += 1
    return planes


def plane_matmul_3m(a3: torch.Tensor, b3: torch.Tensor, mu: torch.Tensor,
                    nu: torch.Tensor, moduli,
                    out_dtype: torch.dtype) -> torch.Tensor:
    """The phase planes (p, 3, [Bt,] M, Kp) of A and (p, 3, [Bt,] N, Kp)
    of B^T with scales mu ([Bt,] M, 1) and nu ([Bt,] 1, N) in the part
    type -> complex ([Bt,] M, N) with parts of ``out_dtype`` (float32 or
    float64).

    CPU tensors take the plain version; CUDA tensors launch the plane
    GEMM or raise.
    """
    moduli = tuple(int(m) for m in moduli)
    if a3.device.type == "cpu":
        return plane_matmul_3m_plain(a3, b3, mu, nu, moduli, out_dtype)
    p, three, *lead, m, kp = a3.shape
    n = b3.shape[-2]
    if (three != 3 or len(lead) > 1 or b3.shape != (p, 3, *lead, n, kp)
            or p != len(moduli) or kp % PLANE_K or not a3.is_contiguous()
            or not b3.is_contiguous() or {a3.dtype, b3.dtype} != {torch.int8}
            or mu.shape != (*lead, m, 1) or nu.shape != (*lead, 1, n)
            or mu.dtype not in _PART_DTYPES or nu.dtype != mu.dtype
            or out_dtype not in _PART_DTYPES
            or len({x.device for x in (a3, b3, mu, nu)}) != 1):
        raise ValueError(f"emugemm2 3M plane GEMM: {tuple(a3.shape)} @ "
                         f"{tuple(b3.shape)}, mu {tuple(mu.shape)} "
                         f"{mu.dtype}, nu {tuple(nu.shape)} {nu.dtype}, "
                         f"{len(moduli)} moduli -> {out_dtype}")
    check_moduli(moduli)
    cplx = torch.complex128 if out_dtype == torch.float64 else torch.complex64
    out = torch.empty((*lead, m, n), dtype=cplx, device=a3.device)
    launch_planes(a3, b3, mu, nu, moduli, out)
    COUNTS.launches_planes += 1
    return out


def fused_matmul_3m(a: torch.Tensor, b: torch.Tensor, mu: torch.Tensor,
                    nu: torch.Tensor, moduli,
                    out_dtype: torch.dtype) -> torch.Tensor:
    """Complex ([Bt,] M, K) @ ([Bt,] K, N), either operand complex or
    real, with the shared scales mu ([Bt,] M, 1) and nu ([Bt,] 1, N) ->
    complex ([Bt,] M, N) with parts of ``out_dtype``.

    CPU tensors take the plain version; CUDA tensors launch the plane
    route or raise.
    """
    moduli = tuple(int(m) for m in moduli)
    if a.device.type == "cpu":
        return fused_matmul_3m_plain(a, b, mu, nu, moduli, out_dtype)
    ar, _ = _parts_view(a)
    br, _ = _parts_view(b)
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
    if ar.dim() != br.dim() or ar.dim() not in (2, 3):
        raise ValueError(f"emugemm3m is 2-D or batched 3-D; got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    *lead, m, k = ar.shape
    n = br.shape[-1]
    if (br.shape != (*lead, k, n) or mu.shape != (*lead, m, 1)
            or nu.shape != (*lead, 1, n)):
        raise ValueError(f"emugemm3m: shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}, mu {tuple(mu.shape)}, nu "
                         f"{tuple(nu.shape)}")
    if m * n == 0 or k == 0 or 0 in lead:
        cplx = (torch.complex128 if out_dtype == torch.float64
                else torch.complex64)
        return torch.zeros((*lead, m, n), dtype=cplx, device=a.device)
    return plane_matmul_3m(encode_planes_3m(a, mu, moduli),
                           encode_planes_3m(b.transpose(-1, -2),
                                            nu.transpose(-1, -2), moduli),
                           mu, nu, moduli, out_dtype)


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
