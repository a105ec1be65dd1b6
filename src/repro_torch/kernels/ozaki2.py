"""EmuGEMM-II (``csrc/emugemm2.cu`` and the plane route of
``csrc/emugemm2_planes.cu``): wrappers, plain versions and launch counts.

* :func:`fused_matmul_scheme2` takes (M, K) @ (K, N) or, strided over a
  batch, (B, M, K) @ (B, K, N) operands with their power-of-two
  integerization scales mu (..., M, 1) in a's type and nu (..., 1, N) in
  b's type, and returns the Scheme-II product in ``out_dtype``:
  integerize and carve residues in the prologue, one int8 GEMM per
  modulus, modular reduction and the CRT in the epilogue. The kernel
  takes float32 and bfloat16 operands in any pairing with a float32,
  bfloat16 or float64 output; float64 operands (both, with a float64 or
  float32 output) take the plane route below. Its plain version is
  ``repro_torch.core.scheme2.scaled_matmul``.
* :func:`fused_matmul_scheme2_prepared` takes an (M, K) float lhs with
  its scale mu (M, 1) and a prepared weight: the (p, N, Kp) int8 planes
  of its B^T (K padded with zero residues to ``PLANE_K``), written once
  by :func:`encode_planes` when it was prepared, and its scale nu
  (1, Np >= N) in the weight's type. It runs the plane route: one encode
  of the lhs and one plane GEMM. It takes the lhs types of the 2-D form
  and a float64 lhs against a float64 weight. Its plain version on the
  reference's (p, Kp, Np) residue stack is
  :func:`fused_matmul_scheme2_prepared_plain` (the reference's XLA
  expansion of a prepared operand,
  ``repro.kernels.prepared.matmul_prepared_scheme2``).
* :func:`fused_residue_matmul` takes (p, M, K) and (p, K, N) balanced int8
  residues and returns the balanced int8 residues (p, M, N) of their
  products mod each modulus. Its plain version is the reference's oracle
  ``repro.kernels.ref.scheme2_residues``.

The plane route: :func:`encode_planes` writes an operand's balanced
residues once as K-contiguous int8 planes (p, [Bt,] R, Kp), K padded with
zero residues to ``PLANE_K``, and :func:`plane_matmul` is a TMA-fed wgmma
int8 GEMM per modulus with the reduction and the CRT in its epilogue; a
leading batch axis is the kernels' batch coordinate. Float64 operands (a
DGEMM, or a batch of them) take it with two encodes, the prepared form
with one. Their plain versions are :func:`encode_planes_plain` and
:func:`plane_matmul_plain`; together they are ``scheme2.scaled_matmul``.

On a CUDA tensor a wrapper launches the kernel or raises; on a CPU tensor
it runs the plain version. The kernels replace the Pallas kernels
``repro.kernels.backends.gpu.fused_matmul_scheme2`` (2-D launch with a
float rhs; prepared launch with a residue rhs, ``b_res``),
``fused_matmul_scheme2_batched`` (batched launch) and
``repro.kernels.ozaki2.fused_residue_matmul`` (residue launch).
"""

from __future__ import annotations

import ctypes
import dataclasses
from functools import lru_cache

import torch

from repro_torch.core import scheme2

# The kernel unrolls its CRT over at most 16 moduli, each <= 256 (the
# reference's gpu.MAX_MODULI).
MAX_MODULI = 16
# The kernels' type codes (csrc/emugemm2.cu, csrc/emugemm2_planes.cu).
TYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}
# The plane GEMM's K tile (csrc/emugemm2_planes.cu), to which planes are
# padded, and its output tile, which sizes its park; PLANE_NARROW_N is the
# width of its narrow tile (plane_tile_n).
PLANE_K = 128
PLANE_TILE = (128, 256)
PLANE_NARROW_N = 128
_INT_P = ctypes.POINTER(ctypes.c_int)


@dataclasses.dataclass
class LaunchCounts:
    """Launches of the fused kernel in each form and of the plane route's
    kernels (encodes, plane GEMMs), calls of the prepared form (each an
    encode and a plane GEMM), and calls of the plain versions on CUDA
    tensors (which the model paths must never make)."""
    launches_2d: int = 0
    launches_batched: int = 0
    launches_residues: int = 0
    launches_prepared: int = 0
    launches_encode: int = 0
    launches_planes: int = 0
    plain_cuda_calls: int = 0

    def reset(self) -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, 0)


COUNTS = LaunchCounts()


def check_moduli(moduli) -> None:
    """Raise unless the kernel runs this moduli set (the reference's
    ``supported_moduli`` and ``_check_moduli``)."""
    moduli = tuple(int(m) for m in moduli)
    if not (0 < len(moduli) <= MAX_MODULI and max(moduli) <= 256):
        raise NotImplementedError(
            f"emugemm2 takes at most {MAX_MODULI} moduli, each <= 256 "
            f"(balanced int8 residues); got {len(moduli)} moduli, max "
            f"{max(moduli, default=0)}. The 'torch' backend runs larger "
            "sets; the 'cuda' backend does not fall back to it")


def fused_matmul_scheme2_plain(a, b, mu, nu, moduli, out_dtype):
    """The fused forms' function in plain torch ops (CPU or CUDA)."""
    if a.is_cuda:
        COUNTS.plain_cuda_calls += 1
    return scheme2.scaled_matmul(a, b, mu, nu, moduli, out_dtype)


def fused_matmul_scheme2_prepared_plain(a, b_res, mu, nu, moduli,
                                        out_dtype, n=None):
    """The prepared form's function in plain torch ops (CPU or CUDA), on
    the reference's (p, Kp, Np) residue stack (the 'stacked' layout, or
    ``PreparedResidues.stacked()``): the lhs's balanced residues, one
    exact GEMM per modulus against the stack, their reduction, the CRT,
    then / (mu * nu). Rows of the stack past K are zero residues and add
    nothing, so they are sliced off instead of padding the lhs."""
    if a.is_cuda:
        COUNTS.plain_cuda_calls += 1
    m, k = a.shape
    n = b_res.shape[-1] if n is None else n
    moduli = tuple(int(x) for x in moduli)
    a_res = scheme2.balanced_residues(torch.trunc(a * mu), moduli)
    c_res = scheme2.modular_reduce(
        scheme2.residue_gemms(a_res, b_res[:, :k, :n]), moduli)
    return scheme2.unscale(scheme2.crt_reconstruct(c_res, moduli, out_dtype),
                           mu, nu[:, :n], out_dtype)


def fused_residue_matmul_plain(a_res, b_res, moduli):
    """The residue form's function in plain torch ops (CPU or CUDA)."""
    if a_res.is_cuda:
        COUNTS.plain_cuda_calls += 1
    acc = scheme2.residue_gemms(a_res, b_res)
    outs = []
    for l, m in enumerate(moduli):
        half = int(m) // 2
        outs.append((torch.remainder(acc[l] + half, int(m)) - half)
                    .to(torch.int8))
    return torch.stack(outs)


def plane_k(k: int) -> int:
    """K padded to the plane GEMM's K tile."""
    return -(-k // PLANE_K) * PLANE_K


def encode_planes_plain(x, scale, moduli):
    """The encode kernel's function in plain torch ops (CPU or CUDA): the
    balanced residues of trunc(x * scale) for an ([Bt,] R, K) operand with
    its row scales ([Bt,] R, 1), as (p, [Bt,] R, Kp) int8 planes padded
    with zero residues along K."""
    if x.is_cuda:
        COUNTS.plain_cuda_calls += 1
    res = scheme2.balanced_residues(torch.trunc(x * scale), moduli)
    k = x.shape[-1]
    return torch.nn.functional.pad(res, (0, plane_k(k) - k))


def plane_matmul_plain(a_planes, b_planes, mu, nu, moduli, out_dtype):
    """The plane GEMM's function in plain torch ops (CPU or CUDA): the
    planes (p, [Bt,] M, Kp) and (p, [Bt,] N, Kp) of A and of B^T, one
    exact product per modulus, its reduction, the CRT, then / (mu * nu)."""
    if a_planes.is_cuda:
        COUNTS.plain_cuda_calls += 1
    return scheme2.residue_matmul(a_planes, b_planes.transpose(-1, -2), mu,
                                  nu, moduli, out_dtype)


@lru_cache(maxsize=None)
def _crt_args(moduli: tuple[int, ...]):
    """The moduli and Garner's inverse table as ctypes int arrays."""
    p = len(moduli)
    inv = scheme2.garner_constants(moduli)
    return ((ctypes.c_int * p)(*moduli),
            (ctypes.c_int * (p * p))(*[x for row in inv for x in row]))


@lru_cache(maxsize=None)
def _bind(lib: ctypes.CDLL):
    fn = lib.emugemm2
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 6 + [ctypes.c_int] * 4
                   + [_INT_P] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@lru_cache(maxsize=None)
def _bind_residues(lib: ctypes.CDLL):
    fn = lib.emugemm2_residues
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                   + [ctypes.c_longlong] * 6 + [ctypes.c_int] + [_INT_P]
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@lru_cache(maxsize=None)
def _bind_encode(lib: ctypes.CDLL):
    fn = lib.emugemm2_encode
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 3 + [_INT_P]
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@lru_cache(maxsize=None)
def _bind_planes(lib: ctypes.CDLL):
    fn = lib.emugemm2_planes
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 5
                   + [_INT_P] * 2 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


# The encode's grid carries the batch on gridDim.z.
MAX_BATCH = 65535


def _batch_stride(x: torch.Tensor) -> int:
    """The stride of a 3-D tensor's batch axis; 0 for a 2-D one."""
    return x.stride(0) if x.dim() == 3 else 0


def launch_encode(xr, xi, scale, moduli, planes_per_modulus):
    """Launch the encode kernel on the ([Bt,] R, K) part views xr and xi
    (xi None for a real operand) with row scales ([Bt,] R, 1): planes
    (p, planes_per_modulus, [Bt,] R, Kp) int8."""
    from repro_torch.kernels import build
    *lead, r, k = xr.shape
    p = len(moduli)
    planes = torch.empty((p, planes_per_modulus, *lead, r, plane_k(k)),
                         dtype=torch.int8, device=xr.device)
    scale = scale.contiguous()
    mods, _ = _crt_args(moduli)
    rc = _bind_encode(build.load("emugemm2_planes"))(
        xr.data_ptr(), xi.data_ptr() if xi is not None else None,
        scale.data_ptr(), planes.data_ptr(), lead[0] if lead else 1, r, k,
        planes.shape[-1], _batch_stride(xr), xr.stride(-2), xr.stride(-1),
        _batch_stride(scale), int(planes_per_modulus == 3),
        TYPE_CODE[xr.dtype], p, mods,
        torch.cuda.current_stream(xr.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"emugemm2 encode failed (code {rc}) for "
                           f"{tuple(xr.shape)} {xr.dtype} moduli={moduli}")
    return planes


def plane_tile_n(batch: int, m: int, n: int, device) -> int:
    """The plane GEMM's tile width for a ([batch,] M, N) output: 256
    columns, or 128 when the narrow tiles still fit in one wave of the
    card's SMs, which then run twice the blocks (each tile's CRT epilogue
    runs after its mainloop, on its own SM)."""
    narrow = batch * -(-m // PLANE_TILE[0]) * -(-n // PLANE_NARROW_N)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return PLANE_NARROW_N if narrow <= sms else PLANE_TILE[1]


def launch_planes(a_planes, b_planes, mu, nu, moduli, out, epilogue=True,
                  tile_n=None):
    """Launch the plane GEMM on planes (p, T, [Bt,] M, Kp) and
    (p, T, [Bt,] N, Kp) (T = 3: the 3M products, into a complex ``out``)
    with scales mu ([Bt,] M, 1) and nu ([Bt,] 1, N), both float64 or both
    float32 / bf16 (which the kernel reads as float32: a power of two
    widens exactly), into ``out`` ([Bt,] M, N); ``epilogue=False`` stops after the mainloop, which leaves
    ``out`` unwritten (for timing the two apart); ``tile_n`` sets the tile
    width instead of :func:`plane_tile_n` (for timing the widths apart)."""
    from repro_torch.kernels import build
    p, phases, *lead, m, kp = a_planes.shape
    n = b_planes.shape[-2]
    batch = lead[0] if lead else 1
    if tile_n is None:
        tile_n = plane_tile_n(batch, m, n, a_planes.device)
    tiles = batch * -(-m // PLANE_TILE[0]) * -(-n // tile_n)
    park = torch.empty(tiles * (2 if phases == 3 else 1) * p
                       * PLANE_TILE[0] * tile_n, dtype=torch.uint8,
                       device=a_planes.device)
    f64 = mu.dtype == torch.float64
    mu, nu = (x.to(torch.float64 if f64 else torch.float32).contiguous()
              for x in (mu, nu))
    part = torch.view_as_real(out) if out.is_complex() else out
    mods, inv = _crt_args(moduli)
    rc = _bind_planes(build.load("emugemm2_planes"))(
        a_planes.data_ptr(), b_planes.data_ptr(), mu.data_ptr(),
        nu.data_ptr(), part.data_ptr(), park.data_ptr(), batch, m, n, kp,
        _batch_stride(mu), _batch_stride(nu),
        part.stride(0) if lead else 0, tile_n, int(phases == 3), int(f64),
        TYPE_CODE[part.dtype], p, mods, inv, int(epilogue),
        torch.cuda.current_stream(a_planes.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"emugemm2 plane GEMM failed (code {rc}) for "
                           f"{(batch, m, kp, n)} moduli={moduli}")
    return out


def encode_planes(x: torch.Tensor, scale: torch.Tensor,
                  moduli) -> torch.Tensor:
    """A float32, bfloat16 or float64 ([Bt,] R, K) operand with its row
    scales ([Bt,] R, 1) in its type -> its (p, [Bt,] R, Kp) int8 balanced
    residue planes (B enters as B^T with nu^T).

    CPU tensors take the plain version; CUDA tensors launch the encode
    kernel or raise.
    """
    moduli = tuple(int(m) for m in moduli)
    if x.device.type == "cpu":
        return encode_planes_plain(x, scale, moduli)
    if (x.dim() not in (2, 3) or x.dtype not in TYPE_CODE or not x.is_cuda
            or scale.dtype != x.dtype or scale.shape != (*x.shape[:-1], 1)
            or scale.device != x.device or x.shape[-1] == 0
            or (x.dim() == 3 and not 0 < x.shape[0] <= MAX_BATCH)):
        raise ValueError(f"emugemm2 encode: {tuple(x.shape)} {x.dtype} on "
                         f"{x.device}, scale {tuple(scale.shape)} "
                         f"{scale.dtype}")
    check_moduli(moduli)
    planes = launch_encode(x, None, scale, moduli, 1)[:, 0]
    COUNTS.launches_encode += 1
    return planes


def _plane_types(mu_type, nu_type, out_dtype) -> bool:
    """Does the plane GEMM have a real instance for these scale and
    output types?"""
    if torch.float64 in (mu_type, nu_type):
        return mu_type == nu_type and out_dtype in (torch.float64,
                                                    torch.float32)
    return ({mu_type, nu_type} <= {torch.float32, torch.bfloat16}
            and out_dtype in TYPE_CODE)


def plane_matmul(a_planes: torch.Tensor, b_planes: torch.Tensor,
                 mu: torch.Tensor, nu: torch.Tensor, moduli,
                 out_dtype: torch.dtype) -> torch.Tensor:
    """The planes (p, [Bt,] M, Kp) of A and (p, [Bt,] N, Kp) of B^T with
    scales mu ([Bt,] M, 1) and nu ([Bt,] 1, N) -> ([Bt,] M, N) in
    ``out_dtype``: float64 scales to a float64 or float32 output, float32
    or bfloat16 ones (any pairing) to a float32, bfloat16 or float64
    output.

    CPU tensors take the plain version; CUDA tensors launch the plane
    GEMM or raise.
    """
    moduli = tuple(int(m) for m in moduli)
    if a_planes.device.type == "cpu":
        return plane_matmul_plain(a_planes, b_planes, mu, nu, moduli,
                                  out_dtype)
    p, *lead, m, kp = a_planes.shape
    n = b_planes.shape[-2]
    if (len(lead) > 1 or b_planes.shape != (p, *lead, n, kp)
            or p != len(moduli) or kp % PLANE_K
            or not a_planes.is_contiguous() or not b_planes.is_contiguous()
            or {a_planes.dtype, b_planes.dtype} != {torch.int8}
            or mu.shape != (*lead, m, 1) or nu.shape != (*lead, 1, n)
            or not _plane_types(mu.dtype, nu.dtype, out_dtype)
            or len({x.device for x in (a_planes, b_planes, mu, nu)}) != 1):
        raise ValueError(f"emugemm2 plane GEMM: {tuple(a_planes.shape)} @ "
                         f"{tuple(b_planes.shape)}, mu {tuple(mu.shape)} "
                         f"{mu.dtype}, nu {tuple(nu.shape)}, {len(moduli)} "
                         f"moduli -> {out_dtype}")
    check_moduli(moduli)
    out = torch.empty((*lead, m, n), dtype=out_dtype, device=a_planes.device)
    launch_planes(a_planes[:, None], b_planes[:, None], mu, nu, moduli, out)
    COUNTS.launches_planes += 1
    return out


def _check(a, b, mu, nu, moduli, out_dtype, b_type=None):
    """Raise unless the kernel has an instance for these operands;
    ``b_type`` is the rhs's float type (the prepared form's b is int8,
    and its type is nu's)."""
    b_type = b.dtype if b_type is None else b_type
    xs = (a, b, mu, nu)
    if not all(x.is_cuda for x in xs):
        raise ValueError("emugemm2: all operands must be CUDA tensors")
    if len({x.device for x in xs}) != 1:
        raise ValueError("emugemm2: operands on different devices")
    if a.dtype not in TYPE_CODE or b_type not in TYPE_CODE:
        raise NotImplementedError(
            f"emugemm2 takes float32, bfloat16 or float64 operands, got "
            f"{a.dtype} @ {b_type}")
    if mu.dtype != a.dtype or nu.dtype != b_type:
        raise ValueError(f"emugemm2: scales in the operands' types, got mu "
                         f"{mu.dtype} for {a.dtype}, nu {nu.dtype} for "
                         f"{b_type}")
    f64 = torch.float64 in (a.dtype, b_type)
    if out_dtype not in TYPE_CODE or (f64 and (
            a.dtype != b_type or out_dtype == torch.bfloat16)):
        raise NotImplementedError(
            f"emugemm2 has no instance for {a.dtype} @ {b_type} -> "
            f"{out_dtype}: float64 operands come in pairs, with a float64 "
            "or float32 output")
    check_moduli(moduli)


def _launch(a3, b3, mu3, nu3, moduli, out_dtype):
    from repro_torch.kernels import build
    batch, m, k = a3.shape
    n = b3.shape[-1]
    if b3.shape[:2] != (batch, k) or mu3.shape != (batch, m, 1) \
            or nu3.shape != (batch, 1, n):
        raise ValueError(f"emugemm2: shapes {tuple(a3.shape)} @ "
                         f"{tuple(b3.shape)}, mu {tuple(mu3.shape)}, "
                         f"nu {tuple(nu3.shape)}")
    mu3, nu3 = mu3.contiguous(), nu3.contiguous()
    out = torch.empty((batch, m, n), dtype=out_dtype, device=a3.device)
    if out.numel() == 0 or k == 0:
        return out.zero_()
    fn = _bind(build.load("emugemm2"))
    mods, inv = _crt_args(moduli)
    stream = torch.cuda.current_stream(a3.device).cuda_stream
    rc = fn(a3.data_ptr(), b3.data_ptr(), mu3.data_ptr(), nu3.data_ptr(),
            out.data_ptr(), batch, m, n, k,
            a3.stride(0), a3.stride(1), a3.stride(2),
            b3.stride(0), b3.stride(1), b3.stride(2),
            TYPE_CODE[a3.dtype], TYPE_CODE[b3.dtype], TYPE_CODE[out_dtype],
            len(moduli), mods, inv, stream)
    if rc != 0:
        raise RuntimeError(f"emugemm2 launch failed (code {rc}) for "
                           f"{(batch, m, k, n)} moduli={moduli}")
    return out


def _dgemm(a, b, mu, nu, moduli, out_dtype):
    """The plane route of a float64 ([Bt,] M, K) @ ([Bt,] K, N): encode A
    and B^T, then the plane GEMM."""
    *lead, m, k = a.shape
    n = b.shape[-1]
    if (b.shape != (*lead, k, n) or mu.shape != (*lead, m, 1)
            or nu.shape != (*lead, 1, n)):
        raise ValueError(f"emugemm2: shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}, mu {tuple(mu.shape)}, "
                         f"nu {tuple(nu.shape)}")
    if m * n == 0 or k == 0 or 0 in lead:
        return torch.zeros((*lead, m, n), dtype=out_dtype, device=a.device)
    return plane_matmul(encode_planes(a, mu, moduli),
                        encode_planes(b.transpose(-1, -2),
                                      nu.transpose(-1, -2), moduli),
                        mu, nu, moduli, out_dtype)


def fused_matmul_scheme2(a: torch.Tensor, b: torch.Tensor, mu: torch.Tensor,
                         nu: torch.Tensor, moduli,
                         out_dtype: torch.dtype) -> torch.Tensor:
    """(M, K) @ (K, N) with scales (M, 1) / (1, N) -> (M, N), or the
    strided-batched (B, M, K) @ (B, K, N) -> (B, M, N) form.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (float64 operands, 2-D or batched: the plane route) or raise.
    """
    moduli = tuple(int(m) for m in moduli)
    if a.device.type == "cpu":
        return fused_matmul_scheme2_plain(a, b, mu, nu, moduli, out_dtype)
    _check(a, b, mu, nu, moduli, out_dtype)
    if a.dim() == b.dim() and a.dim() in (2, 3) and a.dtype == torch.float64:
        return _dgemm(a, b, mu, nu, moduli, out_dtype)
    if a.dim() == 2 and b.dim() == 2:
        out = _launch(a[None], b[None], mu[None], nu[None], moduli,
                      out_dtype)[0]
        COUNTS.launches_2d += 1
        return out
    if a.dim() == 3 and b.dim() == 3:
        out = _launch(a, b, mu, nu, moduli, out_dtype)
        COUNTS.launches_batched += 1
        return out
    raise ValueError(f"emugemm2: operands must both be 2-D or both 3-D, got "
                     f"{tuple(a.shape)} @ {tuple(b.shape)}")


def fused_matmul_scheme2_prepared(a: torch.Tensor, b_planes: torch.Tensor,
                                  mu: torch.Tensor, nu: torch.Tensor, moduli,
                                  out_dtype: torch.dtype,
                                  n: int | None = None) -> torch.Tensor:
    """(M, K) float @ a prepared weight's (p, N, Kp) int8 planes (those of
    its B^T, Kp = plane_k(K)), with scales mu (M, 1) in a's type and nu
    (1, Np >= N) in the weight's type -> (M, N). ``n``, the weight's
    logical width, must be the planes' N (default).

    The plane route: one encode of the lhs (:func:`encode_planes`) and one
    plane GEMM (:func:`plane_matmul`), each of which takes its plain
    version on CPU tensors; CUDA tensors launch both kernels or raise.
    """
    moduli = tuple(int(x) for x in moduli)
    m, k = a.shape
    p, rows, kp = b_planes.shape
    n = rows if n is None else n
    if a.is_cuda:
        _check(a, b_planes, mu, nu, moduli, out_dtype, b_type=nu.dtype)
    if (b_planes.dtype != torch.int8 or p != len(moduli) or rows != n
            or kp != plane_k(k) or mu.shape != (m, 1) or nu.dim() != 2
            or nu.shape[0] != 1 or nu.shape[1] < n):
        raise ValueError(f"emugemm2 prepared: {tuple(a.shape)} @ planes "
                         f"{tuple(b_planes.shape)} {b_planes.dtype} (n={n}), "
                         f"mu {tuple(mu.shape)}, nu {tuple(nu.shape)}, "
                         f"{len(moduli)} moduli")
    if m * n == 0 or k == 0:
        return torch.zeros((m, n), dtype=out_dtype, device=a.device)
    out = plane_matmul(encode_planes(a, mu, moduli), b_planes, mu,
                       nu[:, :n], moduli, out_dtype)
    if a.is_cuda:
        COUNTS.launches_prepared += 1
    return out


def fused_residue_matmul(a_res: torch.Tensor, b_res: torch.Tensor,
                         moduli) -> torch.Tensor:
    """(p, M, K) @ (p, K, N) balanced int8 residues -> (p, M, N) balanced
    int8 residues of the products mod each modulus.

    CPU tensors take the plain version; CUDA tensors launch the kernel's
    residue form or raise.
    """
    from repro_torch.kernels import build
    moduli = tuple(int(m) for m in moduli)
    if a_res.device.type == "cpu":
        return fused_residue_matmul_plain(a_res, b_res, moduli)
    p, m, k = a_res.shape
    n = b_res.shape[-1]
    if (b_res.dim() != 3 or b_res.shape[:2] != (p, k) or p != len(moduli)
            or a_res.dtype != torch.int8 or b_res.dtype != torch.int8
            or not b_res.is_cuda or b_res.device != a_res.device):
        raise ValueError(f"emugemm2 residues: {tuple(a_res.shape)} "
                         f"{a_res.dtype} @ {tuple(b_res.shape)} {b_res.dtype}"
                         f" on {b_res.device}, {len(moduli)} moduli")
    check_moduli(moduli)
    out = torch.empty((p, m, n), dtype=torch.int8, device=a_res.device)
    if out.numel() == 0 or k == 0:
        return out.zero_()
    fn = _bind_residues(build.load("emugemm2"))
    mods, _ = _crt_args(moduli)
    stream = torch.cuda.current_stream(a_res.device).cuda_stream
    rc = fn(a_res.data_ptr(), b_res.data_ptr(), out.data_ptr(), m, n, k,
            a_res.stride(0), a_res.stride(1), a_res.stride(2),
            b_res.stride(0), b_res.stride(1), b_res.stride(2), p, mods,
            stream)
    if rc != 0:
        raise RuntimeError(f"emugemm2 residue launch failed (code {rc}) for "
                           f"{(p, m, k, n)}")
    COUNTS.launches_residues += 1
    return out
