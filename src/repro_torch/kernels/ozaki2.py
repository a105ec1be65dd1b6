"""EmuGEMM-II (the plane route of ``csrc/emugemm2_planes.cu``, its
residue form too): wrappers, plain versions and launch counts.

* :func:`fused_matmul_scheme2` takes (M, K) @ (K, N) or, strided over a
  batch, (B, M, K) @ (B, K, N) operands with their power-of-two
  integerization scales mu (..., M, 1) in a's type and nu (..., 1, N) in
  b's type, and returns the Scheme-II product in ``out_dtype``. It runs
  the plane route below: an encode of A, an encode of B^T (both read
  through their strides) and one plane GEMM. It takes float32 and
  bfloat16 operands in any pairing with a float32, bfloat16 or float64
  output, and float64 operands (both, with a float64 or float32 output).
  Its plain version is ``repro_torch.core.scheme2.scaled_matmul``.
* :func:`fused_matmul_scheme2_prepared` takes an (M, K) float lhs with
  its scale mu (M, 1) and a prepared weight: the (p, N, Kp) int8 planes
  of its B^T (K padded with zero residues to ``PLANE_K``), written once
  by :func:`encode_planes` when it was prepared, and its scale nu
  (1, Np >= N) in the weight's type. It runs the plane route: one encode
  of the lhs and one plane GEMM. It takes the lhs types of the float-rhs
  form. Its plain version on the reference's (p, Kp, Np) residue stack is
  :func:`fused_matmul_scheme2_prepared_plain` (the reference's XLA
  expansion of a prepared operand,
  ``repro.kernels.prepared.matmul_prepared_scheme2``).
* :func:`fused_residue_matmul` takes (p, M, K) and (p, K, N) balanced int8
  residues and returns the balanced int8 residues (p, M, N) of their
  products mod each modulus. It runs the residue route below. Its plain
  version is the reference's oracle ``repro.kernels.ref.scheme2_residues``.

The plane route: :func:`encode_planes` writes an operand's balanced
residues once as K-contiguous int8 planes (p, [Bt,] R, Kp), K padded with
zero residues to ``PLANE_K``, and :func:`plane_matmul` is a TMA-fed wgmma
int8 GEMM per modulus with the reduction and the CRT in its epilogue; a
leading batch axis is the kernels' batch coordinate. Their plain versions
are :func:`encode_planes_plain` and :func:`plane_matmul_plain`; together
they are ``scheme2.scaled_matmul``.

The residue route: :func:`residue_planes` is the plane GEMM's mainloop on
given residues, one block a (modulus, tile), with one int32 sum over the
whole K that wraps as the reference's does and the balanced reduction in
its epilogue; it reads an operand in place through a tensor map where
:func:`tma_strides` allows (K unit-stride, 16-byte strides and base),
and :func:`relayout_planes` first copies any other operand into
K-contiguous planes (B as B^T: it arrives N-contiguous). Their plain
versions are :func:`relayout_planes_plain` and
:func:`residue_planes_plain`; together they are
:func:`fused_residue_matmul_plain`. ``ozaki3m`` runs K7 on the same
kernels.

On a CUDA tensor a wrapper launches the kernels or raises; on a CPU
tensor it runs the plain version. The kernels replace the Pallas kernels
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
# The plane route's type codes (csrc/emugemm2_planes.cu).
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
    """Calls of the float-rhs form's front door, 2-D and batched (each
    two encodes and one plane GEMM), and of the prepared form (each an
    encode and a plane GEMM); launches of the residue plane GEMM (one a
    residue-form call), of the relayout and of the plane route's kernels
    (encodes, plane GEMMs), whoever calls them; and
    calls of the plain versions on CUDA tensors (which the model paths
    must never make)."""
    launches_2d: int = 0
    launches_batched: int = 0
    launches_residues: int = 0
    launches_relayout: int = 0
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


def _balanced_products(acc, moduli):
    """(p, M, N) int32 sums -> their balanced int8 residues, modulus by
    modulus; the + m // 2 wraps in int32, as the reference's does."""
    outs = []
    for l, m in enumerate(moduli):
        half = int(m) // 2
        outs.append((torch.remainder(acc[l] + half, int(m)) - half)
                    .to(torch.int8))
    return torch.stack(outs)


def fused_residue_matmul_plain(a_res, b_res, moduli):
    """The residue form's function in plain torch ops (CPU or CUDA)."""
    if a_res.is_cuda:
        COUNTS.plain_cuda_calls += 1
    return _balanced_products(scheme2.residue_gemms(a_res, b_res), moduli)


def relayout_planes_plain(x):
    """The relayout kernel's function in plain torch ops (CPU or CUDA):
    int8 residues (p, [T,] R, K) through any strides -> their
    K-contiguous planes (p, [T,] R, Kp), zero residues past K."""
    if x.is_cuda:
        COUNTS.plain_cuda_calls += 1
    k = x.shape[-1]
    return torch.nn.functional.pad(x, (0, plane_k(k) - k)).contiguous()


def _common_k(a, b_t):
    """Two K-major operands, the shorter padded with zero residues to the
    other's K (a relaid plane is K padded, an operand read in place is
    not)."""
    k = max(a.shape[-1], b_t.shape[-1])
    pad = torch.nn.functional.pad
    return pad(a, (0, k - a.shape[-1])), pad(b_t, (0, k - b_t.shape[-1]))


def residue_planes_plain(a, b_t, moduli):
    """The residue plane GEMM's function in plain torch ops (CPU or CUDA):
    K-major residues a (p, M, Ka) and b_t (p, N, Kb), past each one's K
    zero residues -> (p, M, N) balanced int8 residues of a @ b_t^T."""
    if a.is_cuda:
        COUNTS.plain_cuda_calls += 1
    a, b_t = _common_k(a, b_t)
    return _balanced_products(
        scheme2.residue_gemms(a, b_t.transpose(-1, -2)), moduli)


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
                   + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 6
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
    float32 / bf16 (which the kernel reads in place and widens to float32:
    a power of two widens exactly), into ``out`` ([Bt,] M, N);
    ``epilogue=False`` stops after the mainloop, which leaves
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
    kept = (torch.float64,) if f64 else (torch.float32, torch.bfloat16)
    mu, nu = ((x if x.dtype in kept else x.to(kept[0])).contiguous()
              for x in (mu, nu))
    scale_bf16 = int(mu.dtype == torch.bfloat16) | 2 * int(
        nu.dtype == torch.bfloat16)
    part = torch.view_as_real(out) if out.is_complex() else out
    mods, inv = _crt_args(moduli)
    rc = _bind_planes(build.load("emugemm2_planes"))(
        a_planes.data_ptr(), b_planes.data_ptr(), mu.data_ptr(),
        nu.data_ptr(), part.data_ptr(), park.data_ptr(), batch, m, n, kp,
        _batch_stride(mu), _batch_stride(nu),
        part.stride(0) if lead else 0, tile_n, int(phases == 3), int(f64),
        scale_bf16, TYPE_CODE[part.dtype], p, mods, inv, int(epilogue),
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


def tma_strides(shape, strides, base: int):
    """The byte strides (s_p, s_t, s_r) through which the residue plane
    GEMM reads int8 residues of ``shape`` (p, T, R, K) in place, or None
    where it cannot and the operand is laid out first: a tensor map needs
    K unit-stride, every other stride a positive multiple of 16 below
    2^40 and a 16-byte aligned base. The stride of an axis of size 1 (and
    of K when K = 1) is never stepped; it is replaced by the extent of the
    axes inside it, rounded up to 16 bytes."""
    *outer, r, k = shape
    if base % 16 or (k > 1 and strides[-1] != 1):
        return None
    out, inner = [], k
    for size, stride in zip((r, *outer[::-1]), strides[-2::-1]):
        if size == 1:
            stride = -(-inner // 16) * 16
        elif stride <= 0 or stride % 16 or stride >= 2 ** 40:
            return None
        out.append(stride)
        inner = stride * size
    return tuple(out[::-1])


def _k_major(x):
    """Residues (p, [T,] R, K) as the residue plane GEMM reads them:
    themselves where :func:`tma_strides` allows, else their planes
    (:func:`relayout_planes`)."""
    if tma_strides(x.shape, x.stride(), x.data_ptr()) is None:
        x = relayout_planes(x)
    return x


@lru_cache(maxsize=None)
def _bind_relayout(lib: ctypes.CDLL):
    fn = lib.emugemm2_relayout
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@lru_cache(maxsize=None)
def _bind_residues(lib: ctypes.CDLL):
    fn = lib.emugemm2_residues
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 6 + [ctypes.c_int] * 3 + [_INT_P]
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def launch_relayout(x):
    """Launch the relayout kernel on int8 residues x (p, T, R, K), any
    strides: planes (p, T, R, Kp)."""
    from repro_torch.kernels import build
    p, phases, r, k = x.shape
    planes = torch.empty((p, phases, r, plane_k(k)), dtype=torch.int8,
                         device=x.device)
    rc = _bind_relayout(build.load("emugemm2_planes"))(
        x.data_ptr(), planes.data_ptr(), p, phases, r, k, planes.shape[-1],
        *x.stride(), torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"emugemm2 relayout failed (code {rc}) for "
                           f"{tuple(x.shape)} strides {x.stride()}")
    return planes


def launch_residues(a, b_t, moduli, out_re, out_im=None, epilogue=True):
    """Launch the residue plane GEMM on K-major residues a (p, T, M, Ka)
    and b_t (p, T, N, Kb) that :func:`tma_strides` reads in place (T = 3:
    K7, into ``out_im`` too), into ``out_re`` (p, M, N) int8;
    ``epilogue=False`` stops after the mainloop, leaving the outputs
    unwritten (for timing). The tile width is :func:`plane_tile_n`'s, the
    moduli as its batch."""
    from repro_torch.kernels import build
    p, phases, m, ka = a.shape
    n, kb = b_t.shape[-2:]
    sa = tma_strides(a.shape, a.stride(), a.data_ptr())
    sb = tma_strides(b_t.shape, b_t.stride(), b_t.data_ptr())
    if sa is None or sb is None:
        raise ValueError(f"emugemm2 residue GEMM: operands {tuple(a.shape)} "
                         f"strides {a.stride()} and {tuple(b_t.shape)} "
                         f"strides {b_t.stride()} are not K-major planes a "
                         "tensor map reads")
    tile_n = plane_tile_n(p, m, n, a.device)
    mods, _ = _crt_args(moduli)
    rc = _bind_residues(build.load("emugemm2_planes"))(
        a.data_ptr(), b_t.data_ptr(), out_re.data_ptr(),
        out_im.data_ptr() if out_im is not None else None, m, n, ka, kb,
        *sa, *sb, phases, tile_n, p, mods, int(epilogue),
        torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"emugemm2 residue GEMM failed (code {rc}) for "
                           f"{tuple(a.shape)} @ {tuple(b_t.shape)} "
                           f"moduli={moduli}")


def _check_residues(a, b_t, moduli, phases):
    """Raise unless a (p, [3,] M, Ka) and b_t (p, [3,] N, Kb) are int8
    residues on one card for these moduli."""
    lead = (len(moduli),) + ((3,) if phases == 3 else ())
    if (a.shape[:-2] != lead or b_t.shape[:-2] != lead
            or a.dtype != torch.int8 or b_t.dtype != torch.int8
            or not a.is_cuda or b_t.device != a.device):
        raise ValueError(f"emugemm2 residues: {tuple(a.shape)} {a.dtype} @ "
                         f"{tuple(b_t.shape)} {b_t.dtype} on {b_t.device}, "
                         f"{len(moduli)} moduli")
    check_moduli(moduli)


def relayout_planes(x: torch.Tensor) -> torch.Tensor:
    """int8 residues (p, [T,] R, K) through any strides -> their
    K-contiguous planes (p, [T,] R, Kp), zero residues past K.

    CPU tensors take the plain version; CUDA tensors launch the relayout
    kernel or raise.
    """
    if x.device.type == "cpu":
        return relayout_planes_plain(x)
    if x.dim() not in (3, 4) or x.dtype != torch.int8 or 0 in x.shape:
        raise ValueError(f"emugemm2 relayout: {tuple(x.shape)} {x.dtype}")
    planes = launch_relayout(x if x.dim() == 4 else x[:, None])
    COUNTS.launches_relayout += 1
    return planes if x.dim() == 4 else planes[:, 0]


def residue_planes(a: torch.Tensor, b_t: torch.Tensor,
                   moduli) -> torch.Tensor:
    """K-major int8 residues a (p, M, Ka) and b_t (p, N, Kb), each read in
    place (:func:`tma_strides`; past its K zero residues) -> the (p, M, N)
    balanced int8 residues of a @ b_t^T mod each modulus.

    CPU tensors take the plain version; CUDA tensors launch the residue
    plane GEMM or raise.
    """
    moduli = tuple(int(m) for m in moduli)
    if a.device.type == "cpu":
        return residue_planes_plain(a, b_t, moduli)
    _check_residues(a, b_t, moduli, 1)
    out = torch.empty((len(moduli), a.shape[1], b_t.shape[1]),
                      dtype=torch.int8, device=a.device)
    if out.numel() == 0 or 0 in (a.shape[-1], b_t.shape[-1]):
        return out.zero_()
    launch_residues(a[:, None], b_t[:, None], moduli, out)
    COUNTS.launches_residues += 1
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


def _planes(a, b, mu, nu, moduli, out_dtype):
    """The plane route of ([Bt,] M, K) @ ([Bt,] K, N): encode A and B^T
    (B^T and a transposed A are read through their strides), then the
    plane GEMM."""
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

    CPU tensors take the plain version; CUDA tensors launch the plane
    route (two encodes and one plane GEMM) or raise.
    """
    moduli = tuple(int(m) for m in moduli)
    if a.device.type == "cpu":
        return fused_matmul_scheme2_plain(a, b, mu, nu, moduli, out_dtype)
    _check(a, b, mu, nu, moduli, out_dtype)
    if a.dim() != b.dim() or a.dim() not in (2, 3):
        raise ValueError(f"emugemm2: operands must both be 2-D or both 3-D, "
                         f"got {tuple(a.shape)} @ {tuple(b.shape)}")
    out = _planes(a, b, mu, nu, moduli, out_dtype)
    if a.dim() == 2:
        COUNTS.launches_2d += 1
    else:
        COUNTS.launches_batched += 1
    return out


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

    CPU tensors take the plain version; CUDA tensors launch the residue
    route (a relayout of each operand that is not read in place, then the
    residue plane GEMM) or raise.
    """
    moduli = tuple(int(m) for m in moduli)
    if a_res.device.type == "cpu":
        return fused_residue_matmul_plain(a_res, b_res, moduli)
    p, m, k = a_res.shape
    n = b_res.shape[-1]
    if b_res.dim() != 3 or b_res.shape[:2] != (p, k):
        raise ValueError(f"emugemm2 residues: {tuple(a_res.shape)} @ "
                         f"{tuple(b_res.shape)}")
    b_t = b_res.transpose(-1, -2)
    _check_residues(a_res, b_t, moduli, 1)
    if m * n == 0 or k == 0:
        return torch.zeros((p, m, n), dtype=torch.int8, device=a_res.device)
    return residue_planes(_k_major(a_res), _k_major(b_t), moduli)
