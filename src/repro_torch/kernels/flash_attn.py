"""Fused flash attention (``csrc/flash_attn.cu``): wrapper, plain version
and launch count.

:func:`flash_attention` takes q (B, H, Sq, D) and k, v (B, KVH, Sk, D)
with H % KVH == 0 (grouped-query heads: q head h reads kv head
h // (H / KVH)), float32, bfloat16 or float16, causal and/or a sliding
window, and returns (B, H, Sq, D) in q's dtype. On a CUDA tensor it launches the
kernel, which keeps the score tile, the softmax statistics and the output
accumulator on chip; on a CPU tensor it runs the plain version, the
reference oracle's math in torch (``repro.kernels.ref.flash_attention``):
float32 scores, the mask, softmax, PV, then a cast to q's dtype.

Masks are top-left aligned (rel = q_pos - k_pos, both from 0): causal
keeps rel >= 0 and a window keeps rel < window. A masked score is the
finite -1e30, as in the reference, so a row whose keys are all masked
(a window, or Sq > Sk) averages v uniformly instead of giving NaN.

The kernel replaces the Pallas kernel ``repro.kernels.flash_attn.
flash_attention``. ``csrc/flash_attn.cu`` holds three kernels, each
compiled for the head dims 32, 64, 128 and 256, and :func:`instance` names
the one a call runs, statically by dtype and head dim. Any head dim
D <= 256 that is a multiple of 8 runs on the instance of the next
compiled dim ``Instance.d`` (hubert-xlarge's D = 80 on 128, deepseek-v3's
D = 192 on 256): the tensor maps' inner extent is the true D and their
boxes ``d`` wide, so TMA fills the columns past D with zeros on chip, and
only D columns are stored; nothing is padded in device memory, and the
scale is ``1 / sqrt(D)`` of the true D. bfloat16 and float16 (the .f16
form of the same ``wgmma`` shapes) run on the TMA-fed, warp-specialised
``wgmma`` kernel (128 query rows a block, k and v tiles of ``bk`` keys in
a ring of ``stages``); float32 at D <= 128 on the same structure in
3xTF32 (``wgmma`` .tf32: every operand split as hi + lo, three products),
after a pre-pass (:func:`split_3xtf32`) that writes the parts, v
transposed; float32 at 128 < D <= 256 on the FFMA kernel (64 query rows
a block, true float32 products), because the 3xTF32 kernel's two q parts
alone would take all of a block's shared memory there. Any other dtype,
a ragged head dim or one past 256 raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128, 256)          # the compiled instances
_KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# tf32 keeps the sign, the exponent and 10 of float32's 23 mantissa bits.
TF32_MASK = -(1 << 13)


@dataclasses.dataclass(frozen=True)
class Instance:
    """The compiled kernel a (dtype, head dim) runs on, with its tiles
    (``csrc/flash_attn.cu``: ``Tiles``, ``Tiles32`` and ``Layout32``)."""
    kernel: str        # "wgmma" (bf16, float16), "wgmma-3xtf32" or "ffma"
    bq: int            # query rows of a block
    bk: int            # keys of a k/v tile
    stages: int        # k/v tiles in flight
    d: int             # the compiled head dim that runs the call


def instance(dtype: torch.dtype, d: int) -> Instance:
    """The kernel instance for q, k, v of ``dtype`` and head dim ``d``;
    raises for what has none."""
    if dtype not in _KERNEL_DTYPES:
        raise NotImplementedError(
            f"flash_attention takes float32, bfloat16 or float16 q, k, v, "
            f"got {dtype}")
    if not (0 < d <= HEAD_DIMS[-1] and d % 8 == 0):
        raise NotImplementedError(
            f"flash_attention runs head dims D <= {HEAD_DIMS[-1]} that are "
            f"multiples of 8, got D={d} (a ragged or wider head is "
            "ROADMAP.md § 2 item 5)")
    di = next(x for x in HEAD_DIMS if x >= d)
    if dtype != torch.float32:
        return Instance("wgmma", 128, 64 if di == 256 else 128,
                        3 if di <= 64 else 2, di)
    if di == 256:
        return Instance("ffma", 64, 32, 1, di)
    return Instance("wgmma-3xtf32", 128, 32 if di == 128 else 64,
                    1 if di == 128 else 2, di)


@dataclasses.dataclass
class LaunchCounts:
    """Launches of the attention kernels (``launches``: every call; those
    of the 3xTF32 and the FFMA kernel also apart, the rest ran the bf16
    kernel) and of the 3xTF32 pre-pass, and calls of the plain versions on
    CUDA tensors."""
    launches: int = 0
    launches_3xtf32: int = 0
    launches_ffma: int = 0
    launches_split: int = 0
    plain_cuda_calls: int = 0

    def reset(self) -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, 0)


COUNTS = LaunchCounts()


def visible(sq: int, sk: int, causal: bool, window: int | None,
            device=None) -> torch.Tensor:
    """The (Sq, Sk) mask of keys each query sees (top-left aligned)."""
    rel = (torch.arange(sq, device=device)[:, None]
           - torch.arange(sk, device=device)[None, :])
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= rel >= 0
    if window is not None:
        mask &= rel < window
    return mask


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, window: int | None = None,
                          softmax_scale: float | None = None) -> torch.Tensor:
    """The kernel's function in plain torch ops (CPU or CUDA), of any
    dtype and head dim: float32 scores, the output cast to q's dtype."""
    if q.is_cuda:
        COUNTS.plain_cuda_calls += 1
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    g = h // kvh
    scale = softmax_scale or 1.0 / math.sqrt(d)
    qg = q.reshape(b, kvh, g, sq, d).to(torch.float32)
    s = torch.einsum("bkgqd,bkjd->bkgqj", qg, k.to(torch.float32)) * scale
    s = torch.where(visible(sq, sk, causal, window, q.device), s,
                    torch.tensor(NEG_INF, dtype=torch.float32,
                                 device=q.device))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqj,bkjd->bkgqd", w, v.to(torch.float32))
    return out.reshape(b, h, sq, d).to(q.dtype)


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """float32 x as (hi, lo): hi is x with its 13 low mantissa bits
    cleared, lo the same of x - hi (exact in float32); both are tf32
    values, and hi + lo keeps about 22 of x's 24 significant bits."""
    hi = (x.view(torch.int32) & TF32_MASK).view(torch.float32)
    return hi, ((x - hi).view(torch.int32) & TF32_MASK).view(torch.float32)


def key_order(sk_pad: int) -> torch.Tensor:
    """The key each column of v^T's parts holds: in each group of 8,
    column c holds key 2c (c < 4) or 2(c - 4) + 1, the order in which the
    score accumulator hands P to wgmma's tf32 register A fragment."""
    c = torch.arange(sk_pad)
    within = c % 8
    return c - within + torch.where(within < 4, 2 * within,
                                    2 * (within - 4) + 1)


def split_3xtf32_plain(q, k, v):
    """The pre-pass's function in plain torch ops (CPU or CUDA): the parts
    (qh, ql, kh, kl, vh, vl) of float32 q (B, H, Sq, D) and k, v
    (B, KVH, Sk, D), v transposed to (B, KVH, D, Skp), Skp = Sk rounded
    up to 32, its keys in :func:`key_order`, zeros past Sk."""
    if q.is_cuda:
        COUNTS.plain_cuda_calls += 1
    sk = k.shape[2]
    skp = -(-sk // 32) * 32
    vp = torch.nn.functional.pad(v, (0, 0, 0, skp - sk))
    vt = vp[:, :, key_order(skp).to(v.device)].transpose(2, 3).contiguous()
    return (*tf32_split(q), *tf32_split(k), *tf32_split(vt))


def _aligned(x: torch.Tensor) -> torch.Tensor:
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


@functools.lru_cache(maxsize=None)
def _library():
    from repro_torch.kernels import build
    lib = build.load("flash_attn")
    lib.flash_attention.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                                    + [ctypes.c_float] + [ctypes.c_int] * 3
                                    + [ctypes.c_void_p])
    lib.flash_split_tf32.argtypes = ([ctypes.c_void_p] * 4
                                     + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.flash_attention_tf32.argtypes = ([ctypes.c_void_p] * 2
                                         + [ctypes.c_int] * 7
                                         + [ctypes.c_float]
                                         + [ctypes.c_int] * 3
                                         + [ctypes.c_void_p])
    for fn in (lib.flash_attention, lib.flash_split_tf32,
               lib.flash_attention_tf32):
        fn.restype = ctypes.c_int
    return lib


def _pointers(parts) -> ctypes.Array:
    return (ctypes.c_void_p * len(parts))(*[x.data_ptr() for x in parts])


def split_3xtf32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """The 3xTF32 kernel's pre-pass: the parts of contiguous float32 q, k
    and v (:func:`split_3xtf32_plain`). CPU tensors take the plain
    version; CUDA tensors launch the pre-pass or raise."""
    if q.device.type == "cpu":
        return split_3xtf32_plain(q, k, v)
    b, h, sq, d = q.shape
    _, kvh, sk, _ = k.shape
    if (q.dtype, k.dtype, v.dtype) != (torch.float32,) * 3 or d % 8 \
            or not all(x.is_cuda and x.is_contiguous() for x in (q, k, v)):
        raise ValueError(f"flash_attention 3xTF32 split: q {tuple(q.shape)} "
                         f"{q.dtype}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    skp = -(-sk // 32) * 32
    parts = [torch.empty_like(q), torch.empty_like(q), torch.empty_like(k),
             torch.empty_like(k)]
    parts += [k.new_empty((b, kvh, d, skp)) for _ in range(2)]
    rc = _library().flash_split_tf32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _pointers(parts), b, h, kvh,
        sq, sk, skp, d, torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention 3xTF32 split failed (code {rc}) "
                           f"for q {tuple(q.shape)}, k {tuple(k.shape)}")
    COUNTS.launches_split += 1
    return tuple(parts)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    softmax_scale: float | None = None,
                    bq: int = 256, bk: int = 256) -> torch.Tensor:
    """q (B, H, Sq, D); k, v (B, KVH, Sk, D) with H % KVH == 0 ->
    (B, H, Sq, D) in q's dtype.

    ``bq`` and ``bk`` are the reference's block sizes, kept with its
    refusals (Sq and Sk must divide into them, after each is capped at
    the sequence length); they do not choose the CUDA kernel's tiles,
    which are its own. The scale is ``softmax_scale or 1 / sqrt(D)``.
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (float32 at D <= 128: the pre-pass, then the 3xTF32 kernel) or raise
    (a ragged head dim, or one past 256: :func:`instance`).
    """
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}; expected "
                         "(B, H, Sq, D) and two (B, KVH, Sk, D)")
    b, h, sq, d = q.shape
    _, kvh, sk, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d or h % kvh:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} against k/v "
                         f"{tuple(k.shape)} (H must be a multiple of KVH)")
    bq, bk = min(bq, sq), min(bk, sk)
    if bq <= 0 or bk <= 0 or sq % bq or sk % bk:
        raise ValueError(f"flash_attention: Sq={sq}, Sk={sk} do not divide "
                         f"into blocks bq={bq}, bk={bk}")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, window, softmax_scale)
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention: q, k and v must be on one CUDA "
                         "device")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise NotImplementedError(
            f"flash_attention takes q, k, v of one type, got {q.dtype}, "
            f"{k.dtype}, {v.dtype}")
    kernel = instance(q.dtype, d).kernel
    scale = softmax_scale or 1.0 / math.sqrt(d)
    mask = (int(bool(causal)), int(window is not None),
            0 if window is None else int(window))
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if kernel == "wgmma-3xtf32":
        parts = split_3xtf32(q, k, v)
        rc = _library().flash_attention_tf32(
            _pointers(parts), out.data_ptr(), b, h, kvh, sq, sk,
            parts[4].shape[-1], d, scale, *mask, stream)
    else:
        rc = _library().flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h,
            kvh, sq, sk, d, _DTYPE_CODE[q.dtype], scale, *mask, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed (code {rc}) for "
                           f"q {tuple(q.shape)}, k {tuple(k.shape)}")
    COUNTS.launches += 1
    COUNTS.launches_3xtf32 += kernel == "wgmma-3xtf32"
    COUNTS.launches_ffma += kernel == "ffma"
    return out
