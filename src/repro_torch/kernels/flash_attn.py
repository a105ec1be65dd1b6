"""Fused flash attention (``csrc/flash_attn.cu``): wrapper, plain version
and launch count.

:func:`flash_attention` takes q (B, H, Sq, D) and k, v (B, KVH, Sk, D)
with H % KVH == 0 (grouped-query heads: q head h reads kv head
h // (H / KVH)), float32 or bfloat16, causal and/or a sliding window, and
returns (B, H, Sq, D) in q's dtype. On a CUDA tensor it launches the
kernel, which keeps the score tile, the softmax statistics and the output
accumulator on chip; on a CPU tensor it runs the plain version, the
reference oracle's math in torch (``repro.kernels.ref.flash_attention``):
float32 scores, the mask, softmax, PV, then a cast to q's dtype.

Masks are top-left aligned (rel = q_pos - k_pos, both from 0): causal
keeps rel >= 0 and a window keeps rel < window. A masked score is the
finite -1e30, as in the reference, so a row whose keys are all masked
(a window, or Sq > Sk) averages v uniformly instead of giving NaN.

The kernel replaces the Pallas kernel ``repro.kernels.flash_attn.
flash_attention``. The CUDA kernel is compiled for head dims 32, 64, 128
and 256 (recurrentgemma-2b's); any other raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128, 256)
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


@dataclasses.dataclass
class LaunchCounts:
    """Launches of the kernel, and calls of the plain version on CUDA
    tensors."""
    launches: int = 0
    plain_cuda_calls: int = 0

    def reset(self) -> None:
        self.launches = self.plain_cuda_calls = 0


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
    """The kernel's function in plain torch ops (CPU or CUDA)."""
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


def _aligned(x: torch.Tensor) -> torch.Tensor:
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


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
    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise.
    """
    from repro_torch.kernels import build
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
    if q.dtype not in _KERNEL_DTYPES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise NotImplementedError(
            f"flash_attention takes float32 or bfloat16 q, k, v of one type, "
            f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if d not in HEAD_DIMS:
        raise NotImplementedError(
            f"flash_attention is compiled for head dims {HEAD_DIMS}, got "
            f"D={d} (another instance is ROADMAP.md § 2 item 5)")
    scale = softmax_scale or 1.0 / math.sqrt(d)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty_like(q)
    fn = build.load("flash_attn").flash_attention
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_float] + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h,
            kvh, sq, sk, d, int(q.dtype == torch.bfloat16), scale,
            int(bool(causal)), int(window is not None),
            0 if window is None else int(window), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed (code {rc}) for "
                           f"q {tuple(q.shape)}, k {tuple(k.shape)}")
    COUNTS.launches += 1
    return out
