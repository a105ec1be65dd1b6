"""Configuration schema of the port (``repro.configs.base`` without its
jax import and the dry-run's ``input_specs``).

Every architecture is an ``ArchConfig`` in its own module under
``repro_torch.configs``; ``repro_torch.configs.get_config`` maps
``--arch`` ids to them.
"""

from __future__ import annotations

import dataclasses
from typing import Literal


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    d_ff_shared: int = 0          # total shared-expert hidden width
    scoring: Literal["softmax", "sigmoid"] = "softmax"
    norm_topk: bool = True
    shared_gate: bool = False     # qwen2-moe gates the shared expert
    capacity_factor: float = 1.25
    n_groups: int = 512           # GShard-style dispatch groups (>= dp size)
    aux_loss_weight: float = 0.01
    pad_multiple: int = 64        # pad experts so the E axis shards cleanly


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSDConfig:
    d_state: int = 128
    head_dim: int = 64            # mamba2 P
    expand: int = 2
    conv_kernel: int = 4
    chunk: int = 256
    dt_min: float = 0.001
    dt_max: float = 0.1


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    lru_width: int = 0            # 0 => d_model
    conv_kernel: int = 4
    c: float = 8.0


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


TRAIN_4K = ShapeSpec("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524288, 1, "decode")
ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


@dataclasses.dataclass(frozen=True)
class TrainPolicy:
    """Per-arch distribution / memory knobs for the production mesh."""
    microbatches: int = 1
    remat: bool = True
    optimizer: Literal["adamw", "adafactor"] = "adamw"
    fsdp: bool = False            # ZeRO-3: shard params over 'data'
    zero2: bool = False           # ZeRO-2: params replicated over 'data',
    #                               optimizer states + grad accumulator
    #                               sharded — no per-microbatch weight
    #                               gathers (one AG per step instead)
    learning_rate: float = 3e-4


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # audio|dense|vlm|moe|hybrid|ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0             # 0 => d_model // n_heads
    qkv_bias: bool = False
    norm: Literal["rms", "layernorm", "nonparam"] = "rms"
    act: Literal["swiglu", "gelu", "geglu"] = "swiglu"
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    causal: bool = True           # False => encoder (bidirectional)
    attn_window: int | None = None
    block_pattern: tuple[str, ...] = ("attn",)   # attn | rec | ssd
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    ssd: SSDConfig | None = None
    rglru: RGLRUConfig | None = None
    mtp: bool = False             # deepseek-v3 multi-token prediction
    frontend: Literal["none", "audio_stub", "vision_stub"] = "none"
    frontend_dim: int = 0         # stub embedding input width
    n_image_tokens: int = 256     # vlm prefix length
    dtype: str = "float32"
    kv_cache_dtype: str = "auto"  # 'auto' (= dtype) | 'int8' (quantized)
    attn_sharding: str = "heads"  # 'heads' (TP over heads) | 'sp' (context)
    q_chunk: int = 1024
    kv_chunk: int = 1024
    sub_quadratic: bool = False   # may run long_500k

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def pattern_for_layers(self) -> list[str]:
        pat = list(self.block_pattern)
        return [pat[i % len(pat)] for i in range(self.n_layers)]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    model: ModelConfig
    train: TrainPolicy = TrainPolicy()
    shape_skips: tuple[str, ...] = ()
    skip_reason: str = ""
    # Per-call-site GEMM emulation specs, e.g.
    #     (("ffn", "ozaki1-p4+cached"), ("attn_qk", "ozaki2-m6"))
    # Spec strings use the ``repro_torch.api.precision`` grammar; the pseudo-site
    # 'default' sets the policy default. Ships emulation choices with the
    # config zoo instead of CLI flags — see :meth:`gemm_policy`.
    gemm_sites: tuple[tuple[str, str], ...] = ()

    def gemm_policy(self):
        """The :class:`repro_torch.models.common.GemmPolicy` of ``gemm_sites``.

        Each ``(site, spec)`` entry is parsed with :func:`repro_torch.api.precision`
        ('ozaki1-p4+cached', 'ozaki2-m6', 'native', ...). 'default' sets
        the policy default; every other key becomes a per-site override
        ('attn', 'ffn', 'logits', 'attn_qk', 'attn_av', 'moe_gate',
        'moe_expert', 'mla_latent', 'ssd_state', ...). An empty table
        returns the bare ambient-deferring ``GemmPolicy()`` — exactly the
        policy launchers historically built when no ``--gemm`` was given.
        """
        from repro_torch import api
        from repro_torch.models.common import GemmPolicy
        default = None
        overrides = []
        for site, spec in self.gemm_sites:
            cfg = api.precision(spec)
            if site == "default":
                default = cfg
            else:
                overrides.append((site, cfg))
        return GemmPolicy(default=default, overrides=tuple(overrides))

    def shapes(self) -> list[ShapeSpec]:
        out = []
        for s in ALL_SHAPES:
            if s.name in self.shape_skips:
                continue
            # encoder-only archs have no decode step at all
            if s.kind == "decode" and not self.model.causal:
                continue
            out.append(s)
        return out
