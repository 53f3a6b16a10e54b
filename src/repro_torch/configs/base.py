"""Architecture + shape configuration (assigned pool, DESIGN.md §4).

Every architecture is a selectable config (``--arch <id>``); each model is
assembled from a per-layer *pattern* of block kinds:

  ``attn``        global causal GQA attention
  ``attn_local``  sliding-window causal attention (gemma3-style)
  ``attn_chunk``  chunked-local causal attention (llama4 iRoPE-style)
  ``mamba``       Mamba-2 SSD mixer

MoE placement is a per-layer boolean mask.  Shapes pair each arch with the
assigned (seq_len, global_batch, kind) cells.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, Optional, Tuple


@dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    # which layers are MoE: every k-th layer starting at `offset`
    every: int = 1
    offset: int = 0


@dataclass(frozen=True)
class SSMCfg:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    n_groups: int = 1
    d_conv: int = 4
    chunk: int = 256


@dataclass(frozen=True)
class EncoderCfg:
    """Encoder stack for enc-dec archs (whisper). The modality frontend is a
    STUB: ``input_specs`` supplies precomputed frame embeddings."""

    n_layers: int
    n_frames: int      # encoder sequence length (whisper-tiny: 1500)
    d_frame: int       # frontend embedding dim (== d_model)


@dataclass(frozen=True)
class VisionCfg:
    """ViT frontend STUB for VLMs: precomputed patch embeddings."""

    n_patches: int
    d_vision: int


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    pattern: Tuple[str, ...] = ()   # per-layer block kinds (len == n_layers)
    window: int = 4096              # sliding window for attn_local
    chunk: int = 8192               # chunk for attn_chunk
    moe: Optional[MoECfg] = None
    ssm: Optional[SSMCfg] = None
    encoder: Optional[EncoderCfg] = None
    vision: Optional[VisionCfg] = None
    rope_theta: float = 500_000.0
    rms_eps: float = 1e-5
    tie_embeddings: bool = False
    scan_period: int = 1            # layers per lax.scan step (pattern period)
    # per-arch sharding profile (§Perf iterations 1/6/7): explicit head
    # sharding fixes flash-loop permutes for attention-dominated stacks but
    # hurts SSD-dominated ones where GSPMD propagation is already optimal
    head_sharded_attn: bool = True
    # gradient-accumulation microbatches for train_4k (activation memory /N)
    train_microbatches: int = 1
    # ZeRO-3-style weight sharding: add a 'dp' shard to every big weight
    # (gathered per layer per pass; the only way ≥100B fp32 masters fit)
    zero3_weights: bool = False
    sub_quadratic: bool = False     # eligible for long_500k
    source: str = ""                # provenance tag [source; verified-tier]

    def moe_layer_mask(self) -> Tuple[bool, ...]:
        if self.moe is None:
            return tuple(False for _ in range(self.n_layers))
        m = self.moe
        return tuple(
            (i % m.every == m.offset % m.every) for i in range(self.n_layers)
        )

    def with_reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        n_layers = min(self.n_layers, 2 * max(1, self.scan_period))
        period = self.pattern[: self.scan_period] if self.pattern else ("attn",)
        pattern = tuple(period * (n_layers // len(period) + 1))[:n_layers]
        kw = dict(
            n_layers=n_layers,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2),
            d_head=16,
            d_ff=128,
            vocab=256,
            pattern=pattern,
            window=32,
            chunk=32,
            scan_period=min(self.scan_period, n_layers),
        )
        if self.moe:
            kw["moe"] = replace(
                self.moe, n_experts=min(4, self.moe.n_experts), d_ff_expert=128
            )
        if self.ssm:
            kw["ssm"] = replace(self.ssm, d_state=16, head_dim=16, chunk=16)
        if self.encoder:
            kw["encoder"] = EncoderCfg(n_layers=2, n_frames=24, d_frame=64)
        if self.vision:
            kw["vision"] = VisionCfg(n_patches=16, d_vision=64)
        return replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    def reduced(self) -> "ShapeConfig":
        return ShapeConfig(self.name, min(self.seq_len, 64), min(self.global_batch, 4), self.kind)


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def uniform_pattern(kind: str, n: int) -> Tuple[str, ...]:
    return tuple(kind for _ in range(n))


def periodic_pattern(period: Tuple[str, ...], n: int) -> Tuple[str, ...]:
    reps = n // len(period) + 1
    return tuple(period * reps)[:n]


def shape_applicable(cfg: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Assignment rules: long_500k only for sub-quadratic archs; decode only
    for archs with a decoder (all of ours have one)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "pure full-attention arch — long_500k skipped (DESIGN.md §4)"
    return True, ""
