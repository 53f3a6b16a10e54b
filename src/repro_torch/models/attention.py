"""GQA attention block: prefill (flash path) + KV-cache decode (the port of
``models/attention.py``).

Attention variants per layer kind (configs.base):
  attn        — global causal
  attn_local  — sliding window (gemma3 5:1 local:global)
  attn_chunk  — chunked local (llama4 iRoPE-style)

``impl`` selects both the flash attention and the RMSNorm implementation
(``kernels/ops.py``).  The decode step's attention is the plain
``decode_attention_reference``, as in the reference.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.models.layers import PD, dense, rms_norm, rope


def attn_defs(cfg: ArchConfig) -> Dict[str, PD]:
    d, H, KV, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    return {
        "ln": PD((d,), (None,), init="ones"),
        "wq": PD((d, H * Dh), (None, "tp")),
        "wk": PD((d, KV * Dh), (None, "tp")),
        "wv": PD((d, KV * Dh), (None, "tp")),
        "wo": PD((H * Dh, d), ("tp", None)),
    }


def _kind_masks(kind: str, cfg: ArchConfig) -> Dict[str, Optional[int]]:
    if kind == "attn_local":
        return {"window": cfg.window, "chunk": None}
    if kind == "attn_chunk":
        return {"window": None, "chunk": cfg.chunk}
    return {"window": None, "chunk": None}


def attn_block(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,              # (B, S, d)
    cfg: ArchConfig,
    kind: str,
    *,
    positions: Optional[torch.Tensor] = None,   # (S,)
    causal: bool = True,
    attn_impl: str = "auto",
) -> torch.Tensor:
    B, S, d = x.shape
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    h = rms_norm(x, p["ln"], cfg.rms_eps, impl=attn_impl)
    q = dense(h, p["wq"]).reshape(B, S, H, Dh)
    k = dense(h, p["wk"]).reshape(B, S, KV, Dh)
    v = dense(h, p["wv"]).reshape(B, S, KV, Dh)
    if positions is None:
        positions = torch.arange(S, device=x.device)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    o = kops.flash_attention(q, k, v, causal=causal, impl=attn_impl, **_kind_masks(kind, cfg))
    return x + dense(o.reshape(B, S, H * Dh), p["wo"])


# ---------------------------------------------------------------------------
# Decode with KV cache
# ---------------------------------------------------------------------------


def attn_cache_shape(cfg: ArchConfig, batch: int, seq: int) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    KV, Dh = cfg.n_kv_heads, cfg.d_head
    return {
        "k": ((batch, seq, KV, Dh), torch.bfloat16),
        "v": ((batch, seq, KV, Dh), torch.bfloat16),
    }


def _cache_write(cache: torch.Tensor, new: torch.Tensor, pos: torch.Tensor) -> None:
    """Write ``new`` (B, 1, KV, D) into ``cache`` (B, T, KV, D) at ``pos``
    along axis 1, in place.  As ``jax.lax.dynamic_update_slice`` does in the
    reference, a negative ``pos`` counts from the end (``pos + T``) and the
    result is clamped to [0, T - 1] instead of raising; this runs on the
    device, so no value goes to the host."""
    T = cache.shape[1]
    idx = pos.reshape(1)
    idx = torch.where(idx < 0, idx + T, idx).clamp(0, T - 1)
    cache.index_copy_(1, idx, new.to(cache.dtype))


def attn_decode_block(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,              # (B, 1, d) the new token's activations
    cache: Dict[str, torch.Tensor],
    pos: torch.Tensor,            # 0-d integer tensor on x's device
    cfg: ArchConfig,
    kind: str,
    *,
    impl: str = "auto",
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token through the block.  The cache is updated in place (the
    reference returns a new one) and returned."""
    B, _, d = x.shape
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    h = rms_norm(x, p["ln"], cfg.rms_eps, impl=impl)
    q = dense(h, p["wq"]).reshape(B, 1, H, Dh)
    k = dense(h, p["wk"]).reshape(B, 1, KV, Dh)
    v = dense(h, p["wv"]).reshape(B, 1, KV, Dh)
    q = rope(q, pos.reshape(1), cfg.rope_theta)
    k = rope(k, pos.reshape(1), cfg.rope_theta)
    _cache_write(cache["k"], k, pos)
    _cache_write(cache["v"], v, pos)
    o = kref.decode_attention_reference(q[:, 0], cache["k"], cache["v"], pos,
                                        **_kind_masks(kind, cfg))
    out = x + dense(o.reshape(B, 1, H * Dh), p["wo"])
    return out, cache
