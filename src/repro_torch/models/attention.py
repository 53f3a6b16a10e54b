"""GQA attention block: prefill (flash path) + KV-cache decode (the port of
``models/attention.py``).

Attention variants per layer kind (configs.base):
  attn        — global causal
  attn_local  — sliding window (gemma3 5:1 local:global)
  attn_chunk  — chunked local (llama4 iRoPE-style)

``impl`` selects both the flash attention and the RMSNorm implementation
(``kernels/ops.py``).  The decode step's attention is the plain
``decode_attention_reference``, as in the reference.

Under a mesh context (``distributed/sharding.py``) q, k, v and the output
are constrained to head parallelism, batch over "dp" and heads over "tp",
as the reference's (for the configs with ``head_sharded_attn``);
``attn_cache_spec`` is the decode caches' logical spec.  A cache whose
sequence is split over ranks (decode on a production mesh) is written and
attended through ``local_map``, split-K (``_sharded_decode_attention``).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch.distributed.tensor import Replicate

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import all_reduce_over, constrain, shard_offset, split_dims
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.models.layers import PD, dense, merge_heads, rms_norm, rope, split_heads, whole_rows


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
    S = x.shape[1]
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    x = whole_rows(x)
    h = rms_norm(x, p["ln"], cfg.rms_eps, impl=attn_impl)
    # Megatron-style head parallelism: attention is fully local per head
    hs = cfg.head_sharded_attn

    def _c(t, spec):
        return constrain(t, spec) if hs else t

    q = _c(split_heads(dense(h, p["wq"]), H, Dh), ("dp", None, "tp", None))
    k = _c(split_heads(dense(h, p["wk"]), KV, Dh), ("dp", None, _kv_axis(cfg), None))
    v = _c(split_heads(dense(h, p["wv"]), KV, Dh), ("dp", None, _kv_axis(cfg), None))
    if positions is None:
        positions = torch.arange(S, device=x.device)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    o = kops.flash_attention(q, k, v, causal=causal, impl=attn_impl, **_kind_masks(kind, cfg))
    o = _c(o, ("dp", None, "tp", None))
    return x + dense(merge_heads(o), p["wo"])


def _kv_axis(cfg: ArchConfig):
    # KV heads shard over tp only when divisible (GQA kv=2..16 vs tp=16);
    # otherwise replicate KV heads (cheap) and keep Q heads sharded.
    return "tp" if cfg.n_kv_heads % 16 == 0 else None


# ---------------------------------------------------------------------------
# Decode with KV cache
# ---------------------------------------------------------------------------


def attn_cache_shape(cfg: ArchConfig, batch: int, seq: int) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    KV, Dh = cfg.n_kv_heads, cfg.d_head
    return {
        "k": ((batch, seq, KV, Dh), torch.bfloat16),
        "v": ((batch, seq, KV, Dh), torch.bfloat16),
    }


def attn_cache_spec(long_context: bool) -> Dict[str, Tuple]:
    # decode_32k: batch over dp, kv-seq over tp (KV memory dominates).
    # long_500k (batch=1): sequence over BOTH axes.
    if long_context:
        return {"k": (None, ("dp", "tp"), None, None),
                "v": (None, ("dp", "tp"), None, None)}
    return {"k": ("dp", "tp", None, None), "v": ("dp", "tp", None, None)}


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


def _seq_split(cache):
    """``(mesh, split_dims)`` of a DTensor cache whose sequence axis is split
    over more than one rank; None otherwise (a plain tensor, a mesh of
    one)."""
    dims = split_dims(cache, 1)
    return (cache.device_mesh, dims) if math.prod(n for _, n in dims) > 1 else None


def _batch_like(cache):
    """Placements of a (B, ...) tensor batched as ``cache``, its other axes
    whole."""
    return [p if p.is_shard() and p.dim == 0 else Replicate() for p in cache.placements]


def _sharded_cache_write(split, cache, new, pos) -> None:
    """``_cache_write`` into a cache whose sequence is split over ranks
    (``attn_cache_spec`` puts it over "tp"): DTensor has no rule for an
    index_copy along a split axis, so each rank writes its own shard through
    ``local_map``, where the position falls in it."""
    from torch.distributed.tensor.experimental import local_map

    mesh, dims = split
    T = cache.shape[1]

    def local(c, n, p):
        lo = shard_offset(mesh, dims, T)
        idx = p.reshape(1)
        idx = torch.where(idx < 0, idx + T, idx).clamp(0, T - 1) - lo
        inside = ((idx >= 0) & (idx < c.shape[1])).reshape(1, 1, 1, 1)
        idx = idx.clamp(0, max(c.shape[1] - 1, 0))
        c.index_copy_(1, idx, torch.where(inside, n.to(c.dtype), c.index_select(1, idx)))
        return c

    local_map(local, out_placements=list(cache.placements),
              in_placements=(list(cache.placements), _batch_like(cache), [Replicate()] * mesh.ndim),
              device_mesh=mesh, redistribute_inputs=True)(cache, new, pos)


def _sharded_decode_attention(split, q, k_cache, v_cache, pos, *, window=None, chunk=None):
    """``decode_attention_reference`` over caches whose sequence is split
    over ranks, through ``local_map``: each rank scores its own positions,
    and the softmax's max and sum and the output are all-reduced over the
    ranks that split the sequence (split-K decoding, what GSPMD makes of a
    softmax over a split axis); DTensor's softmax needs the axis whole,
    which would gather the caches every step."""
    from torch.distributed.tensor.experimental import local_map

    mesh, dims = split
    T = k_cache.shape[1]

    def reduce(t, op):
        return all_reduce_over(t, op, mesh, dims)

    def local(q, k, v, p):
        B, H, D = q.shape
        KV = k.shape[2]
        qg = q.reshape(B, KV, H // KV, D).to(k.dtype)
        scores = torch.einsum("bkgd,btkd->bkgt", qg.float(), k.float()) / math.sqrt(D)
        kpos = shard_offset(mesh, dims, T) + torch.arange(k.shape[1], device=k.device)
        mask = kpos <= p
        if window is not None:
            mask &= kpos > p - window
        if chunk is not None:
            mask &= torch.div(kpos, chunk, rounding_mode="floor") == torch.div(p, chunk, rounding_mode="floor")
        scores = torch.where(mask[None, None, None], scores, kref.NEG_INF)
        m = reduce(scores.amax(dim=-1, keepdim=True), "max")
        e = torch.exp(scores - m)
        probs = e / reduce(e.sum(dim=-1, keepdim=True), "sum")
        out = reduce(torch.einsum("bkgt,btkd->bkgd", probs.to(k.dtype).float(), v.float()), "sum")
        return out.reshape(B, H, D).to(q.dtype)

    lay = _batch_like(k_cache)
    return local_map(local, out_placements=lay,
                     in_placements=(lay, list(k_cache.placements), list(v_cache.placements),
                                    [Replicate()] * mesh.ndim),
                     device_mesh=mesh, redistribute_inputs=True)(q, k_cache, v_cache, pos)


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
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    h = rms_norm(x, p["ln"], cfg.rms_eps, impl=impl)
    q = split_heads(dense(h, p["wq"]), H, Dh)
    k = split_heads(dense(h, p["wk"]), KV, Dh)
    v = split_heads(dense(h, p["wv"]), KV, Dh)
    q = rope(q, pos.reshape(1), cfg.rope_theta)
    k = rope(k, pos.reshape(1), cfg.rope_theta)
    split = _seq_split(cache["k"])
    if split is None:
        _cache_write(cache["k"], k, pos)
        _cache_write(cache["v"], v, pos)
        o = kref.decode_attention_reference(q[:, 0], cache["k"], cache["v"], pos,
                                            **_kind_masks(kind, cfg))
    else:
        _sharded_cache_write(split, cache["k"], k, pos)
        _sharded_cache_write(split, cache["v"], v, pos)
        o = _sharded_decode_attention(split, q[:, 0], cache["k"], cache["v"], pos, **_kind_masks(kind, cfg))
    out = x + dense(merge_heads(o[:, None]), p["wo"])
    return out, cache
