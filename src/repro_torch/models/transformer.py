"""Decoder-only LM assembled from the per-layer pattern (the port of
``models/transformer.py``: the dense, Mamba-2 SSM, MoE and hybrid families,
and the VLM's backbone).

The parameter tree keeps the reference's keys: ``embed``, ``final_ln``,
``lm_head`` (untied archs), the stacked ``scan`` whose leaves carry a leading
``n_periods`` axis, and ``tail{i}`` for the layers after the last whole
period.  The reference's ``lax.scan`` over periods is a Python loop over
that axis here.  A layer whose index the config's ``moe_layer_mask`` marks
has an ``ffn_moe`` (``models/moe.py``) in place of its dense ``ffn``.

``lm_loss`` is differentiable; with ``remat`` each period of the stack and
each tail layer runs under activation checkpointing, as the reference's
``jax.checkpoint(period_fn)``.  Under a mesh context the activations are
constrained where the reference's are (``distributed/sharding.py``): batch
over "dp" after the embedding, sequence over "tp" between layers
(Megatron-SP), the logits' vocabulary over "tp"; ``lm_cache_specs`` is the
decode caches' logical spec.  The serving entry points (``lm_forward``,
``lm_decode_step``, ``lm_prefill``) run under ``torch.no_grad``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import constrain
from repro_torch.models import attention as A
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.models.layers import (PD, checkpointed, dense, embed, mlp_block, mlp_defs, rms_norm,
                                       stack_defs, token_loss, tree_map, whole_rows, zeros_tree)

COMPUTE_DTYPE = torch.bfloat16


# ---------------------------------------------------------------------------
# Layer definitions from the pattern
# ---------------------------------------------------------------------------


def _layer_defs(cfg: ArchConfig, layer_idx: int) -> Dict[str, Any]:
    kind = cfg.pattern[layer_idx]
    defs: Dict[str, Any] = {"mixer": S.mamba_defs(cfg) if kind == "mamba" else A.attn_defs(cfg)}
    if cfg.moe is not None and cfg.moe_layer_mask()[layer_idx]:
        defs["ffn_moe"] = M.moe_defs(cfg)
    elif cfg.d_ff > 0:
        defs["ffn"] = mlp_defs(cfg.d_model, cfg.d_ff)
    return defs


def _segments(cfg: ArchConfig) -> Tuple[int, int, int]:
    p = max(1, cfg.scan_period)
    n_periods = cfg.n_layers // p
    rem = cfg.n_layers - n_periods * p
    # pattern must actually be periodic over the scanned prefix
    for i in range(n_periods * p):
        if cfg.pattern[i] != cfg.pattern[i % p]:
            raise ValueError(f"{cfg.name}: layer {i} breaks the pattern period {p}")
    if cfg.moe is not None and not (p % cfg.moe.every == 0 or cfg.moe.every % p == 0
                                    or cfg.moe.every == 1):
        raise ValueError(f"{cfg.name}: MoE every {cfg.moe.every} layers does not fit the period {p}")
    return p, n_periods, rem


def vocab_axis(V: int) -> Any:
    """Vocab-parallel only when the vocab divides the 16-wide model axis —
    whisper (51865) / internvl (92553) / mamba2 (50280) replicate instead."""
    return "tp" if V % 16 == 0 else None


def lm_param_defs(cfg: ArchConfig) -> Dict[str, Any]:
    p, n_periods, rem = _segments(cfg)
    d, V = cfg.d_model, cfg.vocab
    tp = vocab_axis(V)
    defs: Dict[str, Any] = {
        "embed": PD((V, d), (tp, None), scale=1.0 / (d ** 0.5)),
        "final_ln": PD((d,), (None,), init="ones"),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = PD((d, V), (None, tp))
    if n_periods > 0:
        period_defs = {f"l{j}": _layer_defs(cfg, j) for j in range(p)}
        defs["scan"] = stack_defs(period_defs, n_periods)
    for i in range(rem):
        defs[f"tail{i}"] = _layer_defs(cfg, n_periods * p + i)
    return defs


def _layers(params: Dict[str, Any], cfg: ArchConfig):
    """``(kind, layer params, cache key path)`` for every layer in order:
    the periods of the stacked ``scan``, then the tail."""
    p, n_periods, rem = _segments(cfg)
    for period in range(n_periods):
        for j in range(p):
            lp = tree_map(lambda t: t[period], params["scan"][f"l{j}"])
            yield cfg.pattern[j], lp, ("scan", period, f"l{j}")
    for i in range(rem):
        yield cfg.pattern[n_periods * p + i], params[f"tail{i}"], (f"tail{i}",)


def _head(params: Dict[str, Any], cfg: ArchConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------


def _block_fwd(lp, x, cfg: ArchConfig, kind: str, positions, attn_impl: str) -> torch.Tensor:
    if kind == "mamba":
        x = S.mamba_block(lp["mixer"], x, cfg, ssd_impl=attn_impl_to_ssd(attn_impl))
    else:
        x = A.attn_block(lp["mixer"], x, cfg, kind, positions=positions, attn_impl=attn_impl)
    if "ffn_moe" in lp:
        x = M.moe_block(lp["ffn_moe"], x, cfg, impl=attn_impl)
    elif "ffn" in lp:
        x = mlp_block(lp["ffn"], x, cfg.rms_eps, impl=attn_impl)
    # Megatron-SP: activations sequence-sharded between layers, heads and
    # ffn sharded inside blocks
    return constrain(x, ("dp", "tp", None))


def attn_impl_to_ssd(attn_impl: str) -> str:
    return attn_impl  # same dispatch vocabulary


def _logits(params, tokens, cfg: ArchConfig, attn_impl: str, prefix_embeds, remat: bool) -> torch.Tensor:
    """The forward of ``lm_forward``, differentiable, each period (and tail
    layer) checkpointed when ``remat``."""
    p, n_periods, rem = _segments(cfg)
    x = embed(params["embed"], tokens).to(COMPUTE_DTYPE)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(COMPUTE_DTYPE), x], dim=1)
    positions = torch.arange(x.shape[1], device=x.device)
    x = constrain(x, ("dp", None, None))

    def period_fn(x, period):
        for j in range(p):
            lp = tree_map(lambda t: t[period], params["scan"][f"l{j}"])
            x = _block_fwd(lp, x, cfg, cfg.pattern[j], positions, attn_impl)
        return x

    def tail_fn(x, i):
        return _block_fwd(params[f"tail{i}"], x, cfg, cfg.pattern[n_periods * p + i], positions,
                          attn_impl)

    for period in range(n_periods):
        x = checkpointed(remat, period_fn, x, period)
    for i in range(rem):
        x = checkpointed(remat, tail_fn, x, i)
    x = rms_norm(whole_rows(x), params["final_ln"], cfg.rms_eps, impl=attn_impl)
    return constrain(dense(x, _head(params, cfg)), ("dp", None, vocab_axis(cfg.vocab)))


@torch.no_grad()
def lm_forward(
    params: Dict[str, Any],
    tokens: torch.Tensor,  # (B, S) integer
    cfg: ArchConfig,
    *,
    attn_impl: str = "auto",
    prefix_embeds: Optional[torch.Tensor] = None,  # (B, Sp, d) VLM patches
) -> torch.Tensor:
    """Logits (B, Sp + S, V) in bf16.  A prefix (the VLM's projected
    patches) goes before the token embeddings in bf16; positions and the
    causal mask run over the whole sequence.  Serving: no graph."""
    return _logits(params, tokens, cfg, attn_impl, prefix_embeds, remat=False)


def lm_loss(params: Dict[str, Any], batch: Dict[str, torch.Tensor], cfg: ArchConfig, *,
            attn_impl: str = "auto", remat: bool = True) -> torch.Tensor:
    """Mean next-token loss of ``batch["tokens"]`` (B, S + 1); a
    ``prefix_embeds`` in the batch (the VLM's) is run and left out of it.
    Differentiable in the parameters (and the prefix)."""
    tokens = batch["tokens"]
    prefix = batch.get("prefix_embeds")
    logits = _logits(params, tokens[:, :-1], cfg, attn_impl, prefix, remat)
    if prefix is not None:
        logits = logits[:, prefix.shape[1]:]
    return token_loss(logits, tokens[:, 1:])


# ---------------------------------------------------------------------------
# Decode (serve_step): one token against stacked KV/SSM caches
# ---------------------------------------------------------------------------


def lm_cache_shapes(cfg: ArchConfig, batch: int, seq: int) -> Dict[str, Any]:
    """``(shape, dtype)`` of every cache, in the parameter tree's layout."""
    p, n_periods, rem = _segments(cfg)

    def layer_cache(kind):
        if kind == "mamba":
            return S.mamba_cache_shape(cfg, batch)
        return A.attn_cache_shape(cfg, batch, seq)

    out: Dict[str, Any] = {}
    if n_periods > 0:
        out["scan"] = {
            f"l{j}": {name: ((n_periods,) + shape, dtype)
                      for name, (shape, dtype) in layer_cache(cfg.pattern[j]).items()}
            for j in range(p)
        }
    for i in range(rem):
        out[f"tail{i}"] = layer_cache(cfg.pattern[n_periods * p + i])
    return out


def lm_cache_specs(cfg: ArchConfig, long_context: bool) -> Dict[str, Any]:
    """The logical spec of every cache of ``lm_cache_shapes``."""
    p, n_periods, rem = _segments(cfg)

    def layer_spec(kind):
        if kind == "mamba":
            return S.mamba_cache_spec(long_context)
        return A.attn_cache_spec(long_context)

    out: Dict[str, Any] = {}
    if n_periods > 0:
        out["scan"] = {
            f"l{j}": {name: (None,) + spec for name, spec in layer_spec(cfg.pattern[j]).items()}
            for j in range(p)
        }
    for i in range(rem):
        out[f"tail{i}"] = layer_spec(cfg.pattern[n_periods * p + i])
    return out


def _block_decode(lp, cache, x, pos, cfg: ArchConfig, kind: str, impl: str):
    if kind == "mamba":
        x, cache = S.mamba_decode_block(lp["mixer"], x, cache, pos, cfg, impl=impl)
    else:
        x, cache = A.attn_decode_block(lp["mixer"], x, cache, pos, cfg, kind, impl=impl)
    if "ffn_moe" in lp:
        x = M.moe_block(lp["ffn_moe"], x, cfg, impl=impl)
    elif "ffn" in lp:
        x = mlp_block(lp["ffn"], x, cfg.rms_eps, impl=impl)
    return x, cache


@torch.no_grad()
def lm_decode_step(
    params: Dict[str, Any],
    caches: Dict[str, Any],
    token: torch.Tensor,  # (B,) integer
    pos,                  # int or 0-d integer tensor
    cfg: ArchConfig,
    *,
    impl: str = "auto",
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step: returns (logits (B, V) in fp32, caches).  The caches
    are updated in place and returned."""
    x = embed(params["embed"], token)[:, None, :].to(COMPUTE_DTYPE)
    if not isinstance(pos, torch.Tensor):
        # a fill on the device: no blocking host-to-device copy, so the host
        # queues the next steps while the device runs this one
        pos = torch.full((), int(pos), dtype=torch.int64, device=x.device)
    for kind, lp, path in _layers(params, cfg):
        if path[0] == "scan":
            cache = {name: c[path[1]] for name, c in caches["scan"][path[2]].items()}
        else:
            cache = caches[path[0]]
        x, _ = _block_decode(lp, cache, x, pos, cfg, kind, impl)
    x = rms_norm(x, params["final_ln"], cfg.rms_eps, impl=impl)
    logits = dense(x, _head(params, cfg))[:, 0]
    return logits.to(torch.float32), caches


# ---------------------------------------------------------------------------
# Prefill that also fills the caches
# ---------------------------------------------------------------------------


def init_cache_tree(cfg: ArchConfig, batch: int, cache_len: int, device) -> Dict[str, Any]:
    """Zero caches of ``lm_cache_shapes`` on ``device``."""
    return zeros_tree(lm_cache_shapes(cfg, batch, cache_len), device)


@torch.no_grad()
def lm_prefill(
    params: Dict[str, Any],
    tokens: torch.Tensor,  # (B, S)
    cache_len: int,
    cfg: ArchConfig,
    *,
    impl: str = "auto",
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Sequential decode-based prefill (simple + exact): the last position's
    logits and the filled caches."""
    B, S = tokens.shape
    caches = init_cache_tree(cfg, B, cache_len, tokens.device)
    logits = torch.zeros((B, cfg.vocab), dtype=torch.float32, device=tokens.device)
    for t in range(S):
        logits, caches = lm_decode_step(params, caches, tokens[:, t], t, cfg, impl=impl)
    return logits, caches
