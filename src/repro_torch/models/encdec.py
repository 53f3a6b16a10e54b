"""Encoder-decoder transformer, the whisper-tiny backbone (the port of
``models/encdec.py``).

The conv/mel frontend is a stub: the caller supplies precomputed frame
embeddings (B, n_frames, d).  The encoder is a bidirectional self-attention
stack; each decoder layer runs causal self-attention, cross-attention over
the encoder's states, and the MLP.  The reference's ``lax.scan`` over the
stacked layers is a Python loop over their leading axis here.

Dispatch differs from the reference by design: ``attn_impl`` selects the
flash attention and RMSNorm implementation (``kernels/ops.py``) everywhere,
so on the card the encoder's self-attention and the forward's
cross-attention run the flash kernel with ``causal=False``, and every norm
the RMSNorm kernel.  The reference runs plain attention there (its
``encode`` passes no ``attn_impl`` and its ``_cross_attn`` calls
``attention_reference``).  ``attn_impl="reference"`` is the plain path
throughout.  The decode step's cross-attention is the plain
``decode_attention_reference``, as in the reference.

``encdec_loss`` is differentiable; with ``remat`` each decoder layer runs
under activation checkpointing, as the reference's ``jax.checkpoint`` over
its decoder scan (the encoder is not checkpointed there either).  The
serving entry points (``encode``, ``encdec_forward``,
``encdec_decode_step``) run under ``torch.no_grad``.  Under a mesh context
the activations are constrained batch over "dp" where the reference's are
(the encoder's input and each layer's exit); ``encdec_cache_specs`` is the
decode caches' logical spec.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import constrain
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.models import attention as A
from repro_torch.models.layers import (PD, checkpointed, dense, embed, merge_heads, mlp_block, mlp_defs, rms_norm,
                                       split_heads, stack_defs, token_loss, tree_map)

COMPUTE_DTYPE = torch.bfloat16


def _xattn_defs(cfg: ArchConfig) -> Dict[str, PD]:
    d, H, KV, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    return {
        "ln": PD((d,), (None,), init="ones"),
        "wq": PD((d, H * Dh), (None, "tp")),
        "wk": PD((d, KV * Dh), (None, "tp")),
        "wv": PD((d, KV * Dh), (None, "tp")),
        "wo": PD((H * Dh, d), ("tp", None)),
    }


def encdec_param_defs(cfg: ArchConfig) -> Dict[str, Any]:
    enc = cfg.encoder
    d, V = cfg.d_model, cfg.vocab
    tp = "tp" if V % 16 == 0 else None
    enc_layer = {"self": A.attn_defs(cfg), "ffn": mlp_defs(d, cfg.d_ff)}
    dec_layer = {"self": A.attn_defs(cfg), "cross": _xattn_defs(cfg), "ffn": mlp_defs(d, cfg.d_ff)}
    return {
        "embed": PD((V, d), (tp, None), scale=1.0 / (d ** 0.5)),
        "enc_pos": PD((enc.n_frames, d), (None, None)),
        "enc": stack_defs(enc_layer, enc.n_layers),
        "dec": stack_defs(dec_layer, cfg.n_layers),
        "enc_ln": PD((d,), (None,), init="ones"),
        "final_ln": PD((d,), (None,), init="ones"),
        "lm_head": PD((d, V), (None, tp)),
    }


def _layer(stacked: Dict[str, Any], i: int) -> Dict[str, Any]:
    return tree_map(lambda t: t[i], stacked)


def _cross_attn(p, x, enc_k, enc_v, cfg: ArchConfig, attn_impl: str) -> torch.Tensor:
    """x (B, S, d) decoder states over enc_k, enc_v (B, T, KV, Dh)."""
    H, Dh = cfg.n_heads, cfg.d_head
    h = rms_norm(x, p["ln"], cfg.rms_eps, impl=attn_impl)
    q = split_heads(dense(h, p["wq"]), H, Dh)
    o = kops.flash_attention(q, enc_k, enc_v, causal=False, impl=attn_impl)
    return x + dense(merge_heads(o), p["wo"])


def _enc_kv(p, enc_out: torch.Tensor, cfg: ArchConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    KV, Dh = cfg.n_kv_heads, cfg.d_head
    k = split_heads(dense(enc_out, p["wk"]), KV, Dh)
    v = split_heads(dense(enc_out, p["wv"]), KV, Dh)
    return k, v


def _enc_layer(lp, x, cfg: ArchConfig, attn_impl: str) -> torch.Tensor:
    x = A.attn_block(lp["self"], x, cfg, "attn", causal=False, attn_impl=attn_impl)
    return constrain(mlp_block(lp["ffn"], x, cfg.rms_eps, impl=attn_impl), ("dp", None, None))


def _dec_layer(lp, x, enc_out, positions, cfg: ArchConfig, attn_impl: str) -> torch.Tensor:
    x = A.attn_block(lp["self"], x, cfg, "attn", positions=positions, attn_impl=attn_impl)
    k, v = _enc_kv(lp["cross"], enc_out, cfg)
    x = _cross_attn(lp["cross"], x, k, v, cfg, attn_impl)
    return constrain(mlp_block(lp["ffn"], x, cfg.rms_eps, impl=attn_impl), ("dp", None, None))


def _encode(params, frames: torch.Tensor, cfg: ArchConfig, attn_impl: str) -> torch.Tensor:
    x = frames.to(COMPUTE_DTYPE) + params["enc_pos"].to(COMPUTE_DTYPE)[None]
    x = constrain(x, ("dp", None, None))
    for i in range(cfg.encoder.n_layers):
        x = _enc_layer(_layer(params["enc"], i), x, cfg, attn_impl)
    return rms_norm(x, params["enc_ln"], cfg.rms_eps, impl=attn_impl)


@torch.no_grad()
def encode(params, frames: torch.Tensor, cfg: ArchConfig, *, attn_impl: str = "auto") -> torch.Tensor:
    """frames: (B, n_frames, d) stub frontend output → encoder states, bf16."""
    return _encode(params, frames, cfg, attn_impl)


def _logits(params, frames, inputs, cfg: ArchConfig, attn_impl: str, remat: bool) -> torch.Tensor:
    """The forward of ``encdec_forward``, differentiable, each decoder layer
    checkpointed when ``remat``."""
    enc_out = _encode(params, frames, cfg, attn_impl)
    x = embed(params["embed"], inputs).to(COMPUTE_DTYPE)
    positions = torch.arange(inputs.shape[1], device=x.device)

    def layer_fn(x, i):
        return _dec_layer(_layer(params["dec"], i), x, enc_out, positions, cfg, attn_impl)

    for i in range(cfg.n_layers):
        x = checkpointed(remat, layer_fn, x, i)
    x = rms_norm(x, params["final_ln"], cfg.rms_eps, impl=attn_impl)
    return dense(x, params["lm_head"])


@torch.no_grad()
def encdec_forward(
    params: Dict[str, Any],
    frames: torch.Tensor,   # (B, T, d) stub frontend output
    inputs: torch.Tensor,   # (B, S) decoder tokens
    cfg: ArchConfig,
    *,
    attn_impl: str = "auto",
) -> torch.Tensor:
    """Logits (B, S, V) in bf16.  Serving: no graph."""
    return _logits(params, frames, inputs, cfg, attn_impl, remat=False)


def encdec_loss(params, batch: Dict[str, torch.Tensor], cfg: ArchConfig, *,
                attn_impl: str = "auto", remat: bool = True) -> torch.Tensor:
    """batch: frames (B, T, d), tokens (B, S + 1).  Differentiable."""
    tokens = batch["tokens"]
    logits = _logits(params, batch["frames"], tokens[:, :-1], cfg, attn_impl, remat)
    return token_loss(logits, tokens[:, 1:])


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def encdec_cache_shapes(cfg: ArchConfig, batch: int, seq: int) -> Dict[str, Any]:
    """``(shape, dtype)`` of every cache: the decoder's self-attention K/V
    and the cross K/V over the encoder's frames, stacked over the layers."""
    L, KV, Dh = cfg.n_layers, cfg.n_kv_heads, cfg.d_head
    cross = ((L, batch, cfg.encoder.n_frames, KV, Dh), torch.bfloat16)
    return {"dec": {
        "self": {name: ((L,) + shape, dtype)
                 for name, (shape, dtype) in A.attn_cache_shape(cfg, batch, seq).items()},
        "cross_k": cross,
        "cross_v": cross,
    }}


def encdec_cache_specs(cfg: ArchConfig, long_context: bool) -> Dict[str, Any]:
    """The logical spec of every cache of ``encdec_cache_shapes``."""
    # whisper has 6 KV heads (not divisible by tp=16) and only 1500
    # encoder frames — keep cross-KV replicated over tp
    per = {
        "self": A.attn_cache_spec(long_context),
        "cross_k": ("dp", None, None, None),
        "cross_v": ("dp", None, None, None),
    }
    return {"dec": {
        "self": {name: (None,) + spec for name, spec in per["self"].items()},
        "cross_k": (None,) + per["cross_k"],
        "cross_v": (None,) + per["cross_v"],
    }}


@torch.no_grad()
def encdec_decode_step(
    params: Dict[str, Any],
    caches: Dict[str, Any],
    token: torch.Tensor,  # (B,) integer
    pos,                  # int or 0-d integer tensor
    cfg: ArchConfig,
    *,
    impl: str = "auto",
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decoder step against the cross K/V in ``caches`` (the caller
    fills them from the encoder; zeros otherwise): (logits (B, V) fp32,
    caches).  The self-attention caches are updated in place."""
    x = embed(params["embed"], token)[:, None, :].to(COMPUTE_DTYPE)
    if not isinstance(pos, torch.Tensor):
        pos = torch.full((), int(pos), dtype=torch.int64, device=x.device)
    H, Dh = cfg.n_heads, cfg.d_head
    dec = caches["dec"]
    T = dec["cross_k"].shape[2]
    for i in range(cfg.n_layers):
        lp = _layer(params["dec"], i)
        x, _ = A.attn_decode_block(lp["self"], x, {n: c[i] for n, c in dec["self"].items()},
                                   pos, cfg, "attn", impl=impl)
        h = rms_norm(x, lp["cross"]["ln"], cfg.rms_eps, impl=impl)
        q = split_heads(dense(h, lp["cross"]["wq"]), H, Dh)[:, 0]
        o = kref.decode_attention_reference(q, dec["cross_k"][i], dec["cross_v"][i], T - 1)
        x = x + dense(merge_heads(o[:, None]), lp["cross"]["wo"])
        x = mlp_block(lp["ffn"], x, cfg.rms_eps, impl=impl)
    x = rms_norm(x, params["final_ln"], cfg.rms_eps, impl=impl)
    logits = dense(x, params["lm_head"])[:, 0]
    return logits.to(torch.float32), caches
