"""Batched serving: prefill + greedy decode against the KV/SSM caches (the
port of ``serve/decode.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import encdec as E
from repro_torch.models import transformer as T
from repro_torch.models.layers import zeros_tree
from repro_torch.models.registry import Model


def init_caches(model: Model, batch: int, cache_len: int, device="cuda"):
    """Zero caches for ``batch`` sequences of up to ``cache_len`` tokens, in
    the layout of ``lm_cache_shapes``: bf16 K/V for attention layers; for
    mamba layers the bf16 conv buffer and the fp32 SSM state (whose size
    does not depend on ``cache_len``).  The audio family's are those of
    ``encdec_cache_shapes``: the decoder's K/V and bf16 cross K/V over the
    encoder's frames, zero as in the reference, which runs no encoder
    before decoding."""
    cfg = model.cfg
    if cfg.family == "audio":
        return zeros_tree(E.encdec_cache_shapes(cfg, batch, cache_len), device)
    return T.init_cache_tree(cfg, batch, cache_len, device)


@torch.no_grad()
def greedy_generate(
    model: Model,
    params,
    prompt: torch.Tensor,  # (B, S0) integer, on the params' device
    *,
    max_new_tokens: int,
    cache_len: Optional[int] = None,
) -> torch.Tensor:
    """Prefill the prompt token by token, then decode greedily: returns the
    (B, max_new_tokens) new tokens.  Everything stays on the prompt's
    device; nothing waits for the host between steps."""
    B, S0 = prompt.shape
    cache_len = cache_len or (S0 + max_new_tokens)
    caches = init_caches(model, B, cache_len, prompt.device)
    logits = None
    for t in range(S0):
        logits, caches = model.decode_step(params, caches, prompt[:, t], t)
    out = [torch.argmax(logits, dim=-1)]
    for i in range(max_new_tokens - 1):
        logits, caches = model.decode_step(params, caches, out[-1], S0 + i)
        out.append(torch.argmax(logits, dim=-1))
    return torch.stack(out, dim=1)
