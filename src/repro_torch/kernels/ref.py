"""Plain PyTorch versions of the LLM kernels (the port of ``kernels/ref.py``).

These are the oracles the tests hold the hand-written kernels to, and the
computation a kernel wrapper runs for tensors on the CPU:

  * ``attention_reference`` — naive O(S*T) attention with an fp32 softmax;
  * ``flash_attention_reference`` — the forward of the blocked online-softmax
    attention (``_flash_fwd_impl`` with ``_block_bias``), blocked as the
    flash kernel is: kernel 3's plain version;
  * ``decode_attention_reference`` — one new token against a KV cache;
  * ``rmsnorm_reference`` — kernel 2's plain version.

The flash custom VJP of the reference comes with the training slice.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def _inv_sqrt(D: int) -> float:
    """``1 / sqrt(D)`` rounded as the reference computes it, in fp32."""
    return float(1.0 / torch.sqrt(torch.tensor(float(D), dtype=torch.float32)))


def attention_reference(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, T, KV, D)
    v: torch.Tensor,  # (B, T, KV, D)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    chunk: Optional[int] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Naive O(S·T) attention — the oracle for tests. fp32 softmax."""
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, S, KV, G, D)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float())
    scores = scores / math.sqrt(D)
    qpos = torch.arange(S, device=q.device) + q_offset
    kpos = torch.arange(T, device=q.device)
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    if chunk is not None:
        mask &= torch.div(kpos[None, :], chunk, rounding_mode="floor") == torch.div(
            qpos[:, None], chunk, rounding_mode="floor")
    scores = torch.where(mask[None, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    return out.reshape(B, S, H, D).to(q.dtype)


def _block_bias(qpos, kpos, T, causal, window, chunk) -> torch.Tensor:
    """Additive mask bias for a (q_block, kv_block) tile, built from the
    position vectors (never materialized across blocks)."""
    keep = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool, device=qpos.device)
    if causal:
        keep &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        keep &= kpos[None, :] > qpos[:, None] - window
    if chunk is not None:
        keep &= torch.div(kpos[None, :], chunk, rounding_mode="floor") == torch.div(
            qpos[:, None], chunk, rounding_mode="floor")
    keep &= (kpos < T)[None, :]
    return torch.zeros(keep.shape, dtype=torch.float32, device=qpos.device).masked_fill_(~keep, NEG_INF)


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    chunk: Optional[int] = None,
    q_block: int = 512,
    kv_block: int = 512,
    q_offset: int = 0,
) -> torch.Tensor:
    """Blocked online-softmax attention, forward only: loops over q blocks
    and, inside, over kv blocks, carrying the fp32 state (acc, m, l)."""
    return _flash_fwd_impl(q, k, v, causal, window, chunk, q_block, kv_block, q_offset)[0]


def _flash_fwd_impl(
    q, k, v, causal, window, chunk, q_block, kv_block, q_offset
) -> Tuple[torch.Tensor, torch.Tensor]:
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    dev = q.device
    q_block = min(q_block, S)
    kv_block = min(kv_block, T)
    nq = (S + q_block - 1) // q_block
    nk = (T + kv_block - 1) // kv_block
    pad_q = nq * q_block - S
    pad_k = nk * kv_block - T
    if pad_q:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad_q))
    if pad_k:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad_k))

    qb = q.reshape(B, nq, q_block, KV, G, D).float()
    kb = k.reshape(B, nk, kv_block, KV, D).float()
    vb = v.reshape(B, nk, kv_block, KV, D).float()
    scale = _inv_sqrt(D)

    outs, lses = [], []
    for qi in range(nq):
        q_tile = qb[:, qi]                                  # (B, q_block, KV, G, D)
        qpos = qi * q_block + torch.arange(q_block, device=dev) + q_offset
        acc = torch.zeros((B, KV, G, q_block, D), dtype=torch.float32, device=dev)
        m = torch.full((B, KV, G, q_block), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, KV, G, q_block), dtype=torch.float32, device=dev)
        for ki in range(nk):
            kpos = ki * kv_block + torch.arange(kv_block, device=dev)
            s = torch.einsum("bqkgd,btkd->bkgqt", q_tile, kb[:, ki]) * scale
            s = s + _block_bias(qpos, kpos, T, causal, window, chunk)[None, None, None]
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bkgqt,btkd->bkgqd", p, vb[:, ki])
            m = m_new
        l = torch.clamp(l, min=1e-30)
        out = acc / l[..., None]
        lse = m + torch.log(l)
        # (B, KV, G, q_block, D) -> (B, q_block, KV, G, D)
        outs.append(out.permute(0, 3, 1, 2, 4))
        lses.append(lse.permute(0, 3, 1, 2))
    out = torch.cat(outs, dim=1).reshape(B, nq * q_block, H, D)
    lse = torch.cat(lses, dim=1).reshape(B, nq * q_block, H)
    return out[:, :S].to(q.dtype), lse[:, :S]


def decode_attention_reference(
    q: torch.Tensor,        # (B, H, D) single new token
    k_cache: torch.Tensor,  # (B, T, KV, D)
    v_cache: torch.Tensor,  # (B, T, KV, D)
    pos,                    # int or 0-d integer tensor: index of the new token
    *,
    window: Optional[int] = None,
    chunk: Optional[int] = None,
) -> torch.Tensor:
    """Attention of one new token over the cache.  q is cast to the cache's
    dtype and the probabilities are cast to it before the PV product, as in
    the reference; both products accumulate in fp32 (the products of two
    bf16 values are exact in fp32, so the fp32 product of the cast values is
    the bf16 product with fp32 accumulation)."""
    B, H, D = q.shape
    T, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    dev = k_cache.device
    qg = q.reshape(B, KV, G, D).to(k_cache.dtype)
    scores = torch.einsum("bkgd,btkd->bkgt", qg.float(), k_cache.float())
    scores = scores / math.sqrt(D)
    if not isinstance(pos, torch.Tensor):
        pos = torch.full((), int(pos), dtype=torch.int64, device=dev)
    kpos = torch.arange(T, device=dev)
    mask = kpos <= pos
    if window is not None:
        mask &= kpos > pos - window
    if chunk is not None:
        mask &= torch.div(kpos, chunk, rounding_mode="floor") == torch.div(
            pos, chunk, rounding_mode="floor")
    scores = torch.where(mask[None, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", probs.to(k_cache.dtype).float(), v_cache.float())
    return out.reshape(B, H, D).to(q.dtype)


def rmsnorm_reference(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)
