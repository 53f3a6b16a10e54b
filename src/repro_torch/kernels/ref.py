"""Plain PyTorch versions of the LLM kernels (the port of ``kernels/ref.py``).

These are the oracles the tests hold the hand-written kernels to, and the
computation a kernel wrapper runs for tensors on the CPU:

  * ``attention_reference`` — naive O(S*T) attention with an fp32 softmax;
  * ``flash_attention_reference`` — the blocked online-softmax attention
    (``_flash_fwd_impl`` with ``_block_bias``), blocked as the flash kernel
    is: kernel 3's plain version; under grad it is the reference's custom
    VJP (``FlashAttentionVJP``), as the reference's ``flash_attention_jnp``;
  * ``flash_attention_bwd_reference`` — the backward of the reference's flash
    custom VJP (``_flash_bwd_impl``): dQ, dK, dV from (q, k, v, o, lse, dO),
    block probabilities recomputed from the saved log-sum-exp; the plain
    version of ``csrc/flash_attention_bwd.cu``;
  * ``decode_attention_reference`` — one new token against a KV cache;
  * ``rmsnorm_reference`` — kernel 2's plain version, and
    ``rmsnorm_bwd_reference``, its autodiff written out, the plain version
    of ``csrc/rmsnorm_bwd.cu``;
  * ``ssd_reference`` — the chunked Mamba-2 SSD scan, kernel 4's plain
    version (with ``_segsum``), and ``ssd_bwd_reference``, its autodiff
    written out, the plain version of ``csrc/ssd_scan_bwd.cu``;
    ``ssd_decode_step``, the one-token recurrence the decode path runs;
  * ``flash_attention_tc_reference``, ``flash_attention_bwd_tc_reference``,
    ``ssd_chunked_reference`` and ``ssd_bwd_tc_reference`` — the arithmetic
    of the bf16 tensor-core instances of kernel 3, its backward, kernel 4
    and its backward, with
    their operands split into bf16 hi + lo where the kernels split them, so
    that a test can hold each kernel to it tightly and hold it to the plain
    versions above at their tolerances.  Tests and
    ``chip_smoke.py`` use them; the main path never does.

The math runs in fp32 for fp32 and bf16 inputs, as the reference's does;
float64 inputs stay float64 (``_acc``), so that ``torch.autograd.gradcheck``
can hold the autograd Functions of ``kernels/flash_attention.py``,
``kernels/rmsnorm.py`` and ``kernels/ssd_scan.py`` to finite differences on
the host.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def _acc(t: torch.Tensor) -> torch.Tensor:
    """``t`` in the type the plain versions compute in: float64 stays, any
    other floating type goes to fp32 (the reference's ``.astype(f32)``)."""
    return t if t.dtype == torch.float64 else t.float()


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
    """Blocked online-softmax attention: loops over q blocks and, inside,
    over kv blocks, carrying the fp32 state (acc, m, l).  Differentiable as
    the reference's ``flash_attention_jnp`` is, through its custom VJP
    (``FlashAttentionVJP``): the forward saves (q, k, v, out, lse) and the
    backward is ``flash_attention_bwd_reference`` with the same blocks."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionVJP.apply(q, k, v, causal, window, chunk, q_block, kv_block, q_offset)
    return _flash_fwd_impl(q, k, v, causal, window, chunk, q_block, kv_block, q_offset)[0]


class FlashAttentionVJP(torch.autograd.Function):
    """The reference's ``_flash`` custom VJP on plain PyTorch: the blocking,
    the masks and ``q_offset`` are not differentiable (its
    ``nondiff_argnums``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, chunk, q_block, kv_block, q_offset):
        out, lse = _flash_fwd_impl(q, k, v, causal, window, chunk, q_block, kv_block, q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = dict(causal=causal, window=window, chunk=chunk, q_block=q_block, kv_block=kv_block,
                        q_offset=q_offset)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_reference(q, k, v, out, lse, g.contiguous(), **ctx.args)
        return dq, dk, dv, None, None, None, None, None, None


def _tiles(n: int, meta: bool):
    """``range(n)`` for a tile loop.  On meta tensors (the dry run's shards,
    which hold no values) only tile 0, traced inside ``loop_trips(n)``: every
    tile issues the same ops on the same shapes, so the trace's counts are
    the whole loop's, and a 32k-token layer's 64 x 64 tiles cost one."""
    if not meta:
        yield from range(n)
        return
    from repro_torch.launch.roofline import loop_trips

    with loop_trips(n):
        yield 0


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

    qb = _acc(q.reshape(B, nq, q_block, KV, G, D))
    kb = _acc(k.reshape(B, nk, kv_block, KV, D))
    vb = _acc(v.reshape(B, nk, kv_block, KV, D))
    f = qb.dtype
    scale = _inv_sqrt(D)

    meta = q.device.type == "meta"
    outs, lses = [], []
    for qi in _tiles(nq, meta):
        q_tile = qb[:, qi]                                  # (B, q_block, KV, G, D)
        qpos = qi * q_block + torch.arange(q_block, device=dev) + q_offset
        acc = torch.zeros((B, KV, G, q_block, D), dtype=f, device=dev)
        m = torch.full((B, KV, G, q_block), NEG_INF, dtype=f, device=dev)
        l = torch.zeros((B, KV, G, q_block), dtype=f, device=dev)
        for ki in _tiles(nk, meta):
            kpos = ki * kv_block + torch.arange(kv_block, device=dev)
            s = torch.einsum("bqkgd,btkd->bkgqt", q_tile, kb[:, ki]) * scale
            s = s + _block_bias(qpos, kpos, T, causal, window, chunk).to(f)[None, None, None]
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
    if meta:  # the other tiles' results, of the same shapes, for the cat
        outs, lses = outs * nq, lses * nq
    out = torch.cat(outs, dim=1).reshape(B, nq * q_block, H, D)
    lse = torch.cat(lses, dim=1).reshape(B, nq * q_block, H)
    return out[:, :S].to(q.dtype), lse[:, :S]


def flash_attention_bwd_reference(
    q: torch.Tensor,    # (B, S, H, D)
    k: torch.Tensor,    # (B, T, KV, D)
    v: torch.Tensor,    # (B, T, KV, D)
    out: torch.Tensor,  # (B, S, H, D) the forward's output
    lse: torch.Tensor,  # (B, S, H) fp32, the forward's log-sum-exp
    g: torch.Tensor,    # (B, S, H, D) the gradient of the output
    *,
    causal: bool = True,
    window: Optional[int] = None,
    chunk: Optional[int] = None,
    q_block: int = 512,
    kv_block: int = 512,
    q_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flash backward (the reference's ``_flash_bwd_impl``): recompute block
    probabilities from the saved lse.

    dV = Σ_q pᵀ g;  dP = g Vᵀ;  dS = p ∘ (dP − δ) with δ = Σ_d g·out;
    dQ = dS K;  dK = dSᵀ Q.  Loops over kv blocks and, inside, over q blocks,
    carrying the dK/dV accumulators, as the reference's nested scans do.
    Returns (dq, dk, dv) in q's, k's and v's dtypes."""
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

    def padq(x):
        return torch.nn.functional.pad(x, (0, 0) * (x.dim() - 2) + (0, pad_q)) if pad_q else x

    def padk(x):
        return torch.nn.functional.pad(x, (0, 0) * (x.dim() - 2) + (0, pad_k)) if pad_k else x

    qb = _acc(padq(q).reshape(B, nq, q_block, KV, G, D))
    ob = _acc(padq(out).reshape(B, nq, q_block, KV, G, D))
    gb = _acc(padq(g).reshape(B, nq, q_block, KV, G, D))
    lseb = padq(lse).reshape(B, nq, q_block, KV, G).to(qb.dtype)
    kb = _acc(padk(k).reshape(B, nk, kv_block, KV, D))
    vb = _acc(padk(v).reshape(B, nk, kv_block, KV, D))
    f = qb.dtype
    scale = _inv_sqrt(D)
    delta = torch.sum(ob * gb, dim=-1)  # (B, nq, q_block, KV, G)

    dq_acc = torch.zeros((B, nq, q_block, KV, G, D), dtype=f, device=dev)
    meta = q.device.type == "meta"
    dk_all, dv_all = [], []
    for ki in _tiles(nk, meta):
        k_tile, v_tile = kb[:, ki], vb[:, ki]
        kpos = ki * kv_block + torch.arange(kv_block, device=dev)
        dk_acc = torch.zeros((B, kv_block, KV, D), dtype=f, device=dev)
        dv_acc = torch.zeros((B, kv_block, KV, D), dtype=f, device=dev)
        for qi in _tiles(nq, meta):
            q_tile, g_tile = qb[:, qi], gb[:, qi]
            l_tile, d_tile = lseb[:, qi], delta[:, qi]
            qpos = qi * q_block + torch.arange(q_block, device=dev) + q_offset
            s = torch.einsum("bqkgd,btkd->bkgqt", q_tile, k_tile) * scale
            bias = _block_bias(qpos, kpos, T, causal, window, chunk).to(f)
            p = torch.exp(s + bias[None, None, None] - l_tile.permute(0, 2, 3, 1)[..., None])
            dv_acc = dv_acc + torch.einsum("bkgqt,bqkgd->btkd", p, g_tile)
            dp = torch.einsum("bqkgd,btkd->bkgqt", g_tile, v_tile)
            ds = p * (dp - d_tile.permute(0, 2, 3, 1)[..., None]) * scale
            dq_acc[:, qi] += torch.einsum("bkgqt,btkd->bqkgd", ds, k_tile)
            dk_acc = dk_acc + torch.einsum("bkgqt,bqkgd->btkd", ds, q_tile)
        dk_all.append(dk_acc)
        dv_all.append(dv_acc)
    if meta:  # the other tiles' results, of the same shapes, for the cat
        dk_all, dv_all = dk_all * nk, dv_all * nk
    dq = dq_acc.reshape(B, nq * q_block, H, D)[:, :S].to(q.dtype)
    dk = torch.cat(dk_all, dim=1)[:, :T].to(k.dtype)
    dv = torch.cat(dv_all, dim=1)[:, :T].to(v.dtype)
    return dq, dk, dv


TC_KV_BLOCK = 128  # keys per tile of flash_attention_sm90.cu
LOG2E = 1.4426950408889634


def _split_bf16(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 ``a`` as the two bf16 operands the tensor-core kernels multiply
    it as, ``hi = bf16(a)`` and ``lo = bf16(a - hi)``, each back in fp32."""
    hi = a.to(torch.bfloat16).to(torch.float32)
    return hi, (a - hi).to(torch.bfloat16).to(torch.float32)


def _split_bf16_3(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """fp32 ``a`` as three bf16 operands ``hi + mid + lo`` (24 bits of it),
    each back in fp32."""
    hi, mid = _split_bf16(a)
    return hi, mid, (a - hi - mid).to(torch.bfloat16).to(torch.float32)


def flash_attention_tc_reference(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, T, KV, D)
    v: torch.Tensor,  # (B, T, KV, D)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    chunk: Optional[int] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """The arithmetic of the bf16 flash kernel (``csrc/flash_attention_sm90.cu``):
    kv tiles of 128 keys; scores in fp32 times ``scale * log2(e)``, masked to
    NEG_INF; the online softmax in base 2 (``exp2``), its row sum over the
    fp32 probabilities; the probabilities split into bf16 hi + lo
    (``_split_bf16``) for two products with V, accumulated in fp32;
    ``acc / max(l, 1e-30)`` in q's dtype."""
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    dev = q.device
    f32 = torch.float32
    scale2 = torch.tensor(_inv_sqrt(D), dtype=f32) * torch.tensor(LOG2E, dtype=f32)
    qf = q.reshape(B, S, KV, G, D).to(f32)
    qpos = torch.arange(S, device=dev) + q_offset
    acc = torch.zeros((B, KV, G, S, D), dtype=f32, device=dev)
    m = torch.full((B, KV, G, S), NEG_INF, dtype=f32, device=dev)
    l = torch.zeros((B, KV, G, S), dtype=f32, device=dev)
    for k0 in range(0, T, TC_KV_BLOCK):
        kpos = torch.arange(k0, min(k0 + TC_KV_BLOCK, T), device=dev)
        keep = _block_bias(qpos, kpos, T, causal, window, chunk) == 0
        if not bool(keep.any()):
            continue  # the kernel skips the tile too
        kt = k[:, k0:k0 + TC_KV_BLOCK].to(f32)
        vt = v[:, k0:k0 + TC_KV_BLOCK].to(f32)
        s = torch.einsum("bskgd,btkd->bkgst", qf, kt) * scale2.to(dev)
        s = torch.where(keep, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp2(s - m_new[..., None])
        corr = torch.exp2(m - m_new)
        l = l * corr + p.sum(dim=-1)
        hi, lo = _split_bf16(p)
        acc = (acc * corr[..., None] + torch.einsum("bkgst,btkd->bkgsd", hi, vt)
               + torch.einsum("bkgst,btkd->bkgsd", lo, vt))
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, D).to(q.dtype)


TC_BWD_KEYS = 128    # keys of a dK/dV block of flash_attention_bwd_sm90.cu
TC_BWD_ROWS = 64     # query rows of each tile it streams
TC_BWD_DQ_KEYS = 64  # keys of each tile a dQ block streams


def flash_attention_bwd_tc_reference(
    q: torch.Tensor,    # (B, S, H, D)
    k: torch.Tensor,    # (B, T, KV, D)
    v: torch.Tensor,    # (B, T, KV, D)
    out: torch.Tensor,  # (B, S, H, D) the forward's output
    lse: torch.Tensor,  # (B, S, H) fp32, the forward's natural-log log-sum-exp
    g: torch.Tensor,    # (B, S, H, D) the gradient of the output
    *,
    causal: bool = True,
    window: Optional[int] = None,
    chunk: Optional[int] = None,
    q_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The arithmetic of the bf16 flash backward kernel
    (``csrc/flash_attention_bwd_sm90.cu``): ``δ = rowsum(dO ∘ O)`` in fp32;
    ``P = exp2(s · (scale · log2 e) − lse · log2 e)``, 0 where a mask hides
    the pair, and ``dS = P ∘ (dP − δ) · scale`` in fp32, with s and dP the
    fp32 sums of bf16 products; P and dS split into bf16 hi + lo
    (``_split_bf16``) for two products each.  dK and dV are summed per
    block of keys over the group's heads in order and, inside, over query
    tiles of 64 rows; dQ over key tiles of 64.  Returns ``(dq, dk, dv)`` in
    q's, k's and v's dtypes."""
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    dev = q.device
    f32 = torch.float32
    scale = torch.tensor(_inv_sqrt(D), dtype=f32)
    log2e = torch.tensor(LOG2E, dtype=f32)
    scale2 = (scale * log2e).to(dev)
    scale = scale.to(dev)
    qf = q.reshape(B, S, KV, G, D).to(f32)
    gf = g.reshape(B, S, KV, G, D).to(f32)
    kf, vf = k.to(f32), v.to(f32)
    delta = torch.sum(out.to(f32) * g.to(f32), dim=-1).reshape(B, S, KV, G)
    lse2 = (lse.to(f32) * log2e.to(dev)).reshape(B, S, KV, G)
    keep = _block_bias(torch.arange(S, device=dev) + q_offset, torch.arange(T, device=dev), T, causal,
                       window, chunk) == 0  # (S, T)

    def probs(s, dp, l2, d, kp):
        p = torch.where(kp, torch.exp2(s * scale2 - l2), 0.0)
        return p, p * (dp - d) * scale

    # dK and dV: per head of the group, per query tile, keys as rows
    dk = torch.zeros((B, KV, T, D), dtype=f32, device=dev)
    dv = torch.zeros((B, KV, T, D), dtype=f32, device=dev)
    for gi in range(G):
        for q0 in range(0, S, TC_BWD_ROWS):
            qt, gt = qf[:, q0:q0 + TC_BWD_ROWS, :, gi], gf[:, q0:q0 + TC_BWD_ROWS, :, gi]  # (B, r, KV, D)
            st = torch.einsum("btkd,brkd->bktr", kf, qt)
            dpt = torch.einsum("btkd,brkd->bktr", vf, gt)
            l2 = lse2[:, q0:q0 + TC_BWD_ROWS, :, gi].permute(0, 2, 1)[:, :, None]
            d = delta[:, q0:q0 + TC_BWD_ROWS, :, gi].permute(0, 2, 1)[:, :, None]
            p, ds = probs(st, dpt, l2, d, keep[q0:q0 + TC_BWD_ROWS].T)
            for part, rhs, acc in ((p, gt, dv), (ds, qt, dk)):
                hi, lo = _split_bf16(part)
                acc += torch.einsum("bktr,brkd->bktd", hi, rhs) + torch.einsum("bktr,brkd->bktd", lo, rhs)

    # dQ: per key tile
    dq = torch.zeros((B, S, KV, G, D), dtype=f32, device=dev)
    l2 = lse2.permute(0, 2, 3, 1)[..., None]  # (B, KV, G, S, 1)
    d = delta.permute(0, 2, 3, 1)[..., None]
    for k0 in range(0, T, TC_BWD_DQ_KEYS):
        kt, vt = kf[:, k0:k0 + TC_BWD_DQ_KEYS], vf[:, k0:k0 + TC_BWD_DQ_KEYS]
        s = torch.einsum("bskgd,btkd->bkgst", qf, kt)
        dp = torch.einsum("bskgd,btkd->bkgst", gf, vt)
        _, ds = probs(s, dp, l2, d, keep[:, k0:k0 + TC_BWD_DQ_KEYS])
        hi, lo = _split_bf16(ds)
        dq += torch.einsum("bkgst,btkd->bskgd", hi, kt) + torch.einsum("bkgst,btkd->bskgd", lo, kt)
    return (dq.reshape(B, S, H, D).to(q.dtype), dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


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


# ---------------------------------------------------------------------------
# Mamba-2 SSD (state-space duality) — chunked reference
# ---------------------------------------------------------------------------


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """Stable segment-sum: out[..., i, j] = sum_{k=j+1..i} x[..., k] for j<i,
    -inf above the diagonal (no contribution)."""
    L = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    idx = torch.arange(L, device=x.device)
    mask = idx[:, None] >= idx[None, :]
    return diff.masked_fill(~mask, -math.inf)


def ssd_reference(
    x: torch.Tensor,    # (B, L, H, P) inputs per head
    dt: torch.Tensor,   # (B, L, H)    softplus'd step sizes
    A: torch.Tensor,    # (H,)         negative decay rates
    Bm: torch.Tensor,   # (B, L, G, N) input projections
    Cm: torch.Tensor,   # (B, L, G, N) output projections
    *,
    chunk: int = 256,
    initial_state: Optional[torch.Tensor] = None,  # (B, H, P, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD (Mamba-2, arXiv:2405.21060 Listing 1), fp32 inside
    (float64 inputs stay float64, ``_acc``).

    Returns (y: (B, L, H, P) in x's dtype, final_state: (B, H, P, N) fp32).
    The reference's ``lax.scan`` over chunks is a Python loop here."""
    Bsz, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if chunk <= 0 or L % chunk:
        raise ValueError(f"ssd: sequence length {L} is not a multiple of chunk {chunk}")
    nc = L // chunk
    rep = H // G

    x_ = _acc(x.reshape(Bsz, nc, chunk, H, P))
    f32 = x_.dtype
    dt_ = dt.reshape(Bsz, nc, chunk, H).to(f32)
    B_ = Bm.reshape(Bsz, nc, chunk, G, N).to(f32)
    C_ = Cm.reshape(Bsz, nc, chunk, G, N).to(f32)

    dA = dt_ * A.to(f32)[None, None, None, :]               # (B, nc, c, H)
    dA_cs = torch.cumsum(dA, dim=2)                          # within-chunk cumsum

    # 1) intra-chunk (diagonal blocks): Y_diag = (C Bᵀ ∘ L) · (dt·x)
    Lmat = torch.exp(_segsum(dA.permute(0, 1, 3, 2)))        # (B, nc, H, c, c)
    CB = torch.einsum("bzcgn,bzsgn->bzgcs", C_, B_)          # (B, nc, G, c, c)
    CB = torch.repeat_interleave(CB, rep, dim=2)             # (B, nc, H, c, c)
    dtx = x_ * dt_[..., None]                                # (B, nc, c, H, P)
    y_diag = torch.einsum("bzhcs,bzshp->bzchp", CB * Lmat, dtx)

    # 2) chunk-final states: S_z = Σ_s exp(dA_cs[end]-dA_cs[s]) B_s ⊗ dtx_s
    decay_to_end = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)    # (B, nc, c, H)
    Bh = torch.repeat_interleave(B_, rep, dim=3)             # (B, nc, c, H, N)
    states = torch.einsum("bzshn,bzshp->bzhpn", Bh * decay_to_end[..., None], dtx)

    # 3) inter-chunk recurrence: carry the running state across chunks,
    #    keeping the state entering each chunk
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])              # (B, nc, H)
    carry = (initial_state.to(f32) if initial_state is not None
             else torch.zeros((Bsz, H, P, N), dtype=f32, device=x.device))
    prev = []
    for z in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, z, :, None, None] + states[:, z]
    prev_states = torch.stack(prev, dim=1)                   # (B, nc, H, P, N)

    # 4) inter-chunk output: Y_off = (C_s · S_prev) * exp(dA_cs[s])
    state_decay = torch.exp(dA_cs)                           # (B, nc, c, H)
    Ch = torch.repeat_interleave(C_, rep, dim=3)             # (B, nc, c, H, N)
    y_off = torch.einsum("bzchn,bzhpn->bzchp", Ch, prev_states) * state_decay[..., None]

    y = (y_diag + y_off).reshape(Bsz, L, H, P)
    return y.to(x.dtype), carry


def _cumsum_in_order(a: torch.Tensor, dim: int) -> torch.Tensor:
    """The cumulative sum of ``a`` along ``dim``, each add rounded in order
    from the first element, as the CUDA kernels' one thread sums it."""
    out = torch.empty_like(a)
    run = torch.zeros_like(a.select(dim, 0))
    for i in range(a.shape[dim]):
        run = run + a.select(dim, i)
        out.select(dim, i).copy_(run)
    return out


def ssd_bwd_reference(
    x: torch.Tensor,    # (B, L, H, P)
    dt: torch.Tensor,   # (B, L, H)
    A: torch.Tensor,    # (H,)
    Bm: torch.Tensor,   # (B, L, G, N)
    Cm: torch.Tensor,   # (B, L, G, N)
    dy: torch.Tensor,   # (B, L, H, P) the gradient of y
    *,
    chunk: int = 256,
    initial_state: Optional[torch.Tensor] = None,  # (B, H, P, N)
    d_final_state: Optional[torch.Tensor] = None,  # (B, H, P, N) the gradient of the final state
) -> Tuple[torch.Tensor, ...]:
    """The gradients of ``ssd_reference`` for the output gradients ``dy``
    and ``d_final_state`` (zero when None), its autodiff written out; the
    plain version of ``csrc/ssd_scan_bwd.cu``.  Per chunk, with ``cs`` the
    within-chunk cumulative sum of ``dt * A`` (summed in order),
    ``u = dt * x``, ``S_in`` the state entering the chunk (the forward's
    scan) and ``R`` the gradient of the state leaving it (``d_final_state``
    for the last chunk):

      * ``R`` of the chunk before is ``exp(cs_end) R + Σ_i exp(cs_i) dy_i ⊗ C_i``,
        and ``d_initial_state`` is that of the first chunk;
      * ``du_j = Σ_{i≥j} (C_i·B_j) exp(cs_i − cs_j) dy_i + exp(cs_end − cs_j) R B_j``;
      * ``dC_i = Σ_{j≤i} exp(cs_i − cs_j) (dy_i·u_j) B_j + exp(cs_i) dy_i S_in`` and
        ``dB_j = Σ_{i≥j} exp(cs_i − cs_j) (dy_i·u_j) C_i + exp(cs_end − cs_j) u_j R``,
        summed over the heads of their group;
      * the gradient of ``cs`` collects its four exponents' terms, that of
        ``dt * A`` is its reverse cumulative sum ``ddA``; then
        ``dx = dt du``, ``d_dt = x·du + A ddA`` and ``dA = Σ dt ddA``.

    fp32 inside (float64 stays float64, ``_acc``).  Returns ``(dx, d_dt,
    dA, dBm, dCm, d_initial_state)``: dx, dBm and dCm in their inputs'
    dtypes, the rest fp32 (shapes of x, dt, A, Bm, Cm and the state)."""
    Bsz, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if chunk <= 0 or L % chunk:
        raise ValueError(f"ssd: sequence length {L} is not a multiple of chunk {chunk}")
    nc, rep, c = L // chunk, H // G, chunk
    x_ = _acc(x.reshape(Bsz, nc, c, H, P))
    f = x_.dtype
    dt_ = dt.reshape(Bsz, nc, c, H).to(f)
    a = A.to(f)
    B_ = torch.repeat_interleave(Bm.reshape(Bsz, nc, c, G, N).to(f), rep, dim=3)  # (B, nc, c, H, N)
    C_ = torch.repeat_interleave(Cm.reshape(Bsz, nc, c, G, N).to(f), rep, dim=3)
    dy_ = dy.reshape(Bsz, nc, c, H, P).to(f)

    cs = _cumsum_in_order(dt_ * a, dim=2)                    # (B, nc, c, H)
    u = x_ * dt_[..., None]                                  # (B, nc, c, H, P)
    ecs = torch.exp(cs)
    wend = torch.exp(cs[:, :, -1:] - cs)                     # exp(cs_end - cs_j)
    decay = torch.exp(cs[:, :, -1])                          # (B, nc, H)

    # the state entering each chunk, as the forward's scan carries it
    S = (initial_state.to(f) if initial_state is not None
         else torch.zeros((Bsz, H, P, N), dtype=f, device=x.device))
    s_in = []
    for z in range(nc):
        s_in.append(S)
        S = S * decay[:, z, :, None, None] + torch.einsum("bjhp,bjhn->bhpn", u[:, z] * wend[:, z, ..., None],
                                                         B_[:, z])

    idx = torch.arange(c, device=x.device)
    causal = idx[:, None] >= idx[None, :]                    # [i, j]: j <= i
    R = (d_final_state.to(f) if d_final_state is not None
         else torch.zeros((Bsz, H, P, N), dtype=f, device=x.device))
    du = torch.empty_like(u)
    dB = torch.empty_like(B_)
    dC = torch.empty_like(C_)
    dcs = torch.empty_like(cs)
    for z in reversed(range(nc)):
        Si, uz, dyz, Bz, Cz = s_in[z], u[:, z], dy_[:, z], B_[:, z], C_[:, z]
        csh = cs[:, z].permute(0, 2, 1)                      # (B, H, c)
        Lm = torch.exp(torch.where(causal, csh[..., :, None] - csh[..., None, :], -math.inf))
        CB = torch.einsum("bihn,bjhn->bhij", Cz, Bz)
        Gm = torch.einsum("bihp,bjhp->bhij", dyz, uz)        # dy_i . u_j
        W1, W2 = CB * Lm, Gm * Lm
        T = W1 * Gm
        RB = torch.einsum("bhpn,bjhn->bjhp", R, Bz)          # R B_j
        uR = torch.einsum("bjhp,bhpn->bjhn", uz, R)          # u_j R
        dyS = torch.einsum("bihp,bhpn->bihn", dyz, Si)       # dy_i S_in
        w = wend[:, z, ..., None]
        du[:, z] = torch.einsum("bhij,bihp->bjhp", W1, dyz) + w * RB
        dB[:, z] = torch.einsum("bhij,bihn->bjhn", W2, Cz) + w * uR
        dC[:, z] = torch.einsum("bhij,bjhn->bihn", W2, Bz) + ecs[:, z, ..., None] * dyS
        wq = wend[:, z] * (uz * RB).sum(-1)                  # (B, c, H)
        d = (T.sum(-1) - T.sum(-2)).permute(0, 2, 1) + ecs[:, z] * (Cz * dyS).sum(-1) - wq
        d[:, -1] += decay[:, z] * (R * Si).sum((-1, -2)) + wq.sum(1)
        dcs[:, z] = d
        R = R * decay[:, z, :, None, None] + torch.einsum("bih,bihp,bihn->bhpn", ecs[:, z], dyz, Cz)

    ddA = torch.flip(torch.cumsum(torch.flip(dcs, (2,)), dim=2), (2,))
    dx = (dt_[..., None] * du).reshape(Bsz, L, H, P).to(x.dtype)
    d_dt = ((x_ * du).sum(-1) + a * ddA).reshape(Bsz, L, H)
    dA = (dt_ * ddA).sum((0, 1, 2))
    dBm = dB.reshape(Bsz, nc, c, G, rep, N).sum(4).reshape(Bsz, L, G, N).to(Bm.dtype)
    dCm = dC.reshape(Bsz, nc, c, G, rep, N).sum(4).reshape(Bsz, L, G, N).to(Cm.dtype)
    return dx, d_dt, dA, dBm, dCm, R


TC_BWD_MAX_RUN = 8  # heads of a group whose dB and dC one block of ssd_scan_bwd_sm90.cu sums


def ssd_bwd_head_run(rep: int) -> int:
    """Heads a block of the bf16 SSD backward walks in order, summing their
    dB and dC before it writes a partial: the largest divisor of the heads
    per group ``rep`` up to ``TC_BWD_MAX_RUN``."""
    return max(d for d in range(1, min(rep, TC_BWD_MAX_RUN) + 1) if rep % d == 0)


def ssd_bwd_tc_reference(
    x: torch.Tensor,    # (B, L, H, P)
    dt: torch.Tensor,   # (B, L, H)
    A: torch.Tensor,    # (H,)
    Bm: torch.Tensor,   # (B, L, G, N)
    Cm: torch.Tensor,   # (B, L, G, N)
    dy: torch.Tensor,   # (B, L, H, P) the gradient of y
    *,
    chunk: int = 256,
    initial_state: Optional[torch.Tensor] = None,  # (B, H, P, N)
    d_final_state: Optional[torch.Tensor] = None,  # (B, H, P, N)
) -> Tuple[torch.Tensor, ...]:
    """The arithmetic of the bf16 SSD backward on the tensor cores
    (``csrc/ssd_scan_bwd_sm90.cu``), the math of ``ssd_bwd_reference``:

      * cs in order in fp32 and ``CB = C Bᵀ`` once per group, as the
        forward's kernels 1 and 2 compute them;
      * every chunk's own forward state ``Σ_j a_j ⊗ B_j`` (``a_j = x_j ·
        exp(cs_end − cs_j) · dt_j``) and own reverse state ``Σ_i e_i ⊗ C_i``
        (``e_i = dy_i · exp(cs_i)``), all chunks at once, a_j split into
        bf16 hi + lo (``_split_bf16``) and e_i into hi + mid + lo
        (``_split_bf16_3``: their sum over every chunk is the initial
        state's gradient, held to 1e-5 of its largest element);
      * one pass over the chunks carrying S_in forward and R back in fp32;
        ``Σ R · S_in`` of each chunk in double;
      * per chunk and head, with ``M = exp(cs_i − cs_j)`` on the causal
        half: ``DX = dy xᵀ`` (bf16 operands, no split), ``Gm = DX · dt_j``,
        ``W1 = CB · M``, ``W2 = Gm · M``, ``T = W1 · Gm``; W1, W2, R and
        S_in split for their products; du, dB and dC as
        ``ssd_bwd_reference`` writes them, with ``u R`` as
        ``(exp(cs_end − cs_j) dt_j) (x R)``;
      * dB and dC summed in fp32 over runs of ``ssd_bwd_head_run`` heads in
        order, the runs in double; T's row and column sums, dcs, its
        reverse cumulative sum ddA and dA in double, rounded to fp32 once.

    Returns ``(dx, d_dt, dA, dBm, dCm, d_initial_state)`` as
    ``ssd_bwd_reference`` does."""
    Bsz, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if chunk <= 0 or L % chunk:
        raise ValueError(f"ssd: sequence length {L} is not a multiple of chunk {chunk}")
    nc, rep, c = L // chunk, H // G, chunk
    run = ssd_bwd_head_run(rep)
    f32, f64 = torch.float32, torch.float64
    dev = x.device
    x_ = x.reshape(Bsz, nc, c, H, P).to(f32)
    dy_ = dy.reshape(Bsz, nc, c, H, P).to(f32)
    dt_ = dt.reshape(Bsz, nc, c, H).to(f32)
    a = A.to(f32)
    B_ = Bm.reshape(Bsz, nc, c, G, N).to(f32)
    C_ = Cm.reshape(Bsz, nc, c, G, N).to(f32)

    cs = _cumsum_in_order(dt_ * a, dim=2)                    # (B, nc, c, H)
    ecs = torch.exp(cs)
    wend = torch.exp(cs[:, :, -1:] - cs)
    decay = torch.exp(cs[:, :, -1])                          # (B, nc, H)

    def heads(t):                                            # (B, c, G, N) -> (B, c, H, N)
        return torch.repeat_interleave(t, rep, dim=2)

    def outer(parts, rows):                                  # Σ_j w_j ⊗ rows_j, w given in parts
        return sum(torch.einsum("bjhp,bjhn->bhpn", part, rows) for part in parts)

    # every chunk's own states, then one pass carrying S_in and R
    own_f = [outer(_split_bf16(x_[:, z] * (wend[:, z] * dt_[:, z])[..., None]), heads(B_[:, z]))
             for z in range(nc)]
    own_r = [outer(_split_bf16_3(dy_[:, z] * ecs[:, z, ..., None]), heads(C_[:, z])) for z in range(nc)]
    S = (initial_state.to(f32) if initial_state is not None
         else torch.zeros((Bsz, H, P, N), dtype=f32, device=dev))
    s_in = []
    for z in range(nc):
        s_in.append(S)
        S = S * decay[:, z, :, None, None] + own_f[z]
    R = (d_final_state.to(f32) if d_final_state is not None
         else torch.zeros((Bsz, H, P, N), dtype=f32, device=dev))
    r_out = [None] * nc
    for z in reversed(range(nc)):
        r_out[z] = R
        R = R * decay[:, z, :, None, None] + own_r[z]
    d_init = R

    idx = torch.arange(c, device=dev)
    causal = idx[:, None] >= idx[None, :]                    # [i, j]: j <= i
    du = torch.empty_like(x_)
    dB = torch.zeros((Bsz, nc, c, G, N), dtype=f64, device=dev)
    dC = torch.zeros_like(dB)
    dcs = torch.empty((Bsz, nc, c, H), dtype=f64, device=dev)
    for z in range(nc):
        Si, Rz = s_in[z], r_out[z]
        xz, dyz, dtz = x_[:, z], dy_[:, z], dt_[:, z]
        Bz, Cz = B_[:, z], C_[:, z]
        CB = torch.einsum("bign,bjgn->bgij", Cz, Bz)
        CBh = torch.repeat_interleave(CB, rep, dim=1)        # (B, H, c, c)
        csh = cs[:, z].permute(0, 2, 1)                      # (B, H, c)
        Mz = torch.exp(torch.where(causal, csh[..., :, None] - csh[..., None, :], -math.inf))
        Gm = torch.einsum("bihp,bjhp->bhij", dyz, xz) * dtz.permute(0, 2, 1)[:, :, None, :]
        W1, W2 = CBh * Mz, Gm * Mz
        T = (W1 * Gm).to(f64)
        W1h, W1l = _split_bf16(W1)
        W2h, W2l = _split_bf16(W2)
        Rh, Rl = _split_bf16(Rz)
        Sh, Sl = _split_bf16(Si)
        Bh, Ch = heads(Bz), heads(Cz)
        br = torch.einsum("bjhn,bhpn->bjhp", Bh, Rh) + torch.einsum("bjhn,bhpn->bjhp", Bh, Rl)
        xR = torch.einsum("bjhp,bhpn->bjhn", xz, Rh) + torch.einsum("bjhp,bhpn->bjhn", xz, Rl)
        ys = torch.einsum("bihp,bhpn->bihn", dyz, Sh) + torch.einsum("bihp,bhpn->bihn", dyz, Sl)
        w = wend[:, z, ..., None]
        duz = (w * br + torch.einsum("bhij,bihp->bjhp", W1h, dyz)
               + torch.einsum("bhij,bihp->bjhp", W1l, dyz))
        dBh = ((w * dtz[..., None]) * xR + torch.einsum("bhij,bihn->bjhn", W2h, Ch)
               + torch.einsum("bhij,bihn->bjhn", W2l, Ch))
        dCh = (ecs[:, z, ..., None] * ys + torch.einsum("bhij,bjhn->bihn", W2h, Bh)
               + torch.einsum("bhij,bjhn->bihn", W2l, Bh))
        du[:, z] = duz
        for part, acc in ((dBh, dB), (dCh, dC)):             # fp32 in runs of heads, the runs in double
            runs = part.reshape(Bsz, c, G, rep // run, run, N)
            total = torch.zeros_like(runs[:, :, :, :, 0])
            for r in range(run):
                total = total + runs[:, :, :, :, r]
            acc[:, z] = total.to(f64).sum(3)
        off = ecs[:, z] * (Ch * ys).sum(-1)                  # (B, c, H)
        wq = (wend[:, z] * dtz) * (xz * br).sum(-1)
        rs = (Rz.to(f64) * Si.to(f64)).sum((-1, -2))         # (B, H)
        d = (T.sum(-1) - T.sum(-2)).permute(0, 2, 1) + off.to(f64) - wq.to(f64)
        d[:, -1] += decay[:, z].to(f64) * rs + wq.to(f64).sum(1)
        dcs[:, z] = d

    ddA = torch.flip(torch.cumsum(torch.flip(dcs, (2,)), dim=2), (2,))
    dx = (dt_[..., None] * du).reshape(Bsz, L, H, P).to(x.dtype)
    xdu = (x_ * du).sum(-1)
    d_dt = (xdu.to(f64) + a.to(f64) * ddA).to(f32).reshape(Bsz, L, H)
    dA = (dt_.to(f64) * ddA).sum((0, 1, 2)).to(f32)
    dBm = dB.to(f32).reshape(Bsz, L, G, N).to(Bm.dtype)
    dCm = dC.to(f32).reshape(Bsz, L, G, N).to(Cm.dtype)
    return dx, d_dt, dA, dBm, dCm, d_init


def ssd_chunked_reference(
    x: torch.Tensor,    # (B, L, H, P)
    dt: torch.Tensor,   # (B, L, H)
    A: torch.Tensor,    # (H,)
    Bm: torch.Tensor,   # (B, L, G, N)
    Cm: torch.Tensor,   # (B, L, G, N)
    *,
    chunk: int = 256,
    initial_state: Optional[torch.Tensor] = None,  # (B, H, P, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The arithmetic of the bf16 SSD kernel (``csrc/ssd_scan_sm90.cu``),
    step by step: (1) cs, the within-chunk cumulative sum of ``dt * A`` in
    order in fp32; (2) ``CB = C Bᵀ`` once per group; (3) each chunk's own
    state ``Σ_j a_j ⊗ B_j`` with ``a_j = x_j · exp(cs_end - cs_j) · dt_j``
    split into bf16 hi + lo (``_split_bf16``); (4) the state entering each
    chunk, carried in fp32 and split likewise; (5) ``y = exp(cs_i) (C_i ·
    S_in) + M x`` with ``M = (CB · exp(cs_i - cs_j)) · dt_j`` on the causal
    half, split likewise, y rounded once.  Returns ``(y in x's dtype, final state fp32)``."""
    Bsz, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if chunk <= 0 or L % chunk:
        raise ValueError(f"ssd: sequence length {L} is not a multiple of chunk {chunk}")
    nc, rep = L // chunk, H // G
    f32, bf16 = torch.float32, torch.bfloat16
    x_ = x.reshape(Bsz, nc, chunk, H, P).to(f32)
    dt_ = dt.reshape(Bsz, nc, chunk, H).to(f32)
    B_ = Bm.reshape(Bsz, nc, chunk, G, N).to(f32)
    C_ = Cm.reshape(Bsz, nc, chunk, G, N).to(f32)

    cs = _cumsum_in_order(dt_ * A.to(f32), dim=2)           # (B, nc, c, H)

    CB = torch.einsum("bzign,bzjgn->bzgij", C_, B_)          # (B, nc, G, c, c)

    a = x_ * (torch.exp(cs[:, :, -1:] - cs) * dt_)[..., None]  # (B, nc, c, H, P)
    hi, lo = _split_bf16(a)
    Bh = torch.repeat_interleave(B_, rep, dim=3)             # (B, nc, c, H, N)
    states = (torch.einsum("bzjhp,bzjhn->bzhpn", hi, Bh)
              + torch.einsum("bzjhp,bzjhn->bzhpn", lo, Bh))

    decay = torch.exp(cs[:, :, -1])                          # (B, nc, H)
    carry = (initial_state.to(f32) if initial_state is not None
             else torch.zeros((Bsz, H, P, N), dtype=f32, device=x.device))
    s_in = []
    for z in range(nc):
        s_in.append(_split_bf16(carry))
        carry = carry * decay[:, z, :, None, None] + states[:, z]
    s_hi = torch.stack([h for h, _ in s_in], dim=1)          # (B, nc, H, P, N)
    s_lo = torch.stack([l for _, l in s_in], dim=1)

    Ch = torch.repeat_interleave(C_, rep, dim=3)             # (B, nc, c, H, N)
    y_off = (torch.einsum("bzihn,bzhpn->bzihp", Ch, s_hi)
             + torch.einsum("bzihn,bzhpn->bzihp", Ch, s_lo)) * torch.exp(cs)[..., None]
    idx = torch.arange(chunk, device=x.device)
    causal = (idx[:, None] >= idx[None, :])[None, None, None]
    csh = cs.permute(0, 1, 3, 2)                             # (B, nc, H, c)
    seg = torch.where(causal, csh[..., :, None] - csh[..., None, :], 0.0)
    CBh = torch.repeat_interleave(CB, rep, dim=2)            # (B, nc, H, c, c)
    M = (CBh * torch.exp(seg)) * dt_.permute(0, 1, 3, 2)[..., None, :]
    M_hi, M_lo = _split_bf16(torch.where(causal, M, 0.0))
    y = (y_off + torch.einsum("bzhij,bzjhp->bzihp", M_hi, x_)
         + torch.einsum("bzhij,bzjhp->bzihp", M_lo, x_))
    return y.reshape(Bsz, L, H, P).to(x.dtype), carry


def ssd_decode_step(
    state: torch.Tensor,  # (B, H, P, N)
    x: torch.Tensor,      # (B, H, P)
    dt: torch.Tensor,     # (B, H)
    A: torch.Tensor,      # (H,)
    Bm: torch.Tensor,     # (B, G, N)
    Cm: torch.Tensor,     # (B, G, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token SSM recurrence: h ← h·exp(dt·A) + dt·(B ⊗ x); y = C·h.
    Returns (y (B, H, P) in x's dtype, new state in the state's dtype)."""
    H = x.shape[1]
    G = Bm.shape[1]
    rep = H // G
    f32 = torch.float32
    dA = torch.exp(dt.to(f32) * A.to(f32)[None, :])             # (B, H)
    Bh = torch.repeat_interleave(Bm.to(f32), rep, dim=1)        # (B, H, N)
    Ch = torch.repeat_interleave(Cm.to(f32), rep, dim=1)
    dBx = torch.einsum("bhn,bhp->bhpn", Bh, x.to(f32) * dt.to(f32)[..., None])
    new_state = state.to(f32) * dA[..., None, None] + dBx
    y = torch.einsum("bhn,bhpn->bhp", Ch, new_state)
    return y.to(x.dtype), new_state.to(state.dtype)


def rmsnorm_reference(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = _acc(x)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.to(xf.dtype)).to(x.dtype)


def rmsnorm_bwd_reference(
    x: torch.Tensor, w: torch.Tensor, g: torch.Tensor, eps: float = 1e-5
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradients of ``rmsnorm_reference`` at ``x`` (..., D) and ``w``
    (D,) for the output gradient ``g``, its autodiff written out in fp32:
    with ``r = rsqrt(mean(x²) + eps)``,
    ``dx = r·(w∘g) − x·r³·mean(x∘w∘g)`` in x's dtype and
    ``dw = Σ_rows g∘x·r`` in fp32."""
    xf, gf = _acc(x), _acc(g)
    wf = w.to(xf.dtype)
    D = x.shape[-1]
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    wg = wf * gf
    dx = r * wg - xf * (r * r * r) * (torch.sum(xf * wg, dim=-1, keepdim=True) / D)
    dw = torch.sum((gf * xf * r).reshape(-1, D), dim=0)
    return dx.to(x.dtype), dw
