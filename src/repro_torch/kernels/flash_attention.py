"""Flash attention, forward and backward: GQA, causal / sliding-window /
chunked-local.

Replaces ``src/repro/kernels/flash_attention.py::flash_attention_pallas``.
Two hand-written CUDA instances, built by ``kernels/_build.py`` at first use
and bound with ``ctypes``; the dtype picks one:

  * bf16: ``src/repro_torch/csrc/flash_attention_sm90.cu``, both products
    as ``wgmma`` on Hopper's tensor cores (one block per 128-row q tile of
    one batch x head, K/V tiles copied ahead with ``cp.async``, P split
    into bf16 hi + lo for the second product).  Its arithmetic, rounding for
    rounding, is ``ref.flash_attention_tc_reference``.
  * fp32: ``src/repro_torch/csrc/flash_attention.cu``, fp32 FMAs on the
    CUDA cores (TF32 would not hold the fp32 tolerance of 2e-6).

``flash_attention`` is the wrapper: on CUDA tensors it launches the instance
of their dtype (or raises); on CPU tensors it runs
``ref.flash_attention_reference``, the plain PyTorch version, blocked as the
reference's flash forward is.  ``flash_attention.launches`` counts kernel
launches, ``launches_tc`` and ``launches_fp32`` those of each instance.

Gradients.  When grad mode is on and q, k or v requires grad, the wrapper
takes CUDA tensors through ``FlashAttention``, a ``torch.autograd.Function`` (the
reference's ``jax.custom_vjp`` at ``src/repro/kernels/ref.py:94``; the
masks and ``q_offset`` are not differentiable, as its ``nondiff_argnums``).
Its forward launches the forward instance with an ``lse`` output (the
row's natural-log sum of exponentials; serving passes a null pointer) and
saves (q, k, v, o, lse); its backward is ``flash_attention_bwd``, two
hand-written instances picked by dtype as the forward's are:

  * bf16: ``src/repro_torch/csrc/flash_attention_bwd_sm90.cu``, every
    product as ``wgmma`` on the tensor cores (δ, then one block per 128 keys
    for dK/dV, then one per 128 query rows for dQ; TMA copies; P and dS
    split into bf16 hi + lo).  Its arithmetic is
    ``ref.flash_attention_bwd_tc_reference``.
  * fp32: ``src/repro_torch/csrc/flash_attention_bwd.cu``, fp32 FMAs on the
    CUDA cores.

``flash_attention_bwd.launches`` counts its launches, ``launches_tc`` and
``launches_fp32`` those of each instance.  On CPU tensors the wrapper runs
the plain version, whose gradient is the same custom VJP on the plain forward
(``ref._flash_fwd_impl``) and ``ref.flash_attention_bwd_reference``.  No path
returns an output that silently has no graph.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (NEG_INF, _inv_sqrt, flash_attention_bwd_reference,
                                     flash_attention_reference)

SOURCE = _build.CudaSource("flash_attention")          # the fp32 instance
SOURCE_TC = _build.CudaSource("flash_attention_sm90")  # the bf16 instance
SOURCE_BWD = _build.CudaSource("flash_attention_bwd")          # the backward's fp32 instance
SOURCE_BWD_TC = _build.CudaSource("flash_attention_bwd_sm90")  # its bf16 instance
HEAD_DIMS = (16, 32, 64, 128)  # the head dims each instance is built for
_DTYPES = (torch.float32, torch.bfloat16)
_I32 = 2**31 - 1


def flash_attention(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, T, KV, D)
    v: torch.Tensor,  # (B, T, KV, D)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    chunk: Optional[int] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Attention of q over k, v with the given masks, shifted by
    ``q_offset`` (the absolute position of q's first row).  The kernel for
    CUDA tensors, the plain version for CPU tensors, ``ValueError`` for
    anything else."""
    if _build.on_cpu("flash attention", q, k, v):  # differentiable through the reference's VJP
        return flash_attention_reference(q, k, v, causal=causal, window=window, chunk=chunk,
                                         q_offset=q_offset)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, window, chunk, q_offset)
    return _launch(q, k, v, causal, window, chunk, q_offset)[0]


flash_attention.launches = 0
flash_attention.launches_tc = 0
flash_attention.launches_fp32 = 0


class FlashAttention(torch.autograd.Function):
    """Flash attention on the card with hand-written kernels both ways: the
    port of the reference's ``_flash`` custom VJP (the forward saves (q, k,
    v, o, lse), the backward recomputes the block probabilities from lse).
    Its host counterpart is ``ref.FlashAttentionVJP``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, chunk, q_offset):
        out, lse = _launch(q, k, v, causal, window, chunk, q_offset, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.masks = dict(causal=causal, window=window, chunk=chunk, q_offset=q_offset)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, g.contiguous(), **ctx.masks)
        return dq, dk, dv, None, None, None, None


def flash_attention_bwd(
    q: torch.Tensor,    # (B, S, H, D)
    k: torch.Tensor,    # (B, T, KV, D)
    v: torch.Tensor,    # (B, T, KV, D)
    out: torch.Tensor,  # (B, S, H, D) the forward's output
    lse: torch.Tensor,  # (B, S, H) fp32 the forward's log-sum-exp
    g: torch.Tensor,    # (B, S, H, D) the output's gradient
    *,
    causal: bool = True,
    window: Optional[int] = None,
    chunk: Optional[int] = None,
    q_offset: int = 0,
):
    """``(dq, dk, dv)`` in q's, k's and v's dtype: the backward instance of
    their dtype for CUDA tensors, ``ref.flash_attention_bwd_reference`` for
    CPU tensors, ``ValueError`` for anything else."""
    if _build.on_cpu("flash attention backward", q, k, v, out, lse, g):
        return flash_attention_bwd_reference(q, k, v, out, lse, g, causal=causal, window=window,
                                             chunk=chunk, q_offset=q_offset)
    _check(q, k, v, window, chunk, q_offset)
    B, S, H, D = q.shape
    if out.shape != q.shape or g.shape != q.shape or out.dtype != q.dtype or g.dtype != q.dtype:
        raise ValueError(f"flash attention backward: o and dO must be {tuple(q.shape)} {q.dtype}, got "
                         f"{tuple(out.shape)} {out.dtype} and {tuple(g.shape)} {g.dtype}")
    if lse.shape != (B, S, H) or lse.dtype != torch.float32:
        raise ValueError(f"flash attention backward: lse must be {(B, S, H)} fp32, got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    for t in (out, g, lse):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("flash attention backward needs contiguous, 16-byte aligned o, dO, lse")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if B == 0 or S == 0 or H == 0:
        return dq, dk.zero_(), dv.zero_()
    tc = q.dtype == torch.bfloat16
    lib = _library_bwd_tc() if tc else _library_bwd()
    if tc:  # lse * log2(e) and δ, each (B, H, S rounded up to 128)
        scratch = torch.empty((lib.veer_flash_attention_bwd_tc_scratch(B, S, H),), dtype=torch.float32,
                              device=q.device)
    else:  # δ
        scratch = torch.empty((B, S, H), dtype=torch.float32, device=q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(), g.data_ptr(),
            scratch.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, S, k.shape[1], H, k.shape[2],
            D, *_masks(causal, window, chunk, q_offset), _inv_sqrt(D))
    fn = lib.veer_flash_attention_bwd_tc if tc else lib.veer_flash_attention_bwd
    with torch.cuda.device(q.device):
        rc = fn(*args, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, rc, "flash attention backward kernel")
    flash_attention_bwd.launches += 1
    if tc:
        flash_attention_bwd.launches_tc += 1
    else:
        flash_attention_bwd.launches_fp32 += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.launches_tc = 0
flash_attention_bwd.launches_fp32 = 0


def _masks(causal, window, chunk, q_offset):
    return (int(bool(causal)), int(window is not None), int(window or 0),
            int(chunk is not None), int(chunk or 0), int(q_offset))


def _check(q, k, v, window, chunk, q_offset) -> None:
    """What both kernels take: shapes, dtypes, layout and int32 positions."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("flash attention takes q (B, S, H, D) and k, v (B, T, KV, D)")
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or KV == 0 or H % KV:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} do not fit GQA")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash attention kernel takes fp32 or bf16 q, k, v of one dtype, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash attention kernel is built for head dims {HEAD_DIMS}, got {D}")
    for t in (q, k, v):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("flash attention kernel needs contiguous, 16-byte aligned q, k, v")
    if B * H > 65535:
        raise ValueError(f"flash attention kernel: batch x heads {B * H} beyond 65535")
    for name, val in (("window", window), ("chunk", chunk)):
        if val is not None and not 0 < val <= _I32:
            raise ValueError(f"flash attention kernel: {name} must be a positive int32, got {val}")
    if not (0 <= q_offset and q_offset + S + 64 <= _I32 and T + 64 <= _I32):
        raise ValueError(f"flash attention kernel: positions beyond int32 (q_offset {q_offset})")


def _launch(q, k, v, causal, window, chunk, q_offset, with_lse: bool = False):
    """``(out, lse)``: the forward instance of q's dtype; ``lse`` (B, S, H)
    fp32 when ``with_lse`` (training), else None and a null pointer."""
    _check(q, k, v, window, chunk, q_offset)
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((B, S, H), dtype=torch.float32, device=q.device) if with_lse else None
    if B == 0 or S == 0 or H == 0:
        return out, lse
    if T == 0 and with_lse:  # no keys: acc = 0 and l = 0, as the kernels leave them
        return out.zero_(), lse.fill_(NEG_INF)
    masks = _masks(causal, window, chunk, q_offset)
    tc = q.dtype == torch.bfloat16
    lib = _library_tc() if tc else _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr() if with_lse else None)
        if tc:
            rc = lib.veer_flash_attention_fwd_tc(*ptrs, B, S, T, H, KV, D, *masks, _inv_sqrt(D),
                                                 stream)
        else:
            rc = lib.veer_flash_attention_fwd(*ptrs, 0, B, S, T, H, KV, D, *masks, _inv_sqrt(D),
                                              stream)
    _build.check(lib, rc, "flash attention kernel")
    flash_attention.launches += 1
    if tc:
        flash_attention.launches_tc += 1
    else:
        flash_attention.launches_fp32 += 1
    return out, lse


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    lib.veer_flash_attention_fwd.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 13 + [ctypes.c_float, ctypes.c_void_p]
    )
    lib.veer_flash_attention_fwd.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=1)
def _library_tc() -> ctypes.CDLL:
    lib = _build.load(SOURCE_TC)
    lib.veer_flash_attention_fwd_tc.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 12 + [ctypes.c_float, ctypes.c_void_p]
    )
    lib.veer_flash_attention_fwd_tc.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=1)
def _library_bwd() -> ctypes.CDLL:
    lib = _build.load(SOURCE_BWD)
    lib.veer_flash_attention_bwd.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 12 + [ctypes.c_float, ctypes.c_void_p]
    )
    lib.veer_flash_attention_bwd.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=1)
def _library_bwd_tc() -> ctypes.CDLL:
    lib = _build.load(SOURCE_BWD_TC)
    lib.veer_flash_attention_bwd_tc_scratch.argtypes = [ctypes.c_int] * 3
    lib.veer_flash_attention_bwd_tc_scratch.restype = ctypes.c_longlong
    lib.veer_flash_attention_bwd_tc.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 12 + [ctypes.c_float, ctypes.c_void_p]
    )
    lib.veer_flash_attention_bwd_tc.restype = ctypes.c_int
    return lib
