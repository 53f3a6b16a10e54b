"""Flash attention, forward: GQA, causal / sliding-window / chunked-local.

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
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import _inv_sqrt, flash_attention_reference

SOURCE = _build.CudaSource("flash_attention")          # the fp32 instance
SOURCE_TC = _build.CudaSource("flash_attention_sm90")  # the bf16 instance
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
    kinds = {t.device.type for t in (q, k, v)}
    if kinds == {"cpu"}:
        return flash_attention_reference(q, k, v, causal=causal, window=window, chunk=chunk,
                                         q_offset=q_offset)
    if kinds != {"cuda"} or len({t.device for t in (q, k, v)}) != 1:
        raise ValueError(f"flash attention kernel needs q, k, v on one CUDA device, got {kinds}")
    return _launch(q, k, v, causal, window, chunk, q_offset)


flash_attention.launches = 0
flash_attention.launches_tc = 0
flash_attention.launches_fp32 = 0


def _launch(q, k, v, causal, window, chunk, q_offset) -> torch.Tensor:
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
    out = torch.empty_like(q)
    if B == 0 or S == 0 or H == 0:
        return out
    masks = (int(bool(causal)), int(window is not None), int(window or 0),
             int(chunk is not None), int(chunk or 0), int(q_offset))
    tc = q.dtype == torch.bfloat16
    lib = _library_tc() if tc else _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
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
    return out


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    lib.veer_flash_attention_fwd.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 13 + [ctypes.c_float, ctypes.c_void_p]
    )
    lib.veer_flash_attention_fwd.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=1)
def _library_tc() -> ctypes.CDLL:
    lib = _build.load(SOURCE_TC)
    lib.veer_flash_attention_fwd_tc.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 12 + [ctypes.c_float, ctypes.c_void_p]
    )
    lib.veer_flash_attention_fwd_tc.restype = ctypes.c_int
    return lib
