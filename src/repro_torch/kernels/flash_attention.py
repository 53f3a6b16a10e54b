"""Flash attention, forward: GQA, causal / sliding-window / chunked-local.

Replaces ``src/repro/kernels/flash_attention.py::flash_attention_pallas``.
The CUDA source is ``src/repro_torch/csrc/flash_attention.cu`` (one block per
(64-row q tile, batch x head), the fp32 online-softmax state in registers,
fully masked kv tiles skipped), built by ``kernels/_build.py`` at first use
and bound with ``ctypes``.

``flash_attention`` is the wrapper: on CUDA tensors it launches the kernel
(or raises); on CPU tensors it runs ``ref.flash_attention_reference``, the
plain PyTorch version, blocked as the reference's flash forward is.
``flash_attention.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import _inv_sqrt, flash_attention_reference

SOURCE = _build.CudaSource("flash_attention")
HEAD_DIMS = (16, 32, 64, 128)  # the kernel's instances
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
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
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.veer_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPES[q.dtype],
            B, S, T, H, KV, D, int(bool(causal)), int(window is not None), int(window or 0),
            int(chunk is not None), int(chunk or 0), int(q_offset), _inv_sqrt(D), stream,
        )
    _build.check(lib, rc, "flash attention kernel")
    flash_attention.launches += 1
    return out


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    lib.veer_flash_attention_fwd.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 13 + [ctypes.c_float, ctypes.c_void_p]
    )
    lib.veer_flash_attention_fwd.restype = ctypes.c_int
    return lib
