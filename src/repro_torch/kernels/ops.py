"""Dispatch for the LLM kernels (the port of ``kernels/ops.py``).

``impl`` is one of:
  * ``"auto"``      — the hand-written Hopper kernel for CUDA tensors, the
                      plain PyTorch version for CPU tensors;
  * ``"cuda"``      — the kernel; raises ``ValueError`` for CPU tensors;
  * ``"reference"`` — the plain PyTorch version, asked for by name, on any
                      device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention as _flash_kernel
from repro_torch.kernels.rmsnorm import rmsnorm as _rmsnorm_kernel
from repro_torch.kernels.ssd_scan import ssd_scan as _ssd_kernel

IMPLS = ("auto", "cuda", "reference")


def _check(impl: str, what: str, *tensors: torch.Tensor) -> None:
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; one of {IMPLS}")
    if impl == "cuda" and any(t.device.type != "cuda" for t in tensors):
        raise ValueError(f"{what}: impl='cuda' needs CUDA tensors, got "
                         f"{sorted({str(t.device) for t in tensors})}")


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    chunk: Optional[int] = None,
    q_offset: int = 0,
    impl: str = "auto",
    q_block: int = 512,
    kv_block: int = 512,
) -> torch.Tensor:
    _check(impl, "flash_attention", q, k, v)
    if impl == "reference":
        return ref.flash_attention_reference(
            q, k, v, causal=causal, window=window, chunk=chunk,
            q_block=q_block, kv_block=kv_block, q_offset=q_offset,
        )
    return _flash_kernel(q, k, v, causal=causal, window=window, chunk=chunk, q_offset=q_offset)


def ssd(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    Bm: torch.Tensor,
    Cm: torch.Tensor,
    *,
    chunk: int = 256,
    initial_state: Optional[torch.Tensor] = None,
    impl: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    tensors = (x, dt, A, Bm, Cm) + ((initial_state,) if initial_state is not None else ())
    _check(impl, "ssd", *tensors)
    if impl == "reference":
        return ref.ssd_reference(x, dt, A, Bm, Cm, chunk=chunk, initial_state=initial_state)
    return _ssd_kernel(x, dt, A, Bm, Cm, chunk=chunk, initial_state=initial_state)


def rmsnorm(
    x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5, *, impl: str = "auto"
) -> torch.Tensor:
    _check(impl, "rmsnorm", x, w)
    if impl == "reference":
        return ref.rmsnorm_reference(x, w, eps)
    return _rmsnorm_kernel(x, w, eps)
