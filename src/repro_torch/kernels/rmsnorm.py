"""Fused RMSNorm: ``x * rsqrt(mean(x**2) + eps) * w``, fp32 inside.

Replaces ``src/repro/kernels/rmsnorm.py::rmsnorm_pallas``.  The CUDA source
is ``src/repro_torch/csrc/rmsnorm.cu`` (one block per row, an fp32 sum of
squares reduced through warp shuffles), built by ``kernels/_build.py`` at
first use and bound with ``ctypes``.

``rmsnorm`` is the wrapper: on CUDA tensors it launches the kernel (or
raises); on CPU tensors it runs ``ref.rmsnorm_reference``, the plain
PyTorch version.  ``rmsnorm.launches`` counts kernel launches.

Gradients.  When grad mode is on and x or w requires grad, the wrapper goes
through ``RMSNorm``, a ``torch.autograd.Function`` that saves (x, w); its
backward is ``rmsnorm_bwd``, the hand-written
``src/repro_torch/csrc/rmsnorm_bwd.cu`` (one pass over the rows that reads x
and g once, writes dx in x's dtype and fp32 partials of dw per strip of
rows, then the partials summed in a fixed order: deterministic), counted by
``rmsnorm_bwd.launches``.  On CPU tensors the
Function runs the plain forward and ``ref.rmsnorm_bwd_reference``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import rmsnorm_bwd_reference, rmsnorm_reference

SOURCE = _build.CudaSource("rmsnorm")
SOURCE_BWD = _build.CudaSource("rmsnorm_bwd")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Normalise ``x`` (..., D) over its last axis and scale by ``w`` (D,);
    the result has x's dtype.  The kernel for CUDA tensors, the plain
    version for CPU tensors, ``ValueError`` for anything else."""
    on_cpu = _build.on_cpu("rmsnorm", x, w)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return RMSNorm.apply(x, w, eps)
    return rmsnorm_reference(x, w, eps) if on_cpu else _launch(x, w, eps)


rmsnorm.launches = 0


class RMSNorm(torch.autograd.Function):
    """RMSNorm with a hand-written backward (``rmsnorm_bwd``)."""

    @staticmethod
    def forward(ctx, x, w, eps):
        out = rmsnorm_reference(x, w, eps) if _build.on_cpu("rmsnorm", x, w) else _launch(x, w, eps)
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw = rmsnorm_bwd(x, w, g.contiguous(), ctx.eps)
        return dx, dw.to(w.dtype), None


def rmsnorm_bwd(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor, eps: float = 1e-5):
    """``(dx in x's dtype, dw fp32)``, the gradients of ``rmsnorm(x, w, eps)``
    for the output gradient ``g``: the backward kernel for CUDA tensors,
    ``ref.rmsnorm_bwd_reference`` for CPU tensors, ``ValueError`` for
    anything else."""
    if _build.on_cpu("rmsnorm backward", x, w, g):
        return rmsnorm_bwd_reference(x, w, g, eps)
    _check(x, w)
    if g.shape != x.shape or g.dtype != x.dtype or not g.is_contiguous():
        raise ValueError(f"rmsnorm backward: g must be a contiguous {tuple(x.shape)} {x.dtype}, got "
                         f"{tuple(g.shape)} {g.dtype}")
    w = w.to(torch.float32).contiguous()
    D = x.shape[-1]
    rows = x.numel() // D if D else 0
    dx = torch.empty_like(x)
    dw = torch.empty((D,), dtype=torch.float32, device=x.device)  # the kernel writes every column
    if rows == 0:
        return dx, dw.zero_()
    lib = _library_bwd()
    vec = _vec(x, w, g, dx)
    part = torch.empty((lib.veer_rmsnorm_bwd_partials(rows, D, vec), D), dtype=torch.float32,
                       device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.veer_rmsnorm_bwd(x.data_ptr(), w.data_ptr(), g.data_ptr(), dx.data_ptr(), dw.data_ptr(),
                                  part.data_ptr(), _DTYPES[x.dtype], rows, D, float(eps), vec, stream)
    _build.check(lib, rc, "rmsnorm backward kernel")
    rmsnorm_bwd.launches += 1
    return dx, dw


rmsnorm_bwd.launches = 0


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dtype not in _DTYPES:
        raise ValueError(f"rmsnorm kernel takes fp32 or bf16 x, got {x.dtype}")
    D = x.shape[-1]
    if w.shape != (D,):
        raise ValueError(f"rmsnorm weight must have shape ({D},), got {tuple(w.shape)}")
    if not x.is_contiguous():
        raise ValueError("rmsnorm kernel needs a contiguous x")


def _vec(x: torch.Tensor, *tensors: torch.Tensor) -> int:
    """Values in one 16-byte access, or 1 where a row or a pointer is not
    16-byte aligned."""
    vec = 16 // x.element_size()
    if x.shape[-1] % vec or any(t.data_ptr() % 16 for t in (x,) + tensors):
        vec = 1
    return vec


def _launch(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    _check(x, w)
    D = x.shape[-1]
    w = w.to(torch.float32).contiguous()  # the reference reads w in fp32 too
    out = torch.empty_like(x)
    rows = x.numel() // D if D else 0
    if rows == 0:
        return out
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.veer_rmsnorm(x.data_ptr(), w.data_ptr(), out.data_ptr(), _DTYPES[x.dtype], rows,
                              D, float(eps), _vec(x, w, out), stream)
    _build.check(lib, rc, "rmsnorm kernel")
    rmsnorm.launches += 1
    return out


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    lib.veer_rmsnorm.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.veer_rmsnorm.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=1)
def _library_bwd() -> ctypes.CDLL:
    lib = _build.load(SOURCE_BWD)
    lib.veer_rmsnorm_bwd_partials.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
    lib.veer_rmsnorm_bwd_partials.restype = ctypes.c_longlong
    lib.veer_rmsnorm_bwd.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.veer_rmsnorm_bwd.restype = ctypes.c_int
    return lib
