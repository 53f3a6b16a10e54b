"""Fused RMSNorm: ``x * rsqrt(mean(x**2) + eps) * w``, fp32 inside.

Replaces ``src/repro/kernels/rmsnorm.py::rmsnorm_pallas``.  The CUDA source
is ``src/repro_torch/csrc/rmsnorm.cu`` (one block per row, an fp32 sum of
squares reduced through warp shuffles), built by ``kernels/_build.py`` at
first use and bound with ``ctypes``.

``rmsnorm`` is the wrapper: on CUDA tensors it launches the kernel (or
raises); on CPU tensors it runs ``ref.rmsnorm_reference``, the plain
PyTorch version.  ``rmsnorm.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import rmsnorm_reference

SOURCE = _build.CudaSource("rmsnorm")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Normalise ``x`` (..., D) over its last axis and scale by ``w`` (D,);
    the result has x's dtype.  The kernel for CUDA tensors, the plain
    version for CPU tensors, ``ValueError`` for anything else."""
    kinds = {x.device.type, w.device.type}
    if kinds == {"cpu"}:
        return rmsnorm_reference(x, w, eps)
    if kinds != {"cuda"} or x.device != w.device:
        raise ValueError(f"rmsnorm kernel needs x and w on one CUDA device, got {x.device}, {w.device}")
    return _launch(x, w, eps)


rmsnorm.launches = 0


def _launch(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    if x.dtype not in _DTYPES:
        raise ValueError(f"rmsnorm kernel takes fp32 or bf16 x, got {x.dtype}")
    D = x.shape[-1]
    if w.shape != (D,):
        raise ValueError(f"rmsnorm weight must have shape ({D},), got {tuple(w.shape)}")
    if not x.is_contiguous():
        raise ValueError("rmsnorm kernel needs a contiguous x")
    w = w.to(torch.float32).contiguous()  # the reference reads w in fp32 too
    out = torch.empty_like(x)
    rows = x.numel() // D if D else 0
    if rows == 0:
        return out
    lib = _library()
    vec = 16 // x.element_size()  # values in one 16-byte access
    if D % vec or any(t.data_ptr() % 16 for t in (x, w, out)):
        vec = 1
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.veer_rmsnorm(x.data_ptr(), w.data_ptr(), out.data_ptr(), _DTYPES[x.dtype], rows,
                              D, float(eps), vec, stream)
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
