"""Mamba-2 SSD scan, forward: the chunked state-space duality of
arXiv:2405.21060, fp32 inside.

Replaces ``src/repro/kernels/ssd_scan.py::ssd_pallas``.  The CUDA source is
``src/repro_torch/csrc/ssd_scan.cu`` (one block per batch, head and 64-wide
tile of the head dimension, looping over the chunks in order with the state
in shared memory), built by ``kernels/_build.py`` at first use and bound
with ``ctypes``.

``ssd_scan`` is the wrapper: on CUDA tensors it launches the kernel (or
raises), an ``initial_state`` included, which the kernel reads; on CPU
tensors it runs ``ref.ssd_reference``, the plain PyTorch version.
``ssd_scan.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ssd_reference

SOURCE = _build.CudaSource("ssd_scan")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_SMEM_BYTES = 232_448  # what one block may use on the H100 (227 KB)


def ssd_scan(
    x: torch.Tensor,    # (B, L, H, P)
    dt: torch.Tensor,   # (B, L, H)
    A: torch.Tensor,    # (H,)
    Bm: torch.Tensor,   # (B, L, G, N)
    Cm: torch.Tensor,   # (B, L, G, N)
    *,
    chunk: int = 256,
    initial_state: Optional[torch.Tensor] = None,  # (B, H, P, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(y (B, L, H, P) in x's dtype, final state (B, H, P, N) fp32)``.
    The kernel for CUDA tensors, the plain version for CPU tensors,
    ``ValueError`` for anything else."""
    tensors = [x, dt, A, Bm, Cm] + ([initial_state] if initial_state is not None else [])
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return ssd_reference(x, dt, A, Bm, Cm, chunk=chunk, initial_state=initial_state)
    if kinds != {"cuda"} or len({t.device for t in tensors}) != 1:
        raise ValueError(f"ssd_scan kernel needs every input on one CUDA device, got "
                         f"{sorted({str(t.device) for t in tensors})}")
    return _launch(x, dt, A, Bm, Cm, chunk, initial_state)


ssd_scan.launches = 0


def _launch(x, dt, A, Bm, Cm, chunk, initial_state):
    Bsz, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if x.dtype not in _DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise ValueError(f"ssd_scan kernel takes x, Bm and Cm of one dtype, fp32 or bf16; got "
                         f"{x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if dt.shape != (Bsz, L, H) or A.shape != (H,) or Bm.shape != (Bsz, L, G, N) \
            or Cm.shape != Bm.shape or G <= 0 or H % G:
        raise ValueError(f"ssd_scan shapes do not fit: x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"A {tuple(A.shape)}, Bm {tuple(Bm.shape)}, Cm {tuple(Cm.shape)}")
    if chunk <= 0 or L % chunk:
        raise ValueError(f"ssd: sequence length {L} is not a multiple of chunk {chunk}")
    lib = _library()
    smem = lib.veer_ssd_scan_smem_bytes(N, chunk)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"ssd_scan kernel: N={N}, chunk={chunk} need {smem} bytes of shared "
                         f"memory a block, more than {MAX_SMEM_BYTES}")
    # the reference casts dt, A and the initial state to fp32 (exact from bf16)
    dt, A = dt.to(torch.float32), A.to(torch.float32).contiguous()
    x, Bm, Cm = (t if t.stride(-1) == 1 else t.contiguous() for t in (x, Bm, Cm))
    init = None
    if initial_state is not None:
        if initial_state.shape != (Bsz, H, P, N):
            raise ValueError(f"initial_state must be {(Bsz, H, P, N)}, got {tuple(initial_state.shape)}")
        init = initial_state.to(torch.float32).contiguous()
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    state = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y, state.zero_() if init is None else state.copy_(init)
    strides = (ctypes.c_longlong * 15)(
        *x.stride()[:3], *dt.stride(), *Bm.stride()[:3], *Cm.stride()[:3], *y.stride()[:3])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.veer_ssd_scan(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            init.data_ptr() if init is not None else None, y.data_ptr(), state.data_ptr(),
            _DTYPES[x.dtype], Bsz, L, H, P, G, N, chunk, strides, stream)
    _build.check(lib, rc, "ssd_scan kernel")
    ssd_scan.launches += 1
    return y, state


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    lib.veer_ssd_scan_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.veer_ssd_scan_smem_bytes.restype = ctypes.c_longlong
    lib.veer_ssd_scan.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p,
    ]
    lib.veer_ssd_scan.restype = ctypes.c_int
    return lib
