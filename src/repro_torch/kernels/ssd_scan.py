"""Mamba-2 SSD scan, forward: the chunked state-space duality of
arXiv:2405.21060.

Replaces ``src/repro/kernels/ssd_scan.py::ssd_pallas``.  Two hand-written
CUDA instances, built by ``kernels/_build.py`` at first use and bound with
``ctypes``; the dtype of x, B and C picks one:

  * bf16: ``src/repro_torch/csrc/ssd_scan_sm90.cu``, the chunk-parallel form
    on Hopper's tensor cores (five kernels in order: the cumulative sums,
    C·Bᵀ once per group, each chunk's own state with its left operand split
    into bf16 hi + lo, the sequential state pass, each chunk's output with
    the state entering it and its intra-chunk weights split likewise).  Its
    arithmetic, rounding for rounding, is ``ref.ssd_chunked_reference``.  It
    takes chunk in ``TC_CHUNKS``, P a multiple of 64 and N in ``TC_STATES``,
    and raises on other shapes.  Its 16-byte asynchronous copies need x, B
    and C with strides that are multiples of 8 elements and 16-byte aligned
    bases: a view without them is copied to a contiguous tensor first.
  * fp32: ``src/repro_torch/csrc/ssd_scan.cu``, one block per batch, head and
    64-wide tile of the head dimension, looping over the chunks in order with
    the state in shared memory, fp32 FMAs on the CUDA cores.

``ssd_scan`` is the wrapper: on CUDA tensors it launches the instance of
their dtype (or raises), an ``initial_state`` included, which both read; on
CPU tensors it runs ``ref.ssd_reference``, the plain PyTorch version.
``ssd_scan.launches`` counts calls that launched, ``launches_tc`` and
``launches_fp32`` those of each instance.

The kernel has no backward yet: on CUDA tensors with grad mode on and an
input that requires grad, the wrapper raises ``NotImplementedError``
(``refuse_grad``) instead of returning an output with no graph.  On CPU
tensors the plain version is differentiated by autograd.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ssd_reference

SOURCE = _build.CudaSource("ssd_scan")          # the fp32 instance
SOURCE_TC = _build.CudaSource("ssd_scan_sm90")  # the bf16 instance
_DTYPES = (torch.float32, torch.bfloat16)
TC_CHUNKS = (64, 128, 256)
TC_STATES = (64, 128)
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
    refuse_grad(*tensors)
    return _launch(x, dt, A, Bm, Cm, chunk, initial_state)


ssd_scan.launches = 0
ssd_scan.launches_tc = 0
ssd_scan.launches_fp32 = 0


def refuse_grad(*tensors: torch.Tensor) -> None:
    """Raise if a gradient is asked of the kernel, which has none yet: a
    wrong (missing) gradient must not pass for a right one."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "the ssd_scan kernel has no backward yet (ROADMAP queue 1, item 4: the SSD backward); "
            "differentiate the ssm and hybrid families on the plain path, attn_impl='reference'")


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
    tc = x.dtype == torch.bfloat16
    if tc and (chunk not in TC_CHUNKS or P % 64 or N not in TC_STATES):
        raise ValueError(f"ssd_scan bf16 kernel takes chunk in {TC_CHUNKS}, P a multiple of 64 "
                         f"and N in {TC_STATES}; got chunk={chunk}, P={P}, N={N}")
    lib = _library_tc() if tc else _library()
    if not tc:
        smem = lib.veer_ssd_scan_smem_bytes(N, chunk)
        if smem > MAX_SMEM_BYTES:
            raise ValueError(f"ssd_scan kernel: N={N}, chunk={chunk} need {smem} bytes of shared "
                             f"memory a block, more than {MAX_SMEM_BYTES}")
    # the reference casts dt, A and the initial state to fp32 (exact from bf16)
    dt, A = dt.to(torch.float32), A.to(torch.float32).contiguous()
    if tc:
        x, Bm, Cm = (t if _copyable(t) else t.clone(memory_format=torch.contiguous_format)
                     for t in (x, Bm, Cm))
    else:
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
    ptrs = (x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            init.data_ptr() if init is not None else None, y.data_ptr(), state.data_ptr())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if tc:
            sizes = (ctypes.c_longlong * 4)()
            lib.veer_ssd_scan_tc_scratch(Bsz, L, H, P, G, N, chunk, sizes)
            scratch = [torch.empty(n, dtype=torch.uint8, device=x.device) for n in sizes]
            rc = lib.veer_ssd_scan_tc(*ptrs, *(t.data_ptr() for t in scratch),
                                      Bsz, L, H, P, G, N, chunk, strides, stream)
        else:
            rc = lib.veer_ssd_scan(*ptrs, 0, Bsz, L, H, P, G, N, chunk, strides, stream)
    _build.check(lib, rc, "ssd_scan kernel")
    ssd_scan.launches += 1
    if tc:
        ssd_scan.launches_tc += 1
    else:
        ssd_scan.launches_fp32 += 1
    return y, state


def _copyable(t: torch.Tensor) -> bool:
    """Whether the bf16 kernel's 16-byte copies can read ``t`` in place."""
    return t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in t.stride()[:-1])


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


@functools.lru_cache(maxsize=1)
def _library_tc() -> ctypes.CDLL:
    lib = _build.load(SOURCE_TC)
    lib.veer_ssd_scan_tc_scratch.argtypes = [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_longlong)]
    lib.veer_ssd_scan_tc_scratch.restype = None
    lib.veer_ssd_scan_tc.argtypes = (
        [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
    lib.veer_ssd_scan_tc.restype = ctypes.c_int
    return lib
