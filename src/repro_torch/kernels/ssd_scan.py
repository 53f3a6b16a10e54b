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

Gradients.  When grad mode is on and an input requires grad, the wrapper
goes through ``SSDScan``, a ``torch.autograd.Function`` whose forward
launches what the wrapper launches and saves the inputs; its backward is
``ssd_scan_bwd``, deterministic (no atomics, every sum in a fixed order)
with two hand-written instances:

  * bf16 x, B and C at the tensor-core shapes (chunk in ``TC_CHUNKS``, P in
    ``TC_BWD_HEAD_DIMS``, N in ``TC_STATES``):
    ``src/repro_torch/csrc/ssd_scan_bwd_sm90.cu``, the chunk-parallel form on
    ``wgmma`` (the forward's cumulative sums, C·Bᵀ once per group and the
    chunks' own states, then their own reverse states, one pass over the
    chunks for S_in and R, every chunk's column and row tiles, the ordered
    sums).  Its arithmetic is ``ref.ssd_bwd_tc_reference``.  Counted by
    ``ssd_scan_bwd.launches_tc``.
  * fp32, and bf16 at any other shape: ``src/repro_torch/csrc/ssd_scan_bwd.cu``
    on the CUDA cores (the states entering the chunks and the gradients
    leaving them scanned first, then every chunk's gradients at once, then
    the per-head partials summed in order).

``ssd_scan_bwd.launches`` counts every launch, ``launches_bf16`` and
``launches_fp32`` those of each dtype; ``launches_bf16 - launches_tc`` are
the bf16 calls the shape rule sends to the CUDA cores.  On CPU tensors the Function runs the
plain forward and ``ref.ssd_bwd_reference``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ssd_bwd_reference, ssd_reference

SOURCE = _build.CudaSource("ssd_scan")          # the fp32 instance
SOURCE_TC = _build.CudaSource("ssd_scan_sm90")  # the bf16 instance
SOURCE_BWD = _build.CudaSource("ssd_scan_bwd")  # the backward on the CUDA cores, fp32 and bf16
SOURCE_BWD_TC = _build.CudaSource("ssd_scan_bwd_sm90")  # the bf16 backward on the tensor cores
_DTYPES = (torch.float32, torch.bfloat16)
TC_CHUNKS = (64, 128, 256)
TC_STATES = (64, 128)
TC_BWD_HEAD_DIMS = (64,)  # P of the tensor-core backward
BWD_MAX_STATE = 128       # the CUDA-core backward keeps two 64-column tiles of N in registers
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
    on_cpu = _build.on_cpu("ssd_scan", *tensors)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return SSDScan.apply(x, dt, A, Bm, Cm, initial_state, chunk)
    return _forward(on_cpu, x, dt, A, Bm, Cm, chunk, initial_state)


ssd_scan.launches = 0
ssd_scan.launches_tc = 0
ssd_scan.launches_fp32 = 0


def _forward(on_cpu, x, dt, A, Bm, Cm, chunk, initial_state):
    if on_cpu:
        return ssd_reference(x, dt, A, Bm, Cm, chunk=chunk, initial_state=initial_state)
    return _launch(x, dt, A, Bm, Cm, chunk, initial_state)


class SSDScan(torch.autograd.Function):
    """The SSD scan with a hand-written backward (``ssd_scan_bwd``); both
    outputs, y and the final state, are differentiable, and a gradient
    autograd does not pass (the final state's, where it is unused) is zero."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, initial_state, chunk):
        tensors = [x, dt, A, Bm, Cm] + ([initial_state] if initial_state is not None else [])
        y, state = _forward(_build.on_cpu("ssd_scan", *tensors), x, dt, A, Bm, Cm, chunk, initial_state)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, Bm, Cm, initial_state)
        ctx.chunk = chunk
        return y, state

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy, d_state):
        x, dt, A, Bm, Cm, init = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        dx, d_dt, dA, dBm, dCm, d_init = ssd_scan_bwd(
            x, dt, A, Bm, Cm, dy, chunk=ctx.chunk, initial_state=init, d_final_state=d_state)
        return (dx, d_dt.to(dt.dtype), dA.to(A.dtype), dBm, dCm,
                None if init is None else d_init.to(init.dtype), None)


def ssd_scan_bwd(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    Bm: torch.Tensor,
    Cm: torch.Tensor,
    dy: torch.Tensor,   # (B, L, H, P) the gradient of y
    *,
    chunk: int = 256,
    initial_state: Optional[torch.Tensor] = None,
    d_final_state: Optional[torch.Tensor] = None,  # (B, H, P, N); None: zero
) -> Tuple[torch.Tensor, ...]:
    """``(dx, d_dt, dA, dBm, dCm, d_initial_state)``, the gradients of
    ``ssd_scan`` (dx, dBm and dCm in their inputs' dtypes, the rest fp32):
    the backward kernel for CUDA tensors, ``ref.ssd_bwd_reference`` for CPU
    tensors, ``ValueError`` for anything else (mixed devices, a shape the
    kernel cannot take)."""
    tensors = [t for t in (x, dt, A, Bm, Cm, dy, initial_state, d_final_state) if t is not None]
    if _build.on_cpu("ssd_scan backward", *tensors):
        return ssd_bwd_reference(x, dt, A, Bm, Cm, dy, chunk=chunk, initial_state=initial_state,
                                 d_final_state=d_final_state)
    return _launch_bwd(x, dt, A, Bm, Cm, dy, chunk, initial_state, d_final_state)


ssd_scan_bwd.launches = 0
ssd_scan_bwd.launches_bf16 = 0
ssd_scan_bwd.launches_fp32 = 0
ssd_scan_bwd.launches_tc = 0


def bwd_on_tensor_cores(dtype: torch.dtype, P: int, N: int, chunk: int) -> bool:
    """The shape rule of the backward: bf16 at chunk in ``TC_CHUNKS``, P in
    ``TC_BWD_HEAD_DIMS`` and N in ``TC_STATES`` runs on the tensor cores;
    any other bf16 shape, and fp32, on the CUDA cores."""
    return dtype == torch.bfloat16 and chunk in TC_CHUNKS and P in TC_BWD_HEAD_DIMS and N in TC_STATES


def _check_shapes(x, dt, A, Bm, Cm, chunk):
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
    return Bsz, L, H, P, G, N


def _state(t, shape, what):
    if t is None:
        return None
    if t.shape != shape:
        raise ValueError(f"{what} must be {shape}, got {tuple(t.shape)}")
    return t.to(torch.float32).contiguous()


def _launch_bwd(x, dt, A, Bm, Cm, dy, chunk, initial_state, d_final_state):
    Bsz, L, H, P, G, N = _check_shapes(x, dt, A, Bm, Cm, chunk)
    if dy.shape != x.shape:
        raise ValueError(f"ssd_scan backward: dy must be {tuple(x.shape)}, got {tuple(dy.shape)}")
    tc = bwd_on_tensor_cores(x.dtype, P, N, chunk)
    if not tc:
        if N > BWD_MAX_STATE:
            raise ValueError(f"ssd_scan backward kernel takes N up to {BWD_MAX_STATE}, got N={N}")
        smem = _library_bwd().veer_ssd_scan_bwd_smem_bytes(N, chunk)
        if smem > MAX_SMEM_BYTES:
            raise ValueError(f"ssd_scan backward kernel: N={N}, chunk={chunk} need {smem} bytes of shared "
                             f"memory a block, more than {MAX_SMEM_BYTES}")
    init = _state(initial_state, (Bsz, H, P, N), "initial_state")
    d_final = _state(d_final_state, (Bsz, H, P, N), "d_final_state")
    x, Bm, Cm, dy = (_contiguous(t) for t in (x, Bm, Cm, dy.to(x.dtype)))
    dt, A = dt.to(torch.float32).contiguous(), A.to(torch.float32).contiguous()
    f32 = dict(dtype=torch.float32, device=x.device)
    dx, dBm, dCm = torch.empty_like(x), torch.empty_like(Bm), torch.empty_like(Cm)
    d_dt, dA = torch.empty((Bsz, L, H), **f32), torch.empty((H,), **f32)
    d_init = torch.empty((Bsz, H, P, N), **f32)
    if x.numel() == 0 or N == 0:
        return (dx.zero_(), d_dt.zero_(), dA.zero_(), dBm.zero_(), dCm.zero_(),
                d_init.zero_() if d_final is None else d_init.copy_(d_final))
    ptrs = (x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), dy.data_ptr(),
            init.data_ptr() if init is not None else None,
            d_final.data_ptr() if d_final is not None else None,
            dx.data_ptr(), d_dt.data_ptr(), dA.data_ptr(), dBm.data_ptr(), dCm.data_ptr(), d_init.data_ptr())
    bf16 = x.dtype == torch.bfloat16
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if tc:
            lib = _library_bwd_tc()
            scratch = torch.empty(lib.veer_ssd_scan_bwd_tc_scratch(Bsz, L, H, P, G, N, chunk), dtype=torch.uint8,
                                  device=x.device)
            rc = lib.veer_ssd_scan_bwd_tc(*ptrs, scratch.data_ptr(), Bsz, L, H, P, G, N, chunk, stream)
        else:
            lib = _library_bwd()
            sizes = (ctypes.c_longlong * 6)()
            lib.veer_ssd_scan_bwd_scratch(Bsz, L, H, P, N, chunk, sizes)
            scratch = [torch.empty(n, dtype=torch.uint8, device=x.device) for n in sizes]
            rc = lib.veer_ssd_scan_bwd(*ptrs, *(t.data_ptr() for t in scratch), int(bf16), Bsz, L, H, P, G, N,
                                       chunk, stream)
    _build.check(lib, rc, "ssd_scan backward kernel")
    ssd_scan_bwd.launches += 1
    if bf16:
        ssd_scan_bwd.launches_bf16 += 1
        ssd_scan_bwd.launches_tc += int(tc)
    else:
        ssd_scan_bwd.launches_fp32 += 1
    return dx, d_dt, dA, dBm, dCm, d_init


def _contiguous(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous with a 16-byte aligned base (the tensor-core
    backward's asynchronous copies read 16 bytes at a time)."""
    return t if t.is_contiguous() and t.data_ptr() % 16 == 0 else t.clone(memory_format=torch.contiguous_format)


def _launch(x, dt, A, Bm, Cm, chunk, initial_state):
    Bsz, L, H, P, G, N = _check_shapes(x, dt, A, Bm, Cm, chunk)
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
    init = _state(initial_state, (Bsz, H, P, N), "initial_state")
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


@functools.lru_cache(maxsize=1)
def _library_bwd() -> ctypes.CDLL:
    lib = _build.load(SOURCE_BWD)
    lib.veer_ssd_scan_bwd_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.veer_ssd_scan_bwd_smem_bytes.restype = ctypes.c_longlong
    lib.veer_ssd_scan_bwd_scratch.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_longlong)]
    lib.veer_ssd_scan_bwd_scratch.restype = None
    lib.veer_ssd_scan_bwd.argtypes = [ctypes.c_void_p] * 20 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.veer_ssd_scan_bwd.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=1)
def _library_bwd_tc() -> ctypes.CDLL:
    lib = _build.load(SOURCE_BWD_TC)
    lib.veer_ssd_scan_bwd_tc_scratch.argtypes = [ctypes.c_int] * 7
    lib.veer_ssd_scan_bwd_tc_scratch.restype = ctypes.c_longlong
    lib.veer_ssd_scan_bwd_tc_head_run.argtypes = [ctypes.c_int]
    lib.veer_ssd_scan_bwd_tc_head_run.restype = ctypes.c_int
    lib.veer_ssd_scan_bwd_tc.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.veer_ssd_scan_bwd_tc.restype = ctypes.c_int
    return lib
