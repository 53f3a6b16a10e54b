"""Dispatch for the LLM kernels (the port of ``kernels/ops.py``).

``impl`` is one of:
  * ``"auto"``      — the hand-written Hopper kernel for CUDA tensors, the
                      plain PyTorch version for CPU tensors;
  * ``"cuda"``      — the kernel; raises ``ValueError`` for CPU tensors;
  * ``"reference"`` — the plain PyTorch version, asked for by name, on any
                      device.

On DTensors (a mesh, ``distributed/sharding.py``) each op runs, in the
implementation ``impl`` names, through ``local_map`` with its placements
declared: batch over "dp", heads over "tp" (each where its ranks split it
evenly), rows and sequences local, so a kernel (or plain version) sees
local shards and never a DTensor.  An input laid out otherwise is
redistributed first.  The gradient of an input that is replicated where
others are sharded is a partial sum (``Partial``).  Where the query heads
are split and the KV heads are not (GQA, KV heads fewer than the axis),
each rank takes the KV heads its query heads use.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.distributed.sharding import even, on_local_shards, row_placements, shard_offset
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention as _flash_kernel
from repro_torch.kernels.rmsnorm import rmsnorm as _rmsnorm_kernel
from repro_torch.kernels.ssd_scan import ssd_scan as _ssd_kernel

IMPLS = ("auto", "cuda", "reference")


def _dtensors(*tensors):
    return any(isinstance(t, DTensor) for t in tensors)


def _kv_heads(mesh, H: int, KV: int):
    """The KV heads this rank's query heads use, when the query heads split
    evenly over the mesh's "model" axis and the KV heads do not: a slice of
    them where this rank's query heads cover whole GQA groups (or share
    one), else an index of each query head's KV head; None on a mesh of one
    rank on that axis."""
    i = list(mesh.mesh_dim_names).index("model")
    n = mesh.size(i)
    if n == 1:
        return None
    per, group = H // n, H // KV
    lo = shard_offset(mesh, [(i, n)], H)
    if per % group == 0 or group % per == 0:
        return slice(lo // group, (lo + per - 1) // group + 1)
    return torch.arange(lo, lo + per) // group


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
    if _dtensors(q, k, v):
        mesh = next(t for t in (q, k, v) if _dtensors(t)).device_mesh
        B, H, KV = q.shape[0], q.shape[2], k.shape[2]
        dp, q_ax = even(B, "dp", mesh), even(H, "tp", mesh)
        kv_ax = even(KV, "tp", mesh) if q_ax else None

        def local(q, k, v):
            if q_ax and not kv_ax:
                part = _kv_heads(mesh, H, KV)
                if isinstance(part, torch.Tensor):
                    k, v = (t.index_select(2, part.to(t.device)) for t in (k, v))
                elif part is not None:
                    k, v = k[:, :, part], v[:, :, part]
            return flash_attention(q, k, v, causal=causal, window=window, chunk=chunk, q_offset=q_offset,
                                   impl=impl, q_block=q_block, kv_block=kv_block)

        qs, kvs = (dp, None, q_ax, None), (dp, None, kv_ax, None)
        return on_local_shards(local, (q, k, v), (qs, kvs, kvs), (qs,))
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
    if _dtensors(*tensors):
        mesh = next(t for t in tensors if _dtensors(t)).device_mesh
        dp, hs = even(x.shape[0], "dp", mesh), even(x.shape[2], "tp", mesh)
        xs, bs = (dp, None, hs, None), (dp, None, None, None)
        specs = [xs, (dp, None, hs), (hs,), bs, bs]
        outs = [xs, (dp, hs, None, None)]

        def local(x, dt, A, Bm, Cm, *init):
            return ssd(x, dt, A, Bm, Cm, chunk=chunk, initial_state=init[0] if init else None, impl=impl)

        if initial_state is not None:
            specs.append(outs[1])
        return on_local_shards(local, tensors, specs, outs)
    if impl == "reference":
        return ref.ssd_reference(x, dt, A, Bm, Cm, chunk=chunk, initial_state=initial_state)
    return _ssd_kernel(x, dt, A, Bm, Cm, chunk=chunk, initial_state=initial_state)


def rmsnorm(
    x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5, *, impl: str = "auto"
) -> torch.Tensor:
    _check(impl, "rmsnorm", x, w)
    if _dtensors(x, w):
        # the rows keep the layout they come in (between layers batch over
        # "dp" and sequence over "tp"), each row whole on its rank
        xs = row_placements(x)
        return on_local_shards(lambda x, w: rmsnorm(x, w, eps, impl=impl), (x, w), (xs, (None,)), (xs,))
    if impl == "reference":
        return ref.rmsnorm_reference(x, w, eps)
    return _rmsnorm_kernel(x, w, eps)
