"""Roofline terms of a traced run, with H100 constants (the port of
``launch/roofline.py``).

  compute term    = FLOPs / peak_FLOP/s                  (per rank)
  memory term     = HBM bytes / HBM_bw                   (per rank)
  collective term = collective bytes / link_bw           (per rank)

torch has no HLO text, so ``analyze_hlo`` becomes ``analyze``: one run of a
function under a ``TorchDispatchMode`` that sees every aten op on the
tensors a rank holds.  On DTensors (a mesh) the mode steps aside for the
DTensor op (it returns ``NotImplemented``), and sees the local ops that
DTensor runs on this rank's shards and the ``_c10d_functional`` collectives
of its redistributions, so every term is per rank, as the reference's come
from the SPMD-partitioned HLO.  The ops that DTensor's sharding propagation
runs on fake tensors of the global shapes are not counted.  It accumulates

  * flops        — every op that ``torch.utils.flop_counter`` has a formula
                   for (the registry ``FlopCounterMode`` counts with:
                   matmuls, convolutions, attention), on the local shapes;
  * HBM traffic  — the reference's model of a WELL-FUSED program: operand +
                   result bytes of the data-moving ops (the reference's
                   ``_TRAFFIC_OPS`` mapped to aten: matmuls, convolutions,
                   gathers, scatters, copies, concatenation, padding,
                   reductions, sorts; ``index_copy`` and the slice scatters
                   as a dynamic-update-slice, twice the update), not
                   elementwise ops, which a fused program keeps on chip.
                   torch's transposes and slices are views: they move no
                   data, where XLA's may be copies;
  * collectives  — operand bytes of all-gather / all-reduce /
                   reduce-scatter / all-to-all (collective-permute has no
                   DTensor counterpart), by type, also counted as traffic;
                   ``CommDebugMode`` counts them beside the mode, and the
                   counts must agree.

The port's layer loops are Python loops, unrolled at trace time, so every
layer's ops are seen.  A loop whose every trip issues the same ops on the
same shapes can instead run one trip inside ``loop_trips(n)``: every count
of that trip (flops, traffic, raw bytes, op counts, collectives and the
``ops`` table) is multiplied by ``n``, as the reference's HLO walk
multiplies a while body by its known trip count.  The plain attention does
this on meta tensors (``kernels/ref.py``), where the tile loops of a
32k-token layer would otherwise be traced tile by tile.  An
activation-checkpointed layer's recompute runs in the backward and is
counted, collectives included, as XLA's remat is.  Meta tensors trace the
same ops as real ones without storage, which is how the dry run traces a
production mesh (``launch/dryrun.py``).

  * temporaries  — ``temp_bytes``, the peak of the bytes live in storages
                   that the traced ops allocated on this rank and that are
                   not the run's outputs (XLA's ``temp_size_in_bytes``): a
                   storage counts once however many views share it, from the
                   op that allocates it until its last tensor dies;
                   arguments and what they alias are not counted.  A loop
                   run as one trip allocates one trip's temporaries, as a
                   scan holds one trip's at once.

Constants of one NVIDIA H100 SXM5 at its full power limit of 700 W:

  * ``PEAK_FLOPS`` 989e12 bf16 FLOP/s: dense tensor-core peak (NVIDIA H100
    Tensor Core GPU data sheet, SXM column, without sparsity);
  * ``HBM_BW`` 3.35e12 bytes/s: HBM3 (same data sheet);
  * ``LINK_BW`` 400 Gb/s = 5e10 bytes/s per rank and direction: the
    NDR InfiniBand port each GPU has (NVIDIA DGX H100 data sheet: eight
    ConnectX-7 400 Gb/s ports, one a GPU).  The 16-wide "model" axis spans
    two 8-GPU NVLink domains, so a collective over it is held to the
    slowest link it crosses, the InfiniBand port, not NVLink's 900 GB/s;
  * ``FP32_FLOP_PER_S`` 67e12 and ``FP64_FLOP_PER_S`` 34e12: float32 and
    float64 outside the tensor cores (same data sheet), the rates of the
    kernels' bounds in ``chip_smoke.py``, which reads them from here.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
import weakref
from typing import Any, Dict, List, Optional, Tuple

import torch

# NVIDIA H100 SXM5 constants (module docstring for the sources)
PEAK_FLOPS = 989e12         # bf16 FLOP/s per rank, dense tensor cores
HBM_BW = 3.35e12            # bytes/s per rank
LINK_BW = 400e9 / 8         # bytes/s per rank and direction: NDR InfiniBand
BF16_TENSOR_FLOP_PER_S = PEAK_FLOPS
HBM_BYTES_PER_S = HBM_BW
FP32_FLOP_PER_S = 67e12     # float32 outside the tensor cores
FP64_FLOP_PER_S = 34e12     # float64 outside the tensor cores

_COLLECTIVES = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

# the functional collectives DTensor issues, by the reference's names
_C10D = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}

# ops that MOVE data in a well-fused program, by aten name (the reference's
# dot, convolution, gather, scatter, copy, concatenate, pad, reduce, sort)
_TRAFFIC_OPS = {
    "mm", "bmm", "addmm", "baddbmm", "_scaled_mm",
    "convolution", "_convolution", "convolution_backward",
    "gather", "index", "index_select", "embedding",
    "scatter", "scatter_add", "scatter_reduce", "index_put", "_index_put_impl", "index_add",
    "embedding_dense_backward",
    "clone", "copy",
    "cat",
    "constant_pad_nd",
    "sum", "mean", "amax", "amin", "max", "min", "prod", "logsumexp", "var", "var_mean",
    "argmax", "argmin", "linalg_vector_norm", "any", "all",
    "sort", "topk",
}
# dynamic-update-slice: twice the update's bytes
_UPDATE_OPS = {"index_copy", "slice_scatter", "select_scatter"}

_DTYPE_NAMES = {
    "pred": torch.bool, "s8": torch.int8, "u8": torch.uint8, "s16": torch.int16, "bf16": torch.bfloat16,
    "f16": torch.float16, "s32": torch.int32, "f32": torch.float32, "s64": torch.int64,
    "f64": torch.float64, "c64": torch.complex64, "c128": torch.complex128,
}


def _shape_bytes(shape, dtype) -> int:
    """Bytes of a tensor of ``shape`` and ``dtype`` (a ``torch.dtype`` or
    the HLO name the reference parses, "bf16", "f32", ...)."""
    if isinstance(dtype, str):
        dtype = _DTYPE_NAMES[dtype]
    return math.prod(shape) * dtype.itemsize


_TRIPS: contextvars.ContextVar = contextvars.ContextVar("loop_trips", default=1)


@contextlib.contextmanager
def loop_trips(n: int):
    """Count the traced ops inside as ``n`` trips of a loop (scopes nest:
    their trips multiply).  No-op outside a trace."""
    token = _TRIPS.set(_TRIPS.get() * n)
    try:
        yield
    finally:
        _TRIPS.reset(token)


def _tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _nbytes(tree) -> int:
    return sum(_shape_bytes(t.shape, t.dtype) for t in _tensors(tree))


@dataclasses.dataclass
class TraceAnalysis:
    """Per-rank totals of one traced run (the reference's ``HLOAnalysis``);
    ``raw_bytes`` counts operand + result bytes of every op, fused or not;
    ``ops`` holds each (op, local shapes) once with its totals, a
    collective's key ending in `` @`` and its process group's name;
    ``temp_bytes`` is the peak of the temporaries (module docstring), and
    ``temp_at_peak`` their bytes then, by the op and result that made
    them."""

    flops: float
    traffic_bytes: float
    collective_bytes: Dict[str, float]
    collective_counts: Dict[str, int]
    n_ops: int
    raw_bytes: float = 0.0
    ops: Dict[str, Dict[str, float]] = dataclasses.field(default_factory=dict)
    collective_bytes_by_group: Dict[str, float] = dataclasses.field(default_factory=dict)
    temp_bytes: int = 0
    temp_at_peak: Dict[str, int] = dataclasses.field(default_factory=dict)

    def collective_bytes_by_axis(self, mesh) -> Dict[str, float]:
        """Collective bytes by the mesh axis whose process group ran them."""
        names = {mesh.get_group(a).group_name: a for a in mesh.mesh_dim_names}
        out: Dict[str, float] = {}
        for g, b in self.collective_bytes_by_group.items():
            out[names.get(g, g)] = out.get(names.get(g, g), 0.0) + b
        return out

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())


class _LiveStorages:
    """The storages that the traced ops allocate on this rank, with a
    timeline of their allocations and frees: a storage is known by its
    ``StorageImpl`` (``_cdata``), which every view of it shares, and freed
    when that dies (a finalizer on the storage's Python object, which torch
    keeps alive as long as the storage: a tensor saved for the backward as a
    shallow copy keeps it too)."""

    def __init__(self):
        self.live: Dict[int, int] = {}   # StorageImpl -> allocation number
        self.events: List[Tuple[int, int]] = []  # (allocation number, +/- bytes)
        self.made: Dict[int, str] = {}   # allocation number -> "op dtype[shape]"

    def note(self, op, args, kwargs, out):
        """Record the storages of ``out`` that are new: neither tracked nor
        an input's (a view or in-place result of an argument is the
        argument's)."""
        inputs = None
        for t in _tensors(out):
            st = t.untyped_storage()
            if st._cdata in self.live:
                continue
            if inputs is None:
                inputs = {a.untyped_storage()._cdata for a in _tensors((args, kwargs))}
            if st._cdata in inputs:
                continue
            n = len(self.events)
            self.live[st._cdata] = n
            self.made[n] = f"{op} {_dtype_name(t.dtype)}{list(t.shape)}"
            self.events.append((n, st.nbytes()))
            weakref.finalize(st, self._free, st._cdata, n, st.nbytes())

    def _free(self, key, n, nbytes):
        self.live.pop(key, None)
        self.events.append((n, -nbytes))

    def peak(self, out) -> Tuple[int, Dict[str, int]]:
        """The largest sum of live bytes over the timeline, leaving out the
        allocations that hold ``out``'s tensors (the run's outputs), and the
        bytes live then by the op and result that allocated them."""
        skip = set()
        for t in _tensors(out):
            key = getattr(t, "_local_tensor", t).untyped_storage()._cdata
            if key in self.live:
                skip.add(self.live[key])
        events = [(n, b) for n, b in self.events if n not in skip]
        cur = peak = at = 0
        for i, (_, b) in enumerate(events):
            cur += b
            if cur > peak:
                peak, at = cur, i + 1
        live: Dict[int, int] = {}
        for n, b in events[:at]:
            if b > 0:
                live[n] = b
            else:
                live.pop(n, None)
        by_op: Dict[str, int] = {}
        for n, b in live.items():
            by_op[self.made[n]] = by_op.get(self.made[n], 0) + b
        return peak, dict(sorted(by_op.items(), key=lambda kv: -kv[1]))


def _trace_mode():
    """A ``TorchDispatchMode`` that counts per-rank flops, traffic and
    collective bytes, each multiplied by the active ``loop_trips``, and
    records the storages its ops allocate (built here: the module imports no
    dispatch machinery until a trace runs)."""
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    class _Mode(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.an = TraceAnalysis(0.0, 0.0, {k: 0.0 for k in _COLLECTIVES}, {k: 0 for k in _COLLECTIVES}, 0)
            self.storages = _LiveStorages()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented  # DTensor runs it on the local shards, which come back here
            out = func(*args, **kwargs)
            if any(issubclass(t, FakeTensor) for t in types) or any(
                    isinstance(t, FakeTensor) for t in _tensors(out)):
                return out  # sharding propagation on the global shapes, not this rank's work
            self._count(func, args, kwargs, out, _TRIPS.get())
            self.storages.note(func._overloadpacket._qualified_op_name, args, kwargs, out)
            return out

        def _count(self, func, args, kwargs, out, trips):
            an = self.an
            packet = func._overloadpacket
            ns, name = packet._qualified_op_name.split("::")
            an.n_ops += trips
            flops = 0.0
            if packet in flop_registry:
                flops = float(flop_registry[packet](*args, **kwargs, out_val=out))
            traffic = 0.0
            where = ""
            coll = _C10D.get(name) if ns == "_c10d_functional" else None
            if coll is not None:
                ob = _nbytes(args)
                an.collective_bytes[coll] += trips * ob
                an.collective_counts[coll] += trips
                group = [a for a in args if isinstance(a, str)][-1]  # the op's group name
                an.collective_bytes_by_group[group] = an.collective_bytes_by_group.get(group, 0.0) + trips * ob
                traffic += ob
                where = f" @{group}"
            elif name in _UPDATE_OPS:
                # the update: index_copy's source (argument 3), a slice scatter's src (1)
                upd = args[3] if name == "index_copy" else args[1]
                traffic += 2 * _nbytes(upd)
            elif name in _TRAFFIC_OPS:
                traffic += _nbytes(args) + _nbytes(out)
            an.flops += trips * flops
            an.traffic_bytes += trips * traffic
            an.raw_bytes += trips * (_nbytes(args) + _nbytes(out))
            key = f"{ns}::{name} " + " ".join(
                f"{_dtype_name(t.dtype)}{list(t.shape)}" for t in _tensors(args)) + where
            rec = an.ops.setdefault(key, {"count": 0, "flops": 0.0, "bytes": 0.0})
            rec["count"] += trips
            rec["flops"] += trips * flops
            rec["bytes"] += trips * traffic

    return _Mode()


def _dtype_name(dtype) -> str:
    for k, v in _DTYPE_NAMES.items():
        if v == dtype:
            return k
    return str(dtype).replace("torch.", "")


def analyze(fn, *args, **kwargs) -> Tuple[Any, TraceAnalysis]:
    """``(fn(*args, **kwargs), its per-rank analysis)``: one run under the
    counting mode, with ``CommDebugMode`` around it; the two counts of
    collectives must agree."""
    from torch.distributed.tensor.debug import CommDebugMode

    with CommDebugMode() as comm:
        mode = _trace_mode()
        with mode:
            out = fn(*args, **kwargs)
    an = mode.an
    an.temp_bytes, an.temp_at_peak = mode.storages.peak(out)
    seen = sum(an.collective_counts.values())
    counted = comm.get_total_counts()
    if seen != counted:
        raise RuntimeError(f"the trace saw {seen} collectives, CommDebugMode counted {counted}: "
                           f"{dict(comm.get_comm_counts())}")
    return out, an


@dataclasses.dataclass
class Roofline:
    flops: float               # per-rank flops of the traced run
    hbm_bytes: float           # per-rank bytes of the traffic model
    collective_bytes: float    # per-rank collective operand bytes
    model_flops: float         # 6·N·D (train) / 2·N·B (decode), N_active
    n_chips: int
    raw_cost_flops: float = 0.0
    raw_cost_bytes: float = 0.0
    collective_detail: Optional[Dict[str, float]] = None
    collective_counts: Optional[Dict[str, int]] = None

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        ts = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(ts, key=ts.get)

    @property
    def useful_flops_ratio(self) -> float:
        total = self.flops * self.n_chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Achieved fraction of the compute roofline: time to do the USEFUL
        flops at peak vs. the dominant-term time of the traced program."""
        t_useful = (self.model_flops / self.n_chips) / PEAK_FLOPS
        t_bound = max(self.t_compute, self.t_memory, self.t_collective)
        return t_useful / t_bound if t_bound else 0.0

    def as_dict(self) -> Dict:
        return {
            "flops_per_chip": self.flops,
            "hbm_bytes_per_chip": self.hbm_bytes,
            "collective_bytes_per_chip": self.collective_bytes,
            "raw_cost_flops": self.raw_cost_flops,
            "raw_cost_bytes": self.raw_cost_bytes,
            "model_flops": self.model_flops,
            "n_chips": self.n_chips,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "collective_bytes_by_type": self.collective_detail,
            "collective_count_by_type": self.collective_counts,
        }


def roofline_from_trace(an: TraceAnalysis, *, model_flops: float, n_chips: int) -> Roofline:
    """The roofline of a traced step (the reference's
    ``roofline_from_compiled``).  torch has no ``cost_analysis``: the raw
    fields hold the traced flops and the operand + result bytes of every
    op, fused or not (the upper bound the reference's raw bytes are)."""
    return Roofline(
        flops=an.flops,
        hbm_bytes=an.traffic_bytes,
        collective_bytes=an.total_collective_bytes,
        model_flops=model_flops,
        n_chips=n_chips,
        raw_cost_flops=an.flops,
        raw_cost_bytes=an.raw_bytes,
        collective_detail=an.collective_bytes,
        collective_counts=an.collective_counts,
    )


def kernel_roofline(fn, *args) -> Roofline:
    """Single-rank roofline for one kernel body (data-plane reporting).

    The fused-program traffic model counts only data-movement ops, which
    reports **zero** bytes for a pure elementwise body — but a standalone
    kernel must still stream its operands and results through HBM, so its
    input and output bytes are applied as a floor.  ``model_flops`` is the
    traced flops (relational bodies have no model-level count), so
    ``useful_flops_ratio`` is 1.0 by construction."""
    out, an = analyze(fn, *args)
    io_bytes = _nbytes(list(args)) + _nbytes(out)
    return Roofline(
        flops=an.flops,
        hbm_bytes=max(an.traffic_bytes, float(io_bytes)),
        collective_bytes=an.total_collective_bytes,
        model_flops=an.flops,
        n_chips=1,
        collective_detail=an.collective_bytes,
        collective_counts=an.collective_counts,
    )


def is_bandwidth_bound(fn, *args) -> bool:
    """True when the memory term dominates the compute term for ``fn``.
    Reported only (``TorchPlane.roofline_report``): unlike the reference's,
    the port's relational dispatch never reads it."""
    r = kernel_roofline(fn, *args)
    return r.t_memory >= r.t_compute


def train_model_flops(n_active_params: float, tokens: float) -> float:
    return 6.0 * n_active_params * tokens


def decode_model_flops(n_active_params: float, batch: float) -> float:
    return 2.0 * n_active_params * batch
