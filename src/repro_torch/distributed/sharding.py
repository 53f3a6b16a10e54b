"""Logical→physical sharding translation + activation constraints (the port
of ``distributed/sharding.py``, on ``torch.distributed.tensor``).

Model code speaks *logical* axes ("dp", "tp"); the launcher binds them to the
physical mesh: dp → ("pod","data") on the multi-pod mesh or ("data",) on a
single pod; tp → ("model",).  ``logical_to_physical`` keeps the reference's
value, one entry per tensor dimension (``None``, a mesh axis name, or a tuple
of names), so it equals ``tuple(PartitionSpec)`` of the reference entry for
entry.  ``placements`` turns such a tuple into DTensor placements on a
``DeviceMesh``, one per mesh dimension: ``Shard(i)`` on every mesh dimension
that tensor dimension ``i`` names, ``Replicate()`` on the rest.

``constrain`` is a no-op outside an active mesh context, so model code runs
unmodified on plain tensors; inside one it redistributes a DTensor to the
spec's placements (JAX's ``with_sharding_constraint``) and raises on a plain
tensor.  ``mesh_context`` also lets the plain tensors a model makes inside
it (positions, masks) count as replicated (``implicit_replication``).
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Any, List, NamedTuple, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor

LogicalAxis = Union[None, str, Tuple[str, ...]]
PhysicalAxis = Union[None, str, Tuple[str, ...]]

_CTX: contextvars.ContextVar = contextvars.ContextVar("shard_ctx", default=None)


def _translate_axis(ax: LogicalAxis, multi_pod: bool) -> PhysicalAxis:
    if ax is None:
        return None
    if isinstance(ax, tuple):
        out: Tuple[str, ...] = ()
        for a in ax:
            t = _translate_axis(a, multi_pod)
            if t is None:
                continue
            out += t if isinstance(t, tuple) else (t,)
        return out if out else None
    if ax == "dp":
        return ("pod", "data") if multi_pod else "data"
    if ax == "tp":
        return "model"
    raise ValueError(f"unknown logical axis {ax!r}")


def logical_to_physical(spec: Sequence[LogicalAxis], multi_pod: bool) -> Tuple[PhysicalAxis, ...]:
    """One entry per tensor dimension; a tuple of one axis is that axis, as
    JAX's ``PartitionSpec`` normalizes it."""
    out = (_translate_axis(a, multi_pod) for a in spec)
    return tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a for a in out)


def placements(physical: Sequence[PhysicalAxis], mesh) -> List[Any]:
    """DTensor placements on ``mesh`` for a physical spec: one per mesh
    dimension.  A tensor dimension over several mesh axes is split in mesh
    order (the first axis outermost), as DTensor splits it; a spec that
    names them in another order, names an axis the mesh lacks, or names one
    axis twice raises."""
    names = list(mesh.mesh_dim_names or ())
    out: List[Any] = [Replicate() for _ in names]
    for dim, ax in enumerate(physical):
        if ax is None:
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        idx = []
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {tuple(physical)}: mesh axes {tuple(names)} have no {a!r}")
            idx.append(names.index(a))
        if idx != sorted(idx):
            raise ValueError(f"spec {tuple(physical)}: dimension {dim} names {axes} out of the mesh's "
                             f"order {tuple(names)}; DTensor would place its shards otherwise")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {tuple(physical)}: mesh axis {names[i]!r} shards two dimensions")
            out[i] = Shard(dim)
    return out


class Sharding(NamedTuple):
    """A leaf's sharding: the mesh and its placements there (JAX's
    ``NamedSharding``)."""

    mesh: Any
    placements: Tuple[Any, ...]


def _is_spec(s) -> bool:
    return isinstance(s, tuple) and all(x is None or isinstance(x, (str, tuple)) for x in s)


def _map_specs(fn, spec_tree):
    if isinstance(spec_tree, dict):
        return {k: _map_specs(fn, v) for k, v in spec_tree.items()}
    if not _is_spec(spec_tree):
        raise TypeError(f"not a logical spec: {spec_tree!r}")
    return fn(spec_tree)


def spec_tree_to_shardings(spec_tree, mesh, multi_pod: bool):
    """The ``Sharding`` (mesh, placements) of every leaf of a tree of
    logical specs."""
    return _map_specs(
        lambda s: Sharding(mesh, tuple(placements(logical_to_physical(s, multi_pod), mesh))), spec_tree)


def shard_tree(tree, spec_tree, mesh, multi_pod: bool):
    """Every tensor of ``tree`` distributed over ``mesh`` by its logical spec
    (``distribute_tensor``: each rank keeps its shard of the global tensor;
    on a mesh of one rank the shard is the tensor itself, not a copy)."""
    if isinstance(tree, dict):
        return {k: shard_tree(tree[k], spec_tree[k], mesh, multi_pod) for k in tree}
    where = placements(logical_to_physical(spec_tree, multi_pod), mesh)
    if mesh.size() == 1:
        return DTensor.from_local(tree, mesh, where, run_check=False)
    return distribute_tensor(tree, mesh, where)


def local_tree(tree):
    """Every DTensor of ``tree`` as the full tensor it stands for."""
    if isinstance(tree, dict):
        return {k: local_tree(v) for k, v in tree.items()}
    return tree.full_tensor() if isinstance(tree, DTensor) else tree


def split_dims(t, dim: int) -> List[Tuple[int, int]]:
    """``(mesh dimension, ranks)`` of each mesh dimension that splits axis
    ``dim`` of a DTensor ``t``, in mesh order; empty for a plain tensor."""
    if not isinstance(t, DTensor):
        return []
    dim %= t.dim()
    return [(i, n) for i, (p, n) in enumerate(zip(t.placements, t.device_mesh.shape))
            if p.is_shard() and p.dim % t.dim() == dim]


def shard_offset(mesh, dims: Sequence[Tuple[int, int]], size: int) -> int:
    """This rank's first index of an axis of ``size`` split over ``dims``
    (``split_dims``), chunked as ``torch.chunk`` and DTensor chunk it."""
    coord, lo = mesh.get_coordinate(), 0
    for i, n in dims:
        chunk = -(-size // n)
        lo += coord[i] * chunk
        size = max(0, min(chunk, size - coord[i] * chunk))
    return lo


def all_reduce_over(t: torch.Tensor, op: str, mesh, dims: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """``t`` (a rank's local tensor) reduced by ``op`` over the ranks of the
    mesh dimensions ``dims``: the collective a ``local_map`` body issues."""
    import torch.distributed._functional_collectives as funcol

    for i, _ in dims:
        t = funcol.all_reduce(t, op, (mesh, i))
    return t


def even(n: int, ax: LogicalAxis, mesh) -> LogicalAxis:
    """``ax`` where the ranks it names on ``mesh`` split ``n`` evenly, else
    None: ``local_map`` builds its outputs' global shapes from even shards."""
    names = list(mesh.mesh_dim_names or ())
    phys = _translate_axis(ax, "pod" in names)
    ranks = 1
    for a in (phys if isinstance(phys, tuple) else (phys,)) if phys is not None else ():
        ranks *= mesh.size(names.index(a))
    return ax if n % ranks == 0 else None


def row_placements(x) -> Tuple[Any, ...]:
    """A DTensor's placements with its last axis whole and partial sums
    reduced: its rows as they are laid out, each row whole on its rank."""
    last = x.dim() - 1
    return tuple(Replicate() if p.is_partial() or (p.is_shard() and p.dim % x.dim() == last) else p
                 for p in x.placements)


def on_local_shards(fn, args, specs, out_specs):
    """``fn`` on the local shards of DTensor ``args`` through ``local_map``:
    ``specs`` and ``out_specs`` are the logical layout of each argument and
    output ("dp", "tp" or None a dimension) or its placements; an argument
    laid out otherwise is redistributed first.  The gradient of an argument
    that is replicated on a mesh dimension where another argument or an
    output is split is a partial sum there (each rank's covers its own
    shard)."""
    from torch.distributed.tensor.experimental import local_map

    mesh = next(a for a in args if isinstance(a, DTensor)).device_mesh
    multi_pod = "pod" in (mesh.mesh_dim_names or ())

    def lay(spec):
        if spec and not isinstance(spec[0], (str, tuple, type(None))):
            return tuple(spec)  # placements already
        return tuple(placements(logical_to_physical(spec, multi_pod), mesh))

    ins, outs = [lay(s) for s in specs], [lay(s) for s in out_specs]
    split = [any(not isinstance(p[i], Replicate) for p in ins + outs) for i in range(mesh.ndim)]
    grads = [tuple(Partial() if split[i] and isinstance(p[i], Replicate) else p[i] for i in range(mesh.ndim))
             for p in ins]
    # one output's placements are a list, several outputs' a tuple of lists
    return local_map(fn, out_placements=list(outs[0]) if len(outs) == 1 else tuple(map(list, outs)),
                     in_placements=tuple(map(list, ins)), in_grad_placements=tuple(map(list, grads)),
                     device_mesh=mesh, redistribute_inputs=True)(*args)


@contextlib.contextmanager
def mesh_context(mesh, multi_pod: bool):
    """Activate ``mesh`` for ``constrain`` and let plain tensors count as
    replicated (``implicit_replication``), in this thread.  Contexts nest:
    an inner one leaves the switch as it found it.  Neither follows the work
    into autograd's device threads, so ``layers.checkpointed`` enters the
    context again around a recomputed forward."""
    from torch.distributed.tensor.experimental import implicit_replication

    token = _CTX.set((mesh, multi_pod))
    try:
        # implicit_replication turns the switch off on exit, so only a
        # context that finds it off turns it on
        on = DTensor._op_dispatcher._allow_implicit_replication
        with contextlib.nullcontext() if on else implicit_replication():
            yield
    finally:
        _CTX.reset(token)


def active_mesh() -> Optional[Tuple[Any, bool]]:
    """``(mesh, multi_pod)`` of the active mesh context, or None."""
    return _CTX.get()


def constrain(x: torch.Tensor, spec: Sequence[LogicalAxis]) -> torch.Tensor:
    """``x`` redistributed to ``spec`` on the active mesh (no-op outside a
    mesh context).  Inside one, a plain tensor raises: its sharding is not
    known, so the constraint cannot hold."""
    ctx = _CTX.get()
    if ctx is None:
        return x
    mesh, multi_pod = ctx
    if not isinstance(x, DTensor):
        raise TypeError(f"constrain{tuple(spec)}: a plain {type(x).__name__} inside a mesh context; "
                        f"the model's inputs and parameters must be DTensors on the mesh")
    want = placements(logical_to_physical(spec, multi_pod), mesh)
    if tuple(x.placements) == tuple(want):
        return x
    return x.redistribute(mesh, want)
