"""Shared layers and parameter definitions (the port of ``models/layers.py``).

Parameters are declared once as ``PD(shape, spec, init)`` trees (nested
dicts); ``init_tree`` turns a tree into real tensors on a given device,
``abstract_tree`` into meta tensors of each leaf's shape and dtype (the
reference's ShapeDtypeStructs: no storage), and ``spec_tree`` into the
logical sharding specs ("dp", "tp") that ``distributed/sharding.py`` binds
to a mesh.

One difference from the reference: ``rms_norm`` takes an ``impl`` and goes
through ``ops.rmsnorm``, so on the card the hand-written RMSNorm kernel runs
on every norm of the model, forward and (through its autograd Function)
backward.  The reference pins ``impl="reference"`` there, a dispatch choice
for the TPU; its Pallas kernel computes the same function
(``tests/test_kernels.py`` holds the two to 1e-6).  ``checkpointed`` is the
models' remat.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.utils.checkpoint
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.distributed.sharding import active_mesh, all_reduce_over, mesh_context, shard_offset, split_dims
from repro_torch.kernels import ops as kops


@dataclasses.dataclass(frozen=True)
class PD:
    """Parameter definition: shape + logical partition spec + init scale."""

    shape: Tuple[int, ...]
    spec: Tuple[Optional[str], ...]
    init: str = "normal"        # normal | zeros | ones
    scale: float = 0.02
    dtype: Any = torch.float32

    def __post_init__(self):
        if len(self.shape) != len(self.spec):
            raise ValueError(f"shape {self.shape} and spec {self.spec} differ in rank")


def tree_map(fn, tree):
    """Apply ``fn`` to every leaf of a tree of nested dicts."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree, prefix: str = ""):
    """``(path, leaf)`` pairs in sorted key order, paths joined by "/"."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k], f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def tree_from_leaves(pairs) -> Dict[str, Any]:
    """The tree of nested dicts whose ``tree_leaves`` are ``pairs``."""
    out: Dict[str, Any] = {}
    for path, leaf in pairs:
        node = out
        keys = path.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf
    return out


def init_tree(defs, generator: torch.Generator, device) -> Dict[str, Any]:
    """Real tensors for a tree of ``PD``s, on ``device``: normal draws times
    the scale from ``generator`` (which lives on that device) in sorted key
    order, zeros and ones."""
    def make(pd: PD) -> torch.Tensor:
        if pd.init == "zeros":
            return torch.zeros(pd.shape, dtype=pd.dtype, device=device)
        if pd.init == "ones":
            return torch.ones(pd.shape, dtype=pd.dtype, device=device)
        t = torch.empty(pd.shape, dtype=torch.float32, device=device)
        t.normal_(0.0, pd.scale, generator=generator)
        return t.to(pd.dtype)

    return tree_from_leaves((path, make(pd)) for path, pd in tree_leaves(defs))


def abstract_tree(defs) -> Dict[str, Any]:
    """A meta tensor of every ``PD``'s shape and dtype."""
    return tree_map(lambda pd: torch.empty(pd.shape, dtype=pd.dtype, device="meta"), defs)


def spec_tree(defs) -> Dict[str, Any]:
    """The logical partition spec of every ``PD``."""
    return tree_map(lambda pd: pd.spec, defs)


def zeros_tree(shapes, device) -> Dict[str, Any]:
    """Zero tensors on ``device`` for a tree of ``(shape, dtype)`` leaves."""
    if isinstance(shapes, dict):
        return {k: zeros_tree(v, device) for k, v in shapes.items()}
    shape, dtype = shapes
    return torch.zeros(shape, dtype=dtype, device=device)


def stack_defs(defs, n: int):
    """Stacked (scan) variant: prepend a replicated leading axis of size n."""
    return tree_map(
        lambda pd: PD((n,) + pd.shape, (None,) + pd.spec, pd.init, pd.scale, pd.dtype), defs
    )


# ---------------------------------------------------------------------------
# Primitives
# ---------------------------------------------------------------------------


def checkpointed(remat: bool, fn, *args):
    """``fn(*args)``, under activation checkpointing when ``remat`` is on and
    a graph is being built (grad mode on, a tensor argument that requires
    grad): the reference's ``jax.checkpoint``.  The forward keeps only the
    inputs, and the backward recomputes ``fn`` to get what it saved."""
    if remat and torch.is_grad_enabled() and any(
            isinstance(a, torch.Tensor) and a.requires_grad for a in args):
        mesh = active_mesh()
        if mesh is not None:  # the recompute runs on autograd's thread, outside this context
            fn = functools.partial(_in_mesh, mesh, fn)
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _in_mesh(mesh, fn, *args):
    with mesh_context(*mesh):
        return fn(*args)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5, *, impl: str = "auto") -> torch.Tensor:
    return kops.rmsnorm(x, w, eps, impl=impl)


def whole_rows(h: torch.Tensor) -> torch.Tensor:
    """``h`` (B, S, d) with each sequence whole on its rank (no-op for a
    plain tensor).  Between layers the activations are sequence-sharded over
    "tp" (Megatron-SP); a block's projections need the whole sequence, and
    DTensor's matmul, which flattens batch and sequence, refuses a sequence
    shard (forward and backward): the all-gather GSPMD inserts at block
    entry in the reference is explicit here, on the block's input, so that
    the residual sum and its gradient keep one layout inside the block."""
    return _whole(h, 1)


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``.  A DTensor table is read through ``local_map``:
    where its vocabulary (rows) is split over ranks (the "tp" spec of
    vocab-parallel embeddings), each rank looks up the tokens in its rows,
    zeros for the rest, and the rows are summed over the ranks (a partial
    sum, all-reduced where it is used), as GSPMD reads the reference's;
    DTensor's own index would gather the whole table on every rank."""
    if not isinstance(table, DTensor):
        return table[tokens]
    from torch.distributed.tensor.experimental import local_map

    # even on a mesh of one: DTensor's index_put, the lookup's backward,
    # fails on torch 2.11
    mesh, V, split = table.device_mesh, table.shape[0], split_dims(table, 0)

    def local(tb, tk):
        idx = tk.long() - shard_offset(mesh, split, V)
        inside = (idx >= 0) & (idx < tb.shape[0])
        rows = tb[idx.clamp(0, max(tb.shape[0] - 1, 0))]
        return torch.where(inside[..., None], rows, torch.zeros((), dtype=tb.dtype, device=tb.device))

    tok = list(tokens.placements) if isinstance(tokens, DTensor) else [Replicate()] * mesh.ndim

    def out(p, n, t):  # the rows: partial over the vocabulary's ranks, else as the tokens or the features
        if p.is_shard() and p.dim == 0:
            return Partial() if n > 1 else t
        return Shard(tokens.dim()) if p.is_shard() else t

    # each rank's gradient of the table covers its own tokens: a partial sum
    # where the table is whole and the tokens split
    grad = [Partial() if not p.is_shard() and t.is_shard() else p for p, t in zip(table.placements, tok)]
    return local_map(local, out_placements=[out(p, n, t) for p, n, t in zip(table.placements, mesh.shape, tok)],
                     in_placements=(list(table.placements), tok), in_grad_placements=(grad, tok),
                     device_mesh=mesh, redistribute_inputs=True)(table, tokens)


def _whole(t: torch.Tensor, dim: int) -> torch.Tensor:
    """A DTensor ``t`` with axis ``dim`` whole on every rank, its other
    placements kept."""
    if not isinstance(t, DTensor):
        return t
    dim %= t.dim()
    want = [Replicate() if p.is_shard() and p.dim % t.dim() == dim else p for p in t.placements]
    return t if want == list(t.placements) else t.redistribute(t.device_mesh, want)


def _split_last_like(t: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A DTensor ``t`` with its last axis split as ``w``'s first (the rows
    of a row-parallel weight), on the mesh dimensions that leave ``t``
    otherwise replicated."""
    if not isinstance(t, DTensor):
        return t
    want = [Shard(t.dim() - 1) if q.is_shard() and q.dim == 0 and not p.is_shard() else p
            for p, q in zip(t.placements, w.placements)]
    return t if want == list(t.placements) else t.redistribute(t.device_mesh, want)


def _heads_reshape(t: torch.Tensor, dim: int, n: int, shape) -> torch.Tensor:
    """``t.reshape(shape(t.shape))``, a reshape that splits or merges the
    ``n`` heads at axis ``dim``.  Where the mesh's "model" ranks, which split
    heads, do not divide them evenly (GQA: 8 KV heads over a 16-wide "tp";
    llama4's 40 query heads; whisper's 6), DTensor refuses to view an
    uneven split, forward or backward (a row-parallel projection's gradient
    comes back split), where GSPMD pads it: the reshape then runs on whole
    heads through ``local_map``, which brings the gradient whole too."""
    if isinstance(t, DTensor) and n % math.prod(
            k for a, k in zip(t.device_mesh.mesh_dim_names or (), t.device_mesh.shape) if a == "model"):
        from torch.distributed.tensor.experimental import local_map

        dim %= t.dim()
        whole = [Replicate() if p.is_shard() and p.dim % t.dim() == dim else p for p in t.placements]
        return local_map(lambda x: x.reshape(shape(x.shape)), out_placements=whole, in_placements=(whole,),
                         device_mesh=t.device_mesh, redistribute_inputs=True)(t)
    return t.reshape(shape(t.shape))


def split_heads(t: torch.Tensor, n: int, d: int) -> torch.Tensor:
    """``t`` (..., n·d) as (..., n, d)."""
    return _heads_reshape(t, -1, n, lambda s: s[:-1] + (n, d))


def merge_heads(t: torch.Tensor) -> torch.Tensor:
    """``t`` (..., n, d) as (..., n·d)."""
    n, d = t.shape[-2:]
    return _heads_reshape(t, -2, n, lambda s: s[:-2] + (n * d,))


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with the weight cast to the activations' dtype first."""
    return torch.matmul(x, w.to(x.dtype))


def rope(
    x: torch.Tensor,          # (..., S, n, D) or (..., n, D) with positions (1,)
    positions: torch.Tensor,  # (S,) or (1,)
    theta: float,
) -> torch.Tensor:
    D = x.shape[-1]
    half = D // 2
    freqs = torch.exp(
        -math.log(theta) * torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    )
    angles = positions.to(torch.float32)[..., None] * freqs  # (..., half)
    sin, cos = torch.sin(angles), torch.cos(angles)
    if x.dim() == angles.dim() + 2:  # (..., S, n, D): broadcast over heads
        sin, cos = sin[..., None, :], cos[..., None, :]
    sin, cos = _replicated_like(x, sin), _replicated_like(x, cos)
    x1, x2 = x[..., :half], x[..., half:]
    xr1 = x1 * cos - x2 * sin
    xr2 = x2 * cos + x1 * sin
    return torch.cat([xr1, xr2], dim=-1).to(x.dtype)


def _replicated_like(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``t``, a plain tensor every rank computes alike, as a replicated
    DTensor on ``x``'s mesh when ``x`` is a DTensor: the backward, which
    runs outside the forward's ``implicit_replication``, multiplies by it."""
    if not isinstance(x, DTensor) or isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, x.device_mesh, [Replicate()] * x.device_mesh.ndim, run_check=False)


def token_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy: ``logsumexp`` over the fp32 logits
    minus the label's logit, as the reference computes it.  Logits whose
    vocabulary is split over ranks (the "tp" constraint on a mesh) take
    ``_vocab_parallel_loss``."""
    logits = logits.to(torch.float32)
    split = _vocab_split(logits)
    if split is not None:
        return torch.mean(_vocab_parallel_loss(logits, labels, split))
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(logz - gold)


def _vocab_split(logits):
    """``split_dims`` of a DTensor's last axis when it is split over more
    than one rank, else None."""
    split = split_dims(logits, -1)
    return split if math.prod(n for _, n in split) > 1 else None


class _VocabParallelCE(torch.autograd.Function):
    """Per-row ``logsumexp(logits) - logits[label]`` over this rank's part of
    the vocabulary (``lo`` its first word), the max, the sum and the picked
    logit all-reduced by ``reduce`` over the ranks that split it; the
    backward, ``softmax - onehot`` of the local part, needs no collective."""

    @staticmethod
    def forward(ctx, lg, lb, lo, reduce):
        m = reduce(lg.amax(dim=-1), "max")
        e = torch.exp(lg - m[..., None])
        z = reduce(e.sum(dim=-1), "sum")
        idx = lb.long() - lo
        inside = (idx >= 0) & (idx < lg.shape[-1])
        idx = idx.clamp(0, max(lg.shape[-1] - 1, 0))
        picked = torch.gather(lg, -1, idx[..., None])[..., 0]
        gold = reduce(torch.where(inside, picked, torch.zeros((), dtype=lg.dtype, device=lg.device)), "sum")
        ctx.save_for_backward(e, z, idx, inside)
        return torch.log(z) + m - gold

    @staticmethod
    def backward(ctx, g):
        e, z, idx, inside = ctx.saved_tensors
        grad = e / z[..., None]
        grad.scatter_add_(-1, idx[..., None], -inside[..., None].to(grad.dtype))
        return grad * g[..., None], None, None, None


def _vocab_parallel_loss(logits, labels, split):
    """Each row's loss of logits whose vocabulary ``split`` divides over
    ranks, through ``local_map`` (Megatron's vocab-parallel cross-entropy,
    what GSPMD makes of the reference's logsumexp and gather): DTensor's
    gather along a split axis fails, and its logsumexp would gather the
    logits whole."""
    from torch.distributed.tensor.experimental import local_map

    mesh, V, last = logits.device_mesh, logits.shape[-1], logits.dim() - 1

    def reduce(t, op):
        return all_reduce_over(t, op, mesh, split)

    def local(lg, lb):
        return _VocabParallelCE.apply(lg, lb, shard_offset(mesh, split, V), reduce)

    rows = [p if p.is_shard() and p.dim < last else Replicate() for p in logits.placements]
    return local_map(local, out_placements=rows, in_placements=(list(logits.placements), rows),
                     device_mesh=mesh, redistribute_inputs=True)(logits, labels)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)`` as the reference's ``jax.nn.silu`` computes it:
    ``x * (1 / (1 + exp(-x)))``, each op rounded to x's dtype (a fused
    ``F.silu`` rounds once, and differs from it in the last bf16 bit)."""
    return x * (1 / (1 + torch.exp(-x)))


def swiglu(x: torch.Tensor, w_in: torch.Tensor, w_out: torch.Tensor) -> torch.Tensor:
    """Fused gate+up projection: w_in: (d, 2*ff), w_out: (ff, d).

    On a mesh the column-parallel ``w_in`` splits gate and up over
    different ranks, so the hidden is gathered whole before the split, and
    the product is cut to ``w_out``'s row split (a local slice) before the
    row-parallel projection: the FLOPs stay split, and only the elementwise
    gate runs replicated.  DTensor's own choice there gathers ``w_out``."""
    h = _whole(dense(x, w_in), -1)
    gate, up = torch.chunk(h, 2, dim=-1)
    return dense(_split_last_like(silu(gate) * up, w_out), w_out)


# ---------------------------------------------------------------------------
# Dense MLP block
# ---------------------------------------------------------------------------


def mlp_defs(d: int, ff: int) -> Dict[str, PD]:
    return {
        "ln": PD((d,), (None,), init="ones"),
        "w_in": PD((d, 2 * ff), (None, "tp")),
        "w_out": PD((ff, d), ("tp", None)),
    }


def mlp_block(p: Dict[str, torch.Tensor], x: torch.Tensor, eps: float, *, impl: str = "auto") -> torch.Tensor:
    x = whole_rows(x)
    return x + swiglu(rms_norm(x, p["ln"], eps, impl=impl), p["w_in"], p["w_out"])
