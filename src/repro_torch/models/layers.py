"""Shared layers and parameter definitions (the port of ``models/layers.py``).

Parameters are declared once as ``PD(shape, spec, init)`` trees (nested
dicts); ``init_tree`` turns a tree into real tensors on a given device.
``spec`` keeps the reference's logical sharding axes ("dp", "tp") as
documentation; sharding comes with a later slice.

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
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

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
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5, *, impl: str = "auto") -> torch.Tensor:
    return kops.rmsnorm(x, w, eps, impl=impl)


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
    x1, x2 = x[..., :half], x[..., half:]
    xr1 = x1 * cos - x2 * sin
    xr2 = x2 * cos + x1 * sin
    return torch.cat([xr1, xr2], dim=-1).to(x.dtype)


def token_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy: ``logsumexp`` over the fp32 logits
    minus the label's logit, as the reference computes it."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(logz - gold)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)`` as the reference's ``jax.nn.silu`` computes it:
    ``x * (1 / (1 + exp(-x)))``, each op rounded to x's dtype (a fused
    ``F.silu`` rounds once, and differs from it in the last bf16 bit)."""
    return x * (1 / (1 + torch.exp(-x)))


def swiglu(x: torch.Tensor, w_in: torch.Tensor, w_out: torch.Tensor) -> torch.Tensor:
    """Fused gate+up projection: w_in: (d, 2*ff), w_out: (ff, d)."""
    h = dense(x, w_in)
    gate, up = torch.chunk(h, 2, dim=-1)
    return dense(silu(gate) * up, w_out)


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
    return x + swiglu(rms_norm(x, p["ln"], eps, impl=impl), p["w_in"], p["w_out"])
