"""The train step: loss → grads → optimizer, with optional
microbatching (the port of ``train/train_step.py``)."""

from __future__ import annotations

from typing import Callable, Dict

import torch
from torch.distributed.tensor import DTensor

from repro_torch.models.layers import tree_from_leaves, tree_leaves
from repro_torch.models.registry import Model
from repro_torch.train.optimizer import AdamW


def loss_and_grads(model: Model, params, batch: Dict[str, torch.Tensor], *,
                   microbatches: int = 1):
    """``(loss, grads)``: the mean loss of ``batch`` (fp32 0-d, detached) and
    its fp32 gradient for every leaf of ``params``, a tree like it.

    Mixed precision as the reference's: every fp32 parameter with two or
    more dimensions is cast to bf16 once at step entry, the losses run on
    those copies, and their gradients (bf16, as the cast's cotangent is in
    the reference) come back to fp32.  ``microbatches > 1`` splits the batch
    along its first axis and sums the microbatches' fp32 gradients in order
    (the reference's ``lax.scan``), then divides the sums by the count:
    activation memory drops by the factor, FLOPs unchanged.  DTensor
    parameters and batch (a mesh) give DTensor gradients in the
    parameters' placements."""
    paths, leaves = zip(*tree_leaves(params))
    compute = [
        (p.detach().to(torch.bfloat16) if p.dtype == torch.float32 and p.dim() >= 2
         else p.detach()).requires_grad_()
        for p in leaves
    ]
    cparams = tree_from_leaves(zip(paths, compute))

    def grads_of(b):
        loss = model.loss(cparams, b)
        gs = torch.autograd.grad(loss, compute, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p, dtype=torch.float32) if g is None
                               else g.to(torch.float32) for g, p in zip(gs, leaves)]

    if microbatches <= 1:
        loss, grads = grads_of(batch)
        return loss, tree_from_leaves(zip(paths, grads))

    def split(x, i):
        b = x.shape[0]
        if b % microbatches:
            raise ValueError(f"batch of {b} does not split into {microbatches} microbatches")
        if isinstance(x, DTensor):
            return _local_microbatch(x, i, microbatches)
        return x.reshape((microbatches, b // microbatches) + tuple(x.shape[1:]))[i]

    loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    grads = None
    for i in range(microbatches):
        l, g = grads_of({k: split(v, i) for k, v in batch.items()})
        loss = loss + l
        if grads is None:
            grads = g
        else:
            for acc, x in zip(grads, g):
                acc.add_(x)
        del g
    return loss / microbatches, tree_from_leaves(zip(paths, [g / microbatches for g in grads]))


def _local_microbatch(x, i: int, n: int):
    """Microbatch ``i`` of ``n`` of a DTensor batch: each rank's ``i``-th part
    of its own rows (``local_map``), so every rank works on every microbatch
    and no rows move.  On a mesh of one this is the plain split; otherwise
    the microbatches hold other rows than the plain split's, and their sum,
    the batch's gradient, is the same function.  (DTensor refuses the
    plain split's reshape of a batch axis split over more ranks than the
    microbatches.)"""
    from torch.distributed.tensor.experimental import local_map

    def local(t):
        if t.shape[0] % n:
            raise ValueError(f"a rank's {t.shape[0]} rows do not split into {n} microbatches")
        return t.reshape((n, t.shape[0] // n) + tuple(t.shape[1:]))[i]

    return local_map(local, out_placements=list(x.placements), in_placements=(list(x.placements),),
                     device_mesh=x.device_mesh)(x)


def make_train_step(model: Model, optimizer: AdamW, *, microbatches: int = 1) -> Callable:
    """Returns ``train_step(params, opt_state, batch) -> (params, state,
    metrics)``: ``loss_and_grads``, then ``optimizer.update``, which updates
    ``params`` and the state in place and returns them."""

    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(model, params, batch, microbatches=microbatches)
        new_params, new_state, opt_metrics = optimizer.update(params, grads, opt_state)
        return new_params, new_state, {"loss": loss, **opt_metrics}

    return train_step
