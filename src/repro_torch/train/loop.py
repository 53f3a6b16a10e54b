"""Training loop: checkpoint/restart, failure injection, straggler watch
(the port of ``train/loop.py``).

``fit`` is what the examples and tests drive; ``seed`` and ``device`` take
the place of the reference's ``rng``, and the default device is ``cuda``
(without CUDA it raises unless ``device="cpu"`` is given).  A step's wall
time is read after ``loss.item()``, which waits for the device, so the
straggler monitor sees device time, not launch time.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.distributed.fault import FailureInjector, InjectedFailure, StragglerMonitor
from repro_torch.models.layers import tree_leaves
from repro_torch.models.registry import Model
from repro_torch.train.optimizer import AdamW
from repro_torch.train.train_step import make_train_step


@dataclass
class FitResult:
    losses: List[float] = field(default_factory=list)
    resumed_from: Optional[int] = None
    steps_run: int = 0
    straggler_steps: List[int] = field(default_factory=list)
    final_step: int = 0


def _on(v, device) -> torch.Tensor:
    return (v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))).to(device)


def fit(
    model: Model,
    optimizer: AdamW,
    batches: Iterator[Dict[str, Any]],
    *,
    steps: int,
    ckpt: Optional[CheckpointManager] = None,
    ckpt_every: int = 20,
    seed: int = 0,
    device="cuda",
    params: Any = None,
    failure: Optional[FailureInjector] = None,
    log_every: int = 10,
    log: Callable[[str], None] = print,
    microbatches: int = 1,
) -> FitResult:
    res = FitResult()
    if params is None:
        params = model.init(seed, device=device)
    dev = next(iter(tree_leaves(params)))[1].device
    opt_state = optimizer.init(params)
    start_step = 0

    if ckpt is not None and ckpt.latest_step() is not None:
        (params, opt_state), meta = ckpt.restore(None, (params, opt_state))
        start_step = int(meta["step"])
        res.resumed_from = start_step
        log(f"[fit] resumed from checkpoint step {start_step}")

    step_fn = make_train_step(model, optimizer, microbatches=microbatches)
    monitor = StragglerMonitor()
    failure = failure or FailureInjector()

    for step in range(start_step, steps):
        batch = {k: _on(v, dev) for k, v in next(batches).items()}
        t0 = time.perf_counter()
        failure.check(step)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = metrics["loss"].item()
        dt = time.perf_counter() - t0
        if monitor.observe(step, dt):
            res.straggler_steps.append(step)
            log(f"[fit] straggler at step {step}: {dt:.3f}s vs ewma {monitor.ewma:.3f}s")
        res.losses.append(loss)
        res.steps_run += 1
        if log_every and step % log_every == 0:
            log(f"[fit] step {step} loss {loss:.4f} ({dt*1e3:.0f} ms)")
        if ckpt is not None and (step + 1) % ckpt_every == 0:
            ckpt.save(step + 1, (params, opt_state))
    if ckpt is not None:
        ckpt.save(steps, (params, opt_state))
        ckpt.wait()
    res.final_step = steps
    res.params = params  # type: ignore[attr-defined]
    return res


def fit_with_restarts(
    make_loop_args: Callable[[], Dict[str, Any]],
    *,
    max_restarts: int = 3,
    log: Callable[[str], None] = print,
) -> FitResult:
    """Supervisor: restart `fit` after (injected or real) failures — the
    single-process stand-in for the cluster coordinator."""
    attempt = 0
    while True:
        try:
            return fit(**make_loop_args())
        except InjectedFailure as e:
            attempt += 1
            log(f"[supervisor] {e}; restart {attempt}/{max_restarts}")
            if attempt > max_restarts:
                raise
