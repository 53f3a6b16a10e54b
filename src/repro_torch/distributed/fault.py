"""Fault-tolerance runtime pieces: failure injection, straggler mitigation
(the port's own copy of the reference's ``distributed/fault.py``).

At 1000+ nodes the mean time between node failures is hours, so the loop
must (a) checkpoint/restart cheaply (checkpoint/manager.py), (b) detect and
react to stragglers, and (c) treat crashes as expected control flow.  This
module provides the simulation-friendly pieces the train loop composes:

  * ``FailureInjector`` — crash at a configured step (``REPRO_FAILURE_STEP``)
    to exercise the restart path in tests/examples.
  * ``StragglerMonitor`` — EWMA of step times; flags steps slower than
    ``threshold×`` the moving average.  On a real fleet the flag feeds the
    coordinator (hot-spare swap / checkpoint-and-reshard); here it is
    surfaced in metrics and tested directly.
  * ``ElasticPlan`` — given a checkpoint's logical arrays and a *new* mesh
    size, produce the re-shard plan (restore handles the mechanics; this
    validates divisibility and picks the dp/tp split for the new chip count).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


class InjectedFailure(RuntimeError):
    pass


class FailureInjector:
    """Raises InjectedFailure at the configured step (env or explicit)."""

    def __init__(self, fail_at_step: Optional[int] = None):
        env = os.environ.get("REPRO_FAILURE_STEP")
        self.fail_at = fail_at_step if fail_at_step is not None else (
            int(env) if env else None
        )
        self.fired = False

    def check(self, step: int) -> None:
        if self.fail_at is not None and step == self.fail_at and not self.fired:
            self.fired = True
            raise InjectedFailure(f"injected node failure at step {step}")


@dataclass
class StragglerMonitor:
    alpha: float = 0.1
    threshold: float = 2.0
    warmup: int = 3
    ewma: Optional[float] = None
    steps_seen: int = 0
    flagged: List[int] = field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        """Returns True if this step is a straggler."""
        self.steps_seen += 1
        if self.ewma is None:
            self.ewma = dt
            return False
        is_straggler = (
            self.steps_seen > self.warmup and dt > self.threshold * self.ewma
        )
        if is_straggler:
            self.flagged.append(step)
            # do NOT pollute the EWMA with the anomaly
            return True
        self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return False


@dataclass(frozen=True)
class ElasticPlan:
    old_chips: int
    new_chips: int
    new_mesh_shape: Tuple[int, ...]
    new_axes: Tuple[str, ...]

    @staticmethod
    def plan(new_chips: int, *, model_parallel: int = 16) -> "ElasticPlan":
        if new_chips % model_parallel:
            raise ValueError(
                f"chip count {new_chips} not divisible by tp={model_parallel}"
            )
        dp = new_chips // model_parallel
        return ElasticPlan(
            old_chips=-1,
            new_chips=new_chips,
            new_mesh_shape=(dp, model_parallel),
            new_axes=("data", "model"),
        )
