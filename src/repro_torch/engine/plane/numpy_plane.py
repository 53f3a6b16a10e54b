"""The reference plane: ``ops_impl.execute_op`` semantics, verbatim.

This plane *is* the engine's ground truth — the per-row dict/loop
semantics every other plane must reproduce byte-for-byte.  It lowers
nothing (``lowers`` is always False) so ``ExecStats.ops_lowered`` stays 0
on the default path, and it is where other planes route the operators
they do not lower (mixed-plane execution).
"""

from __future__ import annotations

from typing import List

from repro_torch.core import dag as D
from repro_torch.engine.ops_impl import execute_op
from repro_torch.engine.plane.base import DataPlane
from repro_torch.engine.table import Table


class NumpyPlane(DataPlane):
    name = "numpy"

    def lowers(self, op: D.Operator, inputs: List[Table]) -> bool:
        return False

    def execute_op(self, op: D.Operator, inputs: List[Table]) -> Table:
        return execute_op(op, inputs)
