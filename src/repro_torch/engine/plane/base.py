"""The ``DataPlane`` protocol — pluggable operator execution backends.

A plane is a *pure performance choice*: every plane must produce tables
whose canonical numpy bytes are identical to the reference plane's, so
content digests (``engine.executor``), ``MaterializationStore`` keys,
certificates and the reuse frontier are plane-agnostic.  The contract:

  * ``execute_op(op, inputs)`` returns a ``Table`` bit-identical
    (``tables_identical``) to ``ops_impl.execute_op(op, inputs)``;
  * ``lowers(op, inputs)`` reports whether this call would take a
    vectorized lowering distinct from the reference implementation —
    pure accounting (``ExecStats.ops_lowered``), never a correctness
    signal;
  * planes hold no per-run mutable state: one instance is shared by every
    session/thread of a process (the registry memoizes instances), so any
    internal caches must be idempotent under racing writers.

A plane routes each operator it does not lower (object-dtype columns,
unsupported predicate shapes, UDFs) to the reference implementation —
mixed-plane execution — rather than refuse the chain.  The route is decided
by what the operator is, before it runs: a plane whose accelerator is
missing, or whose kernel fails, raises ``PlaneError`` instead of carrying
on elsewhere.
"""

from __future__ import annotations

import abc
from typing import List

from repro_torch.core import dag as D
from repro_torch.engine.table import Table


class PlaneError(Exception):
    """Unknown plane name or unusable plane backend."""


class DataPlane(abc.ABC):
    """One operator-execution backend (see module docstring for contract)."""

    name: str = "abstract"

    @abc.abstractmethod
    def lowers(self, op: D.Operator, inputs: List[Table]) -> bool:
        """Would this call use a vectorized lowering (vs the reference)?"""

    @abc.abstractmethod
    def execute_op(self, op: D.Operator, inputs: List[Table]) -> Table:
        """Execute one operator; bytes must match the reference plane."""

    def pred_mask(self, pred, table: Table):
        """Boolean keep-mask of ``pred`` over ``table`` (the primitive a
        delta filter is built from).  Must be bit-identical to the reference
        ``eval_pred`` (same epsilon bands); planes with a vectorized
        predicate path override this to serve the mask from it.
        """
        from repro_torch.engine.ops_impl import eval_pred

        return eval_pred(pred, table)
