"""Deterministic synthetic version chains for the chain-verification service.

Models the paper's §1 iterative-analytics workload: an analyst maintains a
dashboard of ``branches`` parallel per-topic pipelines (identical shape,
different sources) and keeps applying small local rewrites — reordering the
two filters of a branch, or inserting/removing a redundant filter.  Every
version is 1-2 changes away from its predecessor, operator ids are stable
(the tracked/identity edit mapping applies), and every consecutive pair is
equivalent by construction.

Because the branches are isomorphic and the rewrites recur, the chain is the
canonical stress test for cross-pair verdict reuse: the *first* occurrence of
each rewrite direction pays EV calls; every later occurrence — on any branch,
in any later pair (or session) — is a fingerprint cache hit.

Determinism: this module uses **no** random state at all (module-level or
otherwise) — ``make_chain`` is a pure function of its arguments, and it
builds the reference package's chain operator for operator (the same
``dag_to_dict``), so a chain built by either package runs in the other.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List, Optional, Tuple

from repro_torch.core import dag as D
from repro_torch.core.dag import DataflowDAG, Link, Operator
from repro_torch.core.predicates import Pred

op = Operator.make

SCHEMA = ("a", "b", "c")


@dataclass(frozen=True)
class _BranchState:
    swapped: bool = False   # filter order: False = fa,fb ; True = fb,fa
    redundant: bool = False  # extra filter fe (implied by fb) present


def _branch(
    j: int, state: _BranchState, heavy: bool = False
) -> Tuple[List[Operator], List[Link]]:
    fa = op(f"fa{j}", D.FILTER, pred=Pred.cmp("a", ">", 2))
    fb = op(f"fb{j}", D.FILTER, pred=Pred.cmp("b", "<", 5))
    ops = [
        op(f"src{j}", D.SOURCE, schema=SCHEMA),
        fa,
        fb,
        op(f"proj{j}", D.PROJECT, cols=tuple((c, c) for c in SCHEMA)),
        op(f"sink{j}", D.SINK, semantics=D.BAG),
    ]
    order = [fb.id, fa.id] if state.swapped else [fa.id, fb.id]
    if state.redundant:
        # fe sits at the branch head and is implied by fb (b < 5 ⇒ b < 9),
        # so it is provably removable; placing it before the swap region
        # keeps the filter-swap windows isomorphic across branches
        ops.append(op(f"fe{j}", D.FILTER, pred=Pred.cmp("b", "<", 9)))
        order = [f"fe{j}"] + order
    tail = [f"proj{j}"]
    if heavy:
        # expensive, deterministic downstream: a per-row classifier and a
        # grouping aggregate, downstream of (and untouched by) the rewrites
        # — the regime where execution dominates verification and
        # materialization reuse pays
        ops.append(
            op(f"cl{j}", D.CLASSIFIER, col="a", out="label",
               model="chain", classes=5)
        )
        ops.append(
            op(f"agg{j}", D.AGGREGATE, group_by=("label",),
               aggs=(("sum", "a", "sa"), ("count", "*", "n")))
        )
        tail += [f"cl{j}", f"agg{j}"]
    path = [f"src{j}"] + order + tail + [f"sink{j}"]
    links = [Link(a, b) for a, b in zip(path, path[1:])]
    return ops, links


def _build(states: List[_BranchState], heavy: bool = False) -> DataflowDAG:
    ops: List[Operator] = []
    links: List[Link] = []
    for j, st in enumerate(states):
        o, l = _branch(j, st, heavy)
        ops += o
        links += l
    return DataflowDAG(ops, links)


def make_chain(
    n_versions: int, branches: Optional[int] = None, heavy: bool = False
) -> List[DataflowDAG]:
    """A chain of ``n_versions`` dataflows, each 1-2 changes from the last.

    Pair k (k ≥ 1) swaps the two filters of branch ``(k-1) % branches`` —
    the same rewrite landing on a *fresh but isomorphic* branch each time,
    so every pair after the first re-poses window questions the first pair
    already paid for.  Every third pair additionally toggles the redundant
    head filter of the next branch over.  ``branches`` defaults to
    ``n_versions - 1`` (each branch is swapped at most once along the
    chain).  ``heavy=True`` appends an expensive classifier + aggregate
    tail to every branch (the execution-reuse benchmark's workload).
    Deterministic — same arguments, same chain.
    """
    if n_versions < 2:
        raise ValueError("a chain needs at least 2 versions")
    if branches is None:
        branches = n_versions - 1
    if branches < 1:
        raise ValueError("need at least one branch")
    states = [_BranchState() for _ in range(branches)]
    versions = [_build(states, heavy)]
    for k in range(1, n_versions):
        j = (k - 1) % branches
        states[j] = replace(states[j], swapped=not states[j].swapped)
        if k % 3 == 0:
            i = k % branches
            states[i] = replace(states[i], redundant=not states[i].redundant)
        versions.append(_build(states, heavy))
    return versions
