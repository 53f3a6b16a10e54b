"""Equitas-style EV (paper §4.2 R1-R6, [59]).

Models queries symbolically and decides equivalence for SPJ + LeftOuterJoin +
Aggregate with linear predicates.  Deviation from the published system (noted
in DESIGN.md): our decision procedure proves the stronger *bag*-level
equivalence of the canonical forms, hence its True verdicts are sound under
both Set and Bag table semantics; like the real Equitas it is **not**
inequivalence-capable (False from Equitas means "could not verify", §4.4), so
``can_prove_inequivalence = False`` and mismatches surface as Unknown.

Restriction-monotonicity: Equitas is NOT monotonic (paper Example 1) — the
counting restrictions R4/R5 can be violated by a window yet satisfied by a
larger window that balances the counts.

Supported fragment (format shared by all EVs; see docs/ARCHITECTURE.md):

    ============== ==========================================================
    EV             EquitasEV (``equitas``)
    Operators      Source, Filter, Project, Join(inner/left_outer),
                   Aggregate, Replicate, Sink
    Semantics      set, bag (decision procedure proves bag-level equality)
    Restrictions   R1 set semantics (bag sound here too); R2 ops in
                   {SPJ, OuterJoin, Aggregate}; R3 predicates linear;
                   R4/R5 equal OuterJoin/Aggregate counts; R6
                   cardinality-dependent aggregates scan inputs once
    Monotonic      no — R4/R5 counting can recover in a larger window
    Proves inequiv no — False means "could not verify" (§4.4)
    ============== ==========================================================
"""

from __future__ import annotations

from typing import FrozenSet, List, Optional

from repro_torch.core import dag as D
from repro_torch.core.dag import BAG, SET, DataflowDAG
from repro_torch.core.ev import relational as R
from repro_torch.core.ev.base import BaseEV, QueryPair, Restriction


_SUPPORTED = frozenset(
    {D.SOURCE, D.FILTER, D.PROJECT, D.JOIN, D.AGGREGATE, D.REPLICATE, D.SINK}
)

_CARDINALITY_AGGS = {"count", "sum", "avg"}


class EquitasEV(BaseEV):
    name = "equitas"
    semantics = frozenset({SET, BAG})
    restriction_monotonic = False
    can_prove_inequivalence = False
    supported_op_types = _SUPPORTED

    def restrictions(self) -> List[Restriction]:
        return [
            Restriction("R1", "table semantics must be set (bag sound here too)"),
            Restriction("R2", "operators in {SPJ, OuterJoin, Aggregate}"),
            Restriction("R3", "SPJ predicates linear"),
            Restriction("R4", "same number of OuterJoin operators"),
            Restriction("R5", "same number of Aggregate operators"),
            Restriction(
                "R6",
                "cardinality-dependent aggregates need SPJ upstream with "
                "inputs scanned once",
            ),
        ]

    # -- validation ------------------------------------------------------------
    def failed_restrictions(self, qp: QueryPair) -> List[str]:
        failed: List[str] = []
        if qp.semantics not in self.semantics:
            failed.append("R1")
        for dag in (qp.P, qp.Q):
            for op in dag.ops.values():
                if op.op_type not in _SUPPORTED:
                    failed.append("R2")
                if op.op_type == D.FILTER and not op.get("pred").is_linear():
                    failed.append("R3")
        if _count(qp.P, D.JOIN, how="left_outer") != _count(
            qp.Q, D.JOIN, how="left_outer"
        ):
            failed.append("R4")
        if _count(qp.P, D.AGGREGATE) != _count(qp.Q, D.AGGREGATE):
            failed.append("R5")
        if "R2" not in failed and "R3" not in failed:
            try:
                for dag, sinks in ((qp.P, [p for p, _ in qp.sink_pairs]),
                                   (qp.Q, [q for _, q in qp.sink_pairs])):
                    for s in sinks:
                        blk = R.normalize(dag, s, allow_union=False)
                        if not _r6_ok(blk):
                            failed.append("R6")
                            raise StopIteration
            except StopIteration:
                pass
            except R.UnsupportedOp:
                failed.append("R2")
        return sorted(set(failed))

    def validate(self, qp: QueryPair) -> bool:
        return not self.failed_restrictions(qp)

    # -- decision ----------------------------------------------------------------
    def check(self, qp: QueryPair) -> Optional[bool]:
        try:
            for ps, qs in qp.sink_pairs:
                a = R.normalize(qp.P, ps, allow_union=False)
                b = R.normalize(qp.Q, qs, allow_union=False)
                if not R.blocks_equivalent(a, b):
                    return None  # cannot verify (never a False proof)
            return True
        except R.UnsupportedOp:
            return None


def _count(dag: DataflowDAG, op_type: str, **props) -> int:
    n = 0
    for op in dag.ops.values():
        if op.op_type != op_type:
            continue
        if all(op.get(k) == v for k, v in props.items()):
            n += 1
    return n


def _r6_ok(b: R.Block) -> bool:
    """R6 on the normal form: any cardinality-dependent aggregate's child
    must be SPJ-only with each input scanned at most once."""

    def walk_ref(ref: R.Ref) -> bool:
        if isinstance(ref, R.Leaf):
            return True
        if isinstance(ref, R.AggNode):
            if any(fn in _CARDINALITY_AGGS for fn, _, _ in ref.aggs):
                child = ref.child
                if not R.is_spj_only(child):
                    return False
                leaves = [r.name for r, _ in child.atoms]
                if len(leaves) != len(set(leaves)):
                    return False
            return walk_block(ref.child)
        if isinstance(ref, R.LOJNode):
            return walk_block(ref.left) and walk_block(ref.right)
        if isinstance(ref, R.UnionNode):
            return all(walk_block(c) for c in ref.children)
        return False

    def walk_block(blk: R.Block) -> bool:
        return all(walk_ref(ref) for ref, _ in blk.atoms)

    return walk_block(b)
