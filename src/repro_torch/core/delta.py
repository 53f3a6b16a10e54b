"""Delta-safety analysis: which edits admit O(|Δrows|) re-execution.

The reuse frontier re-executes the *changed cone* of a verified pair,
but still on full input tables.  The dominant edit family in iterative
refinement (Veer §1) is a one-operator tweak — a predicate narrowed or
widened, a projection column added, an aggregate function swapped — whose
effect on every downstream table is a small row- or column-level **delta**
against the previous version's already-materialized outputs.  This module
decides, statically and conservatively, when that delta can be *propagated*
instead of recomputed ("Spinning Fast Iterative Data Flows", PAPERS.md):

``classify_edit(p_op, q_op)``
    The per-operator amenability rules, built on ``core.predicates`` +
    the EV solver's implication check:

    * ``narrow``  — FILTER with p′ ⇒ p: the delta is pure deletions
      (rows leaving), no new rows can appear;
    * ``widen``   — FILTER with p ⇒ p′: the delta is pure insertions,
      σ_{p′ ∧ ¬p} over the store-materialized input;
    * ``filter-general`` — FILTER change where neither implication is
      provable (or the solver hits an unsupported atom): handled as the
      superset case, deletions *and* insertions from two vectorized masks
      over the materialized input — still O(|Δ|) downstream;
    * ``project-cols`` — PROJECT column add/drop/re-derive: a column
      substitution over row-aligned tables;
    * ``agg-swap`` — AGGREGATE with identical ``group_by`` and swapped
      aggregate functions: groups and their order are unchanged, only
      swapped-out value columns are re-aggregated.

``analyze_delta(P, Q, mapping)``
    The whole-pair gate.  A ``DeltaPlan`` is returned only when the edit
    is a **single amenable operator** whose inputs are all exact-tier
    (bit-identical to P's, per ``core.frontier.exact_frontier_map``), and
    the changed region downstream of it is a **single-consumer spine** of
    signature-identical operators ending at one sink, every side input of
    which is exact-tier.  Anything else — multi-site edits, topology
    changes, unsupported spine operators, branching fan-out — returns
    ``None`` with a census reason, and the caller falls back to the
    seeded full-cone recompute.

The tier is certificate-gated exactly like the exact/semantic frontier
tiers: the service layer (``repro_torch.service.chain``) only consults this
module through ``core.frontier.compute_delta_plan`` on a frontier that was
itself derived from a True certificate replaying green for the pair.  The
engine half (``repro_torch.engine.delta``) then enforces the byte-level
contract: every delta-produced table is bit-identical to full execution,
or it raises and the run falls back.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from repro_torch.core import dag as D
from repro_torch.core.dag import DataflowDAG
from repro_torch.core.edits import EditMapping, identity_mapping

NARROW = "narrow"
WIDEN = "widen"
FILTER_GENERAL = "filter-general"
PROJECT_COLS = "project-cols"
AGG_SWAP = "agg-swap"

#: operator types the engine's delta rules can propagate *through*
#: (the boundary op itself is governed by ``classify_edit``)
SPINE_OP_TYPES = frozenset({
    D.FILTER, D.PROJECT, D.JOIN, D.AGGREGATE, D.DISTINCT, D.SORT,
    D.REPLICATE, D.DICT_MATCHER, D.CLASSIFIER, D.SENTIMENT, D.SINK,
})


@dataclass(frozen=True)
class DeltaPlan:
    """One amenable edit: where the delta originates and how it flows.

    ``spine`` lists Q operator ids from the edited operator to the sink
    (inclusive, in topological order); ``spine_to_p`` aligns each spine
    operator with the P operator whose materialized output the delta is
    expressed against; ``exact`` is the frontier's Q-op → P-op map for the
    bit-identical region (side inputs, the edited operator's inputs, and
    any other sinks are all drawn from it).
    """

    klass: str
    boundary_q: str
    boundary_p: str
    spine: Tuple[str, ...]
    spine_to_p: Tuple[Tuple[str, str], ...]
    exact: Tuple[Tuple[str, str], ...]

    @property
    def sink(self) -> str:
        return self.spine[-1]

    @property
    def spine_map(self) -> Dict[str, str]:
        return dict(self.spine_to_p)

    @property
    def exact_map(self) -> Dict[str, str]:
        return dict(self.exact)

    def to_dict(self) -> Dict[str, object]:
        return {
            "klass": self.klass,
            "boundary_q": self.boundary_q,
            "boundary_p": self.boundary_p,
            "spine": list(self.spine),
        }


def classify_edit(p_op: D.Operator, q_op: D.Operator) -> Optional[str]:
    """Amenability class of one changed operator, or ``None``.

    Conservative by construction: implication checks go through the EV
    solver (exact Fraction arithmetic); an unsupported atom degrades a
    narrow/widen claim to ``filter-general`` (whose delta rule needs no
    implication, only mask evaluation), never promotes anything.
    """
    if p_op.op_type != q_op.op_type:
        return None
    t = q_op.op_type
    if t == D.FILTER:
        p_pred, q_pred = p_op.get("pred"), q_op.get("pred")
        if p_pred is None or q_pred is None:
            return None
        from repro_torch.core.ev.solver import UnsupportedAtomError, pred_implies

        try:
            if pred_implies(q_pred, p_pred):
                return NARROW
            if pred_implies(p_pred, q_pred):
                return WIDEN
        except UnsupportedAtomError:
            pass
        return FILTER_GENERAL
    if t == D.PROJECT:
        if p_op.get("cols") is None or q_op.get("cols") is None:
            return None
        return PROJECT_COLS
    if t == D.AGGREGATE:
        if tuple(p_op.get("group_by", ())) != tuple(q_op.get("group_by", ())):
            return None
        if p_op.get("aggs") is None or q_op.get("aggs") is None:
            return None
        return AGG_SWAP
    return None


def analyze_delta(
    P: DataflowDAG,
    Q: DataflowDAG,
    mapping: Optional[EditMapping] = None,
    *,
    exact: Optional[Dict[str, str]] = None,
) -> Optional[DeltaPlan]:
    """``DeltaPlan`` for (P, Q) or ``None`` (fall back to cone recompute)."""
    plan, _ = delta_census(P, Q, mapping, exact=exact)
    return plan


def delta_census(
    P: DataflowDAG,
    Q: DataflowDAG,
    mapping: Optional[EditMapping] = None,
    *,
    exact: Optional[Dict[str, str]] = None,
) -> Tuple[Optional[DeltaPlan], str]:
    """Like ``analyze_delta`` but also names *why* a pair is ineligible —
    the label a workload census aggregates."""
    if mapping is None:
        mapping = identity_mapping(P, Q)
    if exact is None:
        from repro_torch.core.frontier import exact_frontier_map

        exact = exact_frontier_map(P, Q, mapping)
    bwd = mapping.backward

    order = Q.topo_order()
    changed = [q for q in order if q not in exact]
    if not changed:
        return None, "fallback:no-change"

    # the boundary: changed operators whose inputs are all exact-tier
    boundary = [
        q for q in changed
        if all(l.src in exact for l in Q.in_links[q])
    ]
    if len(boundary) != 1:
        return None, "fallback:multi-site"
    b_q = boundary[0]
    b_p = bwd.get(b_q)
    if b_p is None or b_p not in P.ops:
        return None, "fallback:unmapped-edit"
    klass = classify_edit(P.ops[b_p], Q.ops[b_q])
    if klass is None:
        return None, f"fallback:not-amenable:{Q.ops[b_q].op_type}"

    def inputs_align(q_id: str, p_id: str, spine_prev: Optional[str]) -> bool:
        """Port-for-port: the spine predecessor enters where its P
        counterpart does; every other input is exact-tier and aligned."""
        q_in, p_in = Q.in_links[q_id], P.in_links[p_id]
        if len(q_in) != len(p_in):
            return False
        for lq, lp in zip(q_in, p_in):
            if lq.dst_port != lp.dst_port:
                return False
            if spine_prev is not None and lq.src == spine_prev:
                if lp.src != spine_map[spine_prev]:
                    return False
            elif exact.get(lq.src) != lp.src:
                return False
        return True

    spine_map: Dict[str, str] = {b_q: b_p}
    if not inputs_align(b_q, b_p, None):
        return None, "fallback:topology"

    # walk the single-consumer path from the boundary to a sink
    spine = [b_q]
    cur = b_q
    while Q.ops[cur].op_type != D.SINK:
        outs = Q.out_links[cur]
        if len(outs) != 1:
            return None, "fallback:branching-spine"
        nxt = outs[0].dst
        if nxt in exact:
            # an exact op downstream of a changed one cannot happen
            # (exactness requires exact inputs); defensive
            return None, "fallback:topology"
        p_nxt = bwd.get(nxt)
        if p_nxt is None or p_nxt not in P.ops:
            return None, "fallback:unmapped-edit"
        if Q.ops[nxt].signature() != P.ops[p_nxt].signature():
            return None, "fallback:multi-site"
        if Q.ops[nxt].op_type not in SPINE_OP_TYPES:
            return None, f"fallback:spine-op:{Q.ops[nxt].op_type}"
        spine_map[nxt] = p_nxt
        if not inputs_align(nxt, p_nxt, cur):
            return None, "fallback:side-input"
        spine.append(nxt)
        cur = nxt

    # every changed operator must lie on the spine — otherwise some other
    # sink (or branch) also changed and one delta cannot cover the pair
    if set(changed) != set(spine):
        return None, "fallback:multi-site"

    plan = DeltaPlan(
        klass=klass,
        boundary_q=b_q,
        boundary_p=b_p,
        spine=tuple(spine),
        spine_to_p=tuple(sorted(spine_map.items())),
        exact=tuple(sorted(exact.items())),
    )
    return plan, klass
