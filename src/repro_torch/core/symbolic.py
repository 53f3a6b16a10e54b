"""Partial symbolic representation for fast inequivalence (paper §7.4).

Propagates ``(S, O)`` — the projected column list and the sort-order column
list — from sources to each sink using per-operator transformations.  If the
two versions' sink representations differ, the versions are provably
inequivalent (the result tables differ in schema or ordering), without any
EV call.  Mirrors the paper's observation that this catches exploratory
edits that change projections/sorts but not TPC-DS-style filter edits.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from repro_torch.core import dag as D
from repro_torch.core.dag import DataflowDAG, infer_schema


def sink_summaries(
    dag: DataflowDAG,
) -> Optional[Dict[str, Tuple[Tuple[str, ...], Tuple[Tuple[str, bool], ...]]]]:
    """``{op_id: (projected columns S, sort keys O)}`` for every operator,
    from ONE schema inference + one order-propagation pass — the service
    hot path calls this per version, not per sink (a whole-DAG
    ``infer_schema`` per sink pair dominated warm-cache verification)."""
    try:
        schemas = infer_schema(dag, {})
    except D.DAGError:
        return None
    # propagate sort order: most ops destroy or preserve it
    order: Dict[str, Tuple[Tuple[str, bool], ...]] = {}
    for op_id in dag.topo_order():
        op = dag.ops[op_id]
        ins = [l.src for l in dag.in_links.get(op_id, [])]
        t = op.op_type
        if t == D.SOURCE:
            order[op_id] = ()
        elif t == D.SORT:
            order[op_id] = tuple((c, bool(a)) for c, a in op.get("keys"))
        elif t in (D.FILTER, D.LIMIT, D.REPLICATE, D.SINK, D.DICT_MATCHER,
                   D.CLASSIFIER, D.SENTIMENT):
            order[op_id] = order[ins[0]]
        elif t == D.PROJECT:
            keep = {n for n, e in op.get("cols") if isinstance(e, str)}
            prev = order[ins[0]]
            # order survives while its prefix columns survive (pass-through)
            kept: List[Tuple[str, bool]] = []
            ren = {e: n for n, e in op.get("cols") if isinstance(e, str)}
            for c, a in prev:
                if c in ren:
                    kept.append((ren[c], a))
                else:
                    break
            order[op_id] = tuple(kept)
        else:
            order[op_id] = ()  # joins/aggregates/unions/UDFs scramble order
    return {i: (tuple(schemas[i]), order[i]) for i in dag.ops}


def sink_summary(
    dag: DataflowDAG, sink_id: str
) -> Optional[Tuple[Tuple[str, ...], Tuple[Tuple[str, bool], ...]]]:
    """(projected columns S, sort keys O) at a sink, or None if underivable."""
    summaries = sink_summaries(dag)
    return None if summaries is None else summaries[sink_id]


def quick_inequivalent(
    P: DataflowDAG,
    Q: DataflowDAG,
    sink_pairs: List[Tuple[str, str]],
    semantics: str,
) -> bool:
    """True ⇒ provably inequivalent. Conservative (False ≠ equivalent)."""
    if not sink_pairs:
        return False
    sum_p = sink_summaries(P)
    sum_q = sink_summaries(Q)
    for sp, sq in sink_pairs:
        a = sum_p[sp] if sum_p is not None else None
        b = sum_q[sq] if sum_q is not None else None
        if a is None or b is None:
            continue
        if a[0] != b[0]:
            return True  # projected columns differ ⇒ different result tables
        # NOTE: the paper also compares sort-key lists (O); that check is
        # unsound when upstream operators correlate columns (sort by ``a``
        # vs ``a, b`` with b = 2a upstream), so we only report the
        # schema-mismatch witness, which is sound under our table model.
    return False
