"""Delta-cone execution: propagate row/column deltas instead of re-running.

``execute_delta`` takes a ``repro_torch.core.delta.DeltaPlan`` (a certified
single-site amenable edit), the previous version's per-operator content
digests, and the ``MaterializationStore`` holding its tables, and produces
the new version's sink **byte-identically** to a full run — while touching
only O(|Δrows|) data at each changed operator.

Signed delta representation
---------------------------
Each spine operator's output is expressed against the *previous* version's
materialized output table ``t_p`` as one of:

``_RowDelta(kept, ins, ins_pos)``
    ``kept`` is a boolean mask over ``t_p``'s rows (False = deleted);
    ``ins`` is a table of inserted rows and ``ins_pos`` their row indices
    in the new output.  Surviving ``t_p`` rows keep their relative order
    and fill the remaining positions — the uniform merge invariant every
    rule below preserves, mirroring how each reference operator preserves
    input order.  ``kept.all()`` with no inserts collapses to ``_Empty``.

``_ColDelta(specs)``
    Row-aligned with ``t_p``: each output column is either ``("p", name)``
    — byte-identical to ``t_p``'s column — or ``("arr", ndarray)`` — an
    explicitly computed replacement.  The projection-add/drop and
    aggregate-swap edits start here: rows don't change, columns do.

``_Empty``
    No difference: the output *is* ``t_p`` (served, deduplicated).  Once a
    delta dies (e.g. a narrow's deleted rows all fail a downstream filter
    anyway), every remaining spine operator is served for free.

``_Dense(table)``
    Escape hatch: the output was materialized and the remaining spine runs
    through ``plane.execute_op`` — still skipping everything upstream.
    Always byte-correct; used where a delta rule would not be (SORT with
    inserts, NaN group keys, object columns, ...).

Per-operator rules (the delta algebra): FILTER masks ``t_p`` and ``ins``
with the plane's vectorized ``pred_mask`` — on the torch plane the
relational CUDA kernel computes them; PROJECT and the row-wise model operators
(CLASSIFIER / SENTIMENT / DICT_MATCHER) compute only the insert rows;
JOIN probes the cached build side from the store with canonical key codes
(``engine.canon``) and expands only insert matches; AGGREGATE re-aggregates
only *dirty groups* (groups touched by a delete or insert) and splices
them between the previous output's untouched group rows; DISTINCT tracks
surviving first occurrences per canonical row code.  The final sink delta
is applied against the stored prior sink table.  A PROJECT boundary's
re-derived columns (and a re-derivation along a column delta) are computed
on the host by ``ops_impl.eval_linexpr``, as in the reference package: the
bytes are the same either way.

Everything here is fallback-safe: any violated precondition raises
``DeltaUnsupported`` and the caller reruns the cone as a seeded reuse run.  The
differential tests and the replay oracle enforce the hard gate — a
delta-path sink must be ``tables_identical`` to the full-recompute sink.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import dag as D
from repro_torch.core.delta import AGG_SWAP, PROJECT_COLS, DeltaPlan
from repro_torch.engine.canon import column_codes, combine_codes, keyval, run_bounds
from repro_torch.engine.executor import ExecResult, ExecStats, ExecutionPlan
from repro_torch.engine.store import MaterializationStore
from repro_torch.engine.table import Table


class DeltaUnsupported(RuntimeError):
    """A delta rule cannot reproduce this operator byte-exactly (or a
    required table is gone from the store) — fall back to cone recompute,
    never to a possibly-wrong answer."""


# -- delta states -------------------------------------------------------------


class _Empty:
    """Output == t_p byte-for-byte."""

    __slots__ = ()


class _RowDelta:
    __slots__ = ("kept", "ins", "ins_pos")

    def __init__(self, kept: np.ndarray, ins: Table, ins_pos: np.ndarray):
        self.kept = kept
        self.ins = ins
        self.ins_pos = ins_pos

    def n_delta(self) -> int:
        return len(self.ins) + int((~self.kept).sum())


class _ColDelta:
    __slots__ = ("specs",)

    def __init__(self, specs: List[Tuple[str, str, object]]):
        # (out_col_name, "p"|"arr", t_p column name | ndarray)
        self.specs = specs

    def all_p(self, t_p: Table) -> bool:
        return (
            all(k == "p" and pay == name for name, k, pay in self.specs)
            and [name for name, _, _ in self.specs] == t_p.order
        )


class _Dense:
    __slots__ = ("table",)

    def __init__(self, table: Table):
        self.table = table


_EMPTY = _Empty()


def _p_positions(kept: np.ndarray, ins_pos: np.ndarray) -> np.ndarray:
    """Output row index of each surviving ``t_p`` row (in order): the
    complement of the insert positions."""
    n = int(kept.sum()) + len(ins_pos)
    free = np.ones(n, dtype=bool)
    free[ins_pos] = False
    return np.flatnonzero(free)


def _materialize(state, t_p: Table) -> Table:
    """Explicit table for a state expressed against ``t_p``."""
    if isinstance(state, _Empty):
        return t_p
    if isinstance(state, _Dense):
        return state.table
    if isinstance(state, _ColDelta):
        cols = {}
        order = []
        for name, kind, payload in state.specs:
            cols[name] = t_p.cols[payload] if kind == "p" else payload
            order.append(name)
        if len(set(order)) != len(order):
            raise DeltaUnsupported("duplicate output columns")
        return Table(cols, order)
    kept, ins, ins_pos = state.kept, state.ins, state.ins_pos
    if len(ins) == 0:
        return t_p if kept.all() else t_p.mask(kept)
    if ins.order != t_p.order:
        raise DeltaUnsupported("insert schema drifted from t_p")
    p_pos = _p_positions(kept, ins_pos)
    n = len(p_pos) + len(ins)
    cols = {}
    for c in t_p.order:
        a = t_p.cols[c][kept]
        b = ins.cols[c]
        if a.dtype != b.dtype:
            raise DeltaUnsupported(f"dtype mismatch on {c}")
        out = np.empty(n, dtype=a.dtype)
        out[p_pos] = a
        out[ins_pos] = b
        cols[c] = out
    return Table(cols, list(t_p.order))


def _empty_like(t: Table) -> Table:
    return t.take(np.array([], dtype=int))


def _normalize(state, t_p: Table):
    """Collapse degenerate states to ``_Empty`` so downstream serves."""
    if isinstance(state, _RowDelta):
        if len(state.ins) == 0 and bool(state.kept.all()):
            return _EMPTY
    elif isinstance(state, _ColDelta) and state.all_p(t_p):
        return _EMPTY
    return state


def _codes_or_unsupported(arr: np.ndarray, *, nan_distinct: bool) -> np.ndarray:
    try:
        return column_codes(arr, nan_distinct=nan_distinct)
    except TypeError as e:
        raise DeltaUnsupported(str(e)) from e


def _mixed_zero_signs(col: np.ndarray) -> bool:
    if col.dtype.kind != "f":
        return False
    zeros = col == 0.0
    if not zeros.any():
        return False
    sb = np.signbit(col[zeros])
    return bool(sb.any() and not sb.all())


# -- the entry point ----------------------------------------------------------


def execute_delta(
    dplan: DeltaPlan,
    P: D.DataflowDAG,
    q_plan: ExecutionPlan,
    p_digests: Dict[str, Optional[str]],
    store: MaterializationStore,
) -> ExecResult:
    """Run Q's changed spine as delta propagation; serve everything else.

    Preconditions (any failure raises ``DeltaUnsupported``): every exact
    operator the spine reads has a Q content digest equal to its P
    counterpart's (same sources ⇒ bit-identical, the reuse seeding rule)
    and its table is in the store; every spine P output is in the store.
    Spine outputs are re-materialized under Q's digests so the *next*
    version's frontier/delta finds them.
    """
    t_start = time.perf_counter()
    Q = q_plan.dag
    plane = q_plan.plane
    q_digests = q_plan.digests
    spine_map = dplan.spine_map
    exact_map = dplan.exact_map
    stats = ExecStats(ops_total=len(Q.ops), plane=plane.name)

    def exact_key(q_id: str) -> str:
        p_id = exact_map.get(q_id)
        qd = q_digests.get(q_id)
        if p_id is None or qd is None or qd != p_digests.get(p_id):
            raise DeltaUnsupported(f"{q_id} is not digest-exact")
        return qd

    # pin everything this run reads against concurrent eviction
    want = set()
    for q_id, p_id in spine_map.items():
        if p_digests.get(p_id):
            want.add(p_digests[p_id])
    for q_id in Q.ops:
        if q_id in exact_map and q_digests.get(q_id):
            want.add(q_digests[q_id])
    pinned = store.pin(want) if hasattr(store, "pin") else ()
    try:
        return _execute_delta_pinned(
            dplan, P, q_plan, p_digests, store, stats, exact_key, t_start
        )
    finally:
        if pinned:
            store.unpin(pinned)


def _execute_delta_pinned(
    dplan: DeltaPlan,
    P: D.DataflowDAG,
    q_plan: ExecutionPlan,
    p_digests: Dict[str, Optional[str]],
    store: MaterializationStore,
    stats: ExecStats,
    exact_key,
    t_start: float,
) -> ExecResult:
    Q = q_plan.dag
    plane = q_plan.plane
    q_digests = q_plan.digests
    spine_map = dplan.spine_map
    exact_map = dplan.exact_map
    consumed_exact: set = set()

    def fetch(key: str, what: str) -> Table:
        t = store.get(key)
        if t is None:
            raise DeltaUnsupported(f"{what} not materialized ({key})")
        return t

    def fetch_exact(q_id: str) -> Table:
        t = fetch(exact_key(q_id), f"exact input {q_id}")
        consumed_exact.add(q_id)
        return t

    def fetch_p(q_id: str) -> Table:
        p_id = spine_map[q_id]
        key = p_digests.get(p_id)
        if key is None:
            raise DeltaUnsupported(f"no P digest for {p_id}")
        t = fetch(key, f"P output {p_id}")
        stats.recompute_time_saved += getattr(
            store, "recorded_cost", lambda k: 0.0
        )(key)
        return t

    # -- boundary: turn the edit into an initial delta state
    b_q = dplan.boundary_q
    q_op = Q.ops[b_q]
    p_op = P.ops[dplan.boundary_p]
    in_ids = [l.src for l in Q.in_links[b_q]]
    q_in = [fetch_exact(i) for i in in_ids]
    t_p = fetch_p(b_q)
    t0 = time.perf_counter()
    if q_op.op_type == D.FILTER:
        state = _boundary_filter(q_op, p_op, q_in[0], t_p, plane, stats)
    elif dplan.klass == PROJECT_COLS:
        state = _boundary_project(q_op, p_op, q_in[0], t_p, stats)
    elif dplan.klass == AGG_SWAP:
        state = _boundary_agg_swap(q_op, p_op, q_in[0], t_p, plane, stats)
    else:
        raise DeltaUnsupported(f"no boundary rule for {dplan.klass}")
    state = _normalize(state, t_p)
    stats.ops_delta += 1
    sink_table = _store_spine_output(store, stats, q_digests, b_q, state,
                                     t_p, time.perf_counter() - t0)

    # -- propagate along the spine
    prev_q = b_q
    t_p_in = t_p
    for q_id in dplan.spine[1:]:
        op = Q.ops[q_id]
        t_p_out = fetch_p(q_id)
        side: Dict[int, Table] = {}
        spine_port = None
        for port, l in enumerate(Q.in_links[q_id]):
            if l.src == prev_q:
                spine_port = l.dst_port
            else:
                side[l.dst_port] = fetch_exact(l.src)
        t0 = time.perf_counter()
        state, dense_exec = _transition(
            op, state, t_p_in, t_p_out, side, spine_port, plane, stats
        )
        state = _normalize(state, t_p_out)
        if dense_exec:
            stats.ops_executed += 1
        else:
            stats.ops_delta += 1
        sink_table = _store_spine_output(store, stats, q_digests, q_id,
                                         state, t_p_out,
                                         time.perf_counter() - t0)
        prev_q = q_id
        t_p_in = t_p_out

    # -- other sinks are exact: serve them from the store
    results: Dict[str, Table] = {dplan.sink: sink_table}
    for s in Q.sinks:
        if s != dplan.sink:
            results[s] = fetch_exact(s)
    stats.tables_served += len(consumed_exact)
    stats.ops_reused = len(consumed_exact)
    stats.ops_skipped = (stats.ops_total - stats.ops_executed
                         - stats.ops_reused - stats.ops_delta)
    stats.wall_time = time.perf_counter() - t_start
    return ExecResult(
        results=results,
        stats=stats,
        reused_ops=tuple(sorted(consumed_exact)),
    )


def _store_spine_output(store, stats, q_digests, q_id, state, t_p, elapsed):
    """Materialize a spine output under Q's digest: the next version's
    exact/delta tier keys on it.  ``_Empty`` serves t_p — a pure dedup.
    Returns the materialized table (the sink's is the run's result)."""
    key = q_digests.get(q_id)
    if key is None:
        raise DeltaUnsupported(f"no Q digest for {q_id}")
    table = _materialize(state, t_p)
    wrote = store.put(key, table, elapsed)
    stats.store_writes += wrote
    stats.store_dedup_skipped += not wrote
    return table


# -- boundary rules -----------------------------------------------------------


def _boundary_filter(q_op, p_op, q_in, t_p, plane, stats):
    """narrow / widen / filter-general: two vectorized masks over the
    store-materialized input.  Δ = (rows passing p but not p′ → deletes,
    rows passing p′ but not p → inserts); for a provable narrow the insert
    set is empty by construction, for a widen the delete set is."""
    p_pred = p_op.get("pred")
    q_pred = q_op.get("pred")
    mask_q = np.asarray(plane.pred_mask(q_pred, q_in), dtype=bool)
    mask_p = np.asarray(plane.pred_mask(p_pred, q_in), dtype=bool)
    if int(mask_p.sum()) != len(t_p):
        raise DeltaUnsupported("stored P output disagrees with P's mask")
    kept = mask_q[mask_p]
    ins_idx = np.flatnonzero(mask_q & ~mask_p)
    ins = q_in.take(ins_idx)
    ins_pos = (np.cumsum(mask_q) - 1)[ins_idx].astype(np.int64)
    rd = _RowDelta(kept, ins, ins_pos)
    stats.delta_rows_processed += rd.n_delta()
    return rd


def _boundary_project(q_op, p_op, q_in, t_p, stats):
    """Column add/drop/re-derive over row-aligned tables: unchanged
    ``(name, expr)`` entries serve P's column; new/changed ones compute
    over the exact input — the rows never move."""
    from repro_torch.engine.ops_impl import eval_linexpr

    if len(q_in) != len(t_p):
        raise DeltaUnsupported("stored P output row count drifted")
    p_map = {name: expr for name, expr in p_op.get("cols")}
    specs: List[Tuple[str, str, object]] = []
    for name, expr in q_op.get("cols"):
        if name in p_map and repr(p_map[name]) == repr(expr):
            specs.append((name, "p", name))
        elif isinstance(expr, str):
            if expr not in q_in.cols:
                raise DeltaUnsupported(f"unknown column {expr}")
            specs.append((name, "arr", q_in.cols[expr]))
        else:
            specs.append((name, "arr", eval_linexpr(expr, q_in)))
            stats.delta_rows_processed += len(q_in)
    return _ColDelta(specs)


def _boundary_agg_swap(q_op, p_op, q_in, t_p, plane, stats):
    """Same ``group_by`` ⇒ identical groups in identical (repr-sorted)
    order: group-key columns and unchanged aggregates serve P's columns,
    only swapped-in aggregates run — as a reduced AGGREGATE over the exact
    input with just the missing ``(fn, col, out)`` triples."""
    group_by = list(q_op.get("group_by", ()))
    q_aggs = [tuple(a) for a in q_op.get("aggs")]
    p_aggs = {tuple(a) for a in p_op.get("aggs")}
    out_names = group_by + [a[2] for a in q_aggs]
    if len(set(out_names)) != len(out_names):
        raise DeltaUnsupported("duplicate aggregate output columns")
    missing = [a for a in q_aggs if a not in p_aggs]
    arr_cols: Dict[str, np.ndarray] = {}
    if missing:
        reduced = q_op.with_props(aggs=tuple(missing))
        red_out = plane.execute_op(reduced, [q_in])
        if len(red_out) != len(t_p):
            raise DeltaUnsupported("group census drifted")
        arr_cols = {a[2]: red_out.cols[a[2]] for a in missing}
        stats.delta_rows_processed += len(q_in)
    specs: List[Tuple[str, str, object]] = [
        (c, "p", c) for c in group_by
    ]
    for a in q_aggs:
        if a in p_aggs:
            specs.append((a[2], "p", a[2]))
        else:
            specs.append((a[2], "arr", arr_cols[a[2]]))
    return _ColDelta(specs)


# -- spine transitions --------------------------------------------------------


def _transition(op, state, t_p_in, t_p_out, side, spine_port, plane, stats):
    """One spine step: returns ``(new_state, dense_executed)``."""
    t = op.op_type
    if isinstance(state, _Empty):
        return _EMPTY, False  # output == t_p_out; nothing to do

    if isinstance(state, _Dense):
        return _Dense(_dense_exec(op, state.table, side, spine_port,
                                  plane)), True

    if isinstance(state, _ColDelta):
        return _transition_cols(op, state, t_p_in, t_p_out, side,
                                spine_port, plane, stats)

    # _RowDelta
    if t == D.FILTER:
        return _row_filter(op, state, t_p_in, t_p_out, plane, stats), False
    if t == D.PROJECT:
        return _row_project(op, state, t_p_out, plane, stats), False
    if t in (D.CLASSIFIER, D.SENTIMENT, D.DICT_MATCHER):
        return _row_model(op, state, t_p_out, plane, stats), False
    if t == D.REPLICATE or t == D.SINK:
        stats.delta_rows_processed += state.n_delta()
        return state, False
    if t == D.JOIN:
        return _row_join(op, state, t_p_in, t_p_out, side, spine_port,
                         plane, stats), False
    if t == D.AGGREGATE:
        return _row_aggregate(op, state, t_p_in, t_p_out, plane, stats)
    if t == D.DISTINCT:
        return _row_distinct(op, state, t_p_in, t_p_out, plane, stats)
    if t == D.SORT:
        dense = _materialize(state, t_p_in)
        stats.delta_rows_processed += state.n_delta()
        return _Dense(plane.execute_op(op, [dense])), True
    raise DeltaUnsupported(f"no delta rule for {t}")


def _dense_exec(op, dense_in, side, spine_port, plane):
    inputs = _assemble_inputs(op, dense_in, side, spine_port)
    return plane.execute_op(op, inputs)


def _assemble_inputs(op, spine_table, side, spine_port):
    n_in = 1 + len(side)
    inputs: List[Optional[Table]] = [None] * n_in
    if spine_port is None or spine_port >= n_in:
        raise DeltaUnsupported("spine port out of range")
    inputs[spine_port] = spine_table
    for port, tbl in side.items():
        if port >= n_in or inputs[port] is not None:
            raise DeltaUnsupported("input port collision")
        inputs[port] = tbl
    return inputs


def _row_filter(op, rd, t_p_in, t_p_out, plane, stats):
    pred = op.get("pred")
    mask_p = np.asarray(plane.pred_mask(pred, t_p_in), dtype=bool)
    if int(mask_p.sum()) != len(t_p_out):
        raise DeltaUnsupported("stored filter output disagrees with mask")
    kept_out = rd.kept[mask_p]
    if len(rd.ins):
        mask_ins = np.asarray(plane.pred_mask(pred, rd.ins), dtype=bool)
        n_qin = int(rd.kept.sum()) + len(rd.ins)
        surv = np.zeros(n_qin, dtype=bool)
        surv[_p_positions(rd.kept, rd.ins_pos)] = mask_p[rd.kept]
        surv[rd.ins_pos] = mask_ins
        newpos = np.cumsum(surv) - 1
        ins_out = rd.ins.mask(mask_ins)
        ins_pos_out = newpos[rd.ins_pos[mask_ins]].astype(np.int64)
    else:
        ins_out = rd.ins
        ins_pos_out = rd.ins_pos
    out = _RowDelta(kept_out, ins_out, ins_pos_out)
    stats.delta_rows_processed += out.n_delta()
    return out


def _row_project(op, rd, t_p_out, plane, stats):
    ins_out = plane.execute_op(op, [rd.ins])
    _check_delta_schema(ins_out, t_p_out)
    out = _RowDelta(rd.kept, ins_out, rd.ins_pos)
    stats.delta_rows_processed += out.n_delta()
    return out


def _row_model(op, rd, t_p_out, plane, stats):
    """CLASSIFIER / SENTIMENT / DICT_MATCHER are pure per-row column
    appends: the kept rows' outputs are already in t_p_out, only the
    insert rows pay the per-row model cost."""
    ins_out = plane.execute_op(op, [rd.ins])
    _check_delta_schema(ins_out, t_p_out)
    out = _RowDelta(rd.kept, ins_out, rd.ins_pos)
    stats.delta_rows_processed += out.n_delta()
    return out


def _check_delta_schema(ins_out: Table, t_p_out: Table) -> None:
    if ins_out.order != t_p_out.order:
        raise DeltaUnsupported("delta schema mismatch")
    for c in t_p_out.order:
        if ins_out.cols[c].dtype != t_p_out.cols[c].dtype:
            raise DeltaUnsupported(f"delta dtype mismatch on {c}")


def _row_join(op, rd, t_p_in, t_p_out, side, spine_port, plane, stats):
    """Inner join with the spine on the probe (left) side: per-left-row
    match windows come from canonical key codes + a stable sort of the
    cached build side (the ``MaterializationStore`` holds it — it is
    exact-tier).  Deleted left rows delete their whole match blocks;
    inserted left rows probe only their own keys."""
    if spine_port != 0:
        raise DeltaUnsupported("delta join requires the spine on port 0")
    if op.get("how", "inner") != "inner":
        raise DeltaUnsupported("delta join supports inner joins only")
    right = side.get(1)
    if right is None:
        raise DeltaUnsupported("missing build side")
    on = list(op.get("on"))
    left, ins = t_p_in, rd.ins
    ren = {c: f"r_{c}" for c in right.order if c in left.order}
    r = right.rename(ren)
    r_on = [ren.get(rc, rc) for _, rc in on]
    l_on = [lc for lc, _ in on]

    nl, ni, nr = len(left), len(ins), len(r)
    code_cols = []
    for lc, rc in zip(l_on, r_on):
        both = np.concatenate([
            np.asarray(left.cols[lc]), np.asarray(ins.cols[lc]),
            np.asarray(r.cols[rc]),
        ])
        code_cols.append(_codes_or_unsupported(both, nan_distinct=True))
    joint = combine_codes(code_cols)
    lk, ik, rk = joint[:nl], joint[nl:nl + ni], joint[nl + ni:]

    order_r = np.argsort(rk, kind="stable")
    sr = rk[order_r]
    lo_l = np.searchsorted(sr, lk, side="left")
    hi_l = np.searchsorted(sr, lk, side="right")
    counts_l = (hi_l - lo_l).astype(np.int64)
    if int(counts_l.sum()) != len(t_p_out):
        raise DeltaUnsupported("stored join output disagrees with probe")
    out_left = np.repeat(np.arange(nl), counts_l)
    kept_out = rd.kept[out_left]

    lo_i = np.searchsorted(sr, ik, side="left")
    hi_i = np.searchsorted(sr, ik, side="right")
    counts_i = (hi_i - lo_i).astype(np.int64)
    total_i = int(counts_i.sum())
    if total_i:
        ri = np.concatenate(
            [order_r[lo_i[j]:hi_i[j]] for j in range(ni)]
        ).astype(np.int64)
    else:
        ri = np.array([], dtype=np.int64)
    left_rep = ins.take(np.repeat(np.arange(ni), counts_i))
    right_part = r.take(ri)
    cols = {c: left_rep.cols[c] for c in ins.order}
    for c in r.order:
        cols[c] = right_part.cols[c]
    ins_out = Table(cols, list(ins.order) + list(r.order))
    _check_delta_schema(ins_out, t_p_out)

    # positions: Q emits left-row-major over Q's input order
    n_qin = int(rd.kept.sum()) + ni
    p_pos = _p_positions(rd.kept, rd.ins_pos)
    cnt_q = np.zeros(n_qin, dtype=np.int64)
    cnt_q[p_pos] = counts_l[rd.kept]
    cnt_q[rd.ins_pos] = counts_i
    off = np.concatenate([[0], np.cumsum(cnt_q)[:-1]]).astype(np.int64)
    if total_i:
        block_start = off[rd.ins_pos]
        within = (np.arange(total_i)
                  - np.repeat(np.cumsum(counts_i) - counts_i, counts_i))
        ins_pos_out = (np.repeat(block_start, counts_i) + within).astype(
            np.int64
        )
    else:
        ins_pos_out = np.array([], dtype=np.int64)
    out = _RowDelta(kept_out, ins_out, ins_pos_out)
    stats.delta_rows_processed += out.n_delta()
    return out


def _row_aggregate(op, rd, t_p_in, t_p_out, plane, stats):
    """Re-aggregate only dirty groups; splice between the prior output's
    clean group rows.  Returns ``(_Dense, False)`` — aggregate outputs are
    small, so downstream runs dense — or escapes dense-in on NaN/object
    group keys or an empty ``group_by``."""
    group_by = list(op.get("group_by", ()))
    stats.delta_rows_processed += rd.n_delta()
    if not group_by:
        dense = _materialize(rd, t_p_in)
        return _Dense(plane.execute_op(op, [dense])), True
    for c in group_by:
        for tbl in (t_p_in, rd.ins):
            col = np.asarray(tbl.cols[c])
            if col.dtype == object:
                dense = _materialize(rd, t_p_in)
                return _Dense(plane.execute_op(op, [dense])), True
            if col.dtype.kind == "f" and np.isnan(col).any():
                # NaN keys are each their own group — unmatchable
                dense = _materialize(rd, t_p_in)
                return _Dense(plane.execute_op(op, [dense])), True

    nl, ni, no = len(t_p_in), len(rd.ins), len(t_p_out)
    code_cols = []
    for c in group_by:
        both = np.concatenate([
            np.asarray(t_p_in.cols[c]), np.asarray(rd.ins.cols[c]),
            np.asarray(t_p_out.cols[c]),
        ])
        code_cols.append(_codes_or_unsupported(both, nan_distinct=False))
    joint = combine_codes(code_cols)
    kp, ki, ko = joint[:nl], joint[nl:nl + ni], joint[nl + ni:]

    dirty = np.unique(np.concatenate([kp[~rd.kept], ki]))
    if len(dirty) == 0:
        return _EMPTY, False
    clean_mask = ~np.isin(ko, dirty)

    # dirty input rows, gathered in Q input order
    sel_p = rd.kept & np.isin(kp, dirty)
    p_pos = _p_positions(rd.kept, rd.ins_pos)
    qpos_p = p_pos[sel_p[rd.kept]]
    rows_p = t_p_in.take(np.flatnonzero(sel_p))
    parts_pos = np.concatenate([qpos_p, rd.ins_pos])
    order_q = np.argsort(parts_pos, kind="stable")
    if ni:
        if rows_p.order != list(rd.ins.order):
            raise DeltaUnsupported("insert schema drifted from t_p")
        dirty_in = rows_p.concat(rd.ins).take(order_q)
    else:
        dirty_in = rows_p.take(order_q)
    dirty_out = plane.execute_op(op, [dirty_in])
    stats.delta_rows_processed += len(dirty_in)

    if len(dirty_out) == 0:
        if clean_mask.all():
            return _EMPTY, False
        return _Dense(t_p_out.mask(clean_mask)), False

    # merge clean prior rows with re-aggregated dirty rows in the
    # reference's global group order: repr of the canonicalized key tuple
    _check_delta_schema(dirty_out, t_p_out)
    first_of = {}
    for i in np.flatnonzero(clean_mask):
        first_of[int(ko[i])] = None
    # representative input row per clean output group (all its rows kept)
    uniq_p, first_p = np.unique(kp, return_index=True)
    rep = dict(zip(uniq_p.tolist(), first_p.tolist()))
    clean_keys = []
    for i in np.flatnonzero(clean_mask):
        j = rep.get(int(ko[i]))
        if j is None:
            raise DeltaUnsupported("clean group lost its input rows")
        clean_keys.append(
            repr(tuple(keyval(t_p_in.cols[c][j]) for c in group_by))
        )
    dirty_keys = [
        repr(tuple(keyval(dirty_in.cols[c][j]) for c in group_by))
        for j in _group_rep_rows(dirty_in, group_by)
    ]
    if len(dirty_keys) != len(dirty_out):
        raise DeltaUnsupported("dirty group count drifted")

    tagged = [(k, 0, i) for i, k in enumerate(clean_keys)] + [
        (k, 1, i) for i, k in enumerate(dirty_keys)
    ]
    tagged.sort(key=lambda t: t[0])
    clean_rows = np.flatnonzero(clean_mask)
    cols = {}
    for c in t_p_out.order:
        a, b = t_p_out.cols[c][clean_rows], dirty_out.cols[c]
        if a.dtype != b.dtype:
            raise DeltaUnsupported(f"group column dtype drifted on {c}")
        out = np.empty(len(tagged), dtype=a.dtype)
        for pos, (_, side_tag, i) in enumerate(tagged):
            out[pos] = b[i] if side_tag else a[i]
        cols[c] = out
    return _Dense(Table(cols, list(t_p_out.order))), False


def _group_rep_rows(src: Table, group_by) -> List[int]:
    """First input row of each group, in the reference output order
    (groups sorted by repr of the canonicalized key tuple)."""
    seen: Dict[str, int] = {}
    keys = []
    for i in range(len(src)):
        k = repr(tuple(keyval(src.cols[c][i]) for c in group_by))
        if k not in seen:
            seen[k] = i
            keys.append(k)
    return [seen[k] for k in sorted(keys)]


def _row_distinct(op, rd, t_p_in, t_p_out, plane, stats):
    """Deletes-only fast path: a group's surviving first occurrence is the
    new representative.  Inserts (or repr-hostile columns) escape dense."""
    stats.delta_rows_processed += rd.n_delta()
    if len(rd.ins) or any(
        t_p_in.cols[c].dtype == object or _mixed_zero_signs(t_p_in.cols[c])
        for c in t_p_in.order
    ):
        dense = _materialize(rd, t_p_in)
        return _Dense(plane.execute_op(op, [dense])), True

    codes = combine_codes([
        _codes_or_unsupported(t_p_in.cols[c], nan_distinct=False)
        for c in t_p_in.order
    ])
    n = len(codes)
    uniq, first = np.unique(codes, return_index=True)
    if len(first) != len(t_p_out):
        raise DeltaUnsupported("stored distinct output disagrees")
    # first *kept* occurrence per code
    so = np.argsort(codes, kind="stable")
    cs = codes[so]
    _, starts, _ = run_bounds(cs)
    cand = np.where(rd.kept[so], so, n)
    first_kept = np.minimum.reduceat(cand, starts) if n else np.array(
        [], dtype=np.int64
    )
    # p_out row j represents uniq[perm[j]] where perm sorts first asc.
    perm = np.argsort(first, kind="stable")
    fk = first_kept[perm]
    fo = first[perm]
    kept_out = fk == fo
    ins_rows = fk[(fk < n) & ~kept_out]
    q_rows = np.sort(fk[fk < n])
    ins_table = t_p_in.take(np.sort(ins_rows))
    ins_pos = np.searchsorted(q_rows, np.sort(ins_rows)).astype(np.int64)
    out = _RowDelta(kept_out, ins_table, ins_pos)
    return out, False


# -- column-delta transitions -------------------------------------------------


def _transition_cols(op, cd, t_p_in, t_p_out, side, spine_port, plane,
                     stats):
    t = op.op_type
    spec_map = {name: (kind, pay) for name, kind, pay in cd.specs}

    def is_p(col: str) -> bool:
        # strict: the Q column named `col` is byte-identical to t_p's
        # *same-named* column — the only alignment the P-side operator
        # (identical signature) actually reads
        return spec_map.get(col) == ("p", col)

    def dense():
        table = _materialize(cd, t_p_in)
        stats.delta_rows_processed += len(table)
        return _Dense(_dense_exec(op, table, side, spine_port, plane)), True

    if t == D.FILTER:
        pred = op.get("pred")
        if not all(is_p(c) for c in pred.columns):
            return dense()
        mask = np.asarray(plane.pred_mask(pred, t_p_in), dtype=bool)
        if int(mask.sum()) != len(t_p_out):
            raise DeltaUnsupported("stored filter output disagrees")
        specs = []
        for name, kind, pay in cd.specs:
            if kind == "p":
                specs.append((name, "p", pay))
            else:
                specs.append((name, "arr", pay[mask]))
                stats.delta_rows_processed += int(mask.sum())
        return _ColDelta(specs), False

    if t == D.PROJECT:
        from repro_torch.engine.ops_impl import eval_linexpr

        specs = []
        for name, expr in op.get("cols"):
            if isinstance(expr, str):
                got = spec_map.get(expr)
                if got is None:
                    return dense()
                kind, pay = got
                if kind == "p":
                    # q_in[expr] == t_p_in[pay]; P's identical projection
                    # makes t_p_out[name] == t_p_in[expr] — only safe to
                    # serve by name when pay == expr, else pass the bytes
                    if pay == expr:
                        specs.append((name, "p", name))
                    else:
                        specs.append((name, "arr", t_p_in.cols[pay]))
                else:
                    specs.append((name, "arr", pay))
            else:
                needed = [c for c, _ in expr.coeffs]
                if all(is_p(c) for c in needed):
                    specs.append((name, "p", name))
                else:
                    if not all(c in spec_map for c in needed):
                        return dense()
                    tmp = Table(
                        {c: (t_p_in.cols[spec_map[c][1]]
                             if spec_map[c][0] == "p" else spec_map[c][1])
                         for c in needed},
                        needed,
                    )
                    specs.append((name, "arr", eval_linexpr(expr, tmp)))
                    stats.delta_rows_processed += len(tmp)
        # a "p" spec must actually name a t_p_out column
        for name, kind, pay in specs:
            if kind == "p" and pay not in t_p_out.cols:
                return dense()
        return _ColDelta(specs), False

    if t in (D.CLASSIFIER, D.SENTIMENT, D.DICT_MATCHER):
        col, out = op.get("col"), op.get("out")
        if not is_p(col) or out not in t_p_out.cols:
            return dense()
        specs = [(name, kind, pay) for name, kind, pay in cd.specs
                 if name != out]
        specs.append((out, "p", out))
        by_name = {name: (kind, pay) for name, kind, pay in specs}
        try:
            ordered = [(c, *by_name[c]) for c in t_p_out.order]
        except KeyError:
            return dense()
        return _ColDelta(ordered), False

    if t == D.AGGREGATE:
        needed = list(op.get("group_by", ())) + [
            c for _, c, _ in op.get("aggs") if c != "*"
        ]
        if all(is_p(c) for c in needed):
            return _EMPTY, False  # groups and values untouched by the edit
        return dense()

    if t in (D.JOIN, D.DISTINCT, D.SORT):
        if cd.all_p(t_p_in):
            return _EMPTY, False
        return dense()

    if t in (D.REPLICATE, D.SINK):
        return cd, False

    return dense()
