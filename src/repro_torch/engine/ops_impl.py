"""Deterministic operator semantics (Assumption §2.2: re-runs reproduce).

Every operator is a pure function of its inputs.  ML-ish operators
(Classifier / SentimentAnalyzer / DictionaryMatcher / UDF) are deterministic
by construction — classifier "models" are stable hashes, UDFs come from a
registry of named pure functions — so the paper's determinism assumption
holds exactly, and the property tests can use execution as ground truth.
"""

from __future__ import annotations

import zlib
from typing import Callable, Dict, List

import numpy as np

from repro_torch.core import dag as D
from repro_torch.core.predicates import LinCmp, LinExpr, NonLinearAtom, Pred, StrEq
from repro_torch.engine.canon import column_codes, keyval as _keyval, run_bounds
from repro_torch.engine.table import Table

# -- registries ---------------------------------------------------------------

UDF_REGISTRY: Dict[str, Callable[[Table], Table]] = {}
NONLINEAR_FNS: Dict[str, Callable[..., np.ndarray]] = {}


def register_udf(name: str):
    def deco(fn):
        UDF_REGISTRY[name] = fn
        return fn

    return deco


def register_nonlinear(name: str):
    def deco(fn):
        NONLINEAR_FNS[name] = fn
        NONLINEAR_FNS["not_" + name] = lambda *cols, _f=fn: ~_f(*cols)
        return fn

    return deco


@register_nonlinear("prod_pos")
def _prod_pos(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return (a * b) > 0


@register_udf("double_all")
def _double_all(t: Table) -> Table:
    return Table({c: (t.cols[c] * 2 if t.cols[c].dtype != object else t.cols[c]) for c in t.order}, t.order)


@register_udf("add_rowsum")
def _add_rowsum(t: Table) -> Table:
    num = [c for c in t.order if t.cols[c].dtype != object]
    s = np.zeros(len(t))
    for c in num:
        s = s + t.cols[c]
    return t.with_col("rowsum", s)


# -- predicate evaluation -------------------------------------------------------


def eval_linexpr(e: LinExpr, t: Table) -> np.ndarray:
    out = np.full(len(t), float(e.const))
    for c, v in e.coeffs:
        out = out + float(v) * t.cols[c].astype(np.float64)
    return out


def eval_pred(p: Pred, t: Table) -> np.ndarray:
    if p.kind == "true":
        return np.ones(len(t), dtype=bool)
    if p.kind == "false":
        return np.zeros(len(t), dtype=bool)
    if p.kind == "not":
        return ~eval_pred(p.children[0], t)
    if p.kind == "and":
        m = np.ones(len(t), dtype=bool)
        for c in p.children:
            m &= eval_pred(c, t)
        return m
    if p.kind == "or":
        m = np.zeros(len(t), dtype=bool)
        for c in p.children:
            m |= eval_pred(c, t)
        return m
    a = p.atom
    if isinstance(a, LinCmp):
        v = eval_linexpr(a.expr, t)
        if a.op == "<=":
            return v <= 1e-12
        if a.op == "<":
            return v < -1e-12
        if a.op == "==":
            return np.abs(v) <= 1e-12
        return np.abs(v) > 1e-12
    if isinstance(a, StrEq):
        col = t.cols[a.col]
        m = np.array([x == a.value for x in col], dtype=bool)
        return ~m if a.negated else m
    if isinstance(a, NonLinearAtom):
        fn = NONLINEAR_FNS[a.fn]
        return np.asarray(fn(*[t.cols[c].astype(np.float64) for c in a.cols]), dtype=bool)
    raise TypeError(a)


# -- deterministic "models" -----------------------------------------------------


def _stable_hash(col: np.ndarray, salt: str) -> np.ndarray:
    out = np.empty(len(col), dtype=np.int64)
    for i, v in enumerate(col):
        out[i] = zlib.crc32((salt + ":" + repr(v)).encode()) & 0x7FFFFFFF
    return out


# -- operator execution ----------------------------------------------------------


def execute_op(op: D.Operator, inputs: List[Table]) -> Table:
    t = op.op_type
    if t == D.SOURCE:
        raise ValueError("sources are bound by the executor")

    if t == D.FILTER:
        return inputs[0].mask(eval_pred(op.get("pred"), inputs[0]))

    if t == D.PROJECT:
        src = inputs[0]
        cols: Dict[str, np.ndarray] = {}
        order: List[str] = []
        for name, expr in op.get("cols"):
            if isinstance(expr, str):
                cols[name] = src.cols[expr]
            else:
                cols[name] = eval_linexpr(expr, src)
            order.append(name)
        return Table(cols, order)

    if t == D.JOIN:
        left, right = inputs
        on = op.get("on")
        how = op.get("how", "inner")
        # rename right-side collision columns like infer_schema does
        ren = {c: f"r_{c}" for c in right.order if c in left.order}
        r = right.rename(ren)
        r_on = [ren.get(rc, rc) for _, rc in on]
        l_on = [lc for lc, _ in on]
        # hash join
        idx: Dict[tuple, List[int]] = {}
        for j in range(len(r)):
            key = tuple(_keyval(r.cols[c][j]) for c in r_on)
            idx.setdefault(key, []).append(j)
        li, ri, unmatched = [], [], []
        for i in range(len(left)):
            key = tuple(_keyval(left.cols[c][i]) for c in l_on)
            matches = idx.get(key, [])
            if matches:
                for j in matches:
                    li.append(i)
                    ri.append(j)
            elif how == "left_outer":
                unmatched.append(i)
        lt = left.take(np.array(li + unmatched, dtype=int)) if (li or unmatched) else left.take(np.array([], dtype=int))
        out_cols = {c: lt.cols[c] for c in left.order}
        for c in r.order:
            matched_vals = r.cols[c][np.array(ri, dtype=int)] if ri else r.cols[c][:0]
            if unmatched:
                if matched_vals.dtype == object:
                    pad = np.array([None] * len(unmatched), dtype=object)
                else:
                    # canonical padding rule, pinned by regression test and
                    # shared by every plane: non-object right columns pad
                    # with np.nan, which deliberately upcasts integer
                    # columns to float64 (int64 has no NULL representation;
                    # the float64 result is the canonical byte layout that
                    # digests and stores key on)
                    pad = np.full(len(unmatched), np.nan)
                matched_vals = np.concatenate([matched_vals, pad])
            out_cols[c] = matched_vals
        return Table(out_cols, left.order + r.order)

    if t == D.UNION:
        return inputs[0].concat(inputs[1])

    if t == D.DISTINCT:
        src = inputs[0]
        seen = {}
        for i in range(len(src)):
            seen.setdefault(repr(src.row(i)), i)
        return src.take(np.array(sorted(seen.values()), dtype=int))

    if t == D.AGGREGATE:
        src = inputs[0]
        group_by = list(op.get("group_by", ()))
        aggs = op.get("aggs")
        groups: Dict[tuple, List[int]] = {}
        for i in range(len(src)):
            key = tuple(_keyval(src.cols[c][i]) for c in group_by)
            groups.setdefault(key, []).append(i)
        keys = sorted(groups.keys(), key=repr)
        cols: Dict[str, List] = {c: [] for c in group_by}
        for fn, c, out in aggs:
            cols[out] = []
        for key in keys:
            rows = groups[key]
            for j, c in enumerate(group_by):
                cols[c].append(key[j])
            for fn, c, out in aggs:
                vals = src.cols[c][rows].astype(np.float64) if c != "*" else None
                if fn == "count":
                    cols[out].append(float(len(rows)))
                elif fn == "sum":
                    cols[out].append(float(vals.sum()))
                elif fn == "min":
                    cols[out].append(float(vals.min()))
                elif fn == "max":
                    cols[out].append(float(vals.max()))
                elif fn == "avg":
                    cols[out].append(float(vals.mean()))
                else:
                    raise ValueError(f"agg fn {fn}")
        order = group_by + [out for _, _, out in aggs]
        return Table({c: _col(cols[c]) for c in order}, order)

    if t == D.SORT:
        src = inputs[0]
        keys = op.get("keys")
        idx = np.arange(len(src))
        for col, asc in reversed(list(keys)):
            vals = src.cols[col]
            if vals.dtype == object:
                order_ = np.argsort(np.array([repr(v) for v in vals])[idx], kind="stable")
            else:
                order_ = np.argsort(vals[idx], kind="stable")
            if not asc:
                order_ = order_[::-1]
                # keep stability for equal keys under descending order
                v = vals[idx][order_]
                order_ = _stable_desc_fix(v, order_)
            idx = idx[order_]
        return src.take(idx)

    if t == D.LIMIT:
        n = int(op.get("n"))
        return inputs[0].take(np.arange(min(n, len(inputs[0]))))

    if t == D.UNNEST:
        src = inputs[0]
        col, out = op.get("col"), op.get("out")
        ridx, vals = [], []
        for i in range(len(src)):
            seq = src.cols[col][i]
            seq = seq if isinstance(seq, (list, tuple)) else [seq]
            for v in seq:
                ridx.append(i)
                vals.append(v)
        base = src.take(np.array(ridx, dtype=int))
        return base.with_col(out, _col(vals))

    if t == D.REPLICATE:
        return inputs[0]

    if t == D.DICT_MATCHER:
        src = inputs[0]
        col, out = op.get("col"), op.get("out")
        entries = set(op.get("entries"))
        vals = np.array([1.0 if v in entries else 0.0 for v in src.cols[col]])
        return src.with_col(out, vals)

    if t in (D.CLASSIFIER, D.SENTIMENT):
        src = inputs[0]
        col, out = op.get("col"), op.get("out")
        model = op.get("model", "default")
        k = int(op.get("classes", 3))
        h = _stable_hash(src.cols[col], f"{t}:{model}")
        return src.with_col(out, (h % k).astype(np.float64))

    if t == D.UDF:
        fn = UDF_REGISTRY[op.get("fn")]
        return fn(inputs[0])

    if t == D.SINK:
        return inputs[0]

    raise ValueError(f"no engine rule for {t}")


def _stable_desc_fix(sorted_vals: np.ndarray, order_: np.ndarray) -> np.ndarray:
    """After reversing an ascending stable sort, runs of equal keys are in
    reversed input order; flip each run back to restore stability.

    Numeric columns use a vectorized run-boundary computation (rounded
    equality is transitive and rounding is monotone, so equal keys are
    adjacent and partition into ``column_codes`` runs — NaNs stay singleton
    runs because ``nan != nan``); object columns keep the scalar walk.
    """
    n = len(order_)
    if n <= 1:
        return order_.copy()
    if sorted_vals.dtype == object:
        i = 0
        out = order_.copy()
        while i < n:
            j = i
            while j + 1 < n and _keyval(sorted_vals[j + 1]) == _keyval(sorted_vals[i]):
                j += 1
            out[i : j + 1] = order_[i : j + 1][::-1]
            i = j + 1
        return out
    codes = column_codes(sorted_vals, nan_distinct=True)
    run_id, starts, ends = run_bounds(codes)
    # position i inside run [s, e] maps to s + e - i: per-run reversal
    mapped = starts[run_id] + ends[run_id] - np.arange(n)
    return order_[mapped]


def _col(vals: List) -> np.ndarray:
    if any(isinstance(v, str) for v in vals):
        return np.array(vals, dtype=object)
    return np.array([float(v) for v in vals]) if vals else np.array([])
