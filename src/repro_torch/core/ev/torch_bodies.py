"""Traceable torch semantics for dataflow operators (feeds ``FxEV``).

Tables are modeled as ``(cols: dict[str, f32[N]], mask: bool[N])`` — a fixed
row capacity with a validity mask, so every operator is a shape-stable pure
function and the whole window traces to one ``torch.fx`` graph.  Bodies are
*faithful models* of the engine semantics: identical graphs ⇒ identical
engine results (every semantics-bearing property is folded into the trace
as a Python scalar, e.g. the classifier "model" string becomes a salt).

Every constant is built inside the trace from Python scalars
(``torch.full``, ``torch.where(mask, 0.0, 1.0)``, ``torch.arange``), so its
value is printed in the graph's code; a tensor captured from outside the
trace would print only as a name, and ``FxEV`` refuses such graphs.

The fragment is the reference package's ``core/ev/jax_bodies.py``:
``TRACEABLE_OPS`` and ``op_traceable`` name the same operators, and the
UDF (``double_all``, ``add_rowsum``) and nonlinear-atom (``prod_pos``,
``not_prod_pos``) registries hold the same functions.  The registries are
this package's own.

Not every engine op has a body (group-by aggregates, string predicates,
joins) — ``FxEV``'s validator rejects windows containing those.
"""

from __future__ import annotations

import zlib
from typing import Callable, Dict, List, Tuple

import torch

from repro_torch.core import dag as D
from repro_torch.core.predicates import LinCmp, LinExpr, NonLinearAtom, Pred, StrEq

TTable = Tuple[Dict[str, torch.Tensor], torch.Tensor]  # (cols, mask)

TORCH_UDF_REGISTRY: Dict[str, Callable[[TTable], TTable]] = {}
TORCH_NONLINEAR_FNS: Dict[str, Callable[..., torch.Tensor]] = {}


def register_torch_udf(name: str):
    def deco(fn):
        TORCH_UDF_REGISTRY[name] = fn
        return fn

    return deco


def register_torch_nonlinear(name: str):
    def deco(fn):
        TORCH_NONLINEAR_FNS[name] = fn
        TORCH_NONLINEAR_FNS["not_" + name] = lambda *cols, _f=fn: ~_f(*cols)
        return fn

    return deco


@register_torch_nonlinear("prod_pos")
def _tprod_pos(a, b):
    return (a * b) > 0


@register_torch_udf("double_all")
def _tdouble_all(t: TTable) -> TTable:
    cols, mask = t
    return {c: v * 2 for c, v in cols.items()}, mask


@register_torch_udf("add_rowsum")
def _tadd_rowsum(t: TTable) -> TTable:
    cols, mask = t
    s = torch.zeros_like(next(iter(cols.values())))
    for v in cols.values():
        s = s + v
    out = dict(cols)
    out["rowsum"] = s
    return out, mask


def _eval_linexpr(e: LinExpr, cols: Dict[str, torch.Tensor]) -> torch.Tensor:
    n = next(iter(cols.values())).shape[0]
    out = torch.full((n,), float(e.const), dtype=torch.float32)
    for c, v in e.coeffs:
        out = out + float(v) * cols[c]
    return out


def _eval_pred(p: Pred, cols: Dict[str, torch.Tensor]) -> torch.Tensor:
    n = next(iter(cols.values())).shape[0]
    if p.kind == "true":
        return torch.ones((n,), dtype=torch.bool)
    if p.kind == "false":
        return torch.zeros((n,), dtype=torch.bool)
    if p.kind == "not":
        return ~_eval_pred(p.children[0], cols)
    if p.kind == "and":
        m = torch.ones((n,), dtype=torch.bool)
        for c in p.children:
            m = m & _eval_pred(c, cols)
        return m
    if p.kind == "or":
        m = torch.zeros((n,), dtype=torch.bool)
        for c in p.children:
            m = m | _eval_pred(c, cols)
        return m
    a = p.atom
    if isinstance(a, LinCmp):
        v = _eval_linexpr(a.expr, cols)
        if a.op == "<=":
            return v <= 0
        if a.op == "<":
            return v < 0
        if a.op == "==":
            return v == 0
        return v != 0
    if isinstance(a, NonLinearAtom):
        return TORCH_NONLINEAR_FNS[a.fn](*[cols[c] for c in a.cols])
    raise TraceUnsupported(f"atom {a!r} not traceable")


class TraceUnsupported(Exception):
    pass


# ops with torch bodies — the FxEV fragment
TRACEABLE_OPS = frozenset(
    {
        D.SOURCE,
        D.FILTER,
        D.PROJECT,
        D.UNION,
        D.REPLICATE,
        D.SORT,
        D.UDF,
        D.CLASSIFIER,
        D.SENTIMENT,
        D.SINK,
    }
)


def op_traceable(op: "D.Operator") -> bool:
    t = op.op_type
    if t not in TRACEABLE_OPS:
        return False
    if t == D.FILTER:
        p: Pred = op.get("pred")
        return _pred_traceable(p)
    if t == D.UDF:
        return op.get("fn") in TORCH_UDF_REGISTRY
    return True


def _pred_traceable(p: Pred) -> bool:
    if p.kind == "atom":
        if isinstance(p.atom, StrEq):
            return False
        if isinstance(p.atom, NonLinearAtom):
            return p.atom.fn in TORCH_NONLINEAR_FNS
        return True
    return all(_pred_traceable(c) for c in p.children)


def execute_op_torch(op: "D.Operator", inputs: List[TTable]) -> TTable:
    t = op.op_type
    if t in (D.REPLICATE, D.SINK):
        return inputs[0]

    if t == D.FILTER:
        cols, mask = inputs[0]
        return cols, mask & _eval_pred(op.get("pred"), cols)

    if t == D.PROJECT:
        cols, mask = inputs[0]
        out: Dict[str, torch.Tensor] = {}
        for name, expr in op.get("cols"):
            if isinstance(expr, str):
                out[name] = cols[expr]
            else:
                out[name] = _eval_linexpr(expr, cols)
        return out, mask

    if t == D.UNION:
        (ca, ma), (cb, mb) = inputs
        out = {c: torch.cat([ca[c], cb[c]]) for c in ca}
        return out, torch.cat([ma, mb])

    if t == D.SORT:
        cols, mask = inputs[0]
        keys = list(op.get("keys"))
        # invalid rows to the end; then lexicographic by keys via composed
        # stable argsorts (least-significant key first)
        sort_cols = [torch.where(mask, 0.0, 1.0)]
        for col, asc in keys:
            v = cols[col]
            sort_cols.append(v if asc else -v)
        n = mask.shape[0]
        order = torch.arange(n)
        for k in reversed(sort_cols):
            order = order[torch.argsort(k[order], stable=True)]
        return {c: v[order] for c, v in cols.items()}, mask[order]

    if t in (D.CLASSIFIER, D.SENTIMENT):
        cols, mask = inputs[0]
        col, outn = op.get("col"), op.get("out")
        model = op.get("model", "default")
        k = int(op.get("classes", 3))
        # salt the trace with the model identity so different models yield
        # different graphs (soundness of graph-equality verdicts)
        salt = float(zlib.crc32(f"{t}:{model}".encode()) % 1000003)
        h = torch.abs(torch.sin(cols[col] * 12.9898 + salt) * 43758.5453)
        label = torch.floor(h * k) % k
        out = dict(cols)
        out[outn] = label
        return out, mask

    if t == D.UDF:
        return TORCH_UDF_REGISTRY[op.get("fn")](inputs[0])

    raise TraceUnsupported(t)
