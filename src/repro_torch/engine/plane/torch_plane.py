"""The torch plane: the hot operators on the device, byte-identical to the
reference engine.

The port of the reference package's ``engine/plane/jax_plane.py``.  Every
plane must reproduce the reference engine's per-row dict/loop semantics
**bit for bit** (content digests, materialization keys and reuse all hash
the canonical numpy bytes).  The rules that make that possible:

1. **Dict-key canonicalization is unique-compressed, never re-derived.**
   Join keys, aggregate groups and distinct rows are factorized with
   ``repro_torch.engine.canon.column_codes`` — ``np.unique`` for the
   vectorized part, the real Python ``round``/dict-equality applied only to
   the unique values — so rounded-float collapse, ``-0.0 == 0.0`` and
   NaN-identity semantics match the reference exactly.

2. **Float arithmetic runs in the relational CUDA kernel**
   (``repro_torch.kernels.relational``), which rounds every multiply and
   add on its own, in the reference's order.  A one-time exactness probe
   holds it against the reference on adversarial data at first use; a
   mismatch raises ``PlaneError``.  Nothing switches the kernel off.

3. **Operators the plane does not lower are routed per operator** to the
   reference plane (object-dtype columns, UDFs, descending sorts, ...) —
   mixed-plane execution, decided by what the operator is before it runs.

``device`` is ``"cuda"`` unless the caller asks for ``"cpu"``; on ``"cpu"``
the kernel's plain PyTorch version runs instead of the kernel.  Without a
usable CUDA device, asking for ``"cuda"`` raises ``PlaneError``.

Lowering map:

  FILTER      relational kernel, mask program (LinCmp trees; StrEq /
              NonLinearAtom / constant atoms evaluated host-side and fed
              in as bool masks)
  PROJECT     relational kernel, value program
  JOIN        joint unique-compression of key columns; dense codes probe
              with a host bincount/cumsum table, sparse codes with a
              device stable sort and two searchsorteds; host np.repeat
              expansion
  AGGREGATE   group codes + stable argsort into contiguous segments;
              per-group reductions on contiguous float64 slices (same
              pairwise summation as the reference)
  DISTINCT    per-column codes (NaN collapsed) -> first-occurrence rows
  SORT        ``np.lexsort`` for all-ascending numeric keys
  UNNEST      vectorized identity for scalar numeric columns
  DICT/CLS    unique-compress + per-unique hash/membership, scattered back
  others      reference
"""

from __future__ import annotations

import zlib
from fractions import Fraction
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import dag as D
from repro_torch.core.predicates import LinCmp, LinExpr, NonLinearAtom, Pred, StrEq
from repro_torch.engine.canon import column_codes, combine_codes, keyval, run_bounds
from repro_torch.engine.ops_impl import _col, eval_linexpr, eval_pred
from repro_torch.engine.plane.base import DataPlane, PlaneError
from repro_torch.engine.plane.numpy_plane import NumpyPlane
from repro_torch.engine.table import Table
from repro_torch.kernels import relational as R

_AGG_FNS = ("count", "sum", "min", "max", "avg")
_CODES = {"<=": R.LE, "<": R.LT, "==": R.EQ, "!=": R.NE}


class _PredPlan(NamedTuple):
    """A filter predicate compiled to a mask program."""

    columns: Tuple[str, ...]
    host_atoms: Tuple[object, ...]
    program: R.RelProgram


class _ProjPlan(NamedTuple):
    """A projection compiled to a value program plus pass-through renames."""

    columns: Tuple[str, ...]
    items: Tuple[Tuple[str, str, object], ...]
    program: R.RelProgram


_NO_PLAN = object()


def resolve_device(device: str) -> torch.device:
    """``torch.device`` for ``device``; ``PlaneError`` unless it is a CPU or
    a usable CUDA device."""
    try:
        dev = torch.device(device)
    except (RuntimeError, TypeError) as e:
        raise PlaneError(f"bad device {device!r}: {e}") from e
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise PlaneError(f"the torch plane runs on 'cuda' or 'cpu', not {device!r}")
    if not torch.cuda.is_available():
        raise PlaneError(
            "the torch plane was asked for CUDA, but torch.cuda.is_available() "
            "is False; pass device='cpu' to run it on the host"
        )
    if dev.index is not None and dev.index >= torch.cuda.device_count():
        raise PlaneError(f"no CUDA device {dev.index}")
    return dev


class TorchPlane(DataPlane):
    name = "torch"

    def __init__(self, device: str = "cuda"):
        self.device = resolve_device(device)
        self._ref = NumpyPlane()
        self._pred_plans: Dict[str, object] = {}
        self._proj_plans: Dict[str, object] = {}
        self._probed = False
        self.device_probes = 0  # joins that took the device sort/searchsorted probe
        # relational kernel launches by what asked for them: "probe" (the
        # one-time exactness probe), D.FILTER, D.PROJECT and "pred_mask" (the
        # delta engine's masks); each the kernel's own count across the call
        self.kernel_launches: Dict[str, int] = {}

    # -- protocol -------------------------------------------------------------
    def lowers(self, op: D.Operator, inputs: List[Table]) -> bool:
        t = op.op_type
        try:
            if t == D.FILTER:
                plan = self._pred_plan(op.get("pred"))
                return plan is not None and _numeric(inputs[0], plan.columns)
            if t == D.PROJECT:
                plan = self._proj_plan(op.get("cols"))
                return plan is not None and _numeric(inputs[0], plan.columns)
            if t == D.JOIN:
                left, right = inputs
                on = op.get("on")
                return all(
                    left.cols[lc].dtype != object
                    and right.cols[rc].dtype != object
                    for lc, rc in on
                )
            if t == D.AGGREGATE:
                src = inputs[0]
                group_by = list(op.get("group_by", ()))
                aggs = op.get("aggs")
                if not _numeric(src, group_by):
                    return False
                for fn, c, _ in aggs:
                    if fn not in _AGG_FNS:
                        return False
                    if c == "*":
                        if fn != "count":
                            return False
                    elif c not in src.cols or src.cols[c].dtype == object:
                        return False
                return True
            if t == D.DISTINCT:
                return all(
                    inputs[0].cols[c].dtype != object for c in inputs[0].order
                )
            if t == D.SORT:
                keys = list(op.get("keys"))
                return bool(keys) and all(asc for _, asc in keys) and _numeric(
                    inputs[0], [c for c, _ in keys]
                )
            if t == D.UNNEST:
                return inputs[0].cols[op.get("col")].dtype != object
            if t == D.DICT_MATCHER:
                return inputs[0].cols[op.get("col")].dtype != object
            if t in (D.CLASSIFIER, D.SENTIMENT):
                col = inputs[0].cols[op.get("col")]
                return col.dtype != object and not _mixed_zero_signs(col)
            return False
        except (KeyError, TypeError, AttributeError):
            return False

    def execute_op(self, op: D.Operator, inputs: List[Table]) -> Table:
        if not self.lowers(op, inputs):
            return self._ref.execute_op(op, inputs)
        t = op.op_type
        if t == D.FILTER:
            return self._filter(op, inputs)
        if t == D.PROJECT:
            return self._project(op, inputs)
        if t == D.JOIN:
            return self._join(op, inputs)
        if t == D.AGGREGATE:
            return self._aggregate(op, inputs)
        if t == D.DISTINCT:
            return self._distinct(op, inputs)
        if t == D.SORT:
            return self._sort(op, inputs)
        if t == D.UNNEST:
            return self._unnest(op, inputs)
        if t == D.DICT_MATCHER:
            return self._dict_matcher(op, inputs)
        if t in (D.CLASSIFIER, D.SENTIMENT):
            return self._classifier(op, inputs)
        raise AssertionError(f"lowers/execute_op disagree on {t}")

    # -- host <-> device --------------------------------------------------------
    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        """A numpy array on the plane's device."""
        arr = np.ascontiguousarray(arr)
        if not arr.flags.writeable:
            arr = arr.copy()
        return torch.from_numpy(arr).to(self.device)

    def _column(self, arr: np.ndarray) -> torch.Tensor:
        """A column for the relational kernel, which reads float64 and
        int64: any other numeric dtype is cast to float64 on the host
        first, as the reference's ``astype(np.float64)`` does."""
        if arr.dtype not in (np.float64, np.int64):
            arr = arr.astype(np.float64)
        return self._to_device(arr)

    def _to_host(self, t: torch.Tensor) -> np.ndarray:
        """A result back in host memory as numpy (the copy waits for it)."""
        return t.cpu().numpy()

    # -- FILTER / PROJECT: the relational kernel --------------------------------
    def _check_exact(self) -> None:
        """One-time probe: the kernel path must be bit-identical to the
        reference on adversarial (uniform-float) data.  A mismatch raises
        ``PlaneError``; it never switches the kernel path off."""
        if self._probed:
            return
        rng = np.random.default_rng(0x5EED)
        n = 4096
        t = Table(
            {c: rng.uniform(-1e6, 1e6, n) for c in ("a", "b", "c")},
            ["a", "b", "c"],
        )
        e1 = LinExpr.make({"a": Fraction(5, 2), "b": Fraction(-7, 4)}, 1)
        e2 = LinExpr.make({"b": Fraction(1, 3), "c": 2}, Fraction(-1, 2))
        pred = Pred.and_(Pred.of(LinCmp(e1, "<=")), Pred.of(LinCmp(e2, "<")))
        got_mask = self._eval_pred_plan(self._compile_pred(pred), t, "probe")
        if not np.array_equal(got_mask, eval_pred(pred, t)):
            raise PlaneError(f"exactness probe: filter mask differs on {self.device}")
        cols = (("x", e1), ("y", e2), ("b", "b"))
        got = self._eval_proj_plan(self._compile_proj(cols), t, "probe")
        for name, expr in cols:
            want = t.cols[expr] if isinstance(expr, str) else eval_linexpr(expr, t)
            if got.cols[name].tobytes() != want.tobytes():
                raise PlaneError(
                    f"exactness probe: projected column {name} differs on {self.device}"
                )
        self._probed = True

    def _pred_plan(self, pred: Pred) -> Optional[_PredPlan]:
        key = repr(pred)
        plan = self._pred_plans.get(key)
        if plan is None:
            plan = self._compile_pred(pred) or _NO_PLAN
            self._pred_plans[key] = plan
        return None if plan is _NO_PLAN else plan

    def _compile_pred(self, pred: Pred) -> Optional[_PredPlan]:
        columns: List[str] = []
        prods: List[Tuple[int, float]] = []
        terms: List[Tuple[float, int, int, int]] = []
        host_atoms: List = []

        def slot(c: str) -> int:
            if c not in columns:
                columns.append(c)
            return columns.index(c)

        def emit(p: Pred) -> Optional[Tuple[List[Tuple[int, int]], int]]:
            """Postfix code of ``p`` and the bool-stack depth it needs.  An
            and/or evaluates its deepest child first, so a tree of k
            leaves never needs more than log2(k) + 1 slots."""
            if p.kind in ("true", "false"):
                return [(R.TRUE if p.kind == "true" else R.FALSE, 0)], 1
            if p.kind == "not":
                sub = emit(p.children[0])
                return None if sub is None else (sub[0] + [(R.NOT, 0)], sub[1])
            if p.kind in ("and", "or"):
                op = R.AND if p.kind == "and" else R.OR
                if not p.children:
                    return [(R.TRUE if op == R.AND else R.FALSE, 0)], 1
                subs = [emit(c) for c in p.children]
                if any(sub is None for sub in subs):
                    return None
                subs.sort(key=lambda sub: -sub[1])
                code, depth = list(subs[0][0]), subs[0][1]
                for sub_code, sub_depth in subs[1:]:
                    code += sub_code + [(op, 0)]
                    depth = max(depth, sub_depth + 1)
                return code, depth
            if p.kind == "atom":
                a = p.atom
                if isinstance(a, LinCmp) and a.expr.coeffs:
                    terms.append((float(a.expr.const), _CODES[a.op], len(prods),
                                  len(a.expr.coeffs)))
                    prods.extend((slot(c), float(v)) for c, v in a.expr.coeffs)
                    return [(R.ATOM, len(terms) - 1)], 1
                if isinstance(a, (LinCmp, StrEq, NonLinearAtom)):
                    host_atoms.append(a)
                    return [(R.HOST, len(host_atoms) - 1)], 1
            return None

        tree = emit(pred)
        if tree is None or not terms:
            return None
        program = R.RelProgram(len(columns), tuple(prods), tuple(terms),
                               tuple(tree[0]), len(host_atoms))
        return _PredPlan(tuple(columns), tuple(host_atoms), program)

    def _relational(self, what: str, program, cols, hosts=()):
        """Launch the relational kernel, counting its launches under ``what``
        (a stand-in for the wrapper without a count counts none)."""
        before = getattr(R.relational, "launches", 0)
        out = R.relational(program, cols, list(hosts))
        n = getattr(R.relational, "launches", 0) - before
        if n:
            self.kernel_launches[what] = self.kernel_launches.get(what, 0) + n
        return out

    def _eval_pred_plan(self, plan: _PredPlan, t: Table, what: str) -> np.ndarray:
        hosts = [self._to_device(eval_pred(Pred.of(a), t)) for a in plan.host_atoms]
        cols = [self._column(t.cols[c]) for c in plan.columns]
        return self._to_host(self._relational(what, plan.program, cols, hosts))

    def _filter(self, op: D.Operator, inputs: List[Table]) -> Table:
        self._check_exact()
        plan = self._pred_plan(op.get("pred"))
        return inputs[0].mask(self._eval_pred_plan(plan, inputs[0], D.FILTER))

    def pred_mask(self, pred, t: Table):
        """Keep-mask of ``pred`` over ``t`` through the relational kernel when
        it lowers for this table, else the reference bands — either way
        bit-identical to ``eval_pred``."""
        plan = self._pred_plan(pred)
        if plan is not None and _numeric(t, plan.columns):
            self._check_exact()
            return self._eval_pred_plan(plan, t, "pred_mask")
        return eval_pred(pred, t)

    def _proj_plan(self, cols) -> Optional[_ProjPlan]:
        key = repr(cols)
        plan = self._proj_plans.get(key)
        if plan is None:
            plan = self._compile_proj(cols) or _NO_PLAN
            self._proj_plans[key] = plan
        return None if plan is _NO_PLAN else plan

    def _compile_proj(self, cols) -> Optional[_ProjPlan]:
        columns: List[str] = []
        prods: List[Tuple[int, float]] = []
        terms: List[Tuple[float, int, int, int]] = []
        items: List[Tuple[str, str, object]] = []
        for name, expr in cols:
            if isinstance(expr, str):
                items.append((name, "col", expr))
                continue
            terms.append((float(expr.const), R.VALUE, len(prods), len(expr.coeffs)))
            for c, v in expr.coeffs:
                if c not in columns:
                    columns.append(c)
                prods.append((columns.index(c), float(v)))
            items.append((name, "lin", len(terms) - 1))
        if not prods:
            return None  # pure renames / constant exprs: the reference is exact
        program = R.RelProgram(len(columns), tuple(prods), tuple(terms))
        return _ProjPlan(tuple(columns), tuple(items), program)

    def _eval_proj_plan(self, plan: _ProjPlan, src: Table, what: str) -> Table:
        cols = [self._column(src.cols[c]) for c in plan.columns]
        vals = [self._to_host(v) for v in self._relational(what, plan.program, cols)]
        out_cols: Dict[str, np.ndarray] = {}
        order: List[str] = []
        for name, kind, payload in plan.items:
            out_cols[name] = src.cols[payload] if kind == "col" else vals[payload]
            order.append(name)
        return Table(out_cols, order)

    def _project(self, op: D.Operator, inputs: List[Table]) -> Table:
        self._check_exact()
        plan = self._proj_plan(op.get("cols"))
        return self._eval_proj_plan(plan, inputs[0], D.PROJECT)

    # -- reporting -------------------------------------------------------------
    def roofline_report(self, n: int = 1_000_000) -> List[Dict]:
        """Roofline terms of the plane's relational bodies at ``n`` rows: the
        filter and project programs of the relational kernel (its plain
        version, the same function) and the join probe, traced on meta
        tensors (no device allocation) with ``launch/roofline.py``'s H100
        constants.  Reported only: the plane lowers the same operators to
        the kernel whatever ``bandwidth_bound`` says (the reference gates
        its Pallas lowering on it; the port has no fallback to gate)."""
        from repro_torch.launch.roofline import kernel_roofline

        e1 = LinExpr.make({"a": Fraction(5, 2), "b": -1}, 1)
        e2 = LinExpr.make({"c": Fraction(1, 3)}, Fraction(-1, 2))
        pred = Pred.and_(Pred.of(LinCmp(e1, "<=")), Pred.of(LinCmp(e2, "<")))
        pplan = self._compile_pred(pred)
        jplan = self._compile_proj((("x", e1), ("y", e2)))

        def cols(k, dtype=torch.float64):
            return [torch.empty(n, dtype=dtype, device="meta") for _ in range(k)]

        kernels = [
            ("filter", lambda *c: R.relational_reference(pplan.program, c), cols(len(pplan.columns))),
            ("project", lambda *c: R.relational_reference(jplan.program, c), cols(len(jplan.columns))),
            ("join_probe", _join_probe_body, cols(2, torch.int64)),
        ]
        report: List[Dict] = []
        for name, fn, args in kernels:
            r = kernel_roofline(fn, *args)
            report.append({
                "kernel": name,
                "rows": n,
                "flops": r.flops,
                "hbm_bytes": r.hbm_bytes,
                "t_compute_s": r.t_compute,
                "t_memory_s": r.t_memory,
                "bottleneck": r.bottleneck,
                "bandwidth_bound": r.t_memory >= r.t_compute,
            })
        return report

    # -- JOIN: probe over unique-compressed keys --------------------------------
    def _probe(self, lk: np.ndarray, rk: np.ndarray):
        """Sorted probe on the device: a stable sort of the right codes and
        two searchsorteds.  On int64 codes this is the unique stable
        permutation, so it equals numpy's ``argsort(kind="stable")``."""
        self.device_probes += 1
        order, lo, hi = _join_probe_body(self._to_device(lk), self._to_device(rk))
        return self._to_host(order), self._to_host(lo), self._to_host(hi)

    def _join(self, op: D.Operator, inputs: List[Table]) -> Table:
        left, right = inputs
        on = op.get("on")
        how = op.get("how", "inner")
        ren = {c: f"r_{c}" for c in right.order if c in left.order}
        r = right.rename(ren)
        r_on = [ren.get(rc, rc) for _, rc in on]
        l_on = [lc for lc, _ in on]
        nl, nr = len(left), len(r)

        # joint factorization: left and right key columns share one code
        # space per key position (dict-key equality incl. rounded collapse;
        # NaN keys get fresh codes so they never match — like the reference)
        code_cols = []
        for lc, rc in zip(l_on, r_on):
            both = np.concatenate(
                [np.asarray(left.cols[lc]), np.asarray(r.cols[rc])]
            )
            code_cols.append(column_codes(both, nan_distinct=True))
        joint = combine_codes(code_cols)
        lk, rk = joint[:nl], joint[nl:]

        # probe: per-left-row windows [lo[i], hi[i]) into ``order`` — the
        # right indices stably sorted by key, so each window lists a key's
        # matches in ascending right index.  Dense codes (range comparable
        # to the table sizes) use a host bincount + exclusive-cumsum lookup
        # table; sparse codes use the device sort/searchsorted probe.
        max_code = int(joint.max()) if joint.size else 0
        if max_code <= max(1 << 22, 4 * (nl + nr)):
            order = np.argsort(rk, kind="stable")
            counts_all = np.bincount(rk, minlength=max_code + 1)
            ends_all = np.cumsum(counts_all)
            lo = (ends_all - counts_all)[lk]
            hi = ends_all[lk]
        else:
            order, lo, hi = self._probe(lk, rk)

        # expand the probe windows host-side, replicating the reference
        # output order exactly: left rows in order, each row's matches in
        # ascending right index, unmatched lefts appended after
        counts = hi - lo
        li = np.repeat(np.arange(nl, dtype=np.int64), counts)
        starts_rep = np.repeat(lo, counts)
        csum = np.cumsum(counts)
        offs = np.arange(int(counts.sum()), dtype=np.int64) - np.repeat(
            csum - counts, counts
        )
        ri = order[starts_rep + offs]
        if how == "left_outer":
            unmatched = np.flatnonzero(counts == 0)
        else:
            unmatched = np.array([], dtype=np.int64)

        lt = left.take(np.concatenate([li, unmatched]).astype(int))
        out_cols = {c: lt.cols[c] for c in left.order}
        n_un = len(unmatched)
        for c in r.order:
            matched_vals = r.cols[c][ri] if len(ri) else r.cols[c][:0]
            if n_un:
                if matched_vals.dtype == object:
                    pad = np.array([None] * n_un, dtype=object)
                else:
                    # same canonical padding rule as the reference plane:
                    # np.nan pad, int columns upcast to float64
                    pad = np.full(n_un, np.nan)
                matched_vals = np.concatenate([matched_vals, pad])
            out_cols[c] = matched_vals
        return Table(out_cols, left.order + r.order)

    # -- AGGREGATE: segment reduction over group codes --------------------------
    def _aggregate(self, op: D.Operator, inputs: List[Table]) -> Table:
        src = inputs[0]
        group_by = list(op.get("group_by", ()))
        aggs = op.get("aggs")
        n = len(src)

        cols: Dict[str, List] = {c: [] for c in group_by}
        for _, _, out in aggs:
            cols[out] = []

        if n:
            if group_by:
                codes = combine_codes(
                    [
                        column_codes(src.cols[c], nan_distinct=True)
                        for c in group_by
                    ]
                )
            else:
                codes = np.zeros(n, dtype=np.int64)
            order = np.argsort(codes, kind="stable")
            _, starts, ends = run_bounds(codes[order])
            # stable sort => each segment lists its group's rows in original
            # order, so order[starts] are the first-occurrence rows
            first_idx = order[starts]
            keys = [
                tuple(keyval(src.cols[c][int(fi)]) for c in group_by)
                for fi in first_idx
            ]
            # reference ordering: groups enumerated in first-occurrence
            # (dict-insertion) order, then stably sorted by repr(key) —
            # repr ties (NaN keys) keep insertion order
            occ = np.argsort(first_idx, kind="stable")
            gorder = sorted(occ.tolist(), key=lambda g: repr(keys[g]))
            for g in gorder:
                key = keys[g]
                rows = order[starts[g] : ends[g] + 1]
                for j, c in enumerate(group_by):
                    cols[c].append(key[j])
                for fn, c, out in aggs:
                    # contiguous float64 copy => identical pairwise
                    # summation to the reference's per-group reduction
                    vals = (
                        src.cols[c][rows].astype(np.float64)
                        if c != "*"
                        else None
                    )
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
                    else:  # pragma: no cover - guarded by lowers()
                        raise ValueError(f"agg fn {fn}")

        out_order = group_by + [out for _, _, out in aggs]
        return Table({c: _col(cols[c]) for c in out_order}, out_order)

    def _distinct(self, op: D.Operator, inputs: List[Table]) -> Table:
        src = inputs[0]
        n = len(src)
        if n == 0:
            return src.take(np.array([], dtype=int))
        codes = combine_codes(
            [column_codes(src.cols[c], nan_distinct=False) for c in src.order]
        )
        _, first = np.unique(codes, return_index=True)
        return src.take(np.sort(first))

    def _sort(self, op: D.Operator, inputs: List[Table]) -> Table:
        src = inputs[0]
        keys = list(op.get("keys"))
        # all-ascending numeric: one lexsort == the iterated stable argsort
        # (the stable lexicographic permutation is unique); primary key last
        idx = np.lexsort(tuple(src.cols[c] for c, _ in reversed(keys)))
        return src.take(idx)

    def _unnest(self, op: D.Operator, inputs: List[Table]) -> Table:
        src = inputs[0]
        col, out = op.get("col"), op.get("out")
        vals = src.cols[col]
        base = src.take(np.arange(len(src)))
        return base.with_col(
            out, vals.astype(np.float64) if len(vals) else np.array([])
        )

    def _dict_matcher(self, op: D.Operator, inputs: List[Table]) -> Table:
        src = inputs[0]
        col, out = op.get("col"), op.get("out")
        entries = set(op.get("entries"))
        arr = src.cols[col]
        if len(arr) == 0:
            return src.with_col(out, np.array([]))
        uniq, inv = np.unique(arr, return_inverse=True)
        hit = np.array([1.0 if v in entries else 0.0 for v in uniq])
        return src.with_col(out, hit[inv.reshape(-1)])

    def _classifier(self, op: D.Operator, inputs: List[Table]) -> Table:
        src = inputs[0]
        col, out = op.get("col"), op.get("out")
        model = op.get("model", "default")
        k = int(op.get("classes", 3))
        salt = f"{op.op_type}:{model}"
        arr = src.cols[col]
        if len(arr) == 0:
            h = np.empty(0, dtype=np.int64)
        else:
            uniq, inv = np.unique(arr, return_inverse=True)
            hu = np.empty(len(uniq), dtype=np.int64)
            for i, v in enumerate(uniq):
                hu[i] = zlib.crc32((salt + ":" + repr(v)).encode()) & 0x7FFFFFFF
            h = hu[inv.reshape(-1)]
        return src.with_col(out, (h % k).astype(np.float64))


def _join_probe_body(lk: torch.Tensor, rk: torch.Tensor):
    """The join probe: a stable sort of the right codes, then the left codes'
    first and last match by two searchsorteds."""
    sr, order = torch.sort(rk, stable=True)
    return order, torch.searchsorted(sr, lk), torch.searchsorted(sr, lk, right=True)


def _numeric(t: Table, cols: Sequence[str]) -> bool:
    return all(c in t.cols and t.cols[c].dtype != object for c in cols)


def _mixed_zero_signs(col: np.ndarray) -> bool:
    """True when a float column holds both -0.0 and +0.0 (their reprs
    differ but ``np.unique`` collapses them — the classifier hash must take
    the per-row reference)."""
    if col.dtype.kind != "f":
        return False
    zeros = col == 0.0
    if not zeros.any():
        return False
    sb = np.signbit(col[zeros])
    return bool(sb.any() and not sb.all())
