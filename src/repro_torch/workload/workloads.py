"""Workloads W1-W8 (paper Table 4) + edit generators.

The port's own copy of what the session generator needs from the
repository's ``benchmarks/workloads.py``: the eight shapes, ``WORKLOADS``,
``random_tables`` and the three edit generators, built on
``repro_torch.core.dag``.  A shape or an edit built here is operator for
operator the one built there (the same ``dag_to_dict``), and
``random_tables`` draws the same values from the same seed.

Shapes mirror the paper's table: op counts, join/aggregate/union/replicate
mix, and the semantically-rich operators (UDF, Classifier, Sort, Unnest)
that break the published EVs.  Edits come in the paper's two families:

  * Calcite-style equivalence-preserving rewrites (empty project, push
    project past filter, push filter past join/aggregate, filter reorder,
    filter split) — used for the "equivalent pair" experiments;
  * TPC-DS-iterative-style semantic edits (new filter condition, changed
    constant, changed aggregate function) — the "inequivalent pairs".
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import dag as D
from repro_torch.core.dag import DataflowDAG, Link, Operator
from repro_torch.core.predicates import LinCmp, LinExpr, Pred
from repro_torch.engine.table import Table

op = Operator.make


class _B:
    """Incremental DAG builder."""

    def __init__(self):
        self.ops: List[Operator] = []
        self.links: List[Link] = []
        self.n = 0

    def add(self, o: Operator, *ins: Tuple[str, int]) -> str:
        self.ops.append(o)
        for port, (src) in enumerate(ins):
            self.links.append(Link(src, o.id, port))
        return o.id

    def src(self, name, schema):
        return self.add(op(name, D.SOURCE, schema=tuple(schema)))

    def filt(self, name, prev, col, cmp_, val):
        return self.add(op(name, D.FILTER, pred=Pred.cmp(col, cmp_, val)), prev)

    def join(self, name, l, r, on, how="inner"):
        return self.add(op(name, D.JOIN, on=tuple(on), how=how), l, r)

    def agg(self, name, prev, group_by, aggs):
        return self.add(
            op(name, D.AGGREGATE, group_by=tuple(group_by), aggs=tuple(aggs)), prev
        )

    def proj(self, name, prev, cols):
        return self.add(op(name, D.PROJECT, cols=tuple(cols)), prev)

    def sort(self, name, prev, keys):
        return self.add(op(name, D.SORT, keys=tuple(keys)), prev)

    def sink(self, name, prev, semantics=D.BAG):
        return self.add(op(name, D.SINK, semantics=semantics), prev)

    def build(self) -> DataflowDAG:
        d = DataflowDAG(self.ops, self.links)
        d.validate()
        return d


def _id_proj(schema):
    return tuple((c, c) for c in schema)


def w1() -> DataflowDAG:
    """TPC-DS Q40-ish: 4 joins, 1 aggregate, 17 ops."""
    b = _B()
    cs = b.src("catalog_sales", ["item_sk", "warehouse_sk", "date_sk", "price", "qty"])
    cr = b.src("catalog_returns", ["r_item_sk", "r_qty"])
    w = b.src("warehouse", ["w_sk", "w_state"])
    i = b.src("item", ["i_sk", "i_price"])
    dd = b.src("date_dim", ["d_sk", "d_year"])
    j1 = b.join("j_ret", cs, cr, [("item_sk", "r_item_sk")], how="left_outer")
    f1 = b.filt("f_price", j1, "price", ">", 2)
    j2 = b.join("j_wh", f1, w, [("warehouse_sk", "w_sk")])
    j3 = b.join("j_item", j2, i, [("item_sk", "i_sk")])
    f2 = b.filt("f_iprice", j3, "i_price", "<", 6)
    j4 = b.join("j_date", f2, dd, [("date_sk", "d_sk")])
    f3 = b.filt("f_year", j4, "d_year", ">=", 1)
    a = b.agg("agg_sales", f3, ["w_state"], [("sum", "qty", "total_qty")])
    p = b.proj("p_out", a, (("w_state", "w_state"), ("total_qty", "total_qty")))
    srt = b.sort("sort_out", p, [("w_state", True)])
    b.sink("sink", srt)
    return b.build()


def w2() -> DataflowDAG:
    """TPC-DS Q18-ish: 5 joins, 1 aggregate, 20 ops."""
    b = _B()
    cs = b.src("cs", ["bill_cust_sk", "item_sk", "cdemo_sk", "qty", "price"])
    cd = b.src("cd", ["cd_sk", "cd_dep"])
    c = b.src("cust", ["c_sk", "c_cdemo", "c_addr"])
    ca = b.src("addr", ["ca_sk", "ca_state"])
    i = b.src("item", ["i_sk", "i_id"])
    d2 = b.src("dd", ["d_sk", "d_year"])
    f0 = b.filt("f_dep", cd, "cd_dep", ">", 0)
    j1 = b.join("j1", cs, f0, [("cdemo_sk", "cd_sk")])
    j2 = b.join("j2", j1, c, [("bill_cust_sk", "c_sk")])
    j3 = b.join("j3", j2, ca, [("c_addr", "ca_sk")])
    f1 = b.filt("f_state", j3, "ca_state", "<", 3)
    j4 = b.join("j4", f1, i, [("item_sk", "i_sk")])
    j5 = b.join("j5", j4, d2, [("i_id", "d_sk")])
    f2 = b.filt("f_year2", j5, "d_year", ">=", 1)
    a = b.agg("agg", f2, ["ca_state"], [("avg", "qty", "avg_qty")])
    p = b.proj("proj", a, (("ca_state", "ca_state"), ("avg_qty", "avg_qty")))
    b.sink("sink", p)
    return b.build()


def w3() -> DataflowDAG:
    """TPC-DS Q71-ish: replicate + union + 5 joins + 1 aggregate, 23 ops."""
    b = _B()
    ws = b.src("web_sales", ["item_sk", "sold_sk", "price", "hour"])
    cs = b.src("cat_sales", ["c_item_sk", "c_sold_sk", "c_price", "c_hour"])
    i = b.src("item", ["i_sk", "i_brand"])
    dd = b.src("dd", ["d_sk", "d_moy"])
    t = b.src("time_dim", ["t_sk", "t_hour"])
    # two sales channels unioned (schemas aligned by projection)
    pw = b.proj("p_ws", ws, _id_proj(["item_sk", "sold_sk", "price", "hour"]))
    pc = b.proj(
        "p_cs", cs,
        (("item_sk", "c_item_sk"), ("sold_sk", "c_sold_sk"), ("price", "c_price"), ("hour", "c_hour")),
    )
    u = b.add(op("union_ch", D.UNION), pw, pc)
    f1 = b.filt("f_price", u, "price", ">", 1)
    j1 = b.join("j_item", f1, i, [("item_sk", "i_sk")])
    f2 = b.filt("f_brand", j1, "i_brand", "<", 5)
    j2 = b.join("j_date", f2, dd, [("sold_sk", "d_sk")])
    f3 = b.filt("f_moy", j2, "d_moy", "==", 2)
    j3 = b.join("j_time", f3, t, [("hour", "t_sk")])
    rep = b.add(op("rep", D.REPLICATE), j3)
    a1 = b.agg("agg_brand", rep, ["i_brand"], [("sum", "price", "amt")])
    srt = b.sort("sort_amt", a1, [("amt", False)])
    b.sink("sink", srt)
    # second consumer of replicate feeds a secondary sink
    a2 = b.agg("agg_hour", rep, ["t_hour"], [("count", "*", "n")])
    b.sink("sink2", a2)
    return b.build()


def w4() -> DataflowDAG:
    """TPC-DS Q33-ish: 3 replicates, 1 union, 9 joins, 4 aggregates, 28 ops."""
    b = _B()
    i = b.src("item", ["i_sk", "i_manu", "i_cat"])
    dd = b.src("dd", ["d_sk", "d_year"])
    ca = b.src("addr", ["a_sk", "a_gmt"])
    chans = []
    for name in ("ss", "cs2", "ws2"):
        s = b.src(name, [f"{name}_item", f"{name}_date", f"{name}_addr", f"{name}_price"])
        ri = b.add(op(f"rep_{name}", D.REPLICATE), s)
        j1 = b.join(f"j_{name}_i", ri, i, [(f"{name}_item", "i_sk")])
        j2 = b.join(f"j_{name}_d", j1, dd, [(f"{name}_date", "d_sk")])
        j3 = b.join(f"j_{name}_a", j2, ca, [(f"{name}_addr", "a_sk")])
        a = b.agg(f"agg_{name}", j3, ["i_manu"], [("sum", f"{name}_price", "amt")])
        chans.append(a)
    u1 = b.add(op("u1", D.UNION), chans[0], chans[1])
    u2 = b.add(op("u2", D.UNION), u1, chans[2])
    a4 = b.agg("agg_all", u2, ["i_manu"], [("sum", "amt", "total")])
    srt = b.sort("sort_total", a4, [("total", False)])
    b.sink("sink", srt)
    return b.build()


def w5() -> DataflowDAG:
    """IMDB ratio non-original/original: replicate, 2 joins, 2 aggs, 12 ops."""
    b = _B()
    t = b.src("titles", ["t_id", "is_original", "year"])
    r = b.add(op("rep_t", D.REPLICATE), t)
    f1 = b.filt("f_orig", r, "is_original", "==", 1)
    f2 = b.filt("f_nonorig", r, "is_original", "==", 0)
    a1 = b.agg("agg_o", f1, ["year"], [("count", "*", "n_orig")])
    a2 = b.agg("agg_n", f2, ["year"], [("count", "*", "n_non")])
    j = b.join("j_years", a1, a2, [("year", "year")])
    # NOTE: engine renames collided right columns with r_ prefix after join
    p = b.proj("p_ratio", j, (("year", "year"), ("n_orig", "n_orig"), ("n_non", "n_non")))
    b.sink("sink", p)
    return b.build()


def w6() -> DataflowDAG:
    """IMDB directors with criteria: 2 replicates, 4 joins, 2 unnests, 18 ops."""
    b = _B()
    m = b.src("movies", ["m_id", "m_year", "genres"])
    d2 = b.src("directors", ["dir_id", "dir_movies", "dir_rating"])
    un1 = b.add(op("unnest_g", D.UNNEST, col="genres", out="genre"), m)
    rep1 = b.add(op("rep_m", D.REPLICATE), un1)
    un2 = b.add(op("unnest_dm", D.UNNEST, col="dir_movies", out="dm"), d2)
    rep2 = b.add(op("rep_d", D.REPLICATE), un2)
    f1 = b.filt("f_rating", rep2, "dir_rating", ">", 3)
    j1 = b.join("j_md", rep1, f1, [("m_id", "dm")])
    f2 = b.filt("f_year", j1, "m_year", ">=", 2)
    j2 = b.join("j_md2", rep1, rep2, [("m_id", "dm")])
    j3 = b.join("j_all", f2, d2, [("dir_id", "dir_id")])
    p1 = b.proj("p_d", j3, (("dir_id", "dir_id"), ("m_year", "m_year"), ("genre", "genre")))
    j4 = b.join("j_cnt", p1, j2, [("dir_id", "dir_id")])
    p2 = b.proj("p_out", j4, (("dir_id", "dir_id"), ("genre", "genre")))
    b.sink("sink", p2)
    return b.build()


def w7() -> DataflowDAG:
    """Tobacco Twitter: outer join, aggregate, classifier, 14 ops."""
    b = _B()
    tw = b.src("tweets", ["tweet_id", "user_id", "score", "hour"])
    us = b.src("users", ["u_id", "followers", "is_brand"])
    f1 = b.filt("f_score", tw, "score", ">", 1)
    cl = b.add(op("classify", D.CLASSIFIER, col="score", out="topic", model="tobacco", classes=3), f1)
    f2 = b.filt("f_topic", cl, "topic", "==", 1)
    j = b.join("j_users", f2, us, [("user_id", "u_id")], how="left_outer")
    f3 = b.filt("f_brand", j, "is_brand", "==", 0)
    a = b.agg("agg_u", f3, ["user_id"], [("count", "*", "n_tweets")])
    f4 = b.filt("f_rate", a, "n_tweets", ">", 1)
    p = b.proj("p_out", f4, (("user_id", "user_id"), ("n_tweets", "n_tweets")))
    srt = b.sort("sort_rate", p, [("n_tweets", False)])
    b.sink("sink", srt)
    return b.build()


def w8() -> DataflowDAG:
    """Wildfire Twitter: 1 join, 1 UDF, 13 ops."""
    b = _B()
    tw = b.src("tweets", ["tweet_id", "geo", "score", "len"])
    rg = b.src("regions", ["g_id", "g_risk"])
    f1 = b.filt("f_len", tw, "len", ">", 0)
    u = b.add(op("udf_feat", D.UDF, fn="add_rowsum",
                 out_schema=("tweet_id", "geo", "score", "len", "rowsum")), f1)
    f2 = b.filt("f_feat", u, "rowsum", ">", 3)
    j = b.join("j_geo", f2, rg, [("geo", "g_id")])
    f3 = b.filt("f_risk", j, "g_risk", ">=", 2)
    p = b.proj("p_out", f3, (("tweet_id", "tweet_id"), ("g_risk", "g_risk")))
    a = b.agg("agg_r", p, ["g_risk"], [("count", "*", "n")])
    srt = b.sort("s_out", a, [("n", False)])
    b.sink("sink", srt)
    return b.build()


WORKLOADS = {"W1": w1, "W2": w2, "W3": w3, "W4": w4, "W5": w5, "W6": w6, "W7": w7, "W8": w8}


def random_tables(dag: DataflowDAG, seed: int = 0, n: int = 30) -> Dict[str, Table]:
    """Random bindings for every source (small integer domain; list columns
    for unnest get short integer lists)."""
    rng = np.random.default_rng(seed)
    out = {}
    for sid in dag.sources:
        schema = dag.ops[sid].get("schema")
        cols = {}
        for c in schema:
            if c in ("genres", "dir_movies"):
                cols[c] = np.array(
                    [list(map(float, rng.integers(0, 6, rng.integers(1, 4)))) for _ in range(n)],
                    dtype=object,
                )
            else:
                cols[c] = rng.integers(0, 7, n).astype(np.float64)
        out[sid] = Table(cols, list(schema))
    return out


# ---------------------------------------------------------------------------
# Edit generators
# ---------------------------------------------------------------------------


def _one_to_one_edges(dag: DataflowDAG) -> List[Link]:
    """Edges where an operator can be spliced in (dst port 0 chains)."""
    return [l for l in dag.links if l.dst_port == 0]


def _splice(dag: DataflowDAG, l: Link, new_op: Operator) -> DataflowDAG:
    q = dag.add_op(new_op).remove_link(l)
    return q.add_link(Link(l.src, new_op.id)).add_link(Link(new_op.id, l.dst, l.dst_port))


def _schema_at(dag: DataflowDAG, op_id: str) -> List[str]:
    from repro_torch.core.dag import infer_schema

    return infer_schema(dag, {})[op_id]


def apply_equivalent_edits(
    dag: DataflowDAG,
    n: int,
    seed: int = 0,
    kinds: Optional[List[str]] = None,
    rng: Optional[random.Random] = None,
    prefix: str = "",
) -> DataflowDAG:
    """Apply n Calcite-style rewrites at random valid placements.

    Determinism contract: all randomness comes from one explicit
    ``random.Random`` — either the ``rng`` the caller threads through (the
    workload generator's per-session stream) or a fresh ``Random(seed)``.
    No module-level ``random``/``np.random`` state is ever touched, so the
    same ``(dag, n, seed/rng-state, kinds)`` always yields a byte-identical
    result (regression-tested in ``tests/test_torch_workload.py``).
    ``prefix`` namespaces the ids of inserted operators so repeated
    applications along one edit session never collide.
    """
    if rng is None:
        rng = random.Random(seed)
    q = dag
    kinds = kinds or ["empty_project", "empty_filter", "swap_filters", "split_filter", "scale_pred"]
    applied = 0
    guard = 0
    while applied < n and guard < 200:
        guard += 1
        kind = rng.choice(kinds)
        if kind in ("empty_project", "empty_filter"):
            l = rng.choice(_one_to_one_edges(q))
            if kind == "empty_project":
                sch = _schema_at(q, l.src)
                new = op(f"{prefix}ep{applied}_{guard}", D.PROJECT, cols=_id_proj(sch))
            else:
                new = op(f"{prefix}ef{applied}_{guard}", D.FILTER, pred=Pred.true())
            q = _splice(q, l, new)
            applied += 1
        elif kind == "swap_filters":
            fs = [o for o in q.ops.values() if o.op_type == D.FILTER]
            rng.shuffle(fs)
            done = False
            for f_op in fs:
                ups = q.upstream(f_op.id)
                if ups and q.ops[ups[0]].op_type == D.FILTER and len(q.out_links[ups[0]]) == 1:
                    lo, hi = ups[0], f_op.id
                    below_l = q.in_links[lo][0]
                    above_l = q.out_links[hi][0]
                    # swap only when both predicates valid below (columns exist)
                    sch_below = _schema_at(q, below_l.src)
                    if not set(q.ops[hi].get("pred").columns) <= set(sch_below):
                        continue
                    q2 = q.remove_link(below_l).remove_link(Link(lo, hi)).remove_link(above_l)
                    q2 = q2.add_link(Link(below_l.src, hi, below_l.dst_port))
                    q2 = q2.add_link(Link(hi, lo))
                    q2 = q2.add_link(Link(lo, above_l.dst, above_l.dst_port))
                    q = q2
                    applied += 1
                    done = True
                    break
            if not done:
                continue
        elif kind == "split_filter":
            fs = [
                o for o in q.ops.values()
                if o.op_type == D.FILTER and o.get("pred").kind == "and"
            ]
            if not fs:
                continue
            f_op = rng.choice(fs)
            p = f_op.get("pred")
            below = q.in_links[f_op.id][0]
            q = q.replace_op(f_op.with_props(pred=Pred.and_(*p.children[1:])))
            new = op(f"{prefix}fs{applied}_{guard}", D.FILTER, pred=p.children[0])
            q = _splice(q, Link(below.src, f_op.id, below.dst_port), new)
            applied += 1
        elif kind == "scale_pred":
            fs = [
                o for o in q.ops.values()
                if o.op_type == D.FILTER and o.get("pred").kind == "atom"
                and isinstance(o.get("pred").atom, LinCmp)
            ]
            if not fs:
                continue
            f_op = rng.choice(fs)
            a = f_op.get("pred").atom
            q = q.replace_op(f_op.with_props(pred=Pred.of(LinCmp(a.expr.scale(3), a.op))))
            applied += 1
    return q


def apply_inequivalent_edits(
    dag: DataflowDAG,
    n: int,
    seed: int = 0,
    kinds: Optional[List[str]] = None,
    rng: Optional[random.Random] = None,
    prefix: str = "",
) -> DataflowDAG:
    """TPC-DS-iterative-style semantic edits.  ``drop_proj_col`` mimics the
    real-workload edits (paper W5-W8) that §7.4's symbolic check catches.

    Same determinism contract as ``apply_equivalent_edits``: one explicit
    ``random.Random`` (threaded ``rng`` or fresh ``Random(seed + 1)``), no
    module-level random state, ``prefix``-namespaced inserted-operator ids.
    """
    if rng is None:
        rng = random.Random(seed + 1)
    q = dag
    applied = 0
    guard = 0
    kinds = kinds or ["bump_const", "new_filter"]
    while applied < n and guard < 100:
        guard += 1
        kind = rng.choice(kinds)
        if kind == "drop_proj_col":
            ps = [
                o for o in q.ops.values()
                if o.op_type == D.PROJECT and len(o.get("cols")) > 1
            ]
            if not ps:
                kind = "bump_const"
            else:
                p_op = rng.choice(ps)
                cols = list(p_op.get("cols"))
                # only drop when no downstream op references the column
                dropped = cols.pop()
                try:
                    q2 = q.replace_op(p_op.with_props(cols=tuple(cols)))
                    from repro_torch.core.dag import infer_schema

                    infer_schema(q2, {})
                    q2.validate()
                    q = q2
                    applied += 1
                    continue
                except Exception:
                    continue
        if kind == "bump_const":
            fs = [
                o for o in q.ops.values()
                if o.op_type == D.FILTER and o.get("pred").kind == "atom"
                and isinstance(o.get("pred").atom, LinCmp)
            ]
            if not fs:
                continue
            f_op = rng.choice(fs)
            a = f_op.get("pred").atom
            q = q.replace_op(
                f_op.with_props(pred=Pred.of(LinCmp(a.expr + LinExpr.lit(1), a.op)))
            )
            applied += 1
        else:
            l = rng.choice(_one_to_one_edges(q))
            sch = _schema_at(q, l.src)
            col = rng.choice(list(sch))
            new = op(f"{prefix}nf{applied}_{guard}", D.FILTER, pred=Pred.cmp(col, "<", rng.randint(2, 5)))
            q = _splice(q, l, new)
            applied += 1
    return q


def edits_with_distance(
    dag: DataflowDAG, hops: int, seed: int = 0, prefix: str = "fe"
) -> DataflowDAG:
    """Two empty-filter edits separated by `hops` one-to-one operators
    (paper Fig 26). Requires a chain of ≥ hops+1 consecutive 1-1 ops.
    ``prefix`` namespaces the two inserted filter ids (``<prefix>_a/_b``)."""
    # find a chain of one-input/one-output ops
    chain_edges = _one_to_one_edges(dag)
    # walk chains
    for l in chain_edges:
        path = [l]
        cur = l.dst
        while len(path) <= hops:
            outs = dag.out_links.get(cur, [])
            if len(outs) != 1 or dag.ops[cur].arity() != 1:
                break
            path.append(outs[0])
            cur = outs[0].dst
        if len(path) > hops:
            q = _splice(dag, path[0], op(f"{prefix}_a", D.FILTER, pred=Pred.true()))
            if hops == 0:
                # adjacent edits: the second splice goes on the NEW edge
                tail = Link(f"{prefix}_a", path[0].dst, path[0].dst_port)
            else:
                tail = path[hops]
            q = _splice(q, tail, op(f"{prefix}_b", D.FILTER, pred=Pred.true()))
            return q
    raise ValueError(f"no chain with {hops} hops in workflow")
