"""The port's delta-cone execution against the reference package's, on the CPU.

Each scenario of ``tests/test_delta_exec.py`` is built by the reference
package, carried across with ``dag_to_dict`` and
``repro_torch.carry.from_reference``, and run twice on the same seeded
tables: by the reference at ``plane="numpy"`` and by the port at
``plane="torch", device="cpu"`` (the relational kernel's plain version
computes the masks there).  The port must return sinks byte-identical to the
reference's, the same ``DeltaPlan``, and the same counters (``ops_delta``,
``delta_rows_processed``, ``ops_reused``, ``ops_executed``, ...); the
analysis must give the same classes and census labels.  The jax-plane case
of the reference file has no counterpart (the port has no jax plane), and
its hypothesis draws are seeded cases here.
"""

from __future__ import annotations

import numpy as np
import pytest

from repro.api import VeerConfig as RefVeerConfig
from repro.api.serialize import dag_to_dict, operator_to_dict
from repro.core import dag as D
from repro.core.dag import DataflowDAG, Link, Operator
from repro.core.delta import analyze_delta as ref_analyze_delta
from repro.core.delta import classify_edit as ref_classify_edit
from repro.core.delta import delta_census as ref_delta_census
from repro.core.edits import EditMapping as RefEditMapping
from repro.core.predicates import LinExpr, Pred
from repro.engine import InMemoryMaterializationStore as RefMemStore
from repro.engine import Table as RTable
from repro.engine import execute as ref_execute
from repro.engine import table_digest as ref_table_digest
from repro.engine import tables_identical as ref_identical
from repro.engine.delta import DeltaUnsupported as RefDeltaUnsupported
from repro.engine.delta import execute_delta as ref_execute_delta
from repro.engine.executor import ExecutionPlan as RefPlan
from repro.service import VersionChainSession as RefSession
from repro.workload import SessionGenerator, WorkloadConfig

from repro_torch.api import VeerConfig
from repro_torch.api.config import ConfigError
from repro_torch.carry import from_reference
from repro_torch.core.delta import (
    AGG_SWAP,
    FILTER_GENERAL,
    NARROW,
    PROJECT_COLS,
    WIDEN,
    analyze_delta,
    classify_edit,
    delta_census,
)
from repro_torch.core.edits import EditMapping
from repro_torch.api.serialize import operator_from_dict
from repro_torch.engine import InMemoryMaterializationStore, Table, execute, table_digest
from repro_torch.engine.delta import DeltaUnsupported, execute_delta
from repro_torch.engine.executor import ExecutionPlan
from repro_torch.engine.store import table_nbytes
from repro_torch.kernels import relational as R
from repro_torch.service import VersionChainSession

ALL_SEMANTICS = [D.SET, D.BAG, D.ORDERED]
TORCH = dict(plane="torch", device="cpu")
COUNTERS = ("ops_total", "ops_executed", "ops_reused", "ops_skipped", "ops_delta",
            "delta_rows_processed", "tables_served", "store_writes", "store_dedup_skipped")


# ---------------------------------------------------------------------------
# the DAGs of tests/test_delta_exec.py, built in the reference package
# ---------------------------------------------------------------------------
def src_table(n=3000, seed=7):
    rng = np.random.default_rng(seed)
    return RTable(
        {
            "a": rng.integers(0, 10, n).astype(np.float64),
            "b": rng.uniform(0, 100, n),
            "c": rng.integers(-5, 5, n).astype(np.float64),
        },
        ["a", "b", "c"],
    )


def seq(op):
    return op, (lambda prev: [Link(prev, op.id)])


def build(pred_b, *, extra=(), sem=D.BAG):
    """src → fe(pred_b) → fa(a>2) → ``extra`` ops → sink."""
    ops = [
        Operator.make("src", D.SOURCE, schema=("a", "b", "c")),
        Operator.make("fe", D.FILTER, pred=pred_b),
        Operator.make("fa", D.FILTER, pred=Pred.cmp("a", ">", 2)),
    ]
    links = [Link("src", "fe"), Link("fe", "fa")]
    prev = "fa"
    for op, mk in extra:
        ops.append(op)
        links.extend(mk(prev))
        prev = op.id
    ops.append(Operator.make("sink", D.SINK, semantics=sem))
    links.append(Link(prev, "sink"))
    dag = DataflowDAG(ops, links)
    dag.validate()
    return dag


def heavy_tail():
    return [
        seq(Operator.make("fb", D.FILTER, pred=Pred.cmp("b", "<", 50))),
        seq(Operator.make("cl", D.CLASSIFIER, col="a", out="label", model="m", classes=5)),
        seq(Operator.make("agg", D.AGGREGATE, group_by=("label",),
                          aggs=(("sum", "a", "sa"), ("count", "*", "n")))),
    ]


P95 = Pred.cmp("b", "<", 95)
P85 = Pred.cmp("b", "<", 85)


def build_join(pred_b):
    ops = [
        Operator.make("src", D.SOURCE, schema=("a", "b", "c")),
        Operator.make("dim", D.SOURCE, schema=("k", "w")),
        Operator.make("fe", D.FILTER, pred=pred_b),
        Operator.make("j", D.JOIN, on=(("a", "k"),), how="inner"),
        Operator.make("sink", D.SINK, semantics=D.BAG),
    ]
    links = [Link("src", "fe"), Link("fe", "j", 0), Link("dim", "j", 1), Link("j", "sink")]
    dag = DataflowDAG(ops, links)
    dag.validate()
    return dag


def dim_table():
    rng = np.random.default_rng(3)
    return RTable({"k": np.arange(12).astype(np.float64), "w": rng.uniform(0, 1, 12)}, ["k", "w"])


def _random_amenable_edit(rng):
    """tests/test_delta_exec.py's draw: (P, Q) over the heavy spine."""
    kind = rng.choice(["narrow", "widen", "general", "project", "agg"])
    sem = ALL_SEMANTICS[int(rng.integers(0, 3))]
    lo, hi = sorted(rng.uniform(20, 95, 2))
    if kind in ("narrow", "widen", "general"):
        tail = heavy_tail()
        if kind == "narrow":
            P = build(Pred.cmp("b", "<", float(hi)), extra=tail, sem=sem)
            Q = build(Pred.cmp("b", "<", float(lo)), extra=tail, sem=sem)
        elif kind == "widen":
            P = build(Pred.cmp("b", "<", float(lo)), extra=tail, sem=sem)
            Q = build(Pred.cmp("b", "<", float(hi)), extra=tail, sem=sem)
        else:
            P = build(Pred.cmp("b", "<", float(hi)), extra=tail, sem=sem)
            Q = build(Pred.cmp("c", ">=", float(rng.integers(-3, 3))), extra=tail, sem=sem)
    elif kind == "project":
        mk = lambda cols: [  # noqa: E731
            seq(Operator.make("pr", D.PROJECT, cols=cols)),
            seq(Operator.make("f2", D.FILTER, pred=Pred.cmp("a", "<", float(hi) / 10))),
        ]
        P = build(P95, extra=mk((("a", "a"), ("b", "b"))), sem=sem)
        Q = build(P95, extra=mk((
            ("a", "a"), ("b", "b"),
            ("d", LinExpr((("a", float(rng.integers(1, 4))),), float(rng.integers(0, 5)))),
        )), sem=sem)
    else:
        cl = Operator.make("cl", D.CLASSIFIER, col="a", out="label", model="m", classes=5)
        mk = lambda aggs: [seq(cl), seq(Operator.make(  # noqa: E731
            "agg", D.AGGREGATE, group_by=("label",), aggs=aggs))]
        P = build(P95, extra=mk((("sum", "a", "sa"),)), sem=sem)
        Q = build(P95, extra=mk((("sum", "a", "sa"), ("min", "b", "mb"), ("count", "*", "n"))),
                  sem=sem)
    return P, Q


def _project_pair():
    tail = [
        seq(Operator.make("f2", D.FILTER, pred=Pred.cmp("a", "<", 8))),
        seq(Operator.make("ag2", D.AGGREGATE, group_by=("a",), aggs=(("sum", "b", "sb"),))),
    ]
    pr_p = Operator.make("pr", D.PROJECT, cols=(
        ("a", "a"), ("b", "b"), ("d", LinExpr((("a", 2.0), ("c", 1.0)), 1.0)),
    ))
    pr_q = Operator.make("pr", D.PROJECT, cols=(
        ("a", "a"), ("b", "b"), ("d", LinExpr((("a", 2.0),), 5.0)), ("e", "c"),
    ))
    return build(P95, extra=[seq(pr_p)] + tail), build(P95, extra=[seq(pr_q)] + tail)


def _agg_swap_pair():
    cl = Operator.make("cl", D.CLASSIFIER, col="a", out="label", model="m", classes=5)
    ag_p = Operator.make("agg", D.AGGREGATE, group_by=("label",),
                         aggs=(("sum", "a", "sa"), ("count", "*", "n")))
    ag_q = Operator.make("agg", D.AGGREGATE, group_by=("label",),
                         aggs=(("sum", "a", "sa"), ("avg", "b", "ab"), ("count", "*", "n")))
    return build(P95, extra=[seq(cl), seq(ag_p)]), build(P95, extra=[seq(cl), seq(ag_q)])


def _distinct_tail():
    return [
        seq(Operator.make("rp", D.PROJECT, cols=(("a", "a"), ("c", "c")))),
        seq(Operator.make("dd", D.DISTINCT)),
    ]


def _sort_tail():
    return [seq(Operator.make("so", D.SORT, keys=(("a", True),)))]


def _scenario(name):
    """(P, Q, sources) of one named scenario of tests/test_delta_exec.py."""
    kind, _, arg = name.partition(":")
    src = {"src": src_table()}
    if kind in ("narrow", "widen", "general"):
        sem = arg
        q_pred = {"narrow": P85, "widen": P95, "general": Pred.cmp("c", ">=", 0)}[kind]
        p_pred = P85 if kind == "widen" else P95
        return (build(p_pred, extra=heavy_tail(), sem=sem),
                build(q_pred, extra=heavy_tail(), sem=sem), src)
    if kind == "project":
        return (*_project_pair(), src)
    if kind == "agg_swap":
        return (*_agg_swap_pair(), src)
    if kind == "distinct":
        P, Q = build(P95, extra=_distinct_tail()), build(P85, extra=_distinct_tail())
        return (P, Q, src) if arg == "narrow" else (Q, P, src)
    if kind == "sort":
        return build(P95, extra=_sort_tail()), build(P85, extra=_sort_tail()), src
    if kind == "join":
        P, Q = build_join(P95), build_join(P85)
        if arg == "widen":
            P, Q = Q, P
        return P, Q, {"src": src_table(), "dim": dim_table()}
    if kind == "seeded":
        rng = np.random.default_rng(int(arg))
        t = src_table(n=int(rng.integers(500, 2500)), seed=int(arg) + 50)
        return (*_random_amenable_edit(rng), {"src": t})
    if kind == "draw":  # the reference's hypothesis property, as seeded cases
        rng = np.random.default_rng(int(arg))
        t = src_table(n=int(rng.integers(200, 2000)), seed=int(arg) + 1)
        return (*_random_amenable_edit(rng), {"src": t})
    raise KeyError(name)


SCENARIOS = (
    [f"{k}:{s}" for k in ("narrow", "widen", "general") for s in ALL_SEMANTICS]
    + ["project", "agg_swap", "distinct:narrow", "distinct:widen", "sort",
       "join:narrow", "join:widen"]
    + [f"seeded:{s}" for s in range(6)]
    + [f"draw:{s}" for s in (101, 202, 303, 404)]
)


# ---------------------------------------------------------------------------
# carrying across, and comparing
# ---------------------------------------------------------------------------
def carry_dag(dag):
    return from_reference(dag_to_dict(dag), {})[0]


def carry_sources(sources):
    return {sid: Table(dict(t.cols), list(t.order)) for sid, t in sources.items()}


def carry_op(op):
    return operator_from_dict(operator_to_dict(op))


def carry_mapping(mapping):
    return None if mapping is None else EditMapping.make(dict(mapping.p_to_q))


def assert_same_bytes(ref_table, port_table, what):
    assert ref_identical(ref_table, RTable(port_table.cols, port_table.order)), what
    assert table_digest(port_table) == ref_table_digest(ref_table), what


def assert_same_stats(ref_stats, port_stats, what=""):
    for field in COUNTERS:
        assert getattr(port_stats, field) == getattr(ref_stats, field), f"{what} {field}"


def delta_both(P, Q, sources, *, store=None):
    """Materialize P, delta-execute Q, in both packages.  Returns the
    reference's and the port's ``ExecResult`` after comparing plans."""
    rstore = RefMemStore()
    rp = RefPlan(P, sources, plane="numpy")
    rp.run(store=rstore, materialize=True)
    rplan = ref_analyze_delta(P, Q)
    assert rplan is not None, "edit unexpectedly not delta-amenable"
    ref = ref_execute_delta(rplan, P, RefPlan(Q, sources, plane="numpy"), rp.digests, rstore)

    pP, pQ, psrc = carry_dag(P), carry_dag(Q), carry_sources(sources)
    store = store if store is not None else InMemoryMaterializationStore()
    pp = ExecutionPlan(pP, psrc, **TORCH)
    pp.run(store=store, materialize=True)
    assert pp.digests == rp.digests
    plan = analyze_delta(pP, pQ)
    assert plan is not None and plan.to_dict() == rplan.to_dict()
    assert plan.spine_to_p == rplan.spine_to_p and plan.exact == rplan.exact
    got = execute_delta(plan, pP, ExecutionPlan(pQ, psrc, **TORCH), pp.digests, store)
    return ref, got, psrc, pQ


# ---------------------------------------------------------------------------
# core/delta.py: classification and census
# ---------------------------------------------------------------------------
def _f(p):
    return Operator.make("f", D.FILTER, pred=p)


CLASSIFY = {
    "narrow": (_f(P95), _f(P85), NARROW),
    "widen": (_f(P85), _f(P95), WIDEN),
    "general": (_f(P95), _f(Pred.cmp("c", ">=", 0)), FILTER_GENERAL),
    "conjunct": (_f(P95), _f(Pred.and_(P95, Pred.cmp("a", "<", 5))), NARROW),
    "project": (Operator.make("p", D.PROJECT, cols=(("a", "a"),)),
                Operator.make("p", D.PROJECT, cols=(("a", "a"), ("b", "b"))), PROJECT_COLS),
    "agg_swap": (Operator.make("g", D.AGGREGATE, group_by=("a",), aggs=(("sum", "b", "sb"),)),
                 Operator.make("g", D.AGGREGATE, group_by=("a",),
                               aggs=(("sum", "b", "sb"), ("avg", "c", "ac"))), AGG_SWAP),
    "group_by": (Operator.make("g", D.AGGREGATE, group_by=("a",), aggs=(("sum", "b", "sb"),)),
                 Operator.make("g", D.AGGREGATE, group_by=("c",), aggs=(("sum", "b", "sb"),)),
                 None),
    "op_type": (Operator.make("p", D.PROJECT, cols=(("a", "a"),)),
                Operator.make("g", D.AGGREGATE, group_by=("a",), aggs=(("sum", "b", "sb"),)),
                None),
}


@pytest.mark.parametrize("name", sorted(CLASSIFY))
def test_classify_edit_matches_reference(name):
    p_op, q_op, want = CLASSIFY[name]
    assert ref_classify_edit(p_op, q_op) == want
    assert classify_edit(carry_op(p_op), carry_op(q_op)) == want


def _census_pairs():
    cl = lambda col, model, classes: [seq(Operator.make(  # noqa: E731
        "cl", D.CLASSIFIER, col=col, out="label", model=model, classes=classes))]
    P = build(P95, extra=cl("a", "m", 5))
    return {
        "not-amenable": (P, build(P95, extra=cl("c", "m2", 4))),
        "no-change": (P, P),
        "multi-site": (P, build(Pred.cmp("b", "<", 80), extra=cl("a", "m", 7))),
        "narrow": (build(P95, extra=heavy_tail()), build(P85, extra=heavy_tail())),
    }


@pytest.mark.parametrize("name", sorted(_census_pairs()))
def test_delta_census_labels_match_reference(name):
    P, Q = _census_pairs()[name]
    rplan, rlabel = ref_delta_census(P, Q)
    plan, label = delta_census(carry_dag(P), carry_dag(Q))
    assert label == rlabel
    assert (plan is None) == (rplan is None)
    if plan is not None:
        assert plan.to_dict() == rplan.to_dict()
    if name == "not-amenable":
        assert label == "fallback:not-amenable:Classifier"
    elif name == "no-change":
        assert label == "fallback:no-change"
    elif name == "multi-site":
        assert label.startswith("fallback:")


# ---------------------------------------------------------------------------
# engine/delta.py: every scenario, byte for byte and counter for counter
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", SCENARIOS)
def test_delta_matches_reference(name):
    P, Q, sources = _scenario(name)
    ref, got, psrc, pQ = delta_both(P, Q, sources)
    full = ref_execute(Q, sources)
    assert set(got.results) == set(ref.results) == set(full)
    for s, table in full.items():
        assert ref_identical(ref.results[s], table), f"reference sink {s}"
        assert_same_bytes(table, got.results[s], f"sink {s}")
    assert_same_stats(ref.stats, got.stats, name)
    assert got.reused_ops == ref.reused_ops
    st = got.stats
    assert st.ops_delta > 0
    assert st.ops_executed + st.ops_reused + st.ops_skipped + st.ops_delta == st.ops_total
    port_full = execute(pQ, psrc, **TORCH)
    for s, table in port_full.items():
        assert_same_bytes(full[s], table, f"port full sink {s}")
    if name.startswith("narrow"):
        assert st.delta_rows_processed > 0
    if name == "agg_swap":
        assert st.ops_executed == 0  # the swapped aggregate re-reduces its exact input
    if name == "sort":
        assert st.ops_executed >= 1  # SORT densifies and executes


def test_delta_filter_masks_go_through_the_relational_kernel(monkeypatch):
    """On the torch plane the boundary filter's and the spine filter's masks
    are ``pred_mask`` calls that reach the relational kernel's wrapper (its
    plain version on the CPU, the CUDA kernel on the card)."""
    calls = []
    wrapper = R.relational

    def spy(*args, **kw):
        calls.append(args[0])
        return wrapper(*args, **kw)

    P, Q, sources = _scenario("narrow:bag")
    pP, pQ, psrc = carry_dag(P), carry_dag(Q), carry_sources(sources)
    store = InMemoryMaterializationStore()
    pp = ExecutionPlan(pP, psrc, **TORCH)
    pp.run(store=store, materialize=True)
    q_plan = ExecutionPlan(pQ, psrc, **TORCH)
    plane = q_plan.plane
    masks = []
    pred_mask = type(plane).pred_mask

    def spy_mask(self, pred, t):
        out = pred_mask(self, pred, t)
        masks.append(out)
        return out

    monkeypatch.setattr(R, "relational", spy)
    monkeypatch.setattr(type(plane), "pred_mask", spy_mask)
    res = execute_delta(analyze_delta(pP, pQ), pP, q_plan, pp.digests, store)
    assert res.stats.ops_delta > 0
    # boundary: q's and p's predicate over fe's input; the spine: fa and fb
    assert len(masks) >= 4 and all(isinstance(m, np.ndarray) and m.dtype == bool for m in masks)
    assert len(calls) == len(masks)


def test_missing_p_table_raises_delta_unsupported():
    t = src_table(500)
    P, Q = build(P95, extra=heavy_tail()), build(P85, extra=heavy_tail())
    rp = RefPlan(P, {"src": t})
    rp.run()
    with pytest.raises(RefDeltaUnsupported):
        ref_execute_delta(ref_analyze_delta(P, Q), P, RefPlan(Q, {"src": t}), rp.digests,
                          RefMemStore())
    pP, pQ, psrc = carry_dag(P), carry_dag(Q), carry_sources({"src": t})
    pp = ExecutionPlan(pP, psrc, **TORCH)
    pp.run()  # no store, nothing materialized
    with pytest.raises(DeltaUnsupported):
        execute_delta(analyze_delta(pP, pQ), pP, ExecutionPlan(pQ, psrc, **TORCH), pp.digests,
                      InMemoryMaterializationStore())


# ---------------------------------------------------------------------------
# store pinning under eviction pressure
# ---------------------------------------------------------------------------
class _UnpinnableStore(InMemoryMaterializationStore):
    def pin(self, keys):
        return ()


def _pin_scenario(store):
    """tests/test_delta_exec.py's: P materialized into ``store`` whose byte
    budget is then just P's tables, so any fresh Q table evicts."""
    t = src_table(n=4000, seed=11)
    P, Q = build(P95, extra=heavy_tail()), build(P85, extra=heavy_tail())
    pP, pQ, psrc = carry_dag(P), carry_dag(Q), carry_sources({"src": t})
    pp = ExecutionPlan(pP, psrc, **TORCH)
    pp.run(store=store, materialize=True)
    store.byte_budget = store.total_bytes()
    res = execute_delta(analyze_delta(pP, pQ), pP, ExecutionPlan(pQ, psrc, **TORCH),
                        pp.digests, store)
    return res, ref_execute(Q, {"src": t})


def test_pinned_delta_run_survives_eviction_pressure():
    store = InMemoryMaterializationStore()
    res, full = _pin_scenario(store)
    for s, table in full.items():
        assert_same_bytes(table, res.results[s], s)
    assert store.stats()["pinned_keys"] == 0


def test_unpinned_delta_run_loses_tables_mid_run():
    with pytest.raises(DeltaUnsupported):
        _pin_scenario(_UnpinnableStore())


def test_store_pin_refcounts():
    store = InMemoryMaterializationStore()
    a = Table({"x": np.arange(100, dtype=np.float64)}, ["x"])
    b = Table({"x": np.arange(100, 200, dtype=np.float64)}, ["x"])
    store.put("a", a)
    store.put("b", b)
    pinned = store.pin(["a", "ghost"])
    assert pinned == ("a",)
    store.byte_budget = table_nbytes(a) + 10
    store.put("c", Table({"x": np.arange(300, 400, dtype=np.float64)}, ["x"]))
    assert "a" in store and "b" not in store
    store.unpin(pinned)
    store.put("d", Table({"x": np.arange(7, dtype=np.float64)}, ["x"]))
    assert "a" not in store


# ---------------------------------------------------------------------------
# the session: exec_mode, and the certificate gate
# ---------------------------------------------------------------------------
def test_exec_mode_validation():
    with pytest.raises(ConfigError):
        VeerConfig(exec_mode="partial").validate()
    VeerConfig(exec_mode="delta").validate()
    assert VeerConfig(exec_mode="delta").exec_mode == RefVeerConfig(exec_mode="delta").exec_mode


def _equivalent_chain(thresholds=(80.0, 74.0, 77.0)):
    return [build(Pred.cmp("b", "<", th), extra=heavy_tail()) for th in thresholds]


def _sessions(mode, versions, sources, mappings=None):
    """The same chain through a reference session (numpy plane) and a port
    session (torch plane on the CPU); returns both lists of reports."""
    mappings = mappings or [None] * len(versions)
    ref = RefSession(config=RefVeerConfig(evs=("equitas", "spes", "udp"), exec_mode=mode),
                     materialization_store=RefMemStore())
    port = VersionChainSession(config=VeerConfig(evs=("equitas", "spes", "udp"), exec_mode=mode),
                               materialization_store=InMemoryMaterializationStore(),
                               device="cpu")
    assert port.plane == "torch"
    psrc = carry_sources(sources)
    rr = [ref.submit(v, m, sources=sources) for v, m in zip(versions, mappings)]
    pr = [port.submit(carry_dag(v), carry_mapping(m), sources=psrc)
          for v, m in zip(versions, mappings)]
    for k, (a, b) in enumerate(zip(rr, pr)):
        assert b.verdict is a.verdict and b.certified == a.certified, k
        assert set(b.results) == set(a.results)
        for s in a.results:
            assert_same_bytes(a.results[s], b.results[s], f"v{k} sink {s}")
        assert_same_stats(a.exec_stats, b.exec_stats, f"v{k}")
    assert port.report().total_ops_delta == ref.report().total_ops_delta
    return rr, pr, port


def test_session_delta_mode_byte_identical_to_full():
    sources = {"src": src_table(n=5000, seed=2)}
    chain = _equivalent_chain()
    _, reports, session = _sessions("delta", chain, sources)
    for k, (v, r) in enumerate(zip(chain, reports)):
        for s, table in ref_execute(v, sources).items():
            assert_same_bytes(table, r.results[s], f"v{k} sink {s}")
        if k > 0:
            assert r.verdict is True and r.certified
            assert r.exec_stats.ops_delta > 0
            assert r.exec_stats.delta_rows_processed > 0
    assert session.report().total_ops_delta > 0
    assert "delta:" in session.report().summary()


def test_session_delta_mode_falls_back_on_non_amenable():
    sources = {"src": src_table(n=2000, seed=4)}
    P = build(P95, extra=heavy_tail())
    renames = {o.id: (o.id + "x" if o.id == "fa" else o.id) for o in P.ops.values()}
    Q = DataflowDAG(
        [Operator.make(renames[o.id], o.op_type, **o.props) for o in P.ops.values()],
        [Link(renames[l.src], renames[l.dst], l.dst_port) for l in P.links],
    )
    Q.validate()
    _, reports, _ = _sessions("delta", [P, Q], sources, [None, RefEditMapping.make(renames)])
    r = reports[1]
    assert r.verdict is True
    for s, table in ref_execute(Q, sources).items():
        assert_same_bytes(table, r.results[s], s)
    assert r.exec_stats.ops_delta == 0  # fell back to seeded reuse
    assert r.exec_stats.ops_reused > 0


def test_session_full_mode_matches_delta_mode():
    sources = {"src": src_table(n=3000, seed=9)}
    chain = _equivalent_chain()
    results = {mode: _sessions(mode, chain, sources)[1] for mode in ("full", "delta")}
    for rf, rd in zip(results["full"], results["delta"]):
        for s in rf.results:
            assert_same_bytes(RTable(rf.results[s].cols, rf.results[s].order), rd.results[s], s)
    assert all(r.exec_stats.ops_delta == 0 for r in results["full"])
    assert all(r.exec_stats.ops_delta > 0 for r in results["delta"][1:])


# ---------------------------------------------------------------------------
# the reference's predicate edit family: the same census, the same deltas
# ---------------------------------------------------------------------------
def test_predicate_family_census_and_deltas_match_reference():
    config = WorkloadConfig(seed=5, sessions=2, chain_length=6,
                            edit_mix=(("predicate", 1.0),), rows=40)
    labels, amenable = [], 0
    for s in SessionGenerator(config).generate():
        psrc = carry_sources(s.sources)
        for k, p in enumerate(s.pairs):
            P, Q = s.versions[k], s.versions[k + 1]
            rplan, rlabel = ref_delta_census(P, Q, p.mapping)
            pP, pQ = carry_dag(P), carry_dag(Q)
            plan, label = delta_census(pP, pQ, carry_mapping(p.mapping))
            assert label == rlabel
            labels.append(label)
            if rplan is None:
                assert plan is None
                continue
            assert plan.to_dict() == rplan.to_dict()
            rstore, store = RefMemStore(), InMemoryMaterializationStore()
            rp = RefPlan(P, s.sources)
            rp.run(store=rstore, materialize=True)
            pp = ExecutionPlan(pP, psrc, **TORCH)
            pp.run(store=store, materialize=True)
            try:
                ref = ref_execute_delta(rplan, P, RefPlan(Q, s.sources), rp.digests, rstore)
            except RefDeltaUnsupported:
                with pytest.raises(DeltaUnsupported):
                    execute_delta(plan, pP, ExecutionPlan(pQ, psrc, **TORCH), pp.digests, store)
                continue
            got = execute_delta(plan, pP, ExecutionPlan(pQ, psrc, **TORCH), pp.digests, store)
            for sink, table in ref.results.items():
                assert_same_bytes(table, got.results[sink], sink)
            assert_same_stats(ref.stats, got.stats, label)
            amenable += 1
    assert any(not label.startswith("fallback:") for label in labels)
    assert amenable > 0
