"""The port's traced EV (``repro_torch.core.ev.fx_ev.FxEV``, registered as
``"jaxpr"``) held against the reference package's ``JaxprEV`` on the CPU.

Every check is exact: on the same window both EVs must give the same
``validate``, ``failed_restrictions`` and ``check`` verdicts.  The windows
are hand-built pairs (a UDF past a commuting filter, a classifier's model
changed, SORT ascending and descending, UNION, the ``prod_pos`` atom, a
string predicate, a JOIN) and every window the reference's ``Veer`` hands
to ``JaxprEV`` on a seeded ``SessionGenerator`` corpus.  Each is built by
the reference package and carried across through ``dag_to_dict``.
"""

import os
import pathlib
import subprocess
import sys

import pytest
import torch

from helpers import SCHEMA, chain, f
from repro import api as ref_api
from repro.api.serialize import dag_to_dict, query_pair_to_dict
from repro.core import dag as D
from repro.core.dag import DataflowDAG, Link, Operator
from repro.core.ev.base import QueryPair as RefQueryPair
from repro.core.ev.jaxpr_ev import JaxprEV
from repro.core.predicates import LinCmp, LinExpr, NonLinearAtom, Pred
from repro.workload import SessionGenerator, WorkloadConfig

from repro_torch import api as port_api
from repro_torch import carry
from repro_torch.core.ev import FxEV
from repro_torch.core.ev import fx_ev
from repro_torch.core.ev import torch_bodies as B
from repro_torch.core.ev.base import QueryPair
from repro_torch.api.serialize import query_pair_from_dict

op = Operator.make
ROOT = pathlib.Path(__file__).resolve().parent.parent


def _carry(dag):
    return carry.from_reference(dag_to_dict(dag), {})[0]


def _union(swap, pred_b=("b", "<", 4)):
    fa, fb = f("fa", "a", ">", 3), f("fb", *pred_b)
    first, second = (fb, fa) if swap else (fa, fb)
    return DataflowDAG(
        [op("src", D.SOURCE, schema=SCHEMA), op("rep", D.REPLICATE), fa, fb,
         op("u", D.UNION), op("sink", D.SINK, semantics=D.BAG)],
        [Link("src", "rep"), Link("rep", "fa"), Link("rep", "fb"),
         Link(first.id, "u", 0), Link(second.id, "u", 1), Link("u", "sink")],
    )


def _join(how="inner"):
    return DataflowDAG(
        [op("l", D.SOURCE, schema=("a", "b")), op("r", D.SOURCE, schema=("k", "v")),
         op("j", D.JOIN, on=(("a", "k"),), how=how), op("sink", D.SINK, semantics=D.BAG)],
        [Link("l", "j", 0), Link("r", "j", 1), Link("j", "sink")],
    )


def _udf(fn="double_all"):
    out = SCHEMA + ("rowsum",) if fn == "add_rowsum" else SCHEMA
    return op("u", D.UDF, fn=fn, out_schema=out)


def _cls(model="m", col="a", kind=D.CLASSIFIER):
    return op("c", kind, col=col, out="t", model=model, classes=3)


def _sort(*keys):
    return op("s", D.SORT, keys=tuple(keys))


def _nl(fn):
    return op("fn", D.FILTER, pred=Pred.of(NonLinearAtom(fn, ("a", "b"))))


def _scaled(id_, k):
    """``a > 2`` written as ``k*a > 2k``: equal rows, another expression."""
    return op(id_, D.FILTER, pred=Pred.of(LinCmp.make(LinExpr.col("a").scale(k), ">",
                                                       LinExpr.lit(2 * k))))


WINDOWS = {
    # a UDF moved past a commuting filter: the same rows, another graph
    "udf_past_filter": (chain(f("f1", "a", ">", 2), _udf()), chain(_udf(), f("f1", "a", ">", 4))),
    # the UDF unchanged, the filter after it renamed: the same graph
    "udf_filter_renamed": (chain(_udf(), f("f1", "a", ">", 2)), chain(_udf(), f("f9", "a", ">", 2))),
    "udf_changed": (chain(_udf("double_all")), chain(_udf("add_rowsum"))),
    "udf_rowsum_same": (chain(_udf("add_rowsum")), chain(_udf("add_rowsum"))),
    "filter_rescaled": (chain(f("f1", "a", ">", 2)), chain(_scaled("f1", 3))),
    "identity_project": (chain(op("p", D.PROJECT, cols=tuple((c, c) for c in SCHEMA))), chain()),
    "replicate_spliced": (chain(f("f1", "a", ">", 2)),
                          chain(op("r", D.REPLICATE), f("f1", "a", ">", 2))),
    "classifier_model_changed": (chain(_cls("m")), chain(_cls("m2"))),
    "classifier_same_model": (chain(_cls("m")), chain(_cls("m"))),
    "classifier_column_changed": (chain(_cls("m")), chain(_cls("m", col="b"))),
    "sentiment_vs_classifier": (chain(_cls("m")), chain(_cls("m", kind=D.SENTIMENT))),
    "sort_asc_vs_desc": (chain(_sort(("a", True))), chain(_sort(("a", False)))),
    "sort_asc_same": (chain(_sort(("a", True), ("b", False))),
                      chain(_sort(("a", True), ("b", False)))),
    "sort_keys_swapped": (chain(_sort(("a", True), ("b", True))),
                          chain(_sort(("b", True), ("a", True)))),
    "sort_ordered_sink": (chain(_sort(("a", True)), sink_sem=D.ORDERED),
                          chain(_sort(("a", True)), sink_sem=D.ORDERED)),
    "union_swapped": (_union(False), _union(True)),
    "union_same": (_union(False), _union(False)),
    "union_filter_changed": (_union(False), _union(False, ("b", "<", 5))),
    "prod_pos_same": (chain(_nl("prod_pos")), chain(_nl("prod_pos"))),
    "prod_pos_negated": (chain(_nl("prod_pos")), chain(_nl("not_prod_pos"))),
    "str_eq_j2": (chain(op("fs", D.FILTER, pred=Pred.str_eq("a", "x"))),
                  chain(op("fs", D.FILTER, pred=Pred.str_eq("a", "x")))),
    "join_j1": (_join(), _join()),
    "join_j1_vs_left_outer": (_join(), _join("left_outer")),
}


def _pair(name):
    P, Q = WINDOWS[name]
    sinks = tuple((s, s) for s in sorted(P.sinks))
    ref = RefQueryPair(P, Q, sinks)
    return ref, QueryPair(_carry(P), _carry(Q), sinks)


def _agree(ref_qp, port_qp):
    ref_ev, port_ev = JaxprEV(), FxEV()
    assert port_ev.failed_restrictions(port_qp) == ref_ev.failed_restrictions(ref_qp)
    valid = port_ev.validate(port_qp)
    assert valid == ref_ev.validate(ref_qp)
    got = port_ev.check(port_qp)
    assert got is ref_ev.check(ref_qp)
    return valid, got


EXPECTED = {  # what the reference says; the port must say the same
    "udf_filter_renamed": True, "udf_rowsum_same": True, "identity_project": True,
    "replicate_spliced": True, "classifier_same_model": True, "sort_asc_same": True,
    "sort_ordered_sink": True, "union_same": True, "prod_pos_same": True,
    "classifier_model_changed": None, "sort_asc_vs_desc": None, "union_swapped": None,
    "prod_pos_negated": None, "udf_past_filter": None, "udf_changed": None,
}


@pytest.mark.parametrize("name", sorted(WINDOWS))
def test_hand_built_windows_match_jaxpr_ev(name):
    valid, got = _agree(*_pair(name))
    if name in EXPECTED:
        assert valid and got is EXPECTED[name]
    if name.endswith("_j2"):
        assert not valid and FxEV().failed_restrictions(_pair(name)[1]) == ["J2"]
    if name.startswith("join_j1"):
        assert not valid and FxEV().failed_restrictions(_pair(name)[1]) == ["J1"]


def test_capabilities_match_jaxpr_ev():
    ref, port = JaxprEV(), FxEV()
    assert port.name == ref.name == "jaxpr"
    assert port.semantics == ref.semantics
    assert port.supported_op_types == ref.supported_op_types
    assert (port.restriction_monotonic, port.can_prove_inequivalence) == (True, False)
    assert [r.name for r in port.restrictions()] == [r.name for r in ref.restrictions()]
    assert sorted(B.TORCH_UDF_REGISTRY) == ["add_rowsum", "double_all"]
    assert sorted(B.TORCH_NONLINEAR_FNS) == ["not_prod_pos", "prod_pos"]
    spec = port_api.default_registry().spec("jaxpr")
    assert spec.factory is FxEV and spec.supported_op_types == B.TRACEABLE_OPS


def test_captured_tensor_constant_answers_none(monkeypatch):
    """A body that reads a tensor built outside the trace: the graph names it
    (``get_attr``) without its value, so even an identical pair is None."""
    bias = torch.ones(fx_ev._SYMBOLIC_ROWS)

    def add_bias(t):
        cols, mask = t
        return {c: v + bias for c, v in cols.items()}, mask

    monkeypatch.setitem(B.TORCH_UDF_REGISTRY, "add_bias", add_bias)
    dag = _carry(chain(op("u", D.UDF, fn="add_bias", out_schema=SCHEMA)))
    qp = QueryPair(dag, dag, (("sink", "sink"),))
    assert FxEV().validate(qp)
    assert fx_ev._window_graph(dag, ["sink"]) is None
    assert FxEV().check(qp) is None
    # the same pair with a registered, scalar-built body is proved
    same = _carry(chain(_udf()))
    assert FxEV().check(QueryPair(same, same, (("sink", "sink"),))) is True


def test_checks_from_many_threads_match_sequential_checks():
    """A window pool or a service's threads trace at once: every verdict and
    every graph text equals the sequential one."""
    import threading

    pairs = [qp for qp in (_pair(name)[1] for name in sorted(WINDOWS)) if FxEV().validate(qp)]
    want = [FxEV().check(qp) for qp in pairs]
    texts = [fx_ev._window_graph(qp.P, ["sink"]) for qp in pairs[:6]]
    got, errors = {}, []

    def worker(t):
        try:
            ev = FxEV()
            got[t] = ([ev.check(qp) for qp in pairs],
                      [fx_ev._window_graph(qp.P, ["sink"]) for qp in pairs[:6]])
        except Exception as e:  # pragma: no cover - the assertion is the point
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and not any(t.is_alive() for t in threads)
    assert all(g == (want, texts) for g in got.values()) and len(got) == 4


def test_graph_text_is_the_same_in_another_process():
    code = (
        "import sys\n"
        "from repro_torch.core import dag as D\n"
        "from repro_torch.core.predicates import Pred\n"
        "from repro_torch.core.ev import fx_ev\n"
        "ops = [D.Operator.make('src', D.SOURCE, schema=('a', 'b')),\n"
        "       D.Operator.make('f', D.FILTER, pred=Pred.cmp('a', '>', 2)),\n"
        "       D.Operator.make('s', D.SORT, keys=(('b', False),)),\n"
        "       D.Operator.make('c', D.CLASSIFIER, col='a', out='t', model='m', classes=3),\n"
        "       D.Operator.make('sink', D.SINK)]\n"
        "ids = [o.id for o in ops]\n"
        "dag = D.DataflowDAG(ops, [D.Link(x, y) for x, y in zip(ids, ids[1:])])\n"
        "sys.stdout.write(fx_ev._window_graph(dag, ['sink']))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300, check=True).stdout
    exec_env = {}
    exec(code.replace("sys.stdout.write(", "text = ("), exec_env)
    assert out == exec_env["text"]
    assert "0x" not in out and "_tensor_constant" not in out


# ---------------------------------------------------------------------------
# every window the reference's Veer hands to JaxprEV on a seeded corpus
# ---------------------------------------------------------------------------

CORPUS_SEEDS = (0, 1, 2)


def _corpus_windows():
    seen = []
    orig = JaxprEV.check

    def recording(self, qp):
        verdict = orig(self, qp)
        seen.append((query_pair_to_dict(qp), verdict))
        return verdict

    JaxprEV.check = recording
    try:
        for seed in CORPUS_SEEDS:
            cfg = WorkloadConfig(seed=seed, sessions=4, chain_length=6, rows=12,
                                 max_decompositions=60)
            for s in SessionGenerator(cfg).generate():
                for planned in s.pairs:
                    k = planned.index
                    ref_api.verify(s.versions[k - 1], s.versions[k],
                                   ref_api.VeerConfig(max_decompositions=60),
                                   mapping=planned.mapping)
    finally:
        JaxprEV.check = orig
    return seen


def test_every_corpus_window_matches_jaxpr_ev():
    windows = _corpus_windows()
    assert len(windows) >= 40
    ev = FxEV()
    for d, verdict in windows:
        qp = query_pair_from_dict(d)
        assert ev.validate(qp)
        assert ev.check(qp) is verdict, [o["type"] for o in d["P"]["ops"]]
