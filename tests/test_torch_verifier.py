"""The port's verifier (``repro_torch.core.verifier``, ``repro_torch.api``)
held against the reference package on the CPU.

Every check is exact: the verifier is symbolic reasoning over ``Fraction``s
and hashing, so there is no tolerance.  The pairs are those of
``tests/test_ev_verifier.py`` (without the JAX-traced EV's), of
``tests/test_certificate.py`` and of ``tests/test_search_kernel.py``'s seeded
workflows, and a seeded corpus of the reference's ``SessionGenerator``.
Each is built by the reference package and carried across through
``dag_to_dict`` and ``repro_torch.carry.from_reference``, so both packages
hash the same operators.  On each pair, under the baseline and Veer+, both
search backends and one or four window workers, the port must give the
reference's verdict, its deterministic ``VeerStats`` counters and its
``Certificate.to_json()`` bytes; the same holds under both packages' full
default roster, whose fourth EV is the traced one (the port's FxEV, the
reference's JaxprEV), and under ``guidance="model"``.  Anything executed
runs with ``device="cpu"``.
"""

import functools
import json
import random

import numpy as np
import pytest
import torch

from helpers import SCHEMA, chain, f, proj_identity, rand_table
from repro import api as ref_api
from repro.api.serialize import dag_to_dict
from repro.core import dag as D
from repro.core.dag import DataflowDAG, Link, Operator
from repro.core.edits import identity_mapping as ref_identity_mapping
from repro.core.ev.cache import VerdictCache as RefVerdictCache
from repro.core.predicates import LinCmp, LinExpr, Pred
from repro.core.verifier import Veer as RefVeer
from repro.core.window import VersionPair as RefVersionPair
from repro.engine import execute as ref_execute
from repro.engine.table import Table as RefTable
from repro.engine.table import tables_equal as ref_tables_equal
from repro.workload import SessionGenerator, WorkloadConfig

from repro_torch import api as port_api
from repro_torch import carry
from repro_torch.core.edits import EditMapping, identity_mapping
from repro_torch.core.ev import EquitasEV, SpesEV, UDPEV
from repro_torch.core.ev.cache import VerdictCache
from repro_torch.core.verifier import Veer
from repro_torch.core.window import VersionPair, initial_window
from repro_torch.engine import PlaneError, Table, sink_results_equal, tables_equal
from repro_torch.engine import plane as plane_registry

op = Operator.make
EVS3 = ("equitas", "spes", "udp")
COUNTERS = (
    "decompositions_explored", "windows_formed", "windows_verified", "ev_calls",
    "segments", "mappings_tried", "fast_inequivalence_hit", "cache_hits",
    "windows_deduped", "ev_calls_saved", "decompositions_to_first_certificate",
    "ev_attempts",
)
ANY = "any"  # a pair whose verdict only the reference decides


def _carry(dag):
    return carry.from_reference(dag_to_dict(dag), {})[0]


def _carry_mapping(mapping):
    return None if mapping is None else EditMapping.make(dict(mapping.p_to_q))


# ---------------------------------------------------------------------------
# the corpus: name -> (P, Q, evs, semantics, mapping, max_decompositions, expected)
# ---------------------------------------------------------------------------


def _case(P, Q, evs=("spes", "equitas", "udp"), expected=ANY, semantics=D.BAG,
          mapping=None, budget=50_000):
    return dict(P=P, Q=Q, evs=evs, semantics=semantics, mapping=mapping,
                budget=budget, expected=expected)


def _union_pair():
    def mk(swap):
        fa, fb = f("fa", "a", ">", 3), f("fb", "b", "<", 4)
        first, second = (fb, fa) if swap else (fa, fb)
        return DataflowDAG(
            [op("s", D.SOURCE, schema=SCHEMA), op("rep", D.REPLICATE), fa, fb,
             op("u", D.UNION), op("sink", D.SINK, semantics=D.BAG)],
            [Link("s", "rep"), Link("rep", "fa"), Link("rep", "fb"),
             Link(first.id, "u", 0), Link(second.id, "u", 1), Link("u", "sink")],
        )

    return mk(False), mk(True)


def _two_filter_pair(prefix="x", swap=True, a_thresh=2):
    def build(order):
        fa = op(f"{prefix}fa", D.FILTER, pred=Pred.cmp("a", ">", a_thresh))
        fb = op(f"{prefix}fb", D.FILTER, pred=Pred.cmp("b", "<", 5))
        path = [f"{prefix}src"] + [o.id for o in order(fa, fb)] + [f"{prefix}sink"]
        return DataflowDAG(
            [op(f"{prefix}src", D.SOURCE, schema=SCHEMA), fa, fb,
             op(f"{prefix}sink", D.SINK, semantics=D.BAG)],
            [Link(x, y) for x, y in zip(path, path[1:])],
        )

    return build(lambda fa, fb: (fa, fb)), build(lambda fa, fb: (fb, fa) if swap else (fa, fb))


def _two_branch_pair():
    def build(swap):
        ops, links = [], []
        for j in (0, 1):
            fa = op(f"fa{j}", D.FILTER, pred=Pred.cmp("a", ">", 2 + j))
            fb = op(f"fb{j}", D.FILTER, pred=Pred.cmp("b", "<", 5 + j))
            order = (fb, fa) if swap else (fa, fb)
            path = [f"src{j}", order[0].id, order[1].id, f"sink{j}"]
            ops += [op(f"src{j}", D.SOURCE, schema=SCHEMA), fa, fb,
                    op(f"sink{j}", D.SINK, semantics=D.BAG)]
            links += [Link(x, y) for x, y in zip(path, path[1:])]
        return DataflowDAG(ops, links)

    return build(False), build(True)


def _hand_cases():
    agg = lambda: op("agg", D.AGGREGATE, group_by=("a",), aggs=(("sum", "b", "s"),))  # noqa: E731
    count = lambda: op("agg", D.AGGREGATE, group_by=("a",), aggs=(("count", "*", "n"),))  # noqa: E731
    five = (f("f1", "a", ">", 1), f("f2", "b", "<", 5), f("f3", "c", ">", 0),
            proj_identity("p1"), f("f4", "a", "<", 6))
    union_P, union_Q = _union_pair()
    zP, _ = _two_filter_pair("z", swap=False)
    proj_P = chain(op("p", D.PROJECT, cols=(("a", "a"), ("b", "b"))))
    cls_P = DataflowDAG(
        [op("s", D.SOURCE, schema=SCHEMA),
         op("c", D.CLASSIFIER, col="a", out="t", model="m", classes=2),
         op("k", D.SINK, semantics=D.BAG)],
        [Link("s", "c"), Link("c", "k")],
    )
    return {
        # tests/test_ev_verifier.py
        "empty_filter": _case(
            chain(f("f1", "a", ">", 2)),
            chain(f("f1", "a", ">", 2), op("fe", D.FILTER, pred=Pred.true())), expected=True),
        "filter_reorder": _case(
            chain(f("f1", "a", ">", 2), f("f2", "b", "<", 5)),
            chain(f("f2", "b", "<", 5), f("f1", "a", ">", 2)), expected=True),
        "filter_split_merge": _case(
            chain(op("f12", D.FILTER,
                     pred=Pred.and_(Pred.cmp("a", ">", 2), Pred.cmp("b", "<", 5)))),
            chain(f("f1", "a", ">", 2), f("f2", "b", "<", 5)), expected=True),
        "inequivalent_constant": _case(
            chain(f("f1", "a", ">", 2)), chain(f("f1", "a", ">", 3)), expected=False),
        "filter_past_aggregate": _case(
            chain(agg(), f("fg", "a", "<", 4)), chain(f("fg", "a", "<", 4), agg()),
            evs=("equitas",), expected=True),
        "projection_pushdown": _case(
            chain(f("f1", "a", ">", 1), proj_identity("p1")),
            chain(proj_identity("p1"), f("f1", "a", ">", 1)), expected=True),
        "union_without_udp": _case(union_P, union_Q, evs=("spes", "equitas"), expected=None),
        "union_with_udp": _case(union_P, union_Q, evs=("udp",), expected=True),
        "paper_mapping_matters": _case(
            chain(proj_identity("p1"), f("fl", "a", ">", 2), count()),
            chain(count(), f("fl", "a", ">", 2),
                  op("p1", D.PROJECT, cols=(("a", "a"), ("n", "n")))),
            evs=("equitas",), expected=True),
        "unsupported_udf_change": _case(
            chain(op("u", D.UDF, fn="double_all", out_schema=SCHEMA)),
            chain(op("u", D.UDF, fn="add_rowsum", out_schema=SCHEMA)),
            evs=("spes", "equitas"), expected=None),
        "five_ops_swap": _case(chain(*five), chain(five[1], five[0], *five[2:]),
                               evs=("spes",), expected=True),
        "symbolic_inequivalence": _case(
            proj_P, proj_P.replace_op(op("p", D.PROJECT, cols=(("a", "a"),))),
            evs=("spes",), expected=False),
        "single_edit": _case(
            chain(f("f1", "a", ">", 2), proj_identity("p1")),
            chain(f("f1", "a", ">", 2), op("fe", D.FILTER, pred=Pred.true()),
                  proj_identity("p1")),
            evs=("spes",), expected=True),
        "ordered_sink_reorder": _case(
            chain(f("f1", "a", ">", 2), f("f2", "b", "<", 5), sink_sem=D.ORDERED),
            chain(f("f2", "b", "<", 5), f("f1", "a", ">", 2), sink_sem=D.ORDERED),
            semantics=D.ORDERED),
        # tests/test_certificate.py
        "cert_two_filters": _case(*_two_filter_pair(), evs=EVS3, expected=True),
        "cert_exact": _case(_two_filter_pair()[0], _two_filter_pair()[0], evs=EVS3,
                            expected=True),
        "cert_witness": _case(
            zP, zP.replace_op(op("zfa", D.FILTER, pred=Pred.cmp("a", ">", 4))),
            evs=EVS3, expected=False),
        "cert_symbolic": _case(
            proj_P, proj_P.replace_op(op("p", D.PROJECT, cols=(("a", "a"),))),
            evs=EVS3, expected=False),
        "cert_classifier_unknown": _case(
            cls_P, cls_P.replace_op(op("c", D.CLASSIFIER, col="b", out="t", model="m",
                                       classes=2)),
            evs=EVS3, expected=None),
        "cert_two_branches": _case(*_two_branch_pair(), evs=EVS3, expected=True),
    }


# tests/test_search_kernel.py's seeded generators, with the port's roster


def _workflow(rng):
    ops = []
    for i in range(rng.randint(1, 4)):
        kind = rng.choice(["filter", "filter", "project", "agg"])
        if kind == "filter":
            ops.append(f(f"op{i}", rng.choice(list(SCHEMA)),
                         rng.choice(["<", "<=", ">", ">=", "=="]), rng.randint(0, 6)))
        elif kind == "project":
            ops.append(proj_identity(f"op{i}"))
        else:
            ops.append(op(f"op{i}", D.AGGREGATE, group_by=(rng.choice(list(SCHEMA)),),
                          aggs=(("sum", rng.choice(list(SCHEMA)), "agg_out"),)))
            break
    return chain(*ops)


def _rewritten(P, rng):
    choice = rng.choice(["empty_filter", "scale", "bump", "new_filter"])
    if choice in ("scale", "bump"):
        for o in (o for o in P.ops.values() if o.op_type == D.FILTER):
            p = o.get("pred")
            if p.kind == "atom" and isinstance(p.atom, LinCmp):
                expr = p.atom.expr.scale(2) if choice == "scale" else p.atom.expr + LinExpr.lit(1)
                return P.replace_op(o.with_props(pred=Pred.of(LinCmp(expr, p.atom.op))))
        choice = "empty_filter"
    link = rng.choice(list(P.links))
    pred = (Pred.cmp(rng.choice(list(SCHEMA)), "<", rng.randint(1, 5))
            if choice == "new_filter" else Pred.true())
    new = op("fx_new", D.FILTER, pred=pred)
    Q = P.add_op(new).remove_link(link)
    return Q.add_link(Link(link.src, new.id)).add_link(Link(new.id, link.dst, 0))


def _splice_true_filters(P, n):
    Q = P
    for i, link in enumerate(list(P.links)[:n]):
        new = op(f"tf{i}", D.FILTER, pred=Pred.true())
        Q = Q.add_op(new).remove_link(Link(link.src, link.dst, link.dst_port))
        Q = Q.add_link(Link(link.src, new.id)).add_link(Link(new.id, link.dst, link.dst_port))
    return Q


SEEDED = 12
MULTI = ((0, 20), (1, 200), (2, 60), (3, 20))
# the reference's SessionGenerator: (seed, shapes); 2 sessions of 5 pairs each
SESSIONS = ((7, ("W1", "W5", "W8")), (11, ("W2", "W3", "W4", "W6", "W7")))
SESSION_COUNT, CHAIN = 2, 6
SESSION_BUDGET = 60


def _seeded_cases():
    out = {}
    for seed in range(SEEDED):
        rng = random.Random(seed)
        P = _workflow(rng)
        out[f"seeded{seed}"] = _case(P, _rewritten(P, rng), evs=EVS3)
    for seed, budget in MULTI:
        rng = random.Random(100 + seed)
        P = _workflow(rng)
        out[f"multi{seed}"] = _case(P, _splice_true_filters(P, rng.randint(2, 4)), evs=EVS3,
                                    budget=budget)
    return out


def _session_cases():
    out = {}
    for seed, shapes in SESSIONS:
        cfg = WorkloadConfig(seed=seed, sessions=SESSION_COUNT, chain_length=CHAIN,
                             workloads=shapes, rows=12, max_decompositions=SESSION_BUDGET)
        for s in SessionGenerator(cfg).generate():
            for planned in s.pairs:
                k = planned.index
                out[f"gen{seed}-{s.session_id}-{k}-{planned.kind}"] = _case(
                    s.versions[k - 1], s.versions[k], evs=EVS3, mapping=planned.mapping,
                    budget=SESSION_BUDGET)
    return out


SESSION_NAMES = tuple(f"gen{seed}-s{i}-{k}" for seed, _ in SESSIONS
                      for i in range(SESSION_COUNT) for k in range(1, CHAIN))


@functools.lru_cache(maxsize=None)
def corpus():
    out = dict(_hand_cases())
    out.update(_seeded_cases())
    gen = _session_cases()
    assert tuple(n.rsplit("-", 1)[0] for n in gen) == SESSION_NAMES
    out.update({n.rsplit("-", 1)[0]: c for n, c in gen.items()})
    return out


NAMES = tuple(_hand_cases()) + tuple(_seeded_cases()) + SESSION_NAMES


@functools.lru_cache(maxsize=None)
def carried(name):
    """The pair of ``name`` in both packages: (reference case, port P, Q, mapping)."""
    c = corpus()[name]
    return c, _carry(c["P"]), _carry(c["Q"]), _carry_mapping(c["mapping"])


def run_pair(api, P, Q, c, mapping, *, plus=True, backend="bitmask", workers=1, cache=None):
    preset = api.VeerConfig.plus if plus else api.VeerConfig.baseline
    config = preset(evs=c["evs"], semantics=c["semantics"], search_backend=backend,
                    max_workers=workers, max_decompositions=c["budget"])
    return api.verify(P, Q, config, mapping=mapping, cache=cache)


def _outcome(result):
    cert = result.certificate
    return (result.verdict, {k: getattr(result.stats, k) for k in COUNTERS},
            cert.to_json() if cert is not None else None)


# ---------------------------------------------------------------------------
# verdicts, counters and certificate bytes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["baseline", "plus"])
@pytest.mark.parametrize("name", NAMES)
def test_port_matches_reference(name, mode):
    c, P, Q, mapping = carried(name)
    plus = mode == "plus"
    seen = set()
    for backend in ("bitmask", "reference"):
        for workers in (1, 4):
            ref = _outcome(run_pair(ref_api, c["P"], c["Q"], c, c["mapping"], plus=plus,
                                    backend=backend, workers=workers))
            got = _outcome(run_pair(port_api, P, Q, c, mapping, plus=plus,
                                    backend=backend, workers=workers))
            assert got[0] is ref[0], (backend, workers)
            assert got[1] == ref[1], (backend, workers)
            assert got[2] == ref[2], (backend, workers)
            seen.add(got[0])
    assert len(seen) == 1
    if c["expected"] is not ANY:
        assert seen == {c["expected"]}


@pytest.mark.parametrize("name", NAMES)
def test_port_matches_reference_with_the_full_roster(name):
    """The same pairs under both packages' default roster, the traced EV
    (the reference's JaxprEV, the port's FxEV) among them: Veer+ on both
    search backends, and on four window workers."""
    c, P, Q, mapping = carried(name)
    full = dict(c, evs=port_api.DEFAULT_EV_NAMES)
    assert tuple(ref_api.DEFAULT_EV_NAMES) == port_api.DEFAULT_EV_NAMES
    seen = set()
    for backend, workers in (("bitmask", 1), ("reference", 1), ("bitmask", 4)):
        ref = _outcome(run_pair(ref_api, c["P"], c["Q"], full, c["mapping"],
                                backend=backend, workers=workers))
        got = _outcome(run_pair(port_api, P, Q, full, mapping, backend=backend,
                                workers=workers))
        assert got == ref, (backend, workers)
        seen.add(got[0])
    assert len(seen) == 1


SINGLE_EDIT = ("empty_filter", "single_edit", "inequivalent_constant", "cert_witness",
               "unsupported_udf_change")


@pytest.mark.parametrize("name", SINGLE_EDIT)
def test_single_edit_matches_reference(name):
    """Algorithm 1 and the maximal covering windows of a one-change pair."""
    c, P, Q, _ = carried(name)
    from repro.core.ev import EquitasEV as RE, SpesEV as RS, UDPEV as RU

    ref = RefVeer([RS(), RE(), RU()])
    port = Veer([SpesEV(), EquitasEV(), UDPEV()])
    rv, rs = ref.verify_single_edit(c["P"], c["Q"])
    pv, ps = port.verify_single_edit(P, Q)
    assert pv is rv
    assert {k: getattr(ps, k) for k in COUNTERS} == {k: getattr(rs, k) for k in COUNTERS}
    assert port.maximal_covering_windows(P, Q) == ref.maximal_covering_windows(c["P"], c["Q"])


def _windows(pair, limit=24):
    """Connected windows grown breadth-first from each change's initial
    window, in a deterministic order, at most ``limit``."""
    seen, order = set(), []
    frontier = [initial_window(pair, ch) for ch in pair.changes]
    while frontier and len(order) < limit:
        win = frontier.pop(0)
        if win in seen:
            continue
        seen.add(win)
        order.append(win)
        frontier += [win | {u} for u in sorted(pair.neighbors(win))]
    return order


EV_NAMES = ("equitas", "spes", "udp")


@pytest.mark.parametrize("name", NAMES)
def test_ev_verdicts_match_window_by_window(name):
    """Each window's query pair, fingerprint, and every EV's ``validate``
    and ``check`` verdicts agree between the packages."""
    _match_window_by_window(name, EV_NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_traced_ev_verdicts_match_window_by_window(name):
    """The fourth EV of the roster on the same windows: the port's FxEV
    against the reference's JaxprEV."""
    _match_window_by_window(name, ("jaxpr",))


def _match_window_by_window(name, ev_names):
    c, P, Q, mapping = carried(name)
    rp = RefVersionPair(c["P"], c["Q"], c["mapping"] or ref_identity_mapping(c["P"], c["Q"]),
                        c["semantics"])
    pp = VersionPair(P, Q, mapping or identity_mapping(P, Q), c["semantics"])
    assert [(u.p, u.q) for u in pp.units] == [(u.p, u.q) for u in rp.units]
    assert [sorted(ch.required_units) for ch in pp.changes] == \
        [sorted(ch.required_units) for ch in rp.changes]
    ref_evs = ref_api.default_registry().build(ev_names)
    port_evs = port_api.default_registry().build(ev_names)
    windows = _windows(pp)
    assert windows == _windows(rp)
    assert bool(windows) == bool(pp.changes)
    for win in windows:
        assert pp.window_fingerprint(win) == rp.window_fingerprint(win)
        rq, pq = rp.to_query_pair(win), pp.to_query_pair(win)
        assert (pq is None) == (rq is None)
        if pq is None:
            continue
        assert pq.fingerprint() == rq.fingerprint()
        for rev, pev in zip(ref_evs, port_evs):
            valid = pev.validate(pq)
            assert valid == rev.validate(rq), (win, pev.name)
            assert pev.failed_restrictions(pq) == rev.failed_restrictions(rq)
            if valid:
                assert pev.check(pq) is rev.check(rq), (win, pev.name)


# ---------------------------------------------------------------------------
# the verdict cache's file format is shared
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_cache_file_written_by_one_package_warms_the_other(writer, tmp_path):
    path = str(tmp_path / "verdicts.json")
    names = ("cert_two_filters", "cert_two_branches", "filter_split_merge", "seeded3")
    caches = {"reference": (ref_api, RefVerdictCache), "port": (port_api, VerdictCache)}
    reader = "port" if writer == "reference" else "reference"
    api, Cache = caches[writer]
    cold = Cache(path)
    for n in names:
        c, P, Q, mapping = carried(n)
        pair = (c["P"], c["Q"], c["mapping"]) if writer == "reference" else (P, Q, mapping)
        assert run_pair(api, pair[0], pair[1], c, pair[2], cache=cold).stats.ev_calls > 0
    cold.save()
    api, Cache = caches[reader]
    warm = Cache(path)
    assert len(warm) == len(cold) > 0
    for n in names:
        c, P, Q, mapping = carried(n)
        pair = (c["P"], c["Q"], c["mapping"]) if reader == "reference" else (P, Q, mapping)
        config = api.VeerConfig(evs=c["evs"])
        result = api.verify(pair[0], pair[1], config, mapping=pair[2], cache=warm)
        assert result.stats.ev_calls == 0 and result.stats.cache_hits > 0
        assert result.certificate.replay(P=pair[0], Q=pair[1]).ok


# ---------------------------------------------------------------------------
# VeerConfig
# ---------------------------------------------------------------------------


def test_config_json_differs_from_the_reference_only_in_plane_and_evs():
    """The roster is whole: the default configs differ only in ``plane``."""
    ref = json.loads(ref_api.VeerConfig().to_json())
    port = json.loads(port_api.VeerConfig().to_json())
    assert set(ref) == set(port)
    assert {k for k in ref if ref[k] != port[k]} == {"plane"}
    assert (ref["plane"], port["plane"]) == ("numpy", "torch")
    assert port["evs"] == ref["evs"] == list(port_api.DEFAULT_EV_NAMES)
    assert port["evs"] == ["equitas", "spes", "udp", "jaxpr"]


@pytest.mark.parametrize("preset", ["plus", "baseline"])
def test_config_round_trips_between_the_packages(preset, tmp_path):
    changes = dict(evs=EVS3, plane="numpy", max_workers=3, search_backend="reference",
                   semantics=D.SET, cache_path=str(tmp_path / "c.json"), exec_mode="delta",
                   shared_tier="remote", tier_dir=str(tmp_path), cache_max_entries=64)
    ref = getattr(ref_api.VeerConfig, preset)(**changes)
    port = port_api.VeerConfig.from_json(ref.to_json())
    assert port.to_json() == ref.to_json()
    assert ref_api.VeerConfig.from_json(port.to_json()) == ref
    assert port.validate() is port


def test_config_validates_the_plane_against_the_ports_registry():
    assert port_api.VeerConfig(plane="numpy").validate()
    with pytest.raises(port_api.ConfigError, match="plane"):
        port_api.VeerConfig(plane="jax").validate()
    config = port_api.VeerConfig(evs=("equitas", "jaxpr"))
    assert config.validate() is config
    with pytest.raises(port_api.ConfigError, match="unknown EVs"):
        port_api.VeerConfig(evs=("equitas", "jax")).validate()


def test_guidance_model_raises_config_error():
    """``guidance="model"`` builds (the learn layer is ported) and verifies
    as the reference does; only a bad guidance setting raises."""
    with pytest.raises(port_api.ConfigError):
        port_api.VeerConfig(guidance="learned").validate()
    with pytest.raises(port_api.ConfigError):
        port_api.VeerConfig(guidance_path="/x.json").validate()
    for name in ("cert_two_filters", "cert_witness", "seeded3", "multi1", "empty_filter"):
        c, P, Q, mapping = carried(name)
        config = port_api.VeerConfig(guidance="model", evs=c["evs"])
        assert config.build().guidance is not None
        ref = ref_api.verify(c["P"], c["Q"],
                             ref_api.VeerConfig(guidance="model", evs=c["evs"]),
                             mapping=c["mapping"])
        got = port_api.verify(P, Q, config, mapping=mapping)
        assert _outcome(got) == _outcome(ref), name


def test_default_registry_is_the_three_evs_and_copies_are_isolated():
    """The default registry holds the reference's roster, three symbolic EVs
    and the traced one, and copies of it are isolated."""
    reg = port_api.default_registry()
    assert reg.names() == list(EVS3) + ["jaxpr"] == list(ref_api.default_registry().names())
    mine = reg.copy()
    mine.register(SpesEV, replace=True, description="again")
    assert port_api.default_registry().spec("spes").description != "again"


# ---------------------------------------------------------------------------
# Def 2.2 equality and sink_results_equal
# ---------------------------------------------------------------------------


def _port_table(t):
    return Table(dict(t.cols), list(t.order))


EXECUTED = ("empty_filter", "filter_reorder", "filter_split_merge", "inequivalent_constant",
            "filter_past_aggregate", "projection_pushdown", "cert_witness", "ordered_sink_reorder")


@pytest.mark.parametrize("name", EXECUTED)
def test_sink_results_equal_matches_the_reference(name):
    """Both versions executed on seeded tables: the port's answer on the
    torch plane (CPU) and on numpy equals the reference's."""
    c, P, Q, _ = carried(name)
    from repro.engine import sink_results_equal as ref_sink_results_equal

    (sid,) = [o.id for o in c["P"].ops.values() if o.op_type == D.SOURCE]
    rng = np.random.default_rng(3)
    for _ in range(3):
        t = rand_table(rng)
        want = ref_sink_results_equal(c["P"], c["Q"], {sid: t})
        for plane in ("torch", "numpy"):
            got = sink_results_equal(P, Q, {sid: _port_table(t)}, plane=plane, device="cpu")
            assert got is want, plane
        if c["expected"] is True:
            assert want


@pytest.mark.parametrize("semantics", [D.ORDERED, D.BAG, D.SET])
def test_tables_equal_matches_the_reference_without_nan(semantics):
    rng = np.random.default_rng(5)
    base = {"a": rng.integers(0, 4, 40).astype(np.float64), "b": rng.integers(0, 3, 40)}
    variants = [base, {k: v[::-1] for k, v in base.items()},
                {k: np.concatenate([v, v[:5]]) for k, v in base.items()},
                {k: np.unique(base["a"]) if k == "a" else np.unique(base["a"]).astype(np.int64)
                 for k in base},
                {"a": base["a"] + 0.5, "b": base["b"]}]
    for x in variants:
        for y in variants:
            want = ref_tables_equal(RefTable(x, ["a", "b"]), RefTable(y, ["a", "b"]), semantics)
            assert tables_equal(Table(x, ["a", "b"]), Table(y, ["a", "b"]), semantics) is want


def test_tables_equal_ordered_takes_nan_pads_as_equal():
    """An outer join's NaN pads in an ORDERED sink: a table equals itself
    and a copy of itself (the reference's ``rows()`` comparison does not,
    which is why the port's ORDERED equality normalizes NaN)."""
    a = Table({"k": np.array([1.0, 2.0, 3.0]), "y": np.array([np.nan, 4.0, np.nan])}, ["k", "y"])
    b = Table({"k": a.cols["k"].copy(), "y": a.cols["y"].copy()}, ["k", "y"])
    c = Table({"k": a.cols["k"][::-1].copy(), "y": a.cols["y"][::-1].copy()}, ["k", "y"])
    d = Table({"k": a.cols["k"].copy(), "y": np.array([np.nan, 4.0, 5.0])}, ["k", "y"])
    for x, y, eq in ((a, a, True), (a, b, True), (a, c, False), (a, d, False)):
        assert tables_equal(x, y, D.ORDERED) is eq
        assert tables_equal(x, y, D.BAG) is (eq or y is c)


def test_bare_sink_results_equal_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(plane_registry, "_INSTANCES", {})
    _, P, Q, _ = carried("filter_reorder")
    t = _port_table(rand_table(np.random.default_rng(0)))
    with pytest.raises(PlaneError):
        sink_results_equal(P, Q, {"src": t})
    assert sink_results_equal(P, Q, {"src": t}, device="cpu")


# ---------------------------------------------------------------------------
# the chip check's pinned verdicts are the reference's
# ---------------------------------------------------------------------------


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("pair", ["split", "implied", "const", "dict"])
def test_chip_smoke_pinned_verdicts_are_the_references(pair):
    """chip_smoke.py's hot-chain pairs through the reference at a small
    row count: the verdict it pins is the reference's, and the sink
    equality it pins holds on the reference's execution and the port's."""
    from repro.api.serialize import dag_from_dict
    from repro_torch.core.serialize import dag_to_dict as port_dag_to_dict

    smoke = _chip_smoke()
    P = smoke.hot_chain()
    Q = smoke.verify_pairs(P)[pair]
    rP, rQ = dag_from_dict(port_dag_to_dict(P)), dag_from_dict(port_dag_to_dict(Q))
    ref = ref_api.verify(rP, rQ, ref_api.VeerConfig(evs=smoke.VERIFY_EVS))
    assert ref.verdict is smoke.VERIFY_EXPECTED[pair]
    port = port_api.verify(P, Q, port_api.VeerConfig(evs=smoke.VERIFY_EVS))
    assert _outcome(port) == _outcome(ref)

    sources = smoke.hot_sources(3000, seed=3)
    ref_sources = {k: RefTable(dict(t.cols), t.order) for k, t in sources.items()}
    rp, rq = ref_execute(rP, ref_sources), ref_execute(rQ, ref_sources)
    equal = all(tables_equal(_port_table(rp[s]), _port_table(rq[s]), P.ops[s].get("semantics"))
                for s in rp)
    assert equal is smoke.SINKS_EQUAL[pair]
    assert sink_results_equal(P, Q, sources, device="cpu") is smoke.SINKS_EQUAL[pair]
