"""The port's reuse layer against the reference package's, on the CPU.

The reuse frontier (``repro_torch.core.frontier``), execute-with-reuse
through ``VersionChainSession``, ``ReuseManager``, ``PairVerdictCache`` and
the synthetic chain (``repro_torch.service.synthetic.make_chain``), each held
to the reference package on the same pairs and seeded tables.  DAGs cross
through ``dag_to_dict`` and ``repro_torch.carry.from_reference``;
certificates cross as JSON.  The reference executes on ``plane="numpy"``,
the port on ``plane="torch", device="cpu"``: sinks must be byte-identical,
frontiers and counters equal.  The cases are those of
``tests/test_exec_reuse.py`` (frontier, sessions, reuse manager, the seeded
chain differential) and ``tests/test_concurrency.py`` (the pair cache).
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np
import pytest

from repro import api as ref_api
from repro.api.serialize import dag_to_dict as ref_dag_to_dict
from repro.core import dag as D
from repro.core.edits import EditMapping as RefEditMapping
from repro.core.edits import identity_mapping as ref_identity_mapping
from repro.core.frontier import compute_delta_plan as ref_compute_delta_plan
from repro.core.frontier import exact_frontier_map as ref_exact_frontier_map
from repro.core.predicates import LinCmp as RefLinCmp
from repro.core.predicates import LinExpr as RefLinExpr
from repro.core.predicates import Pred as RefPred
from repro.engine import DiskMaterializationStore as RefDiskStore
from repro.engine import InMemoryMaterializationStore as RefMemStore
from repro.engine import Table as RTable
from repro.engine import execute as ref_execute
from repro.engine import tables_equal as ref_tables_equal
from repro.reuse import ReuseManager as RefReuseManager
from repro.service import VersionChainSession as RefSession
from repro.service import verify_chain as ref_verify_chain
from repro.service.pair_cache import PairVerdictCache as RefPairVerdictCache
from repro.service.synthetic import make_chain as ref_make_chain

from repro_torch import api as port_api
from repro_torch.api import (
    Certificate,
    FrontierError,
    VeerConfig,
    compute_reuse_frontier,
    tampered,
    verify,
)
from repro_torch.core.edits import identity_mapping
from repro_torch.core.frontier import compute_delta_plan, exact_frontier_map
from repro_torch.api.serialize import dag_to_dict
from repro_torch.engine import (
    DiskMaterializationStore,
    InMemoryMaterializationStore,
    execute,
    table_digest,
)
from repro_torch.reuse import ReuseManager
from repro_torch.service import PairEntry, PairVerdictCache, VersionChainSession, verify_chain
from repro_torch.service.synthetic import make_chain

from test_torch_delta import (
    assert_same_bytes,
    build,
    carry_dag,
    carry_mapping,
    carry_sources,
    heavy_tail,
)

EVS3 = ("equitas", "spes", "udp")
CONFIG = VeerConfig(evs=EVS3)
REF_CONFIG = ref_api.VeerConfig(evs=EVS3)
TORCH = dict(plane="torch", device="cpu")
EXEC_COUNTERS = ("ops_total", "ops_executed", "ops_reused", "ops_skipped", "ops_delta",
                 "delta_rows_processed", "tables_served", "store_writes",
                 "store_dedup_skipped", "peak_live_tables", "freed_tables")
REUSE_COUNTERS = ("submissions", "sink_hits", "sink_misses", "executions",
                  "dedup_skipped_writes", "verdict_cache_hits", "certified_reuses",
                  "interior_hits", "ops_executed", "ops_reused")


# ---------------------------------------------------------------------------
# carrying across, and comparing
# ---------------------------------------------------------------------------
def carry_cert(cert):
    return None if cert is None else Certificate.from_json(cert.to_json())


def _sources_for(version, seed=0, n=120):
    rng = np.random.default_rng(seed)
    out = {}
    for sid in version.sources:
        schema = version.ops[sid].get("schema")
        out[sid] = RTable({c: rng.integers(-2, 7, n).astype(np.float64) for c in schema},
                          list(schema))
    return out


def assert_same_sinks(ref_results, port_results, what=""):
    assert set(ref_results) == set(port_results), what
    for s in ref_results:
        assert_same_bytes(ref_results[s], port_results[s], f"{what} sink {s}")


# ---------------------------------------------------------------------------
# the synthetic chain
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", range(2, 9))
def test_make_chain_equals_reference(n):
    for kw in ({}, {"heavy": True}, {"branches": 2}, {"branches": 3, "heavy": True}):
        ref, port = ref_make_chain(n, **kw), make_chain(n, **kw)
        assert len(port) == len(ref) == n
        for r, p in zip(ref, port):
            assert dag_to_dict(p) == ref_dag_to_dict(r)
            assert p.content_digest() == r.content_digest()
    with pytest.raises(ValueError):
        make_chain(1)


# ---------------------------------------------------------------------------
# frontier
# ---------------------------------------------------------------------------
def _dominated_pair():
    """Two versions whose edited filter is dominated by a later one (every
    threshold above 50 is implied by ``b < 50``): EQ and delta-amenable."""
    return (build(RefPred.cmp("b", "<", 80.0), extra=heavy_tail()),
            build(RefPred.cmp("b", "<", 74.0), extra=heavy_tail()))


def _frontier_pairs():
    light, heavy = ref_make_chain(3), ref_make_chain(6, heavy=True)
    pairs = {"chain3": (light[0], light[1])}
    for k in range(5):
        pairs[f"heavy{k}"] = (heavy[k], heavy[k + 1])
    pairs["dominated"] = _dominated_pair()
    return pairs


FRONTIER_PAIRS = sorted(_frontier_pairs())


@pytest.mark.parametrize("name", FRONTIER_PAIRS)
def test_frontier_equals_reference(name):
    P, Q = _frontier_pairs()[name]
    ref_result = ref_api.verify(P, Q, REF_CONFIG)
    assert ref_result.verdict is True
    ref_frontier = ref_api.compute_reuse_frontier(ref_result.certificate, P, Q)
    pP, pQ = carry_dag(P), carry_dag(Q)
    port_result = verify(pP, pQ, CONFIG)
    assert port_result.certificate.to_json() == ref_result.certificate.to_json()
    for cert in (port_result.certificate, carry_cert(ref_result.certificate)):
        frontier = compute_reuse_frontier(cert, pP, pQ)
        assert frontier.to_dict() == ref_frontier.to_dict()
        assert frontier.exact == ref_frontier.exact
        assert frontier.semantic == ref_frontier.semantic
        assert frontier.summary() == ref_frontier.summary()
        assert frontier.coverage(pQ) == ref_frontier.coverage(Q)
        assert frontier.exact == exact_frontier_map(pP, pQ, identity_mapping(pP, pQ))
        assert all(e.provenance for e in frontier.entries)
        assert frontier.pair_digest == cert.pair_digest
        plan, ref_plan = compute_delta_plan(frontier, pP, pQ), ref_compute_delta_plan(
            ref_frontier, P, Q)
        assert (plan is None) == (ref_plan is None)
        if plan is not None:
            assert plan.to_dict() == ref_plan.to_dict() and plan.exact == ref_plan.exact
    assert ref_frontier.exact == ref_exact_frontier_map(P, Q, ref_identity_mapping(P, Q))
    if name == "chain3":
        assert frontier.exact and frontier.semantic
        assert not set(frontier.semantic) & set(frontier.exact)
        assert all(e.provenance.startswith("window[") for e in frontier.entries
                   if e.tier == "semantic")
    if name == "dominated":
        assert plan is not None and plan.klass == "narrow"


def _adversarial(cert, P, Q):
    """tests/test_exec_reuse.py's certificates that must never widen the
    frontier: none, a False verdict, tampered, truncated, a foreign pair."""
    return {
        "none": (None, Q),
        "neq": (dataclasses.replace(cert, verdict=False, kind="witness"), Q),
        "tampered": (tampered(cert), Q),
        "truncated": (dataclasses.replace(cert, windows=cert.windows[:0]), Q),
        "foreign": (cert, carry_dag(ref_make_chain(4)[3])),
    }


@pytest.mark.parametrize("case", ["none", "neq", "tampered", "truncated", "foreign"])
def test_adversarial_certificates_never_widen_the_frontier(case):
    P, Q = ref_make_chain(3)[:2]
    ref_cert = ref_api.verify(P, Q, REF_CONFIG).certificate
    pP, pQ = carry_dag(P), carry_dag(Q)
    cert = carry_cert(ref_cert)
    assert len(compute_reuse_frontier(cert, pP, pQ)) > 0
    bad, q = _adversarial(cert, pP, pQ)[case]
    with pytest.raises(FrontierError):
        compute_reuse_frontier(bad, pP, q)
    # the same certificate is refused by the reference too
    ref_bad = None if bad is None else ref_api.Certificate.from_json(bad.to_json())
    ref_q = Q if q is pQ else ref_make_chain(4)[3]
    with pytest.raises(ref_api.FrontierError):
        ref_api.compute_reuse_frontier(ref_bad, P, ref_q)


# ---------------------------------------------------------------------------
# execute-with-reuse: sessions, held against the reference's
# ---------------------------------------------------------------------------
def _chain_both(versions, sources, semantics=D.BAG, *, stores=None, sources_per=None,
                mode="reuse"):
    """Submit the chain to a reference session and a port session; compare
    every report.  Returns both sessions."""
    ref_store, store = stores or (RefMemStore(), InMemoryMaterializationStore())
    ref = RefSession(config=REF_CONFIG.replace(semantics=semantics, exec_mode=mode),
                     materialization_store=ref_store)
    port = VersionChainSession(config=CONFIG.replace(semantics=semantics, exec_mode=mode),
                               materialization_store=store, device="cpu")
    sources_per = sources_per or [sources] * len(versions)
    for k, (v, src) in enumerate(zip(versions, sources_per)):
        a = ref.submit(v, sources=src)
        b = port.submit(carry_dag(v), sources=carry_sources(src))
        assert b.index == a.index == k
        assert b.verdict is a.verdict and b.certified == a.certified and b.reused == a.reused
        assert_same_sinks(a.results, b.results, f"v{k}")
        assert_same_sinks(ref_execute(v, src), b.results, f"v{k} full")
        for field in EXEC_COUNTERS:
            assert getattr(b.exec_stats, field) == getattr(a.exec_stats, field), (k, field)
        assert (b.frontier is None) == (a.frontier is None)
        if a.frontier is not None:
            assert b.frontier.to_dict() == a.frontier.to_dict()
        if a.certificate is not None:
            assert b.certificate.to_json() == a.certificate.to_json()
        if b.exec_stats.ops_reused:
            assert b.index == 0 or b.certified
    rr, pr = ref.report(), port.report()
    for attr in ("total_ops_executed", "total_ops_reused", "total_tables_served", "total_ops",
                 "total_ops_delta", "total_delta_rows_processed", "executed_fraction",
                 "certified_pairs", "verdicts"):
        assert getattr(pr, attr) == getattr(rr, attr), attr
    return ref, port


@pytest.mark.parametrize("semantics", [D.SET, D.BAG, D.ORDERED])
def test_execute_with_reuse_matches_reference(semantics):
    versions = ref_make_chain(5)
    _, port = _chain_both(versions, _sources_for(versions[0], seed=11), semantics)
    report = port.report()
    if semantics in (D.SET, D.BAG):
        assert report.total_ops_reused > 0 and report.total_tables_served > 0
        assert all(p.certified for p in report.pairs)
        assert report.executed_fraction < 1.0
    else:  # the roster answers Unknown for the swap under ORDERED: no reuse
        assert report.total_ops_reused == 0


def test_execute_with_reuse_disk_store_matches_reference(tmp_path):
    versions = ref_make_chain(4, heavy=True)
    stores = (RefDiskStore(tmp_path / "ref"), DiskMaterializationStore(tmp_path / "port"))
    _, port = _chain_both(versions, _sources_for(versions[0], seed=7), stores=stores)
    assert port.report().total_tables_served > 0


def test_inequivalent_version_falls_back_to_full_execution():
    versions = ref_make_chain(4)
    broken = versions[2].replace_op(
        versions[2].ops["fa1"].with_props(pred=RefPred.cmp("a", ">", 4)))
    versions = [versions[0], versions[1], broken, versions[3]]
    _, port = _chain_both(versions, _sources_for(versions[0], seed=5))
    pair = port.report().pairs[1]
    assert pair.verdict is not True and pair.frontier is None
    assert pair.exec_stats.ops_reused == 0


def test_rebound_source_never_serves_stale_tables():
    versions = ref_make_chain(3)
    s1 = _sources_for(versions[0], seed=1)
    s2 = dict(s1)
    sid = sorted(s2)[0]
    s2[sid] = RTable({c: s1[sid].cols[c] + 1.0 for c in s1[sid].order}, s1[sid].order)
    _chain_both(versions[:2], s1, sources_per=[s1, s2])


def test_first_version_report_and_chain_aggregates():
    versions = ref_make_chain(3)
    _, port = _chain_both(versions[:2], _sources_for(versions[0]))
    rep = port.report()
    assert rep.initial_exec is not None
    assert rep.initial_exec.ops_executed == rep.initial_exec.ops_total
    assert rep.total_ops == 2 * len(versions[0].ops)
    assert 0.0 < rep.executed_fraction < 1.0
    assert "exec:" in rep.summary()
    assert all(p.results is None for p in rep.pairs)


def test_verify_only_submit_contract_unchanged():
    versions = make_chain(4)
    session = VersionChainSession(config=CONFIG)
    assert session.submit(versions[0]) is None
    r = session.submit(versions[1])
    assert r.exec_stats is None and r.results is None
    with pytest.raises(ValueError):
        session.submit(versions[2], sources=carry_sources(_sources_for(versions[2])))
    r3 = session.submit(versions[2])
    assert r3.index == 2
    assert r3.certificate.kind == "decomposition"


@pytest.mark.parametrize("n", [3, 6])
def test_verify_chain_matches_reference(n):
    versions = ref_make_chain(n)
    ref = ref_verify_chain(versions, config=REF_CONFIG)
    port = verify_chain([carry_dag(v) for v in versions], config=CONFIG)
    assert port.verdicts == ref.verdicts
    assert port.certified_pairs == ref.certified_pairs == n - 1
    assert (port.total_ev_calls, port.total_cache_hits, port.total_ev_calls_saved) == (
        ref.total_ev_calls, ref.total_cache_hits, ref.total_ev_calls_saved)
    for a, b in zip(ref.pairs, port.pairs):
        assert b.certificate.to_json() == a.certificate.to_json()
    with pytest.raises(ValueError):
        verify_chain([carry_dag(v) for v in versions], mappings=[None], config=CONFIG)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_seeded_randomized_chain_differential(seed):
    rng = np.random.default_rng(seed)
    n_versions = int(rng.integers(2, 5))
    branches = int(rng.integers(1, 4))
    semantics = [D.SET, D.BAG, D.ORDERED][seed % 3]
    versions = ref_make_chain(n_versions, branches=branches)
    _chain_both(versions, _sources_for(versions[0], seed=seed + 100, n=60), semantics)


@pytest.mark.parametrize("mode", ["full", "reuse", "delta"])
def test_heavy_chain_in_every_mode_matches_reference(mode):
    versions = ref_make_chain(5, heavy=True)
    _, port = _chain_both(versions, _sources_for(versions[0], seed=21, n=400), mode=mode)
    pairs = port.report().pairs
    if mode == "full":
        assert all(p.exec_stats.ops_reused == 0 for p in pairs)
    else:
        assert all(p.exec_stats.ops_reused > 0 for p in pairs)


def test_torch_plane_session_certificates_replay_in_both_packages():
    """A 6-version session of the heavy chain on the torch plane: every
    successor is EQ and certified, and every certificate replays green with
    the port's registry and, after JSON, with the reference's."""
    ref_versions = ref_make_chain(6, heavy=True)
    sources = carry_sources(_sources_for(ref_versions[0], seed=3, n=200))
    versions = make_chain(6, heavy=True)
    session = VersionChainSession(config=CONFIG,
                                  materialization_store=InMemoryMaterializationStore(),
                                  device="cpu")
    reports = [session.submit(v, sources=sources) for v in versions]
    assert session.plane == "torch"
    for k, r in enumerate(reports[1:], start=1):
        assert r.verdict is True and r.certified
        assert r.certificate.replay(port_api.default_registry(), versions[k - 1], versions[k]).ok
        assert r.certificate.replay().ok
        theirs = ref_api.Certificate.from_json(r.certificate.to_json())
        assert theirs.replay(P=ref_versions[k - 1], Q=ref_versions[k]).ok
        assert theirs.replay().ok
        assert r.exec_stats.ops_reused > 0
        for s, table in execute(versions[k], sources, plane="numpy").items():
            assert table_digest(table) == table_digest(r.results[s])


# ---------------------------------------------------------------------------
# ReuseManager
# ---------------------------------------------------------------------------
def _managers(tmp_path):
    ref = RefReuseManager(str(tmp_path / "ref"), config=REF_CONFIG)
    port = ReuseManager(str(tmp_path / "port"), config=CONFIG, device="cpu")
    assert port.plane == "torch"
    return ref, port


def _submit_both(ref, port, dag, sources):
    a = ref.submit(dag, sources)
    b = port.submit(carry_dag(dag), carry_sources(sources))
    for field in REUSE_COUNTERS:
        assert getattr(port.stats, field) == getattr(ref.stats, field), field
    return a, b


def test_reuse_manager_digest_and_interior_hits(tmp_path):
    ref, port = _managers(tmp_path)
    dag = ref_make_chain(2)[0]
    sources = _sources_for(dag, seed=2)
    a, b = _submit_both(ref, port, dag, sources)
    assert_same_sinks(a, b)
    assert port.stats.executions == 1
    verify_time = port.stats.verify_time
    a, b = _submit_both(ref, port, dag, sources)  # served off content digests
    assert_same_sinks(a, b)
    assert port.stats.verify_time == verify_time and port.stats.executions == 1
    edited = dag.replace_op(dag.ops["proj0"].with_props(cols=(("a", "a"), ("b", "b"))))
    executed, interior = port.stats.ops_executed, port.stats.interior_hits
    a, b = _submit_both(ref, port, edited, sources)
    assert_same_sinks(ref_execute(edited, sources), b)
    assert 0 < port.stats.ops_executed - executed < len(edited.ops)
    assert port.stats.interior_hits > interior
    moved = {k: RTable({c: v.cols[c] + 1.0 for c in v.order}, v.order)
             for k, v in sources.items()}
    a, b = _submit_both(ref, port, dag, moved)
    assert_same_sinks(ref_execute(dag, moved), b)


def test_reuse_manager_semantic_serving_is_certificate_backed(tmp_path):
    ref, port = _managers(tmp_path)
    v1, v2 = ref_make_chain(2)
    sources = _sources_for(v1, seed=9)
    _submit_both(ref, port, v1, sources)
    hits = port.stats.sink_hits
    a, b = _submit_both(ref, port, v2, sources)
    assert_same_sinks(a, b)
    assert port.stats.sink_hits > hits and port.stats.certified_reuses >= 1
    (vid, prev_vid, cert), (rvid, rprev, rcert) = port.certificates[-1], ref.certificates[-1]
    assert (vid, prev_vid) == (rvid, rprev) and cert.to_json() == rcert.to_json()
    assert cert.replay(P=carry_dag(v1), Q=carry_dag(v2)).ok
    fresh = ref_execute(v2, sources)
    assert all(ref_tables_equal(fresh[s], RTable(b[s].cols, b[s].order), D.BAG) for s in fresh)
    assert port.stats.recompute_time_saved >= 0.0


# ---------------------------------------------------------------------------
# PairVerdictCache: tests/test_concurrency.py's cases, and the reference's keys
# ---------------------------------------------------------------------------
def test_pair_cache_single_flight_coalesces():
    cache = PairVerdictCache()
    key = ("digest", None)
    computed, results = [], []
    barrier = threading.Barrier(4)

    def worker():
        barrier.wait()
        entry, owner = cache.acquire(key)
        if owner:
            computed.append(1)
            entry = PairEntry(True, None, 3, 0.1)
            cache.publish(key, entry)
        results.append(entry)

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(computed) == 1
    assert all(r is None or r.verdict is True for r in results)
    stats = cache.stats()
    assert stats["misses"] == 1
    assert stats["hits"] + stats["coalesced"] == 3


def test_pair_cache_abandoned_key_disables_coalescing():
    cache = PairVerdictCache()
    key = ("digest", None)
    _, owner = cache.acquire(key)
    assert owner
    cache.abandon(key)
    e1, o1 = cache.acquire(key)
    e2, o2 = cache.acquire(key)
    assert (e1, o1) == (None, True) and (e2, o2) == (None, True)
    cache.publish(key, PairEntry(True, None, 1, 0.1))
    entry, owner = cache.acquire(key)
    assert not owner and entry.verdict is True


def test_pair_cache_is_bounded():
    cache = PairVerdictCache(max_entries=3)
    for i in range(10):
        key = (f"digest{i}", None)
        _, owner = cache.acquire(key)
        assert owner
        cache.publish(key, PairEntry(True, None, 1, 0.1))
    assert len(cache) == 3
    assert cache.peek(("digest9", None)) is not None
    assert cache.peek(("digest0", None)) is None


def test_pair_cache_abandon_hands_off_to_a_waiter():
    cache = PairVerdictCache()
    key = ("digest", None)
    entry, owner = cache.acquire(key)
    assert owner and entry is None
    got = []

    def waiter():
        e, own = cache.acquire(key)
        if own:
            cache.publish(key, PairEntry(False, None, 0, 0.0))
            e = cache.peek(key)
        got.append(e)

    t = threading.Thread(target=waiter)
    t.start()
    cache.abandon(key)
    t.join(timeout=5)
    assert not t.is_alive()
    assert got and got[0].verdict is False


def _key_pairs():
    chain = ref_make_chain(4)
    scaled = chain[0].replace_op(chain[0].ops["fa0"].with_props(
        pred=RefPred.of(RefLinCmp(RefLinExpr.make({"a": -2}, 4), "<"))))
    return {
        "chain": (chain[0], chain[1], None),
        "same": (chain[2], chain[2], None),
        "scaled": (chain[0], scaled, None),
        "mapping": (chain[1], chain[2], RefEditMapping.make({o: o for o in chain[1].ops})),
    }


@pytest.mark.parametrize("name", ["chain", "same", "scaled", "mapping"])
@pytest.mark.parametrize("semantics", [D.BAG, D.ORDERED])
def test_pair_cache_keys_equal_reference(name, semantics):
    P, Q, mapping = _key_pairs()[name]
    want = RefPairVerdictCache.make_key(P, Q, semantics, mapping)
    got = PairVerdictCache.make_key(carry_dag(P), carry_dag(Q), semantics, carry_mapping(mapping))
    assert got == want
    if name in ("same", "scaled"):
        assert (got[1] is not None) == (P.content_digest() == Q.content_digest())


def test_session_pair_cache_reuses_certificate():
    """Two port sessions share one ``PairVerdictCache``: the second answers
    every pair from it, with the first's certificate bytes."""
    versions = make_chain(4)
    cache = PairVerdictCache()
    first = VersionChainSession(config=CONFIG, pair_cache=cache)
    second = VersionChainSession(config=CONFIG, pair_cache=cache)
    a = [first.submit(v) for v in versions][1:]
    b = [second.submit(v) for v in versions][1:]
    assert all(r.reused for r in b) and not any(r.reused for r in a)
    assert [r.certificate.to_json() for r in b] == [r.certificate.to_json() for r in a]
    assert cache.stats()["hits"] == len(b)
