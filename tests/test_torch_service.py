"""The port's verification service and its shared cache tier
(``repro_torch.service.server``, ``repro_torch.service.remote``) on the CPU.

The cases of ``tests/test_service_server.py`` (ordering, reuse,
backpressure, errors), of ``tests/test_concurrency.py`` (thread-safe
caches, atomic saves, parallel window dispatch) and the tier cases of
``tests/test_fleet_faults.py`` (damaged entries, forged payloads, leases,
refcounts, TTL and byte budgets) run here against the port, with every
executing session at ``device="cpu"``.  Where the reference package answers
the same question, the port must give its bytes: a service's verdicts and
certificates are the reference's sequential session's.
"""

import json
import os
import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest

from helpers import SCHEMA
from repro import api as ref_api
from repro.service import VersionChainSession as RefSession
from repro.service.synthetic import make_chain as ref_make_chain

from repro_torch.api import ConfigError, VeerConfig, verify
from repro_torch.api.certificate import certificate_from_evidence
from repro_torch.core import dag as D
from repro_torch.core.dag import DataflowDAG, Link, Operator
from repro_torch.core.ev.cache import VerdictCache
from repro_torch.core.predicates import Pred
from repro_torch.engine import InMemoryMaterializationStore, PlaneError, execute
from repro_torch.engine.store import table_digest
from repro_torch.engine.table import Table, tables_identical
from repro_torch.service import (
    ServiceBusy,
    ServiceClosed,
    VerificationService,
    VersionChainSession,
)
from repro_torch.service.pair_cache import PairEntry, PairVerdictCache
from repro_torch.service.remote import FileTier, TieredPairCache, make_tier
from repro_torch.service.remote.adapters import TieredMaterializationStore, _tier_pair_key
from repro_torch.service.remote.tier import LocalTier, PairRecord
from repro_torch.service.server import _Job
from repro_torch.service.synthetic import make_chain

EVS3 = ("equitas", "spes", "udp")
CONFIG = VeerConfig(evs=EVS3)
FLEET_CONFIG = VeerConfig(evs=EVS3, max_decompositions=300)
op = Operator.make


def _sequential(chain):
    session = VersionChainSession(config=CONFIG)
    for v in chain:
        session.submit(v)
    return session.report()


def _reference_sequential(n):
    session = RefSession(config=ref_api.VeerConfig(evs=EVS3))
    for v in ref_make_chain(n):
        session.submit(v)
    return session.report()


def _gated(svc):
    """Occupy the service's only worker until the returned event is set."""
    gate = threading.Event()
    blocker = _Job(client=None, ticket=0, fn=lambda: gate.wait(30), future=Future())
    with svc._lock:
        svc._pending += 1  # manual enqueue bypasses _enqueue's accounting
    svc._queue.put(blocker)
    return gate


def _chain_sources(version, n=200, seed=0):
    rng = np.random.default_rng(seed)
    return {sid: Table({c: rng.integers(0, 7, n).astype(np.float64) for c in SCHEMA},
                       list(SCHEMA)) for sid in sorted(version.sources)}


# ---------------------------------------------------------------------------
# VerificationService
# ---------------------------------------------------------------------------


def test_service_matches_the_references_sequential_session():
    chain = make_chain(6)
    ref = _reference_sequential(6)
    with VerificationService(config=CONFIG, workers=4, device="cpu") as svc:
        for v in chain:  # round-robin across clients
            for c in range(3):
                svc.submit(f"c{c}", v)
        report = svc.drain()
    assert not report.errors and len(report.sessions) == 3
    for chain_report in report.sessions.values():
        assert chain_report.verdicts == ref.verdicts == _sequential(chain).verdicts
        assert [p.certificate.to_json() for p in chain_report.pairs] == \
            [p.certificate.to_json() for p in ref.pairs]
        assert all(p.certified and p.certificate.replay().ok for p in chain_report.pairs)


def test_service_executes_on_the_torch_plane_like_a_session():
    chain = make_chain(4, heavy=True)
    sources = _chain_sources(chain[0])
    config = CONFIG.replace(exec_mode="delta")
    want = [execute(v, sources, plane="numpy") for v in chain]
    store = InMemoryMaterializationStore()
    with VerificationService(config=config, workers=2, device="cpu",
                             materialization_store=store) as svc:
        assert svc.session("a").device == "cpu" and svc.session("a").plane == "torch"
        futs = {c: [svc.submit(c, v, sources=sources) for v in chain] for c in "ab"}
        report = svc.drain()
    assert not report.errors
    for c, fs in futs.items():
        for k, f in enumerate(fs):
            r = f.result(timeout=60)
            assert r.exec_stats.plane == "torch"
            assert all(tables_identical(want[k][s], r.results[s]) for s in want[k])
            if k:
                assert r.verdict is True and r.certificate.replay(P=chain[k - 1], Q=chain[k]).ok
    assert any(f.result().exec_stats.ops_reused for f in futs["b"][1:])


def test_service_defaults_to_cuda_and_fails_the_future_without_it(monkeypatch):
    from repro_torch.engine import plane as plane_registry
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(plane_registry, "_INSTANCES", {})
    chain = make_chain(2)
    with VerificationService(config=CONFIG, workers=1,
                             materialization_store=InMemoryMaterializationStore()) as svc:
        assert svc.device == "cuda" and svc.session("c").device == "cuda"
        bad = svc.submit("c", chain[0], sources=_chain_sources(chain[0]))
        with pytest.raises(PlaneError):
            bad.result(timeout=60)
        assert svc.submit("v", chain[0]).result(timeout=60) is None  # verifying needs none
        assert svc.submit("v", chain[1]).result(timeout=60).verdict is True
        report = svc.drain()
    assert len(report.errors) == 1


def test_per_client_submission_order_is_preserved():
    chain = make_chain(8)
    with VerificationService(config=CONFIG, workers=8, device="cpu") as svc:
        futures = [svc.submit("solo", v) for v in chain]
        report = svc.drain()
    assert futures[0].result(timeout=60) is None
    assert [f.result(timeout=60).index for f in futures[1:]] == list(range(1, len(chain)))
    assert report.sessions["solo"].verdicts == _sequential(chain).verdicts


def test_cross_client_pair_reuse_and_ev_sharing():
    chain = make_chain(6)
    with VerificationService(config=CONFIG, workers=2, device="cpu") as svc:
        for c in range(4):
            for v in chain:
                svc.submit(f"c{c}", v)
        report = svc.drain()
    assert not report.errors
    assert report.reused_pairs >= 2 * (len(chain) - 1)
    assert report.pair_cache_stats["hits"] == report.reused_pairs
    for chain_report in report.sessions.values():
        for p in chain_report.pairs:
            if p.reused:
                assert p.certificate is not None and p.certificate.replay().ok


def test_submit_pair_one_shot():
    chain = make_chain(4)
    with VerificationService(config=CONFIG, workers=2, device="cpu") as svc:
        f1 = svc.submit_pair(chain[0], chain[1])
        f2 = svc.submit_pair(chain[0], chain[1])  # duplicate: coalesces
        r1, r2 = f1.result(timeout=60), f2.result(timeout=60)
    assert r1.equivalent and r2.equivalent
    assert r1.certificate.to_json() == r2.certificate.to_json()
    ref = ref_api.verify(*ref_make_chain(4)[:2], ref_api.VeerConfig(evs=EVS3))
    assert r1.certificate.to_json() == ref.certificate.to_json()
    assert int(r1.reused) + int(r2.reused) == 1


def test_backpressure_raises_service_busy_without_blocking():
    chain = make_chain(3)
    svc = VerificationService(config=CONFIG, workers=1, queue_size=1, device="cpu")
    gate = _gated(svc)
    try:
        f0 = svc.submit("c", chain[0])
        with pytest.raises(ServiceBusy):
            svc.submit("c", chain[1], block=False)
        gate.set()
        f1 = svc.submit("c", chain[1])
        report = svc.drain()
        assert f0.result(timeout=60) is None
        assert f1.result(timeout=60).index == 1 and f1.result().verdict is True
        assert report.sessions["c"].verdicts == [True]
        assert report.errors == []
    finally:
        gate.set()
        svc.close(save=False)


def test_job_error_is_isolated_to_its_future():
    chain = make_chain(4)
    with VerificationService(config=CONFIG, workers=2, device="cpu") as svc:
        bad = svc.submit("c", "not a dag")  # type: ignore[arg-type]
        with pytest.raises(Exception):
            bad.result(timeout=60)
        ok = [svc.submit("c", v) for v in chain]
        report = svc.drain()
    assert ok[0].result(timeout=60) is None
    assert all(f.result(timeout=60) is not None for f in ok[1:])
    assert len(report.errors) == 1


def test_cancelled_future_is_skipped_and_workers_survive():
    chain = make_chain(4)
    svc = VerificationService(config=CONFIG, workers=1, device="cpu")
    gate = _gated(svc)
    try:
        f0 = svc.submit("c", chain[0])
        f1 = svc.submit("c", chain[1])
        assert f1.cancel()
        gate.set()
        f2 = svc.submit("c", chain[2])
        report = svc.drain()
        assert f0.result(timeout=60) is None
        assert f2.result(timeout=60).index == 1
        assert report.errors == [] and len(report.sessions["c"].pairs) == 1
    finally:
        gate.set()
        svc.close(save=False)


def test_submit_after_close_raises():
    svc = VerificationService(config=CONFIG, workers=1, device="cpu")
    svc.close(save=False)
    with pytest.raises(ServiceClosed):
        svc.submit("c", make_chain(2)[0])
    with pytest.raises(ServiceClosed):
        svc.submit_pair(*make_chain(2)[:2])


def test_shared_verdict_cache_persists_atomically(tmp_path):
    chain = make_chain(5)
    cfg = CONFIG.replace(cache_path=str(tmp_path / "verdicts.json"))
    with VerificationService(config=cfg, workers=2, device="cpu") as svc:
        for v in chain:
            svc.submit("c", v)
        first = svc.drain()
    assert first.total_ev_calls > 0
    with VerificationService(config=cfg, workers=2, device="cpu") as svc2:
        for v in chain:
            svc2.submit("c", v)
        warm = svc2.drain()
    assert warm.total_ev_calls == 0
    assert all(p.certified for r in warm.sessions.values() for p in r.pairs)


def test_drain_is_repeatable_and_concurrent_with_submits():
    chain = make_chain(4)
    with VerificationService(config=CONFIG, workers=2, device="cpu") as svc:
        for v in chain:
            svc.submit("a", v)
        r1 = svc.drain()
        for v in chain:
            svc.submit("b", v)
        r2 = svc.drain()
    assert len(r1.sessions) == 1 and len(r2.sessions) == 2
    assert r2.sessions["b"].verdicts == r1.sessions["a"].verdicts


def test_concurrent_submitters_same_client_never_deadlock():
    chain = make_chain(5)
    svc = VerificationService(config=CONFIG, workers=2, queue_size=4, device="cpu")
    try:
        def burst():
            for v in chain:
                svc.submit("c", v, timeout=60)

        threads = [threading.Thread(target=burst) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        report = svc.drain()
        assert len(report.sessions["c"].pairs) == 19
    finally:
        svc.close(save=False)


def test_ticket_gate_under_many_threads_submitting():
    chain = make_chain(6)
    svc = VerificationService(config=CONFIG, workers=4, device="cpu")
    lock = threading.Lock()
    idx = [0]

    def producer():
        while True:
            with lock:
                i = idx[0]
                if i >= len(chain):
                    return
                idx[0] += 1
                svc.submit("shared", chain[i])

    threads = [threading.Thread(target=producer) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    report = svc.drain()
    svc.close(save=False)
    assert report.sessions["shared"].verdicts == _sequential(chain).verdicts


# ---------------------------------------------------------------------------
# concurrency: caches, atomic saves, parallel window dispatch
# ---------------------------------------------------------------------------


def test_verdict_cache_concurrent_put_get_no_lost_updates(tmp_path):
    cache = VerdictCache(str(tmp_path / "verdicts.json"))
    n_threads, per_thread = 8, 200
    errors = []

    def hammer(t):
        try:
            for i in range(per_thread):
                cache.put(f"ev{t}", f"fp{i}", i % 3 == 0, 0.001 * i)
                cache.get(f"ev{(t + 1) % n_threads}", f"fp{i}")
                if i % 50 == 0:
                    cache.save()
        except Exception as e:  # pragma: no cover - the assertion is the point
            errors.append(e)

    threads = [threading.Thread(target=hammer, args=(t,)) for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and not any(t.is_alive() for t in threads)
    assert len(cache) == n_threads * per_thread
    cache.save()
    assert len(VerdictCache(str(tmp_path / "verdicts.json"))) == n_threads * per_thread


def test_verdict_cache_concurrent_saves_never_torn(tmp_path):
    path = tmp_path / "verdicts.json"
    cache = VerdictCache(str(path))
    stop = threading.Event()
    bad = []

    def writer():
        i = 0
        while not stop.is_set():
            cache.put("ev", f"fp{i}", True, 0.01)
            cache.save()
            i += 1

    def reader():
        while not stop.is_set():
            if not path.exists():
                continue
            try:
                json.loads(path.read_text())
            except json.JSONDecodeError as e:
                bad.append(e)

    threads = [threading.Thread(target=writer) for _ in range(2)] + [
        threading.Thread(target=reader) for _ in range(2)]
    for t in threads:
        t.start()
    time.sleep(0.5)
    stop.set()
    for t in threads:
        t.join(timeout=60)
    assert not bad, f"reader saw a torn cache file: {bad[0]}"


def test_save_partial_write_leaves_previous_snapshot(tmp_path, monkeypatch):
    path = tmp_path / "verdicts.json"
    cache = VerdictCache(str(path))
    cache.put("ev", "fp-old", True, 0.5)
    cache.save()
    before = path.read_text()
    cache.put("ev", "fp-new", False, 0.1)

    def exploding_dump(obj, fh, *a, **kw):
        fh.write('{"version":')
        raise OSError("disk full")

    monkeypatch.setattr(json, "dump", exploding_dump)
    with pytest.raises(OSError):
        cache.save()
    monkeypatch.undo()
    assert path.read_text() == before
    assert [p.name for p in tmp_path.iterdir()] == ["verdicts.json"]
    cache.save()
    assert ("ev", "fp-new") in VerdictCache(str(path))


@pytest.mark.parametrize("workers", [3, 4])
def test_parallel_dispatch_matches_sequential_along_a_chain(workers):
    chain = make_chain(8)
    for a, b in zip(chain, chain[1:]):
        seq = verify(a, b, CONFIG)
        par = verify(a, b, CONFIG.replace(max_workers=workers))
        assert seq.verdict == par.verdict
        assert (seq.certificate is None) == (par.certificate is None)
        if seq.certificate is not None:
            assert seq.certificate.to_json() == par.certificate.to_json()


def test_parallel_dispatch_inequivalent_pair():
    def build(thresh):
        return DataflowDAG(
            [op("src", D.SOURCE, schema=SCHEMA),
             op("flt", D.FILTER, pred=Pred.cmp("a", ">", thresh)),
             op("sink", D.SINK, semantics=D.BAG)],
            [Link("src", "flt"), Link("flt", "sink")])

    P, Q = build(2), build(3)
    seq = verify(P, Q, CONFIG)
    par = verify(P, Q, CONFIG.replace(max_workers=4))
    assert seq.verdict is False and par.verdict is False
    assert seq.certificate.to_json() == par.certificate.to_json()


def test_max_workers_validation():
    with pytest.raises(ConfigError):
        VeerConfig(max_workers=0).validate()
    cfg = VeerConfig(max_workers=2)
    assert VeerConfig.from_json(cfg.to_json()) == cfg


def test_pair_cache_single_flight_coalesces():
    cache = PairVerdictCache()
    key = ("digest", None)
    computed, results = [], []
    barrier = threading.Barrier(4)

    def worker():
        barrier.wait(timeout=30)
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
        t.join(timeout=60)
    assert len(computed) == 1
    assert all(r is None or r.verdict is True for r in results)
    stats = cache.stats()
    assert stats["misses"] == 1 and stats["hits"] + stats["coalesced"] == 3


def test_pair_cache_abandon_hands_off_to_a_waiter():
    cache = PairVerdictCache()
    key = ("digest", None)
    assert cache.acquire(key) == (None, True)
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


# ---------------------------------------------------------------------------
# the shared tier: damaged entries, forged payloads, leases, refcounts
# ---------------------------------------------------------------------------


def _table(seed=0, n=40):
    rng = np.random.default_rng(seed)
    return Table({"a": rng.integers(-5, 9, n).astype(np.float64),
                  "b": np.array([f"s{i % 7}" for i in range(n)], dtype=object)}, ["a", "b"])


def _entry_files(tier, namespace):
    return sorted((tier.dir / namespace).glob("*.json"))


def test_truncated_and_corrupt_entries_read_as_counted_misses(tmp_path):
    tier = FileTier(str(tmp_path))
    tier.put_verdict("equitas", "fp1", True, 0.4)
    tier.put_pair("k1", PairRecord(True, None, 3, 0.2))
    tier.put_validity("spes", "fp2", True)
    for namespace in ("verdicts", "pairs", "validity"):
        (path,) = _entry_files(tier, namespace)
        path.write_text(path.read_text()[: len(path.read_text()) // 2])
    before = tier.corrupt_entries_skipped
    assert tier.get_verdict("equitas", "fp1") is None
    assert tier.get_pair("k1") is None
    assert tier.get_validity("spes", "fp2") is None
    assert tier.corrupt_entries_skipped == before + 3
    for namespace in ("verdicts", "pairs", "validity"):
        assert not _entry_files(tier, namespace)


def test_entry_keyed_for_different_key_is_rejected(tmp_path):
    tier = FileTier(str(tmp_path))
    tier.put_verdict("equitas", "fp-a", False, 0.1)
    (path,) = _entry_files(tier, "verdicts")
    rec = json.loads(path.read_text())
    rec["k"] = ["equitas", "fp-OTHER"]
    path.write_text(json.dumps(rec))
    assert tier.get_verdict("equitas", "fp-a") is None
    assert tier.corrupt_entries_skipped >= 1


def test_truncated_table_payload_reads_as_miss(tmp_path):
    tier = FileTier(str(tmp_path))
    t = _table(1)
    tier.put_table("mat:k1", t, 0.7)
    (npz,) = sorted((tier.dir / "objects").glob("*.npz"))
    npz.write_bytes(npz.read_bytes()[:20])
    assert tier.get_table("mat:k1") is None
    assert tier.corrupt_entries_skipped >= 1
    tier.put_table("mat:k1", t, 0.7)
    got = tier.get_table("mat:k1")
    assert got is not None and tables_identical(got[0], t)


def test_swapped_payload_bytes_fail_digest_check(tmp_path):
    tier = FileTier(str(tmp_path))
    t1, t2 = _table(1), _table(2)
    tier.put_table("k1", t1)
    tier.put_table("k2", t2)
    d1, d2 = table_digest(t1), table_digest(t2)
    obj = tier.dir / "objects"
    (obj / f"{d1}.npz").write_bytes((obj / f"{d2}.npz").read_bytes())
    (obj / f"{d1}.meta.json").write_text((obj / f"{d2}.meta.json").read_text())
    assert tier.get_table("k1") is None
    assert tier.digest_rejections == 1
    got = tier.get_table("k2")
    assert got is not None and tables_identical(got[0], t2)


def test_payload_write_cost_is_counted_once_per_payload(tmp_path):
    tier = FileTier(str(tmp_path))
    t = _table(9, n=500)
    tier.put_table("k1", t)
    tier.put_table("k2", t)  # same content: no second payload write
    stats = tier.stats()
    (npz,) = sorted((tier.dir / "objects").glob("*.npz"))
    assert stats["payload_bytes_written"] == npz.stat().st_size
    assert stats["payload_write_seconds"] > 0


def test_garbage_lease_file_still_excludes(tmp_path):
    tier = FileTier(str(tmp_path))
    lease = tier.lease("pair:x")
    lease.acquire(block=False)
    lease.release()
    for p in (tier.dir / "leases").glob("*.lock"):
        p.write_bytes(b"\x00garbage\xff" * 7)
    a, b = tier.lease("pair:x"), tier.lease("pair:x")
    assert a.acquire(block=False)
    assert not b.acquire(block=False)
    a.release()
    assert b.acquire(block=False)
    b.release()


def _pair_compute(veer, P, Q):
    def compute():
        verdict, stats, evidence = veer.verify_with_evidence(P, Q, None,
                                                             semantics=FLEET_CONFIG.semantics)
        return verdict, stats, certificate_from_evidence(evidence)
    return compute


def _must_not_compute():
    raise AssertionError("must not compute")


def test_tampered_pair_certificate_is_recomputed_not_served(tmp_path):
    chain = make_chain(3)
    P, Q = chain[0], chain[1]
    veer = FLEET_CONFIG.build(None)
    compute = _pair_compute(veer, P, Q)
    tier = FileTier(str(tmp_path))
    key = TieredPairCache.make_key(P, Q, FLEET_CONFIG.semantics, None)
    tkey = _tier_pair_key(key)
    verdict0, _, cert0, reused0 = TieredPairCache(tier).compute_or_reuse(key, compute,
                                                                          pair=(P, Q))
    assert reused0 is False and verdict0 is not None and cert0 is not None
    served = TieredPairCache(tier)
    verdict1, _, cert1, reused1 = served.compute_or_reuse(key, _must_not_compute, pair=(P, Q))
    assert reused1 is True and verdict1 == verdict0
    assert cert1.to_json() == cert0.to_json() and served.tier_hits == 1
    _, _, other_ev = veer.verify_with_evidence(chain[1], chain[2], None,
                                               semantics=FLEET_CONFIG.semantics)
    tier.put_pair(tkey, PairRecord(verdict0, certificate_from_evidence(other_ev).to_json(),
                                   1, 0.1))
    gated = TieredPairCache(tier)
    verdict2, _, cert2, reused2 = gated.compute_or_reuse(key, compute, pair=(P, Q))
    assert reused2 is False and gated.tier_replay_rejections == 1
    assert verdict2 == verdict0 and cert2.to_json() == cert0.to_json()
    tier.put_pair(tkey, PairRecord(verdict0, None, 1, 0.1))
    bare = TieredPairCache(tier)
    assert bare.compute_or_reuse(key, compute, pair=(P, Q))[3] is False
    assert bare.tier_replay_rejections == 1


def test_local_tier_pair_hits_served_without_replay():
    chain = make_chain(3)
    P, Q = chain[0], chain[1]
    tier = LocalTier()
    key = TieredPairCache.make_key(P, Q, FLEET_CONFIG.semantics, None)
    verdict0 = TieredPairCache(tier).compute_or_reuse(
        key, _pair_compute(FLEET_CONFIG.build(None), P, Q), pair=(P, Q))[0]
    second = TieredPairCache(tier)
    verdict1, _, _, reused = second.compute_or_reuse(key, _must_not_compute, pair=(P, Q))
    assert reused is True and verdict1 == verdict0 and second.tier_replay_rejections == 0


def test_tiered_store_serves_the_tiers_tables_to_a_fresh_process_view(tmp_path):
    t = _table(7)
    TieredMaterializationStore(FileTier(str(tmp_path))).put("k", t, 0.3)
    fresh = TieredMaterializationStore(FileTier(str(tmp_path)))
    got = fresh.get("k")
    assert got is not None and tables_identical(got, t)
    assert fresh.stats()["tier_hits"] == 1


def test_stale_refcount_never_frees_live_materialization(tmp_path):
    tier = FileTier(str(tmp_path))
    t = _table(3)
    tier.put_table("k1", t)
    tier.put_table("k2", t)
    d = table_digest(t)
    (tier.dir / "objects" / f"{d}.refs").write_text('{"count": 0}')
    tier.release_table("k2")
    got = tier.get_table("k1")
    assert got is not None and tables_identical(got[0], t)
    assert (tier.dir / "objects" / f"{d}.npz").exists()


def test_double_release_never_frees_live_materialization(tmp_path):
    tier = FileTier(str(tmp_path))
    t = _table(4)
    tier.put_table("k1", t)
    tier.put_table("k2", t)
    for _ in range(3):
        tier.release_table("k2")
    got = tier.get_table("k1")
    assert got is not None and tables_identical(got[0], t)
    tier.release_table("k1")
    assert tier.get_table("k1") is None
    assert not list((tier.dir / "objects").glob("*.npz"))


def test_corrupt_refcount_file_resyncs_from_live_scan(tmp_path):
    tier = FileTier(str(tmp_path))
    t = _table(5)
    tier.put_table("k1", t)
    tier.put_table("k2", t)
    d = table_digest(t)
    (tier.dir / "objects" / f"{d}.refs").write_text("not json at all")
    tier.release_table("k2")
    assert tier.get_table("k1") is not None
    assert json.loads((tier.dir / "objects" / f"{d}.refs").read_text())["count"] == 1


def test_expired_entries_read_as_counted_misses(tmp_path):
    tier = FileTier(str(tmp_path), ttl_seconds=60.0)
    tier.put_verdict("equitas", "fp", True, 0.1)
    tier.put_pair("pk", PairRecord(True, None, 1, 0.1))
    stale = time.time() - 3600
    for namespace in ("verdicts", "pairs"):
        for p in (tier.dir / namespace).glob("*.json"):
            os.utime(p, (stale, stale))
    assert tier.get_verdict("equitas", "fp") is None
    assert tier.get_pair("pk") is None
    assert tier.expired_entries == 2


def test_sweep_expires_tables_and_releases_refcounts(tmp_path):
    tier = FileTier(str(tmp_path), ttl_seconds=60.0)
    tier.put_table("k1", _table(6))
    stale = time.time() - 3600
    for p in (tier.dir / "tables").glob("*.json"):
        os.utime(p, (stale, stale))
    assert tier.sweep()["expired"] == 1
    assert tier.get_table("k1") is None
    assert not list((tier.dir / "objects").glob("*.npz"))


def test_byte_budget_evicts_stalest_key_first(tmp_path):
    probe = FileTier(str(tmp_path / "probe"))
    probe.put_table("probe", _table(100, n=200))
    one = probe._object_bytes()
    budget = 3 * one + one // 2
    tier = FileTier(str(tmp_path / "tier"), byte_budget=budget)
    keys = [f"k{i}" for i in range(6)]
    for i, k in enumerate(keys):
        tier.put_table(k, _table(100 + i, n=200))
        time.sleep(0.01)
    assert tier.evictions > 0 and tier._object_bytes() <= budget
    assert tier.get_table(keys[-1]) is not None
    assert tier.get_table(keys[0]) is None


def test_make_tier_validation(tmp_path):
    assert isinstance(make_tier("local"), LocalTier)
    assert isinstance(make_tier("remote", str(tmp_path)), FileTier)
    with pytest.raises(ValueError):
        make_tier("remote")
    with pytest.raises(ValueError):
        make_tier("carrier-pigeon")
