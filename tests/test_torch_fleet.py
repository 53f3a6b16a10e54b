"""The port's verification fleet (``repro_torch.service.fleet``) on the CPU:
worker processes at ``device="cpu"``, the torch plane.

Seeded cases of ``tests/test_fleet_differential.py``'s property: fleets of
1, 2 and 4 workers over the local and the file tier answer byte for byte
what one process answers, and what the reference package's fleet answers
(verdicts, ``decompositions_explored``, certificate JSON, the canonical
bytes of every executed sink).  Then a UDF registered at run time in the
parent, and the ingestion pipeline's ``tokenize_pack``, through workers
that are forked and through workers started from a forkserver (as on
CUDA), and an unpicklable registry entry refused at start.  Then the
process-death cases of
``tests/test_fleet_faults.py``: a worker killed with SIGKILL is respawned
and its journal replayed.  Every wait is bounded: a fleet that stops
answering is written off and the test fails instead of hanging.
"""

import os
import signal
import threading

import pytest

from repro import workload as ref_workload
from repro.api.config import VeerConfig as RefVeerConfig
from repro.service import VerificationFleet as RefFleet

import numpy as np

import repro_torch.service.fleet as fleet_mod
from repro_torch.api.config import VeerConfig
from repro_torch.core import dag as D
from repro_torch.core.ev import torch_bodies
from repro_torch.core.predicates import Pred
from repro_torch.data import corpus_table, ingestion_pipeline
from repro_torch.engine import (
    InMemoryMaterializationStore,
    PlaneError,
    Table,
    execute,
    ops_impl,
    tables_identical,
)
from repro_torch.service import (
    ConsistentHashRing,
    FleetRegistryError,
    VerificationFleet,
    shard_key,
)
from repro_torch.service.chain import VersionChainSession
from repro_torch.service.synthetic import make_chain
from repro_torch.workload import SessionGenerator, WorkloadConfig
from repro_torch.workload.replay import (
    REPLAY_EVS,
    ReplayResult,
    _check_session,
    canonical_results_bytes,
)

CONFIG = VeerConfig(evs=REPLAY_EVS, max_decompositions=60)
TIMEOUT = 180.0
FLEET_SHAPES = [(1, "local"), (2, "local"), (4, "local"),
                (1, "remote"), (2, "remote"), (4, "remote")]


def _workload(seed, sessions=3, chain_length=5):
    return dict(seed=seed, sessions=sessions, clients=sessions, chain_length=chain_length,
                max_decompositions=60)


def _write_off(fleet):
    """Make a stuck fleet give up: no respawns left, every worker killed."""
    for i, proc in enumerate(fleet._procs):
        fleet._respawns[i] = fleet_mod.MAX_RESPAWNS_PER_SHARD
        if proc.is_alive():
            os.kill(proc.pid, signal.SIGKILL)


def _bounded(fleet, fn, timeout=TIMEOUT):
    box = {}

    def run():
        try:
            box["out"] = fn()
        except BaseException as e:  # re-raised in the test's thread below
            box["err"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout)
    if t.is_alive():
        _write_off(fleet)
        t.join(60)
        pytest.fail(f"the fleet did not answer within {timeout} s")
    if "err" in box:
        raise box["err"]
    return box.get("out")


def _signature(session, reports, results_bytes):
    trace = []
    for k, report in enumerate(reports):
        if report is None:
            trace.append(("none",))
            continue
        dag = session.versions[k]
        sinks = (sorted(results_bytes(dag, report.results).items())
                 if report.results is not None else None)
        if k == 0:
            trace.append(("first", sinks))
            continue
        trace.append((report.verdict, report.stats.decompositions_explored, report.certified,
                      report.certificate.to_json() if report.certificate is not None else None,
                      sinks))
    return trace


def _one_process(sessions):
    out = {}
    for s in sessions:
        chain = VersionChainSession(config=CONFIG, device="cpu",
                                    materialization_store=InMemoryMaterializationStore())
        reports = [chain.submit(v, s.pairs[k - 1].mapping if k else None, sources=s.sources)
                   for k, v in enumerate(s.versions)]
        out[s.session_id] = _signature(s, reports, canonical_results_bytes)
    return out


def _submit_all(fleet, sessions):
    futures = {s.session_id: [] for s in sessions}
    for k in range(max(len(s.versions) for s in sessions)):
        for s in sessions:
            if k < len(s.versions):
                mapping = s.pairs[k - 1].mapping if k > 0 else None
                futures[s.session_id].append(
                    fleet.submit(s.session_id, s.versions[k], mapping, sources=s.sources,
                                 timeout=TIMEOUT))
    return futures


def _fleet_run(sessions, workers, shared_tier, tier_dir):
    cfg = CONFIG.replace(shared_tier=shared_tier,
                         tier_dir=str(tier_dir) if shared_tier == "remote" else None)
    fleet = VerificationFleet(workers, config=cfg, device="cpu")
    try:
        futures = _bounded(fleet, lambda: _submit_all(fleet, sessions))
        report = _bounded(fleet, fleet.drain)
        assert not report.errors, report.errors
        assert len(report.worker_stats) == workers
        for ws in report.worker_stats:  # the CPU plane launches no kernel
            assert ws is not None and ws["relational_launches"] == 0
        return {s.session_id: _signature(s, [f.result(timeout=TIMEOUT)
                                             for f in futures[s.session_id]],
                                         canonical_results_bytes)
                for s in sessions}
    finally:
        _bounded(fleet, fleet.close)


@pytest.fixture(scope="module")
def seeded_case():
    """Seed 23 (the reference's own seeded sweep): the port's sessions, the
    port in one process, and the reference fleet's answers."""
    wc = _workload(23)
    sessions = SessionGenerator(WorkloadConfig(**wc)).generate()
    ref_sessions = ref_workload.SessionGenerator(ref_workload.WorkloadConfig(**wc)).generate()
    ref_cfg = RefVeerConfig(evs=REPLAY_EVS, max_decompositions=60)
    with RefFleet(2, config=ref_cfg) as ref_fleet:
        futures = _submit_all(ref_fleet, ref_sessions)
        assert not ref_fleet.drain().errors
        reference = {
            s.session_id: _signature(s, [f.result(timeout=TIMEOUT) for f in futures[s.session_id]],
                                     ref_workload.replay.canonical_results_bytes)
            for s in ref_sessions}
    return sessions, _one_process(sessions), reference


@pytest.mark.parametrize("workers,shared_tier", FLEET_SHAPES)
def test_fleet_equals_one_process_and_the_reference_fleet(seeded_case, tmp_path, workers,
                                                          shared_tier):
    sessions, one_process, reference = seeded_case
    assert one_process == reference
    got = _fleet_run(sessions, workers, shared_tier, tmp_path / "tier")
    assert got == one_process


def test_more_workers_than_clients(tmp_path):
    sessions = SessionGenerator(WorkloadConfig(**_workload(77, 2, 4))).generate()
    got = _fleet_run(sessions, 4, "remote", tmp_path / "tier")
    assert got == _one_process(sessions)


def test_warm_remote_tier_changes_no_answers(tmp_path):
    """A second fleet over the same file tier serves pairs and tables from it
    after certificate replay; only the avoided work's accounting moves."""
    sessions = SessionGenerator(WorkloadConfig(**_workload(5, 2, 4))).generate()
    reference = _one_process(sessions)
    cold = _fleet_run(sessions, 2, "remote", tmp_path / "tier")
    warm = _fleet_run(sessions, 2, "remote", tmp_path / "tier")
    assert cold == reference

    def answers(trace):
        return [t if t[0] in ("none", "first") else (t[0], *t[2:]) for t in trace]

    assert {s: answers(t) for s, t in warm.items()} == \
        {s: answers(t) for s, t in reference.items()}


def test_cpu_fleet_forks_and_cuda_fleet_uses_a_forkserver():
    assert fleet_mod._context("cpu").get_start_method() == "fork"
    assert fleet_mod._context("cuda").get_start_method() == "forkserver"
    assert fleet_mod._context("cuda:0").get_start_method() == "forkserver"


def test_default_device_is_cuda_and_a_worker_without_it_fails_the_job():
    """Started from a forkserver (the CUDA default): verification runs, and
    an executing job fails its own future with the plane's error."""
    chain = make_chain(3)
    fleet = VerificationFleet(1, config=CONFIG)
    try:
        assert fleet.device == "cuda"
        futs = _bounded(fleet, lambda: [fleet.submit("v", v, timeout=TIMEOUT) for v in chain])
        ex = _bounded(fleet, lambda: fleet.submit("x", chain[0], sources={}, timeout=TIMEOUT))
        report = _bounded(fleet, fleet.drain)
        assert futs[0].result(timeout=TIMEOUT) is None
        assert [f.result(timeout=TIMEOUT).verdict for f in futs[1:]] == [True, True]
        with pytest.raises(RuntimeError, match=PlaneError.__name__):
            ex.result(timeout=TIMEOUT)
        assert len(report.errors) == 1
    finally:
        _bounded(fleet, fleet.close)
    from multiprocessing import forkserver, resource_tracker

    del fleet
    fleet_mod.stop_helper_processes()
    assert forkserver._forkserver._forkserver_pid is None
    assert resource_tracker._resource_tracker._pid is None


# ---------------------------------------------------------------------------
# registries: what a worker started from a forkserver must be sent
# ---------------------------------------------------------------------------


def _scaled_sum(t):
    """A UDF this module registers at run time (importable, so it pickles)."""
    return t.with_col("s", t.cols["a"] * 3.0 + t.cols["b"])


def _both_pos(a, b):
    return (a > 0) & (b > 0)


def _udf_chain():
    """Two versions that run ``_scaled_sum``: the second adds a filter."""
    def version(th):
        ops = [D.Operator.make("src", D.SOURCE, schema=("a", "b")),
               D.Operator.make("f", D.FILTER, pred=Pred.cmp("a", ">", th)),
               D.Operator.make("u", D.UDF, fn="fleet_scaled_sum", out_schema=("a", "b", "s")),
               D.Operator.make("out", D.SINK, semantics=D.BAG)]
        path = [o.id for o in ops]
        return D.DataflowDAG(ops, [D.Link(x, y) for x, y in zip(path, path[1:])])

    rng = np.random.default_rng(3)
    src = {"src": Table({"a": rng.integers(-5, 9, 400).astype(np.float64),
                         "b": rng.uniform(-1, 1, 400)}, ["a", "b"])}
    return [version(0.0), version(2.0)], src


@pytest.mark.parametrize("start", ["fork", "forkserver"])
def test_workers_run_a_udf_registered_at_run_time_and_tokenize_pack(monkeypatch, start):
    """The parent registers a UDF after import; two clients (one its
    chain, one two versions of the ingestion pipeline with ``tokenize_pack``)
    run on a 2-worker fleet whose workers are forked, or started from a
    forkserver as on CUDA (where they have only the sent snapshot): no
    errors, and every sink identical to one process's."""
    monkeypatch.setitem(ops_impl.UDF_REGISTRY, "fleet_scaled_sum", _scaled_sum)
    if start == "forkserver":  # the CUDA start method, with the plane on the CPU
        cuda_context = fleet_mod._context("cuda")
        monkeypatch.setattr(fleet_mod, "_context", lambda device: cuda_context)
    udf_chain, udf_src = _udf_chain()
    ingest = [ingestion_pipeline(min_quality=0.25, lang=0), ingestion_pipeline(min_quality=0.6, lang=0)]
    ingest_src = {"corpus": corpus_table(300)}
    fleet = VerificationFleet(2, config=CONFIG, device="cpu")
    try:
        assert fleet._ctx.get_start_method() == start
        futs = _bounded(fleet, lambda: (
            [fleet.submit("udf", v, sources=udf_src, timeout=TIMEOUT) for v in udf_chain],
            [fleet.submit("ingest", v, sources=ingest_src, timeout=TIMEOUT) for v in ingest]))
        report = _bounded(fleet, fleet.drain)
    finally:
        _bounded(fleet, fleet.close)
    if start == "forkserver":
        del fleet
        fleet_mod.stop_helper_processes()
    assert not report.errors, report.errors
    for fs, versions, src in ((futs[0], udf_chain, udf_src), (futs[1], ingest, ingest_src)):
        for f, v in zip(fs, versions):
            results = f.result(timeout=TIMEOUT).results
            want = execute(v, src, device="cpu")
            assert all(tables_identical(want[s], results[s]) for s in want)
    assert len(want["packed"]) > 0


def test_snapshot_sends_base_entries_and_refuses_what_does_not_pickle(monkeypatch):
    """A nonlinear atom registered at run time travels without its negation
    (a lambda the worker rebuilds); a lambda UDF makes a forkserver fleet
    raise ``FleetRegistryError`` naming it before any worker starts, while
    a forked fleet, which sends nothing, starts."""
    for name in ("fleet_both_pos", "not_fleet_both_pos"):  # removed again at teardown
        monkeypatch.setitem(ops_impl.NONLINEAR_FNS, name, None)
    ops_impl.register_nonlinear("fleet_both_pos")(_both_pos)
    snap = fleet_mod.registry_snapshot()
    assert snap["nonlinear"]["fleet_both_pos"] is _both_pos
    assert not any(k.startswith("not_") for k in snap["nonlinear"])
    assert set(snap["udf"]) == set(ops_impl.UDF_REGISTRY)
    assert set(snap["torch_udf"]) == set(torch_bodies.TORCH_UDF_REGISTRY)

    monkeypatch.setitem(ops_impl.UDF_REGISTRY, "fleet_lambda_udf", lambda t: t)
    with pytest.raises(FleetRegistryError, match="fleet_lambda_udf"):
        VerificationFleet(1, config=CONFIG, device="cuda")
    fleet = VerificationFleet(1, config=CONFIG, device="cpu")
    _bounded(fleet, fleet.close)


def test_sharding_is_deterministic_and_spreads():
    chain = make_chain(2)
    ring = ConsistentHashRing(4)
    nodes = [ring.node(shard_key(f"c{i}", chain[0])) for i in range(64)]
    assert nodes == [ConsistentHashRing(4).node(shard_key(f"c{i}", chain[0]))
                     for i in range(64)]
    assert set(nodes) == {0, 1, 2, 3}


# ---------------------------------------------------------------------------
# worker death
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shared_tier", ["local", "remote"])
def test_worker_killed_mid_chain_is_respawned_and_drains(tmp_path, shared_tier):
    wc = WorkloadConfig(seed=11, sessions=4, clients=4, chain_length=6, max_decompositions=60)
    sessions = SessionGenerator(wc).generate()
    cfg = CONFIG.replace(shared_tier=shared_tier,
                         tier_dir=str(tmp_path / "tier") if shared_tier == "remote" else None)
    futures = {s.session_id: [] for s in sessions}
    fleet = VerificationFleet(2, config=cfg, device="cpu")
    try:
        def submit_and_kill():
            for k in range(max(len(s.versions) for s in sessions)):
                for s in sessions:
                    if k < len(s.versions):
                        mapping = s.pairs[k - 1].mapping if k > 0 else None
                        futures[s.session_id].append(
                            fleet.submit(s.session_id, s.versions[k], mapping,
                                         timeout=TIMEOUT))
                if k == 2:  # mid-chain: shards have answered and queued jobs
                    os.kill(fleet._procs[0].pid, signal.SIGKILL)

        _bounded(fleet, submit_and_kill)
        report = _bounded(fleet, fleet.drain)
    finally:
        _bounded(fleet, fleet.close)
    assert report.recoveries >= 1 and not report.errors
    result = ReplayResult(config=wc)
    for s in sessions:
        assert all(f.done() for f in futures[s.session_id])
        _check_session(s, futures[s.session_id], result, registry=None, exec_reuse=False,
                       collect_windows=False, check_oracles=True)
    assert result.pairs == wc.total_pairs
    assert not result.violations, "\n".join(map(str, result.violations[:10]))


def test_kill_then_results_match_an_undisturbed_fleet():
    chain = make_chain(6)

    def run(kill):
        fleet = VerificationFleet(2, config=CONFIG, device="cpu")
        try:
            futs = _bounded(fleet, lambda: [fleet.submit(f"c{c}", v, timeout=TIMEOUT)
                                            for c in range(3) for v in chain])
            if kill:
                os.kill(fleet._procs[0].pid, signal.SIGKILL)
            report = _bounded(fleet, fleet.drain)
            assert report.recoveries >= int(kill)
            return [None if r is None else (r.verdict, r.certificate.to_json())
                    for r in (f.result(timeout=TIMEOUT) for f in futs)]
        finally:
            _bounded(fleet, fleet.close)

    assert run(kill=True) == run(kill=False)


def test_shard_lost_after_repeated_deaths_fails_cleanly():
    chain = make_chain(3)
    fleet = VerificationFleet(1, config=CONFIG, device="cpu")
    try:
        futs = _bounded(fleet, lambda: [fleet.submit("c0", v, timeout=TIMEOUT) for v in chain])
        fleet._respawns[0] = fleet_mod.MAX_RESPAWNS_PER_SHARD
        os.kill(fleet._procs[0].pid, signal.SIGKILL)
        report = _bounded(fleet, fleet.drain)
        assert report.errors and fleet._shard_lost[0] is not None
        for f in futs:
            if f.exception(timeout=TIMEOUT) is not None:
                assert isinstance(f.exception(), fleet_mod.FleetWorkerLost)
        with pytest.raises(fleet_mod.FleetWorkerLost):
            fleet.submit("c0", chain[0])
    finally:
        _bounded(fleet, fleet.close)
