"""Sustained-traffic replay of generated edit sessions, with oracles.

``replay_sessions`` pushes N generated ``EditSession``s through one
``VerificationService`` — each session is one service client, versions
interleaved round-robin so many clients are in flight at once, optionally
QPS-paced — and then cross-checks every answer with *differential
oracles* that are independent of the verifier's own machinery:

  * **EQ ⇒ execution-equal**: every True verdict is re-checked by fully
    executing both versions on the session's source tables and comparing
    each sink's *canonical byte encoding* (ordered sinks byte-for-byte in
    order; bag/set sinks byte-for-byte after canonical row sort).  A
    provably-equivalent pair with differing sink bytes is a verifier bug.
  * **expected-eq ⇒ never NEQ, and execution-equal**: pairs built from
    equivalence-preserving families (Calcite rewrites, boundary splices,
    rename storms, churn/revert) must not come back False — and their
    executions must agree even when the verdict is Unknown, which checks
    the *generator's* own construction too.
  * **decided ⇒ certificate replays green, bound to the pair**: every
    True/False verdict (reused ones included) must carry a certificate
    that passes ``Certificate.replay(registry, P, Q)`` — fresh EVs, pair
    digest binding, full change cover.
  * **reuse-path ⇒ bit-identical results** (``exec_reuse=True``): when the
    service executes versions with certificate-seeded materialization
    reuse, every returned sink table must be ``tables_identical`` to a
    fresh, reuse-free execution.

Violations are collected, never raised mid-flight — the driver always
drains the service and reports everything it found.

The service or fleet executes on ``device`` (the torch plane on ``"cuda"``
unless the caller passes ``device="cpu"``); the ground-truth oracle always
executes on the host's numpy plane, independent of the plane under test.
"""

from __future__ import annotations

import shutil
import tempfile
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from repro_torch.api.certificate import Certificate
from repro_torch.api.config import VeerConfig
from repro_torch.api.registry import EVRegistry
from repro_torch.core import dag as D
from repro_torch.core.dag import DataflowDAG
from repro_torch.engine.executor import execute
from repro_torch.engine.store import InMemoryMaterializationStore
from repro_torch.engine.table import Table, tables_identical
from repro_torch.service import ServiceBusy, VerificationService
from repro_torch.service.fleet import VerificationFleet
from repro_torch.workload.config import WorkloadConfig
from repro_torch.workload.corpus import WindowExample, windows_from_certificate
from repro_torch.workload.generator import EXPECTED_EQ, EditSession

# EVs the replayed verifier runs with: the three symbolic provers, as in
# the reference package's replay — the traced EV adds nothing on these
# shapes and would only add tracing time to the stress path
REPLAY_EVS = ("equitas", "spes", "udp")


def canonical_sink_bytes(table: Table, semantics: str) -> bytes:
    """Byte encoding under which two sink tables are compared.

    Equivalence under Def 2.2 is row-set/bag/sequence equality, so the
    encoding sorts rows for bag semantics, dedups+sorts for set semantics,
    and keeps order for ordered sinks; the schema is always part of the
    bytes.  Two tables are oracle-equal iff their encodings are equal."""
    rows = [repr(r) for r in table.rows()]
    if semantics == D.SET:
        rows = sorted(set(rows))
    elif semantics != D.ORDERED:   # BAG (the default)
        rows = sorted(rows)
    return "\n".join([repr(tuple(table.order))] + rows).encode()


def canonical_results_bytes(
    dag: DataflowDAG, results: Dict[str, Table]
) -> Dict[str, bytes]:
    """Canonical bytes per sink, honoring each sink's own semantics."""
    out = {}
    for sink_id, t in results.items():
        sem = dag.ops[sink_id].get("semantics", D.BAG)
        out[sink_id] = canonical_sink_bytes(t, sem)
    return out


@dataclass(frozen=True)
class OracleViolation:
    session_id: str
    pair_index: int                 # -1: session-level failure
    check: str                      # which oracle tripped
    detail: str

    def __str__(self) -> str:
        return (
            f"[{self.session_id}/pair {self.pair_index}] "
            f"{self.check}: {self.detail}"
        )


@dataclass
class ReplayResult:
    """Everything one replay run produced: traffic stats, verdict census,
    oracle violations, and (optionally) the harvested window corpus."""

    config: WorkloadConfig
    pairs: int = 0                  # version pairs actually verified
    verdicts: Dict[str, int] = field(
        default_factory=lambda: {"EQ": 0, "NEQ": 0, "UNK": 0}
    )
    certified: int = 0
    reused: int = 0
    ev_calls: int = 0
    # delta-execution accounting (exec_mode="delta"): summed over every
    # pair's ExecStats — ops answered by delta rules, delta rows they
    # touched, and the recorded recompute cost the served tables avoided
    ops_delta: int = 0
    delta_rows: int = 0
    recompute_saved_s: float = 0.0
    violations: List[OracleViolation] = field(default_factory=list)
    latencies: List[float] = field(default_factory=list)  # per-pair seconds
    busy_rejections: int = 0
    run_wall: float = 0.0           # submit-to-drain wall time
    oracle_wall: float = 0.0        # differential-oracle wall time
    cache_stats: Dict[str, object] = field(default_factory=dict)
    pair_cache_stats: Dict[str, object] = field(default_factory=dict)
    windows: List[WindowExample] = field(default_factory=list)
    errors: List[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.violations and not self.errors

    @property
    def decided(self) -> int:
        return self.verdicts["EQ"] + self.verdicts["NEQ"]

    @property
    def verified_fraction(self) -> float:
        return self.decided / max(1, self.pairs)

    @property
    def pairs_per_sec(self) -> float:
        return self.pairs / self.run_wall if self.run_wall > 0 else 0.0

    def latency_quantile(self, q: float) -> float:
        if not self.latencies:
            return 0.0
        xs = sorted(self.latencies)
        return xs[min(len(xs) - 1, int(q * len(xs)))]

    @property
    def p50_latency(self) -> float:
        return self.latency_quantile(0.50)

    @property
    def p99_latency(self) -> float:
        return self.latency_quantile(0.99)

    def summary(self) -> str:
        v = self.verdicts
        lines = [
            f"replayed {self.pairs} pairs "
            f"({v['EQ']} EQ, {v['NEQ']} NEQ, {v['UNK']} UNK; "
            f"{self.certified} certified, {self.reused} reused) "
            f"in {self.run_wall:.2f}s — {self.pairs_per_sec:.1f} pairs/s",
            f"latency p50 {self.p50_latency * 1e3:.1f} ms, "
            f"p99 {self.p99_latency * 1e3:.1f} ms; "
            f"{self.busy_rejections} busy rejections",
            f"oracles: {len(self.violations)} violations "
            f"({self.oracle_wall:.2f}s)"
            + (f"; windows harvested: {len(self.windows)}" if self.windows else ""),
        ]
        if self.ops_delta:
            lines.insert(2, (
                f"delta: {self.ops_delta} ops via delta rules, "
                f"{self.delta_rows} delta rows, "
                f"{self.recompute_saved_s * 1e3:.1f} ms recompute saved"
            ))
        lines.extend(f"  VIOLATION {viol}" for viol in self.violations[:20])
        lines.extend(f"  ERROR {e}" for e in self.errors[:20])
        return "\n".join(lines)


def default_veer_config(config: WorkloadConfig) -> VeerConfig:
    return VeerConfig(
        evs=REPLAY_EVS,
        max_decompositions=config.max_decompositions,
        plane=config.plane,
        guidance=config.guidance,
        exec_mode=config.exec_mode,
    )


def replay_sessions(
    sessions: Sequence[EditSession],
    config: WorkloadConfig,
    *,
    veer_config: Optional[VeerConfig] = None,
    registry: Optional[EVRegistry] = None,
    exec_reuse: bool = False,
    collect_windows: bool = False,
    workers: Optional[int] = None,
    queue_size: int = 64,
    check_oracles: bool = True,
    device: str = "cuda",
) -> ReplayResult:
    """Replay ``sessions`` as concurrent service traffic; oracle-check all.

    ``workers`` defaults to ``config.clients`` (the inter-client pool);
    ``config.qps > 0`` paces submissions globally.  ``exec_reuse`` routes
    every version through certificate-seeded partial execution against a
    shared in-memory materialization store and adds the bit-identity
    oracle.  A full ``ServiceBusy`` rejection is counted and the version is
    resubmitted blocking — a replayed chain never drops a version.

    ``config.fleet > 0`` replays through a ``VerificationFleet`` of that
    many worker *processes* instead of the threaded service — same submit
    loop, same oracles (the fleet front mirrors the service surface).
    ``config.shared_tier == "remote"`` attaches a ``FileTier`` shared
    cache tier (in a temporary directory unless ``veer_config`` already
    pins ``tier_dir``); with the default ``"local"`` nothing crosses a
    process boundary except jobs and reports.  ``device`` is where the
    service's or the fleet's sessions execute.
    """
    veer_config = veer_config or default_veer_config(config)
    tmp_tier_dir: Optional[str] = None
    if config.shared_tier == "remote" and veer_config.shared_tier != "remote":
        tmp_tier_dir = tempfile.mkdtemp(prefix="veer-tier-")
        veer_config = veer_config.replace(
            shared_tier="remote", tier_dir=tmp_tier_dir
        )
    result = ReplayResult(config=config)
    store = InMemoryMaterializationStore() if exec_reuse else None
    lat_lock = threading.Lock()

    futures: Dict[str, List] = {s.session_id: [] for s in sessions}
    t_run = time.perf_counter()
    next_slot = t_run
    if config.fleet > 0:
        backend = VerificationFleet(
            config.fleet,
            config=veer_config,
            registry=registry,
            queue_size=queue_size,
            device=device,
        )
    else:
        backend = VerificationService(
            config=veer_config,
            registry=registry,
            workers=workers or config.clients,
            queue_size=queue_size,
            materialization_store=store,
            device=device,
        )
    try:
        with backend as svc:
            # round-robin across sessions: every client has work in flight
            for k in range(max(len(s.versions) for s in sessions)):
                for s in sessions:
                    if k >= len(s.versions):
                        continue
                    if config.qps > 0:
                        next_slot += 1.0 / config.qps
                        delay = next_slot - time.perf_counter()
                        if delay > 0:
                            time.sleep(delay)
                    mapping = s.pairs[k - 1].mapping if k > 0 else None
                    kw = {"sources": s.sources} if exec_reuse else {}
                    t0 = time.perf_counter()
                    try:
                        fut = svc.submit(
                            s.session_id, s.versions[k], mapping,
                            block=False, **kw,
                        )
                    except ServiceBusy:
                        result.busy_rejections += 1
                        fut = svc.submit(
                            s.session_id, s.versions[k], mapping, **kw
                        )
                    if k > 0:
                        def _record(f, t0=t0):
                            with lat_lock:
                                result.latencies.append(
                                    time.perf_counter() - t0
                                )
                        fut.add_done_callback(_record)
                    futures[s.session_id].append(fut)
            report = svc.drain()
            result.run_wall = time.perf_counter() - t_run
            result.errors = list(report.errors)
            result.cache_stats = dict(report.cache_stats)
            result.pair_cache_stats = dict(report.pair_cache_stats)
    finally:
        if tmp_tier_dir is not None:
            shutil.rmtree(tmp_tier_dir, ignore_errors=True)

    t_oracle = time.perf_counter()
    for s in sessions:
        _check_session(
            s, futures[s.session_id], result,
            registry=registry,
            exec_reuse=exec_reuse,
            collect_windows=collect_windows,
            check_oracles=check_oracles,
        )
    result.oracle_wall = time.perf_counter() - t_oracle
    return result


def _check_session(
    session: EditSession,
    futs: List,
    result: ReplayResult,
    *,
    registry: Optional[EVRegistry],
    exec_reuse: bool,
    collect_windows: bool,
    check_oracles: bool,
) -> None:
    sid = session.session_id

    def violate(index: int, check: str, detail: str) -> None:
        result.violations.append(OracleViolation(sid, index, check, detail))

    # ground-truth executions are memoized per version: version k is P of
    # pair k+1 and Q of pair k, so each version executes at most once
    exec_cache: Dict[int, Dict[str, bytes]] = {}
    raw_cache: Dict[int, Dict[str, Table]] = {}

    def ground_truth(idx: int) -> Dict[str, bytes]:
        if idx not in exec_cache:
            dag = session.versions[idx]
            srcs = {k: v for k, v in session.sources.items() if k in dag.ops}
            raw_cache[idx] = execute(dag, srcs, plane="numpy")
            exec_cache[idx] = canonical_results_bytes(dag, raw_cache[idx])
        return exec_cache[idx]

    for k, fut in enumerate(futs):
        if fut.exception() is not None:
            violate(k, "job-error", repr(fut.exception()))
            continue
        report = fut.result()
        if k == 0:
            if exec_reuse and report is not None and check_oracles:
                _check_exec_identity(
                    session, 0, report.results, raw_cache, ground_truth, violate
                )
            continue
        if report is None:
            violate(k, "missing-report", "no PairReport for a non-first version")
            continue
        planned = session.pairs[k - 1]
        verdict = report.verdict
        result.pairs += 1
        result.verdicts[{True: "EQ", False: "NEQ", None: "UNK"}[verdict]] += 1
        result.certified += int(report.certified)
        result.reused += int(report.reused)
        result.ev_calls += report.stats.ev_calls
        es = report.exec_stats
        if es is not None:
            result.ops_delta += es.ops_delta
            result.delta_rows += es.delta_rows_processed
            result.recompute_saved_s += es.recompute_time_saved
        P, Q = session.versions[k - 1], session.versions[k]

        if collect_windows and report.certificate is not None:
            result.windows.extend(
                windows_from_certificate(
                    report.certificate,
                    workload=session.workload,
                    session_id=sid,
                    pair_index=k,
                    family=planned.kind,
                    expected=planned.expected,
                )
            )
        if not check_oracles:
            continue

        # decided ⇒ certificate present + replays green bound to the pair
        if verdict is not None:
            cert: Optional[Certificate] = report.certificate
            if cert is None:
                violate(k, "missing-certificate",
                        f"decided verdict {verdict} carries no certificate")
            else:
                rep = cert.replay(registry, P, Q)
                if not rep.ok:
                    violate(k, "certificate-replay", rep.summary())

        # EQ ⇒ byte-identical canonical sinks under execution
        if verdict is True:
            gp, gq = ground_truth(k - 1), ground_truth(k)
            if gp != gq:
                bad = sorted(
                    s for s in set(gp) | set(gq) if gp.get(s) != gq.get(s)
                )
                violate(k, "eq-execution",
                        f"EQ verdict but sinks differ under execution: {bad}")

        # expected-eq pairs: never NEQ, and execution-equal regardless of
        # verdict (this also audits the generator's own constructions)
        if planned.expected == EXPECTED_EQ:
            if verdict is False:
                violate(k, "expected-eq-verdict",
                        f"{planned.kind} pair judged NEQ")
            gp, gq = ground_truth(k - 1), ground_truth(k)
            if gp != gq:
                violate(k, "expected-eq-execution",
                        f"{planned.kind} pair not execution-equal")

        # reuse-path results must be bit-identical to a fresh full run
        if exec_reuse:
            _check_exec_identity(
                session, k, report.results, raw_cache, ground_truth, violate
            )


def _check_exec_identity(
    session: EditSession,
    idx: int,
    served: Optional[Dict[str, Table]],
    raw_cache: Dict[int, Dict[str, Table]],
    ground_truth,
    violate,
) -> None:
    if served is None:
        violate(idx, "reuse-exec", "exec_reuse run returned no results")
        return
    ground_truth(idx)  # populate raw_cache[idx]
    fresh = raw_cache[idx]
    if set(served) != set(fresh):
        violate(idx, "reuse-exec",
                f"sink sets differ: {sorted(served)} vs {sorted(fresh)}")
        return
    for sink_id, t in served.items():
        if not tables_identical(t, fresh[sink_id]):
            violate(idx, "reuse-exec",
                    f"sink {sink_id} not bit-identical to full execution")
