"""Process-sharded verification fleet (multi-tenant scale-out).

``VerificationService`` multiplexes clients over *threads* of one process;
the GIL caps it at roughly one core of pure-Python search no matter how
many clients are in flight.  ``VerificationFleet`` is the next rung: N
**worker processes**, each running ordinary serial ``VersionChainSession``s
for the clients sharded onto it, all sharing one second-level cache tier
(``repro_torch.service.remote``) so a pair any worker decided — with its
certificate — is reusable fleet-wide.

Design:

  * **Sharding** — a client is pinned to a worker by consistent hash of
    ``(client_id, first-version content digest)`` over a 64-virtual-node
    ring (sha256-based: Python's ``hash()`` is salted per process and
    can never shard reproducibly).  Chain sessions are stateful (pair k
    needs pair k-1), so the whole chain lives on one worker and runs in
    submission order; different clients land on different workers and run
    genuinely in parallel.
  * **Transport** — one bounded ``multiprocessing.Queue`` per worker
    (backpressure: ``submit`` raises ``ServiceBusy`` when full, same
    contract as the service) and one result queue *per worker* drained by
    a collector thread that resolves the caller's ``Future``s.  Result
    queues are deliberately not shared: a queue has exactly one writing
    process, so a worker killed mid-``put`` (holding the queue's internal
    write lock) can only wedge its own queue — which recovery abandons
    wholesale — never its siblings' ability to report.  Reports
    cross the boundary with the certificate as its canonical JSON (the
    serialization contract — certificates are *evidence*, and the bytes
    the differential suite compares); tables and stats pickle natively.
  * **Recovery** — the parent journals every accepted job per shard.  A
    worker found dead (mid-pair kill, OOM, fault injection) is replaced
    by a fresh process and its shard's journal is replayed from the
    start: chain state is rebuilt deterministically, already-resolved
    futures ignore the duplicate results (same bytes — verification is
    deterministic), unresolved ones get answered.  Verification is
    idempotent, so crash-then-replay can duplicate work but never change
    an answer.
  * **Safety** — workers trust nothing from the shared tier that they
    could not have computed themselves: remote pair hits are served only
    after pair-bound certificate replay, remote tables only after
    content-digest re-verification (see ``repro_torch.service.remote.adapters``
    and docs/SCALE_OUT.md).  The differential suite asserts fleet runs
    are byte-identical to the sequential reference.
  * **Device** — every worker's sessions execute on ``device`` (the torch
    plane on ``"cuda"`` unless the caller asks for ``"cpu"``).  The worker's
    own session resolves the device; the parent never does.  CUDA cannot
    be used in a child forked from a process that has initialized it (as
    any process that ran the torch plane on the card has), so on a CUDA
    device the workers start from a ``forkserver``: a fresh interpreter
    that has imported this module and never touched the card.  On the CPU
    they are forked from the parent, as the reference package's are.  A
    forkserver's worker has only what its imports registered, so at start
    the fleet takes a snapshot of the parent's UDF and nonlinear-atom
    registries (the engine's and the traced EV's) and each worker
    registers it before its first job: a UDF registered at run time in the
    parent reaches every worker, as it does through a fork.  Either way a
    worker runs torch's CPU ops on one thread: a forked child inherits no
    usable OpenMP pool, and the plane's bytes do not depend on the thread
    count.

``VerificationFleet`` deliberately mirrors the ``VerificationService``
surface that ``workload.replay_sessions`` consumes — ``submit(client_id,
version, mapping, *, sources, block, timeout) -> Future``, ``drain()``,
``close()``, context manager — so the replay driver and its oracles run
unchanged against either backend.
"""

from __future__ import annotations

import bisect
import hashlib
import multiprocessing as mp
import pickle
import queue as stdlib_queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.api.certificate import Certificate
from repro_torch.api.config import VeerConfig
from repro_torch.api.registry import EVRegistry
from repro_torch.core.dag import DataflowDAG
from repro_torch.core.edits import EditMapping
from repro_torch.core.ev import torch_bodies
from repro_torch.engine import ops_impl
from repro_torch.engine import plane as plane_registry
from repro_torch.kernels import relational as R
from repro_torch.service.chain import PairReport, VersionChainSession
from repro_torch.service.remote.adapters import (
    TieredMaterializationStore,
    TieredPairCache,
    TieredVerdictCache,
)
from repro_torch.service.remote.tier import make_tier
from repro_torch.service.server import ServiceBusy, ServiceClosed

#: consecutive respawn failures after which a shard is declared lost and
#: its unresolved futures are failed instead of respawning forever
MAX_RESPAWNS_PER_SHARD = 5

_DRAIN_POLL = 0.05  # parent-side liveness poll while waiting on a barrier


class FleetWorkerLost(RuntimeError):
    """A shard's worker kept dying and its journal could not be replayed."""


class FleetRegistryError(ValueError):
    """An entry of the parent's UDF or nonlinear registries cannot be sent
    to a fleet's workers (a lambda or a closure does not pickle)."""


# -- registries ---------------------------------------------------------------
#: (name, registry, register decorator) of every registry a worker's sessions
#: read by name: the engine's UDFs and nonlinear atoms, and the traced EV's
_REGISTRIES = (
    ("udf", ops_impl.UDF_REGISTRY, ops_impl.register_udf),
    ("nonlinear", ops_impl.NONLINEAR_FNS, ops_impl.register_nonlinear),
    ("torch_udf", torch_bodies.TORCH_UDF_REGISTRY, torch_bodies.register_torch_udf),
    ("torch_nonlinear", torch_bodies.TORCH_NONLINEAR_FNS, torch_bodies.register_torch_nonlinear),
)


def registry_snapshot() -> Dict[str, Dict[str, object]]:
    """The parent's registries as a worker needs them, checked to pickle.

    A nonlinear registry holds, beside each atom, its negation under
    ``"not_" + name``, a lambda that ``register_nonlinear`` builds and that
    does not pickle: those are left out where their base is present, and
    the worker's ``register_nonlinear`` builds them again.  An entry that
    does not pickle raises ``FleetRegistryError`` naming it."""
    snap: Dict[str, Dict[str, object]] = {}
    for kind, reg, _ in _REGISTRIES:
        nonlinear = "nonlinear" in kind
        entries = {name: fn for name, fn in reg.items()
                   if not (nonlinear and name.startswith("not_") and name[4:] in reg)}
        for name, fn in entries.items():
            try:
                pickle.dumps(fn)
            except (pickle.PicklingError, AttributeError, TypeError) as e:
                raise FleetRegistryError(
                    f"{kind} {name!r} ({fn!r}) cannot be sent to a fleet worker: {e}; register an "
                    f"importable module-level function instead") from e
        snap[kind] = entries
    return snap


def _install_registries(snap: Dict[str, Dict[str, object]]) -> None:
    """Register a ``registry_snapshot`` in this process, over what its own
    imports registered (the parent's entries are the ones its jobs mean)."""
    for kind, _, register in _REGISTRIES:
        for name, fn in snap.get(kind, {}).items():
            register(name)(fn)


# -- consistent hashing -------------------------------------------------------
class ConsistentHashRing:
    """sha256-based ring with virtual nodes.  Deterministic across
    processes and runs (never Python ``hash()``, which is salted), stable
    under small fleets, and uniform enough at 64 vnodes per worker."""

    def __init__(self, n_nodes: int, vnodes: int = 64):
        if n_nodes < 1:
            raise ValueError("need at least one node")
        points: List[Tuple[int, int]] = []
        for node in range(n_nodes):
            for v in range(vnodes):
                h = hashlib.sha256(f"shard-{node}-vnode-{v}".encode()).digest()
                points.append((int.from_bytes(h[:8], "big"), node))
        points.sort()
        self._hashes = [p[0] for p in points]
        self._nodes = [p[1] for p in points]

    def node(self, key: str) -> int:
        h = int.from_bytes(hashlib.sha256(key.encode()).digest()[:8], "big")
        i = bisect.bisect_right(self._hashes, h)
        if i == len(self._hashes):
            i = 0  # wrap: keys past the last point belong to the first
        return self._nodes[i]


def shard_key(client_id: str, first_version: DataflowDAG) -> str:
    """What a client is sharded by: id plus the chain's first content
    digest, so two tenants that happen to share a client name still
    spread, while every later version of one chain maps identically."""
    return f"{client_id}|{first_version.content_digest()}"


# -- wire format --------------------------------------------------------------
def _encode_report(report: Optional[PairReport]) -> Optional[dict]:
    """``PairReport`` → queue-safe dict.  The certificate crosses as its
    canonical JSON; the frontier (an object graph over the worker's DAGs)
    stays behind — nothing parent-side consumes it."""
    if report is None:
        return None
    return {
        "index": report.index,
        "verdict": report.verdict,
        "wall_time": report.wall_time,
        "stats": report.stats,
        "certificate_json": (
            report.certificate.to_json() if report.certificate is not None else None
        ),
        "reused": report.reused,
        "exec_stats": report.exec_stats,
        "results": report.results,
    }


def _decode_report(payload: Optional[dict]) -> Optional[PairReport]:
    if payload is None:
        return None
    certificate = None
    if payload["certificate_json"] is not None:
        certificate = Certificate.from_json(payload["certificate_json"])
    return PairReport(
        index=payload["index"],
        verdict=payload["verdict"],
        wall_time=payload["wall_time"],
        stats=payload["stats"],
        certificate=certificate,
        reused=payload["reused"],
        exec_stats=payload["exec_stats"],
        results=payload["results"],
    )


# -- worker process -----------------------------------------------------------
def _plane_launches(device) -> Dict[str, int]:
    """The kernel launches of this process's torch plane on ``device``, by
    use (empty before the plane exists: reading never creates it)."""
    plane = plane_registry._INSTANCES.get(("torch", device))
    return getattr(plane, "kernel_launches", {})


def _since(now: Dict[str, int], start: Dict[str, int]) -> Dict[str, int]:
    return {k: v - start.get(k, 0) for k, v in now.items() if v - start.get(k, 0)}


def _worker_main(worker_id, task_q, result_q, config, registry, device, registries=None):
    """One shard's process: serial chain sessions over tier-backed caches.

    Messages in: ``("job", seq, client_id, version, mapping, sources)``,
    ``("drain", barrier_id)``, ``("stop",)``.  Messages out: ``("ok", wid,
    seq, payload)``, ``("err", wid, seq, repr)``, ``("drained", wid,
    barrier_id, stats)``, ``("stopped", wid)``, ``("fatal", wid, repr)``.
    The task queue is FIFO, so by the time a drain barrier is read every
    prior job of this shard has been answered.  The drain stats carry
    ``relational_launches``: the relational kernel's launches in this
    process since it started, and the same launches by plan route
    (``relational_by_route``) and by what asked for them
    (``relational_by_use``: the torch plane's exactness probe, FILTER,
    PROJECT, the delta engine's masks); the port's own keys.  ``registries`` is the
    parent's ``registry_snapshot`` (None for a forked worker, which has the
    parent's registries already).
    """
    torch.set_num_threads(1)
    # a forked child inherits the counts, and the parent's memoized plane
    launches_at_start = R.relational.launches
    routes_at_start = dict(R.relational.launches_by_instance)
    uses_at_start = dict(_plane_launches(device))
    try:
        if registries is not None:
            _install_registries(registries)
        tier = make_tier(
            config.shared_tier,
            config.tier_dir,
            ttl_seconds=config.tier_ttl_seconds,
            byte_budget=config.tier_byte_budget,
        )
        cache = TieredVerdictCache(tier, max_entries=config.cache_max_entries)
        pair_cache = TieredPairCache(tier, registry=registry)
        store = TieredMaterializationStore(tier)
        sessions: Dict[str, VersionChainSession] = {}
        while True:
            msg = task_q.get()
            kind = msg[0]
            if kind == "stop":
                result_q.put(("stopped", worker_id))
                return
            if kind == "drain":
                result_q.put(
                    (
                        "drained",
                        worker_id,
                        msg[1],
                        {
                            "cache_stats": cache.stats(),
                            "pair_cache_stats": pair_cache.stats(),
                            "store_stats": store.stats(),
                            "tier_stats": tier.stats(),
                            "relational_launches": (
                                R.relational.launches - launches_at_start
                            ),
                            "relational_by_route": _since(
                                R.relational.launches_by_instance, routes_at_start),
                            "relational_by_use": _since(
                                _plane_launches(device), uses_at_start),
                        },
                    )
                )
                continue
            _, seq, client_id, version, mapping, sources = msg
            try:
                session = sessions.get(client_id)
                if session is None:
                    session = VersionChainSession(
                        config=config,
                        registry=registry,
                        cache=cache,
                        pair_cache=pair_cache,
                        materialization_store=store,
                        device=device,
                    )
                    sessions[client_id] = session
                report = session.submit(version, mapping, sources=sources)
                result_q.put(("ok", worker_id, seq, _encode_report(report)))
            except Exception as e:
                # a failing job answers its future; the worker lives on
                result_q.put(("err", worker_id, seq, repr(e)))
    except BaseException as e:  # tier/config construction, queue teardown
        try:
            result_q.put(("fatal", worker_id, repr(e)))
        except Exception:
            pass
        raise


# -- parent-side bookkeeping --------------------------------------------------
@dataclass
class _JournaledJob:
    seq: int
    client_id: str
    version: DataflowDAG
    mapping: Optional[EditMapping]
    sources: Optional[dict]


@dataclass
class FleetReport:
    """What ``drain`` returns — the subset of ``ServiceReport`` the replay
    driver consumes (errors + cache stats), plus fleet-only accounting."""

    errors: List[str] = field(default_factory=list)
    cache_stats: Dict[str, object] = field(default_factory=dict)
    pair_cache_stats: Dict[str, object] = field(default_factory=dict)
    store_stats: Dict[str, object] = field(default_factory=dict)
    tier_stats: Dict[str, object] = field(default_factory=dict)
    worker_stats: List[Optional[dict]] = field(default_factory=list)
    recoveries: int = 0
    workers: int = 0

    def summary(self) -> str:
        return (
            f"fleet: {self.workers} workers, {self.recoveries} recoveries, "
            f"{len(self.errors)} errors; "
            f"pair tier hits {self.pair_cache_stats.get('tier_hits', 0)}, "
            f"verdict tier hits {self.cache_stats.get('tier_hits', 0)}"
        )


def _context(device: str):
    """The start method for workers that execute on ``device``: ``fork`` on
    the CPU, else a ``forkserver`` whose server has imported this module
    and nothing of CUDA (see the module docstring)."""
    if str(device).split(":")[0] == "cpu":
        return mp.get_context("fork")
    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload([__name__])
    return ctx


def stop_helper_processes() -> None:
    """Stop the two helper processes of ``multiprocessing`` that a CUDA fleet
    starts and that otherwise live until this process exits: the
    forkserver its workers fork from, and the resource tracker of its
    queues' semaphores.  Call it once every fleet is closed and dropped;
    a later CUDA fleet starts fresh ones.  Running workers are not
    affected."""
    import gc
    from multiprocessing import forkserver, resource_tracker

    forkserver._forkserver._stop()
    gc.collect()  # dropped queues unregister their semaphores first
    resource_tracker._resource_tracker._stop()


def _merge_numeric(dst: Dict[str, object], src: Dict[str, object]) -> None:
    """Aggregate per-worker stat dicts: sum numbers, keep one exemplar of
    anything non-numeric (backend names, budgets)."""
    for k, v in src.items():
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            dst.setdefault(k, v)
        else:
            cur = dst.get(k, 0)
            dst[k] = (cur if isinstance(cur, (int, float)) else 0) + v


class VerificationFleet:
    """N verification worker processes behind a service-shaped front.

    Parameters mirror ``VerificationService`` where they overlap:
    ``config`` (its ``shared_tier``/``tier_dir`` pick the cache tier every
    worker attaches), ``registry``, ``queue_size`` (per-worker bound;
    backpressure raises ``ServiceBusy``) and ``device`` (default
    ``"cuda"``: where every worker's sessions execute).
    ``workers`` is the process count — the fleet's parallelism.

    Linux only.  On the CPU the workers are forked and inherit the config,
    registry and queue ends directly.  On a CUDA device they start from a
    ``forkserver`` that preloads this module, and the config, the registry,
    the queue ends and a snapshot of the UDF and nonlinear registries taken
    here (``registry_snapshot``) are pickled to them: the registry's
    factories and every UDF and nonlinear atom must be importable classes
    or functions, and one that is not (a lambda, a closure) raises
    ``FleetRegistryError`` here, naming it.  A UDF registered after the
    fleet started does not reach its workers.
    As with any ``forkserver`` or ``spawn`` start, each CUDA worker imports
    the parent's main module, so a script that builds a CUDA fleet keeps
    its work under ``if __name__ == "__main__":``.
    Sessions, caches, and the tier are constructed inside each worker,
    never inherited, so worker state is exactly what a fresh single
    process would build.
    """

    def __init__(
        self,
        workers: int = 2,
        *,
        config: Optional[VeerConfig] = None,
        registry: Optional[EVRegistry] = None,
        queue_size: int = 64,
        device: str = "cuda",
    ):
        if workers < 1:
            raise ValueError("need at least one worker")
        if queue_size < 1:
            raise ValueError("queue_size must be positive")
        self.config = (config if config is not None else VeerConfig()).validate()
        self.registry = registry
        self.device = device
        self.queue_size = queue_size
        self.n_workers = workers
        self._ctx = _context(device)
        # a forked worker has the parent's registries; a forkserver's gets them sent
        self._registries = (registry_snapshot()
                            if self._ctx.get_start_method() != "fork" else None)
        self._ring = ConsistentHashRing(workers)
        self._result_qs = [self._ctx.Queue() for _ in range(workers)]
        self._task_qs = [self._ctx.Queue(maxsize=queue_size) for _ in range(workers)]
        self._procs = [self._spawn(i) for i in range(workers)]
        self._lock = threading.Lock()
        self._resolved = threading.Condition(self._lock)
        self._pending: Dict[int, Future] = {}          # seq -> unresolved future
        self._seq = 0
        self._assignments: Dict[str, int] = {}         # client -> shard
        self._journals: List[List[_JournaledJob]] = [[] for _ in range(workers)]
        self._shard_locks = [threading.Lock() for _ in range(workers)]
        self._respawns = [0] * workers
        self._shard_lost: List[Optional[str]] = [None] * workers
        self._errors: List[str] = []
        self._drained: Dict[int, Dict[int, dict]] = {}  # barrier -> wid -> stats
        self._barrier = 0
        self._stopped: set = set()
        self._recoveries = 0
        self._closed = False
        self._collector_stop = threading.Event()
        self._readers = [
            self._start_reader(i, self._result_qs[i]) for i in range(workers)
        ]

    # -- public API ----------------------------------------------------------
    def submit(
        self,
        client_id: str,
        version: DataflowDAG,
        mapping: Optional[EditMapping] = None,
        *,
        sources=None,
        block: bool = True,
        timeout: Optional[float] = None,
    ) -> "Future[Optional[PairReport]]":
        """Enqueue a version for ``client_id``'s chain on its shard.

        Same contract as ``VerificationService.submit``: a Future of the
        pair's ``PairReport`` (None for the first version), strict
        per-client submission order, ``ServiceBusy`` on a full shard queue
        when ``block=False`` (or the timeout lapses)."""
        with self._lock:
            if self._closed:
                raise ServiceClosed("fleet is closed")
            shard = self._assignments.get(client_id)
            if shard is None:
                shard = self._ring.node(shard_key(client_id, version))
                self._assignments[client_id] = shard
            lost = self._shard_lost[shard]
        if lost is not None:
            raise FleetWorkerLost(lost)
        self._ensure_alive(shard)
        future: Future = Future()
        # the shard lock makes (seq allocation, queue insertion, journal
        # append) atomic per shard, so journal order == queue order ==
        # the replay order a replacement worker sees
        with self._shard_locks[shard]:
            with self._lock:
                seq = self._seq
                self._seq += 1
                self._pending[seq] = future
            try:
                self._task_qs[shard].put(
                    ("job", seq, client_id, version, mapping, sources),
                    block=block,
                    timeout=timeout,
                )
            except BaseException as e:
                with self._lock:
                    self._pending.pop(seq, None)
                if isinstance(e, stdlib_queue.Full):
                    raise ServiceBusy("shard queue is full") from None
                raise
            self._journals[shard].append(
                _JournaledJob(seq, client_id, version, mapping, sources)
            )
        return future

    def drain(self) -> FleetReport:
        """Block until every accepted job is answered and every live worker
        has passed a drain barrier; aggregate stats.  Dead workers found on
        the way are replaced and their shard journals replayed — drain
        returns only when the recovered work is answered too."""
        while True:
            barrier = self._post_barrier()
            if self._await_barrier(barrier):
                break
            # a worker died mid-drain: recover (journal replay) and re-run
            # the whole barrier so replacements get their own drain marker
        report = FleetReport(workers=self.n_workers, recoveries=self._recoveries)
        with self._lock:
            report.errors = list(self._errors)
            stats = self._drained.pop(barrier, {})
        report.worker_stats = [stats.get(i) for i in range(self.n_workers)]
        for ws in report.worker_stats:
            if ws is None:
                continue
            _merge_numeric(report.cache_stats, ws["cache_stats"])
            _merge_numeric(report.pair_cache_stats, ws["pair_cache_stats"])
            _merge_numeric(report.store_stats, ws["store_stats"])
            _merge_numeric(report.tier_stats, ws["tier_stats"])
        return report

    def close(self) -> None:
        """Drain, stop the workers, reap the collector.  Idempotent."""
        with self._lock:
            if self._closed:
                return
        try:
            self.drain()
        finally:
            with self._lock:
                self._closed = True
            for i, proc in enumerate(self._procs):
                if proc.is_alive():
                    try:
                        self._task_qs[i].put(("stop",), timeout=5.0)
                    except Exception:
                        pass
            deadline = time.perf_counter() + 10.0
            for proc in self._procs:
                proc.join(timeout=max(0.1, deadline - time.perf_counter()))
                if proc.is_alive():
                    proc.terminate()
                    proc.join(timeout=5.0)
            self._collector_stop.set()
            for t in self._readers:
                t.join(timeout=1.0)  # torn-queue stragglers stay daemonized
            # abandon every queue: a feeder thread left blocked on a pipe
            # whose reader died (killed worker) would otherwise hang
            # interpreter shutdown in multiprocessing's atexit join
            for q in (*self._task_qs, *self._result_qs):
                self._abandon_queue(q)
            with self._lock:
                for fut in self._pending.values():
                    if not fut.done():
                        fut.set_exception(ServiceClosed("fleet closed"))
                self._pending.clear()

    def __enter__(self) -> "VerificationFleet":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- internals ------------------------------------------------------------
    @staticmethod
    def _abandon_queue(q) -> None:
        """Give up on a queue whose peer process is gone: never flush-join
        its feeder at exit (it may be blocked on a dead pipe forever) and
        release its fds.  Data loss is fine — the journal is authoritative."""
        try:
            q.cancel_join_thread()
            q.close()
        except Exception:
            pass

    def _spawn(self, worker_id: int):
        proc = self._ctx.Process(
            target=_worker_main,
            name=f"veer-fleet-{worker_id}",
            args=(
                worker_id,
                self._task_qs[worker_id],
                self._result_qs[worker_id],
                self.config,
                self.registry,
                self.device,
                self._registries,
            ),
            daemon=True,
        )
        proc.start()
        return proc

    def _start_reader(self, worker_id: int, q) -> threading.Thread:
        t = threading.Thread(
            target=self._read_results,
            args=(q,),
            name=f"veer-fleet-reader-{worker_id}",
            daemon=True,
        )
        t.start()
        return t

    def _read_results(self, q) -> None:
        """One result queue's consumer.  Per-queue threads (never one
        shared loop): a worker killed mid-``put`` leaves a torn message
        that makes any read of *that* queue block forever — here that
        strands only this daemon thread, while recovery swaps in a fresh
        queue with a fresh reader and the journal replay re-produces
        whatever the torn queue still held."""
        while not self._collector_stop.is_set():
            try:
                msg = q.get(timeout=0.2)
            except stdlib_queue.Empty:
                continue
            except Exception:
                return  # queue torn down (close) or corrupt (abandoned)
            self._handle(msg)

    def _handle(self, msg) -> None:
        kind = msg[0]
        if kind == "ok":
            _, _wid, seq, payload = msg
            with self._lock:
                fut = self._pending.pop(seq, None)
                self._resolved.notify_all()
            if fut is not None and not fut.done():
                # decode outside the lock; a replayed duplicate of an
                # already-resolved seq was popped long ago and skipped
                fut.set_result(_decode_report(payload))
        elif kind == "err":
            _, wid, seq, detail = msg
            with self._lock:
                fut = self._pending.pop(seq, None)
                if fut is not None:
                    self._errors.append(f"worker {wid}: {detail}")
                self._resolved.notify_all()
            if fut is not None and not fut.done():
                fut.set_exception(RuntimeError(detail))
        elif kind == "drained":
            _, wid, barrier, stats = msg
            with self._lock:
                self._drained.setdefault(barrier, {})[wid] = stats
                self._resolved.notify_all()
        elif kind == "stopped":
            with self._lock:
                self._stopped.add(msg[1])
                self._resolved.notify_all()
        elif kind == "fatal":
            _, wid, detail = msg
            with self._lock:
                self._errors.append(f"worker {wid} fatal: {detail}")
                self._resolved.notify_all()

    def _post_barrier(self) -> int:
        with self._lock:
            self._barrier += 1
            barrier = self._barrier
        for i in range(self.n_workers):
            if self._shard_lost[i] is None and self._procs[i].is_alive():
                try:
                    self._task_qs[i].put(("drain", barrier), timeout=30.0)
                except Exception:
                    pass  # found dead next poll; barrier re-runs after recovery
        return barrier

    def _await_barrier(self, barrier: int) -> bool:
        """Wait for the barrier on every live shard and all pending futures.
        Returns False if a worker died and was recovered (caller re-runs)."""
        while True:
            with self._lock:
                live = [
                    i for i in range(self.n_workers) if self._shard_lost[i] is None
                ]
                done = self._drained.get(barrier, {})
                if all(i in done for i in live) and not self._pending:
                    return True
                self._resolved.wait(timeout=_DRAIN_POLL)
            recovered = False
            for i in range(self.n_workers):
                if self._shard_lost[i] is None and not self._procs[i].is_alive():
                    self._recover(i)
                    recovered = True
            if recovered:
                return False

    def _ensure_alive(self, shard: int) -> None:
        if not self._procs[shard].is_alive():
            self._recover(shard)

    def _recover(self, shard: int) -> None:
        """Replace a dead worker and replay its journal.  Already-answered
        jobs recompute to rebuild chain state (their duplicate results are
        dropped by the collector); unanswered ones resolve normally."""
        with self._shard_locks[shard]:
            proc = self._procs[shard]
            if proc.is_alive() or self._shard_lost[shard] is not None:
                return  # raced another recoverer, or already written off
            proc.join(timeout=1.0)
            self._respawns[shard] += 1
            with self._lock:
                self._recoveries += 1
            if self._respawns[shard] > MAX_RESPAWNS_PER_SHARD:
                detail = (
                    f"shard {shard} worker died "
                    f"{self._respawns[shard]} times; giving up"
                )
                self._shard_lost[shard] = detail
                self._fail_shard(shard, detail)
                return
            # both of the dead worker's queues are suspect — the task queue
            # may hold undelivered jobs whose feeder is now blocked on a
            # pipe nobody will ever read, and the result queue may be torn
            # mid-``put`` (its internal write lock died held).  Abandon
            # both, start fresh, replay the authoritative journal.
            self._abandon_queue(self._task_qs[shard])
            self._abandon_queue(self._result_qs[shard])
            self._task_qs[shard] = self._ctx.Queue(maxsize=self.queue_size)
            fresh_q = self._ctx.Queue()
            with self._lock:
                self._result_qs[shard] = fresh_q
            self._readers.append(self._start_reader(shard, fresh_q))
            self._procs[shard] = self._spawn(shard)
            for job in self._journals[shard]:
                try:
                    self._task_qs[shard].put(
                        ("job", job.seq, job.client_id, job.version,
                         job.mapping, job.sources),
                        timeout=60.0,
                    )
                except stdlib_queue.Full:
                    # the replacement died already (its next liveness poll
                    # triggers another recovery against a fresh queue, which
                    # replays the whole journal again) — stop pushing here
                    break

    def _fail_shard(self, shard: int, detail: str) -> None:
        journal_seqs = {j.seq for j in self._journals[shard]}
        with self._lock:
            self._errors.append(detail)
            for seq in list(self._pending):
                if seq in journal_seqs:
                    fut = self._pending.pop(seq)
                    if not fut.done():
                        fut.set_exception(FleetWorkerLost(detail))
            self._resolved.notify_all()
