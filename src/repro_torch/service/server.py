"""Concurrent verification service: many clients, one verdict store.

``VersionChainSession`` answers one client's chain; this module multiplexes
*N* concurrent sessions over a shared ``VerdictCache``/``EVRegistry`` — the
GEqO observation that equivalence detection pays off at cloud scale only
when the verifier front-end is cheap and parallel, applied to Veer's
windowed search.  The design (see docs/ARCHITECTURE.md, concurrency model):

  * one **bounded job queue** (``queue_size``) gives backpressure: ``submit``
    blocks (or raises ``ServiceBusy``) when the service is saturated instead
    of buffering unboundedly;
  * a fixed **worker pool** drains the queue.  Jobs of the same client are
    serialized *in submission order* via per-session tickets — a chain
    session is stateful (pair k needs pair k-1's predecessor), so its jobs
    must never run concurrently or out of order — while jobs of different
    clients run in parallel;
  * all sessions share one thread-safe ``VerdictCache``: the first client to
    pay for a window verdict answers it for every other client (and for the
    next process, via ``save``'s atomic snapshot);
  * every verdict keeps its replayable ``Certificate`` — concurrency never
    downgrades auditable evidence to trust-me.

Execute-with-reuse sessions inherit their data plane from the shared
``VeerConfig`` (``plane="torch"``, the default, runs every client's chains
through the relational CUDA kernel on ``device``; ``plane="numpy"`` on the
host) — planes are byte-identical by contract, so this changes throughput,
never results.  ``device`` (default ``"cuda"``) is passed to every client's
``VersionChainSession``; the service itself never touches the device, and
without CUDA an executing submit fails its future with ``PlaneError``
unless the service is built with ``device="cpu"``.  The sessions run on
the service's threads, which share the process's CUDA context and stream.

Typical use::

    from repro_torch.api import VeerConfig
    from repro_torch.service import VerificationService

    with VerificationService(config=VeerConfig(), workers=4,
                             device="cuda") as svc:
        for client, version in incoming:
            svc.submit(client, version)       # Future[PairReport | None]
        report = svc.drain()                  # wait; aggregate stats
        print(report.summary())

``submit_pair`` is the stateless one-shot sibling (no session, any worker):
it verifies a single ``(P, Q)`` pair on the shared cache and resolves to a
``repro_torch.api.VerificationResult``.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.api.config import VeerConfig
from repro_torch.api.facade import VerificationResult, verify
from repro_torch.api.registry import EVRegistry
from repro_torch.core.dag import DataflowDAG
from repro_torch.core.edits import EditMapping
from repro_torch.core.ev.cache import VerdictCache
from repro_torch.service.chain import ChainReport, PairReport, VersionChainSession
from repro_torch.service.pair_cache import PairVerdictCache
from repro_torch.service.remote.adapters import TieredPairCache, TieredVerdictCache
from repro_torch.service.remote.tier import make_tier


class ServiceClosed(RuntimeError):
    """Submit after ``close()`` (the worker pool is gone)."""


class ServiceBusy(RuntimeError):
    """The bounded queue is full and the caller declined to wait."""


@dataclass
class ServiceReport:
    """Aggregate over everything the service verified up to ``drain``."""

    sessions: Dict[str, ChainReport]
    pair_results: List[VerificationResult]
    errors: List[str]
    cache_stats: Dict[str, object] = field(default_factory=dict)
    pair_cache_stats: Dict[str, object] = field(default_factory=dict)

    @property
    def reused_pairs(self) -> int:
        """Pairs answered wholesale from the shared pair-verdict cache
        (chain-session pairs and one-shot ``submit_pair`` results alike)."""
        return sum(r.reused_pairs for r in self.sessions.values()) + sum(
            1 for p in self.pair_results if p.reused
        )

    @property
    def total_pairs(self) -> int:
        return sum(len(r.pairs) for r in self.sessions.values()) + len(
            self.pair_results
        )

    @property
    def total_ev_calls(self) -> int:
        return sum(r.total_ev_calls for r in self.sessions.values()) + sum(
            p.stats.ev_calls for p in self.pair_results
        )

    @property
    def total_ev_calls_saved(self) -> int:
        return sum(r.total_ev_calls_saved for r in self.sessions.values()) + sum(
            p.stats.ev_calls_saved for p in self.pair_results
        )

    @property
    def certified_pairs(self) -> int:
        return sum(r.certified_pairs for r in self.sessions.values()) + sum(
            1 for p in self.pair_results if p.certified
        )

    def summary(self) -> str:
        lines = []
        for client in sorted(self.sessions):
            r = self.sessions[client]
            lines.append(
                f"client {client}: {len(r.pairs)} pairs, "
                f"{r.certified_pairs} certified, {r.total_ev_calls} EV calls, "
                f"{r.total_ev_calls_saved} saved"
            )
        lines.append(
            f"service: {self.total_pairs} pairs "
            f"({self.certified_pairs} certified, {self.reused_pairs} reused), "
            f"{self.total_ev_calls} EV calls, "
            f"{self.total_ev_calls_saved} saved, "
            f"{len(self.errors)} errors"
        )
        return "\n".join(lines)


class _ClientState:
    """One client's session plus the FIFO gate serializing its jobs.

    ``tickets`` hands each submitted job a sequence number; only the job
    whose number equals ``next_ticket`` may run.  A worker that dequeues a
    job that is not ready does **not** wait — it *parks* the job on the
    client and serves other work; whichever worker finishes the client's
    running job advances the ticket and runs the parked successor itself.
    Workers therefore never block on the gate, so one client's burst can
    never stall the pool for other clients, and there is nothing to
    deadlock: every enqueued job is either running, parked behind exactly
    one running job, or in the queue.
    """

    def __init__(self, session: VersionChainSession):
        self.session = session
        self.lock = threading.Lock()
        # held across ticket allocation AND queue insertion, so a ticket
        # abandoned on enqueue failure can never have a later ticket already
        # issued (the abandon fast-forward below stays race-free)
        self.submit_lock = threading.Lock()
        self.tickets = 0     # next ticket to hand out (submit side)
        self.next_ticket = 0  # next ticket allowed to run (worker side)
        self.abandoned: set = set()  # tickets whose job never entered the queue
        self.parked: Dict[int, "_Job"] = {}  # dequeued too early, by ticket


@dataclass
class _Job:
    client: Optional[_ClientState]   # None: stateless one-shot pair job
    ticket: int
    fn: Callable[[], object]
    future: Future


def _fast_forward(state: _ClientState) -> None:
    """Advance past abandoned tickets (caller holds ``state.lock``)."""
    while state.next_ticket in state.abandoned:
        state.abandoned.discard(state.next_ticket)
        state.next_ticket += 1


_STOP = object()


class VerificationService:
    """Multiplexes concurrent verification sessions over one shared cache.

    Parameters
    ----------
    config:
        The ``VeerConfig`` every session (and one-shot verifier) is built
        from.  Its ``max_workers`` still controls *intra-pair* window
        parallelism; ``workers`` below is the *inter-client* pool.
    registry:
        EV registry sessions resolve their EVs from (default roster).
    cache:
        A shared ``VerdictCache``; defaults to one built from
        ``config.cache_path`` (in-memory when unset).
    workers:
        Worker threads draining the job queue — the service's concurrency.
    queue_size:
        Bound of the job queue; ``submit`` blocks (backpressure) or raises
        ``ServiceBusy`` when full.
    share_pair_verdicts:
        Attach a shared ``PairVerdictCache``: content-identical pairs
        submitted by different clients (or repeatedly by one) are decided
        once — concurrent duplicates coalesce onto a single search whose
        verdict and certificate every waiter reuses.  On by default; turn
        off to force every client to run its own searches.
    materialization_store:
        A shared, thread-safe ``repro_torch.engine.MaterializationStore``
        (both built-in stores lock internally).  Enables execute-with-reuse
        per client: ``submit(..., sources=...)`` executes the version's
        changed cone only, seeded from the pair certificate's frontier —
        equivalent results materialized by *any* client's chain are
        content-addressed, so clients evolving the same pipeline share
        tables the same way they share verdicts.
    device:
        Where every session's executing submits run the torch plane
        (``"cuda"`` unless the caller asks for ``"cpu"``).
    """

    def __init__(
        self,
        config: Optional[VeerConfig] = None,
        *,
        registry: Optional[EVRegistry] = None,
        cache: Optional[VerdictCache] = None,
        workers: int = 4,
        queue_size: int = 64,
        share_pair_verdicts: bool = True,
        materialization_store=None,
        device: str = "cuda",
    ):
        if workers < 1:
            raise ValueError("need at least one worker")
        if queue_size < 1:
            raise ValueError("queue_size must be positive")
        self.config = config if config is not None else VeerConfig()
        self.registry = registry
        # config.shared_tier="remote" attaches the FileTier as a second
        # cache level (same tier a VerificationFleet's workers mount, so a
        # service and a fleet can share one directory of verdicts/tables);
        # explicitly passed caches always win over tier construction
        tier = None
        if self.config.shared_tier == "remote":
            tier = make_tier(
                self.config.shared_tier,
                self.config.tier_dir,
                ttl_seconds=self.config.tier_ttl_seconds,
                byte_budget=self.config.tier_byte_budget,
            )
        self.tier = tier
        if cache is not None:
            self.cache = cache
        elif tier is not None:
            self.cache = TieredVerdictCache(
                tier,
                self.config.cache_path,
                max_entries=self.config.cache_max_entries,
            )
        else:
            self.cache = VerdictCache(
                self.config.cache_path,
                max_entries=self.config.cache_max_entries,
            )
        if not share_pair_verdicts:
            self.pair_cache = None
        elif tier is not None:
            self.pair_cache = TieredPairCache(tier, registry=registry)
        else:
            self.pair_cache = PairVerdictCache()
        self.materialization_store = materialization_store
        self.device = device
        self._queue: "queue.Queue[object]" = queue.Queue(maxsize=queue_size)
        self._clients: Dict[str, _ClientState] = {}
        self._lock = threading.Lock()
        # _submitting: submits in flight between their closed-check and
        # their enqueue; _pending: enqueued-but-unfinished jobs (queued,
        # parked, or running — queue.join() can't serve here because parked
        # jobs leave the queue before they run).  drain() and close() wait
        # for BOTH to reach zero on one shared condition, so neither can
        # return while a submit it raced is still materializing its job.
        self._submitting = 0
        self._pending = 0
        self._progress = threading.Condition(self._lock)
        # unsettled futures only; drain() folds settled ones into the
        # persistent aggregates below and drops them
        self._pair_futures: List[Future] = []
        self._chain_futures: List[Tuple[str, Future]] = []
        self._errors: List[str] = []
        self._pair_results: List[VerificationResult] = []
        self._oneshot_veers: List[object] = []  # per-worker thread-local Veers
        self._closed = False
        self._local = threading.local()  # per-worker Veer for one-shot pairs
        self._workers = [
            threading.Thread(
                target=self._worker_loop, name=f"veer-svc-{i}", daemon=True
            )
            for i in range(workers)
        ]
        for t in self._workers:
            t.start()

    # -- public API ----------------------------------------------------------
    def session(self, client_id: str) -> VersionChainSession:
        """The (auto-created) chain session behind ``client_id``."""
        return self._client(client_id).session

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
        """Enqueue a version for ``client_id``'s chain; returns a Future.

        The Future resolves to the pair's ``PairReport`` (None for the
        client's first version).  Jobs of one client run strictly in
        submission order; the call blocks when the queue is full unless
        ``block=False``/``timeout`` asks for ``ServiceBusy`` instead.
        ``sources`` opts this version into execute-with-reuse (needs the
        service's ``materialization_store``; see ``VersionChainSession``).
        """
        state = self._client(client_id)  # built outside the service lock
        with self._lock:
            if self._closed:
                raise ServiceClosed("service is closed")
            self._submitting += 1
        future: Future = Future()
        try:
            # ticket allocation and queue insertion must be one atomic step
            # per client: if they could interleave, a later ticket could
            # enter the queue first and every worker would wait on a job
            # still queued behind it.  The per-client lock serializes
            # same-client submitters only; other clients are unaffected.
            with state.submit_lock:
                ticket = state.tickets
                state.tickets += 1
                job = _Job(
                    client=state,
                    ticket=ticket,
                    fn=lambda: state.session.submit(
                        version, mapping, sources=sources
                    ),
                    future=future,
                )
                self._enqueue(job, block, timeout)
            with self._lock:
                self._chain_futures.append((client_id, future))
        finally:
            with self._lock:
                self._submitting -= 1
                self._progress.notify_all()
        return future

    def submit_pair(
        self,
        P: DataflowDAG,
        Q: DataflowDAG,
        mapping: Optional[EditMapping] = None,
        *,
        block: bool = True,
        timeout: Optional[float] = None,
    ) -> "Future[VerificationResult]":
        """One-shot pair verification on the shared cache (no session state,
        any worker, no ordering constraint)."""
        with self._lock:
            if self._closed:
                raise ServiceClosed("service is closed")
            self._submitting += 1
        future: Future = Future()
        try:
            job = _Job(
                client=None,
                ticket=0,
                fn=lambda: self._verify_pair(P, Q, mapping),
                future=future,
            )
            self._enqueue(job, block, timeout)  # rejected jobs are never tracked
            with self._lock:
                self._pair_futures.append(future)
        finally:
            with self._lock:
                self._submitting -= 1
                self._progress.notify_all()
        return future

    def drain(self) -> ServiceReport:
        """Block until every submitted job has run; aggregate the results.

        Safe to call repeatedly — each call reports the cumulative state.
        Job exceptions are collected into ``errors`` (they are also set on
        the individual Futures); they never kill a worker.  Settled futures
        are folded into compact per-service aggregates and dropped, so a
        long-running service does not retain one Future per job ever
        submitted (nor rescan its whole history on every drain).
        """
        with self._lock:
            # wait for in-flight submits too: a submit past its closed-check
            # but before its enqueue is work this drain must cover
            while self._submitting or self._pending:
                self._progress.wait()
        with self._lock:
            # fold settled futures into the persistent aggregates, keep
            # only the (rare) ones whose tracking append raced the worker
            pending_chain = []
            for client_id, f in self._chain_futures:
                if not f.done():
                    pending_chain.append((client_id, f))
                    continue
                if f.cancelled():
                    continue  # caller withdrew the job; not a service error
                exc = f.exception()
                if exc is not None:
                    self._errors.append(f"{client_id}: {exc!r}")
            self._chain_futures = pending_chain
            pending_pair = []
            for f in self._pair_futures:
                if not f.done():
                    pending_pair.append(f)
                    continue
                if f.cancelled():
                    continue  # caller withdrew the job; not a service error
                exc = f.exception()
                if exc is not None:
                    self._errors.append(f"pair: {exc!r}")
                else:
                    self._pair_results.append(f.result())
            self._pair_futures = pending_pair
            # snapshot: the live ChainReports keep growing if the caller
            # submits after drain, so hand out copies like errors/pair_results
            sessions = {
                cid: ChainReport(
                    pairs=list(st.session.report().pairs),
                    initial_exec=st.session.report().initial_exec,
                )
                for cid, st in self._clients.items()
            }
            errors = list(self._errors)
            pair_results = list(self._pair_results)
        return ServiceReport(
            sessions=sessions,
            pair_results=pair_results,
            errors=errors,
            cache_stats=self.cache.stats(),
            pair_cache_stats=(
                self.pair_cache.stats() if self.pair_cache is not None else {}
            ),
        )

    def save(self) -> None:
        """Persist the shared verdict cache (atomic snapshot)."""
        self.cache.save()

    def close(self, *, save: bool = True) -> None:
        """Drain, stop the workers, optionally persist the cache."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            # wait out submits already past their closed-check and all
            # enqueued jobs: after this, no job can land behind the stop
            # sentinels and nothing is left queued, parked, or running
            while self._submitting or self._pending:
                self._progress.wait()
        for _ in self._workers:
            self._queue.put(_STOP)
        for t in self._workers:
            t.join()
        # defensive sweep: the barriers above mean no job should be able to
        # land behind the stop sentinels, but if one ever does, fail its
        # future instead of leaving it pending forever
        while True:
            try:
                job = self._queue.get_nowait()
            except queue.Empty:
                break
            if job is not _STOP and not job.future.done():
                job.future.set_exception(ServiceClosed("service closed"))
        for state in self._clients.values():
            state.session.veer.close()
        for veer in self._oneshot_veers:
            veer.close()  # per-worker verifiers' window pools
        if save:
            self.save()

    def __enter__(self) -> "VerificationService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- internals -----------------------------------------------------------
    def _client(self, client_id: str) -> _ClientState:
        """Get-or-create a client's state.  Called WITHOUT the service lock:
        session construction (config validation, EV instantiation, verifier
        wiring) must not stall unrelated clients' submits behind the global
        lock.  Racing creators build two sessions; ``setdefault`` keeps the
        first and the loser's fresh, never-used session is discarded."""
        with self._lock:
            state = self._clients.get(client_id)
        if state is not None:
            return state
        session = VersionChainSession(
            config=self.config,
            registry=self.registry,
            cache=self.cache,
            pair_cache=self.pair_cache,
            materialization_store=self.materialization_store,
            device=self.device,
        )
        with self._lock:
            return self._clients.setdefault(client_id, _ClientState(session))

    def _enqueue(self, job: _Job, block: bool, timeout: Optional[float]) -> None:
        # count the job BEFORE it can possibly run: a worker could dequeue
        # and finish it between put and a later increment, letting a racing
        # drain() observe a stale count (hang, or return before the job ran)
        with self._lock:
            self._pending += 1
        try:
            self._queue.put(job, block=block, timeout=timeout)
        except BaseException as e:
            with self._lock:
                self._pending -= 1
                self._progress.notify_all()
            # the job never entered the queue (queue full, or e.g. a
            # KeyboardInterrupt out of a blocking put): mark its ticket
            # abandoned so the gate skips it and the client's later jobs
            # are not wedged.  submit_lock is held here, so no later ticket
            # exists yet and nothing can be parked behind this one.
            if job.client is not None:
                with job.client.lock:
                    job.client.abandoned.add(job.ticket)
            if isinstance(e, queue.Full):
                job.future.set_exception(ServiceBusy("job queue is full"))
                raise ServiceBusy("job queue is full") from None
            if isinstance(e, Exception):
                job.future.set_exception(e)  # defensive: never leave it pending
            raise

    def _verify_pair(
        self,
        P: DataflowDAG,
        Q: DataflowDAG,
        mapping: Optional[EditMapping],
    ) -> VerificationResult:
        if self.pair_cache is None:
            return self._verify_pair_uncoalesced(P, Q, mapping)

        def compute():
            r = self._verify_pair_uncoalesced(P, Q, mapping)
            return r.verdict, r.stats, r.certificate

        key = self.pair_cache.make_key(P, Q, self.config.semantics, mapping)
        verdict, stats, certificate, reused = self.pair_cache.compute_or_reuse(
            key, compute, pair=(P, Q)
        )
        return VerificationResult(
            verdict=verdict,
            stats=stats,
            certificate=certificate,
            config=self.config,
            reused=reused,
        )

    def _verify_pair_uncoalesced(
        self,
        P: DataflowDAG,
        Q: DataflowDAG,
        mapping: Optional[EditMapping],
    ) -> VerificationResult:
        veer = getattr(self._local, "veer", None)
        if veer is None:
            # one verifier per worker thread: fresh EV instances, so only
            # the verdict cache (which has its own lock) is ever shared
            veer = self.config.build(self.registry, cache=self.cache)
            self._local.veer = veer
            with self._lock:
                self._oneshot_veers.append(veer)  # closed with the service
        return verify(P, Q, self.config, mapping=mapping, veer=veer)

    def _worker_loop(self) -> None:
        while True:
            job = self._queue.get()
            if job is _STOP:
                return
            self._run(job)

    def _run(self, job: _Job) -> None:
        state = job.client
        if state is None:
            self._execute(job)
            return
        with state.lock:
            _fast_forward(state)
            if state.next_ticket != job.ticket:
                # not this job's turn: park it and serve other work — the
                # worker finishing the client's running job picks it up.
                # Never blocks, so a burst from one client cannot pin
                # multiple workers while only one of its jobs can run.
                state.parked[job.ticket] = job
                return
        # only the matching ticket reaches here, so the session is never
        # entered by two threads at once; after each job, continue with the
        # client's parked successor (if any) on this same worker
        while job is not None:
            self._execute(job)
            with state.lock:
                state.next_ticket += 1
                _fast_forward(state)
                job = state.parked.pop(state.next_ticket, None)

    def _execute(self, job: _Job) -> None:
        try:
            # a future cancelled while queued/parked must be skipped, not
            # run: set_result on a cancelled future raises InvalidStateError
            # and would kill the worker thread.  For a chain job the ticket
            # still advances (in _run), so the client's later jobs proceed —
            # cancelling removes that version from the chain, cleanly.
            if job.future.set_running_or_notify_cancel():
                try:
                    result = job.fn()
                except BaseException as e:
                    job.future.set_exception(e)
                else:
                    job.future.set_result(result)
        finally:
            with self._lock:
                self._pending -= 1
                self._progress.notify_all()
