"""``SharedTier`` — the pluggable storage protocol behind the three caches.

A single verification process keeps three in-memory maps hot: window
verdicts (``VerdictCache``), whole-pair verdicts with their certificates
(``PairVerdictCache``), and operator materializations
(``MaterializationStore``).  Scaling past one process means those maps must be *shareable* across
worker processes without weakening any of the digest guards that make
reuse sound.  ``SharedTier`` is the seam: the in-process caches stay
exactly as they are and gain a read-through/write-through second level
(``repro_torch.service.remote.adapters``), and the tier decides where that
level lives:

  * ``LocalTier`` — plain in-process dicts under a lock.  This is today's
    behavior restated behind the protocol: nothing crosses a process
    boundary, entries are trusted because this process wrote them.
  * ``FileTier`` (``repro_torch.service.remote.filetier``) — a shared directory
    with fcntl-locked, content-addressed, refcounted, TTL/byte-budget
    evicted entries, usable by every worker process of a
    ``VerificationFleet`` at once.

The ``trusted`` flag is the load-bearing difference: a trusted tier's
pair entries may be served as-is (same trust as the in-memory dict they
replace), while an untrusted tier's pair hits must first pass a
pair-bound certificate replay (see ``adapters.TieredPairCache``) — a
remote verdict is *evidence to re-check*, never an answer to believe.

Leases give cross-process single-flight: ``lease(name)`` returns a
``Lease`` whose ``acquire(block=False)`` succeeds for exactly one holder
at a time; with ``FileTier`` the lock is an ``fcntl.flock`` the kernel
releases when the holder dies, so a crashed owner can never wedge the
other workers.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, Optional, Protocol, Tuple, runtime_checkable

from repro_torch.engine.table import Table


@dataclass(frozen=True)
class PairRecord:
    """One decided pair as a tier stores it: the verdict, the certificate
    JSON (the serialization contract — never pickled objects), and the
    cost the original run paid so hits can account the work avoided."""

    verdict: bool
    certificate_json: Optional[str]
    ev_calls_avoided: int
    ev_time_avoided: float


class Lease:
    """In-process lease: a non-reentrant try-lock with polling ``wait``.

    ``FileTier`` subclasses this with an fcntl-backed variant; both share
    the contract that at most one holder has ``acquire`` succeed at a
    time, and that ``release`` is idempotent (double-release is a no-op —
    the fault-injection suite leans on this).
    """

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self._held = False

    def acquire(self, block: bool = False, timeout: float = 0.0) -> bool:
        if self._held:
            return True
        if block:
            self._held = self._lock.acquire(timeout=max(timeout, 0.0))
        else:
            self._held = self._lock.acquire(blocking=False)
        return self._held

    def wait(self, timeout: float, poll: float = 0.02) -> bool:
        """Poll-acquire until the current holder releases (or ``timeout``).
        Returns True iff the lease was acquired — the caller is then the
        new holder and must ``release``."""
        deadline = time.perf_counter() + timeout
        while not self.acquire(block=False):
            if time.perf_counter() >= deadline:
                return False
            time.sleep(poll)
        return True

    def release(self) -> None:
        if self._held:
            self._held = False
            self._lock.release()

    def __enter__(self) -> "Lease":
        self.acquire(block=True, timeout=60.0)
        return self

    def __exit__(self, *exc) -> None:
        self.release()


@runtime_checkable
class SharedTier(Protocol):
    """What the cache adapters need from a shared second level.

    Every ``get_*`` returns ``None`` on a miss — and a *damaged* entry
    (truncated file, digest mismatch, expired TTL) must also read as
    ``None`` with a counter bumped, never as wrong bytes or an exception.
    """

    #: True when entries are as trustworthy as this process's own memory
    #: (LocalTier); False when hits must be re-validated before serving
    #: (FileTier — certificate replay gates every remote pair hit).
    trusted: bool

    # -- window verdicts ----------------------------------------------------
    def get_verdict(
        self, ev_name: str, fingerprint: str
    ) -> Optional[Tuple[Optional[bool], float]]: ...

    def put_verdict(
        self, ev_name: str, fingerprint: str,
        verdict: Optional[bool], elapsed: float,
    ) -> None: ...

    def get_validity(self, ev_name: str, fingerprint: str) -> Optional[bool]: ...

    def put_validity(self, ev_name: str, fingerprint: str, valid: bool) -> None: ...

    # -- whole-pair verdicts + certificates ----------------------------------
    def get_pair(self, key: str) -> Optional[PairRecord]: ...

    def put_pair(self, key: str, record: PairRecord) -> None: ...

    # -- materializations ----------------------------------------------------
    def get_table(self, key: str) -> Optional[Tuple[Table, float]]: ...

    def put_table(self, key: str, table: Table, elapsed: float = 0.0) -> None: ...

    def release_table(self, key: str) -> None: ...

    # -- cross-process single-flight -----------------------------------------
    def lease(self, name: str) -> Lease: ...

    def stats(self) -> Dict[str, object]: ...


class LocalTier:
    """The local-dict backend: today's in-process sharing, behind the
    protocol.  Thread-safe; nothing persists, nothing crosses a process.

    TTL and byte budgets are accepted for interface parity but the local
    tier does not evict — the in-process caches it backs already carry
    their own LRU bounds (``VerdictCache.max_entries``,
    ``MaterializationStore`` byte budgets), so a second bound here would
    only duplicate accounting.
    """

    trusted = True

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._verdicts: Dict[Tuple[str, str], Tuple[Optional[bool], float]] = {}
        self._validity: Dict[Tuple[str, str], bool] = {}
        self._pairs: Dict[str, PairRecord] = {}
        self._tables: Dict[str, Tuple[Table, float]] = {}
        self._leases: Dict[str, threading.Lock] = {}
        self.hits = 0
        self.misses = 0

    # -- window verdicts ----------------------------------------------------
    def get_verdict(self, ev_name, fingerprint):
        with self._lock:
            got = self._verdicts.get((ev_name, fingerprint))
            self._count(got)
            return got

    def put_verdict(self, ev_name, fingerprint, verdict, elapsed):
        with self._lock:
            self._verdicts[(ev_name, fingerprint)] = (verdict, float(elapsed))

    def get_validity(self, ev_name, fingerprint):
        with self._lock:
            got = self._validity.get((ev_name, fingerprint))
            self._count(got)
            return got

    def put_validity(self, ev_name, fingerprint, valid):
        with self._lock:
            self._validity[(ev_name, fingerprint)] = bool(valid)

    # -- pairs ---------------------------------------------------------------
    def get_pair(self, key):
        with self._lock:
            got = self._pairs.get(key)
            self._count(got)
            return got

    def put_pair(self, key, record):
        with self._lock:
            self._pairs[key] = record

    # -- tables --------------------------------------------------------------
    def get_table(self, key):
        with self._lock:
            got = self._tables.get(key)
            self._count(got)
            return got

    def put_table(self, key, table, elapsed=0.0):
        with self._lock:
            self._tables[key] = (table, float(elapsed))

    def release_table(self, key):
        with self._lock:
            self._tables.pop(key, None)

    # -- leases --------------------------------------------------------------
    def lease(self, name: str) -> Lease:
        with self._lock:
            lock = self._leases.setdefault(name, threading.Lock())
        return Lease(lock)

    # -- stats ---------------------------------------------------------------
    def _count(self, got) -> None:  # caller holds the lock
        if got is None:
            self.misses += 1
        else:
            self.hits += 1

    def stats(self) -> Dict[str, object]:
        with self._lock:
            return {
                "backend": "local",
                "verdicts": len(self._verdicts),
                "validity": len(self._validity),
                "pairs": len(self._pairs),
                "tables": len(self._tables),
                "hits": self.hits,
                "misses": self.misses,
            }


def make_tier(
    shared_tier: str,
    tier_dir: Optional[str] = None,
    *,
    ttl_seconds: Optional[float] = None,
    byte_budget: Optional[int] = None,
):
    """Build the tier a config names: ``"local"`` → ``LocalTier`` (the
    default, today's behavior), ``"remote"`` → a ``FileTier`` rooted at
    ``tier_dir`` (required).  This is the single construction point the
    service and the fleet workers use."""
    if shared_tier == "local":
        return LocalTier()
    if shared_tier == "remote":
        if tier_dir is None:
            raise ValueError("shared_tier='remote' needs a tier_dir")
        from repro_torch.service.remote.filetier import FileTier

        return FileTier(
            tier_dir, ttl_seconds=ttl_seconds, byte_budget=byte_budget
        )
    raise ValueError(f"unknown shared tier {shared_tier!r}")
