"""Tier-backed drop-ins for the three in-process caches.

Each adapter subclasses the cache it replaces and adds the shared tier as
a read-through/write-through second level: local state stays the hot path
(same locks, same LRU bounds, same counters), the tier only sees local
misses and publishes.  Construction is the only difference callers ever
observe — every call site keeps the base-class API.

The trust rules (docs/SCALE_OUT.md §safety):

  * **pair verdicts** — a hit from an *untrusted* tier (``FileTier``) is
    served only after its certificate replays green **bound to the pair**
    (``Certificate.replay(registry, P, Q)``: digest match, fingerprints
    re-derived from the pair, coverage re-checked).  A record with no
    certificate, a failed replay, or a verdict disagreeing with its own
    certificate is a counted miss and the pair is recomputed.
  * **tables** — ``FileTier.get_table`` re-hashes every payload against
    its content address before returning it, so the adapter can promote
    whatever the tier hands back.
  * **window verdicts/validity** — replayed as-is from either tier: the
    persisted ``VerdictCache`` snapshot already carries exactly this trust
    level (a JSON file on disk loaded without re-checking), and the
    fingerprint keying plus EV determinism make a *well-formed* entry
    correct by construction; a malformed one is unlinked and counted by
    the tier before it ever reaches the adapter.

Cross-process single-flight lives in ``TieredPairCache``: the local
``acquire`` coalesces threads of this process, then the owner takes the
tier lease for the pair before computing.  If another process holds it,
the owner waits (bounded); when the lease turns over it re-checks the
tier — the usual outcome is that the other process published and the
search never runs here.  Lease-wait timeout or a dead former holder (the
kernel drops its flock) degrade to duplicate computation, never to a
wrong or missing result.
"""

from __future__ import annotations

import hashlib
import json
import threading
from typing import Callable, Dict, Optional, Tuple

from repro_torch.api.certificate import Certificate
from repro_torch.core.dag import DataflowDAG
from repro_torch.api.registry import EVRegistry
from repro_torch.core.ev.cache import CacheEntry, VerdictCache
from repro_torch.core.verifier import VeerStats
from repro_torch.engine.store import InMemoryMaterializationStore
from repro_torch.engine.table import Table
from repro_torch.service.pair_cache import PairEntry, PairKey, PairVerdictCache
from repro_torch.service.remote.tier import PairRecord, SharedTier

#: how long a pair owner waits on another process's lease before giving up
#: and computing anyway (correct either way — just duplicated work)
LEASE_WAIT_SECONDS = 30.0


class TieredVerdictCache(VerdictCache):
    """``VerdictCache`` with a shared second level for verdicts+validity."""

    def __init__(
        self,
        tier: SharedTier,
        path: Optional[str] = None,
        *,
        autoload: bool = True,
        max_entries: Optional[int] = None,
    ):
        self.tier = tier  # before super().__init__: autoload may call load()
        self.tier_hits = 0
        super().__init__(path, autoload=autoload, max_entries=max_entries)

    def get(self, ev_name: str, fingerprint: str) -> Optional[CacheEntry]:
        entry = super().get(ev_name, fingerprint)
        if entry is not None:
            return entry
        got = self.tier.get_verdict(ev_name, fingerprint)
        if got is None:
            return None
        verdict, elapsed = got
        entry = CacheEntry(verdict, elapsed)
        # promote locally without writing back to the tier (super(), not
        # self: the entry is already there)
        super().put(ev_name, fingerprint, verdict, elapsed)
        with self._lock:
            self.tier_hits += 1
            self.time_saved += elapsed
        return entry

    def put(self, ev_name, fingerprint, verdict, elapsed) -> None:
        super().put(ev_name, fingerprint, verdict, elapsed)
        self.tier.put_verdict(ev_name, fingerprint, verdict, elapsed)

    def get_validity(self, ev_name: str, fingerprint: str) -> Optional[bool]:
        ok = super().get_validity(ev_name, fingerprint)
        if ok is not None:
            return ok
        ok = self.tier.get_validity(ev_name, fingerprint)
        if ok is None:
            return None
        super().put_validity(ev_name, fingerprint, ok)
        with self._lock:
            self.tier_hits += 1
        return ok

    def put_validity(self, ev_name: str, fingerprint: str, valid: bool) -> None:
        super().put_validity(ev_name, fingerprint, valid)
        self.tier.put_validity(ev_name, fingerprint, valid)

    def stats(self) -> Dict[str, object]:
        out = super().stats()
        with self._lock:
            out["tier_hits"] = self.tier_hits
        return out


def _tier_pair_key(key: PairKey) -> str:
    """Stable string form of a ``PairKey`` for tier storage (tuples become
    JSON lists; deterministic across processes, unlike ``repr`` of nested
    structures is not — and unlike ``hash()``, which is salted)."""
    digest, raw, mapping = key
    return json.dumps(
        [
            digest,
            None if raw is None else list(raw),
            None if mapping is None else [list(e) for e in mapping],
        ],
        separators=(",", ":"),
    )


class TieredPairCache(PairVerdictCache):
    """``PairVerdictCache`` with a shared second level and cross-process
    single-flight.  Pair hits that crossed a process boundary are gated by
    pair-bound certificate replay (see module docstring)."""

    def __init__(
        self,
        tier: SharedTier,
        *,
        registry: Optional[EVRegistry] = None,
        max_entries: int = 65_536,
        lease_wait: float = LEASE_WAIT_SECONDS,
    ):
        super().__init__(max_entries=max_entries)
        self.tier = tier
        self.registry = registry
        self.lease_wait = lease_wait
        self._tier_lock = threading.Lock()
        self.tier_hits = 0
        self.tier_replay_rejections = 0
        self.lease_waits = 0

    def compute_or_reuse(
        self,
        key: PairKey,
        compute: Callable,
        *,
        pair: Optional[Tuple[DataflowDAG, DataflowDAG]] = None,
    ):
        entry, _owner = self.acquire(key)
        if entry is not None:
            return self._reuse(entry)
        # this thread owns the local flight; before paying for the search,
        # consult the shared tier, holding the cross-process lease so at
        # most one process fleet-wide computes this pair
        tkey = _tier_pair_key(key)
        entry = self._tier_fetch(tkey, pair)
        if entry is not None:
            self.publish(key, entry)
            return self._reuse(entry)
        lease = self.tier.lease(f"pair:{_lease_name(tkey)}")
        held = lease.acquire(block=False)
        if not held:
            with self._tier_lock:
                self.lease_waits += 1
            held = lease.wait(self.lease_wait)
            # the previous holder resolved (or died): its published result
            # is in the tier now if it ever will be
            entry = self._tier_fetch(tkey, pair)
            if entry is not None:
                if held:
                    lease.release()
                self.publish(key, entry)
                return self._reuse(entry)
        try:
            verdict, stats, certificate = compute()
        except BaseException:
            self.abandon(key)
            if held:
                lease.release()
            raise
        if verdict is None:
            self.abandon(key)  # Unknown: never cached, locally or remotely
        else:
            entry = PairEntry(
                verdict=verdict,
                certificate=certificate,
                ev_calls_avoided=stats.ev_calls + stats.ev_calls_saved,
                ev_time_avoided=stats.ev_time + stats.ev_time_saved,
            )
            self.publish(key, entry)
            self.tier.put_pair(
                tkey,
                PairRecord(
                    verdict=verdict,
                    certificate_json=(
                        certificate.to_json() if certificate is not None else None
                    ),
                    ev_calls_avoided=entry.ev_calls_avoided,
                    ev_time_avoided=entry.ev_time_avoided,
                ),
            )
        if held:
            lease.release()
        return verdict, stats, certificate, False

    # -- internals ------------------------------------------------------------
    def _reuse(self, entry: PairEntry):
        stats = VeerStats(
            verdict=entry.verdict,
            ev_calls_saved=entry.ev_calls_avoided,
            ev_time_saved=entry.ev_time_avoided,
        )
        return entry.verdict, stats, entry.certificate, True

    def _tier_fetch(
        self,
        tkey: str,
        pair: Optional[Tuple[DataflowDAG, DataflowDAG]],
    ) -> Optional[PairEntry]:
        """Tier lookup + the trust gate.  Returns a servable ``PairEntry``
        or None (miss, damaged record, or failed replay — recompute)."""
        record = self.tier.get_pair(tkey)
        if record is None:
            return None
        certificate: Optional[Certificate] = None
        if record.certificate_json is not None:
            try:
                certificate = Certificate.from_json(record.certificate_json)
            except Exception:
                certificate = None
        if not self.tier.trusted:
            # remote entries are evidence, not answers: require a
            # certificate, require it to agree with the stored verdict, and
            # require a green replay *bound to this pair*
            if (
                certificate is None
                or pair is None
                or certificate.verdict is not record.verdict
            ):
                self._reject()
                return None
            try:
                report = certificate.replay(self.registry, pair[0], pair[1])
            except Exception:
                report = None
            if report is None or not report.ok:
                self._reject()
                return None
        with self._tier_lock:
            self.tier_hits += 1
        return PairEntry(
            verdict=record.verdict,
            certificate=certificate,
            ev_calls_avoided=record.ev_calls_avoided,
            ev_time_avoided=record.ev_time_avoided,
        )

    def _reject(self) -> None:
        with self._tier_lock:
            self.tier_replay_rejections += 1

    def stats(self) -> Dict[str, object]:
        out = super().stats()
        with self._tier_lock:
            out["tier_hits"] = self.tier_hits
            out["tier_replay_rejections"] = self.tier_replay_rejections
            out["lease_waits"] = self.lease_waits
        return out


def _lease_name(tkey: str) -> str:
    return hashlib.sha256(tkey.encode()).hexdigest()[:32]


class TieredMaterializationStore(InMemoryMaterializationStore):
    """In-memory store with the tier as a shared second level.

    ``get`` promotes tier hits into local memory; ``put`` writes through.
    Local eviction releases only the local copy; the tier keeps its own
    refcounts and budget.  Digest safety is the tier's job (``FileTier``
    re-hashes payloads on read), so promotion needs no extra checks here.
    """

    def __init__(self, tier: SharedTier, byte_budget: Optional[int] = None):
        super().__init__(byte_budget)
        self.tier = tier
        self.tier_hits = 0

    def get(self, key: str) -> Optional[Table]:
        table = super().get(key)
        if table is not None:
            return table
        got = self.tier.get_table(key)
        if got is None:
            return None
        table, elapsed = got
        super().put(key, table, elapsed)
        with self._lock:
            self.tier_hits += 1
            self.time_saved += elapsed
        return table

    def put(self, key: str, table: Table, elapsed: float = 0.0) -> bool:
        fresh = super().put(key, table, elapsed)
        self.tier.put_table(key, table, elapsed)
        return fresh

    def stats(self) -> Dict[str, object]:
        out = super().stats()
        with self._lock:
            out["tier_hits"] = self.tier_hits
        return out
