"""Pair-level verdict memoization with single-flight coalescing.

The window-level ``VerdictCache`` (``repro_torch.core.ev.cache``) eliminates EV
*calls*, but each pair still pays the full decomposition search — pure
Python that dominates wall time once EV calls are cached.  At service scale
the same *whole pair* recurs constantly: many clients maintain copies of
the same pipeline, re-submit after a no-op edit, or replay a chain a
colleague already verified.  ``PairVerdictCache`` memoizes decided pairs at
that granularity, keyed by the same content digest that binds certificates
(``repro_torch.api.certificate.pair_digest`` over ``(P, Q, semantics)``) plus the
explicitly requested edit mapping — so a hit returns the *original run's
certificate*, which by construction replays green against the pair.

Soundness: digest equality means the two DAGs are content-identical
(signatures cover operators, links, parameters), so the cached verdict and
certificate apply verbatim.  Unknown verdicts are never cached — they can
be budget-dependent and carry no certificate.

Concurrency: ``acquire`` implements *single-flight* — when N threads miss
on the same key simultaneously, exactly one becomes the owner and computes
while the rest block until the owner publishes (or abandons, after which
one waiter takes over).  The owner never waits on anyone, so coalescing
cannot deadlock.  This is what turns N identical concurrent chains into
one chain's worth of search work.
"""

from __future__ import annotations

import hashlib
import json
import threading
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

from repro_torch.api.certificate import Certificate, pair_digest
from repro_torch.core.dag import DataflowDAG
from repro_torch.core.edits import EditMapping
from repro_torch.core.verifier import VeerStats

#: (pair digest, raw per-side digests when the canonical digest cannot tell
#: the sides apart, explicitly requested mapping or None for the default)
PairKey = Tuple[
    str, Optional[Tuple[str, str]], Optional[Tuple[Tuple[str, str], ...]]
]


def _raw_dag_digest(dag: DataflowDAG) -> str:
    """sha256 of the *raw* serialized DAG — the un-canonicalized operator
    forms a certificate payload stores (``dag_to_dict``), so two versions
    that differ only by a canonicalized rewrite (e.g. a scaled predicate)
    get distinct raw digests even though their ``content_digest``s match.
    Memoized on the DAG instance; deterministic across processes."""
    d = getattr(dag, "_raw_pair_cache_digest", None)
    if d is None:
        from repro_torch.api.serialize import dag_to_dict

        blob = json.dumps(dag_to_dict(dag), sort_keys=True,
                          separators=(",", ":"))
        d = hashlib.sha256(blob.encode()).hexdigest()[:32]
        dag._raw_pair_cache_digest = d
    return d


@dataclass(frozen=True)
class PairEntry:
    """One decided pair: the verdict, its certificate, and what the
    original run paid — so hits can account the work they avoided."""

    verdict: bool
    certificate: Optional[Certificate]
    ev_calls_avoided: int     # original ev_calls + ev_calls_saved
    ev_time_avoided: float    # original ev_time + ev_time_saved


class PairVerdictCache:
    """Thread-safe ``PairKey -> PairEntry`` map with single-flight misses.

    Bounded: entries carry full certificates (serialized window payloads),
    so an unbounded map would grow with workload diversity for the life of
    a service.  When ``max_entries`` is exceeded the oldest entry is
    evicted (FIFO — recurring pairs are re-decided and re-inserted, which
    in practice keeps the hot set resident).
    """

    def __init__(self, max_entries: int = 65_536) -> None:
        if max_entries < 1:
            raise ValueError("max_entries must be positive")
        self.max_entries = max_entries
        self._lock = threading.Lock()
        self._entries: Dict[PairKey, PairEntry] = {}
        self._inflight: Dict[PairKey, threading.Event] = {}
        # keys whose owner abandoned (Unknown verdict): coalescing is
        # disabled for them, otherwise N concurrent submissions of an
        # undecidable pair would run their N searches strictly one after
        # another — worse than no coalescing at all
        self._abandoned: set = set()
        self.hits = 0
        self.misses = 0
        self.coalesced = 0  # lookups that waited for an in-flight owner

    @staticmethod
    def make_key(
        P: DataflowDAG,
        Q: DataflowDAG,
        semantics: str,
        mapping: Optional[EditMapping],
    ) -> PairKey:
        """Content key: certificate-binding digest + the pinned mapping.

        The mapping is part of the key because an explicit mapping changes
        which verdict the verifier reports (a False under mapping m is not
        a False under the default mapping search); ``None`` — the common
        case — keys the verifier's own mapping choice.

        When the two sides share one ``content_digest`` (a revert pair
        whose edit was a canonicalized rewrite), the pair digest is the
        same for (P, Q) and (Q, P) — but the cached certificate's payload
        stores the raw operator forms, so serving the swapped entry would
        change certificate bytes versus a cache-less run.  Raw per-side
        digests disambiguate exactly that case; everywhere else they are
        ``None`` and the hit behavior is unchanged.
        """
        raw = None
        if P.content_digest() == Q.content_digest():
            raw = (_raw_dag_digest(P), _raw_dag_digest(Q))
        return (
            pair_digest(P, Q, semantics),
            raw,
            mapping.p_to_q if mapping is not None else None,
        )

    def acquire(self, key: PairKey) -> Tuple[Optional[PairEntry], bool]:
        """``(entry, owner)``: a cached entry (owner False), or a miss the
        caller now owns (entry None, owner True — the caller MUST follow up
        with ``publish`` or ``abandon``).  Threads that miss while another
        owner is computing block here until the owner resolves."""
        while True:
            with self._lock:
                entry = self._entries.get(key)
                if entry is not None:
                    self.hits += 1
                    return entry, False
                if key in self._abandoned:
                    # known-undecidable: every caller computes immediately
                    # and in parallel (a later publish lifts the marker)
                    self.misses += 1
                    return None, True
                event = self._inflight.get(key)
                if event is None:
                    self._inflight[key] = threading.Event()
                    self.misses += 1
                    return None, True
                self.coalesced += 1
            event.wait()

    def compute_or_reuse(
        self,
        key: PairKey,
        compute: Callable[[], Tuple[Optional[bool], VeerStats, Optional[Certificate]]],
        *,
        pair: Optional[Tuple[DataflowDAG, DataflowDAG]] = None,
    ) -> Tuple[Optional[bool], VeerStats, Optional[Certificate], bool]:
        """The whole single-flight protocol in one place (both the chain
        session and the service's one-shot path go through here, so the
        invariants — never cache Unknown, abandon on *any* failure,
        hit-stats synthesis — cannot drift between callers).

        ``compute`` runs the actual verification and returns
        ``(verdict, stats, certificate)``.  Returns the same triple plus
        ``reused``; a reused result carries synthesized stats accounting
        only the avoided work.

        ``pair`` is the ``(P, Q)`` the key was made from.  This in-memory
        cache has no use for it (digest equality already binds entries to
        content-identical pairs); a tier-backed subclass shared across
        processes needs it to replay certificates before serving hits that
        crossed a process boundary.
        """
        del pair  # entries here were written by this process: trusted
        entry, _owner = self.acquire(key)
        if entry is not None:
            stats = VeerStats(
                verdict=entry.verdict,
                ev_calls_saved=entry.ev_calls_avoided,
                ev_time_saved=entry.ev_time_avoided,
            )
            return entry.verdict, stats, entry.certificate, True
        try:
            verdict, stats, certificate = compute()
        except BaseException:
            self.abandon(key)  # waiters re-elect an owner; nothing cached
            raise
        if verdict is None:
            # Unknown is budget-dependent and uncertifiable: never cache it
            self.abandon(key)
        else:
            self.publish(
                key,
                PairEntry(
                    verdict=verdict,
                    certificate=certificate,
                    ev_calls_avoided=stats.ev_calls + stats.ev_calls_saved,
                    ev_time_avoided=stats.ev_time + stats.ev_time_saved,
                ),
            )
        return verdict, stats, certificate, False

    def peek(self, key: PairKey) -> Optional[PairEntry]:
        """Non-coalescing lookup (no ownership, no waiting, no stats)."""
        with self._lock:
            return self._entries.get(key)

    def publish(self, key: PairKey, entry: PairEntry) -> None:
        """Store the owner's result and release every coalesced waiter."""
        with self._lock:
            self._entries[key] = entry
            while len(self._entries) > self.max_entries:
                self._entries.pop(next(iter(self._entries)))  # FIFO eviction
            self._abandoned.discard(key)
            event = self._inflight.pop(key, None)
        if event is not None:
            event.set()

    def abandon(self, key: PairKey) -> None:
        """Owner gives up (Unknown verdict or exception): wake the waiters.
        The key is marked so future ``acquire``s skip coalescing — waiters
        all become owners and recompute *concurrently* rather than
        serializing N hopeless searches behind one event."""
        with self._lock:
            self._abandoned.add(key)
            while len(self._abandoned) > self.max_entries:
                self._abandoned.pop()  # keep the marker set bounded too
            event = self._inflight.pop(key, None)
        if event is not None:
            event.set()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> Dict[str, object]:
        with self._lock:
            return {
                "entries": len(self._entries),
                "hits": self.hits,
                "misses": self.misses,
                "coalesced": self.coalesced,
            }
