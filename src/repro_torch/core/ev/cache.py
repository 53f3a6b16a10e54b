"""EV-verdict memoization keyed by canonical QueryPair fingerprints.

The cost model of iterative analytics (paper §1, GEqO/EqDAC follow-ups) is
that EV calls dominate: a chain of versions re-poses the *same* window-level
equivalence questions over and over — inside one pair (isomorphic windows of
different decompositions), across consecutive pairs (an unchanged region next
to last week's edit), and across sessions (the cache is a small JSON file).

``VerdictCache`` is the store: ``(ev name, QueryPair.fingerprint())`` →
``(verdict, original check time)``.  Soundness rests on two facts:

  * ``fingerprint()`` equality implies the two query pairs are isomorphic
    *as pairs* (including the cross-side source correspondence), and
  * every EV here is deterministic and id-invariant (verdicts depend only on
    the pair's structure), so replaying a verdict — True, False, **or**
    Unknown — is exactly what re-running the EV would produce.

Unknown verdicts are cached per-EV, not per-EV-set: adding an EV to the
roster changes which window verdicts aggregate to True, but never which
verdict an individual EV returns, so per-EV entries stay valid.

``CachedEV`` is the wrapper the verifier sees: a drop-in ``BaseEV`` facade
(attribute access proxies to the wrapped EV) whose ``check`` consults the
cache first and records hit/miss/time-saved statistics.

Besides verdicts the store memoizes **validity**: ``(ev name, fingerprint)``
→ ``ev.validate(query_pair)``.  Restriction checks looked free next to EV
decision procedures, but the decomposition search validates every distinct
window it forms — on search-dominated workloads (cache-warm 12-change pairs,
``benchmarks/search_bench.py``) Equitas' normalize-based restrictions were
the single largest cost.  The same soundness argument as for verdicts
applies: fingerprints capture the whole pair including semantics, and
``validate`` is deterministic and id-invariant.  The bitmask search kernel
consults this table through the window's interned fingerprint; the retained
reference backend deliberately does not (it preserves pre-kernel behavior
as the benchmark baseline).

Memory: ``max_entries`` bounds the verdict and validity tables with LRU
eviction (``get`` refreshes recency, ``put`` evicts the stalest entries),
so a long-running ``VerificationService`` cannot grow without limit;
``evictions`` counts what was dropped.

Concurrency: one ``VerdictCache`` may back many verifier threads — the
parallel window dispatch inside a single ``Veer`` (``max_workers > 1``) and
the worker pool of a verification service both hit
the same store.  All cache state (the entry map, the dirty flag, the
hit/miss counters) is guarded by a single re-entrant lock, and ``save()``
writes a temp file in the target directory and atomically renames it into
place, so a reader (or a crash mid-save) can never observe a torn JSON
file.  See docs/ARCHITECTURE.md's concurrency-model section.
"""

from __future__ import annotations

import json
import os
import pathlib
import stat
import tempfile
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, Iterable, Optional, Tuple

from repro_torch.core.ev.base import BaseEV, QueryPair

# bump when an EV's decision procedure changes incompatibly: old persisted
# verdicts are discarded instead of replayed
CACHE_FORMAT_VERSION = 1

_VERDICT_TO_JSON = {True: "T", False: "F", None: "U"}
_VERDICT_FROM_JSON = {v: k for k, v in _VERDICT_TO_JSON.items()}


@dataclass(frozen=True)
class CacheEntry:
    verdict: Optional[bool]
    elapsed: float  # seconds the original EV check took


class VerdictCache:
    """Persistable map ``(ev_name, fingerprint) -> CacheEntry``.

    With a ``path`` the cache loads eagerly and ``save()`` writes a compact
    JSON file — drop it next to ``ReuseManager``'s content-addressed store to
    share one directory of reusable artifacts (materializations + verdicts).

    ``max_entries`` (None = unbounded) caps the verdict and validity tables
    *each* at that many entries, evicting least-recently-used first.
    """

    def __init__(
        self,
        path: Optional[str] = None,
        *,
        autoload: bool = True,
        max_entries: Optional[int] = None,
    ):
        if max_entries is not None and max_entries <= 0:
            raise ValueError(f"max_entries must be positive, got {max_entries}")
        self.path = pathlib.Path(path).expanduser() if path is not None else None
        self.max_entries = max_entries
        self._entries: "OrderedDict[Tuple[str, str], CacheEntry]" = OrderedDict()
        self._validity: "OrderedDict[Tuple[str, str], bool]" = OrderedDict()
        self._dirty = False
        # single writer lock: every read/write of _entries, _dirty and the
        # counters goes through it, so one store can back many threads
        # (sessions of a VerificationService, the verifier's window pool)
        self._lock = threading.RLock()
        self.hits = 0
        self.misses = 0
        self.time_saved = 0.0
        self.evictions = 0
        self.validity_hits = 0
        self.validity_misses = 0
        if self.path is not None and autoload and self.path.exists():
            self.load()

    # -- core map ------------------------------------------------------------
    def _evict(self, table: OrderedDict) -> None:
        """Drop least-recently-used entries past ``max_entries`` (locked by
        the caller).  Evicted entries leave the persisted snapshot too."""
        if self.max_entries is None:
            return
        while len(table) > self.max_entries:
            table.popitem(last=False)
            self.evictions += 1
            self._dirty = True

    def get(self, ev_name: str, fingerprint: str) -> Optional[CacheEntry]:
        key = (ev_name, fingerprint)
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)  # LRU refresh
            self.hits += 1
            self.time_saved += entry.elapsed
            return entry

    def put(
        self,
        ev_name: str,
        fingerprint: str,
        verdict: Optional[bool],
        elapsed: float,
    ) -> None:
        key = (ev_name, fingerprint)
        entry = CacheEntry(verdict, elapsed)
        with self._lock:
            if self._entries.get(key) != entry:
                self._entries[key] = entry
                self._dirty = True
            self._entries.move_to_end(key)
            self._evict(self._entries)

    def covers(self, ev_names: Iterable[str], fingerprint: str) -> bool:
        """True iff every named EV's verdict for this pair is memoized —
        i.e. the window can be fully resolved without any EV call."""
        with self._lock:
            return all((n, fingerprint) in self._entries for n in ev_names)

    # -- validity map ----------------------------------------------------------
    def get_validity(self, ev_name: str, fingerprint: str) -> Optional[bool]:
        """Memoized ``ev.validate(query_pair)`` result, or None on a miss."""
        key = (ev_name, fingerprint)
        with self._lock:
            ok = self._validity.get(key)
            if ok is None:
                self.validity_misses += 1
                return None
            self._validity.move_to_end(key)
            self.validity_hits += 1
            return ok

    def put_validity(self, ev_name: str, fingerprint: str, valid: bool) -> None:
        key = (ev_name, fingerprint)
        with self._lock:
            if self._validity.get(key) is not valid:
                self._validity[key] = valid
                self._dirty = True
            self._validity.move_to_end(key)
            self._evict(self._validity)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, key: Tuple[str, str]) -> bool:
        with self._lock:
            return key in self._entries

    # -- persistence -----------------------------------------------------------
    def save(self, path: Optional[str] = None) -> None:
        """Serialize to ``path`` (default: the cache's own path) atomically.

        The payload is written to a temp file in the target directory and
        renamed into place (``os.replace``), so concurrent readers and
        crash-interrupted saves never see a partially-written file: they get
        either the previous complete snapshot or the new one.  Only the
        entry snapshot is taken under the cache lock — serialization and
        disk I/O run outside it, so a large save never stalls concurrent
        ``get``/``put`` (i.e. every in-flight EV check of the service).
        """
        target = pathlib.Path(path).expanduser() if path is not None else self.path
        if target is None:
            return
        with self._lock:
            if target == self.path and not self._dirty:
                return  # nothing new since the last write: skip the I/O
            entries = sorted(self._entries.items())
            validity = sorted(self._validity.items())
            if target == self.path:
                # claim the snapshot now; restored below if the write fails
                self._dirty = False
        payload = {
            "version": CACHE_FORMAT_VERSION,
            "entries": [
                [ev, fp, _VERDICT_TO_JSON[e.verdict], round(e.elapsed, 6)]
                for (ev, fp), e in entries
            ],
            "validity": [[ev, fp, ok] for (ev, fp), ok in validity],
        }
        target.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp_name = tempfile.mkstemp(
            dir=target.parent, prefix=target.name + ".", suffix=".tmp"
        )
        try:
            with os.fdopen(fd, "w") as f:  # owns fd from here on
                # mkstemp creates 0600; keep the target's permissions (or a
                # fixed 0644 for a fresh file — probing the umask would
                # mutate process-global state and race other threads) so a
                # shared store stays readable
                try:
                    mode = stat.S_IMODE(os.stat(target).st_mode)
                except OSError:
                    mode = 0o644
                os.chmod(tmp_name, mode)
                json.dump(payload, f)
            os.replace(tmp_name, target)
        except BaseException:
            # the target file is untouched; drop the partial temp file and
            # un-claim the snapshot so a later save retries these entries
            try:
                os.unlink(tmp_name)
            except OSError:
                pass
            if target == self.path:
                with self._lock:
                    self._dirty = True
            raise

    def load(self, path: Optional[str] = None) -> int:
        """Merge entries from disk; returns how many were loaded."""
        target = pathlib.Path(path).expanduser() if path is not None else self.path
        if target is None or not target.exists():
            return 0
        try:
            payload = json.loads(target.read_text())
        except (json.JSONDecodeError, OSError):
            return 0  # empty/corrupt cache file: start cold, don't crash
        if not isinstance(payload, dict) or payload.get("version") != CACHE_FORMAT_VERSION:
            return 0  # incompatible format: start fresh
        n = 0
        with self._lock:
            try:
                for ev, fp, verdict, elapsed in payload["entries"]:
                    self._entries[(ev, fp)] = CacheEntry(
                        _VERDICT_FROM_JSON[verdict], float(elapsed)
                    )
                    n += 1
            except (KeyError, TypeError, ValueError):
                pass  # malformed row: keep what parsed, start cold for the rest
            nv = 0
            try:
                # optional section (absent in pre-validity snapshots)
                for ev, fp, ok in payload.get("validity", ()):
                    self._validity[(ev, fp)] = bool(ok)
                    nv += 1
            except (TypeError, ValueError):
                pass
            self._evict(self._entries)
            self._evict(self._validity)
            if (n or nv) and target != self.path:
                self._dirty = True  # merged foreign entries not yet on self.path
        return n

    def stats(self) -> Dict[str, object]:
        with self._lock:
            return {
                "entries": len(self._entries),
                "validity_entries": len(self._validity),
                "max_entries": self.max_entries,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "validity_hits": self.validity_hits,
                "validity_misses": self.validity_misses,
                "time_saved": self.time_saved,
            }


class CachedEV:
    """Memoizing facade over a ``BaseEV``.

    ``check`` consults the shared ``VerdictCache`` under this EV's name and
    the query pair's canonical fingerprint; on a miss it runs the wrapped EV
    and records the verdict with its cost, so future hits know how much time
    they saved.  ``validate`` is not cached — restriction checks are pure
    Python over tiny DAGs and are not the EV-call cost the paper measures.
    """

    def __init__(self, ev: BaseEV, cache: VerdictCache):
        self.ev = ev
        self.cache = cache
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.time_saved = 0.0

    def __getattr__(self, item):
        return getattr(self.ev, item)

    def __repr__(self) -> str:
        return f"CachedEV({self.ev.name})"

    def validate(self, qp: QueryPair) -> bool:
        return self.ev.validate(qp)

    def check(self, qp: QueryPair) -> Optional[bool]:
        verdict, _, _, _ = self.check_recorded(qp)
        return verdict

    def check_recorded(
        self, qp: QueryPair
    ) -> Tuple[Optional[bool], bool, float, float]:
        """``check`` plus provenance: ``(verdict, hit, elapsed, saved)``.

        ``hit`` says whether the verdict came from the cache, ``elapsed`` is
        the wall time of this call (the EV run on a miss, ~0 on a hit) and
        ``saved`` the original check time a hit avoided.  Callers running
        EV checks on worker threads use this instead of diffing the
        ``hits`` counter before/after — the counters are shared and only
        consistent under the lock, while the returned tuple is local to the
        call.
        """
        fp = qp.fingerprint()
        entry = self.cache.get(self.ev.name, fp)
        if entry is not None:
            with self._lock:
                self.hits += 1
                self.time_saved += entry.elapsed
            return entry.verdict, True, 0.0, entry.elapsed
        t0 = time.perf_counter()
        verdict = self.ev.check(qp)
        elapsed = time.perf_counter() - t0
        with self._lock:
            self.misses += 1
        self.cache.put(self.ev.name, fp, verdict, elapsed)
        return verdict, False, elapsed, 0.0


def wrap_evs(evs, cache: Optional[VerdictCache]):
    """Wrap each EV in ``CachedEV`` bound to ``cache`` (idempotent; no-op
    without a cache).  An EV already wrapped around a *different* cache is
    re-bound, so attaching a new cache never leaves stale wrappers feeding
    the old store."""
    if cache is None:
        return list(evs)
    out = []
    for ev in evs:
        if isinstance(ev, CachedEV):
            out.append(ev if ev.cache is cache else CachedEV(ev.ev, cache))
        else:
            out.append(CachedEV(ev, cache))
    return out
