"""Operator-level materialization stores (the engine-side reuse substrate).

A store maps an arbitrary string *key* — in practice the operator's
content digest from ``repro_torch.engine.executor.ExecutionPlan.digests`` — to a
materialized ``Table``.  Payloads are content-addressed by ``table_digest``
and deduplicated: two keys whose tables are byte-identical share one
payload, which is how equivalent results across pipeline versions (and the
checkpoint object store, which uses the same hashing idea) are stored once.

Two implementations share the ``MaterializationStore`` protocol:

  * ``InMemoryMaterializationStore`` — dict-backed, for tests and
    single-process sessions;
  * ``DiskMaterializationStore`` — the persistent store long-lived
    sessions use.  Every file (payload, metadata, key ref) is written to a
    temp file in the target directory and atomically renamed into place
    (``os.replace``), and a corrupted or truncated entry found on ``get``
    is *skipped and counted* (``corrupt_entries_skipped``), never raised —
    a crash mid-write costs one entry, not the store.

Both stores enforce an optional **byte budget** with LRU eviction over
keys (``get``/``put`` refresh recency): when the payload bytes exceed the
budget, least-recently-used keys are dropped and payloads no longer
referenced by any key are garbage-collected.  Both are thread-safe (one
re-entrant lock), so a ``VerificationService``'s concurrent sessions can
share one store.

Each entry records the wall-clock seconds the original computation took
(``put(..., elapsed=...)``); ``recorded_cost(key)`` reports it so callers
(``ExecStats.recompute_time_saved``, ``ReuseStats``) can account for the
recomputation a hit avoided using ``time.perf_counter`` deltas rather than
wall-clock-adjustable ``time.time`` stamps.
"""

from __future__ import annotations

import hashlib
import json
import os
import pathlib
import tempfile
import threading
from collections import OrderedDict
from typing import Dict, Optional, Protocol, Tuple

import numpy as np

from repro_torch.engine.table import Table


def table_digest(table: Table) -> str:
    """Content address of a table: column order + dtypes + value bytes.

    Memoized on the table instance (tables are treated as immutable
    throughout the engine — every operator returns a fresh ``Table``), so
    chained submissions hash each shared source table once.
    """
    cached = getattr(table, "_digest", None)
    if cached is not None:
        return cached
    h = hashlib.sha256()
    h.update(repr(table.order).encode())
    for c in table.order:
        arr = table.cols[c]
        h.update(str(arr.dtype).encode())
        if arr.dtype == object:
            h.update(repr([_jsonable(v) for v in arr]).encode())
        else:
            h.update(arr.tobytes())
    digest = h.hexdigest()[:32]
    table._digest = digest
    return digest


def table_nbytes(table: Table) -> int:
    """Approximate payload size of a table (the byte-budget unit)."""
    total = 0
    for c in table.order:
        arr = table.cols[c]
        if arr.dtype == object:
            total += len(repr([_jsonable(v) for v in arr]).encode())
        else:
            total += arr.nbytes
    return total


def _jsonable(v):
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, (list, tuple, np.ndarray)):
        return [_jsonable(x) for x in v]
    return v


class MaterializationStore(Protocol):
    """What the executor needs from a store — anything satisfying this
    protocol plugs into ``ExecutionPlan.run``."""

    def get(self, key: str) -> Optional[Table]: ...

    def put(self, key: str, table: Table, elapsed: float = 0.0) -> bool: ...

    def __contains__(self, key: str) -> bool: ...


class _BaseStore:
    """Shared key-index + LRU/byte-budget logic for both store flavors."""

    def __init__(self, byte_budget: Optional[int] = None):
        if byte_budget is not None and byte_budget <= 0:
            raise ValueError(f"byte_budget must be positive, got {byte_budget}")
        self.byte_budget = byte_budget
        # key -> (table_digest, elapsed); recency order = LRU order
        self._keys: "OrderedDict[str, Tuple[str, float]]" = OrderedDict()
        self._refs: Dict[str, int] = {}     # table_digest -> referencing keys
        self._bytes: Dict[str, int] = {}    # table_digest -> payload bytes
        self._pins: Dict[str, int] = {}     # key -> pin refcount (evict-exempt)
        self._total_bytes = 0               # running sum of _bytes values
        self._lock = threading.RLock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.dedup_skipped_writes = 0
        self.corrupt_entries_skipped = 0
        self.time_saved = 0.0

    # subclasses: payload storage
    def _payload_exists(self, tdigest: str) -> bool:
        raise NotImplementedError

    def _payload_write(self, tdigest: str, table: Table) -> None:
        raise NotImplementedError

    def _payload_read(self, tdigest: str) -> Optional[Table]:
        raise NotImplementedError

    def _payload_drop(self, tdigest: str) -> None:
        raise NotImplementedError

    # -- protocol -------------------------------------------------------------
    def get(self, key: str) -> Optional[Table]:
        with self._lock:
            entry = self._keys.get(key)
            if entry is None:
                self.misses += 1
                return None
            tdigest, elapsed = entry
            table = self._payload_read(tdigest)
            if table is None:
                # corrupted/truncated payload: drop the entry, don't crash
                self.corrupt_entries_skipped += 1
                self.misses += 1
                self._drop_key(key)
                return None
            self._keys.move_to_end(key)
            self.hits += 1
            self.time_saved += elapsed
            return table

    def put(self, key: str, table: Table, elapsed: float = 0.0) -> bool:
        """Store ``table`` under ``key``; returns True iff a new payload was
        written (False: deduplicated against an existing identical table)."""
        tdigest = table_digest(table)
        with self._lock:
            old = self._keys.get(key)
            wrote = False
            if self._payload_exists(tdigest):
                self.dedup_skipped_writes += 1
                if tdigest not in self._bytes:
                    # payload on disk but not indexed (e.g. orphaned by a
                    # crash between payload and key write): account for it
                    # now or the byte budget undercounts forever
                    self._record_bytes(tdigest, table_nbytes(table))
            else:
                self._payload_write(tdigest, table)
                self._record_bytes(tdigest, table_nbytes(table))
                wrote = True
            if old is not None and old[0] != tdigest:
                self._decref(old[0])
            if old is None or old[0] != tdigest:
                self._refs[tdigest] = self._refs.get(tdigest, 0) + 1
            self._keys[key] = (tdigest, float(elapsed))
            self._keys.move_to_end(key)
            self._evict(protect=key)
            return wrote

    def __contains__(self, key: str) -> bool:
        with self._lock:
            return key in self._keys

    def __len__(self) -> int:
        with self._lock:
            return len(self._keys)

    def recorded_cost(self, key: str) -> float:
        """Seconds the original computation of ``key``'s table took (0.0
        when unknown) — what a hit saves, measured with ``perf_counter``."""
        with self._lock:
            entry = self._keys.get(key)
            return entry[1] if entry is not None else 0.0

    def total_bytes(self) -> int:
        with self._lock:
            return self._total_bytes

    def stats(self) -> Dict[str, object]:
        with self._lock:
            return {
                "entries": len(self._keys),
                "objects": len(self._bytes),
                "bytes": self._total_bytes,
                "byte_budget": self.byte_budget,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "dedup_skipped_writes": self.dedup_skipped_writes,
                "corrupt_entries_skipped": self.corrupt_entries_skipped,
                "pinned_keys": len(self._pins),
                "time_saved": self.time_saved,
            }

    # -- pinning --------------------------------------------------------------
    def pin(self, keys) -> Tuple[str, ...]:
        """Refcount-pin every *present* key in ``keys`` against LRU eviction.

        An in-flight ``ExecutionPlan.run`` pins the store entries it is about
        to read so a concurrent byte-budget evict cannot free a table mid-run
        and silently degrade the reuse path to a full recompute.  Returns the keys actually pinned — pass
        that tuple (not the request) to ``unpin`` when the run finishes.
        """
        with self._lock:
            pinned = tuple(k for k in keys if k in self._keys)
            for k in pinned:
                self._pins[k] = self._pins.get(k, 0) + 1
            return pinned

    def unpin(self, keys) -> None:
        """Release one pin per key; a key becomes evictable at zero pins."""
        with self._lock:
            for k in keys:
                n = self._pins.get(k, 0) - 1
                if n <= 0:
                    self._pins.pop(k, None)
                else:
                    self._pins[k] = n

    # -- internals (caller holds the lock) ------------------------------------
    def _record_bytes(self, tdigest: str, nbytes: int) -> None:
        self._total_bytes += nbytes - self._bytes.get(tdigest, 0)
        self._bytes[tdigest] = nbytes

    def _drop_key(self, key: str) -> None:
        entry = self._keys.pop(key, None)
        if entry is not None:
            self._decref(entry[0])

    def _decref(self, tdigest: str) -> None:
        n = self._refs.get(tdigest, 0) - 1
        if n <= 0:
            self._refs.pop(tdigest, None)
            self._total_bytes -= self._bytes.pop(tdigest, 0)
            self._payload_drop(tdigest)
        else:
            self._refs[tdigest] = n

    def _evict(self, protect: Optional[str] = None) -> None:
        """LRU-evict keys until under the byte budget (O(1) per check via
        the running byte total).  The just-touched ``protect`` key and any
        ``pin``-ned keys survive even when the remaining tables exceed the
        whole budget — otherwise one oversized put would thrash forever, and
        an in-flight run could lose a table it is about to read."""
        if self.byte_budget is None:
            return
        while self._total_bytes > self.byte_budget and len(self._keys) > 1:
            victim = None
            for key in self._keys:  # LRU order: stalest first
                if key != protect and not self._pins.get(key):
                    victim = key
                    break
            if victim is None:
                break  # everything left is protected or pinned
            self._drop_key(victim)
            self.evictions += 1


class InMemoryMaterializationStore(_BaseStore):
    """Dict-backed store — no serialization, byte-budget LRU still applies."""

    def __init__(self, byte_budget: Optional[int] = None):
        super().__init__(byte_budget)
        self._tables: Dict[str, Table] = {}

    def _payload_exists(self, tdigest: str) -> bool:
        return tdigest in self._tables

    def _payload_write(self, tdigest: str, table: Table) -> None:
        self._tables[tdigest] = table

    def _payload_read(self, tdigest: str) -> Optional[Table]:
        return self._tables.get(tdigest)

    def _payload_drop(self, tdigest: str) -> None:
        self._tables.pop(tdigest, None)


class DiskMaterializationStore(_BaseStore):
    """Persistent content-addressed store.

    Layout (all writes atomic: temp file in the same directory, then
    ``os.replace``):

    ``objects/<tdigest>.npz``       column arrays (object columns as JSON
                                    strings, loaded with ``allow_pickle=False``)
    ``objects/<tdigest>.meta.json`` ``{"order": [...], "object_cols": [...]}``
    ``keys/<key>.json``             ``{"table": tdigest, "elapsed": s}``

    On construction the key index is rebuilt from ``keys/`` (stalest mtime
    first, so pre-existing entries are evicted before this session's).
    Unreadable or truncated entries are skipped and counted, never raised.
    """

    def __init__(self, directory: str, byte_budget: Optional[int] = None):
        super().__init__(byte_budget)
        self.dir = pathlib.Path(directory).expanduser()
        self.objects = self.dir / "objects"
        self.keys_dir = self.dir / "keys"
        self.objects.mkdir(parents=True, exist_ok=True)
        self.keys_dir.mkdir(parents=True, exist_ok=True)
        self._load_index()

    # -- index ----------------------------------------------------------------
    def _load_index(self) -> None:
        entries = []
        for p in self.keys_dir.glob("*.json"):
            try:
                rec = json.loads(p.read_text())
                tdigest = rec["table"]
                elapsed = float(rec.get("elapsed", 0.0))
            except (OSError, json.JSONDecodeError, KeyError, TypeError, ValueError):
                self.corrupt_entries_skipped += 1
                continue
            if not (self.objects / f"{tdigest}.npz").exists():
                self.corrupt_entries_skipped += 1
                continue
            entries.append((p.stat().st_mtime, p.stem, tdigest, elapsed))
        for _, key, tdigest, elapsed in sorted(entries):
            self._keys[key] = (tdigest, elapsed)
            self._refs[tdigest] = self._refs.get(tdigest, 0) + 1
            if tdigest not in self._bytes:
                try:
                    nbytes = (self.objects / f"{tdigest}.npz").stat().st_size
                except OSError:
                    nbytes = 0
                self._record_bytes(tdigest, nbytes)
        self._evict()

    def _key_path(self, key: str) -> pathlib.Path:
        return self.keys_dir / f"{key}.json"

    # -- payloads -------------------------------------------------------------
    def _payload_exists(self, tdigest: str) -> bool:
        return (self.objects / f"{tdigest}.npz").exists()

    def _payload_write(self, tdigest: str, table: Table) -> None:
        payload = {}
        meta = {"order": table.order, "object_cols": []}
        for c in table.order:
            arr = table.cols[c]
            if arr.dtype == object:
                meta["object_cols"].append(c)
                payload[c] = np.array([json.dumps(_jsonable(v)) for v in arr])
            else:
                payload[c] = arr
        _atomic_write(
            self.objects / f"{tdigest}.npz",
            lambda f: np.savez(f, **payload),
            binary=True,
        )
        _atomic_write(
            self.objects / f"{tdigest}.meta.json",
            lambda f: f.write(json.dumps(meta)),
        )

    def _payload_read(self, tdigest: str) -> Optional[Table]:
        try:
            meta = json.loads(
                (self.objects / f"{tdigest}.meta.json").read_text()
            )
            with np.load(
                self.objects / f"{tdigest}.npz", allow_pickle=False
            ) as data:
                cols = {}
                for c in meta["order"]:
                    arr = data[c]
                    if c in meta["object_cols"]:
                        arr = np.array(
                            [json.loads(s) for s in arr], dtype=object
                        )
                    cols[c] = arr
            return Table(cols, meta["order"])
        except Exception:
            # truncated npz, malformed meta, missing member, bad JSON — a
            # damaged entry must read as a miss, never kill the caller
            return None

    def _payload_drop(self, tdigest: str) -> None:
        for name in (f"{tdigest}.npz", f"{tdigest}.meta.json"):
            try:
                (self.objects / name).unlink()
            except OSError:
                pass

    # -- persistence of the key index -----------------------------------------
    def put(self, key: str, table: Table, elapsed: float = 0.0) -> bool:
        with self._lock:
            wrote = super().put(key, table, elapsed)
            entry = self._keys.get(key)
            if entry is not None:  # may have been evicted (oversized budget)
                rec = {"table": entry[0], "elapsed": entry[1]}
                _atomic_write(
                    self._key_path(key), lambda f: f.write(json.dumps(rec))
                )
            return wrote

    def _drop_key(self, key: str) -> None:
        super()._drop_key(key)
        try:
            self._key_path(key).unlink()
        except OSError:
            pass


def _atomic_write(target: pathlib.Path, write_fn, binary: bool = False) -> None:
    """Write-temp-then-``os.replace`` (the ``VerdictCache.save`` pattern):
    a reader or a crash mid-write sees the old file or the new one, never a
    torn half."""
    target.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp_name = tempfile.mkstemp(
        dir=target.parent, prefix=target.name + ".", suffix=".tmp"
    )
    try:
        with os.fdopen(fd, "wb" if binary else "w") as f:
            write_fn(f)
        os.replace(tmp_name, target)
    except BaseException:
        try:
            os.unlink(tmp_name)
        except OSError:
            pass
        raise
