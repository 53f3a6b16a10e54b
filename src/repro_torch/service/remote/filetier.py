"""``FileTier`` — the shared remote materialization/verdict tier.

One directory, shared by every worker process of a ``VerificationFleet``
(same box or same network filesystem), holding the three namespaces the
cache adapters read/write through plus the lease files that give
cross-process single-flight:

``tier.lock``                    global index lock (``fcntl.flock``)
``verdicts/<h>.json``            window verdict: ``{"k": [ev, fp], "v": "T|F|U", "s": secs}``
``validity/<h>.json``            restriction check: ``{"k": [ev, fp], "ok": bool}``
``pairs/<h>.json``               pair verdict + certificate JSON
``tables/<h>.json``              materialization key → payload ref
``objects/<tdigest>.npz``        content-addressed table payload (+ ``.meta.json``)
``objects/<tdigest>.refs``       payload reference count: ``{"count": n}``
``leases/<h>.lock``              single-flight leases (kernel-released on death)

Hardening, in the ``VerdictCache``/``DiskMaterializationStore`` tradition
(the fault-injection cases of ``tests/test_torch_service.py`` drive
every branch):

  * every write is temp-file + ``os.replace`` — a reader or a crash
    mid-write sees the old entry or the new one, never a torn half;
  * every entry embeds the key it serves (``"k"``); a read whose payload
    is truncated, malformed, or keyed differently is **counted and
    treated as a miss** (the damaged file is unlinked), never returned;
  * table payloads are verified against their content address on every
    read — ``table_digest(loaded) == tdigest`` or the entry reads as a
    counted miss.  A remote tier can therefore *lose* work but never
    serve wrong bytes;
  * entries expire after ``ttl_seconds`` (mtime-based, checked on read
    and on ``sweep()``); object bytes are bounded by ``byte_budget`` with
    stalest-key-first eviction;
  * payloads are refcounted by the key entries naming them, and a payload
    is only ever garbage-collected when its refcount reaches zero **and**
    a scan of the key namespace confirms no live key still references it
    — so a stale refcount file or a double ``release_table`` can never
    free a live materialization;
  * leases are ``fcntl.flock`` locks: exactly one process holds one at a
    time, and the kernel releases the lock when the holder dies, so a
    worker crashing mid-compute never wedges its waiters.

Concurrency model: index mutations (refcounts, evictions, key writes)
serialize on the single global ``tier.lock``; reads go lock-free against
atomically-replaced files.  Coarse, but correct — and the tier is a
*second* level behind each worker's in-process caches, so it sees misses
and publishes, not the hot path.
"""

from __future__ import annotations

import fcntl
import hashlib
import json
import os
import pathlib
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.engine.store import _atomic_write, _jsonable, table_digest
from repro_torch.engine.table import Table
from repro_torch.service.remote.tier import Lease, PairRecord

_VERDICT_TO_JSON = {True: "T", False: "F", None: "U"}
_VERDICT_FROM_JSON = {v: k for k, v in _VERDICT_TO_JSON.items()}


def _hname(*parts: str) -> str:
    """Filesystem-safe entry name for an arbitrary key tuple."""
    return hashlib.sha256("\x1f".join(parts).encode()).hexdigest()[:40]


class _GlobalLock:
    """``with`` wrapper over ``fcntl.flock`` on the tier's lock file.

    A fresh fd per acquisition: flock excludes across *open file
    descriptions*, so this serializes both other processes and other
    threads of this process."""

    def __init__(self, path: pathlib.Path):
        self.path = path
        self._fd: Optional[int] = None

    def __enter__(self) -> "_GlobalLock":
        self._fd = os.open(self.path, os.O_CREAT | os.O_RDWR, 0o644)
        fcntl.flock(self._fd, fcntl.LOCK_EX)
        return self

    def __exit__(self, *exc) -> None:
        if self._fd is not None:
            fcntl.flock(self._fd, fcntl.LOCK_UN)
            os.close(self._fd)
            self._fd = None


class FileLease(Lease):
    """Cross-process lease: ``flock`` on a dedicated file.

    ``acquire`` is try-lock (or bounded blocking via ``wait``'s polling,
    inherited); ``release`` is idempotent; death of the holding process
    releases the underlying lock automatically."""

    def __init__(self, path: pathlib.Path):
        self.path = path
        self._fd: Optional[int] = None

    def acquire(self, block: bool = False, timeout: float = 0.0) -> bool:
        if self._fd is not None:
            return True
        fd = os.open(self.path, os.O_CREAT | os.O_RDWR, 0o644)
        if block:
            if not self._flock_deadline(fd, timeout):
                os.close(fd)
                return False
        else:
            try:
                fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
            except OSError:
                os.close(fd)
                return False
        self._fd = fd
        return True

    @staticmethod
    def _flock_deadline(fd: int, timeout: float, poll: float = 0.02) -> bool:
        deadline = time.perf_counter() + timeout
        while True:
            try:
                fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
                return True
            except OSError:
                if time.perf_counter() >= deadline:
                    return False
                time.sleep(poll)

    def release(self) -> None:
        if self._fd is not None:
            try:
                fcntl.flock(self._fd, fcntl.LOCK_UN)
            finally:
                os.close(self._fd)
                self._fd = None


class FileTier:
    """Shared-directory ``SharedTier`` backend (see module docstring)."""

    trusted = False  # cross-process entries: pair hits must replay their cert

    def __init__(
        self,
        directory: str,
        *,
        ttl_seconds: Optional[float] = None,
        byte_budget: Optional[int] = None,
    ):
        if ttl_seconds is not None and ttl_seconds <= 0:
            raise ValueError(f"ttl_seconds must be positive, got {ttl_seconds}")
        if byte_budget is not None and byte_budget <= 0:
            raise ValueError(f"byte_budget must be positive, got {byte_budget}")
        self.dir = pathlib.Path(directory).expanduser()
        self.ttl_seconds = ttl_seconds
        self.byte_budget = byte_budget
        for sub in ("verdicts", "validity", "pairs", "tables", "objects", "leases"):
            (self.dir / sub).mkdir(parents=True, exist_ok=True)
        self._lockfile = self.dir / "tier.lock"
        self._stats_lock = threading.Lock()  # counters only
        self.hits = 0
        self.misses = 0
        self.corrupt_entries_skipped = 0
        self.expired_entries = 0
        self.evictions = 0
        self.digest_rejections = 0
        # what writing new table payloads cost this process (the port's own
        # stats: a fleet worker reports them at every drain)
        self.payload_write_seconds = 0.0
        self.payload_bytes_written = 0

    # -- counters -------------------------------------------------------------
    def _bump(self, name: str, by: int = 1) -> None:
        with self._stats_lock:
            setattr(self, name, getattr(self, name) + by)

    # -- generic JSON entries -------------------------------------------------
    def _entry_path(self, namespace: str, *key: str) -> pathlib.Path:
        return self.dir / namespace / f"{_hname(*key)}.json"

    def _read_entry(self, namespace: str, *key: str) -> Optional[dict]:
        """Read one entry, enforcing TTL and the embedded-key self-check.
        Anything damaged is unlinked and counted — a miss, never a raise."""
        path = self._entry_path(namespace, *key)
        try:
            if self._expired(path):
                self._bump("expired_entries")
                self._bump("misses")
                self._unlink(path)
                return None
            rec = json.loads(path.read_text())
            if not isinstance(rec, dict) or rec.get("k") != list(key):
                raise ValueError("key self-check failed")
        except FileNotFoundError:
            self._bump("misses")
            return None
        except (OSError, json.JSONDecodeError, ValueError, TypeError):
            self._bump("corrupt_entries_skipped")
            self._bump("misses")
            self._unlink(path)
            return None
        self._bump("hits")
        return rec

    def _write_entry(self, namespace: str, key: Tuple[str, ...], payload: dict) -> None:
        payload = {"k": list(key), **payload}
        _atomic_write(
            self._entry_path(namespace, *key),
            lambda f: f.write(json.dumps(payload)),
        )

    def _expired(self, path: pathlib.Path) -> bool:
        if self.ttl_seconds is None:
            return False
        try:
            return (time.time() - path.stat().st_mtime) > self.ttl_seconds
        except OSError:
            return False  # vanished: the read path reports the plain miss

    @staticmethod
    def _unlink(path: pathlib.Path) -> None:
        try:
            path.unlink()
        except OSError:
            pass

    # -- window verdicts ------------------------------------------------------
    def get_verdict(self, ev_name, fingerprint):
        rec = self._read_entry("verdicts", ev_name, fingerprint)
        if rec is None:
            return None
        try:
            return _VERDICT_FROM_JSON[rec["v"]], float(rec["s"])
        except (KeyError, TypeError, ValueError):
            self._bump("corrupt_entries_skipped")
            self._unlink(self._entry_path("verdicts", ev_name, fingerprint))
            return None

    def put_verdict(self, ev_name, fingerprint, verdict, elapsed):
        self._write_entry(
            "verdicts",
            (ev_name, fingerprint),
            {"v": _VERDICT_TO_JSON[verdict], "s": round(float(elapsed), 6)},
        )

    def get_validity(self, ev_name, fingerprint):
        rec = self._read_entry("validity", ev_name, fingerprint)
        if rec is None or not isinstance(rec.get("ok"), bool):
            return None
        return rec["ok"]

    def put_validity(self, ev_name, fingerprint, valid):
        self._write_entry("validity", (ev_name, fingerprint), {"ok": bool(valid)})

    # -- pairs ----------------------------------------------------------------
    def get_pair(self, key: str) -> Optional[PairRecord]:
        rec = self._read_entry("pairs", key)
        if rec is None:
            return None
        try:
            cert = rec["cert"]
            if cert is not None and not isinstance(cert, str):
                raise TypeError("cert must be a JSON string")
            return PairRecord(
                verdict=bool(rec["verdict"]),
                certificate_json=cert,
                ev_calls_avoided=int(rec["calls"]),
                ev_time_avoided=float(rec["time"]),
            )
        except (KeyError, TypeError, ValueError):
            self._bump("corrupt_entries_skipped")
            self._unlink(self._entry_path("pairs", key))
            return None

    def put_pair(self, key: str, record: PairRecord) -> None:
        self._write_entry(
            "pairs",
            (key,),
            {
                "verdict": record.verdict,
                "cert": record.certificate_json,
                "calls": record.ev_calls_avoided,
                "time": round(record.ev_time_avoided, 6),
            },
        )

    # -- tables ---------------------------------------------------------------
    def get_table(self, key: str) -> Optional[Tuple[Table, float]]:
        rec = self._read_entry("tables", key)
        if rec is None:
            return None
        try:
            tdigest, elapsed = str(rec["table"]), float(rec["elapsed"])
        except (KeyError, TypeError, ValueError):
            self._bump("corrupt_entries_skipped")
            self._unlink(self._entry_path("tables", key))
            return None
        table = self._read_payload(tdigest)
        if table is None or table_digest(table) != tdigest:
            # truncated npz, malformed meta, or valid-looking bytes that do
            # not hash to their content address: never serve them
            self._bump("digest_rejections" if table is not None else
                       "corrupt_entries_skipped")
            with _GlobalLock(self._lockfile):
                self._release_table_locked(key)
                self._drop_payload(tdigest)  # unreadable/forged: rewritable
            return None
        return table, elapsed

    def put_table(self, key: str, table: Table, elapsed: float = 0.0) -> None:
        tdigest = table_digest(table)
        with _GlobalLock(self._lockfile):
            old = self._peek_table_ref(key)
            path = self.dir / "objects" / f"{tdigest}.npz"
            if not path.exists():
                t0 = time.perf_counter()
                self._write_payload(tdigest, table)
                with self._stats_lock:
                    self.payload_write_seconds += time.perf_counter() - t0
                    self.payload_bytes_written += path.stat().st_size
            if old != tdigest:
                self._bump_refcount(tdigest, +1)
                if old is not None:
                    self._decref_and_maybe_gc(old, skip_key=key)
            self._write_entry(
                "tables", (key,),
                {"table": tdigest, "elapsed": round(float(elapsed), 6)},
            )
            self._enforce_byte_budget(protect=key)

    def release_table(self, key: str) -> None:
        """Drop one key's reference; GC the payload only when no live key
        still names it.  Releasing an absent key is a no-op — double
        releases can never drive a refcount past its true value."""
        with _GlobalLock(self._lockfile):
            self._release_table_locked(key)

    # -- table internals (caller holds the global lock) -----------------------
    def _peek_table_ref(self, key: str) -> Optional[str]:
        path = self._entry_path("tables", key)
        try:
            rec = json.loads(path.read_text())
            return str(rec["table"])
        except (OSError, json.JSONDecodeError, KeyError, TypeError, ValueError):
            return None

    def _release_table_locked(self, key: str) -> None:
        tdigest = self._peek_table_ref(key)
        self._unlink(self._entry_path("tables", key))
        if tdigest is not None:
            self._decref_and_maybe_gc(tdigest)

    def _refs_path(self, tdigest: str) -> pathlib.Path:
        return self.dir / "objects" / f"{tdigest}.refs"

    def _read_refcount(self, tdigest: str) -> int:
        try:
            return max(0, int(json.loads(self._refs_path(tdigest).read_text())["count"]))
        except (OSError, json.JSONDecodeError, KeyError, TypeError, ValueError):
            return 0  # missing/corrupt refcount: rebuilt by the live scan

    def _bump_refcount(self, tdigest: str, by: int) -> None:
        count = max(0, self._read_refcount(tdigest) + by)
        _atomic_write(
            self._refs_path(tdigest), lambda f: f.write(json.dumps({"count": count}))
        )

    def _live_references(self, tdigest: str) -> int:
        """Authoritative reference count: scan the key namespace.  This is
        the guard that makes stale refcounts and double releases harmless
        — a payload is freed only when *no key file* names it."""
        live = 0
        for p in (self.dir / "tables").glob("*.json"):
            try:
                if json.loads(p.read_text()).get("table") == tdigest:
                    live += 1
            except (OSError, json.JSONDecodeError, ValueError):
                continue
        return live

    def _decref_and_maybe_gc(self, tdigest: str, skip_key: Optional[str] = None) -> None:
        self._bump_refcount(tdigest, -1)
        if self._read_refcount(tdigest) <= 0:
            if self._live_references(tdigest) == 0:
                self._drop_payload(tdigest)
            else:
                # stale refcount (crash between key write and refs write, or
                # a corrupted refs file): resync to the live scan, keep it
                _atomic_write(
                    self._refs_path(tdigest),
                    lambda f: json.dump(
                        {"count": self._live_references(tdigest)}, f
                    ),
                )

    def _drop_payload(self, tdigest: str) -> None:
        for suffix in (".npz", ".meta.json", ".refs"):
            self._unlink(self.dir / "objects" / f"{tdigest}{suffix}")

    def _write_payload(self, tdigest: str, table: Table) -> None:
        payload, meta = {}, {"order": table.order, "object_cols": []}
        for c in table.order:
            arr = table.cols[c]
            if arr.dtype == object:
                meta["object_cols"].append(c)
                payload[c] = np.array([json.dumps(_jsonable(v)) for v in arr])
            else:
                payload[c] = arr
        _atomic_write(
            self.dir / "objects" / f"{tdigest}.npz",
            lambda f: np.savez(f, **payload),
            binary=True,
        )
        _atomic_write(
            self.dir / "objects" / f"{tdigest}.meta.json",
            lambda f: f.write(json.dumps(meta)),
        )

    def _read_payload(self, tdigest: str) -> Optional[Table]:
        try:
            meta = json.loads(
                (self.dir / "objects" / f"{tdigest}.meta.json").read_text()
            )
            with np.load(
                self.dir / "objects" / f"{tdigest}.npz", allow_pickle=False
            ) as data:
                cols = {}
                for c in meta["order"]:
                    arr = data[c]
                    if c in meta["object_cols"]:
                        arr = np.array([json.loads(s) for s in arr], dtype=object)
                    cols[c] = arr
            return Table(cols, meta["order"])
        except Exception:
            return None  # damaged payload reads as a miss, never a raise

    # -- eviction -------------------------------------------------------------
    def _object_bytes(self) -> int:
        total = 0
        for p in (self.dir / "objects").glob("*.npz"):
            try:
                total += p.stat().st_size
            except OSError:
                continue
        return total

    def _enforce_byte_budget(self, protect: Optional[str] = None) -> None:
        """Stalest-key-first eviction until object bytes fit the budget
        (caller holds the global lock).  The just-written ``protect`` key
        survives even when a single table exceeds the whole budget."""
        if self.byte_budget is None:
            return
        while self._object_bytes() > self.byte_budget:
            candidates = []
            for p in (self.dir / "tables").glob("*.json"):
                try:
                    rec = json.loads(p.read_text())
                    key = rec["k"][0]
                except (OSError, json.JSONDecodeError, KeyError,
                        IndexError, TypeError):
                    self._unlink(p)  # unreadable ref: drop, payload GCs below
                    continue
                if key == protect:
                    continue
                candidates.append((p.stat().st_mtime, key))
            if not candidates:
                # nothing left to evict but orphaned payloads may remain
                self._gc_orphan_payloads(protect)
                return
            candidates.sort()
            self._release_table_locked(candidates[0][1])
            self._bump("evictions")

    def _gc_orphan_payloads(self, protect: Optional[str] = None) -> None:
        protected = self._peek_table_ref(protect) if protect else None
        for p in (self.dir / "objects").glob("*.npz"):
            tdigest = p.stem
            if tdigest == protected:
                continue
            if self._live_references(tdigest) == 0:
                self._drop_payload(tdigest)

    def sweep(self) -> Dict[str, int]:
        """Expire TTL-stale entries and re-enforce the byte budget; returns
        what was dropped.  Cheap enough to run opportunistically (the
        fleet runs it at drain)."""
        dropped = {"expired": 0, "evicted_before": self.evictions}
        if self.ttl_seconds is not None:
            for namespace in ("verdicts", "validity", "pairs"):
                for p in (self.dir / namespace).glob("*.json"):
                    if self._expired(p):
                        self._unlink(p)
                        dropped["expired"] += 1
            with _GlobalLock(self._lockfile):
                for p in (self.dir / "tables").glob("*.json"):
                    if self._expired(p):
                        try:
                            key = json.loads(p.read_text())["k"][0]
                        except (OSError, json.JSONDecodeError, KeyError,
                                IndexError, TypeError):
                            self._unlink(p)
                            continue
                        self._release_table_locked(key)
                        dropped["expired"] += 1
        with _GlobalLock(self._lockfile):
            self._enforce_byte_budget()
            self._gc_orphan_payloads()
        dropped["evicted"] = self.evictions - dropped.pop("evicted_before")
        self._bump("expired_entries", dropped["expired"])
        return dropped

    # -- leases ---------------------------------------------------------------
    def lease(self, name: str) -> FileLease:
        return FileLease(self.dir / "leases" / f"{_hname(name)}.lock")

    # -- stats ----------------------------------------------------------------
    def stats(self) -> Dict[str, object]:
        with self._stats_lock:
            return {
                "backend": "remote",
                "dir": str(self.dir),
                "ttl_seconds": self.ttl_seconds,
                "byte_budget": self.byte_budget,
                "object_bytes": self._object_bytes(),
                "hits": self.hits,
                "misses": self.misses,
                "corrupt_entries_skipped": self.corrupt_entries_skipped,
                "expired_entries": self.expired_entries,
                "digest_rejections": self.digest_rejections,
                "evictions": self.evictions,
                "payload_write_seconds": self.payload_write_seconds,
                "payload_bytes_written": self.payload_bytes_written,
            }
