"""Veer-driven materialization reuse (paper Use cases 1 & 2).

``ReuseManager.submit(dag, sources)`` — execute (or reuse) a new pipeline
version, rebased on the **operator-level** content-addressed store
(``repro_torch.engine.store``).  Three reuse paths, strongest first:

  1. **digest identity** — any operator (sink *or interior*) whose Merkle
     content digest (upstream cone × concrete source bytes, see
     ``ExecutionPlan.digests``) is already materialized is served from the
     store, bit-identically, with no verification at all.  One changed
     filter late in a 40-operator pipeline re-executes its cone only.
  2. **certificate-backed semantic serving** — sinks the digests cannot
     serve are verified against previously-executed versions via Veer;
     a True verdict whose ``Certificate`` *replays green bound to the
     pair* yields a reuse frontier (``repro_torch.core.frontier``) from which
     the sinks are served under the declared table semantics (Def 2.2),
     guarded by source-digest equality so a rebound source can never
     alias stale results.
  3. **partial execution** — whatever remains runs through
     ``ExecutionPlan.run`` with store serving + materialization on, so
     the executed cone's outputs become reusable for the next version.

The store is shared with checkpointing in spirit (same content-hash dedup
scheme), so equivalent results are stored once (Use case 2: no periodic
de-duplication pass needed), and every *semantic* reuse decision is
recorded with its replayable ``Certificate`` in ``self.certificates`` —
serving a cached result is the verdict that most needs an audit trail.

Execution runs on the torch data plane on ``"cuda"`` unless the manager is
built with ``device="cpu"`` or a config whose ``plane`` is ``"numpy"``;
without CUDA the default raises ``PlaneError`` at the first submit.

All timing uses ``time.perf_counter`` (monotonic), and
``ReuseStats.recompute_time_saved`` totals the recorded original compute
cost of every served table — benchmark deltas are immune to wall-clock
adjustments.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.api.certificate import Certificate, certificate_from_evidence
from repro_torch.api.config import VeerConfig
from repro_torch.api.registry import EVRegistry
from repro_torch.core.dag import DataflowDAG
from repro_torch.core.edits import EditMapping
from repro_torch.core.ev.cache import VerdictCache
from repro_torch.core.frontier import FrontierError, compute_reuse_frontier
from repro_torch.engine.executor import ExecutionPlan
from repro_torch.engine.store import DiskMaterializationStore
from repro_torch.engine.table import Table

# The operator-level disk store backs the reuse layer, under the name the
# reference package exports here; it is key-addressed like every store of
# repro_torch.engine.store (put(key, table) -> wrote / get(key)).
MaterializationStore = DiskMaterializationStore


@dataclass
class ReuseStats:
    submissions: int = 0
    sink_hits: int = 0
    sink_misses: int = 0
    executions: int = 0
    verify_time: float = 0.0           # perf_counter deltas
    execute_time: float = 0.0          # perf_counter deltas
    dedup_skipped_writes: int = 0
    verdict_cache_hits: int = 0
    certified_reuses: int = 0   # reuse decisions backed by a replayable cert
    # operator-level accounting (new with the content-addressed store)
    interior_hits: int = 0      # non-sink tables served during partial exec
    ops_executed: int = 0
    ops_reused: int = 0
    # recorded original compute seconds every served table avoided — the
    # honest counterpart to execute_time for benchmark deltas
    recompute_time_saved: float = 0.0


@dataclass
class _Version:
    vid: int
    dag: DataflowDAG
    digests: Dict[str, Optional[str]]   # op id -> content digest
    sink_keys: Dict[str, str]           # sink id -> store key actually served


class ReuseManager:
    def __init__(
        self,
        directory: str,
        *,
        config: Optional[VeerConfig] = None,
        registry: Optional[EVRegistry] = None,
        byte_budget: Optional[int] = None,
        device: str = "cuda",
    ):
        """``config`` (default ``VeerConfig()``) names the EVs, resolved
        through ``registry``, and carries the semantics and the data plane.
        ``byte_budget`` bounds the on-disk store with LRU eviction.  Reuse
        decisions carry replayable certificates (``self.certificates``) —
        serving a stored result is exactly the kind of verdict an auditor
        wants evidence for.  ``device`` is where every version's
        ``ExecutionPlan`` runs its plane, as in ``VersionChainSession``."""
        config = config if config is not None else VeerConfig()
        veer = config.build(registry)
        self.config = config
        self.store = DiskMaterializationStore(directory, byte_budget=byte_budget)
        # EV verdicts live next to the materializations: one content-addressed
        # directory of reusable artifacts, shared across sessions.  A config
        # that names its own ``cache_path`` keeps that cache; otherwise the
        # verifier gets the store-local one.
        if veer.verdict_cache is None:
            veer.attach_cache(VerdictCache(self.store.dir / "ev_verdicts.json"))
        self.verdict_cache = veer.verdict_cache
        self.veer = veer
        self.semantics = config.semantics
        self.plane = config.plane
        self.device = device
        self._registry = registry
        self.versions: List[_Version] = []
        self.stats = ReuseStats()
        # certificate per reuse decision: (new version index, matched
        # version id, Certificate) — the audit trail for served results
        self.certificates: List[Tuple[int, int, Certificate]] = []

    def submit(
        self, dag: DataflowDAG, sources: Dict[str, Table]
    ) -> Dict[str, Table]:
        """Execute (or reuse) a pipeline version; returns sink tables."""
        dag.validate()
        plan = ExecutionPlan(dag, sources, plane=self.plane, device=self.device)
        self.stats.submissions += 1
        digests = plan.digests
        sinks = dag.sinks
        results: Dict[str, Table] = {}
        remaining = set(sinks)
        sink_keys: Dict[str, str] = {}

        # sinks the content digests cannot serve directly need Veer; the
        # rest resolve during partial execution (path 1, no verification)
        unresolved = {
            s for s in remaining
            if digests[s] is None or digests[s] not in self.store
        }
        if unresolved:
            self._serve_semantic(
                dag, digests, unresolved, remaining, results, sink_keys
            )

        if remaining:
            before = self.store.stats()
            t0 = time.perf_counter()
            res = plan.run(
                store=self.store,
                serve_from_store=True,
                materialize=True,
                keep=sorted(remaining),
            )
            self.stats.execute_time += time.perf_counter() - t0
            after = self.store.stats()
            if res.stats.ops_executed:
                self.stats.executions += 1
            self.stats.ops_executed += res.stats.ops_executed
            self.stats.ops_reused += res.stats.ops_reused
            self.stats.recompute_time_saved += res.stats.recompute_time_saved
            self.stats.dedup_skipped_writes += (
                after["dedup_skipped_writes"] - before["dedup_skipped_writes"]
            )
            reused = set(res.reused_ops)
            for s in remaining:
                results[s] = res.results[s]
                sink_keys[s] = digests[s]
                if s in reused:
                    self.stats.sink_hits += 1
                else:
                    self.stats.sink_misses += 1
            self.stats.interior_hits += res.stats.tables_served - len(
                remaining & reused
            )

        self.versions.append(
            _Version(len(self.versions), dag, digests, sink_keys)
        )
        self.verdict_cache.save()  # verdicts persist like materializations do
        return results

    def _serve_semantic(
        self,
        dag: DataflowDAG,
        digests: Dict[str, Optional[str]],
        unresolved: set,
        remaining: set,
        results: Dict[str, Table],
        sink_keys: Dict[str, str],
    ) -> None:
        """Path 2: verify against earlier versions, serve sinks off the
        certificate's reuse frontier (Def 2.2 equality, source-guarded)."""
        for prev in reversed(self.versions):
            if not unresolved:
                return
            t0 = time.perf_counter()
            verdict, vstats, evidence = self.veer.verify_with_evidence(
                prev.dag, dag, semantics=self.semantics
            )
            self.stats.verify_time += time.perf_counter() - t0
            self.stats.verdict_cache_hits += vstats.cache_hits
            if verdict is not True:
                continue
            cert = certificate_from_evidence(evidence)
            if cert is None:
                continue
            try:
                # reuse is only ever taken on a certificate that replays
                # green *bound to this pair* (tampered/truncated/foreign
                # evidence yields no frontier, never a wider one)
                frontier = compute_reuse_frontier(
                    cert, prev.dag, dag, registry=self._registry
                )
            except FrontierError:
                continue
            # source guard: Def 2.2 transfer needs the SAME concrete inputs —
            # every source of the matched version must map to a current
            # source bound to a byte-identical table
            fwd = EditMapping(cert.mapping).forward
            if not all(
                fwd.get(s) is not None
                and prev.digests.get(s) is not None
                and prev.digests.get(s) == digests.get(fwd[s])
                for s in prev.dag.sources
            ):
                continue
            # what may stand in for an unresolved sink: a frontier entry,
            # or — the Def 2.2 pair-level guarantee the True verdict itself
            # makes — the prev-version sink it maps to (corresponding sinks
            # of an equivalent pair are equal under the table semantics)
            bwd = EditMapping(cert.mapping).backward
            reusable = {**frontier.semantic, **frontier.exact}
            served = 0
            for q in sorted(unresolved):
                p = reusable.get(q)
                if p is None:
                    mapped = bwd.get(q)
                    if mapped is not None and mapped in prev.sink_keys:
                        p = mapped
                if p is None:
                    continue
                key = prev.sink_keys.get(p) or prev.digests.get(p)
                if key is None:
                    continue
                table = self.store.get(key)
                if table is None:
                    continue  # evicted or corrupt: fall through to execution
                results[q] = table
                sink_keys[q] = key
                unresolved.discard(q)
                remaining.discard(q)
                self.stats.sink_hits += 1
                self.stats.recompute_time_saved += self.store.recorded_cost(key)
                served += 1
            if served:
                # only decisions that actually served a result enter the
                # audit trail — an equivalent version whose sinks were
                # already covered reused nothing
                self.certificates.append((len(self.versions), prev.vid, cert))
                self.stats.certified_reuses += 1
