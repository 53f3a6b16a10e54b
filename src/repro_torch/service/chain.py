"""Version-chain verification service (paper §1 workload, ROADMAP north star).

Iterative analytics produces *chains* of dataflow versions: v1 → v2 → … → vn,
each a handful of edits from its predecessor.  ``Veer.verify`` answers one
pair; a ``VersionChainSession`` answers the whole chain while amortizing EV
cost across pairs through the canonical-fingerprint verdict cache
(``repro_torch.core.ev.cache``): a window isomorphic to one decided for *any*
earlier pair — or persisted by an earlier session — resolves without an EV
call.  This is the GEqO/EqDAC observation (cache and share semantic
equivalence sub-results) applied to Veer's windowed decomposition search.

Every decided pair carries a replayable ``repro_torch.api.Certificate`` — cached
cross-session verdicts are auditable evidence, not trust-me (see
``repro_torch.api.certificate``); ``ChainReport.summary()`` shows which pairs are
certificate-backed.

Execution (``sources=`` on ``submit``) runs on the torch data plane on
``"cuda"`` unless the session is built with ``device="cpu"`` or a config
whose ``plane`` is ``"numpy"``; without CUDA the default raises
``PlaneError`` at the first executing submit.

Typical use::

    from repro_torch.api import VeerConfig

    session = VersionChainSession(
        config=VeerConfig(cache_path="~/.veer/verdicts.json")
    )
    session.submit(v1)                  # first version: nothing to verify
    report = session.submit(v2)         # verifies (v1, v2)
    report.certificate.replay()         # audit the verdict, no search
    report = session.submit(v3)         # verifies (v2, v3), reusing verdicts
    print(session.report().summary())
    session.save()                      # persist verdicts for the next session

or, batch-style::

    report = verify_chain([v1, v2, ..., vn])
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from repro_torch.api.certificate import Certificate, certificate_from_evidence
from repro_torch.api.config import VeerConfig
from repro_torch.api.registry import EVRegistry
from repro_torch.core.dag import DataflowDAG
from repro_torch.core.edits import EditMapping
from repro_torch.core.ev.cache import VerdictCache
from repro_torch.core.frontier import FrontierError, ReuseFrontier, compute_reuse_frontier
from repro_torch.core.verifier import VeerStats
from repro_torch.engine.executor import ExecStats, ExecutionPlan
from repro_torch.engine.store import MaterializationStore
from repro_torch.engine.table import Table
from repro_torch.service.pair_cache import PairVerdictCache


@dataclass
class PairReport:
    """Verification outcome for one consecutive pair of the chain."""

    index: int                      # pair k verifies (version k-1, version k)
    verdict: Optional[bool]         # True / False / None (Unknown)
    wall_time: float
    stats: VeerStats
    certificate: Optional[Certificate] = None
    # whether the verdict is certificate-backed (set from ``certificate``)
    certified: bool = False
    # verdict + certificate reused wholesale from a PairVerdictCache hit
    # (no search ran for this pair; stats carry only the avoided work)
    reused: bool = False
    # execute-with-reuse mode (sources= passed to submit): accounting for
    # this version's partial execution, the certificate-derived frontier
    # that seeded it, and the sink tables (results are handed to the
    # submit caller only — the session-lifetime report drops them)
    exec_stats: Optional[ExecStats] = None
    frontier: Optional[ReuseFrontier] = None
    results: Optional[Dict[str, Table]] = None

    def __post_init__(self) -> None:
        if self.certificate is not None:
            self.certified = True

    @property
    def equivalent(self) -> bool:
        return self.verdict is True

    @property
    def ev_calls(self) -> int:
        return self.stats.ev_calls

    @property
    def cache_hits(self) -> int:
        return self.stats.cache_hits

    @property
    def ev_calls_saved(self) -> int:
        return self.stats.ev_calls_saved

    def row(self) -> str:
        v = {True: "EQ", False: "NEQ", None: "UNK"}[self.verdict]
        cert = "cert" if self.certified else "----"
        line = (
            f"pair {self.index:>3}: {v:>3}  {cert}  ev_calls={self.ev_calls:<4} "
            f"cache_hits={self.cache_hits:<4} saved={self.ev_calls_saved:<4} "
            f"{self.wall_time * 1e3:8.1f} ms"
            + ("  reused" if self.reused else "")
        )
        if self.exec_stats is not None:
            e = self.exec_stats
            line += (
                f"  exec[{e.ops_executed}/{e.ops_total} ops, "
                f"{e.ops_reused} reused, {e.tables_served} served]"
            )
            if e.ops_delta:
                line += (
                    f"  delta[{e.ops_delta} ops, "
                    f"{e.delta_rows_processed} rows]"
                )
        return line


@dataclass
class ChainReport:
    """Aggregate over all pairs verified so far in a session."""

    pairs: List[PairReport] = field(default_factory=list)
    # execute-with-reuse: accounting for the chain's FIRST version (it has
    # no pair — v1 executes fully and materializes the seed corpus)
    initial_exec: Optional[ExecStats] = None

    @property
    def exec_stats_list(self) -> List[ExecStats]:
        out = [self.initial_exec] if self.initial_exec is not None else []
        out.extend(p.exec_stats for p in self.pairs if p.exec_stats is not None)
        return out

    @property
    def total_ops_executed(self) -> int:
        return sum(e.ops_executed for e in self.exec_stats_list)

    @property
    def total_ops_reused(self) -> int:
        return sum(e.ops_reused for e in self.exec_stats_list)

    @property
    def total_tables_served(self) -> int:
        return sum(e.tables_served for e in self.exec_stats_list)

    @property
    def total_ops(self) -> int:
        return sum(e.ops_total for e in self.exec_stats_list)

    @property
    def total_ops_delta(self) -> int:
        """Operators whose outputs came from delta rules, chain-wide."""
        return sum(e.ops_delta for e in self.exec_stats_list)

    @property
    def total_delta_rows_processed(self) -> int:
        """Delta rows (inserts + deletes) the delta rules touched — the
        O(|Δ|) work that replaced full re-execution."""
        return sum(e.delta_rows_processed for e in self.exec_stats_list)

    @property
    def total_recompute_time_saved(self) -> float:
        """Recorded original compute cost of every table served instead of
        recomputed (store-recorded seconds)."""
        return sum(e.recompute_time_saved for e in self.exec_stats_list)

    @property
    def executed_fraction(self) -> float:
        """Share of all chain operators that actually ran ``execute_op`` —
        the headline the exec benchmark bounds (≤ 0.30 on the 12-version
        workload with a warm verdict cache)."""
        return self.total_ops_executed / max(1, self.total_ops)

    @property
    def total_ev_calls(self) -> int:
        return sum(p.ev_calls for p in self.pairs)

    @property
    def total_cache_hits(self) -> int:
        return sum(p.cache_hits for p in self.pairs)

    @property
    def total_ev_calls_saved(self) -> int:
        return sum(p.ev_calls_saved for p in self.pairs)

    @property
    def total_wall_time(self) -> float:
        return sum(p.wall_time for p in self.pairs)

    @property
    def verdicts(self) -> List[Optional[bool]]:
        return [p.verdict for p in self.pairs]

    @property
    def certified_pairs(self) -> int:
        return sum(1 for p in self.pairs if p.certified)

    @property
    def reused_pairs(self) -> int:
        """Pairs answered wholesale from the shared pair-verdict cache."""
        return sum(1 for p in self.pairs if p.reused)

    @property
    def certified_fraction(self) -> float:
        """Share of *decided* (True/False) pairs backed by a certificate."""
        decided = [p for p in self.pairs if p.verdict is not None]
        if not decided:
            return 0.0
        return sum(1 for p in decided if p.certified) / len(decided)

    def summary(self) -> str:
        lines = [p.row() for p in self.pairs]
        lines.append(
            f"chain: {len(self.pairs)} pairs, "
            f"{self.certified_pairs} certificate-backed, "
            f"{self.total_ev_calls} EV calls, "
            f"{self.total_cache_hits} cache hits, "
            f"{self.total_ev_calls_saved} calls saved, "
            f"{self.total_wall_time * 1e3:.1f} ms"
        )
        if self.exec_stats_list:
            lines.append(
                f"exec:  {self.total_ops_executed}/{self.total_ops} ops "
                f"executed ({100.0 * self.executed_fraction:.0f}%), "
                f"{self.total_ops_reused} reused, "
                f"{self.total_tables_served} tables served"
            )
        if self.total_ops_delta:
            lines.append(
                f"delta: {self.total_ops_delta} ops via delta rules, "
                f"{self.total_delta_rows_processed} delta rows, "
                f"{self.total_recompute_time_saved * 1e3:.1f} ms "
                f"recompute saved"
            )
        return "\n".join(lines)


class VersionChainSession:
    """Stateful chain-verification service around a cache-backed ``Veer``.

    Each ``submit`` verifies the new version against the previous one; all
    pairs share one ``VerdictCache`` (persisted at ``config.cache_path`` when
    it is set), so pair *k*
    pays EV cost only for windows no earlier pair or session has decided.
    """

    def __init__(
        self,
        *,
        config: Optional[VeerConfig] = None,
        registry: Optional[EVRegistry] = None,
        pair_cache: Optional[PairVerdictCache] = None,
        materialization_store: Optional[MaterializationStore] = None,
        device: str = "cuda",
    ):
        """``config`` (default ``VeerConfig()``) names the EVs, resolved
        through ``registry``, and carries the semantics, the data plane, the
        ``exec_mode`` and the verdict cache's path and LRU bound (in-memory
        when ``cache_path`` is None).

        ``pair_cache`` (a shared ``repro_torch.service.pair_cache
        .PairVerdictCache``) short-circuits whole pairs already decided by
        any session sharing the cache: a content-digest hit reuses the
        original verdict *and certificate* without running the search —
        so N clients evolving the same pipeline cost one client's worth
        of work.

        ``materialization_store`` enables **execute-with-reuse**: pass
        ``sources=`` to ``submit`` and the session executes each version
        through an ``ExecutionPlan``, materializing operator outputs into
        the store and seeding every successor from the certificate-derived
        reuse frontier (``repro_torch.core.frontier``) — v1 runs fully, each
        later version recomputes only its changed cone.  Seeding is taken
        only from exact-tier frontier entries whose content digests match,
        so the returned sink tables are bit-identical to a full
        re-execution; frontier reuse is only ever taken when the pair's
        certificate replays green against the pair.

        ``device`` is where every ``ExecutionPlan`` of the session runs its
        plane (``"cuda"`` unless the caller asks for ``"cpu"``); it is not
        part of the config, so ``VeerConfig.to_json()`` does not carry it."""
        config = config if config is not None else VeerConfig()
        # honor the config's LRU bound so long-lived sessions do not
        # accumulate verdict/validity entries without limit
        self.cache = VerdictCache(
            config.cache_path, max_entries=config.cache_max_entries
        )
        self.config = config
        self.veer = config.build(registry, cache=self.cache)
        self.semantics = config.semantics
        # data plane for execute-with-reuse submits; plane-invariant bytes
        # keep store keys / frontier digests / certificates unchanged
        self.plane = config.plane
        self.device = device
        # how successor versions execute: full / reuse / delta (mode-invariant
        # sink bytes; "delta" falls back to the seeded reuse run whenever the
        # edit is not amenable or a required table left the store)
        self.exec_mode = config.exec_mode
        self.pair_cache = pair_cache
        self.store = materialization_store
        self._registry = registry
        # only the previous version is needed for the next pair; a long-lived
        # session must not accumulate every DAG it ever saw
        self._prev: Optional[DataflowDAG] = None
        self._prev_plan: Optional[ExecutionPlan] = None
        self.version_count = 0
        self._report = ChainReport()

    # -- service API ---------------------------------------------------------
    def submit(
        self,
        version: DataflowDAG,
        mapping: Optional[EditMapping] = None,
        *,
        sources: Optional[Dict[str, Table]] = None,
    ) -> Optional[PairReport]:
        """Append a version; verify it against the previous one.

        ``mapping`` is the tracked edit mapping from the previous version to
        this one (defaults to the id-stable identity mapping, the natural
        choice when the version-control layer assigns stable operator ids).
        Returns ``None`` for the first version (nothing to verify yet).

        ``sources`` (execute-with-reuse mode; needs a session
        ``materialization_store``) additionally *executes* the version:
        the first version runs fully, successors recompute only the cone
        the edit touched, seeded from exact-tier frontier entries of the
        pair's replay-green certificate.  The returned report then carries
        ``exec_stats``, the ``frontier``, and the sink ``results`` —
        including for the **first** version, which gets a report (verdict
        ``None``, nothing to verify) instead of the verify-only ``None``.
        """
        version.validate()
        if sources is not None and self.store is None:
            # checked before any session state moves: a rejected submit must
            # leave the chain exactly where it was
            raise ValueError(
                "execute-with-reuse needs a session materialization_store"
            )
        plan: Optional[ExecutionPlan] = None
        if sources is not None:
            # built before any session state moves, like the store check:
            # a plane that cannot run here (PlaneError) rejects the submit
            plan = ExecutionPlan(version, sources, plane=self.plane,
                                 device=self.device)
        prev, self._prev = self._prev, version
        self.version_count += 1
        prev_plan, self._prev_plan = self._prev_plan, plan

        if prev is None:
            if plan is None:
                return None
            res = plan.run(store=self.store, materialize=True)
            self._report.initial_exec = res.stats
            return PairReport(
                index=0,
                verdict=None,
                wall_time=res.stats.wall_time,
                stats=VeerStats(),
                exec_stats=res.stats,
                results=res.results,
            )

        t0 = time.perf_counter()
        verdict, stats, certificate, reused = self._decide(prev, version, mapping)
        exec_stats = frontier = results = None
        if plan is not None:
            if self.exec_mode == "full":
                res = plan.run(store=self.store, materialize=True)
            else:
                frontier, seed_keys = self._frontier_seeds(
                    prev, version, certificate, verdict, prev_plan, plan
                )
                res = None
                if self.exec_mode == "delta" and frontier is not None:
                    res = self._try_delta(frontier, prev, prev_plan, plan)
                if res is None:
                    res = plan.run(
                        store=self.store, seed_keys=seed_keys,
                        materialize=True,
                    )
            exec_stats, results = res.stats, res.results
        report = PairReport(
            index=self.version_count - 1,
            verdict=verdict,
            wall_time=time.perf_counter() - t0,
            stats=stats,
            certificate=certificate,
            reused=reused,
            exec_stats=exec_stats,
            frontier=frontier,
            results=results,
        )
        # the session-lifetime report never accumulates sink tables
        self._report.pairs.append(dataclasses.replace(report, results=None))
        return report

    def _frontier_seeds(
        self,
        prev: DataflowDAG,
        version: DataflowDAG,
        certificate: Optional[Certificate],
        verdict: Optional[bool],
        prev_plan: Optional[ExecutionPlan],
        plan: ExecutionPlan,
    ):
        """Certificate-gated seeding for this version's partial execution.

        Only a True verdict whose certificate **replays green bound to the
        pair** yields a frontier (``compute_reuse_frontier`` enforces it);
        only *exact-tier* entries are seeded, and each one additionally
        requires digest equality between the Q operator's cone (current
        sources folded in) and the P operator's materialized table — so a
        source rebinding or any mismatch falls back to recomputation and
        the executed results stay bit-identical to a full run.
        """
        if verdict is not True or certificate is None or prev_plan is None:
            return None, {}
        try:
            frontier = compute_reuse_frontier(
                certificate, prev, version, registry=self._registry
            )
        except FrontierError:
            return None, {}
        prev_digests = prev_plan.digests
        cur_digests = plan.digests
        seed_keys = {}
        for q_op, p_op in frontier.exact.items():
            key = prev_digests.get(p_op)
            if key is not None and cur_digests.get(q_op) == key:
                seed_keys[q_op] = key
        return frontier, seed_keys

    def _try_delta(
        self,
        frontier: ReuseFrontier,
        prev: DataflowDAG,
        prev_plan: Optional[ExecutionPlan],
        plan: ExecutionPlan,
    ):
        """Delta tier: O(|Δrows|) propagation through the changed cone.

        Engages only on a frontier from ``_frontier_seeds`` — i.e. a True
        verdict whose certificate replayed green for the pair — and only
        when the edit is statically amenable (``compute_delta_plan``).
        Returns ``None`` on any fallback condition (not amenable, a table
        evicted mid-chain, a byte-identity precondition violated at run
        time), and the caller takes the seeded reuse run instead — the
        sink bytes are identical either way, only the cost differs.
        """
        if prev_plan is None:
            return None
        from repro_torch.core.frontier import compute_delta_plan
        from repro_torch.engine.delta import DeltaUnsupported, execute_delta

        dplan = compute_delta_plan(frontier, prev, plan.dag)
        if dplan is None:
            return None
        try:
            return execute_delta(
                dplan, prev, plan, prev_plan.digests, self.store
            )
        except DeltaUnsupported:
            return None

    def _decide(
        self,
        prev: DataflowDAG,
        version: DataflowDAG,
        mapping: Optional[EditMapping],
    ):
        """Verify one pair, going through the shared pair-verdict cache
        when one is attached (single-flight: concurrent sessions deciding
        the same content-identical pair run the search exactly once)."""
        def compute():
            verdict, stats, evidence = self.veer.verify_with_evidence(
                prev, version, mapping, semantics=self.semantics
            )
            return verdict, stats, certificate_from_evidence(evidence)

        if self.pair_cache is None:
            verdict, stats, certificate = compute()
            return verdict, stats, certificate, False
        key = self.pair_cache.make_key(prev, version, self.semantics, mapping)
        return self.pair_cache.compute_or_reuse(
            key, compute, pair=(prev, version)
        )

    def report(self) -> ChainReport:
        return self._report

    def save(self) -> None:
        """Persist the verdict cache (no-op for purely in-memory caches)."""
        self.cache.save()

    def close(self) -> None:
        """Persist the cache and release the verifier's window-dispatch
        pool (relevant for ``VeerConfig(max_workers > 1)``); the session
        remains usable — the pool is recreated on the next parallel run."""
        self.save()
        self.veer.close()

    def __enter__(self) -> "VersionChainSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def verify_chain(
    versions: Sequence[DataflowDAG],
    mappings: Optional[Sequence[Optional[EditMapping]]] = None,
    *,
    config: Optional[VeerConfig] = None,
    registry: Optional[EVRegistry] = None,
) -> ChainReport:
    """Batch entry point: verify every consecutive pair of ``versions`` in
    a session built from ``config`` and ``registry`` (nothing executes).

    ``mappings[k]`` (optional) maps version k to version k+1.
    """
    if mappings is not None and len(mappings) != len(versions) - 1:
        raise ValueError("need exactly one mapping per consecutive pair")
    session = VersionChainSession(config=config, registry=registry)
    for k, v in enumerate(versions):
        session.submit(v, mappings[k - 1] if mappings and k > 0 else None)
    session.save()
    return session.report()
