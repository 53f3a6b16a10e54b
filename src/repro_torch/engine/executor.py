"""Plan-based DAG executor with incremental, materialization-backed reuse.

``execute(dag, sources)`` keeps its §2.2 contract (run a version on bound
source tables, return the sink tables), but is now a thin wrapper over
``ExecutionPlan`` — the abstraction the reuse stack is built on:

  * **content digests** — every operator gets a Merkle-style content
    address: ``H(op.signature(), input digests)``, grounded at sources in
    ``H(signature, table_digest(bound table))``.  The digest captures the
    operator's *entire upstream cone plus the concrete source bytes*, and
    the engine is deterministic and identity-free (``execute_op`` reads
    only type + properties), so **equal digests imply bit-identical
    results** — across versions, sessions, and processes.  This is the
    key a ``MaterializationStore`` entry is filed under.

  * **partial execution** — ``run`` accepts seeds (tables, or store keys
    resolved lazily) and recomputes only the *affected cone*: a backward
    pass from the requested outputs stops at every resolved operator, so
    operators upstream of a seed are never visited, let alone executed.

  * **reference-counted freeing** — an operator's result is dropped as
    soon as its last consumer has read it (fan-out counted over
    ``dag.in_links``), instead of every intermediate staying live until
    the end; ``ExecStats.peak_live_tables`` makes the improvement
    measurable and testable.

Seeding policy: ``run`` only ever seeds what the *caller* resolved —
byte-identity is the caller's contract to uphold.  Digest-equality serving
(``serve_from_store``) is bit-identical to a full run by construction.
"""

from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Set, Tuple

from repro_torch.core import dag as D
from repro_torch.core.dag import DataflowDAG
from repro_torch.engine.store import MaterializationStore, table_digest
from repro_torch.engine.table import Table, tables_equal


@dataclass
class ExecStats:
    """Accounting for one ``ExecutionPlan.run``.

    ``ops_total`` counts the DAG's operators; every operator lands in
    exactly one of ``ops_executed`` (ran ``execute_op`` or bound a source),
    ``ops_reused`` (result adopted without execution — seeded by the
    caller or served from the store), or ``ops_skipped`` (never needed:
    upstream of a reused result, or off the requested outputs).
    ``tables_served`` is the subset of reuses fetched from the
    ``MaterializationStore``; ``recompute_time_saved`` sums the recorded
    original compute cost of every served table (``perf_counter``-based,
    so benchmark deltas are immune to wall-clock adjustments).
    """

    ops_total: int = 0
    ops_executed: int = 0
    ops_reused: int = 0
    ops_skipped: int = 0
    plane: str = "numpy"
    ops_lowered: int = 0
    tables_served: int = 0
    store_writes: int = 0
    store_dedup_skipped: int = 0
    peak_live_tables: int = 0
    freed_tables: int = 0
    recompute_time_saved: float = 0.0
    wall_time: float = 0.0

    def as_dict(self) -> Dict[str, object]:
        return dict(self.__dict__)


@dataclass
class ExecResult:
    """Requested output tables + run accounting + which ops were reused."""

    results: Dict[str, Table]
    stats: ExecStats
    reused_ops: Tuple[str, ...] = ()


class ExecutionPlan:
    """One version bound to concrete source tables, ready to (re)execute.

    The plan owns the topological order and the per-operator content
    digests; ``run`` may be called repeatedly (e.g. once to materialize,
    again to serve) — each call returns a fresh ``ExecResult``.
    """

    def __init__(
        self,
        dag: DataflowDAG,
        sources: Mapping[str, Table],
        *,
        plane: str = "torch",
        device: str = "cuda",
    ):
        """The plan runs on the ``torch`` plane on ``"cuda"`` unless the
        caller asks for ``device="cpu"`` or for the host reference,
        ``plane="numpy"`` (which does not read ``device``).  Without CUDA the
        default raises ``PlaneError``."""
        dag.validate()
        self.dag = dag
        self.sources: Dict[str, Table] = dict(sources)
        self.order: List[str] = dag.topo_order()
        self._digests: Optional[Dict[str, Optional[str]]] = None
        # planes are a pure performance choice: digests/reuse keys hash the
        # canonical numpy bytes, which every plane must reproduce exactly
        from repro_torch.engine.plane import get_plane

        self.plane = get_plane(plane, device=device)

    # -- content digests ------------------------------------------------------
    @property
    def digests(self) -> Dict[str, Optional[str]]:
        """Merkle content digest per operator (``None`` below an unbound
        source — such cones have no content address).  Computed once per
        plan; source-table hashing is memoized on the tables themselves."""
        if self._digests is None:
            out: Dict[str, Optional[str]] = {}
            for op_id in self.order:
                op = self.dag.ops[op_id]
                if op.op_type == D.SOURCE:
                    bound = self.sources.get(op_id)
                    if bound is None:
                        out[op_id] = None
                        continue
                    blob = repr(("src", op.signature(), table_digest(bound)))
                else:
                    ins = [out[l.src] for l in self.dag.in_links[op_id]]
                    if any(i is None for i in ins):
                        out[op_id] = None
                        continue
                    blob = repr((op.signature(), tuple(ins)))
                out[op_id] = hashlib.sha256(blob.encode()).hexdigest()[:32]
            self._digests = out
        return self._digests

    # -- execution ------------------------------------------------------------
    def run(
        self,
        *,
        seed: Optional[Mapping[str, Table]] = None,
        seed_keys: Optional[Mapping[str, str]] = None,
        store: Optional[MaterializationStore] = None,
        serve_from_store: bool = False,
        materialize: bool = False,
        keep: Optional[Sequence[str]] = None,
    ) -> ExecResult:
        """Execute the affected cone; everything else is reused or skipped.

        ``seed``            op id → table the caller already holds.
        ``seed_keys``       op id → store key; fetched lazily, only for
                            operators the backward pass actually reaches
                            (a miss — evicted or corrupt entry — falls
                            back to recomputation, never to an error).
        ``serve_from_store``resolve any reached operator whose own content
                            digest is in ``store`` (digest-equality reuse:
                            bit-identical by construction).
        ``materialize``     put every executed operator's table into
                            ``store`` under its content digest.
        ``keep``            which operators' tables to return (default:
                            the DAG's sinks).
        """
        t_start = time.perf_counter()
        keep_list = list(keep) if keep is not None else list(self.dag.sinks)
        stats = ExecStats(ops_total=len(self.dag.ops), plane=self.plane.name)
        seed = dict(seed) if seed else {}
        seed_keys = dict(seed_keys) if seed_keys else {}
        if (seed_keys or serve_from_store or materialize) and store is None:
            raise ValueError("seed_keys/serve_from_store/materialize need a store")
        digests = self.digests if (serve_from_store or materialize) else None

        # -- pin every store entry this run may read: a concurrent
        #    byte-budget evict mid-run must not free a table between the
        #    backward pass resolving it and the forward pass consuming it
        pinned_keys: Tuple[str, ...] = ()
        if store is not None and hasattr(store, "pin"):
            want = set(seed_keys.values())
            if serve_from_store:
                want.update(d for d in digests.values() if d is not None)
            if want:
                pinned_keys = store.pin(want)
        try:
            return self._run_passes(
                keep_list, stats, seed, seed_keys, store,
                serve_from_store, materialize, digests, t_start,
            )
        finally:
            if pinned_keys:
                store.unpin(pinned_keys)

    def _run_passes(
        self,
        keep_list: List[str],
        stats: ExecStats,
        seed: Dict[str, Table],
        seed_keys: Dict[str, str],
        store: Optional[MaterializationStore],
        serve_from_store: bool,
        materialize: bool,
        digests: Optional[Dict[str, Optional[str]]],
        t_start: float,
    ) -> ExecResult:
        # -- backward pass: find the affected cone, resolving reuse lazily
        resolved: Dict[str, Table] = {}
        needed: Set[str] = set()
        visited: Set[str] = set()
        stack = list(keep_list)
        while stack:
            op_id = stack.pop()
            if op_id in visited:
                continue
            visited.add(op_id)
            table = seed.get(op_id)
            served = False
            if table is None and store is not None:
                key = seed_keys.get(op_id)
                if key is None and serve_from_store:
                    key = digests[op_id]
                if key is not None:
                    table = store.get(key)
                    if table is not None:
                        served = True
                        stats.recompute_time_saved += getattr(
                            store, "recorded_cost", lambda k: 0.0
                        )(key)
            if table is not None:
                resolved[op_id] = table
                stats.ops_reused += 1
                stats.tables_served += served
                continue  # inputs not needed: the cone stops here
            needed.add(op_id)
            stack.extend(l.src for l in self.dag.in_links[op_id])

        # -- refcounts: consumers among *executing* ops, +pin for kept outputs
        refcount: Dict[str, int] = {}
        for op_id in needed:
            for l in self.dag.in_links[op_id]:
                refcount[l.src] = refcount.get(l.src, 0) + 1
        pinned = set(keep_list)

        # -- forward pass over the affected cone, freeing as consumers drain
        results: Dict[str, Table] = {}
        for op_id in self.order:
            if op_id in resolved:
                if refcount.get(op_id, 0) > 0 or op_id in pinned:
                    results[op_id] = resolved[op_id]
            elif op_id in needed:
                op = self.dag.ops[op_id]
                t0 = time.perf_counter()
                if op.op_type == D.SOURCE:
                    if op_id not in self.sources:
                        raise KeyError(f"unbound source {op_id}")
                    table = self.sources[op_id]
                else:
                    ins = [results[l.src] for l in self.dag.in_links[op_id]]
                    stats.ops_lowered += self.plane.lowers(op, ins)
                    table = self.plane.execute_op(op, ins)
                elapsed = time.perf_counter() - t0
                stats.ops_executed += 1
                if materialize and digests[op_id] is not None:
                    wrote = store.put(digests[op_id], table, elapsed)
                    stats.store_writes += wrote
                    stats.store_dedup_skipped += not wrote
                results[op_id] = table
                for l in self.dag.in_links[op_id]:
                    src = l.src
                    refcount[src] -= 1
                    if refcount[src] == 0 and src not in pinned and src in results:
                        del results[src]
                        stats.freed_tables += 1
            else:
                continue
            stats.peak_live_tables = max(stats.peak_live_tables, len(results))

        stats.ops_skipped = (stats.ops_total - stats.ops_executed
                             - stats.ops_reused)
        stats.wall_time = time.perf_counter() - t_start
        return ExecResult(
            results={k: results[k] for k in keep_list},
            stats=stats,
            reused_ops=tuple(sorted(resolved)),
        )


def execute(
    dag: DataflowDAG,
    sources: Mapping[str, Table],
    *,
    plane: str = "torch",
    device: str = "cuda",
) -> Dict[str, Table]:
    """Execute and return ``{sink_id: result table}``.

    ``sources`` binds every Source operator id to an input table. Missing
    bindings raise — determinism demands fully-specified inputs.
    Intermediates are freed as their consumers drain (see ``ExecutionPlan``).
    It runs on the ``torch`` plane on ``"cuda"`` unless the caller asks for
    ``device="cpu"`` or ``plane="numpy"``.
    """
    return ExecutionPlan(dag, sources, plane=plane, device=device).run().results


def sink_results_equal(
    P: DataflowDAG,
    Q: DataflowDAG,
    sources: Mapping[str, Table],
    sink_map: Optional[Mapping[str, str]] = None,
    semantics: str = D.BAG,
    *,
    plane: str = "torch",
    device: str = "cuda",
) -> bool:
    """Ground truth for one source instance: execute both versions, compare
    corresponding sinks under the table semantics (Def 2.2).  Both run on
    ``plane`` and ``device`` as ``execute`` does, so without CUDA the
    default raises ``PlaneError``."""
    rp = execute(P, sources, plane=plane, device=device)
    rq = execute(Q, {k: v for k, v in sources.items() if k in Q.ops}, plane=plane, device=device)
    if sink_map is None:
        if set(rp) != set(rq):
            return False
        sink_map = {s: s for s in rp}
    for sp, sq in sink_map.items():
        sem = P.ops[sp].get("semantics", semantics) if P.ops[sp].op_type == D.SINK else semantics
        if not tables_equal(rp[sp], rq[sq], sem):
            return False
    return True
