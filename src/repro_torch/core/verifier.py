"""Veer: the verification algorithms (paper §4, §5, §7, §8).

``Veer`` is the baseline: Algorithm 1 (single edit) and Algorithm 2
(decomposition search).  ``make_veer_plus`` enables the §7 optimizations —
segmentation, pruning, ranking, fast inequivalence — mirroring the paper's
Veer⁺, plus the §8 extensions (multiple EVs, relaxed expansion for
non-monotonic EVs, greedy/backtracking verification).

Soundness: True only via Lemma 5.3 (every covering window of a decomposition
EV-verified equivalent) or Lemma 4.1; False only from (a) the §7.4 symbolic
witness or (b) an inequivalence-capable EV on a window spanning the entire
version pair (Theorem 5.8).

The decomposition search itself (Algorithm 2) runs on the **bitmask kernel**
by default: windows are interned integer ids into a
``repro_torch.core.window.WindowTable``, neighbor/subsumption/connectivity checks
are big-int instructions, and the explored/dead/verdict sets hash small
ints.  ``search_backend="reference"`` selects the retained frozenset
implementation (``repro_torch.core.search_ref``) — same canonical exploration
order, same verdicts, byte-identical certificates, an order of magnitude
slower.  See docs/PERFORMANCE.md.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from repro_torch.core import dag as D
from repro_torch.core.dag import DataflowDAG
from repro_torch.core.edits import EditMapping, enumerate_mappings, identity_mapping
from repro_torch.core.ev.base import BaseEV, QueryPair
from repro_torch.core.ev.cache import VerdictCache, wrap_evs
from repro_torch.core.ranking import decomposition_score_from_sizes, segment_score
from repro_torch.core.search_ref import (
    BaseSearchContext,
    SetSearchContext,
    ref_algorithm2,
)
from repro_torch.core.symbolic import quick_inequivalent
from repro_torch.core.window import Change, VersionPair, WindowTable

TRUE, FALSE, UNKNOWN = True, False, None

SEARCH_BACKENDS = ("bitmask", "reference")


@dataclass
class WindowEvidence:
    """How one window of the winning decomposition was decided.

    ``kind`` is ``"ev"`` (an EV call — possibly answered by the verdict
    cache or adopted from an isomorphic in-pair window; either way the named
    EV is the one whose verdict stands) or ``"identical"`` (the Lemma 5.3
    CASE1 structural shortcut — no EV involved).  ``query_pair`` /
    ``identity_payload`` carry everything a certificate needs to re-check
    the window without re-running the search.
    """

    units: Tuple[int, ...]
    kind: str                               # "ev" | "identical"
    verdict: Optional[bool]
    ev_name: Optional[str] = None
    fingerprint: Optional[str] = None
    query_pair: Optional[QueryPair] = None
    identity_payload: Optional[Dict[str, object]] = None


@dataclass
class VerificationEvidence:
    """Raw, non-serialized proof material backing a True/False verdict.

    ``kind``:
      * ``"exact"``          — no changes under the mapping (Alg 2 lines 1-2);
      * ``"decomposition"``  — every window of a covering decomposition
                               verified (Lemma 5.3 / Theorem 5.8 True side);
      * ``"witness"``        — an inequivalence-capable EV refuted a window
                               spanning the entire pair (Theorem 5.8 False);
      * ``"symbolic"``       — the §7.4 fast-inequivalence witness.

    ``repro_torch.api.certificate`` turns this into a serializable, replayable
    ``Certificate``; core keeps only live objects.
    """

    kind: str
    verdict: Optional[bool]
    semantics: str
    mapping: EditMapping
    windows: List[WindowEvidence] = field(default_factory=list)
    # the verified versions themselves — lets the certificate layer bind the
    # evidence to this specific pair (digest + window/coverage re-derivation)
    P: Optional[DataflowDAG] = None
    Q: Optional[DataflowDAG] = None
    n_units: int = 0
    # symbolic-witness payload (whole-pair inequivalence, §7.4)
    sink_pairs: Tuple[Tuple[str, str], ...] = ()


class _EvidenceCollector:
    """Per-mapping scratchpad the search paths tag as they conclude."""

    def __init__(self) -> None:
        self.kind: Optional[str] = None
        self.pair: Optional[VersionPair] = None
        self.ctx: Optional[BaseSearchContext] = None
        self.sink_pairs: Tuple[Tuple[str, str], ...] = ()


@dataclass
class VeerStats:
    decompositions_explored: int = 0
    # frontier pushes suppressed by the decomposition budget (the heap is
    # bounded so explored + frontier never exceeds max_decompositions)
    pushes_skipped: int = 0
    windows_formed: int = 0
    windows_verified: int = 0
    ev_calls: int = 0
    ev_time: float = 0.0
    explore_time: float = 0.0
    total_time: float = 0.0
    segments: int = 0
    mappings_tried: int = 0
    fast_inequivalence_hit: bool = False
    budget_exhausted: bool = False
    verdict: Optional[bool] = None
    # verdict-cache accounting (only moves when a VerdictCache is attached)
    cache_hits: int = 0          # EV checks answered from the verdict cache
    windows_deduped: int = 0     # windows resolved via in-pair fingerprint dedup
    ev_calls_saved: int = 0      # cache_hits + per-window savings from dedup
    ev_time_saved: float = 0.0   # sum of original check times of saved calls
    # how many decompositions Algorithm 2 popped before the first one whose
    # windows all verified (None when the search never certified — UNK/NEQ
    # pairs and the exact-match shortcut, which needs no search at all).
    # The guided-search headline metric: machine-independent, directly
    # comparable across frontier orderings.
    decompositions_to_first_certificate: Optional[int] = None
    # EV attempts per EV name across every checked window (cache-answered
    # attempts included) — shows where the attempt ordering spends its tries
    ev_attempts: Dict[str, int] = field(default_factory=dict)

    def note_first_certificate(self) -> None:
        """Record the decomposition count at the first verified covering
        decomposition (idempotent — later segments don't overwrite it)."""
        if self.decompositions_to_first_certificate is None:
            self.decompositions_to_first_certificate = self.decompositions_explored

    def as_dict(self) -> Dict[str, object]:
        return dict(self.__dict__)


class Veer:
    """Baseline verifier (Algorithms 1-3). Optimization flags off by default.

    ``max_workers > 1`` parallelizes the *batched window dispatch*: the
    windows of each candidate decomposition are checked concurrently on a
    thread pool, then their verdicts are committed in the deterministic
    planned order, so verdicts, provenance and certificates are identical to
    the sequential run regardless of thread completion order (see
    ``BaseSearchContext.prefetch``).  The search itself stays single-threaded —
    Algorithm 2's frontier is inherently sequential; the EV calls are the
    cost worth spreading.

    ``search_backend`` selects the decomposition-search representation:
    ``"bitmask"`` (default — interned integer windows, the fast kernel) or
    ``"reference"`` (the retained frozenset implementation).  Both produce
    identical verdicts, stats and certificates; the reference backend exists
    as the semantics oracle for tests and benchmarks.
    """

    def __init__(
        self,
        evs: Sequence[BaseEV],
        *,
        segmentation: bool = False,
        pruning: bool = False,
        ranking: bool = False,
        fast_inequivalence: bool = False,
        relaxed_expansion: bool = False,
        eager_verify: bool = False,
        try_all_mappings: bool = False,
        max_decompositions: int = 50_000,
        max_windows: int = 200_000,
        mapping_limit: int = 8,
        max_workers: int = 1,
        verdict_cache: Optional[VerdictCache] = None,
        search_backend: str = "bitmask",
        guidance=None,
        window_observer=None,
    ):
        if search_backend not in SEARCH_BACKENDS:
            raise ValueError(
                f"search_backend must be one of {SEARCH_BACKENDS}, "
                f"got {search_backend!r}"
            )
        self.search_backend = search_backend
        # learned search guidance (a SearchGuidance of the learn layer, or None):
        # reorders the best-first frontier and the per-window EV attempt
        # order; never decides a verdict — certificates still gate everything
        self.guidance = guidance
        # corpus-harvest hook: observer(ctx, win, WindowOutcome) per freshly
        # committed window verdict (the learn layer's trainer uses it to collect
        # negatives the certificate corpus never sees)
        self.window_observer = window_observer
        self.verdict_cache = verdict_cache
        self.evs = wrap_evs(evs, verdict_cache)
        self.segmentation = segmentation
        self.pruning = pruning
        self.ranking = ranking
        self.fast_inequivalence = fast_inequivalence
        self.relaxed_expansion = relaxed_expansion
        self.eager_verify = eager_verify
        self.try_all_mappings = try_all_mappings
        self.max_decompositions = max_decompositions
        self.max_windows = max_windows
        self.mapping_limit = mapping_limit
        self.max_workers = max_workers
        self._executor: Optional[ThreadPoolExecutor] = None
        self._executor_lock = threading.Lock()

    def attach_cache(self, cache: VerdictCache) -> "Veer":
        """Wire a (possibly shared) verdict cache into this verifier —
        idempotent; used by ``ReuseManager``/``VersionChainSession`` to share
        one cache across many ``verify`` calls and sessions."""
        self.verdict_cache = cache
        self.evs = wrap_evs(self.evs, cache)
        return self

    # -------------------------------------------------------------- worker pool
    def _pool(self) -> Optional[ThreadPoolExecutor]:
        """The lazily-created window-dispatch pool (None when sequential)."""
        if self.max_workers <= 1:
            return None
        if self._executor is None:
            with self._executor_lock:
                if self._executor is None:
                    self._executor = ThreadPoolExecutor(
                        max_workers=self.max_workers,
                        thread_name_prefix="veer-window",
                    )
        return self._executor

    def close(self) -> None:
        """Shut down the window-dispatch pool (idempotent; the verifier
        remains usable — the pool is recreated on the next parallel run)."""
        with self._executor_lock:
            if self._executor is not None:
                self._executor.shutdown(wait=True)
                self._executor = None

    def __enter__(self) -> "Veer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------ public
    def verify(
        self,
        P: DataflowDAG,
        Q: DataflowDAG,
        mapping: Optional[EditMapping] = None,
        semantics: str = D.BAG,
    ) -> Tuple[Optional[bool], VeerStats]:
        verdict, stats, _ = self._verify(P, Q, mapping, semantics, collect=False)
        return verdict, stats

    def verify_with_evidence(
        self,
        P: DataflowDAG,
        Q: DataflowDAG,
        mapping: Optional[EditMapping] = None,
        semantics: str = D.BAG,
    ) -> Tuple[Optional[bool], VeerStats, Optional[VerificationEvidence]]:
        """Like ``verify`` but additionally returns the proof material behind
        a True/False verdict (None for Unknown) — the chosen mapping, the
        covering decomposition, and per-window provenance.  This is the hook
        ``repro_torch.api`` builds replayable ``Certificate``s from."""
        return self._verify(P, Q, mapping, semantics, collect=True)

    def _verify(
        self,
        P: DataflowDAG,
        Q: DataflowDAG,
        mapping: Optional[EditMapping],
        semantics: str,
        collect: bool,
    ) -> Tuple[Optional[bool], VeerStats, Optional[VerificationEvidence]]:
        t0 = time.perf_counter()
        stats = VeerStats()
        mappings = (
            [mapping]
            if mapping is not None
            else (
                enumerate_mappings(P, Q, self.mapping_limit)
                if self.try_all_mappings
                else [identity_mapping(P, Q)]
            )
        )
        verdict: Optional[bool] = UNKNOWN
        evidence: Optional[VerificationEvidence] = None
        for m in mappings:
            stats.mappings_tried += 1
            try:
                pair = VersionPair(P, Q, m, semantics)
            except (D.DAGError, ValueError):
                continue
            coll = _EvidenceCollector()
            coll.pair = pair
            verdict = self._verify_pair(pair, stats, coll)
            if verdict is not UNKNOWN:
                if collect:
                    evidence = _assemble_evidence(verdict, coll)
                break
        stats.total_time = time.perf_counter() - t0
        stats.verdict = verdict
        return verdict, stats, evidence

    # ------------------------------------------------------------ per mapping
    def _verify_pair(
        self,
        pair: VersionPair,
        stats: VeerStats,
        coll: Optional[_EvidenceCollector] = None,
    ) -> Optional[bool]:
        coll = coll if coll is not None else _EvidenceCollector()
        coll.pair = pair
        if not pair.changes:
            coll.kind = "exact"
            return TRUE  # exact match (Alg 2 lines 1-2)

        sink_pairs = self._version_sink_pairs(pair)

        if self.fast_inequivalence and quick_inequivalent(
            pair.P, pair.Q, sink_pairs, pair.semantics
        ):
            stats.fast_inequivalence_hit = True
            coll.kind = "symbolic"
            coll.sink_pairs = tuple(sink_pairs)
            return FALSE

        ctx = self._make_context(pair, stats)
        coll.ctx = ctx

        if self.segmentation:
            segments = self._segment(pair, ctx)
            if segments is None:  # a change sits on an unsupported operator
                return UNKNOWN
            stats.segments = max(stats.segments, len(segments))
            order = sorted(
                segments,
                key=lambda s: segment_score(len(s[0]), len(s[1])),
            )
            whole = len(order) == 1 and len(order[0][0]) == len(pair.units)
            for universe, changes in order:
                r = self._algorithm2(ctx, frozenset(universe), changes)
                if r is TRUE:
                    continue  # Alg 3: next segment
                if r is FALSE and whole:
                    coll.kind = "witness"
                    return FALSE
                return UNKNOWN  # early termination (Alg 3 line 5)
            coll.kind = "decomposition"
            return TRUE

        universe = frozenset(range(len(pair.units)))
        r = self._algorithm2(ctx, universe, pair.changes)
        if r is TRUE:
            coll.kind = "decomposition"
        elif r is FALSE:
            coll.kind = "witness"
        return r

    def _version_sink_pairs(self, pair: VersionPair) -> List[Tuple[str, str]]:
        fwd = pair.mapping.forward
        out = []
        for sp in pair.P.sinks:
            sq = fwd.get(sp)
            if sq is not None and sq in pair.Q.ops and not pair.Q.out_links[sq]:
                out.append((sp, sq))
        return out

    # ------------------------------------------------------------ segmentation
    def _segment(
        self, pair: VersionPair, ctx: BaseSearchContext
    ) -> Optional[List[Tuple[Set[int], List[Change]]]]:
        """§7.1 method 2: boundaries at operators no EV supports."""
        supported = set()
        for ev in self.evs:
            supported |= set(ev.supported_op_types)

        def unit_supported(i: int) -> bool:
            u = pair.units[i]
            if u.p is not None and pair.P.ops[u.p].op_type not in supported:
                return False
            if u.q is not None and pair.Q.ops[u.q].op_type not in supported:
                return False
            return True

        boundary = {i for i in range(len(pair.units)) if not unit_supported(i)}
        for c in pair.changes:
            if c.required_units & boundary:
                return None  # the change itself is unverifiable — quick Unknown
        # connected components of the unit graph minus boundary units
        remaining = set(range(len(pair.units))) - boundary
        comps: List[Set[int]] = []
        seen: Set[int] = set()
        for start in sorted(remaining):
            if start in seen:
                continue
            comp = set()
            stack = [start]
            while stack:
                n = stack.pop()
                if n in comp:
                    continue
                comp.add(n)
                stack.extend((pair.adj[n] & remaining) - comp)
            seen |= comp
            comps.append(comp)
        segments = []
        for comp in comps:
            changes = [c for c in pair.changes if c.required_units <= comp]
            if changes:
                segments.append((comp, changes))
        # sanity: every change assigned to exactly one segment
        assigned = sum(len(cs) for _, cs in segments)
        if assigned != len(pair.changes):
            return None
        return segments

    # ------------------------------------------------------------- Algorithm 2
    def _make_context(self, pair: VersionPair, stats: VeerStats) -> BaseSearchContext:
        cls = (
            SetSearchContext
            if self.search_backend == "reference"
            else _SearchContext
        )
        return cls(
            pair,
            self.evs,
            stats,
            self.verdict_cache,
            guidance=self.guidance,
            observer=self.window_observer,
        )

    def _algorithm2(
        self,
        ctx: BaseSearchContext,
        universe: FrozenSet[int],
        changes: List[Change],
    ) -> Optional[bool]:
        if isinstance(ctx, SetSearchContext):
            return ref_algorithm2(self, ctx, universe, changes)
        return self._algorithm2_masks(ctx, universe, changes)

    def _algorithm2_masks(
        self,
        ctx: "_SearchContext",
        universe: FrozenSet[int],
        changes: List[Change],
    ) -> Optional[bool]:
        """Algorithm 2 on the bitmask kernel: windows are interned table ids,
        decompositions are tuples of ids in canonical order, and the
        inner-loop set algebra (neighbors, merge, subsumption, explored-set
        keys) is big-int arithmetic.  Exploration order is bit-for-bit the
        reference backend's (``repro_torch.core.search_ref.ref_algorithm2``)."""
        stats = ctx.stats
        pair = ctx.pair
        table = ctx.table
        intern = table.intern
        masks = table.masks
        keys = table.key
        pops = table.pop
        universe_mask = pair.mask_of(universe)
        universe_size = len(universe)
        max_decomps = self.max_decompositions
        use_ranking = self.ranking

        # anchor masks come from the precomputed per-change masks (``changes``
        # may be a segment's subset of ``pair.changes``, so map by change)
        mask_by_change = dict(zip(pair.changes, pair.change_masks))
        initial = tuple(sorted(
            {intern(m) for m in {mask_by_change[c] for c in changes}},
            key=keys.__getitem__,
        ))
        explored: Set[Tuple[int, ...]] = {initial}
        entire_id = (
            intern(universe_mask) if universe_mask == pair.full_mask else None
        )

        counter = itertools.count()
        guidance = self.guidance
        # heap entries: (score, tiebreak counter, ids); guided searches use
        # a (learned, heuristic) score pair so the unguided ranking breaks
        # ties — identical learned scores fall back to exactly the unguided
        # exploration preference
        heap: List[Tuple[object, int, Tuple[int, ...]]] = []

        def push(ids: Tuple[int, ...]):
            # frontier bound: never let explored + frontier exceed the budget.
            # Under ranking this is lossy at the budget edge — a suppressed
            # candidate might have outscored entries already in the heap — so
            # a drained search with skipped pushes reports budget_exhausted
            # (Unknown-is-budget-limited, never a wrong verdict).
            if stats.decompositions_explored + len(heap) >= max_decomps:
                stats.pushes_skipped += 1
                return
            score = (
                -decomposition_score_from_sizes(
                    [pops[i] for i in ids], universe_size
                )
                if use_ranking
                else 0.0
            )
            if guidance is not None:
                score = (-guidance.decomposition_score(ctx, ids), score)
            heapq.heappush(heap, (score, next(counter), ids))

        push(initial)
        t_explore = time.perf_counter()

        while heap:
            if stats.decompositions_explored >= max_decomps:
                stats.budget_exhausted = True
                break
            _, _, windows = heapq.heappop(heap)
            stats.decompositions_explored += 1

            # §7.2: decompositions containing a known-not-equivalent maximal
            # window can never verify — skip their (EV-expensive) verification
            # but keep EXPANDING them: other windows may merge the dead one
            # away into a larger window that does verify.
            dead = ctx.dead
            doomed = self.pruning and any(w in dead for w in windows)

            if self.eager_verify and not doomed:
                r = self._try_verify_decomposition(ctx, windows, entire_id)
                if r is not UNKNOWN:
                    if r is TRUE:
                        stats.note_first_certificate()
                    stats.explore_time += time.perf_counter() - t_explore
                    return r

            owner: Dict[int, int] = {}
            for wid in windows:
                for u in keys[wid]:
                    owner[u] = wid

            all_marked = True
            for wid in windows:
                w_mask = masks[wid]
                frontier = table.neighbor_mask(wid) & universe_mask
                cand_masks: Set[int] = set()
                f = frontier
                while f:
                    low = f & -f
                    f ^= low
                    target = owner.get(low.bit_length() - 1)
                    cand_masks.add(
                        w_mask | (masks[target] if target is not None else low)
                    )
                expanded_any = False
                for mid in sorted(map(intern, cand_masks), key=keys.__getitem__):
                    if not self._accept_window_id(ctx, mid):
                        continue
                    merged_mask = masks[mid]
                    new_windows = tuple(sorted(
                        [x for x in windows if masks[x] & ~merged_mask] + [mid],
                        key=keys.__getitem__,
                    ))
                    if new_windows in explored:
                        expanded_any = True  # an accepted move exists
                        continue
                    explored.add(new_windows)
                    push(new_windows)
                    expanded_any = True
                if not expanded_any:
                    # window is maximal in this decomposition (Alg 2 line 14);
                    # §7.2: verify immediately, remember refuted VALID windows
                    if (
                        self.pruning
                        and wid not in dead
                        and ctx.valid_evs(wid)
                        and ctx.window_verdict(wid) is not TRUE
                    ):
                        dead.add(wid)
                        doomed = True
                else:
                    all_marked = False

            if all_marked and not doomed:
                r = self._try_verify_decomposition(ctx, windows, entire_id)
                if r is not UNKNOWN:
                    if r is TRUE:
                        stats.note_first_certificate()
                    stats.explore_time += time.perf_counter() - t_explore
                    return r
            if all_marked and doomed and len(windows) == 1 and windows[0] == entire_id:
                # Alg 2 line 19: whole-pair window refuted by a capable EV
                if ctx.window_verdict(windows[0]) is FALSE:
                    ctx.witness = windows[0]
                    stats.explore_time += time.perf_counter() - t_explore
                    return FALSE

        if stats.pushes_skipped:
            # the frontier bound suppressed work: the Unknown is budget-limited
            stats.budget_exhausted = True
        stats.explore_time += time.perf_counter() - t_explore
        return UNKNOWN

    def _accept_window_id(self, ctx: "_SearchContext", wid: int) -> bool:
        """Alg 2 line 9 policy on an interned window id (all checks cached
        per id in the ``WindowTable`` — repeat encounters cost two list
        reads)."""
        table = ctx.table
        if not table.connected(wid):
            return False
        if table.query_pair(wid) is None:
            return True  # ill-formed: must keep growing
        if ctx.valid_evs(wid):
            return True
        return self.relaxed_expansion

    def _accept_window(self, ctx: SetSearchContext, win: FrozenSet[int]) -> bool:
        """Alg 2 line 9 policy. Ill-formed windows are always expandable
        (their boundary is incoherent — no EV could ever see them); formed
        windows must be valid for some EV, unless ``relaxed_expansion``
        (§5.5(1): recovers completeness for non-monotonic EVs like Equitas,
        at the cost of a larger search space — paper Example 1)."""
        if not ctx.pair.connected(win):
            return False
        qp = ctx.query_pair(win)
        if qp is None:
            return True  # ill-formed: must keep growing
        if ctx.valid_evs(win):
            return True
        return self.relaxed_expansion

    def _try_verify_decomposition(
        self,
        ctx: BaseSearchContext,
        windows: Tuple,
        entire_pair,
    ) -> Optional[bool]:
        """Batched dispatch: resolve every window that needs no EV call first
        (memoized verdicts, then verdict-cache-covered windows), so a cached
        non-True verdict short-circuits before any EV runs; the remaining
        windows are deduplicated by canonical fingerprint so isomorphic
        windows inside one decomposition cost a single EV call.

        With ``max_workers > 1`` the planned windows are checked concurrently
        and committed in planned order (``prefetch``) before the sequential
        adoption loop below runs — the loop then only reads memoized
        verdicts, so its control flow (short-circuit on the first non-True
        window, witness detection) is byte-for-byte the sequential one."""
        order, adopt = ctx.batch_plan(windows)
        pool = self._pool()
        if pool is not None:
            ctx.prefetch(order, pool)
        resolved = 0
        for w in order:
            v = ctx.window_verdict(w)
            resolved += 1
            for w2 in adopt.get(w, ()):
                ctx.adopt_verdict(w2, v, rep=w)
                resolved += 1
            if v is not TRUE:
                if (
                    len(windows) == 1
                    and entire_pair is not None
                    and windows[0] == entire_pair
                    and v is FALSE
                ):
                    ctx.witness = windows[0]
                    return FALSE  # inequivalence-capable EV refuted the pair
                return UNKNOWN
        if resolved == len(windows):
            ctx.proof.extend(windows)
            return TRUE
        return UNKNOWN

    # ------------------------------------------------------------- Algorithm 1
    def verify_single_edit(
        self,
        P: DataflowDAG,
        Q: DataflowDAG,
        mapping: Optional[EditMapping] = None,
        semantics: str = D.BAG,
    ) -> Tuple[Optional[bool], VeerStats]:
        """Paper Algorithm 1 — kept explicit for fidelity; also used to
        compute MCWs (maximal covering windows) for §7.1 method 1."""
        t0 = time.perf_counter()
        stats = VeerStats()
        m = mapping or identity_mapping(P, Q)
        pair = VersionPair(P, Q, m, semantics)
        stats.mappings_tried = 1
        if not pair.changes:
            stats.total_time = time.perf_counter() - t0
            stats.verdict = TRUE
            return TRUE, stats
        if len(pair.changes) != 1:
            raise ValueError("Algorithm 1 requires a single change")
        ctx = SetSearchContext(pair, self.evs, stats, self.verdict_cache)
        verdict, _ = self._algorithm1(ctx, pair.changes[0])
        stats.total_time = time.perf_counter() - t0
        stats.verdict = verdict
        return verdict, stats

    def _algorithm1(
        self, ctx: SetSearchContext, change: Change
    ) -> Tuple[Optional[bool], List[FrozenSet[int]]]:
        pair = ctx.pair
        universe = frozenset(range(len(pair.units)))
        start = change.required_units
        explored: Set[FrozenSet[int]] = {start}
        queue: List[FrozenSet[int]] = [start]
        mcws: List[FrozenSet[int]] = []
        verdict: Optional[bool] = UNKNOWN
        while queue:
            if ctx.stats.windows_formed >= self.max_windows:
                ctx.stats.budget_exhausted = True
                break
            w = queue.pop(0)
            ctx.stats.windows_formed += 1
            expanded_any = False
            for u in pair.neighbors(w) & universe:
                w2 = w | {u}
                if w2 in explored:
                    expanded_any = True
                    continue
                if not self._accept_window(ctx, w2):
                    continue
                explored.add(w2)
                queue.append(w2)
                expanded_any = True
            if not expanded_any:
                mcws.append(w)
                v = ctx.window_verdict(w)
                if v is TRUE:
                    ctx.proof.append(w)
                    return TRUE, mcws
                if v is FALSE and w == universe:
                    ctx.witness = w
                    return FALSE, mcws
        return verdict, mcws

    def maximal_covering_windows(
        self,
        P: DataflowDAG,
        Q: DataflowDAG,
        mapping: Optional[EditMapping] = None,
        semantics: str = D.BAG,
    ) -> List[FrozenSet[int]]:
        """All MCWs of a single change (used by segmentation method 1)."""
        m = mapping or identity_mapping(P, Q)
        pair = VersionPair(P, Q, m, semantics)
        if len(pair.changes) != 1:
            raise ValueError("single change required")
        ctx = SetSearchContext(pair, self.evs, VeerStats(), self.verdict_cache)
        _, mcws = self._algorithm1(ctx, pair.changes[0])
        return mcws


class _SearchContext(BaseSearchContext):
    """The bitmask-kernel search context: window handles are dense small-int
    ids interned through a per-search ``WindowTable``, which pins every
    derived fact (mask, canonical unit tuple, neighbor mask, connectivity,
    query pair, fingerprint, EV validity) to the id so the search never
    recomputes them.  All verdict/provenance/batched-dispatch machinery is
    inherited from ``BaseSearchContext`` — it is handle-agnostic, which is
    what keeps this backend and the reference backend bit-comparable.
    """

    def __init__(
        self,
        pair: VersionPair,
        evs: Sequence[BaseEV],
        stats: VeerStats,
        cache: Optional[VerdictCache] = None,
        guidance=None,
        observer=None,
    ):
        super().__init__(pair, evs, stats, cache, guidance, observer)
        self.table = WindowTable(pair)

    def query_pair(self, wid: int) -> Optional[QueryPair]:
        return self.table.query_pair(wid)

    def fingerprint(self, wid: int) -> Optional[str]:
        return self.table.fingerprint(wid)

    def valid_evs(self, wid: int) -> Tuple[int, ...]:
        out = self.table.valid[wid]
        if out is None:
            out = self._compute_valid(wid)
            self.table.valid[wid] = out
        return out

    def _compute_valid(self, wid: int) -> Tuple[int, ...]:
        """EV validity with cross-version memoization: restriction checks
        (notably Equitas' normalize-based ones) dominate cache-warm searches,
        and ``validate`` is as deterministic and id-invariant as ``check`` —
        so the kernel keys it by the window's canonical fingerprint in the
        shared ``VerdictCache``.  Falls back to the plain computation when no
        cache is attached.  (The reference backend keeps validating afresh:
        it is the pre-kernel baseline.)"""
        cache = self.cache
        if cache is None:
            return super()._compute_valid(wid)
        qp = self.query_pair(wid)
        if qp is None:
            return ()
        fp = self.fingerprint(wid)
        out = []
        for i, ev in enumerate(self.evs):
            if qp.semantics not in ev.semantics:
                continue
            ok = cache.get_validity(ev.name, fp)
            if ok is None:
                ok = bool(ev.validate(qp))
                cache.put_validity(ev.name, fp, ok)
            if ok:
                out.append(i)
        return tuple(out)

    def units_tuple(self, wid: int) -> Tuple[int, ...]:
        return self.table.key[wid]

    def win_frozenset(self, wid: int) -> FrozenSet[int]:
        return self.table.frozen(wid)


def _identity_payload(
    pair: VersionPair, win: Optional[FrozenSet[int]]
) -> Dict[str, object]:
    """Everything ``identical_under_mapping`` needs, as plain structures —
    ``win=None`` means the whole pair (the exact-match certificate)."""
    fwd = pair.mapping.forward
    if win is None:
        p_ops = set(pair.P.ops)
        q_ops = set(pair.Q.ops)
    else:
        p_ops = pair.p_ops(win)
        q_ops = pair.q_ops(win)
    p_links = [
        (l.src, l.dst, l.dst_port) for l in pair.P.links if l.dst in p_ops
    ]
    q_links = [
        (l.src, l.dst, l.dst_port) for l in pair.Q.links if l.dst in q_ops
    ]
    needed = p_ops | {s for s, _, _ in p_links}
    return {
        "p_ops": {p: pair.P.ops[p] for p in p_ops},
        "q_ops": {q: pair.Q.ops[q] for q in q_ops},
        "p_links": p_links,
        "q_links": q_links,
        "forward": {p: fwd[p] for p in needed if p in fwd},
    }


def _window_evidence(ctx: BaseSearchContext, win) -> WindowEvidence:
    """``win`` is a backend window handle (table id or frozenset); the
    emitted evidence is representation-free and byte-identical either way."""
    kind, ev_name = ctx.provenance.get(win, ("identical", None))
    verdict = ctx._verdict.get(win)
    if kind == "identical":
        return WindowEvidence(
            units=ctx.units_tuple(win),
            kind="identical",
            verdict=verdict,
            identity_payload=_identity_payload(ctx.pair, ctx.win_frozenset(win)),
        )
    return WindowEvidence(
        units=ctx.units_tuple(win),
        kind="ev",
        verdict=verdict,
        ev_name=ev_name,
        fingerprint=ctx.fingerprint(win),
        query_pair=ctx.query_pair(win),
    )


def _assemble_evidence(
    verdict: Optional[bool], coll: _EvidenceCollector
) -> Optional[VerificationEvidence]:
    """Turn the search's scratchpad into a ``VerificationEvidence`` (only
    called once a mapping produced a True/False verdict)."""
    pair = coll.pair
    if pair is None or coll.kind is None:
        return None
    ev = VerificationEvidence(
        kind=coll.kind,
        verdict=verdict,
        semantics=pair.semantics,
        mapping=pair.mapping,
        P=pair.P,
        Q=pair.Q,
        n_units=len(pair.units),
    )
    if coll.kind == "exact":
        ev.windows.append(
            WindowEvidence(
                units=(),
                kind="identical",
                verdict=TRUE,
                identity_payload=_identity_payload(pair, None),
            )
        )
    elif coll.kind == "symbolic":
        ev.sink_pairs = coll.sink_pairs
    elif coll.kind == "decomposition" and coll.ctx is not None:
        seen: Set[object] = set()
        for win in coll.ctx.proof:
            if win in seen:
                continue
            seen.add(win)
            ev.windows.append(_window_evidence(coll.ctx, win))
    elif coll.kind == "witness" and coll.ctx is not None:
        if coll.ctx.witness is not None:
            ev.windows.append(_window_evidence(coll.ctx, coll.ctx.witness))
    return ev


def make_veer_plus(evs: Sequence[BaseEV], **kw) -> Veer:
    """Veer⁺: all §7 optimizations + §8 greedy window verification.

    ``eager_verify`` is the §8 fix for incomplete EVs: a window already
    verified equivalent must not be lost when the maximality-driven search
    expands it into a window the EV cannot decide (Example 2 — triggered in
    practice by the multi-EV setup, where JaxprEV validates Sort-containing
    supersets it then cannot prove).  Verdicts are memoized per window, so
    the overhead is one EV call per distinct valid window."""
    defaults = dict(
        segmentation=True,
        pruning=True,
        ranking=True,
        fast_inequivalence=True,
        eager_verify=True,
        try_all_mappings=True,  # §5.5(2): identity mapping first, then swaps
    )
    defaults.update(kw)
    return Veer(evs, **defaults)
