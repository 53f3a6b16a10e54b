"""Shared search-context machinery + the retained set-based search backend.

The decomposition search (Algorithm 2) exists twice:

  * the **bitmask kernel** in ``repro_torch.core.verifier`` — windows are interned
    integer ids into a ``repro_torch.core.window.WindowTable``; the production
    path (``search_backend="bitmask"``, the default);
  * the **reference backend** here — windows are ``FrozenSet[int]``, the
    pre-kernel representation, retained verbatim (``search_backend=
    "reference"``).

Both backends explore the *same canonical sequence of decompositions*:
windows inside a decomposition are ordered lexicographically by their sorted
unit tuples, and expansion candidates are visited in that same order.  That
makes the two backends bit-comparable — identical verdicts, identical
``VeerStats.decompositions_explored``, byte-identical certificates — which
``tests/test_search_kernel.py`` asserts property-style and
``benchmarks/search_bench.py`` uses to measure the kernel's speedup against
its own semantics-preserving baseline.

``BaseSearchContext`` holds everything representation-independent: verdict
memoization, provenance, the batched cache-aware dispatch plan, parallel
prefetch, and the Lemma 5.3 CASE1 structural shortcut.  Subclasses supply
only the window-handle operations (query pair, fingerprint, EV validity,
unit tuple) over their handle type — frozensets here, table ids in the
verifier.
"""

from __future__ import annotations

import heapq
import itertools
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from repro_torch.core.ev.base import BaseEV, QueryPair
from repro_torch.core.ev.cache import CachedEV, VerdictCache
from repro_torch.core.ranking import decomposition_score
from repro_torch.core.window import Change, VersionPair, identical_under_mapping

TRUE, FALSE, UNKNOWN = True, False, None


@dataclass
class WindowOutcome:
    """The result of checking one window, decoupled from shared state.

    ``BaseSearchContext._compute_outcome`` produces these without touching
    the context's memo/provenance/stats (so it can run on worker threads);
    ``_commit_outcome`` applies them on the search thread in deterministic
    planned order.  The stat deltas ride along so parallel runs account EV
    calls exactly where the commit happens, not where the thread ran.
    ``attempts`` lists the EVs consulted in order (cache answers included) —
    it feeds ``VeerStats.ev_attempts`` and the corpus harvest observer.
    """

    verdict: Optional[bool]
    provenance: Optional[Tuple[str, Optional[str]]]
    ev_calls: int = 0
    ev_time: float = 0.0
    cache_hits: int = 0
    calls_saved: int = 0
    time_saved: float = 0.0
    attempts: Tuple[str, ...] = ()


class BaseSearchContext:
    """Per-(pair, EV-set) caches: validity, verdicts, dead set, provenance.

    Window *handles* are opaque to this class — any hashable value works as
    long as the subclass implements the representation hooks below.  When a
    cross-version ``VerdictCache`` is attached, the context also plans
    *batched* window verification: cache-covered windows run first (they cost
    no EV call, and a cached non-True verdict aborts the decomposition before
    any EV fires) and in-pair isomorphic windows collapse onto a single
    representative whose verdict the others adopt.
    """

    def __init__(
        self,
        pair: VersionPair,
        evs: Sequence[BaseEV],
        stats,
        cache: Optional[VerdictCache] = None,
        guidance=None,
        observer=None,
    ):
        self.pair = pair
        self.evs = evs
        self.stats = stats
        self.cache = cache
        # learned search guidance (a SearchGuidance of the learn layer, or None) and
        # its per-handle score/feature memo — guidance only *schedules* work
        # (frontier order, EV attempt order); verdicts still come from EVs
        self.guidance = guidance
        self.guidance_cache: Dict[object, Tuple] = {}
        # corpus-harvest hook: called once per freshly committed window as
        # observer(ctx, win, WindowOutcome), for the learn layer's trainer
        self.observer = observer
        self._verdict: Dict[object, Optional[bool]] = {}
        self.dead: Set[object] = set()
        # evidence trail: which window was decided how ("identical" or the
        # deciding EV's name), the windows of the accepted decomposition(s),
        # and the refuting whole-pair window if the verdict is False
        self.provenance: Dict[object, Tuple[str, Optional[str]]] = {}
        self.proof: List[object] = []
        self.witness: Optional[object] = None

    # -- representation hooks (subclass responsibility) -----------------------
    def query_pair(self, win) -> Optional[QueryPair]:
        raise NotImplementedError

    def fingerprint(self, win) -> Optional[str]:
        raise NotImplementedError

    def valid_evs(self, win) -> Tuple[int, ...]:
        raise NotImplementedError

    def units_tuple(self, win) -> Tuple[int, ...]:
        """Ascending unit indices — the certificate's ``units`` field."""
        raise NotImplementedError

    def win_frozenset(self, win) -> FrozenSet[int]:
        """The handle back at the frozenset API boundary."""
        raise NotImplementedError

    # -- shared machinery ------------------------------------------------------
    def _compute_valid(self, win) -> Tuple[int, ...]:
        qp = self.query_pair(win)
        if qp is None:
            return ()
        return tuple(
            i
            for i, ev in enumerate(self.evs)
            if qp.semantics in ev.semantics and ev.validate(qp)
        )

    def batch_plan(
        self, windows: Tuple
    ) -> Tuple[List, Dict]:
        """Partition a decomposition's windows into a verification order and
        an adoption map (representative -> isomorphic windows it answers
        for).  Without a verdict cache this degrades to the plain order."""
        if self.cache is None or len(windows) == 1:
            return list(windows), {}
        for w in windows:
            # a memoized non-True verdict dooms the decomposition: surface
            # it alone, before spending fingerprint/validate work on peers
            if w in self._verdict and self._verdict[w] is not TRUE:
                return [w], {}
        memoized: List = []
        covered: List = []
        fresh: List = []
        plain: List = []
        adopt: Dict = {}
        rep_by_fp: Dict[str, object] = {}
        for w in windows:
            if w in self._verdict:
                memoized.append(w)
                continue
            fp = self.fingerprint(w)
            if fp is None:
                plain.append(w)  # ill-formed: window_verdict resolves cheaply
                continue
            rep = rep_by_fp.get(fp)
            if rep is not None:
                adopt.setdefault(rep, []).append(w)
                continue
            rep_by_fp[fp] = w
            names = [self.evs[i].name for i in self.valid_evs(w)]
            if names and self.cache.covers(names, fp):
                covered.append(w)
            else:
                fresh.append(w)
        return memoized + covered + fresh + plain, adopt

    def adopt_verdict(
        self, win, v: Optional[bool], rep=None
    ) -> None:
        """Record a verdict obtained from an isomorphic window — sound
        because fingerprint equality implies the EVs would answer the same.
        Provenance is inherited from the representative: the named EV's
        verdict stands for this window too (same fingerprint)."""
        if win in self._verdict:
            return
        self._verdict[win] = v
        if rep is not None and rep in self.provenance:
            self.provenance[win] = self.provenance[rep]
        self.stats.windows_verified += 1
        self.stats.windows_deduped += 1
        self.stats.ev_calls_saved += 1

    def window_verdict(self, win) -> Optional[bool]:
        """True if some valid EV proves equivalence; False if some valid
        inequivalence-capable EV refutes; else Unknown. Identical sub-DAGs
        shortcut to True (non-covering windows, Lemma 5.3 CASE1)."""
        if win in self._verdict:
            return self._verdict[win]
        return self._commit_outcome(win, self._compute_outcome(win))

    def ev_order(self, win) -> Tuple[int, ...]:
        """The order EVs are attempted for this window.  Unguided: the
        registry's canonical valid-EV order.  Guided: the learned per-EV
        scores reorder the *same set* — which EV answers first can change,
        never whether an answer counts (each EV's verdict is its own)."""
        valid = self.valid_evs(win)
        if self.guidance is None or len(valid) < 2:
            return valid
        return self.guidance.ev_order(self, win, valid)

    def _compute_outcome(self, win) -> WindowOutcome:
        """Check one window without mutating verdict/provenance/stats state.

        Safe to run on a worker thread: the only shared structures it
        touches are the validity/query-pair memos (distinct windows write
        distinct keys; a duplicated computation produces an identical
        value) and the verdict cache / ``CachedEV`` counters, which carry
        their own locks.
        """
        if self._identical(win):
            return WindowOutcome(TRUE, ("identical", None))
        out = WindowOutcome(UNKNOWN, None)
        qp = self.query_pair(win)
        if qp is None:
            return out
        for i in self.ev_order(win):
            ev = self.evs[i]
            out.attempts += (ev.name,)
            if isinstance(ev, CachedEV):
                r, hit, dt, saved = ev.check_recorded(qp)
                if hit:
                    # answered from the verdict cache: not an EV call
                    out.cache_hits += 1
                    out.calls_saved += 1
                    out.time_saved += saved
                else:
                    out.ev_calls += 1
                    out.ev_time += dt
            else:
                t0 = time.perf_counter()
                r = ev.check(qp)
                out.ev_calls += 1
                out.ev_time += time.perf_counter() - t0
            if r is True:
                out.verdict = TRUE
                out.provenance = ("ev", ev.name)
                break
            if r is False and ev.can_prove_inequivalence:
                # a capable EV's refutation is a proof (Thm 5.8):
                # stop — running more EVs wastes calls, and a buggy
                # later True must not overwrite a sound False
                out.verdict = FALSE
                out.provenance = ("ev", ev.name)
                break
        return out

    def _commit_outcome(self, win, out: WindowOutcome) -> Optional[bool]:
        """Apply a computed outcome on the search thread (idempotent)."""
        if win in self._verdict:
            return self._verdict[win]
        if out.provenance is not None:
            self.provenance[win] = out.provenance
        s = self.stats
        s.ev_calls += out.ev_calls
        s.ev_time += out.ev_time
        s.cache_hits += out.cache_hits
        s.ev_calls_saved += out.calls_saved
        s.ev_time_saved += out.time_saved
        s.windows_verified += 1
        for name in out.attempts:
            s.ev_attempts[name] = s.ev_attempts.get(name, 0) + 1
        self._verdict[win] = out.verdict
        if self.observer is not None:
            self.observer(self, win, out)
        return out.verdict

    def prefetch(self, order: List, pool: ThreadPoolExecutor) -> None:
        """Check a planned batch of windows concurrently; commit in order.

        Every window of the batch is computed (no speculative cancellation —
        the work set is fixed by the plan, never by thread timing) and the
        outcomes are committed in the planned order, so memoized verdicts,
        provenance and stats are reproducible run-to-run.  Windows the
        sequential adoption loop then skips via its short-circuit were
        *speculatively* checked; their verdicts stay memoized (and their EV
        calls accounted), which is the latency-for-work trade parallel
        dispatch makes.
        """
        targets = [w for w in order if w not in self._verdict]
        if len(targets) < 2:
            return  # nothing to overlap
        futures = [(w, pool.submit(self._compute_outcome, w)) for w in targets]
        for w, fut in futures:
            self._commit_outcome(w, fut.result())

    def _identical(self, win) -> bool:
        """Both sub-DAGs structurally identical under the mapping."""
        pair = self.pair
        fs = self.win_frozenset(win)
        p_ops = pair.p_ops(fs)
        q_ops = pair.q_ops(fs)
        if len(p_ops) != len(fs) or len(q_ops) != len(fs):
            return False  # contains an inserted/deleted op
        return identical_under_mapping(
            {p: pair.P.ops[p] for p in p_ops},
            {q: pair.Q.ops[q] for q in q_ops},
            [(l.src, l.dst, l.dst_port) for l in pair.P.links if l.dst in p_ops],
            [(l.src, l.dst, l.dst_port) for l in pair.Q.links if l.dst in q_ops],
            pair.mapping.forward,
        )


class SetSearchContext(BaseSearchContext):
    """The retained frozenset-handle context (reference backend; also the
    substrate of Algorithm 1, which is kept explicit for paper fidelity
    rather than speed).  Query pairs and fingerprints go through the
    ``VersionPair``-level memos, exactly as before the bitmask kernel."""

    def __init__(self, pair, evs, stats, cache=None, guidance=None, observer=None):
        super().__init__(pair, evs, stats, cache, guidance, observer)
        self._valid: Dict[FrozenSet[int], Tuple[int, ...]] = {}

    def query_pair(self, win: FrozenSet[int]) -> Optional[QueryPair]:
        return self.pair.to_query_pair(win)

    def fingerprint(self, win: FrozenSet[int]) -> Optional[str]:
        return self.pair.window_fingerprint(win)

    def valid_evs(self, win: FrozenSet[int]) -> Tuple[int, ...]:
        if win in self._valid:
            return self._valid[win]
        out = self._compute_valid(win)
        self._valid[win] = out
        return out

    def units_tuple(self, win: FrozenSet[int]) -> Tuple[int, ...]:
        return tuple(sorted(win))

    def win_frozenset(self, win: FrozenSet[int]) -> FrozenSet[int]:
        return win


def _decomp_key(windows: Tuple[FrozenSet[int], ...]) -> Tuple:
    return tuple(tuple(sorted(w)) for w in windows)


def ref_algorithm2(
    veer,
    ctx: SetSearchContext,
    universe: FrozenSet[int],
    changes: List[Change],
) -> Optional[bool]:
    """Algorithm 2 on frozenset windows — the pre-kernel hot path, retained
    as the semantics oracle for the bitmask kernel.

    Candidate expansions are visited in canonical (sorted-unit-tuple) order
    so exploration is representation-independent; the frontier push is
    bounded by the decomposition budget (``VeerStats.pushes_skipped`` counts
    suppressed pushes) exactly like the kernel's.
    """
    stats = ctx.stats
    initial = tuple(sorted({c.required_units for c in changes}, key=sorted))
    start = _decomp_key(initial)
    explored: Set[Tuple] = {start}
    entire_pair = universe if len(universe) == len(ctx.pair.units) else None

    counter = itertools.count()
    guidance = veer.guidance
    # heap entries: (score, tiebreak counter, windows); guided searches use
    # a (learned, heuristic) score pair so the unguided ranking breaks ties
    heap: List[Tuple[object, int, Tuple[FrozenSet[int], ...]]] = []

    def push(windows: Tuple[FrozenSet[int], ...]):
        # frontier bound: never let explored + frontier exceed the budget.
        # Under ranking this is lossy at the budget edge — a suppressed
        # candidate might have outscored entries already in the heap — so
        # a drained search with skipped pushes reports budget_exhausted
        # (Unknown-is-budget-limited, never a wrong verdict).
        if stats.decompositions_explored + len(heap) >= veer.max_decompositions:
            stats.pushes_skipped += 1
            return
        score = (
            -decomposition_score(windows, len(universe)) if veer.ranking else 0.0
        )
        if guidance is not None:
            score = (-guidance.decomposition_score(ctx, windows), score)
        heapq.heappush(heap, (score, next(counter), windows))

    push(initial)
    t_explore = time.perf_counter()

    while heap:
        if stats.decompositions_explored >= veer.max_decompositions:
            stats.budget_exhausted = True
            break
        _, _, windows = heapq.heappop(heap)
        stats.decompositions_explored += 1

        # §7.2: decompositions containing a known-not-equivalent maximal
        # window can never verify — skip their (EV-expensive) verification
        # but keep EXPANDING them: other windows may merge the dead one
        # away into a larger window that does verify.
        doomed = veer.pruning and any(w in ctx.dead for w in windows)

        if veer.eager_verify and not doomed:
            r = veer._try_verify_decomposition(ctx, windows, entire_pair)
            if r is not UNKNOWN:
                if r is TRUE:
                    stats.note_first_certificate()
                stats.explore_time += time.perf_counter() - t_explore
                return r

        unit_to_window = {}
        for w in windows:
            for u in w:
                unit_to_window[u] = w

        all_marked = True
        for w in windows:
            neighbors = ctx.pair.neighbors(w) & universe
            candidates: Set[FrozenSet[int]] = set()
            for u in neighbors:
                target = unit_to_window.get(u)
                merged = w | (target if target is not None else frozenset([u]))
                candidates.add(merged)
            expanded_any = False
            for merged in sorted(candidates, key=sorted):
                if not veer._accept_window(ctx, merged):
                    continue
                new_windows = tuple(
                    sorted(
                        {x for x in windows if not (x <= merged)} | {merged},
                        key=sorted,
                    )
                )
                key = _decomp_key(new_windows)
                if key in explored:
                    expanded_any = True  # an accepted move exists
                    continue
                explored.add(key)
                push(new_windows)
                expanded_any = True
            if not expanded_any:
                # window is maximal in this decomposition (Alg 2 line 14);
                # §7.2: verify immediately, remember refuted VALID windows
                if (
                    veer.pruning
                    and w not in ctx.dead
                    and ctx.valid_evs(w)
                    and ctx.window_verdict(w) is not TRUE
                ):
                    ctx.dead.add(w)
                    doomed = True
            else:
                all_marked = False

        if all_marked and not doomed:
            r = veer._try_verify_decomposition(ctx, windows, entire_pair)
            if r is not UNKNOWN:
                if r is TRUE:
                    stats.note_first_certificate()
                stats.explore_time += time.perf_counter() - t_explore
                return r
        if all_marked and doomed and len(windows) == 1 and windows[0] == entire_pair:
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
