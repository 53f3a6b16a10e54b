"""Windows over a version pair (paper §3.2, Defs 3.1-3.5).

A *unit* is an aligned operator pair under the edit mapping M: ``(p, q)`` for
mapped operators, ``(p, None)`` for deletions, ``(None, q)`` for insertions.
A *window* is a set of units whose induced sub-DAGs are connected on both
sides; mapped pairs are both-in-or-both-out by construction (Def 3.1).

``to_query_pair`` exports the window as two stand-alone queries with aligned
symbolic sources (Def 3.4): the boundary correspondence below is what makes
Lemma 4.1/5.3 sound —

  * every in-boundary producer must be a *mapped, unmodified-outside* pair
    feeding both sides (its single output stream becomes one shared symbolic
    source table — operators send the same data on every outgoing link, §2);
  * every out-boundary consumer port must pair up exactly under M (the
    window's sinks feed isomorphic downstream consumers);
  * version sinks inside the window must pair under M.

Windows that violate this are *ill-formed*: they cannot be handed to an EV
and the search must expand them (this is how e.g. a bypass link around a
deleted operator forces the window to grow until the boundary is coherent).

*Changes* group the raw edit operations into semantic units the way the
paper counts them ("deleting the Filter operator" = one change including its
incident link edits).

Bitmask search kernel (docs/PERFORMANCE.md): alongside the frozenset API,
``VersionPair`` carries an integer-bitmask view of the unit graph — window
``w`` is an ``int`` with bit *i* set iff unit *i* ∈ w, ``adj_mask[i]`` is the
precomputed neighbor bitmask of unit *i* (with per-side ``p_adj_mask`` /
``q_adj_mask`` for the Def 3.1 sub-DAG connectivity check), so the search's
inner-loop operations become single big-int instructions:

  * ``neighbors``   → OR of per-unit adjacency masks, AND-NOT the window;
  * ``connected``   → iterated mask-expansion fixpoint (no Python DFS);
  * subsumption     → ``x & ~merged == 0``;
  * change coverage → ``change_mask & ~window == 0``.

``WindowTable`` interns masks to dense small-int ids and caches everything
the verifier repeatedly asks about a window (sort key, popcount, neighbor
mask, connectivity, query pair, fingerprint, valid-EV list, covered-change
mask), so the decomposition search operates on small ints end to end.
``FrozenSet`` survives only at the public API boundary (``to_query_pair``,
``window_fingerprint``, certificate replay): the exported query pairs and
evidence are byte-identical either way.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Mapping, Optional, Sequence, Set, Tuple

from repro_torch.core import dag as D
from repro_torch.core.dag import DataflowDAG, Link, Operator, infer_schema
from repro_torch.core.edits import (
    AddLink,
    AddOperator,
    DeleteOperator,
    EditMapping,
    ModifyOperator,
    RemoveLink,
    diff,
)
from repro_torch.core.ev.base import QueryPair


@dataclass(frozen=True)
class Unit:
    p: Optional[str]
    q: Optional[str]

    def __repr__(self) -> str:
        return f"U({self.p}|{self.q})"


@dataclass(frozen=True)
class Change:
    """A semantic change: grouped edit operations (op edit + incident links)."""

    kind: str                      # add|delete|modify|link
    edits: Tuple[object, ...]
    required_units: FrozenSet[int]  # must be inside any covering window
    label: str

    def __repr__(self) -> str:
        return f"Change({self.label})"


class VersionPair:
    """P, Q, mapping + derived: units, unit graph, changes, schemas."""

    def __init__(
        self,
        P: DataflowDAG,
        Q: DataflowDAG,
        mapping: EditMapping,
        semantics: str = D.BAG,
    ):
        P.validate()
        Q.validate()
        self.P, self.Q, self.mapping = P, Q, mapping
        self.semantics = semantics
        fwd = mapping.forward
        bwd = mapping.backward

        units: List[Unit] = []
        for p_id in P.ops:
            units.append(Unit(p_id, fwd.get(p_id)))
        for q_id in Q.ops:
            if q_id not in bwd:
                units.append(Unit(None, q_id))
        self.units = units
        self.unit_ids = {u: i for i, u in enumerate(units)}
        self.by_p = {u.p: i for i, u in enumerate(units) if u.p is not None}
        self.by_q = {u.q: i for i, u in enumerate(units) if u.q is not None}

        # unit adjacency (links of either version connect units)
        adj: Dict[int, Set[int]] = {i: set() for i in range(len(units))}
        for l in P.links:
            a, b = self.by_p[l.src], self.by_p[l.dst]
            adj[a].add(b)
            adj[b].add(a)
        for l in Q.links:
            a, b = self.by_q[l.src], self.by_q[l.dst]
            adj[a].add(b)
            adj[b].add(a)
        self.adj = adj

        # bitmask view of the unit graph (the search kernel's representation)
        n = len(units)
        self.n_units = n
        self.full_mask = (1 << n) - 1
        p_adj = [0] * n
        q_adj = [0] * n
        for l in P.links:
            a, b = self.by_p[l.src], self.by_p[l.dst]
            p_adj[a] |= 1 << b
            p_adj[b] |= 1 << a
        for l in Q.links:
            a, b = self.by_q[l.src], self.by_q[l.dst]
            q_adj[a] |= 1 << b
            q_adj[b] |= 1 << a
        self.p_adj_mask = p_adj
        self.q_adj_mask = q_adj
        self.adj_mask = [p_adj[i] | q_adj[i] for i in range(n)]
        self.p_mask = 0
        self.q_mask = 0
        for i, u in enumerate(units):
            if u.p is not None:
                self.p_mask |= 1 << i
            if u.q is not None:
                self.q_mask |= 1 << i

        self.edits = diff(P, Q, mapping)
        self.changes = self._group_changes()
        self.change_masks = [self.mask_of(c.required_units) for c in self.changes]
        self.schemas_p = infer_schema(P, {})
        self.schemas_q = infer_schema(Q, {})
        self._qp_cache: Dict[FrozenSet[int], Optional[QueryPair]] = {}
        self._fp_cache: Dict[FrozenSet[int], str] = {}

    # -- changes -----------------------------------------------------------------
    def _edit_units(self, e) -> FrozenSet[int]:
        if isinstance(e, DeleteOperator):
            return frozenset([self.by_p[e.op_id]])
        if isinstance(e, AddOperator):
            return frozenset([self.by_q[e.op.id]])
        if isinstance(e, ModifyOperator):
            return frozenset([self.by_q[e.op_id]])
        if isinstance(e, RemoveLink):
            return frozenset([self.by_p[e.link.src], self.by_p[e.link.dst]])
        if isinstance(e, AddLink):
            return frozenset([self.by_q[e.link.src], self.by_q[e.link.dst]])
        raise TypeError(e)

    def _group_changes(self) -> List[Change]:
        """Union-find over edits sharing units, anchored at op edits."""
        n = len(self.edits)
        parent = list(range(n))

        def find(i):
            while parent[i] != i:
                parent[i] = parent[parent[i]]
                i = parent[i]
            return i

        def union(i, j):
            parent[find(i)] = find(j)

        unit_sets = [self._edit_units(e) for e in self.edits]
        by_unit: Dict[int, List[int]] = {}
        for i, us in enumerate(unit_sets):
            for u in us:
                by_unit.setdefault(u, []).append(i)
        # only link edits incident to an op edit's unit group with it; two op
        # edits never merge through a shared mapped neighbor
        op_edit_idx = [
            i
            for i, e in enumerate(self.edits)
            if isinstance(e, (AddOperator, DeleteOperator, ModifyOperator))
        ]
        link_edit_idx = [i for i in range(n) if i not in set(op_edit_idx)]
        for li in link_edit_idx:
            for u in unit_sets[li]:
                for oi in op_edit_idx:
                    if u in unit_sets[oi]:
                        union(li, oi)
        # remaining link edits sharing units group together (pure rewires)
        for u, idxs in by_unit.items():
            ls = [i for i in idxs if i in set(link_edit_idx)]
            anchored = [i for i in ls if any(find(i) == find(o) for o in op_edit_idx)]
            floating = [i for i in ls if i not in anchored]
            for a, b in zip(floating, floating[1:]):
                union(a, b)

        groups: Dict[int, List[int]] = {}
        for i in range(n):
            groups.setdefault(find(i), []).append(i)
        changes = []
        for root, idxs in sorted(groups.items()):
            es = tuple(self.edits[i] for i in idxs)
            ops = [e for e in es if isinstance(e, (AddOperator, DeleteOperator, ModifyOperator))]
            if ops:
                # a covering window must contain the touched operators; the
                # incident link edits are expressed by the window boundary
                # correspondence (ill-formed windows are forced to grow)
                req = frozenset().union(*[self._edit_units(e) for e in ops])
                kind = (
                    "add"
                    if isinstance(ops[0], AddOperator)
                    else "delete"
                    if isinstance(ops[0], DeleteOperator)
                    else "modify"
                )
                label = ",".join(sorted(_edit_label(e) for e in ops))
                changes.append(Change(kind, es, req, label))
            else:
                # pure rewires: anchor each at the CONSUMER whose input
                # changed (the dst unit) — the in-boundary check at that unit
                # is what reveals the rewire; one change per consumer keeps
                # initial windows connected
                by_dst: Dict[int, List[object]] = {}
                for e in es:
                    if isinstance(e, RemoveLink):
                        dst = self.by_p[e.link.dst]
                    else:
                        assert isinstance(e, AddLink)
                        dst = self.by_q[e.link.dst]
                    by_dst.setdefault(dst, []).append(e)
                for dst, des in sorted(by_dst.items()):
                    label = ",".join(sorted(_edit_label(e) for e in des))
                    changes.append(
                        Change("link", tuple(des), frozenset([dst]), label)
                    )
        return self._absorb_bypass_links(changes)

    def _absorb_bypass_links(self, changes: List[Change]) -> List[Change]:
        """A removed P-link a→b whose endpoints are connected in Q through
        ops added by change C is the *bypass* of C (paper running example:
        deleting Filter_o adds link a→b; adding Filter_h removes oj→agg).
        Merge such pure-link changes into C so the user-visible change count
        matches the paper's (one edit = op change + incident link changes)."""
        fwd = self.mapping.forward
        bwd = self.mapping.backward

        def path_through(dag, start, end, allowed: Set[str]) -> bool:
            """Path start →+ end whose intermediates are all in `allowed`
            (and at least one intermediate exists)."""
            stack = [(start, False)]
            seen: Set[str] = set()
            while stack:
                n, passed = stack.pop()
                for l in dag.out_links.get(n, []):
                    if l.dst == end and passed:
                        return True
                    if l.dst in allowed and l.dst not in seen:
                        seen.add(l.dst)
                        stack.append((l.dst, True))
            return False

        op_changes = [c for c in changes if c.kind in ("add", "delete", "modify")]
        out: List[Change] = list(op_changes)
        for lc in [c for c in changes if c.kind == "link"]:
            absorbed = False
            for i, oc in enumerate(out):
                if oc.kind == "add":
                    added = {
                        e.op.id for e in oc.edits if isinstance(e, AddOperator)
                    }
                    ok = all(
                        isinstance(e, RemoveLink)
                        and fwd.get(e.link.src) is not None
                        and fwd.get(e.link.dst) is not None
                        and path_through(
                            self.Q, fwd[e.link.src], fwd[e.link.dst], added
                        )
                        for e in lc.edits
                    )
                elif oc.kind == "delete":
                    deleted = {
                        e.op_id for e in oc.edits if isinstance(e, DeleteOperator)
                    }
                    ok = all(
                        isinstance(e, AddLink)
                        and bwd.get(e.link.src) is not None
                        and bwd.get(e.link.dst) is not None
                        and path_through(
                            self.P, bwd[e.link.src], bwd[e.link.dst], deleted
                        )
                        for e in lc.edits
                    )
                else:
                    ok = False
                if ok and lc.edits:
                    out[i] = Change(
                        oc.kind,
                        oc.edits + lc.edits,
                        oc.required_units,
                        oc.label,
                    )
                    absorbed = True
                    break
            if not absorbed:
                out.append(lc)
        return out

    # -- window helpers -------------------------------------------------------
    def p_ops(self, win: FrozenSet[int]) -> Set[str]:
        return {self.units[i].p for i in win if self.units[i].p is not None}

    def q_ops(self, win: FrozenSet[int]) -> Set[str]:
        return {self.units[i].q for i in win if self.units[i].q is not None}

    def neighbors(self, win: FrozenSet[int]) -> Set[int]:
        out: Set[int] = set()
        for i in win:
            out |= self.adj[i]
        return out - set(win)

    def connected(self, win: FrozenSet[int]) -> bool:
        """Unit-graph connectivity + per-side sub-DAG connectivity (Def 3.1)."""
        if not win:
            return True
        seen: Set[int] = set()
        stack = [next(iter(win))]
        while stack:
            i = stack.pop()
            if i in seen:
                continue
            seen.add(i)
            stack.extend((self.adj[i] & win) - seen)
        if seen != set(win):
            return False
        p = self.p_ops(win)
        q = self.q_ops(win)
        return (not p or self.P.is_connected(p)) and (
            not q or self.Q.is_connected(q)
        )

    # -- bitmask window helpers (see module docstring / docs/PERFORMANCE.md) --
    @staticmethod
    def mask_of(units) -> int:
        m = 0
        for u in units:
            m |= 1 << u
        return m

    @staticmethod
    def mask_units(mask: int) -> Tuple[int, ...]:
        """Ascending unit indices of ``mask`` — doubles as the canonical
        window sort key (lexicographic on sorted unit tuples, exactly the
        ``key=sorted`` order of the frozenset representation)."""
        out = []
        while mask:
            low = mask & -mask
            out.append(low.bit_length() - 1)
            mask ^= low
        return tuple(out)

    def mask_neighbors(self, mask: int) -> int:
        """Units adjacent to the window but outside it, as a mask."""
        adj = self.adj_mask
        out = 0
        m = mask
        while m:
            low = m & -m
            out |= adj[low.bit_length() - 1]
            m ^= low
        return out & ~mask

    @staticmethod
    def _mask_spans(mask: int, adj: List[int]) -> bool:
        """Fixpoint mask expansion from the lowest unit: does one connected
        component cover ``mask`` under the per-unit adjacency ``adj``?"""
        reached = frontier = mask & -mask
        while frontier:
            grow = 0
            f = frontier
            while f:
                low = f & -f
                grow |= adj[low.bit_length() - 1]
                f ^= low
            frontier = grow & mask & ~reached
            reached |= frontier
        return reached == mask

    def mask_connected(self, mask: int) -> bool:
        """``connected`` on the bitmask representation (Def 3.1): unit-graph
        connectivity plus per-side sub-DAG connectivity, each an iterated
        mask-expansion fixpoint over the precomputed adjacency bitsets."""
        if not mask:
            return True
        if not self._mask_spans(mask, self.adj_mask):
            return False
        p = mask & self.p_mask
        if p and not self._mask_spans(p, self.p_adj_mask):
            return False
        q = mask & self.q_mask
        if q and not self._mask_spans(q, self.q_adj_mask):
            return False
        return True

    def covers(self, win: FrozenSet[int], change: Change) -> bool:
        return change.required_units <= win

    def covered_changes(self, win: FrozenSet[int]) -> List[Change]:
        return [c for c in self.changes if self.covers(win, c)]

    def covering_units(self) -> FrozenSet[int]:
        out: Set[int] = set()
        for c in self.changes:
            out |= c.required_units
        return frozenset(out)

    # -- query pair extraction (Def 3.4 + boundary correspondence) ---------------
    def to_query_pair(self, win: FrozenSet[int]) -> Optional[QueryPair]:
        if win in self._qp_cache:
            return self._qp_cache[win]
        qp = self._build_query_pair(win)
        self._qp_cache[win] = qp
        return qp

    def window_fingerprint(self, win: FrozenSet[int]) -> Optional[str]:
        """Canonical content address of the window's query pair (None when
        the window is ill-formed).  Rename-invariant — two isomorphic windows
        from *different* version pairs share a fingerprint, which is what
        lets the cross-version verdict cache answer for them (see
        ``QueryPair.fingerprint`` and ``repro_torch.core.ev.cache``)."""
        fp = self._fp_cache.get(win)
        if fp is not None:
            return fp
        qp = self.to_query_pair(win)
        if qp is None:
            return None
        fp = qp.fingerprint()
        self._fp_cache[win] = fp
        return fp

    def _build_query_pair(
        self, win: FrozenSet[int], *, assume_connected: bool = False
    ) -> Optional[QueryPair]:
        """``assume_connected=True`` skips the Def 3.1 connectivity recheck —
        the ``WindowTable`` fast path has already established it via
        ``mask_connected`` (provably the same predicate)."""
        fwd = self.mapping.forward
        bwd = self.mapping.backward
        p_in = self.p_ops(win)
        q_in = self.q_ops(win)
        if not p_in or not q_in:
            return None
        if not assume_connected and not self.connected(win):
            return None

        # ---- in-boundary producers
        p_srcs = {l.src for op in p_in for l in self.P.in_links[op] if l.src not in p_in}
        q_srcs = {l.src for op in q_in for l in self.Q.in_links[op] if l.src not in q_in}
        for s in p_srcs:
            ms = fwd.get(s)
            if ms is None or ms in q_in or ms not in q_srcs:
                return None
        for s in q_srcs:
            ms = bwd.get(s)
            if ms is None or ms in p_in or ms not in p_srcs:
                return None
        # producers must be unmodified (equal output semantics on both sides)
        for s in p_srcs:
            if self.P.ops[s].signature() != self.Q.ops[fwd[s]].signature():
                return None

        # ---- out-boundary consumer ports
        p_out = [
            l for op in p_in for l in self.P.out_links[op] if l.dst not in p_in
        ]
        q_out = [
            l for op in q_in for l in self.Q.out_links[op] if l.dst not in q_in
        ]
        p_keys: Dict[Tuple[str, int], str] = {}
        for l in p_out:
            md = fwd.get(l.dst)
            if md is None or md in q_in:
                return None
            p_keys[(md, l.dst_port)] = l.src
        q_keys: Dict[Tuple[str, int], str] = {}
        for l in q_out:
            if bwd.get(l.dst) is None:
                return None
            q_keys[(l.dst, l.dst_port)] = l.src
        if set(p_keys) != set(q_keys):
            return None

        # ---- version sinks inside the window
        # iterate in sorted order: the emitted QueryPair must not depend on
        # set iteration order (backends build `win` differently, and string
        # hashing varies per process) — certificates are byte-stable this way
        sink_pairs: List[Tuple[str, str]] = []
        at_version_sink = True
        p_true_sinks = [op for op in sorted(p_in) if not self.P.out_links[op]]
        q_true_sinks = [op for op in sorted(q_in) if not self.Q.out_links[op]]
        matched_q = set()
        for sp in p_true_sinks:
            sq = fwd.get(sp)
            if sq is None or sq not in q_in or self.Q.out_links[sq]:
                return None
            sink_pairs.append((sp, sq))
            matched_q.add(sq)
        for sq in q_true_sinks:
            if sq not in matched_q:
                return None

        boundary_pairs = sorted(
            {(p_keys[k], q_keys[k]) for k in p_keys}
        )
        if boundary_pairs:
            at_version_sink = False
        sink_pairs.extend(boundary_pairs)
        if not sink_pairs:
            return None

        # ---- build the two sub-DAGs with shared symbolic sources
        P_sub = self._induce_with_sources(self.P, p_in, self.schemas_p, side="p")
        Q_sub = self._induce_with_sources(self.Q, q_in, self.schemas_q, side="q")
        if P_sub is None or Q_sub is None:
            return None
        return QueryPair(
            P_sub,
            Q_sub,
            tuple(sink_pairs),
            semantics=self.semantics,
            at_version_sink=at_version_sink,
        )

    def _induce_with_sources(
        self,
        dag: DataflowDAG,
        inside: Set[str],
        schemas: Mapping[str, List[str]],
        side: str,
    ) -> Optional[DataflowDAG]:
        fwd = self.mapping.forward
        bwd = self.mapping.backward
        # sorted: the induced sub-DAG's operator/link order (and so the
        # serialized certificate payload) must not follow set iteration order
        ordered = sorted(inside)
        ops = [dag.ops[i] for i in ordered]
        links = [l for l in dag.links if l.src in inside and l.dst in inside]
        extra_ops: Dict[str, Operator] = {}
        for op_id in ordered:
            for l in dag.in_links[op_id]:
                if l.src in inside:
                    continue
                # symbolic source named by the P-side id of the producer pair
                canonical = l.src if side == "p" else bwd[l.src]
                sym_id = f"__in__{canonical}"
                if sym_id not in extra_ops:
                    extra_ops[sym_id] = Operator.make(
                        sym_id, D.SOURCE, schema=tuple(schemas[l.src])
                    )
                links.append(Link(sym_id, l.dst, l.dst_port))
        try:
            sub = DataflowDAG(ops + list(extra_ops.values()), links)
            sub.validate()
        except D.DAGError:
            return None
        return sub


_UNSET = object()  # WindowTable lazy-slot sentinel (None is a valid value)


class WindowTable:
    """Interning table: one canonical dense id per window bitmask.

    The decomposition search forms the same windows over and over — across
    candidate decompositions, across heap generations, across segments.
    Interning gives each distinct window one small-int id and pins every
    derived fact to it, computed at most once:

      * ``masks[id]`` / ``key[id]`` / ``pop[id]`` — the bitmask, the
        ascending unit tuple (canonical sort key, also the certificate's
        ``units``), and the popcount;
      * ``neighbor_mask(id)`` — the frontier mask (lazy);
      * ``connected(id)`` — Def 3.1 connectivity via mask fixpoint (lazy);
      * ``query_pair(id)`` / ``fingerprint(id)`` — the exported Def 3.4
        query pair and its canonical content address (lazy; ``None`` for
        ill-formed windows);
      * ``covered_mask(id)`` — bit *c* set iff change *c*'s required units
        are inside the window (lazy);
      * ``valid[id]`` — storage slot for the per-EV-roster validity tuple
        (filled by the search context, which owns the EV roster).

    One table serves one search (it is created per ``_SearchContext``); ids
    are meaningless across tables.
    """

    __slots__ = (
        "pair", "_ids", "masks", "key", "pop", "valid",
        "_neighbors", "_connected", "_qp", "_fp", "_covered",
    )

    def __init__(self, pair: "VersionPair"):
        self.pair = pair
        self._ids: Dict[int, int] = {}
        self.masks: List[int] = []
        self.key: List[Tuple[int, ...]] = []
        self.pop: List[int] = []
        self.valid: List[Optional[Tuple[int, ...]]] = []
        self._neighbors: List[Optional[int]] = []
        self._connected: List[Optional[bool]] = []
        self._qp: List[object] = []
        self._fp: List[object] = []
        self._covered: List[Optional[int]] = []

    def __len__(self) -> int:
        return len(self.masks)

    def intern(self, mask: int) -> int:
        wid = self._ids.get(mask)
        if wid is None:
            wid = len(self.masks)
            self._ids[mask] = wid
            self.masks.append(mask)
            units = self.pair.mask_units(mask)
            self.key.append(units)
            self.pop.append(len(units))
            self.valid.append(None)
            self._neighbors.append(None)
            self._connected.append(None)
            self._qp.append(_UNSET)
            self._fp.append(_UNSET)
            self._covered.append(None)
        return wid

    def intern_units(self, units) -> int:
        return self.intern(self.pair.mask_of(units))

    def frozen(self, wid: int) -> FrozenSet[int]:
        """The window back at the frozenset API boundary (evidence,
        certificates, ``to_query_pair``)."""
        return frozenset(self.key[wid])

    def neighbor_mask(self, wid: int) -> int:
        m = self._neighbors[wid]
        if m is None:
            m = self.pair.mask_neighbors(self.masks[wid])
            self._neighbors[wid] = m
        return m

    def connected(self, wid: int) -> bool:
        c = self._connected[wid]
        if c is None:
            c = self.pair.mask_connected(self.masks[wid])
            self._connected[wid] = c
        return c

    def query_pair(self, wid: int) -> Optional[QueryPair]:
        qp = self._qp[wid]
        if qp is _UNSET:
            if not self.connected(wid):
                qp = None
            else:
                qp = self.pair._build_query_pair(
                    self.frozen(wid), assume_connected=True
                )
            self._qp[wid] = qp
        return qp

    def fingerprint(self, wid: int) -> Optional[str]:
        fp = self._fp[wid]
        if fp is _UNSET:
            qp = self.query_pair(wid)
            fp = None if qp is None else qp.fingerprint()
            self._fp[wid] = fp
        return fp

    def covered_mask(self, wid: int) -> int:
        """Bitmask over *change indices* covered by this window.

        The search itself never asks (initial windows cover their anchoring
        change by construction and merges only grow windows); this is the
        coverage-query surface for tooling on top of the table —
        certificate-style coverage audits, benchmarks, tests."""
        cm = self._covered[wid]
        if cm is None:
            cm = 0
            mask = self.masks[wid]
            for ci, ch_mask in enumerate(self.pair.change_masks):
                if not ch_mask & ~mask:
                    cm |= 1 << ci
            self._covered[wid] = cm
        return cm


def identical_under_mapping(
    p_ops: Mapping[str, Operator],
    q_ops: Mapping[str, Operator],
    p_links: Sequence[Tuple[str, str, int]],
    q_links: Sequence[Tuple[str, str, int]],
    forward: Mapping[str, str],
) -> bool:
    """Structural identity of two mapped operator sets (Lemma 5.3 CASE1).

    ``p_links``/``q_links`` are the ``(src, dst, dst_port)`` triples of every
    link *feeding* an operator of the respective set — internal links and
    in-boundary links alike (``src`` may lie outside the set; ``forward``
    must still map it).  A swapped Join/Union input wiring is not
    "identical" even when the op sets match, hence the port in the key.

    Shared between the verifier's window shortcut and certificate replay:
    the certificate serializes exactly these inputs, so replaying an
    "identical" window record re-runs this check from first principles.
    """
    if len(p_ops) != len(q_ops):
        return False
    q_ids = set(q_ops)
    matched = set()
    for p_id, p_op in p_ops.items():
        q_id = forward.get(p_id)
        if q_id is None or q_id not in q_ids:
            return False
        if p_op.signature() != q_ops[q_id].signature():
            return False
        matched.add(q_id)
    if matched != q_ids:
        # the map must be a bijection between the two sets: a non-injective
        # forward (possible in attacker-controlled certificate payloads)
        # would leave unmatched q-side operators completely unexamined
        return False
    if any(s not in forward for s, _, _ in p_links):
        return False
    mapped = {(forward[s], forward[d], pt) for s, d, pt in p_links}
    return mapped == {tuple(l) for l in q_links}


def _edit_label(e) -> str:
    if isinstance(e, AddOperator):
        return f"+{e.op.id}"
    if isinstance(e, DeleteOperator):
        return f"-{e.op_id}"
    if isinstance(e, ModifyOperator):
        return f"~{e.op_id}"
    if isinstance(e, RemoveLink):
        return f"-L{e.link.src}->{e.link.dst}"
    if isinstance(e, AddLink):
        return f"+L{e.link.src}->{e.link.dst}"
    return repr(e)


def initial_window(pair: VersionPair, change: Change) -> FrozenSet[int]:
    """Algorithm 1 line 1: the smallest unit set anchoring the change."""
    return change.required_units
