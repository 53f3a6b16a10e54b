"""Ranking functions for the best-first search (paper §7.3).

Segments: F(S) = m_S + n_S (operators + changes); smaller explored first —
quick answers and early termination.

Decompositions: G(d) = o_d - w_d where o_d is the average number of units in
the covering windows and w_d the number of unmerged (singleton) windows;
larger explored first — closer to a maximal decomposition.
"""

from __future__ import annotations

from typing import FrozenSet, Sequence, Tuple


def segment_score(num_units: int, num_changes: int) -> int:
    return num_units + num_changes


def decomposition_score(
    covering: Sequence[FrozenSet[int]], universe_size: int
) -> float:
    return decomposition_score_from_sizes(
        [len(w) for w in covering], universe_size
    )


def decomposition_score_from_sizes(
    sizes: Sequence[int], universe_size: int
) -> float:
    """G(d) from window *sizes* alone — the bitmask search kernel scores
    decompositions from interned popcounts without materializing sets.
    Bit-identical to ``decomposition_score`` (same integer sums, same float
    division), which the search-equivalence property test relies on."""
    if not sizes:
        return 0.0
    covered = sum(sizes)
    o_d = covered / len(sizes)
    w_d = universe_size - covered  # unmerged singleton windows
    return o_d - w_d
