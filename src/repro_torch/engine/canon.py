"""Canonical key machinery shared by the engine planes.

The reference engine (``repro_torch.engine.ops_impl``) builds hash-join indexes,
aggregate groups and distinct sets with *Python dict keys*: every row value
passes through ``keyval`` (round floats to 9 digits, unwrap numpy scalars)
and equality is Python ``==`` on the results.  That gives three semantics
the vectorized plane must replicate **exactly**:

  * rounded floats compare by value, so ``-0.0`` and ``0.0`` collapse and
    ``1.0000000001`` joins ``0.9999999999`` onto ``1.0``'s slot whenever
    their 9-digit roundings coincide;
  * each ``NaN`` is its own dict key (``nan != nan`` and the objects are
    distinct), so NaN join keys never match and every NaN row is its own
    aggregate group — while ``repr``-keyed paths (DISTINCT) collapse all
    NaNs to one;
  * Python ``round`` is *not* ``np.round`` (different tie/precision
    behavior on ~4% of uniform floats), so rounding must go through the
    real ``round``.

``column_codes`` squares the circle without per-row Python: factorize the
column with ``np.unique`` (vectorized), then apply ``keyval``-keyed dict
compression only to the **unique** values — O(distinct) Python work, exact
dict-key equality by construction.  ``combine_codes`` folds several code
columns into one row key, re-compressing at each step so values stay far
from int64 overflow.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def keyval(v):
    """The reference engine's dict-key canonicalization (one scalar)."""
    if isinstance(v, (np.floating, float)):
        return round(float(v), 9)
    if isinstance(v, np.integer):
        return int(v)
    return v


def column_codes(arr: np.ndarray, *, nan_distinct: bool) -> np.ndarray:
    """Dense int64 codes with ``keyval``-equality semantics, vectorized.

    Two rows get the same code iff their ``keyval`` canonicalizations are
    equal as Python dict keys.  ``nan_distinct=True`` gives every NaN row a
    fresh code (the join/aggregate dict-key behavior: ``nan != nan``);
    ``nan_distinct=False`` collapses all NaNs to one code (the
    ``repr``-keyed DISTINCT behavior, where every NaN prints ``nan``).

    Object-dtype columns are not supported — callers fall back to the
    reference plane for those.
    """
    arr = np.asarray(arr)
    if arr.dtype == object:
        raise TypeError("column_codes does not support object columns")
    if arr.size == 0:
        return np.zeros(0, dtype=np.int64)
    uniq, inv = np.unique(arr, return_inverse=True)
    inv = inv.reshape(-1).astype(np.int64)
    # fast path: the keyval remap can only merge uniques beyond what
    # np.unique already merged (-0.0 with 0.0, equal values) when two
    # uniques share a 9-digit rounding — which forces |a-b| <~ 1.1e-9.
    # Integers/bools can never merge; floats whose adjacent uniques are
    # all farther apart than 1e-8 can never merge either, so the remap is
    # the identity and ``inv`` is already the code column.
    merge_possible = False
    n_slots = len(uniq)
    if arr.dtype.kind == "f":
        fu = uniq[~np.isnan(uniq)] if np.isnan(uniq[-1]) else uniq
        merge_possible = len(fu) > 1 and float(np.min(np.diff(fu))) <= 1e-8
    if not merge_possible:
        codes = inv
    else:
        # dict-compress only the uniques: exact Python round/==/hash
        # semantics at O(distinct) cost
        slots: dict = {}
        remap = np.empty(len(uniq), dtype=np.int64)
        for i, u in enumerate(uniq):
            k = keyval(u)
            remap[i] = slots.setdefault(k, len(slots))
        codes = remap[inv]
        n_slots = len(slots)
    if arr.dtype.kind == "f":
        nan_mask = np.isnan(arr)
        if nan_mask.any() and nan_distinct:
            # np.unique collapsed the NaNs; give each NaN row its own code,
            # numbered in row order so code order tracks insertion order
            base = np.int64(n_slots)
            codes[nan_mask] = base + np.arange(
                int(nan_mask.sum()), dtype=np.int64
            )
    return codes


def combine_codes(code_cols: Sequence[np.ndarray]) -> np.ndarray:
    """Fold per-column codes into one int64 row key (tuple equality).

    Rows are equal under the combined code iff they are equal under every
    input code — the vectorized analogue of keying a dict on the tuple of
    per-column ``keyval`` results.  Output codes are **not** compressed to
    a dense range (callers argsort, run-partition or re-unique them; only
    equality matters); a fold re-compresses through ``np.unique`` only
    when the running value range would otherwise overflow int64.
    """
    cols: List[np.ndarray] = [np.asarray(c, dtype=np.int64) for c in code_cols]
    if not cols:
        raise ValueError("combine_codes needs at least one code column")
    limit = np.iinfo(np.int64).max // 4
    out = cols[0]
    out_max = int(out.max()) if len(out) else 0
    for c in cols[1:]:
        c_max = int(c.max()) if len(c) else 0
        mult = c_max + 1
        if out_max > limit // mult:
            # compress before the fold; compressed codes are < n, and any
            # single column's codes are < 2n, so n*(2n) stays far below
            # int64 for every feasible table
            _, out = np.unique(out, return_inverse=True)
            out = out.reshape(-1).astype(np.int64)
            out_max = int(out.max()) if len(out) else 0
        out = out * np.int64(mult) + c
        out_max = out_max * mult + c_max
    return out


def run_bounds(codes: np.ndarray):
    """Adjacent-run decomposition of ``codes``: ``(run_id, starts, ends)``.

    ``run_id[i]`` is the index of the run row ``i`` belongs to; ``starts``
    and ``ends`` are the inclusive run boundaries.  Used by the vectorized
    descending-sort stability fix and the segment layout of the aggregate
    lowering.
    """
    n = len(codes)
    if n == 0:
        empty = np.zeros(0, dtype=np.int64)
        return empty, empty, empty
    change = np.empty(n, dtype=bool)
    change[0] = True
    np.not_equal(codes[1:], codes[:-1], out=change[1:])
    run_id = np.cumsum(change) - 1
    starts = np.flatnonzero(change)
    ends = np.append(starts[1:], n) - 1
    return run_id, starts, ends
