"""Columnar tables and their bit-level identity.

``Table`` stays a dict of numpy columns: content digests and the stores
hash the numpy bytes, so the torch plane copies columns to the device per
operator and brings its results back as numpy.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np


class Table:
    """Ordered named columns of equal-length 1-D numpy arrays."""

    def __init__(self, columns: Mapping[str, np.ndarray], order: Optional[Sequence[str]] = None):
        self.order: List[str] = list(order) if order is not None else list(columns)
        self.cols: Dict[str, np.ndarray] = {}
        n = None
        for name in self.order:
            arr = np.asarray(columns[name])
            if arr.ndim != 1:
                arr = arr.reshape(-1)
            if n is None:
                n = len(arr)
            elif len(arr) != n:
                raise ValueError(f"column {name}: length {len(arr)} != {n}")
            self.cols[name] = arr
        self.n = n or 0

    # -- constructors ---------------------------------------------------------
    @staticmethod
    def from_rows(schema: Sequence[str], rows: Iterable[Sequence]) -> "Table":
        rows = list(rows)
        cols = {}
        for j, name in enumerate(schema):
            vals = [r[j] for r in rows]
            cols[name] = _np_col(vals)
        return Table(cols, schema)

    @staticmethod
    def empty(schema: Sequence[str]) -> "Table":
        return Table({c: np.array([]) for c in schema}, schema)

    # -- access ----------------------------------------------------------------
    def __len__(self) -> int:
        return self.n

    def col(self, name: str) -> np.ndarray:
        return self.cols[name]

    def row(self, i: int) -> Tuple:
        return tuple(_scalar(self.cols[c][i]) for c in self.order)

    def rows(self) -> List[Tuple]:
        return [self.row(i) for i in range(self.n)]

    def take(self, idx: np.ndarray) -> "Table":
        return Table({c: self.cols[c][idx] for c in self.order}, self.order)

    def mask(self, m: np.ndarray) -> "Table":
        return self.take(np.nonzero(m)[0])

    def with_col(self, name: str, arr: np.ndarray) -> "Table":
        cols = dict(self.cols)
        cols[name] = np.asarray(arr)
        order = self.order + ([name] if name not in self.cols else [])
        return Table(cols, order)

    def select(self, names: Sequence[str]) -> "Table":
        return Table({n: self.cols[n] for n in names}, list(names))

    def rename(self, ren: Mapping[str, str]) -> "Table":
        return Table(
            {ren.get(c, c): self.cols[c] for c in self.order},
            [ren.get(c, c) for c in self.order],
        )

    def concat(self, other: "Table") -> "Table":
        if other.order != self.order:
            other = other.select(self.order)
        return Table(
            {c: np.concatenate([self.cols[c], other.cols[c]]) for c in self.order},
            self.order,
        )

    def __repr__(self) -> str:
        return f"Table({self.order}, n={self.n})"


def _np_col(vals: List) -> np.ndarray:
    if any(isinstance(v, str) for v in vals):
        return np.array(vals, dtype=object)
    if any(isinstance(v, (list, tuple)) for v in vals):
        return np.array(vals, dtype=object)
    return np.array(vals, dtype=np.float64) if vals else np.array([])


def _scalar(v):
    if isinstance(v, (np.floating,)):
        f = float(v)
        # canonicalize -0.0 and near-int floats for row hashing
        r = round(f, 9)
        return r + 0.0
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, np.ndarray):
        return tuple(v.tolist())
    if isinstance(v, (list, tuple)):
        return tuple(v)
    return v


def tables_identical(a: Table, b: Table) -> bool:
    """Bit-level identity: same column order, same dtypes, same values
    (NaN == NaN, so outer-join pads compare).  Stricter than any Def 2.2
    semantics — the contract reuse-aware partial execution upholds versus a
    full re-execution (see ``repro_torch.engine.executor``)."""
    if a.order != b.order or a.n != b.n:
        return False
    for c in a.order:
        xa, xb = a.cols[c], b.cols[c]
        if xa.dtype != xb.dtype:
            # np.array_equal compares across numeric dtypes (int64 [1,2,3]
            # == float64 [1.,2.,3.]); bit-level identity must not
            return False
        if xa.dtype == object:
            if any(repr(_scalar(u)) != repr(_scalar(v)) for u, v in zip(xa, xb)):
                return False
        elif not np.array_equal(xa, xb, equal_nan=True):
            return False
    return True
