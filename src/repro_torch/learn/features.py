"""Deterministic window featurization for the learned search guidance.

One fixed-order numeric vector per window (``FEATURE_NAMES``), computable
from two sources that must agree bit-for-bit:

  * **inference** — a live search window's ``QueryPair`` + canonical
    fingerprint (``features_from_query_pair``), exactly what the
    ``WindowTable`` already interns per window id;
  * **training** — a harvested ``WindowExample``'s ``op_hist`` /
    ``topology`` / ``fingerprint`` fields (``features_from_example``), which
    the corpus observer derives from the *same* query pair.

``tests/test_guidance.py`` locks that train/inference parity: a scorer is
only as sound as the guarantee that it sees the same vector both times.

The vector (all floats, no normalization state to ship):

  * size/topology — log1p op/link counts of both sides, unit count, the
    P→Q op/link deltas and the P-side link density;
  * op-type histogram — the fraction of P-side operators of each type in a
    fixed vocabulary (symbolic ``Source`` ops included, as serialized query
    pairs include them), plus an out-of-vocabulary bucket;
  * fingerprint bucket — a one-hot hash bucket of the rename-invariant
    window fingerprint, giving the model a small amount of memory for
    recurring window shapes (warm-cache windows repeat across versions);
  * EV-capability match — per EV of the canonical roster, the fraction of
    the window's op types the EV supports and an all-supported flag (from
    ``EVRegistry`` capability metadata — the hard precondition for that EV
    ever proving the window).

Ill-formed windows (no query pair) are never featurized: no EV can see
them, so the guidance layer scores them 0 directly.
"""

from __future__ import annotations

from collections import Counter
from math import log1p
from typing import Dict, FrozenSet, List, Optional, Tuple

from repro_torch.core import dag as D

#: Fixed op-type vocabulary (order matters: it is part of the feature
#: contract a serialized model artifact pins via its ``feature_names``).
OP_VOCAB: Tuple[str, ...] = (
    D.SOURCE,
    D.FILTER,
    D.PROJECT,
    D.JOIN,
    D.AGGREGATE,
    D.UNION,
    D.DISTINCT,
    D.SORT,
    D.LIMIT,
    D.UNNEST,
    D.REPLICATE,
    D.UDF,
    D.DICT_MATCHER,
    D.CLASSIFIER,
    D.SENTIMENT,
    D.SINK,
)

#: EVs the capability-match features cover, in canonical roster order.
CAPABILITY_EVS: Tuple[str, ...] = ("equitas", "spes", "udp", "jaxpr")

FP_BUCKETS = 8

FEATURE_NAMES: Tuple[str, ...] = (
    "n_units_log",
    "p_ops_log",
    "q_ops_log",
    "p_links_log",
    "q_links_log",
    "ops_delta",
    "links_delta",
    "p_density",
    *(f"frac_{t}" for t in OP_VOCAB),
    "frac_other",
    *(f"fp_bucket_{i}" for i in range(FP_BUCKETS)),
    *(f"cap_frac_{n}" for n in CAPABILITY_EVS),
    *(f"cap_all_{n}" for n in CAPABILITY_EVS),
)

N_FEATURES = len(FEATURE_NAMES)

_CAPABILITY_SETS: Optional[Dict[str, FrozenSet[str]]] = None


def capability_sets() -> Dict[str, FrozenSet[str]]:
    """``supported_op_types`` per roster EV, snapshotted once from the
    default registry (capability metadata is static per EV name)."""
    global _CAPABILITY_SETS
    if _CAPABILITY_SETS is None:
        from repro_torch.api.registry import default_registry  # late: EV imports

        reg = default_registry()
        _CAPABILITY_SETS = {
            name: reg.spec(name).supported_op_types
            for name in CAPABILITY_EVS
            if name in reg
        }
    return _CAPABILITY_SETS


def fingerprint_bucket(fingerprint: Optional[str]) -> Optional[int]:
    """Stable hash bucket of a canonical window fingerprint (hex string)."""
    if not fingerprint:
        return None
    try:
        return int(fingerprint[:8], 16) % FP_BUCKETS
    except ValueError:
        return None


def window_features(
    *,
    n_units: int,
    p_ops: int,
    q_ops: int,
    p_links: int,
    q_links: int,
    op_hist: Dict[str, int],
    fingerprint: Optional[str],
) -> List[float]:
    """The canonical feature vector from raw window measurements.

    This is the single place the vector is assembled — both the live and
    the corpus paths reduce their inputs to these seven arguments first.
    """
    caps = capability_sets()
    x: List[float] = [
        log1p(float(n_units)),
        log1p(float(p_ops)),
        log1p(float(q_ops)),
        log1p(float(p_links)),
        log1p(float(q_links)),
        float(q_ops - p_ops),
        float(q_links - p_links),
        float(p_links) / float(max(p_ops, 1)),
    ]
    total = max(sum(op_hist.values()), 1)
    in_vocab = 0
    for t in OP_VOCAB:
        c = op_hist.get(t, 0)
        in_vocab += c
        x.append(c / total)
    x.append((sum(op_hist.values()) - in_vocab) / total)
    bucket = fingerprint_bucket(fingerprint)
    for i in range(FP_BUCKETS):
        x.append(1.0 if bucket == i else 0.0)
    kinds = [t for t in sorted(op_hist) if op_hist[t] > 0]
    cap_frac: List[float] = []
    cap_all: List[float] = []
    for name in CAPABILITY_EVS:
        supported = caps.get(name, frozenset())
        if not kinds:
            cap_frac.append(0.0)
            cap_all.append(0.0)
            continue
        hit = sum(1 for t in kinds if t in supported)
        cap_frac.append(hit / len(kinds))
        cap_all.append(1.0 if hit == len(kinds) else 0.0)
    x.extend(cap_frac)
    x.extend(cap_all)
    return x


def op_histogram(qp) -> Dict[str, int]:
    """P-side operator-type counts of a live query pair — the same counts
    ``windows_from_certificate`` reads off a serialized certificate payload
    (symbolic source ops included in both)."""
    return dict(Counter(op.op_type for op in qp.P.ops.values()))


def features_from_query_pair(
    qp, n_units: int, fingerprint: Optional[str]
) -> List[float]:
    """Inference-side featurization from a live window's query pair."""
    return window_features(
        n_units=n_units,
        p_ops=len(qp.P.ops),
        q_ops=len(qp.Q.ops),
        p_links=len(qp.P.links),
        q_links=len(qp.Q.links),
        op_hist=op_histogram(qp),
        fingerprint=fingerprint,
    )


def features_from_example(ex) -> Optional[List[float]]:
    """Training-side featurization from a harvested ``WindowExample``.

    Returns ``None`` for examples that carry no shape information (windows
    that never formed a query pair) — inference never scores those either.
    """
    topo = ex.topology
    if not ex.op_hist and not topo.get("p_ops"):
        return None
    return window_features(
        n_units=int(topo.get("n_units", len(ex.units))),
        p_ops=int(topo.get("p_ops", 0)),
        q_ops=int(topo.get("q_ops", 0)),
        p_links=int(topo.get("p_links", 0)),
        q_links=int(topo.get("q_links", 0)),
        op_hist=ex.op_hist,
        fingerprint=ex.fingerprint,
    )
