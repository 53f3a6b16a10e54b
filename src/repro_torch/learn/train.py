"""Harvest a labeled window corpus and train the guidance scorers.

The certificate corpus (``repro_torch.workload.corpus``) only sees *winning*
windows — every record of a decided pair's certificate verified True.  A
useful scorer also needs the windows the search checked and got nothing
from (UNK, refuted, ill-formed): those are the negatives.  ``harvest``
collects both by replaying seeded ``SessionGenerator`` sessions through a
``Veer`` whose ``window_observer`` hook converts **every** committed window
verdict into a ``WindowExample`` — the same schema ``dump_windows`` /
``load_windows`` stream, so harvested corpora and certificate corpora mix
freely.

``train_guidance`` dedupes by fingerprint (``dedupe_windows``), featurizes
(``features_from_example``), fits the window scorer on
``verdict is True`` and one per-EV scorer on the attempt logs (the final
attempt of a True window proved it; every earlier attempt was a miss), and
returns the bundle with calibration stats in ``meta``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.api.registry import EVRegistry, default_registry
from repro_torch.core.verifier import Veer
from repro_torch.learn.features import FEATURE_NAMES, features_from_example, op_histogram
from repro_torch.learn.model import GuidanceModel, LogisticModel
from repro_torch.workload.config import DEFAULT_WORKLOADS, WorkloadConfig
from repro_torch.workload.corpus import WindowExample, dedupe_windows
from repro_torch.workload.generator import SessionGenerator

_VERDICT_CODE = {True: "T", False: "F", None: "U"}


def _example_from_window(ctx, win, out, *, meta: Dict[str, object]) -> WindowExample:
    """One ``WindowExample`` from a live search window (observer side)."""
    qp = ctx.query_pair(win)
    units = ctx.units_tuple(win)
    prov = out.provenance
    if prov is not None and prov[0] == "identical":
        record_kind = "identical"
        ev_name = None
    else:
        record_kind = "search"
        ev_name = prov[1] if prov is not None else None
    if qp is None:
        op_hist: Dict[str, int] = {}
        topology = {
            "n_units": len(units),
            "p_ops": 0,
            "q_ops": 0,
            "p_links": 0,
            "q_links": 0,
        }
        fp = None
    else:
        op_hist = op_histogram(qp)
        topology = {
            "n_units": len(units),
            "p_ops": len(qp.P.ops),
            "q_ops": len(qp.Q.ops),
            "p_links": len(qp.P.links),
            "q_links": len(qp.Q.links),
        }
        fp = ctx.fingerprint(win)
    return WindowExample(
        workload=str(meta.get("workload", "?")),
        session_id=str(meta.get("session_id", "?")),
        pair_index=int(meta.get("pair_index", -1)),
        family=str(meta.get("family", "?")),
        expected=str(meta.get("expected", "?")),
        record_kind=record_kind,
        cert_kind="-",
        verdict=out.verdict,
        ev_name=ev_name,
        fingerprint=fp,
        units=tuple(units),
        op_hist=op_hist,
        topology=topology,
        ev_attempts=tuple(out.attempts),
    )


def harvest(
    *,
    seed: int = 0,
    sessions: int = 8,
    chain_length: int = 10,
    max_decompositions: int = 200,
    workloads: Sequence[str] = DEFAULT_WORKLOADS,
    registry: Optional[EVRegistry] = None,
) -> List[WindowExample]:
    """Labeled windows from every search over a seeded session workload.

    Each pair is verified with the production Veer⁺ flags minus guidance
    (the corpus must not depend on the model it trains) on the full EV
    roster; the observer captures every window the search decides —
    positives *and* negatives.
    """
    registry = registry if registry is not None else default_registry()
    config = WorkloadConfig(
        seed=seed,
        sessions=sessions,
        chain_length=chain_length,
        workloads=tuple(workloads),
        max_decompositions=max_decompositions,
    ).validate()
    generated = SessionGenerator(config).generate()

    examples: List[WindowExample] = []
    meta: Dict[str, object] = {}

    def observer(ctx, win, out) -> None:
        examples.append(_example_from_window(ctx, win, out, meta=meta))

    for s in generated:
        veer = Veer(
            registry.build(),
            segmentation=True,
            pruning=True,
            ranking=True,
            fast_inequivalence=True,
            eager_verify=True,
            try_all_mappings=True,
            max_decompositions=config.max_decompositions,
            window_observer=observer,
        )
        for k in range(1, len(s.versions)):
            planned = s.pairs[k - 1]
            meta.update(
                workload=s.workload,
                session_id=s.session_id,
                pair_index=planned.index,
                family=planned.kind,
                expected=planned.expected,
            )
            veer.verify(
                s.versions[k - 1], s.versions[k], planned.mapping
            )
    return examples


def _trainable(
    examples: Sequence[WindowExample],
) -> List[Tuple[WindowExample, List[float]]]:
    out = []
    for ex in examples:
        x = features_from_example(ex)
        if x is not None:
            out.append((ex, x))
    return out


def _calibration(model: LogisticModel, X, y, bins: int = 5) -> Dict[str, object]:
    """Simple reliability stats: accuracy, Brier score, per-bin calibration."""
    n = len(y)
    if n == 0:
        return {"n": 0}
    preds = [model.predict(x) for x in X]
    acc = sum(1 for p, t in zip(preds, y) if (p >= 0.5) == bool(t)) / n
    brier = sum((p - t) ** 2 for p, t in zip(preds, y)) / n
    table = []
    for b in range(bins):
        lo, hi = b / bins, (b + 1) / bins
        members = [
            (p, t)
            for p, t in zip(preds, y)
            if lo <= p < hi or (b == bins - 1 and p == 1.0)
        ]
        if members:
            table.append(
                {
                    "bin": f"[{lo:.1f},{hi:.1f})",
                    "n": len(members),
                    "mean_pred": sum(p for p, _ in members) / len(members),
                    "frac_true": sum(t for _, t in members) / len(members),
                }
            )
    return {
        "n": n,
        "base_rate": sum(y) / n,
        "accuracy": acc,
        "brier": brier,
        "reliability": table,
    }


def train_guidance(
    examples: Sequence[WindowExample],
    *,
    seed: int = 0,
    l2: float = 1e-3,
    epochs: int = 400,
    lr: float = 0.5,
) -> Tuple[GuidanceModel, Dict[str, object]]:
    """Fit the guidance bundle from a (mixed) corpus; returns
    ``(model, stats)`` where ``stats`` is also stored in ``model.meta``."""
    deduped = dedupe_windows(examples)
    rows = _trainable(deduped)
    if not rows:
        raise ValueError("corpus contains no featurizable windows")
    X = [x for _, x in rows]
    y = [1 if ex.verdict is True else 0 for ex, _ in rows]
    window_model = LogisticModel.train(
        X, y, l2=l2, epochs=epochs, lr=lr, seed=seed
    )

    # per-EV attempt labels: the final attempt of a True window proved it;
    # every other attempt (earlier in the order, or on a non-True window)
    # was a paid miss.  Cert-only corpora fall back to the deciding ev_name.
    ev_rows: Dict[str, Tuple[List[List[float]], List[int]]] = {}
    for ex, x in rows:
        attempts = tuple(ex.ev_attempts)
        if not attempts and ex.ev_name:
            attempts = (ex.ev_name,)
        for j, name in enumerate(attempts):
            won = ex.verdict is True and j == len(attempts) - 1
            Xs, ys = ev_rows.setdefault(name, ([], []))
            Xs.append(x)
            ys.append(1 if won else 0)
    ev_models: Dict[str, LogisticModel] = {}
    ev_counts: Dict[str, Dict[str, int]] = {}
    for name, (Xs, ys) in sorted(ev_rows.items()):
        ev_models[name] = LogisticModel.train(
            Xs, ys, l2=l2, epochs=epochs, lr=lr, seed=seed
        )
        ev_counts[name] = {"attempts": len(ys), "wins": sum(ys)}

    labels: Dict[str, int] = {}
    for ex, _ in rows:
        code = _VERDICT_CODE[ex.verdict]
        labels[code] = labels.get(code, 0) + 1
    stats: Dict[str, object] = {
        "seed": seed,
        "examples": len(examples),
        "deduped": len(deduped),
        "trainable": len(rows),
        "label_counts": labels,
        "window": _calibration(window_model, X, y),
        "evs": ev_counts,
        "hyper": {"l2": l2, "epochs": epochs, "lr": lr},
    }
    model = GuidanceModel(
        feature_names=tuple(FEATURE_NAMES),
        window=window_model,
        evs=ev_models,
        meta=stats,
    )
    return model, stats
