"""Seeded, serializable logistic scorers for the search guidance.

Training is full-batch gradient descent on numpy (deterministic: fixed
iteration count, fixed initialization, one BLAS-free reduction order per
call — the same corpus and seed always produce byte-identical weights).
Inference is pure Python — a dot product over ~40 floats per window — so
the search's ``push()`` hot path never touches numpy.

Features are standardized internally during training and the affine
transform is folded back into the published weights, so a serialized model
is a flat ``(weights, bias)`` pair over the raw feature space with no
normalization state to keep in sync.

``GuidanceModel`` bundles the window scorer (P(window verifies True)) with
one scorer per EV (P(this EV is the one that proves it)) plus training
metadata; ``to_json``/``from_json`` round-trip the whole bundle, and the
committed artifact ``repro_torch/learn/pretrained.json`` (a byte-for-byte
copy of the reference package's) is exactly one such document.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


def _sigmoid(z: float) -> float:
    if z >= 0:
        return 1.0 / (1.0 + math.exp(-z))
    e = math.exp(z)
    return e / (1.0 + e)


@dataclass(frozen=True)
class LogisticModel:
    """A flat logistic regressor: ``sigmoid(w . x + b)`` over raw features."""

    weights: Tuple[float, ...]
    bias: float

    def predict(self, x: Sequence[float]) -> float:
        z = self.bias
        w = self.weights
        for i in range(len(w)):
            z += w[i] * x[i]
        return _sigmoid(z)

    def to_dict(self) -> Dict[str, object]:
        return {"weights": list(self.weights), "bias": self.bias}

    @staticmethod
    def from_dict(d: Dict[str, object]) -> "LogisticModel":
        return LogisticModel(
            weights=tuple(float(w) for w in d["weights"]),
            bias=float(d["bias"]),
        )

    @staticmethod
    def constant(n_features: int, rate: float) -> "LogisticModel":
        """A degenerate model predicting the base rate (used when a label
        class is absent — e.g. an EV that never decided a training window)."""
        rate = min(max(rate, 1e-6), 1.0 - 1e-6)
        return LogisticModel(
            weights=(0.0,) * n_features,
            bias=math.log(rate / (1.0 - rate)),
        )

    @staticmethod
    def train(
        X: Sequence[Sequence[float]],
        y: Sequence[int],
        *,
        l2: float = 1e-3,
        epochs: int = 400,
        lr: float = 0.5,
        seed: int = 0,
    ) -> "LogisticModel":
        """Deterministic full-batch GD with internal standardization.

        ``seed`` is part of the signature for forward compatibility (the
        current initialization is zeros, so it has no effect) and is
        recorded by callers into training metadata.
        """
        import numpy as np  # training-only dependency

        del seed  # deterministic zero init; kept in the signature/metadata
        Xa = np.asarray(X, dtype=np.float64)
        ya = np.asarray(y, dtype=np.float64)
        n, d = Xa.shape
        if not (0 < ya.sum() < n):
            return LogisticModel.constant(d, float(ya.mean()) if n else 0.5)
        mu = Xa.mean(axis=0)
        sd = Xa.std(axis=0)
        sd[sd == 0.0] = 1.0
        Xs = (Xa - mu) / sd
        w = np.zeros(d)
        b = 0.0
        for _ in range(epochs):
            z = Xs @ w + b
            p = 1.0 / (1.0 + np.exp(-np.clip(z, -35.0, 35.0)))
            g = p - ya
            gw = (Xs.T @ g) / n + l2 * w
            gb = float(g.mean())
            w -= lr * gw
            b -= lr * gb
        # fold the standardization into raw-space weights:
        #   w_s . (x - mu)/sd + b  ==  (w_s/sd) . x + (b - w_s . mu/sd)
        w_raw = w / sd
        b_raw = b - float((w * (mu / sd)).sum())
        return LogisticModel(
            weights=tuple(float(v) for v in w_raw), bias=b_raw
        )


@dataclass(frozen=True)
class GuidanceModel:
    """The serialized guidance bundle: window scorer + per-EV scorers."""

    feature_names: Tuple[str, ...]
    window: LogisticModel
    evs: Dict[str, LogisticModel] = field(default_factory=dict)
    meta: Dict[str, object] = field(default_factory=dict)
    version: int = 1

    def window_score(self, x: Sequence[float]) -> float:
        return self.window.predict(x)

    def ev_scores(self, x: Sequence[float]) -> Dict[str, float]:
        return {name: m.predict(x) for name, m in self.evs.items()}

    def to_dict(self) -> Dict[str, object]:
        return {
            "version": self.version,
            "feature_names": list(self.feature_names),
            "window": self.window.to_dict(),
            "evs": {n: m.to_dict() for n, m in sorted(self.evs.items())},
            "meta": self.meta,
        }

    @staticmethod
    def from_dict(d: Dict[str, object]) -> "GuidanceModel":
        return GuidanceModel(
            feature_names=tuple(d["feature_names"]),
            window=LogisticModel.from_dict(d["window"]),
            evs={
                n: LogisticModel.from_dict(m)
                for n, m in dict(d.get("evs", {})).items()
            },
            meta=dict(d.get("meta", {})),
            version=int(d.get("version", 1)),
        )

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @staticmethod
    def from_json(s: str) -> "GuidanceModel":
        return GuidanceModel.from_dict(json.loads(s))

    def save(self, path) -> None:
        with open(path, "w") as fh:
            fh.write(self.to_json())
            fh.write("\n")

    @staticmethod
    def load(path) -> "GuidanceModel":
        with open(path) as fh:
            return GuidanceModel.from_json(fh.read())


def check_feature_contract(
    model: GuidanceModel, names: Optional[Tuple[str, ...]] = None
) -> None:
    """Refuse to run a model trained against a different feature vector —
    a silently skewed scorer would still 'work' while steering at random."""
    from repro_torch.learn.features import FEATURE_NAMES

    expected = names if names is not None else FEATURE_NAMES
    if tuple(model.feature_names) != tuple(expected):
        raise ValueError(
            "guidance model feature contract mismatch: model has "
            f"{len(model.feature_names)} features, runtime expects "
            f"{len(expected)}; retrain with repro_torch.learn.train_guidance"
        )
