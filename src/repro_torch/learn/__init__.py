"""Learned search guidance for Algorithm 2 (GEqO-style, arXiv 2401.01280).

A featurized logistic scorer, trained on the labeled window corpus the
workload generator emits, steers the decomposition search: the learned
score reorders the best-first frontier and picks which EV to try first per
window.  Predictions only *schedule* work — certificates still gate every
verdict — so guidance can change how fast the search certifies, never what
it certifies.  See docs/SEARCH_GUIDANCE.md.
"""

from repro_torch.learn.features import (
    FEATURE_NAMES,
    features_from_example,
    features_from_query_pair,
    window_features,
)
from repro_torch.learn.guidance import PRETRAINED_PATH, SearchGuidance, load_guidance
from repro_torch.learn.model import GuidanceModel, LogisticModel, check_feature_contract
from repro_torch.learn.train import harvest, train_guidance

__all__ = [
    "FEATURE_NAMES",
    "GuidanceModel",
    "LogisticModel",
    "PRETRAINED_PATH",
    "SearchGuidance",
    "check_feature_contract",
    "features_from_example",
    "features_from_query_pair",
    "harvest",
    "load_guidance",
    "train_guidance",
    "window_features",
]
