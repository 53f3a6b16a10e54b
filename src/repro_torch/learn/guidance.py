"""``SearchGuidance`` — the learned policy Algorithm 2 consults.

The verifier (both search backends) calls exactly two methods:

  * ``decomposition_score(ctx, windows)`` — the mean predicted
    P(window verifies) over a candidate decomposition's windows; the
    best-first heap uses its negation as the *primary* key, with the
    unguided §7.3 ranking as deterministic tie-break;
  * ``ev_order(ctx, win, valid)`` — the window's valid EVs reordered by the
    learned per-EV scores (stable: score ties keep canonical roster order).

Soundness: both are pure *scheduling* decisions.  A misranked frontier
explores decompositions in a worse order; a misranked EV list pays extra EV
calls — neither can flip a verdict, because every True still requires an
EV-verified covering decomposition and every False a capable EV's
refutation (paper Lemma 5.3 / Theorem 5.8).

Determinism and backend identity: per-window scores are computed from the
window's query pair and canonical fingerprint — both byte-identical across
the bitmask and reference backends — and are memoized per window handle in
the context (``ctx.guidance_cache``), so a guided bitmask search and a
guided reference search explore the same decomposition sequence.  Windows
with no query pair (ill-formed — invisible to every EV) score 0.0 without
being featurized.
"""

from __future__ import annotations

import math
import pathlib
from typing import Optional, Tuple

from repro_torch.learn.features import features_from_query_pair
from repro_torch.learn.model import GuidanceModel, check_feature_contract

#: The committed artifact ``load_guidance()`` falls back to: a byte-for-byte
#: copy of the reference package's ``learn/pretrained.json`` (see
#: docs/SEARCH_GUIDANCE.md).
PRETRAINED_PATH = pathlib.Path(__file__).resolve().parent / "pretrained.json"


#: Probability floor for windows no EV can currently see (ill-formed) or
#: that the model writes off — keeps log-scores finite while still making
#: every such window expensive enough that merging it away always helps.
MIN_WINDOW_PROB = 1e-4
MAX_WINDOW_PROB = 1.0 - 1e-6
_LOG_MIN = math.log(MIN_WINDOW_PROB)


class SearchGuidance:
    """Bind a ``GuidanceModel`` to the verifier's guidance protocol."""

    def __init__(self, model: GuidanceModel):
        check_feature_contract(model)
        self.model = model

    # -- per-window memo ------------------------------------------------------
    def _entry(self, ctx, win) -> Tuple[float, Optional[list]]:
        """(log P(window verifies), feature vector) per window handle."""
        cache = ctx.guidance_cache
        e = cache.get(win)
        if e is None:
            qp = ctx.query_pair(win)
            if qp is None:
                e = (_LOG_MIN, None)  # ill-formed: no EV can currently see it
            else:
                x = features_from_query_pair(
                    qp, len(ctx.units_tuple(win)), ctx.fingerprint(win)
                )
                p = min(
                    max(self.model.window_score(x), MIN_WINDOW_PROB),
                    MAX_WINDOW_PROB,
                )
                e = (math.log(p), x)
            cache[win] = e
        return e

    # -- the verifier-facing protocol -----------------------------------------
    def decomposition_score(self, ctx, windows) -> float:
        """log P(the whole decomposition verifies), treating windows as
        independent: the sum of per-window log-probabilities.  Every window
        contributes a penalty, so merging two windows into one that the
        model likes strictly raises the score — the learned analogue of the
        §7.3 coverage drive — while a decomposition stuck with unverifiable
        windows sinks by ``log(MIN_WINDOW_PROB)`` per offender."""
        total = 0.0
        for w in windows:
            total += self._entry(ctx, w)[0]
        return total

    def ev_order(self, ctx, win, valid: Tuple[int, ...]) -> Tuple[int, ...]:
        """Reorder the window's valid EV indices by learned score (the set
        itself never changes — only who gets asked first)."""
        _, x = self._entry(ctx, win)
        if x is None:
            return valid
        scores = self.model.ev_scores(x)
        return tuple(
            sorted(
                valid,
                key=lambda i: (-scores.get(ctx.evs[i].name, 0.0), i),
            )
        )


def load_guidance(path: Optional[str] = None) -> SearchGuidance:
    """The guidance object ``VeerConfig.build`` wires into ``Veer``.

    ``path=None`` loads the committed pretrained artifact; an explicit path
    loads a custom one (e.g. a freshly trained smoke model in CI).
    """
    p = pathlib.Path(path) if path is not None else PRETRAINED_PATH
    if not p.exists():
        raise FileNotFoundError(
            f"no guidance model at {p}; train one with "
            "repro_torch.learn.train_guidance"
        )
    return SearchGuidance(GuidanceModel.load(p))
