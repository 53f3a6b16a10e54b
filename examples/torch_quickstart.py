"""Quickstart on the PyTorch port: verify equivalence of two workflow
versions via ``repro_torch.api`` (the twin of ``examples/quickstart.py``).

Reproduces the paper's running example in miniature: an analyst refines a
tweet-analytics workflow (delete a filter, add two filters); Veer decides
which sinks kept their results — and hands back a *certificate* that can be
independently replayed (and serialized) instead of a bare True.  The
engine cross-check runs both versions on the torch data plane
(``plane="torch"``) on ``--device`` (default ``cuda``; without CUDA it
raises unless ``--device cpu`` is given).

    python examples/torch_quickstart.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import numpy as np

from repro_torch.api import Certificate, VeerConfig, verify
from repro_torch.core import dag as D
from repro_torch.core.dag import DataflowDAG, Link, Operator
from repro_torch.core.predicates import Pred
from repro_torch.engine import Table, sink_results_equal
from repro_torch.engine.plane.torch_plane import resolve_device

op = Operator.make


def version1() -> DataflowDAG:
    """Tweets -> filter commercial-ish users -> classify topic -> aggregate."""
    return DataflowDAG(
        [
            op("tweets", D.SOURCE, schema=("tweet_id", "user_id", "score", "followers")),
            op("f_followers", D.FILTER, pred=Pred.cmp("followers", ">", 2)),
            # provably redundant: implied by f_followers (> 2 ⟹ > 1)
            op("f_obsolete", D.FILTER, pred=Pred.cmp("followers", ">", 1)),
            op("classify", D.CLASSIFIER, col="score", out="topic", model="wildfire", classes=3),
            op("agg", D.AGGREGATE, group_by=("user_id",), aggs=(("count", "*", "n"),)),
            op("top", D.SORT, keys=(("n", False),)),
            op("sink_p", D.SINK, semantics=D.BAG),
        ],
        [
            Link("tweets", "f_followers"),
            Link("f_followers", "f_obsolete"),
            Link("f_obsolete", "classify"),
            Link("classify", "agg"),
            Link("agg", "top"),
            Link("top", "sink_p"),
        ],
    )


def version2(v1: DataflowDAG) -> DataflowDAG:
    """The analyst deletes the redundant filter (implied by its neighbor —
    Veer must PROVE the implication via the EV's linear reasoning, for every
    possible instance) and splits the follower filter."""
    v2 = v1.remove_op("f_obsolete")
    v2 = v2.add_link(Link("f_followers", "classify"))
    # split: followers > 2 == followers > 2 AND followers > 1 (redundant half)
    v2 = v2.remove_link(Link("tweets", "f_followers"))
    v2 = v2.add_op(op("f_redundant", D.FILTER, pred=Pred.cmp("followers", ">", 1)))
    v2 = v2.add_link(Link("tweets", "f_redundant")).add_link(Link("f_redundant", "f_followers"))
    return v2


def main(device: str = "cuda") -> str:
    """Run the example on ``device``; returns what it printed."""
    resolve_device(device)
    out = []

    def say(*parts):
        out.append(" ".join(str(p) for p in parts))
        print(out[-1])

    v1 = version1()
    v2 = version2(v1)

    say("version 1:", sorted(v1.ops))
    say("version 2:", sorted(v2.ops))

    for name, config in [
        ("Veer (baseline)", VeerConfig.baseline()),
        ("Veer+", VeerConfig()),
    ]:
        result = verify(v1, v2, config)
        say(
            f"{name:16s}: verdict={result.verdict}  "
            f"(decompositions={result.stats.decompositions_explored}, "
            f"EV calls={result.stats.ev_calls}, "
            f"{result.stats.total_time*1e3:.1f} ms)"
        )

    # the True verdict is not trust-me: it carries a replayable certificate
    result = verify(v1, v2)
    cert = result.certificate
    say("certificate:", cert.summary())
    say("replay (fresh EVs, no search):", cert.replay().summary())
    restored = Certificate.from_json(cert.to_json())   # survives the wire
    say("after JSON round-trip:", restored.replay().summary())

    # but is it TRUE? check against actual execution, on the torch plane
    rng = np.random.default_rng(0)
    tweets = Table(
        {
            "tweet_id": np.arange(64, dtype=float),
            "user_id": rng.integers(0, 9, 64).astype(float),
            "score": rng.integers(0, 5, 64).astype(float),
            "followers": rng.integers(0, 8, 64).astype(float),
        },
        ["tweet_id", "user_id", "score", "followers"],
    )
    src = {"tweets": tweets}
    say("engine agrees:", sink_results_equal(v1, v2, src, plane="torch", device=device))

    # an actually-different version: tighter follower filter
    v3 = v2.replace_op(op("f_followers", D.FILTER, pred=Pred.cmp("followers", ">", 3)))
    result = verify(v2, v3)
    say(f"v2 vs v3 (tightened filter): verdict={result.verdict} "
        "(Unknown — proving INEQUIVALENCE needs a whole-pair-capable EV, "
        "and this pair has a classifier)")
    say("engine shows they differ:",
        not sink_results_equal(v2, v3, src, plane="torch", device=device))
    return "\n".join(out)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="where the torch plane runs (cuda or cpu)")
    main(ap.parse_args().device)
