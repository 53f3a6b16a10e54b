"""Iterative-analytics session with Veer-driven result reuse (Use case 1)
on the PyTorch port (the twin of ``examples/iterative_analytics.py``).

Simulates an analyst iterating on the token-ingestion pipeline: each
iteration submits a new version to the ReuseManager, which verifies sinks
against executed versions and serves provably-equivalent results from the
content-addressed store instead of re-running ingestion.  Versions run on
the torch data plane on ``--device`` (default ``cuda``; without CUDA it
raises unless ``--device cpu`` is given): the two FILTERs through the
relational kernel, ``tokenize_pack`` and the sink on the host.

    python examples/torch_iterative_analytics.py [--device cpu] [--docs N]
"""

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.api import VeerConfig
from repro_torch.core import dag as D
from repro_torch.core.dag import DataflowDAG, Link, Operator
from repro_torch.core.predicates import Pred
from repro_torch.data import CORPUS_SCHEMA, corpus_table, ingestion_pipeline
from repro_torch.engine.plane.torch_plane import resolve_device
from repro_torch.reuse import ReuseManager

op = Operator.make


def iterations():
    """The analyst's four versions, as ``(what changed, dag)``: the initial
    pipeline, two equivalent rewrites of it, and a tightened threshold."""
    v1 = ingestion_pipeline(min_quality=0.25, lang=0)
    v2 = DataflowDAG(
        [
            op("corpus", D.SOURCE, schema=CORPUS_SCHEMA),
            op("lang_filter", D.FILTER, pred=Pred.cmp("lang_id", "==", 0)),
            op("q_filter", D.FILTER, pred=Pred.cmp("quality", ">", 0.25)),
            op("tokenize", D.UDF, fn="tokenize_pack", out_schema=CORPUS_SCHEMA + ("tokens",)),
            op("packed", D.SINK, semantics=D.BAG),
        ],
        [Link("corpus", "lang_filter"), Link("lang_filter", "q_filter"),
         Link("q_filter", "tokenize"), Link("tokenize", "packed")],
    )
    v3 = v2.replace_op(op("q_filter", D.FILTER, pred=Pred.cmp("quality", ">", 0.5)))
    v3 = v3.replace_op(
        op("q_filter", D.FILTER,
           pred=Pred.and_(Pred.cmp("quality", ">", 0.25), Pred.cmp("quality", ">", 0.1)))
    )
    v4 = ingestion_pipeline(min_quality=0.6, lang=0)
    return [
        ("initial pipeline (quality>0.25, lang=0)", v1),
        ("reorder filters (cosmetic cleanup — equivalent)", v2),
        ("split the quality filter (still equivalent)", v3),
        ("tighten quality threshold (NOT equivalent)", v4),
    ]


def main(device: str = "cuda", n_docs: int = 4096) -> str:
    """Run the four iterations over ``n_docs`` documents on ``device``;
    returns what it printed."""
    resolve_device(device)
    out = []

    def say(*parts):
        out.append(" ".join(str(p) for p in parts))
        print(out[-1])

    with tempfile.TemporaryDirectory(prefix="veer_store_") as store:
        rm = ReuseManager(store, config=VeerConfig(), device=device)
        corpus = corpus_table(n_docs)  # ingestion is the expensive step
        src = {"corpus": corpus}
        (w1, v1), (w2, v2), (w3, v3), (w4, v4) = iterations()

        say(f"iteration 1: {w1}")
        t0 = time.perf_counter()
        r1 = rm.submit(v1, src)
        say(f"  executed, {len(r1['packed'])} docs packed, {time.perf_counter()-t0:.2f}s")

        for k, (what, v) in ((2, (w2, v2)), (3, (w3, v3))):
            say(f"iteration {k}: {what}")
            t0 = time.perf_counter()
            rm.submit(v, src)
            say(f"  served from store in {time.perf_counter()-t0:.2f}s "
                f"(hits={rm.stats.sink_hits}, executions={rm.stats.executions})")

        say(f"iteration 4: {w4}")
        t0 = time.perf_counter()
        r4 = rm.submit(v4, src)
        say(f"  re-executed in {time.perf_counter()-t0:.2f}s "
            f"({len(r4['packed'])} docs; hits={rm.stats.sink_hits}, "
            f"executions={rm.stats.executions})")

        s = rm.stats
        say(
            f"\nsession: {s.submissions} versions, {s.sink_hits} sinks reused, "
            f"{s.executions} executions, verify={s.verify_time:.2f}s vs "
            f"execute={s.execute_time:.2f}s, dedup'd writes={s.dedup_skipped_writes}"
        )
        # every reuse decision is certificate-backed and independently auditable
        for vid, prev_vid, cert in rm.certificates:
            say(f"  reuse v{vid}<-v{prev_vid}: {cert.summary()}; "
                f"{cert.replay().summary()}")
    return "\n".join(out)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="where the torch plane runs (cuda or cpu)")
    ap.add_argument("--docs", type=int, default=4096, help="documents in the corpus")
    args = ap.parse_args()
    main(args.device, args.docs)
