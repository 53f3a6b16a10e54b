"""Token ingestion pipeline expressed as a Veer-verifiable dataflow DAG; the
port's copy of the reference package's ``data/pipeline.py``.

The pipeline (source → quality/lang filters → tokenize-pack → sink) is a
``core.DataflowDAG``: every experiment iteration that edits the pipeline
produces a new *version*, and ``repro_torch.reuse.ReuseManager`` uses Veer to
skip re-ingestion when the packed-tokens sink is provably unchanged (paper
Use case 1 applied to the most expensive I/O stage of training).  On the
torch plane the two FILTERs run through the relational kernel; the
``tokenize_pack`` UDF and the sink run on the host, as in the reference.

Importing this module registers ``tokenize_pack`` in the port's own UDF
registry (``repro_torch.engine.ops_impl``).
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.core import dag as D
from repro_torch.core.dag import DataflowDAG, Link, Operator
from repro_torch.core.predicates import Pred
from repro_torch.data.synthetic import doc_tokens
from repro_torch.engine.ops_impl import register_udf
from repro_torch.engine.table import Table

CORPUS_SCHEMA = ("doc_id", "quality", "lang_id", "length")


@register_udf("tokenize_pack")
def _tokenize_pack(t: Table) -> Table:
    """Documents → token lists (deterministic; engine-level UDF).

    Two departures from the reference's lines.  Each list holds Python
    ints (``tolist``), as the disk store's JSON gives them back, so a sink
    and its round trip through the store are ``tables_identical``; the
    reference's holds numpy scalars, which pickle to a fleet's workers and
    back several times slower, and which ``tables_identical`` tells apart
    from ints (``table_digest`` does not).  And the column is filled one
    document at a time, so it is 1-D even when every list has the same
    length (``np.array`` of such a list of lists would make it 2-D)."""
    toks = np.empty(len(t), dtype=object)
    for i in range(len(t)):
        toks[i] = doc_tokens(int(t.cols["doc_id"][i]), int(t.cols["length"][i])).tolist()
    return t.with_col("tokens", toks)


def ingestion_pipeline(
    *,
    min_quality: float = 0.25,
    lang: Optional[int] = 0,
    pipeline_id: str = "ingest",
) -> DataflowDAG:
    ops = [
        Operator.make("corpus", D.SOURCE, schema=CORPUS_SCHEMA),
        Operator.make(
            "q_filter", D.FILTER, pred=Pred.cmp("quality", ">", min_quality)
        ),
        Operator.make(
            "tokenize",
            D.UDF,
            fn="tokenize_pack",
            out_schema=CORPUS_SCHEMA + ("tokens",),
        ),
        Operator.make("packed", D.SINK, semantics=D.BAG),
    ]
    links = [Link("corpus", "q_filter")]
    prev = "q_filter"
    if lang is not None:
        ops.insert(
            2,
            Operator.make("lang_filter", D.FILTER, pred=Pred.cmp("lang_id", "==", lang)),
        )
        links.append(Link("q_filter", "lang_filter"))
        prev = "lang_filter"
    links.extend([Link(prev, "tokenize"), Link("tokenize", "packed")])
    return DataflowDAG(ops, links)


def pack_batches(
    packed: Table, *, seq_len: int, batch: int, vocab: int
) -> Iterator[Dict[str, np.ndarray]]:
    """Concatenate token lists into fixed (batch, seq_len+1) training rows."""
    stream: list = []
    rows: list = []
    for i in range(len(packed)):
        stream.extend(packed.cols["tokens"][i])
        stream.append(1)  # EOS
        while len(stream) >= seq_len + 1:
            rows.append(np.array(stream[: seq_len + 1], dtype=np.int32) % vocab)
            stream = stream[seq_len + 1 :]
            if len(rows) == batch:
                yield {"tokens": np.stack(rows)}
                rows = []
    # drop remainder (deterministic)
