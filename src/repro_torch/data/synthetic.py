"""Deterministic synthetic corpus (Assumption §2.2: re-runs reproduce); the
port's copy of the reference package's ``data/synthetic.py``.

Documents carry numeric metadata columns (quality, lang_id, length) so the
ingestion pipeline's filters are *linear predicates* the EVs can reason
about — the data pipeline is a first-class Veer workflow.
"""

from __future__ import annotations

import numpy as np

from repro_torch.engine.table import Table


def corpus_table(n_docs: int = 512, seed: int = 7, vocab: int = 50_000) -> Table:
    rng = np.random.default_rng(seed)
    doc_id = np.arange(n_docs, dtype=np.float64)
    quality = np.round(rng.uniform(0, 1, n_docs), 3)
    lang_id = rng.integers(0, 4, n_docs).astype(np.float64)
    length = rng.integers(16, 256, n_docs).astype(np.float64)
    return Table(
        {
            "doc_id": doc_id,
            "quality": quality,
            "lang_id": lang_id,
            "length": length,
        },
        ["doc_id", "quality", "lang_id", "length"],
    )


def doc_tokens(doc_id: int, length: int, vocab: int = 50_000) -> np.ndarray:
    """Deterministic token stream per document (LCG hash, python ints)."""
    mask = (1 << 64) - 1
    x = (int(doc_id) * 2654435761 + 12345) & mask
    out = np.empty(length, dtype=np.int64)
    for i in range(length):
        x = (x * 6364136223846793005 + 1442695040888963407) & mask
        out[i] = (x >> 33) % (vocab - 2) + 2
    return out
