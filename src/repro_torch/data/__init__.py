from repro_torch.data.pipeline import ingestion_pipeline, pack_batches, CORPUS_SCHEMA
from repro_torch.data.synthetic import corpus_table

__all__ = ["ingestion_pipeline", "pack_batches", "CORPUS_SCHEMA", "corpus_table"]
