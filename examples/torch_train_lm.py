"""End-to-end run on the PyTorch port (the twin of ``examples/train_lm.py``):
ingest data through the Veer-verified pipeline, then train a ~100M
llama3-family model with checkpoint/restart and straggler monitoring.

The ingestion pipeline runs through the port's ``ReuseManager`` with the
full EV roster (Equitas, Spes, UDP and the traced EV), on the torch data
plane; training runs ``fit`` with AdamW and a ``CheckpointManager``, on
``--device`` (default ``cuda``; without CUDA it raises unless ``--device
cpu`` is given).

    python examples/torch_train_lm.py --steps 300 [--device cpu]
"""

import argparse
import dataclasses
import itertools
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.api import VeerConfig
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.configs.base import uniform_pattern
from repro_torch.data import corpus_table, ingestion_pipeline, pack_batches
from repro_torch.models import build_model
from repro_torch.models.registry import resolve_device
from repro_torch.reuse import ReuseManager
from repro_torch.train import AdamW, AdamWConfig
from repro_torch.train.loop import fit


def small_llama(d_model=512, n_layers=8, vocab=50_304):
    """~100M-param llama3-family config."""
    base = get_arch("llama3-8b")
    return dataclasses.replace(
        base,
        name="llama3-100m",
        n_layers=n_layers,
        d_model=d_model,
        n_heads=8,
        n_kv_heads=4,
        d_head=64,
        d_ff=4 * d_model,
        vocab=vocab,
        pattern=uniform_pattern("attn", n_layers),
        scan_period=1,
    )


def main(device: str = "cuda", steps: int = 300, batch: int = 8, seq: int = 128,
         d_model: int = 512, layers: int = 8, docs: int = 2048, vocab: int = 50_304) -> str:
    """Ingest ``docs`` documents, train for ``steps`` steps on ``device``;
    returns what it printed."""
    resolve_device(device)
    out = []

    def say(line):
        out.append(line)
        print(line, flush=True)

    with tempfile.TemporaryDirectory(prefix="veer_") as work:
        # 1) data: Veer-verified ingestion
        rm = ReuseManager(os.path.join(work, "store"), config=VeerConfig(), device=device)
        packed = rm.submit(ingestion_pipeline(min_quality=0.2, lang=None),
                           {"corpus": corpus_table(docs)})["packed"]

        # 2) model + optimizer
        cfg = small_llama(d_model, layers, vocab)
        model = build_model(cfg)
        say(f"model: {cfg.name}  params={model.n_params()/1e6:.1f}M  device={device}")
        opt = AdamW(AdamWConfig(lr=3e-4, warmup_steps=50, zero1=False))
        batches = itertools.cycle(pack_batches(packed, seq_len=seq, batch=batch, vocab=cfg.vocab))

        # 3) train with checkpointing
        ckpt = CheckpointManager(os.path.join(work, "ckpt"), keep=2)
        res = fit(model, opt, batches, steps=steps, ckpt=ckpt, ckpt_every=100, seed=0,
                  device=device, log_every=20, log=say)
        say(f"done: steps={res.steps_run} loss {res.losses[0]:.3f} -> {res.losses[-1]:.3f}"
            f" (stragglers flagged: {len(res.straggler_steps)})")
    return "\n".join(out)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--docs", type=int, default=2048)
    ap.add_argument("--vocab", type=int, default=50_304)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    main(a.device, a.steps, a.batch, a.seq, a.d_model, a.layers, a.docs, a.vocab)
