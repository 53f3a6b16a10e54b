"""Serving example on the PyTorch port: batched greedy decode with KV/SSM
caches (the twin of ``examples/serve_decode.py``).

Runs a reduced gemma3 (sliding-window) and a reduced mamba2 (constant-state)
model side by side — the two cache disciplines of the assigned pool — with
weights drawn from a seed on ``--device`` (default ``cuda``; without CUDA
it raises unless ``--device cpu`` is given).

    python examples/torch_serve_decode.py [--device cpu]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.models import build_model
from repro_torch.serve import greedy_generate


def main(device: str = "cuda") -> str:
    """Generate 16 tokens for 4 prompts of 12 with each model on ``device``;
    returns what it printed."""
    out = []

    def say(*parts):
        out.append(" ".join(str(p) for p in parts))
        print(out[-1])

    rng = np.random.default_rng(0)
    for arch in ("gemma3-27b", "mamba2-2.7b"):
        cfg = get_arch(arch).with_reduced()
        model = build_model(cfg)
        params = model.init(1, device=device)
        prompt = torch.from_numpy(rng.integers(2, cfg.vocab, (4, 12))).to(device)
        t0 = time.perf_counter()
        gen = greedy_generate(model, params, prompt, max_new_tokens=16)
        dt = time.perf_counter() - t0
        say(f"{arch:14s} prompt={tuple(prompt.shape)} -> generated {tuple(gen.shape)}  "
            f"({dt:.2f}s incl. first-call setup)")
        say("  sample:", gen[0, :8].cpu().numpy())
    return "\n".join(out)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="where the models run (cuda or cpu)")
    main(ap.parse_args().device)
