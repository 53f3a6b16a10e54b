#!/usr/bin/env python3
"""Time the PyTorch port's hot chain on the card for one checkout: the
torch-plane run that phase 4 of ``chip_smoke.py`` reports, repeated.

    python3 scripts/torch_hot_chain_ab.py --root DIR [--reps 7] [--label NAME]

It imports DIR's own ``chip_smoke.py`` and ``src/`` (so DIR may be an
unpacked ``git archive`` of another commit), builds the kernels there at
first use, warms up at full size on other data, checks once that every sink
is ``tables_identical`` to the numpy plane's, then times
``ExecutionPlan(dag, sources).run()`` ``--reps`` times and prints one JSON
line: each run's seconds, their median, and the relational launches of one
run.  To compare two commits, run it once per checkout, each in its own
process and all on the same card in one sitting, in the order parent, change,
change, parent.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True, help="checkout whose chip_smoke.py and src/ to run")
    ap.add_argument("--reps", type=int, default=7, help="timed runs of the hot chain")
    ap.add_argument("--label", default="", help="name printed with the result")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_hot_chain_ab: needs a CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, os.path.join(root, "src"))
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test",
                                                  os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    from repro_torch.engine import ExecutionPlan, execute
    from repro_torch.kernels import relational as R

    dag = smoke.hot_chain()
    sources = smoke.hot_sources(smoke.MAIN_ROWS)
    execute(dag, smoke.hot_sources(smoke.MAIN_ROWS, seed=1))  # first-use costs, kernels built
    smoke._all_identical(execute(dag, sources, plane="numpy"), execute(dag, sources), "hot chain")

    seconds = []
    by_instance = getattr(R.relational, "launches_by_instance", {})
    for _ in range(args.reps):
        R.relational.launches = 0
        by_instance.update(dict.fromkeys(by_instance, 0))
        t0 = time.perf_counter()
        ExecutionPlan(dag, sources).run()
        seconds.append(time.perf_counter() - t0)
    print(json.dumps({"label": args.label, "root": args.root, "rows": smoke.MAIN_ROWS,
                      "torch_s": seconds, "median_s": statistics.median(seconds),
                      "relational_launches": R.relational.launches,
                      "by_instance": by_instance or None}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
