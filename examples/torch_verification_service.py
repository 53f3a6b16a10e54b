"""Concurrent verification service on the PyTorch port: many clients, one
verdict store (the twin of ``examples/verification_service.py``).

Four analysts evolve the same multi-branch dataflow chain.  A
``VerificationService`` multiplexes their sessions over a worker pool and
two shared caches — window-level EV verdicts (``VerdictCache``) and
whole-pair verdicts with certificates (``PairVerdictCache``) — so the
first client to verify a pair answers it for everyone, and concurrent
duplicates coalesce onto a single search.  Every verdict stays backed by a
replayable certificate.  The service's sessions would execute on
``--device`` (default ``cuda``, checked at start: without CUDA it raises
unless ``--device cpu`` is given).

    python examples/torch_verification_service.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.api import VeerConfig
from repro_torch.engine.plane.torch_plane import resolve_device
from repro_torch.service import VerificationService
from repro_torch.service.synthetic import make_chain

CONFIG = VeerConfig(evs=("equitas", "spes", "udp"))
CLIENTS = 4


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(what)


def main(device: str = "cuda") -> str:
    """Run the example with the service's sessions on ``device``; returns
    what it printed."""
    resolve_device(device)
    out = []

    def say(*parts):
        out.append(" ".join(str(p) for p in parts))
        print(out[-1])

    versions = make_chain(10)

    with VerificationService(config=CONFIG, workers=4, device=device) as svc:
        # round-robin arrival, like real traffic hitting a shared endpoint
        for v in versions:
            for c in range(CLIENTS):
                svc.submit(f"analyst-{c}", v)
        report = svc.drain()
        say(report.summary())
        say("pair cache:", report.pair_cache_stats)

        # every client's chain is fully decided and certificate-backed
        for cid, chain_report in sorted(report.sessions.items()):
            _check(all(v is True for v in chain_report.verdicts), f"{cid}: a pair is not EQ")
            _check(all(p.certified for p in chain_report.pairs), f"{cid}: a pair is uncertified")
        _check(not report.errors, f"errors: {report.errors}")

        # pairs after the first client's are answered without a search;
        # the reused certificate still replays green against fresh EVs
        reused = [
            p
            for r in report.sessions.values()
            for p in r.pairs
            if p.reused
        ]
        say(f"{len(reused)} pairs reused wholesale from the pair cache")
        _check(bool(reused), "expected cross-client pair reuse")
        audit = reused[-1].certificate.replay()
        say("replaying one reused certificate:", audit.summary())
        _check(audit.ok, "the reused certificate did not replay")

        # the one-shot API shares the same caches
        res = svc.submit_pair(versions[0], versions[1]).result()
        _check(res.equivalent and res.certificate.replay().ok, "submit_pair did not certify EQ")
        say("one-shot submit_pair:", res.summary())
    return "\n".join(out)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="where the sessions execute (cuda or cpu)")
    main(ap.parse_args().device)
