"""Chain verification with memoized EV verdicts on the PyTorch port (the
twin of ``examples/chain_session.py``).

An analyst session: ten versions of a multi-branch analytics dataflow, each
1-2 edits apart.  The ``VersionChainSession`` verifies every consecutive
pair; its verdict cache makes pair k cheaper than pair 1, and a second
session restored from the persisted cache file verifies the whole chain
without a single EV call — yet every warm verdict still carries a
certificate that replays green against fresh EVs.  Verification runs on
the host; the sessions would execute on ``--device`` (default ``cuda``,
checked at start: without CUDA it raises unless ``--device cpu`` is given).

    python examples/torch_chain_session.py [--device cpu]
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.api import VeerConfig
from repro_torch.engine.plane.torch_plane import resolve_device
from repro_torch.service import VersionChainSession
from repro_torch.service.synthetic import make_chain

CONFIG = VeerConfig(evs=("equitas", "spes", "udp"))


def main(device: str = "cuda") -> str:
    """Run the example with sessions on ``device``; returns what it printed."""
    resolve_device(device)
    out = []

    def say(*parts):
        out.append(" ".join(str(p) for p in parts))
        print(out[-1])

    with tempfile.TemporaryDirectory(prefix="veer_verdicts_") as tmp:
        cache_path = os.path.join(tmp, "verdicts.json")
        versions = make_chain(10)

        say("-- session 1 (cold cache) --")
        with VersionChainSession(
            config=CONFIG.replace(cache_path=cache_path), device=device
        ) as session:
            for v in versions:
                session.submit(v)
            say(session.report().summary())

        say("\n-- session 2 (warm: verdicts restored from disk) --")
        session2 = VersionChainSession(config=CONFIG.replace(cache_path=cache_path), device=device)
        for v in versions:
            session2.submit(v)
        report = session2.report()
        say(report.summary())
        if report.total_ev_calls != 0:
            raise RuntimeError(f"the warm session made {report.total_ev_calls} EV calls")
        # zero EV calls, yet fully auditable: replay one warm certificate
        cert = report.pairs[-1].certificate
        say("\nauditing last warm pair:", cert.summary())
        audit = cert.replay()
        say(audit.summary())
        if not audit.ok:
            raise RuntimeError("the warm certificate did not replay")
    return "\n".join(out)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="where the sessions execute (cuda or cpu)")
    main(ap.parse_args().device)
