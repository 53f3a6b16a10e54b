"""The port's example twins (``examples/torch_*.py``) on the CPU, at their
reference examples' sizes.

Each twin's ``main(device="cpu")`` runs to its end and returns what it
printed.  Where the reference example's output is deterministic apart from
its clock (quickstart, chain session, iterative analytics), the twin must
print the same lines once every time is masked: the same verdicts, search
statistics, certificates, document counts and reuse counters.  The
service's per-client lines depend on which thread searches first, so its
twin is held to its own invariants; the serving twin to its shapes.
"""

import importlib.util
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
_TIME = re.compile(r" *\d+\.\d+ ?m?s\b")  # a time and the padding its format put before it


def _load(name):
    spec = importlib.util.spec_from_file_location(f"_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _masked(text):
    return [_TIME.sub("<time>", line) for line in text.strip().splitlines()]


@pytest.mark.parametrize("name", ["quickstart", "chain_session", "iterative_analytics"])
def test_twin_prints_what_the_reference_example_prints(name, capsys):
    _load(name).main()
    want = capsys.readouterr().out
    got = _load(f"torch_{name}").main(device="cpu")
    assert got.strip() == capsys.readouterr().out.strip()  # it returns what it printed
    assert _masked(got) == _masked(want)


def test_analytics_twin_reuses_two_sinks_and_executes_twice():
    out = _load("torch_iterative_analytics").main(device="cpu")
    assert "4 versions, 2 sinks reused, 2 executions" in out
    assert out.count("replay OK") == 2


def test_service_twin_answers_every_client_from_one_store():
    out = _load("torch_verification_service").main(device="cpu")
    assert "service: 36 pairs (36 certified" in out and ", 0 errors" in out
    assert "pairs reused wholesale from the pair cache" in out
    assert "replaying one reused certificate: replay OK" in out
    assert "one-shot submit_pair: EQ" in out


def test_serve_twin_generates_for_both_cache_disciplines():
    out = _load("torch_serve_decode").main(device="cpu")
    for arch in ("gemma3-27b", "mamba2-2.7b"):
        assert re.search(rf"^{arch}\s+prompt=\(4, 12\) -> generated \(4, 16\)", out, re.M), out
