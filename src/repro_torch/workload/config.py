"""``WorkloadConfig`` — one validated, serializable edit-session workload.

The adversarial workload generator (``repro_torch.workload.generator``) and the
sustained-traffic replay driver (``repro_torch.workload.replay``) are both driven
by this one plain-data object, mirroring ``repro_torch.api.VeerConfig``: callers
say *what* traffic they want (session count, client concurrency, chain
length, edit-family mix, QPS, seed) and the generator/driver wire the rest.
Because the config is plain data it travels — log it next to a benchmark
row (``BENCH_session.json`` embeds it), ship it to a stress worker, rebuild
the byte-identical workload anywhere from the same seed.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Any, Dict, Tuple

# the edit families the session generator samples from:
#   equivalent   — Calcite-preserving rewrites (repro_torch.workload.workloads)
#   semantic     — TPC-DS-iterative semantic edits (ground truth unknown:
#                  a dropped projection column may be provably unused)
#   boundary     — two empty-filter edits 0-2 hops apart, stressing window
#                  boundary growth (paper Fig 26)
#   rename_storm — equivalence-preserving bulk renames of interior operator
#                  ids with an explicit non-identity EditMapping, stressing
#                  mapping plumbing and rename-invariant fingerprints
#   churn_revert — apply an equivalent edit, revert it, re-apply it with
#                  identical operator ids: the replayed pair is
#                  content-identical to the first and must re-hit the
#                  VerdictCache / PairVerdictCache
#   predicate    — narrow (p ∧ x) or widen (p ∨ x) one FILTER's predicate
#                  in place: the canonical delta-amenable edit
#                  (repro_torch.core.delta); ground truth open, so the pair runs
#                  the same byte-identity oracle as the other families
EDIT_FAMILIES = (
    "equivalent",
    "semantic",
    "boundary",
    "rename_storm",
    "churn_revert",
    "predicate",
)

DEFAULT_EDIT_MIX: Tuple[Tuple[str, float], ...] = (
    ("equivalent", 0.30),
    ("semantic", 0.15),
    ("boundary", 0.15),
    ("rename_storm", 0.10),
    ("churn_revert", 0.15),
    ("predicate", 0.15),
)

DEFAULT_WORKLOADS = ("W1", "W2", "W3", "W4", "W5", "W6", "W7", "W8")


class WorkloadConfigError(ValueError):
    """An invalid ``WorkloadConfig`` (bad mix, unknown workload, bad QPS)."""


@dataclass(frozen=True)
class WorkloadConfig:
    """Declarative description of one sustained edit-session workload.

    ``seed`` fully determines the generated sessions: same config ⇒
    byte-identical version chains, mappings and source tables (the
    determinism regression tests rely on it).
    """

    seed: int = 0
    # traffic shape
    sessions: int = 4          # total edit sessions (one client id each)
    clients: int = 4           # sessions submitted concurrently at a time
    chain_length: int = 6      # versions per session (pairs = length - 1)
    qps: float = 0.0           # global submit rate; 0 = open throttle
    # edit-session grammar
    workloads: Tuple[str, ...] = DEFAULT_WORKLOADS
    edit_mix: Tuple[Tuple[str, float], ...] = DEFAULT_EDIT_MIX
    max_edits_per_version: int = 2
    # differential-oracle environment
    rows: int = 30             # rows per generated source table
    # search budget of the replayed verifier (semantic edits are UNK-heavy;
    # a small budget keeps their exhausted searches cheap)
    max_decompositions: int = 300
    # data plane used by the replayed sessions' execute-with-reuse path:
    # "torch" (the default, like VeerConfig's) or "numpy"; the differential
    # oracle always executes on the numpy plane, so the torch plane turns
    # every replay into a cross-plane identity check
    plane: str = "torch"
    # scale-out: 0 = single-process VerificationService (today's default);
    # N > 0 replays through a VerificationFleet of N worker processes
    fleet: int = 0
    # cache tier the replayed service/fleet shares: "local" (in-process) or
    # "remote" (a FileTier directory; replay creates a temporary one unless
    # the driver is given tier_dir explicitly).  See docs/SCALE_OUT.md.
    shared_tier: str = "local"
    # learned search guidance of the replayed verifiers: "none" (unguided)
    # or "model" (the committed pretrained scorer steers Algorithm 2 —
    # docs/SEARCH_GUIDANCE.md); scheduling-only, so oracle expectations are
    # unchanged
    guidance: str = "none"
    # execute-with-reuse mode of the replayed sessions (when the driver
    # runs the exec-identity oracle): "full" / "reuse" / "delta" — see
    # VeerConfig.exec_mode; sink bytes are mode-invariant, so the oracle's
    # expectations do not change with the mode
    exec_mode: str = "reuse"

    # -- convenience ---------------------------------------------------------
    def replace(self, **changes: Any) -> "WorkloadConfig":
        return dataclasses.replace(self, **changes)

    @property
    def mix(self) -> Dict[str, float]:
        total = sum(w for _, w in self.edit_mix)
        return {name: w / total for name, w in self.edit_mix}

    @property
    def total_pairs(self) -> int:
        return self.sessions * (self.chain_length - 1)

    # -- validation ----------------------------------------------------------
    def validate(self) -> "WorkloadConfig":
        from repro_torch.workload.workloads import WORKLOADS  # late: avoids cycles

        if not isinstance(self.seed, int):
            raise WorkloadConfigError(f"seed must be an int, got {self.seed!r}")
        for f in ("sessions", "clients", "chain_length", "max_edits_per_version",
                  "rows", "max_decompositions"):
            v = getattr(self, f)
            if not isinstance(v, int) or v <= 0:
                raise WorkloadConfigError(f"{f} must be a positive int, got {v!r}")
        if self.chain_length < 2:
            raise WorkloadConfigError("chain_length must be at least 2")
        if not isinstance(self.qps, (int, float)) or self.qps < 0:
            raise WorkloadConfigError(f"qps must be >= 0, got {self.qps!r}")
        if not isinstance(self.fleet, int) or self.fleet < 0:
            raise WorkloadConfigError(
                f"fleet must be a non-negative int, got {self.fleet!r}"
            )
        if self.shared_tier not in ("local", "remote"):
            raise WorkloadConfigError(
                f"shared_tier must be 'local' or 'remote', "
                f"got {self.shared_tier!r}"
            )
        if self.guidance not in ("none", "model"):
            raise WorkloadConfigError(
                f"guidance must be 'none' or 'model', got {self.guidance!r}"
            )
        if self.exec_mode not in ("full", "reuse", "delta"):
            raise WorkloadConfigError(
                f"exec_mode must be 'full', 'reuse' or 'delta', "
                f"got {self.exec_mode!r}"
            )
        if not self.workloads:
            raise WorkloadConfigError("config selects no workloads")
        unknown = [w for w in self.workloads if w not in WORKLOADS]
        if unknown:
            raise WorkloadConfigError(
                f"unknown workloads {unknown}; known: {sorted(WORKLOADS)}"
            )
        if not self.edit_mix:
            raise WorkloadConfigError("edit_mix is empty")
        bad = [n for n, _ in self.edit_mix if n not in EDIT_FAMILIES]
        if bad:
            raise WorkloadConfigError(
                f"unknown edit families {bad}; known: {list(EDIT_FAMILIES)}"
            )
        names = [n for n, _ in self.edit_mix]
        if len(set(names)) != len(names):
            raise WorkloadConfigError(f"duplicate edit families in {names}")
        if any(
            not isinstance(w, (int, float)) or w < 0 for _, w in self.edit_mix
        ) or sum(w for _, w in self.edit_mix) <= 0:
            raise WorkloadConfigError(
                f"edit_mix weights must be >= 0 with a positive sum: "
                f"{self.edit_mix!r}"
            )
        from repro_torch.engine.plane import available_planes  # late: avoids cycles

        if self.plane not in available_planes():
            raise WorkloadConfigError(
                f"plane must be one of {available_planes()}, "
                f"got {self.plane!r}"
            )
        return self

    # -- serialization -------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["workloads"] = list(self.workloads)
        d["edit_mix"] = [[n, w] for n, w in self.edit_mix]
        return d

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "WorkloadConfig":
        known = {f.name for f in dataclasses.fields(WorkloadConfig)}
        unknown = set(d) - known
        if unknown:
            raise WorkloadConfigError(f"unknown config fields {sorted(unknown)}")
        d = dict(d)
        if "workloads" in d:
            d["workloads"] = tuple(d["workloads"])
        if "edit_mix" in d:
            d["edit_mix"] = tuple((n, w) for n, w in d["edit_mix"])
        return WorkloadConfig(**d)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @staticmethod
    def from_json(s: str) -> "WorkloadConfig":
        return WorkloadConfig.from_dict(json.loads(s))


def smoke_config(seed: int = 0) -> WorkloadConfig:
    """The CI stress-smoke profile: ≥200 pairs over ≥4 concurrent clients,
    sized so generation + replay + full differential oracle stay CI-fast."""
    return WorkloadConfig(
        seed=seed,
        sessions=8,
        clients=8,
        chain_length=26,
        workloads=DEFAULT_WORKLOADS,
        max_decompositions=60,
    )


def extended_config(seed: int = 0) -> WorkloadConfig:
    """The nightly-ish profile behind ``workflow_dispatch``: longer chains,
    more sessions, a deeper search budget."""
    return WorkloadConfig(
        seed=seed,
        sessions=16,
        clients=8,
        chain_length=40,
        workloads=DEFAULT_WORKLOADS,
        max_decompositions=300,
    )
