"""``VeerConfig`` — one validated, serializable object describing a verifier.

Replaces the ``Veer(...)``-vs-``make_veer_plus(**kw)`` split: callers say
*what* they want (EV names, optimization flags, budgets, cache location,
semantics) and ``build()`` wires the actual ``Veer`` — EVs resolved through
an ``EVRegistry``, the verdict cache attached.  Because the config is plain
data it travels: log it next to a benchmark row, ship it to a worker, store
it beside a certificate, rebuild the identical verifier anywhere.

The port's config has every field of the reference package's, so a config
round-trips through JSON between the two.  Its ``to_json()`` differs from
the reference's default only in ``plane`` (the port's data planes are
``numpy`` and ``torch``, and it runs on the card unless asked otherwise).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

from repro_torch.api.registry import DEFAULT_EV_NAMES, EVRegistry, default_registry
from repro_torch.core import dag as D
from repro_torch.core.ev.cache import VerdictCache
from repro_torch.core.verifier import SEARCH_BACKENDS, Veer

_FLAG_FIELDS = (
    "segmentation",
    "pruning",
    "ranking",
    "fast_inequivalence",
    "relaxed_expansion",
    "eager_verify",
    "try_all_mappings",
)
_BUDGET_FIELDS = ("max_decompositions", "max_windows", "mapping_limit")


class ConfigError(ValueError):
    """An invalid ``VeerConfig`` (unknown EV, bad budget, bad semantics)."""


@dataclass(frozen=True)
class VeerConfig:
    """Declarative verifier description.  The default is Veer⁺ (§7 + §8
    optimizations on), the recommended production setting; ``baseline()``
    gives the paper's unoptimized Veer for ablations."""

    evs: Tuple[str, ...] = DEFAULT_EV_NAMES
    # §7/§8 optimization flags (Veer⁺ defaults)
    segmentation: bool = True
    pruning: bool = True
    ranking: bool = True
    fast_inequivalence: bool = True
    relaxed_expansion: bool = False
    eager_verify: bool = True
    try_all_mappings: bool = True
    # search budgets
    max_decompositions: int = 50_000
    max_windows: int = 200_000
    mapping_limit: int = 8
    # window-dispatch worker pool: 1 = sequential; N > 1 checks the windows
    # of each candidate decomposition concurrently (verdicts are committed
    # in deterministic order, so certificates match the sequential run)
    max_workers: int = 1
    # decomposition-search representation: "bitmask" (interned integer
    # windows, the fast kernel) or "reference" (retained frozenset search —
    # the semantics oracle used by tests and benchmarks)
    search_backend: str = "bitmask"
    # environment
    semantics: str = D.BAG
    # data plane executing operators when this config drives execution:
    # "torch" = the CUDA data plane (the default), "numpy" = the host
    # reference; a pure performance choice — sink bytes are plane-invariant
    plane: str = "torch"
    # how execute-with-reuse submits run each certified successor version:
    # "full" = unseeded re-execution (ablation baseline); "reuse" = recompute
    # only the changed cone, seeded from the exact-tier frontier;
    # "delta" = additionally propagate row/column deltas through amenable
    # changed cones, falling back to "reuse" whenever the edit is not
    # delta-amenable — sink bytes are mode-invariant
    exec_mode: str = "reuse"
    cache_path: Optional[str] = None
    # LRU bound on the verdict/validity tables of the cache this config
    # creates (None = unbounded); applies to caches built from cache_path —
    # an explicitly passed cache keeps its own bound
    cache_max_entries: Optional[int] = None
    # shared second-level cache tier behind the in-process caches:
    # "local" (in-process dicts — single-process behavior, the default) or
    # "remote" (a FileTier directory shared by every worker process of a
    # VerificationFleet; see docs/SCALE_OUT.md)
    shared_tier: str = "local"
    tier_dir: Optional[str] = None          # required when shared_tier="remote"
    tier_ttl_seconds: Optional[float] = None    # remote entry TTL (None = keep)
    tier_byte_budget: Optional[int] = None      # remote payload bound (bytes)
    # learned search guidance (docs/SEARCH_GUIDANCE.md): "none" = unguided
    # Algorithm 2; "model" = the featurized scorer reorders the best-first
    # frontier and the per-window EV attempt order.  Guidance only schedules
    # work — certificates still gate every verdict — so it can change how
    # fast a search certifies, never what it certifies.
    guidance: str = "none"
    guidance_path: Optional[str] = None     # None = the committed pretrained.json

    # -- presets -------------------------------------------------------------
    @staticmethod
    def plus(**overrides: Any) -> "VeerConfig":
        """Veer⁺ — all optimizations on (same as the bare default)."""
        return VeerConfig(**overrides)

    @staticmethod
    def baseline(**overrides: Any) -> "VeerConfig":
        """The paper's unoptimized Veer (Algorithms 1-3, no §7 flags)."""
        base = dict.fromkeys(_FLAG_FIELDS, False)
        base.update(overrides)
        return VeerConfig(**base)

    def replace(self, **changes: Any) -> "VeerConfig":
        return dataclasses.replace(self, **changes)

    # -- validation ----------------------------------------------------------
    def validate(self, registry: Optional[EVRegistry] = None) -> "VeerConfig":
        registry = registry if registry is not None else default_registry()
        if not self.evs:
            raise ConfigError("config selects no EVs")
        unknown = [n for n in self.evs if n not in registry]
        if unknown:
            raise ConfigError(
                f"unknown EVs {unknown}; registered: {sorted(registry.names())}"
            )
        if len(set(self.evs)) != len(self.evs):
            raise ConfigError(f"duplicate EV names in {self.evs}")
        for f in _BUDGET_FIELDS + ("max_workers",):
            v = getattr(self, f)
            if not isinstance(v, int) or v <= 0:
                raise ConfigError(f"{f} must be a positive int, got {v!r}")
        if self.cache_max_entries is not None and (
            not isinstance(self.cache_max_entries, int)
            or self.cache_max_entries <= 0
        ):
            raise ConfigError(
                f"cache_max_entries must be a positive int or None, "
                f"got {self.cache_max_entries!r}"
            )
        if self.search_backend not in SEARCH_BACKENDS:
            raise ConfigError(
                f"search_backend must be one of {SEARCH_BACKENDS}, "
                f"got {self.search_backend!r}"
            )
        if self.semantics not in (D.SET, D.BAG, D.ORDERED):
            raise ConfigError(f"bad semantics {self.semantics!r}")
        if self.shared_tier not in ("local", "remote"):
            raise ConfigError(
                f"shared_tier must be 'local' or 'remote', "
                f"got {self.shared_tier!r}"
            )
        if self.shared_tier == "remote" and self.tier_dir is None:
            raise ConfigError("shared_tier='remote' requires tier_dir")
        if self.tier_ttl_seconds is not None and not (
            isinstance(self.tier_ttl_seconds, (int, float))
            and self.tier_ttl_seconds > 0
        ):
            raise ConfigError(
                f"tier_ttl_seconds must be positive or None, "
                f"got {self.tier_ttl_seconds!r}"
            )
        if self.tier_byte_budget is not None and not (
            isinstance(self.tier_byte_budget, int) and self.tier_byte_budget > 0
        ):
            raise ConfigError(
                f"tier_byte_budget must be a positive int or None, "
                f"got {self.tier_byte_budget!r}"
            )
        if self.guidance not in ("none", "model"):
            raise ConfigError(
                f"guidance must be 'none' or 'model', got {self.guidance!r}"
            )
        if self.guidance == "none" and self.guidance_path is not None:
            raise ConfigError(
                "guidance_path requires guidance='model' "
                f"(got guidance={self.guidance!r})"
            )
        from repro_torch.engine.plane import available_planes  # late: avoid cycle

        if self.plane not in available_planes():
            raise ConfigError(
                f"plane must be one of {available_planes()}, "
                f"got {self.plane!r}"
            )
        if self.exec_mode not in ("full", "reuse", "delta"):
            raise ConfigError(
                f"exec_mode must be 'full', 'reuse' or 'delta', "
                f"got {self.exec_mode!r}"
            )
        return self

    # -- construction --------------------------------------------------------
    def build(
        self,
        registry: Optional[EVRegistry] = None,
        *,
        cache: Optional[VerdictCache] = None,
    ) -> Veer:
        """A ready ``Veer``: EVs resolved by name, verdict cache attached.

        An explicit ``cache`` wins over ``cache_path`` (so many verifiers can
        share one in-memory store); with neither, the verifier runs uncached.
        """
        registry = registry if registry is not None else default_registry()
        self.validate(registry)
        if cache is None and self.cache_path is not None:
            cache = VerdictCache(
                self.cache_path, max_entries=self.cache_max_entries
            )
        guidance = None
        if self.guidance == "model":
            from repro_torch.learn import load_guidance  # late: learn -> core -> api

            guidance = load_guidance(self.guidance_path)
        return Veer(
            registry.build(list(self.evs)),
            **{f: getattr(self, f) for f in _FLAG_FIELDS},
            **{f: getattr(self, f) for f in _BUDGET_FIELDS},
            max_workers=self.max_workers,
            verdict_cache=cache,
            search_backend=self.search_backend,
            guidance=guidance,
        )

    # -- serialization -------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["evs"] = list(self.evs)
        return d

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "VeerConfig":
        known = {f.name for f in dataclasses.fields(VeerConfig)}
        unknown = set(d) - known
        if unknown:
            raise ConfigError(f"unknown config fields {sorted(unknown)}")
        d = dict(d)
        if "evs" in d:
            d["evs"] = tuple(d["evs"])
        return VeerConfig(**d)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @staticmethod
    def from_json(s: str) -> "VeerConfig":
        return VeerConfig.from_dict(json.loads(s))
