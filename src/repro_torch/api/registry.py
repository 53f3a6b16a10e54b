"""Named EV plugins with capability metadata (the EV roster, one place).

EVs are registered once under their ``BaseEV.name`` with the capability
metadata the verifier's search policy depends on (fragment, restriction
monotonicity, inequivalence power), and every consumer (``VeerConfig.build``,
certificate replay) selects them *by name*.

Selection by name is also what makes certificates auditable: a
``Certificate`` records which EV decided each window, and ``replay`` asks a
registry for a *fresh* instance of that EV — no verdict cache, no search
state — so the replayed verdict is independent of the session that produced
the certificate.  Names are shared with the reference package, so a
certificate written by either package replays in the other.

The port's roster is the reference's: Equitas, Spes, UDP and the traced EV,
which the port traces with ``torch.fx`` (``repro_torch.core.ev.fx_ev``) and
registers under the reference's name, ``"jaxpr"``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, FrozenSet, Iterator, List, Optional, Sequence, Tuple

from repro_torch.core.ev.base import BaseEV

#: Canonical roster order (paper §8 multi-EV setup + the traced EV).
DEFAULT_EV_NAMES: Tuple[str, ...] = ("equitas", "spes", "udp", "jaxpr")


@dataclass(frozen=True)
class EVSpec:
    """One registered EV: a factory plus the capability bits callers and
    the verifier's search policy care about (paper Defs 4.2/4.3, 5.9)."""

    name: str
    factory: Callable[[], BaseEV]
    description: str
    semantics: FrozenSet[str]
    restriction_monotonic: bool
    can_prove_inequivalence: bool
    supported_op_types: FrozenSet[str]

    def create(self) -> BaseEV:
        """A fresh, cache-free instance of this EV."""
        ev = self.factory()
        if ev.name != self.name:
            raise ValueError(
                f"factory for {self.name!r} built an EV named {ev.name!r}"
            )
        return ev


class EVRegistry:
    """Name → ``EVSpec`` map; the single public way to obtain EV instances."""

    def __init__(self) -> None:
        self._specs: Dict[str, EVSpec] = {}

    # -- registration --------------------------------------------------------
    def register(
        self,
        factory: Callable[[], BaseEV],
        *,
        description: str = "",
        replace: bool = False,
    ) -> EVSpec:
        """Register an EV plugin.  Capability metadata is read off a probe
        instance, so a factory is all a plugin author writes."""
        proto = factory()
        name = proto.name
        if name in self._specs and not replace:
            raise ValueError(f"EV {name!r} already registered")
        spec = EVSpec(
            name=name,
            factory=factory,
            description=description or (proto.__doc__ or "").strip().split("\n")[0],
            semantics=frozenset(proto.semantics),
            restriction_monotonic=proto.restriction_monotonic,
            can_prove_inequivalence=proto.can_prove_inequivalence,
            supported_op_types=frozenset(proto.supported_op_types),
        )
        self._specs[name] = spec
        return spec

    # -- lookup --------------------------------------------------------------
    def names(self) -> List[str]:
        return list(self._specs)

    def spec(self, name: str) -> EVSpec:
        try:
            return self._specs[name]
        except KeyError:
            raise KeyError(
                f"unknown EV {name!r}; registered: {sorted(self._specs)}"
            ) from None

    def __contains__(self, name: str) -> bool:
        return name in self._specs

    def __iter__(self) -> Iterator[EVSpec]:
        return iter(self._specs.values())

    def __len__(self) -> int:
        return len(self._specs)

    # -- construction --------------------------------------------------------
    def create(self, name: str) -> BaseEV:
        """A fresh (uncached) instance of the named EV."""
        return self.spec(name).create()

    def build(self, names: Optional[Sequence[str]] = None) -> List[BaseEV]:
        """Fresh instances for ``names`` (default: every EV in registration
        order) — the list ``Veer``/``VeerConfig.build`` consumes."""
        if names is None:
            names = self.names()
        return [self.create(n) for n in names]

    def copy(self) -> "EVRegistry":
        out = EVRegistry()
        out._specs = dict(self._specs)
        return out

    # -- reporting -----------------------------------------------------------
    def capability_table(self) -> str:
        """Human-readable capability matrix (Table-1-style)."""
        header = f"{'ev':<10} {'semantics':<16} {'monotonic':<10} {'ineq':<6} ops"
        lines = [header, "-" * len(header)]
        for spec in self:
            lines.append(
                f"{spec.name:<10} {','.join(sorted(spec.semantics)):<16} "
                f"{str(spec.restriction_monotonic):<10} "
                f"{str(spec.can_prove_inequivalence):<6} "
                f"{len(spec.supported_op_types)}"
            )
        return "\n".join(lines)


_DEFAULT: Optional[EVRegistry] = None


def default_registry() -> EVRegistry:
    """The process-wide registry pre-populated with the canonical roster.

    Callers that need isolation (tests registering toy EVs) should work on
    ``default_registry().copy()`` instead of mutating the shared instance.
    """
    global _DEFAULT
    if _DEFAULT is None:
        from repro_torch.core.ev.equitas import EquitasEV
        from repro_torch.core.ev.fx_ev import FxEV
        from repro_torch.core.ev.spes import SpesEV, UDPEV

        reg = EVRegistry()
        reg.register(
            EquitasEV,
            description="Equitas-style SPJ+OuterJoin+Aggregate EV (R1-R6, "
            "non-monotonic, never proves inequivalence)",
        )
        reg.register(
            SpesEV,
            description="Spes-style SPJ/bag EV (complete on its fragment: "
            "proves inequivalence; monotonic)",
        )
        reg.register(
            UDPEV,
            description="UDP-style EV: Spes fragment plus Union",
        )
        reg.register(
            FxEV,
            description="traced EV: lowers windows to torch.fx graphs over "
            "symbolic tables; handles UDF/Sort windows published EVs reject",
        )
        _DEFAULT = reg
    return _DEFAULT
