"""The black-box equivalence verifiers (EVs): Equitas, Spes, UDP and the
traced EV.

The port's roster is ``repro_torch.api.registry.DEFAULT_EV_NAMES``, the
reference package's four.  The traced EV is ``FxEV``, which compares
``torch.fx`` graphs and is registered as ``"jaxpr"``, the reference's name.
"""
from repro_torch.core.ev.base import BaseEV, EVCallCounter, QueryPair, Restriction
from repro_torch.core.ev.cache import CachedEV, CacheEntry, VerdictCache, wrap_evs
from repro_torch.core.ev.equitas import EquitasEV
from repro_torch.core.ev.fx_ev import FxEV
from repro_torch.core.ev.spes import SpesEV, UDPEV


def default_evs(include_jaxpr: bool = True):
    """The default roster's EVs, the traced one (``"jaxpr"``) left out where
    ``include_jaxpr`` is False: a shim over ``repro_torch.api.registry``
    (``default_registry()``, ``DEFAULT_EV_NAMES``), as the reference package
    keeps one.  Imported when called: ``api`` imports this package."""
    from repro_torch.api.registry import DEFAULT_EV_NAMES, default_registry

    names = [n for n in DEFAULT_EV_NAMES if include_jaxpr or n != "jaxpr"]
    return default_registry().build(names)


__all__ = [
    "default_evs",
    "BaseEV",
    "EVCallCounter",
    "QueryPair",
    "Restriction",
    "CachedEV",
    "CacheEntry",
    "VerdictCache",
    "wrap_evs",
    "EquitasEV",
    "FxEV",
    "SpesEV",
    "UDPEV",
]
