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

__all__ = [
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
