"""The black-box equivalence verifiers (EVs): Equitas, Spes and UDP.

The port's roster is ``repro_torch.api.registry.DEFAULT_EV_NAMES``; the
reference package's fourth EV, the JAX-traced one, has no counterpart here
yet, so the default roster holds these three.
"""
from repro_torch.core.ev.base import BaseEV, EVCallCounter, QueryPair, Restriction
from repro_torch.core.ev.cache import CachedEV, CacheEntry, VerdictCache, wrap_evs
from repro_torch.core.ev.equitas import EquitasEV
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
    "SpesEV",
    "UDPEV",
]
