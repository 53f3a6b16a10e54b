"""The port's ``repro_torch.core.ev.default_evs`` shim against the reference
package's (``repro.core.ev.default_evs``): the same EV names in the same
order, with and without the traced EV, built through the port's registry."""

import pytest

from repro_torch.api.registry import DEFAULT_EV_NAMES
from repro_torch.core.ev import BaseEV, default_evs


@pytest.mark.parametrize("include_jaxpr", [True, False])
def test_default_evs_names_are_the_references(include_jaxpr):
    pytest.importorskip("jax")
    from repro.core.ev import default_evs as ref_default_evs

    want = [ev.name for ev in ref_default_evs(include_jaxpr=include_jaxpr)]
    assert [ev.name for ev in default_evs(include_jaxpr=include_jaxpr)] == want


def test_default_evs_routes_through_the_registry():
    evs = default_evs()
    assert tuple(ev.name for ev in evs) == DEFAULT_EV_NAMES
    assert all(isinstance(ev, BaseEV) for ev in evs)
    assert [ev.name for ev in default_evs(include_jaxpr=False)] == [n for n in DEFAULT_EV_NAMES if n != "jaxpr"]
    # each call builds fresh EVs, as the reference's does
    assert all(a is not b for a, b in zip(evs, default_evs()))
