"""Carry a dataflow and its data, or a model's parameters, across from the
reference package.

``from_reference(dag_dict, tables)`` takes what the reference package's
``api.serialize.dag_to_dict(dag)`` returns (plain JSON-able data) and the
source tables as numpy columns, and returns the port's ``DataflowDAG`` and
``Table``s.  The two packages share the DAG codec, so the carried DAG has
the same operator signatures and content digests, and the same dataflow
runs on the same data in both.

``params_from_reference(tree, device=...)`` takes the reference's
``Model.init`` tree with numpy arrays at the leaves and returns the port's
tree of tensors: the same keys, shapes and dtypes, leaf for leaf.
``opt_state_from_reference`` does the same for the reference's AdamW state
(``{"step", "m", "v"[, "ef"]}``) or a gradient tree.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from repro_torch.core.dag import DataflowDAG
from repro_torch.api.serialize import dag_from_dict
from repro_torch.engine.table import Table


def from_reference(
    dag_dict: Mapping, tables: Mapping[str, Mapping[str, np.ndarray]]
) -> Tuple[DataflowDAG, Dict[str, Table]]:
    """``(dag, {source id: Table})``; each table's columns keep the order
    of the mapping they came in."""
    dag = dag_from_dict(dict(dag_dict))
    return dag, {sid: Table(dict(cols), list(cols)) for sid, cols in tables.items()}


def _tensor(arr) -> torch.Tensor:
    """A tensor that owns a copy of ``arr`` (the reference's buffers are
    read-only, and the port writes caches in place)."""
    arr = np.array(arr, copy=True)
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: same bits as torch's
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def params_from_reference(tree: Mapping[str, Any], device="cuda") -> Dict[str, Any]:
    """The port's parameter tree for the reference's ``tree`` (nested dicts
    of numpy arrays), each leaf a tensor on ``device``."""
    return {k: params_from_reference(v, device) if isinstance(v, Mapping) else _tensor(v).to(device)
            for k, v in tree.items()}


def opt_state_from_reference(state: Mapping[str, Any], device="cuda") -> Dict[str, Any]:
    """The port's AdamW state for the reference's ``state`` (nested dicts of
    numpy arrays; ``step`` a 0-d int32), or the port's gradient tree for the
    reference's gradients, each leaf a tensor on ``device``."""
    return params_from_reference(state, device)
