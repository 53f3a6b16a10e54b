"""The dataflow model: DAGs of operators with linear-predicate properties."""
from repro_torch.core.dag import DataflowDAG, Link, Operator
from repro_torch.core.predicates import LinCmp, LinExpr, Pred

__all__ = ["DataflowDAG", "Link", "Operator", "LinCmp", "LinExpr", "Pred"]
