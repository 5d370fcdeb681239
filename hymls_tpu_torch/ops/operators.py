"""Operator composition utilities.

Torch counterpart of hymls_tpu/ops/operators.py, the equivalents of the
reference's small operator adapters:
  * ShiftedOperator (src/HYMLS_ShiftedOperator.{hpp,cpp}):
    y = (a A + b B) x, used for eigenvalue shifts;
  * ProductOperator (src/HYMLS_EpetraExt_ProductOperator.{hpp,cpp}):
    y = Op_1 Op_2 ... Op_k x (used e.g. to form P^{-1} M for
    deflation);
  * ProjectedOperator (src/HYMLS_ProjectedOperator.{hpp,cpp}):
    (I - V W') A (I - V W').

These are plain closures over callables that take and return tensors;
V and W are tensors of the vectors' dtype and device.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch


def shifted_operator(opA: Callable, opB: Optional[Callable] = None,
                     shift_a: float = 1.0, shift_b: float = 0.0) -> Callable:
    """x -> shift_a * A x + shift_b * B x (B=None means identity)."""
    def apply(x):
        y = shift_a * opA(x)
        if shift_b != 0.0:
            y = y + shift_b * (opB(x) if opB is not None else x)
        return y
    return apply


def product_operator(*ops: Callable) -> Callable:
    """x -> Op_1(Op_2(...Op_k(x)))."""
    def apply(x):
        for op in reversed(ops):
            x = op(x)
        return x
    return apply


def projected_operator(op: Callable, V: torch.Tensor,
                       W: Optional[torch.Tensor] = None) -> Callable:
    """x -> (I - V W') A (I - V W') x (W=None means W:=V; V orthonormal
    columns assumed, as in the reference's deflation use)."""
    Wm = V if W is None else W

    def proj(x):
        return x - V @ (Wm.T @ x)

    def apply(x):
        return proj(op(proj(x)))
    return apply
