"""Symbolic AIR evaluation: serialize a constraint system to a canonical
felt stream.

Runs `Air.eval` with a builder whose values are hash-consed expression
nodes, then flattens the DAG (ops, constraint roots, interactions) into a
list of BabyBear felts. Used to derive verification-key commitments that
bind the *actual constraint structure* — changing any constraint, constant,
selector use, or bus wiring changes the serialization. The port's copy of
the reference's `zkvm_prover_tpu/models/symbolic.py`: the same stream, so
the same verification-key digests.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from ..fields import babybear as bb
from .air import Air, AirBuilder

P = bb.P

# node opcodes
_LOCAL, _NEXT, _PRE, _PRE_NEXT, _PV = 1, 2, 3, 4, 5
_SEL_FIRST, _SEL_LAST, _SEL_TRANS = 6, 7, 8
_CONST, _ADD, _SUB, _MUL = 9, 10, 11, 12


class _Node(int):
    """Expression node id (int subclass so felt-like use fails loudly)."""


class SymbolicBuilder(AirBuilder):
    """Records the expression DAG with hash-consing (identical subtrees
    share one node, so serialization is canonical for a given eval)."""

    def __init__(self):
        self._nodes: List[Tuple[int, int, int]] = []
        self._memo: Dict[Tuple[int, int, int], _Node] = {}
        self._constraints: List[_Node] = []
        self._interactions: List = []

    def _emit(self, op: int, a: int = 0, c: int = 0) -> _Node:
        key = (op, a, c)
        if key in self._memo:
            return self._memo[key]
        node = _Node(len(self._nodes))
        self._nodes.append(key)
        self._memo[key] = node
        return node

    def local(self, col):
        return self._emit(_LOCAL, col)

    def next(self, col):
        return self._emit(_NEXT, col)

    def preprocessed(self, col):
        return self._emit(_PRE, col)

    def preprocessed_next(self, col):
        return self._emit(_PRE_NEXT, col)

    def public_value(self, i):
        return self._emit(_PV, i)

    @property
    def is_first_row(self):
        return self._emit(_SEL_FIRST)

    @property
    def is_last_row(self):
        return self._emit(_SEL_LAST)

    @property
    def is_transition(self):
        return self._emit(_SEL_TRANS)

    def constant(self, v):
        return self._emit(_CONST, int(v) % P)

    def add(self, a, b):
        return self._emit(_ADD, self._as_node(a), self._as_node(b))

    def sub(self, a, b):
        return self._emit(_SUB, self._as_node(a), self._as_node(b))

    def mul(self, a, b):
        return self._emit(_MUL, self._as_node(a), self._as_node(b))

    def _as_node(self, x) -> _Node:
        if isinstance(x, _Node):
            return x
        return self._emit(_CONST, int(x) % P)


def serialize_air(air: Air) -> List[int]:
    """Canonical felt stream for the AIR's constraint system."""
    b = SymbolicBuilder()
    air.eval(b)
    pre = air.preprocessed_trace()
    felts: List[int] = [
        air.width,
        air.num_public_values,
        0 if pre is None else int(pre.shape[1]),
        len(b._nodes),
        len(b._constraints),
        len(b._interactions),
    ]
    for (op, a, c) in b._nodes:
        felts += [op, int(a) % P, int(c) % P]
    for n in b._constraints:
        felts.append(int(n))
    for inter in b._interactions:
        felts += [
            inter.bus,
            1 if inter.is_send else 0,
            len(inter.fields),
            int(b._as_node(inter.mult)),
        ]
        felts += [int(b._as_node(f)) for f in inter.fields]
    return felts
