"""AIR (Algebraic Intermediate Representation) interface.

The same constraint-definition code runs in two modes:

- `LdeBuilder`: values are (m,) int32 tensors over the whole LDE domain
  (the prover's quotient pass, plain torch on the tensors' device). Given
  alpha, it folds each constraint into sum_i alpha^i c_i as it arrives, so
  no stack of all constraint columns is ever held.
- `PointBuilder`: values are extension elements at the out-of-domain point
  zeta, as canonical python ints (the verifier's re-evaluation, host only).
- `TraceBuilder`: an `LdeBuilder` over the raw trace (blowup 1, exact 0/1
  selectors) that keeps only the declared bus interactions: the machine
  prover reads each interaction's field and multiplicity vectors from it.

An Air subclass defines `width`, optional `num_public_values`, and
`eval(builder)`; all arithmetic goes through the builder. Constraint degree
must stay <= MAX_DEGREE = 3 (the log_blowup = 1 budget).
"""

from __future__ import annotations

from typing import Any, List

import numpy as np
import torch

from ..fields import babybear as bb
from ..fields import ext4
from ..utils import ext_np

MAX_DEGREE = 3
LOG_QUOTIENT_DEGREE = 1  # the quotient splits into 2 chunks for degree-3 AIRs


class Air:
    """Base class for constraint systems."""

    width: int = 0
    num_public_values: int = 0

    def eval(self, b: "AirBuilder") -> None:
        raise NotImplementedError

    def preprocessed_trace(self):
        """Verifier-known fixed columns: a canonical uint32 (n, width) numpy
        array, or None. The machine prover commits them on their own; the
        verifier recomputes that commitment from this method."""
        return None

    def generate_trace(self, *args, **kwargs) -> np.ndarray:
        raise NotImplementedError


class Interaction:
    """One logUp bus interaction declared by an AIR during eval(): a message
    (`fields`) sent or received on `bus` with multiplicity `mult`. The
    machine prover proves buses; the single-AIR prover ignores them."""

    def __init__(self, bus: int, fields, mult, is_send: bool):
        self.bus = bus
        self.fields = list(fields)
        self.mult = mult
        self.is_send = is_send


class AirBuilder:
    """Common builder API. Subclasses provide field ops + variable access."""

    def local(self, col: int):
        raise NotImplementedError

    def next(self, col: int):
        raise NotImplementedError

    def preprocessed(self, col: int):
        raise NotImplementedError

    def preprocessed_next(self, col: int):
        raise NotImplementedError

    def public_value(self, i: int):
        raise NotImplementedError

    @property
    def is_first_row(self):
        return self._sels["first"]

    @property
    def is_last_row(self):
        return self._sels["last"]

    @property
    def is_transition(self):
        return self._sels["transition"]

    def add(self, a, b):
        raise NotImplementedError

    def sub(self, a, b):
        raise NotImplementedError

    def mul(self, a, b):
        raise NotImplementedError

    def constant(self, v: int):
        """Canonical integer -> field value."""
        raise NotImplementedError

    def push_send(self, bus: int, fields, mult):
        self._interactions.append(Interaction(bus, fields, mult, True))

    def push_receive(self, bus: int, fields, mult):
        self._interactions.append(Interaction(bus, fields, mult, False))

    @property
    def interactions(self):
        return self._interactions

    def assert_zero(self, expr):
        self._constraints.append(expr)

    def assert_eq(self, a, b):
        self.assert_zero(self.sub(a, b))

    def assert_bool(self, a):
        self.assert_zero(self.mul(a, self.sub(a, self.constant(1))))

    def when(self, condition):
        return _Filtered(self, condition)

    def when_first_row(self):
        return _Filtered(self, self.is_first_row)

    def when_last_row(self):
        return _Filtered(self, self.is_last_row)

    def when_transition(self):
        return _Filtered(self, self.is_transition)

    @property
    def constraints(self):
        return self._constraints


class _Filtered:
    """builder.when(c).assert_zero(e) registers c * e."""

    def __init__(self, b: AirBuilder, condition):
        self.b = b
        self.condition = condition

    def assert_zero(self, expr):
        self.b.assert_zero(self.b.mul(self.condition, expr))

    def assert_eq(self, a, bb_):
        self.assert_zero(self.b.sub(a, bb_))

    def assert_bool(self, a):
        self.assert_zero(self.b.mul(a, self.b.sub(a, self.b.constant(1))))


def base_col(x):
    """A base value against (n, 4): (n, 1) for a tensor, a constant as is."""
    return x[:, None] if isinstance(x, torch.Tensor) else x


class LdeBuilder(AirBuilder):
    """Evaluation over the LDE domain (the prover's quotient pass).

    lde: (m, w) int32 tensor; columns are read from one (w, m) contiguous
    copy, and next(col) rolls one column by `blowup` rows; pre_lde, if given,
    holds the preprocessed columns alike. sels: dict of (m,) tensors;
    public_values: Montgomery ints. With `alpha` (a (4,) ext tensor),
    constraints fold into `folded` = sum_i alpha^i c_i, (m, 4), as they
    arrive (`assert_zero_ext` folds an (m, 4) extension constraint); without
    it they are kept in `constraints`.
    """

    def __init__(self, lde, blowup: int, sels, public_values, alpha=None,
                 pre_lde=None):
        self._cols = lde.t().contiguous()
        self._pre = None if pre_lde is None else pre_lde.t().contiguous()
        self._blowup = blowup
        self._sels = sels
        self._pvs = [int(v) for v in public_values]
        self._constraints: List[Any] = []
        self._interactions: List[Interaction] = []
        self._alpha = alpha
        self._alpha_pows = None
        self.num_constraints = 0
        self.folded = None

    def local(self, col):
        return self._cols[col]

    def next(self, col):
        return torch.roll(self._cols[col], -self._blowup)

    def preprocessed(self, col):
        return self._pre[col]

    def preprocessed_next(self, col):
        return torch.roll(self._pre[col], -self._blowup)

    def public_value(self, i):
        return self._pvs[i]

    # Constants and public values are Montgomery python ints; an operation
    # on two of them stays a python int.
    def add(self, a, b):
        if isinstance(a, int) and isinstance(b, int):
            return (a + b) % bb.P
        return bb.add(a, b)

    def sub(self, a, b):
        if isinstance(a, int) and isinstance(b, int):
            return (a - b) % bb.P
        return bb.sub(a, b)

    def mul(self, a, b):
        if isinstance(a, int) and isinstance(b, int):
            return a * b * bb.R_INV % bb.P
        return bb.mul(a, b)

    def constant(self, v):
        return bb.to_monty_int(int(v) % bb.P)

    def _fold(self, term_of):
        i = self.num_constraints
        if self._alpha_pows is None or i >= self._alpha_pows.shape[0]:
            size = 256 if self._alpha_pows is None else 2 * self._alpha_pows.shape[0]
            self._alpha_pows = ext4.powers(self._alpha, size)
        term = term_of(self._alpha_pows[i])
        self.folded = term if self.folded is None else bb.add(self.folded, term)
        self.num_constraints += 1

    def assert_zero(self, expr):
        if self._alpha is None:
            self._constraints.append(expr)
        else:
            self._fold(lambda a: bb.mul(base_col(expr), a))

    def assert_zero_ext(self, expr):
        """An extension-valued (m, 4) constraint (the logUp constraints),
        next on the same alpha ladder."""
        if self._alpha is None:
            self._constraints.append(expr)
        else:
            self._fold(lambda a: ext4.mul(expr, a))


class TraceBuilder(LdeBuilder):
    """Evaluation over the raw trace domain H (blowup 1) that keeps only the
    interactions: their field and multiplicity vectors, (n,) tensors, feed
    the logUp permutation trace. Selectors are exact 0/1 indicator rows;
    constraints are dropped as they arrive.

    trace_m: (n, w) Montgomery int32 tensor; pre_m alike, or None."""

    def __init__(self, trace_m, public_values, pre_m=None):
        n = int(trace_m.shape[0])
        dev = trace_m.device
        first = torch.zeros(n, dtype=bb.DTYPE, device=dev)
        first[0] = bb.ONE
        last = torch.zeros(n, dtype=bb.DTYPE, device=dev)
        last[-1] = bb.ONE
        transition = torch.full((n,), bb.ONE, dtype=bb.DTYPE, device=dev)
        transition[-1] = 0
        sels = {"first": first, "last": last, "transition": transition}
        super().__init__(trace_m, 1, sels, public_values, pre_lde=pre_m)

    def assert_zero(self, expr):
        pass


class PointBuilder(AirBuilder):
    """Extension-field evaluation at one out-of-domain point (verifier).

    local/next (and pre/pre_next, the preprocessed columns, if any): per
    column canonical ext values (4 python ints); sels: dict of canonical ext
    values; public_values: canonical ints."""

    def __init__(self, local_ext, next_ext, sels_ext, public_values,
                 pre_ext=None, pre_next_ext=None):
        self._local = local_ext
        self._next = next_ext
        self._pre = pre_ext
        self._pre_next = pre_next_ext
        self._sels = sels_ext
        self._pvs = [int(v) for v in public_values]
        self._constraints: List[Any] = []
        self._interactions: List[Interaction] = []

    def local(self, col):
        return self._local[col]

    def next(self, col):
        return self._next[col]

    def preprocessed(self, col):
        return self._pre[col]

    def preprocessed_next(self, col):
        return self._pre_next[col]

    def public_value(self, i):
        return ext_np.from_base(self._pvs[i])

    def add(self, a, b):
        return ext_np.add(a, b)

    def sub(self, a, b):
        return ext_np.sub(a, b)

    def mul(self, a, b):
        return ext_np.mul(a, b)

    def constant(self, v):
        return ext_np.from_base(int(v))
