"""Range-check lookup pair: the canonical logUp test circuit.

`RangeCheckedAir` sends each trace value to bus 1; `RangeTableAir` holds the
table [0, n) and receives with a multiplicity column. The machine proof only
verifies if every sent value appears in the table with matching total
multiplicity — the same send/receive bus structure openvm uses between VM
chips and its range-checker chip (SURVEY.md §2.2 "VM extension AIRs").
"""

from __future__ import annotations

import numpy as np

from ..fields import babybear as bb
from .air import Air, AirBuilder

RANGE_BUS = 1


class RangeTableAir(Air):
    """Columns: [value, multiplicity]. value is constrained to be the row
    counter (value_first = 0, value_next = value + 1)."""

    width = 2
    num_public_values = 0

    def eval(self, b: AirBuilder) -> None:
        v = b.local(0)
        v_next = b.next(0)
        mult = b.local(1)
        b.when_first_row().assert_zero(v)
        b.when_transition().assert_eq(v_next, b.add(v, b.constant(1)))
        b.push_receive(RANGE_BUS, [v], mult)

    def generate_trace(self, log_n: int, lookups) -> np.ndarray:
        n = 1 << log_n
        trace = np.zeros((n, 2), dtype=np.uint32)
        trace[:, 0] = np.arange(n, dtype=np.uint32)
        counts = np.bincount(np.asarray(lookups), minlength=n)
        assert len(counts) <= n, "lookup value out of table range"
        trace[: len(counts), 1] = counts.astype(np.uint32)
        return trace


class RangeCheckedAir(Air):
    """One column of values, each sent to the range bus with multiplicity 1."""

    width = 1
    num_public_values = 0

    def eval(self, b: AirBuilder) -> None:
        x = b.local(0)
        b.push_send(RANGE_BUS, [x], b.constant(1))

    def generate_trace(self, values) -> np.ndarray:
        values = np.asarray(values, dtype=np.uint32)
        n = len(values)
        assert n & (n - 1) == 0
        return values.reshape(n, 1)
