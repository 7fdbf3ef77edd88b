"""Geometric (doubling) AIR — a second toy circuit, used to exercise
mixed-height multi-AIR machine proofs.

One column c; public values [c0, c_last]:
  first row:  c = c0
  transition: c' = 2*c
  last row:   c = c_last
"""

from __future__ import annotations

import numpy as np

from ..fields import babybear as bb
from .air import Air, AirBuilder


class DoublingAir(Air):
    width = 1
    num_public_values = 2

    def eval(self, b: AirBuilder) -> None:
        c0 = b.local(0)
        c1 = b.next(0)
        b.when_first_row().assert_eq(c0, b.public_value(0))
        b.when_transition().assert_eq(c1, b.add(c0, c0))
        b.when_last_row().assert_eq(c0, b.public_value(1))

    def generate_trace(self, log_n: int, c0: int = 3):
        n = 1 << log_n
        trace = np.zeros((n, 1), dtype=np.uint32)
        c = c0 % bb.P
        for i in range(n):
            trace[i, 0] = c
            c = (2 * c) % bb.P
        return trace, [c0 % bb.P, int(trace[n - 1, 0])]
