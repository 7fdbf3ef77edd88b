"""Constraint and bus debugging (the reference's `zkvm_prover_tpu/stark/
debug.py` over the port's builders; the openvm `debug_constraints` analog).

- check_constraints: evaluate an AIR's constraints on the raw trace domain
  (blowup 1, exact selectors) and report the nonzero rows per constraint.
- check_bus_balance: evaluate every AIR's interactions and check that, per
  bus, the multiset of sent field tuples (weighted by multiplicity) equals
  the multiset received: the integer-level statement that the logUp
  argument later proves in the field.

Host code on CPU tensors.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..fields import babybear as bb
from ..models.air import Air, LdeBuilder, TraceBuilder


class _CheckingBuilder(TraceBuilder):
    """A TraceBuilder that keeps its constraints (the prover's drops them)."""

    assert_zero = LdeBuilder.assert_zero


def _monty(trace) -> torch.Tensor:
    return bb.as_tensor(bb.to_monty_np(np.asarray(trace, dtype=np.uint32)), "cpu")


def _builder(air: Air, trace: np.ndarray, public_values=()) -> _CheckingBuilder:
    pvs_m = [bb.to_monty_int(int(v) % bb.P) for v in public_values]
    pre = air.preprocessed_trace()
    tb = _CheckingBuilder(_monty(trace), pvs_m,
                          pre_m=None if pre is None else _monty(pre))
    air.eval(tb)
    return tb


def _canon_rows(x, n: int) -> np.ndarray:
    """A builder value (an (n,) tensor or a Montgomery python int) as n
    canonical int64 values."""
    if isinstance(x, torch.Tensor):
        arr = bb.from_monty_np(bb.to_numpy(x))
    else:
        arr = np.uint32(bb.from_monty_int(int(x)))
    return np.broadcast_to(arr, (n,)).astype(np.int64)


def check_constraints(air: Air, trace: np.ndarray,
                      public_values=()) -> List[Tuple[int, List[int]]]:
    """[(constraint_index, [bad_row, ...])]; empty means every constraint
    vanishes on the trace domain."""
    n = trace.shape[0]
    failures = []
    for idx, c in enumerate(_builder(air, trace, public_values).constraints):
        bad = np.nonzero(_canon_rows(c, n))[0]
        if bad.size:
            failures.append((idx, bad[:8].tolist()))
    return failures


def check_bus_balance(
    pairs: Sequence[Tuple[Air, np.ndarray]],
    public_values: Dict[int, list] = None,
) -> Dict[int, List[Tuple[tuple, int]]]:
    """pairs: (air, trace). {bus: [(field_tuple, net_count), ...]} for every
    unbalanced tuple; an empty dict means every bus balances."""
    public_values = public_values or {}
    net: Dict[int, Dict[tuple, int]] = defaultdict(lambda: defaultdict(int))
    for i, (air, trace) in enumerate(pairs):
        n = trace.shape[0]
        for inter in _builder(air, trace, public_values.get(i, ())).interactions:
            mult = _canon_rows(inter.mult, n)
            fields = np.stack([_canon_rows(f, n) for f in inter.fields], axis=1)
            sign = 1 if inter.is_send else -1
            live = np.nonzero(mult)[0]
            for r, key in zip(live.tolist(), fields[live].tolist()):
                net[inter.bus][tuple(key)] += sign * int(mult[r])
    out = {}
    for bus, d in net.items():
        bad = [(k, v) for k, v in d.items() if v % bb.P != 0]
        if bad:
            out[bus] = bad[:10]
    return out
