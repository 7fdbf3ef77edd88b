"""Tracing / metrics: per-phase wall-clock spans and proving-speed reports
(the reference's `utils/tracing.py`).

Parity with the reference's aux subsystem (SURVEY.md §5): `tracing` spans
with span-close events, per-phase wall-clock and a derived MHz "proving
speed" (crates/prover/src/prover/mod.rs:320-366), and a metrics.json dump.
Spans read the host clock: a span over device work that does not
synchronise measures the host's launch time, not the card's.

Usage:
    with span("prove/chunk", cycles=n):
        ...
    report() -> {phase: {"calls", "total_ms", "cycles"}}
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from collections import defaultdict
from typing import Dict

logger = logging.getLogger("zkvm_prover_tpu_torch")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s"))
    logger.addHandler(_h)
    logger.setLevel(os.environ.get("ZKVM_LOG", "WARNING").upper())

_METRICS: Dict[str, dict] = defaultdict(lambda: {"calls": 0, "total_ms": 0.0, "cycles": 0})


@contextlib.contextmanager
def span(name: str, cycles: int = 0):
    t0 = time.time()
    try:
        yield
    finally:
        dt_ms = (time.time() - t0) * 1e3
        m = _METRICS[name]
        m["calls"] += 1
        m["total_ms"] += dt_ms
        m["cycles"] += cycles
        msg = f"{name}: close time.busy={dt_ms:.1f}ms"
        if cycles:
            mhz = cycles / 1e3 / max(dt_ms, 1e-9)
            msg += f" cycles={cycles} speed={mhz:.3f}MHz"
        logger.info(msg)


def report() -> Dict[str, dict]:
    return {k: dict(v) for k, v in _METRICS.items()}


def reset() -> None:
    _METRICS.clear()


def dump_metrics(path: str) -> None:
    """The metrics.json of the reference's chunk-benchmark bin."""
    with open(path, "w") as f:
        json.dump(report(), f, indent=2, sort_keys=True)
