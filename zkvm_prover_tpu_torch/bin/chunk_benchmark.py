"""chunk-benchmark: execute and prove a chunk task with metric collection.

Parity with the reference's `chunk-benchmark` bin
(crates/integration/src/bin/chunk-benchmark.rs:13-51: BenchmarkCli and
run_with_metric_collection -> metrics.json). The proof runs on the card
unless `--device` names another device; without a card it raises.

Usage: python -m zkvm_prover_tpu_torch.bin.chunk_benchmark
           [--metrics PATH] [--fast] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--metrics", default="metrics.json")
    ap.add_argument("--device", default=None,
                    help="torch device of the proof (default: the card)")
    ap.add_argument("--fast", action="store_true",
                    help="reduced-query test config (NOT secure)")
    args = ap.parse_args(argv)

    from ..integration import ChunkTaskGenerator
    from ..stark.config import StarkConfig, fast_test_config, resolve_device
    from ..utils import tracing

    device = str(resolve_device(args.device))
    os.environ.setdefault("OUTPUT_DIR", tempfile.mkdtemp())
    gen = ChunkTaskGenerator(stark=fast_test_config() if args.fast else StarkConfig(),
                             device=device)

    with tracing.span("chunk/execute"):
        w = gen.witness(0)
    total_gas = w.total_gas_used
    t0 = time.time()
    with tracing.span("chunk/prove", cycles=total_gas):
        proof = gen.get_or_build_proof(0)
    wall = time.time() - t0

    stats = proof.stat.to_dict()
    stats["wall_clock_s"] = wall
    stats["total_gas"] = total_gas
    stats["device"] = device
    # cycles-per-gas budget (the reference asserts <= 35,
    # crates/integration/tests/chunk_circuit.rs:44-54): a regression in
    # guest efficiency fails the benchmark loudly
    if total_gas:
        cpg = proof.stat.total_cycles / total_gas
        stats["cycles_per_gas"] = round(cpg, 4)
        assert cpg <= 35, f"cycles/gas budget exceeded: {cpg:.2f} > 35"
    tracing.dump_metrics(args.metrics)
    print(json.dumps(stats))


if __name__ == "__main__":
    main()
