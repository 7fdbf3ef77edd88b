"""chunk-scanner: execute chunk tasks (no proving) and write a cycles CSV.

Parity with the reference's `chunk-scanner` bin
(crates/integration/src/bin/chunk-scanner.rs:18-80: fetch blocks ->
execute -> per-chunk cycles/gas CSV). There is no RPC endpoint here, so the
blocks come from the integration harness's chained witness generator
(`ChunkTaskGenerator`); the measured path, guest execution on the native
rv32 executor with its traces, is the production one. Nothing runs on a
device.

Usage: python -m zkvm_prover_tpu_torch.bin.chunk_scanner [--chunks N] [--out CSV]
"""

from __future__ import annotations

import argparse
import csv
import sys
import time


def scan(chunks: int) -> list:
    """One row per chunk: blocks, gas, executed rows, seconds, PI hash."""
    from ..circuits.chunk_circuit import ChunkCircuit
    from ..host.app import get_app
    from ..host.task import ProvingTask
    from ..integration.testers import ChunkTaskGenerator

    gen = ChunkTaskGenerator()
    app = get_app("chunk")
    rows = []
    for i in range(chunks):
        w = gen.witness(i)
        task = ProvingTask(serialized_witness=[ChunkCircuit.serialize_witness(w)],
                           identifier=f"scan-{i}")
        t0 = time.time()
        instances, pi_hash = app.execute(task)
        dt = time.time() - t0
        cycles = sum(int(inst.trace.shape[0]) for inst in instances)
        gas = sum(b.gas_used for b in w.blocks)
        rows.append({
            "chunk": i,
            "first_block": w.blocks[0].number,
            "num_blocks": len(w.blocks),
            "gas_used": gas,
            "total_rows": cycles,
            "exec_seconds": round(dt, 4),
            "rows_per_gas": round(cycles / max(gas, 1), 6),
            "pi_hash": pi_hash.hex(),
        })
        print(f"chunk {i}: rows={cycles} gas={gas} t={dt:.3f}s", file=sys.stderr)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--chunks", type=int, default=4)
    ap.add_argument("--out", default="chunk_cycles.csv")
    args = ap.parse_args(argv)

    rows = scan(args.chunks)
    with open(args.out, "w", newline="") as f:
        wcsv = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        wcsv.writeheader()
        wcsv.writerows(rows)
    print(args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
