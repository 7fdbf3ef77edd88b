"""K4, the port's BN254 MSM, on the card for one or more checkouts of the port.

    python3 k4_compare.py [ROOT ...]

Each ROOT is a directory holding a `zkvm_prover_tpu_torch/` package (this
checkout by default); to compare with a parent commit, unpack it with
`git archive <commit> zkvm_prover_tpu_torch native | tar -x -C build/parent`
and run `python3 k4_compare.py build/parent . . build/parent`. Each ROOT runs
in a process of its own (the packages share a name). On the same points
(a chain P, P + Q, P + 2Q, ...) and seeded scalars of six kinds (uniform
below r at 2^13, 2^12 and 2^9; all equal but five at 2^12; all equal at
2^13; 64-bit at 2^12), it checks the whole MSM against the host engine and
times the bucket step (`window_buckets`, with the sort and the plan) and the
window sums with CUDA events (mean of 5 after one warm-up). Where the
package has the chunk plan, it adds each K4 kernel's device ms from
torch.profiler and the bucket kernels' device ms for chunk sizes m = 1 to
32. One JSON line per ROOT and input set, after the card's name and power
limit. Needs a CUDA device; exits 2 without one.
"""

from __future__ import annotations

import json
import os
import random
import subprocess
import sys
import time

SWEEP = (1, 2, 4, 8, 16, 32)


def inputs(bn):
    rng = random.Random(7)
    p = bn.g1_mul(bn.G1_GEN, rng.randrange(1, bn.R))
    step = bn.g1_mul(bn.G1_GEN, rng.randrange(1, bn.R))
    points = []
    for _ in range(1 << 13):
        points.append(p)
        p = bn.g1_add(p, step)
    r = random.Random(11)
    s0 = r.randrange(bn.R)
    skewed = [s0] * 4096
    for i in r.sample(range(4096), 5):
        skewed[i] = r.randrange(bn.R)
    return {
        "uniform 2^13": (points, [r.randrange(bn.R) for _ in range(8192)]),
        "uniform 2^12": (points[:4096], [r.randrange(bn.R) for _ in range(4096)]),
        "equal but 5, 2^12": (points[:4096], skewed),
        "all equal, 2^13": (points, [s0] * 8192),
        "64-bit scalars, 2^12": (points[:4096], [r.randrange(1 << 64) for _ in range(4096)]),
        "uniform 2^9": (points[:512], [r.randrange(bn.R) for _ in range(512)]),
    }


def events_ms(torch, fn, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(torch, kernel_report, fn, reps: int = 3) -> dict:
    fn()
    torch.cuda.synchronize()
    per = kernel_report.kernel_census(lambda: [fn() for _ in range(reps)])["per_kind"]
    return {k: v["ms"] / reps for k, v in per.items()}


def child(root: str) -> int:
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from zkvm_prover_tpu_torch import _build, kernel_report
    from zkvm_prover_tpu_torch.fields import bn254 as bn
    from zkvm_prover_tpu_torch.fields import bn254_native
    from zkvm_prover_tpu_torch.ops import msm

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _build.lib()
    build_s = time.perf_counter() - t0
    planned = hasattr(msm, "chunk_plan")
    for name, (points, scalars) in inputs(bn).items():
        n, c = len(points), msm.window_bits(len(points))
        pts = msm.words_tensor(msm.affine_words(points), dev)
        dig = msm.digits(msm.words_tensor(msm.scalar_words(scalars), dev), c)
        buckets = msm.window_buckets(pts, dig, c)
        sums = msm.window_sums(buckets, c)
        row = {"root": root, "inputs": name, "n": n, "c": c, "build_s": build_s,
               "equal_to_host_engine":
                   msm.combine_windows(sums, c) == bn254_native.msm(points, scalars),
               "bucket_step_ms": events_ms(torch, lambda: msm.window_buckets(pts, dig, c)),
               "window_sums_ms": events_ms(torch, lambda: msm.window_sums(buckets, c))}
        row["device_ms"] = device_ms(torch, kernel_report, lambda: (
            msm.window_sums(msm.window_buckets(pts, dig, c), c)))
        if planned:
            order, offsets = msm.sort_by_digit(dig, c)
            infinity = (pts == 0).all(-1)
            row["m"] = msm.chunk_plan(order, offsets, infinity, c).m
            sweep = {}
            for m in SWEEP:
                plan = msm.chunk_plan(order, offsets, infinity, c, m)

                def kernels(plan=plan):
                    out = torch.zeros_like(buckets)
                    pieces, keys = msm.chunk_partials(pts, plan, out), plan.piece_key
                    while keys.shape[0] > 2:
                        pieces, keys = msm.reduce_segments(pieces, keys, out)
                    return out

                sweep[m] = sum(device_ms(torch, kernel_report, kernels).get(k, 0.0) for k in (
                    "msm_chunks_kernel", "msm_reduce_kernel"))
            row["bucket_kernels_ms_by_m"] = sweep
        print(json.dumps(row), flush=True)
        if not row["equal_to_host_engine"]:
            return 1
    return 0


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--child":
        return child(sys.argv[2])
    import torch

    if not torch.cuda.is_available():
        print("k4_compare: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    rc = 0
    for root in sys.argv[1:] or ["."]:
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__), "--child", root]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
