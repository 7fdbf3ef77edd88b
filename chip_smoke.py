#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`zkvm_prover_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py [--log-n 18] [--seed 0] [--out build/chip_smoke.json]

Phases (any failure exits non-zero; nothing is caught or skipped):
  1. card and build: nvidia-smi's name and power limit, torch's CUDA
     version, the kernels' build time (nvcc, sm_90a, from csrc/); what the
     compiler made of them and the card's integer issue rates
     (zkvm_prover_tpu_torch/kernel_report.py);
  2. every kernel against its plain torch version on the card, at the
     shapes the main path gives it: mismatches (must be 0), time per launch
     (CUDA events), the plain version's time and the bound; K1 per pass,
     per whole transform and as the fused coset LDE (interpolation plus two
     cosets), each with the bound of that whole function;
  3. the main path: a Poseidon2Air trace of 2^log_n rows x 495 columns from
     --seed, proven on cuda at default_config() (100 queries, 16 PoW bits,
     blowup 2) with the launch counts zeroed just before and read just
     after; per-phase wall-clock, peak memory, verify (True) and a tampered
     proof (False); then a second (warm) proof, and a third under
     torch.profiler: device ms and launches per kernel and per shape, the
     device's idle share over the proof, the plain torch kernels that run
     in the LDE (from the proof's start to its first row hash), at most 3
     compress launches per Merkle tree and at most 2 K1 launches per
     transform;
  4. cross-device identity: a 2^10-row proof at fast_test_config() on cuda
     and on cpu, equal in every field but `stat`;
  5. the kernels line (JSON), the card line, and last the result line.
The port imports no JAX; this script imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
# 32-bit integer multiplies per second: the float32 rate of 67 TFLOP/s counts
# an FMA as 2 operations (33.5 T FMA/s); Hopper issues integer multiply-adds
# at half its FP32 FMA rate.
INT_MULS_PER_S = 16.75e12
MULS_PER_MODMUL = 3           # 32x32->64 product, m = lo * NP, m * p
MODMULS_PER_PERM = 772        # Poseidon2-16: 8*16*4 (S-box) + 13*(4 + 16)


# C entry point -> (launch counter, shape from the scalar arguments)
ENTRY_SHAPES = {
    "ntt_pass": ("ntt_pass", lambda a: f"n={a[4]} W={a[5]} a={a[6]} L={a[7]}"
                 f"{' dit' if a[8] else ''}{'' if a[3] == a[5] else f' ld_y={a[3]}'}"),
    "p2_permute": ("poseidon2_permute", lambda a: f"({a[2]},16)"),
    "p2_hash_rows": ("poseidon2_hash_rows", lambda a: f"({a[1]},{a[2]})"),
    "p2_compress": ("poseidon2_compress", lambda a: f"{a[1]} digests, {a[2]} levels"),
    "mont_matmul_rows": ("mont_matmul_rows", lambda a: f"({a[2]},{a[3]})"),
    "mont_matmul_cols": ("mont_matmul_cols", lambda a: f"({a[2]},{a[3]})"),
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    return out.splitlines()[0]


def bound_ms(nbytes: float, muls: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = muls / INT_MULS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, reps: int = 3, warmup: bool = True) -> float:
    import torch

    if warmup:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def max_err(a, b) -> int:
    import torch

    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def random_field(gen, shape, device):
    import torch

    from zkvm_prover_tpu_torch.fields import babybear as bb

    return torch.randint(0, bb.P, shape, generator=gen, dtype=torch.int64,
                         device="cpu").to(device=device, dtype=bb.DTYPE)


def check_kernels(log_n: int, width: int, seed: int):
    """Phase 2: each kernel vs its plain version at the main path's shapes."""
    import torch

    from zkvm_prover_tpu_torch.fields import babybear as bb
    from zkvm_prover_tpu_torch.ops import mont_matmul as mm
    from zkvm_prover_tpu_torch.ops import ntt, ntt_fused
    from zkvm_prover_tpu_torch.ops import poseidon2 as p2

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(seed)
    n, m = 1 << log_n, 2 << log_n
    rows = []

    def record(name, source, replaces, shape, err, ms, plain_ms, nbytes, muls,
               counter=None):
        b_ms, b_by = bound_ms(nbytes, muls)
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "shape": shape, "max_abs_err": err,
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": None, "bytes": nbytes,
                     "counter": counter or name})
        print(f"  {name:20s} {shape:28s} err={err} ms={ms:.4f} "
              f"plain_ms={plain_ms:.3f} bound_ms={b_ms:.4f} ({b_by})", flush=True)
        if err != 0:
            raise AssertionError(f"{name} disagrees with its plain version")

    src_ntt = "zkvm_prover_tpu_torch/csrc/ntt.cu"
    rep_ntt = "zkvm_prover_tpu/ops/ntt_pallas.py:66"
    sizes = ntt_fused.pass_sizes(log_n)
    for w in (width, 4):
        x = random_field(gen, (n, w), dev)
        # whole transforms: the LDE's inverse DIF and forward DIT
        for inverse, dit in ((True, False), (False, True)):
            fn, plain = (ntt_fused.dit, ntt_fused.dit_plain) if dit else \
                (ntt_fused.dif, ntt_fused.dif_plain)
            err = max_err(fn(x, log_n, inverse), plain(x, log_n, inverse))
            record("ntt_transform", src_ntt, rep_ntt,
                   f"({n},{w}) {'dit' if dit else 'dif inv'}, {len(sizes)} passes",
                   err, time_ms(lambda: fn(x, log_n, inverse)),
                   time_ms(lambda: plain(x, log_n, inverse), reps=1, warmup=False),
                   2 * n * w * 4 + n * 4, log_n * (n // 2) * w * MULS_PER_MODMUL,
                   counter="ntt_pass")
        # each pass of the inverse DIF alone
        a = log_n
        for L in sizes:
            a -= L
            err = max_err(ntt_fused.ntt_pass(x, a, L, True),
                          ntt_fused.ntt_pass_plain(x, a, L, True))
            record("ntt_pass", src_ntt, rep_ntt, f"({n},{w}) dif inv a={a} L={L}", err,
                   time_ms(lambda: ntt_fused.ntt_pass(x, a, L, True)),
                   time_ms(lambda: ntt_fused.ntt_pass_plain(x, a, L, True),
                           reps=1, warmup=False),
                   2 * n * w * 4 + (1 << (a + L)) * 4,
                   L * (n // 2) * w * MULS_PER_MODMUL)
        del x

    # the fused LDE as the prover runs it: canonical trace -> c_rev -> 2 cosets
    x = random_field(gen, (n, width), dev)
    shift = bb.GENERATOR

    def lde():
        c = ntt.interpolate_coset_rev(x, 1, canonical=True)
        return ntt.eval_coset_from_rev(c, 1, shift)

    def lde_plain():
        c = bb.mul(ntt_fused.dif_plain(bb.to_monty(x), log_n, True),
                   ntt.n_inv_monty(log_n))
        w_m = bb.two_adic_generator_int(log_n + 1)
        cosets = [ntt_fused.dit_plain(bb.mul(c, ntt.powers_bitrev(
            shift * pow(w_m, r, bb.P) % bb.P, log_n, dev)[:, None]), log_n, False)
                  for r in range(2)]
        return torch.stack(cosets, dim=1).reshape(2 * n, width)

    record("ntt_lde", src_ntt, rep_ntt, f"({n},{width}) -> ({m},{width})",
           max_err(lde(), lde_plain()), time_ms(lde),
           time_ms(lde_plain, reps=1, warmup=False), 4 * n * width * 4 + 3 * n * 4,
           (3 * log_n * (n // 2) + 3 * n) * width * MULS_PER_MODMUL, counter="ntt_pass")
    del x
    torch.cuda.empty_cache()

    src_p2 = "zkvm_prover_tpu_torch/csrc/poseidon2.cu"
    # the trace, the quotient chunks and the largest FRI codeword
    for r, c in ((m, width), (m, 8), (n, 4)):
        mat = random_field(gen, (r, c), dev)
        blocks = max(1, -(-c // p2.RATE))
        record("poseidon2_hash_rows", src_p2, "zkvm_prover_tpu/ops/poseidon2.py:225",
               f"({r},{c})", max_err(p2.hash_rows(mat), p2.hash_rows_plain(mat)),
               time_ms(lambda: p2.hash_rows(mat)),
               time_ms(lambda: p2.hash_rows_plain(mat), reps=1, warmup=False),
               r * c * 4 + r * 32, r * blocks * MODMULS_PER_PERM * MULS_PER_MODMUL)
        del mat
    pairs = random_field(gen, (n, 16), dev)
    record("poseidon2_compress", src_p2, "zkvm_prover_tpu/ops/poseidon2.py:248",
           f"({n},16)", max_err(p2.compress16(pairs), p2.permute_plain(pairs)[:, :8]),
           time_ms(lambda: p2.compress16(pairs)),
           time_ms(lambda: p2.permute_plain(pairs)[:, :8], reps=1, warmup=False),
           n * 96, n * MODMULS_PER_PERM * MULS_PER_MODMUL)
    # every level of a tree over the trace's 2^(log_n+1) leaf digests
    lm = log_n + 1
    leaves = random_field(gen, (m, 8), dev)
    err = max(max_err(a, b) for a, b in zip(p2.compress_levels(leaves, lm),
                                             p2.compress_levels_plain(leaves, lm)))
    record("poseidon2_compress", src_p2, "zkvm_prover_tpu/ops/poseidon2.py:248",
           f"2^{lm} leaves, {lm} levels", err,
           time_ms(lambda: p2.compress_levels(leaves, lm)),
           time_ms(lambda: p2.compress_levels_plain(leaves, lm), reps=1, warmup=False),
           m * 32 + (m - 1) * 32, (m - 1) * MODMULS_PER_PERM * MULS_PER_MODMUL)
    del leaves
    grind_batch = 1 << 18
    states = random_field(gen, (grind_batch, 16), dev)
    record("poseidon2_permute", src_p2, "zkvm_prover_tpu/ops/poseidon2.py:182",
           f"({grind_batch},16)", max_err(p2.permute(states), p2.permute_plain(states)),
           time_ms(lambda: p2.permute(states)),
           time_ms(lambda: p2.permute_plain(states), reps=1, warmup=False),
           grind_batch * 128, grind_batch * MODMULS_PER_PERM * MULS_PER_MODMUL)
    del pairs, states

    src_mm = "zkvm_prover_tpu_torch/csrc/mont_matmul.cu"
    for r, c in ((m, width), (m, 8)):
        a = random_field(gen, (r, c), dev)
        b = random_field(gen, (c, 4), dev)
        record("mont_matmul_rows", src_mm, "zkvm_prover_tpu/stark/prover.py:81",
               f"({r},{c})@({c},4)", max_err(mm.mont_matmul(a, b),
                                             mm.mont_matmul_plain(a, b)),
               time_ms(lambda: mm.mont_matmul(a, b)),
               time_ms(lambda: mm.mont_matmul_plain(a, b), reps=1, warmup=False),
               r * c * 4 + c * 16 + r * 16, 4 * r * c)
    for r, c in ((n, width), (n, 4)):
        a = random_field(gen, (r, c), dev)
        b = random_field(gen, (r, 4), dev)
        record("mont_matmul_cols", src_mm, "zkvm_prover_tpu/ops/ntt.py:367",
               f"({r},{c})^T@({r},4)",
               max_err(mm.mont_matmul(a, b, transpose_a=True),
                       mm.mont_matmul_plain(a, b, transpose_a=True)),
               time_ms(lambda: mm.mont_matmul(a, b, transpose_a=True)),
               time_ms(lambda: mm.mont_matmul_plain(a, b, transpose_a=True), reps=1, warmup=False),
               r * c * 4 + r * 16 + c * 16, 4 * r * c)
    del a, b
    torch.cuda.empty_cache()
    return rows


def launch_counts():
    """Kernel launches by counter (K1's whole transforms are not launches:
    they are read from `ntt_fused.transforms`)."""
    from zkvm_prover_tpu_torch.ops import mont_matmul as mm
    from zkvm_prover_tpu_torch.ops import ntt_fused
    from zkvm_prover_tpu_torch.ops import poseidon2 as p2

    return {**ntt_fused.launches, **p2.launches, **mm.launches}


def reset_counts():
    from zkvm_prover_tpu_torch.ops import mont_matmul as mm
    from zkvm_prover_tpu_torch.ops import ntt_fused
    from zkvm_prover_tpu_torch.ops import poseidon2 as p2

    for d in (ntt_fused.launches, ntt_fused.transforms, p2.launches, mm.launches):
        for key in d:
            d[key] = 0


def profile_proof(prove, trace_path: str) -> dict:
    """One proof under torch.profiler (CPU and CUDA activity): device ms and
    launches per kernel and per shape, the device's idle share over the
    proof, and the compress launches of each Merkle tree. Shapes come from
    the kernels' C calls, logged in order and matched one to one with the
    trace's launches of those kernels (one stream, so the orders agree)."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from zkvm_prover_tpu_torch import _build
    from zkvm_prover_tpu_torch.kernel_report import ENTRY_KERNELS, short_name

    lib = _build.lib()
    calls = []
    originals = {name: getattr(lib, name) for name in ENTRY_SHAPES}

    def logger(name, fn):
        def logged(*args):
            calls.append((name, args))
            return fn(*args)
        return logged

    for name, fn in originals.items():
        setattr(lib, name, logger(name, fn))
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function("prove"):
                prove()
                torch.cuda.synchronize()
        prof.export_chrome_trace(trace_path)
    finally:
        for name, fn in originals.items():
            setattr(lib, name, fn)
    with open(trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    win = next(e for e in events if e["name"] == "prove" and e.get("cat") == "user_annotation")
    w0, w1 = win["ts"], win["ts"] + win["dur"]
    dev = sorted((e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")),
                 key=lambda e: e["ts"])
    busy, end = 0.0, w0
    for e in dev:
        a, b = max(e["ts"], end), min(e["ts"] + e["dur"], w1)
        if b > a:
            busy += b - a
        end = max(end, min(e["ts"] + e["dur"], w1))
    ours = set(k for ks in ENTRY_KERNELS.values() for k in ks)
    per_kernel = collections.defaultdict(lambda: [0, 0.0])
    mine = []
    for e in dev:
        name = short_name(e["name"])
        if e["cat"] != "kernel":
            name = e["cat"]
        elif name.split("<")[0] not in ours:
            name = "other kernels (plain torch)"
        else:
            mine.append(e)
        per_kernel[name][0] += 1
        per_kernel[name][1] += e["dur"] / 1e3
    expected = [(entry, k, ENTRY_SHAPES[entry][1](args))
                for entry, args in calls for k in ENTRY_KERNELS[entry]]
    per_shape = collections.defaultdict(lambda: [0, 0.0])
    matched = len(expected) == len(mine) and all(
        k in e["name"] for (_, k, _), e in zip(expected, mine))
    if matched:
        for (entry, k, shape), e in zip(expected, mine):
            key = (ENTRY_SHAPES[entry][0] + ("/finish" if k == "mm_cols_finish" else ""),
                   shape)
            per_shape[key][0] += 1
            per_shape[key][1] += e["dur"] / 1e3
    # the LDE: from the proof's start to the first row hash (the trace commit)
    t_hash = next((e["ts"] for e in mine if "hash_rows_kernel" in e["name"]), w1)
    lde = collections.defaultdict(lambda: [0, 0.0])
    for e in dev:
        if w0 <= e["ts"] < t_hash:
            name = short_name(e["name"]) if e["cat"] == "kernel" else e["cat"]
            if e["cat"] == "kernel" and name.split("<")[0] not in ours:
                name = "plain torch: " + e["name"][:60]
            lde[name][0] += 1
            lde[name][1] += e["dur"] / 1e3
    trees = []
    for entry, _ in calls:
        if entry == "p2_hash_rows":
            trees.append(0)
        elif entry == "p2_compress" and trees:
            trees[-1] += 1
    return {"window_ms": (w1 - w0) / 1e3, "device_busy_ms": busy / 1e3,
            "idle_share": 1 - busy / (w1 - w0),
            "per_kernel": {k: {"launches": n, "ms": ms} for k, (n, ms) in
                           sorted(per_kernel.items(), key=lambda kv: -kv[1][1])},
            "shapes_matched": matched,
            "per_shape": [{"kernel": k, "shape": sh, "launches": n, "ms": ms}
                          for (k, sh), (n, ms) in sorted(per_shape.items(),
                                                         key=lambda kv: -kv[1][1])],
            "compress_launches_per_tree": trees,
            "lde_window": {k: {"launches": n, "ms": ms} for k, (n, ms) in lde.items()}}


def poseidon2_trace(log_n: int, seed: int):
    import numpy as np

    from zkvm_prover_tpu_torch.fields import babybear as bb
    from zkvm_prover_tpu_torch.models.poseidon2_air import Poseidon2Air

    rng = np.random.default_rng(seed)
    inputs = rng.integers(0, bb.P, size=(1 << log_n, 16), dtype=np.uint64)
    return Poseidon2Air.generate_trace(inputs.astype(np.uint32),
                                       np.ones(1 << log_n, dtype=np.uint32))


def proofs_equal(a, b, path="proof"):
    """Field-by-field equality of two proofs, `stat` excepted."""
    import numpy as np

    if hasattr(a, "__dataclass_fields__"):
        for f in a.__dataclass_fields__:
            if f != "stat":
                proofs_equal(getattr(a, f), getattr(b, f), f"{path}.{f}")
    elif isinstance(a, dict):
        if sorted(a) != sorted(b):
            raise AssertionError(f"{path}: keys differ")
        for key in a:
            proofs_equal(a[key], b[key], f"{path}[{key}]")
    elif isinstance(a, (list, tuple)):
        if len(a) != len(b):
            raise AssertionError(f"{path}: lengths differ")
        for i, (x, y) in enumerate(zip(a, b)):
            proofs_equal(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        x, y = np.asarray(a), np.asarray(b)
        if x.shape != y.shape or x.dtype != y.dtype or not (x == y).all():
            raise AssertionError(f"{path}: arrays differ")
    elif a != b:
        raise AssertionError(f"{path}: {a!r} != {b!r}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log-n", type=int, default=18,
                    help="log2 of the main path's trace height")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="build/chip_smoke.json")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    from zkvm_prover_tpu_torch import _build, kernel_report
    from zkvm_prover_tpu_torch.ops import ntt_fused
    from zkvm_prover_tpu_torch.models.poseidon2_air import NUM_COLS, Poseidon2Air
    from zkvm_prover_tpu_torch.stark import prover, verifier
    from zkvm_prover_tpu_torch.stark.config import default_config, fast_test_config

    t_all = time.perf_counter()
    report = {"log_n": args.log_n, "seed": args.seed}

    # 1. card and build
    card = card_line()
    print(f"[1] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    t0 = time.perf_counter()
    _build.lib()
    report["build_s"] = time.perf_counter() - t0
    report["card"] = card
    print(f"[1] kernels built and loaded in {report['build_s']:.1f} s", flush=True)
    probe_dir = str(_build.BUILD_DIR / "probe")
    report["sass_per_op"] = kernel_report.op_counts(str(_build.CSRC), probe_dir)
    for op, row in report["sass_per_op"].items():
        print(f"[1] SASS per bb::{op}: {row['instructions']:g} {row['opcodes']}")
    report["kernel_resources"] = kernel_report.kernel_resources(str(_build.build()))
    for name, row in report["kernel_resources"].items():
        print(f"[1] {name:24s} {row}")
    report["pipe_rates"] = kernel_report.pipe_rates(probe_dir)
    for row in report["pipe_rates"]:
        print(f"[1] {row['op']:16s} {row['per_clock_per_sm']:7.2f} per clock per SM "
              f"{row['sass']}", flush=True)

    # 2. kernels against their plain versions
    print("[2] kernels vs plain torch on the card; tolerance 0 (exact modular "
          "arithmetic: any mismatch fails)", flush=True)
    rows = check_kernels(args.log_n, NUM_COLS, args.seed)
    report["kernel_checks"] = rows

    # 3. the main path
    t0 = time.perf_counter()
    trace = poseidon2_trace(args.log_n, args.seed)
    report["trace_gen_s"] = time.perf_counter() - t0
    print(f"[3] Poseidon2Air trace {trace.shape} generated in "
          f"{report['trace_gen_s']:.1f} s", flush=True)
    air = Poseidon2Air()
    cfg = default_config()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    proof = prover.prove(air, trace, [], cfg)
    torch.cuda.synchronize()
    prove_s = time.perf_counter() - t0
    counts = launch_counts()
    n_transforms = sum(ntt_fused.transforms.values())
    peak = torch.cuda.max_memory_allocated()
    print(f"[3] proved in {prove_s:.3f} s, peak {peak / 2**30:.2f} GiB", flush=True)
    for key, val in proof.stat.items():
        if key.endswith("_ms"):
            print(f"      {key:24s} {val:10.1f}")
    print(f"[3] launches: {counts}", flush=True)
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    print(f"[3] K1: {counts['ntt_pass']} launches for {n_transforms} transforms "
          f"({ntt_fused.transforms})", flush=True)
    if args.log_n <= 2 * ntt_fused.K_MAX and counts["ntt_pass"] > 2 * n_transforms:
        raise AssertionError("a transform took more than 2 K1 launches")
    t0 = time.perf_counter()
    ok = verifier.verify(air, proof, cfg)
    verify_s = time.perf_counter() - t0
    bad = copy.deepcopy(proof)
    bad.opened_trace_zeta[0, 0] ^= 1
    rejected = not verifier.verify(air, bad, cfg)
    print(f"[3] verify: {ok} in {verify_s:.3f} s; tampered opening rejected: "
          f"{rejected}", flush=True)
    if not ok or not rejected:
        raise AssertionError("verification phase failed")
    report.update(prove_s=prove_s, verify_s=verify_s, peak_bytes=peak,
                  phases_ms={k: v for k, v in proof.stat.items() if k.endswith("_ms")},
                  launches=counts, transforms=dict(ntt_fused.transforms))
    del proof, bad

    # the same proof again in this process (warm), then once more profiled
    t0 = time.perf_counter()
    warm = prover.prove(air, trace, [], cfg)
    torch.cuda.synchronize()
    report["warm_prove_s"] = time.perf_counter() - t0
    report["warm_phases_ms"] = {k: v for k, v in warm.stat.items() if k.endswith("_ms")}
    print(f"[3] warm proof in {report['warm_prove_s']:.3f} s: "
          + ", ".join(f"{k[:-3]} {v:.1f}" for k, v in report["warm_phases_ms"].items()),
          flush=True)
    del warm
    trace_path = os.path.join(os.path.dirname(args.out) or ".", "chip_smoke_trace.json")
    prof = profile_proof(lambda: prover.prove(air, trace, [], cfg), trace_path)
    report["profile"] = prof
    print(f"[3] profiled proof: window {prof['window_ms']:.1f} ms, device busy "
          f"{prof['device_busy_ms']:.1f} ms, idle share {prof['idle_share']:.4f}")
    for name, row in prof["per_kernel"].items():
        print(f"      {name:30s} launches {row['launches']:6d}  device ms {row['ms']:9.3f}")
    print(f"[3] per shape (matched to the C calls: {prof['shapes_matched']}):")
    for row in prof["per_shape"]:
        print(f"      {row['kernel']:24s} {row['shape']:26s} launches {row['launches']:4d}"
              f"  device ms {row['ms']:8.3f}")
    print("[3] device work in the LDE (proof start to the first row hash):")
    for name, row in prof["lde_window"].items():
        print(f"      {name:60s} launches {row['launches']:4d}  device ms {row['ms']:8.3f}")
    plain_lde = sum(r["ms"] for k, r in prof["lde_window"].items()
                    if k.startswith("plain torch"))
    print(f"[3] plain torch device ms in the LDE: {plain_lde:.3f}", flush=True)
    per_tree = prof["compress_launches_per_tree"]
    print(f"[3] compress launches per Merkle tree: {per_tree}", flush=True)
    if not per_tree or max(per_tree) > 3:
        raise AssertionError("a Merkle tree took more than 3 compress launches")
    del trace
    torch.cuda.empty_cache()

    # 4. cross-device identity
    small = poseidon2_trace(10, args.seed + 1)
    p_cuda = prover.prove(air, small, [], fast_test_config(), device="cuda")
    p_cpu = prover.prove(air, small, [], fast_test_config(), device="cpu")
    proofs_equal(p_cuda, p_cpu)
    if not verifier.verify(air, p_cuda, fast_test_config()):
        raise AssertionError("2^10 proof does not verify")
    print("[4] 2^10-row proofs on cuda and cpu are identical", flush=True)

    # 5. the kernels line: per kernel, its largest main-path shape
    kernels = {}
    for row in rows:
        best = kernels.get(row["name"])
        if best is None or row["bytes"] > best["bytes"]:
            kernels[row["name"]] = row
    line = []
    for name, row in kernels.items():
        entry = {key: row[key] for key in (
            "name", "route", "source", "replaces")}
        entry.update(launches=counts[row["counter"]],
                     max_abs_err=max(r["max_abs_err"] for r in rows if r["name"] == name),
                     ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                     bound_by=row["bound_by"], library_ms=None,
                     shape=row["shape"], bytes=row["bytes"])
        line.append(entry)
    report["total_s"] = time.perf_counter() - t_all
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({"kernels": line}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
