"""K2's Poseidon2 kernels on the card: the width-24 kernel of this checkout
(both instances) and of parent checkouts, and the width-16 kernels with the
shift-form diagonal, each timed in turns.

    python3 p2_compare.py [--parent DIR ...] [--w16] [--out PATH]

Every library is built from source by its own `nvcc` (`_build.NVCC_FLAGS`,
`-Xptxas -v`), all started together, into `build/p2_compare/`:

- `tree`: this checkout's `csrc/poseidon2.cu`, as the port builds it;
- one per `--parent DIR` (named after DIR's last part): DIR's
  `zkvm_prover_tpu_torch/csrc/poseidon2.cu`, e.g. after `git archive
  <commit> zkvm_prover_tpu_torch | tar -x -C build/parent`; a source whose
  `p2_permute24` takes the instance (`int shift_diag`) gives both;
- `--w16`: a copy of this checkout's `poseidon2.cu` under the build
  directory in which the width-16 kernels take the standard diagonal by
  shifts (`ShiftDiag<16>` from `ops/poseidon2.py::diag_plan`); the port's
  width-16 kernels are not changed by it.

Each width-24 kernel runs on (2^18, 24) and (1001, 24) states from a seed
and must equal `permute_plain` exactly; then all are timed with CUDA events
in turns (each the median over --rounds rounds of the mean of --reps
launches, the order reversed each round), and the SM clock and power are
sampled (`nvidia-smi` every 100 ms) under a 1.5 s run of each. Beside each:
registers and spills (ptxas), SASS instructions, and the SASS one
permutation executes (`loop_mix`: the round loops run 4, 21 and 4 times)
with the clocks each pipe needs for it (`pipe_clocks`) at the issue rates
`kernel_report.pipe_rates(alu=True)` measures, as a ceiling in ms for
(2^18, 24). With --w16 the tree's and the copy's `hash_rows` (2^19, 495),
`compress_levels` (2^19 digests, 19 levels) and `permute` (2^18, 16), each
exact against its plain version, are timed in turns the same way. Prints
the card's name and power limit, then one JSON line per result; the whole
report goes to --out. Needs a CUDA device; exits 2 without one.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "build" / "p2_compare"
S24 = 1 << 18
TRIPS = [4, 21, 4]  # the permutation's round loops: 4 external, 21 internal, 4 external


def pipe_of(op: str) -> str:
    """The pipe an opcode issues to, as the port's kernels use them: `wide`
    (IMAD.WIDE, IMAD.HI: two cycles of the multiply pipe), `imad` (the other
    IMADs, one cycle of it), `mem`, `control`, `uniform` (the per-warp
    datapath) or `alu` (the integer ALU: IADD3, LOP3, SHF, VIADDMNMX, ...)."""
    if op.startswith(("IMAD.WIDE", "IMAD.HI")):
        return "wide"
    if op.startswith("IMAD"):
        return "imad"
    if op.startswith(("LD", "ST", "RED", "ATOM", "CCTL", "LDGSTS")):
        return "mem"
    if op.startswith(("BRA", "EXIT", "BAR", "BSYNC", "BSSY", "RET", "CALL", "S2R", "CS2R",
                      "DEPBAR", "WARPSYNC", "NANOSLEEP", "MEMBAR", "ERRBAR")):
        return "control"
    if op.startswith(("U", "R2UR", "S2UR")):
        return "uniform"
    return "alu"


def loop_mix(listing: list, trips: list):
    """Opcodes one thread executes: `listing` (one function of
    `kernel_report.sass_listing`) with each loop (a backward branch, in
    address order) run trips[i] times and the rest once. None if the loop
    count differs."""
    loops = [(target, addr) for addr, op, rest in listing if op.startswith("BRA")
             for target in [int(m, 16) for m in re.findall(r"0x([0-9a-f]+)", rest)[:1]]
             if target < addr]
    if len(loops) != len(trips):
        return None
    mix = collections.Counter()
    for addr, op, _ in listing:
        times = 1
        for (lo, hi), n in zip(loops, trips):
            if lo <= addr <= hi:
                times = n
        mix[op] += times
    by_pipe = collections.Counter()
    for op, n in mix.items():
        by_pipe[pipe_of(op)] += n
    return {"opcodes": dict(mix.most_common()), "pipes": dict(by_pipe),
            "instructions": sum(mix.values())}


def pipe_clocks(opcodes: dict, rates: dict, issue_rate: float = 128.0) -> dict:
    """SM clocks each resource needs for one thread's `opcodes` (a
    `loop_mix`; per SM, so a kernel of n threads over m SMs needs n / m
    times these) at the issue rates `rates` of `pipe_rates`: the multiply
    pipe (IMADs at the IMAD rate, wide ones at the slower of IMAD.WIDE and
    IMAD.HI, one after the other), the ALU (VIADDMNMX at its own rate, the
    rest at SHF's) and the issue slots (4 schedulers x 32)."""
    wide = min(rates["IMAD.WIDE"], rates["IMAD.HI"])
    mul = alu = 0.0
    for op, n in opcodes.items():
        pipe = pipe_of(op)
        if pipe == "wide":
            mul += n / wide
        elif pipe == "imad":
            mul += n / rates["IMAD"]
        elif pipe == "alu":
            alu += n / rates["VIADDMNMX" if op.startswith("VIADDMNMX") else "SHF"]
    return {"multiply_pipe": mul, "alu": alu, "issue": sum(opcodes.values()) / issue_rate}


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def max_sm_mhz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         check=True, capture_output=True, text=True).stdout
    return float(out.split()[0])


def clocks_under_load(torch, fn, seconds: float = 1.5) -> dict:
    """SM clock (MHz) and board power (W) that `nvidia-smi` samples every
    100 ms while `fn` is launched back to back for about `seconds`."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(20):
        fn()
    stop.record()
    torch.cuda.synchronize()
    n = max(20, int(seconds * 1e3 / (start.elapsed_time(stop) / 20)))
    mon = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "100"],
                           stdout=subprocess.PIPE, text=True)
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    mon.terminate()
    out, _ = mon.communicate()
    samples = [tuple(float(v) for v in line.split(",")) for line in out.splitlines()
               if line.count(",") == 1]
    samples = samples[2:-1] or samples  # the first and last samples straddle the run
    mhz = sorted(s[0] for s in samples)
    watts = sorted(s[1] for s in samples)
    return {"launches": n, "samples": len(samples), "sm_mhz_median": mhz[len(mhz) // 2],
            "sm_mhz_min": mhz[0], "power_w_median": watts[len(watts) // 2]}


def w16_shift_source(text: str, plan) -> str:
    """poseidon2.cu with the width-16 kernels on the shift-form diagonal:
    `permute<16>` takes the shift form of the internal round."""
    ks = ", ".join(str(k) for k, _ in plan)
    ns = ", ".join(str(n) for _, n in plan)
    spec = ("template <>\nstruct ShiftDiag<16> {\n"
            f"  static constexpr int k[16] = {{{ks}}};\n"
            f"  static constexpr int n[16] = {{{ns}}};\n}};\n\n")
    anchor = "template <>\nstruct ShiftDiag<24> {"
    edits = [(anchor, spec + anchor, 1),
             ("internal_round<W, kShiftDiag, kIntMp>(s, r);",
              "internal_round<W, kShiftDiag || W == 16, kIntMp>(s, r);", 1)]
    for old, new, count in edits:
        if text.count(old) != count:
            raise RuntimeError(f"poseidon2.cu no longer has {count} x {old!r}")
        text = text.replace(old, new)
    return text


def build_all(specs: dict) -> dict:
    """{name: (source, include dir)} -> {name: (library path, ptxas log)},
    one nvcc each, all started together."""
    from zkvm_prover_tpu_torch import _build

    nvcc = _build._nvcc()
    procs = {}
    for name, (src, inc) in specs.items():
        lib = OUT_DIR / f"{name}.so"
        cmd = [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(inc), "-shared", str(src),
               "-o", str(lib)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    out, failed = {}, []
    for name, (lib, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            failed.append(f"{name}:\n{log}")
        out[name] = (lib, log)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return out


def load(lib: Path, entries: dict):
    handle = ctypes.CDLL(str(lib))
    for name, argtypes in entries.items():
        fn = getattr(handle, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return handle


def check(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} failed: cudaError_t {err}")


def events_ms(torch, fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def in_turns(torch, fns: dict, reps: int, rounds: int) -> dict:
    """{name: [ms per round]}, the order reversed every other round."""
    times = {name: [] for name in fns}
    names = list(fns)
    for r in range(rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            times[name].append(events_ms(torch, fns[name], reps))
    return times


def emit(report: list, row: dict) -> None:
    report.append(row)
    print(json.dumps(row), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", action="append", default=[],
                    help="a checkout of an earlier commit to time beside this one (repeatable)")
    ap.add_argument("--w16", action="store_true", help="width 16 with the shift-form diagonal")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=str(OUT_DIR / "p2_compare.json"))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("p2_compare: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from zkvm_prover_tpu_torch import kernel_report
    from zkvm_prover_tpu_torch.fields import babybear as bb
    from zkvm_prover_tpu_torch.ops import poseidon2 as p2

    card = card_line()
    print(card, flush=True)
    report = []
    shutil.rmtree(OUT_DIR, ignore_errors=True)
    OUT_DIR.mkdir(parents=True)
    csrc = ROOT / "zkvm_prover_tpu_torch" / "csrc"
    specs = {"tree": (csrc / "poseidon2.cu", csrc)}
    for parent in args.parent:
        pc = Path(parent).resolve() / "zkvm_prover_tpu_torch" / "csrc"
        name = Path(parent).resolve().name
        if name in specs:
            raise SystemExit(f"p2_compare: two libraries named {name}")
        specs[name] = (pc / "poseidon2.cu", pc)
    if args.w16:
        wdir = OUT_DIR / "w16_shift"
        wdir.mkdir()
        shutil.copy(csrc / "babybear.cuh", wdir)
        (wdir / "poseidon2.cu").write_text(w16_shift_source(
            (csrc / "poseidon2.cu").read_text(), p2.diag_plan(p2.constants(16)[2])))
        specs["w16_shift"] = (wdir / "poseidon2.cu", wdir)
    built = build_all(specs)

    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    rates = {r["op"]: r["per_clock_per_sm"]
             for r in kernel_report.pipe_rates(str(OUT_DIR / "probe"), alu=True)}
    emit(report, {"pipe_rates": rates})
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = max_sm_mhz()

    def resources(name: str, match: str, trips=None) -> dict:
        lib, log = built[name]
        res = {k: v for k, v in kernel_report.kernel_resources(str(lib)).items() if match in k}
        ptx = {k: v for k, v in kernel_report.ptxas_resources(log).items() if match in k}
        listing = {kernel_report.short_name(k): v
                   for k, v in kernel_report.sass_listing(str(lib)).items()}
        out = {}
        for kname, row in res.items():
            mix = loop_mix(listing[kname], trips) if trips else None
            row = {**row, "ptxas": next((v for k, v in ptx.items() if k == kname), None)}
            if mix is not None:
                clocks = pipe_clocks(mix["opcodes"], rates)
                row.update(per_permutation=mix, pipe_clocks=clocks, ceiling_ms={
                    k: S24 / sms * c / (mhz * 1e3) for k, c in clocks.items()})
            out[kname] = row
        return out

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    ext, internal, diag = (t.astype(np.uint32) for t in p2.constants(24))
    c16 = [t.astype(np.uint32) for t in p2.constants(16)]
    stream = torch.cuda.current_stream().cuda_stream
    states = {n: torch.randint(0, bb.P, (n, 24), generator=gen, dtype=bb.DTYPE, device=dev)
              for n in (S24, 1001)}
    want = {n: p2.permute_plain(s) for n, s in states.items()}

    kernels24 = {}  # name -> launch(states, out)
    kernel_of = {}  # name -> (library, kernel)
    for name in built:
        if name == "w16_shift":
            continue
        lib, _ = built[name]
        two = "int shift_diag" in specs[name][0].read_text()
        h = load(lib, {"p2_set_constants24": [P, P, P],
                       "p2_permute24": [P, P, L, I, P] if two else [P, P, L, P]})
        check(h.p2_set_constants24(ext.ctypes.data, internal.ctypes.data, diag.ctypes.data),
              f"{name} constants")
        if two:
            for flag, label in ((1, "shift"), (0, "general")):
                kernels24[f"{name}_{label}"] = (lambda h, f: lambda x, y: h.p2_permute24(
                    x.data_ptr(), y.data_ptr(), x.shape[0], f, stream))(h, flag)
                kernel_of[f"{name}_{label}"] = (name, f"permute24_kernel<{'true' if flag else 'false'}>")
        else:
            kernels24[name] = (lambda h: lambda x, y: h.p2_permute24(
                x.data_ptr(), y.data_ptr(), x.shape[0], stream))(h)
            kernel_of[name] = (name, "permute24_kernel")

    outs = {}
    for kname, launch in kernels24.items():
        for n, s in states.items():
            y = torch.empty_like(s)
            check(launch(s, y), kname)
            torch.cuda.synchronize()
            if not torch.equal(y, want[n]):
                raise AssertionError(f"{kname} disagrees with permute_plain at ({n}, 24)")
        outs[kname] = torch.empty_like(states[S24])
    times = in_turns(torch, {k: (lambda f, y: lambda: f(states[S24], y))(f, outs[k])
                             for k, f in kernels24.items()}, args.reps, args.rounds)
    under_load = {k: clocks_under_load(torch, (lambda f, y: lambda: f(states[S24], y))(f, outs[k]))
                  for k, f in kernels24.items()}
    emit(report, {"clocks_under_load": under_load, "max_sm_mhz": mhz})
    for kname, ms in times.items():
        lib_name, match = kernel_of[kname]
        res = resources(lib_name, match, TRIPS)
        emit(report, {"kernel": kname, "shape": f"({S24},24)", "exact": True,
                      "ms_by_round": ms, "ms": sorted(ms)[len(ms) // 2], "card": card,
                      "resources": res})

    tree16 = resources("tree", "")
    emit(report, {"width16_resources": {k: tree16[k] for k in
                                        ("permute_kernel", "hash_rows_kernel", "compress_kernel")}})

    if args.w16:
        libs16 = {}
        for name in ("tree", "w16_shift"):
            h = load(built[name][0], {"p2_set_constants": [P, P, P], "p2_permute": [P, P, L, P],
                                      "p2_hash_rows": [P, L, I, P, P],
                                      "p2_compress": [P, L, I, P, P]})
            check(h.p2_set_constants(*(t.ctypes.data for t in c16)), f"{name} constants")
            libs16[name] = h
        mat = torch.randint(0, bb.P, (1 << 19, 495), generator=gen, dtype=bb.DTYPE, device=dev)
        st16 = torch.randint(0, bb.P, (S24, 16), generator=gen, dtype=bb.DTYPE, device=dev)
        leaves = p2.hash_rows_plain(mat)
        levels_want = p2.compress_levels_plain(leaves, 19)
        sizes = [leaves.shape[0] >> j for j in range(1, 20)]

        def hash_rows(h, out):
            return lambda: check(h.p2_hash_rows(mat.data_ptr(), mat.shape[0], mat.shape[1],
                                                out.data_ptr(), stream), "p2_hash_rows")

        def compress(h, buf):
            levels = list(torch.split(buf, sizes))

            def run():
                src = leaves
                for j in range(0, 19, p2.LEVELS_PER_LAUNCH):
                    n = min(p2.LEVELS_PER_LAUNCH, 19 - j)
                    check(h.p2_compress(src.data_ptr(), src.shape[0], n, levels[j].data_ptr(),
                                        stream), "p2_compress")
                    src = levels[j + n - 1]
                return levels
            return run

        def permute(h, out):
            return lambda: check(h.p2_permute(st16.data_ptr(), out.data_ptr(), S24, stream),
                                 "p2_permute")

        cases = {"hash_rows (2^19, 495)": (hash_rows, lambda: torch.empty_like(leaves),
                                           lambda out: [out], [leaves]),
                 "compress_levels (2^19, 19 levels)": (
                     compress, lambda: torch.empty((sum(sizes), 8), dtype=bb.DTYPE, device=dev),
                     lambda out: list(torch.split(out, sizes)), levels_want),
                 "permute (2^18, 16)": (permute, lambda: torch.empty_like(st16),
                                        lambda out: [out], [p2.permute_plain(st16)])}
        for case, (make, alloc, view, expect) in cases.items():
            fns = {}
            for name, h in libs16.items():
                out = alloc()
                fn = make(h, out)
                fn()
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(view(out), expect)):
                    raise AssertionError(f"{name} {case} disagrees with its plain version")
                fns[name] = fn
            ms = in_turns(torch, fns, args.reps, args.rounds)
            emit(report, {"width16": case, "exact": True, "card": card,
                          **{f"{k}_ms_by_round": v for k, v in ms.items()},
                          **{f"{k}_ms": sorted(v)[len(v) // 2] for k, v in ms.items()}})
        emit(report, {"w16_shift_resources": {
            k: v for k, v in resources("w16_shift", "").items()
            if k in ("permute_kernel", "hash_rows_kernel", "compress_kernel")}})

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "rows": report}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
