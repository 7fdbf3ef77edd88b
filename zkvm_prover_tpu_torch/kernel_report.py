"""What the compiler made of the port's kernels, and the card's issue rates.

    python -m zkvm_prover_tpu_torch.kernel_report     # on a machine with a card

- `op_counts`: SASS instructions per BabyBear product (`bb::mul`, and the
  lazy signed `bb::smul` where the header has it) and per add, from a probe
  built against `csrc/babybear.cuh`: (chain of 4 - chain of 1) / 3.
- `kernel_resources`: registers, static shared memory, SASS instruction
  count, wide multiplies (IMAD.WIDE, IMAD.HI) and calls (a 64-bit division
  or remainder by a variable is a called routine) of each kernel of the
  built library (`cuobjdump`).
- `ptxas_resources`: what `-Xptxas -v` said of each kernel at the build
  (registers, stack frame, spill stores and loads).
- `sass_listing`: each kernel's SASS as (address, opcode, operands).
- `pipe_rates`: results per clock per SM of the integer instructions the
  kernels are made of (IMAD, IMAD.WIDE, IMAD.HI, IADD3), each alone and
  IMAD.HI with IADD3 interleaved, timed with `clock64()` on the card (the
  IMAD.WIDE probe folds each product with one LOP3, an ALU op); with
  `alu=True` also SHF, IMAD with SHF interleaved and the fused add-and-min
  VIADDMNMX of every modular add (the compiler may merge two dependent
  adds into one three-input IADD3, so the IADD3 row can read up to twice
  its issue rate, which the SHF row, a funnel shift by a run-time amount,
  cannot).
- `kernel_census`: one call under torch.profiler with device activity
  only: launches and device ms per kernel (the port's, the plain torch
  kernels, copies), device busy time and the idle share.

Everything here needs the CUDA toolkit (`nvcc`, `cuobjdump`); `pipe_rates`
and `kernel_census` also need a card. Nothing runs at import time.
"""

from __future__ import annotations

import collections
import json
import os
import re
import subprocess

CUDA_BIN = "/usr/local/cuda/bin"
# C entry point of the library -> the kernels it launches, in order
ENTRY_KERNELS = {
    "ntt_pass": ["ntt_pass_kernel"],
    "p2_permute": ["permute_kernel"], "p2_permute24": ["permute24_kernel"],
    "p2_hash_rows": ["hash_rows_kernel"],
    "p2_compress": ["compress_kernel"], "mont_matmul_rows": ["mm_rows_kernel"],
    "mont_matmul_cols": ["mm_cols_kernel", "mm_cols_finish"],
    "bn254_msm_chunks": ["msm_chunks_kernel"], "bn254_msm_reduce": ["msm_reduce_kernel"],
    "bn254_msm_window_sums": ["msm_window_sums_kernel"],
    "bn254_fq_mul": ["fq_mul_kernel"],
}
# the entries of K4, which only the SNARK wrapper's commitments launch
SNARK_ENTRIES = ("bn254_msm_chunks", "bn254_msm_reduce", "bn254_msm_window_sums",
                 "bn254_fq_mul")


def short_name(name: str) -> str:
    """A kernel's name without namespace and signature, mangled or not, with
    its bool or int template argument."""
    for k in (k for ks in ENTRY_KERNELS.values() for k in ks):
        if k in name:
            num = re.search(re.escape(k) + r"(?:ILi(\d+)E|<(\d+)>)", name)
            flag = ("<true>" if "ILb1E" in name or "<true>" in name else
                    "<false>" if "ILb0E" in name or "<false>" in name else
                    f"<{num.group(1) or num.group(2)}>" if num else "")
            return k + flag
    return name


def kernel_census(fn) -> dict:
    """`fn()` under torch.profiler with device activity only (no chrome
    trace is written): kernel launches and device ms by kind from the raw
    device records, the union of their intervals as device busy time, and
    the idle share over the call's host wall-clock."""
    import time

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ours = set(k for ks in ENTRY_KERNELS.values() for k in ks)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    per_kind = collections.defaultdict(lambda: [0, 0.0])
    spans = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        name = e.name()
        start, dur = e.start_ns(), e.duration_ns()
        spans.append((start, start + dur))
        if name.startswith(("Memcpy", "Memset")):
            kind = name.split()[0].lower()
        else:
            kind = short_name(name)
            if kind.split("<")[0] not in ours:
                kind = "plain torch kernels"
        per_kind[kind][0] += 1
        per_kind[kind][1] += dur / 1e6
    spans.sort()
    busy, end = 0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    busy_ms = busy / 1e6
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms, "idle_share": 1 - busy_ms / wall_ms,
            "per_kind": {k: {"launches": n, "ms": ms} for k, (n, ms) in
                         sorted(per_kind.items(), key=lambda kv: -kv[1][1])}}


_SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[0-9T]\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")


def sass_listing(path: str) -> dict:
    """cuobjdump -sass of a binary -> {function: [(address, opcode, operands)]}."""
    text = subprocess.run([f"{CUDA_BIN}/cuobjdump", "-sass", path], check=True,
                          capture_output=True, text=True).stdout
    out = {}
    for part in re.split(r"\n\s*Function : ", text)[1:]:
        name = part.split("\n", 1)[0].strip()
        out[name] = [(int(a, 16), op, rest.strip()) for a, op, rest in _SASS_LINE.findall(part)
                     if op != "NOP"]
    return out


def sass_functions(path: str) -> dict:
    """cuobjdump -sass of a binary -> {function: Counter of opcodes}."""
    return {name: collections.Counter(op for _, op, _ in listing)
            for name, listing in sass_listing(path).items()}


def _nvcc(args):
    subprocess.run([f"{CUDA_BIN}/nvcc", "-arch=sm_90a", "-O3", *args], check=True,
                   capture_output=True, text=True)


OP_PROBE = r"""
#include "babybear.cuh"
#define CHAIN1(f, x, y) f(x, y)
#define CHAIN4(f, x, y) f(f(f(f(x, y), y), y), y)
#define PROBE(name, T, f, chain) extern "C" __global__ void name(const T* a, T* o) \
  { const T x = a[threadIdx.x], y = a[threadIdx.x + 32]; o[threadIdx.x] = chain(f, x, y); }
PROBE(mul1, uint32_t, bb::mul, CHAIN1)
PROBE(mul4, uint32_t, bb::mul, CHAIN4)
PROBE(add1, uint32_t, bb::add, CHAIN1)
PROBE(add4, uint32_t, bb::add, CHAIN4)
#ifdef HAS_SMUL
PROBE(smul1, int32_t, bb::smul, CHAIN1)
PROBE(smul4, int32_t, bb::smul, CHAIN4)
#endif
"""


def op_counts(csrc: str, build_dir: str) -> dict:
    """{op: {"instructions": n, "opcodes": {opcode: n}}} per BabyBear op."""
    os.makedirs(build_dir, exist_ok=True)
    src = os.path.join(build_dir, "op_probe.cu")
    cubin = os.path.join(build_dir, "op_probe.cubin")
    with open(src, "w") as f:
        f.write(OP_PROBE)
    with open(os.path.join(csrc, "babybear.cuh")) as f:
        has_smul = "smul" in f.read()
    _nvcc(["-cubin", "-I", csrc, *(["-DHAS_SMUL"] if has_smul else []), src, "-o", cubin])
    funcs = sass_functions(cubin)
    out = {}
    for op in ("mul", "smul", "add"):
        if f"{op}4" in funcs:
            one, four = funcs[f"{op}1"], funcs[f"{op}4"]
            per = {k: (four[k] - one[k]) / 3 for k in four if four[k] != one[k]}
            out[op] = {"instructions": sum(per.values()), "opcodes": per}
    return out


def kernel_resources(lib_path: str) -> dict:
    """{kernel: {"registers", "shared_bytes", "instructions", "wide_muls",
    "calls"}} of a library."""
    text = subprocess.run([f"{CUDA_BIN}/cuobjdump", "-res-usage", lib_path], check=True,
                          capture_output=True, text=True).stdout
    res = {}
    for name, regs, shared in re.findall(
            r"Function (\S+):\s*\n\s*REG:(\d+) STACK:\d+ SHARED:(\d+)", text):
        res[name] = {"registers": int(regs), "shared_bytes": int(shared)}
    for name, ops in sass_functions(lib_path).items():
        if name in res:
            res[name]["instructions"] = sum(ops.values())
            res[name]["wide_muls"] = sum(n for op, n in ops.items()
                                         if op.startswith(("IMAD.WIDE", "IMAD.HI")))
            res[name]["calls"] = sum(n for op, n in ops.items() if op.startswith("CALL"))
    return {short_name(name): row for name, row in res.items()}


def ptxas_resources(log: str) -> dict:
    """{kernel: {"registers", "stack_bytes", "spill_stores", "spill_loads"}}
    from a build's `-Xptxas -v` output (`_build.ptxas_log`)."""
    out = {}
    for part in re.split(r"Compiling entry function '", log)[1:]:
        name = part.split("'", 1)[0]
        props = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", part)
        regs = re.search(r"Used (\d+) registers", part)
        out[short_name(name)] = {
            "registers": int(regs.group(1)) if regs else None,
            **({"stack_bytes": int(props.group(1)), "spill_stores": int(props.group(2)),
                "spill_loads": int(props.group(3))} if props else {})}
    return out


PIPE_PROBE = r"""
#include <cstdint>
#include <cstdio>
#include <cuda_runtime.h>
constexpr int CH = 8, ITERS = 4096, THREADS = 1024;
template <int OP>
__global__ void __launch_bounds__(THREADS, 2) k(uint32_t* out, long long* cyc) {
  uint32_t a[CH], b[CH];
  const uint32_t x = threadIdx.x | 1;
  for (int i = 0; i < CH; ++i) { a[i] = threadIdx.x * 7 + i; b[i] = threadIdx.x ^ (i * 13); }
  __syncthreads();
  const long long t0 = clock64();
  for (int it = 0; it < ITERS; ++it) {
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      if (OP == 0) asm volatile("mad.lo.u32 %0, %0, %1, %2;" : "+r"(a[i]) : "r"(x), "r"(b[i]));
      if (OP == 1) asm volatile("{.reg .s64 t; .reg .b32 l, h; mul.wide.s32 t, %0, %1;"
                                " mov.b64 {l, h}, t; xor.b32 %0, l, h;}" : "+r"(a[i]) : "r"(x));
      if (OP == 2) asm volatile("mul.hi.s32 %0, %0, %1;" : "+r"(a[i]) : "r"(x));
      if (OP == 3) asm volatile("add.u32 %0, %0, %1;" : "+r"(a[i]) : "r"(x));
      if (OP == 4) {
        asm volatile("mul.hi.s32 %0, %0, %1;" : "+r"(a[i]) : "r"(x));
        asm volatile("add.u32 %0, %0, %1;" : "+r"(b[i]) : "r"(x));
      }
      if (OP == 5) asm volatile("shf.l.wrap.b32 %0, %0, %0, %1;" : "+r"(a[i]) : "r"(x));
      if (OP == 6) {
        asm volatile("mad.lo.u32 %0, %0, %1, %2;" : "+r"(a[i]) : "r"(x), "r"(b[i]));
        asm volatile("shf.l.wrap.b32 %0, %0, %0, %1;" : "+r"(b[i]) : "r"(x));
      }
      if (OP == 7)
        asm volatile("{.reg .u32 t; add.u32 t, %0, %1; min.u32 %0, t, %2;}"
                     : "+r"(a[i]) : "r"(x), "r"(b[i]));
    }
  }
  const long long t1 = clock64();
  uint32_t s = 0;
  for (int i = 0; i < CH; ++i) s += a[i] + b[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0) cyc[blockIdx.x] = t1 - t0;
}
template <int OP>
void run(const char* name, int per_iter, int sms, uint32_t* out, long long* cyc) {
  const int blocks = 2 * sms;  // two 1024-thread blocks fill each SM
  k<OP><<<blocks, THREADS>>>(out, cyc);
  k<OP><<<blocks, THREADS>>>(out, cyc);
  cudaError_t e = cudaDeviceSynchronize();
  long long c[1024], worst = 0;
  cudaMemcpy(c, cyc, blocks * sizeof(long long), cudaMemcpyDeviceToHost);
  for (int i = 0; i < blocks; ++i) worst = c[i] > worst ? c[i] : worst;
  printf("{\"op\": \"%s\", \"per_clock_per_sm\": %.2f, \"err\": %d}\n", name,
         2.0 * THREADS * ITERS * CH * per_iter / worst, (int)e);
}
int main(int argc, char**) {
  int sms; cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  uint32_t* out; long long* cyc;
  cudaMalloc(&out, 2 * sms * THREADS * 4); cudaMalloc(&cyc, 2 * sms * 8);
  run<0>("IMAD", 1, sms, out, cyc);
  run<1>("IMAD.WIDE", 1, sms, out, cyc);
  run<2>("IMAD.HI", 1, sms, out, cyc);
  run<3>("IADD3", 1, sms, out, cyc);
  run<4>("IMAD.HI + IADD3", 2, sms, out, cyc);
  if (argc > 1) {  // the ALU probes
    run<5>("SHF", 1, sms, out, cyc);
    run<6>("IMAD + SHF", 2, sms, out, cyc);
    run<7>("VIADDMNMX", 1, sms, out, cyc);
  }
  return 0;
}
"""


def pipe_rates(build_dir: str, alu: bool = False) -> list:
    """[{"op", "per_clock_per_sm", "sass"}]: instructions completed per SM
    clock, all SMs loaded (the SASS opcodes of each probe kernel beside);
    `alu` adds the SHF, IMAD + SHF and VIADDMNMX probes."""
    os.makedirs(build_dir, exist_ok=True)
    src = os.path.join(build_dir, "pipe_probe.cu")
    exe = os.path.join(build_dir, "pipe_probe")
    with open(src, "w") as f:
        f.write(PIPE_PROBE)
    _nvcc([src, "-o", exe])
    sass = [ops for name, ops in sorted(sass_functions(exe).items()) if "ILi" in name]
    run = subprocess.run([exe, *(["alu"] if alu else [])], check=True, capture_output=True,
                         text=True).stdout
    rows = [json.loads(line) for line in run.splitlines() if line.startswith("{")]
    for row, ops in zip(rows, sass):
        row["sass"] = dict(ops.most_common(4))
    if any(row["err"] for row in rows):
        raise RuntimeError(f"pipe probe failed: {rows}")
    return rows


def main() -> None:
    from . import _build

    lib = str(_build.build())
    probe_dir = str(_build.BUILD_DIR / "probe")
    print(json.dumps({"ops": op_counts(str(_build.CSRC), probe_dir),
                      "kernels": kernel_resources(lib),
                      "ptxas": ptxas_resources(_build.ptxas_log()),
                      "pipes": pipe_rates(probe_dir)}, indent=1))


if __name__ == "__main__":
    main()
