"""What the compiler made of the port's kernels, and the card's issue rates.

    python -m zkvm_prover_tpu_torch.kernel_report     # on a machine with a card

- `op_counts`: SASS instructions per BabyBear product (`bb::mul`, and the
  lazy signed `bb::smul` where the header has it) and per add, from a probe
  built against `csrc/babybear.cuh`: (chain of 4 - chain of 1) / 3.
- `kernel_resources`: registers, static shared memory and SASS instruction
  count of each kernel of the built library (`cuobjdump`).
- `pipe_rates`: results per clock per SM of the integer instructions the
  kernels are made of (IMAD, IMAD.WIDE, IMAD.HI, IADD3), each alone and
  IMAD.HI with IADD3 interleaved, timed with `clock64()` on the card (the
  IMAD.WIDE probe folds each product with one LOP3, an ALU op).

Everything here needs the CUDA toolkit (`nvcc`, `cuobjdump`); `pipe_rates`
also needs a card. Nothing runs at import time.
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
    "p2_permute": ["permute_kernel"], "p2_hash_rows": ["hash_rows_kernel"],
    "p2_compress": ["compress_kernel"], "mont_matmul_rows": ["mm_rows_kernel"],
    "mont_matmul_cols": ["mm_cols_kernel", "mm_cols_finish"],
}


def short_name(name: str) -> str:
    """A kernel's name without namespace and signature, mangled or not."""
    for k in (k for ks in ENTRY_KERNELS.values() for k in ks):
        if k in name:
            flag = ("<true>" if "ILb1E" in name or "<true>" in name else
                    "<false>" if "ILb0E" in name or "<false>" in name else "")
            return k + flag
    return name


def sass_functions(path: str) -> dict:
    """cuobjdump -sass of a binary -> {function: Counter of opcodes}."""
    text = subprocess.run([f"{CUDA_BIN}/cuobjdump", "-sass", path], check=True,
                          capture_output=True, text=True).stdout
    out = {}
    for part in re.split(r"\n\s*Function : ", text)[1:]:
        name = part.split("\n", 1)[0].strip()
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[0-9T]\s+)?([A-Z][A-Z0-9_.]*)",
                         part)
        out[name] = collections.Counter(op for op in ops if op != "NOP")
    return out


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
    """{kernel: {"registers", "shared_bytes", "instructions"}} of a library."""
    text = subprocess.run([f"{CUDA_BIN}/cuobjdump", "-res-usage", lib_path], check=True,
                          capture_output=True, text=True).stdout
    res = {}
    for name, regs, shared in re.findall(
            r"Function (\S+):\s*\n\s*REG:(\d+) STACK:\d+ SHARED:(\d+)", text):
        res[name] = {"registers": int(regs), "shared_bytes": int(shared)}
    for name, ops in sass_functions(lib_path).items():
        if name in res:
            res[name]["instructions"] = sum(ops.values())
    return {short_name(name): row for name, row in res.items()}


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
int main() {
  int sms; cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  uint32_t* out; long long* cyc;
  cudaMalloc(&out, 2 * sms * THREADS * 4); cudaMalloc(&cyc, 2 * sms * 8);
  run<0>("IMAD", 1, sms, out, cyc);
  run<1>("IMAD.WIDE", 1, sms, out, cyc);
  run<2>("IMAD.HI", 1, sms, out, cyc);
  run<3>("IADD3", 1, sms, out, cyc);
  run<4>("IMAD.HI + IADD3", 2, sms, out, cyc);
  return 0;
}
"""


def pipe_rates(build_dir: str) -> list:
    """[{"op", "per_clock_per_sm", "sass"}]: instructions completed per SM
    clock, all SMs loaded (the SASS opcodes of each probe kernel beside)."""
    os.makedirs(build_dir, exist_ok=True)
    src = os.path.join(build_dir, "pipe_probe.cu")
    exe = os.path.join(build_dir, "pipe_probe")
    with open(src, "w") as f:
        f.write(PIPE_PROBE)
    _nvcc([src, "-o", exe])
    sass = [ops for name, ops in sorted(sass_functions(exe).items()) if "ILi" in name]
    run = subprocess.run([exe], check=True, capture_output=True, text=True).stdout
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
                      "pipes": pipe_rates(probe_dir)}, indent=1))


if __name__ == "__main__":
    main()
