"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` is compiled by its own `nvcc` process (all started
together) for `sm_90a` into an object file, and the objects are linked into
one shared library with a plain C interface under `<repo>/build/`. The
library is bound with `ctypes`; each wrapper passes tensor pointers and the
current stream as `c_void_p`. A library whose name carries the hash of the
sources is reused; a missing `nvcc` or a failed build raises.

Nothing here runs at import time: the first kernel launch calls `lib()`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
# C entry points: name -> argtypes (all return a cudaError_t as int)
SIGNATURES = {
    "ntt_pass": [_P, _L, _P, _L, _L, _I, _I, _I, _I, _P, _P, _P, _P],
    "p2_set_constants": [_P, _P, _P],
    "p2_permute": [_P, _P, _L, _P],
    "p2_hash_rows": [_P, _L, _I, _P, _P],
    "p2_compress": [_P, _L, _I, _P, _P],
    "mont_matmul_rows": [_P, _P, _L, _I, _P, _P],
    "mont_matmul_cols": [_P, _P, _L, _I, _L, _P, _P, _P],
}

_LIB = None
build_seconds = None  # wall-clock of the last build (None: cached or unbuilt)


def _nvcc() -> str:
    cands = [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources():
    cu = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256()
    for f in sorted(CSRC.iterdir()):
        digest.update(f.name.encode())
        digest.update(f.read_bytes())
    return cu, digest.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels (if the sources changed) and return the library."""
    global build_seconds
    cu, tag = _sources()
    out = BUILD_DIR / f"libzkvm_torch_kernels-{tag}.so"
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for src in cu:
        obj = BUILD_DIR / f"{src.stem}-{tag}-{os.getpid()}.o"  # per process
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, obj, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"{src.name}:\n{log}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
         *[str(o) for _, o, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for _, obj, _ in procs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + link.stdout)
    os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _LIB
    if _LIB is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = handle
    return _LIB


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {what} failed: cudaError_t {err}")


def stream(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
