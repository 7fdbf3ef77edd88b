"""The host Poseidon2 permutation in C++: the reference's
`zkvm_prover_tpu/ops/p2_native.py` (its `permute`), the engine of
`ops/poseidon2.py::permute_np`.

The host permutes one state at a time in its hot paths (the challenger's
duplex, the verifier's Merkle paths, the wire circuit builder's Poseidon2
rows); numpy spends milliseconds of call overhead on each. g++ builds the
shared, unedited `native/poseidon2/poseidon2.cpp` into `build/poseidon2/`
(rebuilt when the source is newer; a build writes a private temporary file
and renames it into place, as `vm/executor.py` does), and the caller's
round-constant tables are installed before first use and again whenever
they change, so the result equals the numpy permutation bit for bit. A
missing g++, or a nonzero return code from the library, raises.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from ..fields import babybear as bb

_REPO_ROOT = Path(__file__).resolve().parents[2]
_SRC = _REPO_ROOT / "native" / "poseidon2" / "poseidon2.cpp"
BUILD_DIR = _REPO_ROOT / "build" / "poseidon2"
_SO = BUILD_DIR / "libposeidon2.so"


def build_native(force: bool = False) -> Path:
    """Compile the library if it is missing or older than the source;
    return its path."""
    if _SO.exists() and not force:
        if _SO.stat().st_mtime >= _SRC.stat().st_mtime:
            return _SO
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the host Poseidon2 permutation cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = _SO.with_suffix(f".tmp{os.getpid()}.so")
    subprocess.run([gxx, "-O3", "-shared", "-fPIC", "-std=c++17", str(_SRC), "-o", str(tmp),
                    "-lpthread"], check=True)
    os.replace(tmp, _SO)
    return _SO


_lib = None
_installed = {}  # width -> the tables object installed in the library


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_native()))
        lib.p2_init.argtypes = [ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
                                ctypes.c_void_p, ctypes.c_uint32, ctypes.c_void_p,
                                ctypes.c_uint32, ctypes.c_void_p]
        lib.p2_init.restype = ctypes.c_int
        lib.p2_permute.argtypes = [ctypes.c_uint32, ctypes.c_uint64, ctypes.c_void_p]
        lib.p2_permute.restype = ctypes.c_int
        _lib = lib
    return _lib


def permute(state: np.ndarray, tables) -> np.ndarray:
    """Poseidon2 on (..., width) uint32 Montgomery states; tables: the
    (external, internal, diag) Montgomery constants of that width (a new
    tables object is installed before use)."""
    width = state.shape[-1]
    lib = _load()
    if _installed.get(width) is not tables:
        ext, internal, diag = (np.ascontiguousarray(t, dtype=np.uint32) for t in tables)
        if lib.p2_init(bb.P, bb.NP, width, ext.ctypes.data, ext.shape[0],
                       internal.ctypes.data, internal.shape[0], diag.ctypes.data) != 0:
            raise ValueError(f"no native Poseidon2 of width {width}")
        _installed[width] = tables
    out = np.array(state, dtype=np.uint32, order="C")
    if lib.p2_permute(width, out.size // width, out.ctypes.data) != 0:
        raise RuntimeError(f"the native Poseidon2 of width {width} failed")
    return out
