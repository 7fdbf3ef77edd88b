"""The host BN254 Pippenger MSM in C++: the reference's
`zkvm_prover_tpu/fields/bn254_native.py` over the shared, unedited
`native/bn254/bn254.cpp`, the engine of `bn254.msm_jac` on the CPU.

g++ builds the source into the port's own `build/bn254/` (rebuilt when the
source is newer; a build writes a private temporary file and renames it into
place, as `ops/p2_native.py` does); the library checked in beside the source
is never loaded. The field constants are installed from `fields/bn254.py`
at load. The reference falls back to its python path when the library is
missing; here a missing g++, a failed build or a nonzero return code raises.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path
from typing import Sequence

import numpy as np

from . import bn254 as bn

_REPO_ROOT = Path(__file__).resolve().parents[2]
_SRC = _REPO_ROOT / "native" / "bn254" / "bn254.cpp"
BUILD_DIR = _REPO_ROOT / "build" / "bn254"
_SO = BUILD_DIR / "libbn254.so"


def build_native(force: bool = False) -> Path:
    """Compile the library if it is missing or older than the source;
    return its path."""
    if _SO.exists() and not force:
        if _SO.stat().st_mtime >= _SRC.stat().st_mtime:
            return _SO
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the host BN254 MSM cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = _SO.with_suffix(f".tmp{os.getpid()}.so")
    subprocess.run([gxx, "-O3", "-shared", "-fPIC", "-std=c++17", str(_SRC), "-o", str(tmp)],
                   check=True)
    os.replace(tmp, _SO)
    return _SO


_lib = None


def _limbs64(x: int) -> np.ndarray:
    return np.frombuffer(x.to_bytes(32, "little"), dtype=np.uint64).copy()


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_native()))
        lib.bn254_init.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_uint64]
        lib.bn254_init.restype = ctypes.c_int
        lib.bn254_msm.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64,
                                  ctypes.c_uint32, ctypes.c_void_p]
        lib.bn254_msm.restype = ctypes.c_int
        r_mont = (1 << 256) % bn.Q
        consts = [_limbs64(bn.Q), _limbs64(r_mont * r_mont % bn.Q), _limbs64(r_mont)]
        inv = (-pow(bn.Q, -1, 1 << 64)) % (1 << 64)
        if lib.bn254_init(*(c.ctypes.data for c in consts), inv) != 0:
            raise RuntimeError("bn254_init failed")
        _lib = lib
    return _lib


def msm(points: Sequence, scalars: Sequence[int], c: int = 8):
    """sum_i scalars[i] * points[i] for affine points (None is infinity):
    the affine result, None for infinity."""
    lib = _load()
    n = len(points)
    aff = bytearray(64 * n)  # (0, 0) encodes infinity
    for i, p in enumerate(points):
        if p is not None:
            aff[64 * i:64 * i + 64] = p[0].to_bytes(32, "little") + p[1].to_bytes(32, "little")
    sc = b"".join((s % bn.R).to_bytes(32, "little") for s in scalars)
    aff = np.frombuffer(bytes(aff), dtype=np.uint64)
    sc = np.frombuffer(sc, dtype=np.uint8)
    out = np.zeros(12, dtype=np.uint64)
    rc = lib.bn254_msm(aff.ctypes.data, sc.ctypes.data, n, c, out.ctypes.data)
    if rc != 0:
        raise RuntimeError(f"bn254_msm failed (return code {rc})")

    def unl(a):
        return int.from_bytes(a.tobytes(), "little")

    x, y, z = unl(out[:4]), unl(out[4:8]), unl(out[8:12])
    if z == 0:
        return None
    zinv = pow(z, -1, bn.Q)
    z2 = zinv * zinv % bn.Q
    return (x * z2 % bn.Q, y * z2 * zinv % bn.Q)
