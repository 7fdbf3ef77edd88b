"""ctypes binding to the native RV32IM executor (`native/vm/rv32im.cpp`).

Host-side guest execution with one record per cycle: the port's copy of
the reference's `zkvm_prover_tpu/vm/executor.py`, same API and constants.
The C++ source is shared with the reference and only read here: it is
built with g++ into the port's own `build/rv32im/librv32im.so` (a plain C
ABI, no Python headers), never into the reference's artifact beside the
source. The library is rebuilt when the source is newer; a build writes a
private temporary file and renames it into place, so processes that build
at the same time (test workers) never load a half-written library.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path
from typing import List

import numpy as np

_REPO_ROOT = Path(__file__).resolve().parents[2]
_SRC = _REPO_ROOT / "native" / "vm" / "rv32im.cpp"
BUILD_DIR = _REPO_ROOT / "build" / "rv32im"
_SO = BUILD_DIR / "librv32im.so"

RECORD_FIELDS = 7  # pc, instr, rs1_val, rs2_val, rd_val, mem_addr, mem_val

# run states
RUNNING = 0
HALTED = 1
PAUSED = 2
TRAPPED = 3


def build_native(force: bool = False) -> Path:
    """Compile the executor if the library is missing or older than the
    source; return the library's path. A missing g++ raises."""
    if _SO.exists() and not force:
        if _SO.stat().st_mtime >= _SRC.stat().st_mtime:
            return _SO
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the RV32IM executor cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = _SO.with_suffix(f".tmp{os.getpid()}.so")
    subprocess.run(
        [gxx, "-O2", "-shared", "-fPIC", "-std=c++17", str(_SRC), "-o", str(tmp)],
        check=True,
    )
    os.replace(tmp, _SO)
    return _SO


_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_native()))
        lib.vm_create.restype = ctypes.c_void_p
        lib.vm_destroy.argtypes = [ctypes.c_void_p]
        lib.vm_set_record_trace.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.vm_load_program.argtypes = [
            ctypes.c_void_p, ctypes.c_uint32, ctypes.c_char_p, ctypes.c_uint64,
        ]
        lib.vm_set_pc.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
        lib.vm_set_reg.argtypes = [
            ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32,
        ]
        lib.vm_get_reg.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
        lib.vm_get_reg.restype = ctypes.c_uint32
        lib.vm_get_pc.argtypes = [ctypes.c_void_p]
        lib.vm_get_pc.restype = ctypes.c_uint32
        lib.vm_set_hints.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64,
        ]
        lib.vm_run.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.vm_run.restype = ctypes.c_int
        lib.vm_cycles.argtypes = [ctypes.c_void_p]
        lib.vm_cycles.restype = ctypes.c_uint64
        lib.vm_exit_code.argtypes = [ctypes.c_void_p]
        lib.vm_exit_code.restype = ctypes.c_uint32
        lib.vm_num_records.argtypes = [ctypes.c_void_p]
        lib.vm_num_records.restype = ctypes.c_uint64
        lib.vm_copy_records.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint32),
        ]
        lib.vm_clear_records.argtypes = [ctypes.c_void_p]
        lib.vm_begin_segment.argtypes = [ctypes.c_void_p]
        lib.vm_num_touched.argtypes = [ctypes.c_void_p]
        lib.vm_num_touched.restype = ctypes.c_uint64
        lib.vm_copy_touched.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint32),
        ]
        lib.vm_num_public_values.argtypes = [ctypes.c_void_p]
        lib.vm_num_public_values.restype = ctypes.c_uint64
        lib.vm_copy_public_values.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint32),
        ]
        lib.vm_load_mem32.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
        lib.vm_load_mem32.restype = ctypes.c_uint32
        lib.vm_store_mem32.argtypes = [
            ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32,
        ]
        _lib = lib
    return _lib


class Rv32Executor:
    """One guest VM instance."""

    def __init__(self, record_trace: bool = True):
        self._lib = _load()
        self._h = ctypes.c_void_p(self._lib.vm_create())
        self._lib.vm_set_record_trace(self._h, 1 if record_trace else 0)

    def __del__(self):
        try:
            self._lib.vm_destroy(self._h)
        except Exception:
            pass

    def load_program(self, words_or_bytes, addr: int = 0) -> None:
        if isinstance(words_or_bytes, (bytes, bytearray)):
            data = bytes(words_or_bytes)
        else:
            data = np.asarray(words_or_bytes, dtype="<u4").tobytes()
        self._lib.vm_load_program(self._h, addr, data, len(data))

    def set_pc(self, pc: int) -> None:
        self._lib.vm_set_pc(self._h, pc)

    def set_reg(self, idx: int, val: int) -> None:
        self._lib.vm_set_reg(self._h, idx, val & 0xFFFFFFFF)

    def get_reg(self, idx: int) -> int:
        return int(self._lib.vm_get_reg(self._h, idx))

    @property
    def pc(self) -> int:
        return int(self._lib.vm_get_pc(self._h))

    def set_hints(self, data: bytes) -> None:
        self._lib.vm_set_hints(self._h, bytes(data), len(data))

    def run(self, max_cycles: int = 1 << 62) -> int:
        """Returns HALTED, PAUSED (cycle budget reached) or TRAPPED."""
        return int(self._lib.vm_run(self._h, max_cycles))

    @property
    def cycles(self) -> int:
        return int(self._lib.vm_cycles(self._h))

    @property
    def exit_code(self) -> int:
        return int(self._lib.vm_exit_code(self._h))

    def records(self) -> np.ndarray:
        """(n, 7) uint32: pc, instr, rs1_val, rs2_val, rd_val, mem_addr,
        mem_val."""
        n = int(self._lib.vm_num_records(self._h))
        out = np.zeros((n, RECORD_FIELDS), dtype=np.uint32)
        if n:
            self._lib.vm_copy_records(
                self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))
            )
        return out

    def clear_records(self) -> None:
        self._lib.vm_clear_records(self._h)

    def begin_segment(self) -> None:
        """Clear records and start first-touch tracking (continuations)."""
        self._lib.vm_begin_segment(self._h)

    def touched(self) -> np.ndarray:
        """(n, 3) uint32 (word_addr, old_val, new_val) since begin_segment."""
        n = int(self._lib.vm_num_touched(self._h))
        out = np.zeros((n, 3), dtype=np.uint32)
        if n:
            self._lib.vm_copy_touched(
                self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))
            )
        return out

    def public_values(self) -> List[int]:
        n = int(self._lib.vm_num_public_values(self._h))
        out = np.zeros(n, dtype=np.uint32)
        if n:
            self._lib.vm_copy_public_values(
                self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))
            )
        return [int(v) for v in out]

    def load_mem32(self, addr: int) -> int:
        return int(self._lib.vm_load_mem32(self._h, addr))

    def store_mem32(self, addr: int, val: int) -> None:
        self._lib.vm_store_mem32(self._h, addr, val & 0xFFFFFFFF)
