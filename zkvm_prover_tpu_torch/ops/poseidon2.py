"""Poseidon2 over BabyBear (width 16 and 24), and its hash modes.

The reference's `zkvm_prover_tpu/ops/poseidon2.py` on torch tensors. A batch
of S states is an (S, WIDTH) int32 tensor of Montgomery residues. External
rounds use M_E = circ(2 M4, M4, ...), internal rounds M_I = I + diag(v),
S-box x^7; 8 external rounds, 13 internal (width 16) or 21 (width 24).

Kernel K2 (`csrc/poseidon2.cu`) runs the permutation at both widths, the
row sponge (`hash_rows`) and the 2:1 compression for CUDA tensors, the
latter several Merkle levels per launch (`compress_levels`); a CPU tensor
takes the plain torch version. Width 24 is off the proving path; its
launches have their own counter (`launches_w24`), so that the proving
paths' checks that every counter moved read `launches` alone. Width 24
has two kernel instances, chosen from the installed constants: with the
standard diagonal (`shift_diag24`) the internal layer multiplies by its
entries, each +-1..4 or +-2^-n, with shifts and adds (`diag_plan`);
with any other diagonal it takes the table's products.

The host side (challenger, verifier, the wire circuit builder) permutes
with `permute_np`: the reference's native C++ permutation (`p2_native.py`),
whose numpy version `permute_np_plain` stays as its plain version.

Round constants come from SHA-256 counter-mode expansion, exactly as the
reference derives them; `load_constants` installs other tables (canonical
numpy arrays) for every consumer, the kernel's constant memory included.
"""

from __future__ import annotations

import functools
import hashlib

import numpy as np
import torch

from .. import _build
from ..fields import babybear as bb
from . import p2_native

SBOX_DEGREE = 7
ROUNDS_F = 8  # external rounds (4 initial + 4 final)
ROUNDS_P = {16: 13, 24: 21}

_DIAG16 = [
    -2, 1, 2, "1/2", 3, 4, "-1/2", -3, -4, "1/2^8", "1/4", "1/8",
    "1/2^27", "-1/2^8", "-1/16", "-1/2^27",
]
_DIAG24 = [
    -2, 1, 2, "1/2", 3, 4, "-1/2", -3, -4, "1/2^8", "1/4", "1/8",
    "1/16", "1/32", "1/64", "1/2^27", "-1/2^8", "-1/4", "-1/8", "-1/16",
    "-1/32", "-1/64", "-1/2^27", "1/2^2",
]

WIDTH = 16
RATE = 8
DIGEST = 8

launches = {"poseidon2_permute": 0, "poseidon2_hash_rows": 0,
            "poseidon2_compress": 0}
launches_w24 = {"poseidon2_permute24": 0, "poseidon2_permute24_general": 0}


def _parse_diag_entry(e) -> int:
    if isinstance(e, int):
        return e % bb.P
    neg = e.startswith("-")
    body = e.lstrip("-")
    assert body.startswith("1/")
    d = body[2:]
    if "^" in d:
        base, exp = d.split("^")
        denom = int(base) ** int(exp)
    else:
        denom = int(d)
    v = pow(denom, bb.P - 2, bb.P)
    return (-v) % bb.P if neg else v


def _expand_constants(tag: str, count: int) -> np.ndarray:
    """Field elements by SHA-256(tag || counter) rejection sampling
    (canonical form)."""
    out = []
    ctr = 0
    while len(out) < count:
        h = hashlib.sha256(
            f"zkvm-prover-tpu/poseidon2/{tag}/{ctr}".encode()).digest()
        for i in range(0, 32, 4):
            v = int.from_bytes(h[i:i + 4], "little")
            if v < bb.P and len(out) < count:
                out.append(v)
        ctr += 1
    return np.array(out, dtype=np.uint32)


@functools.lru_cache(maxsize=None)
def constants(width: int):
    """(external_rc (ROUNDS_F, width), internal_rc (ROUNDS_P,), diag (width,)),
    Montgomery uint32 numpy arrays."""
    rp = ROUNDS_P[width]
    ext = _expand_constants(f"w{width}/external", ROUNDS_F * width).reshape(
        ROUNDS_F, width)
    internal = _expand_constants(f"w{width}/internal", rp)
    diag_vals = _DIAG16 if width == 16 else _DIAG24
    diag = np.array([_parse_diag_entry(e) for e in diag_vals], dtype=np.uint32)
    return bb.to_monty_np(ext), bb.to_monty_np(internal), bb.to_monty_np(diag)


@functools.lru_cache(maxsize=None)
def _diag_terms() -> dict:
    """Canonical value -> (k, n) with value = k * 2^-n mod p, for n = 0 and
    k in +-{1, 2, 3, 4}, and for k = +-1 and n in 1..27."""
    out = {}
    for k in (1, -1, 2, -2, 3, -3, 4, -4):
        out.setdefault(k % bb.P, (k, 0))
    for n in range(1, bb.TWO_ADICITY + 1):
        v = pow(2, -n, bb.P)
        out.setdefault(v, (1, n))
        out.setdefault(bb.P - v, (-1, n))
    return out


def diag_plan(diag):
    """The shift-and-add plan of a Montgomery diagonal: per lane (k, n) with
    entry = k * 2^-n mod p (as `_diag_terms`), or None where an entry has
    no such form and the kernel must take products."""
    terms = _diag_terms()
    plan = tuple(terms.get(int(v)) for v in bb.from_monty_np(np.asarray(diag)))
    return None if None in plan else plan


# The plan compiled into the width-24 shift instance (csrc/poseidon2.cu
# `ShiftDiag<24>`): that of the standard diagonal.
SHIFT_PLAN24 = ((-2, 0), (1, 0), (2, 0), (1, 1), (3, 0), (4, 0), (-1, 1), (-3, 0),
                (-4, 0), (1, 8), (1, 2), (1, 3), (1, 4), (1, 5), (1, 6), (1, 27),
                (-1, 8), (-1, 2), (-1, 3), (-1, 4), (-1, 5), (-1, 6), (-1, 27), (1, 2))


# States the width-24 kernel holds resident on one SM (csrc/poseidon2.cu
# THREADS x P24_MIN_BLOCKS, one state per thread): a launch of this many
# states per SM fills whole waves.
PERMUTE24_WAVE_PER_SM = 128 * 8


_OVERRIDES = {}
_VERSION = [0]  # bumped by load_constants; device copies follow it


def load_constants(width: int, external, internal, diag):
    """Install other round constants (canonical numpy arrays)."""
    ext = np.asarray(external, dtype=np.uint64).reshape(ROUNDS_F, width)
    _OVERRIDES[width] = (bb.to_monty_np(ext),
                         bb.to_monty_np(np.asarray(internal, np.uint64)),
                         bb.to_monty_np(np.asarray(diag, np.uint64)))
    _VERSION[0] += 1


def reset_constants():
    """Drop every override and return to the derived tables."""
    _OVERRIDES.clear()
    _VERSION[0] += 1


def _get_constants(width):
    return _OVERRIDES.get(width) or constants(width)


_SHIFT24 = [None, False]  # (_VERSION it was read at, shift_diag24())


def shift_diag24() -> bool:
    """Whether the installed width-24 diagonal is the one the shift instance
    computes: the kernel instance follows the constants, never the caller."""
    if _SHIFT24[0] != _VERSION[0]:
        _SHIFT24[:] = [_VERSION[0], diag_plan(_get_constants(24)[2]) == SHIFT_PLAN24]
    return _SHIFT24[1]


_DEV_CONSTS = {}


def _device_constants(width, device):
    key = (width, str(device))
    hit = _DEV_CONSTS.get(key)
    if hit is None or hit[0] != _VERSION[0]:
        ext, internal, diag = _get_constants(width)
        hit = (_VERSION[0], tuple(
            torch.from_numpy(np.asarray(t, np.int64)).to(device)
            for t in (ext, internal, diag)))
        _DEV_CONSTS[key] = hit
    return hit[1]


# ---------------------------------------------------------------------------
# Plain torch permutation (int64 inside, canonical residues)
# ---------------------------------------------------------------------------

P = bb.P


def _mulw(a, b):
    return (a * b) % P * bb.R_INV % P


def _addw(a, b):
    s = a + b
    return torch.where(s >= P, s - P, s)


def _sbox_w(x):
    x2 = _mulw(x, x)
    x4 = _mulw(x2, x2)
    return _mulw(_mulw(x4, x2), x)


def _m4_w(x):
    v = x.reshape(x.shape[:-1] + (x.shape[-1] // 4, 4))
    a, b, c, d = v.unbind(-1)
    t01 = _addw(a, b)
    t23 = _addw(c, d)
    t0123 = _addw(t01, t23)
    t01123 = _addw(t0123, b)
    t01233 = _addw(t0123, d)
    out = torch.stack([_addw(t01123, t01), _addw(t01123, _addw(c, c)),
                       _addw(t01233, t23), _addw(t01233, _addw(a, a))], dim=-1)
    return out.reshape(x.shape)


def _external_linear_w(x):
    y = _m4_w(x)
    g = y.reshape(y.shape[:-1] + (y.shape[-1] // 4, 4))
    acc = g.sum(dim=-2, keepdim=True) % P
    return ((g + acc) % P).reshape(x.shape)


def _internal_linear_w(x, diag):
    acc = x.sum(dim=-1, keepdim=True) % P
    return (acc + _mulw(diag, x)) % P


def _permute_wide(x):
    """Permutation of int64 (..., width) states."""
    width = x.shape[-1]
    ext_rc, int_rc, diag = _device_constants(width, x.device)
    half = ROUNDS_F // 2
    x = _external_linear_w(x)
    for r in range(half):
        x = _external_linear_w(_sbox_w(_addw(x, ext_rc[r])))
    for r in range(int_rc.shape[0]):
        x0 = _sbox_w(_addw(x[..., :1], int_rc[r]))
        x = _internal_linear_w(torch.cat([x0, x[..., 1:]], dim=-1), diag)
    for r in range(half, ROUNDS_F):
        x = _external_linear_w(_sbox_w(_addw(x, ext_rc[r])))
    return x


def permute_plain(state):
    return _permute_wide(state.to(torch.int64)).to(bb.DTYPE)


def hash_rows_plain(matrix):
    s, c = matrix.shape
    n_blocks = max(1, -(-c // RATE))
    state = torch.zeros((s, WIDTH), dtype=torch.int64, device=matrix.device)
    for b in range(n_blocks):
        block = matrix[:, b * RATE:(b + 1) * RATE].to(torch.int64)
        state = torch.cat([block, torch.zeros((s, RATE - block.shape[1]),
                                              dtype=torch.int64,
                                              device=matrix.device),
                           state[:, RATE:]], dim=1)
        state = _permute_wide(state)
    return state[:, :DIGEST].to(bb.DTYPE)


def compress_plain(left, right):
    return permute_plain(torch.cat([left, right], dim=-1))[..., :DIGEST]


def compress_levels_plain(digests, n_levels):
    out = []
    for _ in range(n_levels):
        digests = compress_plain(digests[0::2], digests[1::2])
        out.append(digests)
    return out


# ---------------------------------------------------------------------------
# Kernel wrappers (K2)
# ---------------------------------------------------------------------------

_INSTALLED = {}  # (device index, width) -> constants version in the kernel's memory
_SET_CONSTANTS = {16: "p2_set_constants", 24: "p2_set_constants24"}


def _lib_for(device, width=WIDTH):
    lib = _build.lib()
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if _INSTALLED.get((idx, width)) != _VERSION[0]:
        ext, internal, diag = (np.ascontiguousarray(t, dtype=np.uint32)
                               for t in _get_constants(width))
        name = _SET_CONSTANTS[width]
        with torch.cuda.device(idx):
            _build.check(getattr(lib, name)(
                ext.ctypes.data, internal.ctypes.data, diag.ctypes.data), name)
        _INSTALLED[(idx, width)] = _VERSION[0]
    return lib


def _check(x, cols=None, aligned=False):
    """`aligned`: the kernel reads x's rows as 16-byte vectors."""
    if not isinstance(x, torch.Tensor) or x.dtype != bb.DTYPE or x.dim() != 2:
        raise TypeError("expected a 2-D int32 tensor")
    if cols is not None and x.shape[1] != cols:
        raise ValueError(f"expected {cols} columns, got {x.shape[1]}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    if x.device.type == "cuda":
        if not x.is_contiguous():
            raise ValueError("the Poseidon2 kernels need contiguous tensors")
        if aligned and x.data_ptr() % 16:
            raise ValueError("the Poseidon2 kernel needs a 16-byte-aligned tensor")


def permute(state):
    """Permutation of (S, width) states, width 16 or 24."""
    width = state.shape[-1]
    if width not in ROUNDS_P:
        raise ValueError(f"no Poseidon2 of width {width}")
    _check(state, aligned=True)
    if state.device.type == "cpu":
        return permute_plain(state)
    out = torch.empty_like(state)
    if state.shape[0]:
        lib = _lib_for(state.device, width)
        stream = _build.stream(state.device)
        if width == WIDTH:
            _build.check(lib.p2_permute(state.data_ptr(), out.data_ptr(),
                                        state.shape[0], stream), "p2_permute")
            launches["poseidon2_permute"] += 1
        else:
            shift = shift_diag24()
            _build.check(lib.p2_permute24(state.data_ptr(), out.data_ptr(),
                                          state.shape[0], int(shift), stream),
                         "p2_permute24")
            launches_w24["poseidon2_permute24" if shift else
                         "poseidon2_permute24_general"] += 1
    return out


def hash_rows(matrix):
    """(S, C) -> (S, 8): padding-free sponge per row, rate 8; each block
    overwrites the rate lanes, the last block zero-filled."""
    _check(matrix)
    if matrix.device.type == "cpu":
        return hash_rows_plain(matrix)
    s, c = matrix.shape
    out = torch.empty((s, DIGEST), dtype=bb.DTYPE, device=matrix.device)
    if s:
        lib = _lib_for(matrix.device)
        _build.check(lib.p2_hash_rows(matrix.data_ptr(), s, c, out.data_ptr(),
                                      _build.stream(matrix.device)),
                     "p2_hash_rows")
        launches["poseidon2_hash_rows"] += 1
    return out


# levels one compress launch builds (csrc/poseidon2.cu CP_MAX_LEVELS)
LEVELS_PER_LAUNCH = 10


def compress_levels(digests, n_levels):
    """Merkle levels over (s, 8) digests: [(s/2, 8), ..., (s/2^n, 8)], level
    j's row i the compression of level j-1's rows 2i and 2i+1. On the card
    up to LEVELS_PER_LAUNCH levels per launch, every level a view of one
    buffer."""
    _check(digests, DIGEST, aligned=True)
    s = digests.shape[0]
    if n_levels < 1 or s % (1 << n_levels):
        raise ValueError(f"{s} digests do not make {n_levels} levels")
    if digests.device.type == "cpu":
        return compress_levels_plain(digests, n_levels)
    sizes = [s >> j for j in range(1, n_levels + 1)]
    buf = torch.empty((sum(sizes), DIGEST), dtype=bb.DTYPE, device=digests.device)
    levels = list(torch.split(buf, sizes))
    if s:
        lib = _lib_for(digests.device)
        src = digests
        for j in range(0, n_levels, LEVELS_PER_LAUNCH):
            n = min(LEVELS_PER_LAUNCH, n_levels - j)
            _build.check(lib.p2_compress(src.data_ptr(), src.shape[0], n,
                                         levels[j].data_ptr(),
                                         _build.stream(digests.device)),
                         "p2_compress")
            launches["poseidon2_compress"] += 1
            src = levels[j + n - 1]
    return levels


def compress16(pairs):
    """(S, 16) rows of left || right -> (S, 8) truncated permutations."""
    _check(pairs, 2 * DIGEST, aligned=True)
    return compress_levels(pairs.reshape(-1, DIGEST), 1)[0]


def compress(left, right):
    """2-to-1 compression: (S, 8) + (S, 8) -> (S, 8)."""
    return compress16(torch.cat([left, right], dim=-1))


# ---------------------------------------------------------------------------
# Host permutation (numpy)
# ---------------------------------------------------------------------------

_P64 = np.uint64(P)
_NP64 = np.uint64(bb.NP)
_M32 = np.uint64(0xFFFFFFFF)


def _mul_np(a, b):
    """Montgomery product of uint64 arrays (REDC)."""
    t = np.asarray(a, np.uint64) * np.asarray(b, np.uint64)
    m = ((t & _M32) * _NP64) & _M32
    u = (t + m * _P64) >> np.uint64(32)
    return np.where(u >= _P64, u - _P64, u)


def _add_np(a, b):
    s = np.asarray(a, np.uint64) + np.asarray(b, np.uint64)
    return np.where(s >= _P64, s - _P64, s)


def _permute_np_numpy(state: np.ndarray) -> np.ndarray:
    width = state.shape[-1]
    ext_rc, int_rc, diag = _get_constants(width)
    x = state.astype(np.uint64)

    def sbox(v):
        v2 = _mul_np(v, v)
        v4 = _mul_np(v2, v2)
        return _mul_np(_mul_np(v4, v2), v)

    def m4(v):
        s = v.shape
        g = v.reshape(s[:-1] + (s[-1] // 4, 4))
        a, b_, c, d = g[..., 0], g[..., 1], g[..., 2], g[..., 3]
        t01 = _add_np(a, b_)
        t23 = _add_np(c, d)
        t0123 = _add_np(t01, t23)
        t01123 = _add_np(t0123, b_)
        t01233 = _add_np(t0123, d)
        out_d = _add_np(t01233, _add_np(a, a))
        out_b = _add_np(t01123, _add_np(c, c))
        out_a = _add_np(t01123, t01)
        out_c = _add_np(t01233, t23)
        return np.stack([out_a, out_b, out_c, out_d], axis=-1).reshape(s)

    def ext_lin(v):
        y = m4(v)
        s = y.reshape(y.shape[:-1] + (width // 4, 4))
        acc = s[..., 0, :]
        for i in range(1, width // 4):
            acc = _add_np(acc, s[..., i, :])
        return _add_np(s, acc[..., None, :]).reshape(v.shape)

    def int_lin(v):
        acc = v[..., 0]
        for i in range(1, width):
            acc = _add_np(acc, v[..., i])
        return _add_np(acc[..., None], _mul_np(np.asarray(diag, np.uint64), v))

    half = ROUNDS_F // 2
    x = ext_lin(x)
    for r in range(half):
        x = _add_np(x, np.asarray(ext_rc[r], np.uint64))
        x = sbox(x)
        x = ext_lin(x)
    for r in range(int_rc.shape[0]):
        x0 = sbox(_add_np(x[..., 0], np.uint64(int_rc[r])))
        x = x.copy()
        x[..., 0] = x0
        x = int_lin(x)
    for r in range(half, ROUNDS_F):
        x = _add_np(x, np.asarray(ext_rc[r], np.uint64))
        x = sbox(x)
        x = ext_lin(x)
    return x.astype(np.uint32)


def permute_np_plain(state: np.ndarray) -> np.ndarray:
    """Poseidon2 on (..., width) uint32 Montgomery numpy arrays, in numpy."""
    return _permute_np_numpy(np.asarray(state, dtype=np.uint32))


def permute_np(state: np.ndarray) -> np.ndarray:
    """Poseidon2 on (..., width) uint32 Montgomery numpy arrays, in C++ on
    the host (`p2_native`): the same values as `permute_np_plain`."""
    return p2_native.permute(state, _get_constants(state.shape[-1]))


def hash_rows_np(matrix: np.ndarray) -> np.ndarray:
    s, c = matrix.shape
    n_blocks = max(1, -(-c // RATE))
    pad = n_blocks * RATE - c
    if pad:
        matrix = np.concatenate([matrix, np.zeros((s, pad), dtype=np.uint32)],
                                axis=1)
    state = np.zeros((s, WIDTH), dtype=np.uint32)
    for b in range(n_blocks):
        state[:, :RATE] = matrix[:, b * RATE:(b + 1) * RATE]
        state = permute_np(state)
    return state[:, :DIGEST]


def compress_np(left: np.ndarray, right: np.ndarray) -> np.ndarray:
    return permute_np(np.concatenate([left, right], axis=-1))[..., :DIGEST]
