"""Pippenger MSM over BN254 G1: kernel K4 (`csrc/bn254_msm.cu`) and its
plain torch version, the reference's `zkvm_prover_tpu/ops/msm.py`.

The commitments of the SNARK wrapper (`snark/plonk.py`, `snark/wrapper.py`)
are MSMs of 2^12 and 2^13 points (`fields/bn254.py::msm_jac`). Per window of
c bits of the scalars:

- the digit split and the sort by digit are torch ops (`digits`,
  `sort_by_digit`); the reference sorts with argsort too (msm.py:188);
- `window_buckets`: per window, the points of each digit summed into its
  bucket. K4's `msm_buckets_kernel` on a CUDA tensor; on a CPU tensor the
  reference's segmented combine of the sorted points (log2 n rounds of
  `pt_add`) and a scatter of each segment's last sum;
- `window_sums`: per window, sum_k k B_k. K4's `msm_window_sums_kernel`; on
  a CPU tensor the same split into S segments of L buckets, each summed
  from the top down with a running sum (the reference runs one such scan
  of 2^c - 1 steps, msm.py:261), then sum_s A_s + L sum_s s T_s;
- the host combines the windows, sum_w 2^(c w) S_w, on python ints, as the
  reference does (msm.py:303-310).

`pt_add` / `pt_double` are the reference's unified Jacobian formulas on
`ops/bigint.py`'s Fq (16-bit limbs); K4 keeps the same Montgomery residues
in 8 words of 32 bits (`bigint.to_words`). Projective coordinates are not
unique, so the kernel and the plain version agree on affine results, not on
the bits of a bucket. A wrapper takes the plain version only for a CPU
tensor; for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .. import _build
from ..fields import bn254 as bn
from .bigint import BN254_FQ as F
from .bigint import from_words, to_words

K = F.K
N_BITS = bn.R.bit_length()  # 254: scalars are reduced mod r first

# Kernel launches by C entry point
launches = {"bn254_msm_buckets": 0, "bn254_msm_window_sums": 0, "bn254_fq_mul": 0}


def window_bits(n: int) -> int:
    """The window c for n points: 4 up to 2^7 points, then log2(n) - 3, at
    most 10 (2^13 points: 26 windows of 1,024 buckets)."""
    return min(10, max(4, n.bit_length() - 4))


def n_windows(c: int) -> int:
    return -(-N_BITS // c)


def segment_bits(c: int) -> int:
    """log2 of the segments S a window's buckets split into in
    `window_sums` (S threads of K4's second kernel): about sqrt(2^c)."""
    return min(8, c // 2)


# ---------------------------------------------------------------------------
# Jacobian lane arithmetic (plain torch, 16-bit limbs)
# ---------------------------------------------------------------------------


def _sel(mask, a, b):
    """Per-lane select over limb tensors; mask shape = lane shape."""
    return torch.where(mask[..., None], a, b)


def pt_infinity(shape, device="cpu"):
    one = torch.from_numpy(F.to_monty_int(1)).to(device).expand(*shape, K).clone()
    return (one, one.clone(), torch.zeros(*shape, K, dtype=torch.int64, device=device))


def pt_double(p):
    X, Y, Z = p
    A = F.square(X)
    B = F.square(Y)
    C = F.square(B)
    t = F.square(F.add(X, B))
    d_half = F.sub(F.sub(t, A), C)
    D = F.add(d_half, d_half)
    E = F.add(F.add(A, A), A)
    Fq2 = F.square(E)
    X3 = F.sub(F.sub(Fq2, D), D)
    eight_c = F.add(C, C)
    eight_c = F.add(eight_c, eight_c)
    eight_c = F.add(eight_c, eight_c)
    Y3 = F.sub(F.mul(E, F.sub(D, X3)), eight_c)
    Z3 = F.mul(F.add(Y, Y), Z)
    return (X3, Y3, Z3)


def pt_add(p, q):
    """Unified Jacobian add (handles P==Q, P==-Q, and infinities)."""
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    Z1Z1 = F.square(Z1)
    Z2Z2 = F.square(Z2)
    U1 = F.mul(X1, Z2Z2)
    U2 = F.mul(X2, Z1Z1)
    S1 = F.mul(F.mul(Y1, Z2), Z2Z2)
    S2 = F.mul(F.mul(Y2, Z1), Z1Z1)
    H = F.sub(U2, U1)
    Rr = F.sub(S2, S1)

    HH = F.square(H)
    HHH = F.mul(H, HH)
    V = F.mul(U1, HH)
    X3 = F.sub(F.sub(F.square(Rr), HHH), F.add(V, V))
    Y3 = F.sub(F.mul(Rr, F.sub(V, X3)), F.mul(S1, HHH))
    Z3 = F.mul(F.mul(Z1, Z2), H)

    p_inf = F.is_zero(Z1)
    q_inf = F.is_zero(Z2)
    h_zero = F.is_zero(H)
    r_zero = F.is_zero(Rr)
    same = h_zero & r_zero & ~p_inf & ~q_inf
    opp = h_zero & ~r_zero & ~p_inf & ~q_inf

    dX, dY, dZ = pt_double(p)
    Z3 = torch.where(opp[..., None], torch.zeros_like(Z3), Z3)
    X3 = _sel(same, dX, X3)
    Y3 = _sel(same, dY, Y3)
    Z3 = _sel(same, dZ, Z3)
    X3 = _sel(p_inf, X2, X3)
    Y3 = _sel(p_inf, Y2, Y3)
    Z3 = _sel(p_inf, Z2, Z3)
    X3 = _sel(q_inf, X1, X3)
    Y3 = _sel(q_inf, Y1, Y3)
    Z3 = _sel(q_inf, Z1, Z3)
    return (X3, Y3, Z3)


def _jacobian(words: torch.Tensor):
    """(..., 24) words (X, Y, Z) -> a limb point."""
    return tuple(from_words(words[..., 8 * i:8 * i + 8]) for i in range(3))


def _words(p) -> torch.Tensor:
    return torch.cat([to_words(c) for c in p], dim=-1)


# ---------------------------------------------------------------------------
# host packing
# ---------------------------------------------------------------------------


def affine_words(points: Sequence[bn.G1]) -> np.ndarray:
    """Host affine points -> (n, 16) uint32: the Montgomery x and y in
    32-bit words, (0, 0) for infinity."""
    r = 1 << 256
    raw = b"".join(b"\0" * 64 if p is None else
                   ((p[0] * r) % bn.Q).to_bytes(32, "little") + ((p[1] * r) % bn.Q).to_bytes(32, "little")
                   for p in points)
    return np.frombuffer(raw, dtype=np.uint32).reshape(len(points), 16)


def scalar_words(scalars: Sequence[int]) -> np.ndarray:
    """Scalars -> (n, 8) uint32 words of s mod r."""
    raw = b"".join((int(s) % bn.R).to_bytes(32, "little") for s in scalars)
    return np.frombuffer(raw, dtype=np.uint32).reshape(len(scalars), 8)


def words_tensor(words: np.ndarray, device) -> torch.Tensor:
    """uint32 words -> an int32 tensor of the same bits on `device`."""
    return torch.from_numpy(words.view(np.int32).copy()).to(device)


_R_INV = pow(1 << 256, -1, bn.Q)


def _host_jacobian(words: torch.Tensor) -> list:
    """(..., 24) Jacobian Montgomery words -> host Jacobian points on python
    ints (None at infinity), flattened."""
    out = []
    for row in words.reshape(-1, 24).cpu().numpy().view(np.uint32):
        X, Y, Z = (int.from_bytes(row[8 * i:8 * i + 8].tobytes(), "little") * _R_INV % bn.Q
                   for i in range(3))
        out.append(None if Z == 0 else (X, Y, Z))
    return out


def to_affine(words: torch.Tensor) -> list:
    """(..., 24) Jacobian Montgomery words -> host affine points (None at
    infinity), flattened."""
    return [bn._jac_to_affine(p) for p in _host_jacobian(words)]


# ---------------------------------------------------------------------------
# digit split and sort (torch)
# ---------------------------------------------------------------------------


def digits(scalars: torch.Tensor, c: int) -> torch.Tensor:
    """(n, 8) int32 scalar words -> (W, n) int64 digits of c bits."""
    u = scalars.to(torch.int64) & 0xFFFFFFFF
    u = torch.nn.functional.pad(u, (0, 1))
    bit = torch.arange(n_windows(c), device=scalars.device) * c
    lo = u[:, bit // 32]
    hi = u[:, bit // 32 + 1]
    sh = bit % 32
    return (((lo >> sh) | (hi << (32 - sh))) & ((1 << c) - 1)).t().contiguous()


def sort_by_digit(dig: torch.Tensor, c: int):
    """(W, n) digits -> the point indices of each window sorted by digit
    (W, n) and each bucket's run in that order, offsets (W, 2^c + 1)."""
    W = dig.shape[0]
    order = torch.sort(dig, dim=1, stable=True).indices
    counts = torch.zeros(W, 1 << c, dtype=torch.int64, device=dig.device)
    counts.scatter_add_(1, dig, torch.ones_like(dig))
    offsets = torch.nn.functional.pad(counts.cumsum(1), (1, 0))
    return order.to(torch.int32), offsets.to(torch.int32)


# ---------------------------------------------------------------------------
# the two steps: kernels and plain versions
# ---------------------------------------------------------------------------


def _check(t: torch.Tensor, shape, what: str) -> None:
    if not isinstance(t, torch.Tensor) or t.dtype != torch.int32:
        raise TypeError(f"{what} must be an int32 tensor")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what} has shape {tuple(t.shape)}, not {tuple(shape)}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} must lie on a cpu or cuda device")


def window_buckets_plain(points: torch.Tensor, dig: torch.Tensor, c: int) -> torch.Tensor:
    """The reference's bucket step: per window the points sorted by digit,
    a log2(n)-round segmented combine, and each segment's last sum
    scattered to its bucket. (n, 16) words, (W, n) digits -> (W, 2^c, 24)."""
    W, n = dig.shape
    nb = 1 << c
    dev = points.device
    x, y = from_words(points[:, :8]), from_words(points[:, 8:])
    z = torch.from_numpy(F.to_monty_int(1)).to(dev).expand(n, K)
    z = torch.where((points == 0).all(-1)[:, None], torch.zeros_like(z), z)  # (0, 0): infinity
    order = torch.sort(dig, dim=1, stable=True).indices
    seg = torch.gather(dig, 1, order)
    Xs, Ys, Zs = x[order], y[order], z[order]
    Zs = torch.where((seg == 0)[..., None], torch.zeros_like(Zs), Zs)  # digit 0: nothing
    val = (Xs, Ys, Zs)
    shift = 1
    while shift < n:
        px, py, pz = (torch.cat([v[:, :shift], v[:, :-shift]], dim=1) for v in val)
        prev = torch.cat([torch.full((W, shift), -1, dtype=seg.dtype, device=dev),
                          seg[:, :-shift]], dim=1)
        pz = torch.where((seg == prev)[..., None], pz, torch.zeros_like(pz))
        val = pt_add(val, (px, py, pz))
        shift *= 2
    nxt = torch.cat([seg[:, 1:], torch.full((W, 1), -1, dtype=seg.dtype, device=dev)], dim=1)
    slot = torch.where((seg != nxt) & (seg > 0), seg, torch.full_like(seg, nb))  # nb: dump
    bx, by, bz = pt_infinity((W, nb + 1), dev)
    rows = torch.arange(W, device=dev)[:, None]
    bx[rows, slot], by[rows, slot], bz[rows, slot] = val
    return _words((bx[:, :nb], by[:, :nb], bz[:, :nb]))


def window_sums_plain(buckets: torch.Tensor, c: int) -> torch.Tensor:
    """sum_k k B_k per window, as K4's second kernel splits it: (W, 2^c, 24)
    -> (W, 24)."""
    W = buckets.shape[0]
    log_s = segment_bits(c)
    S, L = 1 << log_s, 1 << (c - log_s)
    dev = buckets.device
    B = _jacobian(buckets.reshape(W, S, L, 24))
    run, acc = pt_infinity((W, S), dev), pt_infinity((W, S), dev)
    for j in range(L - 1, -1, -1):
        acc = pt_add(acc, run)
        run = pt_add(run, tuple(b[:, :, j] for b in B))
    run2, acc2 = pt_infinity((W,), dev), pt_infinity((W,), dev)
    for s in range(S - 1, -1, -1):
        acc2 = pt_add(acc2, run2)
        run2 = pt_add(run2, tuple(r[:, s] for r in run))
    for _ in range(c - log_s):
        acc2 = pt_double(acc2)
    while acc[0].shape[1] > 1:  # sum the A_s pairwise
        h = acc[0].shape[1] // 2
        acc = pt_add(tuple(a[:, :h] for a in acc), tuple(a[:, h:] for a in acc))
    return _words(pt_add(acc2, tuple(a[:, 0] for a in acc)))


def window_buckets(points: torch.Tensor, dig: torch.Tensor, c: int) -> torch.Tensor:
    """Per window, the sum of the points of each digit: (n, 16) int32
    Montgomery affine words, (W, n) digits -> (W, 2^c, 24) Jacobian words
    (bucket 0 at infinity)."""
    W, n = dig.shape
    _check(points, (n, 16), "points")
    if W != n_windows(c) or dig.device != points.device:
        raise ValueError("digits do not match the points or the window")
    if points.device.type == "cpu":
        return window_buckets_plain(points, dig, c)
    if not points.is_contiguous():
        raise ValueError("window_buckets needs contiguous points")
    order, offsets = sort_by_digit(dig, c)
    out = torch.empty((W, 1 << c, 24), dtype=torch.int32, device=points.device)
    _build.check(_build.lib().bn254_msm_buckets(
        points.data_ptr(), order.data_ptr(), offsets.data_ptr(), n, c, W, out.data_ptr(),
        _build.stream(points.device)), "bn254_msm_buckets")
    launches["bn254_msm_buckets"] += 1
    return out


def window_sums(buckets: torch.Tensor, c: int) -> torch.Tensor:
    """sum_k k B_k per window: (W, 2^c, 24) -> (W, 24) Jacobian words."""
    W = buckets.shape[0]
    _check(buckets, (W, 1 << c, 24), "buckets")
    if buckets.device.type == "cpu":
        return window_sums_plain(buckets, c)
    if not buckets.is_contiguous():
        raise ValueError("window_sums needs contiguous buckets")
    out = torch.empty((W, 24), dtype=torch.int32, device=buckets.device)
    _build.check(_build.lib().bn254_msm_window_sums(
        buckets.data_ptr(), W, c, segment_bits(c), out.data_ptr(),
        _build.stream(buckets.device)), "bn254_msm_window_sums")
    launches["bn254_msm_window_sums"] += 1
    return out


def fq_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery products of (n, 8) int32 words: K4's Fq core alone
    (`bn::mul`), for tests; `ops/bigint.py::Field.mul` on a CPU tensor."""
    _check(a, (a.shape[0], 8), "a")
    _check(b, tuple(a.shape), "b")
    if a.device != b.device:
        raise ValueError("operands must share one device")
    if a.device.type == "cpu":
        return to_words(F.mul(from_words(a), from_words(b)))
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("fq_mul needs contiguous tensors")
    out = torch.empty_like(a)
    if a.shape[0]:
        _build.check(_build.lib().bn254_fq_mul(a.data_ptr(), b.data_ptr(), a.shape[0],
                                               out.data_ptr(), _build.stream(a.device)),
                     "bn254_fq_mul")
        launches["bn254_fq_mul"] += 1
    return out


# ---------------------------------------------------------------------------
# the whole MSM
# ---------------------------------------------------------------------------


def combine_windows(sums: torch.Tensor, c: int) -> bn.G1:
    """sum_w 2^(c w) S_w on the host (python ints), then affine."""
    total = None
    for s_w in reversed(_host_jacobian(sums)):
        if total is not None:
            for _ in range(c):
                total = bn._jac_double(total)
        total = bn._jac_add(total, s_w)
    return bn._jac_to_affine(total)


def msm_device(points: Sequence[bn.G1], scalars: Sequence[int], device,
               c: int = None) -> bn.G1:
    """sum_i scalars[i] * points[i] (affine, None at infinity) by K4 on a
    CUDA device, by the plain version on the CPU."""
    if len(points) != len(scalars) or not points:
        raise ValueError("an MSM needs as many scalars as points, and one point at least")
    device = torch.device(device)
    c = c or window_bits(len(points))
    pts = words_tensor(affine_words(points), device)
    dig = digits(words_tensor(scalar_words(scalars), device), c)
    return combine_windows(window_sums(window_buckets(pts, dig, c), c), c)

