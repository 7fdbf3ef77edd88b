"""Pippenger MSM over BN254 G1: kernel K4 (`csrc/bn254_msm.cu`) and its
plain torch version, the reference's `zkvm_prover_tpu/ops/msm.py`.

The commitments of the SNARK wrapper (`snark/plonk.py`, `snark/wrapper.py`)
are MSMs of 2^12 and 2^13 points (`fields/bn254.py::msm_jac`). Per window of
c bits of the scalars:

- the digit split and the sort by digit are torch ops (`digits`,
  `sort_by_digit`); the reference sorts with argsort too (msm.py:188);
- `window_buckets`: per window, the points of each digit summed into its
  bucket. On a CUDA tensor: `chunk_plan` (torch) lists the live entries of
  all windows in (window, digit) order and cuts them into chunks of m
  points; `chunk_partials` (K4's `msm_chunks_kernel`) sums each chunk's runs
  of equal digits, writing a bucket that one chunk holds whole and leaving
  a piece where a chunk's edge cuts a bucket; `reduce_segments`
  (`msm_reduce_kernel`, one launch a level) sums the pieces of each bucket
  by trees over tiles of 128 until one tile holds the rest. On a CPU
  tensor the reference's segmented combine of the sorted points (log2 n
  rounds of `pt_add`) and a scatter of each segment's last sum;
- `window_sums`: per window, sum_k k B_k. K4's `msm_window_sums_kernel`;
  on a CPU tensor the same split into S leaves of L buckets, each summed
  from the top down with a running sum (the reference runs one such scan
  of 2^c - 1 steps, msm.py:261), then a tree over the leaves whose nodes
  carry A, V = sum_s s T_s and D = size T: sum_k k B_k = A + L V;
- the host combines the windows, sum_w 2^(c w) S_w, on python ints, as the
  reference does (msm.py:303-310).

Beside each kernel is its plain torch version (`chunk_partials_plain`,
`reduce_level_plain`, `window_sums_plain`), which repeats its split on
lanes. `pt_add` / `pt_double` are the reference's unified Jacobian formulas
on `ops/bigint.py`'s Fq (16-bit limbs); K4 keeps the same Montgomery
residues in 8 words of 32 bits (`bigint.to_words`). Projective coordinates
are not unique, so the kernel and the plain version agree on affine
results, not on the bits of a bucket. A wrapper takes the plain version
only for a CPU tensor; for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence

import numpy as np
import torch

from .. import _build
from ..fields import bn254 as bn
from .bigint import BN254_FQ as F
from .bigint import from_words, to_words

K = F.K
N_BITS = bn.R.bit_length()  # 254: scalars are reduced mod r first

# Kernel launches by C entry point
launches = {"bn254_msm_chunks": 0, "bn254_msm_reduce": 0, "bn254_msm_window_sums": 0,
            "bn254_fq_mul": 0}

# csrc/bn254_msm.cu's launch shapes
CHUNK_THREADS_PER_SM = 512  # msm_chunks_kernel: __launch_bounds__(128, 4), <= 128 registers
CHUNK_MIN = 8               # points a chunk takes at least
TILE = 128                  # slots a CTA of msm_reduce_kernel sums
SUM_THREADS = 512           # leaves of a window: one CTA of msm_window_sums_kernel
H100_SMS = 132              # the card's SMs, for a plan made on the CPU


def window_bits(n: int) -> int:
    """The window c for n points: 4 up to 2^7 points, then log2(n) - 3, at
    most 10 (2^13 points: 26 windows of 1,024 buckets)."""
    return min(10, max(4, n.bit_length() - 4))


def n_windows(c: int) -> int:
    return -(-N_BITS // c)


def sum_bits(c: int) -> int:
    """log2 of the leaves S a window's buckets split into in `window_sums`:
    one CTA of up to 512 leaves a window, L = 2^c / S buckets a leaf (c =
    10: L = 2; c <= 9: L = 1)."""
    return min(c, 9)


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    if device.type != "cuda":
        return H100_SMS
    return torch.cuda.get_device_properties(device).multi_processor_count


def chunk_size(live: int, device) -> int:
    """Points a chunk of `msm_chunks_kernel` sums: CHUNK_MIN, or more where
    `live` entries would give more chunks than the card holds resident
    threads (512 an SM). Each piece a chunk leaves costs a full add and a
    slot in the reduction, so chunks shorter than 8 were slower on the card
    (PERF.md)."""
    resident = CHUNK_THREADS_PER_SM * _sms(torch.device(device))
    return max(CHUNK_MIN, -(-live // resident))


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


class ChunkPlan(NamedTuple):
    """The live entries of all windows in (window, digit) order, cut into
    chunks of m: chunk t is entries [t m, min(t m + m, live))."""
    idx: torch.Tensor        # (live,) int32: the point of each entry
    key: torch.Tensor        # (live,) int32: its bucket, w 2^c + digit
    m: int
    piece_key: torch.Tensor  # (2 chunks,) int32: each chunk's head and tail piece's bucket

    def starts(self) -> torch.Tensor:
        """(chunks + 1,) the chunks' first entries, then `live`."""
        live = self.key.shape[0]
        return torch.arange(0, live + self.m, self.m, device=self.key.device).clamp_(max=live)


def piece_keys(keys: torch.Tensor, size: int) -> torch.Tensor:
    """The bucket of each group's two piece slots, for groups of `size`
    consecutive entries (`keys`, -1 for an empty entry; a bucket's entries
    lie side by side): slot 2g holds group g's first run if it began in an
    earlier group, slot 2g + 1 its last run if it goes on in a later one
    (-1: no piece). A bucket's slots then lie side by side again. The rule
    of `msm_chunks_kernel` (the plan gives it) and of `msm_reduce_kernel`
    (which writes it for the next level)."""
    n = keys.shape[0]
    groups = -(-n // size)
    out = torch.full((groups, 2), -1, dtype=keys.dtype, device=keys.device)
    # the edge between groups g and g + 1 (g < groups - 1) cuts a bucket
    cut = ((keys[1:] == keys[:-1]) & (keys[1:] >= 0))[size - 1::size]
    out[1:, 0] = torch.where(cut, keys[size::size], -1)
    out[:-1, 1] = out[1:, 0]
    return out.flatten()


def chunk_plan(order: torch.Tensor, offsets: torch.Tensor, infinity: torch.Tensor, c: int,
               m: int = None) -> ChunkPlan:
    """The bucket step's plan from `sort_by_digit`'s order (W, n) and
    offsets (W, 2^c + 1) and the points at infinity (n,): every window's
    sorted entries but its digit-0 head and the points at infinity, the
    chunks of m (`chunk_size` by default) and their pieces' buckets."""
    W, n = order.shape
    nb = 1 << c
    dev = order.device
    counts = (offsets[:, 1:] - offsets[:, :-1]).flatten()
    key = torch.repeat_interleave(torch.arange(W * nb, dtype=torch.int32, device=dev), counts,
                                  output_size=W * n)
    flat = order.flatten()
    at = (((key & (nb - 1)) != 0) & ~infinity[flat]).nonzero().squeeze(1)
    idx, key = flat[at], key[at]
    m = m or chunk_size(at.shape[0], dev)
    return ChunkPlan(idx, key, m, piece_keys(key, m))


def _run_sums(vals, keys: torch.Tensor, size: int):
    """The entries (a limb point per entry) summed over each run of equal
    keys inside its group of `size`: per run, every entry holds the sum up
    to it (log2(size) rounds of `pt_add`); and the run ids."""
    N = keys.shape[0]
    dev = keys.device
    group = torch.arange(N, device=dev) // size
    new_run = torch.ones(N, dtype=torch.bool, device=dev)
    new_run[1:] = (keys[1:] != keys[:-1]) | (group[1:] != group[:-1])
    run = torch.cumsum(new_run, 0)
    shift = 1
    while shift < min(size, N):
        px, py, pz = (torch.cat([v[:shift], v[:-shift]]) for v in vals)
        prev = torch.cat([torch.zeros(shift, dtype=run.dtype, device=dev), run[:-shift]])
        pz = torch.where((run == prev)[:, None], pz, torch.zeros_like(pz))
        vals = pt_add(vals, (px, py, pz))
        shift *= 2
    return vals, run, group


def _level_plain(vals, keys: torch.Tensor, size: int, piece_key: torch.Tensor,
                 buckets: torch.Tensor) -> torch.Tensor:
    """One level of the bucket step as K4 runs it, on lanes: the entries
    in groups of `size`, each run of equal keys in a group summed; a run
    that the group's edge cuts goes to its piece slot (`piece_key`), any
    other run is a whole bucket and goes into `buckets` (W 2^c, 24) words.
    Returns the piece slots (2 groups, 24), infinity where empty."""
    N = keys.shape[0]
    dev = keys.device
    vals, run, group = _run_sums(vals, keys, size)
    end = torch.ones(N, dtype=torch.bool, device=dev)
    end[:-1] = run[1:] != run[:-1]
    end &= keys >= 0
    first_run = run == run[group * size]
    last_run = run == run[(group * size + size).clamp(max=N) - 1]
    to_head = end & first_run & (piece_key[2 * group] >= 0)
    to_tail = end & last_run & (piece_key[2 * group + 1] >= 0) & ~to_head
    whole = end & ~to_head & ~to_tail
    words = _words(vals)
    slots = torch.zeros((piece_key.shape[0], 24), dtype=torch.int32, device=dev)
    slots[2 * group[to_head]] = words[to_head]
    slots[2 * group[to_tail] + 1] = words[to_tail]
    buckets[keys[whole].long()] = words[whole]
    return slots


def chunk_partials_plain(points: torch.Tensor, plan: ChunkPlan,
                         buckets: torch.Tensor) -> torch.Tensor:
    """`msm_chunks_kernel` on lanes: each chunk's runs summed; whole
    buckets written into `buckets` (W, 2^c, 24); the pieces returned."""
    pts = points[plan.idx.long()]
    x, y = from_words(pts[:, :8]), from_words(pts[:, 8:])
    z = torch.from_numpy(F.to_monty_int(1)).to(points.device).expand(x.shape[0], K)
    z = torch.where((pts == 0).all(-1)[:, None], torch.zeros_like(z), z)
    return _level_plain((x, y, z), plan.key, plan.m, plan.piece_key, buckets.view(-1, 24))


def reduce_level_plain(pieces: torch.Tensor, keys: torch.Tensor, buckets: torch.Tensor):
    """`msm_reduce_kernel` on lanes: one level of the pieces' reduction
    over tiles of TILE slots; whole buckets written into `buckets`; the next
    level's pieces and their buckets returned."""
    X, Y, Z = _jacobian(pieces)
    Z = torch.where((keys >= 0)[:, None], Z, torch.zeros_like(Z))  # an empty slot's words are free
    nxt = piece_keys(keys, TILE)
    return _level_plain((X, Y, Z), keys, TILE, nxt, buckets.view(-1, 24)), nxt


def window_sums_plain(buckets: torch.Tensor, c: int, log_s: int = None) -> torch.Tensor:
    """sum_k k B_k per window, as K4's `msm_window_sums_kernel` splits it:
    2^log_s leaves of L buckets by running sums, then the (A, V, D) tree
    over adjacent leaves; (W, 2^c, 24) -> (W, 24)."""
    W = buckets.shape[0]
    log_s = sum_bits(c) if log_s is None else log_s
    S, L = 1 << log_s, 1 << (c - log_s)
    dev = buckets.device
    B = _jacobian(buckets.reshape(W, S, L, 24))
    run, acc = pt_infinity((W, S), dev), pt_infinity((W, S), dev)
    for j in range(L - 1, -1, -1):
        acc = pt_add(acc, run)
        run = pt_add(run, tuple(b[:, :, j] for b in B))
    A, V, D = acc, pt_infinity((W, S), dev), run
    while A[0].shape[1] > 1:
        left = lambda p: tuple(x[:, 0::2] for x in p)  # noqa: E731
        right = lambda p: tuple(x[:, 1::2] for x in p)  # noqa: E731
        V = pt_add(pt_add(left(V), right(V)), right(D))
        D = pt_double(pt_add(left(D), right(D)))
        A = pt_add(left(A), right(A))
    V = tuple(x[:, 0] for x in V)
    for _ in range(c - log_s):
        V = pt_double(V)
    return _words(pt_add(V, tuple(x[:, 0] for x in A)))


def _check_plan(points: torch.Tensor, plan: ChunkPlan, buckets: torch.Tensor) -> None:
    live = plan.key.shape[0]
    _check(plan.idx, (live,), "plan.idx")
    _check(plan.key, (live,), "plan.key")
    chunks = -(-live // plan.m) if plan.m >= 1 else -1
    _check(plan.piece_key, (2 * chunks,), "plan.piece_key")
    _check(buckets, (buckets.shape[0], buckets.shape[1], 24), "buckets")
    if len({t.device for t in (points, plan.idx, plan.key, plan.piece_key, buckets)}) != 1:
        raise ValueError("the points, the plan and the buckets must share one device")


def chunk_partials(points: torch.Tensor, plan: ChunkPlan, buckets: torch.Tensor) -> torch.Tensor:
    """The chunk step of the bucket sums: (n, 16) affine words, a
    `chunk_plan`, buckets (W, 2^c, 24) -> the pieces (2 chunks, 24); every
    bucket that one chunk holds whole is written into `buckets`.
    `msm_chunks_kernel` on a CUDA tensor, `chunk_partials_plain` on a CPU
    one."""
    _check(points, (points.shape[0], 16), "points")
    _check_plan(points, plan, buckets)
    if points.device.type == "cpu":
        return chunk_partials_plain(points, plan, buckets)
    if not all(t.is_contiguous() for t in (points, plan.idx, plan.key, plan.piece_key, buckets)):
        raise ValueError("chunk_partials needs contiguous tensors")
    pieces = torch.empty((plan.piece_key.shape[0], 24), dtype=torch.int32, device=points.device)
    _build.check(_build.lib().bn254_msm_chunks(
        points.data_ptr(), plan.idx.data_ptr(), plan.key.data_ptr(), plan.key.shape[0], plan.m,
        plan.piece_key.data_ptr(), pieces.data_ptr(), buckets.data_ptr(),
        _build.stream(points.device)), "bn254_msm_chunks")
    launches["bn254_msm_chunks"] += 1
    return pieces


def reduce_segments(pieces: torch.Tensor, keys: torch.Tensor, buckets: torch.Tensor):
    """One level of the pieces' reduction: pieces (N, 24) with their
    buckets (N,) (-1: empty) -> the next level's pieces (2 tiles, 24) and
    buckets, every bucket that one tile of TILE holds whole written into
    `buckets`; at one tile every bucket is written. `msm_reduce_kernel`
    on a CUDA tensor, `reduce_level_plain` on a CPU one."""
    N = keys.shape[0]
    _check(pieces, (N, 24), "pieces")
    _check(keys, (N,), "keys")
    _check(buckets, (buckets.shape[0], buckets.shape[1], 24), "buckets")
    if N < 1 or len({pieces.device, keys.device, buckets.device}) != 1:
        raise ValueError("reduce_segments needs pieces, their keys and the buckets on one device")
    if pieces.device.type == "cpu":
        return reduce_level_plain(pieces, keys, buckets)
    if not all(t.is_contiguous() for t in (pieces, keys, buckets)):
        raise ValueError("reduce_segments needs contiguous tensors")
    tiles = -(-N // TILE)
    out = torch.empty((2 * tiles, 24), dtype=torch.int32, device=pieces.device)
    out_key = torch.empty(2 * tiles, dtype=torch.int32, device=pieces.device)
    _build.check(_build.lib().bn254_msm_reduce(
        pieces.data_ptr(), keys.data_ptr(), N, out.data_ptr(), out_key.data_ptr(),
        buckets.data_ptr(), _build.stream(pieces.device)), "bn254_msm_reduce")
    launches["bn254_msm_reduce"] += 1
    return out, out_key


def window_buckets(points: torch.Tensor, dig: torch.Tensor, c: int) -> torch.Tensor:
    """Per window, the sum of the points of each digit: (n, 16) int32
    Montgomery affine words, (W, n) digits -> (W, 2^c, 24) Jacobian words
    (bucket 0 at infinity). On a CUDA tensor the plan, the chunk partials
    and the levels of the reduction (K4); on a CPU tensor the reference's
    segmented combine (`window_buckets_plain`)."""
    W, n = dig.shape
    _check(points, (n, 16), "points")
    if W != n_windows(c) or dig.device != points.device:
        raise ValueError("digits do not match the points or the window")
    if points.device.type == "cpu":
        return window_buckets_plain(points, dig, c)
    if not points.is_contiguous():
        raise ValueError("window_buckets needs contiguous points")
    order, offsets = sort_by_digit(dig, c)
    plan = chunk_plan(order, offsets, (points == 0).all(-1), c)
    out = torch.zeros((W, 1 << c, 24), dtype=torch.int32, device=points.device)
    if plan.key.shape[0]:
        pieces, keys = chunk_partials(points, plan, out), plan.piece_key
        while keys.shape[0] > 2:  # one chunk or one tile leaves no piece
            pieces, keys = reduce_segments(pieces, keys, out)
    return out


def window_sums(buckets: torch.Tensor, c: int, log_s: int = None) -> torch.Tensor:
    """sum_k k B_k per window: (W, 2^c, 24) -> (W, 24) Jacobian words, over
    2^log_s <= 512 leaves (`sum_bits(c)` by default)."""
    W = buckets.shape[0]
    log_s = sum_bits(c) if log_s is None else log_s
    _check(buckets, (W, 1 << c, 24), "buckets")
    if not (1 <= c <= 16 and 0 <= log_s <= c and 1 << log_s <= SUM_THREADS):
        raise ValueError(f"no window sum of 2^{log_s} leaves at c = {c}")
    if buckets.device.type == "cpu":
        return window_sums_plain(buckets, c, log_s)
    if not buckets.is_contiguous():
        raise ValueError("window_sums needs contiguous buckets")
    out = torch.empty((W, 24), dtype=torch.int32, device=buckets.device)
    _build.check(_build.lib().bn254_msm_window_sums(
        buckets.data_ptr(), W, c, log_s, out.data_ptr(), _build.stream(buckets.device)),
        "bn254_msm_window_sums")
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

