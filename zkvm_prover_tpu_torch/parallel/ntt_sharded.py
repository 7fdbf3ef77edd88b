"""Sharded NTT: the four-step decomposition with one `all_to_all` reshard
(the reference's `parallel/ntt_sharded.py`).

A 2^k-point BabyBear NTT over (n, W) is laid out as an (n1, n2, W) block:

  step A: DIF NTTs of length n1 along axis 0 — local on a column shard
  step B: the mid-twiddle multiply — local, table in the bit-reversed row
          order step A produces
  step C: all_to_all: column shards -> row shards
  step D: DIF NTTs of length n2 along axis 1 — local on a row shard

Output equals the single-device `ntt_natural_to_rev` bit for bit: with
i = i2 + n2*i1 and k = k1 + n1*k2, the (bitrev(k1), bitrev(k2))-ordered
result flattened row-major is the bit-reversed-order NTT. Steps A and D go
through kernel K1 (`ops/ntt_fused.py`) on each shard; D runs on the row
shard transposed to (n2, n1/d * W).

Per-row factors ride on the kernel passes and the mid table: a factor
base^bitrev_n(j) of output (or input) position j = r1*n2 + c2 splits into
(base^n1)^bitrev_n2(c2), on K1's last store (or first load), and
base^bitrev_n1(r1), which is constant along the transform and so folds
into row r1 of the mid table. The inverse transform's 1/n and a coset's
shift powers cost no extra pass.
"""

from __future__ import annotations

import functools
from typing import List

import numpy as np
import torch

from ..fields import babybear as bb
from ..ops import ntt, ntt_fused
from .mesh import Mesh, Sharded, all_to_all, make_mesh, on, split


@functools.lru_cache(maxsize=None)
def mid_twiddles_np(log_n1: int, log_n2: int, inverse: bool = False,
                    row_base: int = 1) -> np.ndarray:
    """Four-step mid table T[r1, i2] = w_n^(bitrev_n1(r1) * i2), times
    row_base^bitrev_n1(r1); Montgomery uint32 (n1, n2). Built vectorised:
    every entry is a power of w_n, read from one table of its n powers."""
    n1, n2 = 1 << log_n1, 1 << log_n2
    n = n1 * n2
    w = bb.two_adic_generator_int(log_n1 + log_n2)
    if inverse:
        w = pow(w, bb.P - 2, bb.P)
    rev = bb.bitrev_perm(log_n1)
    exps = (rev[:, None] * np.arange(n2, dtype=np.int64)[None, :]) % n
    t = bb.powers_np(w, n)[exps]
    if row_base % bb.P != 1:
        t = bb.mulmod_np(t, bb.powers_np(row_base, n1)[rev][:, None])
    return bb.to_monty_np(t)


_TW = {}


def _mid_table(log_n1, log_n2, inverse, row_base, device, rows=None, cols=None):
    """A device copy of a slice of the mid table (cached)."""
    key = (log_n1, log_n2, inverse, row_base % bb.P, str(device), rows, cols)
    if key not in _TW:
        t = mid_twiddles_np(log_n1, log_n2, inverse, row_base % bb.P)
        if rows is not None:
            t = t[rows[0]:rows[1]]
        if cols is not None:
            t = t[:, cols[0]:cols[1]]
        _TW[key] = bb.as_tensor(np.ascontiguousarray(t), device)
    return _TW[key]


def _split_log(n: int):
    log_n = ntt._log2(n)
    log_n1 = log_n // 2
    return log_n, log_n1, log_n - log_n1


def _flat_width(shape) -> int:
    w = 1
    for s in shape[1:]:
        w *= int(s)
    return w


def col_blocks(x, mesh: Mesh) -> List[torch.Tensor]:
    """x as column shards of its (n1, n2, W) block: (n1, n2/d, W) per shard.
    A row-sharded input is resharded by one all_to_all."""
    shape = tuple(x.shape)
    _, log_n1, log_n2 = _split_log(shape[0])
    n1, n2, w = 1 << log_n1, 1 << log_n2, _flat_width(shape)
    devs = mesh.devices()
    d = len(devs)
    if isinstance(x, Sharded):
        if x.axis == 1 and x.parts[0].shape == (n1, n2 // d, w):
            return x.parts
        if x.axis == 0:
            rows = [p.reshape(n1 // d, n2, w) for p in x.parts]
            return all_to_all(rows, devs, split_axis=1, concat_axis=0)
        x = x.gather()
    return split(mesh, x.reshape(n1, n2, w), 1).parts


def row_blocks(x, mesh: Mesh) -> List[torch.Tensor]:
    """x as row shards of its (n1, n2, W) block: (n1/d, n2, W) per shard.
    A column-sharded input is resharded by one all_to_all."""
    shape = tuple(x.shape)
    _, log_n1, log_n2 = _split_log(shape[0])
    n1, n2, w = 1 << log_n1, 1 << log_n2, _flat_width(shape)
    devs = mesh.devices()
    d = len(devs)
    if isinstance(x, Sharded):
        if x.axis == 0:
            return [p.reshape(n1 // d, n2, w) for p in x.parts]
        if x.axis == 1 and x.parts[0].shape == (n1, n2 // d, w):
            return all_to_all(x.parts, devs, split_axis=0, concat_axis=1)
        x = x.gather()
    return split(mesh, x.reshape(n1, n2, w), 0).parts


def _nat_to_rev(x, mesh: Mesh, inverse: bool,
                out_base: int = 1, out_factor: int = 1) -> Sharded:
    """Four-step DIF, natural -> bit-reversed; output position j scaled by
    out_factor * out_base^bitrev(j). Column shards in, row shards out."""
    shape = tuple(x.shape)
    n = shape[0]
    log_n, log_n1, log_n2 = _split_log(n)
    n1, n2, w = 1 << log_n1, 1 << log_n2, _flat_width(shape)
    devs = mesh.devices()
    d = len(devs)
    if n2 % d or n1 % d:
        raise ValueError(f"n1={n1}, n2={n2} must be divisible by the mesh axis {d}")
    cols = col_blocks(x, mesh)
    step = n2 // d
    mids = []
    for s, (blk, dev) in enumerate(zip(cols, devs)):
        with on(dev):
            a = ntt_fused.dif(blk.reshape(n1, step * w), log_n1, inverse)
            tw = _mid_table(log_n1, log_n2, inverse, out_base, dev,
                            cols=(s * step, (s + 1) * step))
            mids.append(bb.mul(a.reshape(n1, step, w), tw[:, :, None]))
    rows = all_to_all(mids, devs, split_axis=0, concat_axis=1)   # (n1/d, n2, W)
    post_base = pow(out_base % bb.P, n1, bb.P)
    out = []
    for blk, dev in zip(rows, devs):
        with on(dev):
            t = blk.permute(1, 0, 2).contiguous().reshape(n2, (n1 // d) * w)
            post = None
            if post_base != 1 or out_factor % bb.P != 1:
                post = ntt.powers_bitrev(post_base, log_n2, dev, out_factor % bb.P)
            e = ntt_fused.dif(t, log_n2, inverse, post=post)
            out.append(e.reshape(n2, n1 // d, w).permute(1, 0, 2).contiguous()
                       .reshape((n // d,) + shape[1:]))
    return Sharded(out, 0, shape)


def _rev_to_nat_cols(x, mesh: Mesh, in_base: int = 1) -> List[torch.Tensor]:
    """Four-step DIT, bit-reversed -> natural, input position j scaled by
    in_base^bitrev(j) first. Row shards in; column shards (n1, n2/d, W) of
    the natural-order block out."""
    shape = tuple(x.shape)
    log_n, log_n1, log_n2 = _split_log(shape[0])
    n1, n2, w = 1 << log_n1, 1 << log_n2, _flat_width(shape)
    devs = mesh.devices()
    d = len(devs)
    if n1 % d or n2 % d:
        raise ValueError(f"n1={n1}, n2={n2} must be divisible by the mesh axis {d}")
    rows = row_blocks(x, mesh)
    step = n1 // d
    pre_base = pow(in_base % bb.P, n1, bb.P)
    mids = []
    for s, (blk, dev) in enumerate(zip(rows, devs)):
        with on(dev):
            t = blk.permute(1, 0, 2).contiguous().reshape(n2, step * w)
            pre = None if pre_base == 1 else ntt.powers_bitrev(pre_base, log_n2, dev)
            e = ntt_fused.dit(t, log_n2, False, pre=pre).reshape(n2, step, w).permute(1, 0, 2)
            tw = _mid_table(log_n1, log_n2, False, in_base, dev,
                            rows=(s * step, (s + 1) * step))
            mids.append(bb.mul(e, tw[:, :, None]))
    cols = all_to_all(mids, devs, split_axis=1, concat_axis=0)   # (n1, n2/d, W)
    out = []
    for blk, dev in zip(cols, devs):
        with on(dev):
            out.append(ntt_fused.dit(blk.reshape(n1, (n2 // d) * w), log_n1, False)
                       .reshape(n1, n2 // d, w))
    return out


def ntt_natural_to_rev_four_step_local(x):
    """Single-device four-step NTT, bit-identical to `ntt_natural_to_rev`:
    the one-shard case of the sharded path, where the all_to_all is a
    local transpose."""
    mesh = make_mesh(1, devices=[x.device])
    return _nat_to_rev(x, mesh, False).gather()


def ntt_natural_to_rev_sharded(x, mesh: Mesh) -> Sharded:
    """Sharded forward NTT, natural input -> bit-reversed output, rows
    sharded. x: (n, *rest), a tensor or a `Sharded`; n = n1 * n2 with n1
    and n2 divisible by the mesh axis."""
    return _nat_to_rev(x, mesh, False)


def intt_natural_to_rev_sharded(x, mesh: Mesh) -> Sharded:
    """Sharded inverse NTT: natural-order evals -> bit-reversed coeffs (the
    1/n on step D's store)."""
    log_n = ntt._log2(tuple(x.shape)[0])
    return _nat_to_rev(x, mesh, True, 1, pow(1 << log_n, bb.P - 2, bb.P))


def ntt_rev_to_natural_sharded(x, mesh: Mesh) -> Sharded:
    """Sharded forward NTT, bit-reversed input -> natural output.

    The mirror four-step: with r = bitrev(k) = rev(k2) + n2*rev(k1), the
    input block's element (r1, r2) is c[rev(r1) + n1*rev(r2)]; per-row DITs
    recover the inner transform over k2, the same mid table applies, one
    all_to_all reshards, and per-column DITs over k1 give the natural
    result, columns sharded."""
    shape = tuple(x.shape)
    return Sharded(_rev_to_nat_cols(x, mesh), 1, shape)


def interpolate_coset_rev_sharded(evals, mesh: Mesh, shift_in_int: int = 1) -> Sharded:
    """Sharded `ops.ntt.interpolate_coset_rev`: coefficient j scaled by
    n^-1 * shift_in^-bitrev(j) on step D's store."""
    log_n = ntt._log2(tuple(evals.shape)[0])
    s_inv = pow(shift_in_int % bb.P, bb.P - 2, bb.P)
    return _nat_to_rev(evals, mesh, True, s_inv,
                       pow(1 << log_n, bb.P - 2, bb.P))


def eval_coset_from_rev_sharded(c_rev, log_blowup: int, shift_int: int,
                                mesh: Mesh) -> Sharded:
    """Sharded `ops.ntt.eval_coset_from_rev`: the (n << log_blowup, W)
    natural-order coset evaluations, rows sharded; coset r's output row i
    is LDE row i * blowup + r. Each coset's columns-sharded result is
    resharded straight into the interleaved row shards."""
    shape = tuple(c_rev.shape)
    n = shape[0]
    log_n, log_n1, log_n2 = _split_log(n)
    n1, n2, w = 1 << log_n1, 1 << log_n2, _flat_width(shape)
    blowup = 1 << log_blowup
    devs = mesh.devices()
    d = len(devs)
    rows = Sharded(row_blocks(c_rev, mesh), 0, shape)
    ldes = [torch.empty((n1 // d, n2, blowup, w), dtype=bb.DTYPE, device=dev) for dev in devs]
    w_m = bb.two_adic_generator_int(log_n + log_blowup)
    for r in range(blowup):
        s_r = shift_int * pow(w_m, r, bb.P) % bb.P
        cols = _rev_to_nat_cols(rows, mesh, s_r)    # (n1, n2/d, W) each
        for j, blk in enumerate(cols):                         # the reshard: piece s of shard j
            for s, pieces in enumerate(blk.chunk(d, dim=0)):
                ldes[s][:, j * (n2 // d):(j + 1) * (n2 // d), r].copy_(pieces)
    m = n * blowup
    return Sharded([t.reshape((m // d,) + shape[1:]) for t in ldes], 0, (m,) + shape[1:])


def coset_lde_sharded(evals, log_blowup: int, mesh: Mesh,
                      shift_int: int = bb.GENERATOR, shift_in_int: int = 1) -> Sharded:
    """Sharded low-degree extension: interpolation then every coset."""
    c_rev = interpolate_coset_rev_sharded(evals, mesh, shift_in_int)
    return eval_coset_from_rev_sharded(c_rev, log_blowup, shift_int, mesh)
