"""Radix-2 NTT and coset LDE over BabyBear, batched column-wise.

The reference's `zkvm_prover_tpu/ops/ntt.py` on torch tensors. A batch of
polynomials is an (N, W) int32 matrix of Montgomery residues: axis 0 is the
evaluation / coefficient index, axis 1 the columns. DIF butterflies take
natural order to bit-reversed order and DIT butterflies take it back, so the
LDE never applies a bit-reversal permutation. Domains are natural-order
cosets. The butterflies run through kernel K1 (`ntt_fused`), and so do the
per-row scalings: the 1/n and 1/shift_in^j factors ride on the store of the
inverse transform's last pass, each coset's shift powers on the load of its
forward transform's first pass, and that transform stores straight into the
interleaved LDE rows.

Tables (twiddles, bit-reversed power ladders) are built vectorised with
numpy uint64 arithmetic and cached per size and device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..fields import babybear as bb
from ..fields import ext4
from . import mont_matmul as mm
from . import ntt_fused


def _log2(n: int) -> int:
    if n <= 0 or n & (n - 1):
        raise ValueError(f"size {n} is not a power of two")
    return n.bit_length() - 1


def _as_2d(x):
    """(N, ...) -> (N, prod(...)), a view where the rows stay contiguous."""
    y = x.reshape(x.shape[0], -1)
    return y if y.shape[1] <= 1 or y.stride(1) == 1 else y.contiguous()


def n_inv_monty(log_n: int) -> int:
    return bb.to_monty_int(pow(1 << log_n, bb.P - 2, bb.P))


@functools.lru_cache(maxsize=None)
def powers_bitrev_np(base_int: int, log_n: int, factor_int: int = 1) -> np.ndarray:
    """[factor * base^bitrev(j) for j < 2^log_n], Montgomery uint32."""
    pw = bb.powers_np(base_int, 1 << log_n)[bb.bitrev_perm(log_n)]
    return bb.to_monty_np(bb.mulmod_np(pw, factor_int % bb.P))


_TABLES = {}


def powers_bitrev(base_int: int, log_n: int, device,
                  factor_int: int = 1) -> torch.Tensor:
    key = (base_int, log_n, factor_int, str(device))
    if key not in _TABLES:
        _TABLES[key] = bb.as_tensor(powers_bitrev_np(base_int, log_n, factor_int),
                                    device)
    return _TABLES[key]


def _n_inv_table(log_n: int, device) -> torch.Tensor:
    """1/n in every row (canonical factor), for the inverse transforms."""
    return powers_bitrev(1, log_n, device, pow(1 << log_n, bb.P - 2, bb.P))


# ---------------------------------------------------------------------------
# Core transforms
# ---------------------------------------------------------------------------


def ntt_natural_to_rev(x):
    """Forward NTT; natural-order input, bit-reversed output."""
    return ntt_fused.dif(_as_2d(x), _log2(x.shape[0]), False).reshape(x.shape)


def ntt_rev_to_natural(x):
    """Forward NTT; bit-reversed input, natural-order output."""
    return ntt_fused.dit(_as_2d(x), _log2(x.shape[0]), False).reshape(x.shape)


def intt_natural_to_rev(x):
    """Inverse NTT; natural-order evals -> bit-reversed coefficients (1/n on
    the last pass's store)."""
    log_n = _log2(x.shape[0])
    return ntt_fused.dif(_as_2d(x), log_n, True,
                         post=_n_inv_table(log_n, x.device)).reshape(x.shape)


def intt_rev_to_natural(x):
    """Inverse NTT; bit-reversed evals -> natural-order coefficients."""
    log_n = _log2(x.shape[0])
    return ntt_fused.dit(_as_2d(x), log_n, True,
                         post=_n_inv_table(log_n, x.device)).reshape(x.shape)


# ---------------------------------------------------------------------------
# Coset LDE
# ---------------------------------------------------------------------------


def interpolate_coset_rev(evals, shift_in_int: int = 1, canonical: bool = False):
    """Evals on the coset shift_in*H (natural order) -> bit-reversed
    coefficients: INTT, then coefficient j divided by shift_in^j. Both
    factors, n^-1 * shift_in^-bitrev(j), are one per-row table on the store
    of the DIF's last pass.

    canonical=True takes evals as canonical residues rather than Montgomery
    ones and folds the conversion into that table: the INTT is linear, so a
    canonical input gives coefficients short of one factor R = 2^32, which
    the table supplies. The output is the Montgomery result either way."""
    n = int(evals.shape[0])
    log_n = _log2(n)
    s_inv = pow(shift_in_int % bb.P, bb.P - 2, bb.P)
    factor = pow(n, bb.P - 2, bb.P) * (bb.R if canonical else 1)
    table = powers_bitrev(s_inv, log_n, evals.device, factor % bb.P)
    return ntt_fused.dif(_as_2d(evals), log_n, True,
                         post=table).reshape(evals.shape)


def eval_coset_from_rev(c_rev, log_blowup: int, shift_int: int, out=None):
    """Bit-reversed coefficients (n, ...) -> evals of the degree < n
    polynomials on the coset shift*G_m (natural order), m = n << log_blowup:
    one DIT per coset of H, its shift powers on the first pass's load, its
    last pass storing rows r, r + blowup, ... (index r + j*blowup). out, if
    given, is an (m, W) view with contiguous rows; it is filled and
    returned."""
    n = int(c_rev.shape[0])
    log_n = _log2(n)
    blowup = 1 << log_blowup
    c2 = _as_2d(c_rev)
    if out is None:
        res = torch.empty((n * blowup,) + tuple(c_rev.shape[1:]), dtype=bb.DTYPE,
                          device=c_rev.device)
        lde = res.view(n * blowup, -1)
    else:
        res = lde = out
    w_m_int = bb.two_adic_generator_int(log_n + log_blowup)
    for r in range(blowup):
        s_r = (shift_int * pow(w_m_int, r, bb.P)) % bb.P
        ntt_fused.dit(c2, log_n, False, pre=powers_bitrev(s_r, log_n, c_rev.device),
                      out=lde[r::blowup])
    return res


def coset_lde(evals, log_blowup: int, shift_int: int = bb.GENERATOR,
              shift_in_int: int = 1):
    """(n, W) evals on shift_in*H -> (n << log_blowup, W) evals on shift*G."""
    c_rev = interpolate_coset_rev(evals, shift_in_int)
    return eval_coset_from_rev(c_rev, log_blowup, shift_int)


def powers_bitrev_ext(point_ext, log_n: int):
    """[z^bitrev(j) for j < 2^log_n] as (n, 4): appending a high bit b to a
    reversed index adds b*2^k to the exponent, so each doubling step
    interleaves the table with itself times z^(2^k)."""
    pw = ext4.one((1,), device=point_ext.device)
    zp = point_ext
    for _ in range(log_n):
        hi = ext4.mul(pw, zp)
        pw = torch.stack([pw, hi], dim=1).reshape(-1, 4)
        zp = ext4.mul(zp, zp)
    return pw


def eval_poly_at_point_ext(coeffs_rev, point_ext):
    """Evaluate polynomials with bit-reversed base-field coefficients
    (n, W) at one ext point: sum_j c_j * z^bitrev(j), a (W, n) @ (n, 4)
    exact product (kernel K3). Returns (W, 4)."""
    log_n = _log2(int(coeffs_rev.shape[0]))
    pw = powers_bitrev_ext(point_ext, log_n).contiguous()
    return mm.mont_matmul(coeffs_rev.contiguous(), pw, transpose_a=True)
