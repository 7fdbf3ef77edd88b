"""SHA-256 compression AIR — one round per row, 64 rows per block.

The port's copy of the reference's `zkvm_prover_tpu/models/sha256_air.py`,
the analog of openvm's sha256 extension chip. Other chips prove sha256 compression
calls by sending `(h_in[16] || block[32] || h_out[16])` 16-bit-limb
messages on SHA256_BUS; this chip holds one 64-round compression per
block of rows and receives each message on the final-round row.

Bit-level constraint design within the MAX_DEGREE=3 budget (independent
implementation of the standard round decomposition):

- All eight working variables a..h are witnessed as 32 bit columns each;
  16-bit-limb values are recomposed where arithmetic needs them (BabyBear
  is ~2^31, so ALL additions run per 16-bit limb with witnessed carry
  bits — a 32-bit recomposition would overflow the field).
- Ch(e,f,g) = e*f + (1-e)*g per bit (degree 2);
  Maj(a,b,c) = ab + ac + bc - 2abc (degree 3);
  Sigma/sigma are xor2/xor3 of rotated/shifted bits (degree <= 3).
- The message schedule keeps a 16-word sliding window (W_{t-15}..W_t) of
  32 bit columns each; rows 16..63 constrain
  W_t = sigma1(W_{t-2}) + W_{t-7} + sigma0(W_{t-15}) + W_{t-16} via
  window rotation, with per-limb carries.
- Round transition (rows 0..62): next row's a..h bits recompose to the
  round outputs (new_a = T1+T2, new_e = d+T1, others shift), again with
  per-limb carries.
- Block chaining: H_in limbs are constant down the block; row 0 binds the
  a..h bits to H_in; the final row witnesses H_out limbs constrained to
  H_in + (post-round-63 state) — the post-round values are expressions
  on the last row, so the state never needs a 65th row.
- Rows not covered by a real compression hold the zero-message
  compression (computed once, tiled) at multiplicity 0, because the
  preprocessed K-constant columns make all-zero rows unsatisfiable —
  the same padding rule as KeccakfAir (models/keccak_air.py).

The step flags, round constants K_t and the 16 row-index flags are
preprocessed columns (fixed 64-periodic schedule, part of the vk).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from .air import Air, AirBuilder

SHA256_BUS = 43

NUM_ROUNDS = 64

_K = [
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5,
    0x3956C25B, 0x59F111F1, 0x923F82A4, 0xAB1C5ED5,
    0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174,
    0xE49B69C1, 0xEFBE4786, 0x0FC19DC6, 0x240CA1CC,
    0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7,
    0xC6E00BF3, 0xD5A79147, 0x06CA6351, 0x14292967,
    0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85,
    0xA2BFE8A1, 0xA81A664B, 0xC24B8B70, 0xC76C51A3,
    0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5,
    0x391C0CB3, 0x4ED8AA4A, 0x5B9CCA4F, 0x682E6FF3,
    0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
]

_H_INIT = [
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
]

# --- preprocessed layout ---------------------------------------------------
P_FIRST = 0            # round-0 rows
P_LAST = 1             # round-63 rows
P_NOT_LAST = 2         # rounds 0..62
P_SCHED = 3            # rounds 15..62: schedule recurrence fires on next
P_K = 4                # 32 round-constant bits
P_ROW = P_K + 32       # 16 flags: row_is_t for t = 0..15 (message rows)
PRE_WIDTH = P_ROW + 16

# --- main layout -----------------------------------------------------------
# 8 working vars x 32 bits
A_BITS = 0             # a, b, c, d, e, f, g, h (each 32 bits)
W_WIN = A_BITS + 8 * 32      # 16-word window x 32 bits: win[i] = W_{t-15+i}
# Witnessed nonlinear bit layers (bound by UNGATED degree<=3 constraints,
# so every GATED sum over them stays degree <= 2 under the flag — the
# machine-wide MAX_DEGREE=3 budget):
SIG1 = W_WIN + 16 * 32       # Sigma1(e), 32 bits
CH_B = SIG1 + 32             # Ch(e,f,g), 32 bits
SIG0 = CH_B + 32             # Sigma0(a), 32 bits
MAJ_B = SIG0 + 32            # Maj(a,b,c), 32 bits
SS0 = MAJ_B + 32             # sigma0(win[1]), 32 bits
SS1 = SS0 + 32               # sigma1(win[14]), 32 bits
H_IN = SS1 + 32              # 16 limbs (8 words x 2), constant down block
H_OUT = H_IN + 16            # 16 limbs, bound on the last row
MSG = H_OUT + 16             # 32 limbs (16 words x 2), constant down block
C_E = MSG + 32               # 3+3 carry bits for new_e (lo, hi limbs)
C_A = C_E + 6                # 3+3 carry bits for new_a
C_W = C_A + 6                # 2+2 carry bits for next W_t
C_H = C_W + 4                # 8 carry bits for H_out lo limbs + 8 for hi
MULT = C_H + 16
NUM_COLS = MULT + 1


def _var(v: int, z: int) -> int:
    """Column of bit z of working var v (v: 0=a .. 7=h)."""
    return A_BITS + v * 32 + z


def _win(i: int, z: int) -> int:
    return W_WIN + i * 32 + z


_ROTR = {
    "S0": (2, 13, 22),     # Sigma0 on a
    "S1": (6, 11, 25),     # Sigma1 on e
}
_SIG = {
    "s0": (7, 18, 3),      # sigma0: rotr7 ^ rotr18 ^ shr3
    "s1": (17, 19, 10),    # sigma1: rotr17 ^ rotr19 ^ shr10
}


class Sha256Air(Air):
    width = NUM_COLS
    num_public_values = 0
    preprocessed_width = PRE_WIDTH

    def __init__(self, log_n: int = 6):
        self.log_n = log_n

    # -- preprocessed -------------------------------------------------------
    def preprocessed_trace(self) -> np.ndarray:
        n = 1 << self.log_n
        pre = np.zeros((n, PRE_WIDTH), dtype=np.uint32)
        for p in range(n // NUM_ROUNDS):
            for r in range(NUM_ROUNDS):
                row = p * NUM_ROUNDS + r
                if r == 0:
                    pre[row, P_FIRST] = 1
                if r == NUM_ROUNDS - 1:
                    pre[row, P_LAST] = 1
                else:
                    pre[row, P_NOT_LAST] = 1
                if 15 <= r <= 62:
                    pre[row, P_SCHED] = 1
                for z in range(32):
                    pre[row, P_K + z] = (_K[r] >> z) & 1
                if r < 16:
                    pre[row, P_ROW + r] = 1
        return pre

    # -- constraints --------------------------------------------------------
    def eval(self, b: AirBuilder) -> None:
        one = b.constant(1)
        two = b.constant(2)
        first = b.preprocessed(P_FIRST)
        last = b.preprocessed(P_LAST)
        not_last = b.preprocessed(P_NOT_LAST)
        sched = b.preprocessed(P_SCHED)

        def xor2(p, q):
            return b.sub(b.add(p, q), b.mul(two, b.mul(p, q)))

        def bit(v, z):
            return b.local(_var(v, z))

        def wbit(i, z):
            return b.local(_win(i, z))

        # booleanity
        for v in range(8):
            for z in range(32):
                b.assert_bool(bit(v, z))
        for i in range(16):
            for z in range(32):
                b.assert_bool(wbit(i, z))
        for c in range(C_E, MULT):
            b.assert_bool(b.local(c))

        # limb recomposition helper: list of (coeff, expr) summed
        def limb(terms, lo: bool):
            """Sum of 2^k * bit-exprs for k in [0,16) or [16,32)."""
            acc = None
            for k in range(16):
                z = k if lo else k + 16
                e = terms(z)
                t = e if k == 0 else b.mul(b.constant(1 << k), e)
                acc = t if acc is None else b.add(acc, t)
            return acc

        # --- witnessed nonlinear layers (UNGATED degree<=3 bindings) -----
        # Ch(e,f,g), Maj(a,b,c), Sigma0(a), Sigma1(e), sigma0/1 per bit
        def ch_expr(z):
            e, f, g = bit(4, z), bit(5, z), bit(6, z)
            return b.add(b.mul(e, f), b.mul(b.sub(one, e), g))

        def maj_expr(z):
            a, bb_, c = bit(0, z), bit(1, z), bit(2, z)
            ab = b.mul(a, bb_)
            return b.sub(
                b.add(b.add(ab, b.mul(a, c)), b.mul(bb_, c)),
                b.mul(two, b.mul(ab, c)),
            )

        def big_sigma_expr(v, rots, z):
            r1, r2, r3 = rots
            return xor2(
                xor2(bit(v, (z + r1) % 32), bit(v, (z + r2) % 32)),
                bit(v, (z + r3) % 32),
            )

        def small_sigma_expr(i, rots, z):
            """sigma on window word i: rotr r1 ^ rotr r2 ^ shr r3."""
            r1, r2, r3 = rots
            x = xor2(wbit(i, (z + r1) % 32), wbit(i, (z + r2) % 32))
            if z + r3 < 32:
                return xor2(x, wbit(i, z + r3))
            return x

        for z in range(32):
            b.assert_eq(b.local(SIG1 + z),
                        big_sigma_expr(4, _ROTR["S1"], z))
            b.assert_eq(b.local(CH_B + z), ch_expr(z))
            b.assert_eq(b.local(SIG0 + z),
                        big_sigma_expr(0, _ROTR["S0"], z))
            b.assert_eq(b.local(MAJ_B + z), maj_expr(z))
            b.assert_eq(b.local(SS0 + z),
                        small_sigma_expr(1, _SIG["s0"], z))
            b.assert_eq(b.local(SS1 + z),
                        small_sigma_expr(14, _SIG["s1"], z))

        # T1 = h + Sigma1(e) + Ch + K + W_t ; T2 = Sigma0(a) + Maj
        # (all through witnessed bit columns -> gated sums stay degree 2)
        def t1_limb(lo):
            h_l = limb(lambda z: bit(7, z), lo)
            s1_l = limb(lambda z: b.local(SIG1 + z), lo)
            ch_l = limb(lambda z: b.local(CH_B + z), lo)
            k_l = limb(lambda z: b.preprocessed(P_K + z), lo)
            w_l = limb(lambda z: wbit(15, z), lo)
            return b.add(b.add(b.add(h_l, s1_l), b.add(ch_l, k_l)), w_l)

        def t2_limb(lo):
            s0_l = limb(lambda z: b.local(SIG0 + z), lo)
            mj_l = limb(lambda z: b.local(MAJ_B + z), lo)
            return b.add(s0_l, mj_l)

        def carry(base, lo):
            """3-bit carry value from bit columns."""
            off = 0 if lo else 3
            return b.add(
                b.add(b.local(base + off),
                      b.mul(two, b.local(base + off + 1))),
                b.mul(b.constant(4), b.local(base + off + 2)),
            )

        shift16 = b.constant(1 << 16)

        # --- transitions (rows 0..62): next.a..h = round outputs --------
        def nbit(v, z):
            return b.next(_var(v, z))

        def nlimb(v, lo):
            acc = None
            for k in range(16):
                z = k if lo else k + 16
                e = nbit(v, z)
                t = e if k == 0 else b.mul(b.constant(1 << k), e)
                acc = t if acc is None else b.add(acc, t)
            return acc

        # new_e = d + T1 : per-limb with carries C_E
        dl = limb(lambda z: bit(3, z), True)
        dh = limb(lambda z: bit(3, z), False)
        ce_lo = carry(C_E, True)
        ce_hi = carry(C_E, False)
        b.when_transition().assert_zero(b.mul(not_last, b.sub(
            b.add(dl, t1_limb(True)),
            b.add(nlimb(4, True), b.mul(ce_lo, shift16)),
        )))
        b.when_transition().assert_zero(b.mul(not_last, b.sub(
            b.add(b.add(dh, t1_limb(False)), ce_lo),
            b.add(nlimb(4, False), b.mul(ce_hi, shift16)),
        )))

        # new_a = T1 + T2 : carries C_A
        ca_lo = carry(C_A, True)
        ca_hi = carry(C_A, False)
        b.when_transition().assert_zero(b.mul(not_last, b.sub(
            b.add(t1_limb(True), t2_limb(True)),
            b.add(nlimb(0, True), b.mul(ca_lo, shift16)),
        )))
        b.when_transition().assert_zero(b.mul(not_last, b.sub(
            b.add(b.add(t1_limb(False), t2_limb(False)), ca_lo),
            b.add(nlimb(0, False), b.mul(ca_hi, shift16)),
        )))

        # shifts: next.b = a, next.c = b, next.d = c,
        #         next.f = e, next.g = f, next.h = g
        for dst, src in ((1, 0), (2, 1), (3, 2), (5, 4), (6, 5), (7, 6)):
            for z in range(32):
                b.when_transition().assert_zero(b.mul(
                    not_last, b.sub(nbit(dst, z), bit(src, z))
                ))

        # --- message schedule -------------------------------------------
        # window rotation: next.win[i] = win[i+1]  (i < 15), in-block
        for i in range(15):
            for z in range(32):
                b.when_transition().assert_zero(b.mul(
                    not_last, b.sub(b.next(_win(i, z)), wbit(i + 1, z))
                ))
        # recurrence on rows with P_SCHED (next W_t):
        # next.win[15] = s1(win[14]) + win[9] + s0(win[1]) + win[0]
        def nwin_limb(lo):
            acc = None
            for k in range(16):
                z = k if lo else k + 16
                e = b.next(_win(15, z))
                t = e if k == 0 else b.mul(b.constant(1 << k), e)
                acc = t if acc is None else b.add(acc, t)
            return acc

        cw_lo = b.add(b.local(C_W), b.mul(two, b.local(C_W + 1)))
        cw_hi = b.add(b.local(C_W + 2), b.mul(two, b.local(C_W + 3)))
        s1_lo = limb(lambda z: b.local(SS1 + z), True)
        s1_hi = limb(lambda z: b.local(SS1 + z), False)
        s0_lo = limb(lambda z: b.local(SS0 + z), True)
        s0_hi = limb(lambda z: b.local(SS0 + z), False)
        w9_lo = limb(lambda z: wbit(9, z), True)
        w9_hi = limb(lambda z: wbit(9, z), False)
        w0_lo = limb(lambda z: wbit(0, z), True)
        w0_hi = limb(lambda z: wbit(0, z), False)
        b.when_transition().assert_zero(b.mul(sched, b.sub(
            b.add(b.add(s1_lo, w9_lo), b.add(s0_lo, w0_lo)),
            b.add(nwin_limb(True), b.mul(cw_lo, shift16)),
        )))
        b.when_transition().assert_zero(b.mul(sched, b.sub(
            b.add(b.add(b.add(s1_hi, w9_hi), b.add(s0_hi, w0_hi)), cw_lo),
            b.add(nwin_limb(False), b.mul(cw_hi, shift16)),
        )))

        # --- message binding: rows t < 16 bind win[15] == MSG word t ----
        for t in range(16):
            flag = b.preprocessed(P_ROW + t)
            w_lo = limb(lambda z: wbit(15, z), True)
            w_hi = limb(lambda z: wbit(15, z), False)
            b.assert_zero(b.mul(flag, b.sub(w_lo, b.local(MSG + 2 * t))))
            b.assert_zero(b.mul(flag,
                                b.sub(w_hi, b.local(MSG + 2 * t + 1))))

        # --- H_in / MSG constant down the block --------------------------
        for i in range(16):
            b.when_transition().assert_zero(b.mul(
                not_last,
                b.sub(b.next(H_IN + i), b.local(H_IN + i)),
            ))
        for i in range(32):
            b.when_transition().assert_zero(b.mul(
                not_last,
                b.sub(b.next(MSG + i), b.local(MSG + i)),
            ))
        for i in range(16):
            b.when_transition().assert_zero(b.mul(
                not_last,
                b.sub(b.next(H_OUT + i), b.local(H_OUT + i)),
            ))

        # --- first row: a..h == H_in -------------------------------------
        for v in range(8):
            vl = limb(lambda z: bit(v, z), True)
            vh = limb(lambda z: bit(v, z), False)
            b.assert_zero(b.mul(first, b.sub(vl, b.local(H_IN + 2 * v))))
            b.assert_zero(b.mul(first,
                                b.sub(vh, b.local(H_IN + 2 * v + 1))))

        # --- last row: H_out == H_in + post-round state -------------------
        # post-round values on the last row: new_a = T1+T2, new_e = d+T1,
        # others are shifts of current vars. Per output word j, add H_in
        # with a single carry bit per limb pair (sum of two 16-bit limbs
        # plus small carries stays < p).
        def post_limb(v, lo):
            """Limb expr of working var v AFTER round 63, on the last
            row — includes the same witnessed carries C_A/C_E."""
            if v == 0:   # new_a = T1 + T2 (mod 2^32 via C_A)
                return (b.sub(b.add(t1_limb(lo), t2_limb(lo)),
                              b.mul(carry(C_A, lo), shift16))
                        if lo else
                        b.sub(b.add(b.add(t1_limb(False), t2_limb(False)),
                                    carry(C_A, True)),
                              b.mul(carry(C_A, False), shift16)))
            if v == 4:   # new_e = d + T1 (mod 2^32 via C_E)
                return (b.sub(b.add(dl, t1_limb(True)),
                              b.mul(carry(C_E, True), shift16))
                        if lo else
                        b.sub(b.add(b.add(dh, t1_limb(False)),
                                    carry(C_E, True)),
                              b.mul(carry(C_E, False), shift16)))
            src = v - 1  # shifts
            return limb(lambda z: bit(src, z), lo)

        for j in range(8):
            ch_lo = b.local(C_H + 2 * j)
            ch_hi = b.local(C_H + 2 * j + 1)
            b.assert_zero(b.mul(last, b.sub(
                b.add(b.local(H_IN + 2 * j), post_limb(j, True)),
                b.add(b.local(H_OUT + 2 * j), b.mul(ch_lo, shift16)),
            )))
            b.assert_zero(b.mul(last, b.sub(
                b.add(b.add(b.local(H_IN + 2 * j + 1),
                            post_limb(j, False)), ch_lo),
                b.add(b.local(H_OUT + 2 * j + 1),
                      b.mul(ch_hi, shift16)),
            )))

        # --- bus ----------------------------------------------------------
        mult = b.local(MULT)
        b.assert_zero(b.mul(mult, b.sub(one, last)))
        msg = [b.local(H_IN + i) for i in range(16)]
        msg += [b.local(MSG + i) for i in range(32)]
        msg += [b.local(H_OUT + i) for i in range(16)]
        b.push_receive(SHA256_BUS, msg, mult)

    # -- trace generation ---------------------------------------------------
    def generate_trace(self, blocks: Sequence, mults: Sequence[int],
                       ) -> np.ndarray:
        """blocks: list of (h_in[8 words], msg[16 words]); mults: bus
        multiplicities. Pads the flagged schedule with zero-message
        compressions at multiplicity 0."""
        n = 1 << self.log_n
        n_slots = n // NUM_ROUNDS
        assert len(blocks) <= n_slots, "trace height too small"
        trace = np.zeros((n, NUM_COLS), dtype=np.uint32)
        pad = None
        for p in range(n_slots):
            if p < len(blocks):
                h_in, msg = blocks[p]
                rows = self._block_rows(list(h_in), list(msg))
                trace[p * NUM_ROUNDS:(p + 1) * NUM_ROUNDS] = rows
                trace[p * NUM_ROUNDS + NUM_ROUNDS - 1, MULT] = mults[p]
            else:
                if pad is None:
                    pad = self._block_rows(list(_H_INIT), [0] * 16)
                trace[p * NUM_ROUNDS:(p + 1) * NUM_ROUNDS] = pad
        return trace

    @staticmethod
    def _block_rows(h_in: List[int], msg: List[int]) -> np.ndarray:
        M32 = (1 << 32) - 1

        def rotr(x, r):
            return ((x >> r) | (x << (32 - r))) & M32

        rows = np.zeros((NUM_ROUNDS, NUM_COLS), dtype=np.uint32)
        # message schedule
        w = list(msg)
        for t in range(16, 64):
            s0 = rotr(w[t - 15], 7) ^ rotr(w[t - 15], 18) ^ (w[t - 15] >> 3)
            s1 = rotr(w[t - 2], 17) ^ rotr(w[t - 2], 19) ^ (w[t - 2] >> 10)
            w.append((w[t - 16] + s0 + w[t - 7] + s1) & M32)

        state = list(h_in)
        for t in range(NUM_ROUNDS):
            row = rows[t]
            a, bv, c, d, e, f, g, h = state
            for vi, val in enumerate(state):
                for z in range(32):
                    row[_var(vi, z)] = (val >> z) & 1
            # window win[i] = W_{t-15+i}
            for i in range(16):
                idx = t - 15 + i
                wv = w[idx] if idx >= 0 else 0
                for z in range(32):
                    row[_win(i, z)] = (wv >> z) & 1
            for j in range(8):
                row[H_IN + 2 * j] = h_in[j] & 0xFFFF
                row[H_IN + 2 * j + 1] = h_in[j] >> 16
            for i in range(16):
                row[MSG + 2 * i] = msg[i] & 0xFFFF
                row[MSG + 2 * i + 1] = msg[i] >> 16

            s1v = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25)
            chv = (e & f) ^ ((~e) & g & M32)
            t1 = (h + s1v + chv + _K[t] + w[t])
            s0v = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22)
            majv = (a & bv) ^ (a & c) ^ (bv & c)
            t2 = (s0v + majv)
            # witnessed nonlinear layers (ungated bindings hold everywhere)
            w1v = w[t - 14] if t - 14 >= 0 else 0   # win[1]
            w14v = w[t - 1] if t - 1 >= 0 else 0    # win[14]
            ss0v = rotr(w1v, 7) ^ rotr(w1v, 18) ^ (w1v >> 3)
            ss1v = rotr(w14v, 17) ^ rotr(w14v, 19) ^ (w14v >> 10)
            for z in range(32):
                row[SIG1 + z] = (s1v >> z) & 1
                row[CH_B + z] = (chv >> z) & 1
                row[SIG0 + z] = (s0v >> z) & 1
                row[MAJ_B + z] = (majv >> z) & 1
                row[SS0 + z] = (ss0v >> z) & 1
                row[SS1 + z] = (ss1v >> z) & 1
            # carries for the limb constraints: the limb sums the
            # constraints build
            def split(x):
                return x & 0xFFFF, (x >> 16) & 0xFFFF
            d_lo, d_hi = split(d)
            h_lo, h_hi = split(h)
            s1_lo, s1_hi = split(s1v)
            ch_lo, ch_hi = split(chv)
            k_lo, k_hi = split(_K[t])
            w_lo, w_hi = split(w[t])
            t1_lo_sum = h_lo + s1_lo + ch_lo + k_lo + w_lo
            t1_hi_sum = h_hi + s1_hi + ch_hi + k_hi + w_hi
            ne = (d + t1) & M32
            ne_lo, ne_hi = split(ne)
            ce_lo = (d_lo + t1_lo_sum - ne_lo) >> 16
            ce_hi = (d_hi + t1_hi_sum + ce_lo - ne_hi) >> 16
            for kk in range(3):
                row[C_E + kk] = (ce_lo >> kk) & 1
                row[C_E + 3 + kk] = (ce_hi >> kk) & 1
            s0_lo, s0_hi = split(s0v)
            mj_lo, mj_hi = split(majv)
            t2_lo_sum = s0_lo + mj_lo
            t2_hi_sum = s0_hi + mj_hi
            na = (t1 + t2) & M32
            na_lo, na_hi = split(na)
            ca_lo = (t1_lo_sum + t2_lo_sum - na_lo) >> 16
            ca_hi = (t1_hi_sum + t2_hi_sum + ca_lo - na_hi) >> 16
            for kk in range(3):
                row[C_A + kk] = (ca_lo >> kk) & 1
                row[C_A + 3 + kk] = (ca_hi >> kk) & 1
            # schedule carries for next W (rows 15..62)
            if 15 <= t <= 62:
                nt = t + 1
                x15, x9, x1, x0 = w[nt - 2], w[nt - 7], w[nt - 15], w[nt - 16]
                # matches constraint: s1(win14=W_{t-1}=W_{nt-2}),
                # win9=W_{nt-7}, s0(win1=W_{nt-15}), win0=W_{nt-16}
                sg1 = rotr(x15, 17) ^ rotr(x15, 19) ^ (x15 >> 10)
                sg0 = rotr(x1, 7) ^ rotr(x1, 18) ^ (x1 >> 3)
                total_lo = (sg1 & 0xFFFF) + (x9 & 0xFFFF) + \
                    (sg0 & 0xFFFF) + (x0 & 0xFFFF)
                total_hi = (sg1 >> 16) + (x9 >> 16) + (sg0 >> 16) + \
                    (x0 >> 16)
                wn = w[nt]
                wn_lo, wn_hi = split(wn)
                cw_lo = (total_lo - wn_lo) >> 16
                cw_hi = (total_hi + cw_lo - wn_hi) >> 16
                row[C_W] = cw_lo & 1
                row[C_W + 1] = (cw_lo >> 1) & 1
                row[C_W + 2] = cw_hi & 1
                row[C_W + 3] = (cw_hi >> 1) & 1

            state = [
                (t1 + t2) & M32, a, bv, c, (d + t1) & M32, e, f, g,
            ]

        # H_out on every row (constant columns), carries on last row
        h_out = [(h_in[j] + state[j]) & M32 for j in range(8)]
        for t in range(NUM_ROUNDS):
            for j in range(8):
                rows[t, H_OUT + 2 * j] = h_out[j] & 0xFFFF
                rows[t, H_OUT + 2 * j + 1] = h_out[j] >> 16
        last = rows[NUM_ROUNDS - 1]
        for j in range(8):
            hi_lo = (h_in[j] & 0xFFFF) + (state[j] & 0xFFFF)
            c_lo = (hi_lo - (h_out[j] & 0xFFFF)) >> 16
            hi_hi = (h_in[j] >> 16) + ((state[j] >> 16) & 0xFFFF) + c_lo
            c_hi = (hi_hi - (h_out[j] >> 16)) >> 16
            last[C_H + 2 * j] = c_lo
            last[C_H + 2 * j + 1] = c_hi
        return rows


# --- host reference --------------------------------------------------------

def sha256_compress(h_in: Sequence[int], msg: Sequence[int]) -> List[int]:
    """One compression over 32-bit words (host oracle)."""
    M32 = (1 << 32) - 1

    def rotr(x, r):
        return ((x >> r) | (x << (32 - r))) & M32

    w = list(msg)
    for t in range(16, 64):
        s0 = rotr(w[t - 15], 7) ^ rotr(w[t - 15], 18) ^ (w[t - 15] >> 3)
        s1 = rotr(w[t - 2], 17) ^ rotr(w[t - 2], 19) ^ (w[t - 2] >> 10)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & M32)
    a, b_, c, d, e, f, g, h = h_in
    for t in range(64):
        s1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25)
        ch = (e & f) ^ ((~e) & g & M32)
        t1 = (h + s1 + ch + _K[t] + w[t]) & ((1 << 40) - 1)
        s0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22)
        maj = (a & b_) ^ (a & c) ^ (b_ & c)
        t2 = s0 + maj
        a, b_, c, d, e, f, g, h = (
            (t1 + t2) & M32, a, b_, c, (d + t1) & M32, e, f, g,
        )
    out = [a, b_, c, d, e, f, g, h]
    return [(x + y) & M32 for x, y in zip(h_in, out)]


def sha256_message_limbs(h_in, msg, h_out) -> List[int]:
    """The 64-limb bus message for one compression call."""
    out = []
    for x in h_in:
        out += [x & 0xFFFF, x >> 16]
    for x in msg:
        out += [x & 0xFFFF, x >> 16]
    for x in h_out:
        out += [x & 0xFFFF, x >> 16]
    return out


H_INIT = list(_H_INIT)
