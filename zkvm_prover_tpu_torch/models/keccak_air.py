"""Keccak-f[1600] permutation AIR — one round per row, 24 rows per
permutation.

The port's copy of the reference's `zkvm_prover_tpu/models/keccak_air.py`,
the analog of openvm's keccak extension chip. Other chips prove keccak-f
evaluations by sending `(state_in[100] || state_out[100])` 16-bit-limb
messages on KECCAK_F_BUS; this chip holds one permutation per 24-row block
and receives each message with a witnessed multiplicity on the final-round
row.

Constraint design (independent implementation of the well-known bit-level
round decomposition used by Plonky3's keccak AIR, within the MAX_DEGREE=3
budget):

- theta: witness the column parities C[x][z] (bits) and
  C'[x][z] = C[x][z] ^ C[x-1][z] ^ C[x+1][z-1] via the cubic xor3
  polynomial; witness A'[x][y][z] = A[x][y][z] ^ C[x][z] ^ C'[x][z] as
  bits; bind A (16-bit limbs) to A' by recomposing
  A[x][y][z] = xor3(A'[x][y][z], C[x][z], C'[x][z]); pin the parity with
  diff = sum_y A'[x][y][z] - C'[x][z] in {0, 2, 4} (cubic).
- rho/pi are free: pure index rotation of A' bits.
- chi: A''[x][y][z] = B[x][y][z] ^ (~B[x+1][y][z] & B[x+2][y][z]) is
  quadratic in the B bits; stored as 16-bit limbs.
- iota: only lane (0,0) — decompose A''[0][0] into bits, xor the round
  constant bits (preprocessed per-row columns), recompose.
- round chaining: within a permutation, next row's A = this row's A'''
  (A'' with the iota lane patched); the first round's A equals the
  preimage; the preimage is copied down all 24 rows so the final-round row
  carries (input, output) for the bus send.

Rows not covered by a permutation are all-zero padding: every ungated
constraint is satisfied by the zero state, and the preprocessed flags are
zero there, so no chaining/bus constraints fire.

The step flags and iota round-constant bits are *preprocessed* columns
(this chip's rows are a fixed 24-periodic schedule — verifier-known, part
of the vk), which removes Plonky3's flag-rotation constraints entirely.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from ..ops.keccak import _ROUND_CONSTANTS, _ROTATIONS, keccak_f1600
from .air import Air, AirBuilder

KECCAK_F_BUS = 41

NUM_ROUNDS = 24
U64_LIMBS = 4          # 16-bit limbs per 64-bit lane
STATE_LIMBS = 25 * U64_LIMBS   # 100

# --- preprocessed layout ---------------------------------------------------
P_FIRST = 0            # 1 on round-0 rows
P_LAST = 1             # 1 on round-23 rows
P_NOT_LAST = 2         # 1 on rounds 0..22 (active, non-final)
P_RC = 3               # 64 round-constant bits for this row's round
PRE_WIDTH = 3 + 64

# --- main layout -----------------------------------------------------------
PREIMAGE = 0                         # 100 limbs (constant down the block)
A = PREIMAGE + STATE_LIMBS           # 100 limbs: round input state
C = A + STATE_LIMBS                  # 5*64 bits
C_PRIME = C + 5 * 64                 # 5*64 bits
A_PRIME = C_PRIME + 5 * 64           # 25*64 bits
A_PP = A_PRIME + 25 * 64             # 100 limbs: after chi
A_PP_00_BITS = A_PP + STATE_LIMBS    # 64 bits of lane (0,0) after chi
A_PPP_00 = A_PP_00_BITS + 64         # 4 limbs of lane (0,0) after iota
MULT = A_PPP_00 + U64_LIMBS          # bus multiplicity (final rows only)
NUM_COLS = MULT + 1


def _limb_idx(x: int, y: int, limb: int) -> int:
    """Column offset of limb `limb` of lane (x, y) within a 100-limb state
    block (lane order matches ops/keccak.py: index x + 5*y)."""
    return (x + 5 * y) * U64_LIMBS + limb


def _aprime_idx(x: int, y: int, z: int) -> int:
    return ((x + 5 * y) * 64) + z


class KeccakfAir(Air):
    width = NUM_COLS
    num_public_values = 0
    preprocessed_width = PRE_WIDTH

    def __init__(self, log_n: int = 5):
        """log_n: trace height (the preprocessed schedule depends on it)."""
        self.log_n = log_n

    def preprocessed_trace(self) -> np.ndarray:
        n = 1 << self.log_n
        pre = np.zeros((n, PRE_WIDTH), dtype=np.uint32)
        n_perms = n // NUM_ROUNDS
        for p in range(n_perms):
            for r in range(NUM_ROUNDS):
                row = p * NUM_ROUNDS + r
                if r == 0:
                    pre[row, P_FIRST] = 1
                if r == NUM_ROUNDS - 1:
                    pre[row, P_LAST] = 1
                else:
                    pre[row, P_NOT_LAST] = 1
                rc = _ROUND_CONSTANTS[r]
                for z in range(64):
                    pre[row, P_RC + z] = (rc >> z) & 1
        return pre

    def eval(self, b: AirBuilder) -> None:
        one = b.constant(1)
        two = b.constant(2)
        four = b.constant(4)
        first = b.preprocessed(P_FIRST)
        last = b.preprocessed(P_LAST)
        not_last = b.preprocessed(P_NOT_LAST)

        def xor2(p, q):
            # p + q - 2pq  (degree 2)
            return b.sub(b.add(p, q), b.mul(two, b.mul(p, q)))

        def xor3(p, q, r):
            # degree 3 over bits
            return xor2(xor2(p, q), r)

        c = [[b.local(C + x * 64 + z) for z in range(64)] for x in range(5)]
        cp = [
            [b.local(C_PRIME + x * 64 + z) for z in range(64)]
            for x in range(5)
        ]
        ap = [
            [
                [b.local(A_PRIME + _aprime_idx(x, y, z)) for z in range(64)]
                for y in range(5)
            ]
            for x in range(5)
        ]

        # --- theta ---------------------------------------------------------
        for x in range(5):
            for z in range(64):
                b.assert_bool(c[x][z])
                # C'[x,z] = C[x,z] ^ C[x-1,z] ^ C[x+1,z-1]
                b.assert_eq(
                    cp[x][z],
                    xor3(
                        c[x][z],
                        c[(x + 4) % 5][z],
                        c[(x + 1) % 5][(z + 63) % 64],
                    ),
                )
        for x in range(5):
            for y in range(5):
                for z in range(64):
                    b.assert_bool(ap[x][y][z])
        # A limbs recompose from A' (A = A' ^ C ^ C')
        for x in range(5):
            for y in range(5):
                for limb in range(U64_LIMBS):
                    acc = None
                    for k in range(16):
                        z = limb * 16 + k
                        bit = xor3(ap[x][y][z], c[x][z], cp[x][z])
                        term = (
                            bit if k == 0
                            else b.mul(b.constant(1 << k), bit)
                        )
                        acc = term if acc is None else b.add(acc, term)
                    b.assert_eq(b.local(A + _limb_idx(x, y, limb)), acc)
        # parity: sum_y A'[x,y,z] - C'[x,z] in {0,2,4}
        for x in range(5):
            for z in range(64):
                s = ap[x][0][z]
                for y in range(1, 5):
                    s = b.add(s, ap[x][y][z])
                diff = b.sub(s, cp[x][z])
                b.assert_zero(
                    b.mul(b.mul(diff, b.sub(diff, two)), b.sub(diff, four))
                )

        # --- rho/pi (index mapping) + chi ----------------------------------
        def b_bit(x: int, y: int, z: int):
            """B[x,y,z]: A' after rho+pi. B[y, 2x+3y] = rotl(A'[x,y], r)."""
            # find (sx, sy) with x == sy, y == (2*sx + 3*sy) % 5
            sx, sy = next(
                (i, j) for i in range(5) for j in range(5)
                if x == j and y == (2 * i + 3 * j) % 5
            )
            rot = _ROTATIONS[sx][sy]
            return ap[sx][sy][(z - rot) % 64]

        for x in range(5):
            for y in range(5):
                for limb in range(U64_LIMBS):
                    acc = None
                    for k in range(16):
                        z = limb * 16 + k
                        b1 = b_bit(x, y, z)
                        b2 = b_bit((x + 1) % 5, y, z)
                        b3 = b_bit((x + 2) % 5, y, z)
                        # B1 ^ (~B2 & B3)  (quadratic in bits)
                        andn = b.mul(b.sub(one, b2), b3)
                        bit = xor2(b1, andn)
                        term = (
                            bit if k == 0
                            else b.mul(b.constant(1 << k), bit)
                        )
                        acc = term if acc is None else b.add(acc, term)
                    b.assert_eq(b.local(A_PP + _limb_idx(x, y, limb)), acc)

        # --- iota on lane (0,0) --------------------------------------------
        pp_bits = [b.local(A_PP_00_BITS + z) for z in range(64)]
        for z in range(64):
            b.assert_bool(pp_bits[z])
        for limb in range(U64_LIMBS):
            acc = None
            for k in range(16):
                z = limb * 16 + k
                term = (
                    pp_bits[z] if k == 0
                    else b.mul(b.constant(1 << k), pp_bits[z])
                )
                acc = term if acc is None else b.add(acc, term)
            b.assert_eq(b.local(A_PP + _limb_idx(0, 0, limb)), acc)
        for limb in range(U64_LIMBS):
            acc = None
            for k in range(16):
                z = limb * 16 + k
                bit = xor2(pp_bits[z], b.preprocessed(P_RC + z))
                term = (
                    bit if k == 0 else b.mul(b.constant(1 << k), bit)
                )
                acc = term if acc is None else b.add(acc, term)
            b.assert_eq(b.local(A_PPP_00 + limb), acc)

        # --- preimage constant down the block; first round A == preimage ---
        for i in range(STATE_LIMBS):
            b.when_transition().assert_zero(
                b.mul(not_last, b.sub(b.next(PREIMAGE + i),
                                      b.local(PREIMAGE + i)))
            )
            b.assert_zero(
                b.mul(first, b.sub(b.local(A + i), b.local(PREIMAGE + i)))
            )

        # --- round chaining: next.A == A''' --------------------------------
        def appp(x: int, y: int, limb: int):
            if x == 0 and y == 0:
                return b.local(A_PPP_00 + limb)
            return b.local(A_PP + _limb_idx(x, y, limb))

        for x in range(5):
            for y in range(5):
                for limb in range(U64_LIMBS):
                    b.when_transition().assert_zero(
                        b.mul(
                            not_last,
                            b.sub(b.next(A + _limb_idx(x, y, limb)),
                                  appp(x, y, limb)),
                        )
                    )

        # --- bus: final-round rows export (preimage, output) ----------------
        mult = b.local(MULT)
        b.assert_zero(b.mul(mult, b.sub(one, last)))
        msg = [b.local(PREIMAGE + i) for i in range(STATE_LIMBS)]
        msg += [
            appp(x, y, limb)
            for y in range(5) for x in range(5)
            for limb in range(U64_LIMBS)
        ]
        b.push_receive(KECCAK_F_BUS, msg, mult)

    # -- trace generation ---------------------------------------------------
    def generate_trace(self, states: Sequence[Sequence[int]],
                       mults: Sequence[int]) -> np.ndarray:
        """states: input states (25 lanes each); mults: bus multiplicity
        per permutation. Returns the (2^log_n, NUM_COLS) canonical trace."""
        n = 1 << self.log_n
        assert len(states) * NUM_ROUNDS <= n, "trace height too small"
        assert n // NUM_ROUNDS >= len(states)
        trace = np.zeros((n, NUM_COLS), dtype=np.uint32)
        for p, (state, mult) in enumerate(zip(states, mults)):
            rows = self._perm_rows(list(state))
            r0 = p * NUM_ROUNDS
            trace[r0 : r0 + NUM_ROUNDS, :] = rows
            trace[r0 + NUM_ROUNDS - 1, MULT] = mult
        # Every block the preprocessed schedule flags must hold a valid
        # permutation: the ungated iota constraint forces
        # A_PPP_00 = recompose(bits ^ RC) != 0 on flagged rows, so all-zero
        # rows there are unsatisfiable. Pad unused flagged blocks with the
        # zero-state permutation at multiplicity 0 (computed once, tiled).
        n_blocks = n // NUM_ROUNDS
        if len(states) < n_blocks:
            pad = self._perm_rows([0] * 25)
            for p in range(len(states), n_blocks):
                trace[p * NUM_ROUNDS : (p + 1) * NUM_ROUNDS, :] = pad
        return trace

    @staticmethod
    def _perm_rows(a: List[int]) -> np.ndarray:
        rows = np.zeros((NUM_ROUNDS, NUM_COLS), dtype=np.uint32)
        preimage = list(a)
        for r in range(NUM_ROUNDS):
            row = rows[r]
            for i in range(25):
                for limb in range(U64_LIMBS):
                    v = (preimage[i] >> (16 * limb)) & 0xFFFF
                    row[PREIMAGE + i * U64_LIMBS + limb] = v
                    row[A + i * U64_LIMBS + limb] = (
                        (a[i] >> (16 * limb)) & 0xFFFF
                    )
            # theta
            cl = [
                a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20]
                for x in range(5)
            ]
            cpl = [
                cl[x] ^ cl[(x + 4) % 5]
                ^ (((cl[(x + 1) % 5] << 1)
                    | (cl[(x + 1) % 5] >> 63)) & ((1 << 64) - 1))
                for x in range(5)
            ]
            apl = [a[x + 5 * y] ^ cl[x] ^ cpl[x]
                   for y in range(5) for x in range(5)]
            for x in range(5):
                for z in range(64):
                    row[C + x * 64 + z] = (cl[x] >> z) & 1
                    row[C_PRIME + x * 64 + z] = (cpl[x] >> z) & 1
            for y in range(5):
                for x in range(5):
                    lane = apl[x + 5 * y]
                    base = A_PRIME + _aprime_idx(x, y, 0)
                    for z in range(64):
                        row[base + z] = (lane >> z) & 1
            # rho/pi on A'
            bl = [0] * 25
            for sx in range(5):
                for sy in range(5):
                    rot = _ROTATIONS[sx][sy]
                    lane = apl[sx + 5 * sy]
                    rl = ((lane << rot) | (lane >> (64 - rot))) \
                        & ((1 << 64) - 1) if rot else lane
                    bl[sy + 5 * ((2 * sx + 3 * sy) % 5)] = rl
            # chi
            ppl = [
                bl[x + 5 * y]
                ^ ((~bl[(x + 1) % 5 + 5 * y]) & bl[(x + 2) % 5 + 5 * y]
                   & ((1 << 64) - 1))
                for y in range(5) for x in range(5)
            ]
            for y in range(5):
                for x in range(5):
                    lane = ppl[x + 5 * y]
                    for limb in range(U64_LIMBS):
                        row[A_PP + _limb_idx(x, y, limb)] = (
                            (lane >> (16 * limb)) & 0xFFFF
                        )
            for z in range(64):
                row[A_PP_00_BITS + z] = (ppl[0] >> z) & 1
            iota = ppl[0] ^ _ROUND_CONSTANTS[r]
            for limb in range(U64_LIMBS):
                row[A_PPP_00 + limb] = (iota >> (16 * limb)) & 0xFFFF
            a = list(ppl)
            a[0] = iota
        return rows


def state_limbs(state: Sequence[int]) -> List[int]:
    """25 lanes -> 100 16-bit limbs (bus message order)."""
    return [
        (int(lane) >> (16 * limb)) & 0xFFFF
        for lane in state for limb in range(U64_LIMBS)
    ]


def keccakf_message(state_in: Sequence[int]) -> List[int]:
    """The 200-limb bus message for one permutation call."""
    out = keccak_f1600(list(state_in))
    return state_limbs(state_in) + state_limbs(out)
