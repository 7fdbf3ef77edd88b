"""256-bit modular arithmetic AIR: the openvm bigint/modular extension
analog (`bigint` + `modular` with six supported moduli). The port's copy
of the reference's `zkvm_prover_tpu/models/bigint_air.py`: the same
layout, constraints, bus ids and trace.

One operation per row: proves  a * b + c  ==  q * m + r  as an exact
integer identity, which covers
  - modmul:   c = 0  ->  r = a*b mod m
  - modadd:   b = 1  ->  r = (a + c) mod m   (q in {0,1})
  - modsub:   rewritten host-side as modadd with the complement
256-bit operands are 32 x 8-bit limbs: limb products stay < 2^16 and a
64-term convolution column sum stays < 2^21 << p ~ 2^31, so the carry
chain fits BabyBear without splitting (the reason for 8-bit, not 16-bit,
limbs).

Constraint, for every convolution coefficient k in [0, 63):
    conv_k(a,b) + c_k - conv_k(q,m) - r_k + carry_{k-1} - 256*carry_k = 0
gated by is_real (degree 3). Carries are signed and bounded
(|carry| < 2^15); each is witnessed as an offset value
carry + 2^15 = lo + 256*hi with lo/hi byte-range-checked through the
shared byte-table bus, as are all operand limbs. The top coefficient's
carry-out must be zero, closing the identity exactly.

The chip receives (a, b, c, r, m) messages on MODMUL_BUS with witnessed
multiplicity on active rows; q and the carries are private witnesses.
r < m canonicity is NOT enforced in-chip (documented divergence — openvm
adds a dedicated comparison chip; callers treating r as canonical must
additionally compare r against m).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from .air import Air, AirBuilder

MODMUL_BUS = 44
from .rv32_v0 import BYTE_BUS as BYTE_BUS_BIGINT  # shared byte table

N_LIMBS = 32          # 8-bit limbs per 256-bit operand
N_COL_SUMS = 2 * N_LIMBS - 1   # 63 convolution coefficients
N_CARRY = N_COL_SUMS - 1       # 62 witnessed carries

# |carry_k| <= (64*255^2 + carry_in)/256 < 2^15
CARRY_OFFSET = 1 << 15

# --- layout ----------------------------------------------------------------
IS_REAL = 0
A = 1                      # 32 limbs each
B = A + N_LIMBS
C = B + N_LIMBS
Q = C + N_LIMBS
M = Q + N_LIMBS
R_ = M + N_LIMBS
CARRY_LO = R_ + N_LIMBS    # 62 byte columns
CARRY_HI = CARRY_LO + N_CARRY
MULT_END = CARRY_HI + N_CARRY
NUM_COLS = MULT_END


class BigIntModMulAir(Air):
    """a*b + c == q*m + r over 256-bit integers, 8-bit limbs."""

    width = NUM_COLS
    num_public_values = 0

    def eval(self, b: AirBuilder) -> None:
        is_real = b.local(IS_REAL)
        b.assert_bool(is_real)

        def limbs(base):
            return [b.local(base + i) for i in range(N_LIMBS)]

        la, lb, lc = limbs(A), limbs(B), limbs(C)
        lq, lm, lr = limbs(Q), limbs(M), limbs(R_)

        # byte range checks through the shared byte table (padding rows
        # are all-zero and send nothing)
        for col in (la, lb, lc, lq, lm, lr):
            for v in col:
                b.push_send(BYTE_BUS_BIGINT, [v], is_real)
        for k in range(N_CARRY):
            b.push_send(BYTE_BUS_BIGINT, [b.local(CARRY_LO + k)], is_real)
            b.push_send(BYTE_BUS_BIGINT, [b.local(CARRY_HI + k)], is_real)

        # signed carry from its byte split
        carries = []
        for k in range(N_CARRY):
            off = b.add(b.local(CARRY_LO + k),
                        b.mul(b.constant(256), b.local(CARRY_HI + k)))
            carries.append(b.sub(off, b.constant(CARRY_OFFSET)))

        def conv(k, xs, ys):
            lo = max(0, k - (N_LIMBS - 1))
            hi = min(k, N_LIMBS - 1)
            acc = None
            for i in range(lo, hi + 1):
                t = b.mul(xs[i], ys[k - i])
                acc = t if acc is None else b.add(acc, t)
            return acc

        prev_carry = None
        for k in range(N_COL_SUMS):
            expr = b.sub(conv(k, la, lb), conv(k, lq, lm))
            if k < N_LIMBS:
                expr = b.add(expr, lc[k])
                expr = b.sub(expr, lr[k])
            if prev_carry is not None:
                expr = b.add(expr, prev_carry)
            if k < N_CARRY:
                expr = b.sub(expr, b.mul(b.constant(256), carries[k]))
                prev_carry = carries[k]
            # k == N_COL_SUMS-1: no carry-out — the identity closes here
            b.assert_zero(b.mul(is_real, expr))

        # bus: receive modular-op requests on active rows
        msg = la + lb + lc + lr + lm
        b.push_receive(MODMUL_BUS, msg, is_real)

    # -- trace generation ---------------------------------------------------
    @staticmethod
    def generate_trace(ops: Sequence, n_rows: int = 0) -> np.ndarray:
        """ops: list of (a, b, c, m) python ints; computes q, r, carries.
        The 256-bit values stay python ints; their byte limbs and the carry
        chain are numpy over all rows at once."""
        n = max(4, n_rows or (1 << max(2, (len(ops) - 1).bit_length())))
        assert len(ops) <= n
        trace = np.zeros((n, NUM_COLS), dtype=np.uint32)
        if not ops:
            return trace
        vals = []
        for a, bv, c, m in ops:
            assert m > 0 and 0 <= a < 1 << 256 and 0 <= bv < 1 << 256 \
                and 0 <= c < 1 << 256
            q, r = divmod(a * bv + c, m)
            assert q < 1 << 256, "quotient overflow (operands too large)"
            vals += (a, bv, c, q, m, r)
        rows = len(ops)
        limbs = np.frombuffer(b"".join(v.to_bytes(N_LIMBS, "little") for v in vals),
                              dtype=np.uint8).reshape(rows, 6, N_LIMBS)
        tr = trace[:rows]
        tr[:, IS_REAL] = 1
        for j, base in enumerate((A, B, C, Q, M, R_)):
            tr[:, base : base + N_LIMBS] = limbs[:, j]
        la, lb, lc, lq, lm, lr = limbs.astype(np.int64).transpose(1, 0, 2)
        # column sums conv_k(a, b) - conv_k(q, m) + c_k - r_k, then the
        # signed carry chain down the 62 carried coefficients
        sums = np.zeros((rows, N_COL_SUMS), dtype=np.int64)
        for i in range(N_LIMBS):
            sums[:, i : i + N_LIMBS] += la[:, i : i + 1] * lb - lq[:, i : i + 1] * lm
        sums[:, :N_LIMBS] += lc - lr
        carry = np.zeros(rows, dtype=np.int64)
        for k in range(N_CARRY):
            s = sums[:, k] + carry
            assert not (s % 256).any(), "carry chain broken"
            carry = s // 256
            assert (np.abs(carry) < CARRY_OFFSET).all(), "carry out of range"
            off = carry + CARRY_OFFSET
            tr[:, CARRY_LO + k] = off & 0xFF
            tr[:, CARRY_HI + k] = off >> 8
        return trace

    @staticmethod
    def byte_lookups(trace: np.ndarray) -> np.ndarray:
        """Multiplicity vector (256,) the byte table must serve for this
        trace's range checks (operand limbs + carry bytes)."""
        real = trace[trace[:, IS_REAL] != 0, A:MULT_END]
        return np.bincount(real.ravel().astype(np.int64), minlength=256)


def _limbs(x: int) -> np.ndarray:
    return np.array([(x >> (8 * i)) & 0xFF for i in range(N_LIMBS)],
                    dtype=np.uint32)


def modmul_message(a: int, bv: int, c: int, m: int) -> List[int]:
    """MODMUL_BUS message limbs for a request (a*b + c mod m)."""
    r = (a * bv + c) % m
    out: List[int] = []
    for x in (a, bv, c, r, m):
        out.extend(int(v) for v in _limbs(x))
    return out


# the six supported moduli (openvm.toml modular extension parity)
SUPPORTED_MODULI = [
    # BN254 base / scalar
    21888242871839275222246405745257275088696311157297823662689037894645226208583,
    21888242871839275222246405745257275088548364400416034343698204186575808495617,
    # secp256k1 base / scalar
    0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F,
    0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141,
    # secp256r1 (P-256) base / scalar
    0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFF,
    0xFFFFFFFF00000000FFFFFFFFFFFFFFFFBCE6FAADA7179E84F3B9CAC2FC632551,
]
