"""Fp2VmAir: the quadratic-extension-field syscall chip (ECALL a7=9).

The port's copy of the reference's `zkvm_prover_tpu/models/fp2_vm.py`,
the analog of openvm's fp2 VM extension (`fp2 Bn254Fp2`; the batch
circuit adds BLS12-381; both towers are
Fp[u]/(u^2 + 1), so one chip serves every supported base field). One Fp2
operation (mul/add/sub) per row; elements are c0 || c1, two 256-bit LE
coordinates (64 bytes). All 256-bit arithmetic DELEGATES to
BigIntModMulAir over MODMUL_BUS:

  mul  (u^2 = -1):  r0 = x0*y0 - x1*y1,  r1 = x0*y1 + x1*y0
     via  t0 = x0*y0;  t1 = x1*y1;  t1 + r0 == t0  (mod m)
          t2 = x0*y1;  t3 = x1*y0;  r1 = t2 + t3
  add:  r_i = x_i + y_i          sub:  r_i = x_i - y_i

Intermediates (t0..t3) may be any residue class — every congruence is
preserved — while the RAM-written coordinates carry in-chip r < m borrow
chains, so the result is exact (same argument as the EC chips).

Request: (pc, ts, rd_ptr, x_ptr, y_ptr, sel), sel = op*16 + modulus_idx,
handed over FP2_REQ_BUS by SystemAir. Fp2 division composes in-guest
from OP_DIV (norm = c0^2 + c1^2, conjugate scale), as openvm guests do.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .air import Air, AirBuilder
from .bigint_air import MODMUL_BUS, SUPPORTED_MODULI
from .rv32_v2 import EXEC_BUS, FP2_REQ_BUS, TS_STRIDE
from .vm_ext import (
    N_LIMBS,
    N_MODULI,
    N_WORDS,
    _canonicity_chain,
    _fill_canonicity,
    _fill_pointers,
    _fill_port,
    _limbs,
    _mem_port,
    _modulus_limbs,
    _pointer_checks,
)

FP2_OP_MUL, FP2_OP_ADD, FP2_OP_SUB = 0, 1, 2
FP2_TS_WINDOW = 56  # 32 reads + 16 writes + margin

# --- column layout ---------------------------------------------------------
IS_REAL = 0
F2_MUL, F2_ADD, F2_SUB = 1, 2, 3
FMOD = 4
REQ_PC = FMOD + N_MODULI
REQ_TS = REQ_PC + 1
RD0, RD1 = REQ_TS + 1, REQ_TS + 2
X0, X1 = RD1 + 1, RD1 + 2
Y0, Y1 = X1 + 1, X1 + 2
SEL = Y1 + 1
RD_Q, X_Q, Y_Q = SEL + 1, SEL + 2, SEL + 3
XRD = Y_Q + 1                    # 16 x [prev_ts, d0, d1, v0..v3] (x c0||c1)
YRD = XRD + 7 * 2 * N_WORDS
WRP = YRD + 7 * 2 * N_WORDS
RES = WRP + 7 * 2 * N_WORDS      # 64 result limbs (r0||r1)
T_ = RES + 2 * N_LIMBS           # 4 x 32 mul intermediates t0..t3
CMP_D = T_ + 4 * N_LIMBS         # 2 x 32 canonicity d limbs
CMP_BW = CMP_D + 2 * N_LIMBS     # 2 x 31 borrow bits
FP2_NUM_COLS = CMP_BW + 2 * (N_LIMBS - 1)


class Fp2VmAir(Air):
    width = FP2_NUM_COLS
    num_public_values = 0

    def eval(self, b: AirBuilder) -> None:
        one = b.constant(1)
        c256 = b.constant(256)
        real = b.local(IS_REAL)
        b.assert_bool(real)
        f_op = [b.local(F2_MUL), b.local(F2_ADD), b.local(F2_SUB)]
        f_m = [b.local(FMOD + j) for j in range(N_MODULI)]
        for f in f_op + f_m:
            b.assert_bool(f)
        b.assert_eq(b.add(b.add(f_op[0], f_op[1]), f_op[2]), real)
        m_sum = f_m[0]
        for f in f_m[1:]:
            m_sum = b.add(m_sum, f)
        b.assert_eq(m_sum, real)

        sel_expr = b.mul(b.constant(16),
                         b.add(f_op[1], b.mul(b.constant(2), f_op[2])))
        for j in range(1, N_MODULI):
            sel_expr = b.add(sel_expr, b.mul(b.constant(j), f_m[j]))
        b.assert_zero(b.mul(real, b.sub(b.local(SEL), sel_expr)))

        pc, ts = b.local(REQ_PC), b.local(REQ_TS)
        b.push_receive(
            FP2_REQ_BUS,
            [pc, ts, b.local(RD0), b.local(RD1), b.local(X0), b.local(X1),
             b.local(Y0), b.local(Y1), b.local(SEL)],
            real)

        _pointer_checks(b, real, ((RD0, RD1, RD_Q), (X0, X1, X_Q), (Y0, Y1, Y_Q)))
        rd_f = b.add(b.local(RD0), b.mul(c256, b.local(RD1)))
        x_f = b.add(b.local(X0), b.mul(c256, b.local(X1)))
        y_f = b.add(b.local(Y0), b.mul(c256, b.local(Y1)))

        ts_base = b.add(ts, b.constant(TS_STRIDE))

        x_limbs, y_limbs = [], []
        for w in range(2 * N_WORDS):
            base = XRD + 7 * w
            vals = [b.local(base + 3 + k) for k in range(4)]
            x_limbs += vals
            _mem_port(b, base, b.add(x_f, b.constant(4 * w)),
                      b.add(ts_base, b.constant(w)), vals, vals, real)
        for w in range(2 * N_WORDS):
            base = YRD + 7 * w
            vals = [b.local(base + 3 + k) for k in range(4)]
            y_limbs += vals
            _mem_port(b, base, b.add(y_f, b.constant(4 * w)),
                      b.add(ts_base, b.constant(2 * N_WORDS + w)), vals,
                      vals, real)
        r_limbs = [b.local(RES + k) for k in range(2 * N_LIMBS)]
        for w in range(2 * N_WORDS):
            base = WRP + 7 * w
            old = [b.local(base + 3 + k) for k in range(4)]
            new = r_limbs[4 * w : 4 * w + 4]
            _mem_port(b, base, b.add(rd_f, b.constant(4 * w)),
                      b.add(ts_base, b.constant(4 * N_WORDS + w)), old, new,
                      real)

        m_limbs = _modulus_limbs(b, f_m)

        x0, x1c = x_limbs[:N_LIMBS], x_limbs[N_LIMBS:]
        y0, y1c = y_limbs[:N_LIMBS], y_limbs[N_LIMBS:]
        r0, r1c = r_limbs[:N_LIMBS], r_limbs[N_LIMBS:]
        t0 = [b.local(T_ + k) for k in range(N_LIMBS)]
        t1 = [b.local(T_ + N_LIMBS + k) for k in range(N_LIMBS)]
        t2 = [b.local(T_ + 2 * N_LIMBS + k) for k in range(N_LIMBS)]
        t3 = [b.local(T_ + 3 * N_LIMBS + k) for k in range(N_LIMBS)]
        zero = b.constant(0)
        zeros = [zero] * N_LIMBS
        one_l = [one] + [zero] * (N_LIMBS - 1)
        f_mul, f_add, f_sub = f_op

        # mul: t0 = x0*y0; t1 = x1*y1; t1 + r0 == t0; t2 = x0*y1;
        #      t3 = x1*y0; r1 = t2 + t3
        b.push_send(MODMUL_BUS, x0 + y0 + zeros + t0 + m_limbs, f_mul)
        b.push_send(MODMUL_BUS, x1c + y1c + zeros + t1 + m_limbs, f_mul)
        b.push_send(MODMUL_BUS, one_l + t1 + r0 + t0 + m_limbs, f_mul)
        b.push_send(MODMUL_BUS, x0 + y1c + zeros + t2 + m_limbs, f_mul)
        b.push_send(MODMUL_BUS, x1c + y0 + zeros + t3 + m_limbs, f_mul)
        b.push_send(MODMUL_BUS, t2 + one_l + t3 + r1c + m_limbs, f_mul)
        # add: r_i = x_i + y_i
        b.push_send(MODMUL_BUS, x0 + one_l + y0 + r0 + m_limbs, f_add)
        b.push_send(MODMUL_BUS, x1c + one_l + y1c + r1c + m_limbs, f_add)
        # sub: y_i + r_i == x_i
        b.push_send(MODMUL_BUS, one_l + y0 + r0 + x0 + m_limbs, f_sub)
        b.push_send(MODMUL_BUS, one_l + y1c + r1c + x1c + m_limbs, f_sub)

        # RAM-written coordinates are canonical
        _canonicity_chain(b, real, r0, m_limbs, CMP_D, CMP_BW)
        _canonicity_chain(b, real, r1c, m_limbs, CMP_D + N_LIMBS,
                          CMP_BW + (N_LIMBS - 1))

        b.push_send(
            EXEC_BUS,
            [b.add(pc, b.constant(4)),
             b.add(ts, b.constant(TS_STRIDE + FP2_TS_WINDOW))],
            real)


def fill_fp2_row(st, pc: int, ts: int, rd_ptr: int, x_ptr: int,
                 y_ptr: int, sel: int) -> Tuple[np.ndarray, List[Tuple]]:
    """Build the Fp2VmAir row for one a7=9 syscall. Returns
    (row, bigint_ops): the (a, b, c, m) requests BigIntModMulAir serves."""
    op, mi = sel >> 4, sel & 15
    assert op in (FP2_OP_MUL, FP2_OP_ADD, FP2_OP_SUB) and mi < N_MODULI
    m = SUPPORTED_MODULI[mi]
    row = np.zeros(FP2_NUM_COLS, dtype=np.uint32)
    row[IS_REAL] = 1
    row[(F2_MUL, F2_ADD, F2_SUB)[op]] = 1
    row[FMOD + mi] = 1
    row[REQ_PC], row[REQ_TS] = pc, ts
    row[SEL] = sel
    _fill_pointers(st, row, ((rd_ptr, RD0, RD1, RD_Q),
                            (x_ptr, X0, X1, X_Q),
                            (y_ptr, Y0, Y1, Y_Q)))

    ts_base = ts + TS_STRIDE

    xv = yv = 0
    for w in range(2 * N_WORDS):
        xv |= _fill_port(st, row, XRD + 7 * w, x_ptr + 4 * w, ts_base + w) << (32 * w)
    for w in range(2 * N_WORDS):
        yv |= _fill_port(st, row, YRD + 7 * w, y_ptr + 4 * w,
                         ts_base + 2 * N_WORDS + w) << (32 * w)
    M256 = (1 << 256) - 1
    x0, x1 = xv & M256, xv >> 256
    y0, y1 = yv & M256, yv >> 256

    if op == FP2_OP_MUL:
        t0, t1 = x0 * y0 % m, x1 * y1 % m
        t2, t3 = x0 * y1 % m, x1 * y0 % m
        r0, r1 = (t0 - t1) % m, (t2 + t3) % m
        for i, t in enumerate((t0, t1, t2, t3)):
            row[T_ + i * N_LIMBS : T_ + (i + 1) * N_LIMBS] = _limbs(t)
        bigint_ops = [(x0, y0, 0, m), (x1, y1, 0, m), (1, t1, r0, m),
                      (x0, y1, 0, m), (x1, y0, 0, m), (t2, 1, t3, m)]
    elif op == FP2_OP_ADD:
        r0, r1 = (x0 + y0) % m, (x1 + y1) % m
        bigint_ops = [(x0, 1, y0, m), (x1, 1, y1, m)]
    else:
        r0, r1 = (x0 - y0) % m, (x1 - y1) % m
        bigint_ops = [(1, y0, r0, m), (1, y1, r1, m)]

    res = r0 | (r1 << 256)
    for k in range(2 * N_LIMBS):
        row[RES + k] = (res >> (8 * k)) & 0xFF
    _fill_canonicity(st, row, r0, m, CMP_D, CMP_BW)
    _fill_canonicity(st, row, r1, m, CMP_D + N_LIMBS,
                     CMP_BW + (N_LIMBS - 1))

    for w in range(2 * N_WORDS):
        _fill_port(st, row, WRP + 7 * w, rd_ptr + 4 * w, ts_base + 4 * N_WORDS + w,
                   (res >> (32 * w)) & 0xFFFFFFFF)
    return row, bigint_ops
