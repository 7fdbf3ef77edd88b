"""VM-extension syscall chips: modular arithmetic (a7=4) and EC point
addition (a7=5) for the rv32 v2 machine.

The port's copy of the reference's `zkvm_prover_tpu/models/vm_ext.py`,
the analogs of openvm's modular/bigint and ecc VM extensions
(`modular.supported_moduli`, `ecc.supported_curves`). The guest issues an
ECALL; `SystemAir` reads the argument registers and hands the request over
MOD_REQ_BUS / EC_REQ_BUS; these chips

  - read the 256-bit operands from RAM over MEM_BUS (offline memory
    checking, 8-bit limbs = the RAM byte limbs, so no repacking),
  - DELEGATE all 256-bit arithmetic to BigIntModMulAir over MODMUL_BUS
    (ModularVmAir: one request; EcVmAir: via EcAddAir on EC_ADD_BUS,
    which itself expands to ten MODMUL_BUS requests),
  - write the result limbs back to RAM and send the execution-chain
    continuation (pc+4) on EXEC_BUS, owning the instruction's timestamp
    window.

Range checks ride the buses: BigIntModMulAir byte-checks every limb of
every message it receives, so operand and result limbs here are bytes by
bus tuple equality; only timestamp-diff bytes and pointer components are
checked locally.

Provable domain: canonical operands (x, y < m). The bigint identity
a*b + c == q*m + r needs q < 2^256, which non-canonical 256-bit operands
can violate for the ~2^254 moduli; the native executor reduces fully
either way (native/vm/rv32im.cpp a7=4/5), matching openvm's documented
canonical-input contract.

Result canonicity IS enforced in-chip: every limb vector written back to
guest RAM carries a byte borrow chain proving r < m (_canonicity_chain
— the openvm comparison-chip analog), so the congruence fixed by the
delegated arithmetic plus the range pin make the RAM result unique.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .air import Air, AirBuilder
from .bigint_air import MODMUL_BUS, SUPPORTED_MODULI
from .ec_air import EC_ADD_BUS
from .ec_double import EC_DBL_BUS
from .rv32_v0 import BYTE_BUS
from .rv32_v2 import (
    EC_DBL_REQ_BUS,
    EC_REQ_BUS,
    EXEC_BUS,
    MEM_BUS,
    MOD_REQ_BUS,
    RANGE16_BUS,
    TS_STRIDE,
)

N_LIMBS = 32            # 8-bit limbs per 256-bit operand
N_WORDS = 8             # RAM words per operand
MOD_TS_WINDOW = 32      # 16 reads + 8 writes + margin
EC_TS_WINDOW = 56       # 32 reads + 16 writes + margin

OP_MUL, OP_ADD, OP_SUB, OP_DIV = 0, 1, 2, 3

# Modulus byte tables: M_TABLE[j][k] = limb k of SUPPORTED_MODULI[j]
M_TABLE = [[(m >> (8 * k)) & 0xFF for k in range(N_LIMBS)]
           for m in SUPPORTED_MODULI]
N_MODULI = len(SUPPORTED_MODULI)


def _limbs(x: int) -> List[int]:
    return [(x >> (8 * i)) & 0xFF for i in range(N_LIMBS)]


def _mem_port(b: AirBuilder, base_col: int, addr, cur_ts, old_vals, new_vals,
              mult) -> None:
    """One offline memory-checking port: receive (addr, prev_ts, old) and
    send (addr, cur_ts, new) on MEM_BUS, and range-check cur_ts - prev_ts - 1
    as a 16-bit low half (RANGE16_BUS) and a high byte (BYTE_BUS). Columns
    from base_col: prev_ts, the two diff parts, then the old value bytes."""
    prev_ts = b.local(base_col)
    b.push_receive(MEM_BUS, [addr, prev_ts] + old_vals, mult)
    b.push_send(MEM_BUS, [addr, cur_ts] + new_vals, mult)
    diff = b.sub(b.sub(cur_ts, prev_ts), b.constant(1))
    recon = b.add(b.local(base_col + 1),
                  b.mul(b.constant(1 << 16), b.local(base_col + 2)))
    b.assert_zero(b.mul(mult, b.sub(diff, recon)))
    b.push_send(RANGE16_BUS, [b.local(base_col + 1)], mult)
    b.push_send(BYTE_BUS, [b.local(base_col + 2)], mult)


def _fill_port(st, row: np.ndarray, base: int, addr: int, cur_ts: int,
               new_val: int = None) -> int:
    """Witness one `_mem_port` of `row` at `base` and advance the shared
    RAM state (range counts: the diff's low half, then its high byte).
    Returns the word's old value; the word keeps it unless new_val is
    given."""
    prev_ts, val = st.ram.get(addr, (0, 0))
    row[base] = prev_ts
    d = cur_ts - prev_ts - 1
    row[base + 1] = st.r16check(d & 0xFFFF)
    row[base + 2] = st.bcheck(d >> 16)
    for k in range(4):
        row[base + 3 + k] = (val >> (8 * k)) & 0xFF
    st.ram[addr] = (cur_ts, val if new_val is None else new_val)
    return val


def _pointer_checks(b: AirBuilder, real, pointers) -> None:
    """Each pointer (lo, hi, q columns) is lo + 256*hi with hi a byte and
    lo = 4*q a word-aligned byte."""
    for _, hi, _ in pointers:
        b.push_send(BYTE_BUS, [b.local(hi)], real)
    for lo, _, q in pointers:
        q4 = b.mul(b.constant(4), b.local(q))
        b.assert_zero(b.mul(real, b.sub(b.local(lo), q4)))
        b.push_send(BYTE_BUS, [q4], real)


def _fill_pointers(st, row: np.ndarray, pointers) -> None:
    """Witness `_pointer_checks` for (value, lo, hi, q columns) pointers
    and count their byte lookups (every hi, then every 4*q)."""
    for ptr, lo, hi, q in pointers:
        assert ptr % 4 == 0 and st.data_base <= ptr < (1 << 16), (
            "syscall buffers must be word-aligned RAM addresses")
        row[lo], row[hi], row[q] = ptr & 0xFF, ptr >> 8, (ptr & 0xFF) >> 2
    for ptr, *_ in pointers:
        st.bcheck(ptr >> 8)
    for ptr, *_ in pointers:
        st.bcheck(4 * ((ptr & 0xFF) >> 2))


def _modulus_limbs(b: AirBuilder, f_m) -> list:
    """The modulus' limbs from the one-hot modulus flags: limb k is
    sum_j M_TABLE[j][k] * f_m[j] (degree 1)."""
    out = []
    for k in range(N_LIMBS):
        acc = None
        for j in range(N_MODULI):
            if M_TABLE[j][k] == 0:
                continue
            t = b.mul(b.constant(M_TABLE[j][k]), f_m[j])
            acc = t if acc is None else b.add(acc, t)
        out.append(acc if acc is not None else b.constant(0))
    return out


def _canonicity_chain(b: AirBuilder, real, r_limbs, m_limbs, d_base: int,
                      bw_base: int) -> None:
    """Constrain r < m in-chip via a byte borrow chain.

    Witnesses d = m - 1 - r limb-wise: for each 8-bit limb k,
        m_k - r_k - c_k + 256*c_{k+1} - d_k = 0,   c_0 = 1,  c_32 = 0,
    with d_k byte-range-checked and borrow bits c boolean. A zero final
    borrow proves m - 1 - r >= 0, i.e. r < m. The openvm analog is the
    modular extension's dedicated IsLessThan comparison; without this,
    BigIntModMulAir's a*b + c == q*m + r identity admits any
    representative r + t*m, letting a malicious prover write a
    non-canonical result to guest RAM."""
    one = b.constant(1)
    c_in = one
    for k in range(N_LIMBS):
        d_k = b.local(d_base + k)
        b.push_send(BYTE_BUS, [d_k], real)
        t = b.sub(b.sub(m_limbs[k], r_limbs[k]), c_in)
        if k < N_LIMBS - 1:
            bw = b.local(bw_base + k)
            b.assert_bool(bw)
            t = b.add(t, b.mul(b.constant(256), bw))
            c_in = bw
        b.assert_zero(b.mul(real, b.sub(t, d_k)))


def _fill_canonicity(st, row: np.ndarray, r_int: int, m: int, d_base: int,
                     bw_base: int) -> None:
    """Witness the r < m borrow chain for one canonical result."""
    assert 0 <= r_int < m, "result must be canonical"
    c = 1
    for k in range(N_LIMBS):
        t = ((m >> (8 * k)) & 0xFF) - ((r_int >> (8 * k)) & 0xFF) - c
        if t < 0:
            assert k < N_LIMBS - 1
            c, t = 1, t + 256
            row[bw_base + k] = 1
        else:
            c = 0
        row[d_base + k] = st.bcheck(t)


# --- ModularVmAir ----------------------------------------------------------
# column layout
IS_REAL = 0
F_MUL, F_ADD, F_SUB = 1, 2, 3
FMOD = 4                    # 6 modulus one-hot flags
REQ_PC = FMOD + N_MODULI    # 10
REQ_TS = REQ_PC + 1
RD0, RD1 = REQ_TS + 1, REQ_TS + 2
X0, X1 = RD1 + 1, RD1 + 2
Y0, Y1 = X1 + 1, X1 + 2
SEL = Y1 + 1
RD_Q, X_Q, Y_Q = SEL + 1, SEL + 2, SEL + 3
XRD = Y_Q + 1               # 8 x [prev_ts, d0, d1, v0..v3] stride 7
YRD = XRD + 7 * N_WORDS
WRP = YRD + 7 * N_WORDS     # 8 x [prev_ts, d0, d1, old0..old3]
RES = WRP + 7 * N_WORDS     # 32 result limbs
CMP_D = RES + N_LIMBS       # 32 limbs of m - 1 - r (canonicity r < m)
CMP_BW = CMP_D + N_LIMBS    # 31 borrow bits
F_DIV = CMP_BW + (N_LIMBS - 1)   # op 3: modular division (openvm ModularDiv)
YINV = F_DIV + 1            # 32 limbs: witnessed y^{-1} (div invertibility)
MOD_NUM_COLS = YINV + N_LIMBS


class ModularVmAir(Air):
    """One 256-bit modular operation (mul/add/sub) per row, delegated to
    BigIntModMulAir. Request: (pc, ts, rd_ptr, x_ptr, y_ptr, sel) with
    sel = op*16 + modulus_index."""

    width = MOD_NUM_COLS
    num_public_values = 0

    def eval(self, b: AirBuilder) -> None:
        one = b.constant(1)
        c256 = b.constant(256)
        real = b.local(IS_REAL)
        b.assert_bool(real)
        f_op = [b.local(F_MUL), b.local(F_ADD), b.local(F_SUB),
                b.local(F_DIV)]
        f_m = [b.local(FMOD + j) for j in range(N_MODULI)]
        for f in f_op + f_m:
            b.assert_bool(f)
        op_sum = b.add(b.add(f_op[0], f_op[1]), b.add(f_op[2], f_op[3]))
        b.assert_eq(op_sum, real)
        m_sum = f_m[0]
        for f in f_m[1:]:
            m_sum = b.add(m_sum, f)
        b.assert_eq(m_sum, real)

        # sel recomposition binds the op/modulus flags to the request
        sel_expr = b.mul(b.constant(16),
                         b.add(b.add(f_op[1], b.mul(b.constant(2),
                                                    f_op[2])),
                               b.mul(b.constant(3), f_op[3])))
        for j in range(N_MODULI):
            if j:
                sel_expr = b.add(sel_expr, b.mul(b.constant(j), f_m[j]))
        b.assert_zero(b.mul(real, b.sub(b.local(SEL), sel_expr)))

        pc, ts = b.local(REQ_PC), b.local(REQ_TS)
        b.push_receive(
            MOD_REQ_BUS,
            [pc, ts, b.local(RD0), b.local(RD1), b.local(X0), b.local(X1),
             b.local(Y0), b.local(Y1), b.local(SEL)],
            real)

        # pointer bytes + word alignment
        _pointer_checks(b, real, ((RD0, RD1, RD_Q), (X0, X1, X_Q), (Y0, Y1, Y_Q)))
        rd_f = b.add(b.local(RD0), b.mul(c256, b.local(RD1)))
        x_f = b.add(b.local(X0), b.mul(c256, b.local(X1)))
        y_f = b.add(b.local(Y0), b.mul(c256, b.local(Y1)))

        ts_base = b.add(ts, b.constant(TS_STRIDE))

        x_limbs, y_limbs = [], []
        for w in range(N_WORDS):
            base = XRD + 7 * w
            vals = [b.local(base + 3 + k) for k in range(4)]
            x_limbs += vals
            _mem_port(b, base, b.add(x_f, b.constant(4 * w)),
                      b.add(ts_base, b.constant(w)), vals, vals, real)
        for w in range(N_WORDS):
            base = YRD + 7 * w
            vals = [b.local(base + 3 + k) for k in range(4)]
            y_limbs += vals
            _mem_port(b, base, b.add(y_f, b.constant(4 * w)),
                      b.add(ts_base, b.constant(N_WORDS + w)), vals, vals,
                      real)
        r_limbs = [b.local(RES + k) for k in range(N_LIMBS)]
        for w in range(N_WORDS):
            base = WRP + 7 * w
            old = [b.local(base + 3 + k) for k in range(4)]
            new = r_limbs[4 * w : 4 * w + 4]
            _mem_port(b, base, b.add(rd_f, b.constant(4 * w)),
                      b.add(ts_base, b.constant(2 * N_WORDS + w)), old, new,
                      real)

        # modulus limbs from the one-hot (degree 2 in the message -> the
        # logUp constraint lands exactly at MAX_DEGREE = 3)
        m_limbs = _modulus_limbs(b, f_m)

        # MODMUL_BUS message (a, b, c, r, m) per op:
        #   mul: (x, y, 0, r, m)        r = x*y       mod m
        #   add: (x, 1, y, r, m)        r = x + y     mod m
        #   sub: (1, y, r, x, m)        r = x - y     mod m  (y + r == x)
        #   div: (r, y, 0, x, m)        r = x / y     mod m  (r*y == x)
        f_mul, f_add, f_sub, f_div = f_op
        mul_or_add = b.add(f_mul, f_add)
        zero = b.constant(0)
        slot_a, slot_b, slot_c, slot_r = [], [], [], []
        for k in range(N_LIMBS):
            d0 = one if k == 0 else zero
            slot_a.append(b.add(b.add(b.mul(mul_or_add, x_limbs[k]),
                                      b.mul(f_sub, d0)),
                                b.mul(f_div, r_limbs[k])))
            slot_b.append(b.add(b.mul(b.add(b.add(f_mul, f_sub), f_div),
                                      y_limbs[k]),
                                b.mul(f_add, d0)))
            slot_c.append(b.add(b.mul(f_add, y_limbs[k]),
                                b.mul(f_sub, r_limbs[k])))
            slot_r.append(b.add(b.mul(mul_or_add, r_limbs[k]),
                                b.mul(b.add(f_sub, f_div), x_limbs[k])))
        b.push_send(MODMUL_BUS, slot_a + slot_b + slot_c + slot_r + m_limbs,
                    real)

        # div soundness: r*y == x alone is satisfied by any r when y == 0
        # (then x must be 0) — require y invertible: y * yinv == 1 mod m
        yinv = [b.local(YINV + k) for k in range(N_LIMBS)]
        one_limbs = [one] + [zero] * (N_LIMBS - 1)
        zeros = [zero] * N_LIMBS
        b.push_send(MODMUL_BUS,
                    y_limbs + yinv + zeros + one_limbs + m_limbs, f_div)

        # the RAM-written result is canonical (r < m): the bigint identity
        # alone only fixes r mod m
        _canonicity_chain(b, real, r_limbs, m_limbs, CMP_D, CMP_BW)

        # execution continuation: the instruction completes here
        b.push_send(
            EXEC_BUS,
            [b.add(pc, b.constant(4)),
             b.add(ts, b.constant(TS_STRIDE + MOD_TS_WINDOW))],
            real)


def fill_modop_row(st, pc: int, ts: int, rd_ptr: int, x_ptr: int,
                   y_ptr: int, sel: int) -> Tuple[np.ndarray, List[Tuple]]:
    """Build the ModularVmAir row for one a7=4 syscall. Updates the shared
    _TraceState (rv32_v2) RAM/byte state. Returns (row, bigint_ops): the
    (a, b, c, m) tuples BigIntModMulAir must serve (two for div)."""
    op, mi = sel >> 4, sel & 15
    assert op in (OP_MUL, OP_ADD, OP_SUB, OP_DIV) and mi < N_MODULI
    m = SUPPORTED_MODULI[mi]
    row = np.zeros(MOD_NUM_COLS, dtype=np.uint32)
    row[IS_REAL] = 1
    row[(F_MUL, F_ADD, F_SUB, F_DIV)[op]] = 1
    row[FMOD + mi] = 1
    row[REQ_PC], row[REQ_TS] = pc, ts
    row[SEL] = sel
    _fill_pointers(st, row, ((rd_ptr, RD0, RD1, RD_Q),
                            (x_ptr, X0, X1, X_Q),
                            (y_ptr, Y0, Y1, Y_Q)))

    ts_base = ts + TS_STRIDE

    x = y = 0
    for w in range(N_WORDS):
        x |= _fill_port(st, row, XRD + 7 * w, x_ptr + 4 * w, ts_base + w) << (32 * w)
    for w in range(N_WORDS):
        y |= _fill_port(st, row, YRD + 7 * w, y_ptr + 4 * w,
                        ts_base + N_WORDS + w) << (32 * w)

    if op == OP_MUL:
        r = x * y % m
        bigint_ops = [(x, y, 0, m)]
    elif op == OP_ADD:
        r = (x + y) % m
        bigint_ops = [(x, 1, y, m)]
    elif op == OP_SUB:
        r = (x - y) % m
        bigint_ops = [(1, y, r, m)]
    else:  # OP_DIV: r = x / y, with the y*yinv == 1 invertibility request
        assert y % m != 0, "modular division by zero"
        yinv = pow(y % m, -1, m)
        r = x * yinv % m
        row[YINV : YINV + N_LIMBS] = _limbs(yinv)
        bigint_ops = [(r, y, 0, m), (y, yinv, 0, m)]
    row[RES : RES + N_LIMBS] = _limbs(r)
    _fill_canonicity(st, row, r, m, CMP_D, CMP_BW)

    for w in range(N_WORDS):
        _fill_port(st, row, WRP + 7 * w, rd_ptr + 4 * w, ts_base + 2 * N_WORDS + w,
                   (r >> (32 * w)) & 0xFFFFFFFF)
    return row, bigint_ops


# --- EcVmAir ---------------------------------------------------------------
E_IS_REAL = 0
E_FMOD = 1                      # 6 modulus one-hot flags
E_REQ_PC = E_FMOD + N_MODULI    # 7
E_REQ_TS = E_REQ_PC + 1
E_RD0, E_RD1 = E_REQ_TS + 1, E_REQ_TS + 2
E_P0, E_P1 = E_RD1 + 1, E_RD1 + 2
E_Q0, E_Q1 = E_P1 + 1, E_P1 + 2
E_SEL = E_Q1 + 1
E_RD_Q, E_P_Q, E_Q_Q = E_SEL + 1, E_SEL + 2, E_SEL + 3
E_PRD = E_Q_Q + 1               # 16 x [prev_ts, d0, d1, v0..v3] (x1||y1)
E_QRD = E_PRD + 7 * 2 * N_WORDS
E_WRP = E_QRD + 7 * 2 * N_WORDS
E_RES = E_WRP + 7 * 2 * N_WORDS  # 64 result limbs (x3||y3)
E_CMP_D = E_RES + 2 * N_LIMBS    # 2 x 32 limbs m-1-x3, m-1-y3
E_CMP_BW = E_CMP_D + 2 * N_LIMBS  # 2 x 31 borrow bits
EC_NUM_COLS = E_CMP_BW + 2 * (N_LIMBS - 1)


class EcVmAir(Air):
    """One affine EC point addition per row, delegated to EcAddAir (which
    delegates to BigIntModMulAir). Request: (pc, ts, rd_ptr, p_ptr, q_ptr,
    sel) with sel = base-field modulus index. Distinct-x adds only."""

    width = EC_NUM_COLS
    num_public_values = 0

    def eval(self, b: AirBuilder) -> None:
        b.constant(1)  # the first node, as in the reference's serialization
        c256 = b.constant(256)
        real = b.local(E_IS_REAL)
        b.assert_bool(real)
        f_m = [b.local(E_FMOD + j) for j in range(N_MODULI)]
        for f in f_m:
            b.assert_bool(f)
        m_sum = f_m[0]
        for f in f_m[1:]:
            m_sum = b.add(m_sum, f)
        b.assert_eq(m_sum, real)
        sel_expr = None
        for j in range(1, N_MODULI):
            t = b.mul(b.constant(j), f_m[j])
            sel_expr = t if sel_expr is None else b.add(sel_expr, t)
        b.assert_zero(b.mul(real, b.sub(b.local(E_SEL), sel_expr)))

        pc, ts = b.local(E_REQ_PC), b.local(E_REQ_TS)
        b.push_receive(
            EC_REQ_BUS,
            [pc, ts, b.local(E_RD0), b.local(E_RD1), b.local(E_P0),
             b.local(E_P1), b.local(E_Q0), b.local(E_Q1), b.local(E_SEL)],
            real)

        _pointer_checks(b, real, ((E_RD0, E_RD1, E_RD_Q), (E_P0, E_P1, E_P_Q),
                                  (E_Q0, E_Q1, E_Q_Q)))
        rd_f = b.add(b.local(E_RD0), b.mul(c256, b.local(E_RD1)))
        p_f = b.add(b.local(E_P0), b.mul(c256, b.local(E_P1)))
        q_f = b.add(b.local(E_Q0), b.mul(c256, b.local(E_Q1)))

        ts_base = b.add(ts, b.constant(TS_STRIDE))

        p_limbs, q_limbs = [], []
        for w in range(2 * N_WORDS):
            base = E_PRD + 7 * w
            vals = [b.local(base + 3 + k) for k in range(4)]
            p_limbs += vals
            _mem_port(b, base, b.add(p_f, b.constant(4 * w)),
                      b.add(ts_base, b.constant(w)), vals, vals, real)
        for w in range(2 * N_WORDS):
            base = E_QRD + 7 * w
            vals = [b.local(base + 3 + k) for k in range(4)]
            q_limbs += vals
            _mem_port(b, base, b.add(q_f, b.constant(4 * w)),
                      b.add(ts_base, b.constant(2 * N_WORDS + w)), vals,
                      vals, real)
        r_limbs = [b.local(E_RES + k) for k in range(2 * N_LIMBS)]
        for w in range(2 * N_WORDS):
            base = E_WRP + 7 * w
            old = [b.local(base + 3 + k) for k in range(4)]
            new = r_limbs[4 * w : 4 * w + 4]
            _mem_port(b, base, b.add(rd_f, b.constant(4 * w)),
                      b.add(ts_base, b.constant(4 * N_WORDS + w)), old, new,
                      real)

        m_limbs = _modulus_limbs(b, f_m)

        # (x1, y1, x2, y2, x3, y3, m) -> EcAddAir
        msg = (p_limbs + q_limbs + r_limbs + m_limbs)
        b.push_send(EC_ADD_BUS, msg, real)

        # the RAM-written coordinates are canonical (x3, y3 < m): the
        # chord-law congruences alone only fix them mod m
        _canonicity_chain(b, real, r_limbs[:N_LIMBS], m_limbs,
                          E_CMP_D, E_CMP_BW)
        _canonicity_chain(b, real, r_limbs[N_LIMBS:], m_limbs,
                          E_CMP_D + N_LIMBS, E_CMP_BW + (N_LIMBS - 1))

        b.push_send(
            EXEC_BUS,
            [b.add(pc, b.constant(4)),
             b.add(ts, b.constant(TS_STRIDE + EC_TS_WINDOW))],
            real)


def fill_ec_row(st, pc: int, ts: int, rd_ptr: int, p_ptr: int,
                q_ptr: int, sel: int) -> Tuple[np.ndarray, Tuple]:
    """Build the EcVmAir row for one a7=5 syscall. Returns (row, ec_add)
    where ec_add is the ((x1,y1), (x2,y2), m) tuple EcAddAir must serve."""
    assert sel < N_MODULI
    m = SUPPORTED_MODULI[sel]
    row = np.zeros(EC_NUM_COLS, dtype=np.uint32)
    row[E_IS_REAL] = 1
    row[E_FMOD + sel] = 1
    row[E_REQ_PC], row[E_REQ_TS] = pc, ts
    row[E_SEL] = sel
    _fill_pointers(st, row, ((rd_ptr, E_RD0, E_RD1, E_RD_Q),
                            (p_ptr, E_P0, E_P1, E_P_Q),
                            (q_ptr, E_Q0, E_Q1, E_Q_Q)))

    ts_base = ts + TS_STRIDE

    pv = qv = 0
    for w in range(2 * N_WORDS):
        pv |= _fill_port(st, row, E_PRD + 7 * w, p_ptr + 4 * w, ts_base + w) << (32 * w)
    for w in range(2 * N_WORDS):
        qv |= _fill_port(st, row, E_QRD + 7 * w, q_ptr + 4 * w,
                         ts_base + 2 * N_WORDS + w) << (32 * w)
    x1, y1 = pv & ((1 << 256) - 1), pv >> 256
    x2, y2 = qv & ((1 << 256) - 1), qv >> 256
    assert x1 % m != x2 % m, "distinct-x adds only (no doubling)"
    lam = (y2 - y1) * pow((x2 - x1) % m, -1, m) % m
    x3 = (lam * lam - x1 - x2) % m
    y3 = (lam * (x1 - x3) - y1) % m
    res = x3 | (y3 << 256)
    for k in range(2 * N_LIMBS):
        row[E_RES + k] = (res >> (8 * k)) & 0xFF
    _fill_canonicity(st, row, x3, m, E_CMP_D, E_CMP_BW)
    _fill_canonicity(st, row, y3, m, E_CMP_D + N_LIMBS,
                     E_CMP_BW + (N_LIMBS - 1))

    for w in range(2 * N_WORDS):
        _fill_port(st, row, E_WRP + 7 * w, rd_ptr + 4 * w, ts_base + 4 * N_WORDS + w,
                   (res >> (32 * w)) & 0xFFFFFFFF)
    return row, ((x1, y1), (x2, y2), m)


# --- EcDoubleVmAir ---------------------------------------------------------
# One affine point doubling per row (ECALL a7=7), delegated to EcDoubleAir.
# P-256 (modulus idx 4) is rejected: the tangent chip implements the a = 0
# law and P-256 has a = -3 (see models/ec_double.py).
D_IS_REAL = 0
D_FMOD = 1                      # 6 modulus one-hot flags
D_REQ_PC = D_FMOD + N_MODULI    # 7
D_REQ_TS = D_REQ_PC + 1
D_RD0, D_RD1 = D_REQ_TS + 1, D_REQ_TS + 2
D_P0, D_P1 = D_RD1 + 1, D_RD1 + 2
D_SEL = D_P1 + 1
D_RD_Q, D_P_Q = D_SEL + 1, D_SEL + 2
D_PRD = D_P_Q + 1               # 16 x [prev_ts, d0, d1, v0..v3] (x1||y1)
D_WRP = D_PRD + 7 * 2 * N_WORDS
D_RES = D_WRP + 7 * 2 * N_WORDS  # 64 result limbs (x3||y3)
D_CMP_D = D_RES + 2 * N_LIMBS    # 2 x 32 limbs m-1-x3, m-1-y3
D_CMP_BW = D_CMP_D + 2 * N_LIMBS  # 2 x 31 borrow bits
DBL_NUM_COLS = D_CMP_BW + 2 * (N_LIMBS - 1)
DBL_TS_WINDOW = 40               # 16 reads + 16 writes + margin


class EcDoubleVmAir(Air):
    """One affine EC point doubling per row, delegated to EcDoubleAir
    (which delegates to BigIntModMulAir). Request: (pc, ts, rd_ptr,
    p_ptr, sel) with sel = base-field modulus index (a = 0 curves only).
    """

    width = DBL_NUM_COLS
    num_public_values = 0

    def eval(self, b: AirBuilder) -> None:
        b.constant(1)  # the first node, as in the reference's serialization
        c256 = b.constant(256)
        real = b.local(D_IS_REAL)
        b.assert_bool(real)
        f_m = [b.local(D_FMOD + j) for j in range(N_MODULI)]
        for f in f_m:
            b.assert_bool(f)
        m_sum = f_m[0]
        for f in f_m[1:]:
            m_sum = b.add(m_sum, f)
        b.assert_eq(m_sum, real)
        # P-256 base field (idx 4) has a != 0: the tangent law is unsound
        b.assert_zero(f_m[4])
        sel_expr = None
        for j in range(1, N_MODULI):
            t = b.mul(b.constant(j), f_m[j])
            sel_expr = t if sel_expr is None else b.add(sel_expr, t)
        b.assert_zero(b.mul(real, b.sub(b.local(D_SEL), sel_expr)))

        pc, ts = b.local(D_REQ_PC), b.local(D_REQ_TS)
        b.push_receive(
            EC_DBL_REQ_BUS,
            [pc, ts, b.local(D_RD0), b.local(D_RD1), b.local(D_P0),
             b.local(D_P1), b.local(D_SEL)],
            real)

        _pointer_checks(b, real, ((D_RD0, D_RD1, D_RD_Q), (D_P0, D_P1, D_P_Q)))
        rd_f = b.add(b.local(D_RD0), b.mul(c256, b.local(D_RD1)))
        p_f = b.add(b.local(D_P0), b.mul(c256, b.local(D_P1)))

        ts_base = b.add(ts, b.constant(TS_STRIDE))

        p_limbs = []
        for w in range(2 * N_WORDS):
            base = D_PRD + 7 * w
            vals = [b.local(base + 3 + k) for k in range(4)]
            p_limbs += vals
            _mem_port(b, base, b.add(p_f, b.constant(4 * w)),
                      b.add(ts_base, b.constant(w)), vals, vals, real)
        r_limbs = [b.local(D_RES + k) for k in range(2 * N_LIMBS)]
        for w in range(2 * N_WORDS):
            base = D_WRP + 7 * w
            old = [b.local(base + 3 + k) for k in range(4)]
            new = r_limbs[4 * w : 4 * w + 4]
            _mem_port(b, base, b.add(rd_f, b.constant(4 * w)),
                      b.add(ts_base, b.constant(2 * N_WORDS + w)), old, new,
                      real)

        m_limbs = _modulus_limbs(b, f_m)

        # (x1, y1, x3, y3, m) -> EcDoubleAir
        b.push_send(EC_DBL_BUS, p_limbs + r_limbs + m_limbs, real)

        # the RAM-written coordinates are canonical (x3, y3 < m)
        _canonicity_chain(b, real, r_limbs[:N_LIMBS], m_limbs,
                          D_CMP_D, D_CMP_BW)
        _canonicity_chain(b, real, r_limbs[N_LIMBS:], m_limbs,
                          D_CMP_D + N_LIMBS, D_CMP_BW + (N_LIMBS - 1))

        b.push_send(
            EXEC_BUS,
            [b.add(pc, b.constant(4)),
             b.add(ts, b.constant(TS_STRIDE + DBL_TS_WINDOW))],
            real)


def fill_ec_double_row(st, pc: int, ts: int, rd_ptr: int, p_ptr: int,
                       sel: int) -> Tuple[np.ndarray, Tuple]:
    """Build the EcDoubleVmAir row for one a7=7 syscall. Returns
    (row, double) where double is the ((x1, y1), m) tuple EcDoubleAir
    must serve."""
    assert sel < N_MODULI and sel != 4, "P-256 doubling unsupported (a != 0)"
    m = SUPPORTED_MODULI[sel]
    row = np.zeros(DBL_NUM_COLS, dtype=np.uint32)
    row[D_IS_REAL] = 1
    row[D_FMOD + sel] = 1
    row[D_REQ_PC], row[D_REQ_TS] = pc, ts
    row[D_SEL] = sel
    _fill_pointers(st, row, ((rd_ptr, D_RD0, D_RD1, D_RD_Q), (p_ptr, D_P0, D_P1, D_P_Q)))

    ts_base = ts + TS_STRIDE

    pv = 0
    for w in range(2 * N_WORDS):
        pv |= _fill_port(st, row, D_PRD + 7 * w, p_ptr + 4 * w, ts_base + w) << (32 * w)
    x1, y1 = pv & ((1 << 256) - 1), pv >> 256
    assert y1 % m != 0, "doubling an order-2 point (y == 0)"
    lam = 3 * x1 * x1 * pow(2 * y1, -1, m) % m
    x3 = (lam * lam - 2 * x1) % m
    y3 = (lam * (x1 - x3) - y1) % m
    res = x3 | (y3 << 256)
    for k in range(2 * N_LIMBS):
        row[D_RES + k] = (res >> (8 * k)) & 0xFF
    _fill_canonicity(st, row, x3, m, D_CMP_D, D_CMP_BW)
    _fill_canonicity(st, row, y3, m, D_CMP_D + N_LIMBS,
                     D_CMP_BW + (N_LIMBS - 1))

    for w in range(2 * N_WORDS):
        _fill_port(st, row, D_WRP + 7 * w, rd_ptr + 4 * w, ts_base + 2 * N_WORDS + w,
                   (res >> (32 * w)) & 0xFFFFFFFF)
    return row, ((x1, y1), m)
