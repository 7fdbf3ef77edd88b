"""RV32 proving chipset v2: the full RV32IM instruction set as a multi-chip
machine (the openvm-style chip decomposition). The port's copy of the
reference's `zkvm_prover_tpu/models/rv32_v2.py`: the same AIRs, trace
generation and constants; it reaches the field only through `bb.P`.

Architecture (all glued by logUp buses, like openvm interactions):

  AluAir        ADD/SUB/ADDI, AND/OR/XOR (+imm), SLT/SLTU (+imm)
  ShiftAir      SLL/SRL/SRA (+imm)
  BranchAir     BEQ/BNE/BLT/BGE/BLTU/BGEU
  JumpAir       JAL/JALR/LUI/AUIPC
  LoadStoreAir  LB/LH/LW/LBU/LHU/SB/SH/SW (byte-granular over word RAM)
  MulAir        MUL/MULH/MULHSU/MULHU
  DivRemAir     DIV/DIVU/REM/REMU (magnitude identity; RISC-V edge cases)
  ProgramAirV2  preprocessed decoded ROM (pc, kind, regs, imm, target)
  ExecBoundaryAirV2 / RamBoundaryAirV2 / MemoryBoundaryAir / ByteTableAir
  XorTableAir   the 256x256 byte-XOR table (AND/OR derived: x+y = x^y + 2(x&y))

Control flow uses the execution bus exactly as rv32_v1: every row receives
(pc, ts) and sends (next_pc, ts+TS_STRIDE); ExecBoundary opens at (0,1) and
closes at the witnessed final state; strictly increasing timestamps make the
chain acyclic, so the logUp balance proves one connected execution path even
though rows are distributed across seven CPU chips.

Register/RAM consistency is offline memory checking over REG_BUS / MEM_BUS
with 24-bit range-checked timestamp diffs — low 16 bits through the
Range16TableAir table, high byte through the byte table (segment cap
~2^24/TS_STRIDE
cycles). Comparisons use a borrow-chain less-than with the sign-flip trick
(x <s y  <=>  x^0x80000000 <u y^0x80000000) so one chain serves signed and
unsigned. All constraints are degree <= 3 (air.MAX_DEGREE).

ECALL rows are proven by SystemAir. Syscall families (a7): 0 HALT,
1 HINT_READ, 2 REVEAL, 3 KECCAK256, 4 MODOP (mul/add/sub/div), 5 EC_ADD,
6 SHA256, 7 EC_DOUBLE, 8 DEFER, 9 FP2. REVEAL rows bind words into
PublicValuesAir via PV_BUS (per-word reveal flags, partial reveals
sound); the extension syscalls hand off over dedicated request buses to
their chips (keccak_vm / sha256_vm / vm_ext / ec_double / fp2_vm /
deferral_vm — the openvm VM-extension analogs), which own the rest of
the instruction's timestamp window and send the continuation.

v2 limitations (ROADMAP Phase 4): rd != x0 for writes; RAM initially zero
at touched addresses above the program image; keccak buffers word-aligned
below 2^16.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..fields import babybear as bb
from ..vm.executor import Rv32Executor
from .air import Air, AirBuilder
from .rv32_v0 import BYTE_BUS, REG_BUS, ByteTableAir, MemoryBoundaryAir

N_LIMBS = 4
LIMB = 256

PROGRAM_BUS = 24
EXEC_BUS = 25
MEM_BUS = 26
XOR_BUS = 27
PV_BUS = 28
KECCAK_REQ_BUS = 42   # SystemAir keccak syscall -> KeccakVmAir handoff
MOD_REQ_BUS = 46      # SystemAir modop syscall -> ModularVmAir handoff
EC_REQ_BUS = 47       # SystemAir ec_add syscall -> EcVmAir handoff
SHA_REQ_BUS = 48      # SystemAir sha256 syscall -> Sha256VmAir handoff
EC_DBL_REQ_BUS = 50   # SystemAir ec_double syscall -> EcDoubleVmAir handoff
RANGE16_BUS = 51      # 16-bit range table (ts-diff low halves)
DEFER_REQ_BUS = 52    # SystemAir defer syscall -> DeferralVmAir handoff
FP2_REQ_BUS = 53      # SystemAir fp2 syscall -> Fp2VmAir handoff

N_PV_WORDS = 8  # 32-byte PI hash as 8 u32 words (reference NUM_PUBLIC_VALUES
#                 = 32 bytes, crates/types/base/src/aggregation.rs)

TS_STRIDE = 5  # ports: rs1@ts, rs2@ts+1, rd@ts+2, mem@ts+3

# ---------------------------------------------------------------------------
# instruction kinds (global IDs; bus id = kind + 1 so 0 = "no instruction")
# ---------------------------------------------------------------------------
(
    K_ADD, K_SUB, K_ADDI, K_AND, K_ANDI, K_OR, K_ORI, K_XOR, K_XORI,
    K_SLT, K_SLTI, K_SLTU, K_SLTIU,
    K_SLL, K_SLLI, K_SRL, K_SRLI, K_SRA, K_SRAI,
    K_BEQ, K_BNE, K_BLT, K_BGE, K_BLTU, K_BGEU,
    K_JAL, K_JALR, K_LUI, K_AUIPC,
    K_LB, K_LH, K_LW, K_LBU, K_LHU, K_SB, K_SH, K_SW,
    K_MUL, K_MULH, K_MULHSU, K_MULHU, K_DIV, K_DIVU, K_REM, K_REMU,
    K_ECALL,
) = range(46)


def _limbs(v: int) -> List[int]:
    return [(v >> (8 * k)) & 0xFF for k in range(N_LIMBS)]


def decode_v2(instr: int) -> Tuple[int, int, int, int, int, int]:
    """-> (kind, rs1, rs2, rd, imm32, branch_offset) or raises.

    For shifts, imm is the 5-bit shamt; for LUI/AUIPC the full 32-bit
    upper-immediate value; otherwise the sign-extended immediate mod 2^32.
    """
    opcode = instr & 0x7F
    rd = (instr >> 7) & 0x1F
    funct3 = (instr >> 12) & 0x7
    rs1 = (instr >> 15) & 0x1F
    rs2 = (instr >> 20) & 0x1F
    funct7 = (instr >> 25) & 0x7F

    def sext12(v):
        return (v - 0x1000 if v >= 0x800 else v) % (1 << 32)

    if opcode == 0x13:  # OP-IMM
        imm = sext12(instr >> 20)
        shamt = (instr >> 20) & 0x1F
        table = {0: K_ADDI, 2: K_SLTI, 3: K_SLTIU, 4: K_XORI,
                 6: K_ORI, 7: K_ANDI}
        if funct3 in table:
            return (table[funct3], rs1, 0, rd, imm, 0)
        if funct3 == 1 and funct7 == 0:
            return (K_SLLI, rs1, 0, rd, shamt, 0)
        if funct3 == 5:
            return (K_SRAI if (funct7 & 0x20) else K_SRLI, rs1, 0, rd,
                    shamt, 0)
    if opcode == 0x33:  # OP
        if funct7 == 1:
            m = [K_MUL, K_MULH, K_MULHSU, K_MULHU,
                 K_DIV, K_DIVU, K_REM, K_REMU][funct3]
            return (m, rs1, rs2, rd, 0, 0)
        if funct7 == 0:
            t = {0: K_ADD, 1: K_SLL, 2: K_SLT, 3: K_SLTU, 4: K_XOR,
                 5: K_SRL, 6: K_OR, 7: K_AND}
            return (t[funct3], rs1, rs2, rd, 0, 0)
        if funct7 == 0x20 and funct3 == 0:
            return (K_SUB, rs1, rs2, rd, 0, 0)
        if funct7 == 0x20 and funct3 == 5:
            return (K_SRA, rs1, rs2, rd, 0, 0)
    if opcode == 0x63:  # branches
        imm = (((instr >> 31) << 12) | (((instr >> 7) & 1) << 11)
               | (((instr >> 25) & 0x3F) << 5) | (((instr >> 8) & 0xF) << 1))
        if imm >= 1 << 12:
            imm -= 1 << 13
        t = {0: K_BEQ, 1: K_BNE, 4: K_BLT, 5: K_BGE, 6: K_BLTU, 7: K_BGEU}
        if funct3 in t:
            return (t[funct3], rs1, rs2, 0, 0, imm)
    if opcode == 0x6F:  # JAL
        imm = (((instr >> 31) << 20) | (((instr >> 12) & 0xFF) << 12)
               | (((instr >> 20) & 1) << 11) | (((instr >> 21) & 0x3FF) << 1))
        if imm >= 1 << 20:
            imm -= 1 << 21
        return (K_JAL, 0, 0, rd, 0, imm)
    if opcode == 0x67 and funct3 == 0:  # JALR
        return (K_JALR, rs1, 0, rd, sext12(instr >> 20), 0)
    if opcode == 0x37:  # LUI
        return (K_LUI, 0, 0, rd, instr & 0xFFFFF000, 0)
    if opcode == 0x17:  # AUIPC
        return (K_AUIPC, 0, 0, rd, instr & 0xFFFFF000, 0)
    if opcode == 0x03:  # loads
        t = {0: K_LB, 1: K_LH, 2: K_LW, 4: K_LBU, 5: K_LHU}
        if funct3 in t:
            return (t[funct3], rs1, 0, rd, sext12(instr >> 20), 0)
    if opcode == 0x23:  # stores
        imm = sext12(((instr >> 25) << 5) | ((instr >> 7) & 0x1F))
        t = {0: K_SB, 1: K_SH, 2: K_SW}
        if funct3 in t:
            return (t[funct3], rs1, rs2, 0, imm, 0)
    if instr == 0x00000073:  # ECALL (syscall variant chosen by a7 at runtime)
        return (K_ECALL, 0, 0, 0, 0, 0)
    raise ValueError(f"instruction 0x{instr:08x} not in rv32im")


# ---------------------------------------------------------------------------
# common column block (identical prefix across all CPU chips)
# ---------------------------------------------------------------------------
IS_REAL = 0
PC, TS = 1, 2
RS1_IDX, RS2_IDX, RD_IDX = 3, 4, 5
IMM = 6            # 4 limbs
TARGET = 10
RS1_VAL = 11       # 4
RS2_VAL = 15       # 4
RD_VAL = 19        # 4
RD_PREV_VAL = 23   # 4
RS1_PREV_TS, RS2_PREV_TS, RD_PREV_TS = 27, 28, 29
DIFF = 30          # 3 ports x 2 bytes
FLAGS = 36
COMMON_WIDTH = 36


def emit_common(b: AirBuilder, kinds, flags, *, rs1_mult, rs2_mult, rd_mult,
                next_pc_expr, check_rd_bytes=True):
    """Flags/ports/ROM/exec-bus logic shared by every CPU chip.

    kinds: global kind ids (same order as flags). A port mult of None means
    the chip never uses that port (no interactions emitted).
    """
    one = b.constant(1)
    real = b.local(IS_REAL)
    pc = b.local(PC)
    ts = b.local(TS)

    b.assert_bool(real)
    acc = None
    for f in flags:
        b.assert_bool(f)
        acc = f if acc is None else b.add(acc, f)
    b.assert_eq(acc, real)

    # program ROM lookup: kid = sum f_j * (kind_j + 1)
    kid = None
    for f, k in zip(flags, kinds):
        term = b.mul(f, b.constant(k + 1))
        kid = term if kid is None else b.add(kid, term)
    b.push_send(
        PROGRAM_BUS,
        [pc, kid, b.local(RS1_IDX), b.local(RS2_IDX), b.local(RD_IDX)]
        + [b.local(IMM + k) for k in range(N_LIMBS)] + [b.local(TARGET)],
        real,
    )

    # execution bus
    b.push_receive(EXEC_BUS, [pc, ts], real)
    b.push_send(EXEC_BUS, [next_pc_expr, b.add(ts, b.constant(TS_STRIDE))],
                real)

    # register ports (offline memory checking) + ts strict ordering
    c256 = b.constant(LIMB)
    ports = [
        (rs1_mult, RS1_IDX, RS1_PREV_TS, ts, 0,
         [b.local(RS1_VAL + k) for k in range(N_LIMBS)], None),
        (rs2_mult, RS2_IDX, RS2_PREV_TS, b.add(ts, one), 2,
         [b.local(RS2_VAL + k) for k in range(N_LIMBS)], None),
        (rd_mult, RD_IDX, RD_PREV_TS, b.add(ts, b.constant(2)), 4,
         [b.local(RD_VAL + k) for k in range(N_LIMBS)],
         [b.local(RD_PREV_VAL + k) for k in range(N_LIMBS)]),
    ]
    for mult, idx_c, prev_c, cur_ts, dk, vals, prev_vals in ports:
        if mult is None:
            continue
        recv_vals = prev_vals if prev_vals is not None else vals
        b.push_receive(REG_BUS, [b.local(idx_c), b.local(prev_c)] + recv_vals,
                       mult)
        b.push_send(REG_BUS, [b.local(idx_c), cur_ts] + vals, mult)
        diff = b.sub(b.sub(cur_ts, b.local(prev_c)), one)
        recon = b.add(b.local(DIFF + dk),
                      b.mul(b.constant(1 << 16), b.local(DIFF + dk + 1)))
        b.assert_zero(b.mul(mult, b.sub(diff, recon)))
        b.push_send(RANGE16_BUS, [b.local(DIFF + dk)], mult)
        b.push_send(BYTE_BUS, [b.local(DIFF + dk + 1)], mult)

    if rd_mult is not None and check_rd_bytes:
        for k in range(N_LIMBS):
            b.push_send(BYTE_BUS, [b.local(RD_VAL + k)], rd_mult)


def emit_sign_decomp(b, val3_expr, sign_col, rest_col, gate):
    """val3 = 128*sign + rest with rest < 128, gated. Returns nothing; the
    caller byte-checks 2*rest with mult=gate."""
    b.assert_bool(b.local(sign_col))
    b.assert_zero(b.mul(gate, b.sub(
        val3_expr,
        b.add(b.mul(b.constant(128), b.local(sign_col)), b.local(rest_col)),
    )))
    b.push_send(BYTE_BUS, [b.mul(b.constant(2), b.local(rest_col))], gate)


def emit_cmp_chain(b, lhs, rhs, d_col, bor_col, gate):
    """Borrow chain lhs - rhs limb-wise, gated; final borrow = (lhs <u rhs).
    lhs/rhs: lists of 4 limb expressions (degree <= 2). d limbs byte-checked
    by the caller. Returns the final-borrow expression."""
    c256 = b.constant(LIMB)
    prev = None
    for k in range(N_LIMBS):
        cur = b.local(bor_col + k)
        b.assert_bool(cur)
        e = b.sub(lhs[k], rhs[k])
        if prev is not None:
            e = b.sub(e, prev)
        e = b.add(b.sub(e, b.local(d_col + k)), b.mul(c256, cur))
        b.assert_zero(b.mul(gate, e))
        b.push_send(BYTE_BUS, [b.local(d_col + k)], gate)
        prev = cur
    return b.local(bor_col + N_LIMBS - 1)


# ---------------------------------------------------------------------------
# AluAir
# ---------------------------------------------------------------------------
ALU_KINDS = (K_ADD, K_SUB, K_ADDI, K_AND, K_ANDI, K_OR, K_ORI, K_XOR,
             K_XORI, K_SLT, K_SLTI, K_SLTU, K_SLTIU)


class AluAir(Air):
    N_FLAGS = len(ALU_KINDS)
    CARRY = FLAGS + N_FLAGS        # 4
    CMP_D = CARRY + 4              # 4
    CMP_B = CMP_D + 4              # 4
    SA = CMP_B + 4
    A3R = SA + 1
    SB = A3R + 1
    B3R = SB + 1
    X = B3R + 1                    # 4 (xor witness limbs)
    width = X + 4
    num_public_values = 0

    def eval(self, b: AirBuilder) -> None:
        C = AluAir
        f = {k: b.local(FLAGS + j) for j, k in enumerate(ALU_KINDS)}
        use_imm = b.add(b.add(f[K_ADDI], b.add(f[K_ANDI], f[K_ORI])),
                        b.add(f[K_XORI], b.add(f[K_SLTI], f[K_SLTIU])))
        use_reg = b.add(b.add(f[K_ADD], b.add(f[K_SUB], f[K_AND])),
                        b.add(b.add(f[K_OR], f[K_XOR]),
                              b.add(f[K_SLT], f[K_SLTU])))
        emit_common(b, ALU_KINDS, [f[k] for k in ALU_KINDS],
                    rs1_mult=b.local(IS_REAL), rs2_mult=use_reg,
                    rd_mult=b.local(IS_REAL),
                    next_pc_expr=b.add(b.local(PC), b.constant(4)))

        a = [b.local(RS1_VAL + k) for k in range(N_LIMBS)]
        ob = [b.add(b.mul(use_imm, b.local(IMM + k)),
                    b.mul(use_reg, b.local(RS2_VAL + k)))
              for k in range(N_LIMBS)]
        rd = [b.local(RD_VAL + k) for k in range(N_LIMBS)]
        c256 = b.constant(LIMB)

        # add/sub carry chains (shared CARRY columns)
        f_addlike = b.add(f[K_ADD], f[K_ADDI])
        prev = None
        for k in range(N_LIMBS):
            cur = b.local(C.CARRY + k)
            b.assert_bool(cur)
            lhs_add = b.add(a[k], ob[k])
            lhs_sub = b.sub(a[k], ob[k])
            if prev is not None:
                lhs_add = b.add(lhs_add, prev)
                lhs_sub = b.sub(lhs_sub, prev)
            e_add = b.sub(b.sub(lhs_add, rd[k]), b.mul(c256, cur))
            e_sub = b.add(b.sub(lhs_sub, rd[k]), b.mul(c256, cur))
            b.assert_zero(b.add(b.mul(f_addlike, e_add),
                                b.mul(f[K_SUB], e_sub)))
            prev = cur

        # bitwise via the XOR table
        f_bw = b.add(b.add(f[K_AND], f[K_ANDI]),
                     b.add(b.add(f[K_OR], f[K_ORI]),
                           b.add(f[K_XOR], f[K_XORI])))
        f_and = b.add(f[K_AND], f[K_ANDI])
        f_or = b.add(f[K_OR], f[K_ORI])
        f_xor = b.add(f[K_XOR], f[K_XORI])
        two = b.constant(2)
        for k in range(N_LIMBS):
            x = b.local(C.X + k)
            b.push_send(XOR_BUS, [a[k], ob[k], x], f_bw)
            b.assert_zero(b.mul(
                f_and, b.sub(b.mul(two, rd[k]),
                             b.sub(b.add(a[k], ob[k]), x))))
            b.assert_zero(b.mul(
                f_or, b.sub(b.mul(two, rd[k]),
                            b.add(b.add(a[k], ob[k]), x))))
            b.assert_zero(b.mul(f_xor, b.sub(rd[k], x)))

        # comparisons (SLT family): borrow chain with sign-flip top limbs
        f_cmp = b.add(b.add(f[K_SLT], f[K_SLTI]),
                      b.add(f[K_SLTU], f[K_SLTIU]))
        f_sgn = b.add(f[K_SLT], f[K_SLTI])
        emit_sign_decomp(b, a[3], C.SA, C.A3R, f_sgn)
        emit_sign_decomp(b, ob[3], C.SB, C.B3R, f_sgn)
        flip_a = b.mul(f_sgn, b.sub(b.constant(128),
                                    b.mul(c256, b.local(C.SA))))
        flip_b = b.mul(f_sgn, b.sub(b.constant(128),
                                    b.mul(c256, b.local(C.SB))))
        lhs = [a[0], a[1], a[2], b.add(a[3], flip_a)]
        rhs = [ob[0], ob[1], ob[2], b.add(ob[3], flip_b)]
        lt = emit_cmp_chain(b, lhs, rhs, C.CMP_D, C.CMP_B, f_cmp)
        b.assert_zero(b.mul(f_cmp, b.sub(rd[0], lt)))
        for k in range(1, N_LIMBS):
            b.assert_zero(b.mul(f_cmp, rd[k]))


# ---------------------------------------------------------------------------
# BranchAir
# ---------------------------------------------------------------------------
BRANCH_KINDS = (K_BEQ, K_BNE, K_BLT, K_BGE, K_BLTU, K_BGEU)


class BranchAir(Air):
    N_FLAGS = len(BRANCH_KINDS)
    IS_EQ = FLAGS + N_FLAGS
    S_INV = IS_EQ + 1
    IS_TAKEN = S_INV + 1
    NEXT_PC = IS_TAKEN + 1
    CMP_D = NEXT_PC + 1          # 4
    CMP_B = CMP_D + 4            # 4
    SA = CMP_B + 4
    A3R = SA + 1
    SB = A3R + 1
    B3R = SB + 1
    width = B3R + 1
    num_public_values = 0

    def eval(self, b: AirBuilder) -> None:
        C = BranchAir
        one = b.constant(1)
        f = {k: b.local(FLAGS + j) for j, k in enumerate(BRANCH_KINDS)}
        emit_common(b, BRANCH_KINDS, [f[k] for k in BRANCH_KINDS],
                    rs1_mult=b.local(IS_REAL), rs2_mult=b.local(IS_REAL),
                    rd_mult=None, next_pc_expr=b.local(C.NEXT_PC))

        a = [b.local(RS1_VAL + k) for k in range(N_LIMBS)]
        v2 = [b.local(RS2_VAL + k) for k in range(N_LIMBS)]
        is_eq = b.local(C.IS_EQ)
        s_inv = b.local(C.S_INV)
        b.assert_bool(is_eq)

        # equality witness: S = sum (a_k - b_k)^2
        s_expr = None
        for k in range(N_LIMBS):
            d = b.sub(a[k], v2[k])
            t = b.mul(d, d)
            s_expr = t if s_expr is None else b.add(s_expr, t)
        b.assert_zero(b.mul(is_eq, s_expr))
        b.assert_zero(b.sub(b.mul(s_expr, s_inv), b.sub(one, is_eq)))

        # less-than chain (signed flip for BLT/BGE)
        f_cmp = b.add(b.add(f[K_BLT], f[K_BGE]), b.add(f[K_BLTU], f[K_BGEU]))
        f_sgn = b.add(f[K_BLT], f[K_BGE])
        c256 = b.constant(LIMB)
        emit_sign_decomp(b, a[3], C.SA, C.A3R, f_sgn)
        emit_sign_decomp(b, v2[3], C.SB, C.B3R, f_sgn)
        flip_a = b.mul(f_sgn, b.sub(b.constant(128),
                                    b.mul(c256, b.local(C.SA))))
        flip_b = b.mul(f_sgn, b.sub(b.constant(128),
                                    b.mul(c256, b.local(C.SB))))
        lhs = [a[0], a[1], a[2], b.add(a[3], flip_a)]
        rhs = [v2[0], v2[1], v2[2], b.add(v2[3], flip_b)]
        lt = emit_cmp_chain(b, lhs, rhs, C.CMP_D, C.CMP_B, f_cmp)

        taken = b.add(
            b.add(b.mul(f[K_BEQ], is_eq),
                  b.mul(f[K_BNE], b.sub(one, is_eq))),
            b.add(b.mul(b.add(f[K_BLT], f[K_BLTU]), lt),
                  b.mul(b.add(f[K_BGE], f[K_BGEU]), b.sub(one, lt))),
        )
        is_taken = b.local(C.IS_TAKEN)
        b.assert_zero(b.sub(is_taken, taken))
        pc4 = b.add(b.local(PC), b.constant(4))
        b.assert_zero(b.sub(
            b.sub(b.local(C.NEXT_PC), pc4),
            b.mul(is_taken, b.sub(b.local(TARGET), pc4)),
        ))


# ---------------------------------------------------------------------------
# JumpAir — JAL / JALR / LUI / AUIPC
# ---------------------------------------------------------------------------
JUMP_KINDS = (K_JAL, K_JALR, K_LUI, K_AUIPC)


class JumpAir(Air):
    N_FLAGS = len(JUMP_KINDS)
    NEXT_PC = FLAGS + N_FLAGS
    ADDR = NEXT_PC + 1           # 4 (JALR rs1+imm)
    CARRY = ADDR + 4             # 4 (shared JALR/AUIPC chains)
    B0 = CARRY + 4               # dropped JALR target bit
    H0 = B0 + 1
    PCL = H0 + 1                 # 4 (AUIPC pc limbs)
    width = PCL + 4
    num_public_values = 0

    def eval(self, b: AirBuilder) -> None:
        C = JumpAir
        f = {k: b.local(FLAGS + j) for j, k in enumerate(JUMP_KINDS)}
        emit_common(b, JUMP_KINDS, [f[k] for k in JUMP_KINDS],
                    rs1_mult=f[K_JALR], rs2_mult=None,
                    rd_mult=b.local(IS_REAL), next_pc_expr=b.local(C.NEXT_PC))

        pc = b.local(PC)
        rd = [b.local(RD_VAL + k) for k in range(N_LIMBS)]
        c256 = b.constant(LIMB)

        # JAL/JALR link value: rd = pc + 4 (3 limbs, top limb 0 => pc < 2^24)
        f_link = b.add(f[K_JAL], f[K_JALR])
        comb = b.add(rd[0], b.add(b.mul(c256, rd[1]),
                                  b.mul(b.constant(1 << 16), rd[2])))
        b.assert_zero(b.mul(f_link, b.sub(comb, b.add(pc, b.constant(4)))))
        b.assert_zero(b.mul(f_link, rd[3]))

        # LUI: rd = imm
        for k in range(N_LIMBS):
            b.assert_zero(b.mul(f[K_LUI], b.sub(rd[k], b.local(IMM + k))))

        # AUIPC: pc limb decomposition + carry-chain pc + imm = rd
        pcl = [b.local(C.PCL + k) for k in range(N_LIMBS)]
        pc_comb = b.add(pcl[0], b.add(b.mul(c256, pcl[1]),
                                      b.mul(b.constant(1 << 16), pcl[2])))
        b.assert_zero(b.mul(f[K_AUIPC], b.sub(pc, pc_comb)))
        b.assert_zero(b.mul(f[K_AUIPC], pcl[3]))
        for k in range(3):
            b.push_send(BYTE_BUS, [pcl[k]], f[K_AUIPC])

        # JALR: addr = rs1 + imm (carry chain, shared with AUIPC's chain)
        a = [b.local(RS1_VAL + k) for k in range(N_LIMBS)]
        addr = [b.local(C.ADDR + k) for k in range(N_LIMBS)]
        prev = None
        for k in range(N_LIMBS):
            cur = b.local(C.CARRY + k)
            b.assert_bool(cur)
            e_jalr = b.add(a[k], b.local(IMM + k))
            e_auipc = b.add(pcl[k], b.local(IMM + k))
            if prev is not None:
                e_jalr = b.add(e_jalr, prev)
                e_auipc = b.add(e_auipc, prev)
            e_jalr = b.sub(b.sub(e_jalr, addr[k]), b.mul(c256, cur))
            e_auipc = b.sub(b.sub(e_auipc, rd[k]), b.mul(c256, cur))
            b.assert_zero(b.add(b.mul(f[K_JALR], e_jalr),
                                b.mul(f[K_AUIPC], e_auipc)))
            prev = cur
        b.assert_zero(b.mul(f[K_JALR], addr[3]))
        for k in range(3):
            b.push_send(BYTE_BUS, [addr[k]], f[K_JALR])
        # drop bit 0: addr0 = 2*H0 + B0, H0 < 128
        b.assert_bool(b.local(C.B0))
        b.assert_zero(b.mul(f[K_JALR], b.sub(
            addr[0], b.add(b.mul(b.constant(2), b.local(C.H0)),
                           b.local(C.B0)))))
        b.push_send(BYTE_BUS, [b.mul(b.constant(2), b.local(C.H0))],
                    f[K_JALR])

        # next_pc per kind
        nxt = b.local(C.NEXT_PC)
        b.assert_zero(b.mul(f[K_JAL], b.sub(nxt, b.local(TARGET))))
        jalr_t = b.add(b.mul(b.constant(2), b.local(C.H0)),
                       b.add(b.mul(c256, addr[1]),
                             b.mul(b.constant(1 << 16), addr[2])))
        b.assert_zero(b.mul(f[K_JALR], b.sub(nxt, jalr_t)))
        b.assert_zero(b.mul(b.add(f[K_LUI], f[K_AUIPC]),
                            b.sub(nxt, b.add(pc, b.constant(4)))))


# ---------------------------------------------------------------------------
# LoadStoreAir — byte-granular access over word-addressed RAM
# ---------------------------------------------------------------------------
LS_KINDS = (K_LB, K_LH, K_LW, K_LBU, K_LHU, K_SB, K_SH, K_SW)


class LoadStoreAir(Air):
    N_FLAGS = len(LS_KINDS)
    ADDR = FLAGS + N_FLAGS       # 4 (byte address rs1+imm)
    CARRY = ADDR + 4             # 4
    Q0 = CARRY + 4               # (addr0 - ofs)/4
    O0 = Q0 + 1                  # offset bits
    O1 = O0 + 1
    IND = O1 + 1                 # 4 one-hot byte indicators
    W_OLD = IND + 4              # 4 old word limbs
    W_NEW = W_OLD + 4            # 4 new word limbs
    MEM_PREV_TS = W_NEW + 4
    MDIFF = MEM_PREV_TS + 1      # 2 (mem port ts diff bytes)
    SGN = MDIFF + 2              # sign bit of loaded byte/half
    SREM = SGN + 1               # remaining 7 bits
    width = SREM + 1
    num_public_values = 0

    def eval(self, b: AirBuilder) -> None:
        C = LoadStoreAir
        one = b.constant(1)
        c256 = b.constant(LIMB)
        f = {k: b.local(FLAGS + j) for j, k in enumerate(LS_KINDS)}
        f_load = b.add(b.add(f[K_LB], f[K_LH]),
                       b.add(f[K_LW], b.add(f[K_LBU], f[K_LHU])))
        f_store = b.add(f[K_SB], b.add(f[K_SH], f[K_SW]))
        real = b.local(IS_REAL)
        ts = b.local(TS)
        emit_common(b, LS_KINDS, [f[k] for k in LS_KINDS],
                    rs1_mult=real, rs2_mult=f_store, rd_mult=f_load,
                    next_pc_expr=b.add(b.local(PC), b.constant(4)))

        a = [b.local(RS1_VAL + k) for k in range(N_LIMBS)]
        src = [b.local(RS2_VAL + k) for k in range(N_LIMBS)]
        rd = [b.local(RD_VAL + k) for k in range(N_LIMBS)]
        addr = [b.local(C.ADDR + k) for k in range(N_LIMBS)]
        w = [b.local(C.W_OLD + k) for k in range(N_LIMBS)]
        wn = [b.local(C.W_NEW + k) for k in range(N_LIMBS)]

        # addr = rs1 + imm
        prev = None
        for k in range(N_LIMBS):
            cur = b.local(C.CARRY + k)
            b.assert_bool(cur)
            e = b.add(a[k], b.local(IMM + k))
            if prev is not None:
                e = b.add(e, prev)
            b.assert_zero(b.mul(real, b.sub(b.sub(e, addr[k]),
                                            b.mul(c256, cur))))
            b.push_send(BYTE_BUS, [addr[k]], real)
            prev = cur

        # offset decomposition: addr0 = 4*Q0 + O0 + 2*O1, Q0 < 64
        o0, o1 = b.local(C.O0), b.local(C.O1)
        b.assert_bool(o0)
        b.assert_bool(o1)
        ofs = b.add(o0, b.mul(b.constant(2), o1))
        b.assert_zero(b.mul(real, b.sub(
            addr[0], b.add(b.mul(b.constant(4), b.local(C.Q0)), ofs))))
        b.push_send(BYTE_BUS, [b.mul(b.constant(4), b.local(C.Q0))], real)

        # alignment rules
        f_word = b.add(f[K_LW], f[K_SW])
        f_half = b.add(f[K_LH], b.add(f[K_LHU], f[K_SH]))
        b.assert_zero(b.mul(f_word, o0))
        b.assert_zero(b.mul(f_word, o1))
        b.assert_zero(b.mul(f_half, o0))

        # one-hot byte indicators from (o0, o1)
        i_ = [b.local(C.IND + j) for j in range(4)]
        no0, no1 = b.sub(one, o0), b.sub(one, o1)
        b.assert_zero(b.sub(i_[0], b.mul(no0, no1)))
        b.assert_zero(b.sub(i_[1], b.mul(o0, no1)))
        b.assert_zero(b.sub(i_[2], b.mul(no0, o1)))
        b.assert_zero(b.sub(i_[3], b.mul(o0, o1)))

        # old word limbs byte-checked
        for k in range(N_LIMBS):
            b.push_send(BYTE_BUS, [w[k]], real)

        # loads: selected byte/half with sign handling
        sel_b = None
        for j in range(4):
            t = b.mul(i_[j], w[j])
            sel_b = t if sel_b is None else b.add(sel_b, t)
        half_lo = b.add(b.mul(i_[0], w[0]), b.mul(i_[2], w[2]))
        half_hi = b.add(b.mul(i_[0], w[1]), b.mul(i_[2], w[3]))
        sgn, srem = b.local(C.SGN), b.local(C.SREM)
        b.assert_bool(sgn)
        sgn_dec = b.add(b.mul(b.constant(128), sgn), srem)
        b.assert_zero(b.mul(f[K_LB], b.sub(sel_b, sgn_dec)))
        b.assert_zero(b.mul(f[K_LH], b.sub(half_hi, sgn_dec)))
        b.push_send(BYTE_BUS, [b.mul(b.constant(2), srem)],
                    b.add(f[K_LB], f[K_LH]))
        ext = b.mul(b.constant(255), sgn)
        # LB: rd = [sel, ext, ext, ext]
        b.assert_zero(b.mul(f[K_LB], b.sub(rd[0], sel_b)))
        for k in (1, 2, 3):
            b.assert_zero(b.mul(f[K_LB], b.sub(rd[k], ext)))
        # LBU: rd = [sel, 0, 0, 0]
        b.assert_zero(b.mul(f[K_LBU], b.sub(rd[0], sel_b)))
        for k in (1, 2, 3):
            b.assert_zero(b.mul(f[K_LBU], rd[k]))
        # LH: rd = [lo, hi, ext, ext]
        b.assert_zero(b.mul(f[K_LH], b.sub(rd[0], half_lo)))
        b.assert_zero(b.mul(f[K_LH], b.sub(rd[1], half_hi)))
        for k in (2, 3):
            b.assert_zero(b.mul(f[K_LH], b.sub(rd[k], ext)))
        # LHU: rd = [lo, hi, 0, 0]
        b.assert_zero(b.mul(f[K_LHU], b.sub(rd[0], half_lo)))
        b.assert_zero(b.mul(f[K_LHU], b.sub(rd[1], half_hi)))
        for k in (2, 3):
            b.assert_zero(b.mul(f[K_LHU], rd[k]))
        # LW: rd = w
        for k in range(N_LIMBS):
            b.assert_zero(b.mul(f[K_LW], b.sub(rd[k], w[k])))

        # new word: loads keep it; stores merge rs2 bytes in
        for k in range(N_LIMBS):
            b.assert_zero(b.mul(f_load, b.sub(wn[k], w[k])))
            b.assert_zero(b.mul(f[K_SW], b.sub(wn[k], src[k])))
            b.assert_zero(b.mul(f[K_SB], b.sub(
                wn[k], b.add(w[k], b.mul(i_[k], b.sub(src[0], w[k]))))))
        # SH merges two bytes at offset 0 or 2
        b.assert_zero(b.mul(f[K_SH], b.sub(
            wn[0], b.add(w[0], b.mul(i_[0], b.sub(src[0], w[0]))))))
        b.assert_zero(b.mul(f[K_SH], b.sub(
            wn[1], b.add(w[1], b.mul(i_[0], b.sub(src[1], w[1]))))))
        b.assert_zero(b.mul(f[K_SH], b.sub(
            wn[2], b.add(w[2], b.mul(i_[2], b.sub(src[0], w[2]))))))
        b.assert_zero(b.mul(f[K_SH], b.sub(
            wn[3], b.add(w[3], b.mul(i_[2], b.sub(src[1], w[3]))))))

        # RAM bus — word-addressed, single-felt address key. The felt
        # encoding is injective because addr < 2^31 - 2^27 < P, enforced by
        # the addr3 + 136 byte check below (addresses >= 0x78000000 are
        # unsupported).
        waddr_f = b.sub(addr[0], ofs)
        for k in range(1, N_LIMBS):
            waddr_f = b.add(waddr_f, b.mul(b.constant(1 << (8 * k)),
                                           addr[k]))
        b.push_send(BYTE_BUS, [b.add(addr[3], b.constant(136))], real)
        mts = b.local(C.MEM_PREV_TS)
        cur_ts = b.add(ts, b.constant(3))
        b.push_receive(MEM_BUS, [waddr_f, mts] + w, real)
        b.push_send(MEM_BUS, [waddr_f, cur_ts] + wn, real)
        mdiff = b.sub(b.sub(cur_ts, mts), one)
        recon = b.add(b.local(C.MDIFF),
                      b.mul(b.constant(1 << 16), b.local(C.MDIFF + 1)))
        b.assert_zero(b.mul(real, b.sub(mdiff, recon)))
        b.push_send(RANGE16_BUS, [b.local(C.MDIFF)], real)
        b.push_send(BYTE_BUS, [b.local(C.MDIFF + 1)], real)


# ---------------------------------------------------------------------------
# ShiftAir — SLL/SRL/SRA (+imm): pow-of-two limb multiplication.
#
# SLL: a * 2^s = hi * 2^32 + rd (exact, positions 0..7).
# SRL: a = rd * 2^s + rem, rem < 2^s (exact unsigned division).
# SRA via the top-bit-flip trick: with u = a ^ 0x80000000,
#   sra(a, s) = srl(u, s) - 2^(31-s)   (mod 2^32)
# because floor((u - 2^31)/2^s) = floor(u/2^s) - 2^(31-s) exactly. The bits
# of 31-s are the complements of the bits of s (31 = 0b11111), so 2^(31-s)
# uses the same bit->limb machinery with flipped bits.
# ---------------------------------------------------------------------------
SHIFT_KINDS = (K_SLL, K_SLLI, K_SRL, K_SRLI, K_SRA, K_SRAI)


class ShiftAir(Air):
    N_FLAGS = len(SHIFT_KINDS)
    S_BITS = FLAGS + N_FLAGS     # 5 shamt bits
    B0HI = S_BITS + 5            # rs2_0 = shamt + 32*B0HI
    T_A = B0HI + 1               # (1+s0)(1+3 s1)
    P2T = T_A + 1                # 2^(s mod 8 restricted to bits 0-2)
    PW = P2T + 1                 # 4 limbs of 2^s
    T_AI = PW + 4                # (2-s0)(4-3 s1)
    P2TI = T_AI + 1              # 2^((31-s) mod 8 bits)
    PWI = P2TI + 1               # 4 limbs of 2^(31-s)
    HI = PWI + 4                 # 4: SLL high limbs
    RDU = HI + 4                 # 4: right-shift unsigned quotient
    REM = RDU + 4                # 4: right-shift remainder
    RCH_D = REM + 4              # 4: rem < pow chain diffs
    RCH_B = RCH_D + 4            # 4: chain borrows
    BR = RCH_B + 4               # 4: SRA bias-subtraction borrows
    POS_C = BR + 4               # 7 x 2 position-carry bytes
    SA = POS_C + 14
    A3R = SA + 1
    width = A3R + 1
    num_public_values = 0

    def eval(self, b: AirBuilder) -> None:
        C = ShiftAir
        one = b.constant(1)
        c256 = b.constant(LIMB)
        f = {k: b.local(FLAGS + j) for j, k in enumerate(SHIFT_KINDS)}
        f_reg = b.add(f[K_SLL], b.add(f[K_SRL], f[K_SRA]))
        f_immv = b.add(f[K_SLLI], b.add(f[K_SRLI], f[K_SRAI]))
        f_left = b.add(f[K_SLL], f[K_SLLI])
        f_right = b.add(b.add(f[K_SRL], f[K_SRLI]),
                        b.add(f[K_SRA], f[K_SRAI]))
        f_sra = b.add(f[K_SRA], f[K_SRAI])
        real = b.local(IS_REAL)
        emit_common(b, SHIFT_KINDS, [f[k] for k in SHIFT_KINDS],
                    rs1_mult=real, rs2_mult=f_reg, rd_mult=real,
                    next_pc_expr=b.add(b.local(PC), b.constant(4)))

        a = [b.local(RS1_VAL + k) for k in range(N_LIMBS)]
        rd = [b.local(RD_VAL + k) for k in range(N_LIMBS)]
        s = [b.local(C.S_BITS + j) for j in range(5)]
        for sj in s:
            b.assert_bool(sj)
        shamt = s[0]
        for j in range(1, 5):
            shamt = b.add(shamt, b.mul(b.constant(1 << j), s[j]))

        # shamt source: rs2_0 mod 32 (reg) or imm_0 (imm variant)
        b.assert_zero(b.add(
            b.mul(f_reg, b.sub(b.local(RS2_VAL),
                               b.add(shamt, b.mul(b.constant(32),
                                                  b.local(C.B0HI))))),
            b.mul(f_immv, b.sub(b.local(IMM), shamt)),
        ))
        b.push_send(BYTE_BUS, [b.mul(b.constant(32), b.local(C.B0HI))],
                    f_reg)

        # 2^s limbs: pw_k = ind_w(k) * 2^(s0+2s1+4s2); padding rows carry
        # T_A = P2T = PW_0 = 1 (the s = 0 solution of these ungated defs)
        t_a, p2t = b.local(C.T_A), b.local(C.P2T)
        b.assert_zero(b.sub(t_a, b.mul(b.add(one, s[0]),
                                       b.add(one, b.mul(b.constant(3),
                                                        s[1])))))
        b.assert_zero(b.sub(p2t, b.mul(t_a, b.add(one,
                                                  b.mul(b.constant(15),
                                                        s[2])))))
        ns3, ns4 = b.sub(one, s[3]), b.sub(one, s[4])
        ind = [b.mul(ns3, ns4), b.mul(s[3], ns4), b.mul(ns3, s[4]),
               b.mul(s[3], s[4])]
        pw = [b.local(C.PW + k) for k in range(N_LIMBS)]
        for k in range(N_LIMBS):
            b.assert_zero(b.sub(pw[k], b.mul(ind[k], p2t)))
            b.push_send(BYTE_BUS, [pw[k]], real)

        # 2^(31-s) limbs (complemented bits); padding: T_AI=8, P2TI=128,
        # PWI_3 = 128
        t_ai, p2ti = b.local(C.T_AI), b.local(C.P2TI)
        b.assert_zero(b.sub(t_ai, b.mul(
            b.sub(b.constant(2), s[0]),
            b.sub(b.constant(4), b.mul(b.constant(3), s[1])))))
        b.assert_zero(b.sub(p2ti, b.mul(
            t_ai, b.sub(b.constant(16), b.mul(b.constant(15), s[2])))))
        indi = [b.mul(s[3], s[4]), b.mul(ns3, s[4]), b.mul(s[3], ns4),
                b.mul(ns3, ns4)]
        pwi = [b.local(C.PWI + k) for k in range(N_LIMBS)]
        for k in range(N_LIMBS):
            b.assert_zero(b.sub(pwi[k], b.mul(indi[k], p2ti)))
            b.push_send(BYTE_BUS, [pwi[k]], real)

        # sign bit of a (for SRA's flip)
        emit_sign_decomp(b, a[3], C.SA, C.A3R, f_sra)
        flip = b.mul(f_sra, b.sub(b.constant(128),
                                  b.mul(c256, b.local(C.SA))))
        u = [a[0], a[1], a[2], b.add(a[3], flip)]

        hi = [b.local(C.HI + k) for k in range(N_LIMBS)]
        rdu = [b.local(C.RDU + k) for k in range(N_LIMBS)]
        rem = [b.local(C.REM + k) for k in range(N_LIMBS)]
        for k in range(N_LIMBS):
            b.push_send(BYTE_BUS, [hi[k]], f_left)
            b.push_send(BYTE_BUS, [rdu[k]], f_right)
            b.push_send(BYTE_BUS, [rem[k]], f_right)

        # position equations t = 0..7, shared carry columns (2 bytes each,
        # t = 0..6; t = 7 closes both chains with no carry-out):
        # left:  a * pw = rd + 2^32 * hi          (outputs rd then hi)
        # right: rdu * pw + rem = u, high half 0  (exact unsigned division)
        for t in range(8):
            prods_l, prods_r = None, None
            for i2 in range(max(0, t - 3), min(4, t + 1)):
                j = t - i2
                pl = b.mul(a[i2], pw[j])
                pr = b.mul(rdu[i2], pw[j])
                prods_l = pl if prods_l is None else b.add(prods_l, pl)
                prods_r = pr if prods_r is None else b.add(prods_r, pr)
            zero = b.constant(0)
            prods_l = prods_l if prods_l is not None else zero
            prods_r = prods_r if prods_r is not None else zero
            if t < 4:
                prods_r = b.add(prods_r, rem[t])
            out_l = rd[t] if t < 4 else hi[t - 4]
            out_r = u[t] if t < 4 else zero
            if t > 0:
                cprev = b.add(b.local(C.POS_C + 2 * (t - 1)),
                              b.mul(c256, b.local(C.POS_C + 2 * t - 1)))
                prods_l = b.add(prods_l, cprev)
                prods_r = b.add(prods_r, cprev)
            if t < 7:
                ccur = b.add(b.local(C.POS_C + 2 * t),
                             b.mul(c256, b.local(C.POS_C + 2 * t + 1)))
                out_l = b.add(out_l, b.mul(c256, ccur))
                out_r = b.add(out_r, b.mul(c256, ccur))
            b.assert_zero(b.mul(f_left, b.sub(prods_l, out_l)))
            b.assert_zero(b.mul(f_right, b.sub(prods_r, out_r)))
        for t in range(7):
            b.push_send(BYTE_BUS, [b.local(C.POS_C + 2 * t)], real)
            b.push_send(BYTE_BUS, [b.local(C.POS_C + 2 * t + 1)], real)

        # rem < pow (right shifts): borrow chain with final borrow 1
        lt = emit_cmp_chain(b, rem, pw, C.RCH_D, C.RCH_B, f_right)
        b.assert_zero(b.mul(f_right, b.sub(lt, one)))

        # bias subtraction: rd = rdu - f_sra * 2^(31-s)  (mod 2^32)
        prev = None
        for k in range(N_LIMBS):
            br = b.local(C.BR + k)
            b.assert_bool(br)
            e = b.sub(rdu[k], b.mul(f_sra, pwi[k]))
            if prev is not None:
                e = b.sub(e, prev)
            e = b.add(b.sub(e, rd[k]), b.mul(c256, br))
            b.assert_zero(b.mul(f_right, e))
            prev = br


# ---------------------------------------------------------------------------
# MulAir — MUL/MULH/MULHSU/MULHU
# ---------------------------------------------------------------------------
MUL_KINDS = (K_MUL, K_MULH, K_MULHSU, K_MULHU)


class MulAir(Air):
    N_FLAGS = len(MUL_KINDS)
    CL = FLAGS + N_FLAGS         # 8 product limbs
    PCAR = CL + 8                # 6 x 2 carry bytes (t = 0..5); c7 is t=6's
    SA = PCAR + 12
    A3R = SA + 1
    SB = A3R + 1
    B3R = SB + 1
    SA_F = B3R + 1               # sa * (mulh + mulhsu)
    SB_F = SA_F + 1              # sb * mulh
    BW = SB_F + 1                # 4 borrow cols in {0,1,2}
    width = BW + 4
    num_public_values = 0

    def eval(self, b: AirBuilder) -> None:
        C = MulAir
        c256 = b.constant(LIMB)
        f = {k: b.local(FLAGS + j) for j, k in enumerate(MUL_KINDS)}
        real = b.local(IS_REAL)
        emit_common(b, MUL_KINDS, [f[k] for k in MUL_KINDS],
                    rs1_mult=real, rs2_mult=real, rd_mult=real,
                    next_pc_expr=b.add(b.local(PC), b.constant(4)))

        a = [b.local(RS1_VAL + k) for k in range(N_LIMBS)]
        v2 = [b.local(RS2_VAL + k) for k in range(N_LIMBS)]
        rd = [b.local(RD_VAL + k) for k in range(N_LIMBS)]
        c = [b.local(C.CL + t) for t in range(8)]
        for t in range(8):
            b.push_send(BYTE_BUS, [c[t]], real)

        # position equations: sum_{i+j=t} a_i b_j + carry_in = c_t + 256 c_out
        for t in range(7):
            prods = None
            for i2 in range(max(0, t - 3), min(4, t + 1)):
                p = b.mul(a[i2], v2[t - i2])
                prods = p if prods is None else b.add(prods, p)
            if t > 0:
                cin = b.add(b.local(C.PCAR + 2 * (t - 1)),
                            b.mul(c256, b.local(C.PCAR + 2 * t - 1)))
                prods = b.add(prods, cin)
            if t < 6:
                cout = b.add(b.local(C.PCAR + 2 * t),
                             b.mul(c256, b.local(C.PCAR + 2 * t + 1)))
            else:
                cout = c[7]  # final carry IS the top product limb
            b.assert_zero(b.mul(real, b.sub(prods,
                                            b.add(c[t], b.mul(c256, cout)))))
        for t in range(6):
            b.push_send(BYTE_BUS, [b.local(C.PCAR + 2 * t)], real)
            b.push_send(BYTE_BUS, [b.local(C.PCAR + 2 * t + 1)], real)

        # MUL: rd = low limbs
        for k in range(N_LIMBS):
            b.assert_zero(b.mul(f[K_MUL], b.sub(rd[k], c[k])))

        # signed corrections: hi - sa*b - sb*a (mod 2^32) via borrow chain
        f_sgn_a = b.add(f[K_MULH], f[K_MULHSU])
        emit_sign_decomp(b, a[3], C.SA, C.A3R, f_sgn_a)
        emit_sign_decomp(b, v2[3], C.SB, C.B3R, f[K_MULH])
        sa_f, sb_f = b.local(C.SA_F), b.local(C.SB_F)
        b.assert_zero(b.sub(sa_f, b.mul(b.local(C.SA), f_sgn_a)))
        b.assert_zero(b.sub(sb_f, b.mul(b.local(C.SB), f[K_MULH])))
        f_hi = b.add(f_sgn_a, f[K_MULHU])
        prev = None
        for t in range(N_LIMBS):
            bw = b.local(C.BW + t)
            b.assert_zero(b.mul(bw, b.mul(b.sub(bw, b.constant(1)),
                                          b.sub(bw, b.constant(2)))))
            e = b.sub(b.sub(c[4 + t], b.mul(sa_f, v2[t])),
                      b.mul(sb_f, a[t]))
            if prev is not None:
                e = b.sub(e, prev)
            e = b.add(b.sub(e, rd[t]), b.mul(c256, bw))
            b.assert_zero(b.mul(f_hi, e))
            prev = bw


# ---------------------------------------------------------------------------
# DivRemAir — DIV/DIVU/REM/REMU via the magnitude identity
#   |a| = |b| * |q| + |r|,  0 <= |r| < |b|  (b != 0)
# with two's-complement negation links. RISC-V edge cases: b == 0 gives
# q = 0xFFFFFFFF, r = a (forced by a dedicated flag); signed overflow
# (INT_MIN / -1) falls out of the magnitude identity naturally.
# ---------------------------------------------------------------------------
DIV_KINDS = (K_DIV, K_DIVU, K_REM, K_REMU)


class DivRemAir(Air):
    N_FLAGS = len(DIV_KINDS)
    Q = FLAGS + N_FLAGS          # 4 quotient (two's complement)
    R = Q + 4                    # 4 remainder (two's complement)
    AM = R + 4                   # magnitudes
    BM = AM + 4
    QM = BM + 4
    RM = QM + 4
    NC = RM + 4                  # 4 links x 4 negation-chain carries
    NA = NC + 16
    NB = NA + 1
    NQ = NB + 1
    SA = NQ + 1
    A3R = SA + 1
    SB = A3R + 1
    B3R = SB + 1
    PCAR = B3R + 1               # 6 x 2 product carry bytes
    LT_D = PCAR + 12             # rm < bm chain
    LT_B = LT_D + 4
    BZ = LT_B + 4
    BINV = BZ + 1
    width = BINV + 1
    num_public_values = 0

    def eval(self, b: AirBuilder) -> None:
        C = DivRemAir
        one = b.constant(1)
        c256 = b.constant(LIMB)
        f = {k: b.local(FLAGS + j) for j, k in enumerate(DIV_KINDS)}
        f_s = b.add(f[K_DIV], f[K_REM])
        real = b.local(IS_REAL)
        emit_common(b, DIV_KINDS, [f[k] for k in DIV_KINDS],
                    rs1_mult=real, rs2_mult=real, rd_mult=real,
                    next_pc_expr=b.add(b.local(PC), b.constant(4)))

        a = [b.local(RS1_VAL + k) for k in range(N_LIMBS)]
        v2 = [b.local(RS2_VAL + k) for k in range(N_LIMBS)]
        rd = [b.local(RD_VAL + k) for k in range(N_LIMBS)]
        q = [b.local(C.Q + k) for k in range(N_LIMBS)]
        r = [b.local(C.R + k) for k in range(N_LIMBS)]
        am = [b.local(C.AM + k) for k in range(N_LIMBS)]
        bm = [b.local(C.BM + k) for k in range(N_LIMBS)]
        qm = [b.local(C.QM + k) for k in range(N_LIMBS)]
        rm = [b.local(C.RM + k) for k in range(N_LIMBS)]
        for k in range(N_LIMBS):
            for col in (q[k], r[k], am[k], bm[k], qm[k], rm[k]):
                b.push_send(BYTE_BUS, [col], real)

        # rd = q for DIV/DIVU, r for REM/REMU
        f_q = b.add(f[K_DIV], f[K_DIVU])
        f_r = b.add(f[K_REM], f[K_REMU])
        for k in range(N_LIMBS):
            b.assert_zero(b.sub(rd[k], b.add(b.mul(f_q, q[k]),
                                             b.mul(f_r, r[k]))))

        # sign bits (only meaningful for signed kinds)
        emit_sign_decomp(b, a[3], C.SA, C.A3R, f_s)
        emit_sign_decomp(b, v2[3], C.SB, C.B3R, f_s)
        sa, sb = b.local(C.SA), b.local(C.SB)
        na, nb, nq = b.local(C.NA), b.local(C.NB), b.local(C.NQ)
        b.assert_zero(b.sub(na, b.mul(f_s, sa)))
        b.assert_zero(b.sub(nb, b.mul(f_s, sb)))
        # nq = f_s * (sa xor sb)
        b.assert_zero(b.sub(nq, b.mul(f_s, b.sub(b.add(sa, sb),
                                                 b.mul(b.constant(2),
                                                       b.mul(sa, sb))))))

        # negation links: x + xm = 2^32*z when negated, xm = x otherwise
        links = [(a, am, na, 0), (v2, bm, nb, 4), (q, qm, nq, 8),
                 (r, rm, na, 12)]
        for x, xm, neg, coff in links:
            prev = None
            for k in range(N_LIMBS):
                cc = b.local(C.NC + coff + k)
                b.assert_bool(cc)
                e_neg = b.add(x[k], xm[k])
                if prev is not None:
                    e_neg = b.add(e_neg, prev)
                e_neg = b.sub(e_neg, b.mul(c256, cc))
                e_id = b.sub(xm[k], x[k])
                b.assert_zero(b.add(b.mul(neg, e_neg),
                                    b.mul(b.sub(real, neg), e_id)))
                prev = cc

        # magnitude identity: bm*qm + rm = am with high positions zero
        for t in range(7):
            prods = None
            for i2 in range(max(0, t - 3), min(4, t + 1)):
                p = b.mul(bm[i2], qm[t - i2])
                prods = p if prods is None else b.add(prods, p)
            if t < 4:
                prods = b.add(prods, rm[t])
            if t > 0:
                cin = b.add(b.local(C.PCAR + 2 * (t - 1)),
                            b.mul(c256, b.local(C.PCAR + 2 * t - 1)))
                prods = b.add(prods, cin)
            rhs = am[t] if t < 4 else b.constant(0)
            if t < 6:
                cout = b.add(b.local(C.PCAR + 2 * t),
                             b.mul(c256, b.local(C.PCAR + 2 * t + 1)))
                rhs = b.add(rhs, b.mul(c256, cout))
            b.assert_zero(b.mul(real, b.sub(prods, rhs)))
        for t in range(6):
            b.push_send(BYTE_BUS, [b.local(C.PCAR + 2 * t)], real)
            b.push_send(BYTE_BUS, [b.local(C.PCAR + 2 * t + 1)], real)

        # b == 0 detection: bz = 1 iff sum of b limbs is 0 (on real rows)
        bz, binv = b.local(C.BZ), b.local(C.BINV)
        b.assert_bool(bz)
        bsum = v2[0]
        for k in range(1, N_LIMBS):
            bsum = b.add(bsum, v2[k])
        b.assert_zero(b.mul(bz, bsum))
        b.assert_zero(b.sub(b.mul(bsum, binv), b.sub(real, bz)))
        # b == 0: q = 0xFFFFFFFF (both signed and unsigned)
        for k in range(N_LIMBS):
            b.assert_zero(b.mul(bz, b.sub(q[k], b.constant(255))))

        # rm < bm when b != 0
        lt = emit_cmp_chain(b, rm, bm, C.LT_D, C.LT_B, b.sub(real, bz))
        b.assert_zero(b.mul(b.sub(real, bz), b.sub(lt, one)))


# ---------------------------------------------------------------------------
# SystemAir — ECALL rows: HALT (a7=0), HINT_READ (a7=1), REVEAL (a7=2).
#
# The reference analog is openvm's system chips (terminate, hint stream,
# reveal via openvm::io::reveal_bytes32). A HALT row receives (pc, ts) from the exec bus
# and sends nothing, so the execution chain can only terminate through a
# genuine ECALL-halt with exit code 0. REVEAL rows forward (index, word
# limbs) onto PV_BUS where PublicValuesAir binds them to the proof's public
# values. HINT rows write a host-chosen word into a0 (witness
# nondeterminism, like the openvm hint stream).
# ---------------------------------------------------------------------------


class SystemAir(Air):
    F_HALT, F_HINT, F_REVEAL, F_KECCAK = 3, 4, 5, 6
    A7_PREV_TS = 7
    A7_D = 8                     # 2 ts-diff bytes
    A0_VAL = 10                  # 4 (read: halt code / reveal word / msg ptr)
    A0_PREV_TS = 14
    A0_D = 15                    # 2
    H_VAL = 17                   # 4 (hint write: new a0)
    H_PREV_VAL = 21              # 4
    H_PREV_TS = 25
    H_D = 26                     # 2
    A1_VAL = 28                  # 4 (reveal index / keccak msg length)
    A1_PREV_TS = 32
    A1_D = 33                    # 2
    A2_VAL = 35                  # 4 (keccak output pointer)
    A2_PREV_TS = 39
    A2_D = 40                    # 2
    F_MOD, F_EC, F_SHA = 42, 43, 44   # a7 = 4 / 5 / 6 extension syscalls
    A3_VAL = 45                  # 4 (modop/ec selector)
    A3_PREV_TS = 49
    A3_D = 50                    # 2
    F_DBL = 52                   # a7 = 7 (ec_double)
    F_DEFER = 53                 # a7 = 8 (defer child-proof verification)
    F_FP2 = 54                   # a7 = 9 (quadratic-extension fp2 op)
    width = 55
    num_public_values = 0

    def eval(self, b: AirBuilder) -> None:
        C = SystemAir
        one = b.constant(1)
        c256 = b.constant(LIMB)
        real = b.local(IS_REAL)
        pc, ts = b.local(PC), b.local(TS)
        f_halt = b.local(C.F_HALT)
        f_hint = b.local(C.F_HINT)
        f_rev = b.local(C.F_REVEAL)
        f_kec = b.local(C.F_KECCAK)
        f_mod = b.local(C.F_MOD)
        f_ec = b.local(C.F_EC)
        f_sha = b.local(C.F_SHA)
        f_dbl = b.local(C.F_DBL)
        f_defer = b.local(C.F_DEFER)
        f_fp2 = b.local(C.F_FP2)
        b.assert_bool(real)
        for f in (f_halt, f_hint, f_rev, f_kec, f_mod, f_ec, f_sha, f_dbl,
                  f_defer, f_fp2):
            b.assert_bool(f)
        b.assert_eq(b.add(b.add(b.add(f_halt, f_hint), b.add(f_rev, f_kec)),
                          b.add(b.add(b.add(f_mod, f_ec), f_fp2),
                                b.add(b.add(f_sha, f_dbl), f_defer))),
                    real)

        zero = b.constant(0)
        b.push_send(PROGRAM_BUS,
                    [pc, b.constant(K_ECALL + 1), zero, zero, zero,
                     zero, zero, zero, zero, zero], real)

        # exec bus: halt consumes the chain; hint/reveal continue at pc+4;
        # keccak's continuation is sent by KeccakVmAir's final block row
        # (which owns the instruction's timestamp window).
        b.push_receive(EXEC_BUS, [pc, ts], real)
        b.push_send(EXEC_BUS,
                    [b.add(pc, b.constant(4)),
                     b.add(ts, b.constant(TS_STRIDE))],
                    b.add(f_hint, f_rev))

        def port(idx, prev_ts_col, cur_ts, d_col, recv_vals, send_vals,
                 mult):
            b.push_receive(REG_BUS,
                           [b.constant(idx), b.local(prev_ts_col)]
                           + recv_vals, mult)
            b.push_send(REG_BUS, [b.constant(idx), cur_ts] + send_vals,
                        mult)
            diff = b.sub(b.sub(cur_ts, b.local(prev_ts_col)), one)
            recon = b.add(b.local(d_col),
                          b.mul(b.constant(1 << 16), b.local(d_col + 1)))
            b.assert_zero(b.mul(mult, b.sub(diff, recon)))
            b.push_send(RANGE16_BUS, [b.local(d_col)], mult)
            b.push_send(BYTE_BUS, [b.local(d_col + 1)], mult)

        # a7 (x17) read at ts: value is the syscall id (0..7 by flag)
        a7 = [b.add(b.add(b.add(f_hint, b.mul(b.constant(2), f_rev)),
                          b.add(b.mul(b.constant(3), f_kec),
                                b.mul(b.constant(4), f_mod))),
                    b.add(b.add(b.mul(b.constant(5), f_ec),
                                b.mul(b.constant(6), f_sha)),
                          b.add(b.add(b.mul(b.constant(7), f_dbl),
                                      b.mul(b.constant(8), f_defer)),
                                b.mul(b.constant(9), f_fp2)))),
              zero, zero, zero]
        port(17, C.A7_PREV_TS, ts, C.A7_D, a7, a7, real)

        # pointer-carrying syscalls: buffers < 2^16 (single-felt MEM_BUS
        # addresses in the extension chips need no carry chains)
        f_ptr = b.add(b.add(b.add(f_kec, f_sha), b.add(f_mod, f_ec)),
                      b.add(f_dbl, f_fp2))

        # a0 (x10) read at ts+1: halt exit code / reveal word / msg or rd ptr
        a0 = [b.local(C.A0_VAL + k) for k in range(N_LIMBS)]
        m0 = b.add(b.add(b.add(f_halt, f_rev), f_ptr), f_defer)
        port(10, C.A0_PREV_TS, b.add(ts, one), C.A0_D, a0, a0, m0)
        for k in range(N_LIMBS):
            b.assert_zero(b.mul(f_halt, a0[k]))
        for k in (2, 3):
            b.assert_zero(b.mul(b.add(f_ptr, f_defer), a0[k]))

        # a0 (x10) write at ts+1 for hint (host-chosen word)
        hv = [b.local(C.H_VAL + k) for k in range(N_LIMBS)]
        hp = [b.local(C.H_PREV_VAL + k) for k in range(N_LIMBS)]
        port(10, C.H_PREV_TS, b.add(ts, one), C.H_D, hp, hv, f_hint)
        for k in range(N_LIMBS):
            b.push_send(BYTE_BUS, [hv[k]], f_hint)

        # a1 (x11) read at ts+2: reveal PV index / msg length / x or P ptr
        a1 = [b.local(C.A1_VAL + k) for k in range(N_LIMBS)]
        port(11, C.A1_PREV_TS, b.add(ts, b.constant(2)), C.A1_D, a1, a1,
             b.add(f_rev, f_ptr))
        for k in range(1, N_LIMBS):
            b.assert_zero(b.mul(f_rev, a1[k]))
        for k in (2, 3):  # msg length / pointers < 2^16
            b.assert_zero(b.mul(f_ptr, a1[k]))

        b.push_send(PV_BUS, [a1[0]] + a0, f_rev)

        # a2 (x12) read at ts+3: output pointer / y or Q ptr (< 2^16)
        a2 = [b.local(C.A2_VAL + k) for k in range(N_LIMBS)]
        port(12, C.A2_PREV_TS, b.add(ts, b.constant(3)), C.A2_D, a2, a2,
             f_ptr)
        for k in (2, 3):
            b.assert_zero(b.mul(f_ptr, a2[k]))

        # a3 (x13) read at ts+4: modop/ec/double/fp2 selector (< 256)
        f_sel = b.add(b.add(f_mod, f_ec), b.add(f_dbl, f_fp2))
        a3 = [b.local(C.A3_VAL + k) for k in range(N_LIMBS)]
        port(13, C.A3_PREV_TS, b.add(ts, b.constant(4)), C.A3_D, a3, a3,
             f_sel)
        for k in (1, 2, 3):
            b.assert_zero(b.mul(f_sel, a3[k]))

        # hand the requests to the extension chips (which own the rest of
        # the instruction's timestamp window and send the continuation)
        b.push_send(KECCAK_REQ_BUS,
                    [pc, ts, a0[0], a0[1], a1[0], a1[1], a2[0], a2[1]],
                    f_kec)
        b.push_send(MOD_REQ_BUS,
                    [pc, ts, a0[0], a0[1], a1[0], a1[1], a2[0], a2[1],
                     a3[0]],
                    f_mod)
        b.push_send(EC_REQ_BUS,
                    [pc, ts, a0[0], a0[1], a1[0], a1[1], a2[0], a2[1],
                     a3[0]],
                    f_ec)
        b.push_send(SHA_REQ_BUS,
                    [pc, ts, a0[0], a0[1], a1[0], a1[1], a2[0], a2[1]],
                    f_sha)
        b.push_send(EC_DBL_REQ_BUS,
                    [pc, ts, a0[0], a0[1], a1[0], a1[1], a3[0]],
                    f_dbl)
        b.push_send(DEFER_REQ_BUS, [pc, ts, a0[0], a0[1]], f_defer)
        b.push_send(FP2_REQ_BUS,
                    [pc, ts, a0[0], a0[1], a1[0], a1[1], a2[0], a2[1],
                     a3[0]],
                    f_fp2)


class PublicValuesAir(Air):
    """Binds the machine's public values to REVEAL messages. PV layout:
    pvs[4i+k] = limb k of word i (i < N_PV_WORDS); pvs[4*N_PV_WORDS + i] =
    per-word reveal flag. A word with flag=1 must have been revealed exactly
    once (the PV bus receive with multiplicity flag_i balances exactly one
    REVEAL send); a word with flag=0 is constrained to zero limbs, so
    partial reveals are sound: unrevealed words cannot carry attacker-chosen
    values. The host rejects all-zero PVs like the reference's precheck
    (crates/prover/src/utils/vm.rs:20-25)."""

    IS_FIRST = 0
    width = 1
    num_public_values = 5 * N_PV_WORDS

    def eval(self, b: AirBuilder) -> None:
        is_first = b.local(PublicValuesAir.IS_FIRST)
        b.assert_bool(is_first)
        b.when_first_row().assert_eq(is_first, b.constant(1))
        b.when_transition().assert_zero(b.next(PublicValuesAir.IS_FIRST))
        for i in range(N_PV_WORDS):
            flag = b.public_value(4 * N_PV_WORDS + i)
            b.when_first_row().assert_bool(flag)
            for k in range(N_LIMBS):
                # unrevealed word => zero limbs
                b.when_first_row().assert_zero(
                    b.mul(b.sub(b.constant(1), flag),
                          b.public_value(4 * i + k)))
            b.push_receive(
                PV_BUS,
                [b.constant(i)]
                + [b.public_value(4 * i + k) for k in range(N_LIMBS)],
                b.mul(is_first, flag),
            )


# ---------------------------------------------------------------------------
# Program ROM / boundaries / tables
# ---------------------------------------------------------------------------


class ProgramAirV2(Air):
    """Preprocessed decoded program ROM: (pc, kind+1, rs1, rs2, rd,
    imm limbs, target); main trace = execution-count multiplicity."""

    P_PC = 0
    P_KID = 1
    P_RS1, P_RS2, P_RD = 2, 3, 4
    P_IMM = 5       # 4
    P_TARGET = 9
    preprocessed_width = 10
    MULT = 0
    width = 1
    num_public_values = 0

    def __init__(self, program_words=None):
        self.program_words = list(program_words or [])

    def eval(self, b: AirBuilder) -> None:
        P_ = ProgramAirV2
        fields = [b.preprocessed(c) for c in range(P_.preprocessed_width)]
        b.push_receive(PROGRAM_BUS, fields, b.local(P_.MULT))

    def preprocessed_trace(self) -> np.ndarray:
        words = self.program_words
        n_prog = max(4, 1 << (max(len(words), 1) - 1).bit_length())
        pre = np.zeros((n_prog, self.preprocessed_width), dtype=np.uint32)
        for j in range(n_prog):
            pre[j, self.P_PC] = 4 * j
            if j < len(words):
                try:
                    kind, rs1, rs2, rd, imm, boff = decode_v2(words[j])
                except ValueError:
                    continue
                pre[j, self.P_KID] = kind + 1
                pre[j, self.P_RS1] = rs1
                pre[j, self.P_RS2] = rs2
                pre[j, self.P_RD] = rd
                for k, v in enumerate(_limbs(imm)):
                    pre[j, self.P_IMM + k] = v
                if kind in (K_BEQ, K_BNE, K_BLT, K_BGE, K_BLTU, K_BGEU,
                            K_JAL):
                    tgt = 4 * j + boff
                    assert 0 <= tgt < 1 << 24
                    pre[j, self.P_TARGET] = tgt
        return pre


class ExecBoundaryAirV2(Air):
    """Opens the execution chain at (pc=0, ts=1). pvs[0] = IS_HALTED: when 1,
    no witnessed-close rows are allowed, so the chain can only terminate in a
    SystemAir HALT row (exit code 0). When 0, one is_fin row closes at the
    witnessed (pc, ts) — the paused-segment (continuations) case."""

    IS_INIT = 0
    IS_FIN = 1
    FIN_PC = 2
    FIN_TS = 3
    width = 4
    num_public_values = 1

    def eval(self, b: AirBuilder) -> None:
        E = ExecBoundaryAirV2
        is_init = b.local(E.IS_INIT)
        is_fin = b.local(E.IS_FIN)
        b.assert_bool(is_init)
        b.assert_bool(is_fin)
        b.when_first_row().assert_eq(is_init, b.constant(1))
        b.when_transition().assert_zero(b.next(E.IS_INIT))
        halted = b.public_value(0)
        b.assert_zero(b.mul(is_fin, halted))
        b.push_send(EXEC_BUS, [b.constant(0), b.constant(1)], is_init)
        b.push_receive(EXEC_BUS, [b.local(E.FIN_PC), b.local(E.FIN_TS)],
                       is_fin)


class RamBoundaryAirV2(Air):
    """Opens/closes the RAM chains per touched word address (initial value
    zero: guest data must live above the program image). Addresses are
    single-felt keys (LoadStoreAir bounds them < 2^31 - 2^27)."""

    B_IS_REAL = 0
    B_ADDR = 1
    B_FINAL_TS = 2
    B_FINAL_VAL = 3  # 4
    width = 7
    num_public_values = 0

    def eval(self, b: AirBuilder) -> None:
        R_ = RamBoundaryAirV2
        real = b.local(R_.B_IS_REAL)
        b.assert_bool(real)
        addr = b.local(R_.B_ADDR)
        zero = b.constant(0)
        b.push_send(MEM_BUS, [addr, zero, zero, zero, zero, zero], real)
        b.push_receive(
            MEM_BUS,
            [addr, b.local(R_.B_FINAL_TS)]
            + [b.local(R_.B_FINAL_VAL + k) for k in range(N_LIMBS)],
            real,
        )


class XorTableAir(Air):
    """256x256 byte XOR lookup (preprocessed x, y, x^y; main = mult).
    AND/OR derive from XOR via x + y = (x^y) + 2*(x&y)."""

    P_X, P_Y, P_XOR = 0, 1, 2
    preprocessed_width = 3
    MULT = 0
    width = 1
    num_public_values = 0

    def eval(self, b: AirBuilder) -> None:
        X_ = XorTableAir
        b.push_receive(
            XOR_BUS,
            [b.preprocessed(X_.P_X), b.preprocessed(X_.P_Y),
             b.preprocessed(X_.P_XOR)],
            b.local(X_.MULT),
        )

    def preprocessed_trace(self) -> np.ndarray:
        x = np.repeat(np.arange(256, dtype=np.uint32), 256)
        y = np.tile(np.arange(256, dtype=np.uint32), 256)
        return np.stack([x, y, x ^ y], axis=1)


class Range16TableAir(Air):
    """2^16-row range table (preprocessed counter; main = mult).

    Serves the LOW 16 bits of every offline-memory-checking timestamp
    diff; the high byte goes through the byte table, so diffs span 24
    bits and a memory location only needs to be re-accessed within 2^24
    timestamps (segment cap ~2^24/TS_STRIDE cycles — the openvm
    range-checker-chip analog, vs the earlier 2-byte/16-bit diffs that
    capped segments at ~13k cycles)."""

    P_V = 0
    preprocessed_width = 1
    MULT = 0
    width = 1
    num_public_values = 0

    def eval(self, b: AirBuilder) -> None:
        b.push_receive(RANGE16_BUS, [b.preprocessed(Range16TableAir.P_V)],
                       b.local(Range16TableAir.MULT))

    def preprocessed_trace(self) -> np.ndarray:
        return np.arange(1 << 16, dtype=np.uint32).reshape(-1, 1)


# ---------------------------------------------------------------------------
# Trace generation (host-side by design; SURVEY.md §2.2)
# ---------------------------------------------------------------------------

ALU_SET = set(ALU_KINDS)
BRANCH_SET = set(BRANCH_KINDS)
JUMP_SET = set(JUMP_KINDS)
LS_SET = set(LS_KINDS)
SHIFT_SET = set(SHIFT_KINDS)
MUL_SET = set(MUL_KINDS)
DIV_SET = set(DIV_KINDS)

READS_RS1 = (ALU_SET | BRANCH_SET | LS_SET | SHIFT_SET | MUL_SET | DIV_SET
             | {K_JALR})
READS_RS2 = (BRANCH_SET | MUL_SET | DIV_SET
             | {K_ADD, K_SUB, K_AND, K_OR, K_XOR, K_SLT, K_SLTU,
                K_SLL, K_SRL, K_SRA, K_SB, K_SH, K_SW})
WRITES_RD = (ALU_SET | JUMP_SET | SHIFT_SET | MUL_SET | DIV_SET
             | {K_LB, K_LH, K_LW, K_LBU, K_LHU})


class _TraceState:
    def __init__(self, data_base: int):
        self.last_ts = np.zeros(32, dtype=np.int64)
        self.last_val = np.zeros(32, dtype=np.int64)
        self.ram: Dict[int, Tuple[int, int]] = {}
        self.byte_counts = np.zeros(256, dtype=np.int64)
        self.r16_counts = np.zeros(1 << 16, dtype=np.int64)
        self.xor_counts: Dict[Tuple[int, int], int] = {}
        self.data_base = data_base
        self.fin_pc = 0
        self.fin_ts = 1
        self.halted = False
        self.pv_words = [0] * N_PV_WORDS
        self.pv_counts = [0] * N_PV_WORDS

    def bcheck(self, v: int) -> int:
        assert 0 <= v < 256, f"byte out of range: {v}"
        self.byte_counts[v] += 1
        return v

    def r16check(self, v: int) -> int:
        assert 0 <= v < (1 << 16), f"u16 out of range: {v}"
        self.r16_counts[v] += 1
        return v

    def xcheck(self, x: int, y: int) -> int:
        self.xor_counts[(x, y)] = self.xor_counts.get((x, y), 0) + 1
        return x ^ y


def _sign(v: int) -> int:
    return (v >> 31) & 1


def _s32(v: int) -> int:
    return v - (1 << 32) if v >= (1 << 31) else v


def _fill_common(row, st: _TraceState, kind, kinds, pc, ts, rs1, rs2, rd,
                 imm, target, rs1_v, rs2_v, rd_v):
    row[IS_REAL] = 1
    row[FLAGS + kinds.index(kind)] = 1
    row[PC], row[TS] = pc, ts
    row[RS1_IDX], row[RS2_IDX], row[RD_IDX] = rs1, rs2, rd
    for k, v in enumerate(_limbs(imm)):
        row[IMM + k] = v
    row[TARGET] = target

    def _port(idx, cur_ts, val, prev_ts_col, dk, is_write):
        row[prev_ts_col] = st.last_ts[idx]
        if is_write:
            for k, v in enumerate(_limbs(int(st.last_val[idx]))):
                row[RD_PREV_VAL + k] = v
        else:
            assert st.last_val[idx] == val, "executor/trace divergence"
        d = cur_ts - st.last_ts[idx] - 1
        row[DIFF + dk] = st.r16check(d & 0xFFFF)
        row[DIFF + dk + 1] = st.bcheck(d >> 16)
        st.last_ts[idx] = cur_ts
        if is_write:
            st.last_val[idx] = val

    if kind in READS_RS1:
        for k, v in enumerate(_limbs(rs1_v)):
            row[RS1_VAL + k] = v
        _port(rs1, ts, rs1_v, RS1_PREV_TS, 0, False)
    if kind in READS_RS2:
        for k, v in enumerate(_limbs(rs2_v)):
            row[RS2_VAL + k] = v
        _port(rs2, ts + 1, rs2_v, RS2_PREV_TS, 2, False)
    if kind in WRITES_RD:
        assert rd != 0, "v2 requires rd != x0 for writes"
        for k, v in enumerate(_limbs(rd_v)):
            row[RD_VAL + k] = st.bcheck(v)
        _port(rd, ts + 2, rd_v, RD_PREV_TS, 4, True)


def _fill_cmp_chain(row, st, d_col, b_col, lhs_limbs, rhs_limbs):
    """Borrow chain witness; returns final borrow (lhs <u rhs)."""
    bor = 0
    for k in range(N_LIMBS):
        v = lhs_limbs[k] - rhs_limbs[k] - bor
        bor = 1 if v < 0 else 0
        row[d_col + k] = st.bcheck(v + 256 * bor)
        row[b_col + k] = bor
    return bor


def _fill_sign(row, st, sign_col, rest_col, val3):
    s = val3 >> 7
    row[sign_col] = s
    row[rest_col] = val3 - 128 * s
    st.bcheck(2 * (val3 - 128 * s))
    return s


def _fill_alu(row, st, kind, rs1_v, rs2_v, rd_v, imm):
    C = AluAir
    use_imm = kind in (K_ADDI, K_ANDI, K_ORI, K_XORI, K_SLTI, K_SLTIU)
    ob = imm if use_imm else rs2_v
    al, obl = _limbs(rs1_v), _limbs(ob)
    if kind in (K_ADD, K_ADDI):
        carry = 0
        for k in range(N_LIMBS):
            carry = (al[k] + obl[k] + carry) >> 8
            row[C.CARRY + k] = carry
    elif kind == K_SUB:
        bor = 0
        for k in range(N_LIMBS):
            bor = 1 if al[k] - obl[k] - bor < 0 else 0
            row[C.CARRY + k] = bor
    elif kind in (K_AND, K_ANDI, K_OR, K_ORI, K_XOR, K_XORI):
        for k in range(N_LIMBS):
            row[C.X + k] = st.xcheck(al[k], obl[k])
    else:  # SLT family
        signed = kind in (K_SLT, K_SLTI)
        lhs, rhs = list(al), list(obl)
        if signed:
            sa = _fill_sign(row, st, C.SA, C.A3R, al[3])
            sb = _fill_sign(row, st, C.SB, C.B3R, obl[3])
            lhs[3] += 128 - 256 * sa
            rhs[3] += 128 - 256 * sb
        lt = _fill_cmp_chain(row, st, C.CMP_D, C.CMP_B, lhs, rhs)
        assert lt == rd_v, "SLT witness/executor divergence"


def _fill_branch(row, st, kind, rs1_v, rs2_v, pc, target):
    C = BranchAir
    al, bl = _limbs(rs1_v), _limbs(rs2_v)
    s_val = sum((al[k] - bl[k]) ** 2 for k in range(N_LIMBS)) % bb.P
    if s_val == 0:
        row[C.IS_EQ], row[C.S_INV] = 1, 0
    else:
        row[C.IS_EQ], row[C.S_INV] = 0, pow(s_val, bb.P - 2, bb.P)
    lt = 0
    if kind in (K_BLT, K_BGE, K_BLTU, K_BGEU):
        signed = kind in (K_BLT, K_BGE)
        lhs, rhs = list(al), list(bl)
        if signed:
            sa = _fill_sign(row, st, C.SA, C.A3R, al[3])
            sb = _fill_sign(row, st, C.SB, C.B3R, bl[3])
            lhs[3] += 128 - 256 * sa
            rhs[3] += 128 - 256 * sb
        lt = _fill_cmp_chain(row, st, C.CMP_D, C.CMP_B, lhs, rhs)
    taken = {
        K_BEQ: rs1_v == rs2_v, K_BNE: rs1_v != rs2_v,
        K_BLT: lt == 1, K_BLTU: lt == 1,
        K_BGE: lt == 0, K_BGEU: lt == 0,
    }[kind]
    row[C.IS_TAKEN] = int(taken)
    next_pc = target if taken else pc + 4
    row[C.NEXT_PC] = next_pc
    return next_pc


def _fill_jump(row, st, kind, rs1_v, pc, imm, target):
    C = JumpAir
    if kind == K_JAL:
        next_pc = target
    elif kind == K_JALR:
        addr = (rs1_v + imm) % (1 << 32)
        assert addr < (1 << 24), "JALR target must be < 2^24"
        carry = 0
        al, il = _limbs(rs1_v), _limbs(imm)
        for k in range(N_LIMBS):
            carry = (al[k] + il[k] + carry) >> 8
            row[C.CARRY + k] = carry
        for k, v in enumerate(_limbs(addr)):
            row[C.ADDR + k] = v
        for k in range(3):
            st.bcheck(_limbs(addr)[k])
        row[C.B0] = addr & 1
        row[C.H0] = (addr & 0xFF) >> 1
        st.bcheck(2 * row[C.H0])
        next_pc = addr & ~1
    elif kind == K_LUI:
        next_pc = pc + 4
    else:  # AUIPC
        assert pc < (1 << 24)
        pl, il = _limbs(pc), _limbs(imm)
        for k in range(N_LIMBS):
            row[C.PCL + k] = pl[k]
        for k in range(3):
            st.bcheck(pl[k])
        carry = 0
        for k in range(N_LIMBS):
            carry = (pl[k] + il[k] + carry) >> 8
            row[C.CARRY + k] = carry
        next_pc = pc + 4
    row[C.NEXT_PC] = next_pc
    return next_pc


def _fill_loadstore(row, st, kind, ts, rs1_v, rs2_v, rd_v, imm, mem_addr):
    C = LoadStoreAir
    addr = (rs1_v + imm) % (1 << 32)
    assert addr == mem_addr, "executor/trace address divergence"
    ofs = addr & 3
    waddr = addr - ofs
    assert waddr >= st.data_base, "RAM access below the data base"
    carry = 0
    al, il = _limbs(rs1_v), _limbs(imm)
    for k in range(N_LIMBS):
        carry = (al[k] + il[k] + carry) >> 8
        row[C.CARRY + k] = carry
    for k, v in enumerate(_limbs(addr)):
        row[C.ADDR + k] = st.bcheck(v)
    st.bcheck(_limbs(addr)[3] + 136)  # addr < 2^31 - 2^27 (felt-injective)
    row[C.Q0] = (addr & 0xFF) >> 2
    st.bcheck(4 * row[C.Q0])
    row[C.O0], row[C.O1] = ofs & 1, ofs >> 1
    row[C.IND + ofs] = 1

    prev_ts, w_old = st.ram.get(waddr, (0, 0))
    wl = _limbs(w_old)
    for k in range(N_LIMBS):
        row[C.W_OLD + k] = st.bcheck(wl[k])

    if kind in (K_LB, K_LBU):
        sel = wl[ofs]
        if kind == K_LB:
            sgn = sel >> 7
            row[C.SGN], row[C.SREM] = sgn, sel & 0x7F
            st.bcheck(2 * (sel & 0x7F))
            expect = sel | (0xFFFFFF00 if sgn else 0)
        else:
            expect = sel
        assert rd_v == expect, "load byte divergence"
        w_new = w_old
    elif kind in (K_LH, K_LHU):
        lo, hi = wl[ofs], wl[ofs + 1]
        if kind == K_LH:
            sgn = hi >> 7
            row[C.SGN], row[C.SREM] = sgn, hi & 0x7F
            st.bcheck(2 * (hi & 0x7F))
            expect = lo | (hi << 8) | (0xFFFF0000 if sgn else 0)
        else:
            expect = lo | (hi << 8)
        assert rd_v == expect, "load half divergence"
        w_new = w_old
    elif kind == K_LW:
        assert rd_v == w_old, "load word divergence"
        w_new = w_old
    else:  # stores
        sl = _limbs(rs2_v)
        nl = list(wl)
        if kind == K_SB:
            nl[ofs] = sl[0]
        elif kind == K_SH:
            nl[ofs], nl[ofs + 1] = sl[0], sl[1]
        else:
            nl = sl
        w_new = sum(v << (8 * k) for k, v in enumerate(nl))
    for k, v in enumerate(_limbs(w_new)):
        row[C.W_NEW + k] = v
    row[C.MEM_PREV_TS] = prev_ts
    d = ts + 3 - prev_ts - 1
    row[C.MDIFF] = st.r16check(d & 0xFFFF)
    row[C.MDIFF + 1] = st.bcheck(d >> 16)
    st.ram[waddr] = (ts + 3, w_new)


def _fill_pos_carries(row, st, col, sums, outs):
    """Position equations: sums[t] + carry_in = outs[t] + 256*carry_out for
    t = 0..6 (t=7 closes). Writes 7 two-byte carries, byte-counted."""
    carry = 0
    for t in range(7):
        total = sums[t] + carry
        carry = (total - outs[t]) >> 8
        assert 0 <= carry < (1 << 16)
        row[col + 2 * t] = st.bcheck(carry & 0xFF)
        row[col + 2 * t + 1] = st.bcheck(carry >> 8)
    assert sums[7] + carry == outs[7], "position chain mismatch"


def _fill_shift(row, st, kind, rs1_v, rs2_v, rd_v, imm):
    C = ShiftAir
    is_reg = kind in (K_SLL, K_SRL, K_SRA)
    shamt = (rs2_v & 31) if is_reg else imm
    if is_reg:
        row[C.B0HI] = (rs2_v & 0xFF) >> 5
        st.bcheck(32 * row[C.B0HI])
    for j in range(5):
        row[C.S_BITS + j] = (shamt >> j) & 1
    s0, s1, s2 = shamt & 1, (shamt >> 1) & 1, (shamt >> 2) & 1
    row[C.T_A] = (1 + s0) * (1 + 3 * s1)
    row[C.P2T] = row[C.T_A] * (1 + 15 * s2)
    row[C.T_AI] = (2 - s0) * (4 - 3 * s1)
    row[C.P2TI] = row[C.T_AI] * (16 - 15 * s2)
    pw = _limbs(1 << shamt)
    pwi = _limbs(1 << (31 - shamt))
    for k in range(N_LIMBS):
        row[C.PW + k] = st.bcheck(pw[k])
        row[C.PWI + k] = st.bcheck(pwi[k])

    al = _limbs(rs1_v)
    if kind in (K_SLL, K_SLLI):
        full = rs1_v << shamt
        rdl = _limbs(full % (1 << 32))
        hil = _limbs(full >> 32)
        for k in range(N_LIMBS):
            row[C.HI + k] = st.bcheck(hil[k])
        assert rd_v == full % (1 << 32)
        sums = [sum(al[i] * pw[t - i]
                    for i in range(max(0, t - 3), min(4, t + 1)))
                for t in range(8)]
        outs = rdl + hil
        _fill_pos_carries(row, st, C.POS_C, sums, outs)
    else:
        is_sra = kind in (K_SRA, K_SRAI)
        sa = 0
        if is_sra:
            sa = _fill_sign(row, st, C.SA, C.A3R, al[3])
        u = rs1_v ^ (0x80000000 if is_sra else 0)
        rdu = u >> shamt
        rem = u & ((1 << shamt) - 1)
        rdul, reml, ul = _limbs(rdu), _limbs(rem), _limbs(u)
        for k in range(N_LIMBS):
            row[C.RDU + k] = st.bcheck(rdul[k])
            row[C.REM + k] = st.bcheck(reml[k])
        sums = [sum(rdul[i] * pw[t - i]
                    for i in range(max(0, t - 3), min(4, t + 1)))
                + (reml[t] if t < 4 else 0)
                for t in range(8)]
        outs = ul + [0, 0, 0, 0]
        _fill_pos_carries(row, st, C.POS_C, sums, outs)
        lt = _fill_cmp_chain(row, st, C.RCH_D, C.RCH_B, reml, pw)
        assert lt == 1
        # bias subtraction rd = rdu - is_sra * 2^(31-s)
        expect = (rdu - (pwi_val := (1 << (31 - shamt)) if is_sra else 0)) \
            % (1 << 32)
        assert rd_v == expect, "right-shift divergence"
        rdl = _limbs(rd_v)
        sub_l = _limbs(pwi_val)
        bor = 0
        for k in range(N_LIMBS):
            prev = bor
            bor = 1 if rdul[k] - sub_l[k] - prev < 0 else 0
            row[C.BR + k] = bor
            assert rdul[k] - sub_l[k] - prev - rdl[k] + 256 * bor == 0


def _fill_mul(row, st, kind, rs1_v, rs2_v, rd_v):
    C = MulAir
    al, bl = _limbs(rs1_v), _limbs(rs2_v)
    full = rs1_v * rs2_v
    cl = [(full >> (8 * t)) & 0xFF for t in range(8)]
    for t in range(8):
        row[C.CL + t] = st.bcheck(cl[t])
    carry = 0
    for t in range(6):
        total = sum(al[i] * bl[t - i]
                    for i in range(max(0, t - 3), min(4, t + 1))) + carry
        carry = (total - cl[t]) >> 8
        row[C.PCAR + 2 * t] = st.bcheck(carry & 0xFF)
        row[C.PCAR + 2 * t + 1] = st.bcheck(carry >> 8)
    assert al[3] * bl[3] + carry == cl[6] + 256 * cl[7]

    sa = sb = 0
    if kind in (K_MULH, K_MULHSU):
        sa = _fill_sign(row, st, C.SA, C.A3R, al[3])
    if kind == K_MULH:
        sb = _fill_sign(row, st, C.SB, C.B3R, bl[3])
    row[C.SA_F], row[C.SB_F] = sa, sb
    if kind == K_MUL:
        assert rd_v == full % (1 << 32)
    else:
        rdl = _limbs(rd_v)
        bor = 0
        for t in range(N_LIMBS):
            v = cl[4 + t] - sa * bl[t] - sb * al[t] - bor
            bor = (rdl[t] - v) >> 8
            assert 0 <= bor <= 2 and v + 256 * bor == rdl[t]
            row[C.BW + t] = bor


def _fill_divrem(row, st, kind, rs1_v, rs2_v, rd_v):
    C = DivRemAir
    signed = kind in (K_DIV, K_REM)
    a_s, b_s = (_s32(rs1_v), _s32(rs2_v)) if signed else (rs1_v, rs2_v)
    if rs2_v == 0:
        q, r = 0xFFFFFFFF, rs1_v
    elif signed and rs1_v == 0x80000000 and rs2_v == 0xFFFFFFFF:
        q, r = 0x80000000, 0
    else:
        qm_i, rm_i = divmod(abs(a_s), abs(b_s))
        q_s = -qm_i if (a_s < 0) != (b_s < 0) else qm_i
        r_s = -rm_i if a_s < 0 else rm_i
        q, r = q_s % (1 << 32), r_s % (1 << 32)
    assert rd_v == (q if kind in (K_DIV, K_DIVU) else r), "div/rem diverge"

    sa = sb = 0
    if signed:
        sa = _fill_sign(row, st, C.SA, C.A3R, _limbs(rs1_v)[3])
        sb = _fill_sign(row, st, C.SB, C.B3R, _limbs(rs2_v)[3])
    na, nb, nq = (sa, sb, sa ^ sb) if signed else (0, 0, 0)
    row[C.NA], row[C.NB], row[C.NQ] = na, nb, nq

    def mag(v, neg):
        return ((1 << 32) - v) % (1 << 32) if neg else v

    am, bm = mag(rs1_v, na), mag(rs2_v, nb)
    qm, rm = mag(q, nq), mag(r, na)
    for base, v in ((C.Q, q), (C.R, r), (C.AM, am), (C.BM, bm),
                    (C.QM, qm), (C.RM, rm)):
        for k, limb in enumerate(_limbs(v)):
            row[base + k] = st.bcheck(limb)

    # negation-link carries
    for (x, xm, neg), coff in (((rs1_v, am, na), 0), ((rs2_v, bm, nb), 4),
                               ((q, qm, nq), 8), ((r, rm, na), 12)):
        if neg:
            xl, xml = _limbs(x), _limbs(xm)
            carry = 0
            for k in range(N_LIMBS):
                carry = (xl[k] + xml[k] + carry) >> 8
                row[C.NC + coff + k] = carry

    # product carries: bm*qm + rm = am (high positions zero)
    bml, qml, rml, aml = _limbs(bm), _limbs(qm), _limbs(rm), _limbs(am)
    carry = 0
    for t in range(6):
        total = sum(bml[i] * qml[t - i]
                    for i in range(max(0, t - 3), min(4, t + 1))) + carry
        if t < 4:
            total += rml[t]
        out = aml[t] if t < 4 else 0
        carry = (total - out) >> 8
        assert carry >= 0
        row[C.PCAR + 2 * t] = st.bcheck(carry & 0xFF)
        row[C.PCAR + 2 * t + 1] = st.bcheck(carry >> 8)
    assert bml[3] * qml[3] + carry == 0, "magnitude identity overflow"

    bsum = sum(_limbs(rs2_v))
    if bsum == 0:
        row[C.BZ], row[C.BINV] = 1, 0
    else:
        row[C.BZ] = 0
        row[C.BINV] = pow(bsum, bb.P - 2, bb.P)
        lt = _fill_cmp_chain(row, st, C.LT_D, C.LT_B, rml, bml)
        assert lt == 1, "remainder >= divisor"


def _fill_system(row, st: _TraceState, pc: int, ts: int, rd_val: int):
    """ECALL row: variant from the tracked a7. Returns (next_pc, ext)
    where next_pc is None for halt and ext is (a7, args) for the extension
    syscalls a7 in {3: keccak, 4: modop, 5: ec_add, 6: sha256} (the caller
    fills the extension-chip rows)."""
    C = SystemAir
    row[IS_REAL] = 1
    row[PC], row[TS] = pc, ts
    a0 = int(st.last_val[10])
    a1 = int(st.last_val[11])
    a2 = int(st.last_val[12])
    a3 = int(st.last_val[13])
    a7 = int(st.last_val[17])

    def port(idx, prev_ts_col, cur_ts, d_col, new_val=None):
        row[prev_ts_col] = st.last_ts[idx]
        d = cur_ts - int(st.last_ts[idx]) - 1
        row[d_col] = st.r16check(d & 0xFFFF)
        row[d_col + 1] = st.bcheck(d >> 16)
        st.last_ts[idx] = cur_ts
        if new_val is not None:
            st.last_val[idx] = new_val

    port(17, C.A7_PREV_TS, ts, C.A7_D)
    if a7 == 0:  # HALT
        row[C.F_HALT] = 1
        assert a0 == 0, "provable halt requires exit code 0"
        port(10, C.A0_PREV_TS, ts + 1, C.A0_D)
        st.halted = True
        return None, None
    if a7 == 1:  # HINT_READ
        row[C.F_HINT] = 1
        for k, v in enumerate(_limbs(a0)):
            row[C.H_PREV_VAL + k] = v
        for k, v in enumerate(_limbs(rd_val)):
            row[C.H_VAL + k] = st.bcheck(v)
        port(10, C.H_PREV_TS, ts + 1, C.H_D, new_val=rd_val)
        return pc + 4, None
    if a7 == 8:  # DEFER: bind 64 bytes (vk digest || pi digest) at a0
        row[C.F_DEFER] = 1
        for k, v in enumerate(_limbs(a0)):
            row[C.A0_VAL + k] = v
        port(10, C.A0_PREV_TS, ts + 1, C.A0_D)
        return pc + 4, (8, (a0,))
    if a7 in (3, 4, 5, 6, 7, 9):  # KECCAK/MODOP/EC_ADD/SHA256/EC_DBL/FP2
        row[{3: C.F_KECCAK, 4: C.F_MOD, 5: C.F_EC, 6: C.F_SHA,
             7: C.F_DBL, 9: C.F_FP2}[a7]] = 1
        for k, v in enumerate(_limbs(a0)):
            row[C.A0_VAL + k] = v
        port(10, C.A0_PREV_TS, ts + 1, C.A0_D)
        for k, v in enumerate(_limbs(a1)):
            row[C.A1_VAL + k] = v
        port(11, C.A1_PREV_TS, ts + 2, C.A1_D)
        for k, v in enumerate(_limbs(a2)):
            row[C.A2_VAL + k] = v
        port(12, C.A2_PREV_TS, ts + 3, C.A2_D)
        if a7 in (4, 5, 7, 9):  # selector register
            for k, v in enumerate(_limbs(a3)):
                row[C.A3_VAL + k] = v
            port(13, C.A3_PREV_TS, ts + 4, C.A3_D)
            if a7 == 7:  # ec_double: a2 read but unused
                return pc + 4, (a7, (a0, a1, a3))
            return pc + 4, (a7, (a0, a1, a2, a3))
        return pc + 4, (a7, (a0, a1, a2))
    assert a7 == 2, f"unknown syscall a7={a7}"
    row[C.F_REVEAL] = 1
    for k, v in enumerate(_limbs(a0)):
        row[C.A0_VAL + k] = v
    port(10, C.A0_PREV_TS, ts + 1, C.A0_D)
    assert 0 <= a1 < N_PV_WORDS, f"reveal index {a1} out of range"
    row[C.A1_VAL] = a1
    port(11, C.A1_PREV_TS, ts + 2, C.A1_D)
    st.pv_words[a1] = a0
    st.pv_counts[a1] += 1
    return pc + 4, None


_PAD_BRANCH = {BranchAir.IS_EQ: 1, BranchAir.NEXT_PC: 4}
_PAD_LS = {LoadStoreAir.IND: 1}
_PAD_SHIFT = {ShiftAir.T_A: 1, ShiftAir.P2T: 1, ShiftAir.PW: 1,
              ShiftAir.T_AI: 8, ShiftAir.P2TI: 128, ShiftAir.PWI + 3: 128}

_CHIPS = [
    ("alu", AluAir, ALU_SET, {}),
    ("shift", ShiftAir, SHIFT_SET, _PAD_SHIFT),
    ("branch", BranchAir, BRANCH_SET, _PAD_BRANCH),
    ("jump", JumpAir, JUMP_SET, {}),
    ("loadstore", LoadStoreAir, LS_SET, _PAD_LS),
    ("mul", MulAir, MUL_SET, {}),
    ("divrem", DivRemAir, DIV_SET, {}),
    ("system", SystemAir, {K_ECALL}, {}),
]
_CHIP_KINDS = {"alu": ALU_KINDS, "shift": SHIFT_KINDS,
               "branch": BRANCH_KINDS, "jump": JUMP_KINDS,
               "loadstore": LS_KINDS, "mul": MUL_KINDS,
               "divrem": DIV_KINDS, "system": (K_ECALL,)}
CHIP_OF_KIND = {}
for _name, _air, _set, _ in _CHIPS:
    for _k in _set:
        CHIP_OF_KIND[_k] = _name


def _stack_rows(rows, width: int) -> np.ndarray:
    """A chip's rows stacked into a trace of max(4, next power of two) rows,
    zero-padded."""
    tr = np.zeros((max(4, 1 << (len(rows) - 1).bit_length()), width), dtype=np.uint32)
    if rows:
        tr[:len(rows)] = rows
    return tr


def generate_traces(program_words: List[int], records: np.ndarray,
                    data_base: int = 0x2000, init_regs=None, init_ram=None,
                    init_pc: int = 0, core_only: bool = False):
    """Build all chip traces for a v2 execution from the executor's records.
    Returns (Air, trace, public_values) triples.

    A continuation segment (models/rv32_continuations.py) passes its
    boundary state: `init_regs` (32 register values), `init_ram`
    ({word_addr: value} of the touched words' values before the segment),
    `init_pc`, and `core_only=True` to get back `(partial_out, state)`:
    the instruction chips, the syscall chips, the program ROM and the PV
    chip only, so that the caller attaches its own boundary AIRs before
    `finish_tables` emits the byte, xor and range tables."""
    st = _TraceState(data_base)
    if init_regs is not None:
        st.last_val[:] = np.asarray(init_regs, dtype=np.int64)
    if init_ram:
        for a, v in init_ram.items():
            st.ram[int(a)] = (0, int(v))
    st.fin_pc = init_pc
    rows: Dict[str, list] = {name: [] for name, *_ in _CHIPS}
    keccak_rows: list = []
    keccak_states: list = []
    mod_rows: list = []
    ec_rows: list = []
    dbl_rows: list = []
    bigint_ops: list = []   # (a, b, c, m) requests BigIntModMulAir serves
    ec_adds: list = []      # ((x1,y1), (x2,y2), m) requests EcAddAir serves
    ec_doubles: list = []   # ((x1,y1), m) requests EcDoubleAir serves
    sha_rows: list = []
    sha_blocks: list = []   # (h_in, block_words) Sha256Air compressions
    fp2_rows: list = []
    defer_rows: list = []
    defer_p2_inputs: list = []  # (16,) canonical Poseidon2Air requests
    defer_acc = np.zeros(8, dtype=np.uint32)  # running deferral digest

    ts_counter = 1  # running timestamp (ext-chip rows consume wide windows)
    for i in range(len(records)):
        pc, instr, rs1_v, rs2_v, rd_v, mem_addr, _ = (
            int(x) for x in records[i])
        kind, rs1, rs2, rd, imm, boff = decode_v2(instr)
        name = CHIP_OF_KIND[kind]
        air_cls = dict((n, a) for n, a, *_ in _CHIPS)[name]
        row = np.zeros(air_cls.width, dtype=np.uint32)
        ts = ts_counter
        ts_counter += TS_STRIDE
        if name == "system":
            assert not st.halted, "records continue past a halt"
            next_pc, ext = _fill_system(row, st, pc, ts, rd_v)
            rows[name].append(row)
            if next_pc is None:
                break
            if ext is not None and ext[0] == 3:
                from .keccak_vm import KECCAK_BLOCK_TS, fill_keccak_rows

                ptr, length, out_ptr = ext[1]
                krows, kstates = fill_keccak_rows(
                    st, pc, ts, ptr, length, out_ptr, lambda a: 0)
                keccak_rows += krows
                keccak_states += kstates
                ts_counter += KECCAK_BLOCK_TS * len(krows)
            elif ext is not None and ext[0] == 4:
                from .vm_ext import MOD_TS_WINDOW, fill_modop_row

                mrow, bops = fill_modop_row(st, pc, ts, *ext[1])
                mod_rows.append(mrow)
                bigint_ops.extend(bops)
                ts_counter += MOD_TS_WINDOW
            elif ext is not None and ext[0] == 5:
                from .vm_ext import EC_TS_WINDOW, fill_ec_row

                erow, eadd = fill_ec_row(st, pc, ts, *ext[1])
                ec_rows.append(erow)
                ec_adds.append(eadd)
                ts_counter += EC_TS_WINDOW
            elif ext is not None and ext[0] == 6:
                from .sha256_vm import SHA_BLOCK_TS, fill_sha256_rows

                ptr, length, out_ptr = ext[1]
                srows, sblocks = fill_sha256_rows(
                    st, pc, ts, ptr, length, out_ptr)
                sha_rows += srows
                sha_blocks += sblocks
                ts_counter += SHA_BLOCK_TS * len(srows)
            elif ext is not None and ext[0] == 7:
                from .vm_ext import DBL_TS_WINDOW, fill_ec_double_row

                drow, dbl = fill_ec_double_row(st, pc, ts, *ext[1])
                dbl_rows.append(drow)
                ec_doubles.append(dbl)
                ts_counter += DBL_TS_WINDOW
            elif ext is not None and ext[0] == 9:
                from .fp2_vm import FP2_TS_WINDOW, fill_fp2_row

                frow2, bops2 = fill_fp2_row(st, pc, ts, *ext[1])
                fp2_rows.append(frow2)
                bigint_ops.extend(bops2)
                ts_counter += FP2_TS_WINDOW
            elif ext is not None and ext[0] == 8:
                from .deferral_vm import DEFER_TS_WINDOW, fill_defer_row

                frow, defer_acc, p2_in = fill_defer_row(
                    st, pc, ts, ext[1][0], defer_acc)
                defer_rows.append(frow)
                defer_p2_inputs += p2_in
                ts_counter += DEFER_TS_WINDOW
            st.fin_pc, st.fin_ts = next_pc, ts_counter
            continue
        target = (pc + boff) if kind in BRANCH_SET | {K_JAL} else 0
        _fill_common(row, st, kind, _CHIP_KINDS[name], pc, ts, rs1, rs2, rd,
                     imm, target, rs1_v, rs2_v, rd_v)
        next_pc = pc + 4
        if name == "alu":
            _fill_alu(row, st, kind, rs1_v, rs2_v, rd_v, imm)
        elif name == "branch":
            next_pc = _fill_branch(row, st, kind, rs1_v, rs2_v, pc, target)
        elif name == "jump":
            next_pc = _fill_jump(row, st, kind, rs1_v, pc, imm, target)
        elif name == "loadstore":
            _fill_loadstore(row, st, kind, ts, rs1_v, rs2_v, rd_v, imm,
                            mem_addr)
        elif name == "shift":
            _fill_shift(row, st, kind, rs1_v, rs2_v, rd_v, imm)
        elif name == "mul":
            _fill_mul(row, st, kind, rs1_v, rs2_v, rd_v)
        elif name == "divrem":
            _fill_divrem(row, st, kind, rs1_v, rs2_v, rd_v)
        rows[name].append(row)
        st.fin_pc, st.fin_ts = next_pc, ts_counter

    assert all(c <= 1 for c in st.pv_counts), (
        "each PV word may be revealed at most once, got counts "
        f"{st.pv_counts}")

    out = []
    for name, air_cls, _kset, pad in _CHIPS:
        chip_rows = rows[name]
        tr = _stack_rows(chip_rows, air_cls.width)
        for j in range(len(chip_rows), tr.shape[0]):
            for col, v in pad.items():
                tr[j, col] = v
            if name == "branch":
                tr[j, BranchAir.NEXT_PC] = 4  # pc=0 padding: next = pc+4
        out.append((air_cls(), tr, []))

    # keccak syscall chips (present only when the program used them)
    if keccak_rows:
        from .keccak_air import NUM_ROUNDS, KeccakfAir
        from .keccak_vm import KeccakVmAir

        out.append((KeccakVmAir(), _stack_rows(keccak_rows, KeccakVmAir.width), []))
        n_perm_rows = NUM_ROUNDS * len(keccak_states)
        log_n = max(5, (n_perm_rows - 1).bit_length())
        kf = KeccakfAir(log_n=log_n)
        out.append((
            kf,
            kf.generate_trace(keccak_states, [1] * len(keccak_states)),
            [],
        ))

    # modular / EC / fp2 syscall chips (present only when the program used
    # them); every 256-bit request lands in one BigIntModMulAir, whose byte
    # range checks join the byte table's counts before it is built
    if mod_rows or ec_rows or dbl_rows or fp2_rows:
        from .bigint_air import BigIntModMulAir
        from .vm_ext import EC_NUM_COLS, MOD_NUM_COLS, EcVmAir, ModularVmAir

        if mod_rows:
            out.append((ModularVmAir(), _stack_rows(mod_rows, MOD_NUM_COLS), []))
        if ec_rows:
            from .ec_air import EcAddAir

            out.append((EcVmAir(), _stack_rows(ec_rows, EC_NUM_COLS), []))
            ec_trace, ec_requests = EcAddAir.generate_trace(ec_adds)
            out.append((EcAddAir(), ec_trace, []))
            bigint_ops = bigint_ops + ec_requests
        if fp2_rows:
            from .fp2_vm import FP2_NUM_COLS, Fp2VmAir

            out.append((Fp2VmAir(), _stack_rows(fp2_rows, FP2_NUM_COLS), []))
        if dbl_rows:
            from .ec_double import EcDoubleAir
            from .vm_ext import DBL_NUM_COLS, EcDoubleVmAir

            out.append((EcDoubleVmAir(), _stack_rows(dbl_rows, DBL_NUM_COLS), []))
            dbl_trace, dbl_requests = EcDoubleAir.generate_trace(ec_doubles)
            out.append((EcDoubleAir(), dbl_trace, []))
            bigint_ops = bigint_ops + dbl_requests
        bi_trace = BigIntModMulAir.generate_trace(bigint_ops)
        st.byte_counts += BigIntModMulAir.byte_lookups(bi_trace)
        out.append((BigIntModMulAir(), bi_trace, []))

    # sha256 syscall chips
    if sha_rows:
        from .sha256_air import NUM_ROUNDS as SHA_ROUNDS
        from .sha256_air import Sha256Air
        from .sha256_vm import SHA_NUM_COLS, Sha256VmAir

        out.append((Sha256VmAir(), _stack_rows(sha_rows, SHA_NUM_COLS), []))
        sa = Sha256Air(log_n=max(6, (SHA_ROUNDS * len(sha_blocks) - 1).bit_length()))
        out.append((sa, sa.generate_trace(sha_blocks, [1] * len(sha_blocks)), []))

    # deferral syscall chip (present only when the program deferred), with
    # the Poseidon2 chip that serves its sponge
    if defer_rows:
        from .deferral_vm import ACC_IN as D_ACC_IN
        from .deferral_vm import DIGEST as D_DIGEST
        from .deferral_vm import NUM_COLS as D_NUM_COLS
        from .deferral_vm import DeferralVmAir
        from .poseidon2_air import Poseidon2Air

        f_tr = _stack_rows(defer_rows, D_NUM_COLS)
        # padding rows thread the final accumulator through to the last
        # row, where the public-value binding reads it
        f_tr[len(defer_rows):, D_ACC_IN : D_ACC_IN + D_DIGEST] = defer_acc
        out.append((DeferralVmAir(), f_tr, [int(v) for v in defer_acc]))
        out.append((
            Poseidon2Air(),
            Poseidon2Air.generate_trace(
                np.asarray(defer_p2_inputs, dtype=np.uint32),
                [1] * len(defer_p2_inputs)),
            [],
        ))

    # program ROM
    program_air = ProgramAirV2(program_words)
    n_prog = program_air.preprocessed_trace().shape[0]
    n_rec = sum(len(r) for r in rows.values())
    exec_counts = (
        np.bincount((records[:n_rec, 0] // 4).astype(np.int64),
                    minlength=n_prog)
        if n_rec else np.zeros(n_prog, dtype=np.int64))
    prog = np.zeros((n_prog, ProgramAirV2.width), dtype=np.uint32)
    prog[:, ProgramAirV2.MULT] = exec_counts[:n_prog].astype(np.uint32)
    out.append((program_air, prog, []))

    # public values chip: limbs + per-word reveal flags
    pv_tr = np.zeros((4, PublicValuesAir.width), dtype=np.uint32)
    pv_tr[0, PublicValuesAir.IS_FIRST] = 1
    pv_list = [limb for w in st.pv_words for limb in _limbs(w)]
    pv_flags = [int(c) for c in st.pv_counts]
    out.append((PublicValuesAir(), pv_tr, pv_list + pv_flags))

    if core_only:
        return out, st

    # execution boundary (halted: the SystemAir halt row closed the chain)
    ex_tr = np.zeros((4, ExecBoundaryAirV2.width), dtype=np.uint32)
    ex_tr[0, ExecBoundaryAirV2.IS_INIT] = 1
    if not st.halted:
        ex_tr[3, ExecBoundaryAirV2.IS_FIN] = 1
        ex_tr[3, ExecBoundaryAirV2.FIN_PC] = st.fin_pc
        ex_tr[3, ExecBoundaryAirV2.FIN_TS] = st.fin_ts
    out.append((ExecBoundaryAirV2(), ex_tr, [1 if st.halted else 0]))

    # RAM boundary (touched word addresses)
    n_ram = max(4, 1 << (max(len(st.ram), 1) - 1).bit_length())
    ram_tr = np.zeros((n_ram, RamBoundaryAirV2.width), dtype=np.uint32)
    for j, (addr, (fts, fval)) in enumerate(sorted(st.ram.items())):
        ram_tr[j, RamBoundaryAirV2.B_IS_REAL] = 1
        ram_tr[j, RamBoundaryAirV2.B_ADDR] = addr
        ram_tr[j, RamBoundaryAirV2.B_FINAL_TS] = fts
        for k, v in enumerate(_limbs(fval)):
            ram_tr[j, RamBoundaryAirV2.B_FINAL_VAL + k] = v
    out.append((RamBoundaryAirV2(), ram_tr, []))

    # register boundary
    mem = np.zeros((32, MemoryBoundaryAir.width), dtype=np.uint32)
    for r in range(32):
        mem[r, MemoryBoundaryAir.ADDR] = r
        mem[r, MemoryBoundaryAir.FINAL_TS] = st.last_ts[r]
        for k, v in enumerate(_limbs(int(st.last_val[r]))):
            mem[r, MemoryBoundaryAir.FINAL_VAL + k] = v
    out.append((MemoryBoundaryAir(), mem, []))

    return finish_tables(out, st)


def finish_tables(out, st: _TraceState):
    """Append the byte/xor lookup tables — LAST, after every other trace has
    registered its byte-range/xor counts into the shared state."""
    byte = np.zeros((256, ByteTableAir.width), dtype=np.uint32)
    byte[:, ByteTableAir.VALUE] = np.arange(256)
    byte[:, ByteTableAir.MULT] = st.byte_counts % bb.P
    out.append((ByteTableAir(), byte, []))

    xor_air = XorTableAir()
    xt = np.zeros((1 << 16, XorTableAir.width), dtype=np.uint32)
    for (x, y), c in st.xor_counts.items():
        xt[x * 256 + y, XorTableAir.MULT] = c % bb.P
    out.append((xor_air, xt, []))

    r16 = np.zeros((1 << 16, Range16TableAir.width), dtype=np.uint32)
    r16[:, Range16TableAir.MULT] = (st.r16_counts % bb.P).astype(np.uint32)
    out.append((Range16TableAir(), r16, []))

    return out


def execute_and_trace(program_words: List[int], max_cycles: int = 1 << 12,
                      data_base: int = 0x2000):
    """Run the native executor, truncate at the first non-v2 record, and
    build all chip traces (ECALL rows included via SystemAir)."""
    ex = Rv32Executor()
    ex.load_program(program_words)
    state = ex.run(max_cycles)
    records = ex.records()
    keep = 0
    for i in range(len(records)):
        try:
            decode_v2(int(records[i, 1]))
            keep = i + 1
        except ValueError:
            break
    records = records[:keep]
    return ex, state, generate_traces(program_words, records, data_base)
