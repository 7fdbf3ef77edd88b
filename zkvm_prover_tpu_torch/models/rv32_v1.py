"""RV32 proving chipset v1 (the reference's `zkvm_prover_tpu/models/
rv32_v1.py`): control flow through an execution bus, and word RAM.

v1 extends v0 (straight-line) with BEQ/BNE/JAL/LUI, that is loops, by
replacing the pc chain with an execution bus (the openvm-style
program-counter argument): every CPU row receives its (pc, ts) state and
sends (next_pc, ts + TS_STRIDE); ExecBoundaryAir opens the chain at (0, 1)
and closes it at the witnessed final state. Timestamps increase strictly,
so no cycle can close and the logUp balance proves one connected run: rows
may come in any order, and the program ROM's multiplicities count loop
iterations.

Per row:
  - branch equality: S = sum((rs1_k - rs2_k)^2), with witnesses is_eq and
    s_inv: is_eq * S = 0 and S * s_inv = 1 - is_eq (`S_INV` is the
    canonical inverse of S, 0 when S = 0);
  - branch and jump targets are preprocessed ROM constants (pc + imm needs
    no u32 wraparound in the field), carried on the program bus;
  - the JAL link rd = pc + 4, its top limb forced to 0 (programs < 2^24
    bytes).

Supported: ADDI/ADD/SUB/BEQ/BNE/JAL/LUI/LW/SW. Word-aligned RAM has its own
offline memory-checking bus (MEM_BUS) closed by RamBoundaryAir over the
touched word addresses, sorted (RAM starts at zero there: guest data lives
above the program image, at `data_base` and up). MemoryBoundaryAir and
ByteTableAir come from v0 (the same REG and BYTE buses). A segment holds
at most 4,096 cycles: timestamp differences are 16-bit range-checked and
5 * 4096 < 2^16.

Bus ids, column and flag order, padding, row order and the `serialize_air`
streams equal the reference's: they enter the verifying key. Traces are
host numpy, as in v0.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..fields import babybear as bb
from ..vm.executor import Rv32Executor
from .air import Air, AirBuilder
from .rv32_v0 import (
    BYTE_BUS,
    REG_BUS,
    ByteTableAir,
    MemoryBoundaryAir,
    N_LIMBS,
    LIMB,
    _limbs,
)

PROGRAM_BUS = 14
EXEC_BUS = 15
MEM_BUS = 16

# instruction kinds (flag order)
K_ADDI, K_ADD, K_SUB, K_BEQ, K_BNE, K_JAL, K_LUI, K_LW, K_SW = range(9)
N_FLAGS = 9

TS_STRIDE = 5  # rs1, rs2, rd, mem ports + headroom


def decode_v1(instr: int) -> Tuple[int, int, int, int, int, int]:
    """-> (kind, rs1, rs2, rd, imm32, branch_offset) or raises."""
    opcode = instr & 0x7F
    rd = (instr >> 7) & 0x1F
    funct3 = (instr >> 12) & 0x7
    rs1 = (instr >> 15) & 0x1F
    rs2 = (instr >> 20) & 0x1F
    funct7 = (instr >> 25) & 0x7F
    if opcode == 0x13 and funct3 == 0:
        imm = instr >> 20
        if imm >= 0x800:
            imm -= 0x1000
        return (K_ADDI, rs1, 0, rd, imm % (1 << 32), 0)
    if opcode == 0x33 and funct3 == 0 and funct7 == 0:
        return (K_ADD, rs1, rs2, rd, 0, 0)
    if opcode == 0x33 and funct3 == 0 and funct7 == 0x20:
        return (K_SUB, rs1, rs2, rd, 0, 0)
    if opcode == 0x63 and funct3 in (0, 1):
        imm = (
            ((instr >> 31) << 12)
            | (((instr >> 7) & 1) << 11)
            | (((instr >> 25) & 0x3F) << 5)
            | (((instr >> 8) & 0xF) << 1)
        )
        if imm >= 1 << 12:
            imm -= 1 << 13
        kind = K_BEQ if funct3 == 0 else K_BNE
        return (kind, rs1, rs2, 0, 0, imm)
    if opcode == 0x6F:
        imm = (
            ((instr >> 31) << 20)
            | (((instr >> 12) & 0xFF) << 12)
            | (((instr >> 20) & 1) << 11)
            | (((instr >> 21) & 0x3FF) << 1)
        )
        if imm >= 1 << 20:
            imm -= 1 << 21
        return (K_JAL, 0, 0, rd, 0, imm)
    if opcode == 0x37:  # LUI
        return (K_LUI, 0, 0, rd, instr & 0xFFFFF000, 0)
    if opcode == 0x03 and funct3 == 2:  # LW
        imm = instr >> 20
        if imm >= 0x800:
            imm -= 0x1000
        return (K_LW, rs1, 0, rd, imm % (1 << 32), 0)
    if opcode == 0x23 and funct3 == 2:  # SW
        imm = ((instr >> 25) << 5) | ((instr >> 7) & 0x1F)
        if imm >= 0x800:
            imm -= 0x1000
        return (K_SW, rs1, rs2, 0, imm % (1 << 32), 0)
    raise ValueError(f"instruction 0x{instr:08x} not in v1 subset")


class CpuAirV1(Air):
    IS_REAL = 0
    FLAGS = 1            # 9 flags
    PC = 10
    TS = 11
    RS1_IDX, RS2_IDX, RD_IDX = 12, 13, 14
    IMM = 15             # 4 limbs
    TARGET = 19
    RS1_VAL = 20         # 4
    RS2_VAL = 24         # 4
    RD_VAL = 28          # 4
    CARRY = 32           # 4
    RS1_PREV_TS, RS2_PREV_TS, RD_PREV_TS = 36, 37, 38
    RD_PREV_VAL = 39     # 4 (doubles as the previous RAM value for SW)
    DIFF = 43            # 4 accesses x 2 byte limbs = 8
    IS_EQ = 51
    S_INV = 52
    IS_TAKEN = 53
    NEXT_PC = 54
    ADDR = 55            # 4 (memory effective address limbs)
    Q0 = 59              # addr0 / 4 (word alignment witness)
    MEM_PREV_TS = 60
    width = 61
    num_public_values = 0

    def eval(self, b: AirBuilder) -> None:
        C = CpuAirV1
        one = b.constant(1)
        real = b.local(C.IS_REAL)
        f = [b.local(C.FLAGS + k) for k in range(N_FLAGS)]
        f_addi, f_add, f_sub, f_beq, f_bne, f_jal, f_lui, f_lw, f_sw = f
        pc = b.local(C.PC)
        ts = b.local(C.TS)
        target = b.local(C.TARGET)
        is_eq = b.local(C.IS_EQ)
        s_inv = b.local(C.S_INV)
        is_taken = b.local(C.IS_TAKEN)
        next_pc = b.local(C.NEXT_PC)

        for v in (real, is_eq, is_taken, *f):
            b.assert_bool(v)
        acc = f[0]
        for v in f[1:]:
            acc = b.add(acc, v)
        b.assert_eq(acc, real)

        # access multiplicities
        f_mem = b.add(f_lw, f_sw)
        rs1_mult = b.add(
            b.add(b.add(f_addi, b.add(f_add, f_sub)), b.add(f_beq, f_bne)),
            f_mem,
        )
        rs2_mult = b.add(b.add(f_add, f_sub), b.add(b.add(f_beq, f_bne), f_sw))
        rd_mult = b.add(
            b.add(b.add(f_addi, b.add(f_add, f_sub)), b.add(f_jal, f_lui)),
            f_lw,
        )

        # operand b for arithmetic: imm for ADDI, rs2 for ADD/SUB
        r_type = b.add(f_add, f_sub)
        ob = [
            b.add(
                b.mul(f_addi, b.local(C.IMM + k)),
                b.mul(r_type, b.local(C.RS2_VAL + k)),
            )
            for k in range(N_LIMBS)
        ]

        # limb arithmetic with carries: ADDI/ADD add into RD, SUB borrows
        # into RD, LW/SW add rs1+imm into ADDR (carry columns shared)
        add_like = b.add(f_addi, f_add)
        c256 = b.constant(LIMB)
        for k in range(N_LIMBS):
            c_prev = b.local(C.CARRY + k - 1) if k > 0 else None
            c_cur = b.local(C.CARRY + k)
            b.assert_bool(c_cur)
            lhs_add = b.add(b.local(C.RS1_VAL + k), ob[k])
            if c_prev is not None:
                lhs_add = b.add(lhs_add, c_prev)
            expr_add = b.sub(
                b.sub(lhs_add, b.local(C.RD_VAL + k)), b.mul(c256, c_cur)
            )
            lhs_sub = b.sub(b.local(C.RS1_VAL + k), ob[k])
            if c_prev is not None:
                lhs_sub = b.sub(lhs_sub, c_prev)
            expr_sub = b.add(
                b.sub(lhs_sub, b.local(C.RD_VAL + k)), b.mul(c256, c_cur)
            )
            lhs_mem = b.add(b.local(C.RS1_VAL + k), b.local(C.IMM + k))
            if c_prev is not None:
                lhs_mem = b.add(lhs_mem, c_prev)
            expr_mem = b.sub(
                b.sub(lhs_mem, b.local(C.ADDR + k)), b.mul(c256, c_cur)
            )
            b.assert_zero(
                b.add(
                    b.add(
                        b.mul(add_like, expr_add), b.mul(f_sub, expr_sub)
                    ),
                    b.mul(f_mem, expr_mem),
                )
            )

        # word alignment: addr0 = 4 * q0, q0 byte-checked via 4*q0
        b.assert_zero(
            b.mul(
                f_mem,
                b.sub(b.local(C.ADDR), b.mul(b.constant(4), b.local(C.Q0))),
            )
        )
        b.push_send(BYTE_BUS, [b.mul(b.constant(4), b.local(C.Q0))], f_mem)
        for k in range(N_LIMBS):
            b.push_send(BYTE_BUS, [b.local(C.ADDR + k)], f_mem)

        # LUI: rd limbs equal the (ROM) imm limbs
        for k in range(N_LIMBS):
            b.assert_zero(
                b.mul(f_lui, b.sub(b.local(C.RD_VAL + k), b.local(C.IMM + k)))
            )

        # JAL link: sum rd_k 256^k == pc + 4. Forcing the top limb to zero
        # keeps the sum < 2^24 so the byte decomposition is unique in the
        # field (programs < 16 MiB).
        rd_comb = b.local(C.RD_VAL)
        for k in range(1, N_LIMBS):
            rd_comb = b.add(
                rd_comb, b.mul(b.constant(LIMB ** k), b.local(C.RD_VAL + k))
            )
        b.assert_zero(
            b.mul(f_jal, b.sub(rd_comb, b.add(pc, b.constant(4))))
        )
        b.assert_zero(b.mul(f_jal, b.local(C.RD_VAL + 3)))

        # branch equality: S = sum d_k^2
        d = [
            b.sub(b.local(C.RS1_VAL + k), b.local(C.RS2_VAL + k))
            for k in range(N_LIMBS)
        ]
        s_expr = b.mul(d[0], d[0])
        for k in range(1, N_LIMBS):
            s_expr = b.add(s_expr, b.mul(d[k], d[k]))
        b.assert_zero(b.mul(is_eq, s_expr))
        b.assert_zero(b.sub(b.mul(s_expr, s_inv), b.sub(one, is_eq)))

        # taken flag and next pc
        b.assert_zero(
            b.sub(
                is_taken,
                b.add(
                    b.add(b.mul(f_beq, is_eq), b.mul(f_bne, b.sub(one, is_eq))),
                    f_jal,
                ),
            )
        )
        pc4 = b.add(pc, b.constant(4))
        b.assert_zero(
            b.sub(b.sub(next_pc, pc4), b.mul(is_taken, b.sub(target, pc4)))
        )

        # byte range checks
        for k in range(N_LIMBS):
            b.push_send(BYTE_BUS, [b.local(C.RD_VAL + k)], rd_mult)
        for dk, mult in (
            (0, rs1_mult), (2, rs2_mult), (4, rd_mult), (6, f_mem)
        ):
            b.push_send(BYTE_BUS, [b.local(C.DIFF + dk)], mult)
            b.push_send(BYTE_BUS, [b.local(C.DIFF + dk + 1)], mult)

        # timestamp strict ordering per access
        accesses = [
            (C.RS1_PREV_TS, ts, rs1_mult, 0),
            (C.RS2_PREV_TS, b.add(ts, one), rs2_mult, 2),
            (C.RD_PREV_TS, b.add(ts, b.constant(2)), rd_mult, 4),
            (C.MEM_PREV_TS, b.add(ts, b.constant(3)), f_mem, 6),
        ]
        for prev_col, cur_ts, mult, dk in accesses:
            diff = b.sub(b.sub(cur_ts, b.local(prev_col)), one)
            recon = b.add(
                b.local(C.DIFF + dk), b.mul(c256, b.local(C.DIFF + dk + 1))
            )
            b.assert_zero(b.mul(mult, b.sub(diff, recon)))

        # register memory argument
        rs1v = [b.local(C.RS1_VAL + k) for k in range(N_LIMBS)]
        rs2v = [b.local(C.RS2_VAL + k) for k in range(N_LIMBS)]
        rdv = [b.local(C.RD_VAL + k) for k in range(N_LIMBS)]
        rd_prev = [b.local(C.RD_PREV_VAL + k) for k in range(N_LIMBS)]
        b.push_receive(
            REG_BUS, [b.local(C.RS1_IDX), b.local(C.RS1_PREV_TS)] + rs1v,
            rs1_mult,
        )
        b.push_send(REG_BUS, [b.local(C.RS1_IDX), ts] + rs1v, rs1_mult)
        b.push_receive(
            REG_BUS, [b.local(C.RS2_IDX), b.local(C.RS2_PREV_TS)] + rs2v,
            rs2_mult,
        )
        b.push_send(
            REG_BUS, [b.local(C.RS2_IDX), b.add(ts, one)] + rs2v, rs2_mult
        )
        b.push_receive(
            REG_BUS, [b.local(C.RD_IDX), b.local(C.RD_PREV_TS)] + rd_prev,
            rd_mult,
        )
        b.push_send(
            REG_BUS, [b.local(C.RD_IDX), b.add(ts, b.constant(2))] + rdv,
            rd_mult,
        )

        # RAM memory argument (word-addressed): LW keeps the value, SW
        # replaces RD_PREV_VAL (the old cell value) with rs2
        addr_f = [b.local(C.ADDR + k) for k in range(N_LIMBS)]
        prev_val_f = [
            b.add(
                b.mul(f_lw, b.local(C.RD_VAL + k)),
                b.mul(f_sw, b.local(C.RD_PREV_VAL + k)),
            )
            for k in range(N_LIMBS)
        ]
        new_val_f = [
            b.add(
                b.mul(f_lw, b.local(C.RD_VAL + k)),
                b.mul(f_sw, b.local(C.RS2_VAL + k)),
            )
            for k in range(N_LIMBS)
        ]
        b.push_receive(
            MEM_BUS, addr_f + [b.local(C.MEM_PREV_TS)] + prev_val_f, f_mem
        )
        b.push_send(
            MEM_BUS, addr_f + [b.add(ts, b.constant(3))] + new_val_f, f_mem
        )

        # program ROM lookup (includes the branch/jump target)
        b.push_send(
            PROGRAM_BUS,
            [pc] + f + [
                b.local(C.RS1_IDX), b.local(C.RS2_IDX), b.local(C.RD_IDX),
            ] + [b.local(C.IMM + k) for k in range(N_LIMBS)] + [target],
            real,
        )

        # execution bus: receive state, send successor state
        b.push_receive(EXEC_BUS, [pc, ts], real)
        b.push_send(
            EXEC_BUS, [next_pc, b.add(ts, b.constant(TS_STRIDE))], real
        )


class RamBoundaryAir(Air):
    """Opens/closes the RAM memory-checking chains for every touched word
    address. Initial RAM at touched addresses must be zero (guest data lives
    above the program image)."""

    IS_REAL = 0
    ADDR = 1          # 4 limbs
    FINAL_TS = 5
    FINAL_VAL = 6     # 4
    width = 10
    num_public_values = 0

    def eval(self, b: AirBuilder) -> None:
        R_ = RamBoundaryAir
        real = b.local(R_.IS_REAL)
        b.assert_bool(real)
        addr = [b.local(R_.ADDR + k) for k in range(N_LIMBS)]
        zero = b.constant(0)
        b.push_send(MEM_BUS, addr + [zero, zero, zero, zero, zero], real)
        b.push_receive(
            MEM_BUS,
            addr
            + [b.local(R_.FINAL_TS)]
            + [b.local(R_.FINAL_VAL + k) for k in range(N_LIMBS)],
            real,
        )


class ProgramAirV1(Air):
    """Program ROM with preprocessed decoded fields incl. branch targets."""

    PC = 0
    FLAGS = 1     # 9
    RS1, RS2, RD = 10, 11, 12
    IMM = 13      # 4
    TARGET = 17
    preprocessed_width = 18
    MULT = 0
    width = 1
    num_public_values = 0

    def __init__(self, program_words=None):
        self.program_words = list(program_words or [])

    def eval(self, b: AirBuilder) -> None:
        P_ = ProgramAirV1
        fields = [b.preprocessed(P_.PC)]
        fields += [b.preprocessed(P_.FLAGS + k) for k in range(N_FLAGS)]
        fields += [
            b.preprocessed(P_.RS1), b.preprocessed(P_.RS2),
            b.preprocessed(P_.RD),
        ]
        fields += [b.preprocessed(P_.IMM + k) for k in range(N_LIMBS)]
        fields.append(b.preprocessed(P_.TARGET))
        b.push_receive(PROGRAM_BUS, fields, b.local(P_.MULT))

    def preprocessed_trace(self) -> np.ndarray:
        words = self.program_words
        n_prog = max(4, 1 << (max(len(words), 1) - 1).bit_length())
        pre = np.zeros((n_prog, self.preprocessed_width), dtype=np.uint32)
        for j in range(n_prog):
            pre[j, self.PC] = 4 * j
            if j < len(words):
                try:
                    kind, rs1, rs2, rd, imm, boff = decode_v1(words[j])
                except ValueError:
                    continue
                pre[j, self.FLAGS + kind] = 1
                pre[j, self.RS1] = rs1
                pre[j, self.RS2] = rs2
                pre[j, self.RD] = rd
                for k, v in enumerate(_limbs(imm)):
                    pre[j, self.IMM + k] = v
                if kind in (K_BEQ, K_BNE, K_JAL):
                    tgt = 4 * j + boff
                    assert 0 <= tgt < 1 << 26
                    pre[j, self.TARGET] = tgt
        return pre


class ExecBoundaryAir(Air):
    """Opens the execution chain at (pc=0, ts=1), closes it at the witnessed
    final state."""

    IS_INIT = 0
    IS_FIN = 1
    FIN_PC = 2
    FIN_TS = 3
    width = 4
    num_public_values = 0

    def eval(self, b: AirBuilder) -> None:
        E = ExecBoundaryAir
        is_init = b.local(E.IS_INIT)
        is_fin = b.local(E.IS_FIN)
        b.assert_bool(is_init)
        b.assert_bool(is_fin)
        b.when_first_row().assert_eq(is_init, b.constant(1))
        b.when_transition().assert_zero(b.next(E.IS_INIT))
        b.when_last_row().assert_eq(is_fin, b.constant(1))
        b.when_transition().assert_zero(is_fin)
        b.push_send(EXEC_BUS, [b.constant(0), b.constant(1)], is_init)
        b.push_receive(
            EXEC_BUS, [b.local(E.FIN_PC), b.local(E.FIN_TS)], is_fin
        )


# ---------------------------------------------------------------------------
# Trace generation
# ---------------------------------------------------------------------------


def generate_traces(program_words: List[int], records: np.ndarray,
                    data_base: int = 0x1000):
    n_cycles = len(records)
    n = max(4, 1 << (n_cycles - 1).bit_length()) if n_cycles else 4

    C = CpuAirV1
    cpu = np.zeros((n, C.width), dtype=np.uint32)
    byte_counts = np.zeros(256, dtype=np.int64)
    last_ts = np.zeros(32, dtype=np.int64)
    last_val = np.zeros(32, dtype=np.int64)
    ram: dict = {}  # word addr -> (last_ts, value)

    def bcheck(v):
        assert 0 <= v < 256
        byte_counts[v] += 1
        return v

    fin_pc, fin_ts = 0, 1
    for i in range(n_cycles):
        pc, instr, rs1_val, rs2_val, rd_val, mem_addr, mem_val = (
            int(x) for x in records[i]
        )
        kind, rs1, rs2, rd, imm, boff = decode_v1(instr)
        ts = TS_STRIDE * i + 1
        row = cpu[i]
        row[C.IS_REAL] = 1
        row[C.FLAGS + kind] = 1
        row[C.PC] = pc
        row[C.TS] = ts
        row[C.RS1_IDX], row[C.RS2_IDX], row[C.RD_IDX] = rs1, rs2, rd
        for k, v in enumerate(_limbs(imm)):
            row[C.IMM + k] = v

        reads_rs1 = kind in (K_ADDI, K_ADD, K_SUB, K_BEQ, K_BNE, K_LW, K_SW)
        reads_rs2 = kind in (K_ADD, K_SUB, K_BEQ, K_BNE, K_SW)
        writes_rd = kind in (K_ADDI, K_ADD, K_SUB, K_JAL, K_LUI, K_LW)
        is_mem = kind in (K_LW, K_SW)
        if writes_rd:
            assert rd != 0, "v1 requires rd != x0 for writes"

        rs1_v = rs1_val if reads_rs1 else 0
        rs2_v = rs2_val if reads_rs2 else 0
        rd_v = rd_val if writes_rd else 0
        for k, v in enumerate(_limbs(rs1_v)):
            row[C.RS1_VAL + k] = v
        for k, v in enumerate(_limbs(rs2_v)):
            row[C.RS2_VAL + k] = v
        for k, v in enumerate(_limbs(rd_v)):
            row[C.RD_VAL + k] = bcheck(v) if writes_rd else v

        # carries: arithmetic into RD or address into ADDR
        if kind in (K_ADDI, K_ADD):
            bop = imm if kind == K_ADDI else rs2_v
            carry = 0
            for k in range(N_LIMBS):
                s = ((rs1_v >> (8 * k)) & 0xFF) + ((bop >> (8 * k)) & 0xFF) + carry
                carry = s >> 8
                row[C.CARRY + k] = carry
        elif kind == K_SUB:
            borrow = 0
            for k in range(N_LIMBS):
                s = ((rs1_v >> (8 * k)) & 0xFF) - ((rs2_v >> (8 * k)) & 0xFF) - borrow
                borrow = 1 if s < 0 else 0
                row[C.CARRY + k] = borrow
        elif is_mem:
            addr = mem_addr
            assert addr == (rs1_v + imm) % (1 << 32)
            assert addr % 4 == 0, "v1 supports word-aligned LW/SW only"
            assert addr >= data_base, (
                "v1 RAM accesses must live above the program image"
            )
            carry = 0
            for k in range(N_LIMBS):
                s = ((rs1_v >> (8 * k)) & 0xFF) + ((imm >> (8 * k)) & 0xFF) + carry
                carry = s >> 8
                row[C.CARRY + k] = carry
            for k, v in enumerate(_limbs(addr)):
                row[C.ADDR + k] = bcheck(v)
            q0 = (addr & 0xFF) // 4
            row[C.Q0] = q0
            bcheck(4 * q0)

        # equality witness
        d = [((rs1_v >> (8 * k)) & 0xFF) - ((rs2_v >> (8 * k)) & 0xFF)
             for k in range(N_LIMBS)]
        s_val = sum(x * x for x in d) % bb.P
        if s_val == 0:
            row[C.IS_EQ] = 1
            row[C.S_INV] = 0
        else:
            row[C.IS_EQ] = 0
            row[C.S_INV] = pow(s_val, bb.P - 2, bb.P)

        # taken + next pc
        if kind == K_BEQ:
            taken = rs1_v == rs2_v
        elif kind == K_BNE:
            taken = rs1_v != rs2_v
        elif kind == K_JAL:
            taken = True
        else:
            taken = False
        row[C.IS_TAKEN] = 1 if taken else 0
        target = (pc + boff) if kind in (K_BEQ, K_BNE, K_JAL) else 0
        row[C.TARGET] = target
        next_pc = target if taken else pc + 4
        row[C.NEXT_PC] = next_pc
        fin_pc, fin_ts = next_pc, ts + TS_STRIDE

        # register accesses
        def read(idx, cur_ts, val, prev_col):
            row[prev_col] = last_ts[idx]
            assert last_val[idx] == val, "executor/trace divergence"
            dd = cur_ts - last_ts[idx] - 1
            last_ts[idx] = cur_ts
            return dd

        if reads_rs1:
            d1 = read(rs1, ts, rs1_v, C.RS1_PREV_TS)
            row[C.DIFF + 0] = bcheck(d1 & 0xFF)
            row[C.DIFF + 1] = bcheck(d1 >> 8)
        if reads_rs2:
            d2 = read(rs2, ts + 1, rs2_v, C.RS2_PREV_TS)
            row[C.DIFF + 2] = bcheck(d2 & 0xFF)
            row[C.DIFF + 3] = bcheck(d2 >> 8)
        if writes_rd:
            row[C.RD_PREV_TS] = last_ts[rd]
            for k, v in enumerate(_limbs(int(last_val[rd]))):
                row[C.RD_PREV_VAL + k] = v
            d3 = ts + 2 - last_ts[rd] - 1
            row[C.DIFF + 4] = bcheck(d3 & 0xFF)
            row[C.DIFF + 5] = bcheck(d3 >> 8)
            last_ts[rd] = ts + 2
            last_val[rd] = rd_v
        if is_mem:
            prev_ts, prev_val = ram.get(mem_addr, (0, 0))
            row[C.MEM_PREV_TS] = prev_ts
            if kind == K_LW:
                assert prev_val == rd_v, "RAM/trace divergence on LW"
                new_val = prev_val
            else:  # SW — RD_PREV_VAL doubles as the old cell value
                for k, v in enumerate(_limbs(prev_val)):
                    row[C.RD_PREV_VAL + k] = v
                new_val = rs2_v
            d4 = ts + 3 - prev_ts - 1
            row[C.DIFF + 6] = bcheck(d4 & 0xFF)
            row[C.DIFF + 7] = bcheck(d4 >> 8)
            ram[mem_addr] = (ts + 3, new_val)

    # padding rows must satisfy next_pc = pc + 4 (all-zero flags)
    for i in range(n_cycles, n):
        cpu[i, C.PC] = 0
        cpu[i, C.NEXT_PC] = 4
        cpu[i, C.IS_EQ] = 1

    # program ROM
    program_air = ProgramAirV1(program_words)
    n_prog = program_air.preprocessed_trace().shape[0]
    exec_counts = (
        np.bincount((records[:, 0] // 4).astype(np.int64), minlength=n_prog)
        if n_cycles
        else np.zeros(n_prog, dtype=np.int64)
    )
    prog = np.zeros((n_prog, ProgramAirV1.width), dtype=np.uint32)
    prog[:, ProgramAirV1.MULT] = exec_counts[:n_prog].astype(np.uint32)

    # execution boundary
    ex_tr = np.zeros((4, ExecBoundaryAir.width), dtype=np.uint32)
    ex_tr[0, ExecBoundaryAir.IS_INIT] = 1
    ex_tr[3, ExecBoundaryAir.IS_FIN] = 1
    ex_tr[3, ExecBoundaryAir.FIN_PC] = fin_pc
    ex_tr[3, ExecBoundaryAir.FIN_TS] = fin_ts

    # register boundary
    mem = np.zeros((32, MemoryBoundaryAir.width), dtype=np.uint32)
    for r in range(32):
        mem[r, MemoryBoundaryAir.ADDR] = r
        mem[r, MemoryBoundaryAir.FINAL_TS] = last_ts[r]
        for k, v in enumerate(_limbs(int(last_val[r]))):
            mem[r, MemoryBoundaryAir.FINAL_VAL + k] = v

    # RAM boundary (touched word addresses)
    n_ram = max(4, 1 << (max(len(ram), 1) - 1).bit_length())
    ram_tr = np.zeros((n_ram, RamBoundaryAir.width), dtype=np.uint32)
    for j, (addr, (fts, fval)) in enumerate(sorted(ram.items())):
        ram_tr[j, RamBoundaryAir.IS_REAL] = 1
        for k, v in enumerate(_limbs(addr)):
            ram_tr[j, RamBoundaryAir.ADDR + k] = v
        ram_tr[j, RamBoundaryAir.FINAL_TS] = fts
        for k, v in enumerate(_limbs(fval)):
            ram_tr[j, RamBoundaryAir.FINAL_VAL + k] = v

    byte = np.zeros((256, ByteTableAir.width), dtype=np.uint32)
    byte[:, ByteTableAir.VALUE] = np.arange(256)
    byte[:, ByteTableAir.MULT] = byte_counts % bb.P

    return [
        (CpuAirV1(), cpu),
        (program_air, prog),
        (ExecBoundaryAir(), ex_tr),
        (RamBoundaryAir(), ram_tr),
        (MemoryBoundaryAir(), mem),
        (ByteTableAir(), byte),
    ]


def execute_and_trace(program_words: List[int], max_cycles: int = 1 << 12):
    # segment cap: timestamp diffs are 16-bit range-checked; 5*4096 < 2^16
    ex = Rv32Executor()
    ex.load_program(program_words)
    state = ex.run(max_cycles)
    records = ex.records()
    keep = []
    for i in range(len(records)):
        try:
            decode_v1(int(records[i, 1]))
            keep.append(i)
        except ValueError:
            break
    records = records[keep] if keep else records[:0]
    return ex, state, generate_traces(program_words, records)
