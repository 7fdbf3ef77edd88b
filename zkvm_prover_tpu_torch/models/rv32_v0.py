"""RV32 proving chipset v0 (the reference's `zkvm_prover_tpu/models/
rv32_v0.py`): a sound multi-AIR machine proof of straight-line RV32
arithmetic (ADDI/ADD/SUB), the first slice of the openvm-style VM circuit.
The v2 chipset and the keccak chips reuse its buses, its byte table and its
register-file boundary chip.

Chips (each an AIR glued by logUp buses, like openvm's interactions):

  CpuAirV0           one row per cycle; byte-limb register arithmetic with
                     carry chains; pc chaining; per-access register
                     read/write events
  ProgramAir         the program ROM as a preprocessed (pc, decoded-fields)
                     table; execution counts as receive multiplicities
  MemoryBoundaryAir  initial (ts=0, value 0) sends and final-state receives
                     for the 32 registers: closes the offline
                     memory-checking chains
  ByteTableAir       the 8-bit range table (limb + timestamp-diff checks)

Register values are four 8-bit limbs (`_limbs`; p is 31-bit, so u32
semantics need limbs and carries). The register file uses offline memory
checking: a read receives (prev_ts, v) and sends (cur_ts, v); a write
receives the previous pair and sends the new one; timestamps increase
strictly, by 16-bit range-checked differences; MemoryBoundaryAir opens and
closes every register's chain, so the global logUp balance proves the
register file consistent.

v0 limits: straight-line programs (no branches, jumps or memory), rd !=
x0, at most about 2^15 cycles a segment (16-bit timestamp differences).
Layouts, bus ids, row order, padding and `serialize_air` streams equal the
reference's.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..fields import babybear as bb
from ..vm.executor import Rv32Executor
from .air import Air, AirBuilder

BYTE_BUS = 10
REG_BUS = 11
PROGRAM_BUS = 12

N_LIMBS = 4
LIMB = 256

# decoded instruction kinds supported in v0
_K_ADDI, _K_ADD, _K_SUB = 0, 1, 2


def _decode_v0(instr: int) -> Tuple[int, int, int, int, int]:
    """-> (kind, rs1, rs2, rd, imm32) or raises for unsupported."""
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
        return (_K_ADDI, rs1, 0, rd, imm % (1 << 32))
    if opcode == 0x33 and funct3 == 0 and funct7 == 0:
        return (_K_ADD, rs1, rs2, rd, 0)
    if opcode == 0x33 and funct3 == 0 and funct7 == 0x20:
        return (_K_SUB, rs1, rs2, rd, 0)
    raise ValueError(f"instruction 0x{instr:08x} not in v0 subset")


def _limbs(v: int) -> List[int]:
    return [(v >> (8 * k)) & 0xFF for k in range(N_LIMBS)]


class CpuAirV0(Air):
    # column indices
    IS_REAL = 0
    IS_ADDI, IS_ADD, IS_SUB = 1, 2, 3
    PC = 4
    TS = 5
    RS1_IDX, RS2_IDX, RD_IDX = 6, 7, 8
    IMM = 9            # 4 limbs
    RS1_VAL = 13       # 4
    RS2_VAL = 17       # 4
    RD_VAL = 21        # 4
    CARRY = 25         # 4
    RS1_PREV_TS, RS2_PREV_TS, RD_PREV_TS = 29, 30, 31
    RD_PREV_VAL = 32   # 4
    DIFF = 36          # 3 accesses x 2 byte limbs = 6
    width = 42
    num_public_values = 0

    def eval(self, b: AirBuilder) -> None:
        C = CpuAirV0
        one = b.constant(1)
        real = b.local(C.IS_REAL)
        f_addi = b.local(C.IS_ADDI)
        f_add = b.local(C.IS_ADD)
        f_sub = b.local(C.IS_SUB)
        pc = b.local(C.PC)
        ts = b.local(C.TS)

        # flags boolean; exactly one set when real
        for f in (real, f_addi, f_add, f_sub):
            b.assert_bool(f)
        b.assert_eq(b.add(b.add(f_addi, f_add), f_sub), real)
        # once padding starts it never stops
        b.when_transition().assert_zero(
            b.mul(b.next(C.IS_REAL), b.sub(one, real))
        )

        # ts chaining: first row ts = 1, ts_next = ts + 3
        b.when_first_row().assert_eq(ts, one)
        b.when_transition().assert_eq(b.next(C.TS), b.add(ts, b.constant(3)))
        # pc chaining (straight-line v0): first pc = 0; pc_next = pc + 4
        # while the next row is real
        b.when_first_row().assert_zero(pc)
        b.when_transition().assert_zero(
            b.mul(
                b.next(C.IS_REAL),
                b.sub(b.next(C.PC), b.add(pc, b.constant(4))),
            )
        )

        # operand b: imm limbs for ADDI, rs2 limbs otherwise
        r_type = b.add(f_add, f_sub)
        ob = [
            b.add(
                b.mul(f_addi, b.local(C.IMM + k)),
                b.mul(r_type, b.local(C.RS2_VAL + k)),
            )
            for k in range(N_LIMBS)
        ]

        # limb arithmetic with carries:
        # add-like (addi/add): rs1[k] + ob[k] + c_{k-1} - rd[k] - 256 c_k = 0
        # sub:                 rs1[k] - ob[k] - c_{k-1} - rd[k] + 256 c_k = 0
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
            b.assert_zero(
                b.add(b.mul(add_like, expr_add), b.mul(f_sub, expr_sub))
            )

        # byte range checks: rd limbs + ts-diff limbs
        for k in range(N_LIMBS):
            b.push_send(BYTE_BUS, [b.local(C.RD_VAL + k)], real)
        for k in range(6):
            b.push_send(BYTE_BUS, [b.local(C.DIFF + k)], real)

        # timestamp strict ordering: cur_ts - prev_ts - 1 = d_lo + 256 d_hi
        accesses = [
            (C.RS1_PREV_TS, ts, real, 0),
            (C.RS2_PREV_TS, b.add(ts, one), r_type, 2),
            (C.RD_PREV_TS, b.add(ts, b.constant(2)), real, 4),
        ]
        for prev_col, cur_ts, mult, dk in accesses:
            diff = b.sub(b.sub(cur_ts, b.local(prev_col)), one)
            recon = b.add(
                b.local(C.DIFF + dk),
                b.mul(c256, b.local(C.DIFF + dk + 1)),
            )
            b.assert_zero(b.mul(mult, b.sub(diff, recon)))

        # register memory argument (offline memory checking)
        rs1v = [b.local(C.RS1_VAL + k) for k in range(N_LIMBS)]
        rs2v = [b.local(C.RS2_VAL + k) for k in range(N_LIMBS)]
        rdv = [b.local(C.RD_VAL + k) for k in range(N_LIMBS)]
        rd_prev = [b.local(C.RD_PREV_VAL + k) for k in range(N_LIMBS)]
        b.push_receive(
            REG_BUS,
            [b.local(C.RS1_IDX), b.local(C.RS1_PREV_TS)] + rs1v,
            real,
        )
        b.push_send(REG_BUS, [b.local(C.RS1_IDX), ts] + rs1v, real)
        b.push_receive(
            REG_BUS,
            [b.local(C.RS2_IDX), b.local(C.RS2_PREV_TS)] + rs2v,
            r_type,
        )
        b.push_send(
            REG_BUS, [b.local(C.RS2_IDX), b.add(ts, one)] + rs2v, r_type
        )
        b.push_receive(
            REG_BUS,
            [b.local(C.RD_IDX), b.local(C.RD_PREV_TS)] + rd_prev,
            real,
        )
        b.push_send(
            REG_BUS,
            [b.local(C.RD_IDX), b.add(ts, b.constant(2))] + rdv,
            real,
        )

        # program ROM lookup
        b.push_send(
            PROGRAM_BUS,
            [pc, f_addi, f_add, f_sub, b.local(C.RS1_IDX),
             b.local(C.RS2_IDX), b.local(C.RD_IDX)]
            + [b.local(C.IMM + k) for k in range(N_LIMBS)],
            real,
        )


class ProgramAir(Air):
    """Program ROM chip: the decoded instruction table lives in
    **preprocessed** (verifier-known) columns, so the executed program is
    bound into the verification key; the only main-trace column is the
    execution-count multiplicity.

    Preprocessed columns: pc, flags, rs1, rs2, rd, imm limbs.
    """

    # preprocessed column indices
    PC = 0
    F_ADDI, F_ADD, F_SUB = 1, 2, 3
    RS1, RS2, RD = 4, 5, 6
    IMM = 7
    preprocessed_width = 11
    # main trace
    MULT = 0
    width = 1
    num_public_values = 0

    def __init__(self, program_words=None):
        self.program_words = list(program_words or [])

    def eval(self, b: AirBuilder) -> None:
        P_ = ProgramAir
        pc = b.preprocessed(P_.PC)
        b.push_receive(
            PROGRAM_BUS,
            [pc] + [b.preprocessed(c) for c in (
                P_.F_ADDI, P_.F_ADD, P_.F_SUB, P_.RS1, P_.RS2, P_.RD,
                P_.IMM, P_.IMM + 1, P_.IMM + 2, P_.IMM + 3,
            )],
            b.local(P_.MULT),
        )

    def preprocessed_trace(self) -> np.ndarray:
        words = self.program_words
        n_prog = max(4, 1 << (max(len(words), 1) - 1).bit_length())
        pre = np.zeros((n_prog, ProgramAir.preprocessed_width), dtype=np.uint32)
        for j in range(n_prog):
            pre[j, ProgramAir.PC] = 4 * j
            if j < len(words):
                try:
                    kind, rs1, rs2, rd, imm = _decode_v0(words[j])
                except ValueError:
                    continue  # non-v0 instruction (e.g. the halt ecall tail)
                pre[j, ProgramAir.F_ADDI + kind] = 1
                pre[j, ProgramAir.RS1] = rs1
                pre[j, ProgramAir.RS2] = rs2
                pre[j, ProgramAir.RD] = rd
                for k, v in enumerate(_limbs(imm)):
                    pre[j, ProgramAir.IMM + k] = v
        return pre


class MemoryBoundaryAir(Air):
    """Height 32: open (ts=0, value 0) and close (final ts/value) every
    register's memory-check chain."""

    ADDR = 0
    FINAL_TS = 1
    FINAL_VAL = 2  # 4 limbs
    width = 6
    num_public_values = 0

    def eval(self, b: AirBuilder) -> None:
        M = MemoryBoundaryAir
        addr = b.local(M.ADDR)
        b.when_first_row().assert_zero(addr)
        b.when_transition().assert_eq(b.next(M.ADDR), b.add(addr, b.constant(1)))
        zero = b.constant(0)
        b.push_send(REG_BUS, [addr, zero, zero, zero, zero, zero], b.constant(1))
        b.push_receive(
            REG_BUS,
            [addr, b.local(M.FINAL_TS)]
            + [b.local(M.FINAL_VAL + k) for k in range(N_LIMBS)],
            b.constant(1),
        )


class ByteTableAir(Air):
    """Height 256 byte range table."""

    VALUE = 0
    MULT = 1
    width = 2
    num_public_values = 0

    def eval(self, b: AirBuilder) -> None:
        v = b.local(ByteTableAir.VALUE)
        b.when_first_row().assert_zero(v)
        b.when_transition().assert_eq(b.next(ByteTableAir.VALUE), b.add(v, b.constant(1)))
        b.push_receive(BYTE_BUS, [v], b.local(ByteTableAir.MULT))


# ---------------------------------------------------------------------------
# Trace generation from executor records
# ---------------------------------------------------------------------------


def generate_traces(program_words: List[int], records: np.ndarray):
    """Build all four chip traces for a straight-line v0 execution.

    program_words: the committed program; records: (n, 7) executor records.
    Returns list of (Air, trace) pairs + byte-lookup bookkeeping.
    """
    n_cycles = len(records)
    n = max(4, 1 << (n_cycles - 1).bit_length()) if n_cycles else 4

    C = CpuAirV0
    cpu = np.zeros((n, CpuAirV0.width), dtype=np.uint32)
    byte_counts = np.zeros(256, dtype=np.int64)

    # register book-keeping: last (ts, value) per register
    last_ts = np.zeros(32, dtype=np.int64)
    last_val = np.zeros(32, dtype=np.int64)

    def byte_check(v):
        byte_counts[v] += 1
        return v

    for i in range(n_cycles):
        pc, instr, rs1_val, rs2_val, rd_val, _, _ = (int(x) for x in records[i])
        kind, rs1, rs2, rd, imm = _decode_v0(instr)
        assert rd != 0, "v0 requires rd != x0"
        ts = 3 * i + 1
        row = cpu[i]
        row[C.IS_REAL] = 1
        row[C.IS_ADDI + kind] = 1
        row[C.PC] = pc
        row[C.TS] = ts
        row[C.RS1_IDX], row[C.RS2_IDX], row[C.RD_IDX] = rs1, rs2, rd
        for k, v in enumerate(_limbs(imm)):
            row[C.IMM + k] = v
        for k, v in enumerate(_limbs(rs1_val)):
            row[C.RS1_VAL + k] = v
        for k, v in enumerate(_limbs(rs2_val if kind != _K_ADDI else 0)):
            row[C.RS2_VAL + k] = v
        for k, v in enumerate(_limbs(rd_val)):
            row[C.RD_VAL + k] = byte_check(v)

        # carries
        a = rs1_val
        bop = imm if kind == _K_ADDI else rs2_val
        if kind in (_K_ADDI, _K_ADD):
            carry = 0
            for k in range(N_LIMBS):
                s = ((a >> (8 * k)) & 0xFF) + ((bop >> (8 * k)) & 0xFF) + carry
                carry = s >> 8
                row[C.CARRY + k] = carry
        else:  # SUB: borrows
            borrow = 0
            for k in range(N_LIMBS):
                s = ((a >> (8 * k)) & 0xFF) - ((bop >> (8 * k)) & 0xFF) - borrow
                borrow = 1 if s < 0 else 0
                row[C.CARRY + k] = borrow

        # register accesses
        def do_read(idx, cur_ts, val, prev_col):
            row[prev_col] = last_ts[idx]
            assert last_val[idx] == val, "executor/trace divergence"
            d = cur_ts - last_ts[idx] - 1
            last_ts[idx] = cur_ts
            return d

        d1 = do_read(rs1, ts, rs1_val, C.RS1_PREV_TS)
        row[C.DIFF + 0] = byte_check(d1 & 0xFF)
        row[C.DIFF + 1] = byte_check(d1 >> 8)
        if kind != _K_ADDI:
            d2 = do_read(rs2, ts + 1, rs2_val, C.RS2_PREV_TS)
            row[C.DIFF + 2] = byte_check(d2 & 0xFF)
            row[C.DIFF + 3] = byte_check(d2 >> 8)
        else:
            byte_check(0)
            byte_check(0)
        # rd write
        row[C.RD_PREV_TS] = last_ts[rd]
        for k, v in enumerate(_limbs(int(last_val[rd]))):
            row[C.RD_PREV_VAL + k] = v
        d3 = ts + 2 - last_ts[rd] - 1
        row[C.DIFF + 4] = byte_check(d3 & 0xFF)
        row[C.DIFF + 5] = byte_check(d3 >> 8)
        last_ts[rd] = ts + 2
        last_val[rd] = rd_val

    # padding rows: keep ts/pc chains consistent
    for i in range(n_cycles, n):
        cpu[i, C.TS] = 3 * i + 1
        cpu[i, C.PC] = 0 if i == 0 else cpu[i - 1, C.PC]

    # program ROM: decoded table is preprocessed (verifier-known); the main
    # trace carries only execution counts
    program_air = ProgramAir(program_words)
    n_prog = program_air.preprocessed_trace().shape[0]
    exec_counts = np.bincount(
        (records[:, 0] // 4).astype(np.int64), minlength=n_prog
    ) if n_cycles else np.zeros(n_prog, dtype=np.int64)
    prog = np.zeros((n_prog, ProgramAir.width), dtype=np.uint32)
    prog[:, ProgramAir.MULT] = exec_counts[:n_prog].astype(np.uint32)

    # memory boundary trace
    mem = np.zeros((32, MemoryBoundaryAir.width), dtype=np.uint32)
    for r in range(32):
        mem[r, MemoryBoundaryAir.ADDR] = r
        mem[r, MemoryBoundaryAir.FINAL_TS] = last_ts[r]
        for k, v in enumerate(_limbs(int(last_val[r]))):
            mem[r, MemoryBoundaryAir.FINAL_VAL + k] = v

    # byte table
    byte = np.zeros((256, ByteTableAir.width), dtype=np.uint32)
    byte[:, ByteTableAir.VALUE] = np.arange(256)
    byte[:, ByteTableAir.MULT] = byte_counts % bb.P

    return [
        (CpuAirV0(), cpu),
        (program_air, prog),
        (MemoryBoundaryAir(), mem),
        (ByteTableAir(), byte),
    ]


def execute_and_trace(program_words: List[int], max_cycles: int = 1 << 14):
    """Run the native executor and build the chip traces."""
    ex = Rv32Executor()
    ex.load_program(program_words)
    state = ex.run(max_cycles)
    records = ex.records()
    # drop trailing non-v0 records (the halt ecall tail)
    keep = []
    for i in range(len(records)):
        try:
            _decode_v0(int(records[i, 1]))
            keep.append(i)
        except ValueError:
            break
    records = records[keep] if keep else records[:0]
    return ex, state, generate_traces(program_words, records)
