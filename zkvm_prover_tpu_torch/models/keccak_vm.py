"""KeccakVmAir: the keccak256 syscall chip (one absorbed rate-block per
row) for the rv32 v2 machine.

The port's copy of the reference's `zkvm_prover_tpu/models/keccak_vm.py`,
the analog of openvm's keccak256 VM extension chip: the guest
issues ECALL a7=3 with (a0=msg ptr, a1=len, a2=out ptr); `SystemAir` reads
the registers and hands the request over KECCAK_REQ_BUS; this chip

  - reads the message words from RAM over MEM_BUS (offline memory
    checking, one 48-slot timestamp window per block row),
  - applies the 0x01..0x80 keccak padding in-constraints via monotone
    prefix flags (p_j = 1 iff byte j of this block is message),
  - XORs the rate bytes into the sponge state via the byte XOR table
    (XOR_BUS) — which also range-checks every byte it touches,
  - proves each permutation by sending (state_in, state_out) 16-bit-limb
    messages to KeccakfAir over KECCAK_F_BUS,
  - chains the state across block rows of one request,
  - on the final block: writes the 32-byte digest to RAM and sends the
    execution-chain continuation (pc+4) on EXEC_BUS, owning the
    instruction's full timestamp window.

Pointers/lengths are bounded < 2^16 (SystemAir constrains the high limbs
to zero), so single-felt MEM_BUS addresses ptr + 4w need no carry chains.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..ops.keccak import keccak_f1600
from .air import Air, AirBuilder
from .keccak_air import KECCAK_F_BUS, U64_LIMBS
from .rv32_v0 import BYTE_BUS
from .rv32_v2 import (
    EXEC_BUS,
    KECCAK_REQ_BUS,
    MEM_BUS,
    RANGE16_BUS,
    TS_STRIDE,
    XOR_BUS,
)

RATE = 136
RATE_WORDS = RATE // 4          # 34
KECCAK_BLOCK_TS = 48            # 34 reads + 8 writes + margin per block

# --- column layout ---------------------------------------------------------
IS_REAL = 0
IS_FIRST = 1
IS_LAST = 2
REQ_PC = 3
REQ_TS = 4
PTR0, PTR1 = 5, 6
LEN0, LEN1 = 7, 8
OUT0, OUT1 = 9, 10
PTR_Q, OUT_Q = 11, 12          # ptr0 = 4*PTR_Q, out0 = 4*OUT_Q (alignment)
BLOCK_IDX = 13
RDP = 14                        # 34 x [prev_ts, d0, d1, v0..v3] stride 7
P_FLAGS = RDP + 7 * RATE_WORDS            # 252: 136 prefix flags
SIN = P_FLAGS + RATE                      # 388: 200 state-in bytes
ABS = SIN + 200                           # 588: 136 absorbed bytes
XRD = ABS + RATE                          # 724: 136 xored rate bytes
SOUT = XRD + RATE                         # 860: 200 state-out bytes
WRP = SOUT + 200                          # 1060: 8 x [prev_ts, d0, d1, old0..3]
NUM_COLS = WRP + 7 * 8                    # 1116


class KeccakVmAir(Air):
    width = NUM_COLS
    num_public_values = 0

    def eval(self, b: AirBuilder) -> None:
        one = b.constant(1)
        c256 = b.constant(256)
        real = b.local(IS_REAL)
        first = b.local(IS_FIRST)
        last = b.local(IS_LAST)
        for f in (real, first, last):
            b.assert_bool(f)
        b.assert_zero(b.mul(first, b.sub(real, one)))
        b.assert_zero(b.mul(last, b.sub(real, one)))

        # real rows form a prefix; block groups are delimited by first/last
        b.when_transition().assert_zero(
            b.mul(b.sub(one, real), b.next(IS_REAL)))
        b.when_first_row().assert_zero(b.mul(real, b.sub(first, one)))
        # within a group: the next row continues it
        cont = b.mul(real, b.sub(one, last))
        b.when_transition().assert_zero(b.mul(cont, b.sub(b.next(IS_REAL),
                                                          one)))
        b.when_transition().assert_zero(b.mul(cont, b.next(IS_FIRST)))
        b.when_transition().assert_zero(
            b.mul(cont, b.sub(b.next(BLOCK_IDX),
                              b.add(b.local(BLOCK_IDX), one))))
        for col in (REQ_PC, REQ_TS, PTR0, PTR1, LEN0, LEN1, OUT0, OUT1):
            b.when_transition().assert_zero(
                b.mul(cont, b.sub(b.next(col), b.local(col))))
        # after a final block: a real next row must start a new group
        b.when_transition().assert_zero(
            b.mul(last, b.sub(b.next(IS_REAL), b.next(IS_FIRST))))
        # the trace must not end mid-group
        b.when_last_row().assert_zero(b.mul(real, b.sub(one, last)))
        b.assert_zero(b.mul(first, b.local(BLOCK_IDX)))

        # request handoff (SystemAir owns the register reads)
        pc, ts = b.local(REQ_PC), b.local(REQ_TS)
        b.push_receive(
            KECCAK_REQ_BUS,
            [pc, ts, b.local(PTR0), b.local(PTR1), b.local(LEN0),
             b.local(LEN1), b.local(OUT0), b.local(OUT1)],
            first,
        )
        # pointer/length bytes + word alignment (checked once per group)
        for col in (PTR1, LEN0, LEN1, OUT1):
            b.push_send(BYTE_BUS, [b.local(col)], first)
        for q_col, p_col in ((PTR_Q, PTR0), (OUT_Q, OUT0)):
            q4 = b.mul(b.constant(4), b.local(q_col))
            b.assert_zero(b.mul(first, b.sub(b.local(p_col), q4)))
            b.push_send(BYTE_BUS, [q4], first)
        ptr_f = b.add(b.local(PTR0), b.mul(c256, b.local(PTR1)))
        out_f = b.add(b.local(OUT0), b.mul(c256, b.local(OUT1)))
        len_f = b.add(b.local(LEN0), b.mul(c256, b.local(LEN1)))

        # prefix flags: p_j = 1 iff block byte j is message
        p = [b.local(P_FLAGS + j) for j in range(RATE)]
        for j in range(RATE):
            b.assert_bool(p[j])
        for j in range(RATE - 1):
            b.assert_zero(b.mul(p[j + 1], b.sub(one, p[j])))
        rem = p[0]
        for j in range(1, RATE):
            rem = b.add(rem, p[j])
        # non-final blocks absorb a full message block
        b.assert_zero(b.mul(b.sub(real, last),
                            b.sub(rem, b.constant(RATE))))
        # final block: len = RATE*block_idx + rem, rem <= 135
        b.assert_zero(b.mul(last, p[RATE - 1]))
        b.assert_zero(b.mul(last, b.sub(
            len_f, b.add(b.mul(b.constant(RATE), b.local(BLOCK_IDX)),
                         rem))))

        # timestamp window base for this block row
        ts_base = b.add(b.add(ts, b.constant(TS_STRIDE)),
                        b.mul(b.constant(KECCAK_BLOCK_TS),
                              b.local(BLOCK_IDX)))

        def mem_port(base_col, addr, cur_ts, old_vals, new_vals, mult):
            prev_ts = b.local(base_col)
            b.push_receive(MEM_BUS, [addr, prev_ts] + old_vals, mult)
            b.push_send(MEM_BUS, [addr, cur_ts] + new_vals, mult)
            diff = b.sub(b.sub(cur_ts, prev_ts), one)
            recon = b.add(b.local(base_col + 1),
                          b.mul(b.constant(1 << 16),
                                b.local(base_col + 2)))
            b.assert_zero(b.mul(mult, b.sub(diff, recon)))
            b.push_send(RANGE16_BUS, [b.local(base_col + 1)], mult)
            b.push_send(BYTE_BUS, [b.local(base_col + 2)], mult)

        # message word reads (word w needed iff byte 4w is message)
        block_off = b.mul(b.constant(RATE), b.local(BLOCK_IDX))
        for w in range(RATE_WORDS):
            base = RDP + 7 * w
            vals = [b.local(base + 3 + k) for k in range(4)]
            addr = b.add(ptr_f, b.add(block_off, b.constant(4 * w)))
            mem_port(base, addr, b.add(ts_base, b.constant(w)),
                     vals, vals, p[4 * w])

        # absorbed bytes: message prefix + keccak padding
        absb = [b.local(ABS + j) for j in range(RATE)]
        for j in range(RATE):
            ram_byte = b.local(RDP + 7 * (j // 4) + 3 + (j % 4))
            first_pad = b.sub(one, p[j]) if j == 0 else \
                b.mul(b.sub(one, p[j]), p[j - 1])
            pad = b.mul(last, first_pad)
            expr = b.add(b.mul(p[j], ram_byte), pad)
            if j == RATE - 1:
                expr = b.add(expr, b.mul(b.constant(0x80), last))
            b.assert_zero(b.sub(absb[j], expr))

        # sponge state: first block starts from zero
        sin = [b.local(SIN + j) for j in range(200)]
        for j in range(200):
            b.assert_zero(b.mul(first, sin[j]))
        # rate XOR via the byte xor table (also range-checks the bytes)
        xrd = [b.local(XRD + j) for j in range(RATE)]
        for j in range(RATE):
            b.push_send(XOR_BUS, [sin[j], absb[j], xrd[j]], real)

        # permutation lookup: (state after xor) -> state_out
        sout = [b.local(SOUT + j) for j in range(200)]
        msg = []
        for half in (xrd, sin[RATE:]):
            for i in range(0, len(half), 2):
                msg.append(b.add(half[i], b.mul(c256, half[i + 1])))
        for i in range(0, 200, 2):
            msg.append(b.add(sout[i], b.mul(c256, sout[i + 1])))
        assert len(msg) == 2 * 25 * U64_LIMBS
        b.push_send(KECCAK_F_BUS, msg, real)

        # state chaining into the next block of the same request
        for j in range(200):
            b.when_transition().assert_zero(
                b.mul(cont, b.sub(b.next(SIN + j), sout[j])))

        # final block: write the 32-byte digest (state_out bytes 0..31)
        for k in range(8):
            base = WRP + 7 * k
            old = [b.local(base + 3 + t) for t in range(4)]
            new = [sout[4 * k + t] for t in range(4)]
            addr = b.add(out_f, b.constant(4 * k))
            mem_port(base, addr,
                     b.add(ts_base, b.constant(RATE_WORDS + k)),
                     old, new, last)
        for j in range(32):
            b.push_send(BYTE_BUS, [sout[j]], last)

        # execution continuation: the instruction completes here
        b.push_send(
            EXEC_BUS,
            [b.add(pc, b.constant(4)),
             b.add(b.add(ts, b.constant(TS_STRIDE)),
                   b.mul(b.constant(KECCAK_BLOCK_TS),
                         b.add(b.local(BLOCK_IDX), one)))],
            last,
        )


def fill_keccak_rows(st, pc: int, ts: int, ptr: int, length: int,
                     out_ptr: int, ram_value) -> Tuple[List[np.ndarray],
                                                       List[List[int]]]:
    """Build the block rows for one keccak syscall.

    st: the shared _TraceState (rv32_v2) — byte counts, xor counts, and the
    RAM offline-checking state are updated through it. ram_value(word_addr)
    -> current word value. Returns (rows, perm_input_states)."""
    assert ptr % 4 == 0 and out_ptr % 4 == 0, "keccak buffers must be aligned"
    assert ptr < (1 << 16) and out_ptr < (1 << 16) and length < (1 << 16)
    assert ptr >= st.data_base and out_ptr >= st.data_base, (
        "keccak buffers must live in RAM (above the program image)")
    n_blocks = length // RATE + 1
    rows: List[np.ndarray] = []
    perm_inputs: List[List[int]] = []
    state = [0] * 25
    for q in range(n_blocks):
        row = np.zeros(NUM_COLS, dtype=np.uint32)
        row[IS_REAL] = 1
        row[REQ_PC], row[REQ_TS] = pc, ts
        row[PTR0], row[PTR1] = ptr & 0xFF, ptr >> 8
        row[LEN0], row[LEN1] = length & 0xFF, length >> 8
        row[OUT0], row[OUT1] = out_ptr & 0xFF, out_ptr >> 8
        row[PTR_Q], row[OUT_Q] = (ptr & 0xFF) >> 2, (out_ptr & 0xFF) >> 2
        row[BLOCK_IDX] = q
        is_first = q == 0
        is_last = q == n_blocks - 1
        if is_first:
            row[IS_FIRST] = 1
            for col in (PTR1, LEN0, LEN1, OUT1):
                st.bcheck(int(row[col]))
            st.bcheck(4 * int(row[PTR_Q]))
            st.bcheck(4 * int(row[OUT_Q]))
        if is_last:
            row[IS_LAST] = 1
        rem = min(max(length - RATE * q, 0), RATE)
        assert rem == RATE or is_last
        for j in range(rem):
            row[P_FLAGS + j] = 1

        ts_base = ts + TS_STRIDE + KECCAK_BLOCK_TS * q
        block_bytes = [0] * RATE
        for w in range(RATE_WORDS):
            if 4 * w >= rem:
                continue
            addr = ptr + RATE * q + 4 * w
            cur_ts = ts_base + w
            ent = st.ram.get(addr)
            prev_ts, val = ent if ent is not None else (0, ram_value(addr))
            base = RDP + 7 * w
            row[base] = prev_ts
            d = cur_ts - prev_ts - 1
            row[base + 1] = st.r16check(d & 0xFFFF)
            row[base + 2] = st.bcheck(d >> 16)
            for k in range(4):
                byte = (val >> (8 * k)) & 0xFF
                row[base + 3 + k] = byte
                block_bytes[4 * w + k] = byte
            st.ram[addr] = (cur_ts, val)

        # padding
        absorbed = list(block_bytes)
        for j in range(rem, RATE):
            absorbed[j] = 0
        if is_last:
            absorbed[rem] ^= 0x01
            absorbed[RATE - 1] ^= 0x80
        for j in range(RATE):
            row[ABS + j] = absorbed[j]

        sin_bytes = [
            (state[i // 8] >> (8 * (i % 8))) & 0xFF for i in range(200)
        ]
        row[SIN : SIN + 200] = sin_bytes
        xored = [st.xcheck(sin_bytes[j], absorbed[j]) for j in range(RATE)]
        row[XRD : XRD + RATE] = xored

        state_in = list(state)
        for i in range(RATE):
            state_in[i // 8] ^= absorbed[i] << (8 * (i % 8))
        perm_inputs.append(state_in)
        state = keccak_f1600(state_in)
        sout_bytes = [
            (state[i // 8] >> (8 * (i % 8))) & 0xFF for i in range(200)
        ]
        row[SOUT : SOUT + 200] = sout_bytes

        if is_last:
            for k in range(8):
                addr = out_ptr + 4 * k
                cur_ts = ts_base + RATE_WORDS + k
                ent = st.ram.get(addr)
                prev_ts, old = ent if ent is not None else (
                    0, ram_value(addr))
                base = WRP + 7 * k
                row[base] = prev_ts
                d = cur_ts - prev_ts - 1
                row[base + 1] = st.r16check(d & 0xFFFF)
                row[base + 2] = st.bcheck(d >> 16)
                for t in range(4):
                    row[base + 3 + t] = (old >> (8 * t)) & 0xFF
                new_word = int.from_bytes(
                    bytes(sout_bytes[4 * k : 4 * k + 4]), "little")
                st.ram[addr] = (cur_ts, new_word)
            for j in range(32):
                st.bcheck(sout_bytes[j])
        rows.append(row)
    return rows, perm_inputs
