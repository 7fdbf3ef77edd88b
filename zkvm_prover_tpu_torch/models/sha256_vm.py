"""Sha256VmAir: the sha256 syscall chip (one 64-byte block per row) for
the rv32 v2 machine.

The port's copy of the reference's `zkvm_prover_tpu/models/sha256_vm.py`,
the analog of openvm's sha256 VM extension chip. The guest issues ECALL a7=6 with
(a0=msg ptr, a1=len, a2=out ptr); `SystemAir` reads the registers and
hands the request over SHA_REQ_BUS; this chip

  - reads the message words from RAM over MEM_BUS (offline memory
    checking, one 32-slot timestamp window per block row),
  - applies the Merkle-Damgard padding in-constraints: monotone prefix
    flags select message bytes, the 0x80 terminator lands on the
    HAS_END block, and the final block carries the 64-bit big-endian
    bit length (8*len < 2^19 -> three witnessed length bytes),
  - proves each compression by sending (h_in || block || h_out)
    16-bit-limb messages to Sha256Air over SHA256_BUS,
  - chains h across the block rows of one request (h_in of the first
    block is the SHA-256 IV, enforced as constants),
  - on the final block: writes the 32-byte big-endian digest to RAM and
    sends the execution-chain continuation (pc+4) on EXEC_BUS, owning
    the instruction's full timestamp window.

Unlike keccak's sponge (fixed 0x01..0x80 pad in the same rate block),
SHA-256's length field can overflow into an extra block: the block
holding the message end (HAS_END) is the last block iff rem <= 55
(equivalently p_55 = 0), otherwise exactly one length-only block
follows. Both facts are constraint-enforced, so a prover cannot skip
the terminator or forge the length binding.

Pointers/lengths are bounded < 2^16 (SystemAir constrains the high
limbs to zero), so single-felt MEM_BUS addresses need no carry chains.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .air import Air, AirBuilder
from .rv32_v0 import BYTE_BUS
from .rv32_v2 import EXEC_BUS, SHA_REQ_BUS, TS_STRIDE
from .sha256_air import _H_INIT, SHA256_BUS, sha256_compress
from .vm_ext import _fill_port, _mem_port

BLOCK = 64
BLOCK_WORDS = BLOCK // 4        # 16
SHA_BLOCK_TS = 32               # 16 reads + 8 writes + margin per block

# --- column layout ---------------------------------------------------------
IS_REAL = 0
IS_FIRST = 1
IS_LAST = 2
HAS_END = 3                     # the message's final byte is in this block
CONT = 4                        # real * (1 - last), materialized for degree
REQ_PC = 5
REQ_TS = 6
PTR0, PTR1 = 7, 8
LEN0, LEN1 = 9, 10
OUT0, OUT1 = 11, 12
PTR_Q, OUT_Q = 13, 14           # ptr0 = 4*PTR_Q, out0 = 4*OUT_Q (alignment)
BLOCK_IDX = 15
RDP = 16                        # 16 x [prev_ts, d0, d1, v0..v3] stride 7
P_FLAGS = RDP + 7 * BLOCK_WORDS           # 128: 64 prefix flags
ABS = P_FLAGS + BLOCK                     # 192: 64 absorbed bytes
LB = ABS + BLOCK                          # 256: 3 bit-length bytes (BE tail)
H_CUR = LB + 3                            # 259: 16 limbs h_in (lo,hi / word)
H_NXT = H_CUR + 16                        # 275: 16 limbs h_out
DIG = H_NXT + 16                          # 291: 32 digest bytes (RAM order)
WRP = DIG + 32                            # 323: 8 x [prev_ts, d0, d1, old0..3]
NUM_COLS = WRP + 7 * 8                    # 379
SHA_NUM_COLS = NUM_COLS


class Sha256VmAir(Air):
    width = NUM_COLS
    num_public_values = 0

    def eval(self, b: AirBuilder) -> None:
        one = b.constant(1)
        c256 = b.constant(256)
        real = b.local(IS_REAL)
        first = b.local(IS_FIRST)
        last = b.local(IS_LAST)
        has_end = b.local(HAS_END)
        cont = b.local(CONT)
        for f in (real, first, last, has_end):
            b.assert_bool(f)
        b.assert_zero(b.mul(first, b.sub(real, one)))
        b.assert_zero(b.mul(last, b.sub(real, one)))
        b.assert_zero(b.mul(has_end, b.sub(real, one)))
        # cont = real * (1 - last): witnessed so gated transition
        # constraints stay within MAX_DEGREE = 3
        b.assert_eq(cont, b.mul(real, b.sub(one, last)))

        # real rows form a prefix; block groups are delimited by first/last
        b.when_transition().assert_zero(
            b.mul(b.sub(one, real), b.next(IS_REAL)))
        b.when_first_row().assert_zero(b.mul(real, b.sub(first, one)))
        b.when_transition().assert_zero(b.mul(cont, b.sub(b.next(IS_REAL),
                                                          one)))
        b.when_transition().assert_zero(b.mul(cont, b.next(IS_FIRST)))
        b.when_transition().assert_zero(
            b.mul(cont, b.sub(b.next(BLOCK_IDX),
                              b.add(b.local(BLOCK_IDX), one))))
        for col in (REQ_PC, REQ_TS, PTR0, PTR1, LEN0, LEN1, OUT0, OUT1):
            b.when_transition().assert_zero(
                b.mul(cont, b.sub(b.next(col), b.local(col))))
        b.when_transition().assert_zero(
            b.mul(last, b.sub(b.next(IS_REAL), b.next(IS_FIRST))))
        b.when_last_row().assert_zero(b.mul(real, b.sub(one, last)))
        b.assert_zero(b.mul(first, b.local(BLOCK_IDX)))

        # request handoff (SystemAir owns the register reads)
        pc, ts = b.local(REQ_PC), b.local(REQ_TS)
        b.push_receive(
            SHA_REQ_BUS,
            [pc, ts, b.local(PTR0), b.local(PTR1), b.local(LEN0),
             b.local(LEN1), b.local(OUT0), b.local(OUT1)],
            first,
        )
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
        p = [b.local(P_FLAGS + j) for j in range(BLOCK)]
        for j in range(BLOCK):
            b.assert_bool(p[j])
        for j in range(BLOCK - 1):
            b.assert_zero(b.mul(p[j + 1], b.sub(one, p[j])))
        rem = p[0]
        for j in range(1, BLOCK):
            rem = b.add(rem, p[j])

        # block-category structure (see module docstring):
        #   full-message blocks (not has_end, not last): rem = 64
        b.assert_zero(b.mul(b.mul(b.sub(real, last),
                                  b.sub(one, has_end)),
                            b.sub(rem, b.constant(BLOCK))))
        #   has_end block binds the request length
        b.assert_zero(b.mul(has_end, b.sub(
            len_f, b.add(b.mul(b.constant(BLOCK), b.local(BLOCK_IDX)),
                         rem))))
        #   length-only block (last, no end): no message bytes
        b.assert_zero(b.mul(b.mul(last, b.sub(one, has_end)), p[0]))
        #   the has_end block carries at most 63 message bytes (rem <= 63):
        #   without this, a block-aligned message admits a forged trace
        #   with has_end on the last FULL block (rem = 64 satisfies the
        #   length binding too) where no byte gets the 0x80 terminator
        b.assert_zero(b.mul(has_end, p[63]))
        #   has_end & last  <=> rem <= 55  <=> p_55 = 0
        b.assert_zero(b.mul(b.mul(has_end, last), p[55]))
        b.assert_zero(b.mul(b.mul(has_end, b.sub(one, last)),
                            b.sub(p[55], one)))
        #   the block after a non-final has_end is the length-only block
        b.when_transition().assert_zero(
            b.mul(b.mul(has_end, b.sub(one, last)),
                  b.sub(b.next(IS_LAST), one)))
        b.when_transition().assert_zero(
            b.mul(b.mul(has_end, b.sub(one, last)), b.next(HAS_END)))
        #   every group ends: a last block has the end here or just before
        b.when_transition().assert_zero(
            b.mul(b.mul(cont, b.next(IS_LAST)),
                  b.sub(b.add(has_end, b.next(HAS_END)), one)))
        #   single-block groups carry their own end (the transition rule
        #   above only sees multi-block groups)
        b.assert_zero(b.mul(b.mul(first, last), b.sub(has_end, one)))

        # timestamp window base for this block row
        ts_base = b.add(b.add(ts, b.constant(TS_STRIDE)),
                        b.mul(b.constant(SHA_BLOCK_TS),
                              b.local(BLOCK_IDX)))

        # message word reads (word w needed iff byte 4w is message)
        block_off = b.mul(b.constant(BLOCK), b.local(BLOCK_IDX))
        for w in range(BLOCK_WORDS):
            base = RDP + 7 * w
            vals = [b.local(base + 3 + k) for k in range(4)]
            addr = b.add(ptr_f, b.add(block_off, b.constant(4 * w)))
            _mem_port(b, base, addr, b.add(ts_base, b.constant(w)),
                      vals, vals, p[4 * w])

        # bit-length bytes: 8*len = LB0 + 256*LB1 + 65536*LB2 (len < 2^16)
        lb = [b.local(LB + i) for i in range(3)]
        for v in lb:
            b.push_send(BYTE_BUS, [v], last)
        b.assert_zero(b.mul(last, b.sub(
            b.add(lb[0], b.add(b.mul(c256, lb[1]),
                               b.mul(b.constant(1 << 16), lb[2]))),
            b.mul(b.constant(8), len_f))))

        # absorbed bytes: message prefix + 0x80 terminator + length tail
        absb = [b.local(ABS + j) for j in range(BLOCK)]
        for j in range(BLOCK):
            ram_byte = b.local(RDP + 7 * (j // 4) + 3 + (j % 4))
            first_pad = b.sub(one, p[j]) if j == 0 else \
                b.mul(b.sub(one, p[j]), p[j - 1])
            expr = b.add(b.mul(p[j], ram_byte),
                         b.mul(b.constant(0x80), b.mul(has_end, first_pad)))
            if j >= 61:
                expr = b.add(expr, b.mul(last, lb[63 - j]))
            b.assert_zero(b.sub(absb[j], expr))

        # compression lookup: h_in chained from the IV
        h_cur = [b.local(H_CUR + i) for i in range(16)]
        h_nxt = [b.local(H_NXT + i) for i in range(16)]
        for j in range(8):
            b.assert_zero(b.mul(first, b.sub(
                h_cur[2 * j], b.constant(_H_INIT[j] & 0xFFFF))))
            b.assert_zero(b.mul(first, b.sub(
                h_cur[2 * j + 1], b.constant(_H_INIT[j] >> 16))))
        for i in range(16):
            b.when_transition().assert_zero(
                b.mul(cont, b.sub(b.next(H_CUR + i), h_nxt[i])))

        # SHA256_BUS message: h_in(16) || msg words(32) || h_out(16);
        # W_t is the big-endian word of the block bytes
        msg = list(h_cur)
        for t in range(BLOCK_WORDS):
            lo = b.add(absb[4 * t + 3], b.mul(c256, absb[4 * t + 2]))
            hi = b.add(absb[4 * t + 1], b.mul(c256, absb[4 * t]))
            msg += [lo, hi]
        msg += h_nxt
        b.push_send(SHA256_BUS, msg, real)

        # final block: digest bytes in RAM order (big-endian per word)
        dig = [b.local(DIG + j) for j in range(32)]
        for k in range(8):
            b.assert_zero(b.mul(last, b.sub(
                h_nxt[2 * k + 1],
                b.add(dig[4 * k + 1], b.mul(c256, dig[4 * k])))))
            b.assert_zero(b.mul(last, b.sub(
                h_nxt[2 * k],
                b.add(dig[4 * k + 3], b.mul(c256, dig[4 * k + 2])))))
        for j in range(32):
            b.push_send(BYTE_BUS, [dig[j]], last)
        for k in range(8):
            base = WRP + 7 * k
            old = [b.local(base + 3 + t) for t in range(4)]
            new = dig[4 * k : 4 * k + 4]
            addr = b.add(out_f, b.constant(4 * k))
            _mem_port(b, base, addr,
                      b.add(ts_base, b.constant(BLOCK_WORDS + k)),
                      old, new, last)

        # execution continuation: the instruction completes here
        b.push_send(
            EXEC_BUS,
            [b.add(pc, b.constant(4)),
             b.add(b.add(ts, b.constant(TS_STRIDE)),
                   b.mul(b.constant(SHA_BLOCK_TS),
                         b.add(b.local(BLOCK_IDX), one)))],
            last,
        )


def fill_sha256_rows(st, pc: int, ts: int, ptr: int, length: int,
                     out_ptr: int) -> Tuple[List[np.ndarray],
                                            List[Tuple]]:
    """Build the block rows for one sha256 syscall.

    st: the shared _TraceState (rv32_v2). Returns (rows, compressions)
    where compressions are the (h_in[8], msg[16]) tuples Sha256Air must
    serve."""
    assert ptr % 4 == 0 and out_ptr % 4 == 0, "sha buffers must be aligned"
    assert ptr < (1 << 16) and out_ptr < (1 << 16) and length < (1 << 16)
    assert ptr >= st.data_base and out_ptr >= st.data_base, (
        "sha buffers must live in RAM (above the program image)")
    n_blocks = (length + 8) // BLOCK + 1
    end_block = length // BLOCK
    rows: List[np.ndarray] = []
    compressions: List[Tuple] = []
    h = list(_H_INIT)
    bitlen = 8 * length
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
        else:
            row[CONT] = 1
        if q == end_block:
            row[HAS_END] = 1
        rem = min(max(length - BLOCK * q, 0), BLOCK)
        if q == end_block:
            # the in-constraint uniqueness of (idx, rem) relies on the
            # end block holding <= 63 message bytes (p[63] = 0 there)
            assert rem <= BLOCK - 1, "has_end block must leave pad room"
        for j in range(rem):
            row[P_FLAGS + j] = 1

        ts_base = ts + TS_STRIDE + SHA_BLOCK_TS * q
        block_bytes = [0] * BLOCK
        for w in range(BLOCK_WORDS):
            if 4 * w >= rem:
                continue
            val = _fill_port(st, row, RDP + 7 * w, ptr + BLOCK * q + 4 * w, ts_base + w)
            block_bytes[4 * w : 4 * w + 4] = val.to_bytes(4, "little")

        absorbed = [block_bytes[j] if j < rem else 0 for j in range(BLOCK)]
        if q == end_block:
            absorbed[rem] = 0x80  # rem <= 63 here
        if is_last:
            row[LB] = st.bcheck(bitlen & 0xFF)
            row[LB + 1] = st.bcheck((bitlen >> 8) & 0xFF)
            row[LB + 2] = st.bcheck(bitlen >> 16)
            absorbed[61] |= bitlen >> 16
            absorbed[62] |= (bitlen >> 8) & 0xFF
            absorbed[63] |= bitlen & 0xFF
        row[ABS : ABS + BLOCK] = absorbed

        msg_words = [
            (absorbed[4 * t] << 24) | (absorbed[4 * t + 1] << 16)
            | (absorbed[4 * t + 2] << 8) | absorbed[4 * t + 3]
            for t in range(BLOCK_WORDS)
        ]
        h_in = list(h)
        compressions.append((h_in, msg_words))
        h = sha256_compress(h, msg_words)
        for j in range(8):
            row[H_CUR + 2 * j] = h_in[j] & 0xFFFF
            row[H_CUR + 2 * j + 1] = h_in[j] >> 16
            row[H_NXT + 2 * j] = h[j] & 0xFFFF
            row[H_NXT + 2 * j + 1] = h[j] >> 16

        if is_last:
            dig_bytes = []
            for k in range(8):
                for t in (24, 16, 8, 0):
                    dig_bytes.append((h[k] >> t) & 0xFF)
            for j, v in enumerate(dig_bytes):
                row[DIG + j] = st.bcheck(v)
            for k in range(8):
                _fill_port(st, row, WRP + 7 * k, out_ptr + 4 * k, ts_base + BLOCK_WORDS + k,
                           int.from_bytes(bytes(dig_bytes[4 * k : 4 * k + 4]), "little"))
        rows.append(row)
    return rows, compressions

