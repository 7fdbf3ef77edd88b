"""DeferralVmAir: the in-guest deferred-verification chip (ECALL a7=8).

The port's copy of the reference's `zkvm_prover_tpu/models/deferral_vm.py`,
the analog of openvm's verify-stark deferral machinery (the guest's
`verify_stark::<0>(input_commit, expected)`). Instead of verifying a child
proof inline, the guest DEFERS it: ECALL a7=8 with a0 = pointer to 64
bytes — keccak(child vk) (32) || child pi-hash (32) — and this chip

  - reads the 16 words from RAM over MEM_BUS (offline memory checking),
  - absorbs their 64 byte limbs into a running Poseidon2 sponge chained
    ACROSS rows (8 rate-8 compressions per request, proven via
    POSEIDON_BUS lookups into Poseidon2Air),
  - exposes the final accumulator digest as this AIR's public values.

The parent proof therefore binds an ordered digest of everything the
guest deferred; the host discharges it with a separate aggregation proof
over the same children, and the verifier rejects unless the two digests
match: the binding lives in the public values, sized by trace rows rather
than a memory carve-out. The discharge and that check are
`host/deferred.py`.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .air import Air, AirBuilder
from .poseidon2_air import POSEIDON_BUS, compress_canonical
from .rv32_v0 import BYTE_BUS
from .rv32_v2 import DEFER_REQ_BUS, EXEC_BUS, MEM_BUS, RANGE16_BUS, TS_STRIDE
from .vm_ext import _fill_port

N_WORDS = 16                # RAM words per request (64 bytes)
N_CHUNKS = 8                # rate-8 sponge absorb steps per request
DIGEST = 8
DEFER_TS_WINDOW = 24        # 16 reads + margin

# --- column layout ---------------------------------------------------------
IS_REAL = 0
REQ_PC = 1
REQ_TS = 2
PTR0, PTR1 = 3, 4
PTR_Q = 5                   # ptr0 = 4*PTR_Q (word alignment)
RDP = 6                     # 16 x [prev_ts, d0, d1, v0..v3] stride 7
ACC_IN = RDP + 7 * N_WORDS  # 118: 8-word accumulator entering this row
CHAIN = ACC_IN + DIGEST     # 126: 8 x 8 intermediate digests
NUM_COLS = CHAIN + N_CHUNKS * DIGEST  # 190


class DeferralVmAir(Air):
    width = NUM_COLS
    num_public_values = DIGEST  # final accumulator digest

    def eval(self, b: AirBuilder) -> None:
        one = b.constant(1)
        c256 = b.constant(256)
        real = b.local(IS_REAL)
        b.assert_bool(real)
        # real rows form a prefix
        b.when_transition().assert_zero(
            b.mul(b.sub(one, real), b.next(IS_REAL)))

        pc, ts = b.local(REQ_PC), b.local(REQ_TS)
        b.push_receive(DEFER_REQ_BUS,
                       [pc, ts, b.local(PTR0), b.local(PTR1)], real)
        b.push_send(BYTE_BUS, [b.local(PTR1)], real)
        q4 = b.mul(b.constant(4), b.local(PTR_Q))
        b.assert_zero(b.mul(real, b.sub(b.local(PTR0), q4)))
        b.push_send(BYTE_BUS, [q4], real)
        ptr_f = b.add(b.local(PTR0), b.mul(c256, b.local(PTR1)))

        ts_base = b.add(ts, b.constant(TS_STRIDE))
        limbs: List = []
        for w in range(N_WORDS):
            base = RDP + 7 * w
            prev_ts = b.local(base)
            vals = [b.local(base + 3 + k) for k in range(4)]
            limbs += vals
            addr = b.add(ptr_f, b.constant(4 * w))
            cur_ts = b.add(ts_base, b.constant(w))
            b.push_receive(MEM_BUS, [addr, prev_ts] + vals, real)
            b.push_send(MEM_BUS, [addr, cur_ts] + vals, real)
            diff = b.sub(b.sub(cur_ts, prev_ts), one)
            recon = b.add(b.local(base + 1),
                          b.mul(b.constant(1 << 16), b.local(base + 2)))
            b.assert_zero(b.mul(real, b.sub(diff, recon)))
            b.push_send(RANGE16_BUS, [b.local(base + 1)], real)
            b.push_send(BYTE_BUS, [b.local(base + 2)], real)

        # sponge chain: c_{-1} = ACC_IN; c_j = P2(c_{j-1} || bytes_j)[:8]
        # (inputs are canonical field elements: byte limbs and Poseidon2
        # digests are both < p)
        acc_in = [b.local(ACC_IN + k) for k in range(DIGEST)]
        prev = acc_in
        for j in range(N_CHUNKS):
            out = [b.local(CHAIN + j * DIGEST + k) for k in range(DIGEST)]
            b.push_send(POSEIDON_BUS,
                        prev + limbs[j * DIGEST : (j + 1) * DIGEST] + out,
                        real)
            prev = out

        # accumulator threading: row 0 starts at zero; padding rows pass
        # the accumulator through so the last row always carries the final
        # digest (acc_out = real ? chain[-1] : acc_in, degree 2)
        for k in range(DIGEST):
            b.when_first_row().assert_zero(b.local(ACC_IN + k))
            acc_out = b.add(b.mul(real, prev[k]),
                            b.mul(b.sub(one, real), acc_in[k]))
            b.when_transition().assert_zero(
                b.sub(b.next(ACC_IN + k), acc_out))
            b.when_last_row().assert_zero(
                b.sub(b.public_value(k), acc_out))

        # execution continuation: the instruction completes here
        b.push_send(
            EXEC_BUS,
            [b.add(pc, b.constant(4)),
             b.add(ts, b.constant(TS_STRIDE + DEFER_TS_WINDOW))],
            real)


def fill_defer_row(st, pc: int, ts: int, ptr: int, acc_in: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray, List[np.ndarray]]:
    """Build one DeferralVmAir row. Returns (row, acc_out, p2_inputs)
    where p2_inputs are the (16,) canonical Poseidon2 inputs the lookup
    chip must serve."""
    assert ptr % 4 == 0 and st.data_base <= ptr < (1 << 16), (
        "defer buffer must be a word-aligned RAM address")
    row = np.zeros(NUM_COLS, dtype=np.uint32)
    row[IS_REAL] = 1
    row[REQ_PC], row[REQ_TS] = pc, ts
    row[PTR0], row[PTR1] = ptr & 0xFF, ptr >> 8
    row[PTR_Q] = (ptr & 0xFF) >> 2
    st.bcheck(ptr >> 8)
    st.bcheck(4 * int(row[PTR_Q]))

    ts_base = ts + TS_STRIDE
    limbs: List[int] = []
    for w in range(N_WORDS):
        val = _fill_port(st, row, RDP + 7 * w, ptr + 4 * w, ts_base + w)
        limbs += val.to_bytes(4, "little")

    row[ACC_IN : ACC_IN + DIGEST] = acc_in
    p2_inputs: List[np.ndarray] = []
    prev = np.asarray(acc_in, dtype=np.uint32)
    for j in range(N_CHUNKS):
        chunk = np.asarray(limbs[j * DIGEST : (j + 1) * DIGEST],
                           dtype=np.uint32)
        inp = np.concatenate([prev, chunk])
        p2_inputs.append(inp)
        prev = compress_canonical(prev[None, :], chunk[None, :])[0]
        row[CHAIN + j * DIGEST : CHAIN + (j + 1) * DIGEST] = prev
    return row, prev, p2_inputs


def chain_digest_from_leaves(leaves: List[bytes]) -> np.ndarray:
    """Host mirror of the chip's sponge chain: leaves are 64-byte blobs
    (keccak(vk) || pi_hash); returns the (8,) canonical digest that
    DeferralVmAir exposes as public values."""
    acc = np.zeros(DIGEST, dtype=np.uint32)
    for leaf in leaves:
        assert len(leaf) == 64
        limbs = np.frombuffer(leaf, dtype=np.uint8).astype(np.uint32)
        for j in range(N_CHUNKS):
            acc = compress_canonical(
                acc[None, :], limbs[j * DIGEST : (j + 1) * DIGEST][None, :]
            )[0]
    return acc
