"""Wire-circuit AIRs: the execution substrate for in-circuit verification.

A wire program is straight-line SSA over BabyBear^4 values ("wires"). Every
wire is defined exactly once and consumed `fanout` times; definition/use
consistency is enforced by a logUp bus (WIRE_BUS) carrying messages
`(wire_id, v0, v1, v2, v3)`: the defining row *sends* with multiplicity =
fanout (preprocessed), every use *receives* with multiplicity 1. The program
itself (opcodes, wire ids, constants) is preprocessed — verification-key
material, recomputed by the verifier — so a proof attests "this fixed
program is satisfied", the wire-circuit analog of openvm's committed
recursion program (reference: crates/prover/src/prover/mod.rs:129-174).

Base-field values ride lane 0 with lanes 1..3 zero; chips that require base
values (Poseidon2 inputs) receive `(wid, v, 0, 0, 0)`, so a non-base value
on such a wire can never balance the bus — base-ness needs no extra
constraints.

The port's copy of the reference's `zkvm_prover_tpu/recursion/wire_air.py`
over the port's builders: the same constraints, buses and `serialize_air`
streams.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..models.air import Air, AirBuilder
from ..models.poseidon2_air import POSEIDON_FULL_BUS

WIRE_BUS = 40

W_EXT = 11  # ext4 tower constant (fields/ext4.py W_INT)

# ALU opcodes (one-hot preprocessed flags)
OP_ADD, OP_SUB, OP_MUL, OP_CONST, OP_WIT, OP_BIT, OP_AZ = range(7)
N_OPS = 7


class WireAluAir(Air):
    """One wire op per row.

    preprocessed: [op flags (7)] [w_out] [w_in1] [w_in2] [use1] [use2]
                  [fanout] [const (4)] = 17 columns
    main:         in1 (4) | in2 (4) | out (4) = 12 columns
    """

    # preprocessed layout
    P_OP = 0              # 7 one-hot flags
    P_WOUT = 7
    P_WIN1 = 8
    P_WIN2 = 9
    P_USE1 = 10
    P_USE2 = 11
    P_FAN = 12
    P_CONST = 13          # 4
    preprocessed_width = 17

    # main layout
    IN1 = 0
    IN2 = 4
    OUT = 8
    width = 12
    num_public_values = 0

    def __init__(self, program: Optional[np.ndarray] = None):
        """program: (n, preprocessed_width) canonical uint32 (the compiled
        wire program), or None for a verifier constructing from a vk dump."""
        self.program = program

    def preprocessed_trace(self):
        return self.program

    def eval(self, b: AirBuilder) -> None:
        C = WireAluAir
        f = [b.preprocessed(C.P_OP + k) for k in range(N_OPS)]
        in1 = [b.local(C.IN1 + k) for k in range(4)]
        in2 = [b.local(C.IN2 + k) for k in range(4)]
        out = [b.local(C.OUT + k) for k in range(4)]
        cst = [b.preprocessed(C.P_CONST + k) for k in range(4)]
        one = b.constant(1)

        for k in range(4):
            b.assert_zero(b.mul(f[OP_ADD],
                                b.sub(out[k], b.add(in1[k], in2[k]))))
            b.assert_zero(b.mul(f[OP_SUB],
                                b.sub(out[k], b.sub(in1[k], in2[k]))))
            b.assert_zero(b.mul(f[OP_CONST], b.sub(out[k], cst[k])))
            b.assert_zero(b.mul(f[OP_AZ], in1[k]))

        # ext4 mul: out_k = sum_{i+j=k} a_i b_j + W * sum_{i+j=k+4} a_i b_j
        for k in range(4):
            acc = None
            for i in range(4):
                for j in range(4):
                    if (i + j) % 4 != k:
                        continue
                    term = b.mul(in1[i], in2[j])
                    if i + j >= 4:
                        term = b.mul(b.constant(W_EXT), term)
                    acc = term if acc is None else b.add(acc, term)
            b.assert_zero(b.mul(f[OP_MUL], b.sub(out[k], acc)))

        # BIT: boolean witness in lane 0, zero elsewhere
        b.assert_zero(b.mul(f[OP_BIT], b.mul(out[0], b.sub(out[0], one))))
        for k in range(1, 4):
            b.assert_zero(b.mul(f[OP_BIT], out[k]))

        b.push_receive(WIRE_BUS, [b.preprocessed(C.P_WIN1)] + in1,
                       b.preprocessed(C.P_USE1))
        b.push_receive(WIRE_BUS, [b.preprocessed(C.P_WIN2)] + in2,
                       b.preprocessed(C.P_USE2))
        b.push_send(WIRE_BUS, [b.preprocessed(C.P_WOUT)] + out,
                    b.preprocessed(C.P_FAN))


class WirePoseidonAir(Air):
    """One Poseidon2 width-16 permutation per row, wired into the program.

    preprocessed: is_real | in wire ids (16) | out wire ids (16) |
                  out fanouts (16) = 49 columns
    main:         in values (16) | out values (16) = 32 columns

    The (input, output) pair is proven by the shared `Poseidon2Air` table
    via POSEIDON_FULL_BUS.
    """

    P_REAL = 0
    P_WIN = 1
    P_WOUT = 17
    P_FAN = 33
    preprocessed_width = 49

    VIN = 0
    VOUT = 16
    width = 32
    num_public_values = 0

    def __init__(self, program: Optional[np.ndarray] = None):
        self.program = program

    def preprocessed_trace(self):
        return self.program

    def eval(self, b: AirBuilder) -> None:
        C = WirePoseidonAir
        real = b.preprocessed(C.P_REAL)
        vin = [b.local(C.VIN + k) for k in range(16)]
        vout = [b.local(C.VOUT + k) for k in range(16)]
        zero = b.constant(0)
        for k in range(16):
            b.push_receive(
                WIRE_BUS,
                [b.preprocessed(C.P_WIN + k), vin[k], zero, zero, zero],
                real,
            )
            b.push_send(
                WIRE_BUS,
                [b.preprocessed(C.P_WOUT + k), vout[k], zero, zero, zero],
                b.preprocessed(C.P_FAN + k),
            )
        b.push_send(POSEIDON_FULL_BUS, vin + vout, real)


class PublicBindAir(Air):
    """Binds the proof's public values to reserved wires.

    PV layout: 4 felts per "slot"; slot s is wire id (s+1) carrying the ext
    element (pv[4s], pv[4s+1], pv[4s+2], pv[4s+3]). The program consumes
    each slot wire exactly once (the builder guarantees fanout 1).
    """

    IS_FIRST = 0
    width = 1

    def __init__(self, n_slots: int):
        self.n_slots = n_slots
        self.num_public_values = 4 * n_slots

    def eval(self, b: AirBuilder) -> None:
        is_first = b.local(PublicBindAir.IS_FIRST)
        b.assert_bool(is_first)
        b.when_first_row().assert_eq(is_first, b.constant(1))
        b.when_transition().assert_zero(b.next(PublicBindAir.IS_FIRST))
        for s in range(self.n_slots):
            b.push_send(
                WIRE_BUS,
                [b.constant(s + 1)]
                + [b.public_value(4 * s + k) for k in range(4)],
                is_first,
            )

    @staticmethod
    def trace(n_rows: int = 4) -> np.ndarray:
        t = np.zeros((n_rows, 1), dtype=np.uint32)
        t[0, 0] = 1
        return t
