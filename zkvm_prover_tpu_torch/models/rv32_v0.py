"""The parts of the reference's RV32 chipset v0 (`zkvm_prover_tpu/models/
rv32_v0.py`) that the v2 chipset and the keccak chips use: the byte and
register bus ids, the byte range table and the register file's boundary
chip.

  MemoryBoundaryAir  initial (ts=0, value 0) sends and final-state receives
                     for the 32 registers: closes the offline
                     memory-checking chains
  ByteTableAir       the 8-bit range table (limb + timestamp-diff checks)

Register values are four 8-bit limbs (`_limbs`).
"""

from __future__ import annotations

from typing import List

from .air import Air, AirBuilder

BYTE_BUS = 10
REG_BUS = 11

N_LIMBS = 4


def _limbs(v: int) -> List[int]:
    return [(v >> (8 * k)) & 0xFF for k in range(N_LIMBS)]


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
