"""Guest programs assembled with the port's `asm`.

`hash_reveal_program` is the chunk app's guest (the reference's
`zkvm_prover_tpu/vm/guests.py`): it reads the PI preimage from the hint
stream, hashes it with the keccak syscall and reveals the digest as the
machine's public values. `bench_guest_program` is the port's copy of the
benchmark guest in the repo's `bench.py`: `bench_guest_program(8, 256)`
runs 24,729 cycles and yields the 18 AIRs of the rv32 machine proof that
`chip_smoke.py` times; `bench_guest_program(1, 4)` runs 124 cycles with one
keccak call and yields the same 18 AIRs at small heights.
"""

from __future__ import annotations

from typing import List

from . import asm

MSG_BASE = 0x3000
OUT_BASE = 0x2F00          # digest buffer (below MSG_BASE, above data base)
DATA_BASE = 0x2F00


def hash_reveal_program() -> List[int]:
    """The PI-hash guest: read a length-prefixed byte stream from the hint
    stream, store it to RAM, keccak256 it via the syscall, and reveal the
    32-byte digest as the machine's public values.

    Hint stream layout: word 0 = byte length L, then ceil(L/4) words of
    little-endian message bytes.
    """
    body = [
        *asm.hint_read("s1"),            # s1 = L
        asm.addi("t0", "s1", 3),
        asm.srli("s2", "t0", 2),         # s2 = n_words
        asm.addi("s0", "zero", 0),       # i = 0
        *asm.li("s3", MSG_BASE),
        ("label", "loop"),
        ("branch", asm.beq, "s0", "s2", "done"),
        *asm.hint_read("t0"),
        asm.slli("t1", "s0", 2),
        asm.add("t1", "t1", "s3"),
        asm.sw("t0", "t1", 0),
        asm.addi("s0", "s0", 1),
        # loop back with an always-taken branch (v2 forbids rd=x0 writes,
        # so `jal zero` is unavailable)
        ("branch", asm.beq, "zero", "zero", "loop"),
        ("label", "done"),
        # keccak256(MSG_BASE, L, OUT_BASE)
        *asm.li("a0", MSG_BASE),
        asm.add("a1", "s1", "zero"),
        *asm.li("a2", OUT_BASE),
        *asm.li("a7", 3),
        asm.ecall(),
    ]
    for i in range(8):
        body += [
            *asm.li("t1", OUT_BASE + 4 * i),
            asm.lw("t0", "t1", 0),
            *asm.reveal("t0", i),
        ]
    body.append(asm.halt(0))
    return asm.assemble(body)


def hash_hints(message: bytes) -> bytes:
    """Hint stream for hash_reveal_program."""
    padded = message + b"\x00" * (-len(message) % 4)
    return len(message).to_bytes(4, "little") + padded


def bench_guest_program(n_outer=64, n_inner=128) -> List[int]:
    """Guest touching every chip family, one keccak syscall per outer
    iteration (interleaving keeps every register/RAM region within the
    16-bit timestamp-diff window of the offline memory argument)."""
    msg_base, out_base = 0x3000, 0x3200
    body = [
        *asm.li("s4", 0),                 # outer counter
        *asm.li("s5", n_outer),
        *asm.li("s1", n_inner),
        *asm.li("s2", 0x9E3779B9),        # accumulator
        *asm.li("s3", msg_base),
        ("label", "outer"),
        *asm.li("s0", 0),                 # inner counter
        ("label", "loop"),
        asm.mul("t0", "s2", "s2"),
        asm.addi("t0", "t0", 0x2D),
        asm.xor("s2", "s2", "t0"),
        asm.srli("t1", "s2", 3),
        asm.add("s2", "s2", "t1"),
        asm.andi("t2", "s0", 0x3C),       # rotating 16-word window
        asm.add("t2", "t2", "s3"),
        asm.sw("s2", "t2", 0),
        asm.lw("t3", "t2", 0),
        asm.divu("t4", "s2", "s1"),
        asm.addi("s0", "s0", 1),
        ("branch", asm.bne, "s0", "s1", "loop"),
        # keccak over the window -> out (touches both RAM regions + a0-a7)
        *asm.li("a0", msg_base), *asm.li("a1", 64),
        *asm.li("a2", out_base), *asm.li("a7", 3), asm.ecall(),
        asm.lw("t5", "a2", 0),            # feed the digest back in
        asm.sw("t5", "s3", 0),
        asm.addi("s4", "s4", 1),
        ("branch", asm.bne, "s4", "s5", "outer"),
    ]
    for i in range(8):
        body += [
            *asm.li("t1", out_base + 4 * i),
            asm.lw("t0", "t1", 0),
            *asm.reveal("t0", i),
        ]
    body.append(asm.halt(0))
    return asm.assemble(body)
