"""Guest programs assembled with the port's `asm`.

`hash_reveal_program` is the chunk app's guest (the reference's
`zkvm_prover_tpu/vm/guests.py`): it reads the PI preimage from the hint
stream, hashes it with the keccak syscall and reveals the digest as the
machine's public values. `bench_guest_program` is the port's copy of the
benchmark guest in the repo's `bench.py`: `bench_guest_program(8, 256)`
runs 24,729 cycles and yields the 18 AIRs of the rv32 machine proof that
`chip_smoke.py` times; `bench_guest_program(1, 4)` runs 124 cycles with one
keccak call and yields the same 18 AIRs at small heights.
`deferred_agg_program` is the guest of the deferred-aggregation app
(`host/deferred.py`): it defers each child's verification and reveals
the keccak of the leaves.
`ecdsa_verify_program` verifies one secp256k1 ECDSA signature with the
modular and EC syscalls and then makes every other extension syscall once
(keccak, sha256, fp2, defer): the guest of `chip_smoke.py`'s ext-guest
phase.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

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


def deferred_agg_program() -> List[int]:
    """The deferred-aggregation guest: for each child proof, read a 64-byte
    leaf (keccak(child vk) || child pi-hash) from the hint stream, store it
    to RAM and DEFER its verification (ECALL a7=8); then keccak256 the
    concatenated leaves and reveal the digest.

    The reference batch/bundle guests' deferred `verify_stark` calls
    (crates/circuits/batch-circuit/src/main.rs:10-35 with
    crates/types/circuit/src/lib.rs:147-153): child validity is not proven
    here. DeferralVmAir's digest binds the ordered leaf list, and the host
    attaches a discharge proof (host/deferred.py).

    Hint stream layout: word 0 = N children, then N x 16 words of leaf
    bytes (little-endian).
    """
    body = [
        *asm.hint_read("s1"),            # s1 = N children
        *asm.li("s3", MSG_BASE),         # leaf cursor
        *asm.li("s5", 16),               # words per leaf
        *asm.li("s0", 0),                # i = 0
        ("label", "outer"),
        ("branch", asm.beq, "s0", "s1", "done"),
        *asm.li("s4", 0),                # j = 0
        ("label", "inner"),
        ("branch", asm.beq, "s4", "s5", "after"),
        *asm.hint_read("t0"),
        asm.slli("t1", "s4", 2),
        asm.add("t1", "t1", "s3"),
        asm.sw("t0", "t1", 0),
        asm.addi("s4", "s4", 1),
        ("branch", asm.beq, "zero", "zero", "inner"),
        ("label", "after"),
        asm.add("a0", "s3", "zero"),     # defer_verify(s3)
        *asm.li("a7", 8),
        asm.ecall(),
        asm.addi("s3", "s3", 64),
        asm.addi("s0", "s0", 1),
        ("branch", asm.beq, "zero", "zero", "outer"),
        ("label", "done"),
        # keccak256(MSG_BASE, 64*N, OUT_BASE) over the leaf concatenation
        *asm.li("a0", MSG_BASE),
        asm.slli("a1", "s1", 6),
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


def deferred_agg_hints(leaves: List[bytes]) -> bytes:
    """Hint stream for deferred_agg_program (64-byte leaves)."""
    if not all(len(leaf) == 64 for leaf in leaves):
        raise ValueError("a deferral leaf is 64 bytes")
    return len(leaves).to_bytes(4, "little") + b"".join(leaves)


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


# secp256k1 (SEC 2): y^2 = x^3 + 7 over F_p, the generator G of prime order n
SECP256K1_P = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F
SECP256K1_N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
SECP256K1_G = (0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798,
               0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8)
MOD_SECP256K1_P, MOD_SECP256K1_N, MOD_BN254_FQ = 2, 3, 0   # modulus indices


def ec_add_affine(p1, p2, m: int = SECP256K1_P):
    """P1 + P2 on an a = 0 curve over F_m (None is the point at infinity)."""
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    (x1, y1), (x2, y2) = p1, p2
    if x1 == x2:
        if (y1 + y2) % m == 0:
            return None
        lam = 3 * x1 * x1 * pow(2 * y1, -1, m) % m
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, m) % m
    x3 = (lam * lam - x1 - x2) % m
    return x3, (lam * (x1 - x3) - y1) % m


def ec_mul_affine(k: int, pt, m: int = SECP256K1_P):
    out = None
    for bit in bin(k)[2:]:
        out = ec_add_affine(out, out, m)
        if bit == "1":
            out = ec_add_affine(out, pt, m)
    return out


def _store_words(data: bytes, addr: int) -> list:
    data = data + bytes(-len(data) % 4)
    out = []
    for i in range(0, len(data), 4):
        out += asm.li("t0", int.from_bytes(data[i:i + 4], "little"))
        out += asm.li("t1", addr + i)
        out.append(asm.sw("t0", "t1", 0))
    return out


def _store256(vals, addr: int) -> list:
    return _store_words(b"".join(v.to_bytes(32, "little") for v in vals), addr)


def _signature(rng, scalar_bits: int):
    """(d, z, r, s, u1, u2): a key, a digest and a valid signature (r, s)
    whose verification scalars u1 = z/s, u2 = r/s (mod n) the double-and-add
    runs over. At 256 bits the nonce k is drawn and (r, s) computed from it;
    below, u1 and u2 are drawn with `scalar_bits` bits and (r, s, z) derived
    from them (then k = u1 + u2 d), so the guest does less EC work."""
    n, g = SECP256K1_N, SECP256K1_G

    def draw(bits):
        return int.from_bytes(rng.bytes(32), "little") % (1 << bits) | (1 << (bits - 1))

    d = draw(256) % n
    q = ec_mul_affine(d, g)
    if scalar_bits >= 256:
        z, k = draw(256) % n, draw(256) % n
        r = ec_mul_affine(k, g)[0] % n
        s = pow(k, -1, n) * (z + r * d) % n
        w = pow(s, -1, n)
        return d, q, z, r, s, z * w % n, r * w % n
    u1, u2 = draw(scalar_bits), draw(scalar_bits)
    r = ec_add_affine(ec_mul_affine(u1, g), ec_mul_affine(u2, q))[0] % n
    s = r * pow(u2, -1, n) % n
    return d, q, u1 * s % n, r, s, u1, u2


def _double_and_add(acc: int, pt: int, scalar: int) -> list:
    """acc = scalar * P (P at `pt`), in place and unrolled over the scalar's
    bits: copy P, then per lower bit a doubling and, where the bit is set,
    an addition of P."""
    out = []
    for w in range(16):
        out += asm.li("t1", pt + 4 * w)
        out.append(asm.lw("t0", "t1", 0))
        out += asm.li("t1", acc + 4 * w)
        out.append(asm.sw("t0", "t1", 0))
    for bit in bin(scalar)[3:]:
        out += asm.ec_double(acc, acc, MOD_SECP256K1_P)
        if bit == "1":
            out += asm.ec_add(acc, acc, pt, MOD_SECP256K1_P)
    return out


# the guest's data (and the trace builder's data_base): above its program
# image (about 7k words at 256-bit scalars), below the syscalls' 2^16 limit
ECDSA_BASE = 0x8000


def ecdsa_verify_program(seed: int = 0, scalar_bits: int = 256) -> Tuple[List[int], Dict]:
    """One secp256k1 ECDSA verification as a guest, then one call of every
    other extension syscall. The key, digest and nonce come from `seed`.

    The guest computes w = 1/s (MODOP_DIV), u1 = z w and u2 = r w (MODOP_MUL,
    mod n) and halts with exit code 1 unless they equal the scalars the
    double-and-add was unrolled over; it computes R = u1 G + u2 Q with
    ec_double / ec_add (mod p) and reveals x(R) as the 8 public-value words.
    Then: keccak256 of the 64-byte Q (the address step), sha256 of 150
    seeded bytes, fp2 MUL / ADD / SUB over BN254 Fq, and two defer calls over
    seeded 64-byte leaves. Returns (words, info): `info` holds the inputs
    and the RAM addresses of every result."""
    rng = np.random.default_rng([seed, scalar_bits])
    d, q, z, r, s, u1, u2 = _signature(rng, scalar_bits)
    p1 = ec_mul_affine(u1, SECP256K1_G)
    p2 = ec_mul_affine(u2, q)
    assert p1[0] != p2[0], "u1 G and u2 Q share an x coordinate"
    b = ECDSA_BASE
    a = {"s": b, "z": b + 0x20, "r": b + 0x40, "one": b + 0x60, "w": b + 0x80,
         "u1": b + 0xA0, "u2": b + 0xC0, "G": b + 0x100, "Q": b + 0x140,
         "acc1": b + 0x180, "acc2": b + 0x1C0, "R": b + 0x200, "keccak": b + 0x300,
         "sha": b + 0x320, "msg": b + 0x400, "fx": b + 0x500, "fy": b + 0x540, "fmul": b + 0x580, "fadd": b + 0x5C0,
         "fsub": b + 0x600, "leaves": b + 0x700}
    msg = rng.bytes(150)
    fx = [int.from_bytes(rng.bytes(32), "little") % (1 << 253) for _ in range(2)]
    fy = [int.from_bytes(rng.bytes(32), "little") % (1 << 253) for _ in range(2)]
    leaves = [rng.bytes(64) for _ in range(2)]
    body = (_store256([s, z, r, 1], a["s"]) + _store256([*SECP256K1_G, *q], a["G"])
            + _store_words(msg, a["msg"]) + _store256(fx + fy, a["fx"])
            + _store_words(b"".join(leaves), a["leaves"]))
    # the verification scalars, checked against the unrolled ones
    body += asm.modop(a["w"], a["one"], a["s"], asm.MODOP_DIV, MOD_SECP256K1_N)
    body += asm.modop(a["u1"], a["z"], a["w"], asm.MODOP_MUL, MOD_SECP256K1_N)
    body += asm.modop(a["u2"], a["r"], a["w"], asm.MODOP_MUL, MOD_SECP256K1_N)
    for name, val in (("u1", u1), ("u2", u2)):
        for i in range(8):
            body += asm.li("t1", a[name] + 4 * i)
            body.append(asm.lw("t0", "t1", 0))
            body += asm.li("t1", (val >> (32 * i)) & 0xFFFFFFFF)
            body.append(("branch", asm.bne, "t0", "t1", "bad_scalar"))
    body += [("branch", asm.beq, "zero", "zero", "scalars_ok"), ("label", "bad_scalar"),
             *asm.halt(1), ("label", "scalars_ok")]
    body += _double_and_add(a["acc1"], a["G"], u1) + _double_and_add(a["acc2"], a["Q"], u2)
    body += asm.ec_add(a["R"], a["acc1"], a["acc2"], MOD_SECP256K1_P)
    for i in range(8):
        body += asm.li("t1", a["R"] + 4 * i)
        body.append(asm.lw("t0", "t1", 0))
        body += asm.reveal("t0", i)
    body += asm.keccak256(a["Q"], 64, a["keccak"])
    body += asm.sha256(a["msg"], len(msg), a["sha"])
    for op, out in ((asm.FP2_MUL, "fmul"), (asm.FP2_ADD, "fadd"), (asm.FP2_SUB, "fsub")):
        body += asm.fp2op(a[out], a["fx"], a["fy"], op, MOD_BN254_FQ)
    for i in range(len(leaves)):
        body += asm.defer_verify(a["leaves"] + 64 * i)
    body += asm.halt(0)
    info = {"seed": seed, "scalar_bits": scalar_bits, "d": d, "Q": q, "z": z, "r": r,
            "s": s, "u1": u1, "u2": u2, "R": ec_add_affine(p1, p2), "msg": msg,
            "fx": fx, "fy": fy, "leaves": leaves, "addr": a,
            "ec_doubles": u1.bit_length() + u2.bit_length() - 2,
            "ec_adds": bin(u1).count("1") + bin(u2).count("1") - 1}
    words = asm.assemble(body)
    assert 4 * len(words) <= ECDSA_BASE, "the program image overlaps the data"
    return words, info
