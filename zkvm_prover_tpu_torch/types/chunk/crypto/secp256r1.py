"""P-256 (secp256r1) ECDSA verification (parity with reference
crates/types/chunk/src/crypto/secp256r1.rs:6-16: the RIP-7212 P256VERIFY
precompile provider).

A copy of the reference's `zkvm_prover_tpu/types/chunk/crypto/secp256r1.py`.
"""

from __future__ import annotations

from .weierstrass import SECP256R1 as C


def p256_verify(msg_hash: bytes, r: int, s: int, x: int, y: int) -> bool:
    if not (1 <= r < C.n and 1 <= s < C.n):
        return False
    if not C.is_on_curve((x, y)):
        return False
    z = int.from_bytes(msg_hash, "big") % C.n
    s_inv = pow(s, C.n - 2, C.n)
    pt = C.mul_add((z * s_inv) % C.n, C.generator(), (r * s_inv) % C.n,
                   (x, y))
    return pt is not None and pt[0] % C.n == r
