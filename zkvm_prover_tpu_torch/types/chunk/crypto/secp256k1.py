"""secp256k1 ecrecover (parity with reference
crates/types/chunk/src/crypto/secp256k1.rs:11-34: k256 recovery installed
into revm as the ECRECOVER precompile provider).

A copy of the reference's `zkvm_prover_tpu/types/chunk/crypto/secp256k1.py`.
"""

from __future__ import annotations

from typing import Optional

from ....ops.keccak import keccak256
from .weierstrass import SECP256K1 as C


def ecrecover(msg_hash: bytes, v: int, r: int, s: int) -> Optional[bytes]:
    """Recover the 20-byte Ethereum address, or None if the signature is
    invalid. v is the recovery id (0/1, or 27/28)."""
    if v >= 27:
        v -= 27
    if v not in (0, 1):
        return None
    if not (1 <= r < C.n and 1 <= s < C.n):
        return None
    try:
        R = C.lift_x(r, v)
    except ValueError:
        return None
    z = int.from_bytes(msg_hash, "big") % C.n
    r_inv = pow(r, C.n - 2, C.n)
    # Q = r^-1 (s*R - z*G)
    q = C.mul_add(
        (s * r_inv) % C.n, R, (-z * r_inv) % C.n, C.generator()
    )
    if q is None:
        return None
    pub = q[0].to_bytes(32, "big") + q[1].to_bytes(32, "big")
    return keccak256(pub)[12:]


def verify(msg_hash: bytes, r: int, s: int, pubkey) -> bool:
    """Plain ECDSA verify over secp256k1 (pubkey = (x, y))."""
    if not (1 <= r < C.n and 1 <= s < C.n) or not C.is_on_curve(pubkey):
        return False
    z = int.from_bytes(msg_hash, "big") % C.n
    s_inv = pow(s, C.n - 2, C.n)
    pt = C.mul_add((z * s_inv) % C.n, C.generator(), (r * s_inv) % C.n,
                   pubkey)
    return pt is not None and pt[0] % C.n == r
