"""ECIES over secp256k1 (parity with the reference's `ecies` crate defaults,
used for validium L1-message decryption at
crates/types/chunk/src/scroll/types/validium.rs:20-71).

Wire format (ecies-rs defaults): uncompressed ephemeral public key (65) ||
nonce (16) || GCM tag (16) || ciphertext. Key = HKDF-SHA256(no salt,
ikm = ephemeral_pk_bytes || shared_point_uncompressed, empty info, 32 bytes),
cipher = AES-256-GCM with the 16-byte nonce.

The reference's `zkvm_prover_tpu/types/chunk/crypto/ecies.py` on the port's
own cipher (`aes_gcm.py`) and an HKDF over `hmac` and `hashlib.sha256`:
the same bytes, with no `cryptography` package. A tag that does not
authenticate raises `aes_gcm.InvalidTag`.
"""

from __future__ import annotations

import hashlib
import hmac
import os

from . import aes_gcm
from .weierstrass import SECP256K1 as C

UNCOMPRESSED_LEN = 65
NONCE_LEN = 16
TAG_LEN = 16


def _uncompressed(pt) -> bytes:
    return b"\x04" + pt[0].to_bytes(32, "big") + pt[1].to_bytes(32, "big")


def _decode_point(data: bytes):
    assert len(data) == UNCOMPRESSED_LEN and data[0] == 4, (
        "expected uncompressed secp256k1 point"
    )
    pt = (int.from_bytes(data[1:33], "big"), int.from_bytes(data[33:], "big"))
    assert C.is_on_curve(pt), "point not on curve"
    return pt


def hkdf_sha256(ikm: bytes, length: int = 32, salt: bytes = b"",
                info: bytes = b"") -> bytes:
    """HKDF-SHA256 (RFC 5869); no salt means 32 zero bytes."""
    prk = hmac.new(salt or bytes(32), ikm, hashlib.sha256).digest()
    okm, block = b"", b""
    for i in range(-(-length // 32)):
        block = hmac.new(prk, block + info + bytes([i + 1]), hashlib.sha256).digest()
        okm += block
    return okm[:length]


def _derive_key(ephemeral_pk: bytes, shared_point) -> bytes:
    ikm = ephemeral_pk + _uncompressed(shared_point)
    return hkdf_sha256(ikm)


def ecies_decrypt(secret_key: int, payload: bytes) -> bytes:
    assert len(payload) >= UNCOMPRESSED_LEN + NONCE_LEN + TAG_LEN
    eph_bytes = payload[:UNCOMPRESSED_LEN]
    nonce = payload[UNCOMPRESSED_LEN : UNCOMPRESSED_LEN + NONCE_LEN]
    tag = payload[
        UNCOMPRESSED_LEN + NONCE_LEN : UNCOMPRESSED_LEN + NONCE_LEN + TAG_LEN
    ]
    ct = payload[UNCOMPRESSED_LEN + NONCE_LEN + TAG_LEN :]
    eph = _decode_point(eph_bytes)
    shared = C.mul(secret_key, eph)
    assert shared is not None
    key = _derive_key(eph_bytes, shared)
    return aes_gcm.decrypt(key, nonce, ct + tag)


def ecies_encrypt(public_key, plaintext: bytes,
                  _rng=os.urandom) -> bytes:
    """Sender side (used by tests/witness builders)."""
    eph_sk = int.from_bytes(_rng(32), "big") % C.n or 1
    eph_pk = C.mul(eph_sk, C.generator())
    eph_bytes = _uncompressed(eph_pk)
    shared = C.mul(eph_sk, public_key)
    key = _derive_key(eph_bytes, shared)
    nonce = _rng(NONCE_LEN)
    ct_tag = aes_gcm.encrypt(key, nonce, plaintext)
    ct, tag = ct_tag[:-TAG_LEN], ct_tag[-TAG_LEN:]
    return eph_bytes + nonce + tag + ct


def public_key_of(secret_key: int):
    return C.mul(secret_key, C.generator())
