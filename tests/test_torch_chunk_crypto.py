"""The port's chunk crypto (`zkvm_prover_tpu_torch/types/chunk/crypto/`)
against the JAX package's and against the libraries it replaces.

secp256k1 `ecrecover`, P-256 `p256_verify`, the curve operations, ECIES in
both directions between the packages (a fixed `_rng`), and validium's
`decrypt_data` / `decrypt` agree with the reference on inputs from a seed.
The port's own AES-256-GCM and HKDF-SHA256 equal `cryptography`'s, which
the reference calls (12- and 16-byte nonces, empty and multi-block
plaintexts, a flipped tag), and its RIPEMD-160 equals `hashlib`'s."""

import hashlib
import zlib

import numpy as np
import pytest
from cryptography.hazmat.primitives.ciphers.aead import AESGCM
from cryptography.hazmat.primitives.hashes import SHA256
from cryptography.hazmat.primitives.kdf.hkdf import HKDF

from zkvm_prover_tpu.types.chunk import crypto as ref_crypto
from zkvm_prover_tpu.types.chunk.crypto import ecies as ref_ecies
from zkvm_prover_tpu.types.chunk.crypto import validium as ref_validium
from zkvm_prover_tpu.types.chunk.crypto import weierstrass as ref_curves
from zkvm_prover_tpu_torch.ops.keccak import keccak256
from zkvm_prover_tpu_torch.types.chunk import crypto
from zkvm_prover_tpu_torch.types.chunk.crypto import aes_gcm, ecies, validium, weierstrass
from zkvm_prover_tpu_torch.types.chunk.crypto.ripemd160 import ripemd160

SEED = 23


def _rng(*tag):
    return np.random.default_rng([SEED, zlib.crc32(repr(tag).encode())])


def _int(rng, n: int) -> int:
    return int.from_bytes(rng.bytes(32), "big") % n or 1


def _sign(curve, sk: int, z: int, k: int):
    pt = curve.mul(k, curve.generator())
    r = pt[0] % curve.n
    s = pow(k, curve.n - 2, curve.n) * (z + r * sk) % curve.n
    return r, s, pt[1] & 1


@pytest.mark.parametrize("i", range(4))
def test_ecrecover_equal(i):
    rng = _rng("ecrecover", i)
    c = weierstrass.SECP256K1
    sk = _int(rng, c.n)
    pk = c.mul(sk, c.generator())
    addr = keccak256(pk[0].to_bytes(32, "big") + pk[1].to_bytes(32, "big"))[12:]
    h = rng.bytes(32)
    r, s, v = _sign(c, sk, int.from_bytes(h, "big") % c.n, _int(rng, c.n))
    cases = [(h, v, r, s), (h, v + 27, r, s), (h, 1 - v, r, s), (h, v, 0, s), (h, v, r, c.n),
             (h, 2, r, s), (h, v, c.p - 1, s)]
    got = [crypto.ecrecover(*a) for a in cases]
    assert got == [ref_crypto.ecrecover(*a) for a in cases]
    assert got[0] == got[1] == addr and got[2] != addr and got[3] is None and got[5] is None


@pytest.mark.parametrize("i", range(3))
def test_p256_verify_equal(i):
    rng = _rng("p256", i)
    c = weierstrass.SECP256R1
    sk = _int(rng, c.n)
    pk = c.mul(sk, c.generator())
    h = hashlib.sha256(rng.bytes(40)).digest()
    r, s, _ = _sign(c, sk, int.from_bytes(h, "big") % c.n, _int(rng, c.n))
    cases = [(h, r, s, *pk), (hashlib.sha256(b"other").digest(), r, s, *pk),
             (h, r, (s + 1) % c.n, *pk), (h, r, s, pk[0], pk[1] + 1), (h, 0, s, *pk)]
    got = [crypto.p256_verify(*a) for a in cases]
    assert got == [ref_crypto.p256_verify(*a) for a in cases] == [True] + [False] * 4


@pytest.mark.parametrize("name", ["SECP256K1", "SECP256R1"])
def test_curve_operations_equal(name):
    c, ref_c = getattr(weierstrass, name), getattr(ref_curves, name)
    assert c == ref_c or vars(c) == vars(ref_c)
    rng = _rng("curve", name)
    k1, k2 = _int(rng, c.n), _int(rng, c.n)
    g = c.generator()
    p1, p2 = c.mul(k1, g), c.mul(k2, g)
    ops = [c.add(p1, p2), c.add(p1, p1), c.add(p1, None), c.mul(0, p1), c.mul(c.n - 1, p1),
           c.mul_add(k1, g, k2, p1), c.lift_x(p1[0], p1[1] & 1), c.lift_x(p1[0], 1 - (p1[1] & 1))]
    ref_ops = [ref_c.add(p1, p2), ref_c.add(p1, p1), ref_c.add(p1, None), ref_c.mul(0, p1),
               ref_c.mul(ref_c.n - 1, p1), ref_c.mul_add(k1, g, k2, p1),
               ref_c.lift_x(p1[0], p1[1] & 1), ref_c.lift_x(p1[0], 1 - (p1[1] & 1))]
    assert ops == ref_ops
    assert ops[6] == p1 and all(c.is_on_curve(p) for p in ops)


def _fixed_rng(seed):
    rng = _rng("ecies", seed)
    return lambda n: rng.bytes(n)


@pytest.mark.parametrize("direction", ["port to reference", "reference to port"])
@pytest.mark.parametrize("size", [0, 20, 57])
def test_ecies_cross_decryption(direction, size):
    """The same fixed `_rng` gives byte-equal ciphertexts in both packages,
    and each decrypts the other's."""
    rng = _rng("ecies-key", size)
    sk = _int(rng, weierstrass.SECP256K1.n)
    msg = rng.bytes(size)
    ct = ecies.ecies_encrypt(ecies.public_key_of(sk), msg, _rng=_fixed_rng(size))
    ref_ct = ref_ecies.ecies_encrypt(ref_ecies.public_key_of(sk), msg, _rng=_fixed_rng(size))
    assert ct == ref_ct
    assert len(ct) == ecies.UNCOMPRESSED_LEN + ecies.NONCE_LEN + ecies.TAG_LEN + size
    if direction == "port to reference":
        assert ref_ecies.ecies_decrypt(sk, ct) == msg
    else:
        assert ecies.ecies_decrypt(sk, ref_ct) == msg


@pytest.mark.parametrize("where", ["tag", "ciphertext", "nonce"])
def test_ecies_tamper_raises_in_both(where):
    sk = 0xABCDE12345
    ct = bytearray(ecies.ecies_encrypt(ecies.public_key_of(sk), b"\x42" * 20,
                                       _rng=_fixed_rng(99)))
    at = {"nonce": 65, "tag": 65 + 16, "ciphertext": len(ct) - 1}[where]
    ct[at] ^= 1
    with pytest.raises(aes_gcm.InvalidTag):
        ecies.ecies_decrypt(sk, bytes(ct))
    with pytest.raises(Exception):
        ref_ecies.ecies_decrypt(sk, bytes(ct))


@pytest.mark.parametrize("nonce_len", [12, 16])
@pytest.mark.parametrize("size", [0, 1, 16, 17, 100])
@pytest.mark.parametrize("aad", [b"", b"header"])
def test_aes_gcm_equals_cryptography(nonce_len, size, aad):
    rng = _rng("gcm", nonce_len, size, len(aad))
    key, nonce, msg = rng.bytes(32), rng.bytes(nonce_len), rng.bytes(size)
    want = AESGCM(key).encrypt(nonce, msg, aad or None)
    assert aes_gcm.encrypt(key, nonce, msg, aad) == want
    assert aes_gcm.decrypt(key, nonce, want, aad) == msg


@pytest.mark.parametrize("nonce_len", [12, 16])
def test_aes_gcm_flipped_tag_raises(nonce_len):
    rng = _rng("gcm-tag", nonce_len)
    key, nonce = rng.bytes(32), rng.bytes(nonce_len)
    ct = bytearray(AESGCM(key).encrypt(nonce, b"validium", None))
    ct[-1] ^= 0x80
    with pytest.raises(aes_gcm.InvalidTag):
        aes_gcm.decrypt(key, nonce, bytes(ct))
    with pytest.raises(aes_gcm.InvalidTag):
        aes_gcm.decrypt(key, nonce, bytes(ct[:15]))


@pytest.mark.parametrize("length", [16, 32, 42, 64])
def test_hkdf_equals_cryptography(length):
    rng = _rng("hkdf", length)
    ikm, salt, info = rng.bytes(130), rng.bytes(32), rng.bytes(7)
    for s, i in [(None, b""), (salt, info)]:
        want = HKDF(algorithm=SHA256(), length=length, salt=s, info=i).derive(ikm)
        assert ecies.hkdf_sha256(ikm, length, s or b"", i) == want


@pytest.mark.parametrize("size", [0, 1, 55, 56, 63, 64, 65, 119, 120, 1000])
def test_ripemd160_equals_hashlib(size):
    data = _rng("ripemd", size).bytes(size)
    assert ripemd160(data) == hashlib.new("ripemd160", data).digest()


def _deposit(mod, sk, rng):
    enc_to = ref_ecies.ecies_encrypt(ref_ecies.public_key_of(sk), rng.bytes(20),
                                     _rng=_fixed_rng(7))
    msg = mod.SEL_FINALIZE_ERC20_ENC + mod.abi_encode(
        mod.ERC20_ENC_TYPES, [rng.bytes(20), rng.bytes(20), rng.bytes(20), enc_to, 42,
                              rng.bytes(37)])
    return mod.SEL_RELAY_MESSAGE + mod.abi_encode(
        mod.RELAY_TYPES, [rng.bytes(20), rng.bytes(20), 7, 9, msg])


def test_validium_decrypt_data_equal():
    sk = 0xABCDE12345
    data = _deposit(ref_validium, sk, _rng("validium"))
    out = validium.decrypt_data(data, sk)
    assert out == ref_validium.decrypt_data(data, sk)
    *_, m2 = validium.abi_decode(validium.RELAY_TYPES, out[4:])
    assert m2.startswith(validium.SEL_FINALIZE_ERC20)
    vals = validium.abi_decode(validium.ERC20_TYPES, m2[4:])
    assert vals[4] == 42 and len(vals[3]) == 20
    other = validium.SEL_RELAY_MESSAGE + validium.abi_encode(
        validium.RELAY_TYPES, [b"\x01" * 20, b"\x02" * 20, 1, 1, b"\x01\x02"])
    assert validium.decrypt_data(other, sk) == other == ref_validium.decrypt_data(other, sk)


def test_validium_decrypt_equal():
    sk = 0x1234
    rng = _rng("validium-tx")
    for data in (_deposit(ref_validium, sk, rng), b"\xAA\xBB"):
        fields = dict(queue_index=1, gas_limit=21000, to=rng.bytes(20), value=0,
                      sender=rng.bytes(20), input=data)
        out = validium.decrypt(validium.TxL1Message(**fields), sk)
        ref_out = ref_validium.decrypt(ref_validium.TxL1Message(**fields), sk)
        assert vars(out) == vars(ref_out)


@pytest.mark.parametrize("blob", ["short head", "offset out of range", "length out of range"])
def test_abi_decode_rejects_in_both(blob):
    good = validium.abi_encode(["uint256", "bytes"], [5, b"\x01" * 40])
    bad = {"short head": good[:40],
           "offset out of range": good[:32] + (10**6).to_bytes(32, "big") + good[64:],
           "length out of range": good[:64] + (10**6).to_bytes(32, "big") + good[96:]}[blob]
    for mod in (validium, ref_validium):
        with pytest.raises(ValueError):
            mod.abi_decode(["uint256", "bytes"], bad)
