"""AES-256-GCM on python ints (host side), for ECIES (`ecies.py`).

The reference encrypts through `cryptography`'s `AESGCM`; the port depends
on no such package, and this module computes the same function (NIST SP
800-38D) with the standard library alone. Any IV length is
taken: a 12-byte IV gives J0 = IV || 0^31 || 1, any other (ECIES sends 16
bytes) J0 = GHASH(IV || 0-pad || [0]_64 || [len(IV) in bits]_64). The
ciphertext is returned with its 16-byte tag appended, as `AESGCM.encrypt`
returns it; `decrypt` raises `InvalidTag` when the tag does not match.
"""

from __future__ import annotations

import hmac

TAG_LEN = 16


class InvalidTag(ValueError):
    """The GCM tag does not authenticate the ciphertext."""


def _xtime(b: int) -> int:
    b <<= 1
    return (b ^ 0x11B) if b & 0x100 else b


def _gmul(a: int, b: int) -> int:
    out = 0
    while b:
        if b & 1:
            out ^= a
        a = _xtime(a)
        b >>= 1
    return out


def _sbox() -> list:
    exp, log = [0] * 255, [0] * 256       # powers of the generator 3
    x = 1
    for i in range(255):
        exp[i], log[x] = x, i
        x = _xtime(x) ^ x
    box = [0] * 256
    for x in range(256):
        inv = 0 if x == 0 else exp[-log[x] % 255]
        s = inv
        for shift in range(1, 5):
            s ^= ((inv << shift) | (inv >> (8 - shift))) & 0xFF
        box[x] = s ^ 0x63
    return box


_SBOX = _sbox()
# MixColumns by tables: column word (s0, s1, s2, s3) -> sum of _T[i][s_i]
_MIX = ((2, 1, 1, 3), (3, 2, 1, 1), (1, 3, 2, 1), (1, 1, 3, 2))
_T = [[int.from_bytes(bytes(_gmul(_SBOX[x], m[r]) for r in range(4)), "big")
       for x in range(256)] for m in _MIX]


def expand_key(key: bytes) -> list:
    """The AES-256 key schedule: 15 round keys, each 4 big-endian words."""
    if len(key) != 32:
        raise ValueError("AES-256 takes a 32-byte key")
    w = [int.from_bytes(key[4 * i:4 * i + 4], "big") for i in range(8)]
    rcon = 1
    for i in range(8, 60):
        t = w[i - 1]
        if i % 8 == 0:
            t = ((t << 8) | (t >> 24)) & 0xFFFFFFFF
            t = int.from_bytes(bytes(_SBOX[b] for b in t.to_bytes(4, "big")), "big")
            t ^= rcon << 24
            rcon = _xtime(rcon)
        elif i % 8 == 4:
            t = int.from_bytes(bytes(_SBOX[b] for b in t.to_bytes(4, "big")), "big")
        w.append(w[i - 8] ^ t)
    return [w[4 * r:4 * r + 4] for r in range(15)]


def encrypt_block(round_keys: list, block: bytes) -> bytes:
    """One AES block (16 bytes) under an expanded key."""
    s = [int.from_bytes(block[4 * i:4 * i + 4], "big") ^ round_keys[0][i] for i in range(4)]
    t0, t1, t2, t3 = _T
    for rnd in range(1, 14):
        k = round_keys[rnd]
        s = [t0[s[c] >> 24] ^ t1[(s[(c + 1) % 4] >> 16) & 0xFF]
             ^ t2[(s[(c + 2) % 4] >> 8) & 0xFF] ^ t3[s[(c + 3) % 4] & 0xFF] ^ k[c]
             for c in range(4)]
    k = round_keys[14]
    out = b"".join(
        ((_SBOX[s[c] >> 24] << 24 | _SBOX[(s[(c + 1) % 4] >> 16) & 0xFF] << 16
          | _SBOX[(s[(c + 2) % 4] >> 8) & 0xFF] << 8 | _SBOX[s[(c + 3) % 4] & 0xFF])
         ^ k[c]).to_bytes(4, "big") for c in range(4))
    return out


_R = 0xE1 << 120


def _gf_mul(x: int, y: int) -> int:
    """The product in GF(2^128) of GCM's bit order (SP 800-38D, 6.3)."""
    z, v = 0, y
    for i in range(127, -1, -1):
        if (x >> i) & 1:
            z ^= v
        v = (v >> 1) ^ _R if v & 1 else v >> 1
    return z


def _ghash(h: int, data: bytes) -> int:
    """GHASH over `data`, zero-padded to whole blocks."""
    y = 0
    for off in range(0, len(data), 16):
        y = _gf_mul(y ^ int.from_bytes(data[off:off + 16].ljust(16, b"\x00"), "big"), h)
    return y


def _pad16(data: bytes) -> bytes:
    return data + bytes(-len(data) % 16)


def _lengths(aad: bytes, data: bytes) -> bytes:
    return (8 * len(aad)).to_bytes(8, "big") + (8 * len(data)).to_bytes(8, "big")


def _inc32(counter: int) -> int:
    return (counter & ~0xFFFFFFFF) | ((counter + 1) & 0xFFFFFFFF)


def _gctr(round_keys: list, counter: int, data: bytes) -> bytes:
    out = bytearray()
    for off in range(0, len(data), 16):
        pad = encrypt_block(round_keys, counter.to_bytes(16, "big"))
        chunk = data[off:off + 16]
        out += bytes(a ^ b for a, b in zip(chunk, pad))
        counter = _inc32(counter)
    return bytes(out)


def _setup(key: bytes, iv: bytes):
    if not iv:
        raise ValueError("GCM takes a nonempty IV")
    round_keys = expand_key(key)
    h = int.from_bytes(encrypt_block(round_keys, bytes(16)), "big")
    if len(iv) == 12:
        j0 = int.from_bytes(iv + b"\x00\x00\x00\x01", "big")
    else:
        j0 = _ghash(h, _pad16(iv) + bytes(8) + (8 * len(iv)).to_bytes(8, "big"))
    return round_keys, h, j0


def _tag(round_keys: list, h: int, j0: int, aad: bytes, ct: bytes) -> bytes:
    s = _ghash(h, _pad16(aad) + _pad16(ct) + _lengths(aad, ct))
    return _gctr(round_keys, j0, s.to_bytes(16, "big"))


def encrypt(key: bytes, iv: bytes, plaintext: bytes, aad: bytes = b"") -> bytes:
    """AES-256-GCM: ciphertext || 16-byte tag."""
    round_keys, h, j0 = _setup(key, iv)
    ct = _gctr(round_keys, _inc32(j0), plaintext)
    return ct + _tag(round_keys, h, j0, aad, ct)


def decrypt(key: bytes, iv: bytes, ct_tag: bytes, aad: bytes = b"") -> bytes:
    """The plaintext of ciphertext || tag; `InvalidTag` if the tag fails."""
    if len(ct_tag) < TAG_LEN:
        raise InvalidTag("ciphertext shorter than its tag")
    round_keys, h, j0 = _setup(key, iv)
    ct, tag = ct_tag[:-TAG_LEN], ct_tag[-TAG_LEN:]
    if not hmac.compare_digest(_tag(round_keys, h, j0, aad, ct), tag):
        raise InvalidTag("GCM tag mismatch")
    return _gctr(round_keys, _inc32(j0), ct)
