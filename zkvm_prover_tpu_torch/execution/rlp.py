"""RLP encoding/decoding (Ethereum wire format).

Needed by the stateless execution layer for trie nodes, account bodies,
transactions and block headers (the alloy/reth primitives analog).

A copy of the reference's `zkvm_prover_tpu/execution/rlp.py`.
"""

from __future__ import annotations

from typing import List, Union

Item = Union[bytes, List["Item"]]


def encode(item: Item) -> bytes:
    if isinstance(item, (bytes, bytearray)):
        b = bytes(item)
        if len(b) == 1 and b[0] < 0x80:
            return b
        return _len_prefix(len(b), 0x80) + b
    if isinstance(item, list):
        payload = b"".join(encode(x) for x in item)
        return _len_prefix(len(payload), 0xC0) + payload
    raise TypeError(f"cannot RLP-encode {type(item)}")


def encode_int(v: int) -> bytes:
    """Integers encode as minimal big-endian byte strings (0 -> empty)."""
    assert v >= 0
    return encode(int_to_bytes(v))


def int_to_bytes(v: int) -> bytes:
    if v == 0:
        return b""
    return v.to_bytes((v.bit_length() + 7) // 8, "big")


def bytes_to_int(b: bytes) -> int:
    return int.from_bytes(b, "big") if b else 0


def _len_prefix(length: int, offset: int) -> bytes:
    if length < 56:
        return bytes([offset + length])
    lb = int_to_bytes(length)
    return bytes([offset + 55 + len(lb)]) + lb


def decode(data: bytes) -> Item:
    item, rest = _decode_one(data)
    if rest:
        raise ValueError("trailing RLP bytes")
    return item


def _decode_one(data: bytes):
    if not data:
        raise ValueError("empty RLP input")
    b0 = data[0]
    if b0 < 0x80:
        return bytes([b0]), data[1:]
    if b0 < 0xB8:
        n = b0 - 0x80
        if len(data) < 1 + n:
            raise ValueError("short string")
        s = data[1 : 1 + n]
        if n == 1 and s[0] < 0x80:
            raise ValueError("non-canonical single byte")
        return s, data[1 + n :]
    if b0 < 0xC0:
        ln = b0 - 0xB7
        n = bytes_to_int(data[1 : 1 + ln])
        if n < 56:
            raise ValueError("non-canonical length")
        start = 1 + ln
        return data[start : start + n], data[start + n :]
    if b0 < 0xF8:
        n = b0 - 0xC0
        payload = data[1 : 1 + n]
        rest = data[1 + n :]
    else:
        ln = b0 - 0xF7
        n = bytes_to_int(data[1 : 1 + ln])
        if n < 56:
            raise ValueError("non-canonical list length")
        payload = data[1 + ln : 1 + ln + n]
        rest = data[1 + ln + n :]
    items = []
    while payload:
        item, payload = _decode_one(payload)
        items.append(item)
    return items, rest
