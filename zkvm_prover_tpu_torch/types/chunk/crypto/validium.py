"""Validium L1-message decryption (parity with reference
crates/types/chunk/src/scroll/types/validium.rs:20-71 and the sol! call
definitions at crates/types/chunk/src/scroll/types.rs:18-48).

An encrypted deposit reaches L2 as
  relayMessage(sender, target, value, nonce, message)
where `message` is finalizeDepositERC20Encrypted(token, l2Token, from,
to: bytes /* ECIES ciphertext of the target address */, amount, l2Data);
the guest decrypts `to` with the validium secret key and rewrites the call
to plain finalizeDepositERC20 before executing the block.

A copy of the reference's `zkvm_prover_tpu/types/chunk/crypto/validium.py`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

from ....ops.keccak import keccak256
from .ecies import ecies_decrypt

# -- minimal ABI codec (static head/dynamic tail) ---------------------------


def _selector(sig: str) -> bytes:
    return keccak256(sig.encode())[:4]


SEL_RELAY_MESSAGE = _selector(
    "relayMessage(address,address,uint256,uint256,bytes)"
)
SEL_FINALIZE_ERC20 = _selector(
    "finalizeDepositERC20(address,address,address,address,uint256,bytes)"
)
SEL_FINALIZE_ERC20_ENC = _selector(
    "finalizeDepositERC20Encrypted(address,address,address,bytes,uint256,bytes)"
)


def abi_decode(types: List[str], data: bytes) -> List:
    """Decode a head/tail ABI blob of address/uint256/bytes fields.
    Malformed offsets/lengths raise (the alloy ABI decoder's behavior)
    instead of silently truncating via Python slicing."""
    out = []
    if len(data) < 32 * len(types):
        raise ValueError("abi blob shorter than its head")
    for i, t in enumerate(types):
        head = data[32 * i : 32 * (i + 1)]
        if t == "address":
            out.append(head[12:])
        elif t == "uint256":
            out.append(int.from_bytes(head, "big"))
        elif t == "bytes":
            off = int.from_bytes(head, "big")
            if off + 32 > len(data):
                raise ValueError("abi bytes offset out of range")
            ln = int.from_bytes(data[off : off + 32], "big")
            if off + 32 + ln > len(data):
                raise ValueError("abi bytes length out of range")
            out.append(data[off + 32 : off + 32 + ln])
        else:
            raise ValueError(f"unsupported abi type {t}")
    return out


def abi_encode(types: List[str], values: List) -> bytes:
    head = b""
    tail = b""
    head_len = 32 * len(types)
    for t, v in zip(types, values):
        if t == "address":
            head += bytes(12) + v
        elif t == "uint256":
            head += int(v).to_bytes(32, "big")
        elif t == "bytes":
            head += (head_len + len(tail)).to_bytes(32, "big")
            padded = len(v) % 32
            tail += (
                len(v).to_bytes(32, "big") + v
                + bytes(32 - padded if padded else 0)
            )
        else:
            raise ValueError(f"unsupported abi type {t}")
    return head + tail


RELAY_TYPES = ["address", "address", "uint256", "uint256", "bytes"]
ERC20_TYPES = ["address", "address", "address", "address", "uint256",
               "bytes"]
ERC20_ENC_TYPES = ["address", "address", "address", "bytes", "uint256",
                   "bytes"]


@dataclass
class TxL1Message:
    queue_index: int
    gas_limit: int
    to: bytes
    value: int
    sender: bytes
    input: bytes


def decrypt_message(message: bytes, secret_key: int) -> bytes:
    if not message.startswith(SEL_FINALIZE_ERC20_ENC):
        return message
    token, l2token, frm, to_ct, amount, l2data = abi_decode(
        ERC20_ENC_TYPES, message[4:]
    )
    to_plain = ecies_decrypt(secret_key, bytes(to_ct))
    if len(to_plain) != 20:
        raise ValueError("invalid target address")
    return SEL_FINALIZE_ERC20 + abi_encode(
        ERC20_TYPES, [token, l2token, frm, to_plain, amount, l2data]
    )


def decrypt_data(data: bytes, secret_key: int) -> bytes:
    if not data.startswith(SEL_RELAY_MESSAGE):
        return data
    sender, target, value, nonce, message = abi_decode(
        RELAY_TYPES, data[4:]
    )
    if message.startswith(SEL_FINALIZE_ERC20_ENC):
        message = decrypt_message(bytes(message), secret_key)
        return SEL_RELAY_MESSAGE + abi_encode(
            RELAY_TYPES, [sender, target, value, nonce, message]
        )
    return data


def decrypt(tx: TxL1Message, secret_key: int) -> TxL1Message:
    return TxL1Message(
        queue_index=tx.queue_index,
        gas_limit=tx.gas_limit,
        to=tx.to,
        value=tx.value,
        sender=tx.sender,
        input=decrypt_data(tx.input, secret_key),
    )
