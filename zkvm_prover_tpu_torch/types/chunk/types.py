"""Chunk digest helpers (parity with reference
crates/types/chunk/src/scroll/types.rs:56-258).

These operate on pre-encoded transaction bytes / hashes (the EVM-level
encoding is produced by the execution layer): the framework's stateless
block execution analog of sbv arrives in a later round (ROADMAP Phase 6 —
SURVEY.md §2.2 "In-guest EVM execution ... host-side witness generation
component").
"""

from __future__ import annotations

from typing import Iterable, List, Tuple

from ...ops.keccak import keccak256

B256_ZERO = b"\x00" * 32


def tx_bytes_hash(encoded_l2_txs: Iterable[bytes]) -> Tuple[int, bytes]:
    """(total_length, keccak digest) of the flattened EIP-2718-encoded L2
    txs (L1 messages excluded by the caller) — types.rs:145-158."""
    buf = b"".join(encoded_l2_txs)
    return len(buf), keccak256(buf)


def rolling_msg_queue_hash(
    initial: bytes, l1_tx_hashes: Iterable[bytes]
) -> bytes:
    """Rolling hash over L1 message tx hashes with the last 4 bytes cleared
    after every step (da-codec convention; types.rs:214-240)."""
    rolling = initial
    for tx_hash in l1_tx_hashes:
        assert len(tx_hash) == 32
        out = bytearray(keccak256(rolling + tx_hash))
        out[28] = out[29] = out[30] = out[31] = 0
        rolling = bytes(out)
    return rolling


def encode_legacy_da_header(
    number: int, timestamp: int, base_fee_per_gas: int, gas_limit: int,
    num_txs: int,
) -> bytes:
    """Legacy (pre-EuclidV2) per-block DA header — types.rs:188-198."""
    return (
        number.to_bytes(8, "big")
        + timestamp.to_bytes(8, "big")
        + base_fee_per_gas.to_bytes(32, "big")
        + gas_limit.to_bytes(8, "big")
        + num_txs.to_bytes(2, "big")
    )


def legacy_data_hash(
    block_headers: List[Tuple[int, int, int, int, int]],
    l1_msg_hashes_per_block: List[List[bytes]],
) -> bytes:
    """keccak(all block DA headers || all blocks' L1 msg hashes) —
    types.rs:80-107. block_headers entries:
    (number, timestamp, base_fee, gas_limit, num_txs)."""
    buf = b"".join(encode_legacy_da_header(*h) for h in block_headers)
    buf += b"".join(h for hashes in l1_msg_hashes_per_block for h in hashes)
    return keccak256(buf)
