"""Batch headers v6/v7/validium with keccak batch-hash formulas (parity with
reference crates/types/batch/src/header/{v6.rs:28-76, v7.rs:19-55,
validium.rs:95-135})."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

from ...ops.keccak import keccak256

B256_ZERO = b"\x00" * 32


@dataclass
class BatchHeaderV7:
    version: int
    batch_index: int
    parent_batch_hash: bytes
    blob_versioned_hash: bytes

    def batch_hash(self) -> bytes:
        """keccak(version || index || versioned_hash || parent_hash)."""
        return keccak256(
            bytes([self.version])
            + self.batch_index.to_bytes(8, "big")
            + self.blob_versioned_hash
            + self.parent_batch_hash
        )


@dataclass
class BatchHeaderV6:
    version: int
    batch_index: int
    l1_message_popped: int
    total_l1_message_popped: int
    parent_batch_hash: bytes
    last_block_timestamp: int
    data_hash: bytes
    blob_versioned_hash: bytes
    blob_data_proof: List[bytes] = field(
        default_factory=lambda: [B256_ZERO, B256_ZERO]
    )

    def batch_hash(self) -> bytes:
        return keccak256(
            bytes([self.version])
            + self.batch_index.to_bytes(8, "big")
            + self.l1_message_popped.to_bytes(8, "big")
            + self.total_l1_message_popped.to_bytes(8, "big")
            + self.data_hash
            + self.blob_versioned_hash
            + self.parent_batch_hash
            + self.last_block_timestamp.to_bytes(8, "big")
            + self.blob_data_proof[0]
            + self.blob_data_proof[1]
        )


@dataclass
class BatchHeaderValidiumV1:
    version: int
    batch_index: int
    parent_batch_hash: bytes
    post_state_root: bytes
    withdraw_root: bytes
    commitment: bytes  # last L3 block hash

    def batch_hash(self) -> bytes:
        return keccak256(
            bytes([self.version])
            + self.batch_index.to_bytes(8, "big")
            + self.parent_batch_hash
            + self.post_state_root
            + self.withdraw_root
            + self.commitment
        )

    def blob_versioned_hash(self) -> bytes:
        return B256_ZERO
