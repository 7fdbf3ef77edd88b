"""ChunkInfo public inputs (parity with reference
crates/types/base/src/public_inputs/scroll/chunk.rs:62-322).

All multi-byte integers are big-endian; B256 values are 32 raw bytes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from ...ops.keccak import keccak256
from .fork_name import ForkName
from .version import Domain, STFVersion, Version

SIZE_BLOCK_CTX = 52

B256_ZERO = b"\x00" * 32


@dataclass
class BlockContextV2:
    timestamp: int
    base_fee: int           # U256
    gas_limit: int
    num_txs: int            # u16
    num_l1_msgs: int        # u16

    def to_bytes(self) -> bytes:
        return (
            self.timestamp.to_bytes(8, "big")
            + self.base_fee.to_bytes(32, "big")
            + self.gas_limit.to_bytes(8, "big")
            + self.num_txs.to_bytes(2, "big")
            + self.num_l1_msgs.to_bytes(2, "big")
        )

    @classmethod
    def from_bytes(cls, b: bytes) -> "BlockContextV2":
        assert len(b) == SIZE_BLOCK_CTX
        return cls(
            timestamp=int.from_bytes(b[0:8], "big"),
            base_fee=int.from_bytes(b[8:40], "big"),
            gas_limit=int.from_bytes(b[40:48], "big"),
            num_txs=int.from_bytes(b[48:50], "big"),
            num_l1_msgs=int.from_bytes(b[50:52], "big"),
        )


@dataclass
class ChunkInfo:
    chain_id: int
    prev_state_root: bytes
    post_state_root: bytes
    withdraw_root: bytes
    data_hash: bytes = B256_ZERO            # legacy (v6 only)
    tx_data_digest: bytes = B256_ZERO
    prev_msg_queue_hash: bytes = B256_ZERO
    post_msg_queue_hash: bytes = B256_ZERO
    tx_data_length: int = 0
    initial_block_number: int = 0
    block_ctxs: List[BlockContextV2] = field(default_factory=list)
    prev_blockhash: bytes = B256_ZERO
    post_blockhash: bytes = B256_ZERO
    encryption_key: Optional[bytes] = None

    # ---- PI encodings (chunk.rs:131-263) ---------------------------------
    def pi_euclidv1(self) -> bytes:
        assert self.data_hash != B256_ZERO, "v6 must have valid data_hash"
        return (
            self.chain_id.to_bytes(8, "big")
            + self.prev_state_root
            + self.post_state_root
            + self.withdraw_root
            + self.data_hash
            + self.tx_data_digest
        )

    def _pi_v7_core(self) -> bytes:
        return (
            self.chain_id.to_bytes(8, "big")
            + self.prev_state_root
            + self.post_state_root
            + self.withdraw_root
            + self.tx_data_digest
            + self.prev_msg_queue_hash
            + self.post_msg_queue_hash
            + self.initial_block_number.to_bytes(8, "big")
            + b"".join(c.to_bytes() for c in self.block_ctxs)
        )

    def pi_euclidv2(self) -> bytes:
        return self._pi_v7_core()

    def pi_feynman(self) -> bytes:
        return self.pi_euclidv2()

    def pi_galileo(self, version: Version) -> bytes:
        return bytes([version.as_version_byte()]) + self._pi_v7_core()

    def pi_galileo_v2(self, version: Version) -> bytes:
        return self.pi_galileo(version)

    def pi_validium(self, version: Version) -> bytes:
        assert self.encryption_key is not None, "domain=Validium"
        return (
            bytes([version.as_version_byte()])
            + self._pi_v7_core()
            + self.prev_blockhash
            + self.post_blockhash
            + self.encryption_key
        )

    def pi_by_version(self, version: Version) -> bytes:
        key = (version.domain, version.stf_version)
        if key == (Domain.SCROLL, STFVersion.V6):
            return self.pi_euclidv1()
        if key == (Domain.SCROLL, STFVersion.V7):
            return self.pi_euclidv2()
        if key == (Domain.SCROLL, STFVersion.V8):
            return self.pi_feynman()
        if key == (Domain.SCROLL, STFVersion.V9):
            return self.pi_galileo(version)
        if key == (Domain.SCROLL, STFVersion.V10):
            return self.pi_galileo_v2(version)
        if key == (Domain.VALIDIUM, STFVersion.V1):
            return self.pi_validium(version)
        raise ValueError(f"unsupported version={key}")

    def pi_hash_by_version(self, version: Version) -> bytes:
        return keccak256(self.pi_by_version(version))

    # ---- chaining validation (chunk.rs:291-321) --------------------------
    def validate(self, prev: "ChunkInfo", version: Version) -> None:
        assert self.chain_id == prev.chain_id
        assert self.prev_state_root == prev.post_state_root
        assert self.prev_msg_queue_hash == prev.post_msg_queue_hash
        if version.fork == ForkName.EUCLID_V1:
            assert self.prev_msg_queue_hash == B256_ZERO
            assert prev.prev_msg_queue_hash == B256_ZERO
            assert self.post_msg_queue_hash == B256_ZERO
            assert prev.post_msg_queue_hash == B256_ZERO
        if version.domain == Domain.VALIDIUM:
            assert self.prev_blockhash == prev.post_blockhash
            assert self.encryption_key is not None
            assert self.encryption_key == prev.encryption_key
