"""BatchInfo public inputs (parity with reference
crates/types/base/src/public_inputs/scroll/batch.rs:10-194)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ...ops.keccak import keccak256
from .chunk import B256_ZERO
from .fork_name import ForkName
from .version import Domain, STFVersion, Version


@dataclass
class BatchInfo:
    parent_state_root: bytes
    parent_batch_hash: bytes
    state_root: bytes
    batch_hash: bytes
    chain_id: int
    withdraw_root: bytes
    prev_msg_queue_hash: bytes = B256_ZERO
    post_msg_queue_hash: bytes = B256_ZERO
    encryption_key: Optional[bytes] = None

    def _pi_core_v6(self) -> bytes:
        return (
            self.parent_state_root
            + self.parent_batch_hash
            + self.state_root
            + self.batch_hash
            + self.chain_id.to_bytes(8, "big")
            + self.withdraw_root
        )

    def pi_euclidv1(self) -> bytes:
        return self._pi_core_v6()

    def pi_euclidv2(self) -> bytes:
        return (
            self._pi_core_v6()
            + self.prev_msg_queue_hash
            + self.post_msg_queue_hash
        )

    def pi_feynman(self) -> bytes:
        return self.pi_euclidv2()

    def pi_galileo(self, version: Version) -> bytes:
        return bytes([version.as_version_byte()]) + self.pi_euclidv2()

    def pi_galileo_v2(self, version: Version) -> bytes:
        return self.pi_galileo(version)

    def pi_validium(self, version: Version) -> bytes:
        assert self.encryption_key is not None, "domain=Validium"
        return self.pi_galileo(version) + self.encryption_key

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

    def validate(self, prev: "BatchInfo", version: Version) -> None:
        assert self.chain_id == prev.chain_id
        assert self.parent_state_root == prev.state_root
        assert self.parent_batch_hash == prev.batch_hash
        assert self.prev_msg_queue_hash == prev.post_msg_queue_hash
        if version.fork == ForkName.EUCLID_V1:
            assert self.prev_msg_queue_hash == B256_ZERO
            assert prev.prev_msg_queue_hash == B256_ZERO
            assert self.post_msg_queue_hash == B256_ZERO
            assert prev.post_msg_queue_hash == B256_ZERO
        if version.domain == Domain.VALIDIUM:
            assert self.encryption_key is not None
            assert self.encryption_key == prev.encryption_key
