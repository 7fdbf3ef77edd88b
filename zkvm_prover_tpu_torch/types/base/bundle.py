"""BundleInfo public inputs (parity with reference
crates/types/base/src/public_inputs/scroll/bundle.rs:10-140)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ...ops.keccak import keccak256
from .chunk import B256_ZERO
from .version import Domain, STFVersion, Version


@dataclass
class BundleInfo:
    chain_id: int
    msg_queue_hash: bytes = B256_ZERO
    num_batches: int = 0
    prev_state_root: bytes = B256_ZERO
    prev_batch_hash: bytes = B256_ZERO
    post_state_root: bytes = B256_ZERO
    batch_hash: bytes = B256_ZERO
    withdraw_root: bytes = B256_ZERO
    encryption_key: Optional[bytes] = None

    def pi_euclidv1(self) -> bytes:
        return (
            self.chain_id.to_bytes(8, "big")
            + self.num_batches.to_bytes(4, "big")
            + self.prev_state_root
            + self.prev_batch_hash
            + self.post_state_root
            + self.batch_hash
            + self.withdraw_root
        )

    def pi_euclidv2(self) -> bytes:
        return (
            self.chain_id.to_bytes(8, "big")
            + self.msg_queue_hash
            + self.num_batches.to_bytes(4, "big")
            + self.prev_state_root
            + self.prev_batch_hash
            + self.post_state_root
            + self.batch_hash
            + self.withdraw_root
        )

    def pi_feynman(self) -> bytes:
        return self.pi_euclidv2()

    def pi_galileo(self) -> bytes:
        return self.pi_euclidv2()

    def pi_galileo_v2(self) -> bytes:
        return self.pi_euclidv2()

    def pi_validium_v1(self) -> bytes:
        assert self.encryption_key is not None, "domain=Validium"
        return self.pi_euclidv2() + self.encryption_key

    def pi_versioned(self, version: Version, pi: bytes) -> bytes:
        # B256::left_padding_from(version_byte): 31 zero bytes then the byte
        # (bundle.rs:116-123)
        return bytes(31) + bytes([version.as_version_byte()]) + pi

    def pi_by_version(self, version: Version) -> bytes:
        key = (version.domain, version.stf_version)
        if key == (Domain.SCROLL, STFVersion.V6):
            return self.pi_euclidv1()
        if key == (Domain.SCROLL, STFVersion.V7):
            return self.pi_euclidv2()
        if key == (Domain.SCROLL, STFVersion.V8):
            return self.pi_versioned(version, self.pi_feynman())
        if key == (Domain.SCROLL, STFVersion.V9):
            return self.pi_versioned(version, self.pi_galileo())
        if key == (Domain.SCROLL, STFVersion.V10):
            return self.pi_versioned(version, self.pi_galileo_v2())
        if key == (Domain.VALIDIUM, STFVersion.V1):
            return self.pi_versioned(version, self.pi_validium_v1())
        raise ValueError(f"unsupported version={key}")

    def pi_hash_by_version(self, version: Version) -> bytes:
        return keccak256(self.pi_by_version(version))
