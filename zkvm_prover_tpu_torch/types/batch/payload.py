"""DA-codec envelope/payload v7 (the reference's
`zkvm_prover_tpu/types/batch/payload.py`; parity with reference
crates/types/batch/src/payload/v7.rs:26-265; the same layout serves
da-codec v7/v8/v9/v10). The zstd frames go through the port's own codec,
`utils/zstd.py`.

Envelope layout (padded to N_BLOB_BYTES):
  [0]      version byte
  [1..4]   unpadded payload size (u24 BE)
  [4]      is_encoded flag (zstd)
  [5..]    payload bytes, zero-padded

Payload layout:
  prevL1MessageQueueHash (32) || postL1MessageQueueHash (32) ||
  initialL2BlockNumber (8) || numBlocks (2) || blockCtxs (52 each) ||
  flattened L2 tx bytes
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

from ...ops.keccak import keccak256
from ...utils import zstd
from ..base.chunk import SIZE_BLOCK_CTX, BlockContextV2, ChunkInfo
from .blob import N_BLOB_BYTES, challenge_digest

INDEX_PREV_MSG_QUEUE_HASH = 0
INDEX_POST_MSG_QUEUE_HASH = 32
INDEX_L2_BLOCK_NUM = 64
INDEX_NUM_BLOCKS = 72
INDEX_BLOCK_CTX = 74


def _zstd_compress(data: bytes) -> bytes:
    """The port's frame writer: Raw blocks, not the reference's
    `zstandard` level 3 (`utils/zstd.py`), so the body bytes differ while
    the payload decodes alike."""
    return zstd.compress(data)


def _zstd_decompress(data: bytes) -> bytes:
    return zstd.decompress(data, max_output_size=1 << 26)


@dataclass
class EnvelopeV7:
    envelope_bytes: bytes  # full padded N_BLOB_BYTES
    version: int
    is_encoded: int
    unpadded_bytes: bytes

    @classmethod
    def from_slice(cls, blob_bytes: bytes) -> "EnvelopeV7":
        assert len(blob_bytes) == N_BLOB_BYTES
        version = blob_bytes[0]
        unpadded_size = (
            blob_bytes[1] * 256 * 256 + blob_bytes[2] * 256 + blob_bytes[3]
        )
        assert unpadded_size <= N_BLOB_BYTES - 5
        is_encoded = blob_bytes[4]
        assert is_encoded <= 1
        assert all(b == 0 for b in blob_bytes[5 + unpadded_size :]), (
            "padding must be zero"
        )
        return cls(
            envelope_bytes=bytes(blob_bytes),
            version=version,
            is_encoded=is_encoded,
            unpadded_bytes=bytes(blob_bytes[5 : 5 + unpadded_size]),
        )

    @classmethod
    def build(cls, version: int, payload_bytes: bytes,
              encode: bool = True) -> "EnvelopeV7":
        """Witness-builder helper (the integration-harness analog of
        crates/integration/src/utils/mod.rs:129-411 blob construction)."""
        body = _zstd_compress(payload_bytes) if encode else payload_bytes
        assert len(body) <= N_BLOB_BYTES - 5
        head = bytes(
            [version, len(body) >> 16 & 0xFF, len(body) >> 8 & 0xFF,
             len(body) & 0xFF, 1 if encode else 0]
        )
        padded = head + body + bytes(N_BLOB_BYTES - 5 - len(body))
        return cls.from_slice(padded)

    def challenge_digest(self, blob_versioned_hash: bytes) -> bytes:
        return challenge_digest(self.envelope_bytes, blob_versioned_hash)


@dataclass
class PayloadV7:
    version: int
    prev_msg_queue_hash: bytes
    post_msg_queue_hash: bytes
    initial_block_number: int
    num_blocks: int
    block_contexts: List[BlockContextV2]
    tx_data: bytes

    @classmethod
    def from_envelope(cls, env: EnvelopeV7) -> "PayloadV7":
        payload = (
            _zstd_decompress(env.unpadded_bytes)
            if env.is_encoded & 1
            else env.unpadded_bytes
        )
        assert len(payload) >= INDEX_BLOCK_CTX
        num_blocks = int.from_bytes(
            payload[INDEX_NUM_BLOCKS:INDEX_BLOCK_CTX], "big"
        )
        assert len(payload) >= INDEX_BLOCK_CTX + num_blocks * SIZE_BLOCK_CTX
        ctxs = [
            BlockContextV2.from_bytes(
                payload[
                    INDEX_BLOCK_CTX + i * SIZE_BLOCK_CTX :
                    INDEX_BLOCK_CTX + (i + 1) * SIZE_BLOCK_CTX
                ]
            )
            for i in range(num_blocks)
        ]
        return cls(
            version=env.version,
            prev_msg_queue_hash=payload[0:32],
            post_msg_queue_hash=payload[32:64],
            initial_block_number=int.from_bytes(payload[64:72], "big"),
            num_blocks=num_blocks,
            block_contexts=ctxs,
            tx_data=payload[INDEX_BLOCK_CTX + num_blocks * SIZE_BLOCK_CTX :],
        )

    def to_bytes(self) -> bytes:
        return (
            self.prev_msg_queue_hash
            + self.post_msg_queue_hash
            + self.initial_block_number.to_bytes(8, "big")
            + self.num_blocks.to_bytes(2, "big")
            + b"".join(c.to_bytes() for c in self.block_contexts)
            + self.tx_data
        )

    def validate(self, chunk_infos: List[ChunkInfo]) -> Tuple[ChunkInfo, ChunkInfo]:
        """Cross-check against the aggregated chunk public inputs
        (payload/v7.rs:198-264)."""
        assert chunk_infos, "at least one chunk in batch"
        first, last = chunk_infos[0], chunk_infos[-1]
        all_ctxs = [c for ci in chunk_infos for c in ci.block_ctxs]
        assert self.num_blocks == len(all_ctxs)
        assert self.num_blocks == len(self.block_contexts)
        assert self.initial_block_number == first.initial_block_number
        assert self.prev_msg_queue_hash == first.prev_msg_queue_hash
        assert self.post_msg_queue_hash == last.post_msg_queue_hash
        assert len(self.tx_data) == sum(ci.tx_data_length for ci in chunk_infos)
        idx = 0
        for ci in chunk_infos:
            sz = ci.tx_data_length
            assert keccak256(self.tx_data[idx : idx + sz]) == ci.tx_data_digest
            idx += sz
        for ctx, wctx in zip(self.block_contexts, all_ctxs):
            assert ctx == wctx
        return first, last


# ---------------------------------------------------------------------------
# DA-codec v6 (euclid forks; parity with reference
# crates/types/batch/src/payload/v6.rs:18-213)
# ---------------------------------------------------------------------------

N_MAX_CHUNKS_V6 = 45
N_BYTES_NUM_CHUNKS = 2
N_BYTES_CHUNK_SIZE = 4
N_BYTES_METADATA_V6 = N_BYTES_NUM_CHUNKS + N_MAX_CHUNKS_V6 * N_BYTES_CHUNK_SIZE


@dataclass
class EnvelopeV6:
    """v6 envelope: byte 0 is the is_encoded flag, the rest is the
    (possibly zstd) payload (v6.rs:18-31)."""

    envelope_bytes: bytes   # blob_bytes[1:]
    is_encoded: bool

    @classmethod
    def from_slice(cls, blob_bytes: bytes) -> "EnvelopeV6":
        return cls(
            envelope_bytes=bytes(blob_bytes[1:]),
            is_encoded=(blob_bytes[0] & 1) == 1,
        )

    @classmethod
    def build(cls, payload_bytes: bytes, encode: bool = True) -> bytes:
        """Witness-builder: payload -> full blob bytes (flag || body)."""
        body = _zstd_compress(payload_bytes) if encode else payload_bytes
        return bytes([1 if encode else 0]) + body


@dataclass
class PayloadV6:
    """Chunk-segmented v6 payload: metadata (chunk count + sizes) followed by
    per-chunk flattened L2 tx bytes (v6.rs:63-142)."""

    metadata_digest: bytes
    chunk_data_digests: List[bytes]

    @classmethod
    def from_envelope(cls, env: EnvelopeV6) -> "PayloadV6":
        payload = (
            _zstd_decompress(env.envelope_bytes)
            if env.is_encoded
            else env.envelope_bytes
        )
        metadata = payload[:N_BYTES_METADATA_V6]
        metadata_digest = keccak256(metadata)
        batch_bytes = payload[N_BYTES_METADATA_V6:]
        valid_chunks = int.from_bytes(metadata[:N_BYTES_NUM_CHUNKS], "big")
        sizes = [
            int.from_bytes(
                metadata[
                    N_BYTES_NUM_CHUNKS + i * N_BYTES_CHUNK_SIZE :
                    N_BYTES_NUM_CHUNKS + (i + 1) * N_BYTES_CHUNK_SIZE
                ],
                "big",
            )
            for i in range(N_MAX_CHUNKS_V6)
        ]
        for sz in sizes[valid_chunks:]:
            assert sz == 0, "unused chunk has size 0"
        digests = []
        idx = 0
        for sz in sizes[:valid_chunks]:
            digests.append(keccak256(batch_bytes[idx : idx + sz]))
            idx += sz
        assert idx == len(batch_bytes), (
            "chunk segmentation len must add up to the correct value"
        )
        return cls(metadata_digest=metadata_digest,
                   chunk_data_digests=digests)

    @classmethod
    def build_payload_bytes(cls, chunk_tx_datas: List[bytes]) -> bytes:
        """Witness-builder inverse of from_envelope."""
        assert 0 < len(chunk_tx_datas) <= N_MAX_CHUNKS_V6
        meta = len(chunk_tx_datas).to_bytes(N_BYTES_NUM_CHUNKS, "big")
        for i in range(N_MAX_CHUNKS_V6):
            sz = len(chunk_tx_datas[i]) if i < len(chunk_tx_datas) else 0
            meta += sz.to_bytes(N_BYTES_CHUNK_SIZE, "big")
        return meta + b"".join(chunk_tx_datas)

    def challenge_digest_preimage(self, versioned_hash: bytes) -> bytes:
        """metadata_digest || 45 chunk digests (padded with the last valid
        digest) || versioned hash (v6.rs:183-212)."""
        assert self.chunk_data_digests, "at least we have one"
        padded = self.chunk_data_digests + [
            self.chunk_data_digests[-1]
        ] * (N_MAX_CHUNKS_V6 - len(self.chunk_data_digests))
        return (
            self.metadata_digest + b"".join(padded[:N_MAX_CHUNKS_V6])
            + versioned_hash
        )

    def challenge_digest(self, versioned_hash: bytes) -> bytes:
        return keccak256(self.challenge_digest_preimage(versioned_hash))

    def validate(self, header, chunk_infos: List[ChunkInfo]):
        """Cross-check against aggregated chunk PIs + the header data_hash
        (v6.rs:144-172)."""
        assert chunk_infos, "at least 1 chunk info"
        assert len(self.chunk_data_digests) == len(chunk_infos)
        for digest, ci in zip(self.chunk_data_digests, chunk_infos):
            assert digest == ci.tx_data_digest
        batch_data_hash = keccak256(
            b"".join(ci.data_hash for ci in chunk_infos)
        )
        assert batch_data_hash == header.data_hash
        return chunk_infos[0], chunk_infos[-1]
