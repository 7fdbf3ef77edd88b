"""Chunk witness (parity with reference
crates/types/chunk/src/scroll/witness.rs:12-143 and execute.rs:21-91).

`BlockExecutionSummary` stands in for the output of stateless block
re-execution (the sbv/revm layer, `execution/`), which `execute_and_fold`
runs when the witness carries block witnesses; everything from the
summaries to the ChunkInfo (digests, rolling hashes, chaining) is here, as
in the reference's `zkvm_prover_tpu/types/chunk/witness.py`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from ..base.chunk import B256_ZERO, BlockContextV2, ChunkInfo
from ..base.fork_name import ForkName
from .types import legacy_data_hash, rolling_msg_queue_hash, tx_bytes_hash


@dataclass
class ValidiumInputs:
    validium_txs: List[List[bytes]]     # per-block encrypted L1 msg tx hashes
    secret_key: bytes


@dataclass
class BlockExecutionSummary:
    """Per-block results of stateless execution (the sbv output analog)."""

    number: int
    timestamp: int
    base_fee_per_gas: int
    gas_limit: int
    gas_used: int
    state_root_after: bytes
    block_hash: bytes
    encoded_l2_txs: List[bytes] = field(default_factory=list)
    l1_msg_hashes: List[bytes] = field(default_factory=list)
    num_txs: int = 0


@dataclass
class ChunkWitness:
    version: int
    blocks: List[BlockExecutionSummary]
    prev_msg_queue_hash: bytes
    fork_name: ForkName
    prev_state_root: bytes = B256_ZERO
    post_state_root: bytes = B256_ZERO
    withdraw_root: bytes = B256_ZERO
    chain_id: int = 534352
    prev_blockhash: bytes = B256_ZERO
    validium: Optional[ValidiumInputs] = None
    # Full stateless-execution inputs (execution.block.BlockWitness).
    # When present, validation RE-EXECUTES the blocks (sbv analog) and
    # derives blocks/post_state_root/withdraw_root instead of trusting
    # pre-summarized values (reference witness.rs BlockWitness field).
    block_witnesses: Optional[list] = None

    @property
    def total_gas_used(self) -> int:
        return sum(b.gas_used for b in self.blocks)


def execute_and_fold(witness: "ChunkWitness") -> ChunkInfo:
    """The full execute() analog (execute.rs:21-91): when the witness
    carries block witnesses, run stateless re-execution to derive the
    summaries and state/withdraw roots; then fold into ChunkInfo. A claimed
    post state or withdraw root that re-execution contradicts raises
    `ValueError` (the reference asserts)."""
    if witness.block_witnesses:
        from ...execution.block import execute_chunk_blocks

        summaries, pre, post, wroot = execute_chunk_blocks(
            witness.block_witnesses, witness.prev_state_root
        )
        if witness.post_state_root not in (B256_ZERO, post):
            raise ValueError("claimed post_state_root contradicts re-execution")
        if witness.withdraw_root not in (B256_ZERO, wroot):
            raise ValueError("claimed withdraw_root contradicts re-execution")
        witness.blocks = summaries
        witness.post_state_root = post
        witness.withdraw_root = wroot
        witness.prev_blockhash = \
            witness.block_witnesses[0].header.parent_hash
    return chunk_info_from_execution(witness)


def chunk_info_from_execution(witness: ChunkWitness) -> ChunkInfo:
    """Fold executed-block summaries into the chunk public inputs
    (execute.rs:21-91 behavior)."""
    blocks = witness.blocks
    assert blocks, "chunk must contain at least one block"

    all_l2 = [tx for b in blocks for tx in b.encoded_l2_txs]
    tx_len, tx_digest = tx_bytes_hash(all_l2)

    post_q = rolling_msg_queue_hash(
        witness.prev_msg_queue_hash,
        (h for b in blocks for h in b.l1_msg_hashes),
    )

    fork = witness.fork_name
    data_hash = B256_ZERO
    if fork == ForkName.EUCLID_V1:
        data_hash = legacy_data_hash(
            [
                (b.number, b.timestamp, b.base_fee_per_gas, b.gas_limit,
                 b.num_txs)
                for b in blocks
            ],
            [b.l1_msg_hashes for b in blocks],
        )

    return ChunkInfo(
        chain_id=witness.chain_id,
        prev_state_root=witness.prev_state_root,
        post_state_root=(
            blocks[-1].state_root_after
            if witness.post_state_root == B256_ZERO
            else witness.post_state_root
        ),
        withdraw_root=witness.withdraw_root,
        data_hash=data_hash,
        tx_data_digest=tx_digest,
        prev_msg_queue_hash=witness.prev_msg_queue_hash,
        post_msg_queue_hash=post_q,
        tx_data_length=tx_len,
        initial_block_number=blocks[0].number,
        block_ctxs=[
            BlockContextV2(
                timestamp=b.timestamp,
                base_fee=b.base_fee_per_gas,
                gas_limit=b.gas_limit,
                num_txs=b.num_txs,
                num_l1_msgs=len(b.l1_msg_hashes),
            )
            for b in blocks
        ],
        prev_blockhash=witness.prev_blockhash,
        post_blockhash=blocks[-1].block_hash,
        encryption_key=(
            None if witness.validium is None else witness.validium.secret_key
        ),
    )
