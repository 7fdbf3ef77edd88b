"""Chunk circuit program (parity with reference
crates/circuits/chunk-circuit/src/{main.rs:14-29, circuit.rs:27-50}):
deserialize witness -> execute/fold -> (ChunkInfo, Version) -> pi hash.

The reference's `zkvm_prover_tpu/circuits/chunk_circuit.py` on the summary
path. A witness that carries block witnesses (stateless re-execution)
raises `NotImplementedError` until `execution/` is ported (ROADMAP Queue 1
item 4b)."""

from __future__ import annotations

import json

from ..types.base.version import Version
from ..types.chunk.witness import (
    BlockExecutionSummary,
    ChunkWitness,
    execute_and_fold,
)
from ..types.base.fork_name import ForkName
from .circuit import Circuit

_NO_EXECUTION = ("ROADMAP Queue 1 item 4b: witnesses with block witnesses need "
                 "execution/ (stateless re-execution)")


def _b(s: str) -> bytes:
    return bytes.fromhex(s)


class ChunkCircuit(Circuit):
    name = "chunk"

    @classmethod
    def serialize_witness(cls, w: ChunkWitness) -> bytes:
        d = {
            "version": w.version,
            "fork_name": w.fork_name.value,
            "prev_msg_queue_hash": w.prev_msg_queue_hash.hex(),
            "prev_state_root": w.prev_state_root.hex(),
            "post_state_root": w.post_state_root.hex(),
            "withdraw_root": w.withdraw_root.hex(),
            "chain_id": w.chain_id,
            "prev_blockhash": w.prev_blockhash.hex(),
            "blocks": [
                {
                    "number": b.number,
                    "timestamp": b.timestamp,
                    "base_fee_per_gas": b.base_fee_per_gas,
                    "gas_limit": b.gas_limit,
                    "gas_used": b.gas_used,
                    "state_root_after": b.state_root_after.hex(),
                    "block_hash": b.block_hash.hex(),
                    "encoded_l2_txs": [t.hex() for t in b.encoded_l2_txs],
                    "l1_msg_hashes": [h.hex() for h in b.l1_msg_hashes],
                    "num_txs": b.num_txs,
                }
                for b in w.blocks
            ],
        }
        if w.block_witnesses:
            raise NotImplementedError(_NO_EXECUTION)
        return json.dumps(d, sort_keys=True).encode()

    @classmethod
    def deserialize_witness(cls, witness_bytes: bytes) -> ChunkWitness:
        d = json.loads(witness_bytes.decode())
        if d.get("block_witnesses"):
            raise NotImplementedError(_NO_EXECUTION)
        return ChunkWitness(
            version=d["version"],
            fork_name=ForkName.from_str(d["fork_name"]),
            prev_msg_queue_hash=_b(d["prev_msg_queue_hash"]),
            prev_state_root=_b(d["prev_state_root"]),
            post_state_root=_b(d["post_state_root"]),
            withdraw_root=_b(d["withdraw_root"]),
            chain_id=d["chain_id"],
            prev_blockhash=_b(d["prev_blockhash"]),
            blocks=[
                BlockExecutionSummary(
                    number=b["number"],
                    timestamp=b["timestamp"],
                    base_fee_per_gas=b["base_fee_per_gas"],
                    gas_limit=b["gas_limit"],
                    gas_used=b["gas_used"],
                    state_root_after=_b(b["state_root_after"]),
                    block_hash=_b(b["block_hash"]),
                    encoded_l2_txs=[_b(t) for t in b["encoded_l2_txs"]],
                    l1_msg_hashes=[_b(h) for h in b["l1_msg_hashes"]],
                    num_txs=b["num_txs"],
                )
                for b in d["blocks"]
            ],
        )

    @classmethod
    def validate(cls, witness: ChunkWitness):
        version = Version.from_version_byte(witness.version)
        # version byte consistent with declared fork (circuit.rs:37-49)
        assert version.fork == witness.fork_name, "fork/version mismatch"
        # full execute() path: re-executes blocks when block witnesses
        # are present (execute.rs:21-91); falls back to the summary fold
        info = execute_and_fold(witness)
        return info, version

