"""Chunk circuit program (parity with reference
crates/circuits/chunk-circuit/src/{main.rs:14-29, circuit.rs:27-50}):
deserialize witness -> execute/fold -> (ChunkInfo, Version) -> pi hash.

The reference's `zkvm_prover_tpu/circuits/chunk_circuit.py`: a witness
that carries block witnesses crosses as JSON (headers, transactions, the
partial trie's nodes and the code preimages) and is re-executed by
`validate`."""

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
            d["block_witnesses"] = [
                _encode_block_witness(bw) for bw in w.block_witnesses
            ]
        return json.dumps(d, sort_keys=True).encode()

    @classmethod
    def deserialize_witness(cls, witness_bytes: bytes) -> ChunkWitness:
        d = json.loads(witness_bytes.decode())
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
            block_witnesses=[
                _decode_block_witness(bw)
                for bw in d.get("block_witnesses", [])
            ] or None,
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


# --- BlockWitness JSON codec ----------------------------------------------

def _encode_block_witness(bw) -> dict:
    h = bw.header
    return {
        "header": {
            "parent_hash": h.parent_hash.hex(),
            "coinbase": h.coinbase.hex(),
            "state_root": h.state_root.hex(),
            "transactions_root": h.transactions_root.hex(),
            "receipts_root": h.receipts_root.hex(),
            "number": h.number,
            "gas_limit": h.gas_limit,
            "gas_used": h.gas_used,
            "timestamp": h.timestamp,
            "base_fee_per_gas": h.base_fee_per_gas,
            "extra_data": h.extra_data.hex(),
        },
        "txs": [
            {
                "tx_type": t.tx_type,
                "nonce": t.nonce,
                "gas_limit": t.gas_limit,
                "to": t.to.hex() if t.to else None,
                "value": t.value,
                "data": t.data.hex(),
                "gas_price": t.gas_price,
                "max_fee": t.max_fee,
                "max_priority_fee": t.max_priority_fee,
                "chain_id": t.chain_id,
                "v": t.v, "r": t.r, "s": t.s,
                "sender": t.sender.hex() if t.sender else None,
            }
            for t in bw.txs
        ],
        "state_nodes": [n.hex() for n in bw.state_nodes.values()],
        "codes": [c.hex() for c in bw.codes.values()],
        "chain_id": bw.chain_id,
    }


def _decode_block_witness(d: dict):
    from ..execution.block import BlockWitness, Header, Tx
    from ..ops.keccak import keccak256

    h = d["header"]
    header = Header(
        parent_hash=_b(h["parent_hash"]),
        coinbase=_b(h["coinbase"]),
        state_root=_b(h["state_root"]),
        transactions_root=_b(h["transactions_root"]),
        receipts_root=_b(h["receipts_root"]),
        number=h["number"],
        gas_limit=h["gas_limit"],
        gas_used=h["gas_used"],
        timestamp=h["timestamp"],
        base_fee_per_gas=h["base_fee_per_gas"],
        extra_data=_b(h.get("extra_data", "")),
    )
    txs = [
        Tx(
            tx_type=t["tx_type"], nonce=t["nonce"],
            gas_limit=t["gas_limit"],
            to=_b(t["to"]) if t["to"] else None,
            value=t["value"], data=_b(t["data"]),
            gas_price=t["gas_price"], max_fee=t["max_fee"],
            max_priority_fee=t["max_priority_fee"],
            chain_id=t["chain_id"], v=t["v"], r=t["r"], s=t["s"],
            sender=_b(t["sender"]) if t["sender"] else None,
        )
        for t in d["txs"]
    ]
    nodes = {keccak256(_b(n)): _b(n) for n in d["state_nodes"]}
    codes = {keccak256(_b(c)): _b(c) for c in d["codes"]}
    return BlockWitness(header=header, txs=txs, state_nodes=nodes,
                        codes=codes, chain_id=d["chain_id"])
