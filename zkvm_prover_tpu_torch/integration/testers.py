"""Integration harness: chained chunk task generators + prove/verify with a
disk proof cache (the reference's `zkvm_prover_tpu/integration/testers.py`,
parity with the reference crates' testers/task generators at
crates/integration/src/{lib.rs:518-586, testers/*.rs}: lazily build chained
witnesses — state root and rolling msg-queue hash — and memoize proofs
keyed by task identifier; OUTPUT_DIR-style resumability).

The batch and bundle generators wait with their apps (ROADMAP Queue 1
item 4).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Optional

from ..circuits.chunk_circuit import ChunkCircuit
from ..host import scroll_apps  # noqa: F401 (registers the chunk app)
from ..host.prover import Prover, ProverConfig
from ..host.task import ProvingTask
from ..host.verifier import UniversalVerifier
from ..ops.keccak import keccak256
from ..stark.config import StarkConfig, fast_test_config
from ..types.base import Version
from ..types.chunk.witness import BlockExecutionSummary, ChunkWitness


def output_dir() -> Path:
    """OUTPUT_DIR-resumable run directory (lib.rs:156-178 analog)."""
    d = Path(os.environ.get("OUTPUT_DIR", ".output/run"))
    d.mkdir(parents=True, exist_ok=True)
    return d


def prove_verify(prover: Prover, task: ProvingTask, stark: StarkConfig):
    """gen_proof + independent verification (lib.rs:518-586 analog)."""
    proof = prover.gen_proof_universal(task)
    if not UniversalVerifier.verify_stark_proof_with_vk(prover.get_app_vk(), proof, stark):
        raise AssertionError("independent verification failed")
    return proof


@dataclass
class ChunkTaskGenerator:
    """Builds chained chunk witnesses and memoizes proofs. `device` is where
    the proofs run (None: the card, as `ProverConfig.device`)."""

    version: Version = field(default_factory=Version.galileo_v2)
    stark: StarkConfig = field(default_factory=fast_test_config)
    blocks_per_chunk: int = 2
    chain_id: int = 534352
    device: Optional[str] = None
    _state: Dict = field(default_factory=dict)
    _proofs: Dict[int, object] = field(default_factory=dict)
    _witnesses: Dict[int, ChunkWitness] = field(default_factory=dict)

    def __post_init__(self):
        self._state.setdefault("state_root", b"\x01" * 32)
        self._state.setdefault("msg_queue", b"\x00" * 32)
        self._state.setdefault("block", 100)
        self.prover = Prover.setup(ProverConfig(
            app_name="chunk",
            cache_dir=str(output_dir() / "chunk" / "proofs"),
            stark=self.stark,
            device=self.device,
        ))

    def witness(self, i: int) -> ChunkWitness:
        while len(self._witnesses) <= i:
            j = len(self._witnesses)
            blocks = []
            state = self._state["state_root"]
            n0 = self._state["block"]
            for k in range(self.blocks_per_chunk):
                n = n0 + k
                state = keccak256(state + b"s")
                blocks.append(BlockExecutionSummary(
                    number=n,
                    timestamp=1_700_000_000 + n,
                    base_fee_per_gas=1000,
                    gas_limit=30_000_000,
                    gas_used=500_000,
                    state_root_after=state,
                    block_hash=keccak256(b"bh" + n.to_bytes(8, "big")),
                    encoded_l2_txs=[b"\x02" + bytes([n % 251]) * 16],
                    l1_msg_hashes=[],
                    num_txs=1,
                ))
            w = ChunkWitness(
                version=self.version.as_version_byte(),
                blocks=blocks,
                prev_msg_queue_hash=self._state["msg_queue"],
                fork_name=self.version.fork,
                prev_state_root=self._state["state_root"],
                withdraw_root=b"\x07" * 32,
                chain_id=self.chain_id,
            )
            info, _ = ChunkCircuit.validate(w)
            self._state["state_root"] = info.post_state_root
            self._state["msg_queue"] = info.post_msg_queue_hash
            self._state["block"] = n0 + self.blocks_per_chunk
            self._witnesses[j] = w
        return self._witnesses[i]

    def task(self, i: int) -> ProvingTask:
        """The proving task of chunk i, as `get_or_build_proof` proves it."""
        w = self.witness(i)
        return ProvingTask(
            serialized_witness=[ChunkCircuit.serialize_witness(w)],
            fork_name=w.fork_name.value,
            identifier=f"chunk-{i}",
            vk=self.prover.get_app_vk(),
        )

    def get_or_build_proof(self, i: int):
        if i not in self._proofs:
            self._proofs[i] = prove_verify(self.prover, self.task(i), self.stark)
        return self._proofs[i]
