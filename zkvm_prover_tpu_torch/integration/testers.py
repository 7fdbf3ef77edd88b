"""Integration harness: chained chunk -> batch -> bundle task generators +
prove/verify with a disk proof cache (the reference's
`zkvm_prover_tpu/integration/testers.py`, parity with the reference
crates' testers/task generators at crates/integration/src/{lib.rs:518-586,
testers/*.rs}: lazily build chained witnesses — state root, rolling
msg-queue hash, parent batch hash — and memoize proofs keyed by task
identifier; OUTPUT_DIR-style resumability).

Every generator proves where its chunk generator's `device` says (None:
the card). The batch envelope's body is written by the port's zstd writer
(Raw blocks, `utils/zstd.py`), not by `zstandard` level 3 as in the
reference, so the blob, its versioned hash and the batch hash differ from
the reference generator's while the payload decodes to the same bytes.
"""

from __future__ import annotations

import os
import pickle
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Optional

from ..circuits.batch_circuit import BatchCircuit, BatchCircuitWitness
from ..circuits.chunk_circuit import ChunkCircuit
from ..fields import bls12_381 as bls
from ..host import scroll_apps
from ..host.prover import Prover, ProverConfig
from ..host.task import ProvingTask
from ..host.verifier import UniversalVerifier
from ..ops.keccak import keccak256
from ..stark.config import StarkConfig, fast_test_config
from ..types.base import AggregationInput, Version
from ..types.batch import (
    BatchHeaderV7,
    BatchWitness,
    BlobPolynomial,
    EnvelopeV7,
    PayloadV7,
    PointEvalWitness,
    kzg_to_versioned_hash,
)
from ..types.batch import blob as blob_mod
from ..types.bundle import BundleWitness
from ..types.chunk.witness import BlockExecutionSummary, ChunkWitness


def output_dir() -> Path:
    """OUTPUT_DIR-resumable run directory (lib.rs:156-178 analog)."""
    d = Path(os.environ.get("OUTPUT_DIR", ".output/run"))
    d.mkdir(parents=True, exist_ok=True)
    return d


def prove_verify(prover: Prover, task: ProvingTask, stark: StarkConfig):
    """gen_proof + independent verification (lib.rs:518-586 analog)."""
    proof = prover.gen_proof_universal(task)
    if not UniversalVerifier.verify_stark_proof_with_vk(prover.get_app_vk(), proof, stark,
                                                        device=prover.config.device):
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


@dataclass
class BatchTaskGenerator:
    """Batches of `chunks_per_batch` chained chunks: the v7 envelope, its
    blob commitment and KZG opening under an insecure test setup, and the
    chunk proofs as host-verified children."""

    chunks: ChunkTaskGenerator
    chunks_per_batch: int = 2
    kzg_setup: Optional[bls.InsecureKzgSetup] = None
    _proofs: Dict[int, object] = field(default_factory=dict)
    _infos: Dict[int, object] = field(default_factory=dict)
    _state: Dict = field(default_factory=dict)

    def __post_init__(self):
        self.kzg_setup = self.kzg_setup or bls.InsecureKzgSetup.generate(tau=0x7E57)
        BatchCircuit.tau_g2_override = self.kzg_setup.tau_g2
        self._state.setdefault("parent_batch_hash", b"\x09" * 32)
        self.version = self.chunks.version
        self.prover = Prover.setup(ProverConfig(
            app_name="batch",
            cache_dir=str(output_dir() / "batch" / "proofs"),
            stark=self.chunks.stark,
            # the test tier's host-verified children, as the reference's
            # generator has them (the entry point's default is in-circuit)
            child_verification="host",
            device=self.chunks.device,
        ))

    def chunk_ids(self, i: int):
        return list(range(i * self.chunks_per_batch, (i + 1) * self.chunks_per_batch))

    def witness_and_children(self, i: int):
        chunk_ids = self.chunk_ids(i)
        infos = []
        child_proofs = []
        for ci in chunk_ids:
            info, _ = ChunkCircuit.validate(self.chunks.witness(ci))
            infos.append(info)
            proof = self.chunks.get_or_build_proof(ci)
            child_proofs.append(AggregationInput.from_pi_hash(bytes(proof.user_pvs_proof)))
        version = self.version
        payload = PayloadV7(
            version=int(version.stf_version),
            prev_msg_queue_hash=infos[0].prev_msg_queue_hash,
            post_msg_queue_hash=infos[-1].post_msg_queue_hash,
            initial_block_number=infos[0].initial_block_number,
            num_blocks=sum(len(ci.block_ctxs) for ci in infos),
            block_contexts=[c for ci in infos for c in ci.block_ctxs],
            tx_data=b"".join(tx for ci_id in chunk_ids
                             for b in self.chunks.witness(ci_id).blocks
                             for tx in b.encoded_l2_txs),
        )
        env = EnvelopeV7.build(int(version.stf_version), payload.to_bytes(), encode=True)
        blob = BlobPolynomial(env.envelope_bytes)
        commitment = blob_mod.commit_blob(self.kzg_setup, blob)
        versioned_hash = kzg_to_versioned_hash(bls.g1_to_compressed_be(commitment))
        header = BatchHeaderV7(
            version=int(version.stf_version),
            batch_index=i,
            parent_batch_hash=self._state["parent_batch_hash"],
            blob_versioned_hash=versioned_hash,
        )
        z, _y = blob.evaluate(env.challenge_digest(versioned_hash))
        _, kproof = blob_mod.prove_blob_eval(self.kzg_setup, blob, z)
        inner = BatchWitness(
            version=version.as_version_byte(),
            chunk_infos=infos,
            blob_bytes=env.envelope_bytes.rstrip(b"\x00"),
            header=header,
            point_eval_witness=PointEvalWitness(
                kzg_commitment_x=commitment[0].to_bytes(48, "big"),
                kzg_commitment_y=commitment[1].to_bytes(48, "big"),
                kzg_proof_x=kproof[0].to_bytes(48, "big"),
                kzg_proof_y=kproof[1].to_bytes(48, "big"),
            ),
        )
        return inner, child_proofs, header

    def task(self, i: int) -> ProvingTask:
        """The proving task of batch i, as `get_or_build_proof` proves it."""
        inner, child_proofs, _ = self.witness_and_children(i)
        return ProvingTask(
            serialized_witness=[pickle.dumps((inner, child_proofs))],
            aggregated_proofs=[self.chunks.get_or_build_proof(ci) for ci in self.chunk_ids(i)],
            fork_name=self.version.fork.value,
            identifier=f"batch-{i}",
            vk=self.prover.get_app_vk(),
        )

    def add_proof(self, i: int, task: ProvingTask, proof) -> None:
        """Memoize batch i's proof of `task` and chain the next batch on it."""
        inner, child_proofs = scroll_apps.load_witness(task.serialized_witness[0])
        info, _ = BatchCircuit.validate(BatchCircuitWitness(inner=inner, chunk_proofs=child_proofs))
        self._proofs[i] = proof
        self._infos[i] = info
        self._state["parent_batch_hash"] = inner.header.batch_hash()

    def get_or_build_proof(self, i: int):
        if i not in self._proofs:
            task = self.task(i)
            self.add_proof(i, task, prove_verify(self.prover, task, self.chunks.stark))
        return self._proofs[i]


@dataclass
class BundleTaskGenerator:
    """One bundle over the first `batches_per_bundle` batches."""

    batches: BatchTaskGenerator
    batches_per_bundle: int = 2

    def __post_init__(self):
        self.prover = Prover.setup(ProverConfig(
            app_name="bundle",
            cache_dir=str(output_dir() / "bundle" / "proofs"),
            stark=self.batches.chunks.stark,
            child_verification="host",
            device=self.batches.chunks.device,
        ))

    def witness(self) -> BundleWitness:
        proofs = [self.batches.get_or_build_proof(i) for i in range(self.batches_per_bundle)]
        return BundleWitness(
            version=self.batches.version.as_version_byte(),
            batch_proofs=[AggregationInput.from_pi_hash(bytes(p.user_pvs_proof)) for p in proofs],
            batch_infos=[self.batches._infos[i] for i in range(self.batches_per_bundle)],
            fork_name=self.batches.version.fork,
        )

    def task(self) -> ProvingTask:
        """The bundle's proving task, as `build_proof` proves it."""
        witness = self.witness()
        return ProvingTask(
            serialized_witness=[pickle.dumps(witness)],
            aggregated_proofs=[self.batches.get_or_build_proof(i)
                               for i in range(self.batches_per_bundle)],
            fork_name=witness.fork_name.value,
            identifier="bundle-0",
            vk=self.prover.get_app_vk(),
        )

    def build_proof(self):
        return prove_verify(self.prover, self.task(), self.batches.chunks.stark)
