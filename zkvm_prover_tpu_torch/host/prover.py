"""Host prover API (parity with reference `Prover` at
crates/prover/src/prover/mod.rs:68-433): the reference's
`zkvm_prover_tpu/host/prover.py` over the port's `prove_machine`.

  setup -> gen_proof_universal (execute-precheck, prove, encode, self-verify)
  + disk proof cache keyed by task identifier
  (crates/integration/src/lib.rs:518-586 caching semantics).

The proof runs on the card unless `ProverConfig.device` names another
device; so do the preprocessed commitments of in-circuit child verifiers
and the SNARK wrapper's KZG commitments (`gen_proof_snark`). The wire
program, the self-verify's replay and the PLONK prover are host code.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

from ..models.poseidon2_air import Poseidon2Air
from ..recursion.aggregation import TAG_LEAF, ChildSlot, build_child_verification, input_commit
from ..recursion.stark_verifier import RealOracle
from ..stark import machine
from ..stark.config import StarkConfig
from . import serialization
from .app import CircuitApp, app_for_vk, get_app
from .deferral import encode_deferral
from .proof_types import AggChildRecord, ProofEnum, StarkProof, StarkProofStat
from .task import ProvingTask
from .verifier import UniversalVerifier


class ProverError(Exception):
    """Mirrors the reference error enum (crates/prover/src/error.rs:5-46)."""


@dataclass
class ProverConfig:
    app_name: str
    cache_dir: Optional[str] = None
    stark: StarkConfig = field(default_factory=StarkConfig)
    # How aggregated child proofs are checked (the engine-switch analog of
    # the reference's cpu/cuda feature, prover/mod.rs:27-39):
    #   "in-circuit": children are verified INSIDE this proof's constraint
    #       system (wire-circuit verifier; no host pre-check) — production.
    #   "host": children are verified by the host before proving and the
    #       envelope carries no aggregation claim — the test-tier shortcut
    #       mirroring the reference harness's execute-tier fake-proof
    #       commitments (SURVEY.md §4).
    child_verification: str = "in-circuit"
    # where prove_machine runs: None is the card (and raises without one),
    # as stark/config.py::resolve_device says
    device: Optional[str] = None


class Prover:
    def __init__(self, config: ProverConfig, app: Optional[CircuitApp] = None):
        self.config = config
        self.app = app or get_app(config.app_name)
        self.cache_dir = Path(config.cache_dir) if config.cache_dir else None
        if self.cache_dir:
            self.cache_dir.mkdir(parents=True, exist_ok=True)

    @classmethod
    def setup(cls, config: ProverConfig) -> "Prover":
        return cls(config)

    # -- vk / commitments --------------------------------------------------
    def get_app_vk(self) -> bytes:
        return self.app.vk_bytes()

    # -- proving -----------------------------------------------------------
    def _cache_path(self, task: ProvingTask) -> Optional[Path]:
        if not self.cache_dir or not task.identifier:
            return None
        return self.cache_dir / f"{self.app.name}-{task.identifier}.json"

    def execute_and_check(self, task: ProvingTask):
        """Execute-precheck (utils/vm.rs:13-48): run the app, reject all-zero
        public values before spending proving time."""
        t0 = time.time()
        instances, pi_hash = self.app.execute(task)
        if all(b == 0 for b in pi_hash):
            raise ProverError("public values are all zeros, check the witness/task")
        return instances, pi_hash, (time.time() - t0) * 1e3

    def gen_proof_universal(self, task: ProvingTask, with_snark: bool = False):
        if with_snark:
            return self.gen_proof_snark(task)
        return self.gen_proof_stark(task)

    def gen_proof_stark(self, task: ProvingTask) -> StarkProof:
        # proof cache hit?
        path = self._cache_path(task)
        if path and path.exists():
            with open(path) as f:
                cached = ProofEnum.from_dict(json.load(f))
            if isinstance(cached, StarkProof):
                return cached

        if task.vk and task.vk != self.get_app_vk():
            raise ProverError(f"task vk mismatch for app {self.app.name}")
        instances, pi_hash, exec_ms = self.execute_and_check(task)

        # Aggregated child proofs are verified IN-CIRCUIT: the machine
        # gains wire-circuit instances that replay each child's transcript,
        # OOD check, Merkle openings, FRI folds and PoW, and bind a digest
        # over (child vk, child PVs) into this proof's public values. No
        # host-side pre-verification: an invalid child makes this proof
        # fail verification. Reference: in-guest verify_stark
        # (crates/types/circuit/src/lib.rs:138-154).
        agg_children: list = []
        input_commits: list = []
        if self.config.child_verification == "host":
            # the test-tier shortcut: children verified by the host, no
            # in-circuit claim in the envelope
            for child in task.aggregated_proofs:
                if not UniversalVerifier.verify_stark_proof_with_vk(
                        child.baseline, child, self.config.stark, device=self.config.device):
                    raise ProverError("aggregated child proof failed host verification")
        elif task.aggregated_proofs:
            if any(isinstance(i.air, Poseidon2Air) for i in instances):
                raise ProverError("app machine already carries a Poseidon2 table")
            slots, oracles = [], []
            for child in task.aggregated_proofs:
                child_app = app_for_vk(child.baseline)
                if child_app is None:
                    raise ProverError("unknown child app vk")
                mp = serialization.decode_machine_proof(child.proof)
                log_ns = [ln for (ln, _, _) in mp.meta]
                # airs_for_meta, not airs(): VM-app children carry
                # height-dependent preprocessed schedules (KeccakfAir), and
                # the slot's vk/preprocessed roots must match the child
                # proof's actual table heights.
                slot = ChildSlot(child_app.airs_for_meta(mp.meta), log_ns,
                                 self.config.stark, self.config.device)
                slots.append(slot)
                oracles.append(RealOracle(mp))
                pvs = [v for (_, _, p) in mp.meta for v in p]
                input_commits.append(input_commit(slot.vk_words, pvs))
                agg_children.append(AggChildRecord(vk=child.baseline, log_ns=log_ns, pvs=pvs))
            instances = list(instances) + build_child_verification(TAG_LEAF, slots, oracles)

        t0 = time.time()
        mproof = machine.prove_machine(instances, self.config.stark, device=self.config.device)
        proving_ms = (time.time() - t0) * 1e3

        envelope = StarkProof(
            proof=serialization.encode_machine_proof(mproof),
            user_pvs_proof=pi_hash,
            baseline=self.get_app_vk(),
            # deferral data: Merkle tree over input_commits (envelope parity
            # with compute_deferral_data, crates/integration/src/lib.rs:461-514)
            deferral_merkle_proofs=encode_deferral(input_commits),
            stat=StarkProofStat(
                total_cycles=sum(int(i.trace.shape[0]) for i in instances),
                execution_time_mills=int(exec_ms),
                proving_time_mills=int(proving_ms),
            ),
            agg_children=agg_children,
            input_commits=input_commits,
        )

        # self-verify before returning (prover/mod.rs:407-411)
        if not UniversalVerifier.verify_stark_proof_with_vk(
                self.get_app_vk(), envelope, self.config.stark, device=self.config.device):
            raise ProverError("self-verification of generated proof failed")

        if path:
            with open(path, "w") as f:
                json.dump(envelope.to_dict(), f)
        return envelope

    def gen_proof_snark(self, task: ProvingTask):
        """STARK proof -> EvmProof through the BN254 PLONK wrapper
        (gen_proof_snark analog, crates/prover/src/prover/mod.rs:419-432).
        The root STARK is produced and self-verified first (or read from the
        proof cache); the wrapper binds (vk, PI hash, proof bytes) into the
        on-chain instance layout (see snark/wrapper.py for the in-circuit
        statement), its commitments on the Prover's device."""
        from ..snark import wrapper as snark_wrapper

        stark = self.gen_proof_stark(task)
        return snark_wrapper.wrap_stark_proof(
            self.get_app_vk(), stark.proof, stark.user_pvs_proof, device=self.config.device)
