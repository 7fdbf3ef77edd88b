"""Deferred aggregation: the guest defers child verification, and a
discharge proof verifies the children.

The port's copy of the reference's `zkvm_prover_tpu/host/deferred.py`, the
analog of the verify-stark deferral machinery (SURVEY.md §2.2 "Deferral
machinery"):

- guest side: `verify_stark::<0>(input_commit, expected)`
  (crates/types/circuit/src/lib.rs:147-153) is the DEFER syscall (ECALL
  a7=8, models/deferral_vm.py) that the deferred-agg guest makes
  (vm/guests.py `deferred_agg_program`);
- host side: `compute_deferral_data` and `enable_deferral`'s
  DeferralAggProver (crates/integration/src/lib.rs:461-514,
  crates/prover/src/prover/mod.rs:200-282) are `DeferredProver`. It proves
  the parent machine, whose DeferralVmAir public values bind the ordered
  digest of the deferred leaves, and DISCHARGES the children with a
  verifier-in-circuit aggregation node proof (recursion/aggregation.py);
- the envelope carries both (`StarkProof.deferral_discharge`) and the
  deferral Merkle tree over the input commits (host/deferral.py).

`verify_deferred` (which `UniversalVerifier` calls for an envelope with a
discharge) checks the chain: the parent's DeferralVmAir digest equals the
sponge chain over the leaves; each leaf is keccak(child vk) || child
pi-hash, with (vk, pvs) the child records that the discharge proof binds
in-circuit; the discharge proof verifies. So no parent proof exists
without every deferred child being valid.

Divergence from the source (as in the reference): the source reserves a
2^25-cell DEFERRAL_AS address space in the parent VM and re-proves child
verification in a dedicated deferral VM; here the binding lives in
DeferralVmAir's public values (sized by the rows deferred) and the
discharge is the wire-circuit verifier machine.

The AIR positions in the parent machine come from its AIR list
(`_MACHINE`), not from constants. The prover and the verifier run on the
card unless the caller passes `device="cpu"`; so do the child slots and
the discharge node they build.
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np

from ..models import rv32_v2
from ..models.deferral_vm import DeferralVmAir, chain_digest_from_leaves
from ..models.keccak_air import KeccakfAir
from ..models.keccak_vm import KeccakVmAir
from ..models.poseidon2_air import Poseidon2Air
from ..models.rv32_v0 import ByteTableAir, MemoryBoundaryAir
from ..ops.keccak import keccak256
from ..recursion.aggregation import (
    TAG_LEAF,
    AggNodeProgram,
    ChildSlot,
    digest_bytes,
    input_commit,
    node_digest_words,
)
from ..stark import machine
from ..stark.config import StarkConfig, resolve_device
from ..stark.machine import AirInstance
from ..vm import guests
from ..vm.executor import HALTED, Rv32Executor
from . import serialization
from .app import CircuitApp, app_for_vk, register_app
from .deferral import decode_and_verify, encode_deferral
from .proof_types import AggChildRecord, StarkProof, StarkProofStat
from .task import ProvingTask

# the deferred-agg guest's machine (keccak and defer syscalls), in the
# instance order of rv32_v2.generate_traces: a fixed composition whose
# heights vary
_MACHINE = (
    rv32_v2.AluAir, rv32_v2.ShiftAir, rv32_v2.BranchAir, rv32_v2.JumpAir,
    rv32_v2.LoadStoreAir, rv32_v2.MulAir, rv32_v2.DivRemAir, rv32_v2.SystemAir,
    KeccakVmAir, KeccakfAir, DeferralVmAir, Poseidon2Air, rv32_v2.ProgramAirV2,
    rv32_v2.PublicValuesAir, rv32_v2.ExecBoundaryAirV2, rv32_v2.RamBoundaryAirV2,
    MemoryBoundaryAir, ByteTableAir, rv32_v2.XorTableAir, rv32_v2.Range16TableAir,
)
KECCAKF_IDX = _MACHINE.index(KeccakfAir)
DEFER_IDX = _MACHINE.index(DeferralVmAir)
PV_IDX = _MACHINE.index(rv32_v2.PublicValuesAir)


def leaf_bytes(child_vk: bytes, child_pi_hash: bytes) -> bytes:
    """One 64-byte deferral leaf: keccak(child vk) || child pi-hash."""
    if len(child_pi_hash) != 32:
        raise ValueError("a child pi-hash is 32 bytes")
    return keccak256(child_vk) + child_pi_hash


class DeferredAggApp(CircuitApp):
    """The app whose guest DEFERS child verification (no in-circuit child
    verifier in this machine) and reveals keccak over the leaves."""

    name = "deferred-agg"
    MAX_CYCLES = 1 << 16
    # cap on the claimed keccak-table height (an untrusted claim would
    # otherwise size a preprocessed trace before any check fails)
    MAX_KECCAK_LOG_N = 20

    def program(self):
        cls = type(self)
        prog = cls.__dict__.get("_prog_cached")
        if prog is None:
            prog = guests.deferred_agg_program()
            cls._prog_cached = prog
        return prog

    def airs(self):
        return self.airs_for_meta(None)

    def airs_for_meta(self, meta):
        """The machine's AIR list; KeccakfAir's preprocessed schedule
        depends on its height, read from the untrusted `meta`: a short list
        or a height out of bounds raises ValueError."""
        kec_log_n = 5
        if meta is not None:
            if len(meta) < len(_MACHINE):
                raise ValueError("not a deferred-agg machine proof")
            kec_log_n = int(meta[KECCAKF_IDX][0])
            if not 5 <= kec_log_n <= self.MAX_KECCAK_LOG_N:
                raise ValueError(f"claimed keccak table height 2^{kec_log_n} out of bounds")
        special = {KeccakfAir: lambda: KeccakfAir(log_n=kec_log_n),
                   rv32_v2.ProgramAirV2: lambda: rv32_v2.ProgramAirV2(self.program())}
        return [special.get(cls, cls)() for cls in _MACHINE]

    def execute(self, task: ProvingTask):
        children = task.aggregated_proofs or []
        if not children:
            raise ValueError("deferred aggregation needs children")
        leaves = [leaf_bytes(c.baseline, c.user_pvs_proof) for c in children]
        prog = self.program()
        ex = Rv32Executor()
        ex.load_program(prog)
        ex.set_hints(guests.deferred_agg_hints(leaves))
        state = ex.run(self.MAX_CYCLES)
        if state != HALTED:
            raise RuntimeError(f"guest did not halt (state={state})")
        air_traces = rv32_v2.generate_traces(prog, ex.records(), data_base=guests.DATA_BASE)
        instances = [AirInstance(a, t, p) for a, t, p in air_traces]
        pi_hash = b"".join(int(w).to_bytes(4, "little") for w in ex.public_values())
        if pi_hash != keccak256(b"".join(leaves)):
            raise RuntimeError("guest/host digest mismatch")
        return instances, pi_hash

    def pi_hash_from_meta(self, metas) -> bytes:
        (_, _, pvs) = metas[PV_IDX]
        n = rv32_v2.N_PV_WORDS
        if len(pvs) < 5 * n or list(pvs[4 * n:5 * n]) != [1] * n:
            raise ValueError("all PV words must be revealed")
        return bytes(int(v) & 0xFF for v in pvs[:4 * n])

    @staticmethod
    def deferral_digest_from_meta(metas) -> np.ndarray:
        (_, _, pvs) = metas[DEFER_IDX]
        if len(pvs) != 8:
            raise ValueError("deferral chip must expose 8 digest words")
        return np.asarray(pvs, dtype=np.uint32)


register_app(DeferredAggApp)


def _child_pi_hash(child_app, rec: AggChildRecord, stark: StarkConfig,
                   device=None) -> Tuple[bytes, ChildSlot]:
    """The child's pi-hash from its flat PV record, split along the rebuilt
    AIR list's public-value counts; and its slot. Returns (pi_hash, slot)."""
    meta_like = [(int(ln), None, []) for ln in rec.log_ns]
    airs = child_app.airs_for_meta(meta_like)
    slot = ChildSlot(airs, rec.log_ns, stark, device)
    metas = []
    off = 0
    for ln, air in zip(rec.log_ns, airs):
        k = air.num_public_values
        metas.append((int(ln), air.width, list(rec.pvs[off:off + k])))
        off += k
    if off != len(rec.pvs):
        raise ValueError("child PV record length mismatch")
    return child_app.pi_hash_from_meta(metas), slot


class DeferredProver:
    """Prove a deferred aggregation over child StarkProofs on `device`
    (None: the card; without one the constructor raises)."""

    def __init__(self, stark: Optional[StarkConfig] = None, device=None):
        self.app = DeferredAggApp()
        self.stark = stark or StarkConfig()
        self.device = resolve_device(device)

    def prove(self, children: List[StarkProof], identifier: str = "") -> StarkProof:
        task = ProvingTask(serialized_witness=[], identifier=identifier,
                           aggregated_proofs=children)
        t0 = time.time()
        instances, pi_hash = self.app.execute(task)
        exec_ms = (time.time() - t0) * 1e3

        # the parent proof: the deferral digest in DeferralVmAir's PVs
        t0 = time.time()
        mproof = machine.prove_machine(instances, self.stark, device=self.device)

        # the discharge: a verifier-in-circuit leaf node over the children
        slots, records, commits, child_mps = [], [], [], []
        for child in children:
            child_app = app_for_vk(child.baseline)
            if child_app is None:
                raise ValueError("unknown child app vk")
            mp = serialization.decode_machine_proof(child.proof)
            log_ns = [ln for (ln, _, _) in mp.meta]
            slot = ChildSlot(child_app.airs_for_meta(mp.meta), log_ns, self.stark, self.device)
            slots.append(slot)
            child_mps.append(mp)
            pvs = [v for (_, _, p) in mp.meta for v in p]
            commits.append(input_commit(slot.vk_words, pvs))
            records.append(AggChildRecord(vk=child.baseline, log_ns=log_ns, pvs=pvs))
        prog = AggNodeProgram(TAG_LEAF, slots, self.stark, self.device)
        discharge, _ = prog.prove(child_mps)
        proving_ms = (time.time() - t0) * 1e3

        envelope = StarkProof(
            proof=serialization.encode_machine_proof(mproof),
            user_pvs_proof=pi_hash,
            baseline=self.app.vk_bytes(),
            deferral_merkle_proofs=encode_deferral(commits),
            stat=StarkProofStat(
                total_cycles=sum(int(i.trace.shape[0]) for i in instances),
                execution_time_mills=int(exec_ms),
                proving_time_mills=int(proving_ms),
            ),
            agg_children=records,
            input_commits=commits,
            deferral_discharge=serialization.encode_machine_proof(discharge),
        )
        if not verify_deferred(envelope, self.stark, self.device):
            raise RuntimeError("self-verification of deferred proof failed")
        return envelope


def verify_deferred(proof: StarkProof, stark: StarkConfig, device=None) -> bool:
    """Full deferred-aggregation verification (see the module docstring),
    on `device` (None: the card; without one this raises). Everything in
    the envelope is untrusted: a malformed one gives False."""
    dev = resolve_device(device)
    app = DeferredAggApp()
    if proof.baseline != app.vk_bytes():
        return False
    if not proof.agg_children or not proof.deferral_discharge:
        return False
    try:
        mproof = serialization.decode_machine_proof(proof.proof)
        airs = app.airs_for_meta(mproof.meta)
        if app.pi_hash_from_meta(mproof.meta) != proof.user_pvs_proof:
            return False

        # the children, rebuilt from the untrusted records
        slots, children, commits, leaves = [], [], [], []
        for rec in proof.agg_children:
            child_app = app_for_vk(rec.vk)
            if child_app is None:
                return False
            pi, slot = _child_pi_hash(child_app, rec, stark, dev)
            slots.append(slot)
            children.append((slot.vk_words, rec.pvs))
            commits.append(input_commit(slot.vk_words, rec.pvs))
            leaves.append(leaf_bytes(rec.vk, pi))
        if proof.input_commits != commits:
            return False
        if not decode_and_verify(proof.deferral_merkle_proofs, commits):
            return False

        # the parent's revealed hash and its deferral digest must both bind
        # exactly these leaves
        if proof.user_pvs_proof != keccak256(b"".join(leaves)):
            return False
        if not np.array_equal(chain_digest_from_leaves(leaves),
                              app.deferral_digest_from_meta(mproof.meta)):
            return False

        # the discharge proof verifies the children in-circuit and pins the
        # node digest over (vk, pvs)
        discharge = serialization.decode_machine_proof(proof.deferral_discharge)
        prog = AggNodeProgram(TAG_LEAF, slots, stark, dev)
        expected = digest_bytes(node_digest_words(TAG_LEAF, children))
        if not prog.verify(discharge, expected_digest=expected):
            return False

        # last, the parent machine itself
        return machine.verify_machine(airs, mproof, stark, device=dev)
    except Exception:
        return False
