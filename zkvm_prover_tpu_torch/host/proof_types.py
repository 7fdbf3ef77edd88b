"""Proof envelope types matching the reference JSON schema
(crates/types/src/proof.rs: StarkProof:52-67, EvmProof:16-37, StarkProofStat:
40-48, ProofEnum:147-242 — untagged stark/evm JSON, base64 byte fields).
"""

from __future__ import annotations

import base64
from dataclasses import dataclass, field
from typing import List, Union


@dataclass
class StarkProofStat:
    total_cycles: int = 0
    execution_time_mills: int = 0
    proving_time_mills: int = 0

    def to_dict(self):
        return {
            "total_cycles": self.total_cycles,
            "execution_time_mills": self.execution_time_mills,
            "proving_time_mills": self.proving_time_mills,
        }

    @classmethod
    def from_dict(cls, d):
        return cls(
            total_cycles=int(d.get("total_cycles", 0)),
            execution_time_mills=int(d.get("execution_time_mills", 0)),
            proving_time_mills=int(d.get("proving_time_mills", 0)),
        )


@dataclass
class AggChildRecord:
    """Untrusted hints about one in-circuit-verified child proof: which app
    (by vk), its trace heights, and its public values. All of it is bound
    by the node digest carried in the machine proof's PublicBindAir public
    values — the verifier recomputes the digest from these hints and the
    registered app's circuit, so lying about any field fails verification.
    Deferral-shaped (crates/integration/src/lib.rs:461-514 input_commits)."""

    vk: bytes
    log_ns: List[int]
    pvs: List[int]

    def to_dict(self):
        return {
            "vk": self.vk.hex(),
            "log_ns": list(self.log_ns),
            "pvs": [int(v) for v in self.pvs],
        }

    @classmethod
    def from_dict(cls, d):
        return cls(
            vk=bytes.fromhex(d["vk"]),
            log_ns=[int(v) for v in d["log_ns"]],
            pvs=[int(v) for v in d["pvs"]],
        )


@dataclass
class StarkProof:
    """Envelope around the encoded machine ("root") proof."""

    proof: bytes                        # encoded MachineProof
    user_pvs_proof: bytes               # encoded user public values
    baseline: bytes = b""               # verification baseline (v2+)
    deferral_merkle_proofs: bytes = b""
    stat: StarkProofStat = field(default_factory=StarkProofStat)
    # verifier-in-circuit aggregation (empty for leaf-level app proofs)
    agg_children: List[AggChildRecord] = field(default_factory=list)
    input_commits: List[bytes] = field(default_factory=list)
    # deferred aggregation: the discharge machine proof that verifies the
    # children the guest deferred (empty when children were verified
    # in-circuit or the proof aggregates nothing) — host/deferred.py
    deferral_discharge: bytes = b""

    def to_dict(self):
        b64 = lambda b: base64.b64encode(b).decode()
        d = {
            "proof": b64(self.proof),
            "user_pvs_proof": b64(self.user_pvs_proof),
            "baseline": b64(self.baseline),
            "deferral_merkle_proofs": b64(self.deferral_merkle_proofs),
            "stat": self.stat.to_dict(),
        }
        if self.agg_children:
            d["agg_children"] = [c.to_dict() for c in self.agg_children]
            d["input_commits"] = [c.hex() for c in self.input_commits]
        if self.deferral_discharge:
            d["deferral_discharge"] = b64(self.deferral_discharge)
        return d

    @classmethod
    def from_dict(cls, d):
        u64 = lambda s: base64.b64decode(s)
        return cls(
            proof=u64(d["proof"]),
            user_pvs_proof=u64(d["user_pvs_proof"]),
            baseline=u64(d.get("baseline", "")),
            deferral_merkle_proofs=u64(d.get("deferral_merkle_proofs", "")),
            stat=StarkProofStat.from_dict(d.get("stat", {})),
            agg_children=[
                AggChildRecord.from_dict(c)
                for c in d.get("agg_children", [])
            ],
            input_commits=[
                bytes.fromhex(c) for c in d.get("input_commits", [])
            ],
            deferral_discharge=u64(d.get("deferral_discharge", "")),
        )

    def public_values(self) -> List[int]:
        """Decode user PVs (byte-per-u32, NUM_PUBLIC_VALUES of them)."""
        return [int(b) for b in self.user_pvs_proof]


# instance layout: 12 accumulator + 2 digest + 32 PI-hash scalars x 32 bytes
N_ACC_SCALARS = 12
N_DIGEST_SCALARS = 2
N_PI_SCALARS = 32


@dataclass
class EvmProof:
    proof: bytes
    instances: bytes  # flattened 32-byte BE scalars

    def to_dict(self):
        b64 = lambda b: base64.b64encode(b).decode()
        return {"proof": b64(self.proof), "instances": b64(self.instances)}

    @classmethod
    def from_dict(cls, d):
        return cls(
            proof=base64.b64decode(d["proof"]),
            instances=base64.b64decode(d["instances"]),
        )

    def public_values(self) -> List[int]:
        """PI-hash bytes from the instances (LSB of each 32-byte scalar),
        mirroring proof.rs:221-239."""
        skip = (N_ACC_SCALARS + N_DIGEST_SCALARS) * 32
        pi = self.instances[skip : skip + N_PI_SCALARS * 32]
        return [pi[i * 32 + 31] for i in range(len(pi) // 32)]


ProofVariant = Union[StarkProof, EvmProof]


class ProofEnum:
    """Untagged stark/evm proof union (ProofEnum in the reference)."""

    @staticmethod
    def to_dict(p: ProofVariant):
        return p.to_dict()

    @staticmethod
    def from_dict(d) -> ProofVariant:
        # untagged: distinguish by fields (reference uses serde untagged)
        if "instances" in d:
            return EvmProof.from_dict(d)
        return StarkProof.from_dict(d)

    @staticmethod
    def public_values(p: ProofVariant) -> List[int]:
        return p.public_values()
