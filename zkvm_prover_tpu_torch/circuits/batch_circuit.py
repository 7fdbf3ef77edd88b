"""Batch circuit program (parity with reference
crates/circuits/batch-circuit/src/{main.rs:10-35, circuit.rs:55-98}):
verify chunk proofs -> aggregated chunk PIs chained + hashed -> envelope
decode -> blob/KZG consistency -> BatchInfo -> pi hash."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from ..types.base.aggregation import AggregationInput
from ..types.base.chunk import ChunkInfo
from ..types.base.version import Codec, Version
from ..types.batch.builder import build_batch_info_v7
from ..types.batch.witness import BatchWitness, PointEvalWitness
from .circuit import AggCircuit


@dataclass
class BatchCircuitWitness:
    """BatchWitness + the child proofs being aggregated."""

    inner: BatchWitness
    chunk_proofs: List[AggregationInput] = field(default_factory=list)

    def get_proofs(self):
        return list(self.chunk_proofs)


class BatchCircuit(AggCircuit):
    name = "batch"

    # test hook: allows substituting the ceremony [tau]G2 in test vectors
    tau_g2_override = None

    @classmethod
    def validate(cls, witness: BatchCircuitWitness):
        version = Version.from_version_byte(witness.inner.version)

        # 1. verify aggregated chunk proofs (commitment checks; the STARK
        #    verification of children happens in the prover, on the host or
        #    in-circuit; a guest that defers them instead is
        #    host/deferred.py's deferred-agg app)
        proofs = cls.verify_proofs(witness)

        # 2. chunk PIs: chained and matching the child proofs' pi hashes
        chunk_infos: List[ChunkInfo] = witness.inner.chunk_infos
        agg_hashes = [p.pi_hash_bytes() for p in proofs]
        cls.validate_aggregated_pi(chunk_infos, agg_hashes, version)

        # 3. envelope decode + blob consistency + payload cross-checks.
        # Builder selection mirrors the reference's version dispatch
        # (builder/{v6,v7,validium}.rs via Codec/Domain).
        if version.is_validium:
            from ..types.batch.builder import build_batch_info_validium

            info = build_batch_info_validium(witness.inner)
        elif version.codec == Codec.V6:
            from ..types.batch.builder import build_batch_info_v6

            info = build_batch_info_v6(witness.inner)
        else:
            info = build_batch_info_v7(
                witness.inner, tau_g2=cls.tau_g2_override
            )
        return info, version
