"""Bundle circuit program (parity with reference
crates/circuits/bundle-circuit/src/{main.rs:13-37, circuit.rs:23-91}):
verify batch proofs -> chained batch PIs -> fold into BundleInfo -> pi hash."""

from __future__ import annotations

from ..types.base.version import Version
from ..types.bundle.witness import BundleWitness, bundle_info_from_witness
from .circuit import AggCircuit


class BundleCircuit(AggCircuit):
    name = "bundle"

    @classmethod
    def validate(cls, witness: BundleWitness):
        version = Version.from_version_byte(witness.version)
        proofs = cls.verify_proofs(witness)
        agg_hashes = [p.pi_hash_bytes() for p in proofs]
        cls.validate_aggregated_pi(
            witness.batch_infos, agg_hashes, version
        )
        info = bundle_info_from_witness(witness)
        return info, version
