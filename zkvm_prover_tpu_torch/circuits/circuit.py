"""Circuit / AggCircuit program interfaces (parity with reference
crates/types/circuit/src/lib.rs:20-154).

These are the chunk/batch/bundle *guest programs* expressed as host logic for
now; they compile to VM guest programs once the rv32 chipset covers the full
instruction set (ROADMAP Phase 4→6). The aggregation path replaces openvm's
in-guest `verify_stark` deferral with host-side verification of the child
proof envelopes (recursion-in-circuit is Phase 5).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from ..types.base.aggregation import (
    AggregationInput,
    NUM_PUBLIC_VALUES,
    ProgramCommitment,
)


def u32_array_to_commit(arr: Sequence[int]) -> bytes:
    """[u32; 8] -> 32-byte commit, little-endian words (lib.rs:129-135)."""
    assert len(arr) == 8
    return b"".join(int(w).to_bytes(4, "little") for w in arr)


def commit_to_u32_array(commit: bytes) -> Tuple[int, ...]:
    assert len(commit) == 32
    return tuple(
        int.from_bytes(commit[4 * i : 4 * i + 4], "little") for i in range(8)
    )


class Circuit:
    """A provable program: witness -> public inputs -> revealed pi hash."""

    name: str = ""

    @classmethod
    def deserialize_witness(cls, witness_bytes: bytes):
        raise NotImplementedError

    @classmethod
    def validate(cls, witness):
        """Validate the witness, producing (public-input object, version)."""
        raise NotImplementedError

    @classmethod
    def pi_hash(cls, witness) -> bytes:
        pi, version = cls.validate(witness)
        return pi.pi_hash_by_version(version)


class AggCircuit(Circuit):
    """A circuit that additionally aggregates child proofs."""

    # expected child program commitments ([(exe, vm) u32x8 tuples])
    expected_child_commitments: List[ProgramCommitment] = []

    @classmethod
    def verify_commitments(cls, commitment: ProgramCommitment) -> None:
        if not cls.expected_child_commitments:
            return
        for expected in cls.expected_child_commitments:
            if commitment.exe == expected.exe and commitment.vm == expected.vm:
                return
        raise AssertionError(
            f"{cls.name}: child program commitment not recognised"
        )

    @classmethod
    def verify_proofs(cls, witness) -> List[AggregationInput]:
        proofs = witness.get_proofs()
        for proof in proofs:
            assert len(proof.public_values) == NUM_PUBLIC_VALUES
            cls.verify_commitments(proof.commitment)
        return proofs

    @classmethod
    def aggregated_public_inputs(cls, witness):
        raise NotImplementedError

    @classmethod
    def validate_aggregated_pi(cls, agg_pis, agg_pi_hashes, version) -> None:
        """Chained-PI validation (lib.rs:107-125)."""
        assert agg_pis, "at least 1 pi to aggregate"
        for prev, cur in zip(agg_pis, agg_pis[1:]):
            cur.validate(prev, version)
        assert len(agg_pis) == len(agg_pi_hashes)
        for pi, h in zip(agg_pis, agg_pi_hashes):
            assert pi.pi_hash_by_version(version) == h, (
                "pi hash mismatch between proofs and witness computed"
            )
