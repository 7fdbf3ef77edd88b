"""Aggregation commitment types (parity with reference
crates/types/base/src/aggregation.rs:3-29)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

NUM_PUBLIC_VALUES = 32  # each u32 holds one byte of the PI hash


@dataclass(frozen=True)
class ProgramCommitment:
    """Commitment needed to verify a child root proof."""

    exe: Tuple[int, ...] = (0,) * 8  # [u32; 8]
    vm: Tuple[int, ...] = (0,) * 8

    def __post_init__(self):
        assert len(self.exe) == 8 and len(self.vm) == 8


@dataclass
class AggregationInput:
    """Child program commitments + public values carried into an aggregation
    circuit."""

    public_values: List[int]  # Vec<u32>; each holds one byte
    commitment: ProgramCommitment = field(default_factory=ProgramCommitment)

    def pi_hash_bytes(self) -> bytes:
        """Recover the 32-byte PI hash from the byte-per-u32 public values."""
        assert len(self.public_values) == NUM_PUBLIC_VALUES
        return bytes(v & 0xFF for v in self.public_values)

    @classmethod
    def from_pi_hash(cls, pi_hash: bytes, commitment=None) -> "AggregationInput":
        assert len(pi_hash) == 32
        return cls(
            public_values=[int(b) for b in pi_hash],
            commitment=commitment or ProgramCommitment(),
        )
