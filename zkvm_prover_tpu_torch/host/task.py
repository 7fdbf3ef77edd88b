"""Universal proving task (parity with reference crates/types/src/task.rs:7-23
and the ProvingTask trait at crates/prover/src/task/mod.rs:8-20)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

from .proof_types import StarkProof


@dataclass
class ProvingTask:
    serialized_witness: List[bytes]
    aggregated_proofs: List[StarkProof] = field(default_factory=list)
    fork_name: str = "galileo"
    vk: bytes = b""
    identifier: str = ""
    input_commits: List[bytes] = field(default_factory=list)  # 32-byte each

    def build_guest_input(self) -> List[bytes]:
        """Concatenated guest stdin stream: witness blobs then input commits
        (task/mod.rs:27-38)."""
        stream = list(self.serialized_witness)
        if self.input_commits:
            stream.append(b"".join(self.input_commits))
        return stream

    # -- wire format (proving-pool / scheduler transport) -------------------
    def to_dict(self) -> dict:
        import base64

        b64 = lambda b: base64.b64encode(b).decode()
        return {
            "serialized_witness": [b64(w) for w in self.serialized_witness],
            "aggregated_proofs": [p.to_dict()
                                  for p in self.aggregated_proofs],
            "fork_name": self.fork_name,
            "vk": self.vk.hex(),
            "identifier": self.identifier,
            "input_commits": [c.hex() for c in self.input_commits],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ProvingTask":
        import base64

        return cls(
            serialized_witness=[base64.b64decode(w)
                                for w in d["serialized_witness"]],
            aggregated_proofs=[StarkProof.from_dict(p)
                               for p in d.get("aggregated_proofs", [])],
            fork_name=d.get("fork_name", "galileo"),
            vk=bytes.fromhex(d.get("vk", "")),
            identifier=d.get("identifier", ""),
            input_commits=[bytes.fromhex(c)
                           for c in d.get("input_commits", [])],
        )
