"""Batch witness types (parity with reference
crates/types/batch/src/witness.rs:43-150)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from ..base.chunk import ChunkInfo


@dataclass
class PointEvalWitness:
    """48-byte BE x/y coordinates of the KZG commitment and proof G1 points."""

    kzg_commitment_x: bytes
    kzg_commitment_y: bytes
    kzg_proof_x: bytes
    kzg_proof_y: bytes


@dataclass
class BatchWitness:
    version: int                      # version byte
    chunk_infos: List[ChunkInfo]
    blob_bytes: bytes                 # unpadded envelope bytes
    header: object                    # BatchHeaderV6/V7/ValidiumV1
    point_eval_witness: Optional[PointEvalWitness] = None
