from .header import BatchHeaderV6, BatchHeaderV7, BatchHeaderValidiumV1
from .blob import (
    BLOB_WIDTH,
    N_BLOB_BYTES,
    BlobPolynomial,
    kzg_to_versioned_hash,
    point_evaluation,
)
from .payload import EnvelopeV7, PayloadV7
from .witness import BatchWitness, PointEvalWitness
from .builder import (
    build_batch_info_v6,
    build_batch_info_v7,
    build_batch_info_validium,
)

__all__ = [
    "BatchHeaderV6",
    "BatchHeaderV7",
    "BatchHeaderValidiumV1",
    "BLOB_WIDTH",
    "N_BLOB_BYTES",
    "BlobPolynomial",
    "kzg_to_versioned_hash",
    "point_evaluation",
    "EnvelopeV7",
    "PayloadV7",
    "BatchWitness",
    "PointEvalWitness",
    "build_batch_info_v6",
    "build_batch_info_v7",
    "build_batch_info_validium",
]
