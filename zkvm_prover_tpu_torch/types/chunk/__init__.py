from .types import (
    legacy_data_hash,
    rolling_msg_queue_hash,
    tx_bytes_hash,
)
from .witness import ChunkWitness, ValidiumInputs, chunk_info_from_execution

__all__ = [
    "legacy_data_hash",
    "rolling_msg_queue_hash",
    "tx_bytes_hash",
    "ChunkWitness",
    "ValidiumInputs",
    "chunk_info_from_execution",
]
