from .circuit import AggCircuit, Circuit, u32_array_to_commit
from .chunk_circuit import ChunkCircuit

__all__ = [
    "AggCircuit",
    "Circuit",
    "u32_array_to_commit",
    "ChunkCircuit",
]
