from .circuit import AggCircuit, Circuit, u32_array_to_commit
from .chunk_circuit import ChunkCircuit
from .batch_circuit import BatchCircuit
from .bundle_circuit import BundleCircuit

__all__ = [
    "AggCircuit",
    "Circuit",
    "u32_array_to_commit",
    "ChunkCircuit",
    "BatchCircuit",
    "BundleCircuit",
]
