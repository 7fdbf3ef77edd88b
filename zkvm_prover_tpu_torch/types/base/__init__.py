from .fork_name import ForkName
from .version import Codec, Domain, STFVersion, Version
from .aggregation import (
    AggregationInput,
    ProgramCommitment,
    NUM_PUBLIC_VALUES,
)
from .chunk import BlockContextV2, ChunkInfo, SIZE_BLOCK_CTX
from .batch import BatchInfo
from .bundle import BundleInfo

__all__ = [
    "ForkName",
    "Codec",
    "Domain",
    "STFVersion",
    "Version",
    "AggregationInput",
    "ProgramCommitment",
    "NUM_PUBLIC_VALUES",
    "BlockContextV2",
    "ChunkInfo",
    "SIZE_BLOCK_CTX",
    "BatchInfo",
    "BundleInfo",
]
