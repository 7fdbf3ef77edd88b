from .testers import (
    BatchTaskGenerator,
    BundleTaskGenerator,
    ChunkTaskGenerator,
    output_dir,
    prove_verify,
)

__all__ = [
    "ChunkTaskGenerator",
    "BatchTaskGenerator",
    "BundleTaskGenerator",
    "output_dir",
    "prove_verify",
]
