from .testers import ChunkTaskGenerator, output_dir, prove_verify

__all__ = [
    "ChunkTaskGenerator",
    "output_dir",
    "prove_verify",
]
