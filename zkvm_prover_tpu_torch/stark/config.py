"""STARK and FRI configuration (the reference's security profile): FRI
log_blowup 1, 100 queries, 16 PoW bits, log_final_poly_len 0; and the
port's device rule."""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from ..fields import babybear as bb


@dataclass(frozen=True)
class FriConfig:
    log_blowup: int = 1
    num_queries: int = 100
    proof_of_work_bits: int = 16
    log_final_poly_len: int = 0


@dataclass(frozen=True)
class StarkConfig:
    fri: FriConfig = field(default_factory=FriConfig)
    # LDE/commitment coset shift (the field generator)
    coset_shift: int = bb.GENERATOR

    @property
    def log_blowup(self) -> int:
        return self.fri.log_blowup

    @property
    def blowup(self) -> int:
        return 1 << self.fri.log_blowup


def default_config() -> StarkConfig:
    return StarkConfig()


def fast_test_config() -> StarkConfig:
    """Reduced-query config for tests (NOT secure)."""
    return StarkConfig(
        fri=FriConfig(log_blowup=1, num_queries=8, proof_of_work_bits=4))


def resolve_device(device=None) -> torch.device:
    """None means the card; without one that raises (no CPU fallback)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the host")
        return torch.device("cuda")
    return torch.device(device)
