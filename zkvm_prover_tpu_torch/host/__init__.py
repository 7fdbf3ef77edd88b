"""The host API: proving tasks in, verified proof envelopes out (the
reference's `zkvm_prover_tpu/host/`). `scroll_apps` registers the chunk,
batch and bundle apps when imported, and `deferred` the deferred-agg app
(imported here, so `app_for_vk` finds its vk)."""

from .proof_types import EvmProof, ProofEnum, StarkProof, StarkProofStat
from .task import ProvingTask
from .prover import Prover, ProverConfig
from .verifier import UniversalVerifier
from .deferred import DeferredAggApp, DeferredProver, verify_deferred

__all__ = [
    "EvmProof",
    "ProofEnum",
    "StarkProof",
    "StarkProofStat",
    "ProvingTask",
    "Prover",
    "ProverConfig",
    "UniversalVerifier",
    "DeferredAggApp",
    "DeferredProver",
    "verify_deferred",
]
