"""Stateless block execution layer — the sbv/revm analog (SURVEY §1 L1).

Re-executes L2 blocks from self-contained witnesses: a partial
Merkle-Patricia state trie (witness nodes), contract code preimages, and
signed transactions. Produces the pre/post state roots, per-block
execution summaries, and the withdraw root that feed the chunk circuit
(reference flow: crates/types/chunk/src/scroll/execute.rs:21-91 via
sbv_core::verifier::run).

The reference's `zkvm_prover_tpu/execution/`, copied; the port's one
departure is in `block.py`: a signed transaction's claimed sender must be
the address its signature recovers (`Tx.recover_sender`).
"""

from .block import (  # noqa: F401
    BlockWitness,
    Header,
    Tx,
    execute_block,
    execute_chunk_blocks,
)
from .state import WorldState  # noqa: F401

