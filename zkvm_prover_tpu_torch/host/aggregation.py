"""Host aggregation API: the verifier-in-circuit recursion tree under the
host namespace (the reference's `host/aggregation.py`).

Aggregation nodes are wire-circuit machine proofs that verify their
children inside the constraint system (`recursion/aggregation.py`), so a
node proof implies its children's validity with no host pre-check.
Reference analog: in-guest `verify_stark` (crates/types/circuit/src/
lib.rs:138-154) and `AggregationTreeConfig { leaf: 4, internal: 3 }`
(crates/prover/src/prover/mod.rs:47-60).
"""

from ..recursion.aggregation import (  # noqa: F401
    TAG_INPUT_COMMIT,
    TAG_INTERNAL,
    TAG_LEAF,
    AggNodeProgram,
    AggNodeProof,
    AggregationTreeConfig,
    ChildSlot,
    RecursiveAggregationProver,
    build_child_verification,
    digest_bytes,
    input_commit,
    machine_vk_bytes,
    machine_vk_words,
    node_digest_words,
    verification_digest_of,
)

AggregationProver = RecursiveAggregationProver
