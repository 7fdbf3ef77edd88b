"""Bundle witness: fold batch infos into a BundleInfo (parity with reference
crates/types/bundle/src/witness.rs:9-65)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

from ..base.aggregation import AggregationInput
from ..base.batch import BatchInfo
from ..base.bundle import BundleInfo
from ..base.fork_name import ForkName


@dataclass
class BundleWitness:
    version: int
    batch_proofs: List[AggregationInput]
    batch_infos: List[BatchInfo]
    fork_name: ForkName

    def get_proofs(self) -> List[AggregationInput]:
        return list(self.batch_proofs)


def bundle_info_from_witness(witness: BundleWitness) -> BundleInfo:
    assert witness.batch_infos, "at least one batch in a bundle"
    first = witness.batch_infos[0]
    last = witness.batch_infos[-1]
    return BundleInfo(
        chain_id=first.chain_id,
        msg_queue_hash=last.post_msg_queue_hash,
        num_batches=len(witness.batch_infos),
        prev_state_root=first.parent_state_root,
        prev_batch_hash=first.parent_batch_hash,
        post_state_root=last.state_root,
        batch_hash=last.batch_hash,
        withdraw_root=last.withdraw_root,
        encryption_key=first.encryption_key,
    )
