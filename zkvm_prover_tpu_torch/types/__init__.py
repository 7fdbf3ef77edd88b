"""The Scroll public-input types: the reference's `zkvm_prover_tpu/types/`
(base: fork names, versions, chunk/batch/bundle public inputs; chunk: the
witness and its summary fold; batch: headers, the blob and its KZG check,
the DA envelopes and the BatchInfo builders; bundle: the witness and its
fold). The validium crypto and the re-execution of block witnesses are not
ported (ROADMAP Queue 1)."""

from . import base  # noqa: F401
