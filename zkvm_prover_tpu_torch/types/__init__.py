"""The Scroll public-input types: the reference's `zkvm_prover_tpu/types/`
(base: fork names, versions, chunk/batch/bundle public inputs; chunk: the
witness and its summary fold). The validium crypto and the re-execution of
block witnesses are not ported (ROADMAP Queue 1)."""

from . import base  # noqa: F401
