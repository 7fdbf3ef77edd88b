"""The Scroll public-input types: the reference's `zkvm_prover_tpu/types/`
(base: fork names, versions, chunk/batch/bundle public inputs; chunk: the
witness and its summary fold; batch: headers, the blob and its KZG check,
the DA envelopes and the BatchInfo builders; bundle: the witness and its
fold). `chunk.crypto` holds the secp256k1 / P-256 curves, ECIES and the
validium decryption; the chunk witness's block witnesses are re-executed
by `execution/`."""

from . import base  # noqa: F401
