"""BatchInfo builder v7 (parity with reference
crates/types/batch/src/builder/v7.rs:27-135): envelope decode, zstd, blob
point-evaluation + KZG pairing check, payload<->chunk-PI cross-validation,
then fold into a BatchInfo."""

from __future__ import annotations

from typing import Optional

from ...fields import bls12_381 as bls
from ..base.batch import BatchInfo
from .blob import BlobPolynomial, N_BLOB_BYTES, kzg_to_versioned_hash
from .payload import EnvelopeV7, PayloadV7
from .witness import BatchWitness


def _build_point(x48: bytes, y48: bytes):
    p = (int.from_bytes(x48, "big"), int.from_bytes(y48, "big"))
    assert bls.g1_is_on_curve(p), "not a BLS12-381 G1 point"
    return p


def build_batch_info_v7(
    witness: BatchWitness,
    tau_g2: Optional[object] = None,
) -> BatchInfo:
    """The in-guest batch-circuit computation, host-expressed. tau_g2
    defaults to the Ethereum ceremony [tau]G2; pass a test setup's for
    insecure test vectors."""
    args_blob = witness.blob_bytes
    assert len(args_blob) <= N_BLOB_BYTES, "blob-envelope bigger than allowed"
    padded = args_blob + bytes(N_BLOB_BYTES - len(args_blob))
    envelope = EnvelopeV7.from_slice(padded)
    payload = PayloadV7.from_envelope(envelope)

    header = witness.header
    blob_versioned_hash = header.blob_versioned_hash
    challenge_digest = envelope.challenge_digest(blob_versioned_hash)

    # blob consistency: barycentric evaluation + KZG pairing check
    pe = witness.point_eval_witness
    assert pe is not None, "point eval witness required"
    blob_poly = BlobPolynomial(padded)
    z, y = blob_poly.evaluate(challenge_digest)
    commitment = _build_point(pe.kzg_commitment_x, pe.kzg_commitment_y)
    proof = _build_point(pe.kzg_proof_x, pe.kzg_proof_y)
    assert bls.verify_kzg_proof(z, y, commitment, proof, tau_g2), (
        "verify_kzg_proof fail!"
    )
    assert (
        kzg_to_versioned_hash(bls.g1_to_compressed_be(commitment))
        == blob_versioned_hash
    ), "kzg_to_versioned_hash"

    first, last = payload.validate(witness.chunk_infos)

    # version consistency between witness byte, blob envelope, header
    from ..base.version import Version

    version = Version.from_version_byte(witness.version)
    stf = int(version.stf_version)
    assert envelope.version == stf, "blob codec version mismatch"
    assert header.version == stf, "batch header version mismatch"

    return BatchInfo(
        parent_state_root=first.prev_state_root,
        parent_batch_hash=header.parent_batch_hash,
        state_root=last.post_state_root,
        batch_hash=header.batch_hash(),
        chain_id=last.chain_id,
        withdraw_root=last.withdraw_root,
        prev_msg_queue_hash=first.prev_msg_queue_hash,
        post_msg_queue_hash=last.post_msg_queue_hash,
        encryption_key=None,
    )


def build_batch_info_v6(witness: BatchWitness) -> BatchInfo:
    """BatchInfo builder v6 (parity with reference
    crates/types/batch/src/builder/v6.rs:14-59): decode the chunk-segmented
    envelope, check the header's blob_data_proof (z, y) against the
    barycentric evaluation at the payload challenge digest, and cross-check
    chunk data digests + the legacy batch data_hash."""
    from .payload import EnvelopeV6, PayloadV6

    header = witness.header
    envelope = EnvelopeV6.from_slice(witness.blob_bytes)
    payload = PayloadV6.from_envelope(envelope)

    padded = witness.blob_bytes + bytes(
        N_BLOB_BYTES - len(witness.blob_bytes)
    )
    blob_poly = BlobPolynomial(padded)
    challenge = payload.challenge_digest(header.blob_versioned_hash)
    z, y = blob_poly.evaluate(challenge)
    assert z.to_bytes(32, "big") == header.blob_data_proof[0], (
        "blob_data_proof challenge (z) mismatch"
    )
    assert y.to_bytes(32, "big") == header.blob_data_proof[1], (
        "blob_data_proof evaluation (y) mismatch"
    )

    first, last = payload.validate(header, witness.chunk_infos)

    return BatchInfo(
        parent_state_root=first.prev_state_root,
        parent_batch_hash=header.parent_batch_hash,
        state_root=last.post_state_root,
        batch_hash=header.batch_hash(),
        chain_id=last.chain_id,
        withdraw_root=last.withdraw_root,
        prev_msg_queue_hash=b"\x00" * 32,
        post_msg_queue_hash=b"\x00" * 32,
        encryption_key=None,
    )


def build_batch_info_validium(witness: BatchWitness) -> BatchInfo:
    """Validium builder (parity with reference
    crates/types/batch/src/builder/validium.rs:26-68): no blob/DA data; the
    header commits to the last block hash, post state root and withdraw
    root directly."""
    from ..base.version import Version

    header = witness.header
    version = Version.from_version_byte(witness.version)
    assert int(version.stf_version) == header.version, (
        "validium header version mismatch"
    )

    chunk_infos = witness.chunk_infos
    assert chunk_infos, "at least one chunk in batch"
    first, last = chunk_infos[0], chunk_infos[-1]

    assert last.post_blockhash == header.commitment, (
        "validium commitment != last block hash"
    )
    assert last.post_state_root == header.post_state_root
    assert last.withdraw_root == header.withdraw_root

    return BatchInfo(
        parent_state_root=first.prev_state_root,
        parent_batch_hash=header.parent_batch_hash,
        state_root=last.post_state_root,
        batch_hash=header.batch_hash(),
        chain_id=last.chain_id,
        withdraw_root=last.withdraw_root,
        prev_msg_queue_hash=first.prev_msg_queue_hash,
        post_msg_queue_hash=last.post_msg_queue_hash,
        encryption_key=first.encryption_key,
    )
