"""EIP-4844 blob consistency: blob polynomial, barycentric point evaluation,
versioned hashes (the reference's `zkvm_prover_tpu/types/batch/blob.py`;
parity with reference crates/types/batch/src/
blob_consistency/{mod.rs:33-58, openvm.rs:61-149}).

The blob is 4096 BLS12-381 scalars in *evaluation* form over the order-4096
subgroup in **bit-reversed order** (EIP-4844 / consensus-specs convention);
point evaluation uses the barycentric formula
    P(z) = (z^N - 1)/N * sum_i f_i * root_i / (z - root_i).
"""

from __future__ import annotations

import hashlib
from typing import List, Tuple

from ...fields import bls12_381 as bls
from ...ops.keccak import keccak256

R = bls.R

N_BYTES_U256 = 32
N_DATA_BYTES_PER_COEFFICIENT = 31
BLOB_WIDTH = 4096
LOG_BLOB_WIDTH = 12
N_BLOB_BYTES = BLOB_WIDTH * N_DATA_BYTES_PER_COEFFICIENT

VERSIONED_HASH_VERSION_KZG = 1

# primitive root of unity 7 (consensus-specs deneb constants)
_ROOT_OF_UNITY = pow(7, (R - 1) // BLOB_WIDTH, R)


def _bitrev(i: int, bits: int) -> int:
    out = 0
    for b in range(bits):
        out |= ((i >> b) & 1) << (bits - 1 - b)
    return out


def roots_of_unity_brp() -> List[int]:
    """Order-4096 roots in bit-reversed-permutation order."""
    asc = [1] * BLOB_WIDTH
    for i in range(1, BLOB_WIDTH):
        asc[i] = (asc[i - 1] * _ROOT_OF_UNITY) % R
    return [asc[_bitrev(i, LOG_BLOB_WIDTH)] for i in range(BLOB_WIDTH)]


_ROOTS_BRP = None


def _roots():
    global _ROOTS_BRP
    if _ROOTS_BRP is None:
        _ROOTS_BRP = roots_of_unity_brp()
    return _ROOTS_BRP


class BlobPolynomial:
    """4096 coefficients, each packing 31 data bytes (MSB zero)."""

    def __init__(self, blob_bytes: bytes):
        assert len(blob_bytes) <= N_BLOB_BYTES, "too many bytes in batch data"
        coeffs = []
        for i in range(BLOB_WIDTH):
            chunk = bytearray(N_BYTES_U256)
            seg = blob_bytes[i * 31 : (i + 1) * 31]
            chunk[1 : 1 + len(seg)] = seg
            coeffs.append(int.from_bytes(bytes(chunk), "big"))
        self.coefficients = coeffs

    def to_blob_bytes(self) -> bytes:
        """Full 4096*32-byte EIP-4844 blob (BE scalars)."""
        return b"".join(c.to_bytes(32, "big") for c in self.coefficients)

    def evaluate(self, challenge_digest: bytes) -> Tuple[int, int]:
        """(challenge, evaluation): challenge = digest mod r; barycentric
        P(z) over the bit-reversed evaluation form."""
        z = int.from_bytes(challenge_digest, "big") % R
        return z, point_evaluation(self.coefficients, z)


def point_evaluation(coefficients: List[int], z: int) -> int:
    """The reference's barycentric sum, with the 4096 inverses of
    (z - root) taken in one batch (Montgomery's trick) instead of one
    modular exponentiation each: the same value, about 100 times faster."""
    roots = _roots()
    for f, root in zip(coefficients, roots):
        if z == root:
            return f % R
    pairs = list(zip(coefficients, roots))
    inverses = _batch_inverse([(z - root) % R for _, root in pairs])
    acc = 0
    for (f, root), inv in zip(pairs, inverses):
        acc = (acc + f * root % R * inv) % R
    n = BLOB_WIDTH
    zn1 = (pow(z, n, R) - 1) % R
    return zn1 * acc % R * pow(n, R - 2, R) % R


def _batch_inverse(values: List[int]) -> List[int]:
    """Inverses mod R of `values`, with 0 for 0 (as pow(0, R - 2, R))."""
    prefix = []
    acc = 1
    for v in values:
        prefix.append(acc)
        if v:
            acc = acc * v % R
    inv = pow(acc, R - 2, R)
    out = [0] * len(values)
    for i in range(len(values) - 1, -1, -1):
        if values[i]:
            out[i] = inv * prefix[i] % R
            inv = inv * values[i] % R
    return out


def kzg_to_versioned_hash(kzg_commitment_compressed: bytes) -> bytes:
    h = bytearray(hashlib.sha256(kzg_commitment_compressed).digest())
    h[0] = VERSIONED_HASH_VERSION_KZG
    return bytes(h)


def challenge_digest(envelope_bytes: bytes, blob_versioned_hash: bytes) -> bytes:
    """keccak(keccak(envelope) || versioned_hash) (payload/v7.rs:82-99)."""
    return keccak256(keccak256(envelope_bytes) + blob_versioned_hash)


# -- host-side commitment/proof helpers (the c-kzg analog; utils.rs:2-55) ---


def commit_blob(setup: bls.InsecureKzgSetup, blob: BlobPolynomial):
    """KZG commitment to the blob (interpolate bit-reversed evaluation form
    to coefficients via an inverse NTT over the scalar field, then commit)."""
    coeffs = _inverse_ntt_brp(blob.coefficients)
    return setup.commit_coeffs_fast(coeffs)


def prove_blob_eval(setup: bls.InsecureKzgSetup, blob: BlobPolynomial, z: int):
    coeffs = _inverse_ntt_brp(blob.coefficients)
    return setup.prove_eval_coeffs_fast(coeffs, z)


def _inverse_ntt_brp(evals_brp: List[int]) -> List[int]:
    """Bit-reversed evaluation form -> coefficients (scalar field NTT)."""
    n = BLOB_WIDTH
    # un-bit-reverse to natural evaluation order
    vals = [0] * n
    for i, v in enumerate(evals_brp):
        vals[_bitrev(i, LOG_BLOB_WIDTH)] = v
    # naive radix-2 inverse NTT (host, 4096 points -> fast enough)
    w_inv = pow(_ROOT_OF_UNITY, R - 2, R)

    def ntt(a, w):
        if len(a) == 1:
            return a
        even = ntt(a[0::2], w * w % R)
        odd = ntt(a[1::2], w * w % R)
        out = [0] * len(a)
        wk = 1
        half = len(a) // 2
        for k in range(half):
            t = wk * odd[k] % R
            out[k] = (even[k] + t) % R
            out[k + half] = (even[k] - t) % R
            wk = wk * w % R
        return out

    coeffs = ntt(vals, w_inv)
    n_inv = pow(n, R - 2, R)
    return [c * n_inv % R for c in coeffs]
