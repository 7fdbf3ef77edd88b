"""Precompile crypto providers for the chunk circuit (parity with reference
crates/types/chunk/src/crypto/*: k256 ecrecover, p256 verify, ECIES for
validium L1-message decryption). Host-side witness-generation components —
the in-guest accelerated versions arrive with the precompile AIRs.

The reference's `zkvm_prover_tpu/types/chunk/crypto/`, with the port's own
AES-256-GCM (`aes_gcm.py`), HKDF (`ecies.hkdf_sha256`) and RIPEMD-160
(`ripemd160.py`), so that nothing here needs the `cryptography` package or
an OpenSSL digest."""

from .secp256k1 import ecrecover  # noqa: F401
from .secp256r1 import p256_verify  # noqa: F401
from .ecies import ecies_decrypt, ecies_encrypt  # noqa: F401
