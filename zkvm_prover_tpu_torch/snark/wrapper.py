"""SNARK wrapper: root STARK proof -> EvmProof (BN254 PLONK): the
reference's `zkvm_prover_tpu/snark/wrapper.py`, with a `device` threaded
through `wrapper_keys`, `wrap_stark_proof` and `verify_evm_proof` (None is
the card) so that every KZG commitment runs on K4; the keys' in-process
cache is keyed by the SRS and the device.

The analog of the reference's gen_proof_snark path
(crates/prover/src/prover/mod.rs:419-432): the bundle/root STARK proof is
wrapped into a single BN254 proof whose instance column matches the
on-chain layout (crates/types/src/proof.rs:221-239):

    instances[0..12]  - KZG accumulator limbs (two G1 points, 3x88-bit
                        limbs per coordinate — the deferred pairing the
                        EVM verifier finishes)
    instances[12..14] - digests: D_vk  = Poseidon2Fr(exe_fr, vm_fr)
                                 D_pf  = Poseidon2Fr sponge over the
                                         root-proof keccak digest + the
                                         packed PI bytes
    instances[14..46] - the 32 PI-hash bytes, one byte per scalar

What the PLONK circuit proves (in-circuit):
  - D_vk is the Poseidon2 compression of the app vk's two commitment
    halves (each reduced into Fr);
  - every PI instance is a byte (8-bit decomposition);
  - D_pf is the Poseidon2 sponge of (root-proof keccak digest halves,
    PI bytes packed 16-per-felt) — binding proof digest and PI bytes
    into one instance.
The accumulator instances are carried (bound as instances, finished by
the pairing in the verifier): they encode a KZG opening of the root-proof
byte polynomial at a Fiat-Shamir point derived from the commitment and
the instances.

Documented divergence: the reference system's halo2 circuit
runs the FULL root-STARK verifier in-circuit (openvm root verifier via
snark-verifier's non-native ecc); here root-STARK validity is established
by the STARK layer itself (the root proof is already a verifier-in-circuit
aggregation proof) and re-checked by the host before wrapping, while the
wrapper binds the proof bytes/vk/PI cryptographically. Moving the STARK
verifier into the PLONK circuit is the remaining step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from ..fields import bn254 as bn
from ..ops.keccak import keccak256
from . import fr, plonk, poseidon2_fr as p2
from .fr import R

N_ACC = 12
N_DIGEST = 2
N_PI = 32
N_INSTANCES = N_ACC + N_DIGEST + N_PI

LIMB_BITS = 88
LIMB_MASK = (1 << LIMB_BITS) - 1


# ---------------------------------------------------------------------------
# instance packing helpers
# ---------------------------------------------------------------------------

def point_limbs(p: bn.G1) -> List[int]:
    """G1 point -> 6 limbs (x then y, little-endian 88-bit limbs)."""
    x, y = (0, 0) if p is None else p
    return [
        (x >> (LIMB_BITS * i)) & LIMB_MASK for i in range(3)
    ] + [
        (y >> (LIMB_BITS * i)) & LIMB_MASK for i in range(3)
    ]


def limbs_to_point(limbs: Sequence[int]) -> bn.G1:
    x = sum(int(v) << (LIMB_BITS * i) for i, v in enumerate(limbs[:3]))
    y = sum(int(v) << (LIMB_BITS * i) for i, v in enumerate(limbs[3:6]))
    if x == 0 and y == 0:
        return None
    assert bn.g1_is_on_curve((x, y)), "accumulator point not on curve"
    return (x, y)


def vk_to_fr(vk: bytes) -> Tuple[int, int]:
    """64-byte app vk -> two Fr elements (each 32-byte half, reduced)."""
    assert len(vk) == 64
    return (int.from_bytes(vk[:32], "big") % R,
            int.from_bytes(vk[32:], "big") % R)


def digest_to_fr(d: bytes) -> Tuple[int, int]:
    """32-byte digest -> two 16-byte Fr elements (no reduction loss)."""
    return (int.from_bytes(d[:16], "big"), int.from_bytes(d[16:], "big"))


# ---------------------------------------------------------------------------
# the wrapper circuit
# ---------------------------------------------------------------------------

def build_wrapper_circuit(
    acc_limbs: Sequence[int],
    exe_fr: int,
    vm_fr: int,
    proof_digest: bytes,
    pi_bytes: bytes,
) -> plonk.CircuitBuilder:
    """Construct + witness the wrapper circuit. Gate structure is
    witness-independent, so every call yields the same PlonkVk."""
    assert len(acc_limbs) == N_ACC and len(pi_bytes) == N_PI
    cb = plonk.CircuitBuilder()

    # --- instance rows, in on-chain order ------------------------------
    acc_vars = [cb.var(v) for v in acc_limbs]
    d_lo, d_hi = digest_to_fr(proof_digest)
    dvk_val = p2.hash_two(exe_fr, vm_fr)
    pk_lo = int.from_bytes(pi_bytes[:16], "big")
    pk_hi = int.from_bytes(pi_bytes[16:], "big")
    dpf_val = p2.sponge([d_lo, d_hi, pk_lo, pk_hi])
    dvk_var = cb.var(dvk_val)
    dpf_var = cb.var(dpf_val)
    pi_vars = [cb.var(b) for b in pi_bytes]
    for v in acc_vars:
        cb.public_input(v)
    cb.public_input(dvk_var)
    cb.public_input(dpf_var)
    for v in pi_vars:
        cb.public_input(v)

    # --- constraints ----------------------------------------------------
    # Witness inputs (exe/vm halves, proof-digest halves) are free
    # variables — NOT gate constants, which would leak into the selector
    # polynomials and change the vk per proof. They are bound through the
    # Poseidon2 outputs being public instances.
    # D_vk = Poseidon2(exe_fr, vm_fr)
    exe_var = cb.var(exe_fr)
    vm_var = cb.var(vm_fr)
    out = p2.circuit_permute(cb, [exe_var, vm_var, cb.constant(0)])
    cb.assert_eq(out[0], dvk_var)

    # PI bytes: 8-bit decomposition + packing
    def byte_check(v: int) -> None:
        bits = []
        val = cb.val(v)
        for k in range(8):
            bit = cb.var((val >> k) & 1)
            cb.assert_bool(bit)
            bits.append(bit)
        recomposed = cb.linear([(1 << k, b) for k, b in enumerate(bits)])
        cb.assert_eq(recomposed, v)

    for v in pi_vars:
        byte_check(v)

    # packed PI felts: big-endian byte order within each 16-byte half
    pk_lo_var = cb.linear(
        [(1 << (8 * (15 - i)), pi_vars[i]) for i in range(16)]
    )
    pk_hi_var = cb.linear(
        [(1 << (8 * (15 - i)), pi_vars[16 + i]) for i in range(16)]
    )

    # D_pf = sponge(d_lo, d_hi, pk_lo, pk_hi)
    dlo_var = cb.var(d_lo)
    dhi_var = cb.var(d_hi)
    dpf_out = p2.circuit_sponge(cb, [dlo_var, dhi_var, pk_lo_var,
                                     pk_hi_var])
    cb.assert_eq(dpf_out, dpf_var)
    return cb


# ---------------------------------------------------------------------------
# keys + proving
# ---------------------------------------------------------------------------

@dataclass
class WrapperKeys:
    pk: plonk.PlonkPk
    srs: bn.KzgSrs

    @property
    def vk(self) -> plonk.PlonkVk:
        return self.pk.vk


_KEYS_CACHE: dict = {}  # (SRS or None for the default one, device) -> WrapperKeys
_DEFAULT_SRS: List[bn.KzgSrs] = []  # generated once, shared by every device


def wrapper_keys(srs: Optional[bn.KzgSrs] = None, device=None) -> WrapperKeys:
    """Build (and cache) the wrapper proving key. The gate structure is
    witness-independent, so a dummy witness fixes the vk."""
    from ..stark.config import resolve_device

    key = (None if srs is None else id(srs), str(resolve_device(device)))
    hit = _KEYS_CACHE.get(key)
    if hit is not None and (srs is None or hit.srs is srs):
        return hit
    if srs is None:
        if not _DEFAULT_SRS:
            _DEFAULT_SRS.append(bn.KzgSrs.generate_insecure(13, tau=0x5EED_1234_ABCD))
        srs = _DEFAULT_SRS[0]
    cb = build_wrapper_circuit([0] * N_ACC, 0, 0, b"\x00" * 32,
                               b"\x00" * N_PI)
    pk = plonk.setup(cb, srs, device)
    _KEYS_CACHE[key] = WrapperKeys(pk=pk, srs=srs)
    return _KEYS_CACHE[key]


def _proof_bytes_poly(proof_bytes: bytes) -> List[int]:
    """Root proof bytes packed 31 bytes per Fr coefficient."""
    out = []
    for i in range(0, len(proof_bytes), 31):
        out.append(int.from_bytes(proof_bytes[i : i + 31], "big"))
    return out or [0]


def _accumulator(
    srs: bn.KzgSrs, proof_bytes: bytes, instance_seed: bytes, device=None
) -> Tuple[List[int], bn.G1, int, bn.G1]:
    """KZG-commit the root-proof byte polynomial, open at the Fiat-Shamir
    point xi = keccak(C_P || seed), and return the deferred pairing pair
    (W, rhs = xi*W + C_P - y*G) as 12 limbs + the decoded parts."""
    coeffs = _proof_bytes_poly(proof_bytes)
    # large proofs: fold down to SRS size by compressing tail pages with
    # keccak (keeps commitment well-defined for any proof size)
    max_len = len(srs.g1_powers)
    while len(coeffs) > max_len:
        page = coeffs[max_len - 1 :]
        acc = b"".join(int(c).to_bytes(32, "big") for c in page)
        coeffs = coeffs[: max_len - 1] + [
            int.from_bytes(keccak256(acc), "big") % R
        ]
    c_p = bn.kzg_commit(srs, coeffs, device)
    xi = int.from_bytes(
        keccak256(_g1b(c_p) + instance_seed), "big"
    ) % R
    y, w = bn.kzg_open(srs, coeffs, xi, device)
    rhs = bn.msm_jac(
        [w, c_p, bn.G1_GEN], [xi, 1, (-y) % R]
    )
    limbs = point_limbs(w) + point_limbs(rhs)
    return limbs, c_p, y, w


def _g1b(p: bn.G1) -> bytes:
    return plonk._g1_bytes(p)


def instances_bytes(
    acc_limbs: Sequence[int], d_vk: int, d_pf: int, pi_bytes: bytes
) -> bytes:
    vals = list(acc_limbs) + [d_vk, d_pf] + list(pi_bytes)
    return b"".join(int(v).to_bytes(32, "big") for v in vals)


def decode_instances(raw: bytes) -> Tuple[List[int], int, int, bytes]:
    assert len(raw) == N_INSTANCES * 32
    vals = [int.from_bytes(raw[i * 32 : (i + 1) * 32], "big")
            for i in range(N_INSTANCES)]
    acc = vals[:N_ACC]
    d_vk, d_pf = vals[N_ACC], vals[N_ACC + 1]
    pi = bytes(v & 0xFF for v in vals[N_ACC + N_DIGEST :])
    return acc, d_vk, d_pf, pi


def wrap_stark_proof(
    app_vk: bytes, proof_bytes: bytes, pi_hash: bytes,
    keys: Optional[WrapperKeys] = None, device=None,
):
    """Produce an EvmProof envelope for a (host-pre-verified) root STARK
    proof. Callers must verify the STARK envelope first (the Prover does:
    gen_proof_snark -> gen_proof_stark self-verifies)."""
    from ..host.proof_types import EvmProof

    keys = keys or wrapper_keys(device=device)
    exe_fr, vm_fr = vk_to_fr(app_vk)
    # the proof digest binds vk + PI + full proof body
    proof_digest = keccak256(app_vk + pi_hash + proof_bytes)
    d_lo, d_hi = digest_to_fr(proof_digest)
    pk_lo = int.from_bytes(pi_hash[:16], "big")
    pk_hi = int.from_bytes(pi_hash[16:], "big")
    d_vk = p2.hash_two(exe_fr, vm_fr)
    d_pf = p2.sponge([d_lo, d_hi, pk_lo, pk_hi])

    # accumulator over the proof bytes, seeded by the non-acc instances
    seed = keccak256(
        instances_bytes([0] * N_ACC, d_vk, d_pf, pi_hash)[N_ACC * 32 :]
    )
    acc_limbs, c_p, y, w = _accumulator(keys.srs, proof_bytes, seed, device)

    cb = build_wrapper_circuit(acc_limbs, exe_fr, vm_fr, proof_digest,
                               pi_hash)
    proof = plonk.prove(keys.pk, cb, device)
    blob = (proof.to_bytes() + _g1b(c_p) + int(y).to_bytes(32, "big")
            + _g1b(w))
    return EvmProof(
        proof=blob,
        instances=instances_bytes(acc_limbs, d_vk, d_pf, pi_hash),
    )


_PLONK_PROOF_LEN = 9 * 64 + 16 * 32


def verify_evm_proof(
    app_vk: bytes, evm_proof, keys: Optional[WrapperKeys] = None,
    use_evm_sim: bool = True, device=None,
) -> bool:
    """Full EvmProof verification: PLONK proof + instance consistency +
    the deferred accumulator pairing. When use_evm_sim is set, the PLONK
    check also runs as generated EVM bytecode under the mini-EVM
    (the reference's revm simulation of verifier.bin — evm.rs:38-43)."""
    try:
        raw = evm_proof.proof
        if len(raw) != _PLONK_PROOF_LEN + 64 + 32 + 64:
            return False
        keys = keys or wrapper_keys(device=device)
        proof = plonk.PlonkProof.from_bytes(raw[:_PLONK_PROOF_LEN])
        off = _PLONK_PROOF_LEN
        c_p = plonk._g1_from_bytes(raw[off : off + 64]); off += 64
        y = int.from_bytes(raw[off : off + 32], "big"); off += 32
        w = plonk._g1_from_bytes(raw[off : off + 64])

        acc, d_vk, d_pf, pi = decode_instances(evm_proof.instances)
        # instance <-> vk binding
        exe_fr, vm_fr = vk_to_fr(app_vk)
        if d_vk != p2.hash_two(exe_fr, vm_fr):
            return False
        instance_vals = acc + [d_vk, d_pf] + [b for b in pi]
        if not plonk.verify(keys.vk, proof, instance_vals, device):
            return False
        # accumulator consistency: recompute xi and rhs from the carried
        # opening, then finish the deferred pairing
        seed = keccak256(evm_proof.instances[N_ACC * 32 :])
        xi = int.from_bytes(keccak256(_g1b(c_p) + seed), "big") % R
        rhs = bn.msm_jac([w, c_p, bn.G1_GEN], [xi, 1, (-y) % R])
        if acc != point_limbs(w) + point_limbs(rhs):
            return False
        # e(W, [tau]2) == e(xi*W + C_P - y*G, G2)
        if not bn.pairing_check([
            (keys.srs.tau_g2, w),
            (bn.g2_neg(bn.G2_GEN), rhs),
        ]):
            return False
        if use_evm_sim:
            from .verifier_contract import evm_verify

            if not evm_verify(keys.vk, proof, instance_vals):
                return False
        return True
    except Exception:
        return False
