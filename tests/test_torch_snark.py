"""The port's SNARK wrapper layer (`snark/`, CPU) against the JAX package's:
Fr polynomials, Poseidon2 over Fr, PLONK, the mini-EVM and its precompiles,
the generated verifier bytecode, and the EvmProof of `wrap_stark_proof`, on
the same inputs made with numpy from a seed. Every comparison is exact:
proofs, digests and bytecode are compared byte for byte, each package's
verifier is run on the other's proof, and tampered proofs are rejected by
both.

The wrapper's keys (an SRS of 2^13 powers and a circuit of 2^12 gates, about
20 s here) are built once, by the reference, and carried to the port by
`convert.py`; the port's own `plonk.setup` of the same circuit is held
against them."""

import copy
import json

import numpy as np
import pytest

from zkvm_prover_tpu.fields import bn254 as ref_bn
from zkvm_prover_tpu.host.proof_types import EvmProof as RefEvmProof
from zkvm_prover_tpu.snark import evm as ref_evm
from zkvm_prover_tpu.snark import fr as ref_fr
from zkvm_prover_tpu.snark import plonk as ref_plonk
from zkvm_prover_tpu.snark import poseidon2_fr as ref_p2
from zkvm_prover_tpu.snark import verifier_contract as ref_vc
from zkvm_prover_tpu.snark import wrapper as ref_wrapper
from zkvm_prover_tpu_torch import convert
from zkvm_prover_tpu_torch.fields import bn254 as bn
from zkvm_prover_tpu_torch.snark import evm, fr, plonk
from zkvm_prover_tpu_torch.snark import poseidon2_fr as p2
from zkvm_prover_tpu_torch.snark import verifier_contract as vc
from zkvm_prover_tpu_torch.snark import wrapper

CPU = "cpu"


def _ints(seed, n, modulus=fr.R):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % modulus for _ in range(n)]


# ---------------------------------------------------------------------------
# Fr polynomials and Poseidon2 over Fr
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("log_n", [1, 4, 7])
def test_fr_ntt_round_trips(log_n):
    coeffs = _ints(log_n, 1 << log_n)
    ev = fr.ntt(coeffs, log_n)
    assert ev == ref_fr.ntt(coeffs, log_n)
    assert fr.ntt(ev, log_n, inverse=True) == coeffs
    ev2 = fr.evals_on_coset(coeffs, log_n + 1, fr.GENERATOR)
    assert ev2 == ref_fr.evals_on_coset(coeffs, log_n + 1, ref_fr.GENERATOR)
    back = fr.coeffs_from_coset(ev2, log_n + 1, fr.GENERATOR)
    assert back[:1 << log_n] == coeffs and not any(back[1 << log_n:])
    om = fr.root_of_unity(log_n)
    assert ev[-1] == fr.poly_eval(coeffs, pow(om, (1 << log_n) - 1, fr.R))
    z = _ints(log_n + 100, 1)[0]
    assert fr.divide_by_linear(coeffs, z) == ref_fr.divide_by_linear(coeffs, z)
    assert fr.vanishing_eval(log_n, z) == ref_fr.vanishing_eval(log_n, z)


def test_poseidon2_fr_matches_reference():
    assert p2._RC == ref_p2._RC
    for seed in range(3):
        s = _ints(seed, 3)
        assert p2.permute(s) == ref_p2.permute(s)
        assert p2.hash_two(s[0], s[1]) == ref_p2.hash_two(s[0], s[1])
        xs = _ints(seed + 10, seed + 2)
        assert p2.sponge(xs) == ref_p2.sponge(xs)
    assert p2.sponge([1, 2]) != p2.sponge([1, 2, 0, 0])


def test_poseidon2_fr_gadgets_match_host():
    cb = plonk.CircuitBuilder()
    ins = _ints(5, 3)
    outs = p2.circuit_permute(cb, [cb.var(v) for v in ins])
    assert [cb.val(v) for v in outs] == p2.permute(ins) == ref_p2.permute(ins)
    xs = _ints(6, 5)
    d = p2.circuit_sponge(cb, [cb.var(v) for v in xs])
    assert cb.val(d) == ref_p2.sponge(xs)
    assert cb.check() == []


# ---------------------------------------------------------------------------
# the small PLONK at generate_insecure(7)
# ---------------------------------------------------------------------------


def _small_circuit(pl):
    cb = pl.CircuitBuilder()
    x, y = cb.var(6), cb.var(7)
    p1, p2_ = cb.var(45), cb.var(55)
    cb.public_input(p1)
    cb.public_input(p2_)
    cb.assert_eq(cb.add_const(cb.mul(x, y), 3), p1)
    cb.assert_eq(cb.add(x, cb.mul(y, y)), p2_)
    bit = cb.var(1)
    cb.assert_bool(bit)
    cb.linear([(2, x), (3, y), (5, bit)], const=11)
    return cb


@pytest.fixture(scope="module")
def small():
    ref_srs = ref_bn.KzgSrs.generate_insecure(7, tau=0xDEADBEEF12345)
    srs = convert.srs_from_reference(ref_srs)
    ref_pk = ref_plonk.setup(_small_circuit(ref_plonk), ref_srs)
    pk = plonk.setup(_small_circuit(plonk), srs, CPU)
    return {"ref_pk": ref_pk, "pk": pk,
            "ref_proof": ref_plonk.prove(ref_pk, _small_circuit(ref_plonk)),
            "proof": plonk.prove(pk, _small_circuit(plonk), CPU), "public": [45, 55]}


def test_small_plonk_equals_reference(small):
    assert small["pk"].vk.digest() == small["ref_pk"].vk.digest()
    assert small["pk"].q_polys == small["ref_pk"].q_polys
    assert small["pk"].sigma_maps == small["ref_pk"].sigma_maps
    assert small["proof"].to_bytes() == small["ref_proof"].to_bytes()
    assert plonk.PlonkProof.from_bytes(small["proof"].to_bytes()).to_bytes() == \
        small["proof"].to_bytes()


def test_small_plonk_cross_verifies(small):
    ref_as_port = plonk.PlonkProof.from_bytes(small["ref_proof"].to_bytes())
    port_as_ref = ref_plonk.PlonkProof.from_bytes(small["proof"].to_bytes())
    assert plonk.verify(small["pk"].vk, ref_as_port, small["public"], CPU)
    assert ref_plonk.verify(small["ref_pk"].vk, port_as_ref, small["public"])


def _tampered(proof, how):
    bad = copy.deepcopy(proof)
    if how == "eval":
        bad.evals["a"] = (bad.evals["a"] + 1) % fr.R
    elif how == "commitment":
        bad.comms["z"] = bn.g1_add(bad.comms["z"], bn.G1_GEN)
    elif how == "swapped openings":
        bad.comms["w_zeta"], bad.comms["w_zeta_omega"] = (bad.comms["w_zeta_omega"],
                                                          bad.comms["w_zeta"])
    return bad


@pytest.mark.parametrize("how", ["eval", "commitment", "swapped openings", "public"])
def test_small_plonk_tampers_rejected_by_both(small, how):
    public = small["public"]
    proof = small["proof"]
    if how == "public":
        public = [public[0] + 1, public[1]]
    else:
        proof = _tampered(proof, how)
    assert not plonk.verify(small["pk"].vk, proof, public, CPU)
    assert not ref_plonk.verify(small["ref_pk"].vk,
                                ref_plonk.PlonkProof.from_bytes(proof.to_bytes()), public)
    assert not vc.evm_verify(small["pk"].vk, proof, public)


# ---------------------------------------------------------------------------
# the mini-EVM: precompiles and the generated verifier
# ---------------------------------------------------------------------------


def _g1b(p):
    return p[0].to_bytes(32, "big") + p[1].to_bytes(32, "big")


def _precompile_inputs():
    a, b = _ints(20, 2)
    pa, pb = bn.g1_mul(bn.G1_GEN, a), bn.g1_mul(bn.G1_GEN, b)
    q = bn.g2_mul(bn.G2_GEN, 3)

    def g2b(p):
        (xr, xi), (yr, yi) = p
        return b"".join(v.to_bytes(32, "big") for v in (xi, xr, yi, yr))

    hdr = (32).to_bytes(32, "big") * 3
    return [
        (5, hdr + b"".join(v.to_bytes(32, "big") for v in _ints(21, 3, 1 << 256))),
        (6, _g1b(pa) + _g1b(pb)),
        (6, _g1b(pa) + _g1b(bn.g1_neg(pa))),
        (6, _g1b(pa) + b"\x00" * 64),
        (6, _g1b(pa) + (1).to_bytes(32, "big") + (3).to_bytes(32, "big")),  # not on the curve
        (7, _g1b(pb) + b.to_bytes(32, "big")),
        (7, _g1b(pa) + fr.R.to_bytes(32, "big")),
        (8, _g1b(bn.g1_mul(bn.G1_GEN, 3)) + g2b(bn.G2_GEN)
         + _g1b(bn.g1_neg(bn.G1_GEN)) + g2b(q)),
        (8, _g1b(bn.G1_GEN) + g2b(q)),
        (8, b"\x01" * 100),
    ]


@pytest.mark.parametrize("case", range(10))
def test_evm_precompiles_match_reference(case):
    addr, data = _precompile_inputs()[case]
    got = evm.Evm(b"")._precompile(addr, data)
    assert got == ref_evm.Evm(b"")._precompile(addr, data)
    if addr == 8 and case == 7:
        assert got == (True, (1).to_bytes(32, "big"))


def test_evm_interpreter_matches_reference():
    # PUSH/ADD/RETURN and MULMOD
    for code in (bytes([0x60, 3, 0x60, 4, 0x01, 0x5F, 0x52, 0x60, 0x20, 0x5F, 0xF3]),
                 bytes([0x60, 7, 0x60, 5, 0x60, 6, 0x09, 0x5F, 0x52, 0x60, 0x20, 0x5F, 0xF3])):
        assert evm.Evm(code).run() == ref_evm.Evm(code).run()


def test_generated_verifier_equals_reference(small):
    code = vc.generate_verifier(small["pk"].vk)
    assert code == ref_vc.generate_verifier(small["ref_pk"].vk)
    assert vc.calldata_for(small["proof"], small["public"]) == \
        ref_vc.calldata_for(small["ref_proof"], small["public"])
    assert vc.evm_verify(small["pk"].vk, small["proof"], small["public"])
    assert ref_vc.evm_verify(small["ref_pk"].vk,
                             ref_plonk.PlonkProof.from_bytes(small["proof"].to_bytes()),
                             small["public"])


# ---------------------------------------------------------------------------
# the wrapper: keys, one EvmProof, its verification
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def app_vk():
    """The fibonacci app's vk, so that the host verifier can take the proof."""
    from zkvm_prover_tpu_torch.host.app import get_app

    return get_app("fibonacci").vk_bytes()


@pytest.fixture(scope="module")
def keys():
    """The reference's default wrapper keys and the port's, converted."""
    ref_keys = ref_wrapper.wrapper_keys()
    return ref_keys, convert.wrapper_keys_from_reference(ref_keys)


@pytest.fixture(scope="module")
def wrapped(keys, app_vk):
    """One wrap_stark_proof of seeded bytes in each package."""
    ref_keys, port_keys = keys
    rng = np.random.default_rng(13)
    proof_bytes, pi = rng.bytes(4000), rng.bytes(32)
    ref_ep = ref_wrapper.wrap_stark_proof(app_vk, proof_bytes, pi, ref_keys)
    ep = wrapper.wrap_stark_proof(app_vk, proof_bytes, pi, port_keys, device=CPU)
    return ref_ep, ep, pi


def test_wrapper_keys_equal_reference(keys):
    ref_keys, port_keys = keys
    assert port_keys.vk.digest() == ref_keys.vk.digest()
    assert (port_keys.vk.log_n, port_keys.vk.n_public) == (12, wrapper.N_INSTANCES)
    # the port's own setup of the wrapper circuit, on the reference's SRS
    cb = wrapper.build_wrapper_circuit([0] * wrapper.N_ACC, 0, 0, b"\x00" * 32,
                                       b"\x00" * wrapper.N_PI)
    pk = plonk.setup(cb, port_keys.srs, CPU)
    assert pk.vk.digest() == ref_keys.vk.digest()
    assert pk.sigma_maps == ref_keys.pk.sigma_maps


def test_wrapper_verifier_bytecode_equals_reference(keys):
    ref_keys, port_keys = keys
    assert vc.generate_verifier(port_keys.vk) == ref_vc.generate_verifier(ref_keys.vk)


def test_evm_proof_equals_reference(wrapped):
    ref_ep, ep, pi = wrapped
    assert ep.proof == ref_ep.proof
    assert ep.instances == ref_ep.instances
    assert ep.public_values() == list(pi) == ref_ep.public_values()
    assert len(ep.instances) == wrapper.N_INSTANCES * 32


def test_evm_proof_cross_verifies(keys, wrapped, app_vk):
    ref_keys, port_keys = keys
    ref_ep, ep, _ = wrapped
    assert wrapper.verify_evm_proof(app_vk, convert.evm_proof_from_reference(ref_ep),
                                    port_keys, device=CPU)
    assert ref_wrapper.verify_evm_proof(app_vk, RefEvmProof(ep.proof, ep.instances), ref_keys)


def _flip(raw: bytes, at: int) -> bytes:
    return raw[:at] + bytes([raw[at] ^ 1]) + raw[at + 1:]


@pytest.mark.parametrize("how", ["instance byte", "accumulator limb", "blob byte", "app vk"])
def test_tampered_evm_proof_rejected_by_both(keys, wrapped, app_vk, how):
    ref_keys, port_keys = keys
    _, ep, _ = wrapped
    vk = app_vk
    proof, instances = ep.proof, ep.instances
    if how == "instance byte":
        instances = _flip(instances, (wrapper.N_ACC + wrapper.N_DIGEST) * 32 + 31)
    elif how == "accumulator limb":
        instances = _flip(instances, 31)
    elif how == "blob byte":
        proof = _flip(proof, 100)
    else:
        vk = bytes(64)
    bad = type(ep)(proof=proof, instances=instances)
    assert not wrapper.verify_evm_proof(vk, bad, port_keys, device=CPU)
    assert not ref_wrapper.verify_evm_proof(vk, RefEvmProof(proof, instances), ref_keys)


def test_universal_verifier_checks_evm_proofs(keys, wrapped, monkeypatch):
    """`UniversalVerifier.verify_evm_proof` on the CPU, with the app's own
    vk (the converted keys stand in for the default ones)."""
    from zkvm_prover_tpu_torch.host import UniversalVerifier
    from zkvm_prover_tpu_torch.stark.config import fast_test_config

    monkeypatch.setitem(wrapper._KEYS_CACHE, (None, CPU), keys[1])
    ep = wrapped[1]
    assert UniversalVerifier("fibonacci", fast_test_config(), device=CPU).verify_evm_proof(ep)
    assert not UniversalVerifier("fib-double", fast_test_config(),
                                 device=CPU).verify_evm_proof(ep)


def test_point_limbs_round_trip():
    p = bn.g1_mul(bn.G1_GEN, 0x123456789ABCDEF)
    limbs = wrapper.point_limbs(p)
    assert limbs == ref_wrapper.point_limbs(p)
    assert all(0 <= v < (1 << wrapper.LIMB_BITS) for v in limbs)
    assert wrapper.limbs_to_point(limbs) == p


# ---------------------------------------------------------------------------
# the whole host path (slow: a fibonacci STARK and a wrap in each package)
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_gen_proof_snark_equals_reference(keys, monkeypatch):
    from zkvm_prover_tpu.host.prover import Prover as RefProver
    from zkvm_prover_tpu.host.prover import ProverConfig as RefConfig
    from zkvm_prover_tpu.host.task import ProvingTask as RefTask
    from zkvm_prover_tpu.host.verifier import UniversalVerifier as RefVerifier
    from zkvm_prover_tpu.stark.config import StarkConfig as RefStark
    from zkvm_prover_tpu.stark.fri import FriConfig as RefFri
    from zkvm_prover_tpu_torch.host import Prover, ProverConfig, ProvingTask, UniversalVerifier
    from zkvm_prover_tpu_torch.stark.config import StarkConfig
    from zkvm_prover_tpu_torch.stark.fri import FriConfig

    ref_keys, port_keys = keys
    monkeypatch.setitem(wrapper._KEYS_CACHE, (None, CPU), port_keys)
    monkeypatch.setattr(ref_wrapper, "_KEYS_CACHE", ref_keys)
    witness = [json.dumps({"log_n": 4}).encode()]
    ref_stark = RefStark(fri=RefFri(log_blowup=1, num_queries=2, proof_of_work_bits=2))
    stark = StarkConfig(fri=FriConfig(log_blowup=1, num_queries=2, proof_of_work_bits=2))
    ref_ep = RefProver.setup(RefConfig(app_name="fibonacci", stark=ref_stark)) \
        .gen_proof_universal(RefTask(serialized_witness=witness), with_snark=True)
    ep = Prover.setup(ProverConfig(app_name="fibonacci", stark=stark, device=CPU)) \
        .gen_proof_universal(ProvingTask(serialized_witness=witness), with_snark=True)
    assert (ep.proof, ep.instances) == (ref_ep.proof, ref_ep.instances)
    assert UniversalVerifier("fibonacci", stark, device=CPU).verify_evm_proof(ep)
    assert RefVerifier("fibonacci", ref_stark).verify_evm_proof(ref_ep)
