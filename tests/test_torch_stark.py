"""The port's single-AIR prover and verifier against the JAX package.

The port proves on `device="cpu"` (plain torch versions of the kernels).
Its FibonacciAir proof must equal the JAX proof in every field except the
timing field `stat`, exactly; each package's verifier must accept the
other's proof and reject tampered ones. The JAX proof is built once per
module (it is compile-dominated, about 50 s on the CPU)."""

import copy

import jax.numpy as jnp  # noqa: F401  (keeps jax initialised on the CPU)
import numpy as np
import pytest
import torch

from zkvm_prover_tpu.models.air import LdeBuilder as RefLdeBuilder
from zkvm_prover_tpu.models.fibonacci import FibonacciAir as RefFibonacciAir
from zkvm_prover_tpu.models.poseidon2_air import Poseidon2Air as RefPoseidon2Air
from zkvm_prover_tpu.stark import domain as ref_domain
from zkvm_prover_tpu.stark import prover as ref_prover
from zkvm_prover_tpu.stark import verifier as ref_verifier
from zkvm_prover_tpu.stark.config import fast_test_config as ref_fast_config
from zkvm_prover_tpu_torch.convert import proof_from_numpy
from zkvm_prover_tpu_torch.fields import babybear as bb
from zkvm_prover_tpu_torch.models.air import LdeBuilder
from zkvm_prover_tpu_torch.models.fibonacci import FibonacciAir
from zkvm_prover_tpu_torch.models.poseidon2_air import Poseidon2Air
from zkvm_prover_tpu_torch.stark import domain, prover, verifier
from zkvm_prover_tpu_torch.stark.config import fast_test_config

LOG_N = 5


def assert_proofs_equal(a, b, path="proof"):
    """Exact, field by field; `stat` (timings) excepted."""
    if hasattr(a, "__dataclass_fields__"):
        assert set(a.__dataclass_fields__) == set(b.__dataclass_fields__), path
        for f in a.__dataclass_fields__:
            if f != "stat":
                assert_proofs_equal(getattr(a, f), getattr(b, f), f"{path}.{f}")
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for key in a:
            assert_proofs_equal(a[key], b[key], f"{path}[{key}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_proofs_equal(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        x, y = np.asarray(a), np.asarray(b)
        assert x.shape == y.shape and x.dtype == y.dtype, path
        np.testing.assert_array_equal(x, y, err_msg=path)
    else:
        assert a == b, path


@pytest.fixture(scope="module")
def fib():
    air = FibonacciAir()
    trace, pvs = air.generate_trace(LOG_N)
    ref_proof = ref_prover.prove(RefFibonacciAir(), trace, pvs, ref_fast_config())
    proof = prover.prove(air, trace, pvs, fast_test_config(), device="cpu")
    return air, ref_proof, proof


def test_fibonacci_proof_equals_reference(fib):
    _, ref_proof, proof = fib
    assert_proofs_equal(proof, ref_proof)


def test_port_verifies_reference_proof(fib):
    air, ref_proof, _ = fib
    assert verifier.verify(air, proof_from_numpy(ref_proof), fast_test_config())


def test_reference_verifies_port_proof(fib):
    _, _, proof = fib
    assert ref_verifier.verify(RefFibonacciAir(), proof, ref_fast_config())


def test_proof_from_numpy_round_trip(fib):
    _, ref_proof, proof = fib
    assert_proofs_equal(proof_from_numpy(ref_proof), proof)


def _tampered(proof, what):
    bad = copy.deepcopy(proof)
    if what == "public_value":
        bad.public_values[2] = (bad.public_values[2] + 1) % bb.P
    elif what == "ood_opening":
        bad.opened_trace_zeta[0, 1] ^= 1
    elif what == "quotient_opening":
        bad.opened_quotient[1, 2, 3] ^= 1
    elif what == "trace_root":
        bad.trace_root[0] ^= 1
    elif what == "query_row":
        qo = next(iter(bad.query_openings.values()))
        qo.trace.rows[0][0] ^= 1
    elif what == "fri_root":
        bad.fri_proof.commitments[0][3] ^= 1
    elif what == "pow_witness":
        bad.fri_proof.pow_witness += 1
    elif what == "ragged_row":
        qo = next(iter(bad.query_openings.values()))
        qo.trace.rows[0] = qo.trace.rows[0][:1]
    elif what == "ragged_fri_row":
        op = bad.fri_proof.rounds[0].openings[0][0]
        op.rows[0] = op.rows[0][:3]
    elif what == "index_2_64":  # key and indices agree, so the cast is reached
        qo = bad.query_openings.pop(next(iter(bad.query_openings)))
        qo.index = qo.trace.index = qo.quotient.index = 2 ** 64
        bad.query_openings[2 ** 64] = qo
    elif what == "query_key_2_64":
        bad.query_openings[2 ** 64] = bad.query_openings.pop(next(iter(bad.query_openings)))
    elif what == "row_2_70":
        qo = next(iter(bad.query_openings.values()))
        qo.trace.rows[0] = _big(qo.trace.rows[0], 2 ** 70)
    elif what == "fri_row_2_70":
        op = bad.fri_proof.rounds[0].openings[0][0]
        op.rows[0] = _big(op.rows[0], 2 ** 70)
    elif what == "root_2_70":
        bad.trace_root = _big(bad.trace_root, 2 ** 70)
    elif what == "fri_commitment_2_70":
        bad.fri_proof.commitments[0] = _big(bad.fri_proof.commitments[0], 2 ** 70)
    elif what == "final_poly_2_70":
        bad.fri_proof.final_poly = _big(bad.fri_proof.final_poly, 2 ** 70)
    elif what == "ood_2_70":
        bad.opened_trace_zeta = _big(bad.opened_trace_zeta, 2 ** 70)
    elif what == "row_plus_2_32":
        qo = next(iter(bad.query_openings.values()))
        row = qo.trace.rows[0].astype(np.uint64)
        row[0] += 2 ** 32
        qo.trace.rows[0] = row
    return bad


def _big(arr, value):
    """arr as an object array whose first entry is `value` (any python int)."""
    out = np.asarray(arr).astype(object)
    out.reshape(-1)[0] = value
    return out


TAMPER = ["public_value", "ood_opening", "quotient_opening", "trace_root",
          "query_row", "fri_root", "pow_witness", "ragged_row", "ragged_fri_row",
          # out-of-range integers: False, not OverflowError; v + 2^32 must not
          # alias v through a uint32 cast
          "index_2_64", "query_key_2_64", "row_2_70", "fri_row_2_70", "root_2_70",
          "fri_commitment_2_70", "final_poly_2_70", "ood_2_70", "row_plus_2_32"]


@pytest.mark.parametrize("what", TAMPER)
def test_port_rejects_tampered(fib, what):
    air, _, proof = fib
    assert verifier.verify(air, _tampered(proof, what), fast_test_config()) is False


def test_prove_without_device_needs_a_card(monkeypatch):
    """device=None means the card; with none it raises, never falls back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    air = FibonacciAir()
    trace, pvs = air.generate_trace(3)
    with pytest.raises(RuntimeError):
        prover.prove(air, trace, pvs, fast_test_config())


def test_selectors_match_reference():
    log_n, log_blowup, shift = 4, 1, 31
    ref = ref_domain.selectors_on_coset(log_n, log_blowup, shift)
    mine = domain.selectors_on_coset(log_n, log_blowup, shift, "cpu")
    for key in ("first", "last", "transition", "inv_zh", "x"):
        np.testing.assert_array_equal(bb.to_numpy(mine[key]), ref[key])


def test_poseidon2_constraints_match_reference():
    """Every Poseidon2Air constraint column from the port's LdeBuilder equals
    the reference LdeBuilder's on the same (numpy) inputs."""
    rng = np.random.default_rng(5)
    m, blowup = 32, 2
    lde = rng.integers(0, bb.P, size=(m, Poseidon2Air.width),
                       dtype=np.uint64).astype(np.uint32)
    sels = ref_domain.selectors_on_coset(4, 1, 31)
    ref_b = RefLdeBuilder(lde, blowup, sels, np.zeros(0, np.uint32))
    RefPoseidon2Air().eval(ref_b)
    mine = LdeBuilder(bb.as_tensor(lde, "cpu"), blowup,
                      {k: bb.as_tensor(v, "cpu") for k, v in sels.items()}, [])
    Poseidon2Air().eval(mine)
    assert len(mine.constraints) == len(ref_b.constraints) > 400
    for got, want in zip(mine.constraints, ref_b.constraints):
        np.testing.assert_array_equal(bb.to_numpy(got), np.asarray(want))


def test_poseidon2_trace_matches_reference():
    rng = np.random.default_rng(6)
    inputs = rng.integers(0, bb.P, size=(5, 16), dtype=np.uint64).astype(np.uint32)
    mults = np.ones(5, dtype=np.uint32)
    np.testing.assert_array_equal(Poseidon2Air.generate_trace(inputs, mults),
                                  RefPoseidon2Air.generate_trace(inputs, mults))


def _poseidon2_trace(n, seed):
    rng = np.random.default_rng(seed)
    inputs = rng.integers(0, bb.P, size=(n, 16), dtype=np.uint64).astype(np.uint32)
    return Poseidon2Air.generate_trace(inputs, np.ones(n, dtype=np.uint32))


def test_poseidon2_air_round_trip():
    air = Poseidon2Air()
    trace = _poseidon2_trace(16, 7)
    proof = prover.prove(air, trace, [], fast_test_config(), device="cpu")
    assert verifier.verify(air, proof, fast_test_config())
    bad = copy.deepcopy(proof)
    bad.opened_trace_zeta[100, 0] ^= 1
    assert not verifier.verify(air, bad, fast_test_config())


@pytest.mark.slow
def test_poseidon2_air_proof_equals_reference():
    trace = _poseidon2_trace(16, 8)
    ref_proof = ref_prover.prove(RefPoseidon2Air(), trace, [], ref_fast_config())
    proof = prover.prove(Poseidon2Air(), trace, [], fast_test_config(),
                         device="cpu")
    assert_proofs_equal(proof, ref_proof)


def test_deep_combine_matches_reference(monkeypatch):
    """The DEEP codeword (the two trace sums fused into one K3 call) equals
    the reference's `_deep_combine` on the same numpy inputs, m = 2^9, w = 33.
    The reference runs unjitted with numpy in place of jnp: its field code
    then takes its host path, bit-identical to the jitted one, with no XLA
    compile (about 25 s on the CPU)."""
    rng = np.random.default_rng(12)
    m, w = 1 << 9, 33

    def rand(*shape):
        return rng.integers(0, bb.P, size=shape, dtype=np.uint64).astype(np.uint32)

    args = (rand(m, w), rand(m, 8), rand(m), rand(4), rand(4), rand(w, 4),
            rand(w, 4), rand(8, 4), rand(4))
    monkeypatch.setattr(ref_prover, "jnp", np)
    want = ref_prover._deep_combine.__wrapped__(*args)
    assert isinstance(want, np.ndarray)
    trace_lde, chunk_lde, x = (bb.as_tensor(a, "cpu") for a in args[:3])
    got = prover._deep_combine(trace_lde, chunk_lde, x, *args[3:])
    np.testing.assert_array_equal(bb.to_numpy(got), want)
