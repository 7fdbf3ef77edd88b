"""The port's multi-AIR machine prover and verifier against the JAX package.

The port proves on `device="cpu"` at `fast_test_config`. For every case of
the reference's `tests/test_machine.py` and `tests/test_interactions.py`,
and for an AIR with a preprocessed column defined here, its `MachineProof`
must equal the reference's in every field but `stat`, exactly; each
package's verifier must accept the other's valid proofs and reject the
invalid ones; tampered and malformed proofs give False. Each case's pair
of proofs is built once per module."""

import copy

import numpy as np
import pytest
import torch

from zkvm_prover_tpu.models.air import Air as RefAir
from zkvm_prover_tpu.models.doubling import DoublingAir as RefDoublingAir
from zkvm_prover_tpu.models.fibonacci import FibonacciAir as RefFibonacciAir
from zkvm_prover_tpu.models.lookup import RangeCheckedAir as RefRangeCheckedAir
from zkvm_prover_tpu.models.lookup import RangeTableAir as RefRangeTableAir
from zkvm_prover_tpu.stark import machine as ref_machine
from zkvm_prover_tpu.stark.config import fast_test_config as ref_fast_config
from zkvm_prover_tpu_torch.convert import machine_proof_from_numpy
from zkvm_prover_tpu_torch.fields import babybear as bb
from zkvm_prover_tpu_torch.models.air import Air
from zkvm_prover_tpu_torch.models.doubling import DoublingAir
from zkvm_prover_tpu_torch.models.fibonacci import FibonacciAir
from zkvm_prover_tpu_torch.models.lookup import RangeCheckedAir, RangeTableAir
from zkvm_prover_tpu_torch.stark import machine
from zkvm_prover_tpu_torch.stark.config import fast_test_config

from test_torch_stark import assert_proofs_equal

P = bb.P
PRE_LOG_N = 3


def _pre_column(n):
    return ((np.arange(n, dtype=np.uint64) ** 2 + 1) % P).astype(np.uint32).reshape(n, 1)


def _pre_eval(b):
    """c = 2 * pre on every row, and c' - c = 2 * (pre' - pre)."""
    c, pre = b.local(0), b.preprocessed(0)
    b.assert_eq(c, b.add(pre, pre))
    d_pre = b.sub(b.preprocessed_next(0), pre)
    b.when_transition().assert_eq(b.sub(b.next(0), c), b.add(d_pre, d_pre))


class PreAir(Air):
    width = 1

    def preprocessed_trace(self):
        return _pre_column(1 << PRE_LOG_N)

    def eval(self, b):
        _pre_eval(b)


class RefPreAir(RefAir):
    width = 1

    def preprocessed_trace(self):
        return _pre_column(1 << PRE_LOG_N)

    def eval(self, b):
        _pre_eval(b)


def _pre_trace():
    return (2 * _pre_column(1 << PRE_LOG_N).astype(np.uint64) % P).astype(np.uint32)


def _lookup(valid=True, tamper_mult=False, log_table=3, log_user=4, seed=9):
    """The reference test's range-check pair: (table, user) instances."""
    rng = np.random.default_rng(seed)
    n_table = 1 << log_table
    values = rng.integers(0, n_table, size=1 << log_user)
    if not valid:
        values = values.copy()
        values[3] = n_table + 5  # not in the table
    t_user = RefRangeCheckedAir().generate_trace(values % (1 << 31))
    t_table = RefRangeTableAir().generate_trace(
        log_table, values[values < n_table] if not valid else values)
    if tamper_mult:
        t_table = t_table.copy()
        t_table[0, 1] = (int(t_table[0, 1]) + 1) % P
    return [("table", t_table, []), ("user", t_user, [])]


def _fib(log_n):
    t, pvs = RefFibonacciAir().generate_trace(log_n)
    return ("fib", t, pvs)


def _dbl(log_n, bad_row=None):
    t, pvs = RefDoublingAir().generate_trace(log_n)
    if bad_row is not None:
        t = t.copy()
        t[bad_row, 0] = (int(t[bad_row, 0]) + 5) % P
    return ("dbl", t, pvs)


AIRS = {  # name -> (reference AIR, port AIR)
    "fib": (RefFibonacciAir, FibonacciAir),
    "dbl": (RefDoublingAir, DoublingAir),
    "table": (RefRangeTableAir, RangeTableAir),
    "user": (RefRangeCheckedAir, RangeCheckedAir),
    "pre": (RefPreAir, PreAir),
}

# case -> (instances, whether the statement is true)
CASES = {
    "fib4_dbl3": (lambda: [_fib(4), _dbl(3)], True),
    "fib3_dbl3": (lambda: [_fib(3), _dbl(3)], True),
    "invalid_second_trace": (lambda: [_fib(4), _dbl(3, bad_row=4)], False),
    "lookup": (lambda: _lookup(), True),
    "lookup_out_of_range": (lambda: _lookup(valid=False), False),
    "lookup_tampered_mult": (lambda: _lookup(tamper_mult=True), False),
    "fib_alone": (lambda: [_fib(4)], True),
    "lookup_and_fib": (lambda: _lookup() + [_fib(5)], True),
    "preprocessed": (lambda: [("pre", _pre_trace(), []), _fib(4)] + _lookup(), True),
}


@pytest.fixture(scope="module")
def proofs():
    """case -> (reference AIRs, port AIRs, reference proof, port proof)."""
    out = {}
    for case, (make, _) in CASES.items():
        insts = make()
        ref_airs = [AIRS[name][0]() for name, _, _ in insts]
        airs = [AIRS[name][1]() for name, _, _ in insts]
        ref_proof = ref_machine.prove_machine(
            [ref_machine.AirInstance(a, t, pv) for a, (_, t, pv) in zip(ref_airs, insts)],
            ref_fast_config())
        proof = machine.prove_machine(
            [machine.AirInstance(a, t, pv) for a, (_, t, pv) in zip(airs, insts)],
            fast_test_config(), device="cpu")
        out[case] = (ref_airs, airs, ref_proof, proof)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_machine_proof_equals_reference(proofs, case):
    _, _, ref_proof, proof = proofs[case]
    assert_proofs_equal(proof, ref_proof)
    assert_proofs_equal(machine_proof_from_numpy(ref_proof), proof)
    assert proof.stat["n_airs"] == len(proof.meta)
    assert proof.stat["constraints_ms"] >= 0 and proof.stat["fri_fold_ms"] >= 0


@pytest.mark.parametrize("case", list(CASES))
def test_each_verifier_checks_the_other(proofs, case):
    ref_airs, airs, ref_proof, proof = proofs[case]
    valid = CASES[case][1]
    cfg, ref_cfg = fast_test_config(), ref_fast_config()
    assert machine.verify_machine(airs, proof, cfg, device="cpu") is valid
    assert machine.verify_machine(airs, machine_proof_from_numpy(ref_proof), cfg,
                                  device="cpu") is valid
    assert ref_machine.verify_machine(ref_airs, proof, ref_cfg) is valid


def test_shapes_of_interaction_and_preprocessed_proofs(proofs):
    _, _, _, proof = proofs["preprocessed"]
    assert [c is None for c in proof.claimed_sums] == [True, True, False, False]
    assert sorted(proof.pre_roots) == [PRE_LOG_N + 1]
    assert proof.opened[0].pre_zeta.shape == (1, 4)
    assert proof.opened[2].perm_zeta.shape == (8, 4)
    assert sorted(proof.perm_roots) == [4, 5]


def _first_query(proof, height=None):
    lm = max(proof.query_openings) if height is None else height
    return next(iter(proof.query_openings[lm].values()))


def _big(arr, value):
    """arr as an object array whose first entry is `value` (any python int)."""
    out = np.asarray(arr).astype(object)
    out.reshape(-1)[0] = value
    return out


def _tampered(proof, what):
    bad = copy.deepcopy(proof)
    if what == "public_value":
        log_n, w, pvs = bad.meta[1]
        bad.meta[1] = (log_n, w, [pvs[0], (pvs[1] + 1) % P])
    elif what == "trace_opening":
        bad.opened[0].trace_zeta[0, 0] ^= 1
    elif what == "perm_opening":
        bad.opened[0].perm_zeta[2, 1] ^= 1
    elif what == "claimed_sum":
        bad.claimed_sums[0] = bad.claimed_sums[0].copy()
        bad.claimed_sums[0][0] = (int(bad.claimed_sums[0][0]) + 1) % P
    elif what == "index_2_64":  # key and indices agree, so the cast is reached
        by_pos = bad.query_openings[max(bad.query_openings)]
        qo = by_pos.pop(next(iter(by_pos)))
        for op in (qo.trace, qo.quotient, qo.perm, qo.pre):
            if op is not None:
                op.index = 2 ** 64
        by_pos[2 ** 64] = qo
    elif what == "query_key_2_64":
        by_pos = bad.query_openings[max(bad.query_openings)]
        by_pos[2 ** 64] = by_pos.pop(next(iter(by_pos)))
    elif what == "row_2_70":
        qo = _first_query(bad)
        qo.trace.rows[0] = _big(qo.trace.rows[0], 2 ** 70)
    elif what == "root_2_70":
        lm = max(bad.trace_roots)
        bad.trace_roots[lm] = _big(bad.trace_roots[lm], 2 ** 70)
    elif what == "fri_commitment_2_70":
        bad.fri_proof.commitments[0] = _big(bad.fri_proof.commitments[0], 2 ** 70)
    elif what == "final_poly_2_70":
        bad.fri_proof.final_poly = _big(bad.fri_proof.final_poly, 2 ** 70)
    elif what == "ood_2_70":
        bad.opened[0].trace_zeta = _big(bad.opened[0].trace_zeta, 2 ** 70)
    elif what == "row_plus_2_32":
        qo = _first_query(bad)
        row = qo.trace.rows[0].astype(np.uint64)
        row[0] += 2 ** 32
        qo.trace.rows[0] = row
    return bad


SEMANTIC = ["public_value", "trace_opening", "perm_opening", "claimed_sum"]
OUT_OF_RANGE = ["index_2_64", "query_key_2_64", "row_2_70", "root_2_70",
                "fri_commitment_2_70", "final_poly_2_70", "ood_2_70", "row_plus_2_32"]


@pytest.mark.parametrize("what", SEMANTIC)
def test_tampered_machine_proofs_rejected_by_both(proofs, what):
    # lookup_and_fib: the table and user carry interactions, fib public values
    ref_airs, airs, ref_proof, proof = proofs["lookup_and_fib"]
    if what == "public_value":
        ref_airs, airs, ref_proof, proof = proofs["fib4_dbl3"]
    assert machine.verify_machine(airs, _tampered(proof, what), fast_test_config(),
                                  device="cpu") is False
    assert not ref_machine.verify_machine(ref_airs, _tampered(ref_proof, what),
                                          ref_fast_config())


@pytest.mark.parametrize("what", OUT_OF_RANGE)
def test_malformed_machine_proof_returns_false(proofs, what):
    _, airs, _, proof = proofs["lookup_and_fib"]
    assert machine.verify_machine(airs, _tampered(proof, what), fast_test_config(),
                                  device="cpu") is False


def test_prove_machine_without_device_needs_a_card(monkeypatch):
    """device=None means the card; with none it raises, never falls back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    t, pvs = FibonacciAir().generate_trace(3)
    with pytest.raises(RuntimeError):
        machine.prove_machine([machine.AirInstance(FibonacciAir(), t, pvs)],
                              fast_test_config())
