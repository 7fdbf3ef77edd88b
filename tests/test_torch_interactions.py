"""The port's logUp argument, TraceBuilder and multi-height FRI against the
JAX package, on the CPU.

Inputs are made from a seed with numpy and go through both packages; every
comparison is exact (the arithmetic is mod p, so the tolerance is 0). The
reference runs its numpy host path, which is bit-identical to its jitted
path and needs no XLA compile."""

import numpy as np
import pytest
import torch

from zkvm_prover_tpu.models.air import Interaction as RefInteraction
from zkvm_prover_tpu.models.air import TraceBuilder as RefTraceBuilder
from zkvm_prover_tpu.models.poseidon2_air import Poseidon2Air as RefPoseidon2Air
from zkvm_prover_tpu.ops import ntt as ref_ntt
from zkvm_prover_tpu.stark import fri as ref_fri
from zkvm_prover_tpu.stark import interactions as ref_ilib
from zkvm_prover_tpu.stark.challenger import Challenger as RefChallenger
from zkvm_prover_tpu.stark.config import FriConfig as RefFriConfig
from zkvm_prover_tpu_torch.convert import fri_proof_from_numpy
from zkvm_prover_tpu_torch.fields import babybear as bb
from zkvm_prover_tpu_torch.models.air import Interaction, TraceBuilder
from zkvm_prover_tpu_torch.models.poseidon2_air import Poseidon2Air
from zkvm_prover_tpu_torch.stark import fri
from zkvm_prover_tpu_torch.stark import interactions as ilib
from zkvm_prover_tpu_torch.stark.challenger import Challenger
from zkvm_prover_tpu_torch.stark.config import FriConfig
from zkvm_prover_tpu_torch.utils import ext_np

from test_torch_stark import assert_proofs_equal

P = bb.P


def _rand(rng, *shape):
    return rng.integers(0, P, size=shape, dtype=np.uint64).astype(np.uint32)


def _t(a):
    return bb.as_tensor(a, "cpu")


def _canon(a):
    """Montgomery numpy values -> canonical python-int lists."""
    return ext_np.from_monty(np.asarray(a))


def _interaction_pairs(rng, n, point_mode=False):
    """Matching (reference, port) interactions: vector fields, a constant
    field and a constant or vector multiplicity, sends and receives."""
    specs = [(3, 2, "vec", True), (7, 3, "const", False), (29, 1, "vec", False)]
    ref, mine = [], []
    for bus, n_fields, mult_kind, is_send in specs:
        r_fields, m_fields = [], []
        for f in range(n_fields):
            if f == 1:  # a builder constant
                c = bb.to_monty_int(int(rng.integers(0, 100)))
                if point_mode:
                    r_fields.append(np.array([c, 0, 0, 0], dtype=np.uint32))
                    m_fields.append(_canon(r_fields[-1]))
                else:
                    r_fields.append(np.uint32(c))
                    m_fields.append(c)
            else:
                v = _rand(rng, 4) if point_mode else _rand(rng, n)
                r_fields.append(v)
                m_fields.append(_canon(v) if point_mode else _t(v))
        if point_mode:
            r_mult = _rand(rng, 4)
            m_mult = _canon(r_mult)
        elif mult_kind == "const":
            r_mult = np.uint32(bb.to_monty_int(1))
            m_mult = bb.to_monty_int(1)
        else:
            r_mult = bb.to_monty_np(rng.integers(0, 5, size=n).astype(np.uint64))
            m_mult = _t(r_mult)
        ref.append(RefInteraction(bus, r_fields, r_mult, is_send))
        mine.append(Interaction(bus, m_fields, m_mult, is_send))
    return ref, mine


@pytest.mark.parametrize("point_mode", [False, True])
def test_fingerprint_and_signed_mult_match_reference(point_mode):
    rng = np.random.default_rng(21)
    n = 64
    ref, mine = _interaction_pairs(rng, n, point_mode)
    z, beta = _rand(rng, 4), _rand(rng, 4)
    for r, m in zip(ref, mine):
        want = ref_ilib.fingerprint(r, z, beta, point_mode)
        want_sm = np.broadcast_to(np.asarray(ref_ilib.signed_mult(r, point_mode)),
                                  (4,) if point_mode else (n, 4))
        if point_mode:
            got = ilib.fingerprint(m, _canon(beta), True)
            assert got == _canon(want)
            assert ilib.signed_mult(m, True) == _canon(want_sm)
        else:
            got = ilib.fingerprint(m, _t(beta))
            np.testing.assert_array_equal(bb.to_numpy(got), want)
            sm = ilib.signed_mult(m)
            sm = bb.to_numpy(sm) if isinstance(sm, torch.Tensor) else np.full(n, sm)
            np.testing.assert_array_equal(np.broadcast_to(sm, (n,)), want_sm[:, 0])
            assert not want_sm[:, 1:].any()


def test_build_perm_trace_matches_reference():
    rng = np.random.default_rng(22)
    n = 128
    ref, mine = _interaction_pairs(rng, n)
    z, beta = _rand(rng, 4), _rand(rng, 4)
    want_perm, want_sum = ref_ilib.build_perm_trace(ref, z, beta)
    perm, claimed = ilib.build_perm_trace(mine, _t(z), _t(beta))
    assert perm.shape == (n, 4 * len(mine) + 4)
    np.testing.assert_array_equal(bb.to_numpy(perm), np.asarray(want_perm))
    np.testing.assert_array_equal(bb.to_numpy(claimed), np.asarray(want_sum))


def test_perm_constraints_lde_mode_match_reference():
    rng = np.random.default_rng(23)
    m = 64
    ref, mine = _interaction_pairs(rng, m)
    k = len(mine)
    z, beta, claimed = _rand(rng, 4), _rand(rng, 4), _rand(rng, 4)
    local = [_rand(rng, m, 4) for _ in range(k + 1)]
    nxt = [_rand(rng, m, 4) for _ in range(k + 1)]
    sels = {key: _rand(rng, m) for key in ("first", "last", "transition")}
    want = ref_ilib.perm_constraints(ref, local, nxt, sels, z, beta, claimed)
    got = ilib.perm_constraints(mine, [_t(a) for a in local], [_t(a) for a in nxt],
                                {key: _t(v) for key, v in sels.items()},
                                _t(z), _t(beta), _t(claimed))
    assert len(got) == len(want) == k + 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(bb.to_numpy(g), np.asarray(w))


def test_perm_constraints_point_mode_match_reference():
    rng = np.random.default_rng(24)
    ref, mine = _interaction_pairs(rng, 1, point_mode=True)
    k = len(mine)
    z, beta, claimed = _rand(rng, 4), _rand(rng, 4), _rand(rng, 4)
    local = [_rand(rng, 4) for _ in range(k + 1)]
    nxt = [_rand(rng, 4) for _ in range(k + 1)]
    sels = {key: _rand(rng, 4) for key in ("first", "last", "transition")}
    want = ref_ilib.perm_constraints(ref, local, nxt, sels, z, beta, claimed,
                                     point_mode=True)
    got = ilib.perm_constraints(mine, [_canon(a) for a in local],
                                [_canon(a) for a in nxt],
                                {key: _canon(v) for key, v in sels.items()},
                                _canon(z), _canon(beta), _canon(claimed),
                                point_mode=True)
    assert got == [_canon(w) for w in want]


def test_trace_builder_poseidon2_interactions_match_reference():
    rng = np.random.default_rng(25)
    n = 8
    inputs = _rand(rng, n, 16)
    mults = rng.integers(0, 3, size=n).astype(np.uint32)
    trace = Poseidon2Air.generate_trace(inputs, mults)
    trace_m = bb.to_monty_np(trace.astype(np.uint64))
    ref_b = RefTraceBuilder(trace_m, np.zeros(0, np.uint32))
    RefPoseidon2Air().eval(ref_b)
    mine = TraceBuilder(_t(trace_m), [])
    Poseidon2Air().eval(mine)
    assert mine.constraints == [] and len(ref_b.constraints) > 400
    assert len(mine.interactions) == len(ref_b.interactions) == 2
    for g, w in zip(mine.interactions, ref_b.interactions):
        assert (g.bus, g.is_send, len(g.fields)) == (w.bus, w.is_send, len(w.fields))
        for gf, wf in zip(g.fields + [g.mult], w.fields + [w.mult]):
            np.testing.assert_array_equal(bb.to_numpy(gf), np.asarray(wf))
    # the verifier's structure pass: a 2-row zero trace
    zero = TraceBuilder(torch.zeros((2, Poseidon2Air.width), dtype=bb.DTYPE), [])
    Poseidon2Air().eval(zero)
    assert len(zero.interactions) == 2


def _low_degree_codeword(rng, log_m, shift):
    """An (m, 4) codeword of degree < m/2 on the coset shift * G_m."""
    evals = _rand(rng, 1 << (log_m - 1), 4)
    return np.asarray(ref_ntt.coset_lde(evals, 1, shift))


def _fri_setup():
    rng = np.random.default_rng(26)
    log_m, g = 7, 31
    cfg = RefFriConfig(log_blowup=1, num_queries=6, proof_of_work_bits=3)
    mine_cfg = FriConfig(log_blowup=1, num_queries=6, proof_of_work_bits=3)
    main = _low_degree_codeword(rng, log_m, g)
    injected = {lm: _low_degree_codeword(rng, lm, pow(g, 1 << (log_m - lm), P))
                for lm in (5, 3)}
    return log_m, g, cfg, mine_cfg, main, injected


def _seeded(challenger_cls):
    ch = challenger_cls()
    ch.observe_slice(np.arange(5, dtype=np.uint32))
    return ch


def _derived(cw):
    canon = bb.from_monty_np(cw)
    return lambda q: canon[q].astype(np.uint64)


def test_fri_injected_matches_reference_and_verifies():
    log_m, g, cfg, mine_cfg, main, injected = _fri_setup()
    want = ref_fri.prove(main, log_m, g, cfg, _seeded(RefChallenger), injected=injected)
    got = fri.prove(_t(main), log_m, g, mine_cfg, _seeded(Challenger),
                    injected={lm: _t(cw) for lm, cw in injected.items()})
    assert_proofs_equal(got, want)
    derived = {log_m: _derived(main), **{lm: _derived(cw) for lm, cw in injected.items()}}
    assert fri.verify(got, log_m, g, mine_cfg, _seeded(Challenger), derived)
    assert ref_fri.verify(got, log_m, g, cfg, _seeded(RefChallenger), derived)
    assert fri.verify(fri_proof_from_numpy(want), log_m, g, mine_cfg, _seeded(Challenger), derived)


@pytest.mark.parametrize("case", ["no_round0", "dropped_injection", "wrong_injection",
                                  "callable_only"])
def test_fri_dict_verify_rejects(case):
    log_m, g, cfg, mine_cfg, main, injected = _fri_setup()
    proof = fri.prove(_t(main), log_m, g, mine_cfg, _seeded(Challenger),
                      injected={lm: _t(cw) for lm, cw in injected.items()})
    derived = {log_m: _derived(main), **{lm: _derived(cw) for lm, cw in injected.items()}}
    if case == "no_round0":
        del derived[log_m]
    elif case == "dropped_injection":
        del derived[3]
    elif case == "wrong_injection":
        bad = injected[5].copy()
        bad[:, 0] = bb.to_monty_np((bb.from_monty_np(bad[:, 0]).astype(np.uint64) + 1) % P)
        derived[5] = _derived(bad)
    else:
        derived = derived[log_m]
    assert fri.verify(proof, log_m, g, mine_cfg, _seeded(Challenger), derived) is False
