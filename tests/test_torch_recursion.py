"""The port's in-circuit recursion (`zkvm_prover_tpu_torch/recursion/`,
`stark/debug.py`, the host's in-circuit branches) against the JAX package.

Every comparison is exact. The same inputs go through both packages: the
wire AIRs and the builder's gadgets (programs, traces, the debug checks),
the child shape, preprocessed roots, vk words and digests, the in-circuit
verifier's program and traces over Fibonacci and lookup children with the
dummy and the real oracle, a leaf node over two Fibonacci children at a
tiny FRI profile (2 queries, 2 PoW bits; the node's `MachineProof` equal in
every field but `stat`, each package's verifier accepting the other's),
and the fib-double envelope over an in-circuit Fibonacci child (byte-equal
but `stat`). The reference's aggregation cases (tampered children, a wrong
digest, forged child public values, the vk bindings) run through the port.
The port proves on `device="cpu"`; the reference proves on its host numpy
path. Under `slow`: an internal node over the leaf (about 80 s here) and
the wire program over chunk 0 of the chunk task generator (about 90 s of
reference time)."""

import copy
import json

import numpy as np
import pytest
import torch

from zkvm_prover_tpu.host import Prover as RefProver
from zkvm_prover_tpu.host import ProverConfig as RefProverConfig
from zkvm_prover_tpu.host import ProvingTask as RefProvingTask
from zkvm_prover_tpu.host import UniversalVerifier as RefVerifier
from zkvm_prover_tpu.host import serialization as ref_ser
from zkvm_prover_tpu.host.proof_types import ProofEnum as RefProofEnum
from zkvm_prover_tpu.models.fibonacci import FibonacciAir as RefFibonacciAir
from zkvm_prover_tpu.models.lookup import RangeCheckedAir as RefRangeCheckedAir
from zkvm_prover_tpu.models.lookup import RangeTableAir as RefRangeTableAir
from zkvm_prover_tpu.models.poseidon2_air import Poseidon2Air as RefPoseidon2Air
from zkvm_prover_tpu.recursion import CircuitBuilder as RefCircuitBuilder
from zkvm_prover_tpu.recursion import aggregation as ref_agg
from zkvm_prover_tpu.recursion import stark_verifier as ref_sv
from zkvm_prover_tpu.recursion import wire_air as ref_wire
from zkvm_prover_tpu.stark import debug as ref_debug
from zkvm_prover_tpu.stark import machine as ref_machine
from zkvm_prover_tpu.stark.config import StarkConfig as RefStarkConfig
from zkvm_prover_tpu.stark.config import fast_test_config as ref_fast_config
from zkvm_prover_tpu.stark.fri import FriConfig as RefFriConfig
from zkvm_prover_tpu_torch.fields import babybear as bb
from zkvm_prover_tpu_torch.host import Prover, ProverConfig, ProvingTask, UniversalVerifier
from zkvm_prover_tpu_torch.host import serialization as ser
from zkvm_prover_tpu_torch.host.proof_types import ProofEnum
from zkvm_prover_tpu_torch.models.fibonacci import FibonacciAir
from zkvm_prover_tpu_torch.models.lookup import RangeCheckedAir, RangeTableAir
from zkvm_prover_tpu_torch.models.poseidon2_air import Poseidon2Air, permute_canonical
from zkvm_prover_tpu_torch.ops import poseidon2 as p2
from zkvm_prover_tpu_torch.recursion import CircuitBuilder
from zkvm_prover_tpu_torch.recursion import aggregation as agg
from zkvm_prover_tpu_torch.recursion import stark_verifier as sv
from zkvm_prover_tpu_torch.recursion import wire_air
from zkvm_prover_tpu_torch.stark import debug, machine
from zkvm_prover_tpu_torch.stark.config import StarkConfig, fast_test_config
from zkvm_prover_tpu_torch.stark.fri import FriConfig

P = bb.P
TINY = StarkConfig(fri=FriConfig(log_blowup=1, num_queries=2, proof_of_work_bits=2))
REF_TINY = RefStarkConfig(fri=RefFriConfig(log_blowup=1, num_queries=2, proof_of_work_bits=2))


@pytest.fixture(autouse=True)
def reference_on_host(monkeypatch):
    """The reference's machine prover on its host numpy path (it sends
    matrices of 2^17 elements or more to JAX, which compiles for minutes)."""
    monkeypatch.setattr(ref_machine, "_DEVICE_MIN_ELEMS", 1 << 62)


@pytest.fixture(params=["native", "numpy"])
def host_permutation(request, monkeypatch):
    """The port's host Poseidon2 for the test: its C++ engine (the default,
    built from the same source as the reference's), or its own numpy
    version (`permute_np_plain`), which shares no code with the reference,
    so that the comparison does not rest on one permutation on both sides."""
    if request.param == "numpy":
        monkeypatch.setattr(p2, "permute_np", p2.permute_np_plain)
    return request.param


def no_card():
    """Skip a check of the behaviour of a host with no card where there is one."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a host with no card")


def _to_port(proof):
    return ser.decode_machine_proof(ref_ser.encode_machine_proof(proof))


def _to_ref(proof):
    return ref_ser.decode_machine_proof(ser.encode_machine_proof(proof))


def _same_proof(port_proof, ref_proof):
    """Equal in every field but `stat` (the codec keeps `stat` out)."""
    assert ser.encode_machine_proof(port_proof) == ref_ser.encode_machine_proof(ref_proof)


def _same_instances(port, ref):
    assert [type(i.air).__name__ for i in port] == [type(i.air).__name__ for i in ref]
    for p, r in zip(port, ref):
        name = type(p.air).__name__
        np.testing.assert_array_equal(p.trace, r.trace, err_msg=name)
        pp, rp = p.air.preprocessed_trace(), r.air.preprocessed_trace()
        assert (pp is None) == (rp is None), name
        if pp is not None:
            np.testing.assert_array_equal(pp, rp, err_msg=name)
        assert [int(v) for v in p.public_values] == [int(v) for v in r.public_values], name


def _satisfied(instances) -> bool:
    """Every constraint vanishes and every bus balances (the port's debug)."""
    if any(debug.check_constraints(i.air, i.trace, i.public_values) for i in instances):
        return False
    pairs = [(i.air, i.trace) for i in instances]
    return debug.check_bus_balance(pairs, {k: i.public_values for k, i in enumerate(instances)}) == {}


# ---------------------------------------------------------------------------
# the wire AIRs and the builder's gadgets (the cases of test_recursion_wire.py)
# ---------------------------------------------------------------------------


def _alu_arith_and_bus(B, permute):
    bld = B()
    a = bld.const(7)
    b = bld.const([1, 2, 3, 4])
    c = bld.mul(a, b)
    d = bld.add(c, bld.sub(b, a))
    bld.assert_eq(d, bld.witness(d.value))
    return bld


def _poseidon(B, permute):
    bld = B()
    outs = bld.poseidon([bld.const(i + 1) for i in range(16)])
    assert [w.base for w in outs] == [int(v) for v in permute(
        np.arange(1, 17, dtype=np.uint32)[None, :])[0]]
    for w in outs:
        bld.assert_eq(w, bld.witness(w.base))
    return bld


def _public_binding_and_select(B, permute):
    bld = B(n_public_slots=1)
    sel = bld.select(bld.bit_witness(1), bld.const(5), bld.const(9))
    bld.assert_eq(sel, bld.set_public(0, (5, 0, 0, 0)))
    return bld


def _bit_decomposition(B, permute):
    bld = B()
    bits = bld.decompose_bits(bld.witness(P - 3), 31)
    bld.assert_zero(bld.mul(bld.bits_to_value(bits), bld.const(0)))
    return bld


def _inverse(B, permute):
    bld = B()
    a = bld.const([3, 1, 4, 1])
    ia = bld.inv(a)
    bld.assert_eq(bld.mul(a, ia), bld.one())
    return bld


def _digest_program(B, permute, seed=3):
    """test_prove_verify_and_tamper's program: a power of a constant, a
    permutation, its first 4 lanes bound to public slot 0."""
    bld = B(n_public_slots=1)
    acc = bld.const(seed)
    for _ in range(4):
        acc = bld.mul(acc, acc)
    outs = bld.poseidon([acc] + [bld.const(0)] * 15)
    digest = bld.pack_ext(outs[:4])
    for w in outs[4:]:
        bld.assert_zero(bld.mul(w, bld.const(0)))
    bld.assert_eq(digest, bld.set_public(0, digest.value))
    return bld


GADGETS = {"alu_arith_and_bus": _alu_arith_and_bus, "poseidon": _poseidon,
           "public_binding_and_select": _public_binding_and_select,
           "bit_decomposition": _bit_decomposition, "inverse": _inverse,
           "digest_program": _digest_program}


def _gadget(name):
    """(port instances, reference instances) of one gadget program."""
    from zkvm_prover_tpu.models.poseidon2_air import permute_canonical as ref_permute

    port = GADGETS[name](CircuitBuilder, permute_canonical).finalize()
    ref = GADGETS[name](RefCircuitBuilder, ref_permute).finalize()
    return port, ref


@pytest.mark.parametrize("name", list(GADGETS))
def test_gadget_program_and_trace_equal_reference(name, host_permutation):
    port, ref = _gadget(name)
    _same_instances(port, ref)
    assert _satisfied(port)


def test_gadget_values():
    from zkvm_prover_tpu_torch.utils import ext_np

    bld = CircuitBuilder()
    a, b = bld.const(7), bld.const([1, 2, 3, 4])
    d = bld.add(bld.mul(a, b), bld.sub(b, a))
    assert list(d.value) == ext_np.add(ext_np.mul((7, 0, 0, 0), (1, 2, 3, 4)),
                                       ext_np.sub((1, 2, 3, 4), (7, 0, 0, 0)))
    c = bld.const([3, 1, 4, 1])
    assert list(ext_np.mul(c.value, bld.inv(c).value)) == [1, 0, 0, 0]
    bits = bld.decompose_bits(bld.witness(P - 3), 31)
    assert [w.base for w in bits[:4]] == [((P - 3) >> i) & 1 for i in range(4)]


def test_forged_wire_value_unbalances_bus_as_in_reference():
    """At the mul row claim in1 = 8 (out fixed so the op holds): the wire
    bus no longer balances, and the port's debug reports what the
    reference's does."""
    def tampered(B, pkg_machine, pkg_wire):
        bld = B()
        c = bld.mul(bld.const(7), bld.const(6))
        bld.assert_eq(c, bld.witness(42))
        inst = bld.finalize()
        A = pkg_wire.WireAluAir
        assert inst[0].air.program[2, A.P_OP + pkg_wire.OP_MUL] == 1
        tr = inst[0].trace.copy()
        tr[2, A.IN1], tr[2, A.OUT] = 8, 48
        return [pkg_machine.AirInstance(inst[0].air, tr, [])] + list(inst[1:])

    port = tampered(CircuitBuilder, machine, wire_air)
    ref = tampered(RefCircuitBuilder, ref_machine, ref_wire)
    got = debug.check_bus_balance([(i.air, i.trace) for i in port])
    assert got != {}
    assert got == ref_debug.check_bus_balance([(i.air, i.trace) for i in ref])


def test_failing_constraint_reported_as_in_reference():
    port, ref = _gadget("alu_arith_and_bus")
    for insts in (port, ref):
        insts[0].trace[2, 8] = (int(insts[0].trace[2, 8]) + 1) % P  # the mul row's out
    got = debug.check_constraints(port[0].air, port[0].trace)
    assert got != []
    assert got == ref_debug.check_constraints(ref[0].air, ref[0].trace)


def test_wire_proof_equals_reference_and_tampers_fail():
    port, ref = _gadget("digest_program")
    proof = machine.prove_machine(port, fast_test_config(), device="cpu")
    ref_proof = ref_machine.prove_machine(ref, ref_fast_config())
    _same_proof(proof, ref_proof)
    airs, ref_airs = [i.air for i in port], [i.air for i in ref]
    assert machine.verify_machine(airs, _to_port(ref_proof), fast_test_config(), device="cpu")
    assert ref_machine.verify_machine(ref_airs, _to_ref(proof), ref_fast_config())
    bad = copy.deepcopy(proof)
    ln, w, pvs = bad.meta[2]
    bad.meta[2] = (ln, w, [(pvs[0] + 1) % P] + list(pvs[1:]))
    assert not machine.verify_machine(airs, bad, fast_test_config(), device="cpu")
    # another program (vk binding)
    other = [i.air for i in _digest_program(CircuitBuilder, None, seed=4).finalize()]
    assert not machine.verify_machine(other, proof, fast_test_config(), device="cpu")


# ---------------------------------------------------------------------------
# child shape, preprocessed roots, vk words, digests
# ---------------------------------------------------------------------------


def _children():
    """name -> (port AIRs, reference AIRs, log_ns)."""
    port_wire, ref_wire_ = _gadget("digest_program")
    return {
        "fibonacci": ([FibonacciAir()], [RefFibonacciAir()], [3]),
        "lookup": ([RangeTableAir(), RangeCheckedAir()],
                   [RefRangeTableAir(), RefRangeCheckedAir()], [8, 3]),
        "wire": ([i.air for i in port_wire], [i.air for i in ref_wire_],
                 [int(i.trace.shape[0]).bit_length() - 1 for i in port_wire]),
    }


@pytest.fixture(scope="module")
def children():
    return _children()


@pytest.mark.parametrize("child,host_permutation", [
    ("fibonacci", "native"), ("lookup", "native"), ("wire", "native"),
    ("fibonacci", "numpy"), ("lookup", "numpy")], indirect=["host_permutation"])
def test_shape_roots_and_vk_equal_reference(children, child, host_permutation):
    airs, ref_airs, log_ns = children[child]
    shape = sv.shape_of(airs, log_ns, TINY)
    ref_shape = ref_sv.shape_of(ref_airs, log_ns, REF_TINY)
    assert (shape.metas, shape.inter_counts, shape.pre_widths, shape.log_ms, shape.heights) == (
        ref_shape.metas, ref_shape.inter_counts, ref_shape.pre_widths, ref_shape.log_ms,
        ref_shape.heights)
    roots = sv.compute_pre_roots(airs, shape, device="cpu")
    ref_roots = ref_sv.compute_pre_roots(ref_airs, ref_shape)
    assert sorted(roots) == sorted(ref_roots)
    for lm in roots:
        np.testing.assert_array_equal(roots[lm], np.asarray(ref_roots[lm]))
    vk = agg.machine_vk_words(airs, log_ns, TINY, device="cpu")
    np.testing.assert_array_equal(vk, ref_agg.machine_vk_words(ref_airs, log_ns, REF_TINY))
    slot = agg.ChildSlot(airs, log_ns, TINY, "cpu")
    np.testing.assert_array_equal(slot.vk_words, vk)
    assert [agg.constraint_digest_felts(a) for a in airs] == [
        ref_agg.constraint_digest_felts(a) for a in ref_airs]


def test_constraint_digests_equal_reference():
    pairs = [(wire_air.PublicBindAir(2), ref_wire.PublicBindAir(2)),
             (Poseidon2Air(), RefPoseidon2Air())]
    for air, ref_air in pairs:
        assert agg.constraint_digest_felts(air) == ref_agg.constraint_digest_felts(ref_air)


class _TweakedFib(FibonacciAir):
    """Same shape, one extra (vacuous) constraint."""

    def eval(self, b):
        super().eval(b)
        b.assert_zero(b.mul(b.constant(0), b.local(0)))


def test_vk_binds_constraints_shape_and_config():
    base = agg.machine_vk_words([FibonacciAir()], [3], TINY, device="cpu")
    other_cfg = StarkConfig(fri=FriConfig(log_blowup=1, num_queries=3, proof_of_work_bits=2))
    for other in (agg.machine_vk_words([_TweakedFib()], [3], TINY, device="cpu"),
                  agg.machine_vk_words([FibonacciAir()], [4], TINY, device="cpu"),
                  agg.machine_vk_words([FibonacciAir()], [3], other_cfg, device="cpu")):
        assert not np.array_equal(base, other)
    assert agg.constraint_digest_felts(FibonacciAir()) == agg.constraint_digest_felts(
        FibonacciAir())


@pytest.mark.parametrize("tag", [agg.TAG_LEAF, agg.TAG_INTERNAL])
def test_digests_equal_reference_and_domain_separated(tag):
    vk, pvs = list(range(8)), [7, 8, 9]
    words = agg.node_digest_words(tag, [(vk, pvs), (vk[::-1], [1])])
    np.testing.assert_array_equal(words, ref_agg.node_digest_words(tag, [(vk, pvs), (vk[::-1], [1])]))
    assert agg.input_commit(vk, pvs) == ref_agg.input_commit(vk, pvs)
    assert agg.digest_bytes(words) == ref_agg.digest_bytes(words)
    leaf = agg.node_digest_words(agg.TAG_LEAF, [(vk, pvs)])
    internal = agg.node_digest_words(agg.TAG_INTERNAL, [(vk, pvs)])
    assert not np.array_equal(leaf, internal)
    assert agg.input_commit(vk, pvs) not in (agg.digest_bytes(leaf), agg.digest_bytes(internal))


# ---------------------------------------------------------------------------
# the in-circuit verifier (the cases of test_recursion_verifier.py)
# ---------------------------------------------------------------------------


def _ref_fib_proof(log_n=3, x1=1):
    air = RefFibonacciAir()
    trace, pvs = air.generate_trace(log_n, 0, x1)
    return ref_machine.prove_machine([ref_machine.AirInstance(air, trace, pvs)], REF_TINY)


def _ref_lookup_proof():
    table, checked = RefRangeTableAir(), RefRangeCheckedAir()
    vals = [1, 5, 5, 200, 3, 3, 3, 7]
    insts = [ref_machine.AirInstance(table, table.generate_trace(8, vals), []),
             ref_machine.AirInstance(checked, checked.generate_trace(vals), [])]
    return ref_machine.prove_machine(insts, REF_TINY)


@pytest.fixture(scope="module")
def child_proofs():
    """name -> the reference's proof of that child (TINY)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_machine, "_DEVICE_MIN_ELEMS", 1 << 62)
        return {"fibonacci": _ref_fib_proof(), "lookup": _ref_lookup_proof()}


def _circuit(airs, log_ns, oracle, pkg_sv, B, cfg, pre_roots):
    bld = B()
    pkg_sv.verify_in_circuit(bld, airs, pkg_sv.shape_of(airs, log_ns, cfg), oracle,
                             pre_mode="constant", pre_roots=pre_roots)
    return bld.finalize()


def _port_circuit(children, child, proof):
    airs, _, log_ns = children[child]
    oracle = sv.DummyOracle() if proof is None else sv.RealOracle(_to_port(proof))
    return _circuit(airs, log_ns, oracle, sv, CircuitBuilder, TINY, {})


@pytest.mark.parametrize("child", ["fibonacci", "lookup"])
@pytest.mark.parametrize("oracle", ["dummy", "real"])
def test_verifier_circuit_equals_reference(children, child_proofs, child, oracle,
                                           host_permutation):
    _, ref_airs, log_ns = children[child]
    proof = child_proofs[child] if oracle == "real" else None
    port = _port_circuit(children, child, proof)
    ref_oracle = ref_sv.DummyOracle() if proof is None else ref_sv.RealOracle(proof)
    ref = _circuit(ref_airs, log_ns, ref_oracle, ref_sv, RefCircuitBuilder, REF_TINY, {})
    _same_instances(port, ref)
    if oracle == "real":
        assert _satisfied(port)
        # the program is shape only: the dummy build's tables are the same
        dummy = _port_circuit(children, child, None)
        for r, d in zip(port[:2], dummy[:2]):
            np.testing.assert_array_equal(r.air.program, d.air.program)


def _tampered(proof, what):
    bad = copy.deepcopy(proof)
    if what == "trace_root":
        lm = max(bad.trace_roots)
        r = np.asarray(bad.trace_roots[lm]).copy()
        r[0] ^= 1
        bad.trace_roots[lm] = r
    elif what == "opened":
        ov = bad.opened[0].trace_zeta.copy()
        ov[0, 0] ^= 1
        bad.opened[0].trace_zeta = ov
    elif what == "pow":
        bad.fri_proof.pow_witness ^= 1
    elif what == "pv":
        ln, w, pvs = bad.meta[0]
        bad.meta[0] = (ln, w, list(pvs[:2]) + [(pvs[2] + 1) % P] + list(pvs[3:]))
    elif what == "fri_final":
        fp = np.asarray(bad.fri_proof.final_poly).copy()
        fp.reshape(-1)[0] ^= 1
        bad.fri_proof.final_poly = fp
    elif what == "quotient_root":
        lm = max(bad.quotient_roots)
        r = np.asarray(bad.quotient_roots[lm]).copy()
        r[3] ^= 2
        bad.quotient_roots[lm] = r
    elif what == "claimed":
        cs = np.asarray(bad.claimed_sums[0]).copy()
        cs[0] ^= 1
        bad.claimed_sums[0] = cs
    return bad


@pytest.mark.parametrize("child,what", [
    ("fibonacci", "trace_root"), ("fibonacci", "opened"), ("fibonacci", "pow"),
    ("fibonacci", "pv"), ("fibonacci", "fri_final"), ("fibonacci", "quotient_root"),
    ("lookup", "claimed")])
def test_tampered_child_does_not_satisfy_the_circuit(children, child_proofs, child, what):
    airs = children[child][0]
    bad = _tampered(_to_port(child_proofs[child]), what)
    assert not machine.verify_machine(airs, bad, TINY, device="cpu")
    assert not _satisfied(_port_circuit(children, child, _to_ref(bad)))


# ---------------------------------------------------------------------------
# leaf node (the cases of test_recursion_aggregation.py)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def leaf():
    """The port's leaf program over two Fibonacci slots, its proof over two
    reference child proofs, and the reference's proof of the same node."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_machine, "_DEVICE_MIN_ELEMS", 1 << 62)
        kids = [_ref_fib_proof(x1=1), _ref_fib_proof(x1=2)]
        ref_slot = ref_agg.ChildSlot([RefFibonacciAir()], [3], REF_TINY)
        ref_insts = ref_agg.build_child_verification(
            ref_agg.TAG_LEAF, [ref_slot, ref_slot], [ref_sv.RealOracle(k) for k in kids])
        ref_proof = ref_machine.prove_machine(ref_insts, REF_TINY)
    slot = agg.ChildSlot([FibonacciAir()], [3], TINY, "cpu")
    prog = agg.AggNodeProgram(agg.TAG_LEAF, [slot, slot], TINY, "cpu")
    port_kids = [_to_port(k) for k in kids]
    proof, pi = prog.prove(port_kids)
    return dict(kids=port_kids, slot=slot, prog=prog, proof=proof, pi=pi,
                ref_insts=ref_insts, ref_proof=ref_proof, ref_slot=ref_slot)


def test_leaf_node_equals_reference(leaf):
    _same_proof(leaf["proof"], leaf["ref_proof"])
    ref_airs = [i.air for i in leaf["ref_insts"]]
    assert ref_machine.verify_machine(ref_airs, _to_ref(leaf["proof"]), REF_TINY)
    assert leaf["prog"].verify(_to_port(leaf["ref_proof"]), expected_digest=leaf["pi"])
    assert leaf["pi"] == ref_agg.verification_digest_of(leaf["ref_insts"])
    np.testing.assert_array_equal(leaf["slot"].vk_words, leaf["ref_slot"].vk_words)


def test_leaf_node_roundtrip(leaf):
    prog, pi = leaf["prog"], leaf["pi"]
    assert prog.verify(leaf["proof"], expected_digest=pi)
    children = [(leaf["slot"].vk_words, [v for (_, _, pvs) in k.meta for v in pvs])
                for k in leaf["kids"]]
    assert pi == agg.digest_bytes(agg.node_digest_words(agg.TAG_LEAF, children))
    assert agg.AggNodeProgram.digest_of(leaf["proof"]) == pi


def test_leaf_rejects_wrong_digest(leaf):
    wrong = bytearray(leaf["pi"])
    wrong[0] ^= 1
    assert not leaf["prog"].verify(leaf["proof"], expected_digest=bytes(wrong))


def test_leaf_rejects_tampered_child(leaf):
    """No host pre-check anywhere: prove() takes the corrupt child and the
    node proof fails verification."""
    bad = _tampered(leaf["kids"][0], "pv")
    assert not machine.verify_machine([FibonacciAir()], bad, TINY, device="cpu")
    node_proof, _ = leaf["prog"].prove([bad, leaf["kids"][1]])
    assert not leaf["prog"].verify(node_proof)


def test_leaf_nodes_proved_in_a_pool_equal_the_leaf(leaf):
    """Two sibling leaf nodes proved by two spawned CPU workers: each is
    byte-equal to the leaf fixture's proof (itself equal to the
    reference's)."""
    from zkvm_prover_tpu_torch.host.app import get_app

    kids = leaf["kids"]
    proved = agg._prove_leaf_nodes_pool([kids, kids], get_app("fibonacci").vk_bytes(),
                                        leaf["slot"], TINY, 2, "cpu")
    assert len(proved) == 2
    for p, stat in proved:
        _same_proof(p, leaf["ref_proof"])
        assert ser.encode_machine_proof(p) == ser.encode_machine_proof(leaf["proof"])
        # on the host the wrappers run their plain versions: nothing launched
        assert stat["device"] == "cpu" and stat["calls"] == []
        assert set(stat["launches"]) == set(stat["setup_launches"]) != set()
        assert not any(stat["launches"].values())


def test_pooled_leaf_at_another_node_config_equals_the_serial_leaf(leaf):
    """The node config differs from the children's: the worker builds the
    child slot at the children's config, so its leaf equals the one the
    serial path's program proves."""
    from zkvm_prover_tpu_torch.host.app import get_app

    node_cfg = StarkConfig(fri=FriConfig(log_blowup=1, num_queries=3, proof_of_work_bits=1))
    prover = agg.RecursiveAggregationProver(
        leaf["slot"], node_cfg, agg.AggregationTreeConfig(num_children_leaf=2), device="cpu")
    serial, _ = prover._program(agg.TAG_LEAF, (leaf["slot"], leaf["slot"])).prove(leaf["kids"])
    [(pooled, _)] = agg._prove_leaf_nodes_pool(
        [leaf["kids"]], get_app("fibonacci").vk_bytes(), leaf["slot"], node_cfg, 1, "cpu")
    assert ser.encode_machine_proof(pooled) == ser.encode_machine_proof(serial)
    assert ser.encode_machine_proof(pooled) != ser.encode_machine_proof(leaf["proof"])


def test_leaf_worker_refuses_a_slot_with_another_vk(leaf):
    from zkvm_prover_tpu_torch.host.app import get_app
    from zkvm_prover_tpu_torch.parallel.pool import stark_config_dict

    vk = bytearray(leaf["slot"].vk_words.tobytes())
    vk[0] ^= 1
    payload = {"app_vk": get_app("fibonacci").vk_bytes().hex(),
               "child_config": stark_config_dict(TINY), "child_vk": bytes(vk).hex(),
               "node_config": stark_config_dict(TINY), "device": "cpu",
               "proofs": [ser.encode_machine_proof(k) for k in leaf["kids"]]}
    with pytest.raises(ValueError, match="another vk"):
        agg._prove_leaf_node_worker(payload)


def test_parallel_leaf_proving_needs_the_app_vk(leaf):
    prover = agg.RecursiveAggregationProver(
        leaf["slot"], TINY, agg.AggregationTreeConfig(num_children_leaf=1), device="cpu")
    with pytest.raises(ValueError, match="app vk"):
        prover.aggregate(leaf["kids"], workers=2)


def test_parallel_leaf_proving_without_a_card_raises(leaf):
    no_card()
    from zkvm_prover_tpu_torch.host.app import get_app

    prover = agg.RecursiveAggregationProver(
        leaf["slot"], TINY, agg.AggregationTreeConfig(num_children_leaf=1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prover.aggregate(leaf["kids"], workers=2, app_vk=get_app("fibonacci").vk_bytes())


@pytest.mark.slow
def test_parallel_tree_equals_serial(leaf):
    """aggregate(workers=2) over four children (two leaf groups) equals the
    serial aggregate at the leaves and at the root's digest."""
    from zkvm_prover_tpu_torch.host.app import get_app

    k1, k2 = leaf["kids"]
    children = [k1, k2, k1, k2]
    tree = agg.AggregationTreeConfig(num_children_leaf=2, num_children_internal=3)
    prover = agg.RecursiveAggregationProver(leaf["slot"], TINY, tree, device="cpu")
    seq = prover.aggregate(children)
    par = prover.aggregate(children, workers=2, app_vk=get_app("fibonacci").vk_bytes())
    assert len(seq[0]) == len(par[0]) == 2
    for a, b in zip(seq[0], par[0]):
        assert ser.encode_machine_proof(a.proof) == ser.encode_machine_proof(b.proof)
        assert a.pi_hash == b.pi_hash
    # the parallel leaves feed the same internal/root chain
    assert seq[-1][0].pi_hash == par[-1][0].pi_hash
    assert par[-1][0].level == "root"
    assert par[-1][0].program.verify(par[-1][0].proof, expected_digest=par[-1][0].pi_hash)


@pytest.mark.slow
def test_internal_node_over_leaf_equals_reference(leaf):
    """An internal node verifies the leaf machine proof in-circuit (the wire
    machine verifying a proof of the wire machine); equal to the
    reference's, each verifier accepting the other's proof."""
    leaf_slot = agg.ChildSlot(leaf["prog"].machine_airs(), leaf["prog"]._log_ns, TINY, "cpu")
    internal = agg.AggNodeProgram(agg.TAG_INTERNAL, [leaf_slot], TINY, "cpu")
    proof, pi = internal.prove([leaf["proof"]])
    assert internal.verify(proof, expected_digest=pi)
    leaf_pvs = [v for (_, _, pvs) in leaf["proof"].meta for v in pvs]
    assert pi == agg.digest_bytes(agg.node_digest_words(
        agg.TAG_INTERNAL, [(leaf_slot.vk_words, leaf_pvs)]))
    ref_leaf_slot = ref_agg.ChildSlot([i.air for i in leaf["ref_insts"]],
                                      leaf["prog"]._log_ns, REF_TINY)
    ref_insts = ref_agg.build_child_verification(
        ref_agg.TAG_INTERNAL, [ref_leaf_slot], [ref_sv.RealOracle(leaf["ref_proof"])])
    ref_proof = ref_machine.prove_machine(ref_insts, REF_TINY)
    _same_proof(proof, ref_proof)
    assert internal.verify(_to_port(ref_proof), expected_digest=pi)
    assert ref_machine.verify_machine([i.air for i in ref_insts], _to_ref(proof), REF_TINY)


# ---------------------------------------------------------------------------
# the host entry point (the cases of test_prover_aggregation.py)
# ---------------------------------------------------------------------------


def _fib_task(Task):
    return Task(serialized_witness=[json.dumps({"log_n": 3, "x0": 0, "x1": 1}).encode()])


def _parent_task(Task, child):
    return Task(serialized_witness=[json.dumps({"log_n_fib": 3, "log_n_dbl": 3}).encode()],
                aggregated_proofs=[child])


def _carried(envelope, Enum):
    return Enum.from_dict(json.loads(json.dumps(envelope.to_dict())))


@pytest.fixture(scope="module")
def envelopes():
    """The fib-double envelope over an in-circuit Fibonacci child, from each
    package (the reference's child carried into the port)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_machine, "_DEVICE_MIN_ELEMS", 1 << 62)
        ref_child = RefProver.setup(RefProverConfig(app_name="fibonacci", stark=REF_TINY)
                                    ).gen_proof_stark(_fib_task(RefProvingTask))
        ref_parent = RefProver.setup(RefProverConfig(app_name="fib-double", stark=REF_TINY)
                                     ).gen_proof_stark(_parent_task(RefProvingTask, ref_child))
    child = _carried(ref_child, ProofEnum)
    prover = Prover.setup(ProverConfig(app_name="fib-double", stark=TINY, device="cpu"))
    assert prover.config.child_verification == "in-circuit"
    parent = prover.gen_proof_stark(_parent_task(ProvingTask, child))
    return dict(child=child, prover=prover, parent=parent, ref_parent=ref_parent)


def test_envelope_equals_reference(envelopes):
    port, ref = envelopes["parent"].to_dict(), envelopes["ref_parent"].to_dict()
    port.pop("stat"), ref.pop("stat")
    assert port == ref
    assert envelopes["parent"].stat.total_cycles == envelopes["ref_parent"].stat.total_cycles


def test_each_verifier_accepts_the_others_envelope(envelopes):
    assert UniversalVerifier("fib-double", TINY, device="cpu").verify_stark_proof(
        _carried(envelopes["ref_parent"], ProofEnum))
    assert RefVerifier("fib-double", REF_TINY).verify_stark_proof(
        _carried(envelopes["parent"], RefProofEnum))


def test_aggregated_envelope_roundtrip(envelopes):
    proof, child = envelopes["parent"], envelopes["child"]
    assert len(proof.agg_children) == 1 and len(proof.input_commits) == 1
    assert proof.agg_children[0].vk == child.baseline
    rt = _carried(proof, ProofEnum)
    assert rt.agg_children[0].pvs == proof.agg_children[0].pvs
    assert rt.input_commits == proof.input_commits
    assert UniversalVerifier.verify_stark_proof_with_vk(envelopes["prover"].get_app_vk(), rt, TINY,
                                                    device="cpu")


@pytest.mark.parametrize("what", ["pvs", "log_ns", "vk", "input_commit", "deferral"])
def test_forged_aggregation_claims_rejected(envelopes, what):
    """The envelope's untrusted hints: each forgery fails the digest pin,
    the input commits, the deferral data or the rebuilt program."""
    bad = _carried(envelopes["parent"], ProofEnum)
    rec = bad.agg_children[0]
    if what == "pvs":
        rec.pvs[0] = (rec.pvs[0] + 1) % 100
    elif what == "log_ns":
        rec.log_ns = [rec.log_ns[0] + 1]
    elif what == "vk":
        rec.vk = envelopes["prover"].get_app_vk()
    elif what == "input_commit":
        bad.input_commits = [bytes(32)]
    else:
        bad.deferral_merkle_proofs = bad.deferral_merkle_proofs[:-1] + bytes(
            [bad.deferral_merkle_proofs[-1] ^ 1])
    assert not UniversalVerifier("fib-double", TINY, device="cpu").verify_stark_proof(bad)


def test_invalid_child_makes_an_unsatisfiable_node(envelopes):
    """A corrupt child proof: the parent machine's constraints cannot hold
    (the constraint-level form of test_leaf_rejects_tampered_child)."""
    mp = ser.decode_machine_proof(envelopes["child"].proof)
    ln, w, pvs = mp.meta[0]
    mp.meta[0] = (ln, w, list(pvs[:2]) + [(pvs[2] + 3) % 1000] + list(pvs[3:]))
    slot = agg.ChildSlot([FibonacciAir()], [ln], TINY, "cpu")
    instances = agg.build_child_verification(agg.TAG_LEAF, [slot], [sv.RealOracle(mp)])
    assert not _satisfied(instances)


def test_in_circuit_child_needs_a_known_app(envelopes):
    from zkvm_prover_tpu_torch.host.prover import ProverError

    child = _carried(envelopes["child"], ProofEnum)
    child.baseline = bytes(64)
    with pytest.raises(ProverError, match="unknown child app vk"):
        envelopes["prover"].gen_proof_stark(_parent_task(ProvingTask, child))


# ---------------------------------------------------------------------------
# chunk 0 (slow: about 90 s of reference time here)
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_chunk_verifier_program_equals_reference(tmp_path, monkeypatch):
    """The leaf wire program over chunk 0 of the chunk task generator at
    TINY: the reference's proof of the chunk, verified in-circuit by both
    packages; programs and traces equal."""
    from zkvm_prover_tpu.host.app import get_app as ref_get_app
    from zkvm_prover_tpu.integration import ChunkTaskGenerator as RefChunkTaskGenerator
    from zkvm_prover_tpu_torch.host.app import get_app

    monkeypatch.setenv("OUTPUT_DIR", str(tmp_path))
    ref_proof = ref_ser.decode_machine_proof(
        RefChunkTaskGenerator(stark=REF_TINY).get_or_build_proof(0).proof)
    log_ns = [ln for (ln, _, _) in ref_proof.meta]
    ref_slot = ref_agg.ChildSlot(ref_get_app("chunk").airs_for_meta(ref_proof.meta), log_ns,
                                 REF_TINY)
    ref = ref_agg.build_child_verification(ref_agg.TAG_LEAF, [ref_slot],
                                           [ref_sv.RealOracle(ref_proof)])
    proof = _to_port(ref_proof)
    slot = agg.ChildSlot(get_app("chunk").airs_for_meta(proof.meta), log_ns, TINY, "cpu")
    np.testing.assert_array_equal(slot.vk_words, ref_slot.vk_words)
    port = agg.build_child_verification(agg.TAG_LEAF, [slot], [sv.RealOracle(proof)])
    _same_instances(port, ref)


@pytest.mark.slow
def test_batch_over_chunk_in_circuit(tmp_path, monkeypatch):
    """The chain at TINY through the port's entry points: chunk 0 of the
    chunk task generator, the batch over it with its child verified
    in-circuit (the default), the envelope through `UniversalVerifier`
    after a JSON round trip (True; a forged child record False), and the
    bundle over that batch with its child checked on the host, which goes
    through the verifier's in-circuit branch (about 7 minutes here)."""
    from zkvm_prover_tpu_torch.host import StarkProof
    from zkvm_prover_tpu_torch.integration import (BatchTaskGenerator, BundleTaskGenerator,
                                                   ChunkTaskGenerator)

    monkeypatch.setenv("OUTPUT_DIR", str(tmp_path))
    chunks = ChunkTaskGenerator(stark=TINY, device="cpu")
    batches = BatchTaskGenerator(chunks=chunks, chunks_per_batch=1)
    task = batches.task(0)
    env = Prover(ProverConfig("batch", stark=TINY, device="cpu")).gen_proof_stark(task)
    assert [r.vk for r in env.agg_children] == [chunks.get_or_build_proof(0).baseline]
    batches.add_proof(0, task, env)
    carried = _carried(env, StarkProof)
    verifier = UniversalVerifier("batch", TINY, device="cpu")
    assert verifier.verify_stark_proof(carried)
    carried.agg_children[0].pvs[0] = (carried.agg_children[0].pvs[0] + 1) % P
    assert verifier.verify_stark_proof(carried) is False
    bundle = BundleTaskGenerator(batches=batches, batches_per_bundle=1).build_proof()
    assert UniversalVerifier("bundle", TINY, device="cpu").verify_stark_proof(bundle)
