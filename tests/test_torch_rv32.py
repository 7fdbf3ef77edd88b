"""The port's rv32 machine (the RV32IM and keccak chips, the executor, the
assembler and the vk serialisation) against the JAX package.

Three programs: the reference's `full_coverage_program` (every RV32IM
instruction kind), the benchmark guest `bench_guest_program(8, 256)`
(24,729 cycles) and `bench_guest_program(1, 4)` (124 cycles, one keccak
call, the same 18 AIRs). For each, the assembled words, the executors'
records and final state, every AIR's trace and public values, and every
AIR's `serialize_air` felt stream (the vk material) must be equal. The
small guest is proven by both packages at `fast_test_config` (the port on
`device="cpu"`): the proofs are equal in every field but `stat`, each
verifier accepts the other's proof, and tampered proofs give False in both.
The benchmark guest's proof parity runs under the `slow` marker."""

import copy
import os

import numpy as np
import pytest

import test_rv32_v2 as ref_rv32_tests
from zkvm_prover_tpu.models import rv32_v2 as ref_rv32_v2
from zkvm_prover_tpu.models import symbolic as ref_symbolic
from zkvm_prover_tpu.stark import machine as ref_machine
from zkvm_prover_tpu.stark.config import default_config as ref_default_config
from zkvm_prover_tpu.stark.config import fast_test_config as ref_fast_config
from zkvm_prover_tpu.vm import executor as ref_executor
from zkvm_prover_tpu_torch.convert import machine_proof_from_numpy
from zkvm_prover_tpu_torch.models import rv32_v2, symbolic
from zkvm_prover_tpu_torch.stark import machine
from zkvm_prover_tpu_torch.stark.config import default_config, fast_test_config
from zkvm_prover_tpu_torch.vm import asm, executor, guests

from test_torch_stark import assert_proofs_equal

DATA_BASE = 0x3000
MAX_CYCLES = 1 << 18


def _reference_bench_guest(n_outer, n_inner):
    """`bench.py::bench_guest_program`. Importing bench.py sets an
    environment default that the reference's machine module reads when it
    is imported (already done above); it is restored at once."""
    key = "ZKVM_TPU_DEVICE_MIN_ELEMS"
    saved = os.environ.get(key)
    import bench
    if saved is None:
        os.environ.pop(key, None)
    else:
        os.environ[key] = saved
    return bench.bench_guest_program(n_outer, n_inner)


def _full_coverage(asm_module):
    """The reference test's program, assembled with `asm_module`."""
    saved = ref_rv32_tests.asm
    ref_rv32_tests.asm = asm_module
    try:
        return ref_rv32_tests.full_coverage_program()
    finally:
        ref_rv32_tests.asm = saved


# program -> (reference words, port words)
PROGRAMS = {
    "full_coverage": lambda: (_full_coverage(ref_rv32_tests.asm), _full_coverage(asm)),
    "bench_8_256": lambda: (_reference_bench_guest(8, 256), guests.bench_guest_program(8, 256)),
    "bench_1_4": lambda: (_reference_bench_guest(1, 4), guests.bench_guest_program(1, 4)),
}


def _execute(ex_module, traces_module, words, name):
    """The full-coverage program runs as its reference test runs it
    (`execute_and_trace`); the benchmark guests as bench.py runs them."""
    if name == "full_coverage":
        ex, state, traces = traces_module.execute_and_trace(words, data_base=DATA_BASE)
    else:
        ex = ex_module.Rv32Executor()
        ex.load_program(words)
        state = ex.run(MAX_CYCLES)
        traces = traces_module.generate_traces(words, ex.records(), data_base=DATA_BASE)
    return {"state": state, "cycles": ex.cycles, "pc": ex.pc, "exit_code": ex.exit_code,
            "regs": [ex.get_reg(r) for r in range(32)], "pvs": ex.public_values(),
            "records": ex.records(), "traces": traces}


@pytest.fixture(scope="module")
def runs():
    """program -> (reference run, port run)."""
    out = {}
    for name, make in PROGRAMS.items():
        ref_words, words = make()
        out[name] = (ref_words, words,
                     _execute(ref_executor, ref_rv32_v2, ref_words, name),
                     _execute(executor, rv32_v2, words, name))
    return out


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_assembled_words_equal(runs, name):
    ref_words, words = runs[name][:2]
    assert [int(w) for w in words] == [int(w) for w in ref_words]


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_executors_agree(runs, name):
    ref, port = runs[name][2:]
    assert port["state"] == ref["state"] == executor.HALTED
    for key in ("cycles", "pc", "exit_code", "regs", "pvs"):
        assert port[key] == ref[key], key
    assert port["records"].shape == ref["records"].shape
    assert port["records"].shape[1] == executor.RECORD_FIELDS
    np.testing.assert_array_equal(port["records"], ref["records"])


def test_bench_guest_sizes(runs):
    assert runs["bench_8_256"][3]["cycles"] == 24729
    assert runs["bench_1_4"][3]["cycles"] == 124
    names = [type(a).__name__ for a, _, _ in runs["bench_1_4"][3]["traces"]]
    assert names == [type(a).__name__ for a, _, _ in runs["bench_8_256"][3]["traces"]]
    assert len(names) == 18 and "KeccakfAir" in names


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_traces_equal(runs, name):
    ref, port = runs[name][2:]
    assert ([type(a).__name__ for a, _, _ in port["traces"]]
            == [type(a).__name__ for a, _, _ in ref["traces"]])
    for (ref_air, ref_t, ref_pvs), (air, t, pvs) in zip(ref["traces"], port["traces"]):
        label = type(air).__name__
        assert t.dtype == ref_t.dtype == np.uint32, label
        np.testing.assert_array_equal(t, ref_t, err_msg=label)
        assert [int(v) for v in pvs] == [int(v) for v in ref_pvs], label
        assert (air.width, air.num_public_values) == (ref_air.width, ref_air.num_public_values)
        pre, ref_pre = air.preprocessed_trace(), ref_air.preprocessed_trace()
        assert (pre is None) == (ref_pre is None), label
        if pre is not None:
            np.testing.assert_array_equal(pre, ref_pre, err_msg=label)


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_serialize_air_equal(runs, name):
    """The felt stream the vk hashes: every constraint, constant, selector
    use and bus interaction of each AIR."""
    ref, port = runs[name][2:]
    for (ref_air, _, _), (air, _, _) in zip(ref["traces"], port["traces"]):
        assert symbolic.serialize_air(air) == ref_symbolic.serialize_air(ref_air), \
            type(air).__name__


# ---------------------------------------------------------------------------
# the whole proof of the small keccak guest
# ---------------------------------------------------------------------------


def _reference_proof(air_traces, cfg):
    """The reference's machine proof on its host numpy path, as bench.py
    runs it (the same proof as its JAX path, without the XLA compiles)."""
    saved = ref_machine._DEVICE_MIN_ELEMS
    ref_machine._DEVICE_MIN_ELEMS = 1 << 62
    try:
        return ref_machine.prove_machine(
            [ref_machine.AirInstance(a, t, p) for a, t, p in air_traces], cfg)
    finally:
        ref_machine._DEVICE_MIN_ELEMS = saved


@pytest.fixture(scope="module")
def small_proofs(runs):
    """(reference AIRs, port AIRs, reference proof, port proof), each built
    once."""
    ref, port = runs["bench_1_4"][2:]
    ref_airs = [a for a, _, _ in ref["traces"]]
    airs = [a for a, _, _ in port["traces"]]
    ref_proof = _reference_proof(ref["traces"], ref_fast_config())
    proof = machine.prove_machine(
        [machine.AirInstance(a, t, p) for a, t, p in port["traces"]],
        fast_test_config(), device="cpu")
    return ref_airs, airs, ref_proof, proof


def test_small_guest_proof_equals_reference(small_proofs):
    _, _, ref_proof, proof = small_proofs
    assert_proofs_equal(proof, ref_proof)
    assert proof.stat["n_airs"] == len(proof.meta) == 18


@pytest.mark.parametrize("which", ["port_verifies_reference", "reference_verifies_port"])
def test_each_verifier_accepts_the_other(small_proofs, which):
    ref_airs, airs, ref_proof, proof = small_proofs
    if which == "port_verifies_reference":
        assert machine.verify_machine(airs, machine_proof_from_numpy(ref_proof),
                                      fast_test_config(), device="cpu") is True
    else:
        assert ref_machine.verify_machine(ref_airs, proof, ref_fast_config())


def _air_index(airs, cls_name):
    return next(i for i, a in enumerate(airs) if type(a).__name__ == cls_name)


def _tampered(airs, proof, what, program_cls):
    """(AIRs, proof) with one change: a public value of PublicValuesAir, an
    opened trace value of the keccak-f AIR, or one program word (the
    verifier's ProgramAirV2, whose preprocessed columns the vk binds)."""
    airs, bad = list(airs), copy.deepcopy(proof)
    if what == "public_value":
        i = _air_index(airs, "PublicValuesAir")
        log_n, w, pvs = bad.meta[i]
        bad.meta[i] = (log_n, w, [(pvs[0] + 1) % 256] + list(pvs[1:]))
    elif what == "trace_opening":
        i = _air_index(airs, "KeccakfAir")
        bad.opened[i].trace_zeta[5, 2] ^= 1
    elif what == "program_word":
        i = _air_index(airs, "ProgramAirV2")
        words = list(airs[i].program_words)
        words[3] = asm.addi("t0", "t0", 7)
        airs[i] = program_cls(words)
    return airs, bad


@pytest.mark.parametrize("what", ["public_value", "trace_opening", "program_word"])
def test_tampered_small_proof_rejected_by_both(small_proofs, what):
    ref_airs, airs, ref_proof, proof = small_proofs
    bad_airs, bad = _tampered(airs, proof, what, rv32_v2.ProgramAirV2)
    assert machine.verify_machine(bad_airs, bad, fast_test_config(), device="cpu") is False
    bad_ref_airs, bad_ref = _tampered(ref_airs, ref_proof, what, ref_rv32_v2.ProgramAirV2)
    assert not ref_machine.verify_machine(bad_ref_airs, bad_ref, ref_fast_config())


def test_executor_builds_into_the_ports_build_dir():
    so = executor.build_native()
    assert so.parent == executor.BUILD_DIR and so.name == "librv32im.so"
    assert so.parent.parent.name == "build"
    assert so.stat().st_mtime >= executor._SRC.stat().st_mtime


def test_executor_build_without_gxx_raises(monkeypatch):
    monkeypatch.setattr(executor.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        executor.build_native(force=True)


# ---------------------------------------------------------------------------
# the benchmark guest's proof (slow)
# ---------------------------------------------------------------------------


@pytest.mark.slow
@pytest.mark.parametrize("cfg_name", ["fast_test_config", "default_config"])
def test_bench_guest_proof_equals_reference(runs, cfg_name):
    ref_cfg, cfg = {"fast_test_config": (ref_fast_config(), fast_test_config()),
                    "default_config": (ref_default_config(), default_config())}[cfg_name]
    ref, port = runs["bench_8_256"][2:]
    ref_proof = _reference_proof(ref["traces"], ref_cfg)
    proof = machine.prove_machine(
        [machine.AirInstance(a, t, p) for a, t, p in port["traces"]], cfg, device="cpu")
    assert_proofs_equal(proof, ref_proof)
    assert machine.verify_machine([a for a, _, _ in port["traces"]], proof, cfg,
                                  device="cpu") is True
