"""The port's RV32 chipset v0 (`zkvm_prover_tpu_torch/models/rv32_v0.py`)
against the JAX package, on the programs of the reference's
`tests/test_rv32_proof.py`.

Every comparison is exact: the native executor's run, the four chips'
traces (and ProgramAir's preprocessed ROM), the `serialize_air` streams,
and a `fast_test_config()` machine proof equal in every field but `stat`
(the reference proves on its host numpy path), which each package's
verifier accepts. A forged register value and a proof checked against
another program are rejected."""

import numpy as np
import pytest

from zkvm_prover_tpu.host import serialization as ref_ser
from zkvm_prover_tpu.models import rv32_v0 as ref_v0
from zkvm_prover_tpu.models.symbolic import serialize_air as ref_serialize_air
from zkvm_prover_tpu.stark import machine as ref_machine
from zkvm_prover_tpu.stark.config import fast_test_config as ref_fast_config
from zkvm_prover_tpu.vm import asm as ref_asm
from zkvm_prover_tpu_torch.host import serialization as ser
from zkvm_prover_tpu_torch.models import rv32_v0
from zkvm_prover_tpu_torch.models.symbolic import serialize_air
from zkvm_prover_tpu_torch.stark import machine
from zkvm_prover_tpu_torch.stark.config import fast_test_config
from zkvm_prover_tpu_torch.vm import asm
from zkvm_prover_tpu_torch.vm.executor import HALTED


def straightline(a):
    # ((5 + 7) - 3) + 100 into t3 through chained arithmetic
    return a.assemble([
        a.addi("t0", "zero", 5),
        a.addi("t1", "zero", 7),
        a.add("t2", "t0", "t1"),
        a.addi("t3", "t2", -3),
        a.addi("t4", "t3", 100),
        a.add("t5", "t4", "t4"),
        a.sub("t6", "t5", "t0"),
        a.halt(0),
    ])


def wraparound(a):
    # u32 overflow semantics through the carry chains
    return a.assemble([
        a.addi("t0", "zero", -1),      # 0xffffffff
        a.addi("t1", "t0", 1),         # wraps to 0
        a.add("t2", "t0", "t0"),       # 0xfffffffe
        a.sub("t3", "t1", "t0"),       # 0 - (-1) = 1
        a.halt(0),
    ])


PROGRAMS = {"straightline": straightline, "wraparound": wraparound}
REGS = {"straightline": {"t6": (5 + 7 - 3 + 100) * 2 - 5},
        "wraparound": {"t1": 0, "t2": 0xFFFFFFFE, "t3": 1}}


def _instances(pkg_machine, air_traces):
    return [pkg_machine.AirInstance(a, t, []) for a, t in air_traces]


@pytest.fixture(scope="module", params=list(PROGRAMS))
def run(request):
    """Both packages' execution, traces and proof of one program."""
    name = request.param
    words = PROGRAMS[name](asm)
    assert words == PROGRAMS[name](ref_asm)
    ex, state, air_traces = rv32_v0.execute_and_trace(words)
    ref_ex, ref_state, ref_air_traces = ref_v0.execute_and_trace(words)
    proof = machine.prove_machine(_instances(machine, air_traces), fast_test_config(),
                                  device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_machine, "_DEVICE_MIN_ELEMS", 1 << 62)
        ref_proof = ref_machine.prove_machine(_instances(ref_machine, ref_air_traces),
                                              ref_fast_config())
    return dict(name=name, words=words, ex=ex, state=state, air_traces=air_traces,
                ref_state=ref_state, ref_air_traces=ref_air_traces, proof=proof,
                ref_proof=ref_proof)


def test_execution_matches_semantics(run):
    assert run["state"] == run["ref_state"] == HALTED
    for reg, val in REGS[run["name"]].items():
        assert run["ex"].get_reg(asm.REGS[reg]) == val


def test_traces_equal_reference(run):
    assert [type(a).__name__ for a, _ in run["air_traces"]] == \
        [type(a).__name__ for a, _ in run["ref_air_traces"]] == \
        ["CpuAirV0", "ProgramAir", "MemoryBoundaryAir", "ByteTableAir"]
    for (a, t), (ra, rt) in zip(run["air_traces"], run["ref_air_traces"]):
        name = type(a).__name__
        np.testing.assert_array_equal(t, rt, err_msg=name)
        assert t.dtype == rt.dtype, name
        assert (a.width, a.num_public_values) == (ra.width, ra.num_public_values), name
        pre, ref_pre = a.preprocessed_trace(), ra.preprocessed_trace()
        assert (pre is None) == (ref_pre is None), name
        if pre is not None:
            np.testing.assert_array_equal(pre, ref_pre, err_msg=name)
        assert [int(v) for v in serialize_air(a)] == \
            [int(v) for v in ref_serialize_air(ra)], name


def test_decode_and_constants_equal_reference(run):
    assert (rv32_v0.BYTE_BUS, rv32_v0.REG_BUS, rv32_v0.PROGRAM_BUS, rv32_v0.LIMB) == \
        (ref_v0.BYTE_BUS, ref_v0.REG_BUS, ref_v0.PROGRAM_BUS, ref_v0.LIMB)
    for w in run["words"][:-1]:
        assert rv32_v0._decode_v0(w) == ref_v0._decode_v0(w)
    with pytest.raises(ValueError):
        rv32_v0._decode_v0(run["words"][-1])   # the halt ecall is not v0


def test_proof_equals_reference_and_cross_verifies(run):
    assert ser.encode_machine_proof(run["proof"]) == \
        ref_ser.encode_machine_proof(run["ref_proof"])
    airs = [a for a, _ in run["air_traces"]]
    assert machine.verify_machine(airs, run["proof"], fast_test_config(), device="cpu")
    ported = ser.decode_machine_proof(ref_ser.encode_machine_proof(run["ref_proof"]))
    assert machine.verify_machine(airs, ported, fast_test_config(), device="cpu")
    ref_airs = [a for a, _ in run["ref_air_traces"]]
    back = ref_ser.decode_machine_proof(ser.encode_machine_proof(run["proof"]))
    assert ref_machine.verify_machine(ref_airs, back, ref_fast_config())


def test_reject_tampered_register_value():
    """A trace claiming a wrong ADD result: the memory argument and the
    constraints catch it."""
    _, _, air_traces = rv32_v0.execute_and_trace(straightline(asm))
    cpu_air, cpu = air_traces[0]
    cpu = cpu.copy()
    C = rv32_v0.CpuAirV0
    # row 2 is add t2, t0, t1: bump the result limb
    cpu[2, C.RD_VAL] = (int(cpu[2, C.RD_VAL]) + 1) % 256
    air_traces = [(cpu_air, cpu)] + air_traces[1:]
    proof = machine.prove_machine(_instances(machine, air_traces), fast_test_config(),
                                  device="cpu")
    assert not machine.verify_machine([a for a, _ in air_traces], proof, fast_test_config(),
                                      device="cpu")


def test_reject_wrong_program(run):
    """The program ROM is preprocessed (verification-key material): a proof
    of program A does not verify against a verifier expecting program B."""
    other = list(run["words"])
    other[0] = asm.assemble([asm.addi("t0", "zero", 6)])[0]   # the first addi loads 6
    airs = [a for a, _ in run["air_traces"]]
    airs_b = list(airs)
    airs_b[1] = rv32_v0.ProgramAir(other)
    assert not machine.verify_machine(airs_b, run["proof"], fast_test_config(), device="cpu")
    assert machine.verify_machine(airs, run["proof"], fast_test_config(), device="cpu")
