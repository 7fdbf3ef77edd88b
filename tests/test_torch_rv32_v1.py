"""The port's RV32 chipset v1 (`zkvm_prover_tpu_torch/models/rv32_v1.py`)
against the JAX package, on the programs of the reference's
`tests/test_rv32_v1.py` and `tests/test_rv32_memory.py`.

Every comparison is exact: the native executor's run, the six chips'
traces (and ProgramAirV1's preprocessed ROM), the `serialize_air` streams,
and a `fast_test_config()` machine proof equal in every field but `stat`
(the reference proves on its host numpy path), which each package's
verifier accepts. A forged branch direction, a forged load value and a
proof checked against another program are rejected."""

import numpy as np
import pytest

from zkvm_prover_tpu.host import serialization as ref_ser
from zkvm_prover_tpu.models import rv32_v1 as ref_v1
from zkvm_prover_tpu.models.symbolic import serialize_air as ref_serialize_air
from zkvm_prover_tpu.stark import machine as ref_machine
from zkvm_prover_tpu.stark.config import fast_test_config as ref_fast_config
from zkvm_prover_tpu.vm import asm as ref_asm
from zkvm_prover_tpu_torch.host import serialization as ser
from zkvm_prover_tpu_torch.models import rv32_v0, rv32_v1
from zkvm_prover_tpu_torch.models.symbolic import serialize_air
from zkvm_prover_tpu_torch.stark import machine
from zkvm_prover_tpu_torch.stark.config import fast_test_config
from zkvm_prover_tpu_torch.vm import asm
from zkvm_prover_tpu_torch.vm.executor import HALTED

DATA = 0x1000


def fib_loop(a, n_iter=8):
    # the reference's `fib_loop_program`: fib(n_iter) into s0 by a BNE loop
    return a.assemble([
        a.addi("s0", "zero", 0),
        a.addi("s1", "zero", 1),
        a.addi("t0", "zero", n_iter),
        ("label", "loop"),
        a.add("t1", "s0", "s1"),
        a.add("s0", "s1", "zero"),
        a.add("s1", "t1", "zero"),
        a.addi("t0", "t0", -1),
        ("branch", a.bne, "t0", "zero", "loop"),
        a.halt(0),
    ])


def branch_both(a):
    # a taken BEQ and a BNE that falls through
    return a.assemble([
        a.addi("t0", "zero", 1),
        a.addi("t1", "zero", 1),
        ("branch", a.beq, "t0", "t1", "eq_path"),
        a.addi("t2", "zero", 99),
        ("label", "eq_path"),
        ("branch", a.bne, "t0", "t1", "never"),
        a.addi("t3", "zero", 7),
        ("label", "never"),
        a.halt(0),
    ])


def jal_lui(a):
    return a.assemble([
        a.lui("t0", 0x12345),
        ("jal", "ra", "after"),
        a.addi("t1", "zero", 111),
        ("label", "after"),
        a.addi("t2", "zero", 5),
        a.halt(0),
    ])


def store_load(a):
    return a.assemble([
        a.lui("s2", DATA >> 12),
        a.addi("t0", "zero", 1234),
        a.sw("t0", "s2", 0),
        a.addi("t1", "zero", 777),
        a.sw("t1", "s2", 4),
        a.lw("t2", "s2", 0),
        a.lw("t3", "s2", 4),
        a.add("t4", "t2", "t3"),
        a.halt(0),
    ])


def array_sum(a):
    # store 1..5 above DATA, then load and sum them in a loop
    return a.assemble([
        a.lui("s2", DATA >> 12),
        a.addi("t0", "zero", 1),
        a.addi("t1", "zero", 0),
        ("label", "fill"),
        a.add("t6", "s2", "t1"),
        a.sw("t0", "t6", 0),
        a.addi("t0", "t0", 1),
        a.addi("t1", "t1", 4),
        a.addi("t2", "zero", 20),
        ("branch", a.bne, "t1", "t2", "fill"),
        a.addi("s0", "zero", 0),
        a.addi("t1", "zero", 0),
        ("label", "sum"),
        a.add("t6", "s2", "t1"),
        a.lw("t3", "t6", 0),
        a.add("s0", "s0", "t3"),
        a.addi("t1", "t1", 4),
        ("branch", a.bne, "t1", "t2", "sum"),
        a.halt(0),
    ])


PROGRAMS = {"fib_loop": fib_loop, "branch_both": branch_both, "jal_lui": jal_lui,
            "store_load": store_load, "array_sum": array_sum}
REGS = {"fib_loop": {"s0": 21},
        "branch_both": {"t2": 0, "t3": 7},
        "jal_lui": {"t0": 0x12345000, "t1": 0, "ra": 8},
        "store_load": {"t4": 1234 + 777},
        "array_sum": {"s0": 1 + 2 + 3 + 4 + 5}}
AIRS = ["CpuAirV1", "ProgramAirV1", "ExecBoundaryAir", "RamBoundaryAir",
        "MemoryBoundaryAir", "ByteTableAir"]


def _instances(pkg_machine, air_traces):
    return [pkg_machine.AirInstance(a, t, []) for a, t in air_traces]


def _prove(air_traces):
    return machine.prove_machine(_instances(machine, air_traces), fast_test_config(),
                                 device="cpu")


def _verify(air_traces, proof):
    return machine.verify_machine([a for a, _ in air_traces], proof, fast_test_config(),
                                  device="cpu")


@pytest.fixture(scope="module", params=list(PROGRAMS))
def run(request):
    """Both packages' execution, traces and proof of one program."""
    name = request.param
    words = PROGRAMS[name](asm)
    assert words == PROGRAMS[name](ref_asm)
    ex, state, air_traces = rv32_v1.execute_and_trace(words)
    ref_ex, ref_state, ref_air_traces = ref_v1.execute_and_trace(words)
    proof = _prove(air_traces)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_machine, "_DEVICE_MIN_ELEMS", 1 << 62)
        ref_proof = ref_machine.prove_machine(_instances(ref_machine, ref_air_traces),
                                              ref_fast_config())
    return dict(name=name, words=words, ex=ex, state=state, air_traces=air_traces,
                ref_ex=ref_ex, ref_state=ref_state, ref_air_traces=ref_air_traces,
                proof=proof, ref_proof=ref_proof)


def test_execution_matches_semantics(run):
    assert run["state"] == run["ref_state"] == HALTED
    for reg, val in REGS[run["name"]].items():
        assert run["ex"].get_reg(asm.REGS[reg]) == val
        assert run["ref_ex"].get_reg(ref_asm.REGS[reg]) == val


def test_traces_equal_reference(run):
    assert [type(a).__name__ for a, _ in run["air_traces"]] == \
        [type(a).__name__ for a, _ in run["ref_air_traces"]] == AIRS
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


def test_heights_are_powers_of_two(run):
    for a, t in run["air_traces"]:
        n = t.shape[0]
        assert n >= 4 and n & (n - 1) == 0, type(a).__name__
    ram = run["air_traces"][3][1]
    R = rv32_v1.RamBoundaryAir
    real = ram[ram[:, R.IS_REAL] == 1]
    addrs = [sum(int(v) << (8 * k) for k, v in enumerate(row[R.ADDR:R.ADDR + 4]))
             for row in real]
    assert addrs == sorted(addrs) and all(x >= DATA for x in addrs)


def test_decode_and_constants_equal_reference(run):
    assert (rv32_v1.PROGRAM_BUS, rv32_v1.EXEC_BUS, rv32_v1.MEM_BUS, rv32_v1.TS_STRIDE,
            rv32_v1.N_FLAGS) == (ref_v1.PROGRAM_BUS, ref_v1.EXEC_BUS, ref_v1.MEM_BUS,
                                 ref_v1.TS_STRIDE, ref_v1.N_FLAGS) == (14, 15, 16, 5, 9)
    assert (rv32_v1.K_ADDI, rv32_v1.K_BEQ, rv32_v1.K_JAL, rv32_v1.K_LW, rv32_v1.K_SW) == \
        (ref_v1.K_ADDI, ref_v1.K_BEQ, ref_v1.K_JAL, ref_v1.K_LW, ref_v1.K_SW)
    assert (rv32_v1.BYTE_BUS, rv32_v1.REG_BUS) == (rv32_v0.BYTE_BUS, rv32_v0.REG_BUS)
    for w in run["words"][:-1]:
        assert rv32_v1.decode_v1(w) == ref_v1.decode_v1(w)
    with pytest.raises(ValueError):
        rv32_v1.decode_v1(run["words"][-1])   # the halt ecall is not v1


def test_proof_equals_reference_and_cross_verifies(run):
    assert ser.encode_machine_proof(run["proof"]) == \
        ref_ser.encode_machine_proof(run["ref_proof"])
    assert _verify(run["air_traces"], run["proof"])
    ported = ser.decode_machine_proof(ref_ser.encode_machine_proof(run["ref_proof"]))
    assert _verify(run["air_traces"], ported)
    ref_airs = [a for a, _ in run["ref_air_traces"]]
    back = ref_ser.decode_machine_proof(ser.encode_machine_proof(run["proof"]))
    assert ref_machine.verify_machine(ref_airs, back, ref_fast_config())


def test_loop_multiplicities_counted(run):
    """The ROM's receive multiplicities count each instruction's executions."""
    prog = run["air_traces"][1][1][:, rv32_v1.ProgramAirV1.MULT].astype(np.int64)
    cpu = run["air_traces"][0][1]
    C = rv32_v1.CpuAirV1
    real = cpu[cpu[:, C.IS_REAL] == 1]
    assert int(prog.sum()) == len(real)
    if run["name"] == "fib_loop":
        assert prog.max() == 8


def test_record_cut_at_the_halt_tail():
    """`execute_and_trace` keeps the records up to the first non-v1 one:
    the halt's two ADDIs stay, its ECALL goes."""
    words = fib_loop(asm, 3)
    ex, _, air_traces = rv32_v1.execute_and_trace(words)
    C = rv32_v1.CpuAirV1
    cpu = air_traces[0][1]
    n_real = int(cpu[:, C.IS_REAL].sum())
    assert n_real == 3 + 5 * 3 + 2 == len(ex.records()) - 1
    assert int(air_traces[2][1][3, rv32_v1.ExecBoundaryAir.FIN_PC]) == 4 * (len(words) - 1)


def test_reject_forged_branch_direction():
    """The fib loop's first BNE made to fall through: the execution bus
    refuses the broken chain."""
    _, _, air_traces = rv32_v1.execute_and_trace(fib_loop(asm))
    C = rv32_v1.CpuAirV1
    cpu_air, cpu = air_traces[0]
    cpu = cpu.copy()
    r = int(np.nonzero(cpu[:, C.FLAGS + rv32_v1.K_BNE])[0][0])
    cpu[r, C.IS_TAKEN] = 0
    cpu[r, C.NEXT_PC] = int(cpu[r, C.PC]) + 4
    forged = [(cpu_air, cpu)] + air_traces[1:]
    assert not _verify(forged, _prove(forged))


def test_reject_forged_load_value():
    """A LW claiming another value than the one stored: the RAM chain
    catches it."""
    words = asm.assemble([
        asm.lui("s2", DATA >> 12),
        asm.addi("t0", "zero", 42),
        asm.sw("t0", "s2", 0),
        asm.lw("t1", "s2", 0),
        asm.halt(0),
    ])
    _, _, air_traces = rv32_v1.execute_and_trace(words)
    C = rv32_v1.CpuAirV1
    cpu_air, cpu = air_traces[0]
    cpu = cpu.copy()
    r = int(np.nonzero(cpu[:, C.FLAGS + rv32_v1.K_LW])[0][0])
    cpu[r, C.RD_VAL] = 43
    forged = [(cpu_air, cpu)] + air_traces[1:]
    assert not _verify(forged, _prove(forged))


def test_reject_wrong_program(run):
    """The ROM is preprocessed (verifying-key material): a proof of one
    program does not verify against another."""
    other = list(run["words"])
    other[0] = asm.assemble([asm.addi("t5", "zero", 3)])[0]
    airs = [a for a, _ in run["air_traces"]]
    airs_b = list(airs)
    airs_b[1] = rv32_v1.ProgramAirV1(other)
    assert not machine.verify_machine(airs_b, run["proof"], fast_test_config(), device="cpu")
    assert machine.verify_machine(airs, run["proof"], fast_test_config(), device="cpu")
