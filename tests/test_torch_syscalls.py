"""The port's extension-syscall chips (the modular, EC, fp2, SHA-256 and
deferral chips of the rv32 machine) against the JAX package.

Every program of the reference's `tests/test_vm_ext_syscalls.py` and
`tests/test_deferral_vm.py`, the six minimal programs (one per syscall
family), the reference's end-to-end ext guest with ec_double, fp2 and defer
added, and the ECDSA-verify guest at 16-bit scalars run through both
packages: the assembled words, the executors' records and final state,
every AIR's trace (every table, the byte and range tables too) and public
values, and every AIR's `serialize_air` stream (the vk material) must be
equal; the port's `debug.check_constraints` and `check_bus_balance` must be
clean; the forged-result cases must break in both. The chip-level cases of
the reference's `test_bigint_air.py`, `test_ec_air.py` and
`test_sha256_air.py` are held the same way. Each new AIR's constraints and
logUp interactions stay within MAX_DEGREE = 3 (the machine's quotient split
at blowup 2).

The whole ext guest's proof (both packages, TINY: 2 queries) runs under
the `slow` marker: equal in every field but `stat`, each verifier accepts
the other's proof and both reject a tampered public value."""

import copy
import hashlib
import struct

import numpy as np
import pytest

import test_bigint_air as ref_bigint_tests
import test_sha256_air as ref_sha_tests
from zkvm_prover_tpu.models import bigint_air as ref_bigint
from zkvm_prover_tpu.models import deferral_vm as ref_deferral
from zkvm_prover_tpu.models import ec_air as ref_ec
from zkvm_prover_tpu.models import ec_double as ref_ec_double
from zkvm_prover_tpu.models import fp2_vm as ref_fp2
from zkvm_prover_tpu.models import rv32_v2 as ref_rv32_v2
from zkvm_prover_tpu.models import sha256_air as ref_sha_air
from zkvm_prover_tpu.models import sha256_vm as ref_sha_vm
from zkvm_prover_tpu.models import symbolic as ref_symbolic
from zkvm_prover_tpu.models import vm_ext as ref_vm_ext
from zkvm_prover_tpu.stark import debug as ref_debug
from zkvm_prover_tpu.stark import machine as ref_machine
from zkvm_prover_tpu.stark.config import StarkConfig as RefStarkConfig
from zkvm_prover_tpu.stark.fri import FriConfig as RefFriConfig
from zkvm_prover_tpu.types.chunk.crypto.weierstrass import SECP256K1 as REF_K1
from zkvm_prover_tpu.vm import asm as ref_asm
from zkvm_prover_tpu.vm import executor as ref_executor
from zkvm_prover_tpu_torch.convert import machine_proof_from_numpy
from zkvm_prover_tpu_torch.models import (bigint_air, deferral_vm, ec_air, ec_double, fp2_vm,
                                          rv32_v2, sha256_air, sha256_vm, symbolic, vm_ext)
from zkvm_prover_tpu_torch.models.air import MAX_DEGREE, Air, AirBuilder
from zkvm_prover_tpu_torch.models.rv32_v0 import ByteTableAir
from zkvm_prover_tpu_torch.ops.keccak import keccak256
from zkvm_prover_tpu_torch.stark import debug, machine
from zkvm_prover_tpu_torch.stark.config import StarkConfig
from zkvm_prover_tpu_torch.stark.fri import FriConfig
from zkvm_prover_tpu_torch.vm import asm, executor, guests

from test_torch_stark import assert_proofs_equal

BASE = 0x3000
MODULI = bigint_air.SUPPORTED_MODULI
G = guests.SECP256K1_G
K1_P = guests.SECP256K1_P


def _k1_mul(k, pt=G):
    return guests.ec_mul_affine(k, pt)


# ---------------------------------------------------------------------------
# the programs, each assembled by either package's `asm` (module `A`)
# ---------------------------------------------------------------------------


def _store256(A, val, addr):
    out = []
    for i in range(8):
        out += A.li("t0", (val >> (32 * i)) & 0xFFFFFFFF)
        out += A.li("t1", addr + 4 * i)
        out.append(A.sw("t0", "t1", 0))
    return out


def _store_point(A, pt, addr):
    return _store256(A, pt[0], addr) + _store256(A, pt[1], addr + 32)


def _reveal_word(A, addr, idx):
    return A.li("t1", addr) + [A.lw("t0", "t1", 0)] + A.reveal("t0", idx)


def _load256(ex, addr):
    return sum(ex.load_mem32(addr + 4 * i) << (32 * i) for i in range(8))


def _modop_program(A, mi):
    m = MODULI[mi]
    x = (0x123456789ABCDEF0 * (mi + 1) ** 7 + 12345) % m
    y = (0xFEDCBA9876543210 * (mi + 3) ** 9 + 999) % m
    body = _store256(A, x, BASE) + _store256(A, y, BASE + 32)
    body += A.modop(BASE + 64, BASE, BASE + 32, A.MODOP_MUL, mi)
    body += A.modop(BASE + 96, BASE, BASE + 32, A.MODOP_ADD, mi)
    body += A.modop(BASE + 128, BASE, BASE + 32, A.MODOP_SUB, mi)
    for j, off in enumerate((64, 96, 128)):
        body += _reveal_word(A, BASE + off, j)
    body += A.halt(0)

    def check(ex):
        assert ex.public_values()[:3] == [v & 0xFFFFFFFF for v in
                                          (x * y % m, (x + y) % m, (x - y) % m)]
    return A.assemble(body), check


def _moddiv_program(A, mi):
    m = MODULI[mi]
    x = (0xDEADBEEFCAFE1234 * (mi + 2) ** 11 + 7) % m
    y = (0x123456789ABCDEF * (mi + 5) ** 13 + 3) % m
    body = _store256(A, x, BASE) + _store256(A, y, BASE + 32)
    body += A.modop(BASE + 64, BASE, BASE + 32, A.MODOP_DIV, mi)
    body += _reveal_word(A, BASE + 64, 0)
    body += A.halt(0)

    def check(ex):
        assert ex.public_values()[0] == x * pow(y, -1, m) % m & 0xFFFFFFFF
    return A.assemble(body), check


def _ec_add_program(A):
    g2 = _k1_mul(2)
    body = _store_point(A, G, BASE) + _store_point(A, g2, BASE + 64)
    body += A.ec_add(BASE + 128, BASE, BASE + 64, 2)
    body += _reveal_word(A, BASE + 128, 0)
    body += A.halt(0)

    def check(ex):
        assert (_load256(ex, BASE + 128), _load256(ex, BASE + 160)) == _k1_mul(3)
    return A.assemble(body), check


def _ec_double_program(A):
    body = _store_point(A, G, BASE) + A.ec_double(BASE + 64, BASE, 2)
    body += _reveal_word(A, BASE + 64, 0)
    body += A.halt(0)

    def check(ex):
        assert (_load256(ex, BASE + 64), _load256(ex, BASE + 96)) == _k1_mul(2)
    return A.assemble(body), check


def _double_then_add_program(A):
    body = _store_point(A, G, BASE)
    body += A.ec_double(BASE + 64, BASE, 2)
    body += A.ec_add(BASE + 128, BASE + 64, BASE, 2)
    body += A.halt(0)

    def check(ex):
        assert (_load256(ex, BASE + 128), _load256(ex, BASE + 160)) == _k1_mul(3)
    return A.assemble(body), check


def _fp2_program(A, mi):
    m = MODULI[mi]
    x0, x1 = 0xAAA1 * 3**40 % m, 0xBBB2 * 5**33 % m
    y0, y1 = 0xCCC3 * 7**29 % m, 0xDDD4 * 11**23 % m
    body = (_store256(A, x0, BASE) + _store256(A, x1, BASE + 32)
            + _store256(A, y0, BASE + 64) + _store256(A, y1, BASE + 96))
    body += A.fp2op(BASE + 128, BASE, BASE + 64, A.FP2_MUL, mi)
    body += A.fp2op(BASE + 192, BASE, BASE + 64, A.FP2_ADD, mi)
    body += A.fp2op(BASE + 256, BASE, BASE + 64, A.FP2_SUB, mi)
    for j, off in enumerate((128, 192, 256)):
        body += _reveal_word(A, BASE + off, j)
        body += _reveal_word(A, BASE + off + 32, j + 3)
    body += A.halt(0)

    def check(ex):
        want = [(x0 * y0 - x1 * y1) % m, (x0 + y0) % m, (x0 - y0) % m,
                (x0 * y1 + x1 * y0) % m, (x1 + y1) % m, (x1 - y1) % m]
        assert ex.public_values()[:6] == [v & 0xFFFFFFFF for v in want]
    return A.assemble(body), check


SHA_MESSAGES = {"empty": b"", "short": b"sha256 on tpu!", "fit-55": b"\xab" * 55,
                "spill-56": b"\xcd" * 56, "exact-64": b"\x11" * 64,
                "three-block": b"\x22" * 150}


def _sha_program(A, msg):
    body = []
    padded = msg + b"\0" * (-len(msg) % 4)
    for i in range(0, len(padded), 4):
        body += A.li("t0", int.from_bytes(padded[i : i + 4], "little"))
        body += A.li("t1", BASE + i)
        body.append(A.sw("t0", "t1", 0))
    body += A.sha256(BASE, len(msg), BASE + 0x400)
    for i in range(8):
        body += _reveal_word(A, BASE + 0x400 + 4 * i, i)
    body += A.halt(0)

    def check(ex):
        digest = b"".join(int(w).to_bytes(4, "little") for w in ex.public_values())
        assert digest == hashlib.sha256(msg).digest()
    return A.assemble(body), check


DEFER_LEAVES = [bytes(range(64)), bytes(range(100, 164)), b"\xAB" * 32 + b"\xCD" * 32]


def _defer_program(A, leaves=DEFER_LEAVES):
    body = []
    for i, leaf in enumerate(leaves):
        base = BASE + 64 * i
        for j in range(0, 64, 4):
            body += A.li("t0", int.from_bytes(leaf[j : j + 4], "little"))
            body += A.li("t1", base + j)
            body.append(A.sw("t0", "t1", 0))
        body += A.defer_verify(base)
    body.append(A.halt(0))
    return A.assemble(body), lambda ex: None


def _ext_guest_program(A):
    """The reference's `test_prove_verify_ext_guest` guest (modop, ec_add,
    sha256 of the sum) with an ec_double, an fp2 MUL and a defer added."""
    g2 = _k1_mul(2)
    body = _store256(A, G[0], BASE) + _store256(A, G[1], BASE + 32)
    body += A.modop(BASE + 64, BASE, BASE + 32, A.MODOP_MUL, 2)
    body += _store_point(A, G, BASE + 128) + _store_point(A, g2, BASE + 192)
    body += A.ec_add(BASE + 256, BASE + 128, BASE + 192, 2)
    body += A.sha256(BASE + 256, 64, BASE + 0x400)
    body += _reveal_word(A, BASE + 0x400, 0)
    body += A.ec_double(BASE + 0x440, BASE + 128, 2)
    body += A.fp2op(BASE + 0x480, BASE, BASE + 128, A.FP2_MUL, 2)
    body += A.defer_verify(BASE + 0x440)
    body += A.halt(0)

    def check(ex):
        x3y3 = b"".join(ex.load_mem32(BASE + 256 + 4 * i).to_bytes(4, "little")
                        for i in range(16))
        expect = hashlib.sha256(x3y3).digest()
        assert ex.public_values()[0] == int.from_bytes(expect[:4], "little")
        assert (_load256(ex, BASE + 0x440), _load256(ex, BASE + 0x460)) == g2
    return A.assemble(body), check


# the six programs that named each syscall family before the chips were
# ported (zero operands where none is stored)
MINIMAL = {
    "sha256": lambda A: A.assemble(_sha_program(A, b"sha256 on tpu!")[0]),
    "modop": lambda A: A.assemble(A.modop(BASE + 0x100, BASE, BASE + 0x40, A.MODOP_ADD, 0)
                                  + A.halt(0)),
    "ec_add": lambda A: A.assemble([*A.li("t0", 1), *A.li("t1", BASE), A.sw("t0", "t1", 0)]
                                   + A.ec_add(BASE + 0x200, BASE, BASE + 0x80, 0) + A.halt(0)),
    "ec_double": lambda A: A.assemble([*A.li("t0", 1), *A.li("t1", BASE + 32),
                                       A.sw("t0", "t1", 0)]
                                      + A.ec_double(BASE + 0x200, BASE, 0) + A.halt(0)),
    "defer": lambda A: A.assemble(A.defer_verify(BASE) + A.halt(0)),
    "fp2": lambda A: A.assemble(A.fp2op(BASE + 0x100, BASE, BASE + 0x80, A.FP2_ADD, 0)
                                + A.halt(0)),
}


def _ecdsa_program(A):
    """The ECDSA-verify guest at 16-bit scalars (the port's builder; its
    words reassemble alike with either package's `asm`)."""
    words, info = guests.ecdsa_verify_program(seed=3, scalar_bits=16)

    def check(ex):
        x = sum(w << (32 * i) for i, w in enumerate(ex.public_values()))
        assert x == info["R"][0] and x % guests.SECP256K1_N == info["r"]
        assert ex.exit_code == 0
        a = info["addr"]
        q = b"".join(v.to_bytes(32, "little") for v in info["Q"])
        assert (b"".join(ex.load_mem32(a["keccak"] + 4 * i).to_bytes(4, "little")
                         for i in range(8)) == keccak256(q))
        assert (b"".join(ex.load_mem32(a["sha"] + 4 * i).to_bytes(4, "little")
                         for i in range(8)) == hashlib.sha256(info["msg"]).digest())
    return words, check


PROGRAMS = {
    **{f"modop_m{mi}": (lambda A, mi=mi: _modop_program(A, mi)) for mi in range(len(MODULI))},
    **{f"moddiv_m{mi}": (lambda A, mi=mi: _moddiv_program(A, mi)) for mi in (0, 2, 5)},
    "ec_add": _ec_add_program,
    "ec_double": _ec_double_program,
    "ec_double_then_add": _double_then_add_program,
    **{f"fp2_m{mi}": (lambda A, mi=mi: _fp2_program(A, mi)) for mi in (0, 1)},
    **{f"sha256_{k}": (lambda A, k=k: _sha_program(A, SHA_MESSAGES[k])) for k in SHA_MESSAGES},
    "defer_chain": _defer_program,
    **{f"minimal_{k}": (lambda A, k=k: (MINIMAL[k](A), lambda ex: None)) for k in MINIMAL},
    "ext_guest": _ext_guest_program,
    "ecdsa_16": _ecdsa_program,
}


def _execute(ex_module, traces_module, words, data_base):
    ex = ex_module.Rv32Executor()
    ex.load_program(words)
    state = ex.run(1 << 16)
    return ex, {"state": state, "cycles": ex.cycles, "pc": ex.pc, "exit_code": ex.exit_code,
                "regs": [ex.get_reg(r) for r in range(32)], "pvs": ex.public_values(),
                "records": ex.records(),
                "traces": traces_module.generate_traces(words, ex.records(),
                                                        data_base=data_base)}


@pytest.fixture(scope="module")
def runs():
    """program -> (reference words, port words, reference run, port run);
    the port's executor runs the guest's own checks."""
    out = {}
    for name, make in PROGRAMS.items():
        ref_words, _ = make(ref_asm)
        words, check = make(asm)
        data_base = guests.ECDSA_BASE if name == "ecdsa_16" else BASE
        _, ref_run = _execute(ref_executor, ref_rv32_v2, ref_words, data_base)
        ex, run = _execute(executor, rv32_v2, words, data_base)
        run["check"] = lambda check=check, ex=ex: check(ex)
        out[name] = (ref_words, words, ref_run, run)
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
    np.testing.assert_array_equal(port["records"], ref["records"])
    port["check"]()


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_traces_equal(runs, name):
    """Every AIR in order, every table included: the fill functions share
    the RAM, byte, range and xor state, so one reordered update shows in the
    tables even where the chip's own trace is equal."""
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


def _air_key(air):
    return type(air).__name__, air.width, getattr(air, "log_n", None)


@pytest.fixture(scope="module")
def distinct_airs(runs):
    """(reference AIR, port AIR) per distinct AIR of every program."""
    out = {}
    for _, _, ref, port in runs.values():
        for (ref_air, _, _), (air, _, _) in zip(ref["traces"], port["traces"]):
            if type(air).__name__ != "ProgramAirV2":
                out.setdefault(_air_key(air), (ref_air, air))
    return out


NEW_AIRS = ["BigIntModMulAir", "EcAddAir", "EcDoubleAir", "ModularVmAir", "EcVmAir",
            "EcDoubleVmAir", "Fp2VmAir", "Sha256Air", "Sha256VmAir", "DeferralVmAir",
            "Poseidon2Air"]


@pytest.mark.parametrize("name", NEW_AIRS)
def test_serialize_air_equal(distinct_airs, name):
    """The felt stream the vk hashes: every constraint, constant, selector
    use and bus interaction (each Sha256Air height once)."""
    pairs = [p for key, p in distinct_airs.items() if key[0] == name]
    assert pairs
    for ref_air, air in pairs:
        assert symbolic.serialize_air(air) == ref_symbolic.serialize_air(ref_air)


def test_serialize_air_equal_for_the_programs(runs):
    """ProgramAirV2 (preprocessed ROM) of every program, and every other AIR
    the programs add."""
    for _, _, ref, port in runs.values():
        for (ref_air, _, _), (air, _, _) in zip(ref["traces"], port["traces"]):
            if type(air).__name__ == "ProgramAirV2" or type(air).__name__ not in NEW_AIRS:
                assert symbolic.serialize_air(air) == ref_symbolic.serialize_air(ref_air)


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_constraints_and_buses_clean(runs, name):
    traces = runs[name][3]["traces"]
    for air, tr, p in traces:
        errs = debug.check_constraints(air, tr, p)
        assert errs == [], (type(air).__name__, errs[:4])
    bal = debug.check_bus_balance([(a, t) for a, t, _ in traces],
                                  {i: p for i, (_, _, p) in enumerate(traces)})
    assert bal == {}, sorted(bal)[:4]


def test_defer_public_values_are_the_chain_digest(runs):
    for name, leaves in (("defer_chain", DEFER_LEAVES),
                         ("ecdsa_16", guests.ecdsa_verify_program(3, 16)[1]["leaves"])):
        pvs = next(p for a, _, p in runs[name][3]["traces"]
                   if isinstance(a, deferral_vm.DeferralVmAir))
        expect = deferral_vm.chain_digest_from_leaves(leaves)
        assert [int(v) for v in pvs] == [int(v) for v in expect]
        np.testing.assert_array_equal(expect, ref_deferral.chain_digest_from_leaves(leaves))


def test_ecdsa_guest_sizes():
    """The 256-bit guest as the card's phase builds it: every extension
    family once or more, about 510 doublings and 256 additions, the data
    above the program image."""
    words, info = guests.ecdsa_verify_program(seed=0)
    assert 4 * len(words) <= guests.ECDSA_BASE
    assert 490 <= info["ec_doubles"] <= 510 and 200 <= info["ec_adds"] <= 300
    u1, u2 = info["u1"], info["u2"]
    assert u1 == info["z"] * pow(info["s"], -1, guests.SECP256K1_N) % guests.SECP256K1_N
    assert u2 == info["r"] * pow(info["s"], -1, guests.SECP256K1_N) % guests.SECP256K1_N
    k = pow(info["s"], -1, guests.SECP256K1_N) * (info["z"] + info["r"] * info["d"])
    assert _k1_mul(k % guests.SECP256K1_N)[0] % guests.SECP256K1_N == info["r"]


def test_curve_helpers_match_the_reference_curve():
    assert G == REF_K1.generator()
    for k in (2, 3, 5, 0xDEADBEEF, guests.SECP256K1_N - 1):
        assert _k1_mul(k) == REF_K1.mul(k, REF_K1.generator())


# ---------------------------------------------------------------------------
# forged results: broken in the port as in the reference
# ---------------------------------------------------------------------------


def _broken(dbg, traces, i, bad, pvs=None):
    air, _, p = traces[i]
    p = p if pvs is None else pvs
    return (dbg.check_constraints(air, bad, p) != []
            or dbg.check_bus_balance(
                [(a, t if j != i else bad) for j, (a, t, _) in enumerate(traces)],
                {j: (q if j != i else p) for j, (_, _, q) in enumerate(traces)}) != {})


def _forge_flip(col_of):
    def forge(module, tr):
        bad = tr.copy()
        row, col = col_of(module, bad)
        bad[row, col] ^= 1
        return bad
    return forge


def _forge_block_aligned(module, tr):
    bad = tr.copy()
    assert bad[1, module.HAS_END] == 1 and bad[0, module.HAS_END] == 0
    bad[0, module.HAS_END], bad[1, module.HAS_END] = 1, 0
    bad[1, module.ABS] = 0
    return bad


def _forge_skipped_terminator(module, tr):
    bad = tr.copy()
    bad[int(np.nonzero(bad[:, module.HAS_END])[0][0]), module.HAS_END] = 0
    return bad


def _forge_noncanonical(module, tr):
    """modadd with q = 0 writes x + y >= m: the greedy borrow-chain witness
    for m - 1 - r needs a final borrow the chain cannot emit."""
    m = MODULI[0]
    bad = tr.copy()
    forged, c = (m - 5) + (m - 3), 1
    for k in range(module.N_LIMBS):
        bad[0, module.RES + k] = (forged >> (8 * k)) & 0xFF
        t = ((m >> (8 * k)) & 0xFF) - int(bad[0, module.RES + k]) - c
        c = 1 if t < 0 else 0
        bad[0, module.CMP_D + k] = t + 256 if t < 0 else t
        if k < module.N_LIMBS - 1:
            bad[0, module.CMP_BW + k] = c
    assert c == 1
    return bad


def _modop_add_near_m(A):
    m = MODULI[0]
    body = _store256(A, m - 5, BASE) + _store256(A, m - 3, BASE + 32)
    body += A.modop(BASE + 64, BASE, BASE + 32, A.MODOP_ADD, 0)
    return A.assemble(body + A.halt(0))


def _single_op(op):
    def make(A):
        body = _store256(A, 123456789, BASE) + _store256(A, 987654321, BASE + 32)
        return A.assemble(body + op(A) + A.halt(0))
    return make


def _fp2_mul(A):
    body = (_store256(A, 123, BASE) + _store256(A, 456, BASE + 32)
            + _store256(A, 789, BASE + 64) + _store256(A, 321, BASE + 96))
    return A.assemble(body + A.fp2op(BASE + 128, BASE, BASE + 64, A.FP2_MUL, 0) + A.halt(0))


# case -> (program(A), module attribute holding the AIR class and the
# forging function's module, forge(module, trace), pvs or None)
FORGED = {
    "modop_result": (_single_op(lambda A: A.modop(BASE + 64, BASE, BASE + 32, A.MODOP_MUL, 0)),
                     ("vm_ext", "ModularVmAir"), _forge_flip(lambda m, t: (0, m.RES))),
    "modop_noncanonical_result": (_modop_add_near_m, ("vm_ext", "ModularVmAir"),
                                  _forge_noncanonical),
    "ec_add_coordinate": (lambda A: _ec_add_program(A)[0], ("vm_ext", "EcVmAir"),
                          _forge_flip(lambda m, t: (0, m.E_RES))),
    "ec_double_result": (lambda A: _ec_double_program(A)[0], ("vm_ext", "EcDoubleVmAir"),
                         _forge_flip(lambda m, t: (0, m.D_RES))),
    "fp2_result": (_fp2_mul, ("fp2_vm", "Fp2VmAir"), _forge_flip(lambda m, t: (0, m.RES))),
    "sha256_digest": (lambda A: _sha_program(A, b"forge me")[0], ("sha256_vm", "Sha256VmAir"),
                      _forge_flip(lambda m, t: (int(np.nonzero(t[:, m.IS_LAST])[0][0]), m.DIG))),
    "sha256_block_aligned": (lambda A: _sha_program(A, b"\x11" * 64)[0],
                             ("sha256_vm", "Sha256VmAir"), _forge_block_aligned),
    "sha256_skipped_terminator": (lambda A: _sha_program(A, b"no terminator")[0],
                                  ("sha256_vm", "Sha256VmAir"), _forge_skipped_terminator),
    "defer_leaf": (lambda A: _defer_program(A, [bytes(range(64))])[0],
                   ("deferral_vm", "DeferralVmAir"), _forge_flip(lambda m, t: (0, m.RDP + 3))),
    "defer_public_value": (lambda A: _defer_program(A, [bytes(64)])[0],
                           ("deferral_vm", "DeferralVmAir"), None),
}
PACKAGES = {"reference": ({"vm_ext": ref_vm_ext, "fp2_vm": ref_fp2, "sha256_vm": ref_sha_vm,
                           "deferral_vm": ref_deferral},
                          ref_asm, ref_executor, ref_rv32_v2, ref_debug),
            "port": ({"vm_ext": vm_ext, "fp2_vm": fp2_vm, "sha256_vm": sha256_vm,
                      "deferral_vm": deferral_vm},
                     asm, executor, rv32_v2, debug)}


@pytest.mark.parametrize("case", sorted(FORGED))
def test_forged_results_break_in_both(case):
    make, (mod_name, cls_name), forge = FORGED[case]
    for package, (mods, A, ex_module, traces_module, dbg) in PACKAGES.items():
        module = mods[mod_name]
        _, run = _execute(ex_module, traces_module, make(A), BASE)
        traces = run["traces"]
        i = next(j for j, (a, _, _) in enumerate(traces)
                 if isinstance(a, getattr(module, cls_name)))
        air, tr, pvs = traces[i]
        if forge is None:       # a claimed digest other than the chain's
            bad_pvs = list(pvs)
            bad_pvs[0] ^= 1
            assert dbg.check_constraints(air, tr, bad_pvs) != [], package
        elif case in ("modop_noncanonical_result", "sha256_block_aligned",
                      "sha256_skipped_terminator"):
            assert dbg.check_constraints(air, forge(module, tr), pvs) != [], package
        else:
            assert _broken(dbg, traces, i, forge(module, tr)), package


def test_defer_reordered_rows_change_digest():
    l1, l2 = bytes(range(64)), bytes(range(64, 128))
    a, b = (deferral_vm.chain_digest_from_leaves(x) for x in ([l1, l2], [l2, l1]))
    assert not np.array_equal(a, b)
    np.testing.assert_array_equal(a, ref_deferral.chain_digest_from_leaves([l1, l2]))


def test_moddiv_by_zero_traps_in_both():
    for A, ex_module in ((ref_asm, ref_executor), (asm, executor)):
        body = _store256(A, 5, BASE) + _store256(A, 0, BASE + 32)
        body += A.modop(BASE + 64, BASE, BASE + 32, A.MODOP_DIV, 0) + A.halt(0)
        ex = ex_module.Rv32Executor()
        ex.load_program(A.assemble(body))
        assert ex.run(1 << 15) == ex_module.TRAPPED


# ---------------------------------------------------------------------------
# the chips on their own (the reference's chip-level tests)
# ---------------------------------------------------------------------------


class _ModmulRequestAir(Air):
    """Sends modmul requests (the extension-user side)."""

    width = 1 + 5 * 32

    def eval(self, b: AirBuilder) -> None:
        real = b.local(0)
        b.assert_bool(real)
        b.push_send(bigint_air.MODMUL_BUS, [b.local(1 + i) for i in range(5 * 32)], real)


class _EcAddRequestAir(Air):
    width = 1 + 7 * 32

    def eval(self, b: AirBuilder) -> None:
        real = b.local(0)
        b.assert_bool(real)
        b.push_send(ec_air.EC_ADD_BUS, [b.local(1 + i) for i in range(7 * 32)], real)


class _ShaQueryAir(Air):
    width = 65

    def eval(self, b: AirBuilder) -> None:
        real = b.local(0)
        b.assert_bool(real)
        b.push_send(sha256_air.SHA256_BUS, [b.local(1 + i) for i in range(64)], real)


def _requests(messages, width):
    n = max(4, 1 << (len(messages) - 1).bit_length())
    t = np.zeros((n, width), dtype=np.uint32)
    for r, msg in enumerate(messages):
        t[r, 0] = 1
        t[r, 1:] = msg
    return t


def _byte_table(counts):
    t = np.zeros((256, 2), dtype=np.uint32)
    t[:, ByteTableAir.VALUE] = np.arange(256)
    t[:, ByteTableAir.MULT] = counts.astype(np.uint32)
    return t


def _clean(pairs):
    for air, tr in pairs:
        assert debug.check_constraints(air, tr, []) == [], type(air).__name__
    assert debug.check_bus_balance(pairs, {}) == {}


def test_bigint_chip_equals_reference():
    ops = ref_bigint_tests._ops() + [(5, 1, MODULI[0] - 9, MODULI[0])]   # + modsub
    tr = bigint_air.BigIntModMulAir.generate_trace(ops)
    ref_tr = ref_bigint.BigIntModMulAir.generate_trace(ops)
    np.testing.assert_array_equal(tr, ref_tr)
    np.testing.assert_array_equal(bigint_air.BigIntModMulAir.byte_lookups(tr),
                                  ref_bigint.BigIntModMulAir.byte_lookups(ref_tr))
    np.testing.assert_array_equal(bigint_air.BigIntModMulAir.generate_trace([], 8),
                                  ref_bigint.BigIntModMulAir.generate_trace([], 8))
    msgs = [bigint_air.modmul_message(*op) for op in ops]
    assert msgs == [ref_bigint.modmul_message(*op) for op in ops]
    _clean([(bigint_air.BigIntModMulAir(), tr),
            (_ModmulRequestAir(), _requests(msgs, _ModmulRequestAir.width)),
            (ByteTableAir(), _byte_table(bigint_air.BigIntModMulAir.byte_lookups(tr)))])
    r = sum(int(tr[4, bigint_air.R_ + i]) << (8 * i) for i in range(32))
    assert r == (5 - 9) % MODULI[0]
    assert bigint_air.SUPPORTED_MODULI == ref_bigint.SUPPORTED_MODULI
    assert bigint_air.MODMUL_BUS == ref_bigint.MODMUL_BUS == 44


@pytest.mark.parametrize("what", ["result", "quotient"])
def test_bigint_forged_witness_fails_in_both(what):
    ops = ref_bigint_tests._ops()
    for module, dbg in ((bigint_air, debug), (ref_bigint, ref_debug)):
        bad = module.BigIntModMulAir.generate_trace(ops)
        if what == "result":
            bad[0, module.R_] ^= 1
        else:
            bad[1, module.Q] = (int(bad[1, module.Q]) + 1) % 256
        assert dbg.check_constraints(module.BigIntModMulAir(), bad, []) != []


def test_ec_add_chip_equals_reference():
    adds = [(G, _k1_mul(2), K1_P), (_k1_mul(2), _k1_mul(3), K1_P), (G, _k1_mul(5), K1_P)]
    tr, reqs = ec_air.EcAddAir.generate_trace(adds)
    ref_tr, ref_reqs = ref_ec.EcAddAir.generate_trace(adds)
    np.testing.assert_array_equal(tr, ref_tr)
    assert reqs == ref_reqs
    msgs = [ec_air.ec_add_message(*a) for a in adds]
    assert msgs == [ref_ec.ec_add_message(*a) for a in adds]
    x3 = sum(msgs[0][4 * 32 + i] << (8 * i) for i in range(32))
    y3 = sum(msgs[0][5 * 32 + i] << (8 * i) for i in range(32))
    assert (x3, y3) == _k1_mul(3)
    big = bigint_air.BigIntModMulAir.generate_trace(reqs)
    pairs = [(ec_air.EcAddAir(), tr), (bigint_air.BigIntModMulAir(), big),
             (ByteTableAir(), _byte_table(bigint_air.BigIntModMulAir.byte_lookups(big))),
             (_EcAddRequestAir(), _requests(msgs, _EcAddRequestAir.width))]
    _clean(pairs)
    bad = tr.copy()
    bad[0, ec_air._OFF["x3"]] ^= 1
    assert debug.check_bus_balance([(ec_air.EcAddAir(), bad), pairs[1]], {}) != {}
    ref_big = ref_bigint.BigIntModMulAir.generate_trace(ref_reqs)
    assert ref_debug.check_bus_balance([(ref_ec.EcAddAir(), bad),
                                        (ref_bigint.BigIntModMulAir(), ref_big)], {}) != {}


def test_ec_double_chip_equals_reference():
    dbls = [(G, K1_P), (_k1_mul(7), K1_P), ((1, 2), MODULI[0])]
    tr, reqs = ec_double.EcDoubleAir.generate_trace(dbls)
    ref_tr, ref_reqs = ref_ec_double.EcDoubleAir.generate_trace(dbls)
    np.testing.assert_array_equal(tr, ref_tr)
    assert reqs == ref_reqs
    assert ([ec_double.ec_double_message(*d) for d in dbls]
            == [ref_ec_double.ec_double_message(*d) for d in dbls])
    assert ec_double.EC_DBL_BUS == ref_ec_double.EC_DBL_BUS == 49


@pytest.mark.parametrize("which", ["ec_add_doubling", "ec_double_order_two"])
def test_ec_exclusions_raise_in_both(which):
    for add_mod, dbl_mod in ((ec_air, ec_double), (ref_ec, ref_ec_double)):
        with pytest.raises(AssertionError):
            if which == "ec_add_doubling":
                add_mod.EcAddAir.generate_trace([(G, G, K1_P)])
            else:
                dbl_mod.EcDoubleAir.generate_trace([((5, 0), K1_P)])


SHA_BLOCKS = [(sha256_air.H_INIT, ref_sha_tests._pad_one_block(b"abc")),
              (sha256_air.H_INIT, ref_sha_tests._pad_one_block(b"tpu sha256 chip"))]


def test_sha256_host_compress_matches_hashlib():
    for data in (b"", b"abc", b"a" * 55):
        msg = ref_sha_tests._pad_one_block(data)
        out = sha256_air.sha256_compress(sha256_air.H_INIT, msg)
        assert out == ref_sha_air.sha256_compress(ref_sha_air.H_INIT, msg)
        assert b"".join(struct.pack(">I", w) for w in out) == hashlib.sha256(data).digest()


@pytest.mark.parametrize("log_n,n_blocks", [(6, 1), (7, 2), (8, 2)])
def test_sha256_chip_equals_reference(log_n, n_blocks):
    """log_n 8 with 2 blocks pads two slots with zero-message compressions
    at multiplicity 0."""
    blocks = SHA_BLOCKS[:n_blocks]
    air, ref_air = sha256_air.Sha256Air(log_n), ref_sha_air.Sha256Air(log_n)
    tr = air.generate_trace(blocks, [1] * n_blocks)
    np.testing.assert_array_equal(tr, ref_air.generate_trace(blocks, [1] * n_blocks))
    np.testing.assert_array_equal(air.preprocessed_trace(), ref_air.preprocessed_trace())
    msgs = [sha256_air.sha256_message_limbs(h, m, sha256_air.sha256_compress(h, m))
            for h, m in blocks]
    assert msgs == [ref_sha_air.sha256_message_limbs(h, m, ref_sha_air.sha256_compress(h, m))
                    for h, m in blocks]
    _clean([(air, tr), (_ShaQueryAir(), _requests(msgs, _ShaQueryAir.width))])
    for p in range(n_blocks, 1 << (log_n - 6)):
        assert tr[p * 64 + 63, sha256_air.MULT] == 0


def test_sha256_tampered_trace_fails_in_both():
    blocks = SHA_BLOCKS[:1]
    for module, dbg in ((sha256_air, debug), (ref_sha_air, ref_debug)):
        air = module.Sha256Air(log_n=6)
        trace = air.generate_trace(blocks, [1])
        for row, col in ((63, module.H_OUT), (30, module.A_BITS + 5)):
            bad = trace.copy()
            bad[row, col] ^= 1
            assert dbg.check_constraints(air, bad, []) != []


# ---------------------------------------------------------------------------
# degree: every new AIR within MAX_DEGREE (constraints and logUp terms)
# ---------------------------------------------------------------------------


class _DegreeBuilder(AirBuilder):
    """Values are their degrees in units of the trace height n: a column
    counts 1, as do the first- and last-row selectors (degree n - 1); the
    transition selector, x - g^-1, counts 0."""

    def __init__(self):
        self._constraints, self._interactions = [], []
        self._sels = {"first": 1, "last": 1, "transition": 0}

    def local(self, col):
        return 1

    next = preprocessed = preprocessed_next = local

    def public_value(self, i):
        return 0

    def constant(self, v):
        return 0

    def add(self, a, b):
        return max(a, b)

    sub = add

    def mul(self, a, b):
        return a + b


@pytest.mark.parametrize("name", NEW_AIRS)
def test_new_air_degree_fits_the_quotient_split(distinct_airs, name):
    for _, air in (p for key, p in distinct_airs.items() if key[0] == name):
        b = _DegreeBuilder()
        air.eval(b)
        assert max(b.constraints) <= MAX_DEGREE
        for inter in b.interactions:
            # logUp: perm_j * (z - fingerprint(fields)) - mult
            assert max(1 + max(inter.fields), inter.mult) <= MAX_DEGREE


# ---------------------------------------------------------------------------
# the whole ext guest's proof (slow)
# ---------------------------------------------------------------------------

TINY = StarkConfig(fri=FriConfig(log_blowup=1, num_queries=2, proof_of_work_bits=2))
REF_TINY = RefStarkConfig(fri=RefFriConfig(log_blowup=1, num_queries=2, proof_of_work_bits=2))


def _reference_proof(air_traces, cfg):
    """The reference's machine proof on its host numpy path (the same proof
    as its JAX path, without the XLA compiles)."""
    saved = ref_machine._DEVICE_MIN_ELEMS
    ref_machine._DEVICE_MIN_ELEMS = 1 << 62
    try:
        return ref_machine.prove_machine(
            [ref_machine.AirInstance(a, t, p) for a, t, p in air_traces], cfg)
    finally:
        ref_machine._DEVICE_MIN_ELEMS = saved


def _tampered_public_value(airs, proof):
    bad = copy.deepcopy(proof)
    i = next(j for j, a in enumerate(airs) if type(a).__name__ == "PublicValuesAir")
    log_n, w, pvs = bad.meta[i]
    bad.meta[i] = (log_n, w, [(pvs[0] + 1) % 256] + list(pvs[1:]))
    return bad


@pytest.mark.slow
def test_ext_guest_proof_equals_reference(runs):
    ref, port = runs["ext_guest"][2:]
    ref_airs = [a for a, _, _ in ref["traces"]]
    airs = [a for a, _, _ in port["traces"]]
    ref_proof = _reference_proof(ref["traces"], REF_TINY)
    proof = machine.prove_machine([machine.AirInstance(a, t, p) for a, t, p in port["traces"]],
                                  TINY, device="cpu")
    assert_proofs_equal(proof, ref_proof)
    assert machine.verify_machine(airs, machine_proof_from_numpy(ref_proof), TINY,
                                  device="cpu") is True
    assert ref_machine.verify_machine(ref_airs, proof, REF_TINY)
    assert machine.verify_machine(airs, _tampered_public_value(airs, proof), TINY,
                                  device="cpu") is False
    assert not ref_machine.verify_machine(ref_airs, _tampered_public_value(ref_airs, ref_proof),
                                          REF_TINY)
