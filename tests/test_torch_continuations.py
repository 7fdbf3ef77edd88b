"""The port's continuations (`models/rv32_continuations.py` and the
continuation arguments of `models/rv32_v2.generate_traces`) against the
JAX package.

Tier 1, exact (no tolerance): `MemState` roots and inner digests at depths
17 and 20 over seeded sparse words; the two guests of the reference's
`tests/test_keccak_continuations.py` (a segmented keccak guest, and a
depth-20 guest that stores far above 2^16 words) through
`execute_segments` (every witness field, the pre and post states' roots)
and `generate_segment_traces` (every table and public value), with the
port's constraint and bus checks clean per segment; the three new AIRs'
`serialize_air` streams; the pause/resume case of the reference's
`tests/test_vm.py::test_segmentation_pause_resume`; `generate_traces` at
its new arguments' defaults equal to the call without them and to the
reference; `device=None` needing a card.

Under `slow`: a three-segment chain (the keccak guest revealing its whole
digest: a chain verifies only when every PV word is revealed) proven at
fast_test_config() by both packages, the proofs equal in every field but
`stat`, each `verify_chain` accepting the other's chain, and three
tampered chains (segments swapped, the halting segment dropped, a wrong
initial root) False in both."""

import numpy as np
import pytest
import torch

from zkvm_prover_tpu.models import rv32_continuations as ref_cont
from zkvm_prover_tpu.models import rv32_v2 as ref_rv32_v2
from zkvm_prover_tpu.models import symbolic as ref_symbolic
from zkvm_prover_tpu.stark import machine as ref_machine
from zkvm_prover_tpu.stark.config import fast_test_config as ref_fast_config
from zkvm_prover_tpu.vm import asm as ref_asm
from zkvm_prover_tpu.vm import executor as ref_executor
from zkvm_prover_tpu_torch.convert import machine_proof_from_numpy
from zkvm_prover_tpu_torch.models import rv32_continuations as cont
from zkvm_prover_tpu_torch.models import rv32_v2, symbolic
from zkvm_prover_tpu_torch.stark import debug
from zkvm_prover_tpu_torch.stark.config import fast_test_config
from zkvm_prover_tpu_torch.vm import asm, executor, guests

from test_torch_stark import assert_proofs_equal

MSG = 0x3000
OUT = 0x3080


def keccak_guest(A, reveal_words=1):
    """The reference test's guest: store a message, spin (a segment
    boundary), keccak it, spin again, reveal the digest's first
    `reveal_words` words (the reference's guest reveals one; a chain
    verifies only when all 8 PV words are revealed)."""
    msg = b"segmented keccak!"
    body = []
    padded = msg + b"\x00" * (-len(msg) % 4)
    for i in range(0, len(padded), 4):
        body += A.li("t0", int.from_bytes(padded[i:i + 4], "little"))
        body += A.li("t1", MSG + i)
        body.append(A.sw("t0", "t1", 0))
    body += [
        *A.li("s0", 0),
        *A.li("s1", 300),
        ("label", "spin1"),
        A.addi("s0", "s0", 1),
        ("branch", A.bne, "s0", "s1", "spin1"),
    ]
    body += A.keccak256(MSG, len(msg), OUT)
    body += [
        *A.li("s0", 0),
        ("label", "spin2"),
        A.addi("s0", "s0", 1),
        ("branch", A.bne, "s0", "s1", "spin2"),
    ]
    for w in range(reveal_words):
        body += [*A.li("t1", OUT + 4 * w), A.lw("t0", "t1", 0), *A.reveal("t0", w)]
    body.append(A.halt(0))
    return A.assemble(body)


def high_offset_guest(A):
    """The reference test's depth-20 guest: a store and a load at word
    offset 300,000, beyond a depth-17 tree."""
    high = MSG + 4 * 300_000
    body = [*A.li("t0", 0xDEADBEEF), *A.li("t1", high), A.sw("t0", "t1", 0)]
    body += [
        *A.li("s0", 0),
        *A.li("s1", 200),
        ("label", "spin"),
        A.addi("s0", "s0", 1),
        ("branch", A.bne, "s0", "s1", "spin"),
    ]
    body += [*A.li("t1", high), A.lw("t0", "t1", 0), *A.reveal("t0", 0), A.halt(0)]
    return A.assemble(body)


# guest -> (program builder, cycles per segment, depth)
GUESTS = {"keccak": (keccak_guest, 256, cont.DEPTH), "high_offset": (high_offset_guest, 128, 20)}


@pytest.fixture(scope="module")
def segmented():
    """Per guest: (program words, reference segments, port segments)."""
    out = {}
    for name, (build, cycles, depth) in GUESTS.items():
        prog = build(asm)
        assert prog == build(ref_asm)
        out[name] = (prog,
                     ref_cont.execute_segments(prog, cycles, data_base=MSG, depth=depth),
                     cont.execute_segments(prog, cycles, data_base=MSG, depth=depth))
    return out


@pytest.fixture(scope="module")
def segment_traces(segmented):
    """Per guest: per segment, (reference triples, port triples)."""
    out = {}
    for name, (prog, ref_segs, segs) in segmented.items():
        depth = GUESTS[name][2]
        out[name] = [(ref_cont.generate_segment_traces(prog, r, MSG, depth=depth),
                      cont.generate_segment_traces(prog, s, MSG, depth=depth))
                     for r, s in zip(ref_segs, segs)]
    return out


def _assert_triples_equal(ref, port):
    assert [type(a).__name__ for a, _, _ in port] == [type(a).__name__ for a, _, _ in ref]
    for (ra, rt, rp), (a, t, p) in zip(ref, port):
        name = type(a).__name__
        assert t.dtype == np.uint32 and t.shape == rt.shape, name
        np.testing.assert_array_equal(t, np.asarray(rt), err_msg=name)
        assert [int(v) for v in p] == [int(v) for v in rp], name


# ---------------------------------------------------------------------------
# the memory tree
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("depth", [17, 20])
@pytest.mark.parametrize("n_words", [0, 1, 40])
def test_memstate_roots_equal(depth, n_words):
    rng = np.random.default_rng(depth * 100 + n_words)
    leaves = rng.choice(1 << depth, size=n_words, replace=False)
    words = rng.integers(0, 1 << 32, size=n_words, dtype=np.uint64)
    ref, port = ref_cont.MemState(depth), cont.MemState(depth)
    for leaf, word in zip(leaves, words):
        ref.words[int(leaf)] = port.words[int(leaf)] = int(word)
    np.testing.assert_array_equal(port.root(), ref.root())
    for level in (0, 1, depth // 2, depth - 1):
        idx = int(leaves[0]) >> level if n_words else 0
        np.testing.assert_array_equal(port.node_digest(level, idx), ref.node_digest(level, idx))
    copied = port.copy()
    copied.words[0] = 7
    np.testing.assert_array_equal(port.root(), ref.root())


def test_embed_word_and_leaf_of_addr_equal():
    for w in (0, 1, 0xDEADBEEF, 0xFFFFFFFF):
        np.testing.assert_array_equal(cont.embed_word(w), ref_cont.embed_word(w))
    for addr in (MSG, MSG + 4, MSG + 4 * 300_000):
        assert cont.leaf_of_addr(addr, MSG) == ref_cont.leaf_of_addr(addr, MSG)


# ---------------------------------------------------------------------------
# segments: witnesses, traces, checks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(GUESTS))
def test_segment_witnesses_equal(segmented, name):
    prog, ref_segs, segs = segmented[name]
    assert len(segs) == len(ref_segs) >= 2 and segs[-1].halted
    assert [s.halted for s in segs] == [False] * (len(segs) - 1) + [True]
    for r, s in zip(ref_segs, segs):
        for field in ("records", "init_regs", "final_regs", "touched_ram"):
            np.testing.assert_array_equal(getattr(s, field), getattr(r, field), err_msg=field)
        assert (s.init_pc, s.final_pc, s.halted) == (r.init_pc, r.final_pc, r.halted)
        for state in ("pre_state", "post_state"):
            assert getattr(s, state).words == getattr(r, state).words, state
            np.testing.assert_array_equal(getattr(s, state).root(), getattr(r, state).root())
    for a, b in zip(segs, segs[1:]):
        assert a.post_state.words == b.pre_state.words and a.final_pc == b.init_pc


@pytest.mark.parametrize("name", list(GUESTS))
def test_segment_traces_equal(segment_traces, name):
    for ref, port in segment_traces[name]:
        _assert_triples_equal(ref, port)


@pytest.mark.parametrize("name", list(GUESTS))
def test_segment_traces_clean(segment_traces, name):
    """The port's constraint and bus checks pass on every segment; the
    keccak chips appear in one of the keccak guest's segments."""
    kinds = set()
    for _, triples in segment_traces[name]:
        for air, tr, pvs in triples:
            assert debug.check_constraints(air, tr, pvs) == [], type(air).__name__
            kinds.add(type(air).__name__)
        pairs = [(a, t) for a, t, _ in triples]
        assert debug.check_bus_balance(pairs, {i: p for i, (_, _, p) in enumerate(triples)}) == {}
    assert {"ExecBoundaryAirV3", "MemoryBoundaryAirV3", "MemoryMerkleAir"} <= kinds
    if name == "keccak":
        assert "KeccakVmAir" in kinds


def test_segment_outside_the_tree_raises(segmented):
    """A data word beyond the tree (the high-offset guest at depth 17)."""
    prog, _, _ = segmented["high_offset"]
    segs = cont.execute_segments(prog, 128, data_base=MSG)
    with pytest.raises(ValueError, match="outside the memory tree"):
        cont.generate_segment_traces(prog, segs[0], MSG)


def test_no_touch_merkle_root_row_equals_reference(segmented):
    """A segment that touches nothing proves old_root == new_root by one
    root row (the reference's `_merkle_rows` branch for that case)."""
    _, ref_segs, segs = segmented["keccak"]
    ref = ref_cont._merkle_rows(ref_segs[1], {}, cont.DEPTH)
    port = cont._merkle_rows(segs[1], {}, cont.DEPTH)
    assert len(port[0]) == len(ref[0]) == 1
    np.testing.assert_array_equal(port[0][0], ref[0][0])
    np.testing.assert_array_equal(port[1], ref[1])
    np.testing.assert_array_equal(port[2], ref[2])


@pytest.mark.parametrize("air", ["ExecBoundaryAirV3", "MemoryBoundaryAirV3@0x2000",
                                 "MemoryBoundaryAirV3@0x3000", "MemoryMerkleAir@17",
                                 "MemoryMerkleAir@20"])
def test_serialize_air_equal(air):
    name, _, arg = air.partition("@")
    args = () if not arg else (int(arg, 0),)
    port, ref = getattr(cont, name)(*args), getattr(ref_cont, name)(*args)
    assert symbolic.serialize_air(port) == ref_symbolic.serialize_air(ref)
    assert (port.width, port.num_public_values) == (ref.width, ref.num_public_values)


# ---------------------------------------------------------------------------
# the executor and generate_traces
# ---------------------------------------------------------------------------


def test_segmentation_pause_resume():
    """The reference's `test_vm.py` case on the port's executor: a loop of
    ~2000 cycles run 300 at a time pauses, resumes and halts, with the
    reference's states and cycle counts."""
    def run(A, ex_mod):
        prog = [A.li("t0", 1000), ("label", "loop"), A.addi("t0", "t0", -1),
                ("branch", A.bne, "t0", "zero", "loop"), A.halt(0)]
        ex = ex_mod.Rv32Executor()
        ex.load_program(A.assemble(prog))
        states, cycles = [], []
        while True:
            states.append(ex.run(300))
            cycles.append(ex.cycles)
            if states[-1] != ex_mod.PAUSED:
                return states, cycles
    states, cycles = run(asm, executor)
    assert states[-1] == executor.HALTED
    assert states.count(executor.PAUSED) >= 5 and cycles[-1] > 2000
    assert (states, cycles) == run(ref_asm, ref_executor)


def test_generate_traces_defaults_unchanged():
    """An existing caller's traces are the same with the continuation
    arguments at their defaults, and equal the reference's; core_only
    returns the first triples of the full list and the trace state."""
    prog = guests.bench_guest_program(1, 4)
    ex = executor.Rv32Executor()
    ex.load_program(prog)
    assert ex.run(1 << 18) == executor.HALTED
    rec = ex.records()
    plain = rv32_v2.generate_traces(prog, rec, data_base=0x3000)
    explicit = rv32_v2.generate_traces(prog, rec, 0x3000, init_regs=None, init_ram=None,
                                       init_pc=0, core_only=False)
    _assert_triples_equal(plain, explicit)
    _assert_triples_equal(ref_rv32_v2.generate_traces(prog, rec, data_base=0x3000), plain)
    core, st = rv32_v2.generate_traces(prog, rec, 0x3000, core_only=True)
    _assert_triples_equal(plain[:len(core)], core)
    assert type(core[-1][0]).__name__ == "PublicValuesAir" and st.halted


def test_generate_traces_with_boundary_state_equals_reference(segmented):
    """The continuation arguments themselves, at a later segment's state."""
    prog, _, segs = segmented["keccak"]
    seg = segs[2]
    init_ram = {int(a): int(old) for a, old, _ in seg.touched_ram}
    kwargs = dict(init_regs=seg.init_regs, init_ram=init_ram, init_pc=seg.init_pc,
                  core_only=True)
    core, st = rv32_v2.generate_traces(prog, seg.records, MSG, **kwargs)
    ref_core, ref_st = ref_rv32_v2.generate_traces(prog, seg.records, MSG, **kwargs)
    _assert_triples_equal(ref_core, core)
    assert (st.fin_pc, st.fin_ts, st.halted) == (ref_st.fin_pc, ref_st.fin_ts, ref_st.halted)
    np.testing.assert_array_equal(st.last_ts, ref_st.last_ts)
    np.testing.assert_array_equal(st.last_val, ref_st.last_val)
    assert st.ram == ref_st.ram


def test_default_device_needs_a_card(monkeypatch, segmented):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prog, _, segs = segmented["keccak"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cont.prove_segments(prog, segs[:1], fast_test_config(), data_base=MSG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cont.verify_chain([], fast_test_config())


def test_empty_chain_is_false():
    assert cont.verify_chain([], fast_test_config(), device="cpu") is False
    assert ref_cont.verify_chain([], ref_fast_config()) is False


# ---------------------------------------------------------------------------
# the chain's proofs (slow: three segment machine proofs in each package)
# ---------------------------------------------------------------------------

CHAIN_CYCLES = 512     # the keccak guest in three segments


def test_one_word_chain_cannot_verify(segment_traces):
    """The reference's keccak guest reveals one PV word; `verify_chain`
    wants each of the 8 revealed exactly once, so the chain guests reveal
    the whole digest. The per-segment PV flags show why."""
    flags = [next(p for a, _, p in port if type(a).__name__ == "PublicValuesAir")[32:]
             for _, port in segment_traces["keccak"]]
    assert [sum(int(f[w]) for f in flags) for w in range(8)] == [1] + [0] * 7


def test_chain_guest_segments():
    """The chain guest (the whole digest revealed) runs in three segments
    of CHAIN_CYCLES, in both packages."""
    prog = keccak_guest(asm, reveal_words=8)
    assert prog == keccak_guest(ref_asm, reveal_words=8)
    segs = cont.execute_segments(prog, CHAIN_CYCLES, data_base=MSG)
    ref_segs = ref_cont.execute_segments(prog, CHAIN_CYCLES, data_base=MSG)
    assert len(segs) == len(ref_segs) == 3
    assert [(s.init_pc, s.final_pc, s.halted) for s in segs] == [
        (s.init_pc, s.final_pc, s.halted) for s in ref_segs]


@pytest.fixture(scope="module")
def chains():
    """The chain guest proven by both packages at fast_test_config (the
    reference on its host numpy path): (reference bundles, port bundles,
    the port's bundles of the reference's proofs)."""
    prog = keccak_guest(asm, reveal_words=8)
    ref_segs = ref_cont.execute_segments(prog, CHAIN_CYCLES, data_base=MSG)
    segs = cont.execute_segments(prog, CHAIN_CYCLES, data_base=MSG)
    saved = ref_machine._DEVICE_MIN_ELEMS
    ref_machine._DEVICE_MIN_ELEMS = 1 << 62
    try:
        ref = ref_cont.prove_segments(prog, ref_segs, ref_fast_config(), data_base=MSG)
    finally:
        ref_machine._DEVICE_MIN_ELEMS = saved
    port = cont.prove_segments(prog, segs, fast_test_config(), data_base=MSG, device="cpu")
    lifted = [cont.SegmentProofBundle(machine_proof_from_numpy(r.proof), p.airs)
              for r, p in zip(ref, port)]
    return ref, port, lifted


@pytest.mark.slow
def test_chain_proofs_equal_reference(chains):
    ref, port, lifted = chains
    assert len(port) == len(ref) == 3
    for r, p in zip(ref, port):
        assert [type(a).__name__ for a in p.airs] == [type(a).__name__ for a in r.airs]
        assert_proofs_equal(p.proof, r.proof)
    assert cont.verify_chain(lifted, fast_test_config(), device="cpu") is True
    assert cont.verify_chain(port, fast_test_config(), device="cpu") is True
    cross = [ref_cont.SegmentProofBundle(proof=p.proof, airs=r.airs) for r, p in zip(ref, port)]
    assert ref_cont.verify_chain(cross, ref_fast_config()) is True


def _tampered_chain(bundles, how):
    if how == "swapped":
        return [bundles[1], bundles[0]] + list(bundles[2:])
    return list(bundles[:-1])


@pytest.mark.slow
@pytest.mark.parametrize("how", ["swapped", "dropped_last", "wrong_initial_root"])
def test_chain_tampers_rejected(chains, how):
    ref, port, _ = chains
    kwargs, ref_kwargs = {}, {}
    if how == "wrong_initial_root":
        root = cont.MemState().root().copy()
        root[0] ^= 1
        kwargs = ref_kwargs = {"initial_root": root}
        bad, ref_bad = port, ref
    else:
        bad, ref_bad = _tampered_chain(port, how), _tampered_chain(ref, how)
    assert cont.verify_chain(bad, fast_test_config(), device="cpu", **kwargs) is False
    assert ref_cont.verify_chain(ref_bad, ref_fast_config(), **ref_kwargs) is False
