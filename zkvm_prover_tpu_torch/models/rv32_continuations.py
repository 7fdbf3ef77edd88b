"""Continuations: segment-parallel rv32 proofs with persistent memory.

The port's copy of the reference's `zkvm_prover_tpu/models/
rv32_continuations.py`, the analog of openvm's continuations layer: the
guest's execution is split into segments, each proven on its own, with
the memory state carried across segments as a Poseidon2 Merkle commitment
(SURVEY.md §2.2 "RISC-V VM executor + continuations", §2.3 "Segment
parallelism").

- The guest runs in the native executor with a per-segment cycle budget;
  a PAUSED segment snapshots its boundary state (pc, registers, the
  first-touch old and new values of memory: `vm_begin_segment` in
  native/vm/rv32im.cpp).
- Registers and data RAM live in one persistent Merkle tree of depth
  `DEPTH` (leaves 0..31 are x0..x31, leaf 32 + k the data word at
  `data_base + 4k`). A leaf digest holds the word's 4 byte limbs in lanes
  0..3. A segment's public values carry its pre and post roots.
- Inside a segment, consistency stays offline memory checking
  (REG_BUS/MEM_BUS, timestamps restarting at 1 in every segment).
- `MemoryBoundaryAirV3` opens every touched cell at ts 0 with its
  witnessed pre-segment value, closes it at the final (ts, value), and
  sends the (leaf, old, new) level-0 message into the Merkle argument.
- `MemoryMerkleAir` takes the leaf updates and proves the path
  recomputation old_root -> new_root, one tree node per row, hashing by
  logUp queries to `Poseidon2Air`.
- `ExecBoundaryAirV3` opens the execution bus at the witnessed initial pc
  (bound to public values) instead of pc = 0.

`verify_chain` verifies every segment's machine proof and the chaining:
final_root[i] == init_root[i+1], final_pc[i] == init_pc[i+1], a halt only
in the last segment, and every user PV word revealed exactly once across
the chain. `prove_segments` and `verify_chain` run on the card unless the
caller passes `device="cpu"`.
"""

from __future__ import annotations

from bisect import bisect_left
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..stark import machine
from ..stark.config import resolve_device
from ..vm.executor import HALTED, PAUSED, Rv32Executor
from . import rv32_v2 as v2
from .air import Air, AirBuilder
from .poseidon2_air import POSEIDON_BUS, Poseidon2Air, compress_canonical
from .rv32_v0 import BYTE_BUS, REG_BUS
from .rv32_v2 import EXEC_BUS, MEM_BUS, N_LIMBS, _limbs

MERKLE_BUS = 30

DEPTH = 17            # 2^17 leaves: 32 registers and ~2^17 data words; the
                      # boundary AIR's 3-limb offset allows any depth <= 24
N_REG_LEAVES = 32


def leaf_of_addr(addr: int, data_base: int) -> int:
    return N_REG_LEAVES + (addr - data_base) // 4


def embed_word(word: int) -> np.ndarray:
    """Leaf digest of a memory word: 4 byte limbs and 4 zero lanes."""
    d = np.zeros(8, dtype=np.uint32)
    d[:4] = _limbs(word)
    return d


# ---------------------------------------------------------------------------
# Host-side sparse Merkle tree over the persistent memory state
# ---------------------------------------------------------------------------


class MemState:
    """Persistent memory state: {leaf: word}, with its sparse Merkle root.
    A subtree that holds no stored leaf has the default digest of its
    level (the reference scans every leaf at every node for this; the port
    bisects a sorted copy of the keys: the same digests)."""

    def __init__(self, depth: int = DEPTH):
        self.depth = depth
        self.words: Dict[int, int] = {}
        self._defaults = [embed_word(0)]
        for _ in range(depth):
            d = self._defaults[-1]
            self._defaults.append(compress_canonical(d[None, :], d[None, :])[0])

    def copy(self) -> "MemState":
        m = MemState.__new__(MemState)
        m.depth = self.depth
        m.words = dict(self.words)
        m._defaults = self._defaults
        return m

    def node_digest(self, level: int, idx: int,
                    _cache: Optional[dict] = None) -> np.ndarray:
        """Digest of node `idx` at `level` (0 = leaves). A cache passed in
        holds the digests of one unchanged state."""
        cache = _cache if _cache is not None else {}
        if "keys" not in cache:
            cache["keys"] = sorted(self.words)
        return self._node(level, idx, cache)

    def _node(self, level: int, idx: int, cache: dict) -> np.ndarray:
        key = (level, idx)
        if key in cache:
            return cache[key]
        if level == 0:
            out = embed_word(self.words.get(idx, 0))
        else:
            keys = cache["keys"]
            lo, hi = idx << level, (idx + 1) << level
            i = bisect_left(keys, lo)
            if i == len(keys) or keys[i] >= hi:
                out = self._defaults[level]
            else:
                left = self._node(level - 1, 2 * idx, cache)
                right = self._node(level - 1, 2 * idx + 1, cache)
                out = compress_canonical(left[None, :], right[None, :])[0]
        cache[key] = out
        return out

    def root(self) -> np.ndarray:
        return self.node_digest(self.depth, 0)


# ---------------------------------------------------------------------------
# AIRs
# ---------------------------------------------------------------------------


class ExecBoundaryAirV3(Air):
    """Execution-bus boundary with a witnessed initial pc.
    pvs = [init_pc, final_pc, is_halted]."""

    IS_INIT = 0
    IS_FIN = 1
    FIN_PC = 2
    FIN_TS = 3
    INIT_PC = 4
    width = 5
    num_public_values = 3

    def eval(self, b: AirBuilder) -> None:
        E = ExecBoundaryAirV3
        is_init = b.local(E.IS_INIT)
        is_fin = b.local(E.IS_FIN)
        b.assert_bool(is_init)
        b.assert_bool(is_fin)
        b.when_first_row().assert_eq(is_init, b.constant(1))
        b.when_transition().assert_zero(b.next(E.IS_INIT))
        init_pc = b.local(E.INIT_PC)
        b.assert_zero(b.mul(is_init, b.sub(init_pc, b.public_value(0))))
        halted = b.public_value(2)
        b.assert_zero(b.mul(is_fin, halted))
        b.assert_zero(b.mul(is_fin, b.sub(b.local(E.FIN_PC), b.public_value(1))))
        b.push_send(EXEC_BUS, [init_pc, b.constant(1)], is_init)
        b.push_receive(EXEC_BUS, [b.local(E.FIN_PC), b.local(E.FIN_TS)], is_fin)


class MemoryBoundaryAirV3(Air):
    """The register and RAM segment boundary: opens each touched cell's
    offline-checking chain at (ts 0, witnessed initial value), closes it at
    the witnessed final (ts, value), and sends the (leaf, old digest, new
    digest) level-0 update into MERKLE_BUS. Register rows (IS_REG) use
    REG_BUS with leaf = register index (< 32 by the 8*leaf byte check); RAM
    rows use MEM_BUS with leaf = 32 + (addr - data_base)/4, the offset
    range-checked to 24 bits (2^24 data words, 64 MiB)."""

    IS_REAL = 0
    IS_REG = 1
    LEAF = 2
    INIT_VAL = 3      # 4
    FINAL_VAL = 7     # 4
    FINAL_TS = 11
    OFF_LO = 12
    OFF_MID = 13
    OFF_HI = 14
    width = 15
    num_public_values = 0

    def __init__(self, data_base: int = 0x2000):
        self.data_base = data_base

    def eval(self, b: AirBuilder) -> None:
        C = MemoryBoundaryAirV3
        real = b.local(C.IS_REAL)
        is_reg = b.local(C.IS_REG)
        b.assert_bool(real)
        b.assert_bool(is_reg)
        b.assert_zero(b.mul(is_reg, b.sub(real, b.constant(1))))
        is_ram = b.sub(real, is_reg)

        leaf = b.local(C.LEAF)
        init = [b.local(C.INIT_VAL + k) for k in range(N_LIMBS)]
        fin = [b.local(C.FINAL_VAL + k) for k in range(N_LIMBS)]
        fin_ts = b.local(C.FINAL_TS)
        zero = b.constant(0)

        # registers: leaf < 32
        b.push_send(BYTE_BUS, [b.mul(b.constant(8), leaf)], is_reg)
        b.push_send(REG_BUS, [leaf, zero] + init, is_reg)
        b.push_receive(REG_BUS, [leaf, fin_ts] + fin, is_reg)

        # RAM: addr = data_base + 4*(leaf - 32) in one felt, offset < 2^24
        # (three byte limbs; addr stays under MEM_BUS's injective-key bound
        # data_base + 2^26 < 2^31 - 2^27)
        lo, mid, hi = b.local(C.OFF_LO), b.local(C.OFF_MID), b.local(C.OFF_HI)
        off = b.add(b.add(lo, b.mul(b.constant(256), mid)),
                    b.mul(b.constant(1 << 16), hi))
        b.push_send(BYTE_BUS, [lo], is_ram)
        b.push_send(BYTE_BUS, [mid], is_ram)
        b.push_send(BYTE_BUS, [hi], is_ram)
        b.assert_zero(b.mul(is_ram, b.sub(leaf, b.add(off, b.constant(N_REG_LEAVES)))))
        addr_val = b.add(b.constant(self.data_base), b.mul(b.constant(4), off))
        b.push_send(MEM_BUS, [addr_val, zero] + init, is_ram)
        b.push_receive(MEM_BUS, [addr_val, fin_ts] + fin, is_ram)

        # the level-0 Merkle leaf update
        b.push_send(MERKLE_BUS, [zero, leaf] + init + [zero] * 4 + fin + [zero] * 4, real)


class MemoryMerkleAir(Air):
    """The Merkle root transition: one touched tree node per row. Receives
    its touched children's (old, new) digests from MERKLE_BUS, witnesses
    untouched siblings (old == new enforced), proves the two compressions
    by POSEIDON_BUS and sends its own (old, new) upward. The root row binds
    pvs = old_root(8) || new_root(8)."""

    IS_REAL = 0
    IS_ROOT = 1
    LEVEL = 2        # parent level (1..depth)
    PIDX = 3         # parent index at LEVEL
    LT = 4           # left child touched
    RT = 5
    OLD_L = 6        # 8
    NEW_L = 14       # 8
    OLD_R = 22       # 8
    NEW_R = 30       # 8
    OLD_P = 38       # 8
    NEW_P = 46       # 8
    width = 54
    num_public_values = 16

    def __init__(self, depth: int = DEPTH):
        self.depth = depth

    def eval(self, b: AirBuilder) -> None:
        C = MemoryMerkleAir
        real = b.local(C.IS_REAL)
        root = b.local(C.IS_ROOT)
        lt, rt = b.local(C.LT), b.local(C.RT)
        for f in (real, root, lt, rt):
            b.assert_bool(f)
        one = b.constant(1)
        for f in (root, lt, rt):
            b.assert_zero(b.mul(f, b.sub(real, one)))

        level, pidx = b.local(C.LEVEL), b.local(C.PIDX)
        old_l = [b.local(C.OLD_L + k) for k in range(8)]
        new_l = [b.local(C.NEW_L + k) for k in range(8)]
        old_r = [b.local(C.OLD_R + k) for k in range(8)]
        new_r = [b.local(C.NEW_R + k) for k in range(8)]
        old_p = [b.local(C.OLD_P + k) for k in range(8)]
        new_p = [b.local(C.NEW_P + k) for k in range(8)]

        # untouched children: a witnessed sibling, unchanged by the segment
        not_lt = b.sub(real, lt)
        not_rt = b.sub(real, rt)
        for k in range(8):
            b.assert_zero(b.mul(not_lt, b.sub(new_l[k], old_l[k])))
            b.assert_zero(b.mul(not_rt, b.sub(new_r[k], old_r[k])))

        child_level = b.sub(level, one)
        two_pidx = b.add(pidx, pidx)
        b.push_receive(MERKLE_BUS, [child_level, two_pidx] + old_l + new_l, lt)
        b.push_receive(MERKLE_BUS, [child_level, b.add(two_pidx, one)] + old_r + new_r, rt)

        b.push_send(POSEIDON_BUS, old_l + old_r + old_p, real)
        b.push_send(POSEIDON_BUS, new_l + new_r + new_p, real)

        b.push_send(MERKLE_BUS, [level, pidx] + old_p + new_p, b.sub(real, root))

        # exactly one root row, pinned to row 0: without it an all-padding
        # trace satisfies every constraint while the 16 root public values
        # float free. A segment that touches nothing proves old_root ==
        # new_root by a root row with lt = rt = 0.
        b.when_first_row().assert_eq(root, one)
        b.when_transition().assert_zero(b.next(C.IS_ROOT))
        b.assert_zero(b.mul(root, b.sub(level, b.constant(self.depth))))
        b.assert_zero(b.mul(root, pidx))
        for k in range(8):
            b.assert_zero(b.mul(root, b.sub(old_p[k], b.public_value(k))))
            b.assert_zero(b.mul(root, b.sub(new_p[k], b.public_value(8 + k))))


# ---------------------------------------------------------------------------
# Host-side trace generation
# ---------------------------------------------------------------------------


@dataclass
class SegmentWitness:
    """Boundary state and execution records of one segment."""
    records: np.ndarray
    init_pc: int
    final_pc: int
    init_regs: np.ndarray          # (32,) before the segment
    final_regs: np.ndarray
    touched_ram: np.ndarray        # (n, 3): word_addr, old, new
    halted: bool
    pre_state: MemState            # persistent memory before the segment
    post_state: MemState


def execute_segments(program_words, max_cycles_per_segment: int,
                     hints: bytes = b"", data_base: int = 0x2000,
                     depth: int = DEPTH,
                     max_segments: int = 64) -> List[SegmentWitness]:
    """Run the guest to completion in bounded segments, snapshotting the
    persistent memory state at every boundary."""
    ex = Rv32Executor()
    ex.load_program(program_words)
    if hints:
        ex.set_hints(hints)
    state = MemState(depth)
    segments: List[SegmentWitness] = []
    for _ in range(max_segments):
        init_pc = ex.pc
        init_regs = np.array([ex.get_reg(r) for r in range(32)], dtype=np.uint32)
        ex.begin_segment()
        run_state = ex.run(max_cycles_per_segment)
        if run_state not in (HALTED, PAUSED):
            raise RuntimeError(f"guest trapped (state {run_state})")
        touched = ex.touched()
        final_regs = np.array([ex.get_reg(r) for r in range(32)], dtype=np.uint32)
        post = state.copy()
        for r in range(32):
            if final_regs[r] != init_regs[r]:
                post.words[r] = int(final_regs[r])
        for addr, _old, new in touched:
            post.words[leaf_of_addr(int(addr), data_base)] = int(new)
        segments.append(SegmentWitness(
            records=ex.records(), init_pc=init_pc, final_pc=ex.pc,
            init_regs=init_regs, final_regs=final_regs,
            touched_ram=touched, halted=(run_state == HALTED),
            pre_state=state, post_state=post,
        ))
        state = post
        if run_state == HALTED:
            return segments
    raise RuntimeError("max_segments exceeded")


def _merkle_rows(seg: SegmentWitness, touched_leaves: Dict[int, Tuple[int, int]],
                 depth: int):
    """The touched subtree's update rows and the Poseidon2 queries.

    Returns (rows, inputs, mults): rows are MemoryMerkleAir rows, inputs
    (m, 16) canonical compression inputs in first-query order with their
    multiplicities. The compressions of one level run in one call."""
    C = MemoryMerkleAir
    pre_cache: dict = {}
    rows = []
    pose: Dict[bytes, list] = {}

    def register(inputs: np.ndarray) -> None:
        for inp in inputs:
            key = inp.tobytes()
            if key in pose:
                pose[key][1] += 1
            else:
                pose[key] = [inp, 1]

    current: Dict[int, Tuple[np.ndarray, np.ndarray]] = {
        leaf: (embed_word(old), embed_word(new))
        for leaf, (old, new) in touched_leaves.items()
    }
    for level in range(1, depth + 1):
        pidxs = sorted({i >> 1 for i in current})
        if not pidxs:
            break
        level_rows = np.zeros((len(pidxs), C.width), dtype=np.uint32)
        level_rows[:, C.IS_REAL] = 1
        level_rows[:, C.LEVEL] = level
        level_rows[:, C.PIDX] = pidxs
        if level == depth:
            level_rows[:, C.IS_ROOT] = 1
        for j, pidx in enumerate(pidxs):
            for flag, cidx, base_o, base_n in ((C.LT, 2 * pidx, C.OLD_L, C.NEW_L),
                                               (C.RT, 2 * pidx + 1, C.OLD_R, C.NEW_R)):
                if cidx in current:
                    old_d, new_d = current[cidx]
                    level_rows[j, flag] = 1
                else:
                    old_d = new_d = seg.pre_state.node_digest(level - 1, cidx, pre_cache)
                level_rows[j, base_o:base_o + 8] = old_d
                level_rows[j, base_n:base_n + 8] = new_d
        # per row: the old compression, then the new one (first-query order)
        inputs = np.empty((2 * len(pidxs), 16), dtype=np.uint32)
        inputs[0::2, :8], inputs[0::2, 8:] = level_rows[:, C.OLD_L:C.OLD_L + 8], \
            level_rows[:, C.OLD_R:C.OLD_R + 8]
        inputs[1::2, :8], inputs[1::2, 8:] = level_rows[:, C.NEW_L:C.NEW_L + 8], \
            level_rows[:, C.NEW_R:C.NEW_R + 8]
        outs = compress_canonical(inputs[:, :8], inputs[:, 8:])
        register(inputs)
        level_rows[:, C.OLD_P:C.OLD_P + 8] = outs[0::2]
        level_rows[:, C.NEW_P:C.NEW_P + 8] = outs[1::2]
        rows.extend(level_rows)
        current = {pidx: (outs[2 * j], outs[2 * j + 1]) for j, pidx in enumerate(pidxs)}

    if not touched_leaves:
        # a segment that touches nothing: the mandatory root row (lt = rt =
        # 0) proving old_root == new_root over the untouched children
        row = np.zeros(C.width, dtype=np.uint32)
        row[C.IS_REAL] = 1
        row[C.IS_ROOT] = 1
        row[C.LEVEL] = depth
        left = seg.pre_state.node_digest(depth - 1, 0, pre_cache)
        right = seg.pre_state.node_digest(depth - 1, 1, pre_cache)
        inp = np.concatenate([left, right]).astype(np.uint32)
        root_d = compress_canonical(left[None, :], right[None, :])[0]
        register(np.stack([inp, inp]))   # the old and the new compression
        for base in (C.OLD_L, C.NEW_L):
            row[base:base + 8] = left
        for base in (C.OLD_R, C.NEW_R):
            row[base:base + 8] = right
        for base in (C.OLD_P, C.NEW_P):
            row[base:base + 8] = root_d
        rows.append(row)

    # the AIR pins the root row to row 0 (the exactly-one-root constraint)
    rows.sort(key=lambda r: -int(r[C.IS_ROOT]))

    if not pose:
        return rows, np.zeros((0, 16), dtype=np.uint32), np.zeros(0, dtype=np.uint32)
    inputs = np.array([v[0] for v in pose.values()], dtype=np.uint32)
    mults = np.array([v[1] for v in pose.values()], dtype=np.uint32)
    return rows, inputs, mults


def generate_segment_traces(program_words, seg: SegmentWitness,
                            data_base: int = 0x2000, depth: int = DEPTH):
    """Every AIR trace of one segment: (air, trace, pvs) triples in the
    segment machine's order."""
    init_ram = {int(a): int(old) for a, old, _ in seg.touched_ram}
    out, st = v2.generate_traces(
        program_words, seg.records, data_base,
        init_regs=seg.init_regs, init_ram=init_ram, init_pc=seg.init_pc,
        core_only=True,
    )
    if st.halted != seg.halted:
        raise RuntimeError("the segment's records and its halt state disagree")

    # execution boundary v3
    E = ExecBoundaryAirV3
    ex_tr = np.zeros((4, E.width), dtype=np.uint32)
    ex_tr[0, E.IS_INIT] = 1
    ex_tr[0, E.INIT_PC] = seg.init_pc
    final_pc_pv = 0
    if not seg.halted:
        if st.fin_pc != seg.final_pc:
            raise RuntimeError("the segment's records end at another pc")
        ex_tr[3, E.IS_FIN] = 1
        ex_tr[3, E.FIN_PC] = st.fin_pc
        ex_tr[3, E.FIN_TS] = st.fin_ts
        final_pc_pv = st.fin_pc
    out.append((ExecBoundaryAirV3(), ex_tr,
                [seg.init_pc, final_pc_pv, 1 if seg.halted else 0]))

    # the register and RAM boundary; the touched leaves for the Merkle rows
    B = MemoryBoundaryAirV3
    touched_leaves: Dict[int, Tuple[int, int]] = {}
    brows = []
    for r in range(32):
        if st.last_ts[r] == 0:
            continue
        row = np.zeros(B.width, dtype=np.uint32)
        row[B.IS_REAL], row[B.IS_REG] = 1, 1
        row[B.LEAF] = r
        st.bcheck(8 * r)
        row[B.INIT_VAL:B.INIT_VAL + 4] = _limbs(int(seg.init_regs[r]))
        row[B.FINAL_VAL:B.FINAL_VAL + 4] = _limbs(int(st.last_val[r]))
        row[B.FINAL_TS] = st.last_ts[r]
        touched_leaves[r] = (int(seg.init_regs[r]), int(st.last_val[r]))
        brows.append(row)
    for addr, (fts, fval) in sorted(st.ram.items()):
        row = np.zeros(B.width, dtype=np.uint32)
        row[B.IS_REAL] = 1
        leaf = leaf_of_addr(addr, data_base)
        off = leaf - N_REG_LEAVES
        if not 0 <= off < min(1 << 24, (1 << depth) - N_REG_LEAVES):
            raise ValueError(f"data word {addr:#x} outside the memory tree of depth {depth}")
        row[B.LEAF] = leaf
        row[B.OFF_LO] = off & 0xFF
        row[B.OFF_MID] = (off >> 8) & 0xFF
        row[B.OFF_HI] = off >> 16
        st.bcheck(off & 0xFF)
        st.bcheck((off >> 8) & 0xFF)
        st.bcheck(off >> 16)
        row[B.INIT_VAL:B.INIT_VAL + 4] = _limbs(init_ram[addr])
        row[B.FINAL_VAL:B.FINAL_VAL + 4] = _limbs(fval)
        row[B.FINAL_TS] = fts
        touched_leaves[leaf] = (init_ram[addr], fval)
        brows.append(row)
    out.append((MemoryBoundaryAirV3(data_base), v2._stack_rows(brows, B.width), []))

    # the Merkle update rows and the Poseidon2 table
    mrows, p_inputs, p_mults = _merkle_rows(seg, touched_leaves, depth)
    old_root = seg.pre_state.root()
    new_root = seg.post_state.root()
    out.append((MemoryMerkleAir(depth), v2._stack_rows(mrows, MemoryMerkleAir.width),
                [int(v) for v in old_root] + [int(v) for v in new_root]))
    out.append((Poseidon2Air(), Poseidon2Air.generate_trace(p_inputs, p_mults), []))

    return v2.finish_tables(out, st)


# ---------------------------------------------------------------------------
# Proving and verifying the segment chain
# ---------------------------------------------------------------------------


@dataclass
class SegmentProofBundle:
    proof: machine.MachineProof
    airs: List[Air]


def prove_segments(program_words, segments: List[SegmentWitness], config,
                   data_base: int = 0x2000, depth: int = DEPTH,
                   device=None) -> List[SegmentProofBundle]:
    """Prove every segment on `device` (None: the card). The segments are
    independent: across cards this is the data-parallel axis."""
    dev = resolve_device(device)
    bundles = []
    for seg in segments:
        triples = generate_segment_traces(program_words, seg, data_base, depth)
        instances = [machine.AirInstance(a, t, pvs) for a, t, pvs in triples]
        proof = machine.prove_machine(instances, config, device=dev)
        bundles.append(SegmentProofBundle(proof=proof, airs=[a for a, _, _ in triples]))
    return bundles


def _seg_pvs(bundle: SegmentProofBundle):
    """The (exec, merkle, user) public values of a segment proof, found by
    AIR type."""
    exec_pvs = merkle_pvs = user_pvs = None
    for air, (_ln, _w, pvs) in zip(bundle.airs, bundle.proof.meta):
        if isinstance(air, ExecBoundaryAirV3):
            exec_pvs = pvs
        elif isinstance(air, MemoryMerkleAir):
            merkle_pvs = pvs
        elif isinstance(air, v2.PublicValuesAir):
            user_pvs = pvs
    if exec_pvs is None or merkle_pvs is None:
        raise ValueError("not a segment proof")
    return exec_pvs, merkle_pvs, user_pvs


def verify_chain(bundles: List[SegmentProofBundle], config,
                 initial_root: Optional[np.ndarray] = None,
                 entry_pc: int = 0, depth: int = DEPTH, device=None) -> bool:
    """Verify every segment proof and the chaining between them, on
    `device` (None: the card). As openvm's leaf verifier does, the first
    segment is pinned to the program's entry point and to a known initial
    memory commitment (by default the empty memory's root at `depth`): a
    chain that starts at another pc or memory state does not verify."""
    dev = resolve_device(device)
    if not bundles:
        return False
    if initial_root is None:
        initial_root = MemState(depth).root()
    prev_root = None
    prev_pc = None
    word_counts = [0] * v2.N_PV_WORDS
    for i, bundle in enumerate(bundles):
        # the chaining is read from the (untrusted) public values before the
        # segment's proof is checked: the answer is the same conjunction,
        # and a broken chain costs no machine verification
        try:
            exec_pvs, merkle_pvs, user_pvs = _seg_pvs(bundle)
            init_pc, final_pc, halted = exec_pvs
            if len(merkle_pvs) != MemoryMerkleAir.num_public_values:
                return False
            old_root = np.array(merkle_pvs[:8], dtype=np.uint32)
            new_root = np.array(merkle_pvs[8:16], dtype=np.uint32)
        except (ValueError, TypeError, OverflowError):
            return False
        if i == 0:
            if init_pc != entry_pc:
                return False
            if not (old_root == np.asarray(initial_root)).all():
                return False
        elif not (old_root == prev_root).all() or init_pc != prev_pc:
            return False
        if bool(halted) != (i == len(bundles) - 1):
            return False
        if not machine.verify_machine(bundle.airs, bundle.proof, config, device=dev):
            return False
        if user_pvs is not None:
            for w, f in enumerate(user_pvs[4 * v2.N_PV_WORDS:]):
                word_counts[w] += int(f)
        prev_root, prev_pc = new_root, final_pc
    # each PV word revealed exactly once across the whole chain
    return all(c == 1 for c in word_counts)
