"""Recursive aggregation nodes: verifier-in-circuit proof trees (the
reference's `zkvm_prover_tpu/recursion/aggregation.py`).

An aggregation node is a machine proof of a wire circuit that

  1. VERIFIES each child STARK proof inside the constraint system
     (`verify_in_circuit`: transcript replay, OOD DEEP-ALI check, logUp
     balance, Merkle openings, FRI folds, PoW), and
  2. binds a Poseidon2 sponge digest over (child machine vk, child public
     values) into its own public values.

A node proof therefore *implies* child validity — no host pre-verification
anywhere in the tree. This is the framework's analog of openvm's
leaf/internal aggregation programs (reference: in-guest `verify_stark` at
crates/types/circuit/src/lib.rs:138-154; tree config
`{num_children_leaf: 4, num_children_internal: 3}` at
crates/prover/src/prover/mod.rs:47-60).

Design notes (TPU-first divergences from openvm):
- Nodes are *depth-specific straight-line wire programs* rather than one
  self-similar RISC-V verifier program: each level's program bakes the
  child machines' verification keys (shape + preprocessed-commitment
  digests) in as constants. The program is itself preprocessed trace —
  vk material — so "which children a node accepts" is pinned by the node's
  own vk. Tree depth is logarithmic, so the program family is small.
- The digest sponge carries a level/domain tag (leaf=1, internal=2,
  input-commit=3) and the child vk words, giving leaf/internal domain
  separation and binding which *program* produced each child proof.

Siblings at every level are independent machine proofs (the proof-tree DP
axis, SURVEY.md §2.3); `aggregate(workers > 1)` proves the leaf level's
siblings in a spawn process pool (`parallel/pool.py`).

Node proofs and the preprocessed commitments of child slots run on the card
unless given another device; the wire programs build on the host.
"""


from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..fields import babybear as bb
from ..models.air import Air
from ..models.poseidon2_air import permute_canonical
from ..models.symbolic import serialize_air
from ..stark import machine
from ..stark.config import StarkConfig
from .builder import CircuitBuilder, Wire
from .stark_verifier import (
    ChildShape,
    DummyOracle,
    RealOracle,
    compute_pre_roots,
    shape_of,
    verify_in_circuit,
)
from .wire_air import PublicBindAir

P = bb.P
RATE = 8
WIDTH = 16
DIGEST_WORDS = 8

TAG_LEAF = 1
TAG_INTERNAL = 2
TAG_INPUT_COMMIT = 3


# ---------------------------------------------------------------------------
# Machine verification keys
# ---------------------------------------------------------------------------


def _sponge_words(felts: Sequence[int]) -> np.ndarray:
    """Overwrite-mode rate-8 Poseidon2 sponge over canonical felts."""
    state = np.zeros((1, WIDTH), dtype=np.uint32)
    padded = list(felts) + [0] * (-len(felts) % RATE)
    for b in range(0, len(padded), RATE):
        state[0, :RATE] = padded[b : b + RATE]
        state = permute_canonical(state)
    return state[0, :DIGEST_WORDS].copy()


def _vk_words(airs: Sequence[Air], shape: ChildShape,
              pre_roots: Dict[int, np.ndarray]) -> np.ndarray:
    config = shape.config
    felts: List[int] = [
        len(airs),
        config.fri.log_blowup,
        config.fri.num_queries,
        config.fri.proof_of_work_bits,
        config.fri.log_final_poly_len,
        config.coset_shift % P,
    ]
    for (log_n, w, n_pvs), ic, pw in zip(
        shape.metas, shape.inter_counts, shape.pre_widths
    ):
        felts += [log_n, w, n_pvs, ic, pw]
    for air in airs:
        felts += constraint_digest_felts(air)
    for lm in sorted(pre_roots):
        felts += [lm] + [int(v) for v in pre_roots[lm]]
    return _sponge_words(felts)


def machine_vk_words(airs: Sequence[Air], log_ns: Sequence[int],
                     config: StarkConfig, device=None) -> np.ndarray:
    """8-word commitment to a machine: its shape, config, constraint
    structure, and preprocessed commitments (made on `device`). Changing
    any constraint, interaction, preprocessed (program ROM) word, or trace
    height changes the vk (reference commitment semantics:
    crates/prover/src/prover/mod.rs:129-174)."""
    shape = shape_of(airs, log_ns, config)
    return _vk_words(airs, shape, compute_pre_roots(airs, shape, device))


def machine_vk_bytes(airs, log_ns, config, device=None) -> bytes:
    words = machine_vk_words(airs, log_ns, config, device)
    return b"".join(int(w).to_bytes(4, "little") for w in words)


def constraint_digest_felts(air: Air) -> List[int]:
    """Structural digest of an AIR's constraint system: serialize the
    symbolic constraint/interaction DAG and sponge it. Two AIRs that differ
    in any constraint, selector, constant, or bus wiring digest
    differently."""
    return [int(v) for v in _sponge_words(serialize_air(air))]


# ---------------------------------------------------------------------------
# Node digest (host mirror of the in-circuit sponge)
# ---------------------------------------------------------------------------


def _child_felts(vk_words: Sequence[int], pvs: Sequence[int]) -> List[int]:
    rec = [int(v) % P for v in vk_words] + [int(v) % P for v in pvs]
    rec += [0] * (-len(rec) % RATE)
    return rec


def node_digest_words(tag: int,
                      children: Sequence[Tuple[Sequence[int], Sequence[int]]]
                      ) -> np.ndarray:
    """Digest over [tag, n_children | pad] + per child [vk words | pvs |
    pad]. The in-circuit sponge computes exactly this stream."""
    felts = [tag, len(children)] + [0] * (RATE - 2)
    for vk_words, pvs in children:
        felts += _child_felts(vk_words, pvs)
    return _sponge_words(felts)


def digest_bytes(words) -> bytes:
    return b"".join(int(w).to_bytes(4, "little") for w in words)


def input_commit(vk_words: Sequence[int], pvs: Sequence[int]) -> bytes:
    """Per-child commitment handed to parent proving tasks (the deferral
    `input_commits` analog, crates/integration/src/lib.rs:461-514)."""
    return digest_bytes(
        node_digest_words(TAG_INPUT_COMMIT, [(vk_words, pvs)])
    )


# ---------------------------------------------------------------------------
# Child slot description
# ---------------------------------------------------------------------------


@dataclass
class ChildSlot:
    """One child machine the node verifies: AIR definitions + fixed trace
    heights + proof config. Shape is vk material — a proof of different
    shape cannot enter this slot. device: where the preprocessed
    commitments are made (None: the card)."""

    airs: List[Air]
    log_ns: List[int]
    config: StarkConfig
    device: object = None
    shape: ChildShape = field(init=False)
    pre_roots: Dict[int, np.ndarray] = field(init=False)
    vk_words: np.ndarray = field(init=False)

    def __post_init__(self):
        self.shape = shape_of(self.airs, self.log_ns, self.config)
        self.pre_roots = compute_pre_roots(self.airs, self.shape, self.device)
        self.vk_words = _vk_words(self.airs, self.shape, self.pre_roots)


# ---------------------------------------------------------------------------
# Circuit construction (shared by standalone nodes and combined app machines)
# ---------------------------------------------------------------------------


def build_child_verification(tag: int, slots: Sequence[ChildSlot],
                             oracles: Sequence) -> List[machine.AirInstance]:
    """Wire instances that verify one child proof per slot and bind the
    node digest (sponge over tag, n_children, and per-child vk words + PVs)
    into PublicBindAir public values. The program is deterministic in
    (tag, slots) alone — building with DummyOracles yields the identical
    preprocessed program (vk material)."""
    bld = CircuitBuilder(n_public_slots=2)
    zero = bld.const(0)

    state: List[Wire] = [zero] * WIDTH

    def absorb(block: List[Wire]) -> None:
        nonlocal state
        state = bld.poseidon(block + state[RATE:])

    header = [bld.const(tag), bld.const(len(slots))]
    absorb(header + [zero] * (RATE - 2))

    for slot, oracle in zip(slots, oracles):
        out = verify_in_circuit(
            bld, slot.airs, slot.shape, oracle,
            pre_mode="constant", pre_roots=slot.pre_roots,
        )
        felts: List[Wire] = [bld.const(int(v)) for v in slot.vk_words]
        for pvs in out.child_pvs:
            felts += pvs
        felts += [zero] * (-len(felts) % RATE)
        for b in range(0, len(felts), RATE):
            absorb(felts[b : b + RATE])

    digest = state[:DIGEST_WORDS]
    for s in range(2):
        lanes = digest[4 * s : 4 * s + 4]
        slot_w = bld.set_public(s, tuple(w.base for w in lanes))
        bld.assert_eq(bld.pack_ext(lanes), slot_w)
    return bld.finalize()


def verification_digest_of(instances: Sequence[machine.AirInstance]) -> bytes:
    """The digest bound by build_child_verification's PublicBindAir."""
    for inst in instances:
        if isinstance(inst.air, PublicBindAir):
            return digest_bytes(
                np.array(inst.public_values, dtype=np.uint32)
            )
    raise ValueError("no PublicBindAir instance")


_VERIFICATION_AIRS_CACHE: "OrderedDict[Tuple, List[Air]]" = OrderedDict()
_VERIFICATION_AIRS_CACHED = 4  # a program may hold 2^24 rows: keep a few


def child_verification_airs(tag: int, slots: Sequence[ChildSlot]
                            ) -> List[Air]:
    """The wire AIRs (with preprocessed programs) a verifier reconstructs
    for a given (tag, slots) signature — deterministic, no proof needed.
    The last few signatures are cached."""
    key = (tag,) + tuple(s.vk_words.tobytes() for s in slots)
    if key in _VERIFICATION_AIRS_CACHE:
        _VERIFICATION_AIRS_CACHE.move_to_end(key)
    else:
        dummy = build_child_verification(
            tag, slots, [DummyOracle()] * len(slots)
        )
        _VERIFICATION_AIRS_CACHE[key] = [i.air for i in dummy]
        while len(_VERIFICATION_AIRS_CACHE) > _VERIFICATION_AIRS_CACHED:
            _VERIFICATION_AIRS_CACHE.popitem(last=False)
    return _VERIFICATION_AIRS_CACHE[key]


# ---------------------------------------------------------------------------
# The node program
# ---------------------------------------------------------------------------


class AggNodeProgram:
    """A compiled aggregation-node circuit for a fixed (tag, child slots)
    signature. The wire program is deterministic in the slots alone —
    `vk_words()` commits to it. device: where the node's proofs and
    preprocessed commitments run (None: the card)."""

    def __init__(self, tag: int, slots: Sequence[ChildSlot],
                 node_config: Optional[StarkConfig] = None, device=None):
        self.tag = tag
        self.slots = list(slots)
        self.node_config = node_config or (
            slots[0].config if slots else StarkConfig()
        )
        self.device = device
        # one dummy build pins the program + machine shape
        dummy = self._build([DummyOracle()] * len(self.slots))
        self._airs = [i.air for i in dummy]
        self._log_ns = [
            int(i.trace.shape[0]).bit_length() - 1 for i in dummy
        ]
        self._vk_words = machine_vk_words(
            self._airs, self._log_ns, self.node_config, device
        )

    # -- circuit construction ---------------------------------------------
    def _build(self, oracles) -> List[machine.AirInstance]:
        return build_child_verification(self.tag, self.slots, oracles)

    # -- public API --------------------------------------------------------
    def machine_airs(self) -> List[Air]:
        """AIRs (with preprocessed programs) for verification."""
        return self._airs

    def vk_words(self) -> np.ndarray:
        return self._vk_words

    def vk_bytes(self) -> bytes:
        return digest_bytes(self._vk_words)

    def expected_digest(
        self, child_proofs: Sequence[machine.MachineProof]
    ) -> np.ndarray:
        children = [
            (slot.vk_words, [v for (_, _, pvs) in pf.meta for v in pvs])
            for slot, pf in zip(self.slots, child_proofs)
        ]
        return node_digest_words(self.tag, children)

    def prove(self, child_proofs: Sequence[machine.MachineProof]
              ) -> Tuple[machine.MachineProof, bytes]:
        """Prove the node over concrete child proofs. NOTE: no host-side
        verification of the children happens here — if any child is
        invalid, the produced node proof fails verification."""
        if len(child_proofs) != len(self.slots):
            raise ValueError("one child proof per slot")
        instances = self._build([RealOracle(p) for p in child_proofs])
        proof = machine.prove_machine(instances, self.node_config, device=self.device)
        digest = self.expected_digest(child_proofs)
        return proof, digest_bytes(digest)

    def verify(self, proof: machine.MachineProof,
               expected_digest: Optional[bytes] = None) -> bool:
        """Verify a node proof; child validity is implied by the
        constraints. Optionally pins the revealed digest."""
        if not machine.verify_machine(self._airs, proof, self.node_config,
                                      device=self.device):
            return False
        if expected_digest is not None:
            return self.digest_of(proof) == expected_digest
        return True

    @staticmethod
    def digest_of(proof: machine.MachineProof) -> bytes:
        """The 32-byte digest revealed by a node proof (PublicBindAir
        public values)."""
        for (_, w, pvs) in proof.meta:
            if w == 1 and len(pvs) == 8:  # PublicBindAir(2 slots)
                return digest_bytes(np.array(pvs, dtype=np.uint32))
        raise ValueError("proof carries no 8-word public digest")


# ---------------------------------------------------------------------------
# Tree orchestration
# ---------------------------------------------------------------------------


@dataclass
class AggregationTreeConfig:
    """Mirrors reference AggregationTreeConfig (prover/mod.rs:54-60)."""

    num_children_leaf: int = 4
    num_children_internal: int = 3


@dataclass
class AggNodeProof:
    proof: machine.MachineProof
    pi_hash: bytes               # the revealed digest
    level: str                   # "leaf" | "internal" | "root"
    program: AggNodeProgram
    children_digests: List[bytes] = field(default_factory=list)
    # a leaf proved in a pool worker: the worker's launches and C calls
    # (`_prove_leaf_node_worker`); empty for a node proved in this process
    stat: Dict = field(default_factory=dict)


def _kernel_counters():
    """This process's launch counters of the STARK kernels (K1, K2, K3)."""
    from ..ops import mont_matmul as mm
    from ..ops import ntt_fused
    from ..ops import poseidon2 as p2

    return ntt_fused.launches, p2.launches, mm.launches


def _read_counters() -> Dict[str, int]:
    return {k: v for d in _kernel_counters() for k, v in d.items()}


def _prove_leaf_node_worker(payload: dict) -> dict:
    """Rebuild the child slot and the leaf program from the registered app
    and prove one node over its (serialized) child proofs, on the device the
    payload names (None: the card). The slot is built at the children's own
    config and must have the parent's vk.

    Returns the proof's bytes and what this task launched in this process
    (the counters are zeroed at its start): `setup_launches` while building
    the slot and the program, `launches` while proving, and on a card every
    C call of the task as (entry, args)."""
    import contextlib

    from .. import _build
    from .. import host  # noqa: F401 (registers the apps app_for_vk searches)
    from ..host import serialization
    from ..host.app import app_for_vk
    from ..parallel.pool import stark_config_from
    from ..stark.config import resolve_device

    app = app_for_vk(bytes.fromhex(payload["app_vk"]))
    if app is None:
        raise ValueError("unknown app vk in leaf-node worker")
    device = resolve_device(payload["device"])
    for d in _kernel_counters():
        for k in d:
            d[k] = 0
    log = _build.log_calls() if device.type == "cuda" else contextlib.nullcontext([])
    with log as calls:
        mps = [serialization.decode_machine_proof(b) for b in payload["proofs"]]
        meta = mps[0].meta
        slot = ChildSlot(app.airs_for_meta(meta), [ln for (ln, _, _) in meta],
                         stark_config_from(payload["child_config"]), device)
        if slot.vk_words.tobytes().hex() != payload["child_vk"]:
            raise ValueError("the worker's child slot has another vk than the prover's")
        prog = AggNodeProgram(TAG_LEAF, [slot] * len(mps),
                              stark_config_from(payload["node_config"]), device)
        setup = _read_counters()
        proof, _ = prog.prove(mps)
    total = _read_counters()
    return {"proof": serialization.encode_machine_proof(proof),
            "setup_launches": setup,
            "launches": {k: total[k] - setup[k] for k in total},
            "calls": list(calls), "device": str(device)}


def _prove_leaf_nodes_pool(groups, app_vk: bytes, app_slot: ChildSlot,
                           node_config: StarkConfig, workers: int, device=None):
    """One leaf node per group of child proofs over `app_slot`, proved by
    `workers` spawned processes on `device` (None: the card; see
    `parallel/pool.py`). `prove_machine` is deterministic, so each proof
    equals the serial one. Returns (proof, stat) per group, stat the
    worker's report of the task (`_prove_leaf_node_worker`)."""
    from ..host import serialization
    from ..parallel.pool import pool_device, spawn_pool, stark_config_dict

    spec = pool_device(device)
    payloads = [
        {
            "app_vk": app_vk.hex(),
            "child_config": stark_config_dict(app_slot.config),
            "child_vk": app_slot.vk_words.tobytes().hex(),
            "node_config": stark_config_dict(node_config),
            "device": None if device is None else str(device),
            "proofs": [serialization.encode_machine_proof(p) for p in group],
        }
        for group in groups
    ]
    with spawn_pool(workers, spec) as ex:
        done = list(ex.map(_prove_leaf_node_worker, payloads))
    return [(serialization.decode_machine_proof(r.pop("proof")), r) for r in done]


class RecursiveAggregationProver:
    """Drives the leaf(4)/internal(3) tree over child machine proofs with
    verifier-in-circuit nodes. Node programs are cached per signature."""

    def __init__(self, app_slot: ChildSlot,
                 node_config: Optional[StarkConfig] = None,
                 tree: Optional[AggregationTreeConfig] = None,
                 device=None):
        self.app_slot = app_slot
        self.node_config = node_config or app_slot.config
        self.tree = tree or AggregationTreeConfig()
        self.device = device
        self._programs: Dict[Tuple, AggNodeProgram] = {}

    def _program(self, tag: int, slots: Tuple[ChildSlot, ...]
                 ) -> AggNodeProgram:
        key = (tag,) + tuple(bytes(s.vk_words.tobytes()) for s in slots)
        if key not in self._programs:
            self._programs[key] = AggNodeProgram(
                tag, list(slots), self.node_config, self.device
            )
        return self._programs[key]

    def _node_slot(self, program: AggNodeProgram) -> ChildSlot:
        return ChildSlot(
            program.machine_airs(), program._log_ns, program.node_config,
            self.device,
        )

    def aggregate(self, child_proofs: Sequence[machine.MachineProof],
                  workers: int = 1, app_vk: Optional[bytes] = None,
                  ) -> List[List[AggNodeProof]]:
        """Full tree; returns proofs per level, root last (single node).

        workers > 1 proves the LEAF level's sibling nodes in parallel OS
        processes (the proof-tree parallelism axis, SURVEY.md §2.3:
        siblings are independent proofs, and internal levels shrink
        geometrically, so the leaf level is where the width is), each on
        this prover's device. It needs `app_vk`, a registered app's vk, so
        the workers can rebuild the child slot; the proofs equal the serial
        path's (prove_machine is deterministic)."""
        levels: List[List[AggNodeProof]] = []
        k = self.tree.num_children_leaf
        groups = [list(child_proofs[i : i + k])
                  for i in range(0, len(child_proofs), k)]
        current: List[AggNodeProof] = []
        if workers > 1 and len(groups) > 1:
            if app_vk is None:
                raise ValueError("parallel leaf proving needs the registered app vk")
            proved = _prove_leaf_nodes_pool(groups, app_vk, self.app_slot,
                                            self.node_config, workers, self.device)
            for group, (mproof, stat) in zip(groups, proved):
                prog = self._program(TAG_LEAF, tuple([self.app_slot] * len(group)))
                current.append(AggNodeProof(
                    proof=mproof, pi_hash=digest_bytes(prog.expected_digest(group)),
                    level="leaf", program=prog, stat=stat,
                ))
        else:
            for group in groups:
                prog = self._program(
                    TAG_LEAF, tuple([self.app_slot] * len(group))
                )
                proof, pi = prog.prove(group)
                current.append(AggNodeProof(
                    proof=proof, pi_hash=pi, level="leaf", program=prog,
                ))
        levels.append(current)

        k = self.tree.num_children_internal
        while len(current) > 1:
            nxt: List[AggNodeProof] = []
            for i in range(0, len(current), k):
                group = current[i : i + k]
                slots = tuple(self._node_slot(n.program) for n in group)
                prog = self._program(TAG_INTERNAL, slots)
                proof, pi = prog.prove([n.proof for n in group])
                nxt.append(AggNodeProof(
                    proof=proof, pi_hash=pi, level="internal",
                    program=prog,
                    children_digests=[n.pi_hash for n in group],
                ))
            current = nxt
            levels.append(current)
        levels[-1][-1].level = "root"
        return levels
