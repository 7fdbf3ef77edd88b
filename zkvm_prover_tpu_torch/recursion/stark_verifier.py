"""In-circuit STARK verifier: compiles `stark.machine.verify_machine` and
`stark.fri.verify` into a wire program over a child proof (the reference's
`zkvm_prover_tpu/recursion/stark_verifier.py`).

This is the framework's analog of openvm's recursion verifier programs
(in-guest `verify_stark`, crates/types/circuit/src/lib.rs:138-154;
leaf/internal aggregation, crates/prover/src/prover/mod.rs:47-60): a
machine proof of the wire circuit implies the child STARK proof verifies —
transcript replay, out-of-domain DEEP-ALI constraint check, logUp balance,
Merkle openings, FRI folds and proof-of-work, all as constraints. No host
pre-verification of the child is required.

The program depends only on the child proof SHAPE (AIR list, per-AIR trace
heights, config); the proof bytes are the witness, read through a proof
oracle so that a `DummyOracle` build extracts the identical program (vk
material) without any proof.

Child program identity:
  - `pre_mode="constant"`: the child's preprocessed commitments are baked
    into the program (pins one exact child circuit: leaf nodes over a
    fixed app).
  - `pre_mode="witness"`: the child's preprocessed roots are witness wires
    returned to the caller, to be bound into this proof's public digest
    (internal nodes of the self-similar recursion tower: the openvm
    "commit child vk as input" pattern).

The program builds on the host. `compute_pre_roots` runs on the card (K1
in the LDEs, K2 in the trees) unless given another device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..fields import babybear as bb
from ..models.air import Air, AirBuilder, LOG_QUOTIENT_DEGREE, TraceBuilder
from ..stark.config import StarkConfig
from ..stark.machine import MachineProof, _shift_for, preprocessed_roots
from .builder import CircuitBuilder, Wire

P = bb.P
N_CHUNKS = 1 << LOG_QUOTIENT_DEGREE
RATE = 8
WIDTH = 16
DIGEST = 8


def _canon(arr) -> np.ndarray:
    """Montgomery uint32 array -> canonical int64 numpy."""
    return bb.from_monty_np(np.asarray(arr, dtype=np.uint32)).astype(np.int64)


# ---------------------------------------------------------------------------
# Child shape
# ---------------------------------------------------------------------------


@dataclass
class ChildShape:
    """Static description of the proofs the program verifies."""

    metas: List[Tuple[int, int, int]]      # (log_n, width, n_pvs) per AIR
    inter_counts: List[int]
    pre_widths: List[int]                   # 0 = no preprocessed columns
    config: StarkConfig

    @property
    def log_ms(self) -> List[int]:
        return [ln + self.config.log_blowup for (ln, _, _) in self.metas]

    @property
    def log_max(self) -> int:
        return max(self.log_ms)

    @property
    def heights(self) -> List[int]:
        return sorted(set(self.log_ms), reverse=True)


def shape_of(airs: Sequence[Air], log_ns: Sequence[int],
             config: StarkConfig) -> ChildShape:
    """Derive the shape from AIR definitions + per-AIR trace log-heights."""
    metas = []
    inter_counts = []
    pre_widths = []
    for air, ln in zip(airs, log_ns):
        metas.append((int(ln), air.width, air.num_public_values))
        pre = air.preprocessed_trace()
        pre_widths.append(0 if pre is None else int(pre.shape[1]))
        zero_pre = (
            None if pre is None
            else torch.zeros((2, pre.shape[1]), dtype=bb.DTYPE)
        )
        tb = TraceBuilder(
            torch.zeros((2, air.width), dtype=bb.DTYPE),
            [0] * air.num_public_values,
            pre_m=zero_pre,
        )
        air.eval(tb)
        inter_counts.append(len(tb.interactions))
    return ChildShape(metas, inter_counts, pre_widths, config)


def compute_pre_roots(airs: Sequence[Air], shape: ChildShape, device=None
                      ) -> Dict[int, np.ndarray]:
    """Preprocessed commitments per height (canonical digests): vk
    material, recomputed exactly like machine.verify_machine. device: None
    (the card) or an explicit torch device."""
    pres = [air.preprocessed_trace() for air in airs]
    for pre, (log_n, _, _) in zip(pres, shape.metas):
        if pre is not None and pre.shape[0] != (1 << log_n):
            raise ValueError("a preprocessed trace does not have its AIR's height")
    roots = preprocessed_roots(pres, shape.log_ms, shape.config, device)
    return {lm: _canon(r) for lm, r in roots.items()}


# ---------------------------------------------------------------------------
# Proof oracles
# ---------------------------------------------------------------------------


class DummyOracle:
    """Shape-only oracle: zeros everywhere. Builds the program (vk) without
    a proof; the resulting witness values are garbage by design."""

    def meta_pvs(self, i: int, n: int) -> List[int]:
        return [0] * n

    def root(self, tree: str, lm: int) -> List[int]:
        return [0] * DIGEST

    def claimed_sum(self, i: int) -> List[int]:
        return [0, 0, 0, 0]

    def opened(self, i: int, kind: str, n_cols: int) -> List[List[int]]:
        return [[0, 0, 0, 0] for _ in range(n_cols)]

    def fri_commit(self, r: int) -> List[int]:
        return [0] * DIGEST

    def fri_final(self, n: int) -> List[List[int]]:
        return [[0, 0, 0, 0] for _ in range(n)]

    def pow_witness(self) -> int:
        return 0

    def fri_opening_row(self, r: int, qi: int, hi: bool) -> List[int]:
        return [0, 0, 0, 0]

    def fri_opening_siblings(self, r: int, qi: int, hi: bool,
                             n_levels: int) -> List[List[int]]:
        return [[0] * DIGEST for _ in range(n_levels)]

    def query_rows(self, lm: int, pos: int, tree: str,
                   widths: List[int]) -> List[List[int]]:
        return [[0] * w for w in widths]

    def query_siblings(self, lm: int, pos: int, tree: str,
                       n_levels: int) -> List[List[int]]:
        return [[0] * DIGEST for _ in range(n_levels)]


def _expect(ok: bool, what: str) -> None:
    if not ok:
        raise ValueError(f"the child proof's {what} do not have the slot's shape")


class RealOracle(DummyOracle):
    """Reads witness values out of an actual MachineProof."""

    _TREE_ROOTS = {
        "trace": "trace_roots", "quotient": "quotient_roots",
        "perm": "perm_roots", "pre": "pre_roots",
    }

    def __init__(self, proof: MachineProof):
        self.proof = proof

    def meta_pvs(self, i, n):
        pvs = self.proof.meta[i][2]
        _expect(len(pvs) == n, "public values")
        return [int(v) % P for v in pvs]

    def root(self, tree, lm):
        return _canon(getattr(self.proof, self._TREE_ROOTS[tree])[lm]).tolist()

    def claimed_sum(self, i):
        return _canon(self.proof.claimed_sums[i]).tolist()

    def opened(self, i, kind, n_cols):
        ov = self.proof.opened[i]
        arr = {
            "trace_z": ov.trace_zeta, "trace_zn": ov.trace_zeta_next,
            "quot": ov.quotient,
            "perm_z": ov.perm_zeta, "perm_zn": ov.perm_zeta_next,
            "pre_z": ov.pre_zeta, "pre_zn": ov.pre_zeta_next,
        }[kind]
        out = _canon(np.asarray(arr).reshape(-1, 4)).tolist()
        _expect(len(out) == n_cols, f"opened {kind} columns")
        return out

    def fri_commit(self, r):
        return _canon(self.proof.fri_proof.commitments[r]).tolist()

    def fri_final(self, n):
        out = _canon(
            np.asarray(self.proof.fri_proof.final_poly).reshape(-1, 4)
        ).tolist()
        _expect(len(out) == n, "final polynomial")
        return out

    def pow_witness(self):
        return int(self.proof.fri_proof.pow_witness)

    def _fri_op(self, r, qi, hi):
        lo_op, hi_op = self.proof.fri_proof.rounds[r].openings[qi]
        return hi_op if hi else lo_op

    def fri_opening_row(self, r, qi, hi):
        return _canon(self._fri_op(r, qi, hi).rows[0]).tolist()

    def fri_opening_siblings(self, r, qi, hi, n_levels):
        op = self._fri_op(r, qi, hi)
        _expect(len(op.siblings) == n_levels, "FRI opening path")
        return [_canon(s).tolist() for s in op.siblings]

    def _qo(self, lm, pos, tree):
        # A tampered proof can shift the sampled indices to positions the
        # prover never opened; fall back to zeros so circuit construction
        # still succeeds (its constraints then fail, as they must).
        qo = self.proof.query_openings.get(lm, {}).get(pos)
        if qo is None:
            return None
        return {
            "trace": qo.trace, "quotient": qo.quotient,
            "perm": qo.perm, "pre": qo.pre,
        }[tree]

    def query_rows(self, lm, pos, tree, widths):
        op = self._qo(lm, pos, tree)
        if op is None:
            return [[0] * w for w in widths]
        rows = [_canon(r).tolist() for r in op.rows]
        _expect([len(r) for r in rows] == list(widths), "query rows")
        return rows

    def query_siblings(self, lm, pos, tree, n_levels):
        op = self._qo(lm, pos, tree)
        if op is None:
            return [[0] * DIGEST for _ in range(n_levels)]
        _expect(len(op.siblings) == n_levels, "query opening path")
        return [_canon(s).tolist() for s in op.siblings]


# ---------------------------------------------------------------------------
# Wire challenger (mirrors stark.challenger.Challenger exactly)
# ---------------------------------------------------------------------------


class WireChallenger:
    def __init__(self, bld: CircuitBuilder):
        self.bld = bld
        zero = bld.const(0)
        self.state: List[Wire] = [zero] * WIDTH
        self.input_buffer: List[Wire] = []
        self.output_buffer: List[Wire] = []

    def observe(self, w: Wire) -> None:
        self.output_buffer.clear()
        self.input_buffer.append(w)
        if len(self.input_buffer) == RATE:
            self._duplex()

    def observe_const_u32(self, v: int) -> None:
        self.observe(self.bld.const(int(v) % P))

    def observe_many(self, ws: Sequence[Wire]) -> None:
        for w in ws:
            self.observe(w)

    def _duplex(self) -> None:
        k = len(self.input_buffer)
        state_in = list(self.input_buffer) + self.state[k:]
        self.input_buffer.clear()
        out = self.bld.poseidon(state_in)
        self.state = out
        self.output_buffer = list(out[:RATE])

    def sample(self) -> Wire:
        if self.input_buffer or not self.output_buffer:
            self._duplex()
        return self.output_buffer.pop()

    def sample_ext(self) -> Wire:
        return self.bld.pack_ext([self.sample() for _ in range(4)])

    def sample_bits(self, n_bits: int) -> List[Wire]:
        """Low n_bits of a canonical sample, LSB first (boolean wires)."""
        v = self.sample()
        bits = self.bld.decompose_bits(v, 31, canonical=True)
        # unused high bits still carry fanout from the recomposition
        return bits[:n_bits]

    def check_pow(self, pow_bits: int, nonce: Wire) -> None:
        self.observe(nonce)
        v = self.sample()
        bits = self.bld.decompose_bits(v, 31, canonical=True)
        for i in range(pow_bits):
            self.bld.assert_zero(bits[i])


# ---------------------------------------------------------------------------
# Wire point-builder for the OOD constraint check
# ---------------------------------------------------------------------------


class WirePointBuilder(AirBuilder):
    """AirBuilder over wires at the out-of-domain point (PointBuilder
    analog, models/air.py)."""

    def __init__(self, bld: CircuitBuilder, local, next_, sels, pvs,
                 pre=None, pre_next=None):
        self.bld = bld
        self._local = local
        self._next = next_
        self._pre_w = pre
        self._pre_next_w = pre_next
        self._sels = sels
        self._pvs = pvs
        self._constraints: List[Wire] = []
        self._interactions: List = []

    def local(self, col):
        return self._local[col]

    def next(self, col):
        return self._next[col]

    def preprocessed(self, col):
        return self._pre_w[col]

    def preprocessed_next(self, col):
        return self._pre_next_w[col]

    def public_value(self, i):
        return self._pvs[i]

    @property
    def is_first_row(self):
        return self._sels["first"]

    @property
    def is_last_row(self):
        return self._sels["last"]

    @property
    def is_transition(self):
        return self._sels["transition"]

    def add(self, a, b):
        return self.bld.add(a, b)

    def sub(self, a, b):
        return self.bld.sub(a, b)

    def mul(self, a, b):
        return self.bld.mul(a, b)

    def constant(self, v):
        return self.bld.const(int(v) % P)


# ---------------------------------------------------------------------------
# The verifier program
# ---------------------------------------------------------------------------


@dataclass
class VerifyOutputs:
    """Wires the caller binds into the node's public digest."""

    child_pvs: List[List[Wire]]             # per AIR
    pre_root_wires: Dict[int, List[Wire]]   # only in pre_mode="witness"


def verify_in_circuit(
    bld: CircuitBuilder,
    child_airs: Sequence[Air],
    shape: ChildShape,
    oracle,
    pre_mode: str = "constant",
    pre_roots: Optional[Dict[int, np.ndarray]] = None,
) -> VerifyOutputs:
    """Emit the full verification of one child proof into `bld`.

    pre_roots: canonical per-height digests (required for "constant" mode
    when any child AIR has preprocessed columns; compute via
    `compute_pre_roots`).
    """
    cfg = shape.config
    fri_cfg = cfg.fri
    g = cfg.coset_shift % P
    metas = shape.metas
    log_ms = shape.log_ms
    log_max = shape.log_max
    heights = shape.heights
    inter_counts = shape.inter_counts
    pre_widths = shape.pre_widths
    n_airs = len(metas)
    if cfg.log_blowup != 1:
        raise ValueError("the in-circuit quotient split assumes blowup 2")

    ch = WireChallenger(bld)
    zero = bld.const(0)
    one = bld.const(1)

    def wit(v) -> Wire:
        return bld.witness(v)

    def wit_list(vs) -> List[Wire]:
        return [bld.witness(v) for v in vs]

    def pack_cols(cols: List[List[Wire]]) -> List[Wire]:
        """Per column: 4 base wires -> ext wire (from_base_cols analog)."""
        return [bld.pack_ext(c) for c in cols]

    # ---- transcript: meta ------------------------------------------------
    ch.observe_const_u32(n_airs)
    child_pvs: List[List[Wire]] = []
    for i, (log_n, w, n_pvs) in enumerate(metas):
        ch.observe_const_u32(log_n)
        ch.observe_const_u32(w)
        pvs = wit_list(oracle.meta_pvs(i, n_pvs))
        ch.observe_many(pvs)
        child_pvs.append(pvs)

    # ---- preprocessed roots ---------------------------------------------
    pre_heights = [
        lm for lm in heights
        if any(log_ms[i] == lm and pre_widths[i] for i in range(n_airs))
    ]
    pre_root_wires: Dict[int, List[Wire]] = {}
    for lm in pre_heights:
        if pre_mode == "constant":
            if pre_roots is None or lm not in pre_roots:
                raise ValueError("constant pre_mode requires precomputed pre_roots")
            pre_root_wires[lm] = [
                bld.const(int(v)) for v in pre_roots[lm]
            ]
        else:
            pre_root_wires[lm] = wit_list(oracle.root("pre", lm))
        ch.observe_many(pre_root_wires[lm])

    # ---- trace roots, beta/z, perm roots, claimed sums -------------------
    trace_roots = {
        lm: wit_list(oracle.root("trace", lm)) for lm in heights
    }
    for lm in heights:
        ch.observe_many(trace_roots[lm])
    beta = ch.sample_ext()
    z = ch.sample_ext()

    perm_heights = [
        lm for lm in heights
        if any(log_ms[i] == lm and inter_counts[i] for i in range(n_airs))
    ]
    perm_roots = {
        lm: wit_list(oracle.root("perm", lm)) for lm in perm_heights
    }
    for lm in perm_heights:
        ch.observe_many(perm_roots[lm])

    claimed_lanes: List[Optional[List[Wire]]] = []
    for i in range(n_airs):
        if inter_counts[i]:
            lanes = wit_list(oracle.claimed_sum(i))
            ch.observe_many(lanes)
            claimed_lanes.append(lanes)
        else:
            claimed_lanes.append(None)
    alpha = ch.sample_ext()

    quotient_roots = {
        lm: wit_list(oracle.root("quotient", lm)) for lm in heights
    }
    for lm in heights:
        ch.observe_many(quotient_roots[lm])
    zeta = ch.sample_ext()

    # ---- openings --------------------------------------------------------
    opened: List[Dict[str, List[List[Wire]]]] = []
    for i, (log_n, w, _) in enumerate(metas):
        ov: Dict[str, List[List[Wire]]] = {}
        for kind, n_cols in (("trace_z", w), ("trace_zn", w),
                             ("quot", 4 * N_CHUNKS)):
            cols = [wit_list(c) for c in oracle.opened(i, kind, n_cols)]
            for c in cols:
                ch.observe_many(c)
            ov[kind] = cols
        if inter_counts[i]:
            k = inter_counts[i]
            for kind in ("perm_z", "perm_zn"):
                cols = [
                    wit_list(c) for c in oracle.opened(i, kind, 4 * k + 4)
                ]
                for c in cols:
                    ch.observe_many(c)
                ov[kind] = cols
        if pre_widths[i]:
            for kind in ("pre_z", "pre_zn"):
                cols = [
                    wit_list(c)
                    for c in oracle.opened(i, kind, pre_widths[i])
                ]
                for c in cols:
                    ch.observe_many(c)
                ov[kind] = cols
        opened.append(ov)
    gamma = ch.sample_ext()

    # packed ext views of every opened column (reused by OOD + DEEP)
    packed: List[Dict[str, List[Wire]]] = [
        {kind: pack_cols(cols) for kind, cols in ov.items()}
        for ov in opened
    ]

    # ---- global logUp balance -------------------------------------------
    if any(inter_counts):
        total = None
        for lanes in claimed_lanes:
            if lanes is None:
                continue
            e = bld.pack_ext(lanes)
            total = e if total is None else bld.add(total, e)
        bld.assert_zero(total)

    # ---- per-AIR OOD constraint check ------------------------------------
    # ext constants
    def ext_const(vals) -> Wire:
        return bld.const(tuple(int(v) % P for v in vals))

    zeta_pow: Dict[int, Wire] = {}  # log_n -> zeta^(2^log_n)

    def zeta_to(log_n: int) -> Wire:
        if log_n not in zeta_pow:
            if log_n == 0:
                zeta_pow[0] = zeta
            else:
                prev = zeta_to(log_n - 1)
                zeta_pow[log_n] = bld.mul(prev, prev)
        return zeta_pow[log_n]

    inv_zh_by_logn: Dict[int, Wire] = {}
    sels_by_logn: Dict[int, Dict[str, Wire]] = {}

    def sels_for(log_n: int) -> Dict[str, Wire]:
        if log_n in sels_by_logn:
            return sels_by_logn[log_n]
        zn = zeta_to(log_n)
        zh = bld.sub(zn, one)
        g_h_inv = pow(bb.two_adic_generator_int(log_n), P - 2, P)
        zm1 = bld.sub(zeta, one)
        zmg = bld.sub(zeta, bld.const(g_h_inv))
        inv_zh = bld.inv(zh)
        sels = {
            "first": bld.mul(zh, bld.inv(zm1)),
            "last": bld.mul(zh, bld.inv(zmg)),
            "transition": zmg,
            "inv_zh": inv_zh,
        }
        sels_by_logn[log_n] = sels
        inv_zh_by_logn[log_n] = inv_zh
        return sels

    interactions_per_air: List[List] = []
    for i, (air, (log_n, w, _), lm) in enumerate(
        zip(child_airs, metas, log_ms)
    ):
        n = 1 << log_n
        shift = _shift_for(lm, log_max, g)
        sels = sels_for(log_n)
        pb = WirePointBuilder(
            bld,
            packed[i]["trace_z"],
            packed[i]["trace_zn"],
            sels,
            child_pvs[i],
            pre=packed[i].get("pre_z"),
            pre_next=packed[i].get("pre_zn"),
        )
        air.eval(pb)
        constraints = list(pb._constraints)
        interactions_per_air.append(pb._interactions)

        if inter_counts[i]:
            k = inter_counts[i]
            # perm column groups: 4 base columns -> one ext element
            def group(kind):
                cols = packed[i][kind]
                out = []
                for j in range(k + 1):
                    lanes4 = cols[4 * j : 4 * j + 4]
                    acc = lanes4[0]
                    for t in range(1, 4):
                        unit = [0, 0, 0, 0]
                        unit[t] = 1
                        acc = bld.add(
                            acc, bld.mul(ext_const(unit), lanes4[t])
                        )
                    out.append(acc)
                return out

            perm_local = group("perm_z")
            perm_next = group("perm_zn")
            claimed_ext = bld.pack_ext(claimed_lanes[i])
            constraints += _wire_perm_constraints(
                bld, pb._interactions, perm_local, perm_next, sels,
                z, beta, claimed_ext,
            )

        # alpha fold
        acc = None
        apow = one
        for cons in constraints:
            term = bld.mul(apow, cons)
            acc = term if acc is None else bld.add(acc, term)
            apow = bld.mul(apow, alpha)
        q_expected = bld.mul(acc, sels["inv_zh"])

        # quotient recombination from chunks
        w_m_int = bb.two_adic_generator_int(lm)
        v = [
            pow((shift * pow(w_m_int, r, P)) % P, n, P)
            for r in range(N_CHUNKS)
        ]
        zeta_n = zeta_to(log_n)
        q_cols = packed[i]["quot"]
        q_zeta = None
        for r in range(N_CHUNKS):
            other = 1 - r
            l_num = bld.sub(zeta_n, bld.const(v[other]))
            denom_inv = pow((v[r] - v[other]) % P, P - 2, P)
            l_r = bld.mul(l_num, bld.const(denom_inv))
            lanes4 = q_cols[4 * r : 4 * r + 4]
            acc_c = lanes4[0]
            for t in range(1, 4):
                unit = [0, 0, 0, 0]
                unit[t] = 1
                acc_c = bld.add(acc_c, bld.mul(ext_const(unit), lanes4[t]))
            term = bld.mul(l_r, acc_c)
            q_zeta = term if q_zeta is None else bld.add(q_zeta, term)
        bld.assert_eq(q_expected, q_zeta)

    # ---- gamma power ladder ----------------------------------------------
    total_terms = 0
    offsets = []
    for i, (_, w, _) in enumerate(metas):
        offsets.append(total_terms)
        total_terms += 2 * w
        if inter_counts[i]:
            total_terms += 2 * (4 * inter_counts[i] + 4)
        total_terms += 2 * pre_widths[i]
        total_terms += 4 * N_CHUNKS
    gammas: List[Wire] = [one]
    for _ in range(1, max(total_terms, 1)):
        gammas.append(bld.mul(gammas[-1], gamma))

    # ---- Merkle helpers --------------------------------------------------
    def hash_row(row: List[Wire]) -> List[Wire]:
        """PaddingFreeSponge over base wires -> 8 digest wires."""
        state = [zero] * WIDTH
        n_blocks = max(1, -(-len(row) // RATE))
        padded = row + [zero] * (n_blocks * RATE - len(row))
        for b_ in range(n_blocks):
            block = padded[b_ * RATE : (b_ + 1) * RATE]
            state = bld.poseidon(block + state[RATE:])
        return state[:DIGEST]

    def compress(l8: List[Wire], r8: List[Wire]) -> List[Wire]:
        return bld.poseidon(l8 + r8)[:DIGEST]

    def verify_path(leaf: List[Wire], idx_bits: List[Wire],
                    siblings: List[List[Wire]],
                    root_w: List[Wire]) -> None:
        d = leaf
        for k, sib in enumerate(siblings):
            b_ = idx_bits[k]
            left = [bld.select(b_, sib[t], d[t]) for t in range(DIGEST)]
            right = [bld.select(b_, d[t], sib[t]) for t in range(DIGEST)]
            d = compress(left, right)
        for t in range(DIGEST):
            bld.assert_eq(d[t], root_w[t])

    def pow_w_from_bits(w_int: int, bits: List[Wire]) -> Wire:
        """w^(sum bits<<i) via selected squarings."""
        acc = None
        cur = w_int % P
        for b_ in bits:
            f = bld.select(b_, bld.const(cur), one)
            acc = f if acc is None else bld.mul(acc, f)
            cur = (cur * cur) % P
        return acc if acc is not None else one

    # ---- DEEP derived-codeword evaluation at a queried position ----------
    zeta_g: Dict[int, Wire] = {}  # log_n -> zeta * g_H

    def zeta_g_for(log_n: int) -> Wire:
        if log_n not in zeta_g:
            g_h = bb.two_adic_generator_int(log_n)
            zeta_g[log_n] = bld.mul(zeta, bld.const(g_h))
        return zeta_g[log_n]

    def acc_cols(row_w: List[Wire], opened_ext: List[Wire],
                 gidx: int) -> Tuple[Wire, int]:
        acc = None
        for j in range(len(row_w)):
            d = bld.sub(row_w[j], opened_ext[j])
            t = bld.mul(gammas[gidx + j], d)
            acc = t if acc is None else bld.add(acc, t)
        return acc, gidx + len(row_w)

    def derived_at(lm: int, pos_bits: List[Wire], pos: int) -> Wire:
        """The verifier-recomputed DEEP codeword value at height lm,
        position pos (bits LSB-first, len == lm). Verifies the Merkle
        openings it consumes."""
        airs_here = [i for i in range(n_airs) if log_ms[i] == lm]
        shift = _shift_for(lm, log_max, g)
        w_m_int = bb.two_adic_generator_int(lm)
        x = bld.mul(bld.const(shift), pow_w_from_bits(w_m_int, pos_bits))

        trace_ws = [metas[i][1] for i in airs_here]
        quot_ws = [4 * N_CHUNKS] * len(airs_here)
        perm_idx = [i for i in airs_here if inter_counts[i]]
        perm_ws = [4 * inter_counts[i] + 4 for i in perm_idx]
        pre_idx = [i for i in airs_here if pre_widths[i]]
        pre_ws = [pre_widths[i] for i in pre_idx]

        rows: Dict[str, List[List[Wire]]] = {}
        for tree, widths, roots_w in (
            ("trace", trace_ws, trace_roots[lm]),
            ("quotient", quot_ws, quotient_roots[lm]),
            ("perm", perm_ws, perm_roots.get(lm)),
            ("pre", pre_ws, pre_root_wires.get(lm)),
        ):
            if not widths:
                continue
            rws = [
                wit_list(r)
                for r in oracle.query_rows(lm, pos, tree, widths)
            ]
            rows[tree] = rws
            sibs = [
                wit_list(s)
                for s in oracle.query_siblings(lm, pos, tree, lm)
            ]
            leaf = hash_row([w for r in rws for w in r])
            verify_path(leaf, pos_bits, sibs, roots_w)

        total = None
        perm_slot = 0
        pre_slot = 0
        for slot, i in enumerate(airs_here):
            log_n, w, _ = metas[i]
            inv_xz = bld.inv(bld.sub(x, zeta))
            inv_xzg = bld.inv(bld.sub(x, zeta_g_for(log_n)))
            gidx = offsets[i]
            trow = rows["trace"][slot]
            a1, gidx = acc_cols(trow, packed[i]["trace_z"], gidx)
            a2, gidx = acc_cols(trow, packed[i]["trace_zn"], gidx)
            term = bld.add(bld.mul(a1, inv_xz), bld.mul(a2, inv_xzg))
            if inter_counts[i]:
                prow = rows["perm"][perm_slot]
                perm_slot += 1
                a3, gidx = acc_cols(prow, packed[i]["perm_z"], gidx)
                a4, gidx = acc_cols(prow, packed[i]["perm_zn"], gidx)
                term = bld.add(
                    term,
                    bld.add(bld.mul(a3, inv_xz), bld.mul(a4, inv_xzg)),
                )
            if pre_widths[i]:
                erow = rows["pre"][pre_slot]
                pre_slot += 1
                a6, gidx = acc_cols(erow, packed[i]["pre_z"], gidx)
                a7, gidx = acc_cols(erow, packed[i]["pre_zn"], gidx)
                term = bld.add(
                    term,
                    bld.add(bld.mul(a6, inv_xz), bld.mul(a7, inv_xzg)),
                )
            qrow = rows["quotient"][slot]
            a5, gidx = acc_cols(qrow, packed[i]["quot"], gidx)
            term = bld.add(term, bld.mul(a5, inv_xz))
            total = term if total is None else bld.add(total, term)
        return total

    # ---- FRI -------------------------------------------------------------
    log_final_domain = fri_cfg.log_final_poly_len + fri_cfg.log_blowup
    n_rounds = log_max - log_final_domain

    # round 0 is the derived DEEP codeword — never committed (stark.fri
    # round-5 structure): beta_0 comes straight off the transcript;
    # fri_roots[k] is the round-(k+1) commitment
    betas: List[Wire] = []
    fri_roots: List[List[Wire]] = []
    for r in range(n_rounds):
        if r > 0:
            root_w = wit_list(oracle.fri_commit(r - 1))
            fri_roots.append(root_w)
            ch.observe_many(root_w)
        betas.append(ch.sample_ext())

    fd = 1 << log_final_domain
    final_lanes = [wit_list(v) for v in oracle.fri_final(fd)]
    for lanes in final_lanes:
        ch.observe_many(lanes)
    final_ext = [bld.pack_ext(lanes) for lanes in final_lanes]

    if fri_cfg.proof_of_work_bits:
        ch.check_pow(fri_cfg.proof_of_work_bits, wit(oracle.pow_witness()))

    # final low-degree check: high interpolation coefficients vanish
    w_f = bb.two_adic_generator_int(log_final_domain)
    for j in range(1 << fri_cfg.log_final_poly_len, fd):
        coeff = None
        for t in range(fd):
            wjt = pow(w_f, (-j * t) % fd, P)
            term = bld.mul(final_ext[t], bld.const(wjt))
            coeff = term if coeff is None else bld.add(coeff, term)
        bld.assert_zero(coeff)

    injected_heights = set(heights) - {log_max}
    inv2 = pow(2, P - 2, P)

    for qi in range(fri_cfg.num_queries):
        qbits = ch.sample_bits(log_max)
        q0 = sum((b.base & 1) << i for i, b in enumerate(qbits))
        value: Optional[Wire] = None
        for r in range(n_rounds):
            lm = log_max - r
            half_bits = qbits[: lm - 1]
            top_bit = qbits[lm - 1]
            qq = q0 % (1 << (lm - 1))

            if r == 0:
                # round 0 has no commitment: both legs of the first fold
                # are derived in-circuit from the outer STARK openings
                lo = derived_at(lm, half_bits + [zero], qq)
                hi = derived_at(
                    lm, half_bits + [one], qq + (1 << (lm - 1))
                )
            else:
                lo_row = wit_list(oracle.fri_opening_row(r - 1, qi, False))
                hi_row = wit_list(oracle.fri_opening_row(r - 1, qi, True))
                lo_sibs = [
                    wit_list(s)
                    for s in oracle.fri_opening_siblings(r - 1, qi, False, lm)
                ]
                hi_sibs = [
                    wit_list(s)
                    for s in oracle.fri_opening_siblings(r - 1, qi, True, lm)
                ]
                # open index qq and qq + half: path bits differ in the top
                verify_path(hash_row(lo_row), half_bits + [zero],
                            lo_sibs, fri_roots[r - 1])
                verify_path(hash_row(hi_row), half_bits + [one],
                            hi_sibs, fri_roots[r - 1])
                lo = bld.pack_ext(lo_row)
                hi = bld.pack_ext(hi_row)

                if lm in injected_heights:
                    q_here = q0 % (1 << lm)
                    value = bld.add(
                        value,
                        derived_at(lm, qbits[:lm], q_here),
                    )
                opened_v = bld.select(top_bit, hi, lo)
                bld.assert_eq(value, opened_v)

            # fold
            w_lm = bb.two_adic_generator_int(lm)
            sh_r = pow(g, 1 << r, P)  # shift after r squarings
            x = bld.mul(bld.const(sh_r), pow_w_from_bits(w_lm, half_bits))
            s_v = bld.add(lo, hi)
            d_v = bld.sub(lo, hi)
            g_v = bld.mul(s_v, bld.const(inv2))
            two_x = bld.mul(x, bld.const(2))
            h_v = bld.mul(d_v, bld.inv(two_x))
            value = bld.add(g_v, bld.mul(betas[r], h_v))
        # final codeword comparison at the folded-down index (LSB-first
        # binary select tree over the small final domain)
        fin_bits = qbits[:log_final_domain]
        sel_vals = final_ext
        for b_ in fin_bits:
            sel_vals = [
                bld.select(b_, sel_vals[2 * t + 1], sel_vals[2 * t])
                for t in range(len(sel_vals) // 2)
            ]
        bld.assert_eq(value, sel_vals[0])

    return VerifyOutputs(child_pvs=child_pvs, pre_root_wires=pre_root_wires)


def _wire_perm_constraints(bld, interactions, perm_local, perm_next, sels,
                           z, beta, claimed_ext) -> List[Wire]:
    """Wire version of stark.interactions.perm_constraints (point mode)."""
    k = len(interactions)
    out = []
    for j, inter in enumerate(interactions):
        # fingerprint
        acc = bld.const(inter.bus)
        bpow = beta
        for f in inter.fields:
            acc = bld.add(acc, bld.mul(bpow, f))
            bpow = bld.mul(bpow, beta)
        sm = inter.mult
        if not inter.is_send:
            sm = bld.sub(bld.const(0), sm)
        c = perm_local[j]
        lhs = bld.mul(c, bld.sub(z, acc))
        out.append(bld.sub(lhs, sm))

    s_local = perm_local[k]
    s_next = perm_next[k]
    csum = perm_local[0]
    for j in range(1, k):
        csum = bld.add(csum, perm_local[j])
    csum_next = perm_next[0]
    for j in range(1, k):
        csum_next = bld.add(csum_next, perm_next[j])

    out.append(bld.mul(sels["first"], bld.sub(s_local, csum)))
    out.append(
        bld.mul(
            sels["transition"],
            bld.sub(bld.sub(s_next, s_local), csum_next),
        )
    )
    out.append(bld.mul(sels["last"], bld.sub(s_local, claimed_ext)))
    return out
