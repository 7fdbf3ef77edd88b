"""Straight-line wire-program builder and witness evaluator (the reference's
`zkvm_prover_tpu/recursion/builder.py`).

The same build pass produces (a) the preprocessed program tables
(verification-key material: a pure function of the *shape* of the verified
object) and (b) the concrete wire values (the witness: a function of the
actual proof bytes). Witness inputs enter through `witness()` so that a
build against a dummy proof oracle yields the identical program with
garbage values (the vk, derived without any proof in hand).

All values are canonical BabyBear^4 tuples; base values ride lane 0.

A verifier program has millions of rows, each recorded by a python call, so
the builder keeps the per-op cost low: a row is appended to flat per-column
lists and the tables are made in one numpy conversion by `finalize`, and
the extension arithmetic runs on python ints. The tables equal the
reference's bit for bit.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from ..fields import babybear as bb
from ..fields.ext4 import W_INT
from ..models.poseidon2_air import Poseidon2Air
from ..ops import poseidon2 as p2
from ..stark.machine import AirInstance
from ..utils import ext_np
from .wire_air import (
    OP_ADD,
    OP_AZ,
    OP_BIT,
    OP_CONST,
    OP_MUL,
    OP_SUB,
    OP_WIT,
    PublicBindAir,
    WireAluAir,
    WirePoseidonAir,
)

P = bb.P
ExtVal = Tuple[int, int, int, int]
_ZERO: ExtVal = (0, 0, 0, 0)


def _ext(v) -> ExtVal:
    if isinstance(v, (int, np.integer)):
        return (int(v) % P, 0, 0, 0)
    t = tuple(int(x) % P for x in v)
    if len(t) != 4:
        raise ValueError("an extension value has 4 coefficients")
    return t  # type: ignore


def _ext_add(a: ExtVal, b: ExtVal) -> ExtVal:
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P, (a[2] + b[2]) % P, (a[3] + b[3]) % P)


def _ext_sub(a: ExtVal, b: ExtVal) -> ExtVal:
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P, (a[2] - b[2]) % P, (a[3] - b[3]) % P)


def _ext_mul(a: ExtVal, b: ExtVal) -> ExtVal:
    """ext4 product (x^4 = W), with the base-by-ext cases short."""
    a0, a1, a2, a3 = a
    b0, b1, b2, b3 = b
    if not (a1 or a2 or a3):
        return (a0 * b0 % P, a0 * b1 % P, a0 * b2 % P, a0 * b3 % P)
    if not (b1 or b2 or b3):
        return (a0 * b0 % P, a1 * b0 % P, a2 * b0 % P, a3 * b0 % P)
    return ((a0 * b0 + W_INT * (a1 * b3 + a2 * b2 + a3 * b1)) % P,
            (a0 * b1 + a1 * b0 + W_INT * (a2 * b3 + a3 * b2)) % P,
            (a0 * b2 + a1 * b1 + a2 * b0 + W_INT * a3 * b3) % P,
            (a0 * b3 + a1 * b2 + a2 * b1 + a3 * b0) % P)


class Wire(NamedTuple):
    id: int
    value: ExtVal

    @property
    def base(self) -> int:
        return self.value[0]


_tuple_new = tuple.__new__  # Wire(i, v) without the generated __new__'s call


class CircuitBuilder:
    """Records wire ops with eagerly computed concrete values."""

    def __init__(self, n_public_slots: int = 0):
        self.n_public_slots = n_public_slots
        self._next_id = n_public_slots + 1
        # ALU rows, one entry per row (the 4-lane columns flat)
        self._op: List[int] = []
        self._wout: List[int] = []
        self._win1: List[int] = []
        self._win2: List[int] = []
        self._in1: List[int] = []
        self._in2: List[int] = []
        self._out: List[int] = []
        self._const_rows: List[Tuple[int, ExtVal]] = []
        # Poseidon rows: 16 input ids, 16 output ids, 16 input values and
        # 16 output values per row, flat
        self._p_win: List[int] = []
        self._p_wout: List[int] = []
        self._p_vin: List[int] = []
        self._p_vout: List[int] = []
        # uses per wire id (the public slots' ids stay 0: they are tracked
        # by _public_consumed)
        self._uses: List[int] = [0] * self._next_id
        self._consts: Dict[ExtVal, Wire] = {}
        self._public_wires: List[Optional[Wire]] = [None] * n_public_slots
        self._public_vals: List[ExtVal] = [_ZERO] * n_public_slots
        self._public_consumed = [False] * n_public_slots

    # -- wire allocation -------------------------------------------------
    def _new(self, value: ExtVal) -> Wire:
        i = self._next_id
        self._next_id = i + 1
        self._uses.append(0)
        return _tuple_new(Wire, (i, value))

    def _use(self, w: Wire) -> int:
        i = w.id
        if i <= self.n_public_slots:
            s = i - 1
            if self._public_consumed[s]:
                raise ValueError(f"public slot {s} consumed twice")
            self._public_consumed[s] = True
        else:
            self._uses[i] += 1
        return i

    def _row(self, op: int, wout: int, win1: int, win2: int,
             in1: ExtVal, in2: ExtVal, out: ExtVal) -> None:
        self._op.append(op)
        self._wout.append(wout)
        self._win1.append(win1)
        self._win2.append(win2)
        self._in1 += in1
        self._in2 += in2
        self._out += out

    # -- public values ---------------------------------------------------
    def set_public(self, slot: int, value) -> Wire:
        """Declare the value of public slot `slot`; returns its wire (which
        must be consumed exactly once, typically by assert_eq against the
        recomputed value)."""
        v = _ext(value)
        if self._public_wires[slot] is not None:
            raise ValueError(f"slot {slot} already set")
        w = Wire(slot + 1, v)
        self._public_wires[slot] = w
        self._public_vals[slot] = v
        return w

    # -- ops -------------------------------------------------------------
    def const(self, v) -> Wire:
        v = _ext(v)
        w = self._consts.get(v)
        if w is None:
            w = self._new(v)
            self._const_rows.append((len(self._op), v))
            self._row(OP_CONST, w.id, 0, 0, _ZERO, _ZERO, v)
            self._consts[v] = w
        return w

    def witness(self, value) -> Wire:
        v = _ext(value)
        w = self._new(v)
        self._row(OP_WIT, w.id, 0, 0, _ZERO, _ZERO, v)
        return w

    def bit_witness(self, value: int) -> Wire:
        v = (int(value) & 1, 0, 0, 0)
        w = self._new(v)
        self._row(OP_BIT, w.id, 0, 0, _ZERO, _ZERO, v)
        return w

    def _binop(self, op: int, a: Wire, b: Wire, out_val: ExtVal) -> Wire:
        w = self._new(out_val)
        self._row(op, w.id, self._use(a), self._use(b), a.value, b.value, out_val)
        return w

    def add(self, a: Wire, b: Wire) -> Wire:
        return self._binop(OP_ADD, a, b, _ext_add(a.value, b.value))

    def sub(self, a: Wire, b: Wire) -> Wire:
        return self._binop(OP_SUB, a, b, _ext_sub(a.value, b.value))

    def mul(self, a: Wire, b: Wire) -> Wire:
        return self._binop(OP_MUL, a, b, _ext_mul(a.value, b.value))

    def assert_zero(self, a: Wire) -> None:
        self._row(OP_AZ, 0, self._use(a), 0, a.value, _ZERO, _ZERO)

    def assert_eq(self, a: Wire, b: Wire) -> None:
        self.assert_zero(self.sub(a, b))

    def poseidon(self, state: Sequence[Wire]) -> List[Wire]:
        """Full width-16 Poseidon2 permutation (base-valued wires)."""
        if len(state) != 16:
            raise ValueError("a Poseidon2 state has 16 wires")
        vin = [w.value[0] for w in state]
        out_vals = bb.from_monty_np(p2.permute_np(bb.to_monty_np(vin))).tolist()
        self._p_win += [self._use(w) for w in state]
        outs = [self._new((v, 0, 0, 0)) for v in out_vals]
        self._p_wout += [w.id for w in outs]
        self._p_vin += vin
        self._p_vout += out_vals
        return outs

    # -- composite helpers ------------------------------------------------
    def zero(self) -> Wire:
        return self.const(0)

    def one(self) -> Wire:
        return self.const(1)

    def select(self, b: Wire, x: Wire, y: Wire) -> Wire:
        """b ? x : y  (b boolean)."""
        return self.add(y, self.mul(b, self.sub(x, y)))

    def inv(self, a: Wire) -> Wire:
        """Witnessed inverse with an a*inv == 1 check (a must be nonzero for
        a satisfying witness to exist)."""
        v = a.value
        if any(v):
            iv = _ext(ext_np.inv(list(v)))
        else:
            iv = _ZERO  # dummy-build path; the constraint is unsatisfiable
        w = self.witness(iv)
        self.assert_eq(self.mul(a, w), self.one())
        return w

    def decompose_bits(self, a: Wire, n_bits: int = 31,
                       canonical: bool = True) -> List[Wire]:
        """Split a base wire into `n_bits` boolean wires (LSB first),
        asserting the recomposition equals `a`. With `canonical`, also
        asserts the bit pattern is < P (unique representation): P =
        15*2^27 + 1, so value >= P iff bits 27..30 are all set and the low
        27 bits are nonzero."""
        x = a.base
        bits = [self.bit_witness((x >> i) & 1) for i in range(n_bits)]
        acc = None
        lo27 = None
        for i, b in enumerate(bits):
            term = b if i == 0 else self.mul(self.const(1 << i), b)
            acc = term if acc is None else self.add(acc, term)
            if i == 26:
                lo27 = acc
        self.assert_eq(acc, a)
        if canonical:
            if n_bits != 31:
                raise ValueError("a canonical decomposition has 31 bits")
            hi = self.mul(self.mul(bits[27], bits[28]),
                          self.mul(bits[29], bits[30]))
            self.assert_zero(self.mul(hi, lo27))
        return bits

    def bits_to_value(self, bits: Sequence[Wire]) -> Wire:
        acc = None
        for i, b in enumerate(bits):
            term = b if i == 0 else self.mul(self.const(1 << i), b)
            acc = term if acc is None else self.add(acc, term)
        return acc if acc is not None else self.zero()

    def pack_ext(self, lanes: Sequence[Wire]) -> Wire:
        """Combine 4 base wires into one ext wire."""
        if len(lanes) != 4:
            raise ValueError("pack_ext takes 4 lanes")
        acc = lanes[0]
        for k in range(1, 4):
            unit = [0, 0, 0, 0]
            unit[k] = 1
            acc = self.add(acc, self.mul(self.const(tuple(unit)), lanes[k]))
        return acc

    # -- finalize ---------------------------------------------------------
    @staticmethod
    def _height(n: int, least: int, fixed: Optional[int], what: str) -> int:
        h = fixed or max(least, 1 << max(0, (n - 1)).bit_length())
        if h < n:
            raise ValueError(f"fixed_{what}_rows too small")
        return h

    def finalize(self, min_alu_rows: int = 4, min_pose_rows: int = 4,
                 fixed_alu_rows: Optional[int] = None,
                 fixed_pose_rows: Optional[int] = None):
        """Compile to AIR instances:
        [WireAluAir, WirePoseidonAir, PublicBindAir?, Poseidon2Air].

        fixed_*_rows pin trace heights (recursion over fixed shapes).
        """
        for s, w in enumerate(self._public_wires):
            if w is not None and not self._public_consumed[s]:
                raise ValueError(f"public slot {s} never consumed")
        uses = np.asarray(self._uses, dtype=np.uint32)

        A = WireAluAir
        n_alu = len(self._op)
        h_alu = self._height(n_alu, min_alu_rows, fixed_alu_rows, "alu")
        prog_a = np.zeros((h_alu, A.preprocessed_width), dtype=np.uint32)
        main_a = np.zeros((h_alu, A.width), dtype=np.uint32)
        op = np.asarray(self._op, dtype=np.int64)
        wout = np.asarray(self._wout, dtype=np.int64)
        prog_a[np.arange(n_alu), A.P_OP + op] = 1
        prog_a[:n_alu, A.P_WOUT] = wout
        prog_a[:n_alu, A.P_WIN1] = self._win1
        prog_a[:n_alu, A.P_WIN2] = self._win2
        two_in = (op == OP_ADD) | (op == OP_SUB) | (op == OP_MUL)
        prog_a[:n_alu, A.P_USE1] = two_in | (op == OP_AZ)
        prog_a[:n_alu, A.P_USE2] = two_in
        prog_a[:n_alu, A.P_FAN] = uses[wout]
        for r, v in self._const_rows:
            prog_a[r, A.P_CONST:A.P_CONST + 4] = v
        for col, flat in ((A.IN1, self._in1), (A.IN2, self._in2), (A.OUT, self._out)):
            main_a[:n_alu, col:col + 4] = np.asarray(flat, dtype=np.uint32).reshape(n_alu, 4)

        PO = WirePoseidonAir
        n_pose = len(self._p_win) // 16
        h_pose = self._height(n_pose, min_pose_rows, fixed_pose_rows, "pose")
        prog_p = np.zeros((h_pose, PO.preprocessed_width), dtype=np.uint32)
        main_p = np.zeros((h_pose, PO.width), dtype=np.uint32)
        p_wout = np.asarray(self._p_wout, dtype=np.int64).reshape(n_pose, 16)
        prog_p[:n_pose, PO.P_REAL] = 1
        prog_p[:n_pose, PO.P_WIN:PO.P_WIN + 16] = np.asarray(
            self._p_win, dtype=np.uint32).reshape(n_pose, 16)
        prog_p[:n_pose, PO.P_WOUT:PO.P_WOUT + 16] = p_wout
        prog_p[:n_pose, PO.P_FAN:PO.P_FAN + 16] = uses[p_wout]
        p_in = np.asarray(self._p_vin, dtype=np.uint32).reshape(n_pose, 16)
        main_p[:n_pose, PO.VIN:PO.VIN + 16] = p_in
        main_p[:n_pose, PO.VOUT:PO.VOUT + 16] = np.asarray(
            self._p_vout, dtype=np.uint32).reshape(n_pose, 16)

        # Poseidon2 lookup table: ONE ROW PER CALL (no dedup) so the table
        # height is a pure function of the program: shape stability is vk
        # material for recursion over recursion proofs (a dummy-oracle
        # build would otherwise collapse duplicate all-zero states and
        # produce a different machine shape than a real proof).
        p_tr = Poseidon2Air.generate_trace(
            p_in, np.zeros(n_pose, dtype=np.uint32), np.ones(n_pose, dtype=np.uint32))

        instances = [
            AirInstance(WireAluAir(prog_a), main_a, []),
            AirInstance(WirePoseidonAir(prog_p), main_p, []),
        ]
        if self.n_public_slots:
            pvs = [v for slot in self._public_vals for v in slot]
            instances.append(AirInstance(
                PublicBindAir(self.n_public_slots), PublicBindAir.trace(), pvs))
        instances.append(AirInstance(Poseidon2Air(), p_tr, []))
        return instances
