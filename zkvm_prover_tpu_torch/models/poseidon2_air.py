"""Poseidon2 permutation AIR (width 16, BabyBear) as a lookup-table chip.

Other chips prove hash evaluations by sending `(input[16] || output[8])`
messages on POSEIDON_BUS; this chip holds one permutation per row and
receives each message with a witnessed multiplicity.

Constraint layout (MAX_DEGREE = 3 budget):
- the S-box x^7 per lane is split as x3 := t*t*t (stored, degree 3) and
  sbox(t) = x3*x3*t (degree 3), t = state + round constant;
- the state after every round is stored, so each round's constraints only
  reference stored columns of the same row (no next-row references);
- padding rows hold the permutation of the all-zero state with mult 0, so
  the constraints hold without an is_real gate.

The round structure and constants are those of ops/poseidon2.py (8 external
rounds, 13 internal). Trace generation is host numpy.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..fields import babybear as bb
from ..ops import poseidon2 as p2
from .air import Air, AirBuilder

POSEIDON_BUS = 29        # compress queries: input[16] || output[0..8]
POSEIDON_FULL_BUS = 32   # sponge queries: input[16] || output[16]

WIDTH = 16
HALF_F = p2.ROUNDS_F // 2
ROUNDS_P = p2.ROUNDS_P[WIDTH]
DIGEST = 8

# --- column layout -----------------------------------------------------
INPUT = 0
_cursor = INPUT + WIDTH
_EXT_COLS = []  # (x3_base, out_base) per external round, in round order
for _r in range(p2.ROUNDS_F):
    _EXT_COLS.append((_cursor, _cursor + WIDTH))
    _cursor += 2 * WIDTH
_INT_COLS = []  # (x3_col, out_base) per internal round
for _r in range(ROUNDS_P):
    _INT_COLS.append((_cursor, _cursor + 1))
    _cursor += 1 + WIDTH
MULT = _cursor
MULT_FULL = _cursor + 1
NUM_COLS = _cursor + 2


def _canon_constants():
    """Round constants in canonical form (the stored tables are Montgomery)."""
    return tuple(bb.from_monty_np(t) for t in p2._get_constants(WIDTH))


class Poseidon2Air(Air):
    width = NUM_COLS
    num_public_values = 0

    def eval(self, b: AirBuilder) -> None:
        ext_rc, int_rc, diag = _canon_constants()

        def m4(v: List):
            out = []
            for g in range(0, WIDTH, 4):
                a, x, c, d = v[g], v[g + 1], v[g + 2], v[g + 3]
                t01 = b.add(a, x)
                t23 = b.add(c, d)
                t0123 = b.add(t01, t23)
                t01123 = b.add(t0123, x)
                t01233 = b.add(t0123, d)
                out += [
                    b.add(t01123, t01),          # 2a + 3b + c + d
                    b.add(t01123, b.add(c, c)),  # a + 2b + 3c + d
                    b.add(t01233, t23),          # a + b + 2c + 3d
                    b.add(t01233, b.add(a, a)),  # 3a + b + c + 2d
                ]
            return out

        def ext_lin(v: List):
            y = m4(v)
            acc = [y[k] for k in range(4)]
            for g in range(4, WIDTH, 4):
                for k in range(4):
                    acc[k] = b.add(acc[k], y[g + k])
            return [b.add(y[i], acc[i % 4]) for i in range(WIDTH)]

        def int_lin(v: List):
            acc = v[0]
            for i in range(1, WIDTH):
                acc = b.add(acc, v[i])
            return [
                b.add(acc, b.mul(b.constant(int(diag[i])), v[i]))
                for i in range(WIDTH)
            ]

        def ext_round(r, state):
            x3_base, out_base = _EXT_COLS[r]
            sbox = []
            for i in range(WIDTH):
                t = b.add(state[i], b.constant(int(ext_rc[r][i])))
                x3 = b.local(x3_base + i)
                b.assert_eq(x3, b.mul(b.mul(t, t), t))
                sbox.append(b.mul(b.mul(x3, x3), t))
            lin = ext_lin(sbox)
            for i in range(WIDTH):
                b.assert_eq(b.local(out_base + i), lin[i])
            return [b.local(out_base + i) for i in range(WIDTH)]

        state = ext_lin([b.local(INPUT + i) for i in range(WIDTH)])
        for r in range(HALF_F):
            state = ext_round(r, state)
        for r in range(ROUNDS_P):
            x3_col, out_base = _INT_COLS[r]
            t = b.add(state[0], b.constant(int(int_rc[r])))
            x3 = b.local(x3_col)
            b.assert_eq(x3, b.mul(b.mul(t, t), t))
            sbox0 = b.mul(b.mul(x3, x3), t)
            lin = int_lin([sbox0] + state[1:])
            for i in range(WIDTH):
                b.assert_eq(b.local(out_base + i), lin[i])
            state = [b.local(out_base + i) for i in range(WIDTH)]
        for r in range(HALF_F, p2.ROUNDS_F):
            state = ext_round(r, state)

        inputs = [b.local(INPUT + i) for i in range(WIDTH)]
        b.push_receive(POSEIDON_BUS, inputs + state[:DIGEST], b.local(MULT))
        b.push_receive(POSEIDON_FULL_BUS, inputs + state, b.local(MULT_FULL))

    # -- trace generation (host-side) -----------------------------------
    @staticmethod
    def generate_trace(inputs: np.ndarray, mults: np.ndarray,
                       mults_full=None) -> np.ndarray:
        """inputs: (n, 16) canonical uint32; mults: (n,) compress-bus
        multiplicities; mults_full: optional (n,) sponge-bus multiplicities.
        Rows are padded to a power of two with zero-input permutations."""
        n = max(4, len(inputs))
        n = 1 << (n - 1).bit_length()
        full_in = np.zeros((n, WIDTH), dtype=np.uint32)
        full_mult = np.zeros(n, dtype=np.uint32)
        full_mult2 = np.zeros(n, dtype=np.uint32)
        if len(inputs):
            full_in[: len(inputs)] = inputs
            full_mult[: len(inputs)] = mults
            if mults_full is not None:
                full_mult2[: len(inputs)] = mults_full

        trace = np.zeros((n, NUM_COLS), dtype=np.uint32)
        trace[:, INPUT: INPUT + WIDTH] = full_in
        trace[:, MULT] = full_mult
        trace[:, MULT_FULL] = full_mult2

        ext_rc, int_rc, diag = p2._get_constants(WIDTH)
        x = bb.to_monty_np(full_in).astype(np.uint64)
        from_m = bb.from_monty_np
        mul, add = p2._mul_np, p2._add_np

        def sbox_with_x3(t):
            x3 = mul(mul(t, t), t)
            return x3, mul(mul(x3, x3), t)

        def ext_lin_np(v):
            s = v.shape
            g = v.reshape(s[:-1] + (s[-1] // 4, 4))
            a, b_, c, d = g[..., 0], g[..., 1], g[..., 2], g[..., 3]
            t01 = add(a, b_)
            t23 = add(c, d)
            t0123 = add(t01, t23)
            t01123 = add(t0123, b_)
            t01233 = add(t0123, d)
            y = np.stack(
                [add(t01123, t01), add(t01123, add(c, c)),
                 add(t01233, t23), add(t01233, add(a, a))], axis=-1)
            acc = y[..., 0, :]
            for i in range(1, WIDTH // 4):
                acc = add(acc, y[..., i, :])
            return add(y, acc[..., None, :]).reshape(s)

        def int_lin_np(v):
            acc = v[..., 0]
            for i in range(1, WIDTH):
                acc = add(acc, v[..., i])
            return add(acc[..., None], mul(np.asarray(diag, np.uint64), v))

        x = ext_lin_np(x)
        for r in range(p2.ROUNDS_F):
            if r == HALF_F:
                for rp in range(ROUNDS_P):
                    x3_col, out_base = _INT_COLS[rp]
                    t0 = add(x[:, 0], np.uint64(int_rc[rp]))
                    x3, s0 = sbox_with_x3(t0)
                    x = x.copy()
                    x[:, 0] = s0
                    x = int_lin_np(x)
                    trace[:, x3_col] = from_m(x3)
                    trace[:, out_base: out_base + WIDTH] = from_m(x)
            x3_base, out_base = _EXT_COLS[r]
            t = add(x, np.asarray(ext_rc[r], np.uint64))
            x3, s = sbox_with_x3(t)
            x = ext_lin_np(s)
            trace[:, x3_base: x3_base + WIDTH] = from_m(x3)
            trace[:, out_base: out_base + WIDTH] = from_m(x)
        return trace

    @staticmethod
    def outputs_from_trace(trace: np.ndarray) -> np.ndarray:
        """(n, 16) canonical final states."""
        out_base = _EXT_COLS[-1][1]
        return trace[:, out_base: out_base + WIDTH]


def permute_canonical(inputs: np.ndarray) -> np.ndarray:
    """Host permutation on canonical words: (n, 16) -> (n, 16)."""
    return bb.from_monty_np(p2.permute_np(bb.to_monty_np(np.asarray(inputs, np.uint32))))


def compress_canonical(left: np.ndarray, right: np.ndarray) -> np.ndarray:
    """Canonical 2-to-1 digest compression, (n, 8) + (n, 8) -> (n, 8)."""
    return permute_canonical(np.concatenate([left, right], axis=-1))[:, :DIGEST]
