"""Poseidon2 permutation over BN254 Fr (t=3, x^5 S-box) — host evaluation
plus a PLONK circuit gadget.

Used by the SNARK wrapper circuit to bind (root vk, root-proof digest)
into the EvmProof digest instances in-circuit. Parameters follow the
Poseidon2 paper's t=3/BN254 instantiation (8 full + 56 partial rounds);
round constants are generated deterministically via SHA-256 expansion
(same derivation scheme as ops/poseidon2.py for BabyBear — a drop-in
`load_constants` hook exists for vendoring canonical tables).

Reference analog: the openvm/axiom root-verifier circuit's native
poseidon2 chip over bn254 (SURVEY §2.2 recursion stack).
"""

from __future__ import annotations

import hashlib
from typing import List, Sequence

from .fr import R

T = 3
FULL_ROUNDS = 8          # 4 + 4
PARTIAL_ROUNDS = 56


def _gen_constants() -> List[List[int]]:
    """[round][lane] constants; partial rounds use lane 0 only."""
    out = []
    ctr = 0
    for r in range(FULL_ROUNDS + PARTIAL_ROUNDS):
        row = []
        for lane in range(T):
            # rejection sampling over 256-bit SHA output
            while True:
                h = hashlib.sha256(
                    b"zkvm-prover-tpu/poseidon2-fr/" +
                    ctr.to_bytes(4, "big")
                ).digest()
                ctr += 1
                v = int.from_bytes(h, "big")
                if v < R:
                    row.append(v)
                    break
        out.append(row)
    return out


_RC: List[List[int]] = _gen_constants()


def load_constants(rc: List[List[int]]) -> None:
    """Drop-in replacement hook for canonical constant tables."""
    global _RC
    assert len(rc) == FULL_ROUNDS + PARTIAL_ROUNDS
    _RC = rc


def _sbox(x: int) -> int:
    x2 = x * x % R
    x4 = x2 * x2 % R
    return x4 * x % R


def _ext_mds(s: List[int]) -> List[int]:
    """External matrix circ(2,1,1): out_i = s_i + sum(s)."""
    tot = sum(s) % R
    return [(x + tot) % R for x in s]


def _int_mds(s: List[int]) -> List[int]:
    """Internal matrix I + diag(0,0,1) + all-ones: [[2,1,1],[1,2,1],[1,1,3]]."""
    tot = sum(s) % R
    return [(s[0] + tot) % R, (s[1] + tot) % R, (2 * s[2] + tot) % R]


def permute(state: Sequence[int]) -> List[int]:
    s = [x % R for x in state]
    assert len(s) == T
    s = _ext_mds(s)
    half = FULL_ROUNDS // 2
    for r in range(half):
        s = [(x + c) % R for x, c in zip(s, _RC[r])]
        s = [_sbox(x) for x in s]
        s = _ext_mds(s)
    for r in range(half, half + PARTIAL_ROUNDS):
        s[0] = _sbox((s[0] + _RC[r][0]) % R)
        s = _int_mds(s)
    for r in range(half + PARTIAL_ROUNDS, FULL_ROUNDS + PARTIAL_ROUNDS):
        s = [(x + c) % R for x, c in zip(s, _RC[r])]
        s = [_sbox(x) for x in s]
        s = _ext_mds(s)
    return s


def hash_two(a: int, b: int) -> int:
    """2-to-1 compression: permute([a, b, 0])[0]."""
    return permute([a, b, 0])[0]


def sponge(inputs: Sequence[int]) -> int:
    """Rate-2 sponge absorb of a field-element list, squeeze one element.
    Length-padded (capacity lane initialised with len) so different-length
    inputs never collide."""
    s = [0, 0, len(inputs) % R]
    xs = list(inputs)
    if len(xs) % 2:
        xs.append(1)  # pad marker
    for i in range(0, len(xs), 2):
        s[0] = (s[0] + xs[i]) % R
        s[1] = (s[1] + xs[i + 1]) % R
        s = permute(s)
    return s[0]


# ---------------------------------------------------------------------------
# PLONK circuit gadget
# ---------------------------------------------------------------------------

def circuit_sbox(cb, x: int) -> int:
    x2 = cb.mul(x, x)
    x4 = cb.mul(x2, x2)
    return cb.mul(x4, x)


def circuit_permute(cb, state: List[int]) -> List[int]:
    """In-circuit permutation; `state` are builder variable ids."""
    def ext(s):
        tot = cb.linear([(1, s[0]), (1, s[1]), (1, s[2])])
        return [cb.add(x, tot) for x in s]

    def internal(s):
        tot = cb.linear([(1, s[0]), (1, s[1]), (1, s[2])])
        return [
            cb.add(s[0], tot),
            cb.add(s[1], tot),
            cb.add(cb.mul_const(s[2], 2), tot),
        ]

    s = ext(list(state))
    half = FULL_ROUNDS // 2
    for r in range(half):
        s = [circuit_sbox(cb, cb.add_const(x, c))
             for x, c in zip(s, _RC[r])]
        s = ext(s)
    for r in range(half, half + PARTIAL_ROUNDS):
        s = [circuit_sbox(cb, cb.add_const(s[0], _RC[r][0])), s[1], s[2]]
        s = internal(s)
    for r in range(half + PARTIAL_ROUNDS, FULL_ROUNDS + PARTIAL_ROUNDS):
        s = [circuit_sbox(cb, cb.add_const(x, c))
             for x, c in zip(s, _RC[r])]
        s = ext(s)
    return s


def circuit_sponge(cb, input_vars: List[int]) -> int:
    """In-circuit rate-2 sponge matching `sponge`."""
    n = len(input_vars)
    state = [cb.constant(0), cb.constant(0), cb.constant(n % R)]
    xs = list(input_vars)
    if len(xs) % 2:
        xs.append(cb.constant(1))
    for i in range(0, len(xs), 2):
        state = [cb.add(state[0], xs[i]), cb.add(state[1], xs[i + 1]),
                 state[2]]
        state = circuit_permute(cb, state)
    return state[0]
