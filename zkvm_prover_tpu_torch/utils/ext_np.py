"""Host-side (python-int) BabyBear quartic-extension arithmetic.

Verifier-side helper: openings are tiny, so the verifier recomputes folds
and constraints with exact python-int arithmetic, no device work. Canonical
(non-Montgomery) representation: sequences of 4 ints.
"""

from __future__ import annotations

import numpy as np

from ..fields import babybear as bb
from ..fields.ext4 import DTH_ROOT_INT, W_INT

P = bb.P


def from_monty(arr) -> list:
    """Montgomery uint32 values (any shape) -> canonical nested int lists."""
    return bb.from_monty_np(np.asarray(arr, dtype=np.uint32)).astype(
        np.int64).tolist()


def add(a, b):
    return [(int(a[i]) + int(b[i])) % P for i in range(4)]


def sub(a, b):
    return [(int(a[i]) - int(b[i])) % P for i in range(4)]


def mul(a, b):
    c = [0] * 7
    for i in range(4):
        for j in range(4):
            c[i + j] += int(a[i]) * int(b[j])
    for k in range(6, 3, -1):
        c[k - 4] += W_INT * c[k]
    return [v % P for v in c[:4]]


def scale(a, s: int):
    return [(int(a[i]) * int(s)) % P for i in range(4)]


def from_base(x: int):
    return [int(x) % P, 0, 0, 0]


def exp(a, e: int):
    result = from_base(1)
    base = list(map(int, a))
    while e > 0:
        if e & 1:
            result = mul(result, base)
        base = mul(base, base)
        e >>= 1
    return result


def inv(a):
    """Inverse via conjugate product: a^-1 = prod(frobenius) / norm."""
    def frob(x, k):
        r = pow(DTH_ROOT_INT, k, P)
        return [(int(x[i]) * pow(r, i, P)) % P for i in range(4)]

    conj = mul(frob(a, 1), mul(frob(a, 2), frob(a, 3)))
    norm = mul(a, conj)[0]
    return scale(conj, pow(norm, P - 2, P))


def eq(a, b) -> bool:
    return all(int(a[i]) % P == int(b[i]) % P for i in range(4))


def from_base_cols(vals):
    """An extension value opened as 4 base columns (4 ext values, one per
    basis element x^c) -> sum_c vals[c] * x^c."""
    acc = [0, 0, 0, 0]
    for c in range(4):
        basis = [0, 0, 0, 0]
        basis[c] = 1
        acc = add(acc, mul(vals[c], basis))
    return acc


def powers(base, n: int):
    out = [from_base(1)]
    for _ in range(n - 1):
        out.append(mul(out[-1], base))
    return out
