"""BN254 scalar-field (Fr) polynomial arithmetic for the PLONK wrapper: the
reference's `zkvm_prover_tpu/snark/fr.py`.

Host-side Python ints: wrapper circuits are small (2^10..2^16 gates) and
run once per bundle; the radix-2 NTT here is the standard in-place butterfly over the 2^28-adic
subgroup of Fr (generator 5, matching the arkworks/halo2curves derivation).

Reference analog: halo2's EvaluationDomain over bn256::Fr.
"""

from __future__ import annotations

from typing import List, Sequence

R = 21888242871839275222246405745257275088548364400416034343698204186575808495617
TWO_ADICITY = 28
GENERATOR = 5  # smallest multiplicative generator of Fr*


def root_of_unity(log_n: int) -> int:
    assert 0 <= log_n <= TWO_ADICITY
    return pow(GENERATOR, (R - 1) >> log_n, R)


def _bit_reverse(a: List[int]) -> None:
    n = len(a)
    j = 0
    for i in range(1, n):
        bit = n >> 1
        while j & bit:
            j ^= bit
            bit >>= 1
        j |= bit
        if i < j:
            a[i], a[j] = a[j], a[i]


def ntt(coeffs: Sequence[int], log_n: int, inverse: bool = False) -> List[int]:
    """In-place iterative radix-2 NTT; returns evaluations over the size-2^log_n
    subgroup in natural order (or coefficients, for inverse=True)."""
    n = 1 << log_n
    a = list(coeffs) + [0] * (n - len(coeffs))
    assert len(a) == n
    _bit_reverse(a)
    length = 2
    while length <= n:
        w_len = root_of_unity(length.bit_length() - 1)
        if inverse:
            w_len = pow(w_len, R - 2, R)
        half = length >> 1
        for start in range(0, n, length):
            w = 1
            for k in range(half):
                u = a[start + k]
                v = a[start + k + half] * w % R
                a[start + k] = (u + v) % R
                a[start + k + half] = (u - v) % R
                w = w * w_len % R
        length <<= 1
    if inverse:
        n_inv = pow(n, R - 2, R)
        a = [x * n_inv % R for x in a]
    return a


def evals_on_coset(coeffs: Sequence[int], log_n: int, shift: int) -> List[int]:
    """Evaluate the polynomial on shift * H for |H| = 2^log_n."""
    n = 1 << log_n
    scaled = []
    s = 1
    for c in list(coeffs) + [0] * (n - len(coeffs)):
        scaled.append(c * s % R)
        s = s * shift % R
    return ntt(scaled, log_n)


def coeffs_from_coset(evals: Sequence[int], log_n: int, shift: int) -> List[int]:
    coeffs = ntt(evals, log_n, inverse=True)
    inv_s = pow(shift, R - 2, R)
    out = []
    s = 1
    for c in coeffs:
        out.append(c * s % R)
        s = s * inv_s % R
    return out


def poly_eval(coeffs: Sequence[int], x: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % R
    return acc


def poly_add(a: Sequence[int], b: Sequence[int]) -> List[int]:
    n = max(len(a), len(b))
    a = list(a) + [0] * (n - len(a))
    b = list(b) + [0] * (n - len(b))
    return [(x + y) % R for x, y in zip(a, b)]


def poly_sub(a: Sequence[int], b: Sequence[int]) -> List[int]:
    n = max(len(a), len(b))
    a = list(a) + [0] * (n - len(a))
    b = list(b) + [0] * (n - len(b))
    return [(x - y) % R for x, y in zip(a, b)]


def poly_scale(a: Sequence[int], k: int) -> List[int]:
    return [x * k % R for x in a]


def poly_mul_x_plus_c(a: Sequence[int], c: int) -> List[int]:
    """(X + c) * a(X)."""
    out = [0] * (len(a) + 1)
    for i, v in enumerate(a):
        out[i] = (out[i] + c * v) % R
        out[i + 1] = (out[i + 1] + v) % R
    return out


def divide_by_linear(coeffs: Sequence[int], z: int) -> List[int]:
    """q(X) = (p(X) - p(z)) / (X - z) via synthetic division."""
    q: List[int] = [0] * (max(len(coeffs) - 1, 1))
    acc = 0
    for i in range(len(coeffs) - 1, 0, -1):
        acc = (acc * z + coeffs[i]) % R
        q[i - 1] = acc
    return q


def vanishing_eval(log_n: int, x: int) -> int:
    """Z_H(x) = x^n - 1."""
    return (pow(x, 1 << log_n, R) - 1) % R
