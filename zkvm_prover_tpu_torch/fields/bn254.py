"""BN254 (alt_bn128) host library: Fq/Fr, G1/G2, optimal-ate pairing, KZG.

The reference's `zkvm_prover_tpu/fields/bn254.py`: python ints on the host,
the foundation of the SNARK wrapper (`snark/`). It wraps the root STARK
proof in a BN254 KZG SNARK (the reference system's `snark-verifier-sdk` +
`halo2curves-axiom`, crates/prover/src/prover/mod.rs:419-432; EVM instance
layout at crates/types/src/proof.rs:221-239).

Fq12 is FLAT, Fq[w]/(w^12 - 18 w^6 + 82) (the canonical alt_bn128
polynomial; w^6 = u + 9 embeds Fq2 = Fq[u]/(u^2+1)), which keeps the pairing
free of tower bookkeeping. G2 points live over Fq2 and are untwisted into
E(Fq12) for the Miller loop.

One change from the reference: `msm_jac` takes a `device` (None is the
card). Eight or more points on a CUDA device go to the hand-written kernel
K4 (`ops/msm.py::msm_device`); on the CPU to the host engine
(`bn254_native.py`, the reference's C++); fewer than eight to the python
path below. Nothing falls back: a kernel or engine that fails raises.
`kzg_commit` and `kzg_open` pass the device through.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

# field / curve parameters
Q = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617
B = 3
ATE_LOOP_COUNT = 29793968203157093288  # 6x + 2, x = 4965661367192848881

G1_GEN = (1, 2)
G2_GEN = (
    (
        10857046999023057135944570762232829481370756359578518086990519993285655852781,
        11559732032986387107991004021392285783925812861821192530917403151452391805634,
    ),
    (
        8495653923123431417604973247489272438418190587263600148770280649306958101930,
        4082367875863433681332203403145435568316851327593401208105741076214120093531,
    ),
)

G1 = Optional[Tuple[int, int]]
Fq2 = Tuple[int, int]
G2pt = Optional[Tuple[Fq2, Fq2]]

# --- Fq12 flat polynomial arithmetic ---------------------------------------
# modulus: w^12 = 18 w^6 - 82
_DEG = 12


def fq12(*coeffs) -> Tuple[int, ...]:
    c = list(coeffs) + [0] * (_DEG - len(coeffs))
    return tuple(v % Q for v in c[:_DEG])


FQ12_ONE = fq12(1)
FQ12_ZERO = fq12()


def fq12_add(a, b):
    return tuple((x + y) % Q for x, y in zip(a, b))


def fq12_sub(a, b):
    return tuple((x - y) % Q for x, y in zip(a, b))


def fq12_neg(a):
    return tuple((-x) % Q for x in a)


def fq12_scalar(a, k: int):
    return tuple((x * k) % Q for x in a)


def fq12_mul(a, b):
    prod = [0] * (2 * _DEG - 1)
    for i, x in enumerate(a):
        if not x:
            continue
        for j, y in enumerate(b):
            if y:
                prod[i + j] += x * y
    for d in range(2 * _DEG - 2, _DEG - 1, -1):
        v = prod[d]
        if v:
            prod[d - 6] += 18 * v
            prod[d - 12] -= 82 * v
            prod[d] = 0
    return tuple(v % Q for v in prod[:_DEG])


def fq12_sq(a):
    return fq12_mul(a, a)


def _poly_divmod(a: List[int], b: List[int]):
    a = list(a)
    out = [0] * (len(a) - len(b) + 1)
    binv = pow(b[-1], Q - 2, Q)
    for d in range(len(a) - len(b), -1, -1):
        f = a[d + len(b) - 1] * binv % Q
        out[d] = f
        for i, c in enumerate(b):
            a[d + i] = (a[d + i] - f * c) % Q
    while len(a) > 1 and a[-1] == 0:
        a.pop()
    return out, a


def fq12_inv(a):
    """Extended Euclid over Fq[w] modulo w^12 - 18 w^6 + 82."""
    mod = [82, 0, 0, 0, 0, 0, -18 % Q, 0, 0, 0, 0, 0, 1]
    lm, hm = [1], [0]
    low = [v % Q for v in a]
    while len(low) > 1 and low[-1] == 0:
        low.pop()
    high = list(mod)
    while len(low) > 1:  # until low is a (nonzero) constant
        q_, r_ = _poly_divmod(high, low)
        nm = [0] * max(len(hm), len(q_) + len(lm) - 1)
        for i, c in enumerate(hm):
            nm[i] = c
        for i, qc in enumerate(q_):
            for j, lc in enumerate(lm):
                nm[i + j] = (nm[i + j] - qc * lc) % Q
        lm, low, hm, high = nm, r_, lm, low
        while len(low) > 1 and low[-1] == 0:
            low.pop()
    inv0 = pow(low[0], Q - 2, Q)
    out = [c * inv0 % Q for c in lm]
    return fq12(*out)


def fq12_pow(a, e: int):
    out = FQ12_ONE
    base = a
    while e:
        if e & 1:
            out = fq12_mul(out, base)
        base = fq12_sq(base)
        e >>= 1
    return out


# --- G1 --------------------------------------------------------------------


def g1_is_on_curve(p: G1) -> bool:
    if p is None:
        return True
    x, y = p
    return (y * y - x * x * x - B) % Q == 0


def g1_add(p: G1, q: G1) -> G1:
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if (y1 + y2) % Q == 0:
            return None
        lam = (3 * x1 * x1) * pow(2 * y1, Q - 2, Q) % Q
    else:
        lam = (y2 - y1) * pow(x2 - x1, Q - 2, Q) % Q
    x3 = (lam * lam - x1 - x2) % Q
    return (x3, (lam * (x1 - x3) - y1) % Q)


def g1_neg(p: G1) -> G1:
    return None if p is None else (p[0], (-p[1]) % Q)


def g1_mul(p: G1, k: int) -> G1:
    k %= R
    out: G1 = None
    add = p
    while k:
        if k & 1:
            out = g1_add(out, add)
        add = g1_add(add, add)
        k >>= 1
    return out


# --- G2 over Fq2 -----------------------------------------------------------


def _f2(a0=0, a1=0) -> Fq2:
    return (a0 % Q, a1 % Q)


def f2_add(a, b):
    return ((a[0] + b[0]) % Q, (a[1] + b[1]) % Q)


def f2_sub(a, b):
    return ((a[0] - b[0]) % Q, (a[1] - b[1]) % Q)


def f2_mul(a, b):
    return (
        (a[0] * b[0] - a[1] * b[1]) % Q,
        (a[0] * b[1] + a[1] * b[0]) % Q,
    )


def f2_scalar(a, k):
    return (a[0] * k % Q, a[1] * k % Q)


def f2_inv(a):
    d = pow(a[0] * a[0] + a[1] * a[1], Q - 2, Q)
    return (a[0] * d % Q, (-a[1]) * d % Q)


# E'(Fq2): y^2 = x^3 + 3 / (9 + u)
_B2 = f2_mul(_f2(3), f2_inv(_f2(9, 1)))


def g2_is_on_curve(p: G2pt) -> bool:
    if p is None:
        return True
    x, y = p
    lhs = f2_mul(y, y)
    rhs = f2_add(f2_mul(f2_mul(x, x), x), _B2)
    return lhs == rhs


def g2_add(p: G2pt, q: G2pt) -> G2pt:
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if f2_add(y1, y2) == (0, 0):
            return None
        lam = f2_mul(f2_scalar(f2_mul(x1, x1), 3),
                     f2_inv(f2_scalar(y1, 2)))
    else:
        lam = f2_mul(f2_sub(y2, y1), f2_inv(f2_sub(x2, x1)))
    x3 = f2_sub(f2_sub(f2_mul(lam, lam), x1), x2)
    y3 = f2_sub(f2_mul(lam, f2_sub(x1, x3)), y1)
    return (x3, y3)


def g2_neg(p: G2pt) -> G2pt:
    return None if p is None else (p[0], f2_sub((0, 0), p[1]))


def g2_mul(p: G2pt, k: int) -> G2pt:
    k %= R
    out: G2pt = None
    add = p
    while k:
        if k & 1:
            out = g2_add(out, add)
        add = g2_add(add, add)
        k >>= 1
    return out


# --- pairing ---------------------------------------------------------------

_W2 = fq12(0, 0, 1)
_W3 = fq12(0, 0, 0, 1)


def _twist(p: G2pt):
    """E'(Fq2) -> E(Fq12) (the py_ecc untwist of the D-type twist)."""
    if p is None:
        return None
    x, y = p
    nx = [0] * _DEG
    ny = [0] * _DEG
    nx[0], nx[6] = (x[0] - 9 * x[1]) % Q, x[1]
    ny[0], ny[6] = (y[0] - 9 * y[1]) % Q, y[1]
    return (fq12_mul(tuple(nx), _W2), fq12_mul(tuple(ny), _W3))


def _cast_g1(p: G1):
    return None if p is None else (fq12(p[0]), fq12(p[1]))


def _line(p1, p2, t):
    """Evaluate the line through p1, p2 (E(Fq12) points) at t."""
    x1, y1 = p1
    x2, y2 = p2
    xt, yt = t
    if x1 != x2:
        m_num = fq12_sub(y2, y1)
        m_den = fq12_sub(x2, x1)
        return (
            fq12_sub(fq12_mul(m_num, fq12_sub(xt, x1)),
                     fq12_mul(m_den, fq12_sub(yt, y1))),
            m_den,
        )
    if y1 == y2:
        m_num = fq12_scalar(fq12_sq(x1), 3)
        m_den = fq12_scalar(y1, 2)
        return (
            fq12_sub(fq12_mul(m_num, fq12_sub(xt, x1)),
                     fq12_mul(m_den, fq12_sub(yt, y1))),
            m_den,
        )
    return (fq12_sub(xt, x1), FQ12_ONE)


def _add_fq12(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2 and fq12_add(y1, y2) == FQ12_ZERO:
        return None
    if x1 == x2 and y1 == y2:
        lam = fq12_mul(fq12_scalar(fq12_sq(x1), 3),
                       fq12_inv(fq12_scalar(y1, 2)))
    else:
        lam = fq12_mul(fq12_sub(y2, y1), fq12_inv(fq12_sub(x2, x1)))
    x3 = fq12_sub(fq12_sub(fq12_sq(lam), x1), x2)
    y3 = fq12_sub(fq12_mul(lam, fq12_sub(x1, x3)), y1)
    return (x3, y3)


def miller_loop(q_pt: G2pt, p: G1):
    """Optimal-ate Miller loop (py_ecc structure), WITHOUT final exp."""
    if q_pt is None or p is None:
        return FQ12_ONE
    qt = _twist(q_pt)
    pt = _cast_g1(p)
    r_pt = qt
    f_num, f_den = FQ12_ONE, FQ12_ONE
    for bit in bin(ATE_LOOP_COUNT)[2:][1:]:
        n, d = _line(r_pt, r_pt, pt)
        f_num = fq12_mul(fq12_sq(f_num), n)
        f_den = fq12_mul(fq12_sq(f_den), d)
        r_pt = _add_fq12(r_pt, r_pt)
        if bit == "1":
            n, d = _line(r_pt, qt, pt)
            f_num = fq12_mul(f_num, n)
            f_den = fq12_mul(f_den, d)
            r_pt = _add_fq12(r_pt, qt)
    # frobenius steps
    q1 = (fq12_pow(qt[0], Q), fq12_pow(qt[1], Q))
    nq2 = (fq12_pow(q1[0], Q), fq12_neg(fq12_pow(q1[1], Q)))
    n, d = _line(r_pt, q1, pt)
    f_num = fq12_mul(f_num, n)
    f_den = fq12_mul(f_den, d)
    r_pt = _add_fq12(r_pt, q1)
    n, d = _line(r_pt, nq2, pt)
    f_num = fq12_mul(f_num, n)
    f_den = fq12_mul(f_den, d)
    return fq12_mul(f_num, fq12_inv(f_den))


def final_exponentiation(f):
    return fq12_pow(f, (Q ** 12 - 1) // R)


def pairing(q_pt: G2pt, p: G1):
    return final_exponentiation(miller_loop(q_pt, p))


def pairing_check(pairs: Sequence[Tuple[G2pt, G1]]) -> bool:
    """prod e(Q_i, P_i) == 1 with a single final exponentiation."""
    acc = FQ12_ONE
    for q_pt, p in pairs:
        acc = fq12_mul(acc, miller_loop(q_pt, p))
    return final_exponentiation(acc) == FQ12_ONE


# --- MSM (host Pippenger) ---------------------------------------------------


# --- Jacobian coordinates (inversion-free adds for the hot MSM path) -------

JPoint = Optional[Tuple[int, int, int]]  # (X, Y, Z); affine = (X/Z^2, Y/Z^3)


def _jac_from_affine(p: G1) -> JPoint:
    return None if p is None else (p[0], p[1], 1)


def _jac_to_affine(p: JPoint) -> G1:
    if p is None or p[2] == 0:
        return None
    zinv = pow(p[2], Q - 2, Q)
    zinv2 = zinv * zinv % Q
    return (p[0] * zinv2 % Q, p[1] * zinv2 % Q * zinv % Q)


def _jac_double(p: JPoint) -> JPoint:
    if p is None:
        return None
    x, y, z = p
    if y == 0:
        return None
    a = x * x % Q
    b = y * y % Q
    c = b * b % Q
    d = 2 * ((x + b) * (x + b) - a - c) % Q
    e = 3 * a % Q
    f = e * e % Q
    x3 = (f - 2 * d) % Q
    y3 = (e * (d - x3) - 8 * c) % Q
    z3 = 2 * y * z % Q
    return (x3, y3, z3)


def _jac_add(p: JPoint, q: JPoint) -> JPoint:
    if p is None:
        return q
    if q is None:
        return p
    x1, y1, z1 = p
    x2, y2, z2 = q
    z1z1 = z1 * z1 % Q
    z2z2 = z2 * z2 % Q
    u1 = x1 * z2z2 % Q
    u2 = x2 * z1z1 % Q
    s1 = y1 * z2 % Q * z2z2 % Q
    s2 = y2 * z1 % Q * z1z1 % Q
    if u1 == u2:
        if s1 != s2:
            return None
        return _jac_double(p)
    h = (u2 - u1) % Q
    i = 4 * h * h % Q
    j = h * i % Q
    r = 2 * (s2 - s1) % Q
    v = u1 * i % Q
    x3 = (r * r - j - 2 * v) % Q
    y3 = (r * (v - x3) - 2 * s1 * j) % Q
    z3 = 2 * h % Q * z1 % Q * z2 % Q
    return (x3, y3, z3)


def msm_jac(points: Sequence[G1], scalars: Sequence[int],
            window: int = 8, device=None) -> G1:
    """Pippenger with Jacobian accumulation: no per-add inversion (one
    inversion per MSM); the PLONK prover's commitment path.

    Eight or more points go to K4 on a CUDA device and to the host engine
    on the CPU (`window` is the host engine's window; K4 picks its own);
    fewer run the python path below, as in the reference."""
    assert len(points) == len(scalars)
    if len(points) >= 8:
        from ..stark.config import resolve_device

        dev = resolve_device(device)
        if dev.type == "cuda":
            from ..ops import msm

            return msm.msm_device(points, scalars, dev)
        if dev.type != "cpu":
            raise ValueError(f"no MSM on device {dev}")
        from . import bn254_native

        return bn254_native.msm(points, scalars, c=window)
    scalars = [s % R for s in scalars]
    jpts = [_jac_from_affine(p) for p in points]
    n_bits = R.bit_length()
    n_windows = -(-n_bits // window)
    total: JPoint = None
    mask = (1 << window) - 1
    for wi in range(n_windows - 1, -1, -1):
        if total is not None:
            for _ in range(window):
                total = _jac_double(total)
        buckets: List[JPoint] = [None] * (1 << window)
        shift = wi * window
        for pnt, s in zip(jpts, scalars):
            idx = (s >> shift) & mask
            if idx:
                buckets[idx] = _jac_add(buckets[idx], pnt)
        run: JPoint = None
        acc: JPoint = None
        for idx in range(mask, 0, -1):
            run = _jac_add(run, buckets[idx])
            acc = _jac_add(acc, run)
        total = _jac_add(total, acc)
    return _jac_to_affine(total)


def g1_mul_jac(p: G1, k: int) -> G1:
    """Scalar mul through Jacobian doubling (one inversion total)."""
    k %= R
    out: JPoint = None
    add = _jac_from_affine(p)
    while k:
        if k & 1:
            out = _jac_add(out, add)
        add = _jac_double(add)
        k >>= 1
    return _jac_to_affine(out)


def msm(points: Sequence[G1], scalars: Sequence[int], window: int = 8) -> G1:
    """Pippenger bucket method over affine G1."""
    assert len(points) == len(scalars)
    scalars = [s % R for s in scalars]
    n_bits = R.bit_length()
    n_windows = -(-n_bits // window)
    total: G1 = None
    for wi in range(n_windows - 1, -1, -1):
        if total is not None:
            for _ in range(window):
                total = g1_add(total, total)
        buckets: List[G1] = [None] * (1 << window)
        shift = wi * window
        mask = (1 << window) - 1
        for pnt, s in zip(points, scalars):
            idx = (s >> shift) & mask
            if idx:
                buckets[idx] = g1_add(buckets[idx], pnt)
        run: G1 = None
        acc: G1 = None
        for idx in range((1 << window) - 1, 0, -1):
            run = g1_add(run, buckets[idx])
            acc = g1_add(acc, run)
        total = g1_add(total, acc)
    return total


# --- KZG -------------------------------------------------------------------


class KzgSrs:
    """Powers-of-tau SRS over G1 + [tau]G2 (the reference system downloads
    kzg_bn254_{22,23,24}.srs; tests and the wrapper generate insecure
    ones)."""

    def __init__(self, g1_powers: List[G1], tau_g2: G2pt):
        self.g1_powers = g1_powers
        self.tau_g2 = tau_g2

    @classmethod
    def generate_insecure(cls, k: int, tau: int) -> "KzgSrs":
        # fixed-base: precompute [2^j]G once, then each [tau^i]G is a
        # ~128-add bit-sum instead of a full double-and-add ladder.
        table: List[JPoint] = []
        d = _jac_from_affine(G1_GEN)
        for _ in range(R.bit_length()):
            table.append(d)
            d = _jac_double(d)
        powers = []
        acc = 1
        for _ in range(1 << k):
            s = acc
            out: JPoint = None
            j = 0
            while s:
                if s & 1:
                    out = _jac_add(out, table[j])
                s >>= 1
                j += 1
            powers.append(_jac_to_affine(out))
            acc = acc * tau % R
        return cls(powers, g2_mul(G2_GEN, tau))


def kzg_commit(srs: KzgSrs, coeffs: Sequence[int], device=None) -> G1:
    assert len(coeffs) <= len(srs.g1_powers)
    return msm_jac(srs.g1_powers[: len(coeffs)], list(coeffs), device=device)


def kzg_open(srs: KzgSrs, coeffs: Sequence[int], z: int,
             device=None) -> Tuple[int, G1]:
    """Evaluate p(z) and produce the witness commitment [(p(X)-y)/(X-z)]."""
    y = 0
    for c in reversed(coeffs):
        y = (y * z + c) % R
    # synthetic division by (X - z)
    quot = [0] * (len(coeffs) - 1)
    carry = 0
    for i in range(len(coeffs) - 1, 0, -1):
        carry = (coeffs[i] + carry * z) % R
        quot[i - 1] = carry
    proof = (msm_jac(srs.g1_powers[: len(quot)], quot, device=device)
             if quot else None)
    return y, proof


def kzg_verify(tau_g2: G2pt, commitment: G1, z: int, y: int,
               proof: G1) -> bool:
    """e(C - [y]G1, G2) == e(W, [tau]G2 - [z]G2)."""
    lhs = g1_add(commitment, g1_neg(g1_mul(G1_GEN, y)))
    z_g2 = g2_add(tau_g2, g2_neg(g2_mul(G2_GEN, z)))
    return pairing_check([
        (G2_GEN, lhs),
        (g2_neg(z_g2), proof),
    ])
