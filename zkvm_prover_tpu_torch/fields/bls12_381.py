"""BLS12-381: host-side (python-int) curve + optimal-ate pairing + KZG.

The reference's `zkvm_prover_tpu/fields/bls12_381.py`, copied whole: the
equivalent of the reference crates' in-guest openvm BLS12-381 pairing
extension and host-side c-kzg usage (blob consistency:
crates/types/batch/src/blob_consistency/openvm.rs:61-149, utils.rs:2-55).
Host-side bignum code: a blob KZG check is one pairing check per batch, on
the host in both packages, not a device kernel.

Tower: Fq2 = Fq[u]/(u^2+1), Fq6 = Fq2[v]/(v^3-(u+1)), Fq12 = Fq6[w]/(w^2-v).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

# base field / scalar field moduli
Q = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001

# curve: y^2 = x^3 + 4;  twist (M-type): y^2 = x^3 + 4(u+1)
B = 4

# BLS parameter x (negative)
BLS_X = 0xD201000000010000
BLS_X_IS_NEG = True


# ---------------------------------------------------------------------------
# Tower arithmetic (tuples of ints; immutable)
# ---------------------------------------------------------------------------

def fq2(a0=0, a1=0):
    return (a0 % Q, a1 % Q)


FQ2_ONE = fq2(1, 0)
FQ2_ZERO = fq2(0, 0)


def fq2_add(a, b):
    return ((a[0] + b[0]) % Q, (a[1] + b[1]) % Q)


def fq2_sub(a, b):
    return ((a[0] - b[0]) % Q, (a[1] - b[1]) % Q)


def fq2_neg(a):
    return ((-a[0]) % Q, (-a[1]) % Q)


def fq2_mul(a, b):
    # (a0 + a1 u)(b0 + b1 u), u^2 = -1
    t0 = a[0] * b[0]
    t1 = a[1] * b[1]
    t2 = (a[0] + a[1]) * (b[0] + b[1])
    return ((t0 - t1) % Q, (t2 - t0 - t1) % Q)


def fq2_sq(a):
    return fq2_mul(a, a)


def fq2_scalar(a, k: int):
    return ((a[0] * k) % Q, (a[1] * k) % Q)


def fq2_inv(a):
    norm = (a[0] * a[0] + a[1] * a[1]) % Q
    ninv = pow(norm, Q - 2, Q)
    return ((a[0] * ninv) % Q, ((-a[1]) * ninv) % Q)


def fq2_conj(a):
    return (a[0], (-a[1]) % Q)


def fq2_mul_nonres(a):
    """Multiply by the sextic non-residue xi = (1 + u)."""
    return ((a[0] - a[1]) % Q, (a[0] + a[1]) % Q)


# Fq6 as tuples of three fq2; v^3 = xi
def fq6_add(a, b):
    return tuple(fq2_add(x, y) for x, y in zip(a, b))


def fq6_sub(a, b):
    return tuple(fq2_sub(x, y) for x, y in zip(a, b))


def fq6_neg(a):
    return tuple(fq2_neg(x) for x in a)


FQ6_ZERO = (FQ2_ZERO, FQ2_ZERO, FQ2_ZERO)
FQ6_ONE = (FQ2_ONE, FQ2_ZERO, FQ2_ZERO)


def fq6_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0 = fq2_mul(a0, b0)
    t1 = fq2_mul(a1, b1)
    t2 = fq2_mul(a2, b2)
    c0 = fq2_add(
        t0,
        fq2_mul_nonres(
            fq2_sub(
                fq2_mul(fq2_add(a1, a2), fq2_add(b1, b2)), fq2_add(t1, t2)
            )
        ),
    )
    c1 = fq2_add(
        fq2_sub(fq2_mul(fq2_add(a0, a1), fq2_add(b0, b1)), fq2_add(t0, t1)),
        fq2_mul_nonres(t2),
    )
    c2 = fq2_add(
        fq2_sub(fq2_mul(fq2_add(a0, a2), fq2_add(b0, b2)), fq2_add(t0, t2)),
        t1,
    )
    return (c0, c1, c2)


def fq6_mul_by_v(a):
    return (fq2_mul_nonres(a[2]), a[0], a[1])


def fq6_inv(a):
    a0, a1, a2 = a
    c0 = fq2_sub(fq2_sq(a0), fq2_mul_nonres(fq2_mul(a1, a2)))
    c1 = fq2_sub(fq2_mul_nonres(fq2_sq(a2)), fq2_mul(a0, a1))
    c2 = fq2_sub(fq2_sq(a1), fq2_mul(a0, a2))
    t = fq2_add(
        fq2_mul(a0, c0),
        fq2_mul_nonres(fq2_add(fq2_mul(a2, c1), fq2_mul(a1, c2))),
    )
    tinv = fq2_inv(t)
    return (fq2_mul(c0, tinv), fq2_mul(c1, tinv), fq2_mul(c2, tinv))


# Fq12 as pairs of fq6; w^2 = v
FQ12_ONE = (FQ6_ONE, FQ6_ZERO)


def fq12_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t0 = fq6_mul(a0, b0)
    t1 = fq6_mul(a1, b1)
    c0 = fq6_add(t0, fq6_mul_by_v(t1))
    c1 = fq6_sub(
        fq6_mul(fq6_add(a0, a1), fq6_add(b0, b1)), fq6_add(t0, t1)
    )
    return (c0, c1)


def fq12_sq(a):
    return fq12_mul(a, a)


def fq12_inv(a):
    a0, a1 = a
    t = fq6_sub(fq6_mul(a0, a0), fq6_mul_by_v(fq6_mul(a1, a1)))
    tinv = fq6_inv(t)
    return (fq6_mul(a0, tinv), fq6_neg(fq6_mul(a1, tinv)))


def fq12_conj(a):
    return (a[0], fq6_neg(a[1]))


def fq12_pow(a, e: int):
    result = FQ12_ONE
    base = a
    while e:
        if e & 1:
            result = fq12_mul(result, base)
        base = fq12_sq(base)
        e >>= 1
    return result


def fq12_frobenius(a, power: int):
    """a^(q^power) via coefficient-wise conjugation + gamma multipliers."""
    out = a
    for _ in range(power):
        out = _fq12_frob1(out)
    return out


# Frobenius coefficients gamma_1,i = xi^((q-1)*i/6)
_XI = (1, 1)


def _frob_coeffs():
    coeffs = []
    e = (Q - 1) // 6
    base = _XI
    # xi^e in Fq2 via square-and-multiply
    def fq2_pow(x, n):
        r = FQ2_ONE
        while n:
            if n & 1:
                r = fq2_mul(r, x)
            x = fq2_sq(x)
            n >>= 1
        return r

    g = fq2_pow(_XI, e)
    acc = FQ2_ONE
    for i in range(6):
        coeffs.append(acc)
        acc = fq2_mul(acc, g)
    return coeffs


_GAMMA1 = _frob_coeffs()


def _fq12_frob1(a):
    (c0, c1, c2), (c3, c4, c5) = a
    # conjugate each Fq2 coefficient, multiply by gamma_1,i
    cs = [c0, c3, c1, c4, c2, c5]  # w-degree order: w^0..w^5
    out = []
    for i, c in enumerate(cs):
        cc = fq2_conj(c)
        out.append(fq2_mul(cc, _GAMMA1[i]))
    return (
        (out[0], out[2], out[4]),
        (out[1], out[3], out[5]),
    )


# ---------------------------------------------------------------------------
# Curve points (affine; None = infinity)
# ---------------------------------------------------------------------------

G1 = Tuple[int, int]
G2pt = Tuple[Tuple[int, int], Tuple[int, int]]

G1_GEN = (
    0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
)
G2_GEN = (
    (
        0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
        0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
    ),
    (
        0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
        0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
    ),
)


def g1_is_on_curve(p: Optional[G1]) -> bool:
    if p is None:
        return True
    x, y = p
    return (y * y - x * x * x - B) % Q == 0


def g2_is_on_curve(p: Optional[G2pt]) -> bool:
    if p is None:
        return True
    x, y = p
    lhs = fq2_sq(y)
    rhs = fq2_add(fq2_mul(fq2_sq(x), x), fq2_scalar(fq2_mul_nonres(FQ2_ONE), B))
    # b' = 4(u+1)
    return lhs == rhs


def g1_add(p, q):
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
    y3 = (lam * (x1 - x3) - y1) % Q
    return (x3, y3)


def g1_neg(p):
    return None if p is None else (p[0], (-p[1]) % Q)


def g1_mul(p, k: int):
    k %= R
    out = None
    add = p
    while k:
        if k & 1:
            out = g1_add(out, add)
        add = g1_add(add, add)
        k >>= 1
    return out


def g2_add(p, q):
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if fq2_add(y1, y2) == FQ2_ZERO:
            return None
        num = fq2_scalar(fq2_sq(x1), 3)
        den = fq2_inv(fq2_scalar(y1, 2))
        lam = fq2_mul(num, den)
    else:
        lam = fq2_mul(fq2_sub(y2, y1), fq2_inv(fq2_sub(x2, x1)))
    x3 = fq2_sub(fq2_sub(fq2_sq(lam), x1), x2)
    y3 = fq2_sub(fq2_mul(lam, fq2_sub(x1, x3)), y1)
    return (x3, y3)


def g2_neg(p):
    return None if p is None else (p[0], fq2_neg(p[1]))


def g2_mul(p, k: int):
    k %= R
    out = None
    add = p
    while k:
        if k & 1:
            out = g2_add(out, add)
        add = g2_add(add, add)
        k >>= 1
    return out


# ---------------------------------------------------------------------------
# Optimal ate pairing
# ---------------------------------------------------------------------------


def _line(q1: G2pt, q2: G2pt, p: G1):
    """Evaluate the line through twist points q1,q2 at the G1 point p.

    BLS12-381 is an M-twist (E': y^2 = x^3 + 4(u+1)); untwist maps
    (x', y') -> (x' w^-2, y' w^-3) with w^6 = xi = 1+u. The affine line at P:
        l = y_P - y'_T w^-3 - lam' w^-1 (x_P - x'_T w^-2)
    scaled by xi = w^6 (an Fq2 constant, killed by the final exponentiation):
        l*xi = (y_P * xi) w^0 + (lam' x'_T - y'_T) w^3 + (-lam' x_P) w^5
    Sparse Fq12: w^0 -> c0.v0, w^3 -> c1.v1, w^5 -> c1.v2.
    """
    x1, y1 = q1
    xp, yp = p
    if q1 == q2:
        lam = fq2_mul(fq2_scalar(fq2_sq(x1), 3), fq2_inv(fq2_scalar(y1, 2)))
    elif q1[0] == q2[0]:
        # vertical: l = x_P - x'_T w^-2; *xi: (x_P xi) w^0 - x'_T w^4
        # w^4 -> c0.v2
        c00 = fq2_mul_nonres(fq2(xp, 0))
        return ((c00, FQ2_ZERO, fq2_neg(x1)), FQ6_ZERO)
    else:
        x2, y2 = q2
        lam = fq2_mul(fq2_sub(y2, y1), fq2_inv(fq2_sub(x2, x1)))
    c_w0 = fq2_mul_nonres(fq2(yp, 0))
    c_w3 = fq2_sub(fq2_mul(lam, x1), y1)
    c_w5 = fq2_neg(fq2_scalar(lam, xp))
    return ((c_w0, FQ2_ZERO, FQ2_ZERO), (FQ2_ZERO, c_w3, c_w5))


def miller_loop(q: G2pt, p: G1):
    if q is None or p is None:
        return FQ12_ONE
    f = FQ12_ONE
    t = q
    bits = bin(BLS_X)[2:]
    for bit in bits[1:]:
        f = fq12_mul(fq12_sq(f), _line(t, t, p))
        t = g2_add(t, t)
        if bit == "1":
            f = fq12_mul(f, _line(t, q, p))
            t = g2_add(t, q)
    if BLS_X_IS_NEG:
        f = fq12_conj(f)
    return f


def final_exponentiation(f):
    # (q^12 - 1)/r = (q^6-1)(q^2+1) * (q^4 - q^2 + 1)/r
    f1 = fq12_mul(fq12_conj(f), fq12_inv(f))        # f^(q^6 - 1)
    f2 = fq12_mul(fq12_frobenius(f1, 2), f1)        # ^(q^2 + 1)
    # hard part by plain exponentiation (host-side, fine)
    e = (Q ** 4 - Q ** 2 + 1) // R
    return fq12_pow(f2, e)


def pairing(q: G2pt, p: G1):
    return final_exponentiation(miller_loop(q, p))


def pairing_check(pairs) -> bool:
    """prod e(P_i, Q_i) == 1; pairs = [(G1, G2), ...]."""
    f = FQ12_ONE
    for p, q in pairs:
        f = fq12_mul(f, miller_loop(q, p))
    return final_exponentiation(f) == FQ12_ONE


# ---------------------------------------------------------------------------
# Serialization (big-endian, zcash/c-kzg format)
# ---------------------------------------------------------------------------


def g2_from_uncompressed_be(data: bytes) -> G2pt:
    """192 bytes: x.c1 || x.c0 || y.c1 || y.c0 (48 each), flags masked off."""
    assert len(data) == 192
    vals = []
    for i in range(4):
        chunk = bytearray(data[48 * i : 48 * (i + 1)])
        if i == 0:
            chunk[0] &= 0x1F  # clear flag bits
        vals.append(int.from_bytes(bytes(chunk), "big"))
    xc1, xc0, yc1, yc0 = vals
    pt = ((xc0, xc1), (yc0, yc1))
    assert g2_is_on_curve(pt), "invalid G2 point"
    return pt


def g1_to_compressed_be(p: Optional[G1]) -> bytes:
    if p is None:
        out = bytearray(48)
        out[0] = 0xC0
        return bytes(out)
    x, y = p
    out = bytearray(x.to_bytes(48, "big"))
    out[0] |= 0x80  # compressed flag
    if y > (Q - 1) // 2:
        out[0] |= 0x20  # sign flag (lexicographically largest y)
    return bytes(out)


def g1_from_compressed_be(data: bytes) -> Optional[G1]:
    assert len(data) == 48
    flags = data[0]
    assert flags & 0x80, "expect compressed flag"
    if flags & 0x40:
        return None
    x = int.from_bytes(bytes([flags & 0x1F]) + data[1:], "big")
    y2 = (x * x * x + B) % Q
    y = pow(y2, (Q + 1) // 4, Q)
    assert (y * y) % Q == y2, "x not on curve"
    big = y > (Q - 1) // 2
    if bool(flags & 0x20) != big:
        y = Q - y
    return (x, y)


# ---------------------------------------------------------------------------
# KZG (EIP-4844)
# ---------------------------------------------------------------------------

# [tau]G2 from the Ethereum KZG ceremony (public constant; c-kzg-4844
# trusted_setup.txt G2[1], also vendored by the reference at
# crates/types/batch/src/blob_consistency/constants.rs)
KZG_G2_SETUP_BYTES = bytes.fromhex(
    "15bfd7dd8cdeb128843bc287230af38926187075cbfbefa81009a2ce615ac53d"
    "2914e5870cb452d2afaaab24f3499f72185cbfee53492714734429b7b38608e2"
    "3926c911cceceac9a36851477ba4c60b087041de621000edc98edada20c1def2"
    "1666c54b0a32529503432fcae0181b4bef79de09fc63671fda5ed1ba9bfa0789"
    "9495346f3d7ac9cd23048ef30d0a154f014353bdb96b626dd7d5ee8599d1fca2"
    "131569490e28de18e82451a496a9c9794ce26d105941f383ee689bfbbb832a99"
)


def kzg_tau_g2() -> G2pt:
    return g2_from_uncompressed_be(KZG_G2_SETUP_BYTES)


def verify_kzg_proof(z: int, y: int, commitment: G1, proof: G1,
                     tau_g2: Optional[G2pt] = None) -> bool:
    """Check P(z) == y: e(C - [y]G1, G2) == e(proof, [tau - z]G2),
    i.e. e(C - yG1, G2) * e(-proof, tauG2 - zG2) == 1.

    Mirrors the reference's in-guest check
    (blob_consistency/openvm.rs:61-83)."""
    tau_g2 = tau_g2 or kzg_tau_g2()
    p_minus_y = g1_add(commitment, g1_neg(g1_mul(G1_GEN, y)))
    x_minus_z = g2_add(g2_mul(G2_GEN, z), g2_neg(tau_g2))
    # e(P - yG1, G2) * e(proof, zG2 - tauG2) == 1
    return pairing_check([(p_minus_y, G2_GEN), (proof, x_minus_z)])


@dataclass
class InsecureKzgSetup:
    """Test-only setup with a known tau — enough to exercise the full KZG
    commit/prove/verify math without the ceremony's G1 powers."""

    tau: int
    g1_powers: list        # [tau^i]G1
    tau_g2: G2pt

    @classmethod
    def generate(cls, tau: int, n: int = 0) -> "InsecureKzgSetup":
        """n G1 powers are only materialized when the honest-MSM path is
        wanted (slow in python); the *_fast methods need none."""
        powers = []
        t = 1
        for _ in range(n):
            powers.append(g1_mul(G1_GEN, t))
            t = (t * tau) % R
        return cls(tau=tau, g1_powers=powers, tau_g2=g2_mul(G2_GEN, tau))

    def commit_coeffs(self, coeffs) -> G1:
        """Commit to a polynomial given in coefficient form."""
        acc = None
        for c, p in zip(coeffs, self.g1_powers):
            if c % R:
                acc = g1_add(acc, g1_mul(p, c % R))
        return acc

    def prove_eval_coeffs(self, coeffs, z: int) -> Tuple[int, G1]:
        """-> (y, proof) for P(z) using the quotient (P(X)-y)/(X-z)."""
        y = 0
        for c in reversed(coeffs):
            y = (y * z + c) % R
        # synthetic division
        q = [0] * (len(coeffs) - 1)
        carry = 0
        for i in reversed(range(1, len(coeffs))):
            carry = (coeffs[i] + carry * z) % R
            q[i - 1] = carry
        return y, self.commit_coeffs(q)

    # -- fast paths exploiting the known tau (test-only; point-identical to
    # the honest MSM computation) --------------------------------------
    def _eval_at_tau(self, coeffs) -> int:
        acc = 0
        for c in reversed(coeffs):
            acc = (acc * self.tau + c) % R
        return acc

    def commit_coeffs_fast(self, coeffs) -> G1:
        return g1_mul(G1_GEN, self._eval_at_tau(coeffs))

    def prove_eval_coeffs_fast(self, coeffs, z: int) -> Tuple[int, G1]:
        y = 0
        for c in reversed(coeffs):
            y = (y * z + c) % R
        p_tau = self._eval_at_tau(coeffs)
        q_tau = (p_tau - y) * pow((self.tau - z) % R, R - 2, R) % R
        return y, g1_mul(G1_GEN, q_tau)
