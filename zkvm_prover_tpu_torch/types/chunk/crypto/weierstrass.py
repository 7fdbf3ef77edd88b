"""Short-Weierstrass curve arithmetic over prime fields (host-side).

Generic backend for the secp256k1/secp256r1 precompile providers (reference
crates/types/chunk/src/crypto/{secp256k1.rs,secp256r1.rs} delegate to the
k256/p256 crates; here one jacobian implementation serves both).

A copy of the reference's `zkvm_prover_tpu/types/chunk/crypto/weierstrass.py`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

Point = Optional[Tuple[int, int]]  # None = point at infinity (affine)


@dataclass(frozen=True)
class Curve:
    p: int          # field prime
    a: int
    b: int
    n: int          # group order
    gx: int
    gy: int

    def is_on_curve(self, pt: Point) -> bool:
        if pt is None:
            return True
        x, y = pt
        return (y * y - (x * x * x + self.a * x + self.b)) % self.p == 0

    # -- jacobian core ----------------------------------------------------
    def _double(self, P):
        X, Y, Z = P
        if Y == 0:
            return (0, 1, 0)
        p = self.p
        S = (4 * X * Y * Y) % p
        M = (3 * X * X + self.a * Z ** 4) % p
        X2 = (M * M - 2 * S) % p
        Y2 = (M * (S - X2) - 8 * Y ** 4) % p
        Z2 = (2 * Y * Z) % p
        return (X2, Y2, Z2)

    def _add(self, P, Q):
        if P[2] == 0:
            return Q
        if Q[2] == 0:
            return P
        p = self.p
        X1, Y1, Z1 = P
        X2, Y2, Z2 = Q
        U1 = (X1 * Z2 * Z2) % p
        U2 = (X2 * Z1 * Z1) % p
        S1 = (Y1 * Z2 ** 3) % p
        S2 = (Y2 * Z1 ** 3) % p
        if U1 == U2:
            if S1 != S2:
                return (0, 1, 0)
            return self._double(P)
        H = (U2 - U1) % p
        R = (S2 - S1) % p
        H2 = (H * H) % p
        H3 = (H * H2) % p
        U1H2 = (U1 * H2) % p
        X3 = (R * R - H3 - 2 * U1H2) % p
        Y3 = (R * (U1H2 - X3) - S1 * H3) % p
        Z3 = (H * Z1 * Z2) % p
        return (X3, Y3, Z3)

    def _to_jac(self, pt: Point):
        return (0, 1, 0) if pt is None else (pt[0], pt[1], 1)

    def _to_affine(self, P) -> Point:
        if P[2] == 0:
            return None
        zi = pow(P[2], self.p - 2, self.p)
        return ((P[0] * zi * zi) % self.p, (P[1] * zi ** 3) % self.p)

    # -- public ops ---------------------------------------------------------
    def add(self, a: Point, b: Point) -> Point:
        return self._to_affine(self._add(self._to_jac(a), self._to_jac(b)))

    def mul(self, k: int, pt: Point) -> Point:
        k %= self.n
        acc = (0, 1, 0)
        base = self._to_jac(pt)
        while k:
            if k & 1:
                acc = self._add(acc, base)
            base = self._double(base)
            k >>= 1
        return self._to_affine(acc)

    def mul_add(self, k1: int, p1: Point, k2: int, p2: Point) -> Point:
        """k1*p1 + k2*p2 (Shamir's trick)."""
        a = self._to_jac(p1)
        b = self._to_jac(p2)
        ab = self._add(a, b)
        acc = (0, 1, 0)
        bits = max(k1.bit_length(), k2.bit_length())
        for i in range(bits - 1, -1, -1):
            acc = self._double(acc)
            s = ((k1 >> i) & 1) | (((k2 >> i) & 1) << 1)
            if s == 1:
                acc = self._add(acc, a)
            elif s == 2:
                acc = self._add(acc, b)
            elif s == 3:
                acc = self._add(acc, ab)
        return self._to_affine(acc)

    def generator(self) -> Point:
        return (self.gx, self.gy)

    def lift_x(self, x: int, y_odd: int) -> Point:
        """Decompress: y^2 = x^3 + ax + b (p ≡ 3 mod 4 for both curves)."""
        assert self.p % 4 == 3
        y2 = (x * x * x + self.a * x + self.b) % self.p
        y = pow(y2, (self.p + 1) // 4, self.p)
        if (y * y) % self.p != y2:
            raise ValueError("x not on curve")
        if (y & 1) != y_odd:
            y = self.p - y
        return (x, y)


SECP256K1 = Curve(
    p=2**256 - 2**32 - 977,
    a=0,
    b=7,
    n=0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141,
    gx=0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798,
    gy=0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8,
)

SECP256R1 = Curve(
    p=0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFF,
    a=0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFC,
    b=0x5AC635D8AA3A93E7B3EBBD55769886BC651D06B0CC53B0F63BCE3C3E27D2604B,
    n=0xFFFFFFFF00000000FFFFFFFFFFFFFFFFBCE6FAADA7179E84F3B9CAC2FC632551,
    gx=0x6B17D1F2E12C4247F8BCE6E563A440F277037D812DEB33A0F4A13945D898C296,
    gy=0x4FE342E2FE1A7F9B8EE7EB4A7C0F9E162BCE33576B315ECECBB6406837BF51F5,
)
