// BN254 base field Fq and G1 point arithmetic for the port's MSM kernel (K4).
//
// q = 21888242871839275222246405745257275088696311157297823662689037894645226208583
// (254 bits). An element is 8 little-endian 32-bit limbs of its Montgomery
// residue x * 2^256 mod q, in [0, q): the same residue as the reference's 16
// limbs of 16 bits (`zkvm_prover_tpu/ops/bigint.py`, R = 2^256 there too), so
// the two compare bit for bit.
//
// The product is CIOS Montgomery: per limb b_i of b, t += a * b_i and then
// t += m * q with m = t_0 * (-q^-1) mod 2^32, each pass one PTX carry chain
// of mad.lo.cc / madc.lo.cc over the low halves and one of mad.hi.cc /
// madc.hi.cc over the high halves, then a one-word shift. Since q < 2^254,
// t stays below 2q and every partial sum below 2^287: nine words hold it and
// no carry leaves the top word. One conditional subtraction of q ends it.
// The carry flag does not survive from one asm statement to the next, so
// every chain is a single statement.
//
// Points are Jacobian (X, Y, Z), affine (X / Z^2, Y / Z^3); Z == 0 is the
// point at infinity. G1 has a = 0, so doubling is dbl-2009-l and addition
// add-2007-bl (madd-2007-bl for an affine second operand), with the special
// cases (an operand at infinity, P == Q, P == -Q) as branches: the same
// formulas as the reference's host engine, `native/bn254/bn254.cpp`.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace bn {

constexpr uint32_t Q0 = 0xd87cfd47u, Q1 = 0x3c208c16u, Q2 = 0x6871ca8du, Q3 = 0x97816a91u,
                   Q4 = 0x8181585du, Q5 = 0xb85045b6u, Q6 = 0xe131a029u, Q7 = 0x30644e72u;
constexpr uint32_t QINV = 0xe4866389u;  // -q^-1 mod 2^32
// 2^256 mod q: the Montgomery form of 1
constexpr uint32_t ONE0 = 0xc58f0d9du, ONE1 = 0xd35d438du, ONE2 = 0xf5c70b3du,
                   ONE3 = 0x0a78eb28u, ONE4 = 0x7879462cu, ONE5 = 0x666ea36fu,
                   ONE6 = 0x9a07df2fu, ONE7 = 0x0e0a77c1u;

struct Fq {
  uint32_t l[8];
};

struct Pt {
  Fq x, y, z;
};

__device__ __forceinline__ bool is_zero(const Fq& a) {
  return (a.l[0] | a.l[1] | a.l[2] | a.l[3] | a.l[4] | a.l[5] | a.l[6] | a.l[7]) == 0;
}

__device__ __forceinline__ bool equal(const Fq& a, const Fq& b) {
  uint32_t d = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) d |= a.l[i] ^ b.l[i];
  return d == 0;
}

__device__ __forceinline__ void set_one(Fq& a) {
  a.l[0] = ONE0; a.l[1] = ONE1; a.l[2] = ONE2; a.l[3] = ONE3;
  a.l[4] = ONE4; a.l[5] = ONE5; a.l[6] = ONE6; a.l[7] = ONE7;
}

__device__ __forceinline__ void set_zero(Fq& a) {
#pragma unroll
  for (int i = 0; i < 8; ++i) a.l[i] = 0;
}

// s (< 2q) -> s mod q: subtract q where that does not borrow.
__device__ __forceinline__ void reduce_once(Fq& r, const uint32_t s[8]) {
  uint32_t d[8], borrow = 0;
  asm("sub.cc.u32  %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32    %8, %8, %8;"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]), "=r"(d[4]), "=r"(d[5]),
        "=r"(d[6]), "=r"(d[7]), "+r"(borrow)
      : "r"(s[0]), "r"(s[1]), "r"(s[2]), "r"(s[3]), "r"(s[4]), "r"(s[5]), "r"(s[6]),
        "r"(s[7]), "r"(Q0), "r"(Q1), "r"(Q2), "r"(Q3), "r"(Q4), "r"(Q5), "r"(Q6),
        "r"(Q7));
  // borrow is all ones where s < q
#pragma unroll
  for (int i = 0; i < 8; ++i) r.l[i] = borrow ? s[i] : d[i];
}

__device__ __forceinline__ void add(Fq& r, const Fq& a, const Fq& b) {
  uint32_t s[8];  // a + b < 2q < 2^255: no carry out of the top limb
  asm("add.cc.u32  %0, %8, %16;\n\t"
      "addc.cc.u32 %1, %9, %17;\n\t"
      "addc.cc.u32 %2, %10, %18;\n\t"
      "addc.cc.u32 %3, %11, %19;\n\t"
      "addc.cc.u32 %4, %12, %20;\n\t"
      "addc.cc.u32 %5, %13, %21;\n\t"
      "addc.cc.u32 %6, %14, %22;\n\t"
      "addc.u32    %7, %15, %23;"
      : "=r"(s[0]), "=r"(s[1]), "=r"(s[2]), "=r"(s[3]), "=r"(s[4]), "=r"(s[5]),
        "=r"(s[6]), "=r"(s[7])
      : "r"(a.l[0]), "r"(a.l[1]), "r"(a.l[2]), "r"(a.l[3]), "r"(a.l[4]), "r"(a.l[5]),
        "r"(a.l[6]), "r"(a.l[7]), "r"(b.l[0]), "r"(b.l[1]), "r"(b.l[2]), "r"(b.l[3]),
        "r"(b.l[4]), "r"(b.l[5]), "r"(b.l[6]), "r"(b.l[7]));
  reduce_once(r, s);
}

__device__ __forceinline__ void sub(Fq& r, const Fq& a, const Fq& b) {
  uint32_t d[8], borrow = 0;
  asm("sub.cc.u32  %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32    %8, %8, %8;"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]), "=r"(d[4]), "=r"(d[5]),
        "=r"(d[6]), "=r"(d[7]), "+r"(borrow)
      : "r"(a.l[0]), "r"(a.l[1]), "r"(a.l[2]), "r"(a.l[3]), "r"(a.l[4]), "r"(a.l[5]),
        "r"(a.l[6]), "r"(a.l[7]), "r"(b.l[0]), "r"(b.l[1]), "r"(b.l[2]), "r"(b.l[3]),
        "r"(b.l[4]), "r"(b.l[5]), "r"(b.l[6]), "r"(b.l[7]));
  // where a < b the difference wrapped by 2^256: add q back (the carry out
  // of the top limb takes the 2^256 off again)
  asm("add.cc.u32  %0, %0, %8;\n\t"
      "addc.cc.u32 %1, %1, %9;\n\t"
      "addc.cc.u32 %2, %2, %10;\n\t"
      "addc.cc.u32 %3, %3, %11;\n\t"
      "addc.cc.u32 %4, %4, %12;\n\t"
      "addc.cc.u32 %5, %5, %13;\n\t"
      "addc.cc.u32 %6, %6, %14;\n\t"
      "addc.u32    %7, %7, %15;"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7])
      : "r"(Q0 & borrow), "r"(Q1 & borrow), "r"(Q2 & borrow), "r"(Q3 & borrow),
        "r"(Q4 & borrow), "r"(Q5 & borrow), "r"(Q6 & borrow), "r"(Q7 & borrow));
#pragma unroll
  for (int i = 0; i < 8; ++i) r.l[i] = d[i];
}

__device__ __forceinline__ void dbl(Fq& r, const Fq& a) { add(r, a, a); }

// r = a * b * 2^-256 mod q, for a, b in [0, q).
__device__ __forceinline__ void mul(Fq& r, const Fq& a, const Fq& b) {
  uint32_t t0 = 0, t1 = 0, t2 = 0, t3 = 0, t4 = 0, t5 = 0, t6 = 0, t7 = 0, t8 = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    // t += a * b_i (t8 is 0 here: t < 2q fits in eight limbs)
    asm("mad.lo.cc.u32  %0, %9, %17, %0;\n\t"
        "madc.lo.cc.u32 %1, %10, %17, %1;\n\t"
        "madc.lo.cc.u32 %2, %11, %17, %2;\n\t"
        "madc.lo.cc.u32 %3, %12, %17, %3;\n\t"
        "madc.lo.cc.u32 %4, %13, %17, %4;\n\t"
        "madc.lo.cc.u32 %5, %14, %17, %5;\n\t"
        "madc.lo.cc.u32 %6, %15, %17, %6;\n\t"
        "madc.lo.cc.u32 %7, %16, %17, %7;\n\t"
        "addc.u32       %8, %8, 0;\n\t"
        "mad.hi.cc.u32  %1, %9, %17, %1;\n\t"
        "madc.hi.cc.u32 %2, %10, %17, %2;\n\t"
        "madc.hi.cc.u32 %3, %11, %17, %3;\n\t"
        "madc.hi.cc.u32 %4, %12, %17, %4;\n\t"
        "madc.hi.cc.u32 %5, %13, %17, %5;\n\t"
        "madc.hi.cc.u32 %6, %14, %17, %6;\n\t"
        "madc.hi.cc.u32 %7, %15, %17, %7;\n\t"
        "madc.hi.u32    %8, %16, %17, %8;"
        : "+r"(t0), "+r"(t1), "+r"(t2), "+r"(t3), "+r"(t4), "+r"(t5), "+r"(t6), "+r"(t7),
          "+r"(t8)
        : "r"(a.l[0]), "r"(a.l[1]), "r"(a.l[2]), "r"(a.l[3]), "r"(a.l[4]), "r"(a.l[5]),
          "r"(a.l[6]), "r"(a.l[7]), "r"(b.l[i]));
    const uint32_t m = t0 * QINV;
    // t += m * q: the low word becomes 0 and is shifted out below
    asm("mad.lo.cc.u32  %0, %9, %10, %0;\n\t"
        "madc.lo.cc.u32 %1, %9, %11, %1;\n\t"
        "madc.lo.cc.u32 %2, %9, %12, %2;\n\t"
        "madc.lo.cc.u32 %3, %9, %13, %3;\n\t"
        "madc.lo.cc.u32 %4, %9, %14, %4;\n\t"
        "madc.lo.cc.u32 %5, %9, %15, %5;\n\t"
        "madc.lo.cc.u32 %6, %9, %16, %6;\n\t"
        "madc.lo.cc.u32 %7, %9, %17, %7;\n\t"
        "addc.u32       %8, %8, 0;\n\t"
        "mad.hi.cc.u32  %1, %9, %10, %1;\n\t"
        "madc.hi.cc.u32 %2, %9, %11, %2;\n\t"
        "madc.hi.cc.u32 %3, %9, %12, %3;\n\t"
        "madc.hi.cc.u32 %4, %9, %13, %4;\n\t"
        "madc.hi.cc.u32 %5, %9, %14, %5;\n\t"
        "madc.hi.cc.u32 %6, %9, %15, %6;\n\t"
        "madc.hi.cc.u32 %7, %9, %16, %7;\n\t"
        "madc.hi.u32    %8, %9, %17, %8;"
        : "+r"(t0), "+r"(t1), "+r"(t2), "+r"(t3), "+r"(t4), "+r"(t5), "+r"(t6), "+r"(t7),
          "+r"(t8)
        : "r"(m), "r"(Q0), "r"(Q1), "r"(Q2), "r"(Q3), "r"(Q4), "r"(Q5), "r"(Q6), "r"(Q7));
    t0 = t1; t1 = t2; t2 = t3; t3 = t4; t4 = t5; t5 = t6; t6 = t7; t7 = t8; t8 = 0;
  }
  const uint32_t s[8] = {t0, t1, t2, t3, t4, t5, t6, t7};
  reduce_once(r, s);
}

__device__ __forceinline__ void sqr(Fq& r, const Fq& a) { mul(r, a, a); }

__device__ __forceinline__ void set_infinity(Pt& p) {
  set_one(p.x);
  set_one(p.y);
  set_zero(p.z);
}

// r = 2p (dbl-2009-l); r may alias p.
__device__ __forceinline__ void pt_dbl(Pt& r, const Pt& p) {
  if (is_zero(p.z)) {
    r = p;
    return;
  }
  Fq A, B, C, D, E, F, t;
  sqr(A, p.x);
  sqr(B, p.y);
  sqr(C, B);
  add(t, p.x, B);
  sqr(t, t);
  sub(t, t, A);
  sub(t, t, C);
  dbl(D, t);         // D = 2((X + B)^2 - A - C)
  dbl(E, A);
  add(E, E, A);      // E = 3A
  sqr(F, E);
  mul(t, p.y, p.z);  // before r.x is written: r may alias p
  dbl(r.z, t);       // Z3 = 2YZ
  dbl(t, D);
  sub(r.x, F, t);    // X3 = F - 2D
  sub(t, D, r.x);
  mul(t, E, t);
  dbl(C, C);
  dbl(C, C);
  dbl(C, C);         // 8C
  sub(r.y, t, C);    // Y3 = E(D - X3) - 8C
}

// r = p + q (add-2007-bl); r may alias p or q.
__device__ __forceinline__ void pt_add(Pt& r, const Pt& p, const Pt& q) {
  if (is_zero(p.z)) {
    r = q;
    return;
  }
  if (is_zero(q.z)) {
    r = p;
    return;
  }
  Fq z1z1, z2z2, u1, u2, s1, s2, h, i, j, rr, v, t;
  sqr(z1z1, p.z);
  sqr(z2z2, q.z);
  mul(u1, p.x, z2z2);
  mul(u2, q.x, z1z1);
  mul(s1, p.y, q.z);
  mul(s1, s1, z2z2);
  mul(s2, q.y, p.z);
  mul(s2, s2, z1z1);
  sub(h, u2, u1);
  sub(rr, s2, s1);
  if (is_zero(h)) {
    if (is_zero(rr)) {
      pt_dbl(r, p);
    } else {
      set_infinity(r);
    }
    return;
  }
  add(t, p.z, q.z);
  sqr(t, t);
  sub(t, t, z1z1);
  sub(t, t, z2z2);
  Fq z3;
  mul(z3, t, h);     // Z3 = ((Z1 + Z2)^2 - Z1Z1 - Z2Z2) H
  dbl(rr, rr);       // r = 2(S2 - S1)
  dbl(t, h);
  sqr(i, t);         // I = (2H)^2
  mul(j, h, i);      // J = H I
  mul(v, u1, i);     // V = U1 I
  sqr(r.x, rr);
  sub(r.x, r.x, j);
  sub(r.x, r.x, v);
  sub(r.x, r.x, v);  // X3 = r^2 - J - 2V
  sub(t, v, r.x);
  mul(t, rr, t);
  mul(s1, s1, j);
  dbl(s1, s1);
  sub(r.y, t, s1);   // Y3 = r(V - X3) - 2 S1 J
  r.z = z3;
}

// r = p + (x2, y2, 1) (madd-2007-bl), the affine operand not at infinity;
// r may alias p.
__device__ __forceinline__ void pt_add_affine(Pt& r, const Pt& p, const Fq& x2, const Fq& y2) {
  if (is_zero(p.z)) {
    r.x = x2;
    r.y = y2;
    set_one(r.z);
    return;
  }
  Fq z1z1, u2, s2, h, hh, i, j, rr, v, t;
  sqr(z1z1, p.z);
  mul(u2, x2, z1z1);
  mul(s2, y2, p.z);
  mul(s2, s2, z1z1);
  sub(h, u2, p.x);
  sub(rr, s2, p.y);
  if (is_zero(h)) {
    if (is_zero(rr)) {
      Pt a;
      a.x = x2;
      a.y = y2;
      set_one(a.z);
      pt_dbl(r, a);
    } else {
      set_infinity(r);
    }
    return;
  }
  sqr(hh, h);
  add(t, p.z, h);
  sqr(t, t);
  sub(t, t, z1z1);
  Fq z3;
  sub(z3, t, hh);    // Z3 = (Z1 + H)^2 - Z1Z1 - HH
  dbl(i, hh);
  dbl(i, i);         // I = 4 HH
  mul(j, h, i);      // J = H I
  dbl(rr, rr);       // r = 2(S2 - Y1)
  mul(v, p.x, i);    // V = X1 I
  Fq y1j;
  mul(y1j, p.y, j);
  sqr(r.x, rr);
  sub(r.x, r.x, j);
  sub(r.x, r.x, v);
  sub(r.x, r.x, v);  // X3 = r^2 - J - 2V
  sub(t, v, r.x);
  mul(t, rr, t);
  dbl(y1j, y1j);
  sub(r.y, t, y1j);  // Y3 = r(V - X3) - 2 Y1 J
  r.z = z3;
}

__device__ __forceinline__ void load(Fq& a, const uint32_t* p) {
#pragma unroll
  for (int i = 0; i < 8; ++i) a.l[i] = p[i];
}

__device__ __forceinline__ void store(uint32_t* p, const Fq& a) {
#pragma unroll
  for (int i = 0; i < 8; ++i) p[i] = a.l[i];
}

__device__ __forceinline__ void load(Pt& a, const uint32_t* p) {
  load(a.x, p);
  load(a.y, p + 8);
  load(a.z, p + 16);
}

__device__ __forceinline__ void store(uint32_t* p, const Pt& a) {
  store(p, a.x);
  store(p + 8, a.y);
  store(p + 16, a.z);
}

}  // namespace bn
