// Shared device arithmetic of the port's kernels: BN254 Fq and Fr and
// BLS12-381 Fr in Montgomery form (R = 2^256) as 8 little-endian 32-bit
// words, the Fq2 tower and the complete projective additions of G1 and G2.
//
// Replaces the TPU kernels' shared helpers: pallas_field._sos_mul_fn (an
// 8-bit f32 column-SOS, a TPU workaround for the missing widening multiply)
// and _mod_add_sub, and pallas_curve._KernelFq / _KernelFq2 with
// complete_add / complete_add_z1. Here the multiply is an 8x32-bit CIOS on
// PTX carry chains (mad.lo.cc / madc.hi.cc, two independent chains per
// step) with one conditional subtract. The Montgomery product mod p
// is unique and both sides reduce to [0, p), so every output is bit-equal to
// the JAX package's; the curve formulas are transcribed term for term, so
// the projective representatives are equal too.
//
// The numbers below are checked against the Python constants by
// tests/test_torch_field.py::test_cuda_constants_match.

#pragma once
#include <cstdint>
#include <cuda_runtime.h>

typedef uint32_t u32;

// field index: 0 = BN254 Fq (base field), 1 = BN254 Fr (scalar field),
// 2 = BLS12-381 Fr (the privacy SDK's Poseidon field). Every modulus is below
// 2^255, so the sum of two canonical elements never carries out of 256 bits
// and the CIOS product stays below 2p < 2^256.
__constant__ u32 kP[3][8] = {
    {0xd87cfd47u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u,
     0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u},
    {0xf0000001u, 0x43e1f593u, 0x79b97091u, 0x2833e848u,
     0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u},
    {0x00000001u, 0xffffffffu, 0xfffe5bfeu, 0x53bda402u,
     0x09a1d805u, 0x3339d808u, 0x299d7d48u, 0x73eda753u},
};
// -p^-1 mod 2^32
__constant__ u32 kN0[3] = {0xe4866389u, 0xefffffffu, 0xffffffffu};
// 2^256 mod p: one in Montgomery form
__constant__ u32 kOne[3][8] = {
    {0xc58f0d9du, 0xd35d438du, 0xf5c70b3du, 0x0a78eb28u,
     0x7879462cu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u},
    {0x4ffffffbu, 0xac96341cu, 0x9f60cd29u, 0x36fc7695u,
     0x7879462eu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u},
    {0xfffffffeu, 0x00000001u, 0x00034802u, 0x5884b7fau,
     0xecbc4ff5u, 0x998c4fefu, 0xacc5056fu, 0x1824b159u},
};
// 3b = 9 of G1, Montgomery form over Fq
__constant__ u32 kB3Q[8] = {0x410d7ff7u, 0xf60647ceu, 0xd31bd011u,
                            0x2f3d6f4du, 0x3940c6d1u, 0x2943337eu,
                            0xa7e39857u, 0x1d9598e8u};
// 3b' of the G2 twist, b' = 3 / (9 + u), Montgomery form (c0, c1)
__constant__ u32 kB3G2[2][8] = {
    {0xb62e0d6au, 0x3baa927cu, 0xd1b664fdu, 0xd71e7c52u,
     0xd95d4664u, 0x03873e63u, 0x082ab8f4u, 0x0e75b5b1u},
    {0x7596fe35u, 0xaab7c666u, 0xbb6a27bau, 0x31d21a78u,
     0x680401ffu, 0x85dd7297u, 0xdf39a7e9u, 0x03c52d6au},
};

template <int F>
struct Fp {
    u32 w[8];
};
typedef Fp<0> Fq;
typedef Fp<1> Fr;

template <int F>
__device__ __forceinline__ Fp<F> one() {
    Fp<F> r;
#pragma unroll
    for (int j = 0; j < 8; ++j) r.w[j] = kOne[F][j];
    return r;
}

struct Fq2 {
    Fq c0, c1;
};

// ---------------------------------------------------------------------------
// PTX carry-chain primitives. The carry flag (CC.CF) passes from one
// statement to the next: each is asm volatile, so the compiler keeps their
// order, and no code the compiler emits between them touches the flag.
// tests/test_torch_field.py::test_cuda_mul_chain_model runs a transcription
// of mul, add256 and sub256 over these primitives, flag for flag.
// ---------------------------------------------------------------------------

namespace ptx {

__device__ __forceinline__ u32 add_cc(u32 a, u32 b) {
    u32 r;
    asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
    return r;
}
__device__ __forceinline__ u32 addc_cc(u32 a, u32 b) {
    u32 r;
    asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
    return r;
}
__device__ __forceinline__ u32 addc(u32 a, u32 b) {
    u32 r;
    asm volatile("addc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
    return r;
}
__device__ __forceinline__ u32 sub_cc(u32 a, u32 b) {
    u32 r;
    asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
    return r;
}
__device__ __forceinline__ u32 subc_cc(u32 a, u32 b) {
    u32 r;
    asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
    return r;
}
__device__ __forceinline__ u32 subc(u32 a, u32 b) {
    u32 r;
    asm volatile("subc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
    return r;
}
// lo(a * b) + c, carry out
__device__ __forceinline__ u32 mad_lo_cc(u32 a, u32 b, u32 c) {
    u32 r;
    asm volatile("mad.lo.cc.u32 %0, %1, %2, %3;"
                 : "=r"(r) : "r"(a), "r"(b), "r"(c));
    return r;
}
// lo(a * b) + c + carry in, carry out
__device__ __forceinline__ u32 madc_lo_cc(u32 a, u32 b, u32 c) {
    u32 r;
    asm volatile("madc.lo.cc.u32 %0, %1, %2, %3;"
                 : "=r"(r) : "r"(a), "r"(b), "r"(c));
    return r;
}
// hi(a * b) + c + carry in, carry out
__device__ __forceinline__ u32 madc_hi_cc(u32 a, u32 b, u32 c) {
    u32 r;
    asm volatile("madc.hi.cc.u32 %0, %1, %2, %3;"
                 : "=r"(r) : "r"(a), "r"(b), "r"(c));
    return r;
}
// hi(a * b) + c + carry in (hi <= 2^32 - 2, so with c = 0 nothing is lost)
__device__ __forceinline__ u32 madc_hi(u32 a, u32 b, u32 c) {
    u32 r;
    asm volatile("madc.hi.u32 %0, %1, %2, %3;"
                 : "=r"(r) : "r"(a), "r"(b), "r"(c));
    return r;
}

}  // namespace ptx

// r = a - b over 256 bits; returns 0xffffffff on a borrow out, else 0
__device__ __forceinline__ u32 sub256(u32* r, const u32* a, const u32* b) {
    r[0] = ptx::sub_cc(a[0], b[0]);
#pragma unroll
    for (int j = 1; j < 8; ++j) r[j] = ptx::subc_cc(a[j], b[j]);
    return ptx::subc(0, 0);
}

// r = a + b over 256 bits; returns the carry out
__device__ __forceinline__ u32 add256(u32* r, const u32* a, const u32* b) {
    r[0] = ptx::add_cc(a[0], b[0]);
#pragma unroll
    for (int j = 1; j < 8; ++j) r[j] = ptx::addc_cc(a[j], b[j]);
    return ptx::addc(0, 0);
}

template <int F>
__device__ __forceinline__ Fp<F> add(const Fp<F>& a, const Fp<F>& b) {
    Fp<F> s, d;
    u32 c = add256(s.w, a.w, b.w);
    u32 bo = sub256(d.w, s.w, kP[F]);
    return (c || !bo) ? d : s;
}

template <int F>
__device__ __forceinline__ Fp<F> sub(const Fp<F>& a, const Fp<F>& b) {
    Fp<F> d, c;
    u32 bo = sub256(d.w, a.w, b.w);
    add256(c.w, d.w, kP[F]);
    return bo ? c : d;
}

// ---------------------------------------------------------------------------
// CIOS Montgomery product over 32-bit words with the even/odd split.
//
// a * b_i = A_e + 2^32 A_o, where A_e holds the products a_j b_i of even j
// (lo in word j, hi in word j + 1: the pairs never overlap, so one carry
// chain adds them) and A_o those of odd j, shifted down one word; m p
// splits the same way. The running value is T = E + 2^32 O in two 8-word
// arrays, and each step adds A_e + P_e to E and A_o + P_o to O with two
// independent chains of mad.lo / madc.hi. Dividing by 2^32 then swaps the
// arrays' roles: the new E is O plus word 1 of E, the new O is E from word
// 2 up (madc_n_rshift). A carry always goes to the word of its weight: out
// of E's top into O's top, out of E's word 0 into O's word 0.
//
// For canonical inputs (a, b < p < 2^255) T < 2p before every step, so a
// step's sum E + 2^32 O = T + a b_i + m p < 2^32 2p + 2p and O < 2^256: no
// chain carries out of O's top word (the flag that cmad_n leaves there is
// not read). The product is unique
// and canonical, so it equals the JAX package's bit for bit.
// ---------------------------------------------------------------------------

// acc[j], acc[j + 1] = lo, hi of a[j] * bi for even j
__device__ __forceinline__ void mul_n(u32* acc, const u32* a, u32 bi) {
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
        acc[j] = a[j] * bi;
        acc[j + 1] = __umulhi(a[j], bi);
    }
}

// acc += sum over even j of a[j] * bi * 2^(32 j); the carry out stays in
// the flag
__device__ __forceinline__ void cmad_n(u32* acc, const u32* a, u32 bi) {
    acc[0] = ptx::mad_lo_cc(a[0], bi, acc[0]);
    acc[1] = ptx::madc_hi_cc(a[0], bi, acc[1]);
#pragma unroll
    for (int j = 2; j < 8; j += 2) {
        acc[j] = ptx::madc_lo_cc(a[j], bi, acc[j]);
        acc[j + 1] = ptx::madc_hi_cc(a[j], bi, acc[j + 1]);
    }
}

// acc = (acc >> 64) + sum over even j of a[j] * bi * 2^(32 j) + carry in
__device__ __forceinline__ void madc_n_rshift(u32* acc, const u32* a,
                                              u32 bi) {
#pragma unroll
    for (int j = 0; j < 6; j += 2) {
        acc[j] = ptx::madc_lo_cc(a[j], bi, acc[j + 2]);
        acc[j + 1] = ptx::madc_hi_cc(a[j], bi, acc[j + 3]);
    }
    acc[6] = ptx::madc_lo_cc(a[6], bi, 0);
    acc[7] = ptx::madc_hi(a[6], bi, 0);
}

// one CIOS step with b_i. On entry (but the first) the previous step left
// its E in od (od[0] = 0) and its O in ev: T = ev + od / 2^32. On exit
// ev + 2^32 od = T + a b_i + m p, with ev[0] = 0.
template <int F>
__device__ __forceinline__ void mad_n_redc(u32* ev, u32* od, const u32* a,
                                           u32 bi, bool first) {
    if (first) {
        mul_n(od, a + 1, bi);
        mul_n(ev, a, bi);
    } else {
        ev[0] = ptx::add_cc(ev[0], od[1]);
        madc_n_rshift(od, a + 1, bi);
        cmad_n(ev, a, bi);
        od[7] = ptx::addc(od[7], 0);
    }
    const u32 m = ev[0] * kN0[F];
    cmad_n(od, kP[F] + 1, m);
    cmad_n(ev, kP[F], m);
    od[7] = ptx::addc(od[7], 0);
}

// a * b * 2^-256 mod p, canonical (< p), for canonical a and b
template <int F>
__device__ __forceinline__ Fp<F> mul(const Fp<F>& a, const Fp<F>& b) {
    u32 ev[8], od[8];
#pragma unroll
    for (int i = 0; i < 8; i += 2) {
        mad_n_redc<F>(ev, od, a.w, b.w[i], i == 0);
        mad_n_redc<F>(od, ev, a.w, b.w[i + 1], false);
    }
    // the last step left E in od and O in ev: T = ev + od / 2^32 < 2p
    Fp<F> r, d;
    r.w[0] = ptx::add_cc(ev[0], od[1]);
#pragma unroll
    for (int j = 1; j < 7; ++j) r.w[j] = ptx::addc_cc(ev[j], od[j + 1]);
    r.w[7] = ptx::addc(ev[7], 0);
    const u32 bo = sub256(d.w, r.w, kP[F]);
    return bo ? r : d;
}

// G1: 3b = 9, as 8x + x (the JAX kernel's doubling chain)
__device__ __forceinline__ Fq mul_b3(const Fq& x) {
    Fq t = add(x, x);
    t = add(t, t);
    t = add(t, t);
    return add(t, x);
}

__device__ __forceinline__ Fq2 add(const Fq2& a, const Fq2& b) {
    return {add(a.c0, b.c0), add(a.c1, b.c1)};
}

__device__ __forceinline__ Fq2 sub(const Fq2& a, const Fq2& b) {
    return {sub(a.c0, b.c0), sub(a.c1, b.c1)};
}

// Karatsuba over Fq[u] / (u^2 + 1): 3 Fq products
__device__ __forceinline__ Fq2 mul(const Fq2& a, const Fq2& b) {
    Fq t0 = mul(a.c0, b.c0);
    Fq t1 = mul(a.c1, b.c1);
    Fq s = mul(add(a.c0, a.c1), add(b.c0, b.c1));
    return {sub(t0, t1), sub(sub(s, t0), t1)};
}

// 3b (G1) / 3b' (G2) as a field element
template <class T>
__device__ __forceinline__ T b3_const();

template <>
__device__ __forceinline__ Fq b3_const<Fq>() {
    Fq r;
#pragma unroll
    for (int j = 0; j < 8; ++j) r.w[j] = kB3Q[j];
    return r;
}

template <>
__device__ __forceinline__ Fq2 b3_const<Fq2>() {
    Fq2 r;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        r.c0.w[j] = kB3G2[0][j];
        r.c1.w[j] = kB3G2[1][j];
    }
    return r;
}

__device__ __forceinline__ Fq2 mul_b3(const Fq2& x) {
    return mul(x, b3_const<Fq2>());
}

template <class T>
struct Proj {
    T X, Y, Z;
};

// Renes-Costello-Batina 2015 Algorithm 7 (a = 0), pallas_curve.complete_add
template <class T>
__device__ __forceinline__ Proj<T> complete_add(const Proj<T>& P,
                                                const Proj<T>& Q) {
    T t0 = mul(P.X, Q.X);
    T t1 = mul(P.Y, Q.Y);
    T t2 = mul(P.Z, Q.Z);
    T t3 = add(P.X, P.Y);
    T t4 = add(Q.X, Q.Y);
    t3 = mul(t3, t4);
    t4 = add(t0, t1);
    t3 = sub(t3, t4);
    t4 = add(P.Y, P.Z);
    T X3 = add(Q.Y, Q.Z);
    t4 = mul(t4, X3);
    X3 = add(t1, t2);
    t4 = sub(t4, X3);
    X3 = add(P.X, P.Z);
    T Y3 = add(Q.X, Q.Z);
    X3 = mul(X3, Y3);
    Y3 = add(t0, t2);
    Y3 = sub(X3, Y3);
    X3 = add(t0, t0);
    t0 = add(X3, t0);
    t2 = mul_b3(t2);
    T Z3 = add(t1, t2);
    t1 = sub(t1, t2);
    Y3 = mul_b3(Y3);
    X3 = mul(t4, Y3);
    t2 = mul(t3, t1);
    X3 = sub(t2, X3);
    Y3 = mul(Y3, t0);
    t1 = mul(t1, Z3);
    Y3 = add(t1, Y3);
    t0 = mul(t0, t3);
    Z3 = mul(Z3, t4);
    Z3 = add(Z3, t0);
    return {X3, Y3, Z3};
}

// Algorithm 7 with Z2 = 1 (Q affine), pallas_curve.complete_add_z1
template <class T>
__device__ __forceinline__ Proj<T> complete_add_z1(const Proj<T>& P,
                                                   const T& X2, const T& Y2) {
    T t0 = mul(P.X, X2);
    T t1 = mul(P.Y, Y2);
    T t3 = sub(mul(add(P.X, P.Y), add(X2, Y2)), add(t0, t1));
    T t4 = add(mul(Y2, P.Z), P.Y);
    T Y3 = add(mul(X2, P.Z), P.X);
    t0 = add(add(t0, t0), t0);
    T t2 = mul_b3(P.Z);
    T Z3 = add(t1, t2);
    t1 = sub(t1, t2);
    Y3 = mul_b3(Y3);
    T X3 = sub(mul(t3, t1), mul(t4, Y3));
    Y3 = add(mul(Y3, t0), mul(t1, Z3));
    Z3 = add(mul(Z3, t4), mul(t0, t3));
    return {X3, Y3, Z3};
}

// Algorithm 7 with Z1 = Z2 = 1 (both operands affine), 9 products and one
// mul_b3, pallas_curve.complete_add_mixed. The result is projective.
template <class T>
__device__ __forceinline__ Proj<T> complete_add_mixed(const T& X1,
                                                      const T& Y1,
                                                      const T& X2,
                                                      const T& Y2) {
    T t0 = mul(X1, X2);
    T t1 = mul(Y1, Y2);
    T t3 = sub(mul(add(X1, Y1), add(X2, Y2)), add(t0, t1));
    T t4 = add(Y1, Y2);
    T Y3 = add(X1, X2);
    t0 = add(add(t0, t0), t0);
    const T b3 = b3_const<T>();
    T Z3 = add(t1, b3);
    t1 = sub(t1, b3);
    Y3 = mul_b3(Y3);
    T X3 = sub(mul(t3, t1), mul(t4, Y3));
    Y3 = add(mul(Y3, t0), mul(t1, Z3));
    Z3 = add(mul(Z3, t4), mul(t0, t3));
    return {X3, Y3, Z3};
}

// ---------------------------------------------------------------------------
// column-major loads and stores: word row c of element i at base[c * ld + i]
// ---------------------------------------------------------------------------

template <int F>
__device__ __forceinline__ Fp<F> load(const u32* base, long ld, long i) {
    Fp<F> r;
#pragma unroll
    for (int j = 0; j < 8; ++j) r.w[j] = base[j * ld + i];
    return r;
}

template <int F>
__device__ __forceinline__ void store(u32* base, long ld, long i,
                                      const Fp<F>& v) {
#pragma unroll
    for (int j = 0; j < 8; ++j) base[j * ld + i] = v.w[j];
}

// one coordinate: 8 word rows (G1) or 16 (G2: c0 then c1)
template <class T>
struct Coord;

template <>
struct Coord<Fq> {
    static constexpr int ROWS = 8;
    static __device__ __forceinline__ Fq load(const u32* b, long ld, long i) {
        return ::load<0>(b, ld, i);
    }
    static __device__ __forceinline__ void store(u32* b, long ld, long i,
                                                 const Fq& v) {
        ::store<0>(b, ld, i, v);
    }
    static __device__ __forceinline__ Fq zero() {
        Fq r;
#pragma unroll
        for (int j = 0; j < 8; ++j) r.w[j] = 0;
        return r;
    }
    static __device__ __forceinline__ Fq one() { return ::one<0>(); }
};

template <>
struct Coord<Fq2> {
    static constexpr int ROWS = 16;
    static __device__ __forceinline__ Fq2 load(const u32* b, long ld,
                                               long i) {
        return {::load<0>(b, ld, i), ::load<0>(b + 8 * ld, ld, i)};
    }
    static __device__ __forceinline__ void store(u32* b, long ld, long i,
                                                 const Fq2& v) {
        ::store<0>(b, ld, i, v.c0);
        ::store<0>(b + 8 * ld, ld, i, v.c1);
    }
    static __device__ __forceinline__ Fq2 zero() {
        return {Coord<Fq>::zero(), Coord<Fq>::zero()};
    }
    static __device__ __forceinline__ Fq2 one() {
        return {Coord<Fq>::one(), Coord<Fq>::zero()};
    }
};

template <class T>
__device__ __forceinline__ Proj<T> load_proj(const u32* b, long ld, long i) {
    constexpr int K = Coord<T>::ROWS;
    return {Coord<T>::load(b, ld, i), Coord<T>::load(b + K * ld, ld, i),
            Coord<T>::load(b + 2 * K * ld, ld, i)};
}

template <class T>
__device__ __forceinline__ void store_proj(u32* b, long ld, long i,
                                           const Proj<T>& p) {
    constexpr int K = Coord<T>::ROWS;
    Coord<T>::store(b, ld, i, p.X);
    Coord<T>::store(b + K * ld, ld, i, p.Y);
    Coord<T>::store(b + 2 * K * ld, ld, i, p.Z);
}

// the identity (0 : 1 : 0)
template <class T>
__device__ __forceinline__ Proj<T> identity() {
    return {Coord<T>::zero(), Coord<T>::one(), Coord<T>::zero()};
}
