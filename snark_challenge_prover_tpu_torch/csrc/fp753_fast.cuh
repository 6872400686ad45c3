// 753-bit prime-field arithmetic for one GPU thread, second form: the
// Montgomery product with PTX carry chains and its operands in registers,
// the modulus as compile-time constants, and lazily reduced values whose
// bound the compiler carries in their type.  Elements are 24 little-endian
// 32-bit words, Montgomery radix R = 2^768, as in fp753.cuh (which
// mont_mul.cu keeps using).
//
// The product (mont_mul) is CIOS with 24 words, fully unrolled, in the
// even/odd form: the products a[j] * b[i] of even j and of odd j go to two
// accumulators offset by one word, so that every row is one carry chain of
// mad.lo.cc / madc.hi.cc and the single carry flag suffices.  It needs the
// modulus to leave headroom in the top word (753 of 768 bits), which also
// lets the operands be lazy.  It is __noinline__: the group-law kernels
// make 14 to 78 products, and inlined they would take minutes of ptxas.
// Its operands come from and go to the caller's local memory; inside, a, b
// and the 48 words of the two accumulators are registers, and the
// modulus words are immediates.  mont_mul_sums is the same product of two
// sums, for Karatsuba, whose four addends it reads and adds in registers
// so that the sums never pass through memory; an extension product is one
// __noinline__ call as well (fe_mul_call).
//
// Lazy reduction: Fq<B> holds a value < B p (not necessarily canonical).
// MAXB bounds every value: 64 p < 2^759.  A product of two such values,
// a * b < 4096 p^2, leaves the CIOS result below p + 4096 p^2 / R < 1.12 p
// (R / p = 37054 for both moduli), so one conditional subtract makes it
// canonical.  Sums add bounds; a - b adds k p with k the power of two at
// or above b's bound; a small integer K multiplies the bound by K.  Where a
// result would pass MAXB, the larger operand is first halved by one
// conditional subtract of ceil(B / 2) p: a value below B p minus C p where
// it is at least C p is below max(C, B - C) p (the true bound, not C).
// The bounds are template arguments, so every one of these decisions is
// made, and static_assert checked, at compile time.
#pragma once
#include <stdint.h>

#include <utility>
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

namespace f753 {

typedef uint32_t u32;
typedef uint64_t u64;

constexpr int NW = 24;       // words of an element
constexpr int MAXB = 64;     // every lazy value is below MAXB p
constexpr int MULB = 4096;   // a product's operand bounds multiply to at most this

#ifdef __CUDACC__
#define F_HD __host__ __device__
#define F_DEV static __device__ __forceinline__
#define F_NOINLINE static __device__ __noinline__

// ---- carry-chain primitives (PTX): .cc writes the carry flag, c reads it
F_DEV u32 add_cc(u32 a, u32 b) { u32 r; asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b)); return r; }
F_DEV u32 addc_cc(u32 a, u32 b) { u32 r; asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b)); return r; }
F_DEV u32 addc(u32 a, u32 b) { u32 r; asm volatile("addc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b)); return r; }
F_DEV u32 sub_cc(u32 a, u32 b) { u32 r; asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b)); return r; }
F_DEV u32 subc_cc(u32 a, u32 b) { u32 r; asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b)); return r; }
F_DEV u32 subc(u32 a, u32 b) { u32 r; asm volatile("subc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b)); return r; }
F_DEV u32 mul_hi(u32 a, u32 b) { return __umulhi(a, b); }
F_DEV u32 mad_lo_cc(u32 a, u32 b, u32 c) { u32 r; asm volatile("mad.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c)); return r; }
F_DEV u32 madc_lo_cc(u32 a, u32 b, u32 c) { u32 r; asm volatile("madc.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c)); return r; }
F_DEV u32 madc_lo(u32 a, u32 b, u32 c) { u32 r; asm volatile("madc.lo.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c)); return r; }
F_DEV u32 madc_hi_cc(u32 a, u32 b, u32 c) { u32 r; asm volatile("madc.hi.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c)); return r; }
F_DEV u32 madc_hi(u32 a, u32 b, u32 c) { u32 r; asm volatile("madc.hi.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c)); return r; }
#else
// A host build (g++ with __global__ and the launch defined away) runs the
// same code with the carry flag kept in a variable.
#define F_HD
#define F_DEV static inline
#define F_NOINLINE static __attribute__((noinline))
static u32 carry_flag;
F_DEV u32 set_cf(u64 s) { carry_flag = (u32)(s >> 32) & 1; return (u32)s; }
F_DEV u32 add_cc(u32 a, u32 b) { return set_cf((u64)a + b); }
F_DEV u32 addc_cc(u32 a, u32 b) { return set_cf((u64)a + b + carry_flag); }
F_DEV u32 addc(u32 a, u32 b) { return a + b + carry_flag; }
F_DEV u32 sub_cc(u32 a, u32 b) { return set_cf((u64)a - b); }
F_DEV u32 subc_cc(u32 a, u32 b) { return set_cf((u64)a - b - carry_flag); }
F_DEV u32 subc(u32 a, u32 b) { return a - b - carry_flag; }
F_DEV u32 mul_hi(u32 a, u32 b) { return (u32)(((u64)a * b) >> 32); }
F_DEV u32 mad_lo_cc(u32 a, u32 b, u32 c) { return set_cf((u64)(a * b) + c); }
F_DEV u32 madc_lo_cc(u32 a, u32 b, u32 c) { return set_cf((u64)(a * b) + c + carry_flag); }
F_DEV u32 madc_lo(u32 a, u32 b, u32 c) { return a * b + c + carry_flag; }
F_DEV u32 madc_hi_cc(u32 a, u32 b, u32 c) { return set_cf((u64)mul_hi(a, b) + c + carry_flag); }
F_DEV u32 madc_hi(u32 a, u32 b, u32 c) { return mul_hi(a, b) + c + carry_flag; }
#endif

// ---- compile-time words: the moduli and their small multiples ----------
struct W24 {
    u32 w[NW];
};

F_HD constexpr W24 w24_times(const W24& p, u32 k)
{
    W24 r{};
    u64 c = 0;
    for (int j = 0; j < NW; j++) {
        const u64 t = (u64)p.w[j] * k + c;
        r.w[j] = (u32)t;
        c = t >> 32;
    }
    return r;
}

F_HD constexpr int pow2ceil(int b)
{
    int k = 1;
    while (k < b) k *= 2;
    return k;
}

// Fq of MNT4753 (models/primes.py FIELD_B)
struct ModMnt4753 {
    static F_HD constexpr W24 p()
    {
        return W24{{0x245e8001u, 0x5e9063deu, 0x2cdd119fu, 0xe39d5452u, 0x9ac425f0u, 0x63881071u,
                    0x767254a4u, 0x685acce9u, 0xcb537e38u, 0xb80f0da5u, 0xf218059du, 0xb117e776u,
                    0xa15af79du, 0x99d124d9u, 0xe8a0ed8du, 0x07fdb925u, 0x6c97d873u, 0x5eb7e8f9u,
                    0x5b8fafedu, 0xb7f99750u, 0xeee2cdadu, 0x10229022u, 0x2d92c411u, 0x0001c4c6u}};
    }
    static constexpr u32 n0 = 0xe45e7fffu;  // -p^-1 mod 2^32
};

// Fq of MNT6753 = Fr of MNT4753 (models/primes.py FIELD_A)
struct ModMnt6753 {
    static F_HD constexpr W24 p()
    {
        return W24{{0x40000001u, 0xd90776e2u, 0x0fa13a4fu, 0x4ea09917u, 0x3f005797u, 0xd6c381bcu,
                    0x34993aa4u, 0xb9dff976u, 0x29212636u, 0x3eebca94u, 0xc859a99bu, 0xb26c5c28u,
                    0xa15af79du, 0x99d124d9u, 0xe8a0ed8du, 0x07fdb925u, 0x6c97d873u, 0x5eb7e8f9u,
                    0x5b8fafedu, 0xb7f99750u, 0xeee2cdadu, 0x10229022u, 0x2d92c411u, 0x0001c4c6u}};
    }
    static constexpr u32 n0 = 0x3fffffffu;
};

// ---- the Montgomery product -------------------------------------------
// acc = a[0, 2, 4, ...] * bi as (lo, hi) word pairs; a is read with stride 2
F_DEV void mul_n(u32* acc, const u32* a, u32 bi)
{
#pragma unroll
    for (int j = 0; j < NW; j += 2) {
        acc[j] = a[j] * bi;
        acc[j + 1] = mul_hi(a[j], bi);
    }
}

// acc += a[0, 2, 4, ...] * bi in one chain; the carry out is left in the flag
F_DEV void cmad_n(u32* acc, const u32* a, u32 bi)
{
    acc[0] = mad_lo_cc(a[0], bi, acc[0]);
    acc[1] = madc_hi_cc(a[0], bi, acc[1]);
#pragma unroll
    for (int j = 2; j < NW; j += 2) {
        acc[j] = madc_lo_cc(a[j], bi, acc[j]);
        acc[j + 1] = madc_hi_cc(a[j], bi, acc[j + 1]);
    }
}

// odd = (odd >> 64) + a[0, 2, ...] * bi + carry in, two words down
F_DEV void madc_n_rshift(u32* odd, const u32* a, u32 bi)
{
#pragma unroll
    for (int j = 0; j < NW - 2; j += 2) {
        odd[j] = madc_lo_cc(a[j], bi, odd[j + 2]);
        odd[j + 1] = madc_hi_cc(a[j], bi, odd[j + 3]);
    }
    odd[NW - 2] = madc_lo_cc(a[NW - 2], bi, 0);
    odd[NW - 1] = madc_hi(a[NW - 2], bi, 0);
}

// One CIOS round.  Before it, the running value is even + odd * 2^32 with
// even[0] == 0 (after a first round) and the caller passes the arrays with
// their roles swapped, so dividing by 2^32 is a renaming plus the shift in
// madc_n_rshift.  After it, the value has gained a * bi + m * p, and
// even[0] == 0 again.  The carries out of the top words that are dropped
// are zero because the value stays below (a + p) (1 + 2^-32) < 2^768.
template <class M>
F_DEV void mad_n_redc(u32* even, u32* odd, const u32* a, u32 bi, bool first)
{
    constexpr W24 P = M::p();
    if (first) {
        mul_n(odd, a + 1, bi);
        mul_n(even, a, bi);
    } else {
        even[0] = add_cc(even[0], odd[1]);
        madc_n_rshift(odd, a + 1, bi);
        cmad_n(even, a, bi);
        odd[NW - 1] = addc(odd[NW - 1], 0);
    }
    const u32 mi = even[0] * M::n0;
    cmad_n(odd, P.w + 1, mi);
    cmad_n(even, P.w, mi);
    odd[NW - 1] = addc(odd[NW - 1], 0);
}

// r = a + b modulo 2^768 in one chain (r may alias a or b)
F_DEV void add_chain(u32* r, const u32* a, const u32* b)
{
    r[0] = add_cc(a[0], b[0]);
#pragma unroll
    for (int j = 1; j < NW - 1; j++) r[j] = addc_cc(a[j], b[j]);
    r[NW - 1] = addc(a[NW - 1], b[NW - 1]);
}

// r = a - b modulo 2^768 in one chain; the borrow out is left in the flag
F_DEV void sub_chain(u32* r, const u32* a, const u32* b)
{
    r[0] = sub_cc(a[0], b[0]);
#pragma unroll
    for (int j = 1; j < NW; j++) r[j] = subc_cc(a[j], b[j]);
}

// r = v - c where v >= c, else v (one conditional subtract of a constant)
F_DEV void cond_sub(u32* r, const u32* v, const u32* c)
{
    u32 d[NW];
    sub_chain(d, v, c);
    const u32 lt = subc(0, 0);  // all ones where v < c
#pragma unroll
    for (int j = 0; j < NW; j++) r[j] = (v[j] & lt) | (d[j] & ~lt);
}

// r = a * b * 2^-768 mod p, canonical, for a * b < MULB p^2
template <class M>
F_DEV void mont_core(u32* r, const u32* a, const u32* b)
{
    constexpr W24 P = M::p();
    u32 even[NW], odd[NW];
#pragma unroll
    for (int i = 0; i < NW; i += 2) {
        mad_n_redc<M>(even, odd, a, b[i], i == 0);
        mad_n_redc<M>(odd, even, a, b[i + 1], false);
    }
    // the result is even + (odd >> 32), below 2p
    even[0] = add_cc(even[0], odd[1]);
#pragma unroll
    for (int j = 1; j < NW - 1; j++) even[j] = addc_cc(even[j], odd[j + 1]);
    even[NW - 1] = addc(even[NW - 1], 0);
    cond_sub(r, even, P.w);
}

// 16-byte moves between memory and registers (every operand is 16-byte aligned)
F_DEV void load_words(u32* x, const u32* src)
{
#ifdef __CUDACC__
#pragma unroll
    for (int k = 0; k < NW / 4; k++) {
        const uint4 v = reinterpret_cast<const uint4*>(src)[k];
        x[4 * k] = v.x; x[4 * k + 1] = v.y; x[4 * k + 2] = v.z; x[4 * k + 3] = v.w;
    }
#else
    for (int j = 0; j < NW; j++) x[j] = src[j];
#endif
}

F_DEV void store_words(u32* dst, const u32* x)
{
#ifdef __CUDACC__
#pragma unroll
    for (int k = 0; k < NW / 4; k++)
        reinterpret_cast<uint4*>(dst)[k] = make_uint4(x[4 * k], x[4 * k + 1], x[4 * k + 2], x[4 * k + 3]);
#else
    for (int j = 0; j < NW; j++) dst[j] = x[j];
#endif
}

// r may alias a or b; a and b may lie in local or in global memory
template <class M>
F_NOINLINE void mont_mul(u32* r, const u32* a, const u32* b)
{
    u32 x[NW], y[NW], t[NW];
    load_words(x, a);
    load_words(y, b);
    mont_core<M>(t, x, y);
    store_words(r, t);
}

// r = (a0 + a1)(b0 + b1) * 2^-768 mod p: a Karatsuba product whose sums are
// formed in registers instead of passing through memory
template <class M>
F_NOINLINE void mont_mul_sums(u32* r, const u32* a0, const u32* a1, const u32* b0, const u32* b1)
{
    u32 x[NW], y[NW], t[NW];
    load_words(x, a0);
    load_words(t, a1);
    add_chain(x, x, t);
    load_words(y, b0);
    load_words(t, b1);
    add_chain(y, y, t);
    mont_core<M>(t, x, y);
    store_words(r, t);
}

// ---- lazy values: Fq<B> < B p, and extension elements of them ----------
template <int B>
struct alignas(16) Fq {
    static constexpr int bound = B;
    u32 w[NW];
};

template <int D, int B>
struct Fe {
    static constexpr int bound = B;
    Fq<B> c[D];
};

F_HD constexpr int cmax(int a, int b) { return a > b ? a : b; }

// one conditional subtract of C p: below B p -> below max(C, B - C) p
template <class M, int C, int B>
F_DEV Fq<cmax(C, B - C)> csub(const Fq<B>& v)
{
    static_assert(1 <= C && C < B, "a conditional subtract that cannot lower the bound");
    constexpr W24 cp = w24_times(M::p(), C);
    Fq<cmax(C, B - C)> r;
    cond_sub(r.w, v.w, cp.w);
    return r;
}

// v - q p with q = floor(v[23] / (p[23] + 1)), below 2p for any v < 2^768:
// q p <= q (p[23] + 1) 2^736 <= v, and v / p - q < 1 + (2^32 + p[23] + 1) /
// (p[23] (p[23] + 1)) < 1.4 for the top word p[23] = 0x1c4c6 of both moduli.
template <class M, int B>
F_DEV Fq<2> reduce_q(const Fq<B>& v)
{
    constexpr W24 P = M::p();
    static_assert(P.w[NW - 1] >= 0x10000, "the quotient estimate needs a wide top word");
    const u32 q = v.w[NW - 1] / (P.w[NW - 1] + 1);
    u32 t[NW];  // q p, below 2^768
    t[0] = P.w[0] * q;
    t[1] = mad_lo_cc(P.w[1], q, mul_hi(P.w[0], q));
#pragma unroll
    for (int j = 2; j < NW - 1; j++) t[j] = madc_lo_cc(P.w[j], q, mul_hi(P.w[j - 1], q));
    t[NW - 1] = madc_lo(P.w[NW - 1], q, mul_hi(P.w[NW - 2], q));
    Fq<2> r;
    sub_chain(r.w, v.w, t);
    return r;
}

// bring the bound to T or below: one conditional subtract where that
// suffices, else the quotient estimate first
template <class M, int T, int B>
F_DEV auto fit(const Fq<B>& v)
{
    if constexpr (B <= T) return v;
    else if constexpr ((B + 1) / 2 <= T || B <= 2) return fit<M, T>(csub<M, (B + 1) / 2>(v));
    else return fit<M, T>(reduce_q<M>(v));
}

template <int T, int B>
F_DEV Fq<T> widen(const Fq<B>& v)
{
    static_assert(B <= T, "widen only loosens a bound");
    Fq<T> r;
#pragma unroll
    for (int j = 0; j < NW; j++) r.w[j] = v.w[j];
    return r;
}

template <class M, int A, int B>
F_DEV auto add(const Fq<A>& a, const Fq<B>& b)
{
    if constexpr (A + B <= MAXB) {
        Fq<A + B> r;
        add_chain(r.w, a.w, b.w);
        return r;
    } else if constexpr (A >= B) {
        return add<M>(csub<M, (A + 1) / 2>(a), b);
    } else {
        return add<M>(a, csub<M, (B + 1) / 2>(b));
    }
}

// a - b + k p with k = pow2ceil(B), exact because a + k p > b
template <class M, int A, int B>
F_DEV auto sub(const Fq<A>& a, const Fq<B>& b)
{
    constexpr int K = pow2ceil(B);
    if constexpr (A + K <= MAXB) {
        constexpr W24 kp = w24_times(M::p(), K);
        u32 d[NW];
        sub_chain(d, a.w, b.w);
        Fq<A + K> r;  // d + k p modulo 2^768, the non-negative a - b + k p
        add_chain(r.w, d, kp.w);
        return r;
    } else if constexpr (A >= K) {
        return sub<M>(csub<M, (A + 1) / 2>(a), b);
    } else {
        return sub<M>(a, csub<M, (B + 1) / 2>(b));
    }
}

// K x for a small integer K (plain scaling, not a Montgomery product)
template <class M, int K, int B>
F_DEV auto smul(const Fq<B>& x)
{
    static_assert(K >= 1 && K * B < 16384, "K B p must stay below 2^768");
    u32 hi[NW];
#pragma unroll
    for (int j = 0; j < NW - 1; j++) hi[j] = mul_hi(x.w[j], K);
    Fq<K * B> r;
    r.w[0] = x.w[0] * K;
    r.w[1] = mad_lo_cc(x.w[1], K, hi[0]);
#pragma unroll
    for (int j = 2; j < NW - 1; j++) r.w[j] = madc_lo_cc(x.w[j], K, hi[j - 1]);
    r.w[NW - 1] = madc_lo(x.w[NW - 1], K, hi[NW - 2]);
    return fit<M, MAXB>(r);
}

// r = a b, canonical
template <class M, int A, int B>
F_DEV void mul(Fq<1>& r, const Fq<A>& a, const Fq<B>& b)
{
    static_assert(A * B <= MULB, "product operands too loose");
    mont_mul<M>(r.w, a.w, b.w);
}

// r = a c for a canonical constant c in device memory
template <class M, int A>
F_DEV void mul_const(Fq<1>& r, const Fq<A>& a, const u32* c)
{
    static_assert(A <= MULB, "product operand too loose");
    mont_mul<M>(r.w, a.w, c);
}

// ---- componentwise extension-field operations --------------------------
template <class M, int D, int A, int B>
F_DEV auto add(const Fe<D, A>& a, const Fe<D, B>& b)
{
    Fe<D, decltype(add<M>(a.c[0], b.c[0]))::bound> r;
#pragma unroll
    for (int k = 0; k < D; k++) r.c[k] = add<M>(a.c[k], b.c[k]);
    return r;
}

template <class M, int D, int A, int B>
F_DEV auto sub(const Fe<D, A>& a, const Fe<D, B>& b)
{
    Fe<D, decltype(sub<M>(a.c[0], b.c[0]))::bound> r;
#pragma unroll
    for (int k = 0; k < D; k++) r.c[k] = sub<M>(a.c[k], b.c[k]);
    return r;
}

template <class M, int K, int D, int B>
F_DEV auto smul(const Fe<D, B>& x)
{
    Fe<D, decltype(smul<M, K>(x.c[0]))::bound> r;
#pragma unroll
    for (int k = 0; k < D; k++) r.c[k] = smul<M, K>(x.c[k]);
    return r;
}

template <class M, int T, int D, int B>
F_DEV auto fit(const Fe<D, B>& x)
{
    Fe<D, decltype(fit<M, T>(x.c[0]))::bound> r;
#pragma unroll
    for (int k = 0; k < D; k++) r.c[k] = fit<M, T>(x.c[k]);
    return r;
}

// The words of an extension element's components, which an extension
// product reads (a product never looks at an operand's type, only at its
// words; its bound is a template argument of the body).
template <int D>
struct Words {
    const u32* c[D];
};

template <int D, int B>
F_DEV Words<D> words(const Fe<D, B>& x)
{
    Words<D> r;
#pragma unroll
    for (int k = 0; k < D; k++) r.c[k] = x.c[k].w;
    return r;
}

// The product in Fq[u] / (u^D - NR) of operands below A p and B p: D = 2
// Karatsuba (libff fp2.tcc:81-104); D = 3 the six-product schedule of libff
// fp3.tcc.  The Karatsuba sums and the recombination stay lazy.
template <class M, int NR, int A, int B>
F_DEV auto fe_mul_body(const Words<2>& a, const Words<2>& b)
{
    static_assert(2 * A <= MAXB && 2 * B <= MAXB, "Karatsuba sums too loose");
    static_assert(4 * A * B <= MULB, "product operands too loose");
    Fq<1> v0, v1, v2;
    mont_mul<M>(v0.w, a.c[0], b.c[0]);
    mont_mul<M>(v1.w, a.c[1], b.c[1]);
    mont_mul_sums<M>(v2.w, a.c[0], a.c[1], b.c[0], b.c[1]);
    const auto c0 = add<M>(v0, smul<M, NR>(v1));    // v0 + NR v1
    const auto c1 = sub<M>(v2, add<M>(v0, v1));     // v2 - v0 - v1
    constexpr int RB = cmax(decltype(c0)::bound, decltype(c1)::bound);
    Fe<2, RB> r;
    r.c[0] = widen<RB>(c0);
    r.c[1] = widen<RB>(c1);
    return r;
}

template <class M, int NR, int A, int B>
F_DEV auto fe_mul_body(const Words<3>& a, const Words<3>& b)
{
    static_assert(2 * A <= MAXB && 2 * B <= MAXB, "Karatsuba sums too loose");
    static_assert(4 * A * B <= MULB, "product operands too loose");
    Fq<1> v0, v1, v2, t01, t02, t12;
    mont_mul<M>(v0.w, a.c[0], b.c[0]);
    mont_mul<M>(v1.w, a.c[1], b.c[1]);
    mont_mul<M>(v2.w, a.c[2], b.c[2]);
    mont_mul_sums<M>(t01.w, a.c[0], a.c[1], b.c[0], b.c[1]);
    mont_mul_sums<M>(t02.w, a.c[0], a.c[2], b.c[0], b.c[2]);
    mont_mul_sums<M>(t12.w, a.c[1], a.c[2], b.c[1], b.c[2]);
    const auto c0 = add<M>(v0, smul<M, NR>(sub<M>(t12, add<M>(v1, v2))));  // v0 + NR (t12 - v1 - v2)
    const auto c1 = add<M>(sub<M>(t01, add<M>(v0, v1)), smul<M, NR>(v2));  // t01 - v0 - v1 + NR v2
    const auto c2 = add<M>(sub<M>(t02, add<M>(v0, v2)), v1);               // t02 - v0 - v2 + v1
    constexpr int RB = cmax(decltype(c0)::bound, cmax(decltype(c1)::bound, decltype(c2)::bound));
    Fe<3, RB> r;
    r.c[0] = widen<RB>(c0);
    r.c[1] = widen<RB>(c1);
    r.c[2] = widen<RB>(c2);
    return r;
}

// An extension product is one call too, with its operands below EXTB p,
// so that its Karatsuba sums need no reduction: 12 call sites of one body
// instead of 12 inlined copies.
constexpr int EXTB = MAXB / 2;

template <class M, int NR, int D>
using ExtProduct = decltype(fe_mul_body<M, NR, EXTB, EXTB>(std::declval<const Words<D>&>(),
                                                            std::declval<const Words<D>&>()));

template <class M, int NR, int D>
F_NOINLINE void fe_mul_call(ExtProduct<M, NR, D>& r, const Words<D> a, const Words<D> b)
{
    r = fe_mul_body<M, NR, EXTB, EXTB>(a, b);
}

template <class M, int NR, int D, int A, int B>
F_DEV auto fe_mul(const Fe<D, A>& a, const Fe<D, B>& b)
{
    if constexpr (D == 1) {
        Fe<1, 1> r;
        mul<M>(r.c[0], a.c[0], b.c[0]);
        return r;
    } else if constexpr (A > EXTB || B > EXTB) {
        return fe_mul<M, NR>(fit<M, EXTB>(a), fit<M, EXTB>(b));
    } else {
        ExtProduct<M, NR, D> r;
        fe_mul_call<M, NR, D>(r, words(a), words(b));
        return r;
    }
}

// x * K u^S for a small integer K: component i is K x[i - S] for i >= S and
// (K NR) x[i - S + D] for i < S
template <class M, int NR, int K, int S, int D, int B>
F_DEV auto mul_monomial_small(const Fe<D, B>& x)
{
    static_assert(0 <= S && S < D, "monomial degree");
    constexpr int BL = decltype(smul<M, K>(x.c[0]))::bound;
    constexpr int BH = S > 0 ? decltype(smul<M, K * NR>(x.c[0]))::bound : 1;
    constexpr int RB = cmax(BL, BH);
    Fe<D, RB> r;
#pragma unroll
    for (int i = S; i < D; i++) r.c[i] = widen<RB>(smul<M, K>(x.c[i - S]));
    if constexpr (S > 0) {
#pragma unroll
        for (int i = 0; i < S; i++) r.c[i] = widen<RB>(smul<M, K * NR>(x.c[i - S + D]));
    }
    return r;
}

// x * c u^S for a constant c in device memory: c and NR c are given
// (canonical, Montgomery form); one base product a component
template <class M, int S, int D, int B>
F_DEV Fe<D, 1> mul_monomial_const(const Fe<D, B>& x, const u32* c, const u32* nr_c)
{
    static_assert(0 <= S && S < D, "monomial degree");
    Fe<D, 1> r;
#pragma unroll
    for (int i = S; i < D; i++) mul_const<M>(r.c[i], x.c[i - S], c);
#pragma unroll
    for (int i = 0; i < S; i++) mul_const<M>(r.c[i], x.c[i - S + D], nr_c);
    return r;
}

// element idx of a (D * 24, n) word-row array; the stores reduce fully
template <int D>
F_DEV void fe_load(Fe<D, 1>& r, const u32* __restrict__ src, long n, long idx)
{
#pragma unroll
    for (int k = 0; k < D; k++)
#pragma unroll
        for (int j = 0; j < NW; j++) r.c[k].w[j] = src[(long)(k * NW + j) * n + idx];
}

template <class M, int D, int B>
F_DEV void fe_store(u32* __restrict__ dst, const Fe<D, B>& a, long n, long idx)
{
    const Fe<D, 1> v = fit<M, 1>(a);
#pragma unroll
    for (int k = 0; k < D; k++)
#pragma unroll
        for (int j = 0; j < NW; j++) dst[(long)(k * NW + j) * n + idx] = v.c[k].w[j];
}

}  // namespace f753
