// 753-bit prime-field arithmetic for one GPU thread: 24 little-endian
// 32-bit words per element, Montgomery radix R = 2^768 (the challenge
// wire format's R, so no conversion at the file boundary).
//
// Every kernel receives one block of constants in device memory (u32):
//   [0..23]   the modulus p
//   [24]      n0 = -p^{-1} mod 2^32
//   [25..31]  unused
//   [32.. )   curve constants for the group kernels: a (DEG*24 words),
//             then 3b and, for DEG > 1, NR * 3b (DEG*24 words each),
//             Montgomery form
// so the same code serves both 753-bit moduli (Fr and Fq) and any curve.
//
// The Montgomery product is CIOS (coarsely integrated operand scanning,
// the form of cuda-fixnum's modnum_monty_cios.cu): 24 rounds, each one
// row of a*b[i] accumulated into a 26-word running value followed by one
// row of m*p that cancels the lowest word.  It is written with 64-bit
// multiply-adds in C; the compiler lowers them to IMAD.WIDE chains.
//
// This is the arithmetic of mont_mul.cu and ec_dbl.cu; ec_add.cu runs on
// fp753_fast.cuh.
//
// fp_mul / fp_add / fp_sub are __noinline__ on purpose: the group-law
// kernels hold 12 (Fq) to 72 (Fq3) products each, and fully inlined the
// unrolled code runs to tens of thousands of instructions and minutes of
// nvcc.  Operands then live in the thread's local memory (the stack) and
// each call loads them into registers, works there, and stores the
// result: 72 local words moved per ~1200 wide multiply-adds.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

typedef uint32_t u32;
typedef uint64_t u64;

#define NW 24
#define C_P 0
#define C_N0 24
#define C_CURVE 32

// t (< 2p, 24 words) -> r = t mod p.  r may alias nothing live in t.
static __device__ __forceinline__ void fp_cond_sub(u32* r, const u32* t, const u32* p)
{
    u32 d[NW];
    u32 borrow = 0;
#pragma unroll
    for (int j = 0; j < NW; j++) {
        u64 s = (u64)t[j] - p[j] - borrow;
        d[j] = (u32)s;
        borrow = (u32)(s >> 63);
    }
#pragma unroll
    for (int j = 0; j < NW; j++) r[j] = borrow ? t[j] : d[j];
}

// r = a * b * 2^-768 mod p, canonical, for canonical a, b.  With
// UNROLL == 24 the rounds are fully unrolled and every operand stays in
// registers (the stand-alone product); with UNROLL == 1 the 24 rounds
// are a loop that indexes b in local memory (the copy inside fp_mul,
// which keeps the group-law kernels' code small).
template <int UNROLL>
static __device__ __forceinline__ void fp_mul_core(u32* r, const u32* a, const u32* b,
                                                   const u32* __restrict__ cst)
{
    u32 p[NW], x[NW], t[NW + 2];
#pragma unroll
    for (int j = 0; j < NW; j++) {
        p[j] = __ldg(cst + C_P + j);
        x[j] = a[j];
    }
    const u32 n0 = __ldg(cst + C_N0);
#pragma unroll
    for (int j = 0; j < NW + 2; j++) t[j] = 0;
#pragma unroll UNROLL
    for (int i = 0; i < NW; i++) {
        const u32 bi = b[i];
        u64 c = 0;
#pragma unroll
        for (int j = 0; j < NW; j++) {
            u64 uv = (u64)x[j] * bi + t[j] + c;   // <= 2^64 - 1
            t[j] = (u32)uv;
            c = uv >> 32;
        }
        u64 uv = (u64)t[NW] + c;
        t[NW] = (u32)uv;
        t[NW + 1] = (u32)(uv >> 32);
        const u32 m = t[0] * n0;
        uv = (u64)m * p[0] + t[0];                // low word becomes 0
        c = uv >> 32;
#pragma unroll
        for (int j = 1; j < NW; j++) {
            uv = (u64)m * p[j] + t[j] + c;
            t[j - 1] = (u32)uv;
            c = uv >> 32;
        }
        uv = (u64)t[NW] + c;
        t[NW - 1] = (u32)uv;
        t[NW] = t[NW + 1] + (u32)(uv >> 32);
    }
    // the running value is < 2p < 2^754, so t[24] == 0 here
    fp_cond_sub(r, t, p);
}

static __device__ __noinline__ void fp_mul(u32* r, const u32* a, const u32* b, const u32* cst)
{
    u32 bb[NW], out[NW];
#pragma unroll
    for (int j = 0; j < NW; j++) bb[j] = b[j];
    fp_mul_core<1>(out, a, bb, cst);
#pragma unroll
    for (int j = 0; j < NW; j++) r[j] = out[j];
}

// r = a + b mod p (canonical in, canonical out; r may alias a or b)
static __device__ __noinline__ void fp_add(u32* r, const u32* a, const u32* b, const u32* cst)
{
    u32 p[NW], s[NW];
    u32 c = 0;
#pragma unroll
    for (int j = 0; j < NW; j++) {
        p[j] = __ldg(cst + C_P + j);
        u64 uv = (u64)a[j] + b[j] + c;
        s[j] = (u32)uv;
        c = (u32)(uv >> 32);
    }
    // a + b < 2p < 2^754: no carry out of word 23
    u32 out[NW];
    fp_cond_sub(out, s, p);
#pragma unroll
    for (int j = 0; j < NW; j++) r[j] = out[j];
}

// r = a - b mod p (canonical in, canonical out; r may alias a or b)
static __device__ __noinline__ void fp_sub(u32* r, const u32* a, const u32* b, const u32* cst)
{
    u32 d[NW];
    u32 borrow = 0;
#pragma unroll
    for (int j = 0; j < NW; j++) {
        u64 s = (u64)a[j] - b[j] - borrow;
        d[j] = (u32)s;
        borrow = (u32)(s >> 63);
    }
    const u32 mask = 0u - borrow;   // add p back where a < b
    u32 c = 0;
#pragma unroll
    for (int j = 0; j < NW; j++) {
        u64 uv = (u64)d[j] + (__ldg(cst + C_P + j) & mask) + c;
        r[j] = (u32)uv;
        c = (u32)(uv >> 32);
    }
}

static __device__ __forceinline__ bool fp_is_zero(const u32* a)
{
    u32 acc = 0;
#pragma unroll
    for (int j = 0; j < NW; j++) acc |= a[j];
    return acc == 0;
}

// r = K * a mod p for a small compile-time K >= 1 (plain scaling, not a
// Montgomery product): binary double-and-add, most significant bit first.
template <int K>
static __device__ __forceinline__ void fp_mul_small(u32* r, const u32* a, const u32* cst)
{
    static_assert(K >= 1 && K < 65536, "small multiplier");
    int top = 0;
    while ((K >> (top + 1)) != 0) top++;
    u32 acc[NW];
#pragma unroll
    for (int j = 0; j < NW; j++) acc[j] = a[j];
    for (int bit = top - 1; bit >= 0; bit--) {
        fp_add(acc, acc, acc, cst);
        if ((K >> bit) & 1) fp_add(acc, acc, a, cst);
    }
#pragma unroll
    for (int j = 0; j < NW; j++) r[j] = acc[j];
}

// ---------------------------------------------------------------------
// Coordinate-field elements: DEG components of 24 words.  DEG == 1 is the
// base field; DEG == 2 is Fp[u]/(u^2 - NR) with Karatsuba multiplication
// (libff fp2.tcc:81-104); DEG == 3 is Fp[u]/(u^3 - NR) with the
// six-product schedule of libff fp3.tcc.  Every result is canonical, so
// any exact schedule gives the same words as the formulas of the reference.
// ---------------------------------------------------------------------
template <int DEG>
struct Fe {
    u32 c[DEG][NW];
};

template <int DEG>
static __device__ __forceinline__ void fe_add(Fe<DEG>& r, const Fe<DEG>& a, const Fe<DEG>& b,
                                              const u32* cst)
{
#pragma unroll
    for (int k = 0; k < DEG; k++) fp_add(r.c[k], a.c[k], b.c[k], cst);
}

template <int DEG>
static __device__ __forceinline__ void fe_sub(Fe<DEG>& r, const Fe<DEG>& a, const Fe<DEG>& b,
                                              const u32* cst)
{
#pragma unroll
    for (int k = 0; k < DEG; k++) fp_sub(r.c[k], a.c[k], b.c[k], cst);
}

template <int DEG>
static __device__ __forceinline__ bool fe_is_zero(const Fe<DEG>& a)
{
    bool z = true;
#pragma unroll
    for (int k = 0; k < DEG; k++) z = z && fp_is_zero(a.c[k]);
    return z;
}

// r may alias a or b in every overload
template <int NR>
static __device__ __forceinline__ void fe_mul(Fe<1>& r, const Fe<1>& a, const Fe<1>& b,
                                              const u32* cst)
{
    fp_mul(r.c[0], a.c[0], b.c[0], cst);
}

template <int NR>
static __device__ __noinline__ void fe_mul(Fe<2>& r, const Fe<2>& a, const Fe<2>& b,
                                           const u32* cst)
{
    u32 v0[NW], v1[NW], s[NW], t[NW];
    fp_mul(v0, a.c[0], b.c[0], cst);
    fp_mul(v1, a.c[1], b.c[1], cst);
    fp_add(s, a.c[0], a.c[1], cst);
    fp_add(t, b.c[0], b.c[1], cst);
    fp_mul(t, s, t, cst);            // (a0 + a1)(b0 + b1); a, b not read below
    fp_sub(t, t, v0, cst);
    fp_sub(r.c[1], t, v1, cst);      // c1 = t - v0 - v1
    fp_mul_small<NR>(v1, v1, cst);
    fp_add(r.c[0], v0, v1, cst);     // c0 = v0 + NR * v1
}

// All six base products go to locals before any word of r is written.
template <int NR>
static __device__ __noinline__ void fe_mul(Fe<3>& r, const Fe<3>& a, const Fe<3>& b,
                                           const u32* cst)
{
    u32 v0[NW], v1[NW], v2[NW], t01[NW], t02[NW], t12[NW], s[NW], t[NW];
    fp_mul(v0, a.c[0], b.c[0], cst);
    fp_mul(v1, a.c[1], b.c[1], cst);
    fp_mul(v2, a.c[2], b.c[2], cst);
    fp_add(s, a.c[0], a.c[1], cst);
    fp_add(t, b.c[0], b.c[1], cst);
    fp_mul(t01, s, t, cst);          // (a0 + a1)(b0 + b1)
    fp_add(s, a.c[0], a.c[2], cst);
    fp_add(t, b.c[0], b.c[2], cst);
    fp_mul(t02, s, t, cst);          // (a0 + a2)(b0 + b2)
    fp_add(s, a.c[1], a.c[2], cst);
    fp_add(t, b.c[1], b.c[2], cst);
    fp_mul(t12, s, t, cst);          // (a1 + a2)(b1 + b2); a, b not read below
    fp_sub(t12, t12, v1, cst);
    fp_sub(t12, t12, v2, cst);
    fp_mul_small<NR>(t12, t12, cst);
    fp_add(r.c[0], v0, t12, cst);    // c0 = v0 + NR (t12 - v1 - v2)
    fp_sub(t01, t01, v0, cst);
    fp_sub(t01, t01, v1, cst);
    fp_mul_small<NR>(s, v2, cst);
    fp_add(r.c[1], t01, s, cst);     // c1 = t01 - v0 - v1 + NR v2
    fp_sub(t02, t02, v0, cst);
    fp_sub(t02, t02, v2, cst);
    fp_add(r.c[2], t02, v1, cst);    // c2 = t02 - v0 - v2 + v1
}

// element idx of a (DEG*24, n) row-major array <-> registers/local
template <int DEG>
static __device__ __forceinline__ void fe_load(Fe<DEG>& r, const u32* __restrict__ src, long n,
                                               long idx)
{
#pragma unroll
    for (int k = 0; k < DEG; k++)
#pragma unroll
        for (int j = 0; j < NW; j++) r.c[k][j] = src[(long)(k * NW + j) * n + idx];
}

template <int DEG>
static __device__ __forceinline__ void fe_store(u32* __restrict__ dst, const Fe<DEG>& a, long n,
                                                long idx)
{
#pragma unroll
    for (int k = 0; k < DEG; k++)
#pragma unroll
        for (int j = 0; j < NW; j++) dst[(long)(k * NW + j) * n + idx] = a.c[k][j];
}

// curve constant number `which` (0: a, 1: 3b) from the constants block
template <int DEG>
static __device__ __forceinline__ void fe_load_const(Fe<DEG>& r, const u32* __restrict__ cst,
                                                     int which)
{
#pragma unroll
    for (int k = 0; k < DEG; k++)
#pragma unroll
        for (int j = 0; j < NW; j++)
            r.c[k][j] = __ldg(cst + C_CURVE + (which * DEG + k) * NW + j);
}
