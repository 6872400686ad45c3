// 753-bit prime-field arithmetic for one GPU thread: 24 little-endian
// 32-bit words per element, Montgomery radix R = 2^768 (the challenge
// wire format's R, so no conversion at the file boundary).  This is the
// arithmetic of mont_mul.cu; the group-law kernels run on fp753_fast.cuh.
//
// The kernel receives one block of constants in device memory (u32):
//   [0..23]   the modulus p
//   [24]      n0 = -p^{-1} mod 2^32
//   [25..31]  unused
// so the same code serves both 753-bit moduli (Fr and Fq).  A curve's
// block (ops/group.py) appends its constants from word 32; ec_add.cu
// reads them there.
//
// The Montgomery product is CIOS (coarsely integrated operand scanning,
// the form of cuda-fixnum's modnum_monty_cios.cu): 24 rounds, each one
// row of a*b[i] accumulated into a 26-word running value followed by one
// row of m*p that cancels the lowest word.  It is written with 64-bit
// multiply-adds in C; the compiler lowers them to IMAD.WIDE chains.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

typedef uint32_t u32;
typedef uint64_t u64;

#define NW 24
#define C_P 0
#define C_N0 24

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

// r = a * b * 2^-768 mod p, canonical, for canonical a, b.  The rounds
// are fully unrolled (UNROLL == NW) and every operand stays in registers.
template <int UNROLL>
static __device__ __forceinline__ void fp_mul_core(u32* r, const u32* a, const u32* b,
                                                   const u32* __restrict__ cst)
{
    static_assert(UNROLL == NW, "the rounds are unrolled in full");
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
