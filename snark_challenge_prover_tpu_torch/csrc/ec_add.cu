// K2: complete projective point addition, one thread per point pair.
//
// Replaces the TPU kernel built by ops/pallas_group.py
// (_build_pallas(curve, "add"), body _apply_formula -> _rcb_add): the
// Renes-Costello-Batina complete addition (2015, Alg. 1), there over lazy
// fields with REDC's constant convolutions on the matrix unit.
//
// Bound on this card: operations.  With the curves' own constants an
// addition needs 14 Montgomery products over Fq, 40 over Fq2 and 78 over
// Fq3 (12 extension products, none for a, two monomials for 3b), each
// 2 * 2 * 24^2 + 24 = 2328 32-bit multiply-adds, against 9, 18 or 27
// values of 96 bytes moved.  What holds it below that bound is not the
// multiply-adds but their surroundings: every product's operands pass
// through local memory, and over Fq2 and Fq3 the kernel takes all 255
// registers, so an SM runs 8 warps (PERF.md).
//
// Design (fp753_fast.cuh): the product is one __noinline__ function per
// modulus whose body keeps a, b and the accumulators in registers and runs
// each row as a PTX carry chain against the modulus as immediates (a
// second form takes the Karatsuba sums' four addends); every other
// operation is inline and lazy, with its bound in its type, and only the
// three stores reduce fully.  Each instantiation is one curve group,
// with a = A_K u^A_S (a small integer: doublings and additions, no
// product) and 3b = c u^B3_S (one base product a component, with c and
// NR c from the constants block).  Coordinates are (D * 24, n), word axis
// first, so a warp's loads of one word row are consecutive; a ragged n is
// masked.  The launchers are CUDA only; the rest also builds for the host
// (g++, with __global__ and __launch_bounds__ defined away), which is how
// the CPU tests run this source against the plain version.
#include "fp753_fast.cuh"

using namespace f753;

// constants block (u32 words): [0, 32) the base field's, then a, 3b and,
// for D > 1, NR * 3b, D * 24 words each, Montgomery form
constexpr int C_CURVE = 32;

// Over Fq the kernel fits 168 registers without much spilling and runs
// faster with three blocks an SM; over Fq2 and Fq3, capping the registers
// below 255 spills more than the extra warps win back.
template <class M, int D, int NR, int A_K, int A_S, int B3_S>
__global__ void __launch_bounds__(128, D == 1 ? 3 : 1)
ec_add_kernel(const u32* __restrict__ x1, const u32* __restrict__ y1, const u32* __restrict__ z1,
              const u32* __restrict__ x2, const u32* __restrict__ y2, const u32* __restrict__ z2,
              u32* __restrict__ x3, u32* __restrict__ y3, u32* __restrict__ z3,
              long n, const u32* __restrict__ cst)
{
    const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= n) return;
    const u32* c = cst + C_CURVE + (D + B3_S) * NW;
    const u32* nr_c = D > 1 ? cst + C_CURVE + (2 * D + B3_S) * NW : c;
    auto mul_a = [](const auto& x) { return mul_monomial_small<M, NR, A_K, A_S>(x); };
    auto mul_b3 = [&](const auto& x) { return mul_monomial_const<M, B3_S>(x, c, nr_c); };
    auto mul = [](const auto& x, const auto& y) { return fe_mul<M, NR>(x, y); };

    Fe<D, 1> X1, Y1, Z1, X2, Y2, Z2;
    fe_load(X1, x1, n, idx); fe_load(Y1, y1, n, idx); fe_load(Z1, z1, n, idx);
    fe_load(X2, x2, n, idx); fe_load(Y2, y2, n, idx); fe_load(Z2, z2, n, idx);

    const auto t0 = mul(X1, X2);
    const auto t1 = mul(Y1, Y2);
    const auto t2 = mul(Z1, Z2);
    const auto t3 = sub<M>(mul(add<M>(X1, Y1), add<M>(X2, Y2)), add<M>(t0, t1));
    const auto t4 = sub<M>(mul(add<M>(X1, Z1), add<M>(X2, Z2)), add<M>(t0, t2));
    const auto t5 = sub<M>(mul(add<M>(Y1, Z1), add<M>(Y2, Z2)), add<M>(t1, t2));
    const auto z = add<M>(mul_b3(t2), mul_a(t4));           // 3b t2 + a t4
    const auto xm = sub<M>(t1, z);                          // t1 - z
    const auto zm = add<M>(t1, z);                          // t1 + z
    const auto t2a = mul_a(t2);
    const auto u = add<M>(smul<M, 3>(t0), t2a);             // 3 t0 + a t2
    const auto v = add<M>(mul_b3(t4), mul_a(sub<M>(t0, t2a)));  // 3b t4 + a (t0 - a t2)
    fe_store<M>(x3, sub<M>(mul(t3, xm), mul(t5, v)), n, idx);
    fe_store<M>(y3, add<M>(mul(xm, zm), mul(u, v)), n, idx);
    fe_store<M>(z3, add<M>(mul(t5, zm), mul(t3, u)), n, idx);
}

// One instantiation per curve group: (launcher, modulus, D, NR, A_K, A_S, B3_S)
// with a = A_K u^A_S and 3b = c u^B3_S.  MNT4753 G1: a = 2.  MNT4753 G2 over
// Fq2 = Fq[u]/(u^2 - 13): a = 26, 3b = (0, c).  MNT6753 G1: a = 11.  MNT6753
// G2 over Fq3 = Fq[u]/(u^3 - 11): a = 11 u^2, 3b = (c, 0, 0).
#define EC_ADD_INSTANTIATIONS(X)                          \
    X(ec_add_fp_mnt4753, ModMnt4753, 1, 1, 2, 0, 0)      \
    X(ec_add_fp2_mnt4753, ModMnt4753, 2, 13, 26, 0, 1)   \
    X(ec_add_fp_mnt6753, ModMnt6753, 1, 1, 11, 0, 0)     \
    X(ec_add_fp3_mnt6753, ModMnt6753, 3, 11, 11, 2, 0)

#ifdef __CUDACC__
template <class M, int D, int NR, int A_K, int A_S, int B3_S>
static int launch(const void* x1, const void* y1, const void* z1, const void* x2, const void* y2,
                  const void* z2, void* x3, void* y3, void* z3, long n, const void* cst,
                  void* stream)
{
    const int threads = 128;
    const long blocks = (n + threads - 1) / threads;
    ec_add_kernel<M, D, NR, A_K, A_S, B3_S><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const u32*)x1, (const u32*)y1, (const u32*)z1, (const u32*)x2, (const u32*)y2,
        (const u32*)z2, (u32*)x3, (u32*)y3, (u32*)z3, n, (const u32*)cst);
    return (int)cudaGetLastError();
}

#define EC_ADD_LAUNCHER(name, ...)                                                               \
    extern "C" int name##_launch(const void* x1, const void* y1, const void* z1, const void* x2, \
                                 const void* y2, const void* z2, void* x3, void* y3, void* z3,   \
                                 long n, const void* cst, void* stream)                          \
    {                                                                                            \
        return launch<__VA_ARGS__>(x1, y1, z1, x2, y2, z2, x3, y3, z3, n, cst, stream);          \
    }

EC_ADD_INSTANTIATIONS(EC_ADD_LAUNCHER)
#endif
