// K3: projective point doubling (dbl-2007-bl), k doublings in one launch:
// the result is 2^k P.  A point whose X and Z are zero (the identity) is
// kept at every doubling.
//
// Replaces the TPU kernel built by ops/pallas_group.py
// (_build_pallas(curve, "dbl"), body _apply_formula -> _dbl_2007_bl with
// the identity mask), which doubles once a launch.
//
// Bound on this card: operations.  With the curves' small a (a ZZ is
// additions, no product) a doubling makes 11 extension products: 11
// Montgomery products over Fq, 33 over Fq2, 66 over Fq3, each 2 * 2 * 24^2
// + 24 = 2328 32-bit multiply-adds, against 6, 12 or 18 values of 96 bytes
// moved whatever k is.  The main path, though, doubles few points: the
// MSM's Horner step doubles M = 4 points (G1) or 1 (G2), c times a window.
// There the time is the latency of one point's chain of products.
//
// So one warp doubles one point, on the core of fp753_fast.cuh (lazy
// values with their bound in the type; a ZZ by mul_monomial_small): the
// 11 products fall into 4 dependency levels (XX, ZZ, Y1 Z1 | s^2, Y1 s,
// w^2 | s ss, R^2, (X1 + R)^2 | h s, w (B - h)).  At each level each thread
// of the warp makes one base product (3 / 3 / 3 / 2 over Fq, 9 / 9 / 9 / 6
// over Fq2, 18 / 18 / 18 / 12 over Fq3, Karatsuba for the extensions);
// then one thread a component recombines them and takes the level's lazy
// linear steps, in one code path for every component (which slots a
// component reads is data), so that these threads too run together (three
// paths one after another made the Fq3 doubling 1.7x slower on an H100).
// The point and every intermediate lie in the block's shared memory, each
// slot with a bound fixed at compile time, and stay there for the k
// doublings.  A doubling's critical path is 4 products instead of 11 / 33
// / 66.  Every product goes through the one call site of mont_mul_sums (a
// plain product adds a zero), so that the threads of a level run it
// together.
// Between two doublings the point is reduced to canonical words, on which
// the identity test is exact; a lane with Y = 0 becomes (0, -w^3, 0), which
// every later doubling keeps.  Coordinates are (D * 24, n), word axis first.
// The launchers are CUDA only; the rest also builds for the host (g++, with
// the CUDA keywords defined away and a warp's threads run one after
// another, stage by stage), which is how the CPU tests run this source
// against the plain version.
#include "fp753_fast.cuh"

using namespace f753;

// a curve group's doubling: modulus, degree, non-residue and a = A_K u^A_S
template <class M_, int D_, int NR_, int A_K_, int A_S_>
struct DblCurve {
    using M = M_;
    static constexpr int D = D_, NR = NR_, A_K = A_K_, A_S = A_S_;
    static constexpr int K = D == 1 ? 1 : D == 2 ? 3 : 6;  // base products of an extension product
};

template <int D>
F_DEV bool fe_is_zero(const Fe<D, 1>& x)
{
    u32 acc = 0;
#pragma unroll
    for (int k = 0; k < D; k++)
#pragma unroll
        for (int j = 0; j < NW; j++) acc |= x.c[k].w[j];
    return acc == 0;
}

constexpr int WARP = 32;
constexpr int DBL_STAGES = 8;  // product level, recombination, four times

// Component I of an extension product from its K base products v: v[j] =
// a[j] b[j] for j < D, then (a0 + a1)(b0 + b1) and, over Fq3, (a0 + a2)(b0 +
// b2), (a1 + a2)(b1 + b2).  fe_mul_body's recombination in one form for every
// component, c_I = (v[p] - v[q] - v[r]) + m (v[s] - v[t] - v[u]) with m = NR
// (1 for component 2 of Fq3), the indices chosen by I and -1 standing for
// zero, so that the threads of the components run the same instructions.
template <class C>
F_DEV auto ext_component(const Fq<1>* v, const Fq<1>& zero, int I)
{
    using M = typename C::M;
    if constexpr (C::D == 1) {
        return v[0];
    } else {
        const bool d3 = C::D == 3;
        const int p = I == 0 ? 0 : d3 ? I + 2 : 2, q = I == 0 ? -1 : 0, r = I == 0 ? -1 : I;
        const int s = I == 0 ? (d3 ? 5 : 1) : d3 ? 3 - I : -1;
        const int t = I == 0 && d3 ? 1 : -1, u = I == 0 && d3 ? 2 : -1;
        auto at = [&](int i) -> const Fq<1>& { return i < 0 ? zero : v[i]; };
        const auto x = sub<M>(at(p), add<M>(at(q), at(r)));
        const auto y = sub<M>(at(s), add<M>(at(t), at(u)));
        const auto y_nr = smul<M, C::NR>(y);
        constexpr int YB = decltype(y_nr)::bound;
        const Fq<YB> m_y = !d3 || I < 2 ? y_nr : widen<YB>(y);
        return add<M>(x, m_y);
    }
}

template <class C>
using ExtComponent = decltype(ext_component<C>(static_cast<const Fq<1>*>(nullptr), Fq<1>{}, 0));

// the level's lazy linear steps, as functions so that the slots can take
// their types: s = 2 Y1 Z1; component I of w = a ZZ + 3 XX, with a = A_K u^A_S
// taking ZZ's component I - A_S (times NR below A_S); XR = X1 + R; B = XR^2
// - XX - RR; h = w^2 - 2 B; B - h.  A value that is a product's operand is
// fitted below EXTB p, so that its Karatsuba sums need no reduction.
template <class C, int B>
F_DEV auto dbl_s(const Fq<B>& yz)
{
    return fit<typename C::M, EXTB>(smul<typename C::M, 2>(yz));
}

template <class C, int B>
F_DEV auto dbl_w(const Fq<B>& zz, const Fq<B>& xx, int I)
{
    using M = typename C::M;
    const auto a_hi = smul<M, C::A_K>(zz);  // components I >= A_S
    if constexpr (C::A_S == 0) {
        return fit<M, EXTB>(add<M>(a_hi, smul<M, 3>(xx)));
    } else {
        const auto a_lo = smul<M, C::A_K * C::NR>(zz);
        constexpr int AB = cmax(decltype(a_lo)::bound, decltype(a_hi)::bound);
        const Fq<AB> a_zz = I < C::A_S ? widen<AB>(a_lo) : widen<AB>(a_hi);
        return fit<M, EXTB>(add<M>(a_zz, smul<M, 3>(xx)));
    }
}

template <class C, int B1, int B2>
F_DEV auto dbl_xr(const Fq<B1>& x, const Fq<B2>& r)
{
    return fit<typename C::M, EXTB>(add<typename C::M>(x, r));
}

template <class C, int B>
F_DEV auto dbl_b(const Fq<B>& xr2, const Fq<B>& xx, const Fq<B>& rr)
{
    return sub<typename C::M>(sub<typename C::M>(xr2, xx), rr);
}

template <class C, int B1, int B2>
F_DEV auto dbl_h(const Fq<B1>& ww, const Fq<B2>& b)
{
    using M = typename C::M;
    return fit<M, EXTB>(sub<M>(ww, smul<M, 2>(b)));
}

template <class C, int B1, int B2>
F_DEV auto dbl_bmh(const Fq<B1>& b, const Fq<B2>& h)
{
    return fit<typename C::M, EXTB>(sub<typename C::M>(b, h));
}

// a point's shared memory: the point, one level's base products and the
// intermediates, each with its bound
template <class C>
struct DblSlots {
    static constexpr int D = C::D;
    using P = ExtComponent<C>;  // a recombined component
    using O = decltype(fit<typename C::M, EXTB>(P{}));
    using S = decltype(dbl_s<C>(P{}));
    using WT = decltype(dbl_w<C>(P{}, P{}, 0));
    using XRT = decltype(dbl_xr<C>(Fq<1>{}, O{}));
    using BT = decltype(dbl_b<C>(P{}, P{}, P{}));
    using HT = decltype(dbl_h<C>(P{}, BT{}));
    using BHT = decltype(dbl_bmh<C>(BT{}, HT{}));

    Fe<D, 1> X, Y, Z;          // the point, canonical
    Fq<1> zero;                // the second addend of a base product that is no sum
    Fq<1> prod[3 * C::K];      // one level's base products
    Fe<D, P::bound> XX, ww, sss, RR;
    Fe<D, S::bound> s;
    Fe<D, WT::bound> w;
    Fe<D, O::bound> ss, R;
    Fe<D, XRT::bound> XR;
    Fe<D, HT::bound> h;
    Fe<D, BHT::bound> bmh;
    int ident;                 // the point is the identity, which this doubling keeps
};

// the two addends of one factor of base product j (the second is zero for j < D)
struct Addends {
    const u32* lo;
    const u32* hi;
};

template <int D, int B>
F_DEV Addends addends(const Fe<D, B>& x, int j, const u32* zero)
{
    const int p = j < D ? j : (D == 3 && j == 5 ? 1 : 0);
    const int q = D == 1 ? 0 : D == 2 ? 1 : (j == 3 ? 1 : 2);
    return Addends{x.c[p].w, j < D ? zero : x.c[q].w};
}

template <int D, class A, class B>
constexpr bool base_product_fits = (D == 1 ? A::bound * B::bound : 4 * A::bound * B::bound) <= MULB &&
                                   2 * A::bound <= MAXB && 2 * B::bound <= MAXB;

// A product level: thread t makes base product t % K of extension product
// t / K, of the E products a0 b0, a1 b1, a2 b2.
template <class C, int E, class A0, class B0, class A1, class B1, class A2, class B2>
F_DEV void level_products(DblSlots<C>& sh, int t, const A0& a0, const B0& b0, const A1& a1,
                          const B1& b1, const A2& a2, const B2& b2)
{
    constexpr int D = C::D;
    static_assert(base_product_fits<D, A0, B0> && base_product_fits<D, A1, B1> &&
                  base_product_fits<D, A2, B2>, "product operands too loose");
    if (t >= E * C::K) return;
    const int e = t / C::K, j = t % C::K;
    const u32* z = sh.zero.w;
    const Addends x = e == 0 ? addends(a0, j, z) : e == 1 ? addends(a1, j, z) : addends(a2, j, z);
    const Addends y = e == 0 ? addends(b0, j, z) : e == 1 ? addends(b1, j, z) : addends(b2, j, z);
    mont_mul_sums<typename C::M>(sh.prod[t].w, x.lo, x.hi, y.lo, y.hi);
}

// A recombination stage (1, 3, 5 or 7) for component I: the extension
// products of the level before it and the linear steps that follow them.
// The components' threads run it together: what differs between them is
// data (which slots), not code.
template <class C, int STAGE>
F_DEV void combine(DblSlots<C>& sh, int I)
{
    using M = typename C::M;
    constexpr int K = C::K;
    const Fq<1>* v = sh.prod;
    auto ext = [&](int e, int i) { return ext_component<C>(v + e * K, sh.zero, i); };
    if constexpr (STAGE == 1) {  // XX, ZZ, Y1 Z1 -> s, w
        const auto xx = ext(0, I);
        const auto zz = ext(1, (I + C::D - C::A_S) % C::D);  // the component a takes
        sh.XX.c[I] = xx;
        sh.s.c[I] = dbl_s<C>(ext(2, I));
        sh.w.c[I] = dbl_w<C>(zz, xx, I);
    } else if constexpr (STAGE == 3) {  // s^2, R = Y1 s, w^2 -> XR
        sh.ss.c[I] = fit<M, EXTB>(ext(0, I));
        sh.R.c[I] = fit<M, EXTB>(ext(1, I));
        sh.ww.c[I] = ext(2, I);
        sh.XR.c[I] = dbl_xr<C>(sh.X.c[I], sh.R.c[I]);
    } else if constexpr (STAGE == 5) {  // sss = s ss, RR, XR^2 -> B, h, B - h
        const auto rr = ext(1, I);
        sh.sss.c[I] = ext(0, I);
        sh.RR.c[I] = rr;
        const auto b = dbl_b<C>(ext(2, I), sh.XX.c[I], rr);
        sh.h.c[I] = dbl_h<C>(sh.ww.c[I], b);
        sh.bmh.c[I] = dbl_bmh<C>(b, sh.h.c[I]);
    } else {  // X3 = h s, Y3 = w (B - h) - 2 RR, Z3 = sss, canonical
        static_assert(STAGE == 7, "stage");
        const auto x3 = ext(0, I);
        const auto y3 = sub<M>(ext(1, I), smul<M, 2>(sh.RR.c[I]));
        if (!sh.ident) {
            sh.X.c[I] = fit<M, 1>(x3);
            sh.Y.c[I] = fit<M, 1>(y3);
            sh.Z.c[I] = fit<M, 1>(sh.sss.c[I]);
        }
    }
}

// Stage `stage` of one doubling for thread t of the point's warp; the warp
// synchronises after each stage.
template <class C>
F_DEV void dbl_stage(DblSlots<C>& sh, int stage, int t)
{
    switch (stage) {
    case 0: level_products<C, 3>(sh, t, sh.X, sh.X, sh.Z, sh.Z, sh.Y, sh.Z); break;
    case 1:
        if (t == WARP - 1) sh.ident = fe_is_zero(sh.X) && fe_is_zero(sh.Z);
        if (t < C::D) combine<C, 1>(sh, t);
        break;
    case 2: level_products<C, 3>(sh, t, sh.s, sh.s, sh.Y, sh.s, sh.w, sh.w); break;
    case 3: if (t < C::D) combine<C, 3>(sh, t); break;
    case 4: level_products<C, 3>(sh, t, sh.s, sh.ss, sh.R, sh.R, sh.XR, sh.XR); break;
    case 5: if (t < C::D) combine<C, 5>(sh, t); break;
    case 6: level_products<C, 2>(sh, t, sh.h, sh.s, sh.w, sh.bmh, sh.w, sh.bmh); break;
    case 7: if (t < C::D) combine<C, 7>(sh, t); break;
    default: break;
    }
}

// thread t < 3 D moves one component of one coordinate; thread 3 D clears the zero
template <class C>
F_DEV void warp_load(DblSlots<C>& sh, const u32* __restrict__ x1, const u32* __restrict__ y1,
                     const u32* __restrict__ z1, long n, long idx, int t)
{
    constexpr int D = C::D;
    if (t < 3 * D) {
        const int k = t % D;
        const u32* src = t < D ? x1 : t < 2 * D ? y1 : z1;
        Fe<D, 1>& dst = t < D ? sh.X : t < 2 * D ? sh.Y : sh.Z;
#pragma unroll
        for (int j = 0; j < NW; j++) dst.c[k].w[j] = src[(long)(k * NW + j) * n + idx];
    } else if (t == 3 * D) {
#pragma unroll
        for (int j = 0; j < NW; j++) sh.zero.w[j] = 0;
    }
}

template <class C>
F_DEV void warp_store(const DblSlots<C>& sh, u32* __restrict__ x3, u32* __restrict__ y3,
                      u32* __restrict__ z3, long n, long idx, int t)
{
    constexpr int D = C::D;
    if (t < 3 * D) {
        const int k = t % D;
        u32* dst = t < D ? x3 : t < 2 * D ? y3 : z3;
        const Fe<D, 1>& src = t < D ? sh.X : t < 2 * D ? sh.Y : sh.Z;
#pragma unroll
        for (int j = 0; j < NW; j++) dst[(long)(k * NW + j) * n + idx] = src.c[k].w[j];
    }
}

// one block (one warp) a point
template <class M, int D, int NR, int A_K, int A_S>
__global__ void __launch_bounds__(WARP)
ec_dbl_warp_kernel(const u32* __restrict__ x1, const u32* __restrict__ y1,
                   const u32* __restrict__ z1, u32* __restrict__ x3, u32* __restrict__ y3,
                   u32* __restrict__ z3, long n, int k)
{
    using C = DblCurve<M, D, NR, A_K, A_S>;
    __shared__ DblSlots<C> sh;
    const long idx = blockIdx.x;
    const int t = threadIdx.x;
    warp_load<C>(sh, x1, y1, z1, n, idx, t);
    __syncwarp();
#pragma unroll 1
    for (int i = 0; i < k; i++) {
#pragma unroll
        for (int stage = 0; stage < DBL_STAGES; stage++) {
            dbl_stage<C>(sh, stage, t);
            __syncwarp();
        }
    }
    warp_store<C>(sh, x3, y3, z3, n, idx, t);
}

// One instantiation per curve group: (launcher, modulus, D, NR, A_K, A_S)
// with a = A_K u^A_S.  MNT4753 G1: a = 2.  MNT4753 G2 over Fq2 =
// Fq[u]/(u^2 - 13): a = 26.  MNT6753 G1: a = 11.  MNT6753 G2 over Fq3 =
// Fq[u]/(u^3 - 11): a = 11 u^2.
#define EC_DBL_INSTANTIATIONS(X)                     \
    X(ec_dbl_fp_mnt4753, ModMnt4753, 1, 1, 2, 0)     \
    X(ec_dbl_fp2_mnt4753, ModMnt4753, 2, 13, 26, 0)  \
    X(ec_dbl_fp_mnt6753, ModMnt6753, 1, 1, 11, 0)    \
    X(ec_dbl_fp3_mnt6753, ModMnt6753, 3, 11, 11, 2)

#ifdef __CUDACC__
#define EC_DBL_LAUNCHER(name, ...)                                                             \
    extern "C" int name##_launch(const void* x1, const void* y1, const void* z1, void* x3,     \
                                 void* y3, void* z3, long n, int k, void* stream)              \
    {                                                                                          \
        ec_dbl_warp_kernel<__VA_ARGS__><<<(unsigned)n, WARP, 0, (cudaStream_t)stream>>>(       \
            (const u32*)x1, (const u32*)y1, (const u32*)z1, (u32*)x3, (u32*)y3, (u32*)z3, n, k); \
        return (int)cudaGetLastError();                                                        \
    }

EC_DBL_INSTANTIATIONS(EC_DBL_LAUNCHER)
#endif
