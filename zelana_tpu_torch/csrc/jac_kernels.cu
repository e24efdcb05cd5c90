// Point kernels of the Jacobian windowed MSM (ops/msm.py), G1 over Fq and
// G2 over Fq2, one thread a point.
//
// jac_add_kernel: p + q, add-2007-bl with the mask dispatch of the JAX
// package's ops/curve_ops.py point_add. jac_double_kernel: count doublings
// (dbl-2009-l, a = 0), then + addend where one is given, so the MSM's
// Horner step (8 doublings and an add) is one launch. The JAX versions are
// XLA programs (no Pallas kernel stands behind them); as torch ops over the
// limb arithmetic one add would be on the order of a thousand launches, so
// each batch operation is one kernel here, as XLA makes it one program on
// the TPU.
//
// Bit-equal to the plain versions (ops/curve_ops.py point_add,
// point_double): the products and sums are field.cuh's, exact and
// canonical, the formulas are transcribed term for term, and the dispatch
// returns the representative the plain version's selects keep, in their
// order: q at infinity gives p, else p at infinity gives q, else H = 0
// gives the doubling of p (S1 = S2) or (0 : one : 0) (S1 != S2), else the
// sum. The plain version computes every branch and selects; here a thread
// computes only the branch it returns (the points of one warp rarely
// differ, so the divergence costs little).
//
// What bounds them on an H100: integer multiplies. A general G1 add is 16
// Fq products, a doubling 7; G2 16 and 7 Fq2 products of 3 Fq products
// each (Karatsuba), 264 multiply instructions an Fq product (field.cuh),
// against 288 (G1) or 576 (G2) bytes read and written an add. The MSM's
// batches are its lanes: 2^20 points a segmented-scan step at 2^16 points,
// but only the 16 to 32 windows of a bucket-reduction step and one point
// of a Horner step, where a launch is one thread's chain of dependent
// products (latency, not throughput).
//
// Layout: words-first (C, ld) columns, C = 24 (G1: X | Y | Z) or 48 (G2:
// X.c0, X.c1, Y.c0, ...), point i in column i; each operand has its own
// row stride, the output is contiguous (C, n).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libjac_kernels.so jac_kernels.cu

#include "field.cuh"

constexpr int JAC_THREADS = 128;

__device__ __forceinline__ bool is_zero(const Fq& a) {
    u32 o = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) o |= a.w[j];
    return o == 0;
}

__device__ __forceinline__ bool is_zero(const Fq2& a) {
    return is_zero(a.c0) && is_zero(a.c1);
}

template <class T>
__device__ __forceinline__ T dbl(const T& a) {
    return add(a, a);
}

// dbl-2009-l (a = 0), curve_ops.point_double; Proj holds (X, Y, Z) as
// Jacobian coordinates here
template <class T>
__device__ __forceinline__ Proj<T> jac_dbl(const Proj<T>& p) {
    const T A = mul(p.X, p.X);
    const T B = mul(p.Y, p.Y);
    const T C = mul(B, B);
    const T XB = add(p.X, B);
    const T D = dbl(sub(sub(mul(XB, XB), A), C));
    const T E = add(dbl(A), A);
    const T X3 = sub(mul(E, E), dbl(D));
    const T C8 = dbl(dbl(dbl(C)));
    const T Y3 = sub(mul(E, sub(D, X3)), C8);
    const T Z3 = dbl(mul(p.Y, p.Z));
    return {X3, Y3, Z3};
}

// add-2007-bl with curve_ops.point_add's dispatch
template <class T>
__device__ __forceinline__ Proj<T> jac_add(const Proj<T>& p,
                                           const Proj<T>& q) {
    if (is_zero(q.Z)) return p;
    if (is_zero(p.Z)) return q;
    const T Z1Z1 = mul(p.Z, p.Z);
    const T Z2Z2 = mul(q.Z, q.Z);
    const T U1 = mul(p.X, Z2Z2);
    const T U2 = mul(q.X, Z1Z1);
    const T S1 = mul(mul(p.Y, q.Z), Z2Z2);
    const T S2 = mul(mul(q.Y, p.Z), Z1Z1);
    const T H = sub(U2, U1);
    const T SS = sub(S2, S1);
    if (is_zero(H)) return is_zero(SS) ? jac_dbl(p) : identity<T>();
    const T H2 = dbl(H);
    const T I = mul(H2, H2);
    const T J = mul(H, I);
    const T Rr = dbl(SS);  // r = 2 (S2 - S1)
    const T V = mul(U1, I);
    const T X3 = sub(sub(mul(Rr, Rr), J), dbl(V));
    const T Y3 = sub(mul(Rr, sub(V, X3)), dbl(mul(S1, J)));
    const T Z3 = mul(mul(H2, p.Z), q.Z);
    return {X3, Y3, Z3};
}

template <class T>
__global__ void __launch_bounds__(JAC_THREADS)
    jac_add_kernel(const u32* __restrict__ p, long ldp,
                   const u32* __restrict__ q, long ldq,
                   u32* __restrict__ out, long n) {
    const long i = (long)blockIdx.x * JAC_THREADS + threadIdx.x;
    if (i >= n) return;
    store_proj(out, n, i,
               jac_add(load_proj<T>(p, ldp, i), load_proj<T>(q, ldq, i)));
}

template <class T>
__global__ void __launch_bounds__(JAC_THREADS)
    jac_double_kernel(const u32* __restrict__ p, long ldp,
                      const u32* __restrict__ addend, long lda,
                      u32* __restrict__ out, long n, int count) {
    const long i = (long)blockIdx.x * JAC_THREADS + threadIdx.x;
    if (i >= n) return;
    Proj<T> acc = load_proj<T>(p, ldp, i);
    for (int k = 0; k < count; ++k) acc = jac_dbl(acc);
    if (addend) acc = jac_add(acc, load_proj<T>(addend, lda, i));
    store_proj(out, n, i, acc);
}

// curve: 0 = G1, 1 = G2. p, q: (C, ld*) words; out: (C, n) words.
extern "C" int zt_jac_add(int curve, const void* p, long ldp, const void* q,
                          long ldq, void* out, long n, void* stream) {
    if (n <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    unsigned blocks = (unsigned)((n + JAC_THREADS - 1) / JAC_THREADS);
    const u32* a = (const u32*)p;
    const u32* b = (const u32*)q;
    u32* o = (u32*)out;
    if (curve == 0)
        jac_add_kernel<Fq><<<blocks, JAC_THREADS, 0, s>>>(a, ldp, b, ldq, o,
                                                          n);
    else
        jac_add_kernel<Fq2><<<blocks, JAC_THREADS, 0, s>>>(a, ldp, b, ldq, o,
                                                           n);
    return (int)cudaGetLastError();
}

// addend: (C, lda) words, or null for none.
extern "C" int zt_jac_double(int curve, const void* p, long ldp,
                             const void* addend, long lda, void* out, long n,
                             int count, void* stream) {
    if (n <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    unsigned blocks = (unsigned)((n + JAC_THREADS - 1) / JAC_THREADS);
    const u32* a = (const u32*)p;
    const u32* d = (const u32*)addend;
    u32* o = (u32*)out;
    if (curve == 0)
        jac_double_kernel<Fq><<<blocks, JAC_THREADS, 0, s>>>(a, ldp, d, lda,
                                                             o, n, count);
    else
        jac_double_kernel<Fq2><<<blocks, JAC_THREADS, 0, s>>>(a, ldp, d, lda,
                                                              o, n, count);
    return (int)cudaGetLastError();
}
