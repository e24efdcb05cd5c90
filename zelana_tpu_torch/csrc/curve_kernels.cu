// Point kernels, for G1 (over Fq) and G2 (over Fq2): the bucket run-scan and
// the batched complete projective add of the run-scan MSM, and the in-place
// slot-pool step of the fixed-base (keygen) reduction tree.
//
// runscan replaces pallas_curve.runscan_call. The TPU kernel walks the R+1
// stream rows as a sequential grid and carries each lane's partial bucket sum
// in VMEM scratch between grid steps. Blocks on Hopper run in parallel and in
// no order, so here one thread owns one lane: it loops over the rows itself
// and keeps the carry in registers. Row r, lane l: if flags[r, l] the thread
// emits its carry and restarts from the incoming point, else carry += point
// (complete_add_z1 for the affine level-1 stream, complete_add for the
// projective level-2 stream); rows without a flag emit the identity. Each
// thread folds its lane top to bottom in stream order, so the emit is
// exactly the TPU kernel's for the same stream, at any stream shape.
//
// The stream is never materialised: element (r, l) is column ids[r, l] of a
// words-first pool, read inside the kernel. Level 1 reads the segment's
// affine pool by point id (8 MB for a G2 segment: its random reads stay in
// the 50 MB L2), level 2 the level-1 emit by position.
//
// pairs_add replaces pallas_curve.pairs_add_call: one thread per pair.
//
// What bounds them on an H100: integer multiplies and the latency of their
// carry chains. A G1 stream add is 11 Fq products, a G2 add 39 (Fq2
// Karatsuba), 264 multiply instructions each (field.cuh), against 64 (G1)
// or 128 (G2) bytes gathered per add. A lane is a chain of R dependent adds
// that cannot be split without changing the projective representatives, so
// the parallelism comes from the lane count: the schedule's lanes are chosen
// for this card (ops/msm_scan.py), enough warps to fill 132 SMs as far as
// the registers allow. The G2 carry (48 words) plus the Fq2 temporaries
// need about all of a thread's 255 registers, which caps residency at 8
// warps per SM; nvcc -Xptxas -v reports registers and spills. The field
// products run on PTX carry chains (field.cuh).
//
// Layouts, all words-first and column-major so a warp's loads coalesce:
//   pool  (VC, pool_ld) words: VC = 16 (G1) / 32 (G2) affine X|Y, or
//         C = 24 / 48 projective X|Y|Z for the level-2 stream
//   ids   (R+1, lanes) int32 pool columns; flags (R+1, lanes) int32,
//         nonzero where a run begins
//   emit  (C, R+1, lanes) words
//   pairs (C, n) words
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libcurve_kernels.so curve_kernels.cu

#include "field.cuh"

// runscan threads per block. No minimum of resident blocks: G2 takes all
// 255 registers (with a few bytes of spills) and a minimum would only force
// more spills; G1 takes 102 (affine) and 132 (projective). At 32,768 lanes
// a segment's 1,024 warps are one wave on 132 SMs for either curve.
constexpr int RS_THREADS = 64;

template <class T, bool PROJ_IN>
__global__ void __launch_bounds__(RS_THREADS)
    runscan_kernel(const u32* __restrict__ pool, long pool_ld,
                   const int* __restrict__ ids, const int* __restrict__ flags,
                   u32* __restrict__ emit, int rows, int lanes) {
    int l = blockIdx.x * blockDim.x + threadIdx.x;
    if (l >= lanes) return;
    const long ld = (long)rows * lanes;  // stride between emit word rows
    constexpr int K = Coord<T>::ROWS;
    Proj<T> carry = identity<T>();
    for (int r = 0; r < rows; ++r) {
        const long i = (long)r * lanes + l;
        const bool f = flags[i] != 0;
        const long id = ids[i];
        store_proj(emit, ld, i, f ? carry : identity<T>());
        if (PROJ_IN) {
            Proj<T> q = load_proj<T>(pool, pool_ld, id);
            carry = f ? q : complete_add(carry, q);
        } else {
            T x = Coord<T>::load(pool, pool_ld, id);
            T y = Coord<T>::load(pool + K * pool_ld, pool_ld, id);
            if (f)
                carry = Proj<T>{x, y, Coord<T>::one()};
            else
                carry = complete_add_z1(carry, x, y);
        }
    }
}

template <class T>
__global__ void __launch_bounds__(128)
    pairs_add_kernel(const u32* __restrict__ a, const u32* __restrict__ b,
                     u32* __restrict__ out, long n) {
    long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    store_proj(out, n, i,
               complete_add(load_proj<T>(a, n, i), load_proj<T>(b, n, i)));
}

// step replaces pallas_curve.step_call: one round of a slot-pool reduction
// (fixed_base._run_fb; the tape MSM's rounds too). The TPU kernel is handed
// two operand blocks that XLA gathered beforehand and writes the S sums in
// place at a scalar-prefetched pool offset (input_output_aliases). Here each
// thread reads its two operands straight from the pool by index, so the two
// (C, S) gathered copies are never materialised (50 MB each for a G1 round 0
// of a 32,768-scalar keygen chunk), and writes pool[:, off + i]. Operand i
// is pool slot ia[i] / ib[i], or, with no index arrays, slots base + 2i and
// base + 2i + 1 (the pairing of the previous round's block). The wrapper
// checks that the slots read and the slots written are disjoint. MIXED
// reads only X | Y (operands with Z = 1) and adds with complete_add_mixed.
// One thread per add, as pairs_add; the bound is integer multiplies
// (12 Fq products a G1 add, 42 a G2 add, 264 multiply instructions each).
template <class T, bool MIXED>
__global__ void __launch_bounds__(128)
    step_kernel(u32* __restrict__ pool, const int* __restrict__ ia,
                const int* __restrict__ ib, long base, long off, long S,
                long total) {
    long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= S) return;
    const long a = ia ? (long)ia[i] : base + 2 * i;
    const long b = ib ? (long)ib[i] : base + 2 * i + 1;
    Proj<T> r;
    if (MIXED) {
        constexpr int K = Coord<T>::ROWS;
        r = complete_add_mixed(Coord<T>::load(pool, total, a),
                               Coord<T>::load(pool + K * total, total, a),
                               Coord<T>::load(pool, total, b),
                               Coord<T>::load(pool + K * total, total, b));
    } else {
        r = complete_add(load_proj<T>(pool, total, a),
                         load_proj<T>(pool, total, b));
    }
    store_proj(pool, total, off + i, r);
}

// pool: (C, total) projective words, updated in place at columns
// [off, off + S). ia / ib: S int32 slot ids each, or both null for the
// (base + 2i, base + 2i + 1) pairing.
extern "C" int zt_step(int curve, int mixed, void* pool, const void* ia,
                       const void* ib, long base, long off, long S,
                       long total, void* stream) {
    if (S <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    unsigned blocks = (unsigned)((S + 127) / 128);
    u32* p = (u32*)pool;
    const int* a = (const int*)ia;
    const int* b = (const int*)ib;
    if (curve == 0 && !mixed)
        step_kernel<Fq, false><<<blocks, 128, 0, s>>>(p, a, b, base, off, S,
                                                      total);
    else if (curve == 0)
        step_kernel<Fq, true><<<blocks, 128, 0, s>>>(p, a, b, base, off, S,
                                                     total);
    else if (!mixed)
        step_kernel<Fq2, false><<<blocks, 128, 0, s>>>(p, a, b, base, off, S,
                                                       total);
    else
        step_kernel<Fq2, true><<<blocks, 128, 0, s>>>(p, a, b, base, off, S,
                                                      total);
    return (int)cudaGetLastError();
}

// curve: 0 = G1, 1 = G2. proj_in: 1 for the projective level-2 stream.
// pool: (VC, pool_ld) words; ids, flags: (rows, lanes) int32.
extern "C" int zt_runscan(int curve, int proj_in, const void* pool,
                          const void* ids, const void* flags, void* emit,
                          int rows, int lanes, long pool_ld, void* stream) {
    if (rows <= 0 || lanes <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    unsigned blocks = (unsigned)((lanes + RS_THREADS - 1) / RS_THREADS);
    const u32* p = (const u32*)pool;
    const int* id = (const int*)ids;
    const int* f = (const int*)flags;
    u32* e = (u32*)emit;
    if (curve == 0 && !proj_in)
        runscan_kernel<Fq, false><<<blocks, RS_THREADS, 0, s>>>(
            p, pool_ld, id, f, e, rows, lanes);
    else if (curve == 0)
        runscan_kernel<Fq, true><<<blocks, RS_THREADS, 0, s>>>(
            p, pool_ld, id, f, e, rows, lanes);
    else if (!proj_in)
        runscan_kernel<Fq2, false><<<blocks, RS_THREADS, 0, s>>>(
            p, pool_ld, id, f, e, rows, lanes);
    else
        runscan_kernel<Fq2, true><<<blocks, RS_THREADS, 0, s>>>(
            p, pool_ld, id, f, e, rows, lanes);
    return (int)cudaGetLastError();
}

// a, b, out: (C, n) projective words.
extern "C" int zt_pairs_add(int curve, const void* a, const void* b,
                            void* out, long n, void* stream) {
    if (n <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    unsigned blocks = (unsigned)((n + 127) / 128);
    if (curve == 0)
        pairs_add_kernel<Fq><<<blocks, 128, 0, s>>>(
            (const u32*)a, (const u32*)b, (u32*)out, n);
    else
        pairs_add_kernel<Fq2><<<blocks, 128, 0, s>>>(
            (const u32*)a, (const u32*)b, (u32*)out, n);
    return (int)cudaGetLastError();
}
