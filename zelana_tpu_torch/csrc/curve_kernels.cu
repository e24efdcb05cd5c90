// Point kernels, for G1 (over Fq) and G2 (over Fq2): the bucket run-scan and
// the bucket tail of the run-scan MSM, and the slot-pool reduction tree of
// the fixed-base (keygen) engine.
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
// What bounds them on an H100: integer multiplies and the latency of their
// carry chains. A G1 stream add is 11 Fq products, a G2 add 39 (Fq2
// Karatsuba), 264 multiply instructions each (field.cuh), against 64 (G1)
// or 128 (G2) bytes gathered per add. A lane is a chain of R dependent adds
// that cannot be split without changing the projective representatives, so
// the run-scan's parallelism comes from the lane count: the schedule's
// lanes are chosen for this card (ops/msm_scan.py), enough warps to fill
// 132 SMs as far as the registers allow. The G2 carry (48 words) plus the
// Fq2 temporaries need about all of a thread's 255 registers, which caps
// residency at 8 warps per SM; nvcc -Xptxas -v reports registers and
// spills. The bucket tail has few adds in flight and long dependent
// chains of them, so there six threads share each add (coop_add below).
// The field products run on PTX carry chains (field.cuh).
//
// Layouts, all words-first and column-major so a warp's loads coalesce:
//   pool  (VC, pool_ld) words: VC = 16 (G1) / 32 (G2) affine X|Y, or
//         C = 24 / 48 projective X|Y|Z for the level-2 stream
//   ids   (R+1, lanes) int32 pool columns; flags (R+1, lanes) int32,
//         nonzero where a run begins
//   emit  (C, R+1, lanes) words
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

// ---------------------------------------------------------------------------
// The cooperative complete add: COOP = 6 threads share one
// Renes-Costello-Batina add (Algorithm 7, a = 0) through shared memory. Its
// products fall into two stages of six independent ones, with additions
// (and G2's two 3b' products) between them:
//   stage 1, thread j: t0 = X1 X2, t1 = Y1 Y2, t2 = Z1 Z2,
//            m3 = (X1 + Y1)(X2 + Y2), m4 = (Y1 + Z1)(Y2 + Z2),
//            m5 = (X1 + Z1)(X2 + Z2)
//   combine, thread j: t3 = m3 - (t0 + t1), t4 = m4 - (t1 + t2),
//            y = 3b (m5 - (t0 + t2)), u = 3 t0, z = t1 + 3b t2,
//            v = t1 - 3b t2
//   stage 2, thread j: t4 y, t3 v, y u, v z, u t3, z t4
//   final, thread j < 3: X3 = t3 v - t4 y, Y3 = v z + y u, Z3 = z t4 + u t3
// These are complete_add's terms (field.cuh), and every field operation
// returns the canonical residue, so the sum is complete_add's projective
// point word for word. An add's critical path is two Fq products for G1
// (3b = 9 is additions) and three Fq2 products for G2, against 12 and 14
// (42 Fq products) in one thread, and a thread holds one product's operands
// instead of two whole points. tests/test_torch_fixed_base.py::
// test_coop_add_model runs this schedule, thread by thread, in Python, and
// tests/test_torch_cuda_emulation.py runs this file on the CPU.
// ---------------------------------------------------------------------------

constexpr int COOP = 6;  // threads per cooperative add

// element s of column i of a words-first shared array with ld columns
template <class T>
__device__ __forceinline__ T sget(const u32* sm, int ld, int s, int i) {
    return Coord<T>::load(sm + s * Coord<T>::ROWS * ld, ld, i);
}

template <class T>
__device__ __forceinline__ void sput(u32* sm, int ld, int s, int i,
                                     const T& v) {
    Coord<T>::store(sm + s * Coord<T>::ROWS * ld, ld, i, v);
}

// pts: projective points in shared memory, (3 K, ldp) words with
// K = Coord<T>::ROWS; scr: 12 elements per add, (12 K, lds) words. Thread
// j < COOP of the add writes its part of pts[o] = pts[p] + pts[q], using
// scratch column a; o may be p or q. Every thread of the block calls it,
// with on = false where it has no add: it holds four barriers.
template <class T>
__device__ __forceinline__ void coop_add(u32* pts, int ldp, int p, int q,
                                         int o, u32* scr, int lds, int a,
                                         int j, bool on) {
    if (on) {  // stage 1: coordinate u (j < 3) or the sum of u and v
        const int u = j < 3 ? j : (j == 4 ? 1 : 0);
        T x = sget<T>(pts, ldp, u, p);
        T y = sget<T>(pts, ldp, u, q);
        if (j >= 3) {
            const int v = j == 3 ? 1 : 2;
            x = add(x, sget<T>(pts, ldp, v, p));
            y = add(y, sget<T>(pts, ldp, v, q));
        }
        sput(scr, lds, j, a, mul(x, y));
    }
    __syncthreads();
    if (on) {  // combine into slots 6 t3, 7 t4, 8 y, 9 u, 10 z, 11 v
        const T t0 = sget<T>(scr, lds, 0, a);
        const T t1 = sget<T>(scr, lds, 1, a);
        const T t2 = sget<T>(scr, lds, 2, a);
        T r;
        if (j == 0)
            r = sub(sget<T>(scr, lds, 3, a), add(t0, t1));
        else if (j == 1)
            r = sub(sget<T>(scr, lds, 4, a), add(t1, t2));
        else if (j == 2)
            r = mul_b3(sub(sget<T>(scr, lds, 5, a), add(t0, t2)));
        else if (j == 3)
            r = add(add(t0, t0), t0);
        else if (j == 4)
            r = add(t1, mul_b3(t2));
        else
            r = sub(t1, mul_b3(t2));
        sput(scr, lds, 6 + j, a, r);
    }
    __syncthreads();
    if (on) {  // stage 2: slot j = slots 6 + A_j times 6 + B_j
        const int A = 6 + ((0x435201 >> (4 * j)) & 0xF);
        const int B = 6 + ((0x104352 >> (4 * j)) & 0xF);
        sput(scr, lds, j, a,
             mul(sget<T>(scr, lds, A, a), sget<T>(scr, lds, B, a)));
    }
    __syncthreads();
    if (on && j < 3) {  // X3 = s1 - s0, Y3 = s3 + s2, Z3 = s5 + s4
        const T hi = sget<T>(scr, lds, 2 * j + 1, a);
        const T lo = sget<T>(scr, lds, 2 * j, a);
        sput(pts, ldp, j, o, j == 0 ? sub(hi, lo) : add(hi, lo));
    }
    __syncthreads();
}

// ---------------------------------------------------------------------------
// The MSM's bucket tail, in two launches per segment; together they replace
// the K - 1 + 7 pallas_curve.pairs_add_call launches of the TPU path and
// the XLA gathers between them. One thread per add would leave the card
// nearly empty (8,192 G2 adds are two warps per SM) and pay one whole
// add's latency per dependent step; here six threads share each add
// (coop_add) and each launch holds all of its dependent adds.
//
// bucket_merge folds the K dense layers of bucket b left to right:
// merged[b] = ((L0 + L1) + L2) + ..., where layer k is column
// dense[k * nb + b] of the level-2 emit. MERGE_ADDS buckets a block, the
// accumulators in shared memory; 256 blocks for the 8,192 buckets.
//
// bucket_tree forms the bit-subset sums: block g = t * 32 + w gathers the
// 128 merged buckets of window w whose digit has bit t set (in digit
// order) and runs the pairwise tree x[i] += x[i + h] for h = 64, ..., 1 in
// shared memory; x[0] is final g. The adds and their order are those of
// the plain version, so the finals are its words exactly.
//
// Why two launches: a bucket feeds one group per set bit of its digit, so
// a block per group would merge every bucket about four times (196,000
// adds a segment instead of 73,500), and a block per window would keep 32
// of 132 SMs busy. The merged buckets (1.5 MB for G2) pass through L2.
// ---------------------------------------------------------------------------

constexpr int MERGE_ADDS = 32;  // 192 threads
constexpr int TREE_ADDS = 64;   // the tree's first level; 384 threads
constexpr int TREE_GROUPS = 256;  // 8 bits x 32 windows
constexpr int TREE_BUCKETS = 256;  // digits per window

template <class T>
__global__ void __launch_bounds__(COOP * MERGE_ADDS)
    bucket_merge_kernel(const u32* __restrict__ emit, long emit_ld,
                        const int* __restrict__ dense, int K, int nb,
                        u32* __restrict__ merged) {
    constexpr int C = 3 * Coord<T>::ROWS;
    constexpr int NA = MERGE_ADDS;
    __shared__ u32 pts[C * 2 * NA];  // accumulators, then the next layer
    __shared__ u32 scr[12 * Coord<T>::ROWS * NA];
    const int a = threadIdx.x % NA, j = threadIdx.x / NA;
    const long b = (long)blockIdx.x * NA + a;  // nb is a multiple of NA
    long col = dense[b];
    for (int r = j; r < C; r += COOP)
        pts[r * 2 * NA + a] = emit[r * emit_ld + col];
    for (int k = 1; k < K; ++k) {
        col = dense[(long)k * nb + b];
        for (int r = j; r < C; r += COOP)
            pts[r * 2 * NA + NA + a] = emit[r * emit_ld + col];
        __syncthreads();
        coop_add<T>(pts, 2 * NA, a, NA + a, a, scr, NA, a, j, true);
    }
    // each thread stores the rows it loaded; coop_add ends on a barrier
    for (int r = j; r < C; r += COOP)
        merged[r * (long)nb + b] = pts[r * 2 * NA + a];
}

template <class T>
__global__ void __launch_bounds__(COOP * TREE_ADDS)
    bucket_tree_kernel(const u32* __restrict__ merged, int nb,
                       u32* __restrict__ out) {
    constexpr int C = 3 * Coord<T>::ROWS;
    constexpr int NA = TREE_ADDS, LEAVES = 2 * TREE_ADDS;
    extern __shared__ u32 sm[];
    u32* pts = sm;                 // (C, LEAVES)
    u32* scr = sm + C * LEAVES;    // (12 K, NA)
    const int g = blockIdx.x, t = g / 32, w = g % 32;
    for (int e = threadIdx.x; e < C * LEAVES; e += blockDim.x) {
        const int r = e / LEAVES, i = e % LEAVES;
        // the i-th digit with bit t set
        const int d = ((i >> t) << (t + 1)) | (1 << t) | (i & ((1 << t) - 1));
        pts[e] = merged[r * (long)nb + w * TREE_BUCKETS + d];
    }
    __syncthreads();
    const int a = threadIdx.x % NA, j = threadIdx.x / NA;
    for (int h = NA; h >= 1; h >>= 1)
        coop_add<T>(pts, LEAVES, a, a + h, a, scr, NA, a, j, a < h);
    for (int r = threadIdx.x; r < C; r += blockDim.x)
        out[r * TREE_GROUPS + g] = pts[r * LEAVES];
}

// step replaces pallas_curve.step_call: `rounds` rounds of a slot-pool
// reduction tree in one launch (fixed_base._run_fb runs keygen's five; the
// tape MSM's rounds use one). The TPU kernel is handed two operand blocks
// that XLA gathered beforehand and writes each round's sums in place at a
// scalar-prefetched pool offset, one launch per round. Round 0 adds
// operands read straight from the pool by index: slot ia[i] / ib[i], or,
// with no index arrays, slots base + 2i and base + 2i + 1. MIXED reads only
// X | Y (operands with Z = 1) and adds with complete_add_mixed. Round r >= 1
// adds outputs 2i and 2i + 1 of round r - 1 (complete_add), and only the
// last round's S / 2^(rounds-1) sums are written, to pool[:, off + q].
//
// One thread per subtree: thread q does round-0 adds q 2^(rounds-1) ... in
// order and folds each finished pair at once (post-order), keeping one
// pending left operand per level in shared memory, so it does every add of
// its subtree, the same adds in the same pairs as five single rounds.
// A block that owns subtrees and runs the later rounds in shared memory,
// one thread per add, was tried first: its threads idle through rounds
// 1-4 (half, then a quarter, ... of them work) while each round costs a
// whole add's latency, and at G2's 8 resident warps per SM nothing else
// fills the SM; it took 2.71 ms for a G2 keygen chunk on an H100 against
// this design's 1.3 ms for G1 and G2 together (PERF.md).
// Here every thread stays busy to the end: 32,768 subtrees of a keygen
// chunk are 1,024 warps, one wave on 132 SMs. The bound is integer
// multiplies (12 Fq products a G1 add, 42 a G2 add).
constexpr int STEP_THREADS = 64;
constexpr int STEP_MAX_ROUNDS = 5;

template <class T, bool MIXED>
__global__ void __launch_bounds__(STEP_THREADS)
    step_kernel(u32* __restrict__ pool, const int* __restrict__ ia,
                const int* __restrict__ ib, long base, long off, long S,
                long total, int rounds) {
    // pending left operands, level l of thread t at column
    // l * STEP_THREADS + t: (C, (STEP_MAX_ROUNDS - 1) * STEP_THREADS) words
    constexpr int LD = (STEP_MAX_ROUNDS - 1) * STEP_THREADS;
    __shared__ u32 stack[3 * Coord<T>::ROWS * LD];
    const int t = threadIdx.x;
    const long q = (long)blockIdx.x * STEP_THREADS + t;
    const long span = 1L << (rounds - 1);
    if (q * span >= S) return;
    Proj<T> cur;
    for (long k = 0; k < span; ++k) {
        const long i = q * span + k;
        const long a = ia ? (long)ia[i] : base + 2 * i;
        const long b = ib ? (long)ib[i] : base + 2 * i + 1;
        if (MIXED) {
            constexpr int K = Coord<T>::ROWS;
            cur = complete_add_mixed(
                Coord<T>::load(pool, total, a),
                Coord<T>::load(pool + K * total, total, a),
                Coord<T>::load(pool, total, b),
                Coord<T>::load(pool + K * total, total, b));
        } else {
            cur = complete_add(load_proj<T>(pool, total, a),
                               load_proj<T>(pool, total, b));
        }
        int lvl = 0;
        for (long m = k; m & 1; m >>= 1, ++lvl)
            cur = complete_add(
                load_proj<T>(stack, LD, lvl * STEP_THREADS + t), cur);
        if (k + 1 < span) store_proj(stack, LD, lvl * STEP_THREADS + t, cur);
    }
    store_proj(pool, total, off + q, cur);
}

// pool: (C, total) projective words, updated in place at columns
// [off, off + S / 2^(rounds-1)). ia / ib: S int32 slot ids each, or both
// null for the (base + 2i, base + 2i + 1) pairing.
// 1 <= rounds <= STEP_MAX_ROUNDS, and 2^(rounds-1) divides S.
extern "C" int zt_step(int curve, int mixed, void* pool, const void* ia,
                       const void* ib, long base, long off, long S,
                       long total, int rounds, void* stream) {
    if (S <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    const long nq = S >> (rounds - 1);
    unsigned blocks = (unsigned)((nq + STEP_THREADS - 1) / STEP_THREADS);
    u32* p = (u32*)pool;
    const int* a = (const int*)ia;
    const int* b = (const int*)ib;
    if (curve == 0 && !mixed)
        step_kernel<Fq, false><<<blocks, STEP_THREADS, 0, s>>>(
            p, a, b, base, off, S, total, rounds);
    else if (curve == 0)
        step_kernel<Fq, true><<<blocks, STEP_THREADS, 0, s>>>(
            p, a, b, base, off, S, total, rounds);
    else if (!mixed)
        step_kernel<Fq2, false><<<blocks, STEP_THREADS, 0, s>>>(
            p, a, b, base, off, S, total, rounds);
    else
        step_kernel<Fq2, true><<<blocks, STEP_THREADS, 0, s>>>(
            p, a, b, base, off, S, total, rounds);
    return (int)cudaGetLastError();
}

// emit: (C, emit_ld) level-2 emit words; dense: (K, nb) int32 columns of
// it; merged: (C, nb) words out. nb is a multiple of MERGE_ADDS.
extern "C" int zt_bucket_merge(int curve, const void* emit, long emit_ld,
                               const void* dense, int K, int nb,
                               void* merged, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    unsigned blocks = (unsigned)(nb / MERGE_ADDS);
    const u32* e = (const u32*)emit;
    const int* d = (const int*)dense;
    u32* m = (u32*)merged;
    if (curve == 0)
        bucket_merge_kernel<Fq><<<blocks, COOP * MERGE_ADDS, 0, s>>>(
            e, emit_ld, d, K, nb, m);
    else
        bucket_merge_kernel<Fq2><<<blocks, COOP * MERGE_ADDS, 0, s>>>(
            e, emit_ld, d, K, nb, m);
    return (int)cudaGetLastError();
}

// merged: (C, nb) words, nb = 32 windows x 256 digits; out: (C, 256)
// projective bit-subset sums, column t * 32 + w.
extern "C" int zt_bucket_tree(int curve, const void* merged, int nb,
                              void* out, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    const u32* m = (const u32*)merged;
    u32* o = (u32*)out;
    const int threads = COOP * TREE_ADDS;
    if (curve == 0) {
        const int bytes = (3 * 8 * 2 * TREE_ADDS + 12 * 8 * TREE_ADDS) * 4;
        bucket_tree_kernel<Fq><<<TREE_GROUPS, threads, bytes, s>>>(m, nb, o);
    } else {
        const int bytes = (3 * 16 * 2 * TREE_ADDS + 12 * 16 * TREE_ADDS) * 4;
        cudaError_t rc = cudaFuncSetAttribute(
            bucket_tree_kernel<Fq2>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
        if (rc != cudaSuccess) return (int)rc;
        bucket_tree_kernel<Fq2><<<TREE_GROUPS, threads, bytes, s>>>(m, nb,
                                                                    o);
    }
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
