// Elementwise and chained field kernels: the Montgomery multiply, the
// MiMC-91 permutation and the three pieces of Montgomery batch inversion.
// (The NTT's butterfly stages run in ntt_kernels.cu.)
//
// mont_mul replaces pallas_field._mont_mul_call / mont_mul_pallas (reached
// through Poseidon's rounds, hashes/poseidon_batch.py); mimc_permute
// replaces pallas_field.mimc_permute_call; inv_fwd, inv_bwd and inv_base
// replace _inv_fwd_call, _inv_bwd_call and _fermat_call (batch_inv_pallas).
//
// What bounds them on an H100: a 256-bit CIOS multiply is ~264 32-bit
// integer multiply instructions for 96 bytes of traffic (mont_mul), so on
// paper it sits near the balance of the integer multiply rate and HBM
// bandwidth (PERF.md has the numbers). mimc_permute
// does 364 multiplies per 64 bytes: bound by the multiply rate. inv_fwd /
// inv_bwd do one or two multiplies per element moved, near the balance
// too. inv_base inverts the recursion's 1,024-element base, which cannot
// fill the card: its time is one thread's dependent chain. Design: one
// thread per element (the inversion kernels: see their notes below),
// the element's 8 words held in registers, word rows of the (8, N)
// words-first layout read and written coalesced across the warp, the ragged
// edge masked (no padding to a tile multiple).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libfield_kernels.so field_kernels.cu

#include "field.cuh"

template <int F>
__global__ void mont_mul_kernel(const u32* __restrict__ a,
                                const u32* __restrict__ b,
                                u32* __restrict__ out, long n) {
    long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    store<F>(out, n, i, mul(load<F>(a, n, i), load<F>(b, n, i)));
}

// MiMC with key 0 over BN254 Fr: x <- (x + c_r)^7 for r < rounds. The TPU
// kernel walks the rounds as a sequential grid axis with the state in VMEM
// scratch; here the state stays in the thread's registers across all rounds
// and the block stages the (rounds, 8) constants in shared memory once (every
// thread of a round reads the same word: a broadcast, no bank conflicts).
__global__ void mimc_permute_kernel(const u32* __restrict__ x,
                                    const u32* __restrict__ rc,
                                    u32* __restrict__ out, long n,
                                    int rounds) {
    extern __shared__ u32 s_rc[];
    for (int k = threadIdx.x; k < rounds * 8; k += blockDim.x) s_rc[k] = rc[k];
    __syncthreads();
    long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    Fr s = load<1>(x, n, i);
#pragma unroll 1
    for (int r = 0; r < rounds; ++r) {
        Fr c;
#pragma unroll
        for (int j = 0; j < 8; ++j) c.w[j] = s_rc[r * 8 + j];
        Fr t = add(s, c);
        Fr t2 = mul(t, t);
        Fr t4 = mul(t2, t2);
        Fr t6 = mul(t4, t2);
        s = mul(t6, t);
    }
    store<1>(out, n, i, s);
}

// Batch inversion, the TPU's chain layout: n is a multiple of 1024, cut into
// tiles of 16,384; chain c of tile t holds elements 16384 t + 1024 i + c for
// i < len(t), where len is 16 for a whole tile and (n - 16384 t) / 1024 for
// a partial last one (the TPU kernels drop that tile). A warp's 32 chains are
// 32 neighbouring elements, so every load and store is coalesced.
constexpr long kInvBlock = 1024;
constexpr long kInvTile = 16 * kInvBlock;

__device__ __forceinline__ int chain_len(long n, long t) {
    long rest = (n - t * kInvTile) / kInvBlock;
    return (int)(rest < 16 ? rest : 16);
}

// A zero a_i counts as one in every product, so that a chain's total is a
// product of nonzero factors and inverts, and inv_bwd writes zero in its
// place (inv(0) = 0, as the base's); returns whether x was zero. Below the
// top level of an inversion every a_i is such a total.
template <int F>
__device__ __forceinline__ bool zero_as_one(Fp<F>& x) {
    u32 any = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) any |= x.w[j];
    const bool z = any == 0;
    if (z) x = one<F>();
    return z;
}

// issue one step's copies: A arrays x 8 word rows x W / 4 chunks of four
// neighbouring chains, spread over `threads` threads; dst is [array][row][W]
// (array 0 from a, array 1 from prefix)
template <int W, int A>
__device__ __forceinline__ void stage_rows(u32 (*dst)[8][W], const u32* a,
                                           const u32* prefix, long n,
                                           long e0, int tid, int threads) {
    for (int u = tid; u < A * 8 * (W / 4); u += threads) {
        const int arr = u / (8 * (W / 4)), j = u / (W / 4) % 8;
        const int q = 4 * (u % (W / 4));
        ptx::cp_async16(&dst[arr][j][q], (arr ? prefix : a) + j * n + e0 + q);
    }
}

template <int F, int W>
__device__ __forceinline__ Fp<F> smem_load(u32 (*rows)[W], int c) {
    Fp<F> r;
#pragma unroll
    for (int j = 0; j < 8; ++j) r.w[j] = rows[j][c];
    return r;
}

// the scan mappings' threads a chain: 16, or the power of two that covers
// the one partial tile's chains
static int scan_threads(long n) {
    int T = 16;
    if (n < kInvTile) {
        T = 1;
        while (T < n / kInvBlock) T <<= 1;
    }
    return T;
}

// inv_fwd: the exclusive prefix products a_0 ... a_{i-1} of each chain in
// place of its elements, and the chain's total at 1024 t + c. Replaces
// pallas_field._inv_fwd_call. One product per element for 64 bytes moved:
// at 2^20 elements the bytes bound (0.021 ms) sits just above the multiply
// rate's (0.017 ms); the shorter levels of an inversion (2^16, 4,096) are
// bound by latency, 16 dependent products a chain. Two thread mappings,
// chosen by the launcher from n; both stage the chains' a rows in shared
// memory by asynchronous copies (16 bytes: four neighbouring chains of one
// word row), so no product waits on a load it could have issued earlier.
//
// Long levels (inv_fwd_kernel, kFwdChains chains a block, a thread a
// chain): the serial chain acc <- acc * a_i reads a_i from a ring of
// kFwdStages steps, kFwdAhead of them in flight ahead of the products, and
// stores each prefix from registers, coalesced across the warp. One warp a
// block spreads the 2^20 level (2,048 warps, one wave) and the 2^16 one
// (128) over the SMs. A second thread a chain (two halves of eight, one
// combining product per element of the upper half) would add half the
// products and make the 2^20 level bound by the multiply rate above its
// bytes bound.
constexpr int kFwdChains = 32;
constexpr int kFwdStages = 4;
constexpr int kFwdAhead = kFwdStages - 1;
// below this many chains (7 tiles or fewer) one warp an SM cannot hide a
// product's latency, and the scan mapping runs instead: on an H100 the scan
// is 24-31% faster at 1 and 4 tiles, a thread a chain 4% faster at 8 tiles
// and 1.9-3.1x at 16 to 64 (PERF.md, inv_fwd's two mappings)
constexpr long kFwdScanBelow = 8 * kInvBlock;

template <int F>
__global__ void __launch_bounds__(kFwdChains)
    inv_fwd_kernel(const u32* __restrict__ a, u32* __restrict__ prefix,
                   u32* __restrict__ totals, long n, long chains) {
    // ring[step % kFwdStages][0 = a][word row][chain]
    __shared__ __align__(16) u32 ring[kFwdStages][1][8][kFwdChains];
    const int c = threadIdx.x;
    const long g0 = (long)blockIdx.x * kFwdChains;
    const long t = g0 / kInvBlock;
    const long base = t * kInvTile + g0 % kInvBlock;
    const int len = chain_len(n, t);  // the same for the whole block
    for (int k = 0; k < kFwdAhead; ++k) {
        if (k < len)
            stage_rows<kFwdChains, 1>(ring[k], a, nullptr, n,
                                      base + (long)k * kInvBlock, c,
                                      kFwdChains);
        ptx::cp_async_commit();
    }
    Fp<F> acc = one<F>();
#pragma unroll 1
    for (int k = 0; k < len; ++k) {
        // groups committed: kFwdAhead + k; step k's is the (k + 1)-th
        ptx::cp_async_wait<kFwdAhead - 1>();
        __syncthreads();
        // the slot of step k - 1, which every thread has read
        const int kn = k + kFwdAhead;
        if (kn < len)
            stage_rows<kFwdChains, 1>(ring[kn % kFwdStages], a, nullptr, n,
                                      base + (long)kn * kInvBlock, c,
                                      kFwdChains);
        ptx::cp_async_commit();
        Fp<F> x = smem_load<F>(ring[k % kFwdStages][0], c);
        zero_as_one(x);
        store<F>(prefix, n, base + (long)k * kInvBlock + c, acc);
        acc = mul(acc, x);
    }
    store<F>(totals, chains, g0 + c, acc);
}

// Short levels (inv_fwd_scan_kernel, kScanChains chains a block, T threads a
// chain, T >= the chain length L, thread 32 i + c on step i of chain c):
// the inclusive products y_i = a_0 ... a_i by log2(L) rounds of a
// Hillis-Steele scan in shared memory; the thread of step i writes y_i as
// the prefix of step i + 1, the thread of step 0 writes one as step 0's,
// the thread of step L - 1 the total. Depth log2(L) products instead of L,
// for about three times the products.
constexpr int kScanChains = 32;

template <int F>
__global__ void __launch_bounds__(16 * kScanChains)
    inv_fwd_scan_kernel(const u32* __restrict__ a, u32* __restrict__ prefix,
                        u32* __restrict__ totals, long n, long chains) {
    // st[step][0 = a][word row][chain]; the scan's exchange buffer once read
    __shared__ __align__(16) u32 st[16][1][8][kScanChains];
    const int i = threadIdx.x / kScanChains, c = threadIdx.x % kScanChains;
    const long g0 = (long)blockIdx.x * kScanChains;
    const long t = g0 / kInvBlock;
    const long base = t * kInvTile + g0 % kInvBlock;
    const int len = chain_len(n, t);
    for (int k = 0; k < len; ++k)
        stage_rows<kScanChains, 1>(st[k], a, nullptr, n,
                                   base + (long)k * kInvBlock, threadIdx.x,
                                   blockDim.x);
    ptx::cp_async_commit();
    ptx::cp_async_wait<0>();
    __syncthreads();
    Fp<F> x;
    if (i < len) {
        x = smem_load<F>(st[i][0], c);
        zero_as_one(x);
    }
#pragma unroll 1
    for (int d = 1; d < len; d <<= 1) {
        if (i < len) {
#pragma unroll
            for (int j = 0; j < 8; ++j) st[i][0][j][c] = x.w[j];
        }
        __syncthreads();
        if (i >= d && i < len) x = mul(smem_load<F>(st[i - d][0], c), x);
        __syncthreads();
    }
    if (i == 0) store<F>(prefix, n, base + c, one<F>());
    if (i < len - 1)
        store<F>(prefix, n, base + (long)(i + 1) * kInvBlock + c, x);
    else if (i == len - 1)
        store<F>(totals, chains, g0 + c, x);
}

// inv_bwd: from the inverse s of a chain's total, downwards, out_i = s *
// prefix_i, then s <- s * a_i; out_i = 0 where a_i is zero, and a zero a_i
// counts as one in s. Two thread mappings, chosen by
// the launcher from n; both stage their chains' a and prefix rows in shared
// memory by asynchronous copies (16 bytes: four neighbouring chains of one
// word row), so no product waits on a load it could have issued earlier.
//
// Long levels (inv_bwd_kernel, kBwdChains chains a block): two threads per
// chain. The chain thread runs the serial suffix chain s <- s * a_i and
// leaves each s in shared memory; the output thread runs the independent
// product s * prefix_i one step behind it, so the card holds two warps of
// products per 32 chains (31 warps an SM at 2^20 elements) instead of one.
// A ring of kBwdStages steps, kBwdAhead of them in flight ahead of the
// products, replaces the 1 KB a chain that staging all 16 steps at once
// would take: at 2^20 elements the whole grid is resident in one wave.
constexpr int kBwdChains = 64;
constexpr int kBwdStages = 4;
constexpr int kBwdAhead = kBwdStages - 2;
// below this many chains (7 tiles or fewer) two threads a chain leave most
// of the card idle, and the short scan mapping runs instead: on an H100 the
// scan is about 30% faster at 1 and 4 tiles, two threads a chain 8% faster
// at 8 tiles and 1.5-1.8x at 16 to 64 (PERF.md, inv_bwd's two mappings)
constexpr long kBwdScanBelow = 8 * kInvBlock;

template <int F>
__global__ void __launch_bounds__(2 * kBwdChains)
    inv_bwd_kernel(const u32* __restrict__ a, const u32* __restrict__ prefix,
                   const u32* __restrict__ tinv, u32* __restrict__ out,
                   long n, long chains) {
    // ring[step % kBwdStages][0 = a, 1 = prefix][word row][chain]
    __shared__ __align__(16) u32 ring[kBwdStages][2][8][kBwdChains];
    __shared__ u32 sbuf[2][8][kBwdChains];  // s of the last two steps
    const int tid = threadIdx.x, c = tid % kBwdChains;
    const bool chain_thread = tid < kBwdChains;
    const long g0 = (long)blockIdx.x * kBwdChains;
    const long t = g0 / kInvBlock;
    const long base = t * kInvTile + g0 % kInvBlock;
    const int len = chain_len(n, t);  // the same for the whole block
    // step k works on element row i = len - 1 - k
    auto row = [&](int k) { return base + (long)(len - 1 - k) * kInvBlock; };
    for (int k = 0; k < kBwdAhead; ++k) {
        if (k < len)
            stage_rows<kBwdChains, 2>(ring[k], a, prefix, n, row(k), tid,
                                      2 * kBwdChains);
        ptx::cp_async_commit();
    }
    Fp<F> s;
    if (chain_thread) s = load<F>(tinv, chains, g0 + c);
#pragma unroll 1
    for (int k = 0; k <= len; ++k) {
        // groups committed: kBwdAhead + k; step k's is the (k + 1)-th
        ptx::cp_async_wait<kBwdAhead - 1>();
        __syncthreads();
        const int kn = k + kBwdAhead;
        if (kn < len)
            stage_rows<kBwdChains, 2>(ring[kn % kBwdStages], a, prefix, n,
                                      row(kn), tid, 2 * kBwdChains);
        ptx::cp_async_commit();
        if (chain_thread) {
            if (k < len) {
#pragma unroll
                for (int j = 0; j < 8; ++j) sbuf[k & 1][j][c] = s.w[j];
                if (k < len - 1) {  // s * a_0 is never used
                    Fp<F> x = smem_load<F>(ring[k % kBwdStages][0], c);
                    zero_as_one(x);
                    s = mul(s, x);
                }
            }
        } else if (k > 0) {
            // step k - 1's slot still holds its a row: the copies of this
            // step went to the slot of step k - 2
            Fp<F> x = smem_load<F>(ring[(k - 1) % kBwdStages][0], c);
            const bool z = zero_as_one(x);
            const Fp<F> sp = smem_load<F>(sbuf[(k - 1) & 1], c);
            Fp<F> r = mul(sp, smem_load<F>(ring[(k - 1) % kBwdStages][1], c));
#pragma unroll
            for (int j = 0; j < 8; ++j) r.w[j] = z ? 0u : r.w[j];
            store<F>(out, n, row(k - 1) + c, r);
        }
    }
}

// Short levels (inv_bwd_scan_kernel, kScanChains chains a block, T threads a
// chain, T >= the chain length L, thread 32 i + c on step i of chain c):
// s_i = w_i ... w_{L-1} with w_{L-1} = the total's inverse and w_i = a_{i+1}
// below, a suffix product that log2(L) rounds of a Hillis-Steele scan in
// shared memory compute; then out_i = s_i * prefix_i. Depth log2(L) + 1
// products instead of 2L, for about twice the products.
template <int F>
__global__ void __launch_bounds__(16 * kScanChains)
    inv_bwd_scan_kernel(const u32* __restrict__ a,
                        const u32* __restrict__ prefix,
                        const u32* __restrict__ tinv, u32* __restrict__ out,
                        long n, long chains) {
    // st[step][0 = a, 1 = prefix][word row][chain]; the a rows become the
    // scan's exchange buffer once read
    __shared__ __align__(16) u32 st[16][2][8][kScanChains];
    const int i = threadIdx.x / kScanChains, c = threadIdx.x % kScanChains;
    const long g0 = (long)blockIdx.x * kScanChains;
    const long t = g0 / kInvBlock;
    const long base = t * kInvTile + g0 % kInvBlock;
    const int len = chain_len(n, t);
    for (int k = 0; k < len; ++k)
        stage_rows<kScanChains, 2>(st[k], a, prefix, n,
                                   base + (long)k * kInvBlock, threadIdx.x,
                                   blockDim.x);
    ptx::cp_async_commit();
    ptx::cp_async_wait<0>();
    __syncthreads();
    Fp<F> x;
    bool z = false;  // a_i is zero: out_i = 0
    if (i < len) {
        Fp<F> ai = smem_load<F>(st[i][0], c);
        z = zero_as_one(ai);
    }
    if (i < len - 1) {
        x = smem_load<F>(st[i + 1][0], c);
        zero_as_one(x);
    } else if (i == len - 1) {
        x = load<F>(tinv, chains, g0 + c);
    }
    __syncthreads();
#pragma unroll 1
    for (int d = 1; d < len; d <<= 1) {
        if (i < len) {
#pragma unroll
            for (int j = 0; j < 8; ++j) st[i][0][j][c] = x.w[j];
        }
        __syncthreads();
        if (i + d < len) x = mul(x, smem_load<F>(st[i + d][0], c));
        __syncthreads();
    }
    if (i < len) {
        Fp<F> r = mul(x, smem_load<F>(st[i][1], c));
#pragma unroll
        for (int j = 0; j < 8; ++j) r.w[j] = z ? 0u : r.w[j];
        store<F>(out, n, base + (long)i * kInvBlock + c, r);
    }
}

// The base of the recursion: x^-1 per element by the fixed-count safegcd
// of field.cuh (600 divsteps in 20 batches, then one product by R^3);
// inv(0) = 0. About 20 x (30 divsteps of ~10 dependent integer operations
// + ~90 32x32 -> 64-bit products) per element, against the ~380 dependent
// Montgomery products of a^(p-2): the time of the 1,024-element base is
// one thread's dependent chain, so only a shorter chain helps. One warp a
// block spreads the base over 32 SMs.
template <int F>
__global__ void __launch_bounds__(32)
    inv_base_kernel(const u32* __restrict__ a, u32* __restrict__ out,
                    long n) {
    long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    store<F>(out, n, i, inv(load<F>(a, n, i)));
}

static const int kThreads = 256;

static unsigned blocks_for(long n) {
    return (unsigned)((n + kThreads - 1) / kThreads);
}

// Runs the launch statement with F bound to `field` as a compile-time
// constant; an unknown field returns cudaErrorInvalidValue.
#define ZT_BY_FIELD(field, ...)                              \
    switch (field) {                                         \
        case 0: { constexpr int F = 0; __VA_ARGS__; } break; \
        case 1: { constexpr int F = 1; __VA_ARGS__; } break; \
        case 2: { constexpr int F = 2; __VA_ARGS__; } break; \
        default: return (int)cudaErrorInvalidValue;          \
    }

// field: 0 = BN254 Fq, 1 = BN254 Fr, 2 = BLS12-381 Fr. a, b, out: (8, n)
// words. Every launcher returns cudaGetLastError.
extern "C" int zt_mont_mul(int field, const void* a, const void* b, void* out,
                           long n, void* stream) {
    if (n <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    ZT_BY_FIELD(field, mont_mul_kernel<F><<<blocks_for(n), kThreads, 0, s>>>(
                           (const u32*)a, (const u32*)b, (u32*)out, n));
    return (int)cudaGetLastError();
}

// BN254 Fr only. x, out: (8, n) words; rc: (rounds, 8) words, row-major.
extern "C" int zt_mimc_permute(const void* x, const void* rc, void* out,
                               long n, int rounds, void* stream) {
    if (n <= 0) return 0;
    mimc_permute_kernel<<<blocks_for(n), kThreads, rounds * 8 * sizeof(u32),
                          (cudaStream_t)stream>>>(
        (const u32*)x, (const u32*)rc, (u32*)out, n, rounds);
    return (int)cudaGetLastError();
}

// a, prefix: (8, n) words, n a multiple of 1024; totals: (8, chains) words,
// chains = 1024 * ceil(n / 16384). a must be 16-byte aligned (the staging
// copies 16 bytes). mapping: 0 = chosen from n (the path's), 1 = a thread a
// chain, 2 = the scan; 1 and 2 let a measurement time both mappings at one
// n. A zero in a counts as one (see zero_as_one).
extern "C" int zt_inv_fwd(int field, const void* a, void* prefix,
                          void* totals, long n, int mapping, void* stream) {
    if (n <= 0) return 0;
    if ((uintptr_t)a & 15) return (int)cudaErrorMisalignedAddress;
    long chains = (n + kInvTile - 1) / kInvTile * kInvBlock;
    if (mapping == 0) mapping = chains >= kFwdScanBelow ? 1 : 2;
    cudaStream_t s = (cudaStream_t)stream;
    const u32* pa = (const u32*)a;
    if (mapping == 1) {
        const unsigned blocks = (unsigned)(chains / kFwdChains);
        ZT_BY_FIELD(field, inv_fwd_kernel<F><<<blocks, kFwdChains, 0, s>>>(
                               pa, (u32*)prefix, (u32*)totals, n, chains));
    } else if (mapping == 2) {
        const unsigned blocks = (unsigned)(chains / kScanChains);
        const unsigned threads = scan_threads(n) * kScanChains;
        ZT_BY_FIELD(field, inv_fwd_scan_kernel<F><<<blocks, threads, 0, s>>>(
                               pa, (u32*)prefix, (u32*)totals, n, chains));
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

// a, prefix, out: (8, n) words; tinv: (8, chains) inverses of the totals.
// a and prefix must be 16-byte aligned (the staging copies 16 bytes).
// mapping: 0 = chosen from n (the path's), 1 = two threads a chain, 2 = the
// scan. Zero in out where a is zero (see zero_as_one).
extern "C" int zt_inv_bwd(int field, const void* a, const void* prefix,
                          const void* tinv, void* out, long n, int mapping,
                          void* stream) {
    if (n <= 0) return 0;
    if (((uintptr_t)a | (uintptr_t)prefix) & 15)
        return (int)cudaErrorMisalignedAddress;
    long chains = (n + kInvTile - 1) / kInvTile * kInvBlock;
    if (mapping == 0) mapping = chains >= kBwdScanBelow ? 1 : 2;
    cudaStream_t s = (cudaStream_t)stream;
    const u32 *pa = (const u32*)a, *pp = (const u32*)prefix,
              *pt = (const u32*)tinv;
    if (mapping == 1) {
        const unsigned blocks = (unsigned)(chains / kBwdChains);
        ZT_BY_FIELD(field, inv_bwd_kernel<F><<<blocks, 2 * kBwdChains, 0, s>>>(
                               pa, pp, pt, (u32*)out, n, chains));
    } else if (mapping == 2) {
        const unsigned blocks = (unsigned)(chains / kScanChains);
        const unsigned threads = scan_threads(n) * kScanChains;
        ZT_BY_FIELD(field, inv_bwd_scan_kernel<F><<<blocks, threads, 0, s>>>(
                               pa, pp, pt, (u32*)out, n, chains));
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

// The launchers' thresholds in chains (bwd = 0: zt_inv_fwd's, 1:
// zt_inv_bwd's): mapping 0 runs the scan below them. A measurement reads
// them here to name the mapping the path takes.
extern "C" int zt_inv_scan_below(int bwd) {
    return (int)(bwd ? kBwdScanBelow : kFwdScanBelow);
}

// a, out: (8, n) words, any n.
extern "C" int zt_inv_base(int field, const void* a, void* out, long n,
                           void* stream) {
    if (n <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    const unsigned blocks = (unsigned)((n + 31) / 32);
    ZT_BY_FIELD(field, inv_base_kernel<F><<<blocks, 32, 0, s>>>(
                           (const u32*)a, (u32*)out, n));
    return (int)cudaGetLastError();
}
