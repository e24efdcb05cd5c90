// Elementwise and chained field kernels: the Montgomery multiply, the
// radix-2 butterfly stage, the MiMC-91 permutation and the three pieces of
// Montgomery batch inversion.
//
// mont_mul replaces pallas_field._mont_mul_call / mont_mul_pallas (reached
// through limbs.mont_mul); butterfly replaces pallas_field.butterfly_call
// (one DIT stage of ntt._ntt_core); mimc_permute replaces
// pallas_field.mimc_permute_call; inv_fwd, inv_bwd and inv_base replace
// _inv_fwd_call, _inv_bwd_call and _fermat_call (batch_inv_pallas).
//
// What bounds them on an H100: a 256-bit CIOS multiply is ~264 32-bit
// integer multiply instructions for 96 bytes of traffic (mont_mul) or 160
// (butterfly), so on paper both sit near the balance of the integer
// multiply rate and HBM bandwidth (PERF.md has the numbers). mimc_permute
// does 364 multiplies per 64 bytes: bound by the multiply rate. inv_fwd /
// inv_bwd do one or two multiplies per element moved, near the balance
// too. inv_base inverts the recursion's 1,024-element base, which cannot
// fill the card: its time is one thread's dependent chain. Design: one
// thread per element (per chain for inv_fwd; inv_bwd and inv_base below),
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

template <int F>
__global__ void butterfly_kernel(const u32* __restrict__ a,
                                 const u32* __restrict__ b,
                                 const u32* __restrict__ tw,
                                 u32* __restrict__ even,
                                 u32* __restrict__ odd, long m) {
    long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= m) return;
    Fp<F> x = load<F>(a, m, i);
    Fp<F> bt = mul(load<F>(b, m, i), load<F>(tw, m, i));
    store<F>(even, m, i, add(x, bt));
    store<F>(odd, m, i, sub(x, bt));
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

// exclusive prefix products in place of the elements, chain totals at
// 1024 t + c
template <int F>
__global__ void inv_fwd_kernel(const u32* __restrict__ a,
                               u32* __restrict__ prefix,
                               u32* __restrict__ totals, long n, long chains) {
    long g = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (g >= chains) return;
    long t = g / kInvBlock;
    long base = t * kInvTile + g % kInvBlock;
    int len = chain_len(n, t);
    Fp<F> acc = one<F>();
#pragma unroll 1
    for (int i = 0; i < len; ++i) {
        long idx = base + i * kInvBlock;
        Fp<F> x = load<F>(a, n, idx);
        store<F>(prefix, n, idx, acc);
        acc = mul(acc, x);
    }
    store<F>(totals, chains, g, acc);
}

// inv_bwd: from the inverse s of a chain's total, downwards, out_i = s *
// prefix_i, then s <- s * a_i. Two thread mappings, chosen by the launcher
// from n; both stage their chains' a and prefix rows in shared memory by
// asynchronous copies (16 bytes: four neighbouring chains of one word row),
// so no product waits on a load it could have issued earlier.
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

// issue step `e0`'s copies: 2 arrays x 8 word rows x W / 4 chunks of four
// chains, spread over `threads` threads; dst is [array][row][W]
template <int W>
__device__ __forceinline__ void stage_rows(u32 (*dst)[8][W], const u32* a,
                                           const u32* prefix, long n,
                                           long e0, int tid, int threads) {
    for (int u = tid; u < 2 * 8 * (W / 4); u += threads) {
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
            stage_rows<kBwdChains>(ring[k], a, prefix, n, row(k), tid,
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
            stage_rows<kBwdChains>(ring[kn % kBwdStages], a, prefix, n,
                                   row(kn), tid, 2 * kBwdChains);
        ptx::cp_async_commit();
        if (chain_thread) {
            if (k < len) {
#pragma unroll
                for (int j = 0; j < 8; ++j) sbuf[k & 1][j][c] = s.w[j];
                if (k < len - 1)  // s * a_0 is never used
                    s = mul(s, smem_load<F>(ring[k % kBwdStages][0], c));
            }
        } else if (k > 0) {
            const Fp<F> sp = smem_load<F>(sbuf[(k - 1) & 1], c);
            store<F>(out, n, row(k - 1) + c,
                     mul(sp, smem_load<F>(ring[(k - 1) % kBwdStages][1], c)));
        }
    }
}

// Short levels (inv_bwd_scan_kernel, kScanChains chains a block, T threads a
// chain, T >= the chain length L, thread 32 i + c on step i of chain c):
// s_i = w_i ... w_{L-1} with w_{L-1} = the total's inverse and w_i = a_{i+1}
// below, a suffix product that log2(L) rounds of a Hillis-Steele scan in
// shared memory compute; then out_i = s_i * prefix_i. Depth log2(L) + 1
// products instead of 2L, for about twice the products.
constexpr int kScanChains = 32;

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
        stage_rows<kScanChains>(st[k], a, prefix, n, base + k * kInvBlock,
                                threadIdx.x, blockDim.x);
    ptx::cp_async_commit();
    ptx::cp_async_wait<0>();
    __syncthreads();
    Fp<F> x;
    if (i < len - 1)
        x = smem_load<F>(st[i + 1][0], c);
    else if (i == len - 1)
        x = load<F>(tinv, chains, g0 + c);
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
    if (i < len)
        store<F>(out, n, base + (long)i * kInvBlock + c,
                 mul(x, smem_load<F>(st[i][1], c)));
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

// a, b, tw, even, odd: (8, m) words, m butterflies.
extern "C" int zt_butterfly(int field, const void* a, const void* b,
                            const void* tw, void* even, void* odd, long m,
                            void* stream) {
    if (m <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    ZT_BY_FIELD(field, butterfly_kernel<F><<<blocks_for(m), kThreads, 0, s>>>(
                           (const u32*)a, (const u32*)b, (const u32*)tw,
                           (u32*)even, (u32*)odd, m));
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
// chains = 1024 * ceil(n / 16384).
extern "C" int zt_inv_fwd(int field, const void* a, void* prefix,
                          void* totals, long n, void* stream) {
    if (n <= 0) return 0;
    long chains = (n + kInvTile - 1) / kInvTile * kInvBlock;
    cudaStream_t s = (cudaStream_t)stream;
    ZT_BY_FIELD(field, inv_fwd_kernel<F><<<blocks_for(chains), kThreads, 0,
                                           s>>>((const u32*)a, (u32*)prefix,
                                                (u32*)totals, n, chains));
    return (int)cudaGetLastError();
}

// a, prefix, out: (8, n) words; tinv: (8, chains) inverses of the totals.
// a and prefix must be 16-byte aligned (the staging copies 16 bytes).
// mapping: 0 = chosen from n (the path's), 1 = two threads a chain, 2 = the
// scan; 1 and 2 let a measurement time both mappings at one n.
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
        // T threads a chain: 16, or the power of two that covers the one
        // partial tile's chains
        int T = 16;
        if (n < kInvTile) {
            T = 1;
            while (T < n / kInvBlock) T <<= 1;
        }
        const unsigned blocks = (unsigned)(chains / kScanChains);
        ZT_BY_FIELD(field,
                    inv_bwd_scan_kernel<F><<<blocks, T * kScanChains, 0, s>>>(
                        pa, pp, pt, (u32*)out, n, chains));
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
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
