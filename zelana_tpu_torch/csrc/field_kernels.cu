// Elementwise and chained field kernels: the Montgomery multiply, the
// radix-2 butterfly stage, the MiMC-91 permutation and the three pieces of
// Montgomery batch inversion.
//
// mont_mul replaces pallas_field._mont_mul_call / mont_mul_pallas (reached
// through limbs.mont_mul); butterfly replaces pallas_field.butterfly_call
// (one DIT stage of ntt._ntt_core); mimc_permute replaces
// pallas_field.mimc_permute_call; inv_fwd, inv_bwd and fermat replace
// _inv_fwd_call, _inv_bwd_call and _fermat_call (batch_inv_pallas).
//
// What bounds them on an H100: a 256-bit CIOS multiply is ~264 32-bit
// integer multiply instructions for 96 bytes of traffic (mont_mul) or 160
// (butterfly), so on paper both sit near the balance of the integer
// multiply rate and HBM bandwidth (PERF.md has the numbers). mimc_permute
// does 364 multiplies per 64 bytes and fermat about 380: both are bound by
// the multiply rate. inv_fwd / inv_bwd do one or two multiplies per element
// moved and are bound by bytes. Design: one thread per element (per chain
// for inv_fwd / inv_bwd), the element's 8 words held in registers, word rows
// of the (8, N) words-first layout read and written coalesced across the
// warp, the ragged edge masked (no padding to a tile multiple).
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

// from the inverse s of the chain's total, downwards: out_i = s * prefix_i,
// then s <- s * a_i
template <int F>
__global__ void inv_bwd_kernel(const u32* __restrict__ a,
                               const u32* __restrict__ prefix,
                               const u32* __restrict__ tinv,
                               u32* __restrict__ out, long n, long chains) {
    long g = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (g >= chains) return;
    long t = g / kInvBlock;
    long base = t * kInvTile + g % kInvBlock;
    int len = chain_len(n, t);
    Fp<F> s = load<F>(tinv, chains, g);
#pragma unroll 1
    for (int i = len - 1; i >= 0; --i) {
        long idx = base + i * kInvBlock;
        store<F>(out, n, idx, mul(s, load<F>(prefix, n, idx)));
        s = mul(s, load<F>(a, n, idx));
    }
}

// a^(p - 2) by left-to-right square-and-multiply; inv(0) = 0. The exponent
// is the field's constant, so the branch on each bit is uniform across the
// warp. Each thread runs ~380 dependent products, so the time is the issue
// rate of the warps sharing a scheduler: the launcher gives each block one
// warp, so that the 1,024-element recursion base spreads over 32 SMs (with
// 256-thread blocks it sat on four).
template <int F>
__global__ void fermat_kernel(const u32* __restrict__ a,
                              u32* __restrict__ out, long n) {
    long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const u32 two[8] = {2, 0, 0, 0, 0, 0, 0, 0};
    u32 e[8];
    sub256(e, kP[F], two);
    int top = 255;
    while (!((e[top >> 5] >> (top & 31)) & 1)) --top;
    Fp<F> x = load<F>(a, n, i);
    Fp<F> acc = x;
#pragma unroll 1
    for (int b = top - 1; b >= 0; --b) {
        acc = mul(acc, acc);
        if ((e[b >> 5] >> (b & 31)) & 1) acc = mul(acc, x);
    }
    store<F>(out, n, i, acc);
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
extern "C" int zt_inv_bwd(int field, const void* a, const void* prefix,
                          const void* tinv, void* out, long n, void* stream) {
    if (n <= 0) return 0;
    long chains = (n + kInvTile - 1) / kInvTile * kInvBlock;
    cudaStream_t s = (cudaStream_t)stream;
    ZT_BY_FIELD(field, inv_bwd_kernel<F><<<blocks_for(chains), kThreads, 0,
                                           s>>>(
                           (const u32*)a, (const u32*)prefix,
                           (const u32*)tinv, (u32*)out, n, chains));
    return (int)cudaGetLastError();
}

// a, out: (8, n) words, any n.
extern "C" int zt_fermat(int field, const void* a, void* out, long n,
                         void* stream) {
    if (n <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    const unsigned blocks = (unsigned)((n + 31) / 32);
    ZT_BY_FIELD(field, fermat_kernel<F><<<blocks, 32, 0, s>>>(
                           (const u32*)a, (u32*)out, n));
    return (int)cudaGetLastError();
}
