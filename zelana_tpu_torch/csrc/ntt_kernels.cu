// The NTT pass kernel: a run of consecutive radix-2 DIT stages [s0, s1) of
// one transform over BN254 Fr, on tiles of up to 2^11 elements held in
// shared memory. A transform of 2^L elements is one launch per pass, the
// split of L into passes picked by ops/ntt.py (default_split: [5, 4, 4] at
// 2^13, [7, 7, 7] at 2^21).
//
// Replaces pallas_field.butterfly_call (one DIT stage a launch, the JAX
// ntt's stage loop) and, on the witness map, pallas_field._mont_mul_call
// (the coset scalings by g^j and g^-j, the scaling by 1/n and the quotient
// (a b - c) / Z on the coset): the first pass applies a pointwise prologue
// as it gathers its inputs, the last pass an epilogue as it stores.
//
//   prologue, at the source index j:  x_j g^j (coset NTT), or
//                                     (a_j b_j - c_j) Z^-1 (the quotient;
//                                     Z^-1 passed by value)
//   epilogue, at the output index j:  y_j n^-1 (iNTT; by value), or
//                                     y_j (n^-1 g^-j) (coset iNTT; a table
//                                     the plan makes once on the device)
//
// Every product, sum and difference is exact and canonical, so any split
// into passes gives the same words as the JAX package's stage-per-launch
// transform, and y (n^-1 g^-j) = (y n^-1) g^-j bit for bit.
//
// Layout. Elements are (8, n) word rows. A pass of k = s1 - s0 stages holds
// 2^(k + c) elements a block in shared memory, word-major ([8][tile], so a
// warp reading one word of neighbouring elements hits distinct banks): the
// 2^k elements one DIT set spans, times 2^c sets that differ in c "spread"
// bits, so that the block's loads and stores run over 2^c neighbouring
// elements of a word row (c = 3: one 32-byte sector). Tile element t = m 2^c
// + l (m: the stage bits, l: the spread bits) of block b sits at position
//
//   first pass (s0 = 0):  m + 2^s1 b + 2^(L - c) l
//   later passes:         l + 2^c (b mod 2^(s0 - c)) + 2^s0 m
//                           + 2^s1 (b >> (s0 - c))
//
// and stage s pairs t with t + 2^(c + s - s0). The first pass reads
// position p from source brev_L(p), the DIT's bit reversal, computed by
// __brev (no device table): the spread bits are the top bits of p, so the
// sources are runs of 2^c neighbours. The first pass reads the inputs and
// writes the output buffer; later passes read and write that buffer in
// place (a block's positions are its own), so the inputs are never written.
// Twiddles come from a stage-major table of the plan, (8, n) words with
// w_{2^(s+1)}^k at column 2^s + k (ops/ntt.py derives it on the device from
// the plan's (8, n/2) table of w^k): a warp's butterflies of one stage read
// neighbouring columns.
//
// What bounds it on an H100: 2^(L-1) butterflies a stage, one Montgomery
// product each (264 32-bit multiplies; stage 0's twiddle is one and its
// product is skipped), against 32 bytes an element read and written once a
// pass, plus the twiddle rows (about n columns a later pass). At 2^21 a
// transform is (21 - 1) x 2^20 products = 0.331 ms of the multiply rate
// against about 0.06 ms of bytes for each of its three passes: bound by the
// operations. (The function needs 19 x 2^20 + 1 of them, 0.314 ms: one
// butterfly in 2^s of stage s multiplies by w^0 = 1, which a warp gains
// nothing by skipping.) At 2^13 (the L2 prove) its 12 x 2^12 products are 0.0008 ms of
// the rate, but every element sits on a chain of 13 dependent products and
// three launches: bound by latency. Small tiles there (2^8 and 2^7
// elements: 32 and 64 blocks) beat large ones (PERF.md §6).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libntt_kernels.so ntt_kernels.cu

#include "field.cuh"

constexpr int kNttTileBits = 11;  // 2^11 elements: 64 KB of shared memory
constexpr int kNttSpread = 3;     // 8 neighbours: a 32-byte sector a row
constexpr int kNttThreads = 256;

enum { kProNone = 0, kProCoset = 1, kProQuotient = 2 };
enum { kEpiNone = 0, kEpiScalar = 1, kEpiTable = 2 };

struct NttShape {
    int L, s0, s1, c;  // log2 n, the stages [s0, s1), the spread bits
};

// the low `bits` bits of x in reverse order
__device__ __forceinline__ u32 brev_bits(u32 x, int bits) {
    return bits ? __brev(x) >> (32 - bits) : 0u;
}

// the position of tile element t of block b (see the layout above)
__device__ __forceinline__ long ntt_pos(const NttShape& P, long b, int t) {
    const int l = t & ((1 << P.c) - 1), m = t >> P.c;
    if (P.s0 == 0) return m + (b << P.s1) + ((long)l << (P.L - P.c));
    const int lo = P.s0 - P.c;
    return l + ((b & ((1L << lo) - 1)) << P.c) + ((long)m << P.s0)
           + ((b >> lo) << P.s1);
}

__device__ __forceinline__ Fr tile_load(const u32* tile, int T, int t) {
    Fr r;
#pragma unroll
    for (int j = 0; j < 8; ++j) r.w[j] = tile[j * T + t];
    return r;
}

__device__ __forceinline__ void tile_store(u32* tile, int T, int t,
                                           const Fr& v) {
#pragma unroll
    for (int j = 0; j < 8; ++j) tile[j * T + t] = v.w[j];
}

// x: the input (first pass) or the output buffer (later passes, in place:
// x == out); y, z: the quotient's b and c; ptab: g^j; etab: n^-1 g^-j
__global__ void __launch_bounds__(kNttThreads)
    ntt_pass_kernel(const u32* x, const u32* __restrict__ y,
                    const u32* __restrict__ z, u32* out,
                    const u32* __restrict__ twst,
                    const u32* __restrict__ ptab,
                    const u32* __restrict__ etab, Fr pk, Fr ek, long n,
                    NttShape P, int pro, int epi) {
    extern __shared__ u32 tile[];
    const int k = P.s1 - P.s0, T = 1 << (k + P.c);
    const long b = blockIdx.x;
    const bool first = P.s0 == 0;
    for (int v = threadIdx.x; v < T; v += blockDim.x) {
        int t = v;
        long src;
        if (first) {
            // v walks the sources in order: its low c bits are the
            // sources' low bits (l reversed), the rest m reversed
            const u32 u = v & ((1 << P.c) - 1), q = v >> P.c;
            t = (int)(brev_bits(q, k) << P.c | brev_bits(u, P.c));
            src = brev_bits((u32)ntt_pos(P, b, t), P.L);
        } else {
            src = ntt_pos(P, b, t);
        }
        Fr e = load<1>(x, n, src);
        if (pro == kProQuotient)
            e = sub(mul(e, load<1>(y, n, src)), load<1>(z, n, src));
        if (pro != kProNone)
            e = mul(e, pro == kProCoset ? load<1>(ptab, n, src) : pk);
        tile_store(tile, T, t, e);
    }
    __syncthreads();
#pragma unroll 1
    for (int s = P.s0; s < P.s1; ++s) {
        const int r = P.c + s - P.s0;
        const long half = 1L << s;
        for (int j = threadIdx.x; j < T / 2; j += blockDim.x) {
            const int lo = (j >> r << (r + 1)) | (j & ((1 << r) - 1));
            const int hi = lo + (1 << r);
            const Fr a = tile_load(tile, T, lo);
            Fr wb = tile_load(tile, T, hi);
            if (s > 0) {  // stage 0's twiddle is one
                const long tk = ntt_pos(P, b, lo) & (half - 1);
                wb = mul(wb, load<1>(twst, n, half + tk));
            }
            tile_store(tile, T, lo, add(a, wb));
            tile_store(tile, T, hi, sub(a, wb));
        }
        __syncthreads();
    }
    const bool scale = P.s1 == P.L && epi != kEpiNone;
    for (int v = threadIdx.x; v < T; v += blockDim.x) {
        // the first pass's positions run along m, the others' along l
        const int t = first ? (v & ((1 << k) - 1)) << P.c | v >> k : v;
        const long p = ntt_pos(P, b, t);
        Fr e = tile_load(tile, T, t);
        if (scale) e = mul(e, epi == kEpiScalar ? ek : load<1>(etab, n, p));
        store<1>(out, n, p, e);
    }
}

// the spread bits of pass [s0, s1) of a 2^L transform, or -1 if its stages
// do not fit a tile
static int ntt_spread(int L, int s0, int s1) {
    const int k = s1 - s0;
    if (k > kNttTileBits) return -1;
    int c = s0 == 0 ? L - s1 : s0;
    c = c < kNttSpread ? c : kNttSpread;
    return c < kNttTileBits - k ? c : kNttTileBits - k;
}

static Fr words_or_zero(const void* w) {
    Fr r;
    for (int j = 0; j < 8; ++j) r.w[j] = w ? ((const u32*)w)[j] : 0u;
    return r;
}

// Stages [s0, s1) of a transform of n = 2^L elements, (8, n) words each.
// x: the input (s0 = 0; never written) or the output buffer (s0 > 0, then
// x == out: the pass runs in place). twst: the (8, n) stage-major twiddle
// table. pro (s0 = 0 only): 0 none, 1 x g^j with g^j from ptab, 2 (x y - z)
// pk, pk 8 host words. epi (s1 = L only): 0 none, 1 times ek (8 host
// words), 2 times etab. Returns cudaGetLastError, or cudaErrorInvalidValue
// for a shape or an operand the pass does not take.
extern "C" int zt_ntt_pass(const void* x, const void* y, const void* z,
                           void* out, const void* twst, const void* ptab,
                           const void* etab, const void* pk, const void* ek,
                           long n, int s0, int s1, int pro, int epi,
                           void* stream) {
    int L = 0;
    while (L < 31 && (1L << L) < n) ++L;
    const int c = ntt_spread(L, s0, s1);
    const bool bad_shape = n < 2 || (1L << L) != n || L > 30 || s0 < 0 ||
                           s1 <= s0 || s1 > L || c < 0;
    const bool bad_pro = pro < 0 || pro > 2 || (pro && s0) ||
                         (pro == kProCoset && !ptab) ||
                         (pro == kProQuotient && (!y || !z || !pk));
    const bool bad_epi = epi < 0 || epi > 2 || (epi && s1 != L) ||
                         (epi == kEpiScalar && !ek) ||
                         (epi == kEpiTable && !etab);
    if (bad_shape || bad_pro || bad_epi || !x || !out || !twst)
        return (int)cudaErrorInvalidValue;
    const int T = 1 << (s1 - s0 + c);
    const unsigned threads = T / 2 < kNttThreads ? T / 2 : kNttThreads;
    const unsigned blocks = (unsigned)(n / T);
    const int bytes = 8 * T * (int)sizeof(u32);
    if (bytes > 48 * 1024)
        cudaFuncSetAttribute(ntt_pass_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
    const NttShape P = {L, s0, s1, c};
    ntt_pass_kernel<<<blocks, threads, bytes, (cudaStream_t)stream>>>(
        (const u32*)x, (const u32*)y, (const u32*)z, (u32*)out,
        (const u32*)twst, (const u32*)ptab, (const u32*)etab,
        words_or_zero(pk), words_or_zero(ek), n, P, pro, epi);
    return (int)cudaGetLastError();
}
