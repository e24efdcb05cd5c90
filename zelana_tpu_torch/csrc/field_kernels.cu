// Elementwise BN254 field kernels of the witness map: the Montgomery
// multiply and the radix-2 butterfly stage.
//
// mont_mul replaces pallas_field._mont_mul_call / mont_mul_pallas (reached
// through limbs.mont_mul); butterfly replaces pallas_field.butterfly_call
// (one DIT stage of ntt._ntt_core).
//
// What bounds them on an H100: a 256-bit CIOS multiply is ~264 32-bit
// integer multiply instructions for 96 bytes of traffic (mont_mul) or 160
// (butterfly), so on paper both sit near the balance of the integer
// multiply rate and HBM bandwidth (PERF.md has the numbers). Design: one
// thread per element, the element's 8 words held in registers, word rows
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

static const int kThreads = 256;

static unsigned blocks_for(long n) {
    return (unsigned)((n + kThreads - 1) / kThreads);
}

// field: 0 = Fq, 1 = Fr. a, b, out: (8, n) words. Returns cudaGetLastError.
extern "C" int zt_mont_mul(int field, const void* a, const void* b, void* out,
                           long n, void* stream) {
    if (n <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    const u32* pa = (const u32*)a;
    const u32* pb = (const u32*)b;
    if (field == 0)
        mont_mul_kernel<0><<<blocks_for(n), kThreads, 0, s>>>(pa, pb,
                                                             (u32*)out, n);
    else
        mont_mul_kernel<1><<<blocks_for(n), kThreads, 0, s>>>(pa, pb,
                                                             (u32*)out, n);
    return (int)cudaGetLastError();
}

// a, b, tw, even, odd: (8, m) words, m butterflies.
extern "C" int zt_butterfly(int field, const void* a, const void* b,
                            const void* tw, void* even, void* odd, long m,
                            void* stream) {
    if (m <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    if (field == 0)
        butterfly_kernel<0><<<blocks_for(m), kThreads, 0, s>>>(
            (const u32*)a, (const u32*)b, (const u32*)tw, (u32*)even,
            (u32*)odd, m);
    else
        butterfly_kernel<1><<<blocks_for(m), kThreads, 0, s>>>(
            (const u32*)a, (const u32*)b, (const u32*)tw, (u32*)even,
            (u32*)odd, m);
    return (int)cudaGetLastError();
}
