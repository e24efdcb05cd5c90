// A CPU stand-in for the CUDA runtime, for tests/test_torch_cuda_emulation.py:
// it lets g++ build the port's kernels (zelana_tpu_torch/csrc) and run them
// on host memory. Each CUDA thread of a block is a fiber (ucontext) on the
// calling thread; the blocks of a launch run one after another, and
// __syncthreads() switches to the next fiber, so one round over the block's
// fibers brings every thread to the same barrier (the kernels' barriers are
// uniform; the order of the fibers alternates between rounds). __shared__
// arrays are static: one copy, which the sequential blocks share. The test
// rewrites each kernel<<<grid, block, bytes, stream>>>(args) into
// emu_launch(grid, block, bytes, stream, [&]{ kernel(args); }) and
// field.cuh's PTX primitives into the C++ below: the carry flag in emu_cf
// (no chain spans a barrier), and each thread's asynchronous copies held
// back until a wait_group releases their group, so a copy read before its
// wait and barrier reads stale shared memory.
#pragma once
#include <ucontext.h>

#include <cstdint>
#include <cstring>
#include <functional>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__ static
#define __constant__ static
#define __launch_bounds__(...)
#define __restrict__
#define __align__(n) __attribute__((aligned(n)))

struct emu_dim3 {
    unsigned x = 0, y = 0, z = 0;
};
inline emu_dim3 threadIdx, blockIdx, blockDim, gridDim;

typedef void* cudaStream_t;
typedef int cudaError_t;
enum {
    cudaSuccess = 0,
    cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
    cudaFuncAttributePreferredSharedMemoryCarveout = 9,
    cudaSharedmemCarveoutMaxShared = 100,
    cudaErrorInvalidValue = 1,
    cudaErrorMisalignedAddress = 716
};
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaGetDevice(int* dev) {
    *dev = 0;
    return cudaSuccess;
}
template <class F>
cudaError_t cudaFuncSetAttribute(F, int, int) {
    return cudaSuccess;
}

inline unsigned __umulhi(unsigned a, unsigned b) {
    return (unsigned)(((unsigned long long)a * b) >> 32);
}

inline unsigned __brev(unsigned x) {  // bit 31 - i of x in bit i
    unsigned r = 0;
    for (int i = 0; i < 32; ++i) r |= ((x >> i) & 1u) << (31 - i);
    return r;
}

inline std::vector<uint32_t> emu_dyn;  // the launch's dynamic shared memory
inline uint32_t emu_cf;                // the PTX carry flag (CC.CF)

struct emu_copy {
    void* dst;
    const void* src;
};
struct emu_async {  // one thread's cp.async state
    std::vector<emu_copy> open;                 // not yet committed
    std::vector<std::vector<emu_copy>> groups;  // committed, oldest first
};
inline std::vector<emu_async> emu_asyncs;  // per thread of the block

inline ucontext_t emu_sched;
inline std::vector<ucontext_t> emu_fibers;
inline std::vector<std::vector<char>> emu_stacks;
inline unsigned emu_cur;
inline bool emu_done;
inline const std::function<void()>* emu_fn;

inline void __syncthreads() {
    swapcontext(&emu_fibers[emu_cur], &emu_sched);
}

// the OR of the block's predicates at this barrier: each fiber adds its
// own before it yields, and the round's OR is published when the round
// ends, before any fiber resumes
inline int emu_or_acc, emu_or_res;
inline int __syncthreads_or(int pred) {
    emu_or_acc |= pred != 0;
    __syncthreads();
    return emu_or_res;
}

inline void emu_entry() {
    (*emu_fn)();
    emu_done = true;  // uc_link returns to emu_sched
}

inline void emu_launch(unsigned grid, unsigned block, int bytes,
                       cudaStream_t, const std::function<void()>& fn) {
    gridDim.x = grid;
    blockDim.x = block;
    emu_fn = &fn;
    emu_dyn.assign(bytes / 4 + 1, 0xdeadbeefu);
    emu_fibers.resize(block);
    emu_stacks.resize(block);
    for (auto& st : emu_stacks) st.resize(1 << 16);
    for (unsigned b = 0; b < grid; ++b) {
        blockIdx.x = b;
        emu_asyncs.assign(block, {});
        std::vector<char> finished(block, 0);
        emu_or_acc = emu_or_res = 0;
        for (unsigned t = 0; t < block; ++t) {
            getcontext(&emu_fibers[t]);
            emu_fibers[t].uc_stack.ss_sp = emu_stacks[t].data();
            emu_fibers[t].uc_stack.ss_size = emu_stacks[t].size();
            emu_fibers[t].uc_link = &emu_sched;
            makecontext(&emu_fibers[t], emu_entry, 0);
        }
        // between two barriers the fibers run in turn, in thread order on
        // even passes and in reverse on odd ones, so a read that misses a
        // barrier sees the wrong value in one of the two orders
        for (unsigned live = block, pass = 0; live; ++pass) {
            for (unsigned k = 0; k < block; ++k) {
                const unsigned t = pass & 1 ? block - 1 - k : k;
                if (finished[t]) continue;
                emu_cur = t;
                threadIdx.x = t;
                emu_done = false;
                swapcontext(&emu_sched, &emu_fibers[t]);
                if (emu_done) {
                    finished[t] = 1;
                    --live;
                }
            }
            emu_or_res = emu_or_acc;
            emu_or_acc = 0;
        }
    }
}

// field.cuh's ptx:: primitives, flag for flag
namespace emu_ptx {
inline void cp_async16(void* smem, const void* gmem) {
    emu_asyncs[emu_cur].open.push_back({smem, gmem});
}
inline void cp_async_commit() {
    emu_async& a = emu_asyncs[emu_cur];
    a.groups.push_back(std::move(a.open));
    a.open.clear();
}
template <int N>
void cp_async_wait() {
    emu_async& a = emu_asyncs[emu_cur];
    while (a.groups.size() > (size_t)N) {
        for (const emu_copy& c : a.groups.front()) std::memcpy(c.dst, c.src, 16);
        a.groups.erase(a.groups.begin());
    }
}
typedef unsigned long long u64;
inline uint32_t add_cc(uint32_t a, uint32_t b) {
    u64 s = (u64)a + b;
    emu_cf = s >> 32;
    return (uint32_t)s;
}
inline uint32_t addc_cc(uint32_t a, uint32_t b) {
    u64 s = (u64)a + b + emu_cf;
    emu_cf = s >> 32;
    return (uint32_t)s;
}
inline uint32_t addc(uint32_t a, uint32_t b) { return a + b + emu_cf; }
inline uint32_t sub_cc(uint32_t a, uint32_t b) {
    u64 d = (u64)a - b;
    emu_cf = (d >> 32) & 1;
    return (uint32_t)d;
}
inline uint32_t subc_cc(uint32_t a, uint32_t b) {
    u64 d = (u64)a - b - emu_cf;
    emu_cf = (d >> 32) & 1;
    return (uint32_t)d;
}
inline uint32_t subc(uint32_t a, uint32_t b) { return a - b - emu_cf; }
inline uint32_t mad_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
    u64 s = (u64)(uint32_t)((u64)a * b) + c;
    emu_cf = s >> 32;
    return (uint32_t)s;
}
inline uint32_t madc_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
    u64 s = (u64)(uint32_t)((u64)a * b) + c + emu_cf;
    emu_cf = s >> 32;
    return (uint32_t)s;
}
inline uint32_t madc_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
    u64 s = (((u64)a * b) >> 32) + c + emu_cf;
    emu_cf = s >> 32;
    return (uint32_t)s;
}
inline uint32_t madc_hi(uint32_t a, uint32_t b, uint32_t c) {
    return (uint32_t)((((u64)a * b) >> 32) + c + emu_cf);
}
}  // namespace emu_ptx
