// A CPU stand-in for the CUDA runtime, for tests/test_torch_cuda_emulation.py:
// it lets g++ build the port's point kernels (zelana_tpu_torch/csrc) and run
// them on host memory. Each CUDA thread of a block is a fiber (ucontext) on
// the calling thread; the blocks of a launch run one after another, and
// __syncthreads() switches to the next fiber, so one round over the block's
// fibers brings every thread to the same barrier (the kernels' barriers are
// uniform). __shared__ arrays are static: one copy, which the sequential
// blocks share. The test rewrites each kernel<<<grid, block, bytes,
// stream>>>(args) into emu_launch(grid, block, bytes, stream, [&]{
// kernel(args); }) and field.cuh's PTX carry-chain primitives into the C++
// below (the flag in emu_cf; no chain spans a barrier).
#pragma once
#include <ucontext.h>

#include <cstdint>
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

struct emu_dim3 {
    unsigned x = 0, y = 0, z = 0;
};
inline emu_dim3 threadIdx, blockIdx, blockDim, gridDim;

typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
template <class F>
cudaError_t cudaFuncSetAttribute(F, int, int) {
    return cudaSuccess;
}

inline unsigned __umulhi(unsigned a, unsigned b) {
    return (unsigned)(((unsigned long long)a * b) >> 32);
}

inline std::vector<uint32_t> emu_dyn;  // the launch's dynamic shared memory
inline uint32_t emu_cf;                // the PTX carry flag (CC.CF)

inline ucontext_t emu_sched;
inline std::vector<ucontext_t> emu_fibers;
inline std::vector<std::vector<char>> emu_stacks;
inline unsigned emu_cur;
inline bool emu_done;
inline const std::function<void()>* emu_fn;

inline void __syncthreads() {
    swapcontext(&emu_fibers[emu_cur], &emu_sched);
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
        std::vector<char> finished(block, 0);
        for (unsigned t = 0; t < block; ++t) {
            getcontext(&emu_fibers[t]);
            emu_fibers[t].uc_stack.ss_sp = emu_stacks[t].data();
            emu_fibers[t].uc_stack.ss_size = emu_stacks[t].size();
            emu_fibers[t].uc_link = &emu_sched;
            makecontext(&emu_fibers[t], emu_entry, 0);
        }
        for (unsigned live = block; live;) {
            for (unsigned t = 0; t < block; ++t) {
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
        }
    }
}

// field.cuh's ptx:: primitives, flag for flag
namespace emu_ptx {
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
