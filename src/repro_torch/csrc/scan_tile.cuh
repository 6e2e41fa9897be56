// The pieces shared by the Mamba-1 scan's forward kernel (mamba_scan.cu)
// and its backward kernel (mamba_scan_bwd.cu) on Hopper (sm_90a): the
// thread layout, the tile of steps that streams through the cp.async ring
// (the backward kernel's checkpoint interval is this tile: the forward
// kernel writes a checkpoint at the start of each), and the copy and
// exponential instructions.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace scan {

constexpr int kThreads = 128;           // per block
constexpr int kStates = 8;              // states per lane
constexpr int kTT = 16;                 // steps per tile and per checkpoint
constexpr int kStages = 2;              // tiles in the ring
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// `bytes` of `src` -> shared memory, the rest of the `size` bytes zeroed
template <int SIZE>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         int bytes) {
  if constexpr (SIZE == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(bytes) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
                 "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int K>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(K) : "memory");
}

// exp(x ln 2), as both kernels compute exp(dt A) = 2^(dt A log2 e)
__device__ __forceinline__ float ex2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

}  // namespace scan
