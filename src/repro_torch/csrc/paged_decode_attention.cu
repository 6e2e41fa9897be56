// Paged decode attention for Hopper (sm_90a), fp32 or int8 page pools.
//
// Replaces the Pallas TPU kernel `paged_decode_attention` in
// src/repro/kernels/paged_decode_attention.py (`_kernel_vmem` and
// `_kernel_hbm`, sharing `_softmax_update` and `_finish`).  It computes
// exactly what that kernel computes: one new query token per sequence b
// attends the first seq_lens[b] slots of the pages named by
// block_tables[b], with an online softmax at scale 1/sqrt(D).  A -1 table
// entry is clamped to page 0 and masked; masked scores are -1e30, not
// -inf, so a row with no valid slot (seq_len 0) returns the uniform mean
// of V over every gathered slot, as the TPU kernel and its reference do.
// int8 pages are dequantized on load as x * scale / 127, one scale per
// (kv head, page).
//
// Bound: memory.  Each (b, g) reads its K and V pages once and does 4*r*D
// flops per slot it reads (r = H/KV query heads per kv head), far below
// the card's ~20 flops per byte for fp32 without tensor cores.  The least
// time is the K and V bytes of the pages the rows need, over 3.35 TB/s.
//
// Design (simple first): one thread block of 128 threads per (b, g).  A
// loop over the row's pages takes the place of the TPU's sequential grid:
// each iteration stages one [block, D] page of K and of V in shared memory
// as fp32 (int8 dequantized on load; K rows padded by one float so that the
// score loop reads distinct banks), computes the r x block scores, updates
// each query row's running max and sum (one warp per row), and adds P @ V
// into an fp32 [r, D] accumulator held in registers.  Pages past a row's
// seq_len contribute exactly zero once the row has a valid slot, so the
// loop stops there; a row with no valid slot walks all nb pages to give
// the uniform mean.  No tensor cores, no TF32.
//
// Known limit: B*KV blocks under-fill the 132 SMs at small batch, and one
// block walks its pages without overlapping the next page's load with the
// current page's arithmetic.  Splitting a row's pages over several blocks
// with a log-sum-exp combine, and a cp.async/TMA ring, are later work.
//
// C interface (bound with ctypes): pda_launch returns the cudaError_t of
// the launch, 0 on success.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxAcc = 16;            // r * D <= kMaxAcc * kThreads = 2048
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Stage one [block, D] page into shared memory as fp32.  `row_stride` is the
// shared-memory stride between slots (D or D + 1).
__device__ __forceinline__ void stage_page(const float* __restrict__ src,
                                           float mul, float* dst, int block,
                                           int D, int row_stride) {
  (void)mul;
  const int n4 = block * D / 4;
  const float4* s4 = reinterpret_cast<const float4*>(src);
  for (int i = threadIdx.x; i < n4; i += kThreads) {
    const float4 x = s4[i];
    const int e = 4 * i;
    const int t = e / D, d = e % D;
    float* o = dst + t * row_stride + d;
    o[0] = x.x; o[1] = x.y; o[2] = x.z; o[3] = x.w;
  }
}

__device__ __forceinline__ void stage_page(const int8_t* __restrict__ src,
                                           float mul, float* dst, int block,
                                           int D, int row_stride) {
  const int n4 = block * D / 4;
  const char4* s4 = reinterpret_cast<const char4*>(src);
  for (int i = threadIdx.x; i < n4; i += kThreads) {
    const char4 x = s4[i];
    const int e = 4 * i;
    const int t = e / D, d = e % D;
    float* o = dst + t * row_stride + d;
    o[0] = static_cast<float>(x.x) * mul;
    o[1] = static_cast<float>(x.y) * mul;
    o[2] = static_cast<float>(x.z) * mul;
    o[3] = static_cast<float>(x.w) * mul;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_attention_kernel(const float* __restrict__ q,
                              const T* __restrict__ k_pages,
                              const T* __restrict__ v_pages,
                              const float* __restrict__ k_scales,
                              const float* __restrict__ v_scales,
                              const int32_t* __restrict__ tables,
                              const int32_t* __restrict__ seq_lens,
                              float* __restrict__ out, int H, int KV, int N,
                              int block, int D, int nb, float scale) {
  extern __shared__ float smem[];
  const int r = H / KV;
  const int b = blockIdx.x / KV;
  const int g = blockIdx.x % KV;
  const int kstride = D + 1;
  float* k_s = smem;                           // [block, D + 1]
  float* v_s = k_s + block * kstride;          // [block, D]
  float* q_s = v_s + block * D;                // [r, D]
  float* p_s = q_s + r * D;                    // [r, block]
  float* m_s = p_s + r * block;                // [r] running max
  float* l_s = m_s + r;                        // [r] running sum
  float* a_s = l_s + r;                        // [r] this page's rescale

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const float* qb = q + (static_cast<int64_t>(b) * H + g * r) * D;
  for (int i = tid; i < r * D; i += kThreads) q_s[i] = qb[i];
  for (int i = tid; i < r; i += kThreads) {
    m_s[i] = kNegInf;
    l_s[i] = 0.f;
  }

  const int seq_len = max(seq_lens[b], 0);
  const int32_t* tb = tables + static_cast<int64_t>(b) * nb;
  const int n_need = min((seq_len + block - 1) / block, nb);
  int any = 0;
  for (int j = tid; j < n_need; j += kThreads) any |= (tb[j] >= 0);
  any = __syncthreads_or(any);
  const int n_iter = any ? n_need : nb;

  float acc[kMaxAcc];
#pragma unroll
  for (int a = 0; a < kMaxAcc; ++a) acc[a] = 0.f;

  const int64_t page_elems = static_cast<int64_t>(block) * D;
  for (int j = 0; j < n_iter; ++j) {
    const int blk = tb[j];
    const int page = min(max(blk, 0), N - 1);
    const int64_t off = (static_cast<int64_t>(g) * N + page) * page_elems;
    float kmul = 1.f, vmul = 1.f;
    if (k_scales != nullptr) {
      kmul = k_scales[g * N + page] / 127.0f;
      vmul = v_scales[g * N + page] / 127.0f;
    }
    __syncthreads();                           // previous page fully used
    stage_page(k_pages + off, kmul, k_s, block, D, kstride);
    stage_page(v_pages + off, vmul, v_s, block, D, D);
    __syncthreads();

    // scores s[i, t] = (q_i . k_t) * scale, masked to -1e30
    for (int idx = tid; idx < r * block; idx += kThreads) {
      const int i = idx / block, t = idx % block;
      const float* qi = q_s + i * D;
      const float* kt = k_s + t * kstride;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(qi[d], kt[d], s);
      const int pos = j * block + t;
      const bool valid = (pos < seq_len) && (blk >= 0);
      p_s[idx] = valid ? s * scale : kNegInf;
    }
    __syncthreads();

    // online softmax: one warp per query row
    for (int i = warp; i < r; i += kWarps) {
      float* pi = p_s + i * block;
      float mx = kNegInf;
      for (int t = lane; t < block; t += 32) mx = fmaxf(mx, pi[t]);
      mx = warp_max(mx);
      const float m_prev = m_s[i];
      const float m_cur = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < block; t += 32) {
        const float p = expf(pi[t] - m_cur);
        pi[t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_cur);
        a_s[i] = alpha;
        l_s[i] = l_s[i] * alpha + sum;
        m_s[i] = m_cur;
      }
    }
    __syncthreads();

    // acc[i, d] = acc[i, d] * alpha_i + sum_t p[i, t] * v[t, d]
#pragma unroll
    for (int a = 0; a < kMaxAcc; ++a) {
      const int idx = tid + a * kThreads;
      if (idx < r * D) {
        const int i = idx / D, d = idx % D;
        const float* pi = p_s + i * block;
        float pv = 0.f;
        for (int t = 0; t < block; ++t) pv = fmaf(pi[t], v_s[t * D + d], pv);
        acc[a] = acc[a] * a_s[i] + pv;
      }
    }
  }
  __syncthreads();

  float* ob = out + (static_cast<int64_t>(b) * H + g * r) * D;
#pragma unroll
  for (int a = 0; a < kMaxAcc; ++a) {
    const int idx = tid + a * kThreads;
    if (idx < r * D) {
      const float l = l_s[idx / D];
      ob[idx] = acc[a] / (l == 0.f ? 1.f : l);
    }
  }
}

size_t smem_bytes(int r, int block, int D) {
  return sizeof(float) *
         (static_cast<size_t>(block) * (D + 1) + static_cast<size_t>(block) * D +
          static_cast<size_t>(r) * D + static_cast<size_t>(r) * block + 3 * r);
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* k_scales, const void* v_scales, const void* tables,
           const void* seq_lens, void* out, int B, int H, int KV, int N,
           int block, int D, int nb, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(H / KV, block, D);
  auto kernel = paged_decode_attention_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B * KV, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const float*>(k_scales),
      static_cast<const float*>(v_scales),
      static_cast<const int32_t*>(tables),
      static_cast<const int32_t*>(seq_lens), static_cast<float*>(out), H, KV,
      N, block, D, nb, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory one block needs, so that the wrapper can refuse a shape
// that does not fit before it launches.
size_t pda_smem_bytes(int r, int block, int D) { return smem_bytes(r, block, D); }

// quantized == 0: fp32 pools, k_scales/v_scales ignored (may be null).
// quantized == 1: int8 pools with fp32 scales [KV, N].
int pda_launch(int quantized, const void* q, const void* k_pages,
               const void* v_pages, const void* k_scales,
               const void* v_scales, const void* tables, const void* seq_lens,
               void* out, int B, int H, int KV, int N, int block, int D,
               int nb, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (quantized)
    return launch<int8_t>(q, k_pages, v_pages, k_scales, v_scales, tables,
                          seq_lens, out, B, H, KV, N, block, D, nb, scale, s);
  return launch<float>(q, k_pages, v_pages, nullptr, nullptr, tables,
                       seq_lens, out, B, H, KV, N, block, D, nb, scale, s);
}

}  // extern "C"
