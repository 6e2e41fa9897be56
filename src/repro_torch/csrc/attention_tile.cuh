// The CUDA-core pieces of the port's flash attention (B3, its float32 route
// and bf16 at head dims 16 and 32, in flash_attention.cu) for Hopper
// (sm_90a): staging rows of Q, K and V into shared memory as fp32, and one
// online-softmax step over a kv tile.
//
// A block has 128 threads, seen as 16 row groups (ty) by 8 column groups
// (tx).  A query tile has BQ = 16 * RPT rows: thread (ty, tx) owns rows
// ty + 16 i (i < RPT).  A kv tile has BK = 8 * CPT slots: for the scores
// the thread owns slots tx + 8 j (j < CPT), and for the output the
// dimensions tx + 8 d (d < D / 8) of its rows.  Each row's running max m
// and sum l live in registers, the same in the 8 threads of a row group,
// which reduce across each other with warp shuffles.  Shared memory rows
// are padded to D + 4 floats, so that float4 reads of 8 different rows hit
// 32 different banks.
//
// Masking keeps the TPU kernels' semantics: a masked score is -1e30, not
// -inf, so a row whose slots are all masked averages V uniformly; a slot
// past the end of the sequence is -inf and contributes exactly nothing.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn {

constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

enum : int { kMasked = 0, kValid = 1, kOutside = 2 };

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ void unpack(const uint4& x, float* o, const float*) {
  o[0] = __uint_as_float(x.x);
  o[1] = __uint_as_float(x.y);
  o[2] = __uint_as_float(x.z);
  o[3] = __uint_as_float(x.w);
}

__device__ __forceinline__ void unpack(const uint4& x, float* o,
                                       const __nv_bfloat16*) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    o[2 * j] = f.x;
    o[2 * j + 1] = f.y;
  }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Copy NROWS rows of D elements (row r at src + r * stride) into dst as
// fp32 with a row pitch of D + 4; rows >= n_valid become zeros.  16-byte
// loads, up to 8 in flight per thread before they are stored.
template <typename T, int D, int NROWS>
__device__ __forceinline__ void stage_rows(const T* __restrict__ src,
                                           int64_t stride, int n_valid,
                                           float* __restrict__ dst) {
  constexpr int V = 16 / sizeof(T);
  constexpr int CPR = D / V;
  constexpr int TOTAL = NROWS * CPR;
  constexpr int PER = (TOTAL + kThreads - 1) / kThreads;
  constexpr int BATCH = PER < 8 ? PER : 8;
  constexpr int P = D + 4;
#pragma unroll
  for (int b0 = 0; b0 < PER; b0 += BATCH) {
    uint4 buf[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int c = threadIdx.x + (b0 + u) * kThreads;
      const int row = c / CPR, col = (c % CPR) * V;
      buf[u] = make_uint4(0u, 0u, 0u, 0u);
      if (c < TOTAL && row < n_valid)
        buf[u] = *reinterpret_cast<const uint4*>(src + row * stride + col);
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int c = threadIdx.x + (b0 + u) * kThreads;
      if (c < TOTAL) {
        const int row = c / CPR, col = (c % CPR) * V;
        float f[V];
        unpack(buf[u], f, static_cast<const T*>(nullptr));
        float4* o = reinterpret_cast<float4*>(dst + row * P + col);
#pragma unroll
        for (int v = 0; v < V / 4; ++v)
          o[v] = make_float4(f[4 * v], f[4 * v + 1], f[4 * v + 2], f[4 * v + 3]);
      }
    }
  }
}

// One kv tile: scores of the thread's rows against the tile's slots, the
// online-softmax update of (m, l, o), and o += P V.  q_s: [BQ][D + 4],
// k_s and v_s: [BK][D + 4], p_s: [BQ][BK + 1] scratch.  mask(row, slot)
// returns kValid, kMasked or kOutside.  Ends after reading p_s and v_s:
// the caller syncs before it overwrites them.
template <int RPT, int CPT, int D, class Mask>
__device__ __forceinline__ void attend_tile(const float* __restrict__ q_s,
                                            const float* __restrict__ k_s,
                                            const float* __restrict__ v_s,
                                            float* __restrict__ p_s,
                                            float (&o)[RPT][D / 8],
                                            float (&m)[RPT], float (&l)[RPT],
                                            float scale, const Mask& mask) {
  constexpr int P = D + 4, BK = 8 * CPT, PP = BK + 1;
  const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;

  float s[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 qv[RPT], kv[CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
      qv[i] = *reinterpret_cast<const float4*>(q_s + (ty + 16 * i) * P + d);
#pragma unroll
    for (int j = 0; j < CPT; ++j)
      kv[j] = *reinterpret_cast<const float4*>(k_s + (tx + 8 * j) * P + d);
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        float a = s[i][j];
        a = fmaf(qv[i].x, kv[j].x, a);
        a = fmaf(qv[i].y, kv[j].y, a);
        a = fmaf(qv[i].z, kv[j].z, a);
        a = fmaf(qv[i].w, kv[j].w, a);
        s[i][j] = a;
      }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = ty + 16 * i;
    float mx = neg_inf();
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int st = mask(row, tx + 8 * j);
      s[i][j] = st == kValid ? s[i][j] * scale
                             : (st == kMasked ? kNegInf : neg_inf());
      mx = fmaxf(mx, s[i][j]);
    }
#pragma unroll
    for (int off = 1; off < 8; off <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(m[i], mx);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const float p = expf(s[i][j] - m_new);
      p_s[row * PP + tx + 8 * j] = p;
      sum += p;
    }
#pragma unroll
    for (int off = 1; off < 8; off <<= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const float alpha = expf(m[i] - m_new);
    l[i] = l[i] * alpha + sum;
    m[i] = m_new;
#pragma unroll
    for (int d = 0; d < D / 8; ++d) o[i][d] *= alpha;
  }
  __syncthreads();

#pragma unroll 4
  for (int t = 0; t < BK; ++t) {
    float p[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) p[i] = p_s[(ty + 16 * i) * PP + t];
#pragma unroll
    for (int d = 0; d < D / 8; ++d) {
      const float vv = v_s[t * P + tx + 8 * d];
#pragma unroll
      for (int i = 0; i < RPT; ++i) o[i][d] = fmaf(p[i], vv, o[i][d]);
    }
  }
}

// Shared memory of one block, in bytes: Q, K and V tiles, P scratch and
// `extra` further bytes.
constexpr size_t smem_bytes(int D, int BQ, int BK, size_t extra) {
  return sizeof(float) * (static_cast<size_t>(BQ + 2 * BK) * (D + 4) +
                          static_cast<size_t>(BQ) * (BK + 1)) + extra;
}

}  // namespace attn
