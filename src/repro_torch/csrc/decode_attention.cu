// Decode attention over a contiguous (linear or ring) KV cache on Hopper
// (sm_90a), fp32 or bf16 (B2).
//
// Replaces the Pallas TPU kernel `decode_attention_bhd` (its `_kernel`) in
// src/repro/kernels/decode_attention.py.  It computes what that kernel
// computes: the r = H / KV query heads of kv head g, one new token of
// sequence b, attend the S slots of the cache; slot j holds absolute
// position positions[b, j] and is kept iff 0 <= pos < cache_len[b] (and
// pos > cache_len[b] - 1 - window with a window), so slot order does not
// matter and ring caches work.  Scores are scaled by 1/sqrt(D); masked
// scores are -1e30, not -inf, so a row with no kept slot returns the
// uniform mean of V over all S slots, as the TPU kernel and its reference
// do.  fp32 accumulation; the output is in q's type.
//
// Bound: memory.  Each (b, g) reads its K and V slots once and does
// 4 * r * D flops per slot, a few flops per byte, far below the card's
// ~295 bf16 (~20 fp32) flops per byte.  The least time is the K and V
// bytes over 3.35 TB/s.
//
// Design (simple first): one block of 128 threads per (b, g), with the r
// query heads as the rows of a 16- or 48-row tile (r <= 48).  A loop over
// the cache in tiles of 64 slots (32 at D >= 128) takes the place of the
// TPU's sequential grid axis: each iteration stages K and V (16-byte loads,
// several in flight per thread) in shared memory as fp32, marks each slot
// kept, masked or past the end from its position, and runs
// attention_tile.cuh's online-softmax step.  Every slot is visited, since
// positions may put a kept slot anywhere.  No tensor cores.
//
// Layout: q is [B, H, D] and the caches [B, KV, S, D], all with element
// strides given by the caller (last one 1), so the model's [B, S, KV, D]
// cache is read in place; cache_len and positions may have batch stride 0.
//
// Known limit: B * KV blocks under-fill the 132 SMs at small batch, and a
// block does not overlap the next tile's loads with this tile's
// arithmetic.  Splitting S over blocks with a log-sum-exp combine
// (flash-decoding) and a cp.async/TMA ring are later work.
//
// C interface (bound with ctypes): da_launch returns the cudaError_t of the
// launch, 0 on success.

#include "attention_tile.cuh"

namespace {

using attn::kThreads;

struct DaArgs {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* cache_len;
  const int32_t* positions;
  void* out;
  int H, KV, S;
  int64_t q_sb, q_sh, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, cl_sb, pos_sb;
  int window;
  float scale;
};

template <typename T, int D, int RPT, int CPT>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const DaArgs a) {
  constexpr int BQ = 16 * RPT, BK = 8 * CPT, P = D + 4, PP = BK + 1;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* k_s = q_s + BQ * P;
  float* v_s = k_s + BK * P;
  float* p_s = v_s + BK * P;
  int* st_s = reinterpret_cast<int*>(p_s + BQ * PP);   // [BK] slot state

  const int b = blockIdx.x / a.KV, g = blockIdx.x % a.KV;
  const int r = a.H / a.KV;
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + g * r * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + g * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + g * a.v_sh;
  const int32_t* pos = a.positions + b * a.pos_sb;
  const int clen = a.cache_len[b * a.cl_sb];
  attn::stage_rows<T, D, BQ>(q, a.q_sh, r, q_s);

  float o[RPT][D / 8], m[RPT], l[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = attn::kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int d = 0; d < D / 8; ++d) o[i][d] = 0.f;
  }

  for (int k0 = 0; k0 < a.S; k0 += BK) {
    __syncthreads();                          // previous tile fully used
    const int nk = min(BK, a.S - k0);
    attn::stage_rows<T, D, BK>(k + k0 * a.k_ss, a.k_ss, nk, k_s);
    attn::stage_rows<T, D, BK>(v + k0 * a.v_ss, a.v_ss, nk, v_s);
    for (int t = threadIdx.x; t < BK; t += kThreads) {
      int st = attn::kOutside;
      if (t < nk) {
        const int p = pos[k0 + t];
        const bool keep = p >= 0 && p < clen &&
                          (a.window <= 0 || p > clen - 1 - a.window);
        st = keep ? attn::kValid : attn::kMasked;
      }
      st_s[t] = st;
    }
    __syncthreads();
    attn::attend_tile<RPT, CPT, D>(q_s, k_s, v_s, p_s, o, m, l, a.scale,
                                   [&](int, int col) { return st_s[col]; });
  }

  const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;
  T* out = static_cast<T*>(a.out) + (static_cast<int64_t>(b) * a.H + g * r) * D;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = ty + 16 * i;
    if (row < r) {
      const float li = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
      for (int d = 0; d < D / 8; ++d)
        attn::store(out + row * D + tx + 8 * d, o[i][d] / li);
    }
  }
}

template <typename T, int D, int RPT, int CPT>
int launch(const DaArgs& a, int B, cudaStream_t stream) {
  constexpr int BQ = 16 * RPT, BK = 8 * CPT;
  constexpr size_t smem = attn::smem_bytes(D, BQ, BK, BK * sizeof(int));
  auto kernel = decode_attention_kernel<T, D, RPT, CPT>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  kernel<<<B * a.KV, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// 16 rows for r <= 16, 48 for r <= 48 (granite-20b's MQA); 64 slots per
// tile, 32 at D >= 128.
template <typename T, int RPT>
int dispatch_d(const DaArgs& a, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16, RPT, 8>(a, B, stream);
    case 32: return launch<T, 32, RPT, 8>(a, B, stream);
    case 64: return launch<T, 64, RPT, 8>(a, B, stream);
    case 128: return launch<T, 128, RPT, 4>(a, B, stream);
    case 256: return launch<T, 256, RPT, 4>(a, B, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch(const DaArgs& a, int B, int D, cudaStream_t stream) {
  const int r = a.H / a.KV;
  if (r <= 16) return dispatch_d<T, 1>(a, B, D, stream);
  if (r <= 48) return dispatch_d<T, 3>(a, B, D, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// dtype 0: fp32, 1: bf16.  Strides are in elements; window <= 0: none.
int da_launch(int dtype, const void* q, const void* k, const void* v,
              const void* cache_len, const void* positions, void* out, int B,
              int H, int KV, int S, int D, int64_t q_sb, int64_t q_sh,
              int64_t k_sb, int64_t k_sh, int64_t k_ss, int64_t v_sb,
              int64_t v_sh, int64_t v_ss, int64_t cl_sb, int64_t pos_sb,
              int window, float scale, void* stream) {
  const DaArgs a{q, k, v, static_cast<const int32_t*>(cache_len),
                 static_cast<const int32_t*>(positions), out, H, KV, S,
                 q_sb, q_sh, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, cl_sb,
                 pos_sb, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return dispatch<__nv_bfloat16>(a, B, D, s);
  return dispatch<float>(a, B, D, s);
}

}  // extern "C"
