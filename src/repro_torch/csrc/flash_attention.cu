// Flash attention for prefill on Hopper (sm_90a), fp32 at every head dim
// and bf16 at head dims 16 and 32 (B3's CUDA-core route).
//
// Replaces the Pallas TPU kernel `flash_attention_bhsd` (its `_kernel`) in
// src/repro/kernels/flash_attention.py.  It computes what that kernel
// computes: each query position of head bh attends the key positions of kv
// head bh / r (r = H / KV) that its masks keep (causal: kpos <= qpos;
// window w: kpos > qpos - w), with scores scaled by 1/sqrt(D), masked
// scores at -1e30 and an online softmax over kv tiles, accumulated in fp32;
// the output is in the inputs' type.
//
// Bound: the larger of the bytes (Q, K, V read once, O written once) over
// 3.35 TB/s and the operations (4 * D per kept (query, key) pair) over the
// bf16 tensor-core rate.  At qwen2-0.5b's heads (14 q, 2 kv, D 64), causal,
// that is about 220 flops per byte at S = 512, just under the card's ~295
// (so bytes bound it), and eight times more at S = 4096 (operations).
// This kernel's fp32 CUDA-core arithmetic makes it compute-limited at both.
//
// Design (simple first): one block of 128 threads per (sequence * head,
// query tile of 64 rows, 32 at D = 256).  The Q tile is staged once in
// shared memory as fp32; a loop over kv tiles stages K and V (64 or 32
// slots) the same way and runs attention_tile.cuh's step: register-tiled
// scores (4 rows x 8 slots per thread), the online softmax with warp
// shuffles, and P V into an fp32 accumulator held in registers.  Kv tiles
// that every row masks (above the causal diagonal, or before the window)
// are skipped, which is exact: each row keeps at least its own position,
// and once a kept key has set the row's max, a masked key contributes
// exp(-1e30 - m) = 0.  Query tiles run from the last to the first, so the
// longest causal rows start first.  No tensor cores: fp32 FMAs on CUDA
// cores, for both input types.
//
// Layout: every tensor is [B, H, S, D] (or [B, KV, S, D]) with element
// strides given by the caller, the last one 1, so the model's [B, S, H, D]
// activations are read in place.
//
// Routing: bf16 at head dims 64, 128 and 256 goes to the tensor-core
// kernel in flash_attention_wgmma.cu (wgmma fed by TMA), which this file's
// fp32 CUDA-core arithmetic could not approach: it reached 2.4% of the
// bf16 tensor-core rate.  float32 stays here, so that it keeps its 2e-5
// agreement with the plain version and the float32 token identity that
// tensor cores in bf16 or TF32 would break; bf16 at D 16 and 32 (test
// shapes, no model in the zoo) stays here too.
//
// For the backward pass (flash_attention_bwd.cu) the epilogue also writes
// each row's log-sum-exp, m + log(l), to `lse` [B, H, S] when the caller
// passes one; inference passes none.
//
// C interface (bound with ctypes): fa_launch returns the cudaError_t of the
// launch, 0 on success.

#include "attention_tile.cuh"

namespace {

using attn::kThreads;

struct FaArgs {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int H, KV, S;
  int64_t q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  int64_t o_sb, o_sh, o_ss;
  int causal, window;
  float scale;
  float* lse;           // [B, H, S] log-sum-exp of each row, or null
};

template <typename T, int D, int RPT, int CPT>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const FaArgs a) {
  constexpr int BQ = 16 * RPT, BK = 8 * CPT, P = D + 4;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* k_s = q_s + BQ * P;
  float* v_s = k_s + BK * P;
  float* p_s = v_s + BK * P;

  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh % a.H;
  const int kvh = h / (a.H / a.KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int nq = min(BQ, a.S - q0);
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  attn::stage_rows<T, D, BQ>(q + q0 * a.q_ss, a.q_ss, nq, q_s);

  float o[RPT][D / 8], m[RPT], l[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = attn::kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int d = 0; d < D / 8; ++d) o[i][d] = 0.f;
  }

  // kv range that any row of this tile keeps
  const int hi = a.causal ? q0 + nq : a.S;
  const int lo = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  for (int k0 = lo / BK * BK; k0 < hi; k0 += BK) {
    __syncthreads();                          // previous tile fully used
    const int nk = min(BK, a.S - k0);
    attn::stage_rows<T, D, BK>(k + k0 * a.k_ss, a.k_ss, nk, k_s);
    attn::stage_rows<T, D, BK>(v + k0 * a.v_ss, a.v_ss, nk, v_s);
    __syncthreads();
    attn::attend_tile<RPT, CPT, D>(
        q_s, k_s, v_s, p_s, o, m, l, a.scale, [&](int row, int col) {
          const int qpos = q0 + row, kpos = k0 + col;
          if (kpos >= a.S) return static_cast<int>(attn::kOutside);
          const bool keep = (!a.causal || qpos >= kpos) &&
                            (a.window <= 0 || kpos > qpos - a.window);
          return static_cast<int>(keep ? attn::kValid : attn::kMasked);
        });
  }

  const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;
  T* out = static_cast<T*>(a.out) + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = ty + 16 * i;
    if (row < nq) {
      const float li = l[i] == 0.f ? 1.f : l[i];
      if (a.lse != nullptr && tx == 0)
        a.lse[static_cast<int64_t>(bh) * a.S + q0 + row] = m[i] + logf(li);
      T* orow = out + (q0 + row) * a.o_ss;
#pragma unroll
      for (int d = 0; d < D / 8; ++d) attn::store(orow + tx + 8 * d, o[i][d] / li);
    }
  }
}

template <typename T, int D, int RPT, int CPT>
int launch(const FaArgs& a, int B, cudaStream_t stream) {
  constexpr int BQ = 16 * RPT, BK = 8 * CPT;
  constexpr size_t smem = attn::smem_bytes(D, BQ, BK, 0);
  auto kernel = flash_attention_kernel<T, D, RPT, CPT>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const dim3 grid(B * a.H, (a.S + BQ - 1) / BQ);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Tiles per head dim: 64 query rows (32 at D = 256), 64 kv slots (32 at
// D >= 128), so that accumulators fit in registers and two or more blocks
// fit on an SM.
int dispatch_f32(const FaArgs& a, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<float, 16, 4, 8>(a, B, stream);
    case 32: return launch<float, 32, 4, 8>(a, B, stream);
    case 64: return launch<float, 64, 4, 8>(a, B, stream);
    case 128: return launch<float, 128, 4, 4>(a, B, stream);
    case 256: return launch<float, 256, 2, 4>(a, B, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int dispatch_bf16(const FaArgs& a, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<__nv_bfloat16, 16, 4, 8>(a, B, stream);
    case 32: return launch<__nv_bfloat16, 32, 4, 8>(a, B, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// dtype 0: fp32 (D in {16, 32, 64, 128, 256}), 1: bf16 (D in {16, 32}).
// Strides are in elements; window <= 0: none; lse may be null.
int fa_launch(int dtype, const void* q, const void* k, const void* v,
              void* out, int B, int H, int KV, int S, int D, int64_t q_sb,
              int64_t q_sh, int64_t q_ss, int64_t k_sb, int64_t k_sh,
              int64_t k_ss, int64_t v_sb, int64_t v_sh, int64_t v_ss,
              int64_t o_sb, int64_t o_sh, int64_t o_ss, int causal,
              int window, float scale, float* lse, void* stream) {
  const FaArgs a{q,    k,    v,    out,  H,    KV,     S,      q_sb,
                 q_sh, q_ss, k_sb, k_sh, k_ss, v_sb,   v_sh,   v_ss,
                 o_sb, o_sh, o_ss, causal, window, scale, lse};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return dispatch_bf16(a, B, D, s);
  return dispatch_f32(a, B, D, s);
}

}  // extern "C"
