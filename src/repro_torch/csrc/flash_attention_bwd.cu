// The backward pass of flash attention (B3) on Hopper (sm_90a) on the CUDA
// cores (the backward's `simt` route): float32 at head dims 16 to 256, and
// bf16 at 16, 32 and 256.  bf16 at 64 and 128, every model's training call
// but gemma3's D 256, runs on the tensor cores in
// flash_attention_bwd_wgmma.cu; kernels/flash_attention.py routes between
// the two (`bwd_route`).
//
// The port's own kernel: the JAX package has no backward Pallas kernel (it
// differentiates its jnp attention, src/repro/models/attention.py), and the
// TPU kernel it stands beside is `flash_attention_bhsd` in
// src/repro/kernels/flash_attention.py.  With the forward pass's output O
// and the log-sum-exp `lse` of each query row's scaled, masked scores
// (written by flash_attention.cu or flash_attention_wgmma.cu), and dO, the
// gradient of O, it computes in fp32, for each (sequence, query head):
//
//   P  = exp(S * scale - lse)   (S = Q K^T; masked entries 0)
//   dP = dO V^T,   delta = rowsum(dO * O),   dS = P * (dP - delta)
//   dQ = dS K * scale,   dK = dS^T Q * scale,   dV = P^T dO
//
// with dK and dV summed over the r = H / KV query heads of each kv head.
// The masks are the forward pass's (causal: kpos <= qpos; window w:
// kpos > qpos - w); kv tiles that every row of a tile masks are skipped by
// the forward pass's rule, which is exact (their P is 0).
//
// Bound (chip_smoke.time_flash_bwd): the bytes of q, k, v, O, dO and lse
// read and dq, dk, dv written, against 10 D operations per kept (query,
// key) pair, the five products Q K^T, dO V^T, P^T dO, dS K and dS^T Q.  At
// qwen2-0.5b's training call in bf16 (8 x 512, 14/2 heads, D 64, causal)
// that is 34 MB, 0.0101 ms at 3.35 TB/s, against 0.0095 ms of operations at
// the 989 TFLOP/s bf16 rate; on the CUDA cores, whose fp32 rate is 67
// TFLOP/s, the same operations take 0.14 ms.
//
// Design (simple first, right before fast): fp32 FMAs on the CUDA cores,
// with attention_tile.cuh's staging and 128-thread layout (16 row groups
// by 8 column groups).  Two kernels, so that no result is summed with
// atomics and two calls are bitwise equal:
//
// * dQ: one block per (sequence * query head, BQ query rows).  It stages
//   its Q and dO rows as fp32, computes delta for its rows from dO and O
//   (and stores it for the second kernel), then walks the kv tiles its
//   rows keep: S and dP in registers (each thread 4 or 2 rows by CPT
//   slots), P and dS from them, dS through shared memory, and
//   dQ += dS K into registers.
// * dK, dV: one block per (sequence * kv head, BK2 kv rows).  It stages
//   its K and V rows once, then walks the r query heads of its group and,
//   for each, the query tiles that keep some of its rows: S^T and dP^T in
//   registers, P^T and dS^T through shared memory, dV += P^T dO and
//   dK += dS^T Q into registers.  GQA's sum over the group happens inside
//   the block, in head order.
//
// What holds it back (PERF.md: it ran at 1.0% of its bound in bf16 at
// qwen2-0.5b's call on an H100): no tensor cores, P and dS through shared
// memory, every tile staged behind two barriers with no copy in flight,
// and a GQA group walked by one block; the fp32 dQ kernel spills 52 bytes
// at D 256.  The tensor-core route answers the first three for bf16 at D
// 64 and 128; here it stays the float32 path and the small and large head
// dims.
//
// Layout: every tensor is [B, heads, S, D] with element strides given by
// the caller, the last one 1 and the others whole 16-byte rows (the
// model's [B, S, heads, D] activations are read in place, and the
// gradients written the same way); lse and delta are [B, H, S] float32.
//
// C interface (bound with ctypes): fab_launch runs both kernels on the
// stream and returns the cudaError_t of the launches, 0 on success.

#include "attention_tile.cuh"

namespace {

using attn::kThreads;

enum { kQ, kK, kV, kO, kDO, kDQ, kDK, kDV, kTensors };

struct BwArgs {
  const void* t[kDQ];           // q, k, v, o, dout
  void* g[3];                   // dq, dk, dv
  const float* lse;
  float* delta;
  int H, KV, S;
  int64_t st[kTensors][3];      // element strides (batch, head, row)
  int causal, window;
  float scale;
};

template <typename T>
__device__ __forceinline__ const T* rows(const BwArgs& a, int which, int b,
                                         int head) {
  return static_cast<const T*>(a.t[which]) + b * a.st[which][0] +
         head * a.st[which][1];
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ bool kept(const BwArgs& a, int qpos, int kpos) {
  return qpos < a.S && kpos < a.S && (!a.causal || qpos >= kpos) &&
         (a.window <= 0 || kpos > qpos - a.window);
}

// acc[i][j] = sum_d x[(ty + 16 i)][d] * y[(tx + 8 j)][d]: rows of x_s (pitch
// D + 4) against rows of y_s, the 16 x 8 thread layout of attend_tile.
template <int RI, int RJ, int D>
__device__ __forceinline__ void dots(const float* __restrict__ x_s,
                                     const float* __restrict__ y_s,
                                     float (&acc)[RI][RJ]) {
  constexpr int P = D + 4;
  const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < RJ; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 xv[RI], yv[RJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
      xv[i] = *reinterpret_cast<const float4*>(x_s + (ty + 16 * i) * P + d);
#pragma unroll
    for (int j = 0; j < RJ; ++j)
      yv[j] = *reinterpret_cast<const float4*>(y_s + (tx + 8 * j) * P + d);
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RJ; ++j) {
        float s = acc[i][j];
        s = fmaf(xv[i].x, yv[j].x, s);
        s = fmaf(xv[i].y, yv[j].y, s);
        s = fmaf(xv[i].z, yv[j].z, s);
        s = fmaf(xv[i].w, yv[j].w, s);
        acc[i][j] = s;
      }
  }
}

// out[i][dd] += sum_c w[(ty + 16 i)][c] * y[c][tx + 8 dd] for c < NC: a
// weight matrix in shared memory (pitch NC + 1) times rows of y_s.
template <int RI, int NC, int D>
__device__ __forceinline__ void accumulate(const float* __restrict__ w_s,
                                           const float* __restrict__ y_s,
                                           float (&out)[RI][D / 8]) {
  constexpr int P = D + 4, PW = NC + 1;
  const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;
#pragma unroll 4
  for (int c = 0; c < NC; ++c) {
    float w[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i) w[i] = w_s[(ty + 16 * i) * PW + c];
#pragma unroll
    for (int dd = 0; dd < D / 8; ++dd) {
      const float y = y_s[c * P + tx + 8 * dd];
#pragma unroll
      for (int i = 0; i < RI; ++i) out[i][dd] = fmaf(w[i], y, out[i][dd]);
    }
  }
}

// dQ and delta.  BQ = 16 RPT query rows, BK = 8 CPT kv slots per tile.
template <typename T, int D, int RPT, int CPT>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const BwArgs a) {
  constexpr int BQ = 16 * RPT, BK = 8 * CPT, P = D + 4, PW = BK + 1;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* do_s = q_s + BQ * P;
  float* k_s = do_s + BQ * P;
  float* v_s = k_s + BK * P;
  float* ds_s = v_s + BK * P;

  const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int kvh = h / (a.H / a.KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int nq = min(BQ, a.S - q0);
  attn::stage_rows<T, D, BQ>(rows<T>(a, kQ, b, h) + q0 * a.st[kQ][2],
                             a.st[kQ][2], nq, q_s);
  attn::stage_rows<T, D, BQ>(rows<T>(a, kDO, b, h) + q0 * a.st[kDO][2],
                             a.st[kDO][2], nq, do_s);
  __syncthreads();

  // delta = rowsum(dO * O) and lse of this thread's rows
  const T* o = rows<T>(a, kO, b, h);
  const int64_t row_bh = static_cast<int64_t>(bh) * a.S;
  float delta[RPT], lse[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = ty + 16 * i;
    float part = 0.f;
    if (row < nq) {
      const T* orow = o + (q0 + row) * a.st[kO][2];
#pragma unroll
      for (int dd = 0; dd < D / 8; ++dd)
        part = fmaf(do_s[row * P + tx + 8 * dd], to_f32(orow[tx + 8 * dd]),
                    part);
    }
#pragma unroll
    for (int off = 1; off < 8; off <<= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    delta[i] = part;
    lse[i] = row < nq ? a.lse[row_bh + q0 + row] : 0.f;
    if (tx == 0 && row < nq) a.delta[row_bh + q0 + row] = part;
  }

  float dq[RPT][D / 8];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int dd = 0; dd < D / 8; ++dd) dq[i][dd] = 0.f;

  const T* k = rows<T>(a, kK, b, kvh);
  const T* v = rows<T>(a, kV, b, kvh);
  const int hi = a.causal ? q0 + nq : a.S;
  const int lo = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  for (int k0 = lo / BK * BK; k0 < hi; k0 += BK) {
    __syncthreads();                          // previous tile fully used
    const int nk = min(BK, a.S - k0);
    attn::stage_rows<T, D, BK>(k + k0 * a.st[kK][2], a.st[kK][2], nk, k_s);
    attn::stage_rows<T, D, BK>(v + k0 * a.st[kV][2], a.st[kV][2], nk, v_s);
    __syncthreads();
    float s[RPT][CPT], dp[RPT][CPT];
    dots<RPT, CPT, D>(q_s, k_s, s);
    dots<RPT, CPT, D>(do_s, v_s, dp);
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int row = ty + 16 * i, col = tx + 8 * j;
        const float p = kept(a, q0 + row, k0 + col)
                            ? expf(s[i][j] * a.scale - lse[i]) : 0.f;
        ds_s[row * PW + col] = p * (dp[i][j] - delta[i]);
      }
    __syncthreads();
    accumulate<RPT, BK, D>(ds_s, k_s, dq);
  }

  T* out = static_cast<T*>(a.g[0]) + b * a.st[kDQ][0] + h * a.st[kDQ][1];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = ty + 16 * i;
    if (row < nq) {
      T* orow = out + (q0 + row) * a.st[kDQ][2];
#pragma unroll
      for (int dd = 0; dd < D / 8; ++dd)
        attn::store(orow + tx + 8 * dd, dq[i][dd] * a.scale);
    }
  }
}

// dK and dV.  BK2 = 16 KR kv rows per block, BQ2 = 8 CQ query rows per
// inner tile.
template <typename T, int D, int KR, int CQ>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const BwArgs a) {
  constexpr int BK2 = 16 * KR, BQ2 = 8 * CQ, P = D + 4, PW = BQ2 + 1;
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);
  float* v_s = k_s + BK2 * P;
  float* q_s = v_s + BK2 * P;
  float* do_s = q_s + BQ2 * P;
  float* p_s = do_s + BQ2 * P;
  float* ds_s = p_s + BK2 * PW;
  float* lse_s = ds_s + BK2 * PW;
  float* delta_s = lse_s + BQ2;

  const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;
  const int bkv = blockIdx.x, b = bkv / a.KV, kvh = bkv % a.KV;
  const int r = a.H / a.KV;
  const int k0 = blockIdx.y * BK2, nk = min(BK2, a.S - k0);
  attn::stage_rows<T, D, BK2>(rows<T>(a, kK, b, kvh) + k0 * a.st[kK][2],
                              a.st[kK][2], nk, k_s);
  attn::stage_rows<T, D, BK2>(rows<T>(a, kV, b, kvh) + k0 * a.st[kV][2],
                              a.st[kV][2], nk, v_s);

  float dk[KR][D / 8], dv[KR][D / 8];
#pragma unroll
  for (int i = 0; i < KR; ++i)
#pragma unroll
    for (int dd = 0; dd < D / 8; ++dd) dk[i][dd] = dv[i][dd] = 0.f;

  // query rows that keep some of this block's kv rows
  const int qlo = a.causal ? k0 : 0;
  const int qhi = a.window > 0 ? min(a.S, k0 + nk - 1 + a.window) : a.S;
  for (int hh = 0; hh < r; ++hh) {
    const int h = kvh * r + hh;
    const T* q = rows<T>(a, kQ, b, h);
    const T* dout = rows<T>(a, kDO, b, h);
    const int64_t row_bh = (static_cast<int64_t>(b) * a.H + h) * a.S;
    for (int q0 = qlo / BQ2 * BQ2; q0 < qhi; q0 += BQ2) {
      __syncthreads();                        // previous tile fully used
      const int nq = min(BQ2, a.S - q0);
      attn::stage_rows<T, D, BQ2>(q + q0 * a.st[kQ][2], a.st[kQ][2], nq, q_s);
      attn::stage_rows<T, D, BQ2>(dout + q0 * a.st[kDO][2], a.st[kDO][2], nq,
                                  do_s);
      if (threadIdx.x < BQ2) {
        const int row = threadIdx.x;
        lse_s[row] = row < nq ? a.lse[row_bh + q0 + row] : 0.f;
        delta_s[row] = row < nq ? a.delta[row_bh + q0 + row] : 0.f;
      }
      __syncthreads();
      float st[KR][CQ], dpt[KR][CQ];
      dots<KR, CQ, D>(k_s, q_s, st);
      dots<KR, CQ, D>(v_s, do_s, dpt);
#pragma unroll
      for (int i = 0; i < KR; ++i)
#pragma unroll
        for (int j = 0; j < CQ; ++j) {
          const int kr = ty + 16 * i, qc = tx + 8 * j;
          const float p = kept(a, q0 + qc, k0 + kr)
                              ? expf(st[i][j] * a.scale - lse_s[qc]) : 0.f;
          p_s[kr * PW + qc] = p;
          ds_s[kr * PW + qc] = p * (dpt[i][j] - delta_s[qc]);
        }
      __syncthreads();
      accumulate<KR, BQ2, D>(p_s, do_s, dv);
      accumulate<KR, BQ2, D>(ds_s, q_s, dk);
    }
  }

#pragma unroll
  for (int i = 0; i < KR; ++i) {
    const int row = ty + 16 * i;
    if (row < nk) {
      T* krow = static_cast<T*>(a.g[1]) + b * a.st[kDK][0] +
                kvh * a.st[kDK][1] + (k0 + row) * a.st[kDK][2];
      T* vrow = static_cast<T*>(a.g[2]) + b * a.st[kDV][0] +
                kvh * a.st[kDV][1] + (k0 + row) * a.st[kDV][2];
#pragma unroll
      for (int dd = 0; dd < D / 8; ++dd) {
        attn::store(krow + tx + 8 * dd, dk[i][dd] * a.scale);
        attn::store(vrow + tx + 8 * dd, dv[i][dd]);
      }
    }
  }
}

template <class K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Tiles per head dim: the dQ kernel's BQ x BK = 64 x 32 (32 x 32 at D 128
// and 256), the dK/dV kernel's BK2 x BQ2 = 64 x 32 (32 x 32 at D 64 and
// 128, 16 x 32 at D 256), so that each thread's accumulators (RPT or KR
// rows by D / 8 dims, twice for dK/dV) stay at 64 floats or fewer.
template <typename T, int D, int RPT, int CPT, int KR, int CQ>
int launch(const BwArgs& a, int B, cudaStream_t stream) {
  constexpr int BQ = 16 * RPT, BK = 8 * CPT, BK2 = 16 * KR, BQ2 = 8 * CQ;
  constexpr size_t smem_dq =
      sizeof(float) * ((2 * BQ + 2 * BK) * (D + 4) + BQ * (BK + 1));
  constexpr size_t smem_dkv =
      sizeof(float) *
      ((2 * BK2 + 2 * BQ2) * (D + 4) + 2 * BK2 * (BQ2 + 1) + 2 * BQ2);
  auto k_dq = flash_bwd_dq_kernel<T, D, RPT, CPT>;
  auto k_dkv = flash_bwd_dkv_kernel<T, D, KR, CQ>;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = allow_smem(k_dq, smem_dq);
    if (err == cudaSuccess) err = allow_smem(k_dkv, smem_dkv);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  k_dq<<<dim3(B * a.H, (a.S + BQ - 1) / BQ), kThreads, smem_dq, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  k_dkv<<<dim3(B * a.KV, (a.S + BK2 - 1) / BK2), kThreads, smem_dkv,
          stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const BwArgs& a, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16, 4, 4, 4, 4>(a, B, stream);
    case 32: return launch<T, 32, 4, 4, 4, 4>(a, B, stream);
    case 64: return launch<T, 64, 4, 4, 2, 4>(a, B, stream);
    case 128: return launch<T, 128, 2, 4, 2, 4>(a, B, stream);
    case 256: return launch<T, 256, 2, 4, 1, 4>(a, B, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// dtype 0: fp32, 1: bf16; D in {16, 32, 64, 128, 256}.  strides: 24
// element strides, (batch, head, row) of q, k, v, o, dout, dq, dk, dv in
// that order; window <= 0: none.
int fab_launch(int dtype, const void* q, const void* k, const void* v,
               const void* o, const void* dout, const float* lse,
               float* delta, void* dq, void* dk, void* dv, int B, int H,
               int KV, int S, int D, const int64_t* strides, int causal,
               int window, float scale, void* stream) {
  BwArgs a;
  a.t[kQ] = q;
  a.t[kK] = k;
  a.t[kV] = v;
  a.t[kO] = o;
  a.t[kDO] = dout;
  a.g[0] = dq;
  a.g[1] = dk;
  a.g[2] = dv;
  a.lse = lse;
  a.delta = delta;
  a.H = H;
  a.KV = KV;
  a.S = S;
  for (int i = 0; i < kTensors; ++i)
    for (int j = 0; j < 3; ++j) a.st[i][j] = strides[3 * i + j];
  a.causal = causal;
  a.window = window;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return dispatch<__nv_bfloat16>(a, B, D, s);
  return dispatch<float>(a, B, D, s);
}

}  // extern "C"
