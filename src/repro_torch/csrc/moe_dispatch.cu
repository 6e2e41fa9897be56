// Mixture-of-Experts dispatch and combine at decode sizes, on Hopper
// (sm_90a), bf16 or fp32 experts.
//
// Replaces no TPU kernel.  The JAX package leaves routing, capacity
// buckets and the combine (src/repro/models/moe.py: _route, _bucket,
// _combine) to XLA, which fuses them.  The port's plain path
// (models/moe.py) runs them as some sixty PyTorch kernels a layer, two of
// them radix sorts.  In a captured decode step each of those costs a few
// microseconds whatever it does, so at decode sizes a moe layer paid for
// launches rather than bytes.  These two kernels do the same work in two
// launches, around the experts' three batched products, which stay
// torch.bmm:
//
// moe_dispatch_kernel, from the router's float32 logits [N, E_pad] and the
//   tokens' rows x [N, d]:
//   * softmax over each token's logits, the padded experts (e >= n_experts)
//     masked to -1e30 as the plain path masks them; the top-k experts by
//     probability (the lower index first on equal values); the gates, the
//     k probabilities over their sum (at least 1e-9), or the probabilities
//     as they are where the launch asks for no renormalisation (DeepSeek-V2);
//   * the switch aux loss, n_experts * sum_e mean_n(p[n, e]) * count_e /
//     (N k), in block (0, 0);
//   * each assignment's slot in its expert's bucket: the number of earlier
//     tokens that chose the same expert.  A token's k experts are distinct,
//     so that is the assignment's position in the stable sort by expert of
//     the flat n * k + j order that the plain path's _bucket takes, and a
//     full bucket (slot >= C) drops the same assignments.  No sort;
//   * xe [E_pad, C, d]: each kept slot's token row, zeros for an empty
//     slot; ge [E_pad, C] float32: its gate, 0 for an empty slot; slots
//     [N, k] int32: for each token its k assignments in expert order, as
//     e * C + slot, or -1 where the bucket was full.  The last replaces the
//     plain combine's second sort, its searchsorted and its scatter.
// moe_combine_kernel, from the experts' outputs y_e [E_pad, C, d], ge and
//   slots: for each token, each kept slot's row scaled by its gate in the
//   experts' type (the gate rounded to it, the product rounded to it, as
//   the plain path's y_e * ge does), summed over the k slots in expert
//   order in float32 and rounded once.  No atomics: a bf16 step repeats
//   bitwise.
//
// Bound: both kernels are far below the card's bytes-per-flop line and move
// little.  At granite-moe's widths (E_pad 40, top-8, d 1,536, bf16) over 64
// tokens (C 20), the dispatch writes xe, 2.46 MB, and the combine reads 64 x
// 8 rows of 3 KB and writes 64: about 2.7 MB and 1.8 MB, 0.8 and 0.5 us at
// 3.35 TB/s.  So what bounds them is latency: the routing each dispatch
// block does, and one pass of loads.
//
// Design.
// * Routing needs every token's choice before any bucket can be filled,
//   and blocks cannot wait on each other.  So every dispatch block routes
//   every token itself, identically, and then fills only its own part of
//   the buckets.  So the kernel's work grows as N^2 (N tokens routed in
//   each of E_pad * C / 8 blocks, C growing with N), and a gate and a rank
//   per token sit in shared memory: a call takes at most kMaxAssignments =
//   N * k.  That is 256 tokens at top-8; decode steps take tens, a prefill
//   thousands, and the wrapper sends anything past it to the plain path.
// * Routing is a half-warp a token, 64 tokens at a time in a block of
//   1,024 threads: lane l of 16 holds experts l, l + 16, l + 32 and l + 48,
//   the softmax's max and sum are butterfly shuffles, and each of the k
//   picks is a maximum over the half-warp of 64-bit keys (the
//   probability's bits above the complement of the index).  So a
//   decode-sized call routes each token in one pass, on a chain of
//   shuffles.  A first version routed a thread a token, its 64
//   probabilities in registers and k passes over them: 20 us a call at 64
//   tokens and at 8, a long serial chain of straight-line code.
// * The grid is (E_pad, ceil(C / kRowsPerBlock)): block (e, s) fills slots
//   [s * kRowsPerBlock, ...) of expert e.  Its tokens' slots come from a
//   block-wide scan, in token order, of which tokens chose e (warp ballots
//   and per-warp counts).  Blocks (e, 0) write the slot lists of every
//   assignment to e, kept or dropped, so each entry is written exactly once.
// * The aux loss's sums run in a fixed order (each lane over its warp's
//   tokens in order, then the warps in order), so it repeats bitwise too.
// * Rows move as 16-byte vectors (d * sizeof(T) a multiple of 16); the
//   combine is one block a token over its row's vectors, with all k slots'
//   rows in flight before the sum.
//
// C interface (bound with ctypes): moe_dispatch_launch and
// moe_combine_launch return the cudaError_t of the launch, 0 on success;
// moe_limits gives the kernel's limits, which kernels/moe_dispatch.py holds
// to its own.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kMaxExperts = 64;       // E_pad: two experts a lane
constexpr int kMaxTopK = 8;           // the combine's slots in registers
constexpr int kMaxAssignments = 2048; // N * k: every block routes every token
constexpr int kThreads = 1024;        // dispatch
constexpr int kWarps = kThreads / 32;
constexpr int kPerLane = kMaxExperts / 16;      // a half-warp routes a token
constexpr int kTokensPerPass = kThreads / 16;
static_assert(kPerLane == 4, "a lane's pick is the maximum of four keys");
constexpr int kCombineThreads = 256;
constexpr int kRowsPerBlock = 8;      // bucket slots a dispatch block fills
constexpr float kMasked = -1e30f;

struct DispatchArgs {
  const float* logits;   // [N, E_pad]
  const uint4* x;        // [N, row_vecs]
  uint4* xe;             // [E_pad, C, row_vecs]
  float* ge;             // [E_pad, C]
  int* slots;            // [N, k]
  float* aux;            // scalar
  int n_tokens, e_pad, n_experts, top_k, capacity, row_vecs;
  int renormalize;       // 0: the gates are the probabilities as they are
};

// An expert's key for the warp-wide top-k: its probability's bits (p >= 0
// orders as an unsigned integer) above the complement of its index, so the
// largest key is the largest probability, the lower index first on equal
// ones.  0 for an expert that is out of the running.
__device__ __forceinline__ unsigned long long key_of(float p, int i) {
  return (static_cast<unsigned long long>(__float_as_uint(p)) << 32) |
         (0xffffffffu - static_cast<unsigned>(i));
}

__global__ void __launch_bounds__(kThreads)
    moe_dispatch_kernel(const DispatchArgs a) {
  __shared__ float s_gate[kMaxAssignments];       // gate of expert e, by token
  // e's rank among the token's experts in expert order, -1: not chosen
  __shared__ signed char s_rank[kMaxAssignments];
  __shared__ float s_psum[kWarps][kMaxExperts];   // aux: sums of probabilities
  __shared__ int s_pick[kWarps][kMaxExperts];     // aux: counts of choices
  __shared__ float s_prod[kMaxExperts];
  __shared__ int s_warp[kWarps];
  __shared__ int s_tok[kRowsPerBlock];

  const int e = blockIdx.x, c0 = blockIdx.y * kRowsPerBlock;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int N = a.n_tokens, E = a.e_pad, k = a.top_k, C = a.capacity;
  const bool aux_block = blockIdx.x == 0 && blockIdx.y == 0;
  const int rows = min(kRowsPerBlock, C - c0);
  if (tid < kRowsPerBlock) s_tok[tid] = -1;

  // -- routing: a half-warp a token (lane l of 16 holds experts l, l + 16,
  //    l + 32 and l + 48), 64 tokens at a time, every token in every block,
  //    each lane's tokens in order ----------------------------------------
  const int half = lane >> 4, sub = lane & 15;
  float psum[kPerLane];                           // aux: this lane's experts
  int pick[kPerLane];
#pragma unroll
  for (int q = 0; q < kPerLane; ++q) {
    psum[q] = 0.f;
    pick[q] = 0;
  }
  for (int base = 0; base < N; base += kTokensPerPass) {
    if (base + 2 * warp >= N) break;              // both halves past N
    const int n = base + 2 * warp + half;
    const bool live = n < N;
    const float* row = a.logits + static_cast<size_t>(live ? n : 0) * E;
    float p[kPerLane];
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int q = 0; q < kPerLane; ++q) {
      const int i = sub + 16 * q;
      p[q] = i < E ? (i < a.n_experts ? row[i] : kMasked) : -CUDART_INF_F;
      mx = fmaxf(mx, p[q]);
    }
#pragma unroll
    for (int o = 8; o; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, o));
    float sum = 0.f;
#pragma unroll
    for (int q = 0; q < kPerLane; ++q) {
      p[q] = sub + 16 * q < E ? expf(p[q] - mx) : 0.f;
      sum += p[q];
    }
#pragma unroll
    for (int o = 8; o; o >>= 1) sum += __shfl_xor_sync(~0u, sum, o);
    unsigned long long key[kPerLane];
#pragma unroll
    for (int q = 0; q < kPerLane; ++q) {
      const int i = sub + 16 * q;
      p[q] /= sum;
      key[q] = i < E ? key_of(p[q], i) : 0ull;
    }
    uint64_t chosen = 0;
    float top = 0.f, mine = 0.f;
    for (int j = 0; j < k; ++j) {
      const unsigned long long k01 = key[0] > key[1] ? key[0] : key[1];
      const unsigned long long k23 = key[2] > key[3] ? key[2] : key[3];
      unsigned long long best = k01 > k23 ? k01 : k23;
#pragma unroll
      for (int o = 8; o; o >>= 1) {
        const unsigned long long other = __shfl_xor_sync(~0u, best, o);
        best = other > best ? other : best;
      }
      const int bi =
          static_cast<int>(0xffffffffu - static_cast<unsigned>(best));
      const float bv = __uint_as_float(static_cast<unsigned>(best >> 32));
      chosen |= 1ull << bi;
      top += bv;
      if (bi == e) mine = bv;
#pragma unroll
      for (int q = 0; q < kPerLane; ++q)
        if (bi == sub + 16 * q) key[q] = 0ull;
    }
    if (live) {
#pragma unroll
      for (int q = 0; q < kPerLane; ++q) {
        psum[q] += p[q];
        pick[q] += static_cast<int>((chosen >> (sub + 16 * q)) & 1);
      }
      if (sub == 0) {
        s_rank[n] = (chosen >> e) & 1 ? __popcll(chosen & ((1ull << e) - 1))
                                      : -1;
        s_gate[n] = a.renormalize ? mine / fmaxf(top, 1e-9f) : mine;
      }
    }
  }
  if (aux_block) {                                // the two halves, in order
#pragma unroll
    for (int q = 0; q < kPerLane; ++q) {
      const float other = __shfl_xor_sync(~0u, psum[q], 16);
      const int others = __shfl_xor_sync(~0u, pick[q], 16);
      if (half == 0) {
        s_psum[warp][sub + 16 * q] = psum[q] + other;
        s_pick[warp][sub + 16 * q] = pick[q] + others;
      }
    }
  }
  __syncthreads();

  if (aux_block) {
    if (tid < kMaxExperts) {
      float me = 0.f, prod = 0.f;
      int count = 0;
      if (tid < a.n_experts) {
        for (int w = 0; w < kWarps; ++w) {
          me += s_psum[w][tid];
          count += s_pick[w][tid];
        }
        me /= N;
        prod = me * (static_cast<float>(count) / N / k);
      }
      s_prod[tid] = prod;
    }
    __syncthreads();
    if (warp == 0) {
      float v = s_prod[lane] + s_prod[lane + 32];
#pragma unroll
      for (int o = 16; o; o >>= 1) v += __shfl_down_sync(~0u, v, o);
      if (lane == 0) a.aux[0] = a.n_experts * v;
    }
  }

  // -- expert e's bucket: its tokens in token order --------------------------
  int running = 0;
  for (int base = 0; base < N; base += kThreads) {
    const int n = base + tid;
    const int r = n < N ? s_rank[n] : -1;
    const unsigned m = __ballot_sync(~0u, r >= 0);
    if (lane == 0) s_warp[warp] = __popc(m);
    __syncthreads();
    int before = running, total = running;
    for (int w = 0; w < kWarps; ++w) {
      total += s_warp[w];
      if (w < warp) before += s_warp[w];
    }
    if (r >= 0) {
      const int c = before + __popc(m & ((1u << lane) - 1));
      if (c >= c0 && c < c0 + rows) s_tok[c - c0] = n;
      if (blockIdx.y == 0)
        a.slots[static_cast<size_t>(n) * k + r] = c < C ? e * C + c : -1;
    }
    running = total;
    __syncthreads();
  }

  const size_t first = static_cast<size_t>(e) * C + c0;
  if (tid < rows) {
    const int t = s_tok[tid];
    a.ge[first + tid] = t >= 0 ? s_gate[t] : 0.f;
  }
  const int V = a.row_vecs, total = rows * V;
  uint4* out = a.xe + first * V;
  auto row_vec = [&](int i) {                     // slot i / V's token row
    const int r = i / V, t = s_tok[r];
    return t >= 0 ? a.x[static_cast<size_t>(t) * V + (i - r * V)]
                  : make_uint4(0, 0, 0, 0);
  };
  for (int i = tid; i < total; i += 2 * kThreads) {   // two loads in flight
    const int i2 = i + kThreads;
    const uint4 v0 = row_vec(i);
    const uint4 v1 = i2 < total ? row_vec(i2) : make_uint4(0, 0, 0, 0);
    out[i] = v0;
    if (i2 < total) out[i2] = v1;
  }
}

// A value rounded to the experts' type and back.
template <typename T>
__device__ __forceinline__ float rounded(float v);
template <>
__device__ __forceinline__ float rounded<float>(float v) { return v; }
template <>
__device__ __forceinline__ float rounded<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
    moe_combine_kernel(const uint4* __restrict__ y_e,
                       const float* __restrict__ ge,
                       const int* __restrict__ slots, uint4* __restrict__ out,
                       int top_k, int row_vecs) {
  constexpr int L = 16 / sizeof(T);
  const int n = blockIdx.x;
  const int v = blockIdx.y * blockDim.x + threadIdx.x;
  if (v >= row_vecs) return;
  // every slot's gate and row in flight at once, then the sum in order
  int s[kMaxTopK];
  float g[kMaxTopK];
  uint4 raw[kMaxTopK];
#pragma unroll
  for (int j = 0; j < kMaxTopK; ++j)
    s[j] = j < top_k ? slots[static_cast<size_t>(n) * top_k + j] : -1;
#pragma unroll
  for (int j = 0; j < kMaxTopK; ++j) {
    if (s[j] >= 0) {                                // -1 dropped: a zero row
      g[j] = rounded<T>(ge[s[j]]);
      raw[j] = y_e[static_cast<size_t>(s[j]) * row_vecs + v];
    }
  }
  float acc[L];
#pragma unroll
  for (int i = 0; i < L; ++i) acc[i] = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxTopK; ++j) {
    if (s[j] >= 0) {
      const T* y = reinterpret_cast<const T*>(&raw[j]);
#pragma unroll
      for (int i = 0; i < L; ++i)
        acc[i] += rounded<T>(__fmul_rn(to_float(y[i]), g[j]));
    }
  }
  uint4 res;
  T* o = reinterpret_cast<T*>(&res);
#pragma unroll
  for (int i = 0; i < L; ++i) o[i] = from_float<T>(acc[i]);
  out[static_cast<size_t>(n) * row_vecs + v] = res;
}

}  // namespace

extern "C" {

// logits [N, e_pad] float32; x [N, d] and xe [e_pad, capacity, d] with rows
// of row_bytes (a multiple of 16); ge [e_pad, capacity] float32; slots
// [N, top_k] int32; aux one float32.  All contiguous, 16-byte aligned.
// renormalize 0 keeps the top-k probabilities as the gates.
int moe_dispatch_launch(const void* logits, const void* x, void* xe,
                        void* ge, void* slots, void* aux, int n_tokens,
                        int e_pad, int n_experts, int top_k, int capacity,
                        int row_bytes, int renormalize, void* stream) {
  if (n_tokens < 1 || n_tokens * top_k > kMaxAssignments || e_pad < 1 ||
      e_pad > kMaxExperts || n_experts < 1 || n_experts > e_pad ||
      top_k < 1 || top_k > kMaxTopK || top_k > e_pad || capacity < 1 ||
      row_bytes < 16 || row_bytes % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const DispatchArgs a{static_cast<const float*>(logits),
                       static_cast<const uint4*>(x),
                       static_cast<uint4*>(xe),
                       static_cast<float*>(ge),
                       static_cast<int*>(slots),
                       static_cast<float*>(aux),
                       n_tokens, e_pad, n_experts, top_k, capacity,
                       row_bytes / 16, renormalize};
  const dim3 grid(e_pad, (capacity + kRowsPerBlock - 1) / kRowsPerBlock);
  moe_dispatch_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// dtype 0: float32, 1: bfloat16.  y_e [*, row_bytes] rows indexed by slots
// [N, top_k] (-1: none); ge float32 by slot; out [N, row_bytes].
int moe_combine_launch(int dtype, const void* y_e, const void* ge,
                       const void* slots, void* out, int n_tokens, int top_k,
                       int row_bytes, void* stream) {
  if (n_tokens < 1 || top_k < 1 || top_k > kMaxTopK || row_bytes < 16 ||
      row_bytes % 16 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int vecs = row_bytes / 16;
  const int threads = std::min(kCombineThreads, (vecs + 31) / 32 * 32);
  const dim3 grid(n_tokens, (vecs + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint4* y = static_cast<const uint4*>(y_e);
  const float* g = static_cast<const float*>(ge);
  const int* sl = static_cast<const int*>(slots);
  uint4* o = static_cast<uint4*>(out);
  if (dtype == 0)
    moe_combine_kernel<float><<<grid, threads, 0, s>>>(y, g, sl, o, top_k,
                                                       vecs);
  else
    moe_combine_kernel<__nv_bfloat16><<<grid, threads, 0, s>>>(
        y, g, sl, o, top_k, vecs);
  return static_cast<int>(cudaGetLastError());
}

// which = 0: most experts (E_pad), 1: most top_k, 2: most N * top_k.
int moe_limits(int which) {
  return which == 0 ? kMaxExperts
                    : which == 1 ? kMaxTopK : kMaxAssignments;
}

}  // extern "C"
