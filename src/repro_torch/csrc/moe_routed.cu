// Mixture-of-Experts routing, capacity buckets and combine at prefill
// sizes and past the decode kernels' limits ("route once, then fill"), on
// Hopper (sm_90a), bf16 or fp32 experts.
//
// Replaces no TPU kernel.  The JAX package leaves routing, capacity
// buckets and the combine (src/repro/models/moe.py: _route, _bucket,
// _combine) to XLA.  The port's plain path (models/moe.py) runs them as
// sorts, gathers and copies: at granite-4.0-h's prefill (N 65,536 tokens,
// 72 experts top-10, d 4,096 bf16, capacity 11,380) its combine alone
// writes the buckets twice more (y_e * ge, torch.cat), gathers [N, 10, d]
// and sums it, about 45 GB of traffic a layer.  csrc/moe_dispatch.cu does
// the same work in two launches at decode sizes, but there every block
// routes every token, so its work grows as N^2 and it stops at 2,048
// assignments, 64 experts and top-8.  These four kernels route each token
// once across the grid and then fill, so they move each byte about once at
// any N, around the experts' three batched products, which stay torch.bmm:
//
// moe_routed_route_kernel, from the router's float32 logits [N, E_pad], a
//   block a run of kTokensPerBlock tokens, a warp a token:
//   * softmax over the token's logits, the padded experts (e >= n_experts)
//     masked to -1e30 as the plain path masks them; the top-k experts by
//     probability (the lower index first on equal values); the gates, the
//     k probabilities over their sum (at least 1e-9), or the probabilities
//     as they are where the launch asks for no renormalisation (DeepSeek-V2);
//   * idx and gates [N, k]: the token's experts and gates in expert order;
//   * each assignment's rank in its block: the number of earlier tokens of
//     the block that chose the same expert (per-expert bit masks over the
//     block's tokens, popcounts of the bits below);
//   * per block and expert, the count of choices and the sum of the
//     probabilities (the aux loss's partial sums), in a fixed order.
// moe_routed_offsets_kernel, a block an expert: the exclusive scan of its
//   per-block counts in block order (each block's first slot in the
//   expert's bucket), its total, and its term of the switch aux loss,
//   n_experts * sum_e mean_n(p[n, e]) * count_e / (N k), the probabilities
//   summed over the blocks in a fixed order.
// moe_routed_fill_kernel: each assignment's slot is its block's offset for
//   the expert plus its rank in the block, which is the number of earlier
//   tokens that chose the expert.  A token's k experts are distinct, so
//   that is its position in the stable sort by expert of the flat n * k + j
//   order that _bucket takes, and a full bucket (slot >= C) drops the same
//   assignments.  A block a token reads its row once and writes it to each
//   kept slot of xe [E_pad, C, d]; ge [E_pad, C] float32 gets the gate and
//   slots [N, k] int32 e * C + slot, or -1 where the bucket was full; the
//   blocks past N write zero rows and zero gates into each bucket's empty
//   slots, and one of them sums the aux loss over the experts in order.
// moe_routed_combine_kernel, from the experts' outputs y_e [E_pad, C, d],
//   ge and slots: for each token, each kept slot's row scaled by its gate
//   in the experts' type (the gate rounded to it, the product rounded to
//   it, as the plain path's y_e * ge does), summed over the k slots in
//   expert order in float32 and rounded once.  No atomics: a bf16 call
//   repeats bitwise.
//
// Bound: bytes.  At granite-4.0-h's prefill the route reads 18.9 MB of
// logits and writes 7.9 MB; the fill reads x once (0.54 GB) and writes xe
// (6.71 GB), 2.2 ms at 3.35 TB/s; the combine reads the kept slots' rows
// (at most N k rows, 5.37 GB) and writes the output (0.54 GB), 1.8 ms.
// Byte offsets are 64-bit: xe there is 819,360 rows of 8,192 B.
//
// Design.
// * A warp routes a token: lane l holds experts l, l + 32, l + 64 and
//   l + 96; the softmax's max and sum are butterfly shuffles, and each of
//   the k picks is a maximum over the warp of 64-bit keys (the
//   probability's bits above the complement of the index).  A block of 8
//   warps routes 64 tokens, 8 a warp: 1,024 blocks at N 65,536.
// * Ranks come from shared memory, not from a sort: each chosen (token,
//   expert) sets its token's bit in the expert's 64-bit mask of the block
//   (atomicOr on shared words, whose result does not depend on order),
//   then a thread an expert takes the popcount prefix of its words.
// * Every sum runs in a fixed order (a lane over its warp's tokens in
//   order, the warps in order, the blocks in a fixed tree), so the aux loss
//   repeats bitwise.
// * Rows move as 16-byte vectors (d * sizeof(T) a multiple of 16); the
//   combine is one block a token over its row's vectors, with all k <= 16
//   slots' rows in flight before the sum.
// * At most four launches a call, none of which waits on the host.
//
// C interface (bound with ctypes): moe_routed_dispatch_launch (the first
// three kernels) and moe_routed_combine_launch return the cudaError_t of
// their launches, 0 on success; moe_routed_workspace_bytes gives the
// scratch the dispatch needs; moe_routed_limits gives the kernels' limits,
// which kernels/moe_routed.py holds to its own.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kMaxExperts = 128;      // E_pad: four experts a lane
constexpr int kMaxTopK = 16;          // the combine's slots in registers
constexpr int kPerLane = kMaxExperts / 32;
constexpr int kRouteThreads = 256;
constexpr int kRouteWarps = kRouteThreads / 32;
constexpr int kTokensPerBlock = 64;   // a route block's tokens
constexpr int kTokensPerWarp = kTokensPerBlock / kRouteWarps;
constexpr int kWords = kTokensPerBlock / 32;   // an expert's mask a block
constexpr int kScanThreads = 256;
constexpr int kScanWarps = kScanThreads / 32;
constexpr int kFillThreads = 256;
constexpr int kMaxZeroBlocks = 32;    // fill blocks an expert's empty slots
constexpr int kCombineThreads = 256;
constexpr float kMasked = -1e30f;
static_assert(kPerLane == 4, "a lane's pick is the maximum of four keys");
static_assert(kTokensPerBlock % 32 == 0, "masks of whole words");

// The dispatch's scratch, carved from one buffer of 4-byte words.
struct Work {
  int* idx;        // [N, k]: each token's experts in expert order
  float* gates;    // [N, k]
  int* offsets;    // [blocks, E_pad]: counts, then each block's first slot
  float* psums;    // [blocks, E_pad]: sums of probabilities
  int* totals;     // [E_pad]
  float* prods;    // [E_pad]: each expert's term of the aux loss
};

int route_blocks(int n_tokens) {
  return (n_tokens + kTokensPerBlock - 1) / kTokensPerBlock;
}

size_t work_words(int n_tokens, int e_pad, int top_k) {
  return 2 * static_cast<size_t>(n_tokens) * top_k +
         2 * static_cast<size_t>(route_blocks(n_tokens)) * e_pad +
         2 * static_cast<size_t>(e_pad);
}

Work carve(void* base, int n_tokens, int e_pad, int top_k) {
  char* p = static_cast<char*>(base);
  const size_t nk = static_cast<size_t>(n_tokens) * top_k * 4;
  const size_t be = static_cast<size_t>(route_blocks(n_tokens)) * e_pad * 4;
  Work w;
  w.idx = reinterpret_cast<int*>(p);
  w.gates = reinterpret_cast<float*>(p + nk);
  w.offsets = reinterpret_cast<int*>(p + 2 * nk);
  w.psums = reinterpret_cast<float*>(p + 2 * nk + be);
  w.totals = reinterpret_cast<int*>(p + 2 * nk + 2 * be);
  w.prods = reinterpret_cast<float*>(p + 2 * nk + 2 * be + 4 * e_pad);
  return w;
}

// An expert's key for the warp-wide top-k: its probability's bits (p >= 0
// orders as an unsigned integer) above the complement of its index, so the
// largest key is the largest probability, the lower index first on equal
// ones.  0 for an expert that is out of the running.
__device__ __forceinline__ unsigned long long route_key(float p, int i) {
  return (static_cast<unsigned long long>(__float_as_uint(p)) << 32) |
         (0xffffffffu - static_cast<unsigned>(i));
}

struct RouteArgs {
  const float* logits;   // [N, E_pad]
  int* ranks;            // [N, k]: the slots array, rewritten by the fill
  Work w;
  int n_tokens, e_pad, n_experts, top_k;
  int renormalize;       // 0: the gates are the probabilities as they are
};

__global__ void __launch_bounds__(kRouteThreads)
    moe_routed_route_kernel(const RouteArgs a) {
  __shared__ unsigned s_bits[kMaxExperts][kWords];   // who chose e, by token
  __shared__ int s_pre[kMaxExperts][kWords];         // choices of e before
  __shared__ unsigned char s_idx[kTokensPerBlock][kMaxTopK];
  __shared__ float s_psum[kRouteWarps][kMaxExperts];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int N = a.n_tokens, E = a.e_pad, k = a.top_k;
  const int n0 = blockIdx.x * kTokensPerBlock;
  for (int i = tid; i < kMaxExperts * kWords; i += kRouteThreads)
    (&s_bits[0][0])[i] = 0u;
  __syncthreads();

  float psum[kPerLane];                  // aux: this lane's experts
#pragma unroll
  for (int q = 0; q < kPerLane; ++q) psum[q] = 0.f;
  for (int i = 0; i < kTokensPerWarp; ++i) {
    const int t = warp * kTokensPerWarp + i, n = n0 + t;
    if (n >= N) break;                   // the whole warp
    const float* row = a.logits + static_cast<size_t>(n) * E;
    float p[kPerLane];
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int q = 0; q < kPerLane; ++q) {
      const int e = lane + 32 * q;
      p[q] = e < E ? (e < a.n_experts ? row[e] : kMasked) : -CUDART_INF_F;
      mx = fmaxf(mx, p[q]);
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, o));
    float sum = 0.f;
#pragma unroll
    for (int q = 0; q < kPerLane; ++q) {
      p[q] = lane + 32 * q < E ? expf(p[q] - mx) : 0.f;
      sum += p[q];
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) sum += __shfl_xor_sync(~0u, sum, o);
    unsigned long long key[kPerLane];
#pragma unroll
    for (int q = 0; q < kPerLane; ++q) {
      const int e = lane + 32 * q;
      p[q] /= sum;
      key[q] = e < E ? route_key(p[q], e) : 0ull;
      psum[q] += p[q];
    }
    bool chosen[kPerLane] = {false, false, false, false};
    float top = 0.f;
    for (int j = 0; j < k; ++j) {
      const unsigned long long k01 = key[0] > key[1] ? key[0] : key[1];
      const unsigned long long k23 = key[2] > key[3] ? key[2] : key[3];
      unsigned long long best = k01 > k23 ? k01 : k23;
#pragma unroll
      for (int o = 16; o; o >>= 1) {
        const unsigned long long other = __shfl_xor_sync(~0u, best, o);
        best = other > best ? other : best;
      }
      const int bi =
          static_cast<int>(0xffffffffu - static_cast<unsigned>(best));
      top += __uint_as_float(static_cast<unsigned>(best >> 32));
#pragma unroll
      for (int q = 0; q < kPerLane; ++q)
        if (bi == lane + 32 * q) {
          key[q] = 0ull;
          chosen[q] = true;
        }
    }
    // the token's experts in expert order: lanes, then the four quarters
    const float norm = a.renormalize ? fmaxf(top, 1e-9f) : 1.f;
    int before = 0;
#pragma unroll
    for (int q = 0; q < kPerLane; ++q) {
      const unsigned m = __ballot_sync(~0u, chosen[q]);
      if (chosen[q]) {
        const int e = lane + 32 * q;
        const int r = before + __popc(m & ((1u << lane) - 1));
        const size_t at = static_cast<size_t>(n) * k + r;
        a.w.idx[at] = e;
        a.w.gates[at] = p[q] / norm;
        s_idx[t][r] = static_cast<unsigned char>(e);
        atomicOr(&s_bits[e][t >> 5], 1u << (t & 31));
      }
      before += __popc(m);
    }
  }
#pragma unroll
  for (int q = 0; q < kPerLane; ++q) s_psum[warp][lane + 32 * q] = psum[q];
  __syncthreads();

  const size_t b = blockIdx.x;
  if (tid < E) {
    int running = 0;
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      s_pre[tid][w] = running;
      running += __popc(s_bits[tid][w]);
    }
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kRouteWarps; ++w) s += s_psum[w][tid];
    a.w.offsets[b * E + tid] = running;
    a.w.psums[b * E + tid] = s;
  }
  __syncthreads();
  const int live = min(kTokensPerBlock, N - n0);
  for (int i = tid; i < live * k; i += kRouteThreads) {
    const int t = i / k, j = i - t * k;
    const int e = s_idx[t][j], w = t >> 5;
    a.ranks[static_cast<size_t>(n0 + t) * k + j] =
        s_pre[e][w] + __popc(s_bits[e][w] & ((1u << (t & 31)) - 1));
  }
}

// A block an expert: its per-block counts scanned in block order, in
// place, into each block's first slot; its total; its aux term.
__global__ void __launch_bounds__(kScanThreads)
    moe_routed_offsets_kernel(Work w, int n_blocks, int e_pad, int n_experts,
                              int n_tokens, int top_k) {
  __shared__ int s_warp[kScanWarps];
  __shared__ float s_sum[kScanWarps];
  const int e = blockIdx.x, tid = threadIdx.x, lane = tid & 31,
            warp = tid >> 5;
  int running = 0;
  float acc = 0.f;
  for (int base = 0; base < n_blocks; base += kScanThreads) {
    const int b = base + tid;
    const size_t at = static_cast<size_t>(b) * e_pad + e;
    const int c = b < n_blocks ? w.offsets[at] : 0;
    if (b < n_blocks) acc += w.psums[at];
    int v = c;                                       // inclusive, the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(~0u, v, o);
      if (lane >= o) v += u;
    }
    if (lane == 31) s_warp[warp] = v;
    __syncthreads();
    int before = running, total = running;
#pragma unroll
    for (int i = 0; i < kScanWarps; ++i) {
      total += s_warp[i];
      if (i < warp) before += s_warp[i];
    }
    if (b < n_blocks) w.offsets[at] = before + v - c;
    running = total;
    __syncthreads();
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) acc += __shfl_down_sync(~0u, acc, o);
  if (lane == 0) s_sum[warp] = acc;
  __syncthreads();
  if (tid == 0) {
    float me = 0.f;
    for (int i = 0; i < kScanWarps; ++i) me += s_sum[i];
    me /= n_tokens;
    w.totals[e] = running;
    w.prods[e] = e < n_experts
                     ? me * (static_cast<float>(running) / n_tokens / top_k)
                     : 0.f;
  }
}

struct FillArgs {
  const uint4* x;        // [N, row_vecs]
  uint4* xe;             // [E_pad, C, row_vecs]
  float* ge;             // [E_pad, C]
  int* slots;            // [N, k]: ranks in, slots out
  float* aux;            // scalar
  Work w;
  int n_tokens, e_pad, n_experts, top_k, capacity, row_vecs, zero_blocks;
};

__global__ void __launch_bounds__(kFillThreads)
    moe_routed_fill_kernel(const FillArgs a) {
  __shared__ int s_dst[kMaxTopK];
  const int tid = threadIdx.x;
  const int N = a.n_tokens, E = a.e_pad, k = a.top_k, C = a.capacity,
            V = a.row_vecs;
  if (static_cast<int>(blockIdx.x) < N) {         // token n's kept slots
    const int n = blockIdx.x;
    if (tid < k) {
      const size_t at = static_cast<size_t>(n) * k + tid;
      const int e = a.w.idx[at];
      const int s =
          a.w.offsets[static_cast<size_t>(n / kTokensPerBlock) * E + e] +
          a.slots[at];
      const int slot = s < C ? e * C + s : -1;
      a.slots[at] = slot;
      if (slot >= 0) a.ge[slot] = a.w.gates[at];
      s_dst[tid] = slot;
    }
    __syncthreads();
    const uint4* src = a.x + static_cast<size_t>(n) * V;
    for (int v = tid; v < V; v += blockDim.x) {
      const uint4 val = src[v];
      for (int j = 0; j < k; ++j) {
        const int d = s_dst[j];
        if (d >= 0) a.xe[static_cast<size_t>(d) * V + v] = val;
      }
    }
    return;
  }
  // expert e's empty slots, from min(total, C) on: zero rows, zero gates
  const int g = blockIdx.x - N;
  const int e = g / a.zero_blocks, part = g - e * a.zero_blocks;
  if (g == 0 && tid == 0) {                        // the aux loss, in order
    float s = 0.f;
    for (int i = 0; i < E; ++i) s += a.w.prods[i];
    a.aux[0] = a.n_experts * s;
  }
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int s = min(a.w.totals[e], C) + part; s < C; s += a.zero_blocks) {
    const size_t row = static_cast<size_t>(e) * C + s;
    if (tid == 0) a.ge[row] = 0.f;
    uint4* out = a.xe + row * V;
    for (int v = tid; v < V; v += blockDim.x) out[v] = zero;
  }
}

// A value rounded to the experts' type and back.
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
    moe_routed_combine_kernel(const uint4* __restrict__ y_e,
                              const float* __restrict__ ge,
                              const int* __restrict__ slots,
                              uint4* __restrict__ out, int top_k,
                              int row_vecs) {
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
      g[j] = round_to<T>(ge[s[j]]);
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
        acc[i] += round_to<T>(__fmul_rn(widen(y[i]), g[j]));
    }
  }
  uint4 res;
  T* o = reinterpret_cast<T*>(&res);
#pragma unroll
  for (int i = 0; i < L; ++i) o[i] = narrow<T>(acc[i]);
  out[static_cast<size_t>(n) * row_vecs + v] = res;
}

}  // namespace

extern "C" {

// Bytes of scratch moe_routed_dispatch_launch needs (4-byte aligned).
size_t moe_routed_workspace_bytes(int n_tokens, int e_pad, int top_k) {
  return 4 * work_words(n_tokens, e_pad, top_k);
}

// logits [N, e_pad] float32; x [N, d] and xe [e_pad, capacity, d] with rows
// of row_bytes (a multiple of 16); ge [e_pad, capacity] float32; slots
// [N, top_k] int32; aux one float32; work moe_routed_workspace_bytes.  All
// contiguous; logits, x and xe 16-byte aligned.  renormalize 0 keeps the
// top-k probabilities as the gates.
int moe_routed_dispatch_launch(const void* logits, const void* x, void* xe,
                               void* ge, void* slots, void* aux, void* work,
                               int n_tokens, int e_pad, int n_experts,
                               int top_k, int capacity, int row_bytes,
                               int renormalize, void* stream) {
  if (n_tokens < 1 || e_pad < 1 || e_pad > kMaxExperts || n_experts < 1 ||
      n_experts > e_pad || top_k < 1 || top_k > kMaxTopK || top_k > e_pad ||
      capacity < 1 ||
      static_cast<long long>(e_pad) * capacity > INT32_MAX ||
      static_cast<long long>(n_tokens) * top_k > INT32_MAX ||
      row_bytes < 16 || row_bytes % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Work w = carve(work, n_tokens, e_pad, top_k);
  const int blocks = route_blocks(n_tokens);
  const RouteArgs ra{static_cast<const float*>(logits),
                     static_cast<int*>(slots), w, n_tokens, e_pad,
                     n_experts, top_k, renormalize};
  moe_routed_route_kernel<<<blocks, kRouteThreads, 0, s>>>(ra);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  moe_routed_offsets_kernel<<<e_pad, kScanThreads, 0, s>>>(
      w, blocks, e_pad, n_experts, n_tokens, top_k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vecs = row_bytes / 16;
  const int zero_blocks = std::min(kMaxZeroBlocks, (capacity + 7) / 8);
  const FillArgs fa{static_cast<const uint4*>(x),
                    static_cast<uint4*>(xe),
                    static_cast<float*>(ge),
                    static_cast<int*>(slots),
                    static_cast<float*>(aux),
                    w, n_tokens, e_pad, n_experts, top_k, capacity, vecs,
                    zero_blocks};
  const int threads = std::min(kFillThreads, (vecs + 31) / 32 * 32);
  moe_routed_fill_kernel<<<n_tokens + e_pad * zero_blocks, threads, 0, s>>>(
      fa);
  return static_cast<int>(cudaGetLastError());
}

// dtype 0: float32, 1: bfloat16.  y_e [*, row_bytes] rows indexed by slots
// [N, top_k] (-1: none); ge float32 by slot; out [N, row_bytes].
int moe_routed_combine_launch(int dtype, const void* y_e, const void* ge,
                              const void* slots, void* out, int n_tokens,
                              int top_k, int row_bytes, void* stream) {
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
    moe_routed_combine_kernel<float><<<grid, threads, 0, s>>>(y, g, sl, o,
                                                              top_k, vecs);
  else
    moe_routed_combine_kernel<__nv_bfloat16><<<grid, threads, 0, s>>>(
        y, g, sl, o, top_k, vecs);
  return static_cast<int>(cudaGetLastError());
}

// which = 0: most experts (E_pad), 1: most top_k.
int moe_routed_limits(int which) {
  return which == 0 ? kMaxExperts : kMaxTopK;
}

}  // extern "C"
