// Flash attention for prefill on Hopper (sm_90a), bf16, on the tensor cores
// (B3's bf16 route for head dims 64, 128 and 256).
//
// Replaces the Pallas TPU kernel `flash_attention_bhsd` (its `_kernel`) in
// src/repro/kernels/flash_attention.py for bf16 inputs.  It computes what
// that kernel computes: each query position of head h attends the key
// positions of kv head h / r (r = H / KV) that its masks keep (causal:
// kpos <= qpos; window w: kpos > qpos - w), with scores scaled by
// 1/sqrt(D), masked scores at -1e30, slots past S at -inf and an online
// softmax over kv tiles, accumulated in fp32; the output is bf16.
// csrc/flash_attention.cu keeps float32 (all head dims) and bf16 at head
// dims 16 and 32; kernels/flash_attention.py routes between the two.
//
// Bound: at qwen2-0.5b's heads (14 q, 2 kv, D 64), causal, the operations
// (4 * D per kept (query, key) pair) over the 989 TFLOP/s bf16 tensor-core
// rate bound a long prefill (1 x 4096: 30 GFLOP, 0.030 ms); a batch of
// 512-token prompts sits just under the card's ~295 flops per byte, so its
// bytes bound it.  Either way the arithmetic has to run on the tensor
// cores in bf16, fed without stalls.
//
// Design.  One block per (sequence * head, 64 query rows) with one
// consumer warpgroup (128 threads) at D 64 and 128, so that four (D 64) or
// two (D 128) blocks share an SM and hide each other's waits; at D 256
// one block of two warpgroups (128 rows) per SM.  A block walks the kv
// tiles its rows keep:
//
// * Loads: TMA.  The Q tile is loaded once; K and V tiles of 64 slots come
//   through a ring of two stages in shared memory, each stage under an
//   mbarrier that counts the bytes TMA delivers.  Thread 0 issues the
//   loads of tile i + 2 as soon as every warp has finished tile i, so the
//   next tile's copy runs while the warpgroups compute on the current one.
//   Tensor maps are 4-D (D, S, heads, B) over the caller's element strides,
//   so the model's [B, S, H, D] activations are read in place; a row is
//   loaded as 64-column boxes of 128 bytes with the 128-byte swizzle, the
//   layout wgmma reads without bank conflicts.  Rows past S arrive as zeros.
// * S = Q K^T: wgmma.m64n64k16, Q and K both from shared memory (K-major),
//   fp32 accumulators in registers; D / 16 steps.
// * Masking and softmax: the mask is applied only on tiles that straddle
//   the diagonal, the window's edge or the end of the sequence; tiles that
//   every row of a warpgroup masks are skipped (exact: every row keeps its
//   own position, and once a kept key has set the row's max a masked key
//   adds exp(-1e30 - m) = 0).  The online softmax runs in registers with
//   exp2, log2(e) / sqrt(D) folded into the scale (a masked score is -1e30
//   in that domain, which changes nothing: it still weighs 0 beside a kept
//   key); a row's four threads reduce with two shuffles.
// * O += P V: P is rounded to bf16 in registers, where wgmma's accumulator
//   layout already is the A-operand layout, and wgmma.m64n64k16 reads V
//   from shared memory as an MN-major (transposed) B operand, once per 64
//   columns of D.
// * Epilogue: O / l, rounded to bf16, stored through the output's strides;
//   rows >= S are not written.  For the backward pass
//   (flash_attention_bwd.cu) it also writes each row's log-sum-exp in the
//   natural domain, (m + log2 l) * ln 2 (m is kept in the log2 domain),
//   to `lse` when the caller passes one; inference passes none.
// Blocks start from the last query tile to the first, over all heads, so
// the longest causal rows start first.
//
// What still holds it back (PERF.md has the numbers): within a warpgroup
// Q K^T, the softmax and P V run one after another, and every 64-row
// block reads all of its kv tiles from L2 again (at 1 x 4096 that is
// about 0.5 GB of L2 reads per call).  Issuing the next tile's Q K^T
// before this tile's softmax, with two score accumulators, ran slower:
// ptxas serialized the wgmmas (C7515), with or without zeroing the
// accumulators, and the registers cut the blocks per SM.  Later work: a
// producer warp with setmaxnreg and two consumer warpgroups taking turns
// (FA3's ping-pong), several query heads of a GQA group per block, a
// persistent grid.
//
// C interface (bound with ctypes): fa_wgmma_launch returns 0 on success,
// the cudaError_t of the launch, or kEncodeFailed + the CUresult when a
// tensor map cannot be encoded.  cuTensorMapEncodeTiled is reached through
// cudaGetDriverEntryPoint, so the library needs no -lcuda.

#include "wgmma_tile.cuh"

namespace {

using namespace wg;

constexpr int kBK = 64;         // kv slots per tile
constexpr float kMasked = -1e30f;

// One instantiation: head dim D, NWG consumer warpgroups of 64 query rows
// each, a ring of STAGES kv tiles, at least MINB blocks per SM.
template <int D_, int NWG_, int STAGES_, int MINB_>
struct Cfg {
  static constexpr int D = D_, NWG = NWG_, STAGES = STAGES_, MINB = MINB_;
  static constexpr int BQ = 64 * NWG, THREADS = 128 * NWG;
  static constexpr int NC = D / 64;                  // 64-column chunks
  static constexpr int Q_BYTES = NC * BQ * kRow;
  static constexpr int KV_BYTES = NC * kBK * kRow;   // one K or V tile
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  // barriers, and slack to align the base to the 1024-byte swizzle atom
  static constexpr int BYTES = BAR_OFF + 8 * (1 + STAGES) + 1024;
};

struct FwArgs {
  void* out;
  int H, KV, S;
  int64_t o_sb, o_sh, o_ss;
  int causal, window;
  float scale_log2;             // log2(e) / sqrt(D)
  float* lse;                   // [B, H, S] log-sum-exp of each row, or null
};

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// Accumulator element i of a thread of an m64n64 wgmma sits at row
// 16 * warp + lane / 4 + 8 * ((i / 2) % 2) and column
// 8 * (i / 4) + 2 * (lane % 4) + i % 2 of the warpgroup's 64 x 64 tile.
template <class C>
__global__ void __launch_bounds__(C::THREADS, C::MINB)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const FwArgs a) {
  constexpr int D = C::D, NC = C::NC, BQ = C::BQ;
  constexpr int kStages = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base, k_s = base + C::K_OFF, v_s = base + C::V_OFF;
  const uint32_t bar_q = base + C::BAR_OFF;           // then one per stage

  const int tid = threadIdx.x, wg = tid / 128;
  const int warp = (tid % 128) / 32, lane = tid % 32;
  // blocks start in the order of blockIdx.x + gridDim.x * blockIdx.y: the
  // last query tile of every head first, so that the longest causal rows
  // do not start last
  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh % a.H, kvh = h / (a.H / a.KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  // kv tiles [j0, j0 + n) that some row of the block keeps
  const int hi = a.causal ? min(a.S, q0 + BQ) : a.S;
  const int lo = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int j0 = lo / kBK, n = (hi + kBK - 1) / kBK - j0;

  if (tid == 0) {
    for (int s = 0; s <= kStages; ++s) mbar_init(bar_q + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto issue = [&](int it) {                   // tile j0 + it into its stage
    const int s = it % kStages, k0 = (j0 + it) * kBK;
    const uint32_t bar = bar_q + 8 * (1 + s);
    mbar_expect_tx(bar, 2 * C::KV_BYTES);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const uint32_t off = s * C::KV_BYTES + c * kBK * kRow;
      tma_load_4d(k_s + off, &tk, bar, 64 * c, k0, kvh, b);
      tma_load_4d(v_s + off, &tv, bar, 64 * c, k0, kvh, b);
    }
  };
  if (tid == 0) {
    mbar_expect_tx(bar_q, C::Q_BYTES);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      tma_load_4d(q_s + c * BQ * kRow, &tq, bar_q, 64 * c, q0, h, b);
    for (int it = 0; it < min(n, kStages); ++it) issue(it);
  }
  __syncwarp();

  const int qw = q0 + 64 * wg;                 // this warpgroup's first row
  const int row0 = qw + 16 * warp + lane / 4;  // rows row0 and row0 + 8
  const bool active = qw < a.S;
  float o[NC][32];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
  float m[2] = {neg_inf(), neg_inf()}, l[2] = {0.f, 0.f};
  mbar_wait(bar_q, 0);

  for (int it = 0; it < n; ++it) {
    const int s = it % kStages, k0 = (j0 + it) * kBK;
    const bool skip = !active || (a.causal && k0 > qw + 63) ||
                      (a.window > 0 && k0 + kBK - 1 <= qw - a.window);
    if (!skip) {
      mbar_wait(bar_q + 8 * (1 + s), (it / kStages) & 1);
      const uint32_t kt = k_s + s * C::KV_BYTES, vt = v_s + s * C::KV_BYTES;

      // S = Q K^T; no zeroing: the first step's scale-d 0 ignores sc
      float sc[32];
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;     // 16 columns = 32 bytes
        const uint64_t da = sw128_desc(
            q_s + (kk / 4) * BQ * kRow + wg * 64 * kRow + off, 16, 1024);
        const uint64_t db = sw128_desc(kt + (kk / 4) * kBK * kRow + off, 16,
                                       1024);
        wgmma_ss(sc, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      const bool edge = (a.causal && k0 + kBK - 1 > qw) ||
                        (a.window > 0 && k0 <= qw + 63 - a.window) ||
                        k0 + kBK > a.S;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        float x = sc[i] * a.scale_log2;
        if (edge) {
          const int row = row0 + 8 * ((i / 2) % 2);
          const int col = k0 + 8 * (i / 4) + 2 * (lane % 4) + i % 2;
          if (col >= a.S)
            x = neg_inf();
          else if ((a.causal && col > row) ||
                   (a.window > 0 && col <= row - a.window))
            x = kMasked;
        }
        sc[i] = x;
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float mx = neg_inf();
#pragma unroll
        for (int j = 0; j < 8; ++j)
          mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * rr], sc[4 * j + 2 * rr + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[rr], mx);     // >= -1e30: k0 < S
        const float alpha = exp2f(m[rr] - m_new);
        m[rr] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = exp2f(sc[4 * j + 2 * rr + e] - m_new);
            sc[4 * j + 2 * rr + e] = p;
            sum += p;
          }
        l[rr] = l[rr] * alpha + sum;              // this thread's columns
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            o[c][4 * j + 2 * rr] *= alpha;
            o[c][4 * j + 2 * rr + 1] *= alpha;
          }
      }
      // P in bf16 as wgmma A fragments, one per 16 slots
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pa[kk][e] = pack_bf16(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);
#pragma unroll
      for (int c = 0; c < NC; ++c) fence_regs(o[c]);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs(o[c], pa[kk],
                   sw128_desc(vt + c * kBK * kRow + kk * 16 * kRow,
                              kBK * kRow, 1024));
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int c = 0; c < NC; ++c) fence_regs(o[c]);
    }
    __syncthreads();                           // stage s fully read
    if (tid == 0 && it + kStages < n) issue(it + kStages);
    __syncwarp();
  }

  if (!active) return;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out) + b * a.o_sb +
                       h * a.o_sh;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float li = l[rr];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    const float inv = 1.f / (li == 0.f ? 1.f : li);
    const int row = row0 + 8 * rr;
    if (row < a.S) {
      if (a.lse != nullptr && lane % 4 == 0)
        a.lse[static_cast<int64_t>(bh) * a.S + row] =
            (m[rr] + log2f(li == 0.f ? 1.f : li)) * 0.6931471805599453f;
      __nv_bfloat16* orow = out + row * a.o_ss;
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 64 * c + 8 * j + 2 * (lane % 4);
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(o[c][4 * j + 2 * rr] * inv,
                                    o[c][4 * j + 2 * rr + 1] * inv);
        }
    }
  }
}

template <class C>
int launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
           const FwArgs& a, int B, cudaStream_t stream) {
  auto kernel = flash_attention_wgmma_kernel<C>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const dim3 grid(B * a.H, (a.S + C::BQ - 1) / C::BQ);
  kernel<<<grid, C::THREADS, C::BYTES, stream>>>(tq, tk, tv, a);
  return static_cast<int>(cudaGetLastError());
}

// The instantiation per head dim, chosen on an H100 (PERF.md): one
// warpgroup per block and a two-stage ring, so that four blocks (D 64) or
// two (D 128) share an SM and hide each other's waits; at D 256 the 64 KB
// tiles leave room for one block, so it takes two warpgroups.
using Cfg64 = Cfg<64, 1, 2, 4>;
using Cfg128 = Cfg<128, 1, 2, 2>;
using Cfg256 = Cfg<256, 2, 2, 1>;

template <class C>
int encode_and_launch(const void* q, const void* k, const void* v,
                      const FwArgs& a, int B, int KV, int64_t q_sb,
                      int64_t q_sh, int64_t q_ss, int64_t k_sb, int64_t k_sh,
                      int64_t k_ss, int64_t v_sb, int64_t v_sh, int64_t v_ss,
                      cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int err = encode(&tq, q, C::D, a.S, a.H, B, q_sb, q_sh, q_ss, C::BQ);
  if (!err) err = encode(&tk, k, C::D, a.S, KV, B, k_sb, k_sh, k_ss, kBK);
  if (!err) err = encode(&tv, v, C::D, a.S, KV, B, v_sb, v_sh, v_ss, kBK);
  if (err) return err;
  return launch<C>(tq, tk, tv, a, B, stream);
}

}  // namespace

extern "C" {

// bf16 only, D in {64, 128, 256}.  Strides are in elements; window <= 0:
// none; lse may be null.
int fa_wgmma_launch(const void* q, const void* k, const void* v, void* out,
                    int B, int H, int KV, int S, int D, int64_t q_sb,
                    int64_t q_sh, int64_t q_ss, int64_t k_sb, int64_t k_sh,
                    int64_t k_ss, int64_t v_sb, int64_t v_sh, int64_t v_ss,
                    int64_t o_sb, int64_t o_sh, int64_t o_ss, int causal,
                    int window, float scale_log2, float* lse, void* stream) {
  const FwArgs a{out, H,      KV,     S,          o_sb, o_sh,
                 o_ss, causal, window, scale_log2, lse};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return encode_and_launch<Cfg64>(q, k, v, a, B, KV, q_sb, q_sh, q_ss,
                                      k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, s);
    case 128:
      return encode_and_launch<Cfg128>(q, k, v, a, B, KV, q_sb, q_sh, q_ss,
                                       k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, s);
    case 256:
      return encode_and_launch<Cfg256>(q, k, v, a, B, KV, q_sb, q_sh, q_ss,
                                       k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
