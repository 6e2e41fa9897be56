// The backward pass of flash attention (B3) on Hopper (sm_90a), bf16 at
// head dims 64 and 128, on the tensor cores (the backward's `wgmma` route).
//
// The port's own kernel: the JAX package has no backward Pallas kernel (it
// differentiates its jnp attention, src/repro/models/attention.py); the
// TPU kernel it stands beside is `flash_attention_bhsd` in
// src/repro/kernels/flash_attention.py.  It computes what
// flash_attention_bwd.cu computes (its note gives the formulas): from q, k,
// v, the forward pass's output O and row log-sum-exp `lse` (natural
// domain), and dO, the gradients dQ, dK and dV, with dK and dV summed over
// the r = H / KV query heads of each kv head, in fp32, written in bf16.
// flash_attention_bwd.cu keeps float32 and bf16 at head dims 16, 32 and
// 256; kernels/flash_attention.py routes between the two (`bwd_route`).
//
// Bound (chip_smoke.time_flash_bwd): the bytes of q, k, v, O, dO and lse
// read and dq, dk, dv written, against 10 D operations per kept (query,
// key) pair (the five products Q K^T, dO V^T, P^T dO, dS K, dS^T Q) at the
// 989 TFLOP/s bf16 rate.  At qwen2-0.5b's training call (8 x 512, 14/2
// heads, D 64, causal) that is 34 MB, 0.0101 ms of bytes against 0.0095 ms
// of operations; at whisper's encoder (8 x 1,500, 12/12, D 64,
// bidirectional) 0.1398 ms of operations.
//
// Design.  Two kernels on the stream, so that no sum needs atomics and two
// calls give bitwise-equal gradients; both built like the forward kernel
// (flash_attention_wgmma.cu, helpers in wgmma_tile.cuh): tiles of 64 rows
// by TMA into 128-byte-swizzled shared memory under mbarriers, a two-stage
// ring whose next copies run while the tensor cores work, m64n64k16 wgmma
// with fp32 accumulators in registers.
//
// * dQ: one warpgroup per (sequence * query head, 64 query rows).  It
//   loads its Q and dO tiles once and, while they land, computes
//   delta = rowsum(dO * O) for its rows from global memory and writes it
//   with lse * log2(e) to a [B * H, 2, SP] scratch (SP: S rounded up to
//   64, the rows past S zeros) for the second kernel.  Then it walks the
//   kv tiles its rows keep through the ring of K and V tiles: S = Q K^T
//   and dP = dO V^T by wgmma from shared memory; P = exp2(S log2(e) /
//   sqrt(D) - lse log2(e)) and dS = P (dP - delta) in registers, masked
//   only on tiles that straddle a mask edge or the end of the sequence;
//   dS split into two bf16 parts (hi + lo) where the accumulator layout
//   already is the A operand's, and dQ += dS K by wgmma on each, with K
//   read MN-major.
// * dK, dV: one block per (sequence * kv head, 64 kv rows), in the
//   transposed form, so that P^T and dS^T come out of wgmma in the
//   register layout of an A operand and never touch shared memory.  The K
//   and V tiles are loaded once.  The block's work is the (query head of
//   the group, query tile that keeps some of its rows) pairs, head by
//   head; NW warpgroups take them in turns (pair i to warpgroup i % NW),
//   each through a ring of its own, whose slots carry a Q and a dO tile
//   and their rows' lse and delta (bulk copies from the scratch), with a
//   barrier of its own: the warpgroups run apart, so one's exponentials
//   overlap another's products.  Per
//   pair: S^T = K Q^T and dP^T = V dO^T; P^T and dS^T in registers,
//   each split into two bf16 parts; dV += P^T dO and dK += dS^T Q, a
//   wgmma per part, with dO and Q read MN-major from the tiles that fed
//   the first two.  At the end the warpgroups' fp32 sums meet in shared
//   memory and warpgroup 0 adds them in warpgroup order: a fixed order,
//   so the result does not depend on timing.  Splitting the GQA group
//   this way fills the card where the grid alone would not (qwen2-0.5b at
//   8 x 512: 128 blocks).
// * Rows past S arrive as zeros from TMA, are masked, and are not written.
// Blocks of the dQ kernel start from the last query tile, those of the
// dK/dV kernel from the first kv tile: under a causal mask, the longest.
//
// What still holds it back (PERF.md has the numbers): within a warpgroup
// the products, the exponentials and the next products run one after
// another; under a causal mask the blocks of the first kv tiles have
// eight times the pairs of the last; both kernels compute Q K^T and
// dO V^T, and P and dS enter
// their products in two parts, so the tensor cores do 20 D operations per
// kept pair where the five products need 10.  Later work: FA3's producer
// warp and ping-pong consumers, dQ in the dK/dV kernel through an fp32
// scratch.
//
// Layout: q, dq [B, H, S, D], k, v, dk, dv [B, KV, S, D] and O, dO as q,
// each with the element strides given (rows of 16 bytes, the last stride
// 1: the model's [B, S, heads, D] activations are read in place); lse
// [B, H, S] float32.
//
// C interface (bound with ctypes): fab_wgmma_launch runs both kernels on
// the stream and returns 0, the cudaError_t of a launch, or
// kEncodeFailed + the CUresult when a tensor map cannot be encoded.

#include "wgmma_tile.cuh"

namespace {

using namespace wg;

constexpr int kTile = 64;                 // rows of every tile
constexpr int kTileBytes = kTile * kRow;  // one 64-column chunk of a tile
constexpr float kLog2e = 1.4426950408889634f;

enum { kQ, kK, kV, kO, kDO, kDQ, kDK, kDV, kTensors };

struct BwArgs {
  const void* o;
  const void* dout;
  void* g[3];                   // dq, dk, dv
  const float* lse;
  float* stats;                 // [B * H, 2, SP]: lse * log2(e), delta
  int H, KV, S, SP;
  int64_t st[kTensors][3];      // element strides (batch, head, row)
  int causal, window;
  float scale_log2;             // log2(e) / sqrt(D)
  float scale;                  // 1 / sqrt(D)
};

__device__ __forceinline__ bool kept(const BwArgs& a, int qpos, int kpos) {
  return qpos < a.S && kpos < a.S && (!a.causal || kpos <= qpos) &&
         (a.window <= 0 || kpos > qpos - a.window);
}

// S (+)= X Y^T over D: X and Y 64-row tiles of D columns in shared memory,
// both K-major.
template <int D>
__device__ __forceinline__ void tile_dots(float (&s)[32], uint32_t x,
                                          uint32_t y) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * kTileBytes + (kk % 4) * 32;
    wgmma_ss(s, sw128_desc(x + off, 16, 1024), sw128_desc(y + off, 16, 1024),
             kk > 0);
  }
}

// acc[c] += A Y[:, 64 c : 64 c + 64]: A the 64 x 64 bf16 fragments in
// registers, Y a 64-row tile of D columns read MN-major.
template <int NC>
__device__ __forceinline__ void tile_acc(float (&acc)[NC][32],
                                         const uint32_t (&a)[4][4],
                                         uint32_t y) {
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(acc[c], a[kk],
               sw128_desc(y + c * kTileBytes + kk * 16 * kRow, kTileBytes,
                          1024));
}

// 32 accumulators as the A fragments of following wgmmas, split into two
// bf16 parts, x = hi + lo: each product runs twice, on hi and on lo, so
// that P and dS enter it with about 16 bits, not bf16's 8 (rounded to
// bf16 alone, the GQA group's sums missed the plain backward by up to 2e-2).
__device__ __forceinline__ void to_frags(const float (&x)[32],
                                         uint32_t (&hi)[4][4],
                                         uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x0 = x[8 * kk + 2 * e], x1 = x[8 * kk + 2 * e + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
      const float2 hf = __bfloat1622float2(h);
      hi[kk][e] = *reinterpret_cast<const uint32_t*>(&h);
      lo[kk][e] = pack_bf16(x0 - hf.x, x1 - hf.y);
    }
}

// The dQ kernel: head dim D, a ring of STAGES kv tiles, at least MINB
// blocks per SM.
template <int D_, int STAGES_, int MINB_>
struct DqCfg {
  static constexpr int D = D_, STAGES = STAGES_, MINB = MINB_;
  static constexpr int NC = D / 64;
  static constexpr int T_BYTES = NC * kTileBytes;   // one tile of D columns
  static constexpr int DO_OFF = T_BYTES;
  static constexpr int K_OFF = 2 * T_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * T_BYTES;
  static constexpr int ROW_OFF = V_OFF + STAGES * T_BYTES;   // 2 x 64 floats
  static constexpr int BAR_OFF = ROW_OFF + 2 * kTile * 4;
  static constexpr int BYTES = BAR_OFF + 8 * (1 + STAGES) + 1024;
};

template <class C>
__global__ void __launch_bounds__(128, C::MINB)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const BwArgs a) {
  constexpr int D = C::D, NC = C::NC, kStages = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t q_s = base, do_s = base + C::DO_OFF;
  const uint32_t k_s = base + C::K_OFF, v_s = base + C::V_OFF;
  const uint32_t bar0 = base + C::BAR_OFF;          // then one per stage
  float* l2_s = reinterpret_cast<float*>(gbase + C::ROW_OFF);
  float* dl_s = l2_s + kTile;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh % a.H, kvh = h / (a.H / a.KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  // kv tiles [j0, j0 + n) that some row of the block keeps; with one
  // warpgroup per block, none of them is masked for all its rows
  const int hi = a.causal ? min(a.S, q0 + kTile) : a.S;
  const int lo = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int j0 = lo / kTile, n = (hi + kTile - 1) / kTile - j0;

  if (tid == 0) {
    for (int s = 0; s <= kStages; ++s) mbar_init(bar0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto issue = [&](int it) {                   // kv tile j0 + it, its stage
    const int s = it % kStages, k0 = (j0 + it) * kTile;
    const uint32_t bar = bar0 + 8 * (1 + s);
    mbar_expect_tx(bar, 2 * C::T_BYTES);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const uint32_t off = s * C::T_BYTES + c * kTileBytes;
      tma_load_4d(k_s + off, &tk, bar, 64 * c, k0, kvh, b);
      tma_load_4d(v_s + off, &tv, bar, 64 * c, k0, kvh, b);
    }
  };
  if (tid == 0) {
    mbar_expect_tx(bar0, 2 * C::T_BYTES);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      tma_load_4d(q_s + c * kTileBytes, &tq, bar0, 64 * c, q0, h, b);
      tma_load_4d(do_s + c * kTileBytes, &tdo, bar0, 64 * c, q0, h, b);
    }
    for (int it = 0; it < min(n, kStages); ++it) issue(it);
  }
  __syncwarp();

  // delta = rowsum(dO * O) and lse * log2(e) of the block's rows, while
  // the tiles land: two threads a row, D / 2 columns each
  {
    const int row = tid / 2, qpos = q0 + row;
    float part = 0.f;
    if (qpos < a.S) {
      const int col = (tid % 2) * (D / 2);
      const uint4* orow = reinterpret_cast<const uint4*>(
          static_cast<const __nv_bfloat16*>(a.o) + b * a.st[kO][0] +
          h * a.st[kO][1] + qpos * a.st[kO][2] + col);
      const uint4* drow = reinterpret_cast<const uint4*>(
          static_cast<const __nv_bfloat16*>(a.dout) + b * a.st[kDO][0] +
          h * a.st[kDO][1] + qpos * a.st[kDO][2] + col);
#pragma unroll
      for (int u = 0; u < D / 16; ++u) {
        const uint4 ov = orow[u], dv = drow[u];
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 of = __bfloat1622float2(o2[e]);
          const float2 df = __bfloat1622float2(d2[e]);
          part = fmaf(df.x, of.x, part);
          part = fmaf(df.y, of.y, part);
        }
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    if (tid % 2 == 0) {
      const float l2 = qpos < a.S
          ? a.lse[static_cast<int64_t>(bh) * a.S + qpos] * kLog2e : 0.f;
      l2_s[row] = l2;
      dl_s[row] = part;
      float* st = a.stats + static_cast<int64_t>(bh) * 2 * a.SP + qpos;
      st[0] = l2;
      st[a.SP] = part;
    }
  }
  __syncthreads();

  const int rl = 16 * warp + lane / 4;          // local rows rl and rl + 8
  const float l2r[2] = {l2_s[rl], l2_s[rl + 8]};
  const float dlr[2] = {dl_s[rl], dl_s[rl + 8]};
  float dq[NC][32];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[c][i] = 0.f;
  mbar_wait(bar0, 0);

  for (int it = 0; it < n; ++it) {
    const int s = it % kStages, k0 = (j0 + it) * kTile;
    mbar_wait(bar0 + 8 * (1 + s), (it / kStages) & 1);
    const uint32_t kt = k_s + s * C::T_BYTES, vt = v_s + s * C::T_BYTES;

    // S = Q K^T, dP = dO V^T; no zeroing: a first step's scale-d 0
    float sc[32], dp[32];
    fence_regs(sc);
    fence_regs(dp);
    wgmma_fence();
    tile_dots<D>(sc, q_s, kt);
    tile_dots<D>(dp, do_s, vt);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(dp);

    const bool edge = (a.causal && k0 + kTile - 1 > q0) ||
                      (a.window > 0 && k0 <= q0 + kTile - 1 - a.window) ||
                      k0 + kTile > a.S || q0 + kTile > a.S;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int rr = (i / 2) % 2;
      const float p = exp2f(sc[i] * a.scale_log2 - l2r[rr]);
      float ds = p * (dp[i] - dlr[rr]);
      if (edge) {
        const int row = q0 + rl + 8 * rr;
        const int col = k0 + 8 * (i / 4) + 2 * (lane % 4) + i % 2;
        if (!kept(a, row, col)) ds = 0.f;
      }
      sc[i] = ds;
    }
    uint32_t ds_hi[4][4], ds_lo[4][4];
    to_frags(sc, ds_hi, ds_lo);
#pragma unroll
    for (int c = 0; c < NC; ++c) fence_regs(dq[c]);
    wgmma_fence();
    tile_acc<NC>(dq, ds_hi, kt);                 // dQ += dS K
    tile_acc<NC>(dq, ds_lo, kt);
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < NC; ++c) fence_regs(dq[c]);

    __syncthreads();                           // stage s fully read
    if (tid == 0 && it + kStages < n) issue(it + kStages);
    __syncwarp();
  }

  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.g[0]) +
                       b * a.st[kDQ][0] + h * a.st[kDQ][1];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = q0 + rl + 8 * rr;
    if (row >= a.S) continue;
    __nv_bfloat16* orow = out + row * a.st[kDQ][2];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * c + 8 * j + 2 * (lane % 4);
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(dq[c][4 * j + 2 * rr] * a.scale,
                                  dq[c][4 * j + 2 * rr + 1] * a.scale);
      }
  }
}

// The dK/dV kernel: head dim D, NW warpgroups, each with a ring of STAGES
// slots, a slot one (head, query tile) pair.
template <int D_, int NW_, int STAGES_>
struct DkvCfg {
  static constexpr int D = D_, NW = NW_, STAGES = STAGES_;
  static constexpr int NC = D / 64, THREADS = 128 * NW;
  static constexpr int T_BYTES = NC * kTileBytes;
  static constexpr int V_OFF = T_BYTES;
  static constexpr int RING_OFF = 2 * T_BYTES;
  // a slot: the pair's Q tile, its dO tile, then its rows' lse and delta
  // (2 x 64 floats), padded to the 1024-byte swizzle atom
  static constexpr int ROWS_OFF = 2 * T_BYTES;
  static constexpr int SLOT = ROWS_OFF + 1024;
  static constexpr int BAR_OFF = RING_OFF + NW * STAGES * SLOT;
  static constexpr int BYTES = BAR_OFF + 8 * (1 + NW * STAGES) + 1024;
  // warpgroups 1.. leave their fp32 dK and dV in the ring at the end
  static_assert((NW - 1) * 2 * NC * 32 * 128 * 4 <= NW * STAGES * SLOT,
                "the ring must hold the warpgroups' sums");
};

// Waits at named barrier `id` for the `threads` threads that use it.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <class C>
__global__ void __launch_bounds__(C::THREADS, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo,
                           const BwArgs a) {
  constexpr int D = C::D, NC = C::NC, NW = C::NW, kStages = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t k_s = base, v_s = base + C::V_OFF;
  const uint32_t bar_kv = base + C::BAR_OFF;   // then one per (wg, slot)

  const int tid = threadIdx.x, wgi = tid / 128;
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int bkv = blockIdx.x, b = bkv / a.KV, kvh = bkv % a.KV;
  const int r = a.H / a.KV;
  const int kv0 = blockIdx.y * kTile;
  // query tiles [t0, t0 + nqt) that keep some of the block's kv rows
  const int t0 = a.causal ? kv0 / kTile : 0;
  const int qhi = a.window > 0 ? min(a.S, kv0 + kTile - 1 + a.window) : a.S;
  const int nqt = (qhi + kTile - 1) / kTile - t0;
  // this warpgroup's pairs: wgi, wgi + NW, ... of the block's r * nqt
  const int n = (r * nqt - wgi + NW - 1) / NW;
  const uint32_t ring = base + C::RING_OFF + wgi * kStages * C::SLOT;
  const uint32_t bars = bar_kv + 8 * (1 + wgi * kStages);
  const bool leader = tid % 128 == 0;

  if (tid == 0) {
    for (int s = 0; s <= NW * kStages; ++s) mbar_init(bar_kv + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto issue = [&](int it) {           // this warpgroup's pair it, its slot
    const int pair = it * NW + wgi;
    const int h = kvh * r + pair / nqt, q0 = (t0 + pair % nqt) * kTile;
    const uint32_t slot = ring + (it % kStages) * C::SLOT;
    const uint32_t bar = bars + 8 * (it % kStages);
    mbar_expect_tx(bar, 2 * C::T_BYTES + 2 * kTile * 4);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      tma_load_4d(slot + c * kTileBytes, &tq, bar, 64 * c, q0, h, b);
      tma_load_4d(slot + C::T_BYTES + c * kTileBytes, &tdo, bar, 64 * c, q0,
                  h, b);
    }
    const float* rows = a.stats +
                        static_cast<int64_t>(b * a.H + h) * 2 * a.SP + q0;
    bulk_load(slot + C::ROWS_OFF, rows, kTile * 4, bar);
    bulk_load(slot + C::ROWS_OFF + kTile * 4, rows + a.SP, kTile * 4, bar);
  };
  if (tid == 0) {
    mbar_expect_tx(bar_kv, 2 * C::T_BYTES);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      tma_load_4d(k_s + c * kTileBytes, &tk, bar_kv, 64 * c, kv0, kvh, b);
      tma_load_4d(v_s + c * kTileBytes, &tv, bar_kv, 64 * c, kv0, kvh, b);
    }
  }
  if (leader)
    for (int it = 0; it < min(n, kStages); ++it) issue(it);
  __syncwarp();

  const int kl = 16 * warp + lane / 4;          // local kv rows kl, kl + 8
  float dk[NC][32], dv[NC][32];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[c][i] = dv[c][i] = 0.f;
  mbar_wait(bar_kv, 0);

  // the warpgroups run apart, each on its own slots, so that one's
  // exponentials overlap another's products
  for (int it = 0; it < n; ++it) {
    const int s = it % kStages, pair = it * NW + wgi;
    mbar_wait(bars + 8 * s, (it / kStages) & 1);
    const int q0 = (t0 + pair % nqt) * kTile;
    const uint32_t qt = ring + s * C::SLOT, dot = qt + C::T_BYTES;
    const float* l2_s = reinterpret_cast<const float*>(
        gbase + (qt - base) + C::ROWS_OFF);
    const float* dl_s = l2_s + kTile;

    // S^T = K Q^T, dP^T = V dO^T
    float sc[32], dp[32];
    fence_regs(sc);
    fence_regs(dp);
    wgmma_fence();
    tile_dots<D>(sc, k_s, qt);
    tile_dots<D>(dp, v_s, dot);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(dp);

    const bool edge = (a.causal && q0 < kv0 + kTile - 1) ||
                      (a.window > 0 && q0 + kTile - 1 >= kv0 + a.window) ||
                      q0 + kTile > a.S || kv0 + kTile > a.S;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ql = 8 * j + 2 * (lane % 4) + e;   // this column's row
        const float l2 = l2_s[ql], dl = dl_s[ql];
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int i = 4 * j + 2 * rr + e;
          float p = exp2f(sc[i] * a.scale_log2 - l2);
          float ds = p * (dp[i] - dl);
          if (edge && !kept(a, q0 + ql, kv0 + kl + 8 * rr)) p = ds = 0.f;
          sc[i] = p;
          dp[i] = ds;
        }
      }
    uint32_t hi[4][4], lo[4][4];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      fence_regs(dv[c]);
      fence_regs(dk[c]);
    }
    to_frags(sc, hi, lo);
    wgmma_fence();
    tile_acc<NC>(dv, hi, dot);                 // dV += P^T dO
    tile_acc<NC>(dv, lo, dot);
    uint32_t ds_hi[4][4], ds_lo[4][4];
    to_frags(dp, ds_hi, ds_lo);
    tile_acc<NC>(dk, ds_hi, qt);               // dK += dS^T Q
    tile_acc<NC>(dk, ds_lo, qt);
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      fence_regs(dv[c]);
      fence_regs(dk[c]);
    }
    named_sync(1 + wgi, 128);                  // slot s fully read
    if (leader && it + kStages < n) issue(it + kStages);
    __syncwarp();
  }
  __syncthreads();

  // the warpgroups' sums, added by warpgroup 0 in warpgroup order (every
  // copy into the ring has landed: each was waited for)
  float* red = reinterpret_cast<float*>(gbase + C::RING_OFF);
  constexpr int PER = 2 * NC * 32;               // floats per thread
  const int t = tid % 128;
  if (wgi > 0) {
    float* mine = red + (wgi - 1) * PER * 128;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        mine[(c * 32 + i) * 128 + t] = dk[c][i];
        mine[((NC + c) * 32 + i) * 128 + t] = dv[c][i];
      }
  }
  __syncthreads();
  if (wgi > 0) return;
  for (int w = 1; w < NW; ++w) {
    const float* other = red + (w - 1) * PER * 128;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        dk[c][i] += other[(c * 32 + i) * 128 + t];
        dv[c][i] += other[((NC + c) * 32 + i) * 128 + t];
      }
  }
  __nv_bfloat16* gk = static_cast<__nv_bfloat16*>(a.g[1]) +
                      b * a.st[kDK][0] + kvh * a.st[kDK][1];
  __nv_bfloat16* gv = static_cast<__nv_bfloat16*>(a.g[2]) +
                      b * a.st[kDV][0] + kvh * a.st[kDV][1];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = kv0 + kl + 8 * rr;
    if (row >= a.S) continue;
    __nv_bfloat16* krow = gk + row * a.st[kDK][2];
    __nv_bfloat16* vrow = gv + row * a.st[kDV][2];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * c + 8 * j + 2 * (lane % 4);
        const int i = 4 * j + 2 * rr;
        *reinterpret_cast<__nv_bfloat162*>(krow + col) =
            __floats2bfloat162_rn(dk[c][i] * a.scale, dk[c][i + 1] * a.scale);
        *reinterpret_cast<__nv_bfloat162*>(vrow + col) =
            __floats2bfloat162_rn(dv[c][i], dv[c][i + 1]);
      }
  }
}

template <class K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <class Q, class KV>
int launch(const CUtensorMap (&maps)[4], const BwArgs& a, int B,
           cudaStream_t stream) {
  auto k_dq = flash_bwd_dq_wgmma_kernel<Q>;
  auto k_dkv = flash_bwd_dkv_wgmma_kernel<KV>;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = allow_smem(k_dq, Q::BYTES);
    if (err == cudaSuccess) err = allow_smem(k_dkv, KV::BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const int tiles = a.SP / kTile;
  k_dq<<<dim3(B * a.H, tiles), 128, Q::BYTES, stream>>>(
      maps[0], maps[1], maps[2], maps[3], a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  k_dkv<<<dim3(B * a.KV, tiles), KV::THREADS, KV::BYTES, stream>>>(
      maps[0], maps[1], maps[2], maps[3], a);
  return static_cast<int>(cudaGetLastError());
}

// The instantiations per head dim, chosen on an H100 (PERF.md): the dQ
// kernel like the forward's (one warpgroup, a two-stage ring, three blocks
// per SM at D 64, two at D 128; four at D 64 gained nothing); the dK/dV
// kernel with three warpgroups sharing a block's pairs at D 64 (faster
// than two at 8 x 512 and 8 x 1,500, though ptxas then spills 16 bytes)
// and two at D 128, whose accumulators need 249 registers.
int dispatch(const CUtensorMap (&maps)[4], const BwArgs& a, int B, int D,
             cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<DqCfg<64, 2, 3>, DkvCfg<64, 3, 2>>(maps, a, B, stream);
    case 128:
      return launch<DqCfg<128, 2, 2>, DkvCfg<128, 2, 2>>(maps, a, B, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// SP, the row count of fab_wgmma_launch's stats scratch: S rounded up to
// a whole tile
int fab_wgmma_rows(int S) { return (S + kTile - 1) / kTile * kTile; }

// bf16 only, D in {64, 128}.  strides: 24 element strides, (batch, head,
// row) of q, k, v, o, dout, dq, dk, dv in that order; window <= 0: none;
// stats: [B * H, 2, fab_wgmma_rows(S)] float32 scratch.
int fab_wgmma_launch(const void* q, const void* k, const void* v,
                     const void* o, const void* dout, const float* lse,
                     float* stats, void* dq, void* dk, void* dv, int B, int H,
                     int KV, int S, int D, const int64_t* strides, int causal,
                     int window, float scale_log2, float scale,
                     void* stream) {
  BwArgs a;
  a.o = o;
  a.dout = dout;
  a.g[0] = dq;
  a.g[1] = dk;
  a.g[2] = dv;
  a.lse = lse;
  a.stats = stats;
  a.H = H;
  a.KV = KV;
  a.S = S;
  a.SP = fab_wgmma_rows(S);
  for (int i = 0; i < kTensors; ++i)
    for (int j = 0; j < 3; ++j) a.st[i][j] = strides[3 * i + j];
  a.causal = causal;
  a.window = window;
  a.scale_log2 = scale_log2;
  a.scale = scale;
  // make this device's context current to the calling thread (autograd
  // runs the backward pass on a thread of its own, where a tensor map
  // would otherwise be encoded with no current context)
  int dev = 0;
  cudaError_t bound = cudaGetDevice(&dev);
  if (bound == cudaSuccess) bound = cudaSetDevice(dev);
  if (bound != cudaSuccess) return static_cast<int>(bound);
  const int64_t* s = strides;
  CUtensorMap maps[4];        // q, k, v, dout
  int err = encode(&maps[0], q, D, S, H, B, s[0], s[1], s[2], kTile);
  if (!err) err = encode(&maps[1], k, D, S, KV, B, s[3], s[4], s[5], kTile);
  if (!err) err = encode(&maps[2], v, D, S, KV, B, s[6], s[7], s[8], kTile);
  if (!err)
    err = encode(&maps[3], dout, D, S, H, B, s[12], s[13], s[14], kTile);
  if (err) return err;
  return dispatch(maps, a, B, D, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
