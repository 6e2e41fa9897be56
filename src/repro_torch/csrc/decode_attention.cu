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
// bytes over 3.35 TB/s.  To reach it the kernel must keep enough loads in
// flight on every SM, and its arithmetic must stay off the critical path:
// with the r heads padded to 16 rows, fp32 FMAs alone would take about as
// long as the bytes.
//
// Design.
// * Split over S (flash-decoding): the grid is (B * KV * row groups,
//   n_splits); a row group is 16 of the r query heads (r <= 48: at most 3).
//   Split i takes tiles [i * tps, (i + 1) * tps) of the cache, with the
//   count chosen by the wrapper so that the grid covers about two waves of
//   the SMs, at most 16 (one block merges them in turn); every split holds
//   at least one tile.
// * Loads: a ring of STAGES tiles in shared memory, filled with cp.async
//   (16-byte copies; slots past S are zero-filled), so the next tiles'
//   loads run while this tile is computed.  K and V stay in their own type;
//   rows are padded by 16 bytes, so ldmatrix reads are free of bank
//   conflicts.  Each tile's slot positions come along, 4 bytes each.
// * Arithmetic, bf16: mma.sync.m16n8k16 on the tensor cores, for Q K^T and
//   for P V, fp32 accumulators.  Each of the 4 warps takes 16 slots of a
//   64-slot tile and keeps its own online softmax (m, l, o) over its slots;
//   P is rounded to bf16 in registers, where the m16n8 accumulator layout
//   is the A-fragment layout.  fp32: the same split, ring and warp split
//   on CUDA-core FMAs (two threads per row, each owning half of the slots
//   for the scores and half of D for the output), so float32 keeps its
//   2e-5 agreement with the plain version.
// * Combine: the block merges its warps' states in shared memory.  With one
//   split it writes the output.  Otherwise it writes its (m, l, o) in fp32
//   to a scratch, and the last block of its (b, g, row group) to finish
//   (a __threadfence and an atomic counter, reset by that block, so no
//   memset is needed) merges the splits with a log-sum-exp rescale, in
//   split order, not arrival order: two calls give bitwise-equal outputs.
//   A row with no kept slot has m = -1e30 in every split, so the merge
//   gives the uniform mean of V; a state with m = -inf (a warp whose slots
//   all lie past S) weighs exactly 0.
// * Log-sum-exp: given an lse buffer, the block that writes a row's output
//   also writes the float32 natural log-sum-exp of its masked, scaled
//   scores, ln 2 (m + log2 l) from the merged base-2 state (-1e30 + ln l
//   for a row with no kept slot, as the plain version gives), so that
//   results over disjoint slot ranges can be merged by the caller.
//
// Layout: q is [B, H, D] and the caches [B, KV, S, D], all with element
// strides given by the caller (last one 1), so the model's [B, S, KV, D]
// cache is read in place; cache_len and positions may have batch stride 0.
//
// C interface (bound with ctypes): da_launch returns the cudaError_t of the
// launch, 0 on success; da_tile_slots the slots per tile of an
// instantiation (kernels/decode_attention.py mirrors it).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = 4;
constexpr int kRows = 16;             // query heads per block (row group)
constexpr float kMasked = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;

template <typename T, int D>
struct Cfg {
  static constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int BK = kMma || D <= 64 ? 64 : 32;     // slots per tile
  static constexpr int SW = BK / kWarps;                    // slots per warp
  static constexpr int STAGES = kMma && D <= 128 ? 3 : 2;
  static constexpr int PITCH = D * static_cast<int>(sizeof(T)) + 16;
  static constexpr int TILE = BK * PITCH;                   // K or V
  static constexpr int STAGE = 2 * TILE + BK * 4;           // K, V, positions
  static constexpr int RING = STAGES * STAGE;
  static constexpr int Q_BYTES = kRows * PITCH;
  // per warp: m and l of 16 rows, o of 16 x D (fp32), reusing the ring
  static constexpr int PART = kWarps * kRows * (D + 2) * 4;
  static constexpr int SMEM = Q_BYTES + (RING > PART ? RING : PART) + 16;
};

struct DaArgs {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* cache_len;
  const int32_t* positions;
  void* out;
  float* lse;                   // [B, H] or null
  float* part;                  // [grid.x, n_splits, 16, D + 2] if n_splits > 1
  int* counters;                // [grid.x], zero between calls
  int H, KV, S, row_groups, tiles_per_split;
  int64_t q_sb, q_sh, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, cl_sb, pos_sb;
  int window;
  float scale_log2;             // log2(e) / sqrt(D)
};

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// The natural log-sum-exp of a row from its base-2 state (m, l), l >= 1.
__device__ __forceinline__ float natural_lse(float m, float l) {
  return (m == kMasked ? kMasked : m * kLn2) + logf(l);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; `bytes` 0 fills the destination with zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// c += a b: m16n8k16, bf16 inputs, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float& c0, float& c1, float& c2,
                                         float& c3, const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c0), "+f"(c1), "+f"(c2), "+f"(c3)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Score of one slot in the exp2 domain: kept, masked (-1e30) or outside
// the cache (-inf).
__device__ __forceinline__ float masked_score(float s, int slot, int pos,
                                              const DaArgs& a, int clen) {
  if (slot >= a.S) return neg_inf();
  const bool keep = pos >= 0 && pos < clen &&
                    (a.window <= 0 || pos > clen - 1 - a.window);
  return keep ? s * a.scale_log2 : kMasked;
}

// The online-softmax step of one row: the new max (never -inf once a
// slot of the cache was seen) and the factor that rescales the old state.
__device__ __forceinline__ float step_max(float& m, float mx, float& alpha) {
  const float m_new = fmaxf(m, mx);
  const float m_use = m_new == neg_inf() ? 0.f : m_new;
  alpha = exp2f(m - m_use);
  m = m_new;
  return m_use;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const DaArgs a) {
  using C = Cfg<T, D>;
  constexpr int BK = C::BK, SW = C::SW, STAGES = C::STAGES, P = C::PITCH;
  extern __shared__ float4 smem4[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem4);
  uint8_t* q_s = smem;
  uint8_t* ring = smem + C::Q_BYTES;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bg = blockIdx.x / a.row_groups, rgi = blockIdx.x % a.row_groups;
  const int b = bg / a.KV, g = bg % a.KV;
  const int r = a.H / a.KV, row0 = rgi * kRows, nrows = min(kRows, r - row0);
  const int split = blockIdx.y, n_splits = gridDim.y;
  const int tiles = (a.S + BK - 1) / BK;
  const int t0 = split * a.tiles_per_split;
  const int t1 = min(tiles, t0 + a.tiles_per_split);
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + (g * r + row0) * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + g * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + g * a.v_sh;
  const int32_t* pos = a.positions + b * a.pos_sb;
  const int clen = a.cache_len[b * a.cl_sb];

  // Q rows of this group (zeros past r), in T
  constexpr int QCH = D * static_cast<int>(sizeof(T)) / 16;   // 16 B chunks/row
  for (int c = tid; c < kRows * QCH; c += kThreads) {
    const int row = c / QCH, col = c % QCH;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (row < nrows)
      x = *reinterpret_cast<const uint4*>(
          reinterpret_cast<const uint8_t*>(q + row * a.q_sh) + 16 * col);
    *reinterpret_cast<uint4*>(q_s + row * P + 16 * col) = x;
  }

  auto issue = [&](int t) {                   // tile t into its ring stage
    uint8_t* st = ring + ((t - t0) % STAGES) * C::STAGE;
    const uint32_t ks = smem_u32(st), vs = ks + C::TILE;
    const uint32_t ps = vs + C::TILE;
    const int k0 = t * BK;
    for (int c = tid; c < BK * QCH; c += kThreads) {
      const int row = c / QCH, col = c % QCH;
      const int slot = k0 + row;
      const int ok = slot < a.S;
      const int64_t srow = ok ? slot : k0;
      cp_async16(ks + row * P + 16 * col,
                 reinterpret_cast<const uint8_t*>(k + srow * a.k_ss) + 16 * col,
                 ok ? 16 : 0);
      cp_async16(vs + row * P + 16 * col,
                 reinterpret_cast<const uint8_t*>(v + srow * a.v_ss) + 16 * col,
                 ok ? 16 : 0);
    }
    for (int c = tid; c < BK; c += kThreads)
      if (k0 + c < a.S) cp_async4(ps + 4 * c, pos + k0 + c);
  };

  // per-thread state: bf16 rows lane/4 and lane/4 + 8, fp32 row lane/2
  constexpr int NR = C::kMma ? 2 : 1;
  // bf16: o[4 n8 + 2 rr + e] is row lane/4 + 8 rr, column
  // 8 n8 + 2 (lane % 4) + e; fp32: o[dd] is column half * D/2 + dd
  constexpr int NO = D / 2;
  float o[NO], m[NR], l[NR];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    m[i] = neg_inf();
    l[i] = 0.f;
  }

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (t0 + i < t1) issue(t0 + i);
    cp_async_commit();
  }
  for (int t = t0; t < t1; ++t) {
    if (t + STAGES - 1 < t1) issue(t + STAGES - 1);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    __syncthreads();                          // tile t (and Q) in place
    const uint8_t* st = ring + ((t - t0) % STAGES) * C::STAGE;
    const uint8_t* ks = st;
    const uint8_t* vs = st + C::TILE;
    const int32_t* ps = reinterpret_cast<const int32_t*>(st + 2 * C::TILE);
    const int k0 = t * BK, w0 = warp * SW;    // this warp's slots

    if constexpr (C::kMma) {
      // S = Q K^T for 16 rows x 16 slots: two n8 tiles
      float s[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int mi = lane / 8;
        uint32_t qa[4], kb[4];
        ldmatrix_x4(qa, smem_u32(q_s + ((mi % 2) * 8 + lane % 8) * P +
                                 (kk * 16 + (mi / 2) * 8) * 2));
        ldmatrix_x4(kb, smem_u32(ks + (w0 + (mi / 2) * 8 + lane % 8) * P +
                                 (kk * 16 + (mi % 2) * 8) * 2));
        mma_bf16(s[0][0], s[0][1], s[0][2], s[0][3], qa, kb[0], kb[1]);
        mma_bf16(s[1][0], s[1][1], s[1][2], s[1][3], qa, kb[2], kb[3]);
      }
      // mask, online softmax; element (nt, e): row lane/4 + 8 (e / 2),
      // slot w0 + 8 nt + 2 (lane % 4) + e % 2
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = w0 + 8 * nt + 2 * (lane % 4) + e % 2;
          s[nt][e] = masked_score(s[nt][e], k0 + j, ps[j], a, clen);
        }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float mx = fmaxf(fmaxf(s[0][2 * rr], s[0][2 * rr + 1]),
                         fmaxf(s[1][2 * rr], s[1][2 * rr + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        float alpha;
        const float mu = step_max(m[rr], mx, alpha);
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = exp2f(s[nt][2 * rr + e] - mu);
            s[nt][2 * rr + e] = p;
            sum += p;
          }
        l[rr] = l[rr] * alpha + sum;          // this thread's slots
#pragma unroll
        for (int n8 = 0; n8 < D / 8; ++n8) {
          o[4 * n8 + 2 * rr] *= alpha;
          o[4 * n8 + 2 * rr + 1] *= alpha;
        }
      }
      uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                        pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        const int mi = lane / 8;
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, smem_u32(vs + (w0 + (mi % 2) * 8 + lane % 8) * P +
                                       (dn * 16 + (mi / 2) * 8) * 2));
        mma_bf16(o[8 * dn], o[8 * dn + 1], o[8 * dn + 2], o[8 * dn + 3], pa,
                 vb[0], vb[1]);
        mma_bf16(o[8 * dn + 4], o[8 * dn + 5], o[8 * dn + 6], o[8 * dn + 7],
                 pa, vb[2], vb[3]);
      }
    } else {
      // fp32: thread (row lane/2, half lane%2) scores slots
      // w0 + half * SW/2 + jj and accumulates columns half * D/2 + dd
      constexpr int HS = SW / 2;
      const int row = lane / 2, half = lane % 2;
      const float* qr = reinterpret_cast<const float*>(q_s + row * P);
      float s[HS];
#pragma unroll
      for (int jj = 0; jj < HS; ++jj) s[jj] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; d += 4) {
        const float4 qv = *reinterpret_cast<const float4*>(qr + d);
#pragma unroll
        for (int jj = 0; jj < HS; ++jj) {
          const float4 kv = *reinterpret_cast<const float4*>(
              ks + (w0 + half * HS + jj) * P + 4 * d);
          float acc = s[jj];
          acc = fmaf(qv.x, kv.x, acc);
          acc = fmaf(qv.y, kv.y, acc);
          acc = fmaf(qv.z, kv.z, acc);
          acc = fmaf(qv.w, kv.w, acc);
          s[jj] = acc;
        }
      }
      float mx = neg_inf();
#pragma unroll
      for (int jj = 0; jj < HS; ++jj) {
        const int j = w0 + half * HS + jj;
        s[jj] = masked_score(s[jj], k0 + j, ps[j], a, clen);
        mx = fmaxf(mx, s[jj]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      float alpha;
      const float mu = step_max(m[0], mx, alpha);
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < HS; ++jj) {
        s[jj] = exp2f(s[jj] - mu);
        sum += s[jj];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      l[0] = l[0] * alpha + sum;
#pragma unroll
      for (int i = 0; i < NO; ++i) o[i] *= alpha;
#pragma unroll
      for (int jj = 0; jj < HS; ++jj) {
        const float other = __shfl_xor_sync(0xffffffffu, s[jj], 1);
#pragma unroll
        for (int side = 0; side < 2; ++side) {
          const float p = side == half ? s[jj] : other;
          const float* vr = reinterpret_cast<const float*>(
              vs + (w0 + side * HS + jj) * P) + half * (D / 2);
#pragma unroll
          for (int dd = 0; dd < D / 2; dd += 4) {
            const float4 vv = *reinterpret_cast<const float4*>(vr + dd);
            o[dd] = fmaf(p, vv.x, o[dd]);
            o[dd + 1] = fmaf(p, vv.y, o[dd + 1]);
            o[dd + 2] = fmaf(p, vv.z, o[dd + 2]);
            o[dd + 3] = fmaf(p, vv.w, o[dd + 3]);
          }
        }
      }
    }
    __syncthreads();                          // stage read before refill
  }
  cp_async_wait<0>();
  __syncthreads();

  // the warps' states -> shared memory (over the ring): pm, pl [4][16],
  // po [4][16][D]
  float* pm = reinterpret_cast<float*>(ring);
  float* pl = pm + kWarps * kRows;
  float* po = pl + kWarps * kRows;
  if constexpr (C::kMma) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float li = l[rr];
      li += __shfl_xor_sync(0xffffffffu, li, 1);
      li += __shfl_xor_sync(0xffffffffu, li, 2);
      const int row = lane / 4 + 8 * rr;
      if (lane % 4 == 0) {
        pm[warp * kRows + row] = m[rr];
        pl[warp * kRows + row] = li;
      }
#pragma unroll
      for (int n8 = 0; n8 < D / 8; ++n8) {
        float* dst = po + (warp * kRows + row) * D + 8 * n8 + 2 * (lane % 4);
        dst[0] = o[4 * n8 + 2 * rr];
        dst[1] = o[4 * n8 + 2 * rr + 1];
      }
    }
  } else {
    const int row = lane / 2, half = lane % 2;
    if (half == 0) {
      pm[warp * kRows + row] = m[0];
      pl[warp * kRows + row] = l[0];
    }
#pragma unroll
    for (int dd = 0; dd < D / 2; ++dd)
      po[(warp * kRows + row) * D + half * (D / 2) + dd] = o[dd];
  }
  __syncthreads();

  // merge the warps; one split writes the output, several their partials
  T* out = static_cast<T*>(a.out) + (static_cast<int64_t>(b) * a.H + g * r +
                                     row0) * D;
  float* part = a.part + static_cast<int64_t>(blockIdx.x) * n_splits * kRows *
                             (D + 2);
  const int64_t lse_row = static_cast<int64_t>(b) * a.H + g * r + row0;
  for (int c = tid; c < nrows * D; c += kThreads) {
    const int row = c / D, d = c % D;
    float mb = neg_inf();
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mb = fmaxf(mb, pm[w * kRows + row]);
    float lb = 0.f, ob = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = pm[w * kRows + row];
      const float e = mw == neg_inf() ? 0.f : exp2f(mw - mb);
      lb += e * pl[w * kRows + row];
      ob += e * po[(w * kRows + row) * D + d];
    }
    if (n_splits == 1) {
      store(out + row * D + d, ob / (lb == 0.f ? 1.f : lb));
      if (d == 0 && a.lse) a.lse[lse_row + row] = natural_lse(mb, lb);
    } else {
      float* rec = part + (split * kRows + row) * (D + 2);
      rec[2 + d] = ob;
      if (d == 0) {
        rec[0] = mb;
        rec[1] = lb;
      }
    }
  }
  if (n_splits == 1) return;

  // the last block of this (b, g, row group) merges the splits in order
  __shared__ int is_last;
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int done = atomicAdd(a.counters + blockIdx.x, 1);
    is_last = done == n_splits - 1;
    if (is_last) a.counters[blockIdx.x] = 0;  // ready for the next call
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int c = tid; c < nrows * D; c += kThreads) {
    const int row = c / D, d = c % D;
    float mg = neg_inf();
    for (int i = 0; i < n_splits; ++i)
      mg = fmaxf(mg, __ldcg(part + (i * kRows + row) * (D + 2)));
    float lg = 0.f, og = 0.f;
    for (int i = 0; i < n_splits; ++i) {
      const float* rec = part + (i * kRows + row) * (D + 2);
      const float mi = __ldcg(rec);
      const float e = mi == neg_inf() ? 0.f : exp2f(mi - mg);
      lg += e * __ldcg(rec + 1);
      og += e * __ldcg(rec + 2 + d);
    }
    store(out + row * D + d, og / (lg == 0.f ? 1.f : lg));
    if (d == 0 && a.lse) a.lse[lse_row + row] = natural_lse(mg, lg);
  }
}

template <typename T, int D>
int launch(const DaArgs& a, int grid_x, int n_splits, cudaStream_t stream) {
  constexpr int smem = Cfg<T, D>::SMEM;
  auto kernel = decode_attention_kernel<T, D>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  kernel<<<dim3(grid_x, n_splits), kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int tile_slots(int D) {
  switch (D) {
    case 16: return Cfg<T, 16>::BK;
    case 32: return Cfg<T, 32>::BK;
    case 64: return Cfg<T, 64>::BK;
    case 128: return Cfg<T, 128>::BK;
    case 256: return Cfg<T, 256>::BK;
    default: return 0;
  }
}

template <typename T>
int dispatch(DaArgs a, int B, int D, int n_splits, cudaStream_t stream) {
  const int bk = tile_slots<T>(D);
  if (bk == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (a.S + bk - 1) / bk;
  n_splits = n_splits < 1 ? 1 : (n_splits > tiles ? tiles : n_splits);
  a.tiles_per_split = (tiles + n_splits - 1) / n_splits;
  n_splits = (tiles + a.tiles_per_split - 1) / a.tiles_per_split;
  const int grid_x = B * a.KV * a.row_groups;
  switch (D) {
    case 16: return launch<T, 16>(a, grid_x, n_splits, stream);
    case 32: return launch<T, 32>(a, grid_x, n_splits, stream);
    case 64: return launch<T, 64>(a, grid_x, n_splits, stream);
    case 128: return launch<T, 128>(a, grid_x, n_splits, stream);
    default: return launch<T, 256>(a, grid_x, n_splits, stream);
  }
}

}  // namespace

extern "C" {

// Slots per tile of the (dtype, D) instantiation; 0 if there is none.
int da_tile_slots(int dtype, int D) {
  return dtype == 1 ? tile_slots<__nv_bfloat16>(D) : tile_slots<float>(D);
}

// dtype 0: fp32, 1: bf16.  Strides are in elements; window <= 0: none.
// lse: null, or [B, H] floats (contiguous) for each row's log-sum-exp.
// n_splits is capped to the number of tiles; part must hold
// B * KV * ceil(r / 16) * n_splits * 16 * (D + 2) floats when n_splits > 1,
// and counters B * KV * ceil(r / 16) ints, zero.
int da_launch(int dtype, const void* q, const void* k, const void* v,
              const void* cache_len, const void* positions, void* out,
              void* lse, void* part, void* counters, int B, int H, int KV, int S, int D,
              int n_splits, int64_t q_sb, int64_t q_sh, int64_t k_sb,
              int64_t k_sh, int64_t k_ss, int64_t v_sb, int64_t v_sh,
              int64_t v_ss, int64_t cl_sb, int64_t pos_sb, int window,
              float scale_log2, void* stream) {
  const int r = H / KV;
  if (r < 1 || r > 3 * kRows) return static_cast<int>(cudaErrorInvalidValue);
  const DaArgs a{q, k, v, static_cast<const int32_t*>(cache_len),
                 static_cast<const int32_t*>(positions), out,
                 static_cast<float*>(lse), static_cast<float*>(part), static_cast<int*>(counters), H,
                 KV, S, (r + kRows - 1) / kRows, 0, q_sb, q_sh, k_sb, k_sh,
                 k_ss, v_sb, v_sh, v_ss, cl_sb, pos_sb, window, scale_log2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return dispatch<__nv_bfloat16>(a, B, D, n_splits, s);
  return dispatch<float>(a, B, D, n_splits, s);
}

}  // extern "C"
