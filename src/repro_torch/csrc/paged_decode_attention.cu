// Paged decode attention for Hopper (sm_90a), fp32 or int8 page pools (B1).
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
// int8 pages are dequantized as x * scale / 127, one scale per (kv head,
// page).
//
// Bound: memory.  Each (b, g) reads its K and V pages once and does 4*r*D
// flops per slot it reads (r = H/KV query heads per kv head), a few flops
// per byte in fp32 and about 4r in int8, against the card's ~20 fp32
// flops per byte outside the tensor cores.  The least time is the bytes
// of the pages the rows need over 3.35 TB/s; in int8 the arithmetic is
// close behind, so the design must keep the CUDA cores' instruction
// stream short as well.  fp32 stays on CUDA-core FMAs (no TF32), so the
// kernel keeps its 1e-5 agreement with the plain version.
//
// Design.
// * Split over pages (flash-decoding): the grid is (B * KV * row groups,
//   n_splits); a row group is 8 of the r query heads.  Split i takes pages
//   [i * pps, (i + 1) * pps) of the row's table and walks only those below
//   the row's ceil(seq_len / block) (all nb for a row with no valid slot),
//   so a split past a short row's pages is empty and weighs 0 (m = -inf,
//   l = 0).  The wrapper chooses the count (`choose_splits`): enough for
//   the blocks one SM holds (pda_blocks_per_sm: two in fp32 at D 64, more
//   in int8, whose stages are a quarter of the size) on every SM.
// * The split's table entries (and int8 scales) are loaded once into
//   shared memory.  Its slots stream as tiles of 64 slots (spanning pages
//   of fewer slots, or part of a longer page) through a ring of 2-3 stages
//   filled by cp.async in the pool's own type: int8 stays one byte in
//   shared memory and is converted when read.  Each stage also holds its
//   slots' masks (kept, masked, or past the split).  One barrier per tile.
// * Arithmetic: each warp takes 16 slots of a tile with its own online
//   softmax.  For the scores, lane (slot s, half h) reads its K row once,
//   16 bytes at a time, and multiplies it with query rows h, h + 2, h + 4,
//   h + 6 (q kept as fp32 in shared memory and broadcast); int8 scores are
//   scaled by the page's scale afterwards.  For P V, the warp's P (int8:
//   times the page's V scale) goes to shared memory, and each lane owns
//   D / 32 columns of all 8 rows (D 16: 1 column of 4 rows), reading each
//   V element once for all rows.  exp2 with the scale folded into log2(e).
// * Merge: the block merges its warps' states in shared memory.  With one
//   split it writes the output.  Otherwise it writes its (m, l, o) to a
//   scratch, and the last block of its (b, g, row group) to finish (a
//   __threadfence and an atomic counter, reset by that block) merges the
//   splits in split order, not arrival order: two calls give bitwise-equal
//   outputs.
//
// C interface (bound with ctypes): pda_launch returns the cudaError_t of
// the launch, 0 on success; pda_smem_bytes the shared memory a launch
// needs.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = 4;
constexpr int kRows = 8;              // query heads per block (row group)
constexpr int kSlots = 64;            // slots per tile
constexpr int kWarpSlots = kSlots / kWarps;
constexpr float kMasked = -1e30f;

template <typename T, int D>
struct Cfg {
  static constexpr bool kInt8 = std::is_same<T, int8_t>::value;
  static constexpr int ROW = D * static_cast<int>(sizeof(T));  // bytes
  static constexpr int CHUNKS = ROW / 16;                      // per row
  static constexpr int PITCH = ROW + 16;
  static constexpr int TILE = kSlots * PITCH;                  // K or V
  // K, V, then per slot: mask flag (int), K and V multipliers
  static constexpr int STAGE = 2 * TILE + kSlots * 12;
  static constexpr int STAGES = STAGE <= 40 * 1024 ? 3 : 2;
  static constexpr int RING = STAGES * STAGE;
  static constexpr int QP = D + 4;                             // floats
  static constexpr int Q_BYTES = kRows * QP * 4;
  // per warp: P [8][16] and the rows' rescale [8]
  static constexpr int P_BYTES = kWarps * kRows * (kWarpSlots + 1) * 4;
  // the warps' (m, l, o) at the end, over the ring
  static constexpr int MERGE = kWarps * kRows * (D + 2) * 4;
  static_assert(MERGE <= RING, "merge area must fit in the ring");
  static constexpr int FIXED = Q_BYTES + RING + P_BYTES;
  // P V: columns per lane and row sets
  static constexpr int CPL = D >= 32 ? D / 32 : 1;
  static constexpr int COL_LANES = D / CPL;                    // 32 or 16
  static constexpr int RSETS = 32 / COL_LANES;                 // 1 or 2
  static constexpr int RPL = kRows / RSETS;                    // rows a lane
};

struct PdaArgs {
  const float* q;
  const void* k_pages;
  const void* v_pages;
  const float* k_scales;
  const float* v_scales;
  const int32_t* tables;
  const int32_t* seq_lens;
  float* out;
  float* part;          // [grid.x, n_splits, 8, D + 2] when n_splits > 1
  int* counters;        // [grid.x], zero between calls
  int H, KV, N, block, nb, row_groups, pps;
  float scale_log2;     // log2(e) / sqrt(D)
};

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; `bytes` 0 fills the destination with zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int K>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(K) : "memory");
}

// 16 bytes of a row as floats: 4 fp32 or 16 int8 values.
template <typename T>
__device__ __forceinline__ void to_float(const uint4& raw,
                                         float (&v)[16 / sizeof(T)]) {
  if constexpr (std::is_same<T, float>::value) {
    v[0] = __uint_as_float(raw.x);
    v[1] = __uint_as_float(raw.y);
    v[2] = __uint_as_float(raw.z);
    v[3] = __uint_as_float(raw.w);
  } else {
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const char4 c = *reinterpret_cast<const char4*>(&w[i]);
      v[4 * i] = static_cast<float>(c.x);
      v[4 * i + 1] = static_cast<float>(c.y);
      v[4 * i + 2] = static_cast<float>(c.z);
      v[4 * i + 3] = static_cast<float>(c.w);
    }
  }
}

// CPL consecutive elements of type T at `p` (a V row) as floats.
template <typename T, int CPL>
__device__ __forceinline__ void load_cols(const uint8_t* p, float (&v)[CPL]) {
  if constexpr (std::is_same<T, float>::value) {
    if constexpr (CPL == 4) {
      const float4 x = *reinterpret_cast<const float4*>(p);
      v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
    } else if constexpr (CPL == 2) {
      const float2 x = *reinterpret_cast<const float2*>(p);
      v[0] = x.x; v[1] = x.y;
    } else {
      v[0] = *reinterpret_cast<const float*>(p);
    }
  } else {
    if constexpr (CPL == 4) {
      const char4 x = *reinterpret_cast<const char4*>(p);
      v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
    } else if constexpr (CPL == 2) {
      const char2 x = *reinterpret_cast<const char2*>(p);
      v[0] = x.x; v[1] = x.y;
    } else {
      v[0] = static_cast<float>(*reinterpret_cast<const int8_t*>(p));
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_attention_kernel(const PdaArgs a) {
  using C = Cfg<T, D>;
  constexpr int E = 16 / static_cast<int>(sizeof(T));  // values per chunk
  constexpr int CPL = C::CPL, RPL = C::RPL;
  extern __shared__ float4 smem4[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem4);
  float* q_s = reinterpret_cast<float*>(smem);                  // [8][QP]
  uint8_t* ring = smem + C::Q_BYTES;
  float* p_all = reinterpret_cast<float*>(ring + C::RING);
  int32_t* tbl_page = reinterpret_cast<int32_t*>(smem + C::FIXED);
  int32_t* tbl_ok = tbl_page + a.pps;
  float* tbl_kmul = reinterpret_cast<float*>(tbl_ok + a.pps);
  float* tbl_vmul = tbl_kmul + a.pps;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bg = blockIdx.x / a.row_groups, rgi = blockIdx.x % a.row_groups;
  const int b = bg / a.KV, g = bg % a.KV;
  const int r = a.H / a.KV, row0 = rgi * kRows;
  const int nrows = min(kRows, r - row0);
  const int split = blockIdx.y, n_splits = gridDim.y;
  const int block = a.block;

  // the pages this row walks, and this split's share of them
  const int seq_len = max(a.seq_lens[b], 0);
  const int32_t* tb = a.tables + static_cast<int64_t>(b) * a.nb;
  const int n_need = min((seq_len + block - 1) / block, a.nb);
  int any = 0;
  for (int j = tid; j < n_need; j += kThreads) any |= (tb[j] >= 0);
  any = __syncthreads_or(any);
  const int n_iter = any ? n_need : a.nb;
  const int p_lo = split * a.pps;
  const int p_hi = min(n_iter, p_lo + a.pps);
  const int64_t s_lo = static_cast<int64_t>(p_lo) * block;
  const int64_t s_hi = static_cast<int64_t>(p_hi) * block;
  const int n_tiles = p_hi > p_lo
                          ? static_cast<int>((s_hi - s_lo + kSlots - 1) / kSlots)
                          : 0;

  for (int j = tid; j < p_hi - p_lo; j += kThreads) {
    const int blk = tb[p_lo + j];
    const int page = min(max(blk, 0), a.N - 1);
    tbl_page[j] = page;
    tbl_ok[j] = blk >= 0;
    if constexpr (C::kInt8) {
      tbl_kmul[j] = a.k_scales[g * a.N + page] / 127.0f;
      tbl_vmul[j] = a.v_scales[g * a.N + page] / 127.0f;
    } else {
      tbl_kmul[j] = tbl_vmul[j] = 1.f;
    }
  }
  const float* qb = a.q + (static_cast<int64_t>(b) * a.H + g * r + row0) * D;
  for (int i = tid; i < kRows * D; i += kThreads) {
    const int row = i / D, d = i % D;
    q_s[row * C::QP + d] = row < nrows ? qb[i] : 0.f;
  }
  __syncthreads();                          // table and q in place

  const int64_t page_stride = static_cast<int64_t>(block) * C::ROW;
  const uint8_t* kp = static_cast<const uint8_t*>(a.k_pages) +
                      static_cast<int64_t>(g) * a.N * page_stride;
  const uint8_t* vp = static_cast<const uint8_t*>(a.v_pages) +
                      static_cast<int64_t>(g) * a.N * page_stride;

  auto issue = [&](int k) {                 // tile k into its ring stage
    uint8_t* st = ring + (k % C::STAGES) * C::STAGE;
    int32_t* flag = reinterpret_cast<int32_t*>(st + 2 * C::TILE);
    float* kmul = reinterpret_cast<float*>(flag + kSlots);
    float* vmul = kmul + kSlots;
    const int64_t pos0 = s_lo + static_cast<int64_t>(k) * kSlots;
    for (int c = tid; c < kSlots * C::CHUNKS; c += kThreads) {
      const int row = c / C::CHUNKS, col = c % C::CHUNKS;
      const int64_t pos = pos0 + row;
      const bool in = pos < s_hi;
      const int j = in ? static_cast<int>(pos / block) - p_lo : 0;
      const int off = in ? static_cast<int>(pos % block) : 0;
      const int64_t src = tbl_page[j] * page_stride +
                          static_cast<int64_t>(off) * C::ROW + 16 * col;
      const uint32_t dst = smem_u32(st + row * C::PITCH + 16 * col);
      cp_async16(dst, kp + src, in ? 16 : 0);
      cp_async16(dst + C::TILE, vp + src, in ? 16 : 0);
      if (col == 0) {
        flag[row] = !in ? -1 : (pos < seq_len && tbl_ok[j]) ? 1 : 0;
        kmul[row] = in ? tbl_kmul[j] : 0.f;
        vmul[row] = in ? tbl_vmul[j] : 0.f;
      }
    }
  };

  // scores: lane (slot lane % 16, half lane / 16) for rows half + 2m
  const int s_lane = lane % kWarpSlots, half = lane / kWarpSlots;
  // P V: lane's columns and rows
  const int col0 = (lane % C::COL_LANES) * CPL;
  const int rset = lane / C::COL_LANES;
  float m_run[4], l_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = neg_inf();
    l_run[i] = 0.f;
  }
  float acc[RPL][CPL];
#pragma unroll
  for (int i = 0; i < RPL; ++i)
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[i][c] = 0.f;
  float* p_s = p_all + warp * kRows * (kWarpSlots + 1);   // [8][16] + [8]
  float* alpha_s = p_s + kRows * kWarpSlots;

#pragma unroll
  for (int k = 0; k < C::STAGES - 1; ++k) {
    if (k < n_tiles) issue(k);
    cp_async_commit();
  }
  for (int k = 0; k < n_tiles; ++k) {
    cp_async_wait<C::STAGES - 2>();
    __syncthreads();                        // tile k in place; k - 1 used up
    if (k + C::STAGES - 1 < n_tiles) issue(k + C::STAGES - 1);
    cp_async_commit();

    const uint8_t* st = ring + (k % C::STAGES) * C::STAGE;
    const int32_t* flag = reinterpret_cast<const int32_t*>(st + 2 * C::TILE);
    const float* kmul = reinterpret_cast<const float*>(flag + kSlots);
    const float* vmul = kmul + kSlots;
    const int slot = warp * kWarpSlots + s_lane;

    // scores of this lane's slot for rows half, half + 2, ...
    // two chains per row, half as long
    float sc2[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    const uint8_t* krow = st + slot * C::PITCH;
#pragma unroll
    for (int cc = 0; cc < C::CHUNKS; ++cc) {
      float kv[E];
      to_float<T>(*reinterpret_cast<const uint4*>(krow + 16 * cc), kv);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const float* qr = q_s + (half + 2 * m) * C::QP + cc * E;
#pragma unroll
        for (int e4 = 0; e4 < E / 4; ++e4) {
          const float4 qv = *reinterpret_cast<const float4*>(qr + 4 * e4);
          float& acc = sc2[(cc * (E / 4) + e4) & 1][m];
          acc = fmaf(qv.x, kv[4 * e4], acc);
          acc = fmaf(qv.y, kv[4 * e4 + 1], acc);
          acc = fmaf(qv.z, kv[4 * e4 + 2], acc);
          acc = fmaf(qv.w, kv[4 * e4 + 3], acc);
        }
      }
    }
    float sc[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) sc[m] = sc2[0][m] + sc2[1][m];
    const int f = flag[slot];
    const float mul = a.scale_log2 * (C::kInt8 ? kmul[slot] : 1.f);
    const float pmul = C::kInt8 ? vmul[slot] : 1.f;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const float s = f > 0 ? sc[m] * mul : (f == 0 ? kMasked : neg_inf());
      float mx = s;
#pragma unroll
      for (int o = kWarpSlots / 2; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_run[m], mx);
      const float m_use = m_new == neg_inf() ? 0.f : m_new;
      const float alpha = exp2f(m_run[m] - m_use);
      const float p = exp2f(s - m_use);
      m_run[m] = m_new;
      l_run[m] = l_run[m] * alpha + p;      // this lane's slot; summed later
      const int row = half + 2 * m;
      p_s[row * kWarpSlots + s_lane] = p * pmul;
      if (s_lane == 0) alpha_s[row] = alpha;
    }
    __syncwarp();

    // acc[row] = acc[row] * alpha + sum_s p[row, s] * v[s, cols]
#pragma unroll
    for (int i = 0; i < RPL; ++i) {
      const float al = alpha_s[rset + C::RSETS * i];
#pragma unroll
      for (int c = 0; c < CPL; ++c) acc[i][c] *= al;
    }
    const uint8_t* vrow = st + C::TILE + (warp * kWarpSlots) * C::PITCH +
                          col0 * static_cast<int>(sizeof(T));
#pragma unroll
    for (int s4 = 0; s4 < kWarpSlots; s4 += 4) {
      float v[4][CPL];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        load_cols<T, CPL>(vrow + (s4 + u) * C::PITCH, v[u]);
#pragma unroll
      for (int i = 0; i < RPL; ++i) {
        const float4 p = *reinterpret_cast<const float4*>(
            p_s + (rset + C::RSETS * i) * kWarpSlots + s4);
        const float pp[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int c = 0; c < CPL; ++c)
            acc[i][c] = fmaf(pp[u], v[u][c], acc[i][c]);
      }
    }
    __syncwarp();                           // P read before the next tile
  }
  cp_async_wait<0>();
  __syncthreads();                          // the ring is free

  // the warps' states -> shared memory (over the ring): pm, pl [4][8],
  // po [4][8][D]
  float* pm = reinterpret_cast<float*>(ring);
  float* pl = pm + kWarps * kRows;
  float* po = pl + kWarps * kRows;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    float l = l_run[m];
#pragma unroll
    for (int o = kWarpSlots / 2; o > 0; o >>= 1)
      l += __shfl_xor_sync(0xffffffffu, l, o);
    if (s_lane == 0) {
      pm[warp * kRows + half + 2 * m] = m_run[m];
      pl[warp * kRows + half + 2 * m] = l;
    }
  }
#pragma unroll
  for (int i = 0; i < RPL; ++i)
#pragma unroll
    for (int c = 0; c < CPL; ++c)
      po[(warp * kRows + rset + C::RSETS * i) * D + col0 + c] = acc[i][c];
  __syncthreads();

  // merge the warps; one split writes the output, several their partials
  float* out = a.out + (static_cast<int64_t>(b) * a.H + g * r + row0) * D;
  float* part = a.part + static_cast<int64_t>(blockIdx.x) * n_splits * kRows *
                             (D + 2);
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
      out[row * D + d] = ob / (lb == 0.f ? 1.f : lb);
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
    out[row * D + d] = og / (lg == 0.f ? 1.f : lg);
  }
}

template <typename T, int D>
size_t smem_bytes(int pps) {
  return Cfg<T, D>::FIXED + static_cast<size_t>(pps) * 16;
}

template <typename T>
size_t smem_for(int D, int pps) {
  switch (D) {
    case 16: return smem_bytes<T, 16>(pps);
    case 32: return smem_bytes<T, 32>(pps);
    case 64: return smem_bytes<T, 64>(pps);
    case 128: return smem_bytes<T, 128>(pps);
    default: return 0;
  }
}

// Lets the kernel take `smem` bytes of dynamic shared memory.
template <typename T, int D>
cudaError_t allow_smem(size_t smem) {
  static size_t attr = 0;           // the largest size set so far
  if (smem <= attr) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      paged_decode_attention_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess) attr = smem;
  return err;
}

template <typename T, int D>
int launch(const PdaArgs& a, int grid_x, int n_splits, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, D>(a.pps);
  const cudaError_t err = allow_smem<T, D>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  paged_decode_attention_kernel<T, D>
      <<<dim3(grid_x, n_splits), kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the (T, D) instantiation one SM holds at `pps` pages a split.
template <typename T, int D>
int resident(int pps) {
  const size_t smem = smem_bytes<T, D>(pps);
  int n = 0;
  if (allow_smem<T, D>(smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, paged_decode_attention_kernel<T, D>, kThreads, smem) !=
          cudaSuccess)
    return 0;
  return n;
}

template <typename T>
int resident_for(int D, int pps) {
  switch (D) {
    case 16: return resident<T, 16>(pps);
    case 32: return resident<T, 32>(pps);
    case 64: return resident<T, 64>(pps);
    case 128: return resident<T, 128>(pps);
    default: return 0;
  }
}

template <typename T>
int dispatch(PdaArgs a, int B, int D, int n_splits, cudaStream_t stream) {
  n_splits = n_splits < 1 ? 1 : (n_splits > a.nb ? a.nb : n_splits);
  a.pps = (a.nb + n_splits - 1) / n_splits;
  n_splits = (a.nb + a.pps - 1) / a.pps;
  const int grid_x = B * a.KV * a.row_groups;
  switch (D) {
    case 16: return launch<T, 16>(a, grid_x, n_splits, stream);
    case 32: return launch<T, 32>(a, grid_x, n_splits, stream);
    case 64: return launch<T, 64>(a, grid_x, n_splits, stream);
    case 128: return launch<T, 128>(a, grid_x, n_splits, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Shared memory one block needs for head dim D and pps pages per split,
// so that the wrapper can refuse a call that does not fit before it
// launches; 0 for a D the kernel is not built for.
size_t pda_smem_bytes(int quantized, int D, int pps) {
  return quantized ? smem_for<int8_t>(D, pps) : smem_for<float>(D, pps);
}

// Blocks one SM holds at head dim D and pps pages a split (on the current
// device); 0 if the query fails.
int pda_blocks_per_sm(int quantized, int D, int pps) {
  return quantized ? resident_for<int8_t>(D, pps) : resident_for<float>(D, pps);
}

// quantized == 0: fp32 pools, k_scales/v_scales ignored (may be null).
// quantized == 1: int8 pools with fp32 scales [KV, N].  n_splits is capped
// to nb and may come out smaller (whole pages per split); part must hold
// B * KV * ceil(r / 8) * n_splits * 8 * (D + 2) floats when n_splits > 1,
// and counters B * KV * ceil(r / 8) ints, zero.
int pda_launch(int quantized, const void* q, const void* k_pages,
               const void* v_pages, const void* k_scales,
               const void* v_scales, const void* tables, const void* seq_lens,
               void* out, void* part, void* counters, int B, int H, int KV,
               int N, int block, int D, int nb, int n_splits, float scale_log2,
               void* stream) {
  const int r = H / KV;
  if (r < 1 || nb < 1 || block < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  PdaArgs a{static_cast<const float*>(q), k_pages, v_pages,
            static_cast<const float*>(k_scales),
            static_cast<const float*>(v_scales),
            static_cast<const int32_t*>(tables),
            static_cast<const int32_t*>(seq_lens), static_cast<float*>(out),
            static_cast<float*>(part), static_cast<int*>(counters), H, KV, N,
            block, nb, (r + kRows - 1) / kRows, 0, scale_log2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (quantized) return dispatch<int8_t>(a, B, D, n_splits, s);
  return dispatch<float>(a, B, D, n_splits, s);
}

}  // extern "C"
