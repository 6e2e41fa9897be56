// The published Mamba-2's chunked SSD (state-space duality) for a prefill,
// on Hopper (sm_90a): float32 arithmetic over bf16 inputs.
//
// Replaces no TPU kernel.  The JAX package has no SSD kernel: it runs
// zamba2's chunked SSD as jnp.einsums (src/repro/models/ssm.py:232-246),
// and the published block (granite-4.0-h) is port-only.  The port's plain
// version is models/ssm.py's ssd_reference, torch products over
// materialised [B, heads, chunks, T, T] float32 decay matrices; the card
// tests hold this kernel to it.  Per sequence b and head h, with chunks of
// T positions, cum_t the running sum of dt_s * A_h within a chunk (<= 0),
// and head h reading group g = h / (nh / G) of B and C:
//
//   y_t = sum_{s <= t in t's chunk} (C_t . B_s) exp(cum_t - cum_s) dt_s x_s
//         + exp(cum_t) C_t h_c
//   h_{c+1} = exp(cum_T,c) h_c + sum_{s in chunk c} exp(cum_T - cum_s) dt_s x_s B_s^T
//
// h_0 is h0 or zero, h_last the state after the last chunk.  y leaves out
// the D term, which the caller adds.  A ragged tail is padded with dt = 0
// and x = B = C = 0, which neither decays nor adds to the state.
//
// Bound.  At granite-4.0-h's prefill (B 4, S 16,384, 128 heads of 64,
// d_state 128, one group, chunk 256) the work is 415 GFLOP a call
// (portbench/roofline_hybrid.ssd_flops): 6.2 ms at 67 TFLOP/s on float32
// CUDA cores.  It moves about 3.4 GB (x in bf16 1.07 GB, y in float32
// 2.15 GB, B, C and dt 0.1 GB), 1.0 ms at 3.35 TB/s.  So it is bound by
// float32 operations: no tensor core, no TF32, no rounding of any operand
// to bf16 or fp8 (x, B and C are read as the bf16 values they are).
//
// Design: four kernels, each a pass over the chunks.
// * ssd_cumsum_kernel: a warp per (sequence, chunk, head) takes the running
//   sums of dt * A over the chunk's T positions (T / 32 a lane, then a
//   shuffle scan over the lanes) and writes them, and dt, per head and
//   position, so that the other passes read them as contiguous rows.
// * ssd_cb_kernel: C_c B_c^T [T, T] once per (sequence, group, chunk), only
//   its 64 x 64 tiles on and below the diagonal, shared by every head of
//   the group (granite: 128 heads read one).  2 x 4 x 64 x 256^2 x 128 / 2
//   ~ 2.7 GFLOP at granite's shape, 67 MB written.
// * ssd_state_kernel: a block per (sequence, head) walks the chunks in
//   order.  In each it forms the chunk's own end state [64, 128] as a
//   product of u_s = dt_s x_s exp(cum_T - cum_s) and B_s over the chunk (a
//   thread an 8 x 8 tile of it in registers), then carries the state:
//   h_{c+1} = exp(cum_T) h_c + st_c.  That is the einsum path's dense
//   (chunks + 1)^2 carry product taken as a sum in chunk order.  It writes
//   the state entering each chunk, transposed to [n][p] for the next pass,
//   and h_last.  No chunk state is kept: 512 blocks at granite's shape, all
//   resident at once (4 a SM).
// * ssd_scan_kernel: a block per (sequence, chunk, 64-row tile, 4 heads of
//   a group), a head per 64 threads, a thread an 8 x 8 tile of y.  First
//   exp(cum_t) C_t h_c over d_state, the C tile shared by the 4 heads; then
//   sum_s M[t][s] dt_s x_s over the chunk's positions up to the tile's last
//   row, M[t][s] = (C.B)[t][s] exp(cum_t - cum_s) for s <= t, else 0,
//   built in shared memory a 16-column tile at a time from the C.B tile
//   (read once for the 4 heads) and the running sums: no decay matrix
//   reaches device memory.  Tiles wholly above the diagonal are never
//   visited.
// * The products are register-tiled float32 FMAs (8 x 8 a thread from two
//   float4 reads of each operand per step, conflict-free), over k-tiles of
//   16.  A tile's inputs arrive by cp.async in a two-stage ring (zeros past
//   S), started before the previous tile's product, so no register holds
//   them across it; after the product the block widens them to float32 and
//   builds the operand tiles (the decays, x dt) in shared memory.
// * The running sums are float32 pairs (hi, lo), summed with error-free
//   transformations, so hi is the exact sum rounded once; a decay takes
//   exp((hi_t - hi_s) + (lo_t - lo_s)).  A plain float32 running sum over a
//   chunk of a fast-decaying head reaches a few hundred, so each rounding
//   moves a decay by ~1e-5 of itself, more than any other error here: the
//   plain path's decays carry that error (torch's cumsum), these do not.
// * Every product and sum is taken in float32, in the plain version's
//   association where it names one: (x dt) exp(...), exp(cum_t - cum_s)
//   (C.B), (C h) exp(cum_t).  The sums run in another order than cuBLAS's.
//
// Limits (ssd_limits, which kernels/ssd.py holds to its own): head dim 64,
// d_state 128, chunk a multiple of 64 up to 256, heads per group a multiple
// of 4.  x [B, S, nh, 64], B and C [B, S, G, 128] bf16, with unit
// stride over the last two dims and 16-byte aligned rows (element strides
// over sequence and position given: the model passes slices of the conv's
// output); dt [B, S, nh] and A [nh] float32 contiguous; h0 and h_last
// [B, nh, 64, 128] float32 contiguous, h0 may be null; y [B, S, nh, 64]
// float32 contiguous.  Scratch from the wrapper: cum [3, B, nh, nc T] (the
// running sums' hi and lo, and dt); cb [B, G, nc, T, T]; hT [B, nh, nc,
// 128, 64], all float32.
//
// C interface (bound with ctypes): ssd_launch returns the cudaError_t of
// the first launch that failed, 0 on success.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "scan_tile.cuh"

namespace {

using scan::cp_async;
using scan::cp_async_commit;
using scan::cp_async_wait;
using scan::smem_u32;

constexpr int kHd = 64;            // head dim
constexpr int kN = 128;            // d_state
constexpr int kMaxT = 256;         // longest chunk
constexpr int kRows = 64;          // rows of a scan tile; T is a multiple
constexpr int kHb = 4;             // heads a scan block runs
constexpr int kK = 16;             // depth of a k-tile
constexpr int kLd = kHd + 4;       // a [k][64] operand tile's padded row
constexpr int kLdN = kN + 4;       // a [k][128] operand tile's padded row
constexpr int kLdS = kK + 4;       // a [64][k] staged tile's padded row
constexpr int kScanThreads = 64 * kHb;
constexpr int kStateThreads = 128;

struct Args {
  const void* x;        // [B, S, nh, 64]: strides x_sb, x_ss
  const float* dt;      // [B, S, nh]
  const float* A;       // [nh]
  const void* b;        // [B, S, G, 128]: strides b_sb, b_ss
  const void* c;        // [B, S, G, 128]: strides c_sb, c_ss
  const float* h0;      // [B, nh, 64, 128] or null
  float* y;             // [B, S, nh, 64]
  float* h_last;        // [B, nh, 64, 128]
  float* cum;           // [3, B, nh, Sp]: running sums (hi, lo), dt
  float* cb;            // [B, G, nc, T, T]
  float* hT;            // [B, nh, nc, 128, 64]
  int batch, S, nh, G, T, nc, Sp;
  long long x_sb, x_ss, b_sb, b_ss, c_sb, c_ss;
};

// x, B and C are the conv's bf16 output; each is read as bf16 and widened.
using In = __nv_bfloat16;
constexpr int kSz = sizeof(In);

// bf16 to float is exact: the value's bits in the high half of the word
__device__ __forceinline__ float4 widen(uint2 v) {
  return make_float4(__uint_as_float(v.x << 16),
                     __uint_as_float(v.x & 0xffff0000u),
                     __uint_as_float(v.y << 16),
                     __uint_as_float(v.y & 0xffff0000u));
}
// four consecutive bf16 values at p, widened
__device__ __forceinline__ float4 load4(const In* p) {
  return widen(*reinterpret_cast<const uint2*>(p));
}
// four staged bf16 values at p, widened
__device__ __forceinline__ float4 staged4(const unsigned char* p) {
  return widen(*reinterpret_cast<const uint2*>(p));
}
__device__ __forceinline__ float lane_of(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// A running sum as a float32 pair: hi, the sum rounded, and lo, what the
// rounding left (|lo| <= ulp(hi) / 2).
struct Pair {
  float hi, lo;
};
// a + b as its rounded sum and the rounding's error, exactly (Knuth)
__device__ __forceinline__ Pair two_sum(float a, float b) {
  const float s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  return {s, __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb))};
}
__device__ __forceinline__ Pair add_pair(Pair a, Pair b) {
  const Pair s = two_sum(a.hi, b.hi);
  const float lo = __fadd_rn(s.lo, __fadd_rn(a.lo, b.lo));
  const float hi = __fadd_rn(s.hi, lo);
  return {hi, __fsub_rn(lo, __fsub_rn(hi, s.hi))};
}
// exp(cum_t - cum_s) from the pairs: hi_t - hi_s is exact when the two are
// within a factor of two, and lo carries what rounding the sums dropped
__device__ __forceinline__ float decay(float hi_t, float lo_t, float hi_s,
                                       float lo_s) {
  return expf(__fadd_rn(__fsub_rn(hi_t, hi_s), __fsub_rn(lo_t, lo_s)));
}

// acc[i][j] += a[i] b[j] over one k-tile: a's 8 values at a[ao], a[ao + 32]
// (4 each), b's at bm[bo], bm[bo + kHalfB] (4 each), rows kLdA and kLdB
// apart.
template <int kLdA, int kLdB, int kHalfB>
__device__ __forceinline__ void tile_fma(float (&acc)[8][8], const float* a,
                                         int ao, const float* bm, int bo) {
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(a + k * kLdA + ao);
    const float4 a1 =
        *reinterpret_cast<const float4*>(a + k * kLdA + ao + 32);
    const float4 b0 = *reinterpret_cast<const float4*>(bm + k * kLdB + bo);
    const float4 b1 =
        *reinterpret_cast<const float4*>(bm + k * kLdB + bo + kHalfB);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// ---------------------------------------------------------------------------
// pass 0: running sums of dt * A within each chunk
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(1024) ssd_cumsum_kernel(Args a) {
  const int c = blockIdx.x, b = blockIdx.y;
  const int h = blockIdx.z * 32 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (h >= a.nh) return;                     // the whole warp
  const int E = a.T / 32;
  const float Ah = a.A[h];
  const int s0 = c * a.T + lane * E;
  float d[kMaxT / 32];
  Pair part[kMaxT / 32];
  Pair run{0.f, 0.f};
#pragma unroll
  for (int i = 0; i < kMaxT / 32; ++i) {
    if (i < E) {
      const int t = s0 + i;
      d[i] = t < a.S
                 ? a.dt[(static_cast<size_t>(b) * a.S + t) * a.nh + h]
                 : 0.f;
      run = add_pair(run, {__fmul_rn(d[i], Ah), 0.f});
      part[i] = run;
    }
  }
  Pair incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const Pair v{__shfl_up_sync(0xffffffffu, incl.hi, o),
                 __shfl_up_sync(0xffffffffu, incl.lo, o)};
    if (lane >= o) incl = add_pair(v, incl);
  }
  Pair excl{__shfl_up_sync(0xffffffffu, incl.hi, 1),
            __shfl_up_sync(0xffffffffu, incl.lo, 1)};
  if (lane == 0) excl = {0.f, 0.f};
  const size_t plane = static_cast<size_t>(a.batch) * a.nh * a.Sp;
  float* out = a.cum + (static_cast<size_t>(b) * a.nh + h) * a.Sp + s0;
#pragma unroll
  for (int i = 0; i < kMaxT / 32; ++i) {
    if (i < E) {
      const Pair p = add_pair(excl, part[i]);
      out[i] = p.hi;
      out[plane + i] = p.lo;
      out[2 * plane + i] = d[i];
    }
  }
}

// ---------------------------------------------------------------------------
// pass 1: C.B per (sequence, group, chunk), tiles on and below the diagonal
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(256) ssd_cb_kernel(Args a) {
  __shared__ __align__(16) float cs[32][kLd];
  __shared__ __align__(16) float bs[32][kLd];
  int p = blockIdx.x, ti = 0;               // the pair (ti, si), si <= ti
  while (p > ti) {
    p -= ti + 1;
    ++ti;
  }
  const int si = p;
  const int c = blockIdx.y, b = blockIdx.z / a.G, g = blockIdx.z % a.G;
  const In* C = static_cast<const In*>(a.c) + b * a.c_sb + g * kN;
  const In* Bm = static_cast<const In*>(a.b) + b * a.b_sb + g * kN;
  const int j = threadIdx.x;
  const int lr = j / 4, lk = (j % 4) * 8;   // loader: row, first of 8 of k
  const int tpos = c * a.T + ti * kRows + lr;
  const int spos = c * a.T + si * kRows + lr;
  const int tt = j / 16, ss = j % 16;       // product: rows tt * 4, cols ss * 4
  float acc[4][4] = {};
  for (int n0 = 0; n0 < kN; n0 += 32) {
    float4 cv[2], bv[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      cv[q] = tpos < a.S ? load4(C + tpos * a.c_ss + n0 + lk + 4 * q)
                         : float4{};
      bv[q] = spos < a.S ? load4(Bm + spos * a.b_ss + n0 + lk + 4 * q)
                         : float4{};
    }
    __syncthreads();                        // the last tile's product is done
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        cs[lk + 4 * q + e][lr] = lane_of(cv[q], e);
        bs[lk + 4 * q + e][lr] = lane_of(bv[q], e);
      }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < 32; ++k) {
      const float4 x4 = *reinterpret_cast<const float4*>(&cs[k][tt * 4]);
      const float4 y4 = *reinterpret_cast<const float4*>(&bs[k][ss * 4]);
      const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
      const float yv[4] = {y4.x, y4.y, y4.z, y4.w};
#pragma unroll
      for (int i2 = 0; i2 < 4; ++i2)
#pragma unroll
        for (int j2 = 0; j2 < 4; ++j2)
          acc[i2][j2] = fmaf(xv[i2], yv[j2], acc[i2][j2]);
    }
  }
  float* out = a.cb +
               ((static_cast<size_t>(b) * a.G + g) * a.nc + c) * a.T * a.T +
               static_cast<size_t>(ti * kRows + tt * 4) * a.T + si * kRows +
               ss * 4;
#pragma unroll
  for (int i2 = 0; i2 < 4; ++i2)
    *reinterpret_cast<float4*>(out + static_cast<size_t>(i2) * a.T) =
        make_float4(acc[i2][0], acc[i2][1], acc[i2][2], acc[i2][3]);
}

// ---------------------------------------------------------------------------
// pass 2: each chunk's end state, carried in chunk order
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kStateThreads, 4) ssd_state_kernel(Args a) {
  __shared__ __align__(16) unsigned char xst[2][kK][kHd * kSz];  // staged x
  __shared__ __align__(16) unsigned char bst[2][kK][kN * kSz];   // staged B
  __shared__ __align__(16) float us[kK][kLd];      // [k][p]: x dt w
  __shared__ __align__(16) float bsm[kK][kLdN];    // [k][n]: B
  __shared__ float ws[kMaxT], dts[kMaxT];
  const int h = blockIdx.x, b = blockIdx.y, g = h / (a.nh / a.G);
  const int j = threadIdx.x;
  const int pg = j / 16, ng = j % 16;   // p: pg * 4 + {0, 32}; n: ng * 4 + {0, 64}
  const int xr = j / 8, xc = (j % 8) * 4;        // x: row, cols + {0, 32}
  const int br = j / 16, bc = (j % 16) * 4;      // B: rows + {0, 8}, cols + {0, 64}
  const In* X = static_cast<const In*>(a.x) + b * a.x_sb + h * kHd;
  const In* Bm = static_cast<const In*>(a.b) + b * a.b_sb + g * kN;
  const size_t hrow = static_cast<size_t>(b) * a.nh + h;
  const size_t plane = static_cast<size_t>(a.batch) * a.nh * a.Sp;
  const float* hi = a.cum + hrow * a.Sp;
  const float* lo = hi + plane;
  const float* dtT = hi + 2 * plane;
  float* hT = a.hT + hrow * a.nc * kN * kHd;
  auto pcol = [&](int i) { return pg * 4 + (i & 3) + (i >> 2) * 32; };
  auto ncol = [&](int i) { return ng * 4 + (i & 3) + (i >> 2) * 64; };

  // the state entering chunk 0, transposed
  {
    float hv[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float4 v =
            a.h0 ? *reinterpret_cast<const float4*>(
                       a.h0 + (hrow * kHd + pcol(i)) * kN + ng * 4 + 64 * q)
                 : float4{};
#pragma unroll
        for (int e = 0; e < 4; ++e) hv[i][4 * q + e] = lane_of(v, e);
      }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int q = 0; q < 2; ++q)
        *reinterpret_cast<float4*>(hT + ncol(n) * kHd + pg * 4 + 32 * q) =
            make_float4(hv[4 * q][n], hv[4 * q + 1][n], hv[4 * q + 2][n],
                        hv[4 * q + 3][n]);
  }

  const int ntile = a.T / kK;
  for (int c = 0; c < a.nc; ++c) {
    const int base = c * a.T;
    // x and B rows of k-tile kt into stage kt % 2, zeros past S
    auto fetch = [&](int kt) {
      const int st = kt & 1;
      for (int q = j; q < kK * 4 * kSz; q += kStateThreads) {
        const int row = q / (4 * kSz), col = q % (4 * kSz);
        const int s = base + kt * kK + row;
        cp_async<16>(smem_u32(&xst[st][row][col * 16]),
                     X + static_cast<long long>(min(s, a.S - 1)) * a.x_ss +
                         col * (16 / kSz),
                     s < a.S ? 16 : 0);
      }
      for (int q = j; q < kK * 8 * kSz; q += kStateThreads) {
        const int row = q / (8 * kSz), col = q % (8 * kSz);
        const int s = base + kt * kK + row;
        cp_async<16>(smem_u32(&bst[st][row][col * 16]),
                     Bm + static_cast<long long>(min(s, a.S - 1)) * a.b_ss +
                         col * (16 / kSz),
                     s < a.S ? 16 : 0);
      }
      cp_async_commit();
    };
    // stage kt % 2 -> the operands: u = (x dt) w and B, in float32
    auto build = [&](int kt) {
      const int st = kt & 1, s = kt * kK + xr;
      const float d = dts[s], w = ws[s];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float4 v = staged4(&xst[st][xr][(xc + 32 * q) * kSz]);
        *reinterpret_cast<float4*>(&us[xr][xc + 32 * q]) = make_float4(
            __fmul_rn(__fmul_rn(v.x, d), w), __fmul_rn(__fmul_rn(v.y, d), w),
            __fmul_rn(__fmul_rn(v.z, d), w), __fmul_rn(__fmul_rn(v.w, d), w));
      }
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int u = 0; u < 2; ++u)
          *reinterpret_cast<float4*>(&bsm[br + 8 * q][bc + 64 * u]) =
              staged4(&bst[st][br + 8 * q][(bc + 64 * u) * kSz]);
    };

    fetch(0);
    __syncthreads();                 // the last chunk's readers are done
    const float hi_end = hi[base + a.T - 1], lo_end = lo[base + a.T - 1];
    for (int s = j; s < a.T; s += kStateThreads) {
      ws[s] = decay(hi_end, lo_end, hi[base + s], lo[base + s]);
      dts[s] = dtT[base + s];
    }
    cp_async_wait<0>();
    __syncthreads();
    build(0);
    __syncthreads();
    float acc[8][8] = {};
    for (int kt = 0; kt < ntile; ++kt) {
      if (kt + 1 < ntile) fetch(kt + 1);
      tile_fma<kLd, kLdN, 64>(acc, &us[0][0], pg * 4, &bsm[0][0], ng * 4);
      if (kt + 1 < ntile) {
        cp_async_wait<0>();
        __syncthreads();
        build(kt + 1);
        __syncthreads();
      }
    }
    // h_{c+1} = exp(cum_T) h_c + st_c, h_c as this thread wrote it
    const float carry = expf(hi_end);
    const float* hin = hT + static_cast<size_t>(c) * kN * kHd;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(
            hin + ncol(n) * kHd + pg * 4 + 32 * q);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[4 * q + e][n] = fmaf(carry, lane_of(v, e), acc[4 * q + e][n]);
      }
    if (c + 1 < a.nc) {
      float* hout = hT + static_cast<size_t>(c + 1) * kN * kHd;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int q = 0; q < 2; ++q)
          *reinterpret_cast<float4*>(hout + ncol(n) * kHd + pg * 4 + 32 * q) =
              make_float4(acc[4 * q][n], acc[4 * q + 1][n],
                          acc[4 * q + 2][n], acc[4 * q + 3][n]);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int q = 0; q < 2; ++q)
          *reinterpret_cast<float4*>(
              a.h_last + (hrow * kHd + pcol(i)) * kN + ng * 4 + 64 * q) =
              make_float4(acc[i][4 * q], acc[i][4 * q + 1],
                          acc[i][4 * q + 2], acc[i][4 * q + 3]);
    }
  }
}

// ---------------------------------------------------------------------------
// pass 3: y, a 64-row tile of a chunk for 4 heads of one group
// ---------------------------------------------------------------------------

constexpr int scan_smem_bytes() {
  return 4 * (3 * kHb * kK * kLd + 2 * kRows * kLdS + 3 * kHb * kMaxT +
              kHb * kRows) +
         2 * kHb * kK * kHd * kSz;
}

__global__ void __launch_bounds__(kScanThreads, 2) ssd_scan_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  float* const as = smem;                             // [kHb][kK][kLd]
  float* const xs = as + kHb * kK * kLd;              // [2][kHb][kK][kLd]
  float* const rst = xs + 2 * kHb * kK * kLd;         // [2][kRows][kLdS]
  float* const chi = rst + 2 * kRows * kLdS;          // [kHb][kMaxT]
  float* const clo = chi + kHb * kMaxT;               // [kHb][kMaxT]
  float* const dts = clo + kHb * kMaxT;               // [kHb][kMaxT]
  float* const ecum = dts + kHb * kMaxT;              // [kHb][kRows]
  unsigned char* const xst =
      reinterpret_cast<unsigned char*>(ecum + kHb * kRows);  // [2][kHb][kK][kHd * kSz]

  const int r = blockIdx.y, b = blockIdx.z / a.nc, c = blockIdx.z % a.nc;
  const int j = threadIdx.x, hg = j / 64, i = j % 64;
  const int h_first = blockIdx.x * kHb, h = h_first + hg;
  const int g = h_first / (a.nh / a.G);
  const int tg = i / 8, pg = i % 8;       // rows tg * 4 + {0, 32}, cols pg * 4 + {0, 32}
  const int base = c * a.T, row0 = r * kRows;
  const size_t hrow = static_cast<size_t>(b) * a.nh + h;
  const size_t plane = static_cast<size_t>(a.batch) * a.nh * a.Sp;
  float* const A_h = as + hg * kK * kLd;
  float* const X_h = xs + hg * kK * kLd;

  for (int s = i; s < a.T; s += 64) {
    const size_t at = hrow * a.Sp + base + s;
    chi[hg * kMaxT + s] = a.cum[at];
    clo[hg * kMaxT + s] = a.cum[plane + at];
    dts[hg * kMaxT + s] = a.cum[2 * plane + at];
  }
  __syncthreads();
  ecum[hg * kRows + i] = expf(chi[hg * kMaxT + row0 + i]);

  float acc[8][8] = {};

  // -- exp(cum_t) (C_t . h_c): over d_state, the C tile shared by the heads
  {
    const In* Cm = static_cast<const In*>(a.c) + b * a.c_sb + g * kN;
    const float* H = a.hT + (hrow * a.nc + c) * kN * kHd;
    auto fetch = [&](int kt) {
      const int st = kt & 1;
      // C rows row0.. of the tile's 16 columns into stage st, zeros past S
      if (j < kRows * kSz) {
        const int row = j / kSz, col = j % kSz;
        const int pos = base + row0 + row;
        cp_async<16>(smem_u32(reinterpret_cast<unsigned char*>(
                                  rst + (st * kRows + row) * kLdS) +
                              col * 16),
                     Cm + static_cast<long long>(min(pos, a.S - 1)) * a.c_ss +
                         kt * kK + col * (16 / kSz),
                     pos < a.S ? 16 : 0);
      }
      cp_async_commit();
    };
    // the head's h rows of the tile go straight to operand stage kt % 2
    auto fetch_h = [&](int kt) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int id = q * 64 + i, row = id / 16, col = id % 16;
        cp_async<16>(smem_u32(X_h + (kt & 1) * kHb * kK * kLd + row * kLd +
                              col * 4),
                     H + (kt * kK + row) * kHd + col * 4, 16);
      }
      cp_async_commit();
    };
    auto build = [&](int kt) {
      const int lt = j / 4, lk = (j % 4) * 4;
      const float4 v = staged4(reinterpret_cast<const unsigned char*>(
                                      rst + ((kt & 1) * kRows + lt) * kLdS) +
                                  lk * kSz);
#pragma unroll
      for (int e = 0; e < 4; ++e) as[(lk + e) * kLd + lt] = lane_of(v, e);
    };
    const int ntile = kN / kK;
    fetch(0);
    fetch_h(0);
    cp_async_wait<0>();
    __syncthreads();
    build(0);
    __syncthreads();
    for (int kt = 0; kt < ntile; ++kt) {
      if (kt + 1 < ntile) {
        fetch(kt + 1);
        fetch_h(kt + 1);
      }
      tile_fma<kLd, kLd, 32>(acc, as, tg * 4,
                             X_h + (kt & 1) * kHb * kK * kLd, pg * 4);
      if (kt + 1 < ntile) {
        cp_async_wait<0>();
        __syncthreads();
        build(kt + 1);
        __syncthreads();
      }
    }
#pragma unroll
    for (int ii = 0; ii < 8; ++ii) {
      const float e = ecum[hg * kRows + tg * 4 + (ii & 3) + (ii >> 2) * 32];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) acc[ii][jj] = __fmul_rn(acc[ii][jj], e);
    }
  }
  __syncthreads();                            // the operand tiles are free

  // -- sum_{s <= t} (C.B)[t][s] exp(cum_t - cum_s) (x_s dt_s), per head
  {
    const float* CB = a.cb +
                      ((static_cast<size_t>(b) * a.G + g) * a.nc + c) *
                          a.T * a.T +
                      static_cast<size_t>(row0) * a.T;
    const In* X = static_cast<const In*>(a.x) + b * a.x_sb + h * kHd;
    unsigned char* const xst_h = xst + hg * kK * kHd * kSz;
    auto fetch = [&](int kt) {
      const int st = kt & 1;
      {
        // C.B rows row0.. of the tile's 16 columns
        const int row = j / 4, col = j % 4;
        cp_async<16>(smem_u32(rst + (st * kRows + row) * kLdS + col * 4),
                     CB + static_cast<size_t>(row) * a.T + kt * kK + col * 4,
                     16);
      }
#pragma unroll
      for (int q = 0; q < kSz; ++q) {
        // the head's x rows of the tile, zeros past S
        const int id = q * 64 + i, row = id / (4 * kSz), col = id % (4 * kSz);
        const int pos = base + kt * kK + row;
        cp_async<16>(smem_u32(xst_h + st * kHb * kK * kHd * kSz +
                              (row * kHd) * kSz + col * 16),
                     X + static_cast<long long>(min(pos, a.S - 1)) * a.x_ss +
                         col * (16 / kSz),
                     pos < a.S ? 16 : 0);
      }
      cp_async_commit();
    };
    // the head's M tile [k][t] and its x dt tile [k][p], from stage kt % 2
    const float t_hi = chi[hg * kMaxT + row0 + i];
    const float t_lo = clo[hg * kMaxT + row0 + i];
    auto build = [&](int kt) {
      const int st = kt & 1, s0 = kt * kK;
      const float* cbrow = rst + (st * kRows + i) * kLdS;
#pragma unroll
      for (int k4 = 0; k4 < kK; k4 += 4) {
        const float4 v = *reinterpret_cast<const float4*>(cbrow + k4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int s = s0 + k4 + e;
          A_h[(k4 + e) * kLd + i] =
              s <= row0 + i
                  ? __fmul_rn(decay(t_hi, t_lo, chi[hg * kMaxT + s],
                                    clo[hg * kMaxT + s]),
                              lane_of(v, e))
                  : 0.f;
        }
      }
      const int lr = i / 16, lc = (i % 16) * 4;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = lr + 4 * q;
        const float d = dts[hg * kMaxT + s0 + row];
        const float4 v = staged4(xst_h + st * kHb * kK * kHd * kSz +
                                    (row * kHd + lc) * kSz);
        *reinterpret_cast<float4*>(X_h + row * kLd + lc) =
            make_float4(__fmul_rn(v.x, d), __fmul_rn(v.y, d),
                        __fmul_rn(v.z, d), __fmul_rn(v.w, d));
      }
    };
    const int ntile = (row0 + kRows) / kK;
    fetch(0);
    cp_async_wait<0>();
    __syncthreads();
    build(0);
    __syncthreads();
    for (int kt = 0; kt < ntile; ++kt) {
      if (kt + 1 < ntile) fetch(kt + 1);
      tile_fma<kLd, kLd, 32>(acc, A_h, tg * 4, X_h, pg * 4);
      if (kt + 1 < ntile) {
        cp_async_wait<0>();
        __syncthreads();
        build(kt + 1);
        __syncthreads();
      }
    }
  }

#pragma unroll
  for (int ii = 0; ii < 8; ++ii) {
    const int pos = base + row0 + tg * 4 + (ii & 3) + (ii >> 2) * 32;
    if (pos < a.S) {
      float* out = a.y + ((static_cast<size_t>(b) * a.S + pos) * a.nh + h) *
                             kHd + pg * 4;
      *reinterpret_cast<float4*>(out) =
          make_float4(acc[ii][0], acc[ii][1], acc[ii][2], acc[ii][3]);
      *reinterpret_cast<float4*>(out + 32) =
          make_float4(acc[ii][4], acc[ii][5], acc[ii][6], acc[ii][7]);
    }
  }
}

int launch_all(const Args& a, cudaStream_t s) {
  ssd_cumsum_kernel<<<dim3(a.nc, a.batch, (a.nh + 31) / 32), 1024, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = a.T / kRows;
  ssd_cb_kernel<<<dim3(tiles * (tiles + 1) / 2, a.nc, a.batch * a.G), 256, 0,
                  s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_state_kernel<<<dim3(a.nh, a.batch), kStateThreads, 0, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  constexpr int smem = scan_smem_bytes();
  err = cudaFuncSetAttribute(ssd_scan_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_scan_kernel<<<dim3(a.nh / kHb, tiles, a.nc * a.batch), kScanThreads,
                    smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x, b and c bfloat16.  Layouts and limits in the header above; strides
// in elements.
int ssd_launch(const void* x, const void* dt, const void* A,
               const void* b, const void* c, const void* h0, void* y,
               void* h_last, void* cum, void* cb, void* hT,
               int batch, int S, int nh, int G, int T, long long x_sb,
               long long x_ss, long long b_sb, long long b_ss, long long c_sb,
               long long c_ss, void* stream) {
  if (batch < 1 || S < 1 || G < 1 || nh < 1 || nh % G ||
      (nh / G) % kHb || T < kRows || T > kMaxT || T % kRows)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long nc = (static_cast<long long>(S) + T - 1) / T;
  if (nc * batch > 65535 || batch * G > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, static_cast<const float*>(dt), static_cast<const float*>(A),
               b, c, static_cast<const float*>(h0), static_cast<float*>(y),
               static_cast<float*>(h_last), static_cast<float*>(cum),
               static_cast<float*>(cb),
               static_cast<float*>(hT), batch, S, nh, G, T,
               static_cast<int>(nc), static_cast<int>(nc * T), x_sb, x_ss,
               b_sb, b_ss, c_sb, c_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return launch_all(a, s);
}

// which = 0: head dim, 1: d_state, 2: longest chunk, 3: the chunk's step,
// 4: the step of heads per group.
int ssd_limits(int which) {
  const int v[] = {kHd, kN, kMaxT, kRows, kHb};
  return which >= 0 && which < 5 ? v[which] : -1;
}

}  // extern "C"
