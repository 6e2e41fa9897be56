// Mamba-1 selective scan on Hopper (sm_90a), fp32 (B4).
//
// Replaces the Pallas TPU kernel `mamba1_scan` (its `_kernel`) in
// src/repro/kernels/mamba_scan.py.  It computes what that kernel computes,
// per sequence b and channel d, sequentially over t, in fp32:
//
//   h_t[n] = exp(dt_t * A[d, n]) * h_{t-1}[n] + dt_t * x_t * B_t[n]
//   y_t    = sum_n C_t[n] * h_t[n]
//
// without the D-skip term, which the caller adds.  Unlike the TPU kernel,
// which starts from zero and returns only y, the state may start from h0
// (decode carries it from step to step) and the final state is written to
// h_last (prefill fills the cache with it).  With h0 = 0, y is the TPU
// kernel's y.
//
// Bound.  Each call reads x and dt and writes y, 3 * B * T * Di floats, plus
// B_t, C_t (B * T * N each), A (Di * N) and the states (B * Di * N each):
// at falcon-mamba's prefill (B 8, T 512, Di 8192, N 16) 0.41 GB, 0.12 ms at
// 3.35 TB/s.  Its B * T * Di * N = 537 M exponentials take about as long on
// the special-function units (16 per SM per clock: 0.13 ms at 1.98 GHz), so
// the design has to keep those units fed while the tiles stream in, and
// adds no exponential.  The recurrence over T is serial, but B * Di * N
// independent recurrences already give the card enough parallel work at
// the shapes the model path runs (B * Di >= 8 * 8192); a single long
// sequence (B = 1) would want a chunked scan over T, which this kernel does
// not do.
//
// Design.
// * Lanes per channel: a channel's N states are split over L = N / 8
//   neighbouring lanes of a warp (L = 1, 2, 4, 8 for N = 8, 16, 32, 64), so
//   each lane holds 8 states and the matching 8 values of A[d, :] * log2(e)
//   in registers: eight independent exponentials per lane and step.  A
//   block is 128 threads, 128 / L channels of one sequence, on a grid of
//   (ceil(Di / (128 / L)), B): 1,024 blocks at falcon-mamba's width (N 16),
//   three resident per SM.
// * Sum over the lanes: each lane keeps its partial y for L steps, then a
//   reduce-scatter over the L lanes (L - 1 shuffles per L steps) leaves lane
//   j with the whole y of step j of the group.
// * Latency, not throughput, held the first version back (one group of L
//   steps at a time: 0.31 ms at the prefill shape): each step is a chain
//   of a shared-memory load, the exponential, the state update and the
//   sum over the states.  So the scan runs U groups at once with no bound
//   check inside (8 steps at N 16), letting one step's loads and
//   exponentials overlap another's recurrence, and sums y in two chains.
// * Tiles through an asynchronous ring: the x and dt tiles [TT, channels]
//   and the B_t and C_t rows [TT, N] of a tile arrive by cp.async (16-byte
//   copies where the rows allow, else 4-byte ones) into a two-stage ring in
//   shared memory, so tile k + 1 loads while tile k is scanned, with one
//   barrier per tile.  y is written over the x column it came from (each
//   warp owns its channels' columns; x rows are padded so these writes hit
//   distinct banks), and each warp stores its channels' y rows of the tile
//   as 16-byte vectors.
// * Exponentials: exp(dt * A) = 2^(dt * A log2 e), with A scaled once per
//   lane and one ex2.approx per state and step.
// * Checkpoints for the backward pass (mamba_scan_bwd.cu), when the caller
//   passes `ckpt`: each lane stores its 8 states at the start of every
//   tile, [B, ceil(T / 16), Di, N] float32 (a separate instantiation, so a
//   call without them runs the kernel it ran before).
//
// Layout: x, dt, y [B, T, Di] contiguous; B_t, C_t [B, T, N] with element
// strides (sb, st) given and a unit last stride (the model passes slices of
// one projection); A [Di, N]; h0, h_last [B, Di, N] contiguous; A, h0 and
// h_last 16-byte aligned.  h0 may be null (zeros).  h_last may alias h0, as
// it does at a decode step, which advances the cache entry in place: each
// lane reads its states before it writes them, and no other lane reads
// them.
//
// C interface (bound with ctypes): ms_launch returns the cudaError_t of
// the launch, 0 on success.

#include "scan_tile.cuh"

namespace {

using namespace scan;

// Blocks per SM (which caps the registers: 168 a thread at 3) for N <= 16,
// and groups of L steps unrolled together (8 steps at N 16).  A design
// sweep on the H100 chose these and scan_tile.cuh's states per lane,
// threads and ring: four blocks per SM (128 registers) spilled, four
// states a lane ran slower, a deeper ring changed nothing.
constexpr int kBlocksPerSM = 3, kGroups = 4;

template <int N>
struct Cfg {
  static constexpr int S = kStates;
  static constexpr int WARPS = kThreads / 32;
  static constexpr int L = N / S;                   // lanes per channel
  static constexpr int CH = kThreads / L;           // channels per block
  static constexpr int CW = CH / WARPS;             // channels per warp
  static constexpr int XS = CH + 32 / L;            // x row pitch (floats)
  static constexpr int U = L >= 8 ? 1 : kGroups;   // groups unrolled
  static_assert(L >= 1 && L <= 8 && CW % 4 == 0, "unsupported N");
  static constexpr int X = 0;                       // offsets in a stage
  static constexpr int DT = X + kTT * XS;
  static constexpr int BT = DT + kTT * CH;
  static constexpr int CT = BT + kTT * N;
  static constexpr int STAGE = CT + kTT * N;        // floats
  static constexpr int SMEM = kStages * STAGE * 4;  // bytes
};

struct ScanArgs {
  const float* x;
  const float* dt;
  const float* bt;
  const float* ct;
  const float* a;
  const float* h0;
  float* y;
  float* h_last;
  float* ckpt;        // [B, n_tiles, Di, N] states at tile starts, or null
  int T, Di;
  int64_t bt_sb, bt_st, ct_sb, ct_st;
  int vec;            // x, dt, B_t, C_t rows allow 16-byte copies
};

// v[i] is this lane's part of y for step i of a group of L steps; returns
// the whole y of step j = lane % L (L - 1 shuffles).
template <int L>
__device__ __forceinline__ float reduce_scatter(float (&v)[L], int j) {
#pragma unroll
  for (int o = L / 2; o >= 1; o /= 2) {
    const bool hi = j & o;
#pragma unroll
    for (int m = 0; m < o; ++m) {
      const float send = hi ? v[m] : v[m + o];
      const float keep = hi ? v[m + o] : v[m];
      v[m] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
  }
  return v[0];
}

// N 32 and 64 (test sizes) may take more registers: no spills.  CKPT:
// write the state at the start of every tile to p.ckpt.
template <int N, bool CKPT>
__global__ void __launch_bounds__(kThreads,
                                  N <= 16 ? kBlocksPerSM : 2)
mamba1_scan_kernel(const ScanArgs p) {
  using C = Cfg<N>;
  constexpr int L = C::L, CH = C::CH, CW = C::CW, XS = C::XS, S = C::S;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int j = tid % L;                     // this lane's slice of states
  const int c = tid / L;                     // channel within the block
  const int d0 = blockIdx.x * CH, b = blockIdx.y;
  const int d = d0 + c;
  const bool live = d < p.Di;
  const int64_t row0 = static_cast<int64_t>(b) * p.T;   // row (b, t = 0)
  const int n_tiles = (p.T + kTT - 1) / kTT;

  auto issue = [&](int k) {                  // tile k into its ring stage
    float* st = smem + (k % kStages) * C::STAGE;
    const int t0 = k * kTT, nt = min(kTT, p.T - t0);
    if (p.vec) {
      constexpr int Q = CH / 4;              // 16-byte chunks per x row
      for (int i = tid; i < nt * Q; i += kThreads) {
        const int t = i / Q, q = i % Q;
        const int dd = d0 + 4 * q;
        const int64_t off = (row0 + t0 + t) * p.Di + (dd < p.Di ? dd : 0);
        const int bytes = dd < p.Di ? 16 : 0;
        cp_async<16>(smem_u32(st + C::X + t * XS + 4 * q), p.x + off, bytes);
        cp_async<16>(smem_u32(st + C::DT + t * CH + 4 * q), p.dt + off, bytes);
      }
      for (int i = tid; i < nt * (N / 4); i += kThreads) {
        const int t = i / (N / 4), q = i % (N / 4);
        cp_async<16>(smem_u32(st + C::BT + t * N + 4 * q),
                     p.bt + b * p.bt_sb + (t0 + t) * p.bt_st + 4 * q, 16);
        cp_async<16>(smem_u32(st + C::CT + t * N + 4 * q),
                     p.ct + b * p.ct_sb + (t0 + t) * p.ct_st + 4 * q, 16);
      }
    } else {
      for (int i = tid; i < nt * CH; i += kThreads) {
        const int t = i / CH, q = i % CH;
        const int dd = d0 + q;
        const int64_t off = (row0 + t0 + t) * p.Di + (dd < p.Di ? dd : 0);
        const int bytes = dd < p.Di ? 4 : 0;
        cp_async<4>(smem_u32(st + C::X + t * XS + q), p.x + off, bytes);
        cp_async<4>(smem_u32(st + C::DT + t * CH + q), p.dt + off, bytes);
      }
      for (int i = tid; i < nt * N; i += kThreads) {
        const int t = i / N, q = i % N;
        cp_async<4>(smem_u32(st + C::BT + t * N + q),
                    p.bt + b * p.bt_sb + (t0 + t) * p.bt_st + q, 4);
        cp_async<4>(smem_u32(st + C::CT + t * N + q),
                    p.ct + b * p.ct_sb + (t0 + t) * p.ct_st + q, 4);
      }
    }
  };

#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < n_tiles) issue(k);
    cp_async_commit();
  }

  // this lane's states and A * log2(e), while the first tiles load
  float a2[S], h[S];
  const int64_t state = (static_cast<int64_t>(b) * p.Di + d) * N + j * S;
#pragma unroll
  for (int n = 0; n < S; ++n) a2[n] = h[n] = 0.f;
  if (live) {
    const float4* ar = reinterpret_cast<const float4*>(
        p.a + static_cast<int64_t>(d) * N + j * S);
#pragma unroll
    for (int i = 0; i < S / 4; ++i) {
      const float4 v = ar[i];
      a2[4 * i] = v.x * kLog2e;
      a2[4 * i + 1] = v.y * kLog2e;
      a2[4 * i + 2] = v.z * kLog2e;
      a2[4 * i + 3] = v.w * kLog2e;
    }
    if (p.h0) {
      const float4* hr = reinterpret_cast<const float4*>(p.h0 + state);
#pragma unroll
      for (int i = 0; i < S / 4; ++i) {
        const float4 v = hr[i];
        h[4 * i] = v.x;
        h[4 * i + 1] = v.y;
        h[4 * i + 2] = v.z;
        h[4 * i + 3] = v.w;
      }
    }
  }

  for (int k = 0; k < n_tiles; ++k) {
    if constexpr (CKPT) {
      if (live) {
        float4* out = reinterpret_cast<float4*>(
            p.ckpt +
            ((static_cast<int64_t>(b) * n_tiles + k) * p.Di + d) * N + j * S);
#pragma unroll
        for (int i = 0; i < S / 4; ++i)
          out[i] = make_float4(h[4 * i], h[4 * i + 1], h[4 * i + 2],
                               h[4 * i + 3]);
      }
    }
    cp_async_wait<kStages - 2>();
    __syncthreads();              // tile k in place; tile k - 1 used up
    if (k + kStages - 1 < n_tiles) issue(k + kStages - 1);
    cp_async_commit();

    float* st = smem + (k % kStages) * C::STAGE;
    float* xs = st + C::X;
    const float* dts = st + C::DT;
    const int t0 = k * kTT, nt = min(kTT, p.T - t0);
    // One group of L steps; `guard`: the tile may end inside the group.
    auto group = [&](const int g, const bool guard) {
      float part[L];
#pragma unroll
      for (int i = 0; i < L; ++i) {
        part[i] = 0.f;
        const int t = g + i;
        if (!guard || t < nt) {
          const float dtv = dts[t * CH + c];
          const float dtx = dtv * xs[t * XS + c];
          const float4* br = reinterpret_cast<const float4*>(
              st + C::BT + t * N + j * S);
          const float4* cr = reinterpret_cast<const float4*>(
              st + C::CT + t * N + j * S);
          float y0 = 0.f, y1 = 0.f;           // two chains, half as long
#pragma unroll
          for (int q = 0; q < S / 4; ++q) {
            const float4 bv = br[q], cv = cr[q];
            const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
            const float cc[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int n = 4 * q + e;
              h[n] = fmaf(h[n], ex2(dtv * a2[n]), dtx * bb[e]);
              if (e % 2) y1 = fmaf(cc[e], h[n], y1);
              else y0 = fmaf(cc[e], h[n], y0);
            }
          }
          part[i] = y0 + y1;
        }
      }
      const float y = reduce_scatter<L>(part, j);
      if (!guard || g + j < nt) xs[(g + j) * XS + c] = y;  // over x, read
    };
    // U groups at a time with no bound inside, so that one group's loads
    // and exponentials overlap the others' recurrence; then the rest
    int g = 0;
#pragma unroll 1
    for (; g + C::U * L <= nt; g += C::U * L) {
#pragma unroll
      for (int u = 0; u < C::U; ++u) group(g + u * L, false);
    }
#pragma unroll 1
    for (; g < nt; g += L) group(g, true);
    __syncwarp();

    // this warp's channels' y rows of the tile, 16 bytes at a time
    const int w0 = warp * CW;
    float* yg = p.y + (row0 + t0) * p.Di + d0 + w0;
    if (p.vec) {
      constexpr int Q = CW / 4;
      for (int i = lane; i < nt * Q; i += 32) {
        const int t = i / Q, q = i % Q;
        if (d0 + w0 + 4 * q < p.Di)
          *reinterpret_cast<float4*>(yg + t * p.Di + 4 * q) =
              *reinterpret_cast<const float4*>(xs + t * XS + w0 + 4 * q);
      }
    } else {
      for (int i = lane; i < nt * CW; i += 32) {
        const int t = i / CW, q = i % CW;
        if (d0 + w0 + q < p.Di) yg[t * p.Di + q] = xs[t * XS + w0 + q];
      }
    }
  }
  cp_async_wait<0>();

  if (live) {
    float4* out = reinterpret_cast<float4*>(p.h_last + state);
#pragma unroll
    for (int i = 0; i < S / 4; ++i)
      out[i] = make_float4(h[4 * i], h[4 * i + 1], h[4 * i + 2], h[4 * i + 3]);
  }
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

template <int N, bool CKPT>
int launch(ScanArgs p, int B, cudaStream_t stream) {
  using C = Cfg<N>;
  p.vec = p.Di % 4 == 0 && aligned16(p.x) && aligned16(p.dt) &&
          aligned16(p.bt) && aligned16(p.ct) && p.bt_sb % 4 == 0 &&
          p.bt_st % 4 == 0 && p.ct_sb % 4 == 0 && p.ct_st % 4 == 0;
  static bool attr_set = false;       // once per instantiation
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        mamba1_scan_kernel<N, CKPT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        C::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const dim3 grid((p.Di + C::CH - 1) / C::CH, B);
  mamba1_scan_kernel<N, CKPT><<<grid, kThreads, C::SMEM, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <bool CKPT>
int dispatch(const ScanArgs& p, int B, int N, cudaStream_t s) {
  switch (N) {
    case 8: return launch<8, CKPT>(p, B, s);
    case 16: return launch<16, CKPT>(p, B, s);
    case 32: return launch<32, CKPT>(p, B, s);
    case 64: return launch<64, CKPT>(p, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// N (d_state) in {8, 16, 32, 64}; h0 and ckpt may be null; strides in
// elements.
int ms_launch(const void* x, const void* dt, const void* bt, const void* ct,
              const void* a, const void* h0, void* y, void* h_last,
              void* ckpt, int B, int T, int Di, int N, int64_t bt_sb,
              int64_t bt_st, int64_t ct_sb, int64_t ct_st, void* stream) {
  const ScanArgs p{
      static_cast<const float*>(x),  static_cast<const float*>(dt),
      static_cast<const float*>(bt), static_cast<const float*>(ct),
      static_cast<const float*>(a),  static_cast<const float*>(h0),
      static_cast<float*>(y),        static_cast<float*>(h_last),
      static_cast<float*>(ckpt),     T, Di, bt_sb, bt_st, ct_sb, ct_st, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return ckpt ? dispatch<true>(p, B, N, s) : dispatch<false>(p, B, N, s);
}

// steps between the checkpoints ms_launch writes (the caller sizes them)
int ms_ckpt_steps() { return kTT; }

}  // extern "C"
