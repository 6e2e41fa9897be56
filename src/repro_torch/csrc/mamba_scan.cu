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
// Bound: bytes.  Each call reads x and dt and writes y, 3 * B * T * Di
// floats, plus B_t, C_t (B * T * N each), A (Di * N) and the states
// (B * Di * N each): about 7 flops per (b, t, d, n) against the 12 bytes
// per (b, t, d), i.e. 7N / 12 flops per byte, under 10 at N = 16 and far
// below the card's ~20 fp32 flops per byte.  At falcon-mamba's prefill
// shape (B 8, T 512, Di 8192, N 16) that is 0.41 GB, 0.12 ms at
// 3.35 TB/s, against 3.8 GFLOP, 0.06 ms at 67 TFLOP/s.  The likely real
// limits lie elsewhere: B * T * Di * N = 537 M exponentials on the
// special-function units (16 per SM per clock: about 0.13 ms at 1.98 GHz,
// more with accurate expf's range reduction), and the serial dependence
// over T, which leaves only B * Di threads of parallel work.
//
// Design (simple first): one thread per (b, d) holds that channel's N
// state values and its row A[d, :] in registers; a block is 128 channels
// of one sequence, on a grid of (B, ceil(Di / 128)).  The loop over T
// takes the place of the TPU's fori_loop; it walks T in tiles of TT
// steps.  At the start of a tile every thread loads its own x and dt
// column for the tile into shared memory (independent loads, all in
// flight together: neighbouring threads on neighbouring channels, so they
// coalesce), and the block stages the tile's B_t and C_t rows ([TT, N],
// shared by every channel of the block).  y is written as it is made, one
// coalesced row of 128 channels per step.  Accurate expf; no tensor cores,
// cp.async, TMA or chunked-parallel scan yet.
//
// Layout: x, dt, y [B, T, Di]; B_t, C_t [B, T, N]; A [Di, N]; h0, h_last
// [B, Di, N]; all contiguous fp32, 16-byte aligned.  h0 may be null
// (zeros).  h_last may alias h0, as it does at a decode step, which
// advances the cache entry in place: each thread reads its state before
// it writes it.
//
// C interface (bound with ctypes): ms_launch returns the cudaError_t of
// the launch, 0 on success.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

struct ScanArgs {
  const float* x;
  const float* dt;
  const float* bt;
  const float* ct;
  const float* a;
  const float* h0;
  float* y;
  float* h_last;
  int T, Di;
};

template <int N>
__device__ __forceinline__ void load_row(const float* src, float (&dst)[N]) {
  const float4* s = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const float4 v = s[i];
    dst[4 * i] = v.x;
    dst[4 * i + 1] = v.y;
    dst[4 * i + 2] = v.z;
    dst[4 * i + 3] = v.w;
  }
}

template <int N, int TT>
__global__ void __launch_bounds__(kThreads)
mamba1_scan_kernel(const ScanArgs p) {
  __shared__ float x_s[TT][kThreads];
  __shared__ float dt_s[TT][kThreads];
  __shared__ float b_s[TT * N];
  __shared__ float c_s[TT * N];

  const int b = blockIdx.x, tid = threadIdx.x;
  const int d = blockIdx.y * kThreads + tid;
  const bool live = d < p.Di;
  const int64_t state = (static_cast<int64_t>(b) * p.Di + d) * N;

  float a[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) a[n] = h[n] = 0.f;
  if (live) {
    load_row<N>(p.a + static_cast<int64_t>(d) * N, a);
    if (p.h0) load_row<N>(p.h0 + state, h);
  }

  const int64_t row0 = static_cast<int64_t>(b) * p.T;   // row (b, t = 0)
  for (int t0 = 0; t0 < p.T; t0 += TT) {
    const int nt = min(TT, p.T - t0);
    __syncthreads();                        // the previous tile is used up
    const float* bt = p.bt + (row0 + t0) * N;
    const float* ct = p.ct + (row0 + t0) * N;
    for (int i = tid; i < nt * N; i += kThreads) {
      b_s[i] = bt[i];
      c_s[i] = ct[i];
    }
    const int64_t off0 = (row0 + t0) * p.Di + d;
    if (live) {
      for (int tt = 0; tt < nt; ++tt) {
        x_s[tt][tid] = p.x[off0 + static_cast<int64_t>(tt) * p.Di];
        dt_s[tt][tid] = p.dt[off0 + static_cast<int64_t>(tt) * p.Di];
      }
    }
    __syncthreads();
    if (!live) continue;
    for (int tt = 0; tt < nt; ++tt) {
      const float dt_t = dt_s[tt][tid];
      const float dtx = dt_t * x_s[tt][tid];
      const float* bn = b_s + tt * N;
      const float* cn = c_s + tt * N;
      float y = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        h[n] = h[n] * expf(dt_t * a[n]) + dtx * bn[n];
        y += cn[n] * h[n];
      }
      p.y[off0 + static_cast<int64_t>(tt) * p.Di] = y;
    }
  }

  if (live) {
    float4* out = reinterpret_cast<float4*>(p.h_last + state);
#pragma unroll
    for (int i = 0; i < N / 4; ++i)
      out[i] = make_float4(h[4 * i], h[4 * i + 1], h[4 * i + 2], h[4 * i + 3]);
  }
}

// Tiles of 32 steps (16 at N = 64) keep the static shared memory under
// 48 KB: 2 * TT * 128 floats of x and dt plus 2 * TT * N of B_t and C_t.
template <int N>
int launch(const ScanArgs& p, int B, cudaStream_t stream) {
  constexpr int TT = N <= 32 ? 32 : 16;
  const dim3 grid(B, (p.Di + kThreads - 1) / kThreads);
  mamba1_scan_kernel<N, TT><<<grid, kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// N (d_state) in {8, 16, 32, 64}; h0 may be null.
int ms_launch(const void* x, const void* dt, const void* bt, const void* ct,
              const void* a, const void* h0, void* y, void* h_last, int B,
              int T, int Di, int N, void* stream) {
  const ScanArgs p{
      static_cast<const float*>(x),  static_cast<const float*>(dt),
      static_cast<const float*>(bt), static_cast<const float*>(ct),
      static_cast<const float*>(a),  static_cast<const float*>(h0),
      static_cast<float*>(y),        static_cast<float*>(h_last),
      T, Di};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 8: return launch<8>(p, B, s);
    case 16: return launch<16>(p, B, s);
    case 32: return launch<32>(p, B, s);
    case 64: return launch<64>(p, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
