// The backward pass of the Mamba-1 selective scan (B4) on Hopper (sm_90a),
// fp32.
//
// The port's own kernel: the JAX package has no backward Pallas kernel (it
// differentiates its chunked associative scan, src/repro/models/ssm.py),
// and the TPU kernel it stands beside is `mamba1_scan` in
// src/repro/kernels/mamba_scan.py.  The forward pass (mamba_scan.cu) is,
// per sequence b and channel d, h_t = a_t * h_{t-1} + dt_t x_t B_t with
// a_t = exp(dt_t A[d, :]), y_t = C_t . h_t.  With g_t the gradient that
// reaches h_t:
//
//   g_T = C_T dy_T + dh_last,   g_t = C_t dy_t + a_{t+1} * g_{t+1}
//   dC_t[n] = sum_d dy_t[d] h_t[d, n]
//   dB_t[n] = sum_d g_t[d, n] dt_t[d] x_t[d]
//   dx_t[d] = dt_t[d] sum_n g_t[d, n] B_t[n]
//   ddt_t[d] = sum_n g_t[d, n] (A[d, n] a_t[d, n] h_{t-1}[d, n] + x_t[d] B_t[n])
//   dA = sum_{b, t} g_t dt_t a_t h_{t-1},   dh0 = a_1 * g_1
//
// Bound (chip_smoke.time_scan_bwd): it reads x, dt, dy and writes dx, ddt
// (5 * B * T * Di floats), reads B_t, C_t and writes dB_t, dC_t
// (4 * B * T * N), reads A and writes dA (2 * Di * N), against about 20
// fp32 operations per (b, t, d, n) at 67 TFLOP/s: at falcon-mamba's
// training shape (8 x 512, Di 8192, N 16) 0.67 GB, 0.2010 ms of bytes
// against 0.16 ms of operations.  Its two exponentials per (b, t, d, n)
// take about as long again on the special-function units (16 per SM per
// clock: 1.07 G, about 0.25 ms).
//
// Design.
// * Threads, as in the forward kernel: a channel's N states are split
//   over L = N / 8 neighbouring lanes, 8 states a lane; a block of 128
//   threads holds 128 / L channels of one sequence.
// * States going backward: a state is never inverted from h_t (a_t
//   underflows for large dt |A|).  The forward kernel writes the state at
//   the start of every tile of 16 steps ([B, T / 16, Di, N] float32, the
//   caller keeps it for the backward pass); each tile's states are
//   recomputed from its checkpoint into shared memory, each thread its own
//   slots, and walked from the tile's last step to its first.  That is
//   two exponentials per state and step, one in each pass.
// * Tiles through an asynchronous ring, walked backward: the x, dt and dy
//   tiles [16 steps, channels] and the B_t and C_t rows [16, N] arrive by
//   cp.async into a two-stage ring, tile k - 1 while tile k is worked on,
//   as the forward kernel streams them forward; the next tile's
//   checkpoint is loaded into registers a tile ahead.  One barrier per
//   tile.
// * Sums over the states (dx, ddt): each lane sums its 8 states, the L
//   lanes of a channel combine with shuffles; lane 0 of the channel writes.
// * Sums over the channels (dB, dC), with no barrier per step: each lane's
//   16 terms of a step (8 of dB, 8 of dC) are reduce-scattered over the
//   warp's channels with shuffles (15 for N 16), each lane keeping whole
//   warp sums, which it writes to the warp's slice of a [warps, 16 steps,
//   2N] buffer in shared memory.  After the tile's barrier the block adds
//   its warps in warp order and writes one partial per (channel block, b,
//   t, n); a second kernel sums the partials over the channel blocks in a
//   fixed order, and dA (one partial per sequence, kept in registers) over
//   the sequences: no atomics, so two calls are bitwise equal.  The buffer
//   alternates between tiles, so a tile's sums are read while the next
//   tile's are written.
// * Exponentials: exp(dt A) = 2^(dt A log2 e) with ex2.approx, as the
//   forward kernel computes them.
//
// What still holds it back (PERF.md has the numbers): the recomputed
// states take 64 KB of shared memory per block, so two blocks (8 warps)
// share an SM and the latency of each step's chain is hidden by four
// unrolled steps alone; the per-step sums over channels cost 15
// shuffles and 30 selects a lane; the partials (blocks x B x T x 2N
// floats, 67 MB at the training shape) are written and read back once.
//
// Layout: x, dt, dy, dx, ddt [B, T, Di]; B_t, C_t [B, T, N]; A [Di, N];
// ckpt [B, ceil(T / 16), Di, N]; dh_last, dh0 [B, Di, N]; all contiguous,
// 16-byte aligned.  dh_last may be null (zeros).
//
// C interface (bound with ctypes): msb_launch runs the scan backward and
// the two sums on the stream and returns the cudaError_t of the launches,
// 0 on success.

#include "scan_tile.cuh"

namespace {

using namespace scan;

constexpr int kWarps = kThreads / 32;
// steps of a whole tile unrolled in the recompute and in the walk back:
// 4 and 4 ran 8% faster on an H100 than 16 and 16, which took 255
// registers and spilled (PERF.md)
constexpr int kUnrollRecompute = 4, kUnrollWalk = 4;

template <int N>
struct Cfg {
  static constexpr int S = kStates;
  static constexpr int L = N / S;                   // lanes per channel
  static constexpr int CH = kThreads / L;           // channels per block
  static constexpr int LW = L > 2 ? L : 2;          // lanes per summed group
  static constexpr int R = LW / 2;                  // warp sums per lane
  static_assert(L >= 1 && L <= 8, "unsupported N");
  static constexpr int X = 0;                       // offsets in a stage
  static constexpr int DT = X + kTT * CH;
  static constexpr int DY = DT + kTT * CH;
  static constexpr int BT = DY + kTT * CH;
  static constexpr int CT = BT + kTT * N;
  static constexpr int STAGE = CT + kTT * N;        // floats
  static constexpr int HS = kTT * S * kThreads;     // recomputed states
  static constexpr int RED = kWarps * kTT * 2 * N;  // one tile's warp sums
  static constexpr int SMEM = 4 * (HS + kStages * STAGE + 2 * RED);
};

struct BwdArgs {
  const float* x;
  const float* dt;
  const float* bt;
  const float* ct;
  const float* a;
  const float* dy;
  const float* ckpt;       // [B, n_tiles, Di, N]
  const float* dh_last;    // may be null
  float* dx;
  float* ddt;
  float* part_bc;          // [gridDim.x, B, T, 2N]: dB then dC
  float* part_a;           // [B, Di, N]
  float* dh0;
  int B, T, Di;
  int vec;                 // x, dt, dy rows allow 16-byte copies
};

__device__ __forceinline__ void load8(const float* p, float (&v)[kStates]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store8(float* p, const float (&v)[kStates]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// a if p else b, as one selp on values held in registers: a select
// between two array elements written in C++ may become a load from a
// selected address, which puts the array in local memory
__device__ __forceinline__ float pick(bool p, float a, float b) {
  float r;
  asm("{\n .reg .pred q;\n setp.ne.u32 q, %3, 0;\n"
      " selp.f32 %0, %1, %2, q;\n}\n"
      : "=f"(r) : "f"(a), "f"(b), "r"(static_cast<unsigned>(p)));
  return r;
}

// One round of the sum below: lanes O apart swap halves of their live
// terms and add, so each keeps half as many.
template <int O>
__device__ __forceinline__ void halve(float (&v)[16], int lane) {
  constexpr int kHalf = O / 2;
  const bool hi = lane & O;
#pragma unroll
  for (int q = 0; q < kHalf; ++q) {
    const float send = pick(hi, v[q], v[q + kHalf]);
    const float keep = pick(hi, v[q + kHalf], v[q]);
    v[q] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
}

// v[0..15] summed over the lanes of the warp that share lane % L (its
// channels), as a reduce-scatter over lane offsets 16, 8, .., L:
// afterwards v[q], q < R, holds the warp sum of term q + R * (lane / LW).
// With L = 1 a last round adds pairs, so lanes 2m and 2m + 1 hold the
// same sums.  (The rounds are templates so that every loop has a constant
// trip count: a loop nest unrolled from a loop over the offsets left v in
// local memory.)
template <int L>
__device__ __forceinline__ void warp_channel_sum(float (&v)[16], int lane) {
  halve<16>(v, lane);
  if constexpr (L <= 8) halve<8>(v, lane);
  if constexpr (L <= 4) halve<4>(v, lane);
  if constexpr (L <= 2) halve<2>(v, lane);
  if constexpr (L == 1) v[0] += __shfl_xor_sync(0xffffffffu, v[0], 1);
}

template <int N>
__global__ void __launch_bounds__(kThreads, N == 16 ? 2 : 1)
mamba1_scan_bwd_kernel(const BwdArgs p) {
  using C = Cfg<N>;
  constexpr int S = C::S, L = C::L, CH = C::CH, R = C::R;
  extern __shared__ float4 smem4[];
  float* hs = reinterpret_cast<float*>(smem4);     // [kTT][S][kThreads]
  float* ring = hs + C::HS;                         // kStages x STAGE
  float* red = ring + kStages * C::STAGE;           // [2][warps][kTT][2N]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int j = tid % L, c = tid / L;
  const int d0 = blockIdx.x * CH, b = blockIdx.y;
  const int d = d0 + c;
  const bool live = d < p.Di;
  const int dc = live ? d : 0;               // loads of a dead channel
  const int64_t row0 = static_cast<int64_t>(b) * p.T;   // row (b, t = 0)
  const int n_tiles = (p.T + kTT - 1) / kTT;
  const int64_t state = (static_cast<int64_t>(b) * p.Di + dc) * N + j * S;
  auto ckpt_of = [&](int k) {
    return p.ckpt + ((static_cast<int64_t>(b) * n_tiles + k) * p.Di + dc) *
                        N + j * S;
  };

  auto issue = [&](int k) {                  // tile k into its ring stage
    float* st = ring + (k % kStages) * C::STAGE;
    const int t0 = k * kTT, nt = min(kTT, p.T - t0);
    if (p.vec) {
      constexpr int Q = CH / 4;              // 16-byte chunks per row
      for (int i = tid; i < nt * Q; i += kThreads) {
        const int t = i / Q, q = i % Q;
        const int dd = d0 + 4 * q;
        const int64_t off = (row0 + t0 + t) * p.Di + (dd < p.Di ? dd : 0);
        const int bytes = dd < p.Di ? 16 : 0;
        const uint32_t dst = smem_u32(st + t * CH + 4 * q);
        cp_async<16>(dst + 4 * C::X, p.x + off, bytes);
        cp_async<16>(dst + 4 * C::DT, p.dt + off, bytes);
        cp_async<16>(dst + 4 * C::DY, p.dy + off, bytes);
      }
    } else {
      for (int i = tid; i < nt * CH; i += kThreads) {
        const int t = i / CH, q = i % CH;
        const int dd = d0 + q;
        const int64_t off = (row0 + t0 + t) * p.Di + (dd < p.Di ? dd : 0);
        const int bytes = dd < p.Di ? 4 : 0;
        const uint32_t dst = smem_u32(st + t * CH + q);
        cp_async<4>(dst + 4 * C::X, p.x + off, bytes);
        cp_async<4>(dst + 4 * C::DT, p.dt + off, bytes);
        cp_async<4>(dst + 4 * C::DY, p.dy + off, bytes);
      }
    }
    for (int i = tid; i < nt * (N / 4); i += kThreads) {
      const int t = i / (N / 4), q = i % (N / 4);
      const int64_t off = (row0 + t0 + t) * N + 4 * q;
      const uint32_t dst = smem_u32(st + t * N + 4 * q);
      cp_async<16>(dst + 4 * C::BT, p.bt + off, 16);
      cp_async<16>(dst + 4 * C::CT, p.ct + off, 16);
    }
  };
  // the warp sums of tile k (buffer `buf`), added in warp order
  auto flush = [&](int k, int buf) {
    const int t0 = k * kTT, nt = min(kTT, p.T - t0);
    const float* rb = red + buf * C::RED;
    float* out = p.part_bc +
                 ((static_cast<int64_t>(blockIdx.x) * p.B + b) * p.T + t0) *
                     (2 * N);
    for (int e = tid; e < nt * 2 * N; e += kThreads) {
      float acc = rb[e];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) acc += rb[w * kTT * 2 * N + e];
      out[e] = acc;
    }
  };

  issue(n_tiles - 1);                        // the last tile first
  cp_async_commit();

  float A[S], a2[S], g[S], da_acc[S], h_next[S];
  load8(p.a + static_cast<int64_t>(dc) * N + j * S, A);
#pragma unroll
  for (int s = 0; s < S; ++s) {
    a2[s] = A[s] * kLog2e;
    g[s] = da_acc[s] = h_next[s] = 0.f;
  }
  if (live) {
    if (p.dh_last) load8(p.dh_last + state, g);
    load8(ckpt_of(n_tiles - 1), h_next);
  }

  for (int m = 0; m < n_tiles; ++m) {
    const int k = n_tiles - 1 - m;           // tiles from the last
    cp_async_wait<0>();
    __syncthreads();              // tile k in place; tile k + 1 used up
    if (m > 0) flush(k + 1, (m - 1) & 1);
    if (k > 0) issue(k - 1);
    cp_async_commit();

    float h_start[S];
#pragma unroll
    for (int s = 0; s < S; ++s) h_start[s] = h_next[s];
    if (k > 0 && live) load8(ckpt_of(k - 1), h_next);   // a tile ahead

    const float* st = ring + (k % kStages) * C::STAGE;
    const int t0 = k * kTT, nt = min(kTT, p.T - t0);
    float* rb = red + (m & 1) * C::RED + warp * kTT * 2 * N;

    // the tile's states, each thread into its own slots
    float h[S];
#pragma unroll
    for (int s = 0; s < S; ++s) h[s] = h_start[s];
    auto forward = [&](int i) {
      const float dtv = st[C::DT + i * CH + c];
      const float u = dtv * st[C::X + i * CH + c];
      float bb[S];
      load8(st + C::BT + i * N + j * S, bb);
#pragma unroll
      for (int s = 0; s < S; ++s) {
        h[s] = fmaf(h[s], ex2(dtv * a2[s]), u * bb[s]);
        hs[(i * S + s) * kThreads + tid] = h[s];
      }
    };
    if (nt == kTT) {
#pragma unroll kUnrollRecompute
      for (int i = 0; i < kTT; ++i) forward(i);
    } else {
#pragma unroll 1
      for (int i = 0; i < nt; ++i) forward(i);
    }

    // walk the tile back; h holds h_t of the step, then h_{t-1}
    auto backward = [&](int i) {
      const float dtv = st[C::DT + i * CH + c];
      const float xv = st[C::X + i * CH + c];
      const float dyv = st[C::DY + i * CH + c];
      const float dtx = dtv * xv;
      float bb[S], cc[S], hp[S], v[16];
      load8(st + C::BT + i * N + j * S, bb);
      load8(st + C::CT + i * N + j * S, cc);
#pragma unroll
      for (int s = 0; s < S; ++s)
        hp[s] = i > 0 ? hs[((i - 1) * S + s) * kThreads + tid] : h_start[s];
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const float av = ex2(dtv * a2[s]);
        g[s] = fmaf(cc[s], dyv, g[s]);
        v[s] = g[s] * dtx;                               // dB
        v[S + s] = dyv * h[s];                           // dC
        s1 = fmaf(g[s], bb[s], s1);
        const float gah = g[s] * av * hp[s];
        s2 = fmaf(gah, A[s], s2);
        da_acc[s] = fmaf(gah, dtv, da_acc[s]);
        g[s] *= av;
        h[s] = hp[s];
      }
#pragma unroll
      for (int o = L / 2; o >= 1; o /= 2) {
        s1 += __shfl_xor_sync(0xffffffffu, s1, o);
        s2 += __shfl_xor_sync(0xffffffffu, s2, o);
      }
      if (live && j == 0) {
        const int64_t r = (row0 + t0 + i) * p.Di + d;
        p.dx[r] = dtv * s1;
        p.ddt[r] = s2 + xv * s1;
      }
      warp_channel_sum<L>(v, lane);
      if (L > 1 || lane % 2 == 0) {
#pragma unroll
        for (int q = 0; q < R; ++q) {
          const int term = q + R * (lane / C::LW);     // 0..15
          rb[i * 2 * N + (term / S) * N + j * S + term % S] = v[q];
        }
      }
    };
    if (nt == kTT) {
#pragma unroll kUnrollWalk
      for (int i = kTT - 1; i >= 0; --i) backward(i);
    } else {
#pragma unroll 1
      for (int i = nt - 1; i >= 0; --i) backward(i);
    }
  }
  __syncthreads();
  flush(0, (n_tiles - 1) & 1);
  if (live) {
    store8(p.dh0 + state, g);
    store8(p.part_a + state, da_acc);
  }
}

// out[i] = sum over p < n_parts of in[p * stride + i], in order of p.
__global__ void sum_parts_kernel(const float* __restrict__ in,
                                 float* __restrict__ out, int n_parts,
                                 int64_t stride) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= stride) return;
  float acc = 0.f;
  for (int q = 0; q < n_parts; ++q) acc += in[q * stride + i];
  out[i] = acc;
}

int sum_parts(const float* in, float* out, int n_parts, int64_t stride,
              cudaStream_t stream) {
  constexpr int kSumThreads = 256;
  const int64_t blocks = (stride + kSumThreads - 1) / kSumThreads;
  sum_parts_kernel<<<static_cast<unsigned>(blocks), kSumThreads, 0,
                     stream>>>(in, out, n_parts, stride);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

template <int N>
int launch(BwdArgs p, float* dbc, float* da, cudaStream_t stream) {
  using C = Cfg<N>;
  p.vec = p.Di % 4 == 0 && aligned16(p.x) && aligned16(p.dt) &&
          aligned16(p.dy);
  static bool attr_set = false;       // once per instantiation
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        mamba1_scan_bwd_kernel<N>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const int blocks = (p.Di + C::CH - 1) / C::CH;
  mamba1_scan_bwd_kernel<N><<<dim3(blocks, p.B), kThreads, C::SMEM,
                              stream>>>(p);
  int err = static_cast<int>(cudaGetLastError());
  if (!err)
    err = sum_parts(p.part_bc, dbc, blocks,
                    static_cast<int64_t>(p.B) * p.T * 2 * N, stream);
  if (!err)
    err = sum_parts(p.part_a, da, p.B, static_cast<int64_t>(p.Di) * N,
                    stream);
  return err;
}

}  // namespace

extern "C" {

// channel blocks of msb_launch's grid, which size part_bc (the caller
// allocates it); 0 for an N the kernel does not take
int msb_blocks(int Di, int N) {
  switch (N) {
    case 8: return (Di + Cfg<8>::CH - 1) / Cfg<8>::CH;
    case 16: return (Di + Cfg<16>::CH - 1) / Cfg<16>::CH;
    case 32: return (Di + Cfg<32>::CH - 1) / Cfg<32>::CH;
    case 64: return (Di + Cfg<64>::CH - 1) / Cfg<64>::CH;
    default: return 0;
  }
}

// N (d_state) in {8, 16, 32, 64}; dh_last may be null; ckpt as the
// forward kernel writes it; part_bc [msb_blocks(Di, N), B, T, 2N].
// dbc [B, T, 2N] gets dB_t then dC_t per step, da [Di, N] gets dA.
int msb_launch(const void* x, const void* dt, const void* bt, const void* ct,
               const void* a, const void* dy, const void* ckpt,
               const void* dh_last, void* dx, void* ddt, void* part_bc,
               void* part_a, void* dh0, void* dbc, void* da, int B, int T,
               int Di, int N, void* stream) {
  const BwdArgs p{
      static_cast<const float*>(x),    static_cast<const float*>(dt),
      static_cast<const float*>(bt),   static_cast<const float*>(ct),
      static_cast<const float*>(a),    static_cast<const float*>(dy),
      static_cast<const float*>(ckpt), static_cast<const float*>(dh_last),
      static_cast<float*>(dx),         static_cast<float*>(ddt),
      static_cast<float*>(part_bc),    static_cast<float*>(part_a),
      static_cast<float*>(dh0),        B, T, Di, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out_bc = static_cast<float*>(dbc);
  float* out_a = static_cast<float*>(da);
  switch (N) {
    case 8: return launch<8>(p, out_bc, out_a, s);
    case 16: return launch<16>(p, out_bc, out_a, s);
    case 32: return launch<32>(p, out_bc, out_a, s);
    case 64: return launch<64>(p, out_bc, out_a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
