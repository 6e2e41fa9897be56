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
// Bound: it reads x, dt, dy and writes dx, ddt (5 * B * T * Di floats),
// reads B_t, C_t and writes dB_t, dC_t (4 * B * T * N), and does about 20
// fp32 operations and 3 exponentials per (b, t, d, n): at falcon-mamba's
// training shape (8 x 512, Di 8192, N 16) 0.71 GB and 11 G operations,
// about 0.21 ms of bytes and 0.16 ms of fp32 operations.
//
// Design (simple first, right before fast).
// * Threads: as in the forward kernel, a channel's N states are split over
//   L = N / 8 neighbouring lanes, 8 states a lane; a block of 128 threads
//   holds 128 / L channels of one sequence.
// * States going backward: the states are never inverted from h_t (a_t
//   underflows for large dt |A|).  A first sweep forward keeps the state
//   at the start of every chunk of kChunk steps in a float32 scratch
//   [B, T / kChunk, Di, N]; going backward, each chunk's states are
//   recomputed from its start into shared memory (each thread its own
//   slots) and walked from the chunk's last step to its first.
// * Sums over the states (dx, ddt): each lane sums its 8 states, the L
//   lanes of a channel combine with shuffles.
// * Sums over the channels (dB, dC): per step, each thread puts its 8 dB
//   and 8 dC terms in shared memory, and the block sums its channels in a
//   fixed order, one partial per (channel block, b, t, n); dA keeps one
//   partial per sequence in registers.  A second kernel sums the partials
//   in a fixed order (over channel blocks for dB and dC, over sequences
//   for dA): no atomics, so two calls are bitwise equal.
// * Exponentials: exp(dt A) = 2^(dt A log2 e) with ex2.approx, as the
//   forward kernel computes them.
//
// Layout: x, dt, dy, dx, ddt [B, T, Di]; B_t, C_t [B, T, N]; A [Di, N];
// h0, dh_last, dh0 [B, Di, N]; all contiguous, 16-byte aligned.  h0 and
// dh_last may be null (zeros).
//
// C interface (bound with ctypes): msb_launch runs the scan backward and
// the two sums on the stream and returns the cudaError_t of the launches,
// 0 on success.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;           // per block
constexpr int kStates = 8;              // states per lane
constexpr int kChunk = 16;              // steps per recomputed chunk
constexpr float kLog2e = 1.4426950408889634f;

struct BwdArgs {
  const float* x;
  const float* dt;
  const float* bt;
  const float* ct;
  const float* a;
  const float* dy;
  const float* h0;         // may be null
  const float* dh_last;    // may be null
  float* dx;
  float* ddt;
  float* ckpt;             // [B, n_chunks, Di, N]
  float* part_bc;          // [gridDim.x, B, T, 2N]: dB then dC
  float* part_a;           // [B, Di, N]
  float* dh0;
  int B, T, Di, n_chunks;
};

__device__ __forceinline__ float ex2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

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

template <int N>
__global__ void __launch_bounds__(kThreads)
mamba1_scan_bwd_kernel(const BwdArgs p) {
  constexpr int S = kStates, L = N / S, CH = kThreads / L;
  constexpr int TPO = kThreads / (2 * N);   // threads per (dB | dC, n) sum
  constexpr int PER = CH / TPO;             // channels each of them adds
  extern __shared__ float4 smem4[];
  float* hs = reinterpret_cast<float*>(smem4);     // [kChunk][S][kThreads]
  float* red = hs + kChunk * S * kThreads;         // [2][2][CH][N]

  const int tid = threadIdx.x, j = tid % L, c = tid / L;
  const int d0 = blockIdx.x * CH, b = blockIdx.y;
  const int d = d0 + c;
  const bool live = d < p.Di;
  const int dc = live ? d : 0;               // loads of a dead channel
  const int64_t state = (static_cast<int64_t>(b) * p.Di + dc) * N + j * S;
  const int64_t seq = static_cast<int64_t>(b) * p.T;

  float A[S], a2[S], h[S];
  load8(p.a + static_cast<int64_t>(dc) * N + j * S, A);
#pragma unroll
  for (int s = 0; s < S; ++s) {
    a2[s] = A[s] * kLog2e;
    h[s] = 0.f;
  }
  if (p.h0) load8(p.h0 + state, h);

  // the state at the start of every chunk
  for (int t = 0; t < p.T; ++t) {
    if (t % kChunk == 0 && live)
      store8(p.ckpt + ((static_cast<int64_t>(b) * p.n_chunks + t / kChunk) *
                           p.Di + dc) * N + j * S, h);
    const int64_t r = (seq + t) * p.Di + dc;
    const float dtv = p.dt[r], u = dtv * p.x[r];
    float bb[S];
    load8(p.bt + (seq + t) * N + j * S, bb);
#pragma unroll
    for (int s = 0; s < S; ++s) h[s] = fmaf(h[s], ex2(dtv * a2[s]), u * bb[s]);
  }

  float g[S], da_acc[S];
#pragma unroll
  for (int s = 0; s < S; ++s) g[s] = da_acc[s] = 0.f;
  if (p.dh_last) load8(p.dh_last + state, g);

  int buf = 0;
  for (int ch = p.n_chunks - 1; ch >= 0; --ch) {
    const int t0 = ch * kChunk, nt = min(kChunk, p.T - t0);
    float h_start[S];
    load8(p.ckpt + ((static_cast<int64_t>(b) * p.n_chunks + ch) * p.Di + dc) *
                       N + j * S, h_start);
    // recompute the chunk's states, each thread into its own slots
#pragma unroll
    for (int s = 0; s < S; ++s) h[s] = h_start[s];
    for (int i = 0; i < nt; ++i) {
      const int64_t r = (seq + t0 + i) * p.Di + dc;
      const float dtv = p.dt[r], u = dtv * p.x[r];
      float bb[S];
      load8(p.bt + (seq + t0 + i) * N + j * S, bb);
#pragma unroll
      for (int s = 0; s < S; ++s) {
        h[s] = fmaf(h[s], ex2(dtv * a2[s]), u * bb[s]);
        hs[(i * S + s) * kThreads + tid] = h[s];
      }
    }
    // walk the chunk back
    for (int i = nt - 1; i >= 0; --i) {
      const int t = t0 + i;
      const int64_t r = (seq + t) * p.Di + dc;
      const float dtv = p.dt[r], xv = p.x[r], dyv = live ? p.dy[r] : 0.f;
      float bb[S], cc[S];
      load8(p.bt + (seq + t) * N + j * S, bb);
      load8(p.ct + (seq + t) * N + j * S, cc);
      float* rb = red + buf * (2 * CH * N);
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const float h_t = hs[(i * S + s) * kThreads + tid];
        const float h_prev =
            i > 0 ? hs[((i - 1) * S + s) * kThreads + tid] : h_start[s];
        const float av = ex2(dtv * a2[s]);
        g[s] = fmaf(cc[s], dyv, g[s]);
        rb[c * N + j * S + s] = live ? g[s] * dtv * xv : 0.f;       // dB
        rb[(CH + c) * N + j * S + s] = live ? dyv * h_t : 0.f;      // dC
        s1 = fmaf(g[s], bb[s], s1);
        const float gah = g[s] * av * h_prev;
        s2 = fmaf(gah, A[s], s2);
        da_acc[s] = fmaf(gah, dtv, da_acc[s]);
        g[s] *= av;
      }
#pragma unroll
      for (int o = L / 2; o >= 1; o /= 2) {
        s1 += __shfl_xor_sync(0xffffffffu, s1, o);
        s2 += __shfl_xor_sync(0xffffffffu, s2, o);
      }
      if (live && j == 0) {
        p.dx[r] = dtv * s1;
        p.ddt[r] = s2 + xv * s1;
      }
      __syncthreads();            // this step's terms in place
      {
        const int out = tid / TPO, part = tid % TPO;   // out: q * N + n
        const int q = out / N, n = out % N;
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < PER; ++k)
          acc += rb[(q * CH + part * PER + k) * N + n];
#pragma unroll
        for (int o = TPO / 2; o >= 1; o /= 2)
          acc += __shfl_xor_sync(0xffffffffu, acc, o);
        if (part == 0)
          p.part_bc[((static_cast<int64_t>(blockIdx.x) * p.B + b) * p.T + t) *
                        (2 * N) + out] = acc;
      }
      // the other buffer next step: the one read here is written again
      // only after every thread has passed the next step's barrier
      buf ^= 1;
    }
  }
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

template <int N>
int launch(const BwdArgs& p, float* dbc, float* da, cudaStream_t stream) {
  constexpr int L = N / kStates, CH = kThreads / L;
  constexpr size_t smem =
      sizeof(float) * (kChunk * kStates * kThreads + 2 * 2 * CH * N);
  static bool attr_set = false;       // once per instantiation
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        mamba1_scan_bwd_kernel<N>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const int blocks = (p.Di + CH - 1) / CH;
  mamba1_scan_bwd_kernel<N><<<dim3(blocks, p.B), kThreads, smem, stream>>>(p);
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

// N (d_state) in {8, 16, 32, 64}; h0 and dh_last may be null.  dbc
// [B, T, 2N] gets dB_t then dC_t per step, da [Di, N] gets dA.
int msb_launch(const void* x, const void* dt, const void* bt, const void* ct,
               const void* a, const void* dy, const void* h0,
               const void* dh_last, void* dx, void* ddt, void* ckpt,
               void* part_bc, void* part_a, void* dh0, void* dbc, void* da,
               int B, int T, int Di, int N, void* stream) {
  const BwdArgs p{
      static_cast<const float*>(x),  static_cast<const float*>(dt),
      static_cast<const float*>(bt), static_cast<const float*>(ct),
      static_cast<const float*>(a),  static_cast<const float*>(dy),
      static_cast<const float*>(h0), static_cast<const float*>(dh_last),
      static_cast<float*>(dx),       static_cast<float*>(ddt),
      static_cast<float*>(ckpt),     static_cast<float*>(part_bc),
      static_cast<float*>(part_a),   static_cast<float*>(dh0),
      B, T, Di, (T + kChunk - 1) / kChunk};
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
