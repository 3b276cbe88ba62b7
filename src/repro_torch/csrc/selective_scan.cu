// The Mamba mixer's selective scan on Hopper (sm_90a): the prefill's
// recurrence and its C-contraction in one pass over the sequence.
//
// Replaces no TPU kernel: the reference computes this step with
// jax.lax.associative_scan over chunks (src/repro/models/mamba.py:107,
// _scan_chunk), and the port's plain path is a doubling scan over
// (B, chunk, d_inner, d_state) tensors in device memory
// (models/mamba.py:_scan_chunk).  This kernel keeps the states in registers.
//
// What it computes, for batch b, channel i and token t (float32 throughout):
//   dx     = dt[t, i] * x[t, i]                   x the conv output, widened
//   a_s    = exp(dt[t, i] * A[i, s])              A = -exp(a_log), s < st
//   h_s    = a_s * h_s + dx * B[t, s]             h_s = 0 before token 0
//   y[t,i] = sum_s h_s * C[t, s] + D[i] * x[t, i]
// and the states at the last token, h_last[b, i, s], the decode state.
// The inputs are _ssm_inputs' (models/mamba.py), in its rounding order for
// dx and a_s; the kernel contracts multiply-adds where the plain version
// rounds twice (kernels/ssm/ref.py:selective_scan_ref models the order).
//
// What bounds it on an H100: at the jamba2-mini cell's shape (B 2, L 4,096,
// d_inner 8,192, d_state 16) it reads x (bf16) and dt (f32) once, 0.40 GB,
// and writes y (f32), 0.27 GB: 0.20 ms at 3.35 TB/s.  The 1.07e9
// exponentials take 0.26 ms on the SFUs (16 a clock an SM, 132 SMs,
// 1.98 GHz), and each state costs ~12 fp32 instructions besides, ~0.4 ms
// of instruction slots: the arithmetic bounds it, not the bytes.
//
// Design:
// - Four lanes share a channel, each keeping ns = ceil(st / 4) <= 4 of its
//   states in registers (a template); a warp holds 8 channels, a block of
//   128 threads 32 channels of one batch row.  The grid is
//   (ceil(d_inner / 32), B): 512 blocks at the cell's shape, ~4 an SM,
//   all resident at once.
// - The block walks the sequence in tiles of kTile tokens through two
//   shared-memory stages: while it computes one tile, each thread holds
//   its share of the next tile's loads in registers (coalesced: a warp
//   reads 32 channels of a token row, or two tokens' B or C), and stores
//   them to the other stage after the tile; one barrier a tile.  The
//   loads' latency hides behind kTile tokens of arithmetic.  B[t] and
//   C[t], the same for every channel of the batch row, are read from
//   device memory once a block, and from shared memory as float4 where a
//   lane keeps four states.
// - The sum over states: each lane adds its states in order, then the four
//   lanes add by a fixed xor tree ((q0 + q1) + (q2 + q3)), and lane 0 adds
//   D x and writes y.  No atomics and no data-dependent order, so two
//   launches on the same inputs give the same bits.
// - Nothing of shape (..., d_inner, d_state) is written: y and the last
//   states are the only outputs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 4;                       // lanes sharing a channel
constexpr int kThreads = 128;
constexpr int kChannels = kThreads / kLanes;    // channels a block
constexpr int kMaxStates = 16;                  // d_state at most
constexpr int kTile = 8;                        // tokens a stage
// loads a thread makes a tile: (x, dt) pairs, and B and C values
constexpr int kRowLoads = kTile * kChannels / kThreads;
constexpr int kStateLoads = kTile * kMaxStates / kThreads;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kTile * kChannels % kThreads == 0, "whole row loads");
static_assert(kTile * kMaxStates % kThreads == 0, "whole state loads");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

struct __align__(16) Stage {
  float2 xd[kTile][kChannels];   // (x, dt) of each token and channel
  float b[kTile][kMaxStates];    // B, zero past st
  float c[kTile][kMaxStates];    // C, zero past st
};

// One thread's share of a tile's loads, in flight in registers.
struct Loads {
  float x[kRowLoads], dt[kRowLoads], b[kStateLoads], c[kStateLoads];
};

template <typename T>
__device__ __forceinline__ void load_tile(
    Loads& r, const T* __restrict__ xc, const float* __restrict__ dt,
    const float* __restrict__ bm, const float* __restrict__ cm,
    long long row, int t0, int L, int di, int st, int ch0) {
#pragma unroll
  for (int k = 0; k < kRowLoads; ++k) {
    const int e = threadIdx.x + k * kThreads;
    const int t = t0 + e / kChannels, ch = ch0 + e % kChannels;
    const bool on = t < L && ch < di;
    const long long i = (row + t) * di + ch;
    r.x[k] = on ? to_f32(xc[i]) : 0.f;
    r.dt[k] = on ? dt[i] : 0.f;
  }
#pragma unroll
  for (int k = 0; k < kStateLoads; ++k) {
    const int e = threadIdx.x + k * kThreads;
    const int t = t0 + e / kMaxStates, s = e % kMaxStates;
    const bool on = t < L && s < st;
    const long long i = (row + t) * st + s;
    r.b[k] = on ? bm[i] : 0.f;
    r.c[k] = on ? cm[i] : 0.f;
  }
}

__device__ __forceinline__ void store_tile(Stage& g, const Loads& r) {
#pragma unroll
  for (int k = 0; k < kRowLoads; ++k) {
    const int e = threadIdx.x + k * kThreads;
    g.xd[e / kChannels][e % kChannels] = make_float2(r.x[k], r.dt[k]);
  }
#pragma unroll
  for (int k = 0; k < kStateLoads; ++k) {
    const int e = threadIdx.x + k * kThreads;
    g.b[e / kMaxStates][e % kMaxStates] = r.b[k];
    g.c[e / kMaxStates][e % kMaxStates] = r.c[k];
  }
}

// One token of one lane: the states' update and y's sum.
template <int NS>
__device__ __forceinline__ void token(const Stage& g, int u, int cl, int s0,
                                      const float (&am)[NS], float (&h)[NS],
                                      float dv, bool write,
                                      float* __restrict__ yt) {
  const float2 xd = g.xd[u][cl];
  float b[NS], c[NS];
  if constexpr (NS == 4) {
    const float4 b4 = *reinterpret_cast<const float4*>(&g.b[u][s0]);
    const float4 c4 = *reinterpret_cast<const float4*>(&g.c[u][s0]);
    b[0] = b4.x; b[1] = b4.y; b[2] = b4.z; b[3] = b4.w;
    c[0] = c4.x; c[1] = c4.y; c[2] = c4.z; c[3] = c4.w;
  } else {
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      b[j] = g.b[u][s0 + j];
      c[j] = g.c[u][s0 + j];
    }
  }
  const float dx = xd.y * xd.x;
  float q = 0.f;
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const float at = expf(xd.y * am[j]);
    h[j] = at * h[j] + dx * b[j];
    q = j == 0 ? h[j] * c[j] : q + h[j] * c[j];
  }
  q += __shfl_xor_sync(kFull, q, 1);
  q += __shfl_xor_sync(kFull, q, 2);
  if (write) *yt = q + dv * xd.x;
}

template <typename T, int NS>
__global__ void __launch_bounds__(kThreads)
selective_scan_kernel(const T* __restrict__ xc, const float* __restrict__ dt,
                      const float* __restrict__ bm,
                      const float* __restrict__ cm,
                      const float* __restrict__ a,
                      const float* __restrict__ dskip, int L, int di, int st,
                      float* __restrict__ y, float* __restrict__ h_last) {
  __shared__ Stage stage[2];
  const int lane4 = threadIdx.x % kLanes;
  const int cl = threadIdx.x / kLanes;
  const int ch0 = blockIdx.x * kChannels;
  const int ch = ch0 + cl;
  const bool live = ch < di;  // out-of-range lanes still shuffle
  const bool write = live && lane4 == 0;
  const int s0 = lane4 * NS;
  const long long row = (long long)blockIdx.y * L;

  float am[NS], h[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    am[j] = live && s0 + j < st ? a[(long long)ch * st + s0 + j] : 0.f;
    h[j] = 0.f;
  }
  const float dv = live ? dskip[ch] : 0.f;
  float* yc = y + row * di + ch;

  Loads r;
  load_tile(r, xc, dt, bm, cm, row, 0, L, di, st, ch0);
  store_tile(stage[0], r);
  __syncthreads();
  for (int t0 = 0, buf = 0; t0 < L; t0 += kTile, buf ^= 1) {
    const bool more = t0 + kTile < L;
    if (more) load_tile(r, xc, dt, bm, cm, row, t0 + kTile, L, di, st, ch0);
    const Stage& g = stage[buf];
    if (more) {
#pragma unroll
      for (int u = 0; u < kTile; ++u) {
        token<NS>(g, u, cl, s0, am, h, dv, write,
                  yc + (long long)(t0 + u) * di);
      }
    } else {
      for (int u = 0; u < L - t0; ++u) {
        token<NS>(g, u, cl, s0, am, h, dv, write,
                  yc + (long long)(t0 + u) * di);
      }
    }
    // the other stage was last read before the previous barrier
    if (more) store_tile(stage[buf ^ 1], r);
    __syncthreads();
  }
  if (live) {
    float* out = h_last + ((long long)blockIdx.y * di + ch) * st;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      if (s0 + j < st) out[s0 + j] = h[j];
    }
  }
}

template <typename T>
int launch(const void* xc, const void* dt, const void* bm, const void* cm,
           const void* a, const void* dskip, int B, int L, int di, int st,
           void* y, void* h_last, cudaStream_t s) {
  const dim3 grid((di + kChannels - 1) / kChannels, B);
  const int ns = (st + kLanes - 1) / kLanes;
#define SCAN_CASE(NS)                                                       \
  case NS:                                                                  \
    selective_scan_kernel<T, NS><<<grid, kThreads, 0, s>>>(                 \
        (const T*)xc, (const float*)dt, (const float*)bm, (const float*)cm, \
        (const float*)a, (const float*)dskip, L, di, st, (float*)y,         \
        (float*)h_last);                                                    \
    break;
  switch (ns) {
    SCAN_CASE(1) SCAN_CASE(2) SCAN_CASE(3) SCAN_CASE(4)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SCAN_CASE
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// xc (B, L, di) in the model's dtype (0 float32, 1 bfloat16); dt (B, L, di),
// bm and cm (B, L, st), a (di, st) and dskip (di,) float32; all contiguous
// on the current device.  B >= 1, L >= 1, di >= 1, 1 <= st <= 16,
// B <= 65535.  Writes y (B, L, di) and h_last (B, di, st) float32 on
// `stream`.  Returns 0 or an error code for kernel_error_string; does not
// synchronise.
int selective_scan(const void* xc, int dtype, const void* dt, const void* bm,
                   const void* cm, const void* a, const void* dskip, int B,
                   int L, int di, int st, void* y, void* h_last,
                   void* stream) {
  if (B < 1 || B > 65535 || L < 1 || di < 1 || st < 1 || st > kMaxStates) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    return launch<float>(xc, dt, bm, cm, a, dskip, B, L, di, st, y, h_last,
                         s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(xc, dt, bm, cm, a, dskip, B, L, di, st, y,
                                 h_last, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The scan's form: out = [threads a block, lanes a channel, most states],
// for the wrapper to hold its plain model and routing to.
void selective_scan_form(int* out) {
  out[0] = kThreads;
  out[1] = kLanes;
  out[2] = kMaxStates;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
