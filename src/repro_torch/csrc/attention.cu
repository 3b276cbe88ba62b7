// Causal (or full) flash-attention forward on Hopper (sm_90a).
//
// Replaces the TPU kernel in src/repro/kernels/attention/attention.py:
// _flash_kernel (:42; flash_attention_kernel :97, pallas_call :129), which
// the reference's wrapper (attention/ops.py) feeds after repeating the KV
// heads, transposing to (B*H, S, D) and padding S to the block size.
//
// What it computes, for batch b, query head h and query row i:
//   s_j = (q_i * scale) . k_j            fp32, scale = 1/sqrt(D) applied to q
//   s_j = -1e30 for j >= Sk and, when causal, for j > i
//   running max m, normaliser l and fp32 accumulator acc (online softmax)
//   o_i = acc / max(l, 1e-30), cast to q's dtype
// reading KV head h / (H / KV): grouped-query attention without repeating K
// and V.  q, k, v and o are read and written in their (B, S, heads, D)
// layout through strides: no transpose, no pad.
//
// What bounds it on an H100: the two products, 2 * 2 * D operations per live
// (query, key) pair (B * H * S * (S + 1) / 2 pairs when causal) against
// 4 * B * S * H * D elements moved once.  At the serving shape (OLMo-1B
// prefill, B 4, S 4096, H 16, D 128, bf16) that is 2.75e11 operations for
// 0.27 GB: operation-bound, 0.28 ms at the bf16 tensor-core peak, 4.1 ms at
// the fp32 CUDA-core peak.  This first kernel computes in fp32 on the CUDA
// cores (no tensor cores, no wgmma or TMA: a later change), so the fp32 time
// is its ceiling.
//
// Design (simple and right first):
// - One block of 8 warps owns 32 query rows of one (b, h); each warp owns 4
//   rows.  The block's queries are staged once, scaled, in shared memory.
// - The block walks key tiles of 32 keys in order (the Pallas grid's
//   sequential axis), staging each K and V tile in shared memory as fp32.
//   With causal masking the walk stops at the block's last row: tiles above
//   the diagonal are never loaded.
// - Scores: lane j scores key j of the tile against the warp's 4 rows, one
//   float4 of K (row stride padded by 4 floats, so a quarter-warp's float4
//   loads hit distinct banks) feeding 16 multiply-adds.
// - Softmax: one warp max and one warp sum per row and tile (xor butterfly:
//   every lane ends with the same bits).
// - Values: lane c owns dims c, c + 32, ...; each key's weight is broadcast
//   with a shuffle and multiplied into the lane's accumulators.
// - Every sum runs in a fixed order and there are no atomics, so two
//   launches on the same inputs give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kBlockQ = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kBlockK = 32;                     // keys per tile, one per lane
constexpr int kThreads = kWarps * 32;
constexpr int kMaxChunks = 8;                   // D <= 32 * 8 = 256
constexpr float kMasked = -1e30f;

struct Strides {  // element strides of a (B, S, heads, D) tensor; D's is 1
  long long b, s, h;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's cast
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Shared-memory layout, in floats: Q [kBlockQ][qstr], K [kBlockK][qstr + 4],
// V [kBlockK][d], with qstr = d rounded up to 4 (zero-filled past d).
__host__ __device__ inline int q_stride(int d) { return (d + 3) & ~3; }
__host__ __device__ inline size_t smem_floats(int d) {
  const int qs = q_stride(d);
  return (size_t)kBlockQ * qs + (size_t)kBlockK * (qs + 4) +
         (size_t)kBlockK * d;
}

// DC: 32-dim chunks of the output each lane holds, ceil(d / 32).
template <typename T, int DC>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int H, int group,
                 int Sq, int Sk, int d, Strides sq, Strides sk, Strides sv,
                 Strides so, float scale, int causal) {
  extern __shared__ __align__(16) float smem[];
  const int qstr = q_stride(d);
  const int kstr = qstr + 4;
  float* qsm = smem;
  float* ksm = qsm + kBlockQ * qstr;
  float* vsm = ksm + kBlockK * kstr;

  const int b = blockIdx.y / H, h = blockIdx.y % H, hk = h / group;
  // the longest causal rows first: blocks are dispatched in index order
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + hk * sk.h;
  const T* vb = v + b * sv.b + hk * sv.h;

  for (int idx = tid; idx < kBlockQ * qstr; idx += kThreads) {
    const int r = idx / qstr, c = idx - r * qstr;
    float x = 0.f;
    if (q0 + r < Sq && c < d) x = to_f32(qb[(q0 + r) * sq.s + c]) * scale;
    qsm[idx] = x;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DC];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kMasked;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.f;
  }

  const int row0 = q0 + warp * kRowsPerWarp;  // the warp's first query row
  const int k_end = causal ? min(Sk, q0 + kBlockQ) : Sk;
  const float4* qrow = reinterpret_cast<const float4*>(qsm + warp *
                                                       kRowsPerWarp * qstr);
  const int n4 = qstr >> 2;

  for (int k0 = 0; k0 < k_end; k0 += kBlockK) {
    __syncthreads();  // Q is staged; the previous tile's readers are done
    for (int idx = tid; idx < kBlockK * qstr; idx += kThreads) {
      const int j = idx / qstr, c = idx - j * qstr;
      const bool key = k0 + j < Sk;
      float kx = 0.f, vx = 0.f;
      if (key && c < d) {
        kx = to_f32(kb[(k0 + j) * sk.s + c]);
        vx = to_f32(vb[(k0 + j) * sv.s + c]);
      }
      ksm[j * kstr + c] = kx;
      if (c < d) vsm[j * d + c] = vx;
    }
    __syncthreads();

    // scores: lane j against key k0 + j
    float s[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.f;
    const float4* krow = reinterpret_cast<const float4*>(ksm + lane * kstr);
#pragma unroll 4
    for (int c = 0; c < n4; ++c) {
      const float4 kv = krow[c];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 qv = qrow[r * n4 + c];
        s[r] = fmaf(qv.x, kv.x, s[r]);
        s[r] = fmaf(qv.y, kv.y, s[r]);
        s[r] = fmaf(qv.z, kv.z, s[r]);
        s[r] = fmaf(qv.w, kv.w, s[r]);
      }
    }

    // online softmax; s[r] becomes the key's weight p
    const int key = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const bool live = key < Sk && (!causal || key <= row0 + r);
      const float sr = live ? s[r] : kMasked;
      const float m_new = fmaxf(m[r], warp_max(sr));
      const float p = live ? expf(sr - m_new) : 0.f;
      const float alpha = expf(m[r] - m_new);
      l[r] = alpha * l[r] + warp_sum(p);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[r][c] *= alpha;
      s[r] = p;
    }

    // values: keys past Sk, or (causal) past the warp's last row, weigh 0
    int n_keys = min(kBlockK, Sk - k0);
    if (causal) n_keys = min(n_keys, row0 + kRowsPerWarp - k0);
    for (int j = 0; j < n_keys; ++j) {
      float p[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
        p[r] = __shfl_sync(0xffffffffu, s[r], j);
      const float* vrow = vsm + j * d;
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int dim = lane + 32 * c;
        const float vv = dim < d ? vrow[dim] : 0.f;
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r)
          acc[r][c] = fmaf(p[r], vv, acc[r][c]);
      }
    }
  }

  T* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = row0 + r;
    if (row >= Sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int dim = lane + 32 * c;
      if (dim < d) store(ob + row * so.s + dim, acc[r][c] / denom);
    }
  }
}

template <typename T, int DC>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int KV, int Sq, int Sk, int d, Strides sq, Strides sk, Strides sv,
           Strides so, float scale, int causal, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, DC>;
  const size_t smem = smem_floats(d) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, H, H / KV, Sq, Sk, d, sq,
      sk, sv, so, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int H, int KV, int Sq, int Sk, int d, Strides sq, Strides sk,
             Strides sv, Strides so, float scale, int causal,
             cudaStream_t stream) {
  switch ((d + 31) / 32) {
#define CASE(DC)                                                             \
  case DC:                                                                   \
    return launch<T, DC>(q, k, v, o, B, H, KV, Sq, Sk, d, sq, sk, sv, so,    \
                         scale, causal, stream);
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B, Sq, H, D), k and v (B, Sk, KV, D), o (B, Sq, H, D), all on the
// current device with unit stride along D; the other strides are in
// elements.  dtype: 0 float32, 1 bfloat16 (all four tensors alike).
// 1 <= D <= 256, H % KV == 0, B * H <= 65535.  Launches on `stream` and
// returns the CUDA error code of the launch (0 on success); does not
// synchronise.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int dtype, int B, int H, int KV, int Sq, int Sk, int d,
                        long long q_sb, long long q_ss, long long q_sh,
                        long long k_sb, long long k_ss, long long k_sh,
                        long long v_sb, long long v_ss, long long v_sh,
                        long long o_sb, long long o_ss, long long o_sh,
                        float scale, int causal, void* stream) {
  if (d < 1 || d > 32 * kMaxChunks || KV < 1 || H % KV != 0 ||
      B * H > 65535 || Sq < 1 || Sk < 1)
    return (int)cudaErrorInvalidValue;
  const Strides sq{q_sb, q_ss, q_sh}, sk{k_sb, k_ss, k_sh},
      sv{v_sb, v_ss, v_sh}, so{o_sb, o_ss, o_sh};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, B, H, KV, Sq, Sk, d, sq, sk, sv, so,
                           scale, causal, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, B, H, KV, Sq, Sk, d, sq, sk,
                                   sv, so, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
