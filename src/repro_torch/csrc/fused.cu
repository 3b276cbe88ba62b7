// Fused masked Lloyd step on Hopper (sm_90a): assignment plus the masked
// per-centroid sums, counts and inertia the centroid update needs.
//
// Replaces the TPU kernel _fused_step_kernel
// (src/repro/kernels/distance/fused.py:42, launched by fused_step_kernel at
// :101, pallas_call at :125, wrapper fused_masked_assign_update at :151).
//
// What it computes, for points x (n, d), centroids c (k, d), mask (n,):
// - idx[i]: the nearest centroid of every point (masked rows included), by
//   the score ||c_j||^2 - 2 x_i.c_j, first minimum on ties;
// - sums[j, :] = sum of x_i over unmasked i with idx[i] = j, counts[j] the
//   number of such i, inertia = sum over unmasked i of
//   max(min(score_i, 3.4e38) + ||x_i||^2, 0).
//
// What bounds it on an H100: 2*n*k*d fp32 operations for the scores against
// n*d*4 + 5n bytes (x and the mask read once, idx written once).  At the
// service's shape (n = 2^20, d = 32, k = 64) it is bound by the fp32 CUDA
// cores, like the assignment kernel.  Tensor cores are out for the same
// reason: TF32 would move argmins.
//
// Design:
// - Pass 1: each block owns a contiguous chunk of points (tiles_per_block
//   tiles of 128), one thread per point of the current tile.  The search is
//   the inlined code of assign_common.cuh, so idx equals assign_clusters bit
//   for bit.  The block then folds its tile into per-block accumulators in
//   shared memory in a FIXED order: thread f owns feature f and walks the
//   tile's points in index order, so each sum has one writer and one order.
//   Thread 0 sums the tile's inertia terms in index order.
// - Centroid tiles are staged through shared memory (any k works); the
//   accumulators cover acc_k centroids at a time, and a block whose k does
//   not fit walks its chunk again for each further range, reading back the
//   idx it wrote in the first range.
// - Each block writes its partial [sums (k*d) | counts (k) | inertia] to its
//   own slice of a partials buffer: no float atomics anywhere.
// - Pass 2 reduces the partials over blocks in block order, one thread per
//   output element.  The same inputs give the same launch shape and so
//   bitwise-identical sums on every run.  The second pass exists because
//   Hopper's blocks run in parallel: the Pallas kernel carried the sums in
//   one VMEM block across a sequential grid axis.
// - Masked rows are assigned but skipped by the accumulation; counts are
//   fp32 (as in the reference) and exact up to 2^24 rows, which the wrapper
//   enforces.

#include <cuda_runtime.h>
#include <math.h>

#include "assign_common.cuh"

namespace {

using repro_assign::kTileK;

constexpr int kThreads = 128;        // points per tile, one per thread
constexpr float kBig = 3.4e38f;      // the reference's score clamp
constexpr int kReduceThreads = 256;

__global__ void __launch_bounds__(kThreads)
fused_partials_kernel(const float* __restrict__ x, const float* __restrict__ c,
                      const unsigned char* __restrict__ mask, int n, int k,
                      int d, int tiles_per_block, int acc_k,
                      int* __restrict__ idx_out, float* __restrict__ part) {
  extern __shared__ float smem[];
  float* cs = smem;                             // [kTileK * d] centroid tile
  float* cn = cs + kTileK * d;                  // [kTileK] its squared norms
  float* acc = cn + kTileK;                     // [acc_k * d] sums
  float* cnt = acc + (size_t)acc_k * d;         // [acc_k] counts
  float* wd2 = cnt + acc_k;                     // [kThreads] inertia terms
  int* idx_s = reinterpret_cast<int*>(wd2 + kThreads);        // [kThreads]
  unsigned char* w_s =
      reinterpret_cast<unsigned char*>(idx_s + kThreads);     // [kThreads]

  const int tid = threadIdx.x;
  const size_t stride = (size_t)k * d + k + 1;
  float* mine = part + (size_t)blockIdx.x * stride;
  const int p_begin = blockIdx.x * tiles_per_block * kThreads;
  const int p_end = min(n, p_begin + tiles_per_block * kThreads);
  float inertia = 0.f;  // thread 0's running sum, in point order

  for (int j0 = 0; j0 < k; j0 += acc_k) {
    const int ka = min(acc_k, k - j0);
    for (int e = tid; e < ka * d; e += kThreads) acc[e] = 0.f;
    for (int e = tid; e < ka; e += kThreads) cnt[e] = 0.f;
    // the first __syncthreads below orders these stores before any update
    for (int t0 = p_begin; t0 < p_end; t0 += kThreads) {
      const int i = t0 + tid;
      const bool live = i < p_end;
      int j;
      if (j0 == 0) {
        const float* xi = x + (size_t)(live ? i : 0) * d;
        float best;
        repro_assign::nearest_centroid(xi, c, k, d, cs, cn, best, j);
        float xn = 0.f;
        for (int f = 0; f < d; ++f) {
          const float v = __ldg(xi + f);
          xn = __fadd_rn(xn, __fmul_rn(v, v));
        }
        const float d2 = fmaxf(__fadd_rn(fminf(best, kBig), xn), 0.f);
        const bool w = live && mask[i] != 0;
        if (live) idx_out[i] = j;
        wd2[tid] = w ? d2 : 0.f;
        w_s[tid] = w ? 1 : 0;
      } else {
        // written by this same thread in the first range
        j = live ? idx_out[i] : 0;
        w_s[tid] = (live && mask[i] != 0) ? 1 : 0;
      }
      idx_s[tid] = j;
      __syncthreads();
      const int tl = min(kThreads, p_end - t0);
      if (j0 == 0 && tid == 0) {
        for (int p = 0; p < tl; ++p) inertia = __fadd_rn(inertia, wd2[p]);
      }
      for (int f = tid; f < d; f += kThreads) {
        const float* xt = x + (size_t)t0 * d + f;
        for (int p = 0; p < tl; ++p) {
          const int jj = idx_s[p] - j0;
          if (w_s[p] && jj >= 0 && jj < ka) {
            acc[jj * d + f] = __fadd_rn(acc[jj * d + f], xt[(size_t)p * d]);
            if (f == 0) cnt[jj] = __fadd_rn(cnt[jj], 1.f);
          }
        }
      }
      __syncthreads();  // the tile's idx_s / w_s are read before reuse
    }
    for (int e = tid; e < ka * d; e += kThreads) {
      mine[(size_t)j0 * d + e] = acc[e];
    }
    for (int e = tid; e < ka; e += kThreads) {
      mine[(size_t)k * d + j0 + e] = cnt[e];
    }
    __syncthreads();  // acc / cnt are written out before the next range
  }
  if (tid == 0) mine[(size_t)k * d + k] = inertia;
}

// out[e] = sum over blocks b, in order, of part[b * stride + e].
__global__ void __launch_bounds__(kReduceThreads)
reduce_partials_kernel(const float* __restrict__ part, int blocks,
                       int stride, float* __restrict__ out) {
  const int e = blockIdx.x * kReduceThreads + threadIdx.x;
  if (e >= stride) return;
  float s = 0.f;
  for (int b = 0; b < blocks; ++b) {
    s = __fadd_rn(s, part[(size_t)b * stride + e]);
  }
  out[e] = s;
}

}  // namespace

extern "C" {

// Shared memory one pass-1 block needs for width d and acc_k centroids.
size_t fused_smem_bytes(int d, int acc_k) {
  return (repro_assign::search_smem_floats(d) + (size_t)acc_k * d + acc_k +
          kThreads) * sizeof(float) +
         kThreads * sizeof(int) + kThreads;
}

// x: (n, d) f32, c: (k, d) f32, mask: (n,) bool, all contiguous on the
// current device; n >= 1.  part: blocks * (k*d + k + 1) f32 scratch, where
// blocks = ceil(ceil(n / 128) / tiles_per_block).  Writes idx (n,) i32 and
// out = [sums (k*d) | counts (k) | inertia (1)] f32 on `stream`.  Returns
// the CUDA error code of the launches (0 on success); does not synchronise.
int fused_masked_assign_update(const void* x, const void* c, const void* mask,
                               int n, int k, int d, int tiles_per_block,
                               int acc_k, void* idx, void* part, void* out,
                               void* stream) {
  const size_t smem = fused_smem_bytes(d, acc_k);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fused_partials_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int tiles = (n + kThreads - 1) / kThreads;
  const int blocks = (tiles + tiles_per_block - 1) / tiles_per_block;
  cudaStream_t s = (cudaStream_t)stream;
  fused_partials_kernel<<<blocks, kThreads, smem, s>>>(
      (const float*)x, (const float*)c, (const unsigned char*)mask, n, k, d,
      tiles_per_block, acc_k, (int*)idx, (float*)part);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int stride = k * d + k + 1;
  const unsigned rblocks = (unsigned)((stride + kReduceThreads - 1) /
                                      kReduceThreads);
  reduce_partials_kernel<<<rblocks, kReduceThreads, 0, s>>>(
      (const float*)part, blocks, stride, (float*)out);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
