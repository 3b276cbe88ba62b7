// Nearest-centroid search shared by the assignment kernel (distance.cu) and
// the fused masked Lloyd step (fused.cu).
//
// Both kernels call the same inlined code, so they compute the same score
// ||c_j||^2 - 2 x_i.c_j with the same fp32 operations in the same order
// (feature order, __fmul_rn/__fadd_rn, no fused multiply-add) and pick the
// same argmin (strict <: the first minimum wins).  The fused step's
// assignment is therefore bit-identical to assign_clusters on the card.
//
// Centroids are staged through shared memory in tiles of kTileK with their
// squared norms; a warp reads one centroid value at a time (broadcast).  x is
// read kChunkD features at a time into registers, and kTileK accumulators
// stay in registers across the feature chunks.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace repro_assign {

constexpr int kTileK = 32;  // centroids per shared-memory tile
constexpr int kChunkD = 8;  // features of x held in registers at a time

// Shared memory the search needs for feature width d (floats).
__host__ __device__ inline size_t search_smem_floats(int d) {
  return (size_t)kTileK * d + kTileK;
}

// (min score, argmin) of point xi over all k centroids.  Every thread of the
// block must call it with the same k and d: it synchronises the block while
// staging centroid tiles into cs ([kTileK * d]) and cn ([kTileK]).
__device__ __forceinline__ void nearest_centroid(
    const float* __restrict__ xi, const float* __restrict__ c, int k, int d,
    float* cs, float* cn, float& best_out, int& best_j_out) {
  float best = INFINITY;
  int best_j = 0;
  for (int j0 = 0; j0 < k; j0 += kTileK) {
    const int kt = min(kTileK, k - j0);
    __syncthreads();  // the previous tile has been read by every thread
    for (int e = threadIdx.x; e < kt * d; e += blockDim.x) {
      cs[e] = c[(size_t)j0 * d + e];
    }
    __syncthreads();
    if (threadIdx.x < kt) {
      const float* cj = cs + threadIdx.x * d;
      float s = 0.f;
      for (int f = 0; f < d; ++f) s = __fadd_rn(s, __fmul_rn(cj[f], cj[f]));
      cn[threadIdx.x] = s;
    }
    __syncthreads();

    float acc[kTileK];
#pragma unroll
    for (int j = 0; j < kTileK; ++j) acc[j] = 0.f;
    for (int f0 = 0; f0 < d; f0 += kChunkD) {
      float xr[kChunkD];
#pragma unroll
      for (int u = 0; u < kChunkD; ++u) {
        xr[u] = (f0 + u < d) ? __ldg(xi + f0 + u) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kTileK; ++j) {
        if (j < kt) {
          const float* cj = cs + j * d + f0;
#pragma unroll
          for (int u = 0; u < kChunkD; ++u) {
            if (f0 + u < d) acc[j] = __fadd_rn(acc[j], __fmul_rn(xr[u], cj[u]));
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kTileK; ++j) {
      if (j < kt) {
        const float score = __fsub_rn(cn[j], __fmul_rn(2.f, acc[j]));
        if (score < best) {  // strict: the first minimum wins
          best = score;
          best_j = j0 + j;
        }
      }
    }
  }
  best_out = best;
  best_j_out = best_j;
}

}  // namespace repro_assign
