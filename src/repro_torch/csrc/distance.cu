// K-Means assignment on Hopper (sm_90a): nearest centroid for every point.
//
// Replaces the TPU kernel _assign_kernel
// (src/repro/kernels/distance/distance.py:46, launched by
// assign_clusters_kernel at :92, pallas_call at :114).
//
// What it computes: for each point x_i the index of the centroid with the
// smallest score ||c_j||^2 - 2 x_i.c_j (||x_i||^2 is constant per point and
// is left out; the Python wrapper adds it back and clamps at 0), and that
// score.  Ties go to the first centroid: a later centroid replaces the
// running best only if it scores strictly less.
//
// What bounds it on an H100: 2*n*k*d FLOPs of fp32 against n*d*4 bytes of
// x read once.  At the main path's shape (n = 2^20, d = 32, k = 64) that is
// 4.3 GFLOP against 134 MB, so it is bound by the fp32 CUDA cores, not by
// memory.  Tensor cores are out: TF32 keeps ~3 decimal digits and would move
// argmins away from the reference.
//
// Design:
// - One thread owns one point and keeps a running (min, argmin) in
//   registers; the result is written to device memory once.
// - The search itself (centroid tiles staged in shared memory, x read a few
//   features at a time into registers, feature-order sums) lives in
//   assign_common.cuh, shared with the fused Lloyd step in fused.cu.
// - Every product and sum is rounded on its own (__fmul_rn/__fadd_rn, no
//   fused multiply-add), so the kernel is bit-identical to the plain
//   PyTorch version in kernels/distance/ref.py, which does the same
//   element-wise operations in the same order.  That costs up to half the
//   fp32 peak; it buys exact agreement on every argmin.
// - The Pallas kernel's padding (centroid rows of 1e19, d padded to 128)
//   only fed the TPU's tiles; here the loops stop at k and d.

#include <cuda_runtime.h>
#include <math.h>

#include "assign_common.cuh"

namespace {

using repro_assign::kTileK;

constexpr int kThreads = 128;  // points per block, one per thread

__global__ void __launch_bounds__(kThreads)
assign_kernel(const float* __restrict__ x, const float* __restrict__ c,
              int n, int k, int d, int* __restrict__ idx_out,
              float* __restrict__ score_out) {
  extern __shared__ float smem[];
  float* cs = smem;                // [kTileK * d] centroid tile
  float* cn = smem + kTileK * d;   // [kTileK] squared norms of the tile
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < n;
  const float* xi = x + (size_t)(live ? i : 0) * d;

  float best;
  int best_j;
  repro_assign::nearest_centroid(xi, c, k, d, cs, cn, best, best_j);
  if (live) {
    idx_out[i] = best_j;
    score_out[i] = best;
  }
}

}  // namespace

extern "C" {

// Shared memory one block needs for feature width d.
size_t assign_smem_bytes(int d) {
  return repro_assign::search_smem_floats(d) * sizeof(float);
}

// x: (n, d) f32, c: (k, d) f32, both contiguous on the current device.
// Writes idx (n,) i32 and score (n,) f32 on `stream`.  Returns the CUDA
// error code of the launch (0 on success); does not synchronise.
int assign_clusters(const void* x, const void* c, int n, int k, int d,
                    void* idx, void* score, void* stream) {
  const size_t smem = assign_smem_bytes(d);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        assign_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  assign_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)c, n, k, d, (int*)idx, (float*)score);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
