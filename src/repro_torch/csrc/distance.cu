// K-Means assignment on Hopper (sm_90a): nearest centroid for every point.
//
// Replaces the TPU kernel _assign_kernel
// (src/repro/kernels/distance/distance.py:46, launched by
// assign_clusters_kernel at :92, pallas_call at :114).
//
// What it computes: for each point x_i the index of the centroid with the
// smallest score ||c_j||^2 - 2 x_i.c_j (first minimum on ties, NaN counting
// as the minimum), and either that score or the squared distance
// max(score + ||x_i||^2, 0), ||x_i||^2 summed in feature order: bit for bit
// what the plain version in kernels/distance/ref.py computes.
//
// What bounds it on an H100: reading x once.  At the main path's shape
// (n = 2^20, d = 32, k = 64) that is 134 MB, 0.040 ms at 3.35 TB/s; the
// scores, 2 n k d = 4.3 GFLOP, go to the tensor cores as three TF32
// products (12.9 GFLOP, 26 us at the 495 TFLOP/s TF32 peak), so the
// exact fp32 arithmetic runs only for the ~1 candidate a point keeps.
//
// Design (the search itself is assign_common.cuh, shared with fused.cu):
// - What held the CUDA-core kernel back, and what this one does about it:
//   every thread re-read its own row of x from device memory once per tile
//   of 32 centroids (x is now staged once per block tile through a TMA
//   ring); each multiply-add cost a shared load, a multiply and an add with
//   no FMA (the products run on the tensor cores, and only the candidates
//   take the exact path); three block barriers per centroid tile and one
//   thread per centroid norm (centroids are packed once per call and staged
//   once per block); a second pass over x for ||x||^2 (the norm is summed
//   while the row is in shared memory, and the distance written here).
// - The window: |s~ - s| <= alpha(d) ||x|| cmax + 2^-21 (cnmax + 2 ||x||
//   cmax) (+ an underflow term) over a chunk whose largest ||c|| is cmax
//   and largest ||c||^2 cnmax, alpha(d) = (d + 64 ceil(d/8) + 12) 2^-21:
//   four times a first-order bound on the exact path's rounding, the TF32
//   split residuals, the dropped lo.lo product, the tensor cores'
//   truncating accumulation and the final subtraction (derived term by
//   term in assign_common.cuh, item 2).
// - pack_centroids runs first, one block per chunk of centroids.
// - One block owns tiles_per_block tiles of tm points; four warps each take
//   16-row m-tiles; every grid dimension is a function of (n, k, d).
// - Wide rows (d > 96, the plan's choice) take the wide search
//   (assign_common.cuh, item 5): search_wide_kernel, a persistent grid of
//   one block an SM, two warpgroups of 64 points sharing the centroids'
//   boxes that a producer warp streams by TMA, x's tile resident across
//   the chunks, the exact rechecks deferred to the end of the tile; or, for
//   k <= 8, exact_wide_kernel, every pair scored in the exact arithmetic.
// - The recheck counts (in all, and the most for one point) go to two
//   scratch words by one integer atomic pair a warp, at the end
//   (kernels/distance/ops.py:rechecks reads them).

#include "assign_common.cuh"

namespace {

using namespace repro_assign;

template <int NT>
__global__ void __launch_bounds__(kThreads)
assign_kernel(const __grid_constant__ CUtensorMap xmap,
              const float* __restrict__ x, const float* __restrict__ cpack,
              int n, int k, int d, const Plan p, int tma, int with_dists,
              int* __restrict__ idx_out, float* __restrict__ out,
              unsigned long long* __restrict__ stats) {
  extern __shared__ unsigned char smem_raw[];
  float* base = aligned_smem(smem_raw);
  const int tm = p.tm, resident = p.resident;
  const int tiles = (n + tm - 1) / tm;
  const int tile0 = blockIdx.x * p.tiles_per_block;
  const int ntiles = min(p.tiles_per_block, tiles - tile0);
  float* slots = base + kStages * stage_bytes(d, tm) / 4;
  const int nkc = (k + 8 * NT - 1) / (8 * NT);
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      slots + (size_t)(resident ? nkc : 1) * chunk_floats(d, NT));

  const Ring ring{&xmap, x, n, d, tm, tma, tile0, ntiles, base, bars};
  const Centroids cs{cpack, slots, k, d, NT, resident};
  Rechecks rc;
  ring.init();
  if (resident) {
    for (int ch = 0; ch < nkc; ++ch) {
      stage_chunk(cs, ch, slots + (size_t)ch * chunk_floats(d, NT));
    }
  }
  __syncthreads();

  for (int q = 0; q < kStages - 1 && q < ntiles; ++q) {
    ring.issue(q);
    ring.commit();
  }
  for (int q = 0; q < ntiles; ++q) {
    if (q + kStages - 1 < ntiles) ring.issue(q + kStages - 1);
    ring.commit();
    ring.wait(q);
    const int row0 = (tile0 + q) * tm;
    search_tile<NT>(cs, ring.stage(q), tm, min(tm, n - row0), &rc,
                [&](int r, int j, float s, float xn) {
                  idx_out[row0 + r] = j;
                  if (with_dists) {
                    const float t = __fadd_rn(s, xn);
                    s = (t < 0.f) ? 0.f : t;  // NaN stays NaN
                  }
                  out[row0 + r] = s;
                });
    __syncthreads();  // the stage is read by every warp before its reuse
  }
  rc.flush(stats);
}

// The kernel for nt 8-centroid groups a chunk (1, 2, 4 or 8).
decltype(&assign_kernel<8>) assign_kernel_for(int nt) {
  switch (nt) {
    case 1: return assign_kernel<1>;
    case 2: return assign_kernel<2>;
    case 4: return assign_kernel<4>;
    default: return assign_kernel<8>;
  }
}

}  // namespace

extern "C" {

// Shared memory one block needs (bytes): the staged search's, or for wide
// rows the wide search's (assign_common.cuh, wide_smem_bytes).
size_t assign_smem_bytes(int d, int tm, int nt, int slots, int wide,
                         int stages, int xres) {
  return wide ? wide_smem_bytes(d, nt, stages, xres)
              : search_smem_bytes(d, tm, nt, slots) +
                    kStages * sizeof(uint64_t);
}

// x: (n, d) f32, c: (k, d) f32, both contiguous on the current device,
// n >= 1.  cpack: centroid_pack_floats(k, d, nt) f32 scratch (unused by
// the exact form); stats: 2 u64 scratch (rechecks in all, most for one
// point).  tm (a multiple of 16, at most 128), nt (1, 2, 4 or 8),
// resident, tiles_per_block, wide, and for wide rows stages (0: the exact
// form), xres and search_blocks come from the wrapper's plan.  Writes idx
// (n,) i32 and out (n,) f32 (the score, or the squared distance when
// with_dists) on `stream`.  Returns 0 or an error code for
// kernel_error_string; does not synchronise.
int assign_clusters(const void* x, const void* c, int n, int k, int d, int tm,
                    int nt, int resident, int tiles_per_block, int wide,
                    int stages, int xres, int search_blocks, int with_dists,
                    void* cpack, void* idx, void* out, void* stats,
                    void* stream) {
  const Plan p{tm, resident, tiles_per_block, wide, stages, xres,
               search_blocks};
  if (const int err = check_plan(p, nt, k)) return err;
  cudaStream_t s = (cudaStream_t)stream;
  if (wide) {
    return launch_wide(x, c, n, k, d, nt, p, with_dists ? 1 : 0, cpack, idx,
                       out, stats, s);
  }
  const int nkc = (k + 8 * nt - 1) / (8 * nt);
  const size_t smem = assign_smem_bytes(d, tm, nt, resident ? nkc : 1, 0, 0,
                                        0);
  // x by TMA where it allows it (the kernel's argument after the plan)
  const int tma = use_tma(x, d) ? 1 : 0;
  CUtensorMap xmap{};
  if (tma) {
    const int err = encode_x(&xmap, x, n, d, tm);
    if (err) return err;
  }
  const auto kernel = assign_kernel_for(nt);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  pack_centroids<<<nkc, 256, 0, s>>>((const float*)c, k, d, nt,
                                     (float*)cpack,
                                     (unsigned long long*)stats);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int tiles = (n + tm - 1) / tm;
  const unsigned blocks =
      (unsigned)((tiles + tiles_per_block - 1) / tiles_per_block);
  kernel<<<blocks, kThreads, smem, s>>>(
      xmap, (const float*)x, (const float*)cpack, n, k, d, p, tma,
      with_dists, (int*)idx, (float*)out, (unsigned long long*)stats);
  return (int)cudaGetLastError();
}

}  // extern "C"
