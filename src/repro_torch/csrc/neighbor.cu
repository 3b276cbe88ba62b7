// DBSCAN eps-neighbourhood kernels on Hopper (sm_90a).
//
// Replaces the TPU kernels in src/repro/kernels/neighbor/neighbor.py:
// - _degree_kernel (:53; degree_kernel :83, pallas_call :95):
//       deg[i] = #{ j : d2(i, j) <= eps^2 }, the point itself included;
// - _expand_kernel (:65; expand_kernel :111, pallas_call :125):
//       reach[i] = any_j ( d2(i, j) <= eps^2 and front[j] ),
//   the Pallas kernel's sum_j A[i,j] * front[j] thresholded at 0.5.
// The n x n adjacency A is never stored.
//
// What bounds them on an H100: the pair loop.  Degree does n^2 pairs of
// 3*d fp32 operations (subtract, multiply, add) against n*d*4 bytes read
// once, so at the main path's shape (n = 65536, d = 4) it is bound by the
// fp32 CUDA cores.  Expansion only needs the pairs whose column is on the
// frontier (a few percent of n per BFS step), which makes it cheap enough
// that reading x and writing the flags bounds it instead.
//
// Design:
// - One thread owns one row i and holds x_i in registers (for d <= 8 the
//   width is a template parameter; wider points read x_i through L1).
// - The block loops over column tiles of kCols points staged in shared
//   memory; that loop is the Pallas grid's sequential "arbitrary" axis.
//   Each thread writes its own row's result once: no atomics, no second
//   pass.
// - d2 is computed directly as sum_f (x_i,f - x_j,f)^2 in feature order,
//   each operation rounded on its own (no fused multiply-add).  That is the
//   paper's OpenCL form and the plain PyTorch version's form
//   (kernels/neighbor/ref.py), so the two agree bit for bit, and it needs
//   no padding coordinate.  The TPU kernel's ||x_i||^2 - 2 x_i.x_j +
//   ||x_j||^2 decomposition only paid off on the MXU; at d = 1..4 a matrix
//   unit has nothing to chew on, and the decomposition's cancellation moves
//   pairs across the eps boundary.
// - eps^2 is a runtime argument: a new eps rebuilds nothing.
// - Expansion skips a column tile that holds no frontier point, skips each
//   non-frontier column (the branch is uniform across the warp), and stops
//   early once every row of the block has found a frontier neighbour.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 128;  // rows per block, one per thread
constexpr int kCols = 256;  // columns per shared-memory tile

// D > 0: compile-time width, x_i in registers.  D == 0: runtime width d.
template <int D>
struct Row {
  float v[D > 0 ? D : 1];
  const float* p;
  __device__ Row(const float* x, int i, int d) : p(x + (size_t)i * d) {
    if constexpr (D > 0) {
#pragma unroll
      for (int f = 0; f < D; ++f) v[f] = __ldg(p + f);
    }
  }
  // Squared distance to the point at xj (shared memory), feature order.
  __device__ __forceinline__ float d2(const float* xj, int d) const {
    float acc = 0.f;
    if constexpr (D > 0) {
#pragma unroll
      for (int f = 0; f < D; ++f) {
        const float t = __fsub_rn(v[f], xj[f]);
        acc = __fadd_rn(acc, __fmul_rn(t, t));
      }
    } else {
      for (int f = 0; f < d; ++f) {
        const float t = __fsub_rn(__ldg(p + f), xj[f]);
        acc = __fadd_rn(acc, __fmul_rn(t, t));
      }
    }
    return acc;
  }
};

template <int D>
__global__ void __launch_bounds__(kRows)
degree_kernel(const float* __restrict__ x, int n, int d, float eps2,
              int* __restrict__ deg) {
  extern __shared__ float xs[];  // [kCols * d]
  const int w = D > 0 ? D : d;
  const int i = blockIdx.x * kRows + threadIdx.x;
  const bool live = i < n;
  const Row<D> row(x, live ? i : 0, w);
  int count = 0;
  for (int j0 = 0; j0 < n; j0 += kCols) {
    const int jt = min(kCols, n - j0);
    __syncthreads();  // the previous tile has been read by every thread
    for (int e = threadIdx.x; e < jt * w; e += kRows) {
      xs[e] = x[(size_t)j0 * w + e];
    }
    __syncthreads();
    for (int j = 0; j < jt; ++j) count += row.d2(xs + j * w, w) <= eps2;
  }
  if (live) deg[i] = count;
}

template <int D>
__global__ void __launch_bounds__(kRows)
expand_kernel(const float* __restrict__ x, const unsigned char* __restrict__ front,
              int n, int d, float eps2, unsigned char* __restrict__ reach) {
  extern __shared__ float xs[];  // [kCols * d], then kCols frontier flags
  const int w = D > 0 ? D : d;
  unsigned char* fs = reinterpret_cast<unsigned char*>(xs + kCols * w);
  const int i = blockIdx.x * kRows + threadIdx.x;
  const bool live = i < n;
  const Row<D> row(x, live ? i : 0, w);
  bool hit = false;
  for (int j0 = 0; j0 < n; j0 += kCols) {
    const int jt = min(kCols, n - j0);
    __syncthreads();  // the previous tile has been read by every thread
    int any = 0;
    for (int e = threadIdx.x; e < jt; e += kRows) {
      fs[e] = front[j0 + e];
      any |= fs[e];
    }
    if (!__syncthreads_or(any)) continue;  // no frontier point in the tile
    for (int e = threadIdx.x; e < jt * w; e += kRows) {
      xs[e] = x[(size_t)j0 * w + e];
    }
    __syncthreads();
    for (int j = 0; j < jt; ++j) {
      if (fs[j] && !hit) hit = row.d2(xs + j * w, w) <= eps2;
    }
    if (__syncthreads_and(hit || !live)) break;  // every row is reached
  }
  if (live) reach[i] = hit ? 1 : 0;
}

size_t smem_bytes(int d, bool with_front) {
  return (size_t)kCols * d * sizeof(float) + (with_front ? kCols : 0);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int D>
int launch_degree(const float* x, int n, int d, float eps2, int* deg,
                  cudaStream_t stream) {
  const size_t smem = smem_bytes(D > 0 ? D : d, false);
  cudaError_t e = allow_smem(degree_kernel<D>, smem);
  if (e != cudaSuccess) return (int)e;
  const unsigned blocks = (unsigned)((n + kRows - 1) / kRows);
  degree_kernel<D><<<blocks, kRows, smem, stream>>>(x, n, d, eps2, deg);
  return (int)cudaGetLastError();
}

template <int D>
int launch_expand(const float* x, const unsigned char* front, int n, int d,
                  float eps2, unsigned char* reach, cudaStream_t stream) {
  const size_t smem = smem_bytes(D > 0 ? D : d, true);
  cudaError_t e = allow_smem(expand_kernel<D>, smem);
  if (e != cudaSuccess) return (int)e;
  const unsigned blocks = (unsigned)((n + kRows - 1) / kRows);
  expand_kernel<D><<<blocks, kRows, smem, stream>>>(x, front, n, d, eps2, reach);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one block needs for feature width d (expansion adds the
// frontier flags).
size_t neighbor_smem_bytes(int d) { return smem_bytes(d, true); }

// x: (n, d) f32 contiguous; writes deg (n,) i32 on `stream`.  Returns the
// CUDA error code of the launch; does not synchronise.
int epsilon_degree(const void* x, int n, int d, float eps2, void* deg,
                   void* stream) {
  const float* xp = (const float*)x;
  int* out = (int*)deg;
  cudaStream_t s = (cudaStream_t)stream;
  switch (d) {
    case 1: return launch_degree<1>(xp, n, d, eps2, out, s);
    case 2: return launch_degree<2>(xp, n, d, eps2, out, s);
    case 3: return launch_degree<3>(xp, n, d, eps2, out, s);
    case 4: return launch_degree<4>(xp, n, d, eps2, out, s);
    case 5: return launch_degree<5>(xp, n, d, eps2, out, s);
    case 6: return launch_degree<6>(xp, n, d, eps2, out, s);
    case 7: return launch_degree<7>(xp, n, d, eps2, out, s);
    case 8: return launch_degree<8>(xp, n, d, eps2, out, s);
    default: return launch_degree<0>(xp, n, d, eps2, out, s);
  }
}

// x: (n, d) f32, front: (n,) bool (one byte each), both contiguous; writes
// reach (n,) bool on `stream`.  Returns the CUDA error code of the launch.
int expand_frontier(const void* x, const void* front, int n, int d,
                    float eps2, void* reach, void* stream) {
  const float* xp = (const float*)x;
  const unsigned char* fp = (const unsigned char*)front;
  unsigned char* out = (unsigned char*)reach;
  cudaStream_t s = (cudaStream_t)stream;
  switch (d) {
    case 1: return launch_expand<1>(xp, fp, n, d, eps2, out, s);
    case 2: return launch_expand<2>(xp, fp, n, d, eps2, out, s);
    case 3: return launch_expand<3>(xp, fp, n, d, eps2, out, s);
    case 4: return launch_expand<4>(xp, fp, n, d, eps2, out, s);
    case 5: return launch_expand<5>(xp, fp, n, d, eps2, out, s);
    case 6: return launch_expand<6>(xp, fp, n, d, eps2, out, s);
    case 7: return launch_expand<7>(xp, fp, n, d, eps2, out, s);
    case 8: return launch_expand<8>(xp, fp, n, d, eps2, out, s);
    default: return launch_expand<0>(xp, fp, n, d, eps2, out, s);
  }
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
