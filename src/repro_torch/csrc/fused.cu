// Fused masked Lloyd step on Hopper (sm_90a): assignment plus the masked
// per-centroid sums, counts and inertia the centroid update needs.  Beside
// it, the one-job step's sums for narrow rows (lloyd_sums_kernel, with its
// own note below), which share pass 2.
//
// Replaces the TPU kernel _fused_step_kernel
// (src/repro/kernels/distance/fused.py:42, launched by fused_step_kernel at
// :101, pallas_call at :125, wrapper fused_masked_assign_update at :151).
//
// What it computes, for points x (n, d), centroids c (k, d), mask (n,):
// - idx[i]: the nearest centroid of every point (masked rows included), by
//   the score ||c_j||^2 - 2 x_i.c_j, first minimum on ties, bit for bit
//   the index assign_clusters and the plain version give;
// - sums[j, :] = sum of x_i over unmasked i with idx[i] = j, counts[j] the
//   number of such i, inertia = sum over unmasked i of
//   max(min(score_i, 3.4e38) + ||x_i||^2, 0).
//
// What bounds it on an H100: reading x (and the mask) once: n*d*4 + 5n
// bytes, 0.042 ms at the service's shape (n = 2^20, d = 32, k = 64).  The
// scores take the tensor cores as in distance.cu (the search is
// assign_common.cuh, shared with it); the accumulation is d adds per
// unmasked point.
//
// Design, and what it does about the CUDA-core kernel's costs:
// - The search: see assign_common.cuh (TMA-staged x, 3xTF32 candidate
//   scores, a certified window, an exact recheck).  The window is
//   alpha(d) ||x|| cmax + 2^-21 (cnmax + 2 ||x|| cmax) with alpha(d) =
//   (d + 64 ceil(d/8) + 12) 2^-21, four times a first-order bound on the
//   split residuals, the dropped lo.lo product, the tensor cores'
//   truncating accumulation and both paths' rounding (derived there,
//   item 2).
// - The accumulation was serial: only the threads f < d worked, each
//   walking the tile's points in order with a device-memory load per step,
//   and thread 0 alone summed the inertia terms and the counts.  Now every
//   warp works: the sums of centroid j belong to warp j % 4, which takes
//   its points in index order (a ballot over 32 rows at a time), two at a
//   step so their shared-memory round trips overlap, one lane per feature,
//   reading the rows from the staged tile; every sum has one writer and
//   the order of the points, whatever the warps or the card.  Counts are
//   integers in shared memory, one integer atomic per point, exact in any
//   order.  Thread r sums the inertia terms of row r of every tile in tile
//   order, and the block adds the 128 sums by a fixed tree at its end.
// - Each block owns tiles_per_block tiles and writes its partial
//   [sums (k*d) | counts (k) | inertia] to its own slice: no float
//   atomics.  The sums cover acc_k centroids of shared memory at a time;
//   when k needs more, the block walks its tiles again for each further
//   range (searching again: the same arithmetic gives the same indices).
// - Wide rows (d > 96, the plan's choice): pass 1 is the wide search
//   (assign_common.cuh, item 5: on its own persistent grid, one block an
//   SM, bound by its three TF32 products, 51.6 ms at the pod-scale cell's
//   2-shard shard), writing every row's index and inertia term, then
//   wide_sums_kernel: one block per (partial block, range of acc_k
//   centroids), adding the block's rows in row order from those indices,
//   reading each row once.  The first wide form searched inside the 31
//   partial blocks that the partials' 2^24 floats allow at k = 4,096, d =
//   128 (31 of 132 SMs) and re-walked every tile for each further range;
//   block_rows, the partials' layout and their bits are unchanged (the
//   sums of a centroid in row order, the inertia in the same tree).
// - Pass 2 reduced 1,024 partials with one thread per element on 9 blocks.
//   Now one block takes 32 elements: each of its 8 warps sums a fixed
//   eighth of the blocks in order, and warp 0 adds the eight in order.
//   The launch shape is a function of (n, k, d), so the same inputs give
//   the same bits on every run and every card.
// - Counts are fp32 (as in the reference) and exact up to 2^24 rows, which
//   the wrapper enforces.
// - The passes also run apart (fused_masked_partials, fused_reduce_partials)
//   for the distributed lane: shards of an item cut at multiples of
//   tiles_per_block * tm rows, each through pass 1 with the whole item's
//   tiles_per_block, write the whole launch's partials block for block,
//   and one pass 2 over them gives its sums bit for bit.

#include "assign_common.cuh"

namespace {

using namespace repro_assign;

constexpr float kBig = kScoreClamp;  // the reference's score clamp
constexpr int kReduceWarps = 8;

__host__ __device__ inline size_t acc_floats(int d, int tm, int acc_k) {
  // sums, counts, and per-row index / weight / inertia term, kept even so
  // the mbarriers after them are 8-byte aligned
  const size_t f = (size_t)acc_k * d + acc_k + 3 * (size_t)tm;
  return f + (f & 1);
}

// The sums of one tile's rows, in row order: centroid j0 + jj belongs to
// warp jj % 4, which adds its rows (a ballot over 32 rows at a time), one
// lane per feature, xv(r, f) reading feature f of row r.  row_j / row_w
// hold each row's centroid and weight.
template <class XV>
__device__ __forceinline__ void add_rows(float* acc, const int* row_j,
                                         const int* row_w, int tm, int d,
                                         int j0, int ka, XV xv) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r0 = 0; r0 < tm; r0 += 32) {
    const int r = r0 + lane;
    int jj = -1;
    if (r < tm && row_w[r]) {
      jj = row_j[r] - j0;
      if (jj < 0 || jj >= ka || (jj & (kWarps - 1)) != warp) jj = -1;
    }
    unsigned bits = __ballot_sync(0xffffffffu, jj >= 0);
    while (bits) {  // two rows a step: their round trips overlap
      const int b0 = __ffs(bits) - 1;
      bits &= bits - 1;
      const int b1 = bits ? __ffs(bits) - 1 : b0;
      const int jb = bits ? __shfl_sync(0xffffffffu, jj, b1) : -1;
      bits &= bits - 1;
      const int ja = __shfl_sync(0xffffffffu, jj, b0);
      float* sa = acc + (size_t)ja * d;
      float* sb = acc + (size_t)max(jb, 0) * d;
      for (int f = lane; f < d; f += 32) {
        const float x0 = xv(r0 + b0, f);
        const float x1 = xv(r0 + b1, f);
        if (jb == ja) {  // one centroid: in order
          sa[f] = __fadd_rn(__fadd_rn(sa[f], x0), x1);
        } else {
          const float va = sa[f];
          const float vb = jb >= 0 ? sb[f] : 0.f;
          sa[f] = __fadd_rn(va, x0);
          if (jb >= 0) sb[f] = __fadd_rn(vb, x1);
        }
      }
    }
  }
}

// Pass 1, rows up to WIDE_D features: tiles staged through the ring (by
// TMA when tma), searched by search_tile, and the sums read from the
// staged tile; a further range of sums searches the tile again.
template <int NT>
__global__ void __launch_bounds__(kThreads)
fused_partials_kernel(const __grid_constant__ CUtensorMap xmap,
                      const float* __restrict__ x,
                      const unsigned char* __restrict__ mask,
                      const float* __restrict__ cpack, int n, int k, int d,
                      const Plan p, int tma, int acc_k,
                      int* __restrict__ idx_out, float* __restrict__ part,
                      unsigned long long* __restrict__ stats) {
  extern __shared__ unsigned char smem_raw[];
  float* base = aligned_smem(smem_raw);
  const int tm = p.tm, resident = p.resident;
  const int tiles = (n + tm - 1) / tm;
  const int tile0 = blockIdx.x * p.tiles_per_block;
  const int ntiles = min(p.tiles_per_block, tiles - tile0);
  const int nkc = (k + 8 * NT - 1) / (8 * NT);
  float* slots = base + kStages * stage_bytes(d, tm) / 4;
  float* acc = slots + (size_t)(resident ? nkc : 1) * chunk_floats(d, NT);
  int* cnt = reinterpret_cast<int*>(acc + (size_t)acc_k * d);
  int* row_j = cnt + acc_k;
  int* row_w = row_j + tm;
  float* row_d2 = reinterpret_cast<float*>(row_w + tm);
  uint64_t* bars = reinterpret_cast<uint64_t*>(acc + acc_floats(d, tm, acc_k));

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t stride = (size_t)k * d + k + 1;
  float* mine = part + (size_t)blockIdx.x * stride;
  const Ring ring{&xmap, x, n, d, tm, tma, tile0, ntiles, base, bars};
  ring.init();
  if (resident) {
    const Centroids cs{cpack, slots, k, d, NT, 1};
    for (int ch = 0; ch < nkc; ++ch) {
      stage_chunk(cs, ch, slots + (size_t)ch * chunk_floats(d, NT));
    }
  }

  const int ranges = (k + acc_k - 1) / acc_k;
  const int total = ranges * ntiles;  // the ring's sequence of tiles
  float inertia = 0.f;  // thread r's: row r of each tile, in tile order
  Rechecks rc;
  for (int q = 0; q < kStages - 1 && q < total; ++q) {
    ring.issue(q);
    ring.commit();
  }
  for (int rg = 0; rg < ranges; ++rg) {
    const int j0 = rg * acc_k, ka = min(acc_k, k - j0);
    for (int e = threadIdx.x; e < ka * d; e += kThreads) acc[e] = 0.f;
    for (int e = threadIdx.x; e < ka; e += kThreads) cnt[e] = 0;
    __syncthreads();
    const Centroids cs{cpack, slots, k, d, NT, resident};
    for (int tt = 0; tt < ntiles; ++tt) {
      const int q = rg * ntiles + tt;
      const int row0 = (tile0 + tt) * tm;
      const int valid = min(tm, n - row0);
      // thread r loads row r's weight now and stores it after the search
      // (tm <= kThreads)
      const int w_r = threadIdx.x < valid ? mask[row0 + threadIdx.x] != 0 : 0;
      if (threadIdx.x >= valid && threadIdx.x < tm) row_d2[threadIdx.x] = 0.f;
      const auto emit = [&](int r, int j, float s, float xn) {
        if (rg == 0) idx_out[row0 + r] = j;
        const float t = __fadd_rn((s > kBig) ? kBig : s, xn);
        row_j[r] = j;
        row_d2[r] = (t < 0.f) ? 0.f : t;  // NaN stays NaN
      };
      if (q + kStages - 1 < total) ring.issue(q + kStages - 1);
      ring.commit();
      ring.wait(q);
      const float* stage = ring.stage(q);
      search_tile<NT>(cs, stage, tm, valid, rg == 0 ? &rc : nullptr, emit);
      if (threadIdx.x < tm) row_w[threadIdx.x] = w_r;
      __syncthreads();

      // counts: integers, so the order does not matter (no float atomics)
      if (threadIdx.x < tm && row_w[threadIdx.x]) {
        const int jj = row_j[threadIdx.x] - j0;
        if (jj >= 0 && jj < ka) atomicAdd(cnt + jj, 1);
      }
      add_rows(acc, row_j, row_w, tm, d, j0, ka, [&](int r, int f) {
        return stage[swz(r, f, tm)];
      });
      // thread r's inertia terms: its row of every tile, in tile order
      if (rg == 0 && w_r) inertia = __fadd_rn(inertia, row_d2[threadIdx.x]);
      __syncthreads();  // the stage and the row arrays are free again
    }
    for (int e = threadIdx.x; e < ka * d; e += kThreads) {
      mine[(size_t)j0 * d + e] = acc[e];
    }
    for (int e = threadIdx.x; e < ka; e += kThreads) {
      mine[(size_t)k * d + j0 + e] = (float)cnt[e];  // exact below 2^24
    }
    __syncthreads();  // acc / cnt are written out before the next range
  }
  // the threads' inertia by a fixed tree: lanes, then warps in order
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    inertia = __fadd_rn(inertia, __shfl_xor_sync(0xffffffffu, inertia, o));
  }
  float* warp_sums = acc;  // free after the last range's write-out
  if (lane == 0) warp_sums[warp] = inertia;
  __syncthreads();
  if (threadIdx.x == 0) {
    float v = warp_sums[0];
    for (int w = 1; w < kWarps; ++w) v = __fadd_rn(v, warp_sums[w]);
    mine[(size_t)k * d + k] = v;
  }
  rc.flush(stats);
}

// out[e] = sum over blocks of part[b * stride + e]: warp w sums blocks
// [w B / 8, (w + 1) B / 8) in order, then warp 0 adds the eight in order.
__global__ void __launch_bounds__(32 * kReduceWarps)
reduce_partials_kernel(const float* __restrict__ part, int blocks,
                       int stride, float* __restrict__ out) {
  __shared__ float sums[kReduceWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int e = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (e < stride) {
    const int b1 = (int)((long long)(warp + 1) * blocks / kReduceWarps);
#pragma unroll 8
    for (int b = (int)((long long)warp * blocks / kReduceWarps); b < b1; ++b) {
      s = __fadd_rn(s, part[(size_t)b * stride + e]);
    }
  }
  sums[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && e < stride) {
    float t = sums[0][lane];
    for (int w = 1; w < kReduceWarps; ++w) t = __fadd_rn(t, sums[w][lane]);
    out[e] = t;
  }
}

// The pass-1 kernel for nt 8-centroid groups a chunk (1, 2, 4 or 8).
decltype(&fused_partials_kernel<8>) fused_kernel_for(int nt) {
  switch (nt) {
    case 1: return fused_partials_kernel<1>;
    case 2: return fused_partials_kernel<2>;
    case 4: return fused_partials_kernel<4>;
    default: return fused_partials_kernel<8>;
  }
}

// Pass 1's sums for wide rows, after the wide search has written every
// row's index and inertia term (rowval).  Block (b, rg) writes the sums and
// counts of centroids [rg acc_k, (rg + 1) acc_k) over the rows of partial
// block b (block_rows rows) into its slice of part, and block (b, 0) the
// inertia: the first kernel's arithmetic and order, so the partials are
// its bits.  Warp w adds the rows of the centroids jj with jj % kSumsWarps
// == w, in row order, kSumsBatch rows at a time (their loads in flight
// together, the adds in order), one lane a feature; it reads the indices
// and the mask of 128 rows at once, the next 128 in flight meanwhile.
// Thread r < kWideTM sums the inertia terms of row r of every 64-row tile
// in tile order; then the lanes by a fixed tree and the two warps in
// order.
constexpr int kSumsThreads = 256;
constexpr int kSumsWarps = kSumsThreads / 32;
constexpr int kSumsBatch = 4;

__host__ __device__ inline size_t sums_smem_bytes(int d, int acc_k) {
  return ((size_t)acc_k * d + acc_k) * sizeof(float) + 16;
}

__global__ void __launch_bounds__(kSumsThreads)
wide_sums_kernel(const float* __restrict__ x,
                 const unsigned char* __restrict__ mask,
                 const int* __restrict__ idx, const float* __restrict__ rowval,
                 int n, int k, int d, int block_rows, int acc_k,
                 float* __restrict__ part) {
  extern __shared__ float sums_smem[];
  const int rg = blockIdx.y, j0 = rg * acc_k, ka = min(acc_k, k - j0);
  float* acc = sums_smem;
  int* cnt = reinterpret_cast<int*>(acc + (size_t)ka * d);
  float* wsum = reinterpret_cast<float*>(cnt + ka);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = blockIdx.x * block_rows, r1 = min(n, r0 + block_rows);
  for (int e = threadIdx.x; e < ka * d; e += kSumsThreads) acc[e] = 0.f;
  for (int e = threadIdx.x; e < ka; e += kSumsThreads) cnt[e] = 0;
  __syncthreads();

  // the indices and weights of 128 rows at a time, the next 128 in flight
  // while these are added
  int ir[4], nir[4];
  unsigned char mr[4], nmr[4];
  const auto load = [&](int base, int (&i4)[4], unsigned char (&m4)[4]) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int r = base + 32 * u + lane;
      i4[u] = r < r1 ? idx[r] : 0;
      m4[u] = r < r1 ? mask[r] : 0;
    }
  };
  load(r0, ir, mr);
  for (int base = r0; base < r1; base += 128) {
    if (base + 128 < r1) load(base + 128, nir, nmr);
    int jr[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int jj = ir[u] - j0;
      jr[u] = (mr[u] && jj >= 0 && jj < ka && jj % kSumsWarps == warp) ? jj
                                                                      : -1;
      ir[u] = nir[u];
      mr[u] = nmr[u];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      unsigned bits = __ballot_sync(0xffffffffu, jr[u] >= 0);
      while (bits) {
        int rr[kSumsBatch], jb[kSumsBatch], m = 0;
#pragma unroll
        for (int i = 0; i < kSumsBatch; ++i) {
          rr[i] = -1;
          jb[i] = 0;
          if (bits) {
            const int b = __ffs(bits) - 1;
            bits &= bits - 1;
            rr[i] = base + 32 * u + b;
            jb[i] = __shfl_sync(0xffffffffu, jr[u], b);
            m = i + 1;
          }
        }
        for (int f0 = 0; f0 < d; f0 += 128) {
          float v[kSumsBatch][4];
#pragma unroll
          for (int i = 0; i < kSumsBatch; ++i) {
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int f = f0 + 32 * c + lane;
              v[i][c] = 0.f;
              if (i < m && f < d) v[i][c] = __ldg(x + (size_t)rr[i] * d + f);
            }
          }
#pragma unroll
          for (int i = 0; i < kSumsBatch; ++i) {
            if (i < m) {
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                const int f = f0 + 32 * c + lane;
                if (f < d) {
                  float* a = acc + (size_t)jb[i] * d + f;
                  *a = __fadd_rn(*a, v[i][c]);
                }
              }
            }
          }
        }
        if (lane == 0) {  // the warp's own centroids: no atomics
#pragma unroll
          for (int i = 0; i < kSumsBatch; ++i) {
            if (i < m) ++cnt[jb[i]];
          }
        }
      }
    }
  }

  if (rg == 0) {
    float inertia = 0.f;
    if (threadIdx.x < kWideTM) {
#pragma unroll 8
      for (int r = r0 + threadIdx.x; r < r1; r += kWideTM) {
        if (mask[r]) inertia = __fadd_rn(inertia, rowval[r]);
      }
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      inertia = __fadd_rn(inertia, __shfl_xor_sync(0xffffffffu, inertia, o));
    }
    if (lane == 0 && warp < 2) wsum[warp] = inertia;
  }
  __syncthreads();
  const size_t stride = (size_t)k * d + k + 1;
  float* mine = part + (size_t)blockIdx.x * stride;
  for (int e = threadIdx.x; e < ka * d; e += kSumsThreads) {
    mine[(size_t)j0 * d + e] = acc[e];
  }
  for (int e = threadIdx.x; e < ka; e += kSumsThreads) {
    mine[(size_t)k * d + j0 + e] = (float)cnt[e];  // exact below 2^24
  }
  // the first kernel added warps 2 and 3's +0 after these two
  if (rg == 0 && threadIdx.x == 0) {
    mine[(size_t)k * d + k] = __fadd_rn(wsum[0], wsum[1]);
  }
}

// The one-job Lloyd step's sums for narrow rows (core/kmeans.py's step and
// mini-batch step, when k <= kLloydK and d <= kLloydD): the sums and
// counts of x's rows by their labels, for the centroid update.  It
// replaces no TPU kernel: the reference updates by jax.nn.one_hot and an
// einsum, which the port ran as an (n, k) fp32 one-hot and a GEMM on the
// CUDA cores (2.15 ms at 2^24 rows of 4 features, k = 8, on an H100).
//
// What bounds it: reading x and the labels once, n (4 d + 4) bytes, 0.100
// ms at that shape; it takes 0.118 there, plus 0.002 for pass 2.
//
// One form, kLloydK x kLloydD sums a thread: the paper's K-Means (2 to 4
// features, up to 8 clusters), which is every narrow shape a workload
// runs (the kmeans-d4 cell, the examples' quickstart and mine_cluster).
// Wider forms up to k (d + 1) = 64 beat the product too on an H100
// (PERF.md), but no workload runs them, so they keep the product.
//
// Design:
// - Each thread keeps every centroid's sums (kLloydK x kLloydD floats) and
//   counts (integers) in registers.  It walks rows r, r + T, r + 2T, ...
//   (T the grid's threads), the loads of kLloydRows rows in flight
//   together, the adds in row order: a row goes to centroid j's sums when
//   its label is j, one select a sum, so no register array is indexed at
//   run time.  Rows of 4 features load as one float4 when x is 16-byte
//   aligned.
// - The warp adds its lanes by a fixed xor tree, the block its warps in
//   order, and each block writes its partial [sums (k d) | counts (k) | 0]
//   to its own slice, the layout of the fused step's; pass 2 is
//   reduce_partials_kernel.  No float atomics, and the grid is a function
//   of n alone (the wrapper's), so the same inputs give the same bits on
//   every run and every card (ref.lloyd_sums_ref models the order).
// - Counts stay integers to the end: exact, and their floats exact below
//   2^24 rows, which the wrapper enforces.
// - A NaN row adds NaN to its own centroid's sums only, as
//   fused_partials_kernel does; the one-hot product spreads it to every
//   centroid (0 x NaN).
constexpr int kLloydThreads = 256;
constexpr int kLloydWarps = kLloydThreads / 32;
constexpr int kLloydK = 8;     // centroids at most
constexpr int kLloydD = 4;     // features at most
constexpr int kLloydRows = 4;  // rows in flight a thread
static_assert(kLloydD == 4, "a row is one float4");

__global__ void __launch_bounds__(kLloydThreads)
lloyd_sums_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                  int n, int k, int d, int vec, float* __restrict__ part) {
  __shared__ float wsum[kLloydWarps][kLloydK * kLloydD];
  __shared__ int wcnt[kLloydWarps][kLloydK];
  float acc[kLloydK][kLloydD];
  int cnt[kLloydK];
#pragma unroll
  for (int j = 0; j < kLloydK; ++j) {
    cnt[j] = 0;
#pragma unroll
    for (int f = 0; f < kLloydD; ++f) acc[j][f] = 0.f;
  }
  const int step = gridDim.x * kLloydThreads;
  for (int r0 = blockIdx.x * kLloydThreads + threadIdx.x; r0 < n;
       r0 += kLloydRows * step) {
    float v[kLloydRows][kLloydD];
    int lab[kLloydRows];
#pragma unroll
    for (int u = 0; u < kLloydRows; ++u) {
      const int r = r0 + u * step;
      const bool in = r < n;
      lab[u] = in ? __ldg(idx + r) : -1;
      const float* row = x + (size_t)(in ? r : 0) * d;
      if (vec) {
        float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
        if (in) t = __ldg(reinterpret_cast<const float4*>(row));
        v[u][0] = t.x;
        v[u][1] = t.y;
        v[u][2] = t.z;
        v[u][3] = t.w;
      } else {
#pragma unroll
        for (int f = 0; f < kLloydD; ++f) {
          v[u][f] = in && f < d ? __ldg(row + f) : 0.f;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kLloydRows; ++u) {
#pragma unroll
      for (int j = 0; j < kLloydK; ++j) {
        const bool hit = lab[u] == j;
        cnt[j] += hit ? 1 : 0;
#pragma unroll
        for (int f = 0; f < kLloydD; ++f) {
          acc[j][f] = hit ? __fadd_rn(acc[j][f], v[u][f]) : acc[j][f];
        }
      }
    }
  }

  // the lanes by a fixed xor tree (every lane ends with the same bits)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < kLloydK; ++j) {
    if (j < k) {
#pragma unroll
      for (int o = 16; o; o >>= 1) {
        cnt[j] += __shfl_xor_sync(0xffffffffu, cnt[j], o);
      }
#pragma unroll
      for (int f = 0; f < kLloydD; ++f) {
        if (f < d) {
#pragma unroll
          for (int o = 16; o; o >>= 1) {
            acc[j][f] = __fadd_rn(acc[j][f],
                                  __shfl_xor_sync(0xffffffffu, acc[j][f], o));
          }
        }
      }
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < kLloydK; ++j) {
      if (j < k) {
        wcnt[warp][j] = cnt[j];
#pragma unroll
        for (int f = 0; f < kLloydD; ++f) {
          if (f < d) wsum[warp][j * d + f] = acc[j][f];
        }
      }
    }
  }
  __syncthreads();
  // then the warps in order
  const int stride = k * d + k + 1;
  float* mine = part + (size_t)blockIdx.x * stride;
  for (int e = threadIdx.x; e < k * d; e += kLloydThreads) {
    float s = wsum[0][e];
    for (int w = 1; w < kLloydWarps; ++w) s = __fadd_rn(s, wsum[w][e]);
    mine[e] = s;
  }
  for (int e = threadIdx.x; e < k; e += kLloydThreads) {
    int c = 0;
    for (int w = 0; w < kLloydWarps; ++w) c += wcnt[w][e];
    mine[k * d + e] = (float)c;  // exact below 2^24
  }
  if (threadIdx.x == 0) mine[k * d + k] = 0.f;
}

}  // namespace

extern "C" {

// Shared memory one pass-1 block needs (bytes): the staged kernel's, or for
// wide rows the sums kernel's (the wide search's is assign_smem_bytes').
size_t fused_smem_bytes(int d, int tm, int nt, int slots, int wide,
                        int acc_k) {
  if (wide) return sums_smem_bytes(d, acc_k);
  return search_smem_bytes(d, tm, nt, slots) +
         acc_floats(d, tm, acc_k) * sizeof(float) +
         kStages * sizeof(uint64_t);
}

}  // extern "C"

namespace {

// Pass 1 (pack_centroids + the partials kernel, or for wide rows the wide
// search and the sums kernel): part gets one partial a block, *blocks
// their number.
int launch_partials(const void* x, const void* c, const void* mask, int n,
                    int k, int d, const Plan& p, int nt, int acc_k,
                    void* cpack, void* idx, void* rowval, void* part,
                    void* stats, cudaStream_t s, int* blocks) {
  if (const int err = check_plan(p, nt, k)) return err;
  if (acc_k < 1) return (int)cudaErrorInvalidValue;
  const int tiles = (n + p.tm - 1) / p.tm;
  *blocks = (tiles + p.tiles_per_block - 1) / p.tiles_per_block;
  if (p.wide) {
    if (rowval == nullptr) return (int)cudaErrorInvalidValue;
    int err = launch_wide(x, c, n, k, d, nt, p, 2, cpack, idx, rowval, stats,
                          s);
    if (err) return err;
    const size_t smem = sums_smem_bytes(d, acc_k);
    cudaError_t e = cudaFuncSetAttribute(
        wide_sums_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid(*blocks, (k + acc_k - 1) / acc_k);
    wide_sums_kernel<<<grid, kSumsThreads, smem, s>>>(
        (const float*)x, (const unsigned char*)mask, (const int*)idx,
        (const float*)rowval, n, k, d, p.tiles_per_block * p.tm, acc_k,
        (float*)part);
    return (int)cudaGetLastError();
  }
  const int nkc = (k + 8 * nt - 1) / (8 * nt);
  const size_t smem =
      fused_smem_bytes(d, p.tm, nt, p.resident ? nkc : 1, 0, acc_k);
  // as in assign_clusters: TMA where x allows it
  const int tma = use_tma(x, d) ? 1 : 0;
  CUtensorMap xmap{};
  if (tma) {
    const int err = encode_x(&xmap, x, n, d, p.tm);
    if (err) return err;
  }
  const auto kernel = fused_kernel_for(nt);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  pack_centroids<<<nkc, 256, 0, s>>>((const float*)c, k, d, nt,
                                     (float*)cpack,
                                     (unsigned long long*)stats);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  kernel<<<*blocks, kThreads, smem, s>>>(
      xmap, (const float*)x, (const unsigned char*)mask, (const float*)cpack,
      n, k, d, p, tma, acc_k, (int*)idx, (float*)part,
      (unsigned long long*)stats);
  return (int)cudaGetLastError();
}

int launch_reduce(const void* part, int blocks, int stride, void* out,
                  cudaStream_t s) {
  reduce_partials_kernel<<<(stride + 31) / 32, 32 * kReduceWarps, 0, s>>>(
      (const float*)part, blocks, stride, (float*)out);
  return (int)cudaGetLastError();
}

// The narrow-row sums' pass 1: one partial a block of `blocks`.
int launch_lloyd(const void* x, const void* idx, int n, int k, int d,
                 int blocks, void* part, cudaStream_t s) {
  if (n < 1 || k < 1 || k > kLloydK || d < 1 || d > kLloydD || blocks < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int vec = d == kLloydD && ((uintptr_t)x & 15) == 0;
  lloyd_sums_kernel<<<blocks, kLloydThreads, 0, s>>>(
      (const float*)x, (const int*)idx, n, k, d, vec, (float*)part);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (n, d) f32, c: (k, d) f32, mask: (n,) bool, all contiguous on the
// current device; n >= 1.  tm, nt, resident, tiles_per_block, wide,
// stages, xres and search_blocks as for assign_clusters; acc_k centroids'
// sums fit the shared memory at a time.  cpack:
// centroid_pack_floats(k, d, nt) f32 scratch; rowval: n f32 scratch for
// wide rows (else unused); part: blocks * (k*d + k + 1) f32 scratch,
// blocks = ceil(ceil(n / tm) / tiles_per_block); stats: 2 u64 scratch.
// Writes idx (n,) i32 and out = [sums (k*d) | counts (k) | inertia (1)]
// f32 on `stream`.  Returns 0 or an error code for kernel_error_string;
// does not synchronise.
int fused_masked_assign_update(const void* x, const void* c, const void* mask,
                               int n, int k, int d, int tm, int nt,
                               int resident, int tiles_per_block, int wide,
                               int stages, int xres, int search_blocks,
                               int acc_k, void* cpack, void* idx,
                               void* rowval, void* part, void* out,
                               void* stats, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Plan p{tm, resident, tiles_per_block, wide, stages, xres,
               search_blocks};
  int blocks = 0;
  const int err = launch_partials(x, c, mask, n, k, d, p, nt, acc_k, cpack,
                                  idx, rowval, part, stats, s, &blocks);
  if (err) return err;
  return launch_reduce(part, blocks, k * d + k + 1, out, s);
}

// Pass 1 alone, as fused_masked_assign_update without out: writes idx and
// part (one partial a block of tiles_per_block tiles).  A launch over the
// rows of a whole item and launches over its cuts at multiples of
// tiles_per_block * tm rows write the same partials, block for block: the
// distributed lane's shards (core/distributed.py).
int fused_masked_partials(const void* x, const void* c, const void* mask,
                          int n, int k, int d, int tm, int nt, int resident,
                          int tiles_per_block, int wide, int stages, int xres,
                          int search_blocks, int acc_k, void* cpack,
                          void* idx, void* rowval, void* part, void* stats,
                          void* stream) {
  const Plan p{tm, resident, tiles_per_block, wide, stages, xres,
               search_blocks};
  int blocks = 0;
  return launch_partials(x, c, mask, n, k, d, p, nt, acc_k, cpack, idx,
                         rowval, part, stats, (cudaStream_t)stream, &blocks);
}

// Pass 2 alone: out[e] = the sum over `blocks` partials of part[b * stride
// + e], in fused_masked_assign_update's order.
int fused_reduce_partials(const void* part, int blocks, int stride, void* out,
                          void* stream) {
  if (blocks < 1 || stride < 1) return (int)cudaErrorInvalidValue;
  return launch_reduce(part, blocks, stride, out, (cudaStream_t)stream);
}

// The one-job Lloyd step's sums for narrow rows: x (n, d) f32 and idx (n,)
// i32 labels in [0, k), contiguous on the current device; n >= 1, k <= 8
// and d <= 4 (lloyd_form).  part: blocks * (k*d + k + 1) f32 scratch.
// Writes out = [sums (k*d) | counts (k) | 0] f32 on `stream`, pass 2 as in
// fused_masked_assign_update.  Returns 0 or an error code for
// kernel_error_string; does not synchronise.
int lloyd_sums(const void* x, const void* idx, int n, int k, int d,
               int blocks, void* part, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int err = launch_lloyd(x, idx, n, k, d, blocks, part, s);
  if (err) return err;
  return launch_reduce(part, blocks, k * d + k + 1, out, s);
}

// The narrow-row sums' form: out = [threads a block, most centroids, most
// features], for the wrapper to hold its plain model and routing to.
void lloyd_form(int* out) {
  out[0] = kLloydThreads;
  out[1] = kLloydK;
  out[2] = kLloydD;
}

}  // extern "C"
