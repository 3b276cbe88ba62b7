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
// Contract: d2(i, j) = sum_f (x_i,f - x_j,f)^2 in feature order, every
// subtraction, product and sum rounded on its own (no fused multiply-add):
// the plain version's arithmetic (kernels/neighbor/ref.py), so both agree
// bit for bit.  A NaN d2 never counts (a point with a NaN or inf
// coordinate has degree 0 and reaches nothing).
//
// What bounds them on an H100: the pairs.  Degree compares n^2 pairs, the
// expansion n x |frontier|; the bytes (x read once, one result a point) are
// a few microseconds.  Done directly, a pair costs ~15 issued instructions
// on the CUDA cores at d = 4 (the first CUDA-core form of these kernels
// ran at two thirds of that issue limit).  Here the tensor cores compute a
// candidate d2 and the CUDA cores classify it: the degree with a
// saturating fma, one add for the row and one for the column, and a min a
// pair (items 3 and 6), the expansion with one min.  The classification is what bounds the degree
// now (PERF.md).  d2 is bit-symmetric ((a - b)^2 = (b - a)^2), so the
// degree visits each pair once (item 6) and adds it to both its points.
//
// 1. Candidate d2 - eps^2 on the tensor cores, the depth packed.  With the
//    TF32 split v = hi + lo (hi = cvt.rna.tf32(v), lo = cvt.rna.tf32(v -
//    hi)) and the row norms n = ||x||^2:
//      row i    (A): [xh_i, xh_i, xl_i | nh_i, nl_i, 1, 1, 0 ...]
//      column j (B): [-2 xh_j, -2 xl_j, -2 xh_j | 1, 1, mh_j, ml_j, 0 ...]
//    m_j = fl(n_j - eps^2); each segment d wide, 3 d + 4 terms padded to
//    ks = ceil((3 d + 4) / 8) k-steps of wgmma m64n64k8 TF32 (fp32
//    accumulation): two k-steps at d = 4.  Products of TF32 values are
//    exact, and the -2 and the ones are exact, so
//      c~_ij ~ n_i + n_j - eps^2 - 2 (xh.xh + xh.xl + xl.xh) ~ d2 - eps^2.
//
// 2. A window that certainly holds the exact value: |c~_ij - (d2_ij -
//    eps^2)| <= E, one per row and tile of 64 columns:
//      E = kappa(d) Q + 2^-100 (1 + r_i + R_J),   Q = (r_i + R_J)^2 + eps^2,
//      kappa(d) = (3 d + 27 + 18 ks) 2^-22,
//    r_i = sqrt(n_i), R_J the largest r over the tile's columns.
//    Derivation, u = 2^-24, r the real norms, Q' = (r_i + r_j)^2 + eps^2 <=
//    Q (first order), S = sum_f |x_i,f x_j,f| <= r_i r_j <= Q' / 2:
//    - the exact path's own rounding: d2 is a sum of d non-negative terms,
//      each from a rounded difference squared and rounded (3 u) and d - 1
//      rounded sums: |d2 - delta^2| <= (d + 2) u delta^2 <= (d + 2) u Q';
//    - the two norms (d products and sums, any order, rounded to fp32):
//      (d + 2) u Q' each;
//    - the split of n_i and of m_j (the residual v - hi - lo is at most
//      2^-22 |v| = 4 u |v|), and m_j's own rounding: 4 + 4 + 1 u Q';
//    - the cross terms: per feature, the dropped lo.lo product and the
//      split residuals of x_i and x_j are at most 3 2^-22 |x_i,f x_j,f|,
//      times the 2: 24 u S <= 12 u Q';
//    - the tensor cores' fp32 accumulation, modelled as in
//      assign_common.cuh (item 2): each k-step adds 8 exact products to the
//      accumulator, every addend aligned to the largest and cut to 24 bits,
//      the sum cut to fp32; every addend and every partial sum is at most
//      Q' (norms, |m_j|, 2 |x_i,f x_j,f|, and their sums), so a step errs by
//      less than 18 u Q': 18 ks u Q'.
//    In all (3 d + 27 + 18 ks) u Q'; kappa is four times that, which also
//    covers the second-order terms and the fp32 rounding of E and of the
//    comparisons.  Subnormals (flushed products, the split of a subnormal
//    coordinate, the exact path's subnormal results) err by at most
//    ~2^-134 d (r_i + r_j), inside the 2^-100 term.  ref.py models the
//    accumulation step by step on the CPU (candidate_scores, pair_window).
//    Guard: where Q is not below 2^100 (or is not finite: a NaN or inf
//    coordinate or eps, or a huge one) E = inf and every pair of that row
//    and tile is rechecked, the exact scan.  A column past the tile's
//    points is the pack's sentinel row (B = 2^100 at mh), so its c~ is
//    2^100 + n_i, far outside any finite window.
//
// 3. Classification and the exact recheck.  c~ < -E counts for certain;
//    c~ > E never counts; the rest (|c~| <= E, NaN included) is recomputed
//    in the exact arithmetic, feature by feature from x in device memory.
//    Degree: each thread counts its rows' certain pairs and tracks min |c~|
//    a row; only a row whose min is inside its window is scanned for
//    candidates.  The count goes through the FP32 pipe (classify_tri, an
//    FFMA.SAT and an add a pair): on the compare and integer path it cost
//    about twice as much.  Expansion: min c~ a row; below -E the row is
//    reached, inside the window its candidates are rechecked until one
//    holds; a reached row rechecks nothing more.
//    The rechecks and the pairs scored go to two scratch words
//    (kernels/neighbor/ops.py:rechecks).
//
// 4. Staging.  pack_points writes every point's A and B vectors once per
//    call (TF32 bit patterns, 8 ks floats each), its r, each 64-point
//    tile's largest r, and a sentinel row at index n; it also zeroes the
//    result.  A block (one warpgroup) owns R groups of 64 rows (kGroups =
//    2 at d <= 9) and a slice of the columns: its rows' boxes are
//    copied once into shared memory; the slice's column tiles stream
//    through a ring of kRing 32-float boxes (cp.async into the 128-byte
//    swizzled layout of assign_common.cuh, which wgmma reads for both
//    operands).  cp.async rather than TMA: the expansion's columns are
//    gathered points, not a box of the pack, and a tile is two 16-byte
//    copies a thread at d <= 4.  At d <= 9 the k-steps are a template argument (a branch
//    around a wgmma serialises every wgmma of the kernel) and group r + 1's
//    products are in flight while group r is classified.  Rows wider than
//    one box (d > 9) take R = 1 and stream each tile box by box, four
//    k-steps a box (zero-filled past the vector), the accumulators held
//    across the boxes (as search_tile_wide does).  Several blocks share a
//    row group when the plan splits the columns into slices (enough blocks
//    at n = 2048 too): the degree adds its partial counts with integer
//    atomics, the expansion stores 1 into the flags it reaches; both
//    results are zeroed first, so any order of blocks gives the same bits.
//
// 5. The expansion's frontier.  gather_frontier writes each slice's
//    frontier points to a list in device memory, in index order (a
//    block-wide scan), and the expansion streams only those columns:
//    n x |frontier| pairs.  A block whose rows are all reached stops.
//
// 6. The degree's triangle (degree_tri_kernel, d <= 9).  Row group b meets
//    only the column tiles from its own first row on; a pair adds to its
//    row and, off the diagonal, to its column (column sums reduced over
//    the block's rows per tile, integer atomics).  A block pairs row
//    groups k and RG - 1 - k so that every block has the same work.  Each
//    pair (d2 is bit-symmetric) is classified once: about half the pairs
//    of the full square at ~1.25 times the work a pair (the column adds
//    and their reduction).  Wide rows (d > 9) keep the full square in
//    neighbor_kernel, which the expansion needs at those widths anyway:
//    streaming the triangle's row and column boxes would add about 20
//    lines and a second loop shape to degree_tri_kernel, and take about
//    15 (the degree's counts, tile maxima and atomics) out of
//    neighbor_kernel.  No path runs the degree at d > 9 (the paper's
//    DBSCAN widths are 2 to 8); the card tests hold it at 64 and 226.
//
// 7. The cross entries (epsilon_degree_cross, expand_frontier_cross): rows
//    of one point set against the columns of another, the distributed
//    lane's ring step (core/distributed.py: each shard's rows against the
//    column shard it holds).  The rows' A vectors and the columns' B
//    vectors are packed by two pack_points calls, each with its own norms,
//    tile maxima and sentinel row; the rest is items 1-5 on the rectangle
//    (the triangle needs rows = columns).  d2 is computed as the plain
//    version sums it, so the counts summed over any split of the columns
//    (and the flags OR-ed) are epsilon_degree's and expand_frontier's bits.
//
// Forked from assign_common.cuh rather than shared: the packing (a
// threshold test needs the norms inside the product, the argmin search
// adds them afterwards), A from shared memory (the rows stay resident for
// many column tiles; the search reads A from registers once per tile).
// Shared: the swizzle, the TF32 conversion, the wgmma and barrier
// primitives, the cp.async helpers.
//
// Tried on the card and dropped (PERF.md): R = 1 or 4 at d <= 9, a 3-box
// ring, no register cap (three blocks an SM instead of four), the full
// square for the degree, the count as a compare and integer add, or as a
// subtract, a saturating multiply and an add.

#include <algorithm>

#include "assign_common.cuh"

namespace {

using namespace repro_assign;

constexpr int kTile = 64;                        // points of a row group / tile
constexpr int kBoxFloats = kTile * kBoxCols;     // one 8 KB box
constexpr int kRing = 2;                         // column boxes in flight
constexpr int kGather = 1024;                    // threads of a gather block
constexpr float kSentinel = 0x1p100f;

__host__ __device__ inline int pk_ksteps(int d) { return (3 * d + 4 + 7) / 8; }
__host__ __device__ inline int pk_floats(int d) { return 8 * pk_ksteps(d); }
__host__ __device__ inline int pk_boxes(int d) { return (pk_ksteps(d) + 3) / 4; }

constexpr int kSide = 4 * kTile;   // floats after the ring: stage norms or
                                   // the triangle's column sums
static_assert(kRing * kTile <= kSide, "stage norms overflow the side area");

__host__ __device__ inline size_t smem_bytes(int d, int groups) {
  return 1024 + (size_t)groups * pk_boxes(d) * kBoxFloats * 4 +
         (size_t)kRing * kBoxFloats * 4 + kSide * 4;
}

__device__ __forceinline__ float nanmax(float a, float b) {
  return (a != a || b != b) ? NAN : fmaxf(a, b);
}

// --- the pack ---------------------------------------------------------------

// One block of 128 threads per tile of 64 points; the block holding index n
// also writes the sentinel row (A zeros, B zeros but 2^100 at mh, r = 0).
// Also writes each tile's largest r (NaN if any is NaN: the degree's column
// tiles are these tiles) and zeroes the result (out_bytes a point) and the
// two stats words.  The norms are summed in any order (the window bounds
// any order).  A null apack, bpack, out or stats is skipped: the cross
// entries pack the rows' A vectors and the columns' B vectors in two calls
// (item 7).
__global__ void __launch_bounds__(kThreads)
pack_points(const float* __restrict__ x, int n, int d, float eps2,
            float* __restrict__ apack, float* __restrict__ bpack,
            float* __restrict__ rnorm, float* __restrict__ tmax,
            void* __restrict__ out, int out_bytes,
            unsigned long long* __restrict__ stats) {
  __shared__ float nrm[kTile];
  __shared__ float part[kThreads / 32];
  const int kd = pk_floats(d), p0 = blockIdx.x * kTile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  {
    const int pl = threadIdx.x >> 1, p = p0 + pl;
    float s = 0.f;
    if (p < n) {
      for (int f = threadIdx.x & 1; f < d; f += 2) {
        const float v = x[(size_t)p * d + f];
        s = fmaf(v, v, s);
      }
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    float r = p < n ? sqrtf(s) : 0.f;
    r = r != r ? NAN : r;
    if ((threadIdx.x & 1) == 0) nrm[pl] = s;
    if ((threadIdx.x & 1) == 0 && p <= n) rnorm[p] = r;
#pragma unroll
    for (int o = 16; o; o >>= 1) r = nanmax(r, __shfl_xor_sync(0xffffffffu, r, o));
    if (lane == 0) part[warp] = r;
    if (out && p < n && (threadIdx.x & 1) == 0) {
      if (out_bytes == 4) static_cast<int*>(out)[p] = 0;
      else static_cast<unsigned char*>(out)[p] = 0;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    tmax[blockIdx.x] = nanmax(nanmax(part[0], part[1]), nanmax(part[2], part[3]));
    if (blockIdx.x == 0 && stats) stats[0] = stats[1] = 0ull;
  }
  for (int e = threadIdx.x; e < kTile * kd; e += kThreads) {
    const int pl = e / kd, k = e - pl * kd, p = p0 + pl;
    if (p > n) break;
    float av = 0.f, bv = 0.f;
    if (p == n) {
      bv = (k == 3 * d + 2) ? kSentinel : 0.f;
    } else if (k < 3 * d) {
      const int s = k < d ? 0 : (k < 2 * d ? 1 : 2), f = k - s * d;
      const float v = x[(size_t)p * d + f];
      const float h = __uint_as_float(to_tf32(v));
      const float l = __uint_as_float(to_tf32(__fsub_rn(v, h)));
      av = s == 2 ? l : h;
      bv = -2.f * (s == 1 ? l : h);
    } else if (k < 3 * d + 4) {
      const int q = k - 3 * d;
      const float v = q < 2 ? nrm[pl] : __fsub_rn(nrm[pl], eps2);
      const float h = __uint_as_float(to_tf32(v));
      const float part_v = (q & 1) ? __uint_as_float(to_tf32(__fsub_rn(v, h)))
                                   : h;
      av = q < 2 ? part_v : 1.f;
      bv = q < 2 ? 1.f : part_v;
    }
    if (apack) apack[(size_t)p * kd + k] = av;
    if (bpack) bpack[(size_t)p * kd + k] = bv;
  }
}

// --- staging ------------------------------------------------------------------

// cp.async of box b of 64 packed points into dst (a 1024-byte aligned box),
// swizzled as wgmma reads them: chunks 8 b ... 8 b + cw - 1 of each row
// (CW = 2 KS at one box a point; 8 for wide rows, the chunks past the
// packed vector zero-filled, so every box takes four k-steps).  pt(jj) is
// the pack row of point jj (n: the sentinel).  Every thread calls it; the
// caller commits.
template <int CW, class Pt>
__device__ __forceinline__ void copy_box(float* dst, const float* pack, int kd,
                                         int b, Pt pt) {
#pragma unroll
  for (int e = threadIdx.x; e < kTile * CW; e += kThreads) {
    const int jj = e / CW, c = e % CW, k = 8 * b + c;
    const bool in = 4 * k < kd;
    cp_async16(smem_u32(dst + jj * kBoxCols + ((c ^ (jj & 7)) << 2)),
               pack + (in ? (size_t)pt(jj) * kd + 4 * k : 0), in ? 16 : 0);
  }
}

// Issue acc (+)= the KN k-steps of one A box and one B box (both in shared
// memory) as one wgmma group; every thread of the warpgroup calls it,
// converged.  acc belongs to the tensor cores until wgmma_wait says so.  KN
// is a template argument: a branch around a wgmma makes ptxas serialize
// every wgmma of the kernel.
template <int KN>
__device__ __forceinline__ void mma_issue(float (&acc)[4 * kMaxNT],
                                          uint32_t a_s, uint32_t b_s,
                                          bool accumulate) {
  __syncwarp();
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KN; ++kk) {
    wgmma_tf32_ss64(acc, smem_desc(a_s + 32 * kk), smem_desc(b_s + 32 * kk),
                    accumulate || kk > 0);
  }
  wgmma_commit();
}



// Wait until at most N wgmma groups are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// d2 of row i of xa and row j of xb, exactly as the plain version sums it.
__device__ __forceinline__ float exact_d2(const float* __restrict__ xa, int i,
                                          const float* __restrict__ xb, int j,
                                          int d) {
  const float* a = xa + (size_t)i * d;
  const float* b = xb + (size_t)j * d;
  float s = 0.f;
  for (int f = 0; f < d; ++f) {
    const float t = __fsub_rn(__ldg(a + f), __ldg(b + f));
    s = __fadd_rn(s, __fmul_rn(t, t));
  }
  return s;
}

// The frontier's points, slice by slice: block s writes the indices of the
// frontier flags in [s L, (s + 1) L) to list[s L ...] in index order (a
// block-wide scan) and their number to count[s].
__global__ void __launch_bounds__(kGather)
gather_frontier(const unsigned char* __restrict__ front, int n, int slice_len,
                int* __restrict__ list, int* __restrict__ count) {
  __shared__ int warp_sum[kGather / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = blockIdx.x * slice_len, c1 = min(n, c0 + slice_len);
  const int per = (c1 - c0 + kGather - 1) / kGather;
  const int j0 = c0 + threadIdx.x * per, j1 = min(c1, j0 + per);
  int mine = 0;
  for (int j = j0; j < j1; ++j) mine += front[j] != 0;
  int incl = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  int off = incl - mine, total = 0;
  for (int w = 0; w < kGather / 32; ++w) {
    if (w < warp) off += warp_sum[w];
    total += warp_sum[w];
  }
  int* out = list + c0;
  for (int j = j0; j < j1; ++j) {
    if (front[j]) out[off++] = j;
  }
  if (threadIdx.x == 0) count[blockIdx.x] = total;
}

// Rows are points 0 .. n - 1 of x, columns points 0 .. nc - 1 of xc; both
// are the same points except in the cross entries (item 7).
struct Args {
  const float* x;
  const float* xc;
  const float* apack;          // the rows' A vectors
  const float* bpack;          // the columns' B vectors
  const float* rnorm;          // the rows' r
  const float* rnorm_c;        // the columns' r
  const float* tmax;           // largest r of each 64-column tile
  const int* list;             // expansion: the frontier, slice by slice
  const int* count;            //   and how many points each slice holds
  int n, nc, d, slice_len, row_groups, slices;
  float eps2;
  int* deg;                    // degree
  unsigned char* reach;        // expansion
  unsigned long long* stats;   // rechecks, pairs scored
};

// The window of a thread's two rows (norms r0, r1) against a tile whose
// largest column norm is rj; -1 (no recheck, nothing certain) for a row
// that does not exist (bit h of valid clear).
__device__ __forceinline__ void row_windows(float r0, float r1, float rj,
                                            float eps2, float kappa,
                                            uint32_t valid, float (&e)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float s = (h ? r1 : r0) + rj;
    const float q = fmaf(s, s, eps2);
    const float w = fmaf(kappa, q, fmaf(0x1p-100f, s, 0x1p-100f));
    e[h] = ((valid >> h) & 1u) ? (q < kSentinel ? w : INFINITY) : -1.f;
  }
}

// One group's candidates against one column tile: the certain counts (the
// degree) or the reached rows (the expansion), and bit h of the result set
// where row h has candidates inside its window.  Four partial sums or
// minima a row keep the dependency chains short.
//
// The degree counts through the FP32 pipe, one FFMA.SAT a pair:
// sat(fma(c, -s, -E s)) with s = 2^(24 - e), 2^e <= E < 2^(e+1), is
// exactly 1 where c < -E and 0 elsewhere (NaN included).  -E s is exact
// (a power-of-two scale, in (-2^25, -2^24]); where c < -E the two differ
// by at least 2^(e-23), so the one rounding of the fma leaves at least 2
// (or +inf); where c >= -E it is at most 0 (or -inf); where E is inf,
// -E s is -inf and the result -inf or NaN, which saturates to 0.  For a
// row that exists 2^-100 <= E < 2^90, so s is a normal number.  Sums of
// ones stay exact in fp32 below 2^24 (the plan keeps a slice of columns
// below that).
//
// For the degree's triangle (TRI) every counted pair also adds to its
// column's sum colc[2 nt + q % 2]; in a band tile (BAND, the row group's
// own columns) only pairs with column j >= row i count for the row, j > i
// for the column (j < i is counted from the other side).  i0: row of
// h = 0; j0: column of nt = 0, q = 0 (both global).
template <bool EXPAND, bool TRI, bool BAND>
__device__ __forceinline__ uint32_t classify_tri(
    const float (&acc)[4 * kMaxNT], const float (&e)[2], float& k0,
    float& k1, uint32_t& hit, float (&colc)[2 * kMaxNT], int i0, int j0) {
  float m[2][4], c[2][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      m[h][p] = INFINITY;
      c[h][p] = 0.f;
    }
  }
  const float ne[2] = {-e[0], -e[1]};
  float sc[2], nes[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int be = (__float_as_int(e[h]) >> 23) & 0xff;   // biased exponent
    // a row that does not exist (e = -1) counts nothing
    sc[h] = e[h] < 0.f ? 0.f : __int_as_float((127 + 24 + 127 - be) << 23);
    nes[h] = ne[h] * sc[h];
  }
#pragma unroll
  for (int i = 0; i < 4 * kMaxNT; ++i) {
    const int h = (i >> 1) & 1, p = (i >> 2) & 3;
    if constexpr (EXPAND) {
      m[h][p] = fminf(m[h][p], acc[i]);
    } else {
      const float v = __saturatef(fmaf(acc[i], -sc[h], nes[h]));
      if constexpr (BAND) {
        const int j = j0 + 8 * (i >> 2) + (i & 1), ih = i0 + 8 * h;
        c[h][p] += j >= ih ? v : 0.f;
        colc[2 * (i >> 2) + (i & 1)] += j > ih ? v : 0.f;
        m[h][p] = fminf(m[h][p], j >= ih ? fabsf(acc[i]) : INFINITY);
      } else {
        c[h][p] += v;
        if constexpr (TRI) colc[2 * (i >> 2) + (i & 1)] += v;
        m[h][p] = fminf(m[h][p], fabsf(acc[i]));
      }
    }
  }
  uint32_t pend = 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float mh = fminf(fminf(m[h][0], m[h][1]), fminf(m[h][2], m[h][3]));
    if constexpr (EXPAND) {
      if ((hit >> h) & 1u) continue;
      if (mh < ne[h]) hit |= 1u << h;
      else if (!(mh > e[h])) pend |= 1u << h;
    } else {
      (h ? k1 : k0) += (c[h][0] + c[h][1]) + (c[h][2] + c[h][3]);
      if (!(mh > e[h])) pend |= 1u << h;
    }
  }
  return pend;
}

// classify_tri without the columns (the full square and the expansion).
template <bool EXPAND>
__device__ __forceinline__ uint32_t classify(const float (&acc)[4 * kMaxNT],
                                             const float (&e)[2], float& k0,
                                             float& k1, uint32_t& hit) {
  float colc[2 * kMaxNT];
  return classify_tri<EXPAND, false, false>(acc, e, k0, k1, hit, colc, 0, 0);
}

// Block (row group, slice): R groups of 64 rows against the columns of the
// slice (every point of it, or for the expansion its frontier points).
// Thread (warp w, lane 4 g + t) holds rows 64 r + 16 w + g + 8 h of each
// group r, columns 8 nt + 2 t + (q & 1) of each tile: acc[4 nt + q], h = q / 2.
// KS > 0: d <= 9, one box a point, KS k-steps; the next group's products
// are in flight while a group's candidates are classified.  KS = 0: wide
// rows (R = 1), every box four k-steps, accumulated across the tile's boxes.
template <int R, int KS, bool EXPAND>
__global__ void __launch_bounds__(kThreads, 4)
neighbor_kernel(const Args a) {
  extern __shared__ unsigned char smem_raw[];
  float* base = aligned_smem(smem_raw);
  const int n = a.n, d = a.d, ks = pk_ksteps(d);
  const int nb = KS > 0 ? 1 : pk_boxes(d);
  const int kd = pk_floats(d);
  float* a_s = base;                                  // R nb boxes
  float* ring = a_s + R * nb * kBoxFloats;            // kRing boxes
  float* rn_s = ring + kRing * kBoxFloats;            // kRing x 64 column r

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rg = blockIdx.x % a.row_groups, sl = blockIdx.x / a.row_groups;
  const int row0 = rg * kTile * R;
  const int nc = a.nc;
  const int c0 = sl * a.slice_len, c1 = min(nc, c0 + a.slice_len);
  const int ncols = EXPAND ? a.count[sl] : c1 - c0;
  if (ncols <= 0) return;
  const int* list = a.list + c0;
  auto col = [&](int k) -> int {
    if constexpr (EXPAND) return __ldg(list + k);
    return c0 + k;
  };
  const int tiles = (ncols + kTile - 1) / kTile, nbox = tiles * nb;
  const float eps2 = a.eps2;
  const float kappa = (float)(3 * d + 27 + 18 * ks) * 0x1p-22f;

  // the rows: every box of every group, one cp.async group
#pragma unroll
  for (int r = 0; r < R; ++r) {
    for (int b = 0; b < nb; ++b) {
      copy_box<KS ? 2 * KS : 8>(a_s + (r * nb + b) * kBoxFloats, a.apack,
                                kd, b, [&](int jj) {
                 const int i = row0 + kTile * r + jj;
                 return i < n ? i : n;
               });
    }
  }
  cp_async_commit();
  // box q of the column stream: tile q / nb, box q % nb; the expansion's
  // column norms come with a tile's last box
  auto issue = [&](int q) {
    const int tt = q / nb, b = q - tt * nb, st = q % kRing;
    auto pt = [&](int jj) {
      const int k = tt * kTile + jj;
      return k < ncols ? col(k) : nc;
    };
    copy_box<KS ? 2 * KS : 8>(ring + st * kBoxFloats, a.bpack, kd, b, pt);
    if (EXPAND && b == nb - 1 && tid < kTile) {
      cp_async4(smem_u32(rn_s + st * kTile + tid), a.rnorm_c + pt(tid), 4);
    }
  };
#pragma unroll
  for (int q = 0; q < kRing - 1; ++q) {
    if (q < nbox) issue(q);
    cp_async_commit();
  }

  float rr[R][2];
  uint32_t valid = 0;   // bit 2 r + h: the row exists
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = row0 + kTile * r + 16 * warp + g + 8 * h;
      rr[r][h] = i < n ? __ldg(a.rnorm + i) : 0.f;
      if (i < n) valid |= 1u << (2 * r + h);
    }
  }
  const int vrows = min(kTile * R, n - row0);
  float cnt[R][2];   // the degree's counts, exact in fp32 (below 2^24)
#pragma unroll
  for (int r = 0; r < R; ++r) cnt[r][0] = cnt[r][1] = 0.f;
  uint32_t hit = 0;     // expansion: bit 2 r + h, the row is reached
  unsigned long long rechecks = 0, pairs = 0;
  float acc[2][4 * kMaxNT];

  // the exact recheck of the candidates of group r's row h in this tile
  auto recheck = [&](int r, const float (&ac)[4 * kMaxNT], const float (&e)[2],
                     uint32_t rowpend, int tt, uint32_t colmask) {
    uint32_t pend = 0;
#pragma unroll
    for (int i = 0; i < 4 * kMaxNT; ++i) {
      const int h = (i >> 1) & 1;
      const float c = EXPAND ? ac[i] : fabsf(ac[i]);
      if (((rowpend >> h) & 1u) && !(c > e[h])) pend |= 1u << i;
    }
    pend &= colmask;
    // one loop over the candidates (an unrolled recheck per column would
    // not fit the instruction cache)
    while (pend) {
      const int bit = __ffs(pend) - 1;
      pend &= pend - 1;
      const int h = (bit >> 1) & 1;
      if (EXPAND && ((hit >> (2 * r + h)) & 1u)) continue;
      const int jj = 8 * (bit >> 2) + 2 * t + (bit & 1);
      const int i = row0 + kTile * r + 16 * warp + g + 8 * h;
      const bool in =
          exact_d2(a.x, i, a.xc, col(tt * kTile + jj), d) <= eps2;
      ++rechecks;
      if constexpr (EXPAND) {
        if (in) hit |= 1u << (2 * r + h);
      } else {
        if (h) cnt[r][1] += in ? 1.f : 0.f;
        else cnt[r][0] += in ? 1.f : 0.f;
      }
    }
  };

  // the degree's column-tile maxima, loaded a tile ahead
  float rj_next = EXPAND ? 0.f : __ldg(a.tmax + (c0 >> 6));
  for (int q = 0; q < nbox; ++q) {
    if (q + kRing - 1 < nbox) issue(q + kRing - 1);
    cp_async_commit();
    cp_async_wait<kRing - 1>();
    fence_proxy_async();   // the copies are read by wgmma (the async proxy)
    __syncthreads();
    const int tt = q / nb, b = q - tt * nb, st = q % kRing;
    const bool last = b == nb - 1;
    const uint32_t b_s = smem_u32(ring + st * kBoxFloats);
    const int vcols = min(kTile, ncols - tt * kTile);
    float rj;   // the tile's largest column norm (NaN wins)
    if constexpr (EXPAND) {
      rj = nanmax(rn_s[st * kTile + lane], rn_s[st * kTile + lane + 32]);
#pragma unroll
      for (int o = 16; o; o >>= 1) {
        rj = nanmax(rj, __shfl_xor_sync(0xffffffffu, rj, o));
      }
    } else {
      rj = rj_next;
      if (last && tt + 1 < tiles) rj_next = __ldg(a.tmax + (c0 >> 6) + tt + 1);
    }
    uint32_t colmask = 0xffffffffu;   // bit 4 nt + q: column 8 nt + 2 t + q % 2
    if (vcols < kTile) {
      colmask = 0;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        if (8 * (i >> 2) + 2 * t + (i & 1) < vcols) colmask |= 1u << i;
      }
    }
    if (last && tid == 0) pairs += (unsigned long long)vrows * vcols;
    if constexpr (KS > 0) {
      // R groups against the tile, group r + 1's products in flight while
      // group r is classified
      mma_issue<KS>(acc[0], smem_u32(a_s), b_s, false);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r + 1 < R) {
          mma_issue<KS>(acc[(r + 1) & 1],
                        smem_u32(a_s + (r + 1) * kBoxFloats), b_s, false);
          wgmma_wait<1>();
        } else {
          wgmma_wait<0>();
        }
        fence_regs(acc[r & 1]);
        float e[2];
        row_windows(rr[r][0], rr[r][1], rj, eps2, kappa, valid >> (2 * r), e);
        uint32_t hr = hit >> (2 * r);
        const uint32_t rowpend =
            classify<EXPAND>(acc[r & 1], e, cnt[r][0], cnt[r][1], hr);
        if constexpr (EXPAND) hit |= (hr & 3u) << (2 * r);
        if (__any_sync(0xffffffffu, rowpend != 0)) {
          recheck(r, acc[r & 1], e, rowpend, tt, colmask);
        }
      }
    } else {
      // wide rows (R = 1): the tile's boxes accumulate into acc[0]
      mma_issue<4>(acc[0], smem_u32(a_s + b * kBoxFloats), b_s, b > 0);
      wgmma_wait<0>();
      fence_regs(acc[0]);
      if (last) {
        float e[2];
        row_windows(rr[0][0], rr[0][1], rj, eps2, kappa, valid, e);
        uint32_t hr = hit;
        const uint32_t rowpend =
            classify<EXPAND>(acc[0], e, cnt[0][0], cnt[0][1], hr);
        if constexpr (EXPAND) hit |= hr & 3u;
        if (__any_sync(0xffffffffu, rowpend != 0)) {
          recheck(0, acc[0], e, rowpend, tt, colmask);
        }
      }
    }
    if constexpr (EXPAND) {
      if (last) {
        hit |= __shfl_xor_sync(0xffffffffu, hit, 1);
        hit |= __shfl_xor_sync(0xffffffffu, hit, 2);
        const uint32_t all = (1u << (2 * R)) - 1u;
        if (__syncthreads_and(((hit | ~valid) & all) == all)) break;
        continue;
      }
    }
    __syncthreads();   // every warp is done with box q's stage
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = row0 + kTile * r + 16 * warp + g + 8 * h;
      if constexpr (EXPAND) {
        if (t == 0 && i < n && ((hit >> (2 * r + h)) & 1u)) a.reach[i] = 1;
      } else {
        int c = (int)cnt[r][h];
        c += __shfl_xor_sync(0xffffffffu, c, 1);
        c += __shfl_xor_sync(0xffffffffu, c, 2);
        if (t == 0 && i < n) atomicAdd(a.deg + i, c);
      }
    }
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    rechecks += __shfl_xor_sync(0xffffffffu, rechecks, o);
  }
  if (lane == 0 && rechecks) atomicAdd(a.stats, rechecks);
  if (tid == 0 && pairs) atomicAdd(a.stats + 1, pairs);
}

// The degree at d <= 9 over the upper triangle: each pair (i, j), i <= j,
// once.  Row group b (rows 64 R b ...) meets the column tiles from its own
// first row on; a counted pair adds to row i and, when j > i, to column j.
// A block takes row groups k and RG - 1 - k, whose column ranges together
// are about one full range (so every block has the same work), cut into
// a.slices slices of column tiles ("units"); the block's rows are
// reloaded where its slice crosses from one group to the other.  Row
// counts are added per thread and flushed with integer atomics; column
// counts are summed over the block's rows per tile (lanes, then warps
// through shared memory) and added with integer atomics.
template <int R, int KS>
__global__ void __launch_bounds__(kThreads, 4)
degree_tri_kernel(const Args a) {
  extern __shared__ unsigned char smem_raw[];
  float* base = aligned_smem(smem_raw);
  const int n = a.n, d = a.d, kd = pk_floats(d);
  float* a_s = base;                          // R boxes
  float* ring = a_s + R * kBoxFloats;         // kRing boxes
  float* colsum = ring + kRing * kBoxFloats;  // 4 warps x 64 column sums

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rgs = a.row_groups, pairs_n = (rgs + 1) / 2;
  const int k = blockIdx.x % pairs_n, sl = blockIdx.x / pairs_n;
  const int tiles = (n + kTile - 1) / kTile;
  const int b1 = k, b2 = rgs - 1 - k;
  const int t1 = tiles - R * b1, t2 = b2 != b1 ? tiles - R * b2 : 0;
  const int units = t1 + t2;
  const int u0 = (int)((long long)units * sl / a.slices);
  const int u1 = (int)((long long)units * (sl + 1) / a.slices);
  if (u0 >= u1) return;
  // unit u: row group, column tile
  auto group_of = [&](int u) { return u < t1 ? b1 : b2; };
  auto tile_of = [&](int u) { return u < t1 ? R * b1 + u : R * b2 + u - t1; };
  const float eps2 = a.eps2;
  const float kappa =
      (float)(3 * d + 27 + 18 * pk_ksteps(d)) * 0x1p-22f;

  auto load_rows = [&](int b) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      copy_box<2 * KS>(a_s + r * kBoxFloats, a.apack, kd, 0, [&](int jj) {
        const int i = (b * R + r) * kTile + jj;
        return i < n ? i : n;
      });
    }
  };
  auto issue = [&](int u) {
    const int j0 = tile_of(u) * kTile;
    copy_box<2 * KS>(ring + ((u - u0) % kRing) * kBoxFloats, a.bpack, kd, 0,
                     [&](int jj) { return j0 + jj < n ? j0 + jj : n; });
  };

  int bcur = group_of(u0);
  load_rows(bcur);
  cp_async_commit();
#pragma unroll
  for (int q = 0; q < kRing - 1; ++q) {
    if (u0 + q < u1) issue(u0 + q);
    cp_async_commit();
  }

  float rr[R][2], cnt[R][2];
  uint32_t valid = 0;
  auto row_of = [&](int b, int r, int h) {
    return (b * R + r) * kTile + 16 * warp + g + 8 * h;
  };
  auto load_state = [&](int b) {
    valid = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = row_of(b, r, h);
        rr[r][h] = i < n ? __ldg(a.rnorm + i) : 0.f;
        if (i < n) valid |= 1u << (2 * r + h);
        cnt[r][h] = 0.f;
      }
    }
  };
  auto flush_rows = [&](int b) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int c = (int)cnt[r][h];
        c += __shfl_xor_sync(0xffffffffu, c, 1);
        c += __shfl_xor_sync(0xffffffffu, c, 2);
        const int i = row_of(b, r, h);
        if (t == 0 && i < n && c) atomicAdd(a.deg + i, c);
      }
    }
  };
  load_state(bcur);
  unsigned long long rechecks = 0, pairs = 0;
  float acc[2][4 * kMaxNT];
  float rj_next = __ldg(a.tmax + tile_of(u0));

  for (int u = u0; u < u1; ++u) {
    const int b = group_of(u), jt = tile_of(u);
    if (b != bcur) {   // the slice crosses into the other row group
      flush_rows(bcur);
      cp_async_wait<0>();
      __syncthreads();   // no warp reads the old rows any more
      load_rows(b);
      cp_async_commit();
      cp_async_wait<0>();
      bcur = b;
      load_state(b);
    }
    if (u + kRing - 1 < u1) issue(u + kRing - 1);
    cp_async_commit();
    cp_async_wait<kRing - 1>();
    fence_proxy_async();   // the copies are read by wgmma (the async proxy)
    __syncthreads();
    const uint32_t b_s = smem_u32(ring + ((u - u0) % kRing) * kBoxFloats);
    const int j0 = jt * kTile, vcols = min(kTile, n - j0);
    const int i0 = b * R * kTile;
    const float rj = rj_next;
    if (u + 1 < u1) rj_next = __ldg(a.tmax + tile_of(u + 1));
    uint32_t colmask = 0xffffffffu;   // bit 4 nt + q: column 8 nt + 2 t + q % 2
    if (vcols < kTile) {
      colmask = 0;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        if (8 * (i >> 2) + 2 * t + (i & 1) < vcols) colmask |= 1u << i;
      }
    }
    const bool band = jt < (b + 1) * R;   // the group's own columns
    if (tid == 0) pairs += (unsigned long long)min(kTile * R, n - i0) * vcols;
    float colc[2 * kMaxNT];
#pragma unroll
    for (int c = 0; c < 2 * kMaxNT; ++c) colc[c] = 0.f;
    mma_issue<KS>(acc[0], smem_u32(a_s), b_s, false);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r + 1 < R) {
        mma_issue<KS>(acc[(r + 1) & 1], smem_u32(a_s + (r + 1) * kBoxFloats),
                      b_s, false);
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
      fence_regs(acc[r & 1]);
      float e[2];
      row_windows(rr[r][0], rr[r][1], rj, eps2, kappa, valid >> (2 * r), e);
      uint32_t none = 0;
      const int ir = row_of(b, r, 0), jc = j0 + 2 * t;
      const uint32_t rowpend =
          band ? classify_tri<false, true, true>(acc[r & 1], e, cnt[r][0],
                                                 cnt[r][1], none, colc, ir, jc)
               : classify_tri<false, true, false>(acc[r & 1], e, cnt[r][0],
                                                  cnt[r][1], none, colc, ir,
                                                  jc);
      if (__any_sync(0xffffffffu, rowpend != 0)) {
        uint32_t pend = 0;
#pragma unroll
        for (int i = 0; i < 4 * kMaxNT; ++i) {
          const int h = (i >> 1) & 1;
          if (((rowpend >> h) & 1u) && !(fabsf(acc[r & 1][i]) > e[h])) {
            pend |= 1u << i;
          }
        }
        pend &= colmask;
        while (pend) {
          const int bit = __ffs(pend) - 1;
          pend &= pend - 1;
          const int h = (bit >> 1) & 1;
          const int i = ir + 8 * h, j = jc + 8 * (bit >> 2) + (bit & 1);
          if (j < i) continue;   // counted from the other side
          ++rechecks;
          if (exact_d2(a.x, i, a.x, j, d) <= eps2) {
            if (h) cnt[r][1] += 1.f;
            else cnt[r][0] += 1.f;
            if (j > i) atomicAdd(a.deg + j, 1);
          }
        }
      }
    }
    // the tile's column sums: over the lanes of a column (g), then warps
#pragma unroll
    for (int c = 0; c < 2 * kMaxNT; ++c) {
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        colc[c] += __shfl_xor_sync(0xffffffffu, colc[c], o);
      }
    }
    if (g == 0) {
#pragma unroll
      for (int c = 0; c < 2 * kMaxNT; ++c) {
        colsum[warp * kTile + 8 * (c >> 1) + 2 * t + (c & 1)] = colc[c];
      }
    }
    __syncthreads();   // every warp is done with the stage and its sums
    if (tid < kTile && tid < vcols) {
      const float sum = (colsum[tid] + colsum[kTile + tid]) +
                        (colsum[2 * kTile + tid] + colsum[3 * kTile + tid]);
      if (sum > 0.f) atomicAdd(a.deg + j0 + tid, (int)sum);
    }
  }
  cp_async_wait<0>();
  flush_rows(bcur);
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    rechecks += __shfl_xor_sync(0xffffffffu, rechecks, o);
  }
  if (lane == 0 && rechecks) atomicAdd(a.stats, rechecks);
  if (tid == 0 && pairs) atomicAdd(a.stats + 1, pairs);
}

using Kernel = void (*)(const Args);

// Rows a block holds: kGroups groups of 64 at d <= 9 (one box a point;
// 1 and 4 were slower on an H100, PERF.md), one group for wide rows.
constexpr int kGroups = 2;

// At d <= 9 the degree takes the triangle (the rectangle across two point
// sets), the expansion the rectangle; wide rows take the rectangle, box by
// box.
template <bool EXPAND>
Kernel kernel_for(int d, bool cross) {
  if (pk_boxes(d) > 1) return neighbor_kernel<1, 0, EXPAND>;
  const bool rect = EXPAND || cross;
  switch (pk_ksteps(d)) {
    case 1: return rect ? neighbor_kernel<kGroups, 1, EXPAND>
                        : degree_tri_kernel<kGroups, 1>;
    case 2: return rect ? neighbor_kernel<kGroups, 2, EXPAND>
                        : degree_tri_kernel<kGroups, 2>;
    case 3: return rect ? neighbor_kernel<kGroups, 3, EXPAND>
                        : degree_tri_kernel<kGroups, 3>;
    default: return rect ? neighbor_kernel<kGroups, 4, EXPAND>
                         : degree_tri_kernel<kGroups, 4>;
  }
}

__host__ __device__ inline int groups_for(int d) {
  return pk_boxes(d) > 1 ? 1 : kGroups;
}

// How a launch over n rows and nc columns of d features is cut (the
// wrappers read it through neighbor_plan).  Rows: groups_for(d) groups of
// 64 a block.  The degree over one point set (nc = n) at d <= 9 takes the
// triangle: a block pairs row groups k and RG - 1 - k, and their column
// tiles are cut into enough slices for kTargetBlocks blocks; a row then
// counts at most 64 columns a unit and under 2 n / slices in all, exact in
// fp32 below 2^24.  Otherwise the columns are cut into slices of a multiple
// of 64 points (below 2^24), enough for kTargetBlocks blocks, so that the
// grid fills the card at the service's small requests too.
constexpr int kTargetBlocks = 4 * 132;   // four per SM of an H100
constexpr long long kMaxSlice = 1 << 24;

struct NeighborPlan {
  int groups, row_groups, slices, slice_len, triangle, blocks;
};

inline int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

NeighborPlan plan_for(int n, int nc, int d, bool expand, bool cross) {
  NeighborPlan p;
  p.groups = groups_for(d);
  p.row_groups = cdiv(n, kTile * p.groups);
  p.triangle = !expand && !cross && pk_boxes(d) == 1;
  const int tiles = cdiv(nc, kTile);
  if (p.triangle) {
    const int pairs = (p.row_groups + 1) / 2;
    p.slices = std::min(std::max({1, cdiv(kTargetBlocks, pairs),
                                  cdiv(2LL * n, kMaxSlice)}),
                        tiles);
    p.slice_len = kTile;
    p.blocks = pairs * p.slices;
  } else {
    const int slices = std::max({1, cdiv(kTargetBlocks, p.row_groups),
                                 cdiv(nc, kMaxSlice)});
    p.slice_len = kTile * cdiv(cdiv(nc, std::min(slices, tiles)), kTile);
    p.slices = cdiv(nc, p.slice_len);
    p.blocks = p.row_groups * p.slices;
  }
  return p;
}

// The scratch of one call, in floats: the rows' pack and the columns' (one
// pack of both vectors when they are one point set), the rows' r (n + 1)
// and tile maxima (one per 64 points, the sentinel's tile included), the
// columns' (cross only), and for the expansion the frontier list (nc) and
// one count a slice.
size_t scratch_floats(int n, int nc, int d, bool expand, bool cross) {
  return (size_t)(n + 1) * pk_floats(d) + (size_t)(nc + 1) * pk_floats(d) +
         (n + 1) + (n + kTile) / kTile +
         (cross ? (size_t)(nc + 1) + (nc + kTile) / kTile : 0) +
         (expand ? (size_t)nc + plan_for(n, nc, d, true, cross).slices : 0);
}

// cross: rows x (n points) against columns xc (nc points), two packs;
// otherwise xc is x and nc is n, one pack.
int launch(bool expand, bool cross, const void* x, int n, const void* xc,
           int nc, const void* front, int d, float eps2, void* scratch,
           void* out, void* stats_out, void* stream) {
  if (n < 1 || nc < 1 || d < 1) return (int)cudaErrorInvalidValue;
  const NeighborPlan p = plan_for(n, nc, d, expand, cross);
  const Kernel kernel =
      expand ? kernel_for<true>(d, cross) : kernel_for<false>(d, cross);
  const size_t smem = smem_bytes(d, p.groups);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  unsigned long long* stats = (unsigned long long*)stats_out;
  float* apack = (float*)scratch;
  float* bpack = apack + (size_t)(n + 1) * pk_floats(d);
  float* rnorm = bpack + (size_t)(nc + 1) * pk_floats(d);
  float* tmax = rnorm + (n + 1);
  float* rnorm_c = cross ? tmax + (n + kTile) / kTile : rnorm;
  float* tmax_c = cross ? rnorm_c + (nc + 1) : tmax;
  int* list = reinterpret_cast<int*>(cross ? tmax_c + (nc + kTile) / kTile
                                           : tmax + (n + kTile) / kTile);
  int* count = list + nc;
  pack_points<<<(n + kTile) / kTile, kThreads, 0, s>>>(
      (const float*)x, n, d, eps2, apack, cross ? nullptr : bpack, rnorm,
      tmax, out, expand ? 1 : 4, stats);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (cross) {
    pack_points<<<(nc + kTile) / kTile, kThreads, 0, s>>>(
        (const float*)xc, nc, d, eps2, nullptr, bpack, rnorm_c, tmax_c,
        nullptr, 0, nullptr);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (expand) {
    gather_frontier<<<p.slices, kGather, 0, s>>>((const unsigned char*)front,
                                                 nc, p.slice_len, list, count);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const Args args{(const float*)x, (const float*)xc, apack, bpack, rnorm,
                  rnorm_c, tmax_c, list, count, n, nc, d, p.slice_len,
                  p.row_groups, p.slices, eps2,
                  expand ? nullptr : (int*)out,
                  expand ? (unsigned char*)out : nullptr, stats};
  kernel<<<p.blocks, kThreads, smem, s>>>(args);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one block needs (bytes) for feature width d.
size_t neighbor_smem_bytes(int d) { return smem_bytes(d, groups_for(d)); }

// The plan of one launch over n points (cross: n rows against nc columns):
// groups, row_groups, slices, slice_len, triangle (0 or 1) and blocks,
// written to out[0..5].
void neighbor_plan(int n, int nc, int d, int expand, int cross, int* out) {
  const NeighborPlan p = plan_for(n, cross ? nc : n, d, expand != 0,
                                  cross != 0);
  const int v[6] = {p.groups, p.row_groups, p.slices, p.slice_len,
                    p.triangle, p.blocks};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
}

// Floats of one call's scratch (packs, norms, tile maxima, the expansion's
// frontier lists), as neighbor_plan's arguments.
size_t neighbor_scratch_floats(int n, int nc, int d, int expand, int cross) {
  return scratch_floats(n, cross ? nc : n, d, expand != 0, cross != 0);
}

// x: (n, d) f32 contiguous, n >= 1; scratch: neighbor_scratch_floats f32,
// 16-byte aligned; stats: 2 u64 (rechecks, pairs scored).  The launch is
// cut as neighbor_plan says.  Writes deg (n,) i32 on `stream`.  Returns 0
// or an error code for kernel_error_string; does not synchronise.
int epsilon_degree(const void* x, int n, int d, float eps2, void* scratch,
                   void* deg, void* stats, void* stream) {
  return launch(false, false, x, n, x, n, nullptr, d, eps2, scratch, deg,
                stats, stream);
}

// As epsilon_degree, with front (n,) bool (one byte each, contiguous);
// writes reach (n,) bool.
int expand_frontier(const void* x, const void* front, int n, int d,
                    float eps2, void* scratch, void* reach, void* stats,
                    void* stream) {
  return launch(true, false, x, n, x, n, front, d, eps2, scratch, reach,
                stats, stream);
}

// The cross entries (item 7): rows xr (nr, d) against columns xc (nc, d),
// both f32 contiguous, nr, nc >= 1.  deg[i] = #{ j < nc : d2(xr_i, xc_j)
// <= eps^2 } (nr,) i32; reach[i] = any_j (front[j] and d2(xr_i, xc_j) <=
// eps^2) (nr,) bool, front (nc,) bool.  Scratch and plan as above with
// cross = 1.
int epsilon_degree_cross(const void* xr, int nr, const void* xc, int nc, int d,
                         float eps2, void* scratch, void* deg, void* stats,
                         void* stream) {
  return launch(false, true, xr, nr, xc, nc, nullptr, d, eps2, scratch, deg,
                stats, stream);
}

int expand_frontier_cross(const void* xr, int nr, const void* xc,
                          const void* front, int nc, int d, float eps2,
                          void* scratch, void* reach, void* stats,
                          void* stream) {
  return launch(true, true, xr, nr, xc, nc, front, d, eps2, scratch, reach,
                stats, stream);
}

}  // extern "C"
