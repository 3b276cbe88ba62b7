// Nearest-centroid search shared by the assignment kernel (distance.cu) and
// the fused masked Lloyd step (fused.cu), for Hopper (sm_90a).
//
// Contract: for every point x_i the index and the score of
//   s_ij = ||c_j||^2 - 2 x_i.c_j
// computed in fp32 in feature order with every product and sum rounded on
// its own (__fmul_rn / __fadd_rn, no fused multiply-add), the first minimum
// winning and a NaN score counting as the minimum (torch.argmin's rule).
// That is the plain twin's arithmetic (kernels/distance/ref.py), so index
// and score agree with it bit for bit.
//
// How it gets there without doing that arithmetic for every pair:
//
// 1. Candidate scores on the tensor cores.  v = hi + lo with
//    hi = cvt.rna.tf32(v), lo = cvt.rna.tf32(v - hi) (v - hi is exact), and
//    cross~ = x_lo.c_hi + x_hi.c_lo + x_hi.c_hi by wgmma m64nNk8 TF32 with
//    fp32 accumulation (the block's four warps are one warpgroup: 64 points
//    against a chunk of N = 8 nt centroids; x's fragments from registers,
//    the centroids' from shared memory); s~ = fl(cn - 2 cross~), cn the
//    exact norm.  Features are padded to a multiple of 8 with zeros, which
//    add zeros.
//
// 2. A window that certainly holds the exact score, |s~_ij - s_ij| <= E_i,
//    one per point and chunk of centroids:
//      E_i = alpha(d) ||x_i|| cmax + 2^-21 (cnmax + 2 ||x_i|| cmax)
//            + 2^-100 (||x_i|| + cmax + 1),
//      alpha(d) = (d + 64 ceil(d/8) + 12) 2^-21,
//    cmax = max_j ||c_j|| and cnmax = max_j cn_j over the chunk.
//    Derivation, with u = 2^-24 and S = sum_f |x_f c_f| <= ||x|| ||c||:
//    - the exact path's own rounding: |acc - x.c| <= d u S (d products and
//      d - 1 sums, each rounded once): d/8 2^-21 S;
//    - the split residuals: v - hi - lo is at most 2^-22 |v|, so dropping
//      it from x and from c costs at most 2 2^-22 S: 2^-21 S;
//    - the dropped lo.lo term: at most 2^-22 S;
//    - the tensor cores' fp32 accumulation, which is not round-to-nearest.
//      Products of TF32 values are exact.  Each of the 3 ceil(d/8) wgmma
//      k-steps adds 8 of them to the accumulator; modelled as every addend
//      aligned to the largest, 2^e <= M, and cut to 24 bits (each of the 8
//      others loses less than 2^(e-23) <= 2 u M), and the sum cut to fp32
//      (less than 2 u of it).  M and the sum are at most S (to first
//      order), so a step errs by less than 18 u S: in all 54 ceil(d/8) u S
//      = 6.75 ceil(d/8) 2^-21 S;
//    - the final fl(cn - 2 acc) on both sides: 2 |acc - cross~| + 2 u |s~|,
//      and |s~| <= cnmax + 2 ||x|| cmax (1 + 2^-9).
//    So |s~ - s| <= (d/4 + 3 + 13.5 ceil(d/8)) 2^-21 ||x|| ||c|| + 2^-23 |s~|
//    (to first order); alpha and 2^-21 are four times that and more, which
//    also covers the fp32 rounding of E and of the comparisons below.
//    ref.tf32x3_scores models this accumulation step by step on the CPU.
//    Underflow (subnormal products flushed by the tensor cores) errs by at
//    most 3 d 2^-126 (||x|| + ||c|| + 1), far inside the 2^-100 term.
//    A point whose ||x|| cmax is not below 2^100 (or not finite, which
//    covers inf and NaN in x or c) gets E = inf against the chunk: every
//    centroid of it is rechecked, the exact scan.
//
// 3. An exact recheck.  U_i = min_j (s~_ij + E_i) over the centroids seen
//    so far (NaN ignored) only shrinks as chunks go by; every j with
//    !(s~_ij > U_i + E_i) is a candidate (NaN included), and the true
//    minimum and every tie of it always are.  Each candidate's score is
//    recomputed in the exact arithmetic from x and c in shared memory and
//    the lexicographic min of (score, j) kept: the index and the score
//    bits of the plain scan.  A point keeps ~1 candidate at the main
//    path's shapes.
//
// 4. Staging.  A block owns a contiguous run of tiles of tm points; each
//    tile is staged once into a 2-stage ring, by TMA
//    (cp.async.bulk.tensor, 32-column boxes with the 128-byte swizzle) when
//    d is a multiple of 32 and x is 16-byte aligned, else by cp.async into
//    the same swizzled layout.  The swizzle makes the fragment loads, the
//    row reads of the recheck and the accumulation free of bank conflicts.
//    Centroids are packed once per call by pack_centroids (TF32 hi and lo
//    images in the same swizzled K-major layout, which wgmma reads; exact
//    rows, cn, window terms; one chunk per 8 nt centroids) and staged into
//    shared memory once per block, or chunk by chunk per tile when they do
//    not fit.  The search reads x from device memory once per tile; the
//    fused step reads it again for each further range of sums (fused.cu).
//
// 5. Wide rows (more than 96 features: kernels/distance/ops.py:plan
//    chooses), search_wide_kernel.  What bounds it on an H100 is the
//    tensor cores: three TF32 products of 2 n k d operations at 495
//    TFLOP/s (51.6 ms at the pod-scale cell's 2-shard shard, n 2^23, d 128,
//    k 4,096), with x read once (n d 4 bytes).  What held the first wide
//    form back (PERF.md's split of it): exact rechecks that read x and c
//    feature by feature from device memory after every chunk (72% of the
//    pod-scale shard's 6.5 s, 82% of the embedding fit's 0.60 ms); one
//    128-thread block of 64 points per tile, on 31 of 132 SMs at the
//    pod-scale shape; a block barrier and a drained pipe every 32
//    features, x's A fragments rebuilt for every chunk of 64 centroids.
//    What this one does about it:
//    - a persistent grid of one block an SM (plan.search_blocks), each
//      walking tiles of kWideRows = 128 points, apart from the fused
//      step's partial-sum blocks;
//    - two consumer warpgroups of 64 points share every box of the
//      centroids' hi and lo images, which one producer warp streams by
//      bulk copies (TMA) through a ring of `stages` box steps on
//      mbarriers: no block barrier, the next boxes in flight while a
//      warpgroup multiplies or picks;
//    - x's tile stays in shared memory across all the chunks (xres: where
//      there are several and it fits, d <= 192), loaded once a tile by a
//      TMA tensor map (or cp.async) and turned once into its TF32 hi and
//      lo images, so both operands come from shared memory (wgmma SS) and
//      a box step is twelve wgmma and no other work; else x's box rides
//      in each ring stage and its A fragments come from registers;
//    - the exact rechecks are deferred to the end of the tile
//      (WideRowState: about one a point at k = 4,096, not ~4.8), dealt
//      over each warp's 32 lanes, and read x and c from device memory 16
//      features at a time.
//    For k <= 8 (one 8-column chunk, the embedding fit's k = 4) the exact
//    form, exact_wide_kernel, scores every pair exactly instead, one lane a
//    (point, centroid) pair: the plain scan's arithmetic, so its index and
//    score bits by construction, with no window and no recheck.  Its
//    bytes (x read once) would take 2.5 us at the embedding fit's shape;
//    what bounds it there is each lane's chain of d dependent adds behind
//    its loads: 54 us of device time a call on an H100, where the TF32
//    form's 8 blocks of 128 points take 165 us (PERF.md).
//    Tried and dropped (PERF.md): clusters of two blocks sharing each box
//    by TMA multicast (the centroids' L2 reads halved; 25% slower, the two
//    blocks held in step); a recheck keeping its next loads in flight.
//
// Variants of the staged search (items 1-4) tried on the card and
// dropped, none faster (PERF.md): both groups' wgmma in flight at once (64
// more registers a thread),
// candidates dealt evenly over a quad's lanes, the norms computed under
// the products.  What holds the kernels back is each warp's instruction
// stream per point (A fragments, window, recheck, norm), not the tensor
// cores or the bytes.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <stdio.h>

namespace repro_assign {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 2;     // x ring depth
constexpr int kBoxCols = 32;   // floats of one 128-byte swizzled box row
constexpr int kMaxNT = 8;      // n-tiles of 8 centroids in a chunk
constexpr int kMaxMT = 2;      // 16-row m-tiles a warp holds (tm <= 128)
constexpr float kRel = 0x1p-21f;
constexpr float kAbs = 0x1p-100f;
constexpr float kGuard = 0x1p100f;
// C entry error codes past CUDA's: cuTensorMapEncodeTiled missing / failed
constexpr int kErrNoEncode = 10000;
constexpr int kErrEncode = 10001;

// --- layout, shared by host and device ------------------------------------

__host__ __device__ inline int ksteps(int d) { return (d + 7) / 8; }
__host__ __device__ inline int boxes(int d) {
  return (8 * ksteps(d) + kBoxCols - 1) / kBoxCols;
}
__host__ __device__ inline int row_stride(int d) { return 8 * ksteps(d) + 4; }
// floats of one TF32 image of 8 nt centroids ([box][8 nt rows][32
// swizzled], the layout the tensor cores read)
__host__ __device__ inline int image_floats(int d, int nt) {
  return boxes(d) * 8 * nt * kBoxCols;
}
// floats of one packed chunk of 8 nt centroids (nt = 1, 2, 4 or 8): the
// TF32 hi and lo images, exact rows [8 nt][row_stride], cn (+inf past k),
// and a trailer: max ||c||, max cn, and the window's K1, K0 for the chunk;
// rounded up to 1024 bytes, so every image starts on a swizzle atom
__host__ __device__ inline int chunk_floats(int d, int nt) {
  const int kc = 8 * nt;
  const int f = 2 * image_floats(d, nt) + kc * row_stride(d) + kc + 4;
  return (f + 255) & ~255;
}
__host__ __device__ inline size_t stage_bytes(int d, int tm) {
  return (size_t)boxes(d) * tm * 128;
}
// ring + chunk slots, before a kernel's own arrays (1024 bytes of slack
// align the ring for the swizzle)
__host__ __device__ inline size_t search_smem_bytes(int d, int tm, int nt,
                                                    int slots) {
  return 1024 + kStages * stage_bytes(d, tm) +
         (size_t)slots * chunk_floats(d, nt) * sizeof(float);
}

// Wide rows: search_wide_kernel (the TF32 form) and exact_wide_kernel.
constexpr int kWideTM = 64;        // the fused step's sums: rows of a tile
constexpr int kWideWG = 2;         // consumer warpgroups of 64 points
constexpr int kWideRows = 64 * kWideWG;               // points of a tile
constexpr int kWideThreads = kThreads * kWideWG + 32;  // + a producer warp
constexpr int kExactK = 8;         // k <= 8: the exact form
constexpr int kExactThreads = 64;
// floats of one ring stage: x's box (unless x's tile is resident) and the
// chunk's hi and lo boxes, each a whole number of swizzle atoms
__host__ __device__ inline int wide_stage_floats(int nt, int xres) {
  return (xres ? 0 : kWideRows * kBoxCols) + 16 * nt * kBoxCols;
}
// alignment slack, x's resident tile as TF32 hi and lo images, the ring,
// the mbarriers (full and empty a stage, x full and x empty), and each
// tile row's best key and recheck count; 0 for the exact form
__host__ __device__ inline size_t wide_smem_bytes(int d, int nt, int stages,
                                                  int xres) {
  if (stages == 0) return 0;
  return 1024 + (xres ? 2 * (size_t)boxes(d) * kWideRows * 128 : 0) +
         (size_t)stages * wide_stage_floats(nt, xres) * sizeof(float) +
         (2 * (size_t)stages + 2) * sizeof(uint64_t) + kWideRows * 12;
}
__host__ __device__ inline float window_alpha(int d) {
  return (float)(d + 64 * ksteps(d) + 12) * 0x1p-21f;
}

// How a search is launched (kernels/distance/ops.py:plan chooses it).
struct Plan {
  int tm;               // points per tile, a multiple of 16, <= 128 (wide
                        // rows: kWideTM, the fused step's sums)
  int resident;         // every chunk stays in shared memory
  int tiles_per_block;  // (wide rows: of the fused step's sums)
  int wide;             // d > WIDE_D: search_wide_kernel / exact_wide_kernel
  int stages;           // wide rows: the TF32 form's ring; 0: the exact form
  int xres;             // wide rows: x's tile stays in shared memory
  int search_blocks;    // wide rows: the search's grid (ops.search_grid)
};

// 0, or cudaErrorInvalidValue for a plan the kernels cannot run.
inline int check_plan(const Plan& p, int nt, int k) {
  const bool ok =
      p.tm >= 16 && p.tm <= 128 && p.tm % 16 == 0 &&
      (nt == 1 || nt == 2 || nt == 4 || nt == 8) && p.tiles_per_block >= 1 &&
      (!p.wide || (p.tm == kWideTM && !p.resident && p.search_blocks >= 1 &&
                   (p.stages >= 2 || (p.stages == 0 && !p.xres &&
                                      k <= kExactK))));
  return ok ? 0 : (int)cudaErrorInvalidValue;
}

// Offset (floats) of point r, feature f in a staged tile of tm rows.
__device__ __forceinline__ int swz(int r, int f, int tm) {
  return (f >> 5) * tm * kBoxCols + r * kBoxCols +
         ((((f >> 2) & 7) ^ (r & 7)) << 2) + (f & 3);
}

// --- primitives -----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The dynamic shared memory, rounded up to 1024 bytes (the swizzle atom).
// Pointer arithmetic on the __shared__ array keeps the compiler's view of
// the address space, so loads from it are shared-memory loads.
__device__ __forceinline__ float* aligned_smem(unsigned char* raw) {
  return reinterpret_cast<float*>(raw +
                                  ((1024 - (smem_u32(raw) & 1023)) & 1023));
}


__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One {32 columns, rows} box of a 2-D fp32 map at (col, row).
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row)
      : "memory");
}

// bytes (a multiple of 16) global -> shared by the bulk copy engine, both
// 16-byte aligned, completing on the mbarrier's transaction count.
__device__ __forceinline__ void bulk_load(uint32_t dst, const float* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// The mbarrier's phase also waits for this thread's cp.async copies so far
// (its pending count is raised by one now and lowered when they land).
__device__ __forceinline__ void cp_async_mbar_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];" ::"r"(bar)
               : "memory");
}

// 16 bytes global -> shared (both 16-byte aligned); src_bytes 0 writes
// zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 4 bytes global -> shared; src_bytes 0 writes a zero.
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// Orders this thread's generic writes to shared memory before the async
// proxy's reads of it (wgmma's B operands); a barrier follows.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// v -> its TF32 hi (cvt.rna) in place, and lo = tf32(v - hi).
__device__ __forceinline__ void split_tf32(float& v, float& lo) {
  const float hi = __uint_as_float(to_tf32(v));
  lo = __uint_as_float(to_tf32(__fsub_rn(v, hi)));
  v = hi;
}

// A barrier over the wide search's consumer warpgroups alone (named
// barrier 1; the producer warp never waits on it).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kThreads * kWideWG) : "memory");
}

// --- wgmma -------------------------------------------------------------------

// Shared-memory matrix descriptor, K-major, 128-byte swizzle: SBO = 1024
// bytes between 8-row groups, LBO unused; bases are 1024-byte aligned.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keep the compiler from moving reads or writes of registers the tensor
// cores own across the asynchronous window (fence ... wait).
template <int N, class T>
__device__ __forceinline__ void fence_regs(T (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D (64 x 8 nt, fp32) (+)= A (64 x 8, TF32 in registers: each warp's 16
// rows in the m16n8k8 layout) . B (8 nt x 8, shared, K-major)^T; scale_d 0
// overwrites D.  D's register 4 i + q holds row 16 warp + lane / 4 + 8 (q /
// 2), column 8 i + 2 (lane % 4) + q % 2.
template <int NT>
__device__ __forceinline__ void wgmma_tf32(float (&d)[4 * kMaxNT],
                                         const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  if constexpr (NT == 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d));
  } else if constexpr (NT == 2) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, "
        "1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d));
  } else if constexpr (NT == 4) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, "
        "1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d));
  }
}

// As wgmma_tf32, with A (64 x 8, TF32) in shared memory too (descriptor
// da, K-major, 128-byte swizzle, as smem_desc).
template <int NT>
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[4 * kMaxNT],
                                            uint64_t da, uint64_t db,
                                            int scale_d) {
  if constexpr (NT == 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3}, %4, %5, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(da), "l"(db), "r"(scale_d));
  } else if constexpr (NT == 2) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(scale_d));
  } else if constexpr (NT == 4) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15}, %16, %17, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(scale_d));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
  }
}

// D (64 x 64, fp32) (+)= A (64 x 8) . B (64 x 8)^T, both TF32 in shared
// memory, K-major, 128-byte swizzle (descriptors as smem_desc); D's layout
// as for wgmma_tf32<8>.  The neighbour kernels (neighbor.cu) keep their
// rows in shared memory, where the search above holds A in registers.
__device__ __forceinline__ void wgmma_tf32_ss64(float (&d)[4 * kMaxNT],
                                                uint64_t da, uint64_t db,
                                                int scale_d) {
  wgmma_tf32_ss<8>(d, da, db, scale_d);
}

// (s, j) comes before (bs, bj): NaN first, then the smaller score, then
// the smaller index.
__device__ __forceinline__ bool precedes(float s, int j, float bs, int bj) {
  const bool sn = s != s, bn = bs != bs;
  if (sn || bn) return sn && (!bn || j < bj);
  return s < bs || (s == bs && j < bj);
}

// acc += a . b over 4 features, each product and sum rounded on its own.
__device__ __forceinline__ float dot4(float acc, float4 a, float4 b) {
  acc = __fadd_rn(acc, __fmul_rn(a.x, b.x));
  acc = __fadd_rn(acc, __fmul_rn(a.y, b.y));
  acc = __fadd_rn(acc, __fmul_rn(a.z, b.z));
  return __fadd_rn(acc, __fmul_rn(a.w, b.w));
}

// Features 8 ks ... 8 ks + 7 of staged point r, as two float4 (swz spelt
// out: 16-byte chunks 2 (ks % 4) and 2 (ks % 4) + 1 of the row, XOR r % 8).
__device__ __forceinline__ void staged_8(const float* stage, int r, int tm,
                                         int ks, float4& a, float4& b) {
  const float* row = stage + (ks >> 2) * tm * kBoxCols + r * kBoxCols;
  const int c = 2 * (ks & 3), x = r & 7;
  a = *reinterpret_cast<const float4*>(row + ((c ^ x) << 2));
  b = *reinterpret_cast<const float4*>(row + (((c + 1) ^ x) << 2));
}

// The exact score of staged point r against the packed exact row crow, in
// feature order.  The loops run to 8 ceil(d/8): the padding is +0 in both,
// and adding +0 leaves the sum's bits as they are (it is never -0).
__device__ __forceinline__ float exact_score(const float* stage, int r,
                                             int tm, const float* crow,
                                             float cn, int ks_n) {
  float acc = 0.f;
#pragma unroll 2
  for (int ks = 0; ks < ks_n; ++ks) {
    float4 x0, x1;
    staged_8(stage, r, tm, ks, x0, x1);
    const float4 c0 = *reinterpret_cast<const float4*>(crow + 8 * ks);
    const float4 c1 = *reinterpret_cast<const float4*>(crow + 8 * ks + 4);
    acc = dot4(dot4(acc, x0, c0), x1, c1);
  }
  return __fsub_rn(cn, __fmul_rn(2.f, acc));
}

// ||x_r||^2 in feature order (padding as above).
__device__ __forceinline__ float staged_norm(const float* stage, int r, int tm,
                                             int ks_n) {
  float s = 0.f;
#pragma unroll 2
  for (int ks = 0; ks < ks_n; ++ks) {
    float4 x0, x1;
    staged_8(stage, r, tm, ks, x0, x1);
    s = dot4(dot4(s, x0, x0), x1, x1);
  }
  return s;
}

// --- packing the centroids (one block per chunk) ---------------------------

__global__ void __launch_bounds__(256)
pack_centroids(const float* __restrict__ c, int k, int d, int nt,
               float* __restrict__ cpack,
               unsigned long long* __restrict__ stats) {
  const int kc = 8 * nt, dc = row_stride(d), img = image_floats(d, nt);
  const int base = blockIdx.x * kc;
  float* hi = cpack + (size_t)blockIdx.x * chunk_floats(d, nt);
  float* lo = hi + img;
  float* rows = lo + img;
  float* cn = rows + kc * dc;
  float* trailer = cn + kc;
  auto at = [&](int j, int f) {
    return (j < k && f < d) ? c[(size_t)j * d + f] : 0.f;
  };
  for (int e = threadIdx.x; e < img; e += blockDim.x) {
    const int f = e % kBoxCols + kBoxCols * (e / (kc * kBoxCols));
    const int j = (e / kBoxCols) % kc;
    const float v = at(base + j, f);
    const uint32_t h = to_tf32(v);
    const int o = swz(j, f, kc);
    hi[o] = __uint_as_float(h);
    lo[o] = __uint_as_float(to_tf32(__fsub_rn(v, __uint_as_float(h))));
  }
  for (int e = threadIdx.x; e < kc * dc; e += blockDim.x) {
    rows[e] = at(base + e / dc, e % dc);
  }
  for (int jj = threadIdx.x; jj < kc; jj += blockDim.x) {
    float s = base + jj < k ? 0.f : INFINITY;  // past k: never the minimum
    for (int f = 0; f < d && base + jj < k; ++f) {
      const float v = c[(size_t)(base + jj) * d + f];
      s = __fadd_rn(s, __fmul_rn(v, v));
    }
    cn[jj] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float cnmax = 0.f;  // NaN if any norm is NaN
    for (int jj = 0; jj < kc && base + jj < k; ++jj) {
      cnmax = (cn[jj] != cn[jj] || cnmax != cnmax) ? NAN : fmaxf(cnmax, cn[jj]);
    }
    const float cmax = sqrtf(cnmax);
    trailer[0] = cmax;
    trailer[1] = cnmax;
    // E_i = K1 ||x_i|| + K0 (see the top of this file)
    trailer[2] = fmaf(window_alpha(d) + 2.f * kRel, cmax, kAbs);
    trailer[3] = fmaf(kRel, cnmax, fmaf(kAbs, cmax, kAbs));
    if (blockIdx.x == 0 && stats != nullptr) stats[0] = stats[1] = 0ull;
  }
}

// --- the x ring ------------------------------------------------------------

struct Ring {
  const CUtensorMap* map;  // used when tma
  const float* x;
  int n, d, tm, tma;
  int tile0, ntiles;       // the block's tiles
  float* stage0;           // kStages stages, 1024-byte aligned
  uint64_t* bars;          // kStages mbarriers

  __device__ float* stage(int q) const {
    return stage0 + (size_t)(q % kStages) * (stage_bytes(d, tm) / 4);
  }
  __device__ void init() const {
    if (tma && threadIdx.x == 0) {
      for (int s = 0; s < kStages; ++s) mbar_init(smem_u32(bars + s), 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
  }
  // Start loading the q-th tile of the sequence (tiles repeat per range).
  // Every thread calls it; cp.async commits one group per call.
  __device__ void issue(int q) const {
    const int row0 = (tile0 + q % ntiles) * tm;
    float* dst = stage(q);
    if (tma) {
      if (threadIdx.x == 0) {
        const uint32_t bar = smem_u32(bars + q % kStages);
        mbar_expect_tx(bar, (uint32_t)stage_bytes(d, tm));
        for (int b = 0; b < boxes(d); ++b) {
          tma_load_2d(smem_u32(dst + b * tm * kBoxCols), map, bar,
                      b * kBoxCols, row0);
        }
      }
    } else {
      const int dk = 8 * ksteps(d);
      for (int e = threadIdx.x; e < tm * dk; e += blockDim.x) {
        const int r = e / dk, f = e - r * dk;
        const bool in = row0 + r < n && f < d;
        cp_async4(smem_u32(dst + swz(r, f, tm)),
                  in ? x + (size_t)(row0 + r) * d + f : x, in ? 4 : 0);
      }
    }
  }
  __device__ void commit() const {
    if (!tma) cp_async_commit();
  }
  // Wait for the q-th tile; with cp.async the block synchronises too.
  __device__ void wait(int q) const {
    if (tma) {
      mbar_wait(smem_u32(bars + q % kStages), (q / kStages) & 1);
    } else {
      cp_async_wait<kStages - 1>();
      __syncthreads();
    }
  }
};

// --- the search over one staged tile ----------------------------------------

struct Centroids {
  const float* cpack;  // device: every chunk, packed
  float* slots;        // shared: every chunk (resident) or one
  int k, d, nt, resident;
};

// Exact rechecks a thread has counted (its points' sum and the most for
// one point), added to the stats words once a warp, at the end of the
// kernel (every thread calls flush).
struct Rechecks {
  unsigned long long total = 0, most = 0;

  __device__ void flush(unsigned long long* stats) const {
    unsigned long long t = total, m = most;
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      t += __shfl_xor_sync(0xffffffffu, t, o);
      m = max(m, __shfl_xor_sync(0xffffffffu, m, o));
    }
    if ((threadIdx.x & 31) == 0 && t) {
      atomicAdd(stats, t);
      atomicMax(stats + 1, m);
    }
  }
};

// Copies chunk ch of the packed centroids into shared memory at dst.
// Every thread calls it; a barrier must follow before the chunk is read.
__device__ __forceinline__ void stage_chunk(const Centroids& cs, int ch,
                                            float* dst) {
  const int cf = chunk_floats(cs.d, cs.nt);
  const float4* src =
      reinterpret_cast<const float4*>(cs.cpack + (size_t)ch * cf);
  for (int e = threadIdx.x; e < cf / 4; e += blockDim.x) {
    reinterpret_cast<float4*>(dst)[e] = src[e];
  }
  fence_proxy_async();
}

// This thread's columns of chunk ch that exist: bit 4 nt + 2 h + e for
// column 8 nt + 2 t + e (rows h of the m16n8 fragment share them).
template <int NT>
__device__ __forceinline__ uint32_t live_columns(int cbase, int k, int t) {
  if (cbase + 8 * NT <= k) return 0xffffffffu;
  uint32_t live = 0;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (cbase + nt * 8 + 2 * t + (q & 1) < k) live |= 1u << (nt * 4 + q);
    }
  }
  return live;
}

// The two rows (h = 0, 1) of one m16 fragment that a thread holds, and
// what it knows of them across chunks.
struct RowState {
  float xn[2], xnorm[2], upper[2], bs[2];
  int bj[2], cands[2];

  __device__ void init(float n0, float n1) {
    xn[0] = n0;
    xn[1] = n1;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      xnorm[h] = sqrtf(xn[h]);
      upper[h] = INFINITY;
      bs[h] = INFINITY;
      bj[h] = 0x7fffffff;
      cands[h] = 0;
    }
  }

  // After the products of the fragment against a chunk (acc = cross~):
  // s~ = cn - 2 cross~ in place, the rows' window E (inf: full recheck),
  // upper = min over the centroids seen of (s~ + E), candidates the s~
  // with s~ - E <= upper (NaN included), and the exact recheck of each,
  // in index order, by exact(h, jj) for chunk column jj.
  template <int NT, class Exact>
  __device__ __forceinline__ void pick(float (&acc)[4 * kMaxNT],
                                       const float* cn, float4 win,
                                       uint32_t live, int cbase, int t,
                                       Exact exact) {
    float lo[2] = {INFINITY, INFINITY}, e[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      e[h] = (xnorm[h] * win.x < kGuard) ? fmaf(xnorm[h], win.z, win.w)
                                         : INFINITY;
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float2 cn2 =
          *reinterpret_cast<const float2*>(cn + nt * 8 + 2 * t);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float& a = acc[4 * nt + q];
        a = fmaf(-2.f, a, (q & 1) ? cn2.y : cn2.x);
        lo[q >> 1] = fminf(lo[q >> 1], a);
      }
    }
    float cut[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      lo[h] = fminf(lo[h], __shfl_xor_sync(0xffffffffu, lo[h], 1));
      lo[h] = fminf(lo[h], __shfl_xor_sync(0xffffffffu, lo[h], 2));
      upper[h] = fminf(upper[h], lo[h] + e[h]);
      cut[h] = upper[h] + e[h];
    }
    uint32_t pending = 0;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (!(acc[4 * nt + q] > cut[q >> 1])) pending |= 1u << (nt * 4 + q);
      }
    }
    pending &= live;
    // one loop over the candidates (an unrolled recheck per column would
    // not fit the instruction cache)
    while (pending) {
      const int b = __ffs(pending) - 1;
      pending &= pending - 1;
      const int h = (b >> 1) & 1, jj = (b >> 2) * 8 + 2 * t + (b & 1);
      const float sc = exact(h, jj);
      if (h) {
        if (precedes(sc, cbase + jj, bs[1], bj[1])) {
          bs[1] = sc;
          bj[1] = cbase + jj;
        }
        ++cands[1];
      } else {
        if (precedes(sc, cbase + jj, bs[0], bj[0])) {
          bs[0] = sc;
          bj[0] = cbase + jj;
        }
        ++cands[0];
      }
    }
  }

  // The quad's four columns -> one winner per row; the quad's lane t = 0
  // emits row r0 + h 8 (if below valid_rows) and counts its rechecks.
  template <class Emit>
  __device__ __forceinline__ void finish(int r0, int valid_rows, int t,
                                         Rechecks* rc, Emit& emit) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        const float os = __shfl_xor_sync(0xffffffffu, bs[h], o);
        const int oj = __shfl_xor_sync(0xffffffffu, bj[h], o);
        cands[h] += __shfl_xor_sync(0xffffffffu, cands[h], o);
        if (precedes(os, oj, bs[h], bj[h])) {
          bs[h] = os;
          bj[h] = oj;
        }
      }
      const int r = r0 + 8 * h;
      if (t == 0 && r < valid_rows) {
        emit(r, bj[h], bs[h], xn[h]);
        if (rc != nullptr) {
          rc->total += (unsigned long long)cands[h];
          rc->most = max(rc->most, (unsigned long long)cands[h]);
        }
      }
    }
  }
};

// A warp's A fragments of one k-step from a swizzled box (rows r0 + g and
// r0 + g + 8, both g mod 8; features f and f + 4: 16-byte chunks 2 kk and
// 2 kk + 1 of the box row, XOR g), split into TF32 hi and lo; zeros where
// !on.
__device__ __forceinline__ void a_fragments(const float* box, int kk, int g,
                                            bool on, uint32_t (&ah)[4],
                                            uint32_t (&al)[4]) {
  float v[4] = {0.f, 0.f, 0.f, 0.f};
  if (on) {
    const int c0 = ((2 * kk) ^ g) << 2, c1 = ((2 * kk + 1) ^ g) << 2;
    v[0] = box[c0];
    v[1] = box[8 * kBoxCols + c0];
    v[2] = box[c1];
    v[3] = box[8 * kBoxCols + c1];
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    ah[u] = to_tf32(v[u]);
    al[u] = to_tf32(__fsub_rn(v[u], __uint_as_float(ah[u])));
  }
  fence_regs(ah);
  fence_regs(al);
}

// Every thread of the block calls it.  For each valid point of the staged
// tile, emit(r, j, score, ||x||^2) is called once, by one thread, with the
// point's index in the tile, its nearest centroid and its exact score; the
// rechecks are added to *rc unless it is null.
template <int NT, class Emit>
__device__ __forceinline__ void search_tile(const Centroids& cs,
                                            const float* stage, int tm,
                                            int valid_rows, Rechecks* rc,
                                            Emit emit) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int d = cs.d, k = cs.k, ks_n = ksteps(d);
  const int kc = 8 * NT, cf = chunk_floats(d, NT), dc = row_stride(d);
  const int nkc = (k + kc - 1) / kc;
  const int mtiles = tm / 16;

  // ||x||^2 of the rows: lanes 0-15 take m-tile 0's, lanes 16-31 m-tile 1's
  float own = 0.f;
  {
    const int mt = warp + kWarps * (lane >> 4);
    if (mt < mtiles) own = staged_norm(stage, mt * 16 + (lane & 15), tm, ks_n);
  }
  RowState rs[kMaxMT];
#pragma unroll
  for (int m = 0; m < kMaxMT; ++m) {
    rs[m].init(__shfl_sync(0xffffffffu, own, 16 * m + g),
               __shfl_sync(0xffffffffu, own, 16 * m + g + 8));
  }

  for (int ch = 0; ch < nkc; ++ch) {
    const float* cp = cs.slots;
    if (cs.resident) {
      cp += (size_t)ch * cf;
    } else {
      __syncthreads();  // the previous chunk is read by every warp
      stage_chunk(cs, ch, cs.slots);
      __syncthreads();
    }
    const int img = image_floats(d, NT);
    const uint32_t hi_s = smem_u32(cp), lo_s = hi_s + 4 * img;
    const float* rows = cp + 2 * img;
    const float* cn = rows + kc * dc;
    const float4 win = *reinterpret_cast<const float4*>(cn + kc);
    const int cbase = ch * kc;
    const uint32_t live = live_columns<NT>(cbase, k, t);

    // m: the block's warpgroup takes 64 rows at a time, warp w rows
    // 64 m + 16 w ... + 15 (a warp past the tile's rows feeds zeros)
#pragma unroll
    for (int m = 0; m < kMaxMT; ++m) {
      if (64 * m >= tm) break;
      const int mt = warp + kWarps * m;
      const bool mine = mt < mtiles;
      const int r0 = mt * 16;
      float acc[4 * kMaxNT];
      for (int kb = 0; kb < ks_n; kb += 4) {  // the k-steps of one box
        const int kn = min(4, ks_n - kb);
        uint32_t ah[4][4], al[4][4];
        const float* box = stage + (kb >> 2) * tm * kBoxCols +
                           (r0 + g) * kBoxCols + t;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          a_fragments(box, kk, g, mine && kk < kn, ah[kk], al[kk]);
        }
        fence_regs(acc);
        wgmma_fence();
        // box kb / 4 of the images, 32 bytes per k-step along its rows;
        // k-steps past d multiply zeros (both sides are padded with them)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint32_t off = (kb >> 2) * kc * 128 + kk * 32;
          const uint64_t dh = smem_desc(hi_s + off);
          wgmma_tf32<NT>(acc, al[kk], dh, kb + kk > 0);
          wgmma_tf32<NT>(acc, ah[kk], smem_desc(lo_s + off), 1);
          wgmma_tf32<NT>(acc, ah[kk], dh, 1);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          fence_regs(ah[kk]);
          fence_regs(al[kk]);
        }
      }
      if (!mine) continue;
      rs[m].template pick<NT>(acc, cn, win, live, cbase, t,
                              [&](int h, int jj) {
        return exact_score(stage, r0 + g + 8 * h, tm, rows + jj * dc,
                           cn[jj], ks_n);
      });
    }
  }

#pragma unroll
  for (int m = 0; m < kMaxMT; ++m) {
    const int mt = warp + kWarps * m;
    if (mt >= mtiles) continue;
    rs[m].finish(mt * 16 + g, valid_rows, t, rc, emit);
  }
}

// --- the wide search (d > WIDE_D) -------------------------------------------

// The score's clamp in the fused step's inertia term (the reference's _BIG).
constexpr float kScoreClamp = 3.4e38f;

// What a wide search writes for point i besides its index: the score (0),
// the squared distance max(score + ||x||^2, 0) (1), or the fused step's
// inertia term max(min(score, 3.4e38) + ||x||^2, 0) (2); NaN stays NaN.
__device__ __forceinline__ float wide_value(int mode, float s, float xn) {
  if (mode == 0) return s;
  const float t = __fadd_rn(mode == 2 && s > kScoreClamp ? kScoreClamp : s,
                            xn);
  return (t < 0.f) ? 0.f : t;
}

// The exact score of point x (a row of device memory) against the packed
// exact row crow, in feature order; vec: x's rows are 16-byte aligned
// (crow always is), so 16 features are loaded at a time.  Out of line:
// rechecks are rare (about one a point), and an inlined copy at each call
// would crowd the main loop's instruction cache.  (Keeping the next 32
// features' loads in flight made row 2p 30% slower: the callee's registers
// are saved around every call.)
__device__ __noinline__ float exact_score_global(const float* xr,
                                                 const float* crow, float cn,
                                                 int d, int vec) {
  float acc = 0.f;
  int f = 0;
  if (vec) {
    for (; f + 16 <= d; f += 16) {
      float4 a[4], b[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        a[u] = __ldg(reinterpret_cast<const float4*>(xr + f) + u);
        b[u] = __ldg(reinterpret_cast<const float4*>(crow + f) + u);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) acc = dot4(acc, a[u], b[u]);
    }
  }
#pragma unroll 8
  for (; f < d; ++f) {
    acc = __fadd_rn(acc, __fmul_rn(__ldg(xr + f), __ldg(crow + f)));
  }
  return __fsub_rn(cn, __fmul_rn(2.f, acc));
}

// (score, index) as one 64-bit key whose unsigned order is precedes(): NaN
// first (0), then the scores in order (-0 as +0), then the indices.
__device__ __forceinline__ unsigned long long order_key(float s, int j) {
  uint32_t u = 0;
  if (s == s) {
    const uint32_t b = __float_as_uint(s == 0.f ? 0.f : s);
    u = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  }
  return ((unsigned long long)u << 32) | (uint32_t)j;
}

__device__ __forceinline__ float key_score(unsigned long long key) {
  const uint32_t u = (uint32_t)(key >> 32);
  if (u == 0) return __uint_as_float(0x7fffffffu);
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// The wide search's view of the two rows a thread holds (as RowState),
// with the exact rechecks deferred to the end of the tile.  A chunk's
// candidates (!(s~ > U + E), U the running upper end) are kept as (j, s~),
// kDefer a row; one that finds the list full is rechecked at once.  At the
// end, a kept candidate is rechecked only if it is still one against the
// final U (U only falls, so that set holds every candidate RowState::pick
// would have after the last chunk: the true minimum and all its ties); the
// warp's rechecks are dealt over its 32 lanes, and each row's best (score,
// index) is kept as order_key in shared memory (an integer atomicMin, so
// the order does not matter).  The TF32 scores' running minimum is four or
// five chunks deep at k = 4,096, so deferring cuts the exact rechecks from
// ~4.8 a point to about one.
constexpr int kDefer = 4;

struct WideRowState {
  float xn[2], xnorm[2], upper[2], bs[2];
  int r0, bj[2], cands[2], held[2];
  int hj[2 * kDefer];
  float hs[2 * kDefer];

  // rows r (tile row of h = 0) and r + 8, their ||x||^2 n0 and n1
  __device__ void init(int r, float n0, float n1) {
    r0 = r;
    xn[0] = n0;
    xn[1] = n1;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      xnorm[h] = sqrtf(xn[h]);
      upper[h] = INFINITY;
      bs[h] = INFINITY;
      bj[h] = 0x7fffffff;
      cands[h] = 0;
      held[h] = 0;
    }
  }

  __device__ __forceinline__ float window(int h, float4 win) const {
    return (xnorm[h] * win.x < kGuard) ? fmaf(xnorm[h], win.z, win.w)
                                       : INFINITY;
  }

  // exact(r, j): the exact score of tile row r against centroid j
  template <class Exact>
  __device__ __forceinline__ void recheck(int h, int j, Exact& exact) {
    const float sc = exact(r0 + 8 * h, j);
    if (h) {
      if (precedes(sc, j, bs[1], bj[1])) {
        bs[1] = sc;
        bj[1] = j;
      }
      ++cands[1];
    } else {
      if (precedes(sc, j, bs[0], bj[0])) {
        bs[0] = sc;
        bj[0] = j;
      }
      ++cands[0];
    }
  }

  // After the products of the fragment against a chunk (acc = cross~): as
  // RowState::pick, but the candidates are kept (rechecked at once when
  // the row's list is full).
  template <int NT, class Exact>
  __device__ __forceinline__ void pick(float (&acc)[4 * kMaxNT],
                                       const float* cn, float4 win,
                                       uint32_t live, int cbase, int t,
                                       Exact exact) {
    float lo[2] = {INFINITY, INFINITY}, e[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) e[h] = window(h, win);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float2 cn2 = *reinterpret_cast<const float2*>(cn + nt * 8 + 2 * t);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float& a = acc[4 * nt + q];
        a = fmaf(-2.f, a, (q & 1) ? cn2.y : cn2.x);
        lo[q >> 1] = fminf(lo[q >> 1], a);
      }
    }
    float cut[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      lo[h] = fminf(lo[h], __shfl_xor_sync(0xffffffffu, lo[h], 1));
      lo[h] = fminf(lo[h], __shfl_xor_sync(0xffffffffu, lo[h], 2));
      upper[h] = fminf(upper[h], lo[h] + e[h]);
      cut[h] = upper[h] + e[h];
    }
    uint32_t pending = 0;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (!(acc[4 * nt + q] > cut[q >> 1])) pending |= 1u << (nt * 4 + q);
      }
    }
    pending &= live;
    while (pending) {
      const int b = __ffs(pending) - 1;
      pending &= pending - 1;
      const int h = (b >> 1) & 1, j = cbase + (b >> 2) * 8 + 2 * t + (b & 1);
      if (held[h] == kDefer) {
        recheck(h, j, exact);
        continue;
      }
      float s = acc[0];  // acc[b], by selects (a dynamic index spills)
#pragma unroll
      for (int i = 1; i < 4 * NT; ++i) s = (b == i) ? acc[i] : s;
      const int slot = h * kDefer + held[h];
#pragma unroll
      for (int i = 0; i < 2 * kDefer; ++i) {
        if (i == slot) {
          hj[i] = j;
          hs[i] = s;
        }
      }
      if (h) ++held[1]; else ++held[0];
    }
  }

  // The kept candidates still within the final window (win_of(j): the
  // window terms of centroid j's chunk) rechecked, dealt over the warp's
  // lanes; best and count: the warp's 16 rows' keys (+inf, ~0) and recheck
  // counts (0) in shared memory, row r0 + 8 h at best[(r0 & 15) + 8 h] (the
  // warp's rows are 16-aligned).  Then the quad's lane t = 0 emits row r0
  // + 8 h (if below valid_rows) and counts its rechecks.
  template <class WinOf, class Exact, class Emit>
  __device__ __forceinline__ void finish(int valid_rows, int t,
                                         Rechecks* rc, WinOf win_of,
                                         Exact exact, Emit& emit,
                                         unsigned long long* best,
                                         int* count) {
    const int lane = threadIdx.x & 31, wr = r0 & ~15;
    uint32_t m = 0;
#pragma unroll
    for (int i = 0; i < 2 * kDefer; ++i) {
      const int h = i / kDefer;
      if (i % kDefer < held[h]) {
        const float cut = upper[h] + window(h, win_of(hj[i]));
        if (!(hs[i] > cut)) m |= 1u << i;
      }
    }
    // the warp's rechecks in lane order: lane L's are items excl ... incl - 1
    const int cnt = __popc(m);
    int incl = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    const int excl = incl - cnt;
    const int total = __shfl_sync(0xffffffffu, incl, 31);
    for (int base = 0; base < total; base += 32) {
      const int item = base + lane;
      int o = 0;  // the owner: the first lane whose incl exceeds item
#pragma unroll
      for (int step = 16; step; step >>= 1) {
        if (__shfl_sync(0xffffffffu, incl, o + step - 1) <= item) o += step;
      }
      uint32_t om = __shfl_sync(0xffffffffu, m, o);
      const int k = item - __shfl_sync(0xffffffffu, excl, o);
      for (int q = 0; q < k && om; ++q) om &= om - 1;  // its k-th slot
      const int slot = om ? __ffs(om) - 1 : 0;
      int j = 0;
#pragma unroll
      for (int i = 0; i < 2 * kDefer; ++i) {
        const int v = __shfl_sync(0xffffffffu, hj[i], o);
        if (i == slot) j = v;
      }
      if (item < total) {
        const int row = (o >> 2) + 8 * (slot / kDefer);  // of the warp's 16
        atomicMin(best + row, order_key(exact(wr + row, j), j));
        atomicAdd(count + row, 1);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // the rechecks made along the way
      const int row = (r0 & 15) + 8 * h;
      if (cands[h]) {
        atomicMin(best + row, order_key(bs[h], bj[h]));
        atomicAdd(count + row, cands[h]);
      }
    }
    __syncwarp();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = (r0 & 15) + 8 * h;
      if (t == 0 && r0 + 8 * h < valid_rows) {
        const unsigned long long key = best[row];
        emit(r0 + 8 * h, (int)(uint32_t)key, key_score(key), xn[h]);
        if (rc != nullptr) {
          rc->total += (unsigned long long)count[row];
          rc->most = max(rc->most, (unsigned long long)count[row]);
        }
      }
    }
    __syncwarp();  // every emit has read best[] and count[] before a reset
  }
};

// How the producer brings x in: a TMA tensor map (boxes {32, kWideRows}),
// 16-byte cp.async, or 4-byte cp.async (wide_x_copy chooses).
enum WideCopy { kCopy4 = 0, kCopy16 = 1, kCopyTma = 2 };

// Features 32 b ... 32 b + 31 of rows row0 ... row0 + kWideRows - 1 of x
// into the swizzled box at dst by this producer lane's cp.async copies
// (zeros past n and d).
__device__ __forceinline__ void wide_x_box_cp(const float* x, int n, int d,
                                              int row0, int b, int how,
                                              float* dst, int lane) {
  const int f0 = b * kBoxCols;
  if (how == kCopy16) {
    for (int e = lane; e < kWideRows * 8; e += 32) {
      const int r = e >> 3, q = e & 7;
      const bool in = row0 + r < n && f0 + 4 * q < d;
      cp_async16(smem_u32(dst + r * kBoxCols + ((q ^ (r & 7)) << 2)),
                 in ? x + (size_t)(row0 + r) * d + f0 + 4 * q : x,
                 in ? 16 : 0);
    }
  } else {
    for (int e = lane; e < kWideRows * kBoxCols; e += 32) {
      const int r = e >> 5, c = e & 31;
      const bool in = row0 + r < n && f0 + c < d;
      cp_async4(smem_u32(dst + swz(r, c, kWideRows)),
                in ? x + (size_t)(row0 + r) * d + f0 + c : x, in ? 4 : 0);
    }
  }
}

template <int NT>
__device__ __forceinline__ void search_wide_consumer(
    const float* __restrict__ x, const float* __restrict__ cpack, int n,
    int k, int d, int stages, int xres, int how, int mode,
    int* __restrict__ idx_out, float* __restrict__ val_out,
    unsigned long long* __restrict__ stats, float* xtile, const float* ring,
    uint64_t* full, uint64_t* empty, uint64_t* xfull, uint64_t* xempty);

// Points x (n, d) against every chunk of 8 NT centroids of cpack; point i
// gets idx_out[i] and val_out[i] = wide_value(mode, ...).  One producer
// warp and kWideWG consumer warpgroups; a persistent loop over tiles of
// kWideRows points (tile blockIdx.x, then every gridDim.x-th).
//
// The producer fills ring stage q % stages with step q of the sequence
// (tile, chunk ch, box b): box b of chunk ch's hi and lo images by bulk
// copies, and x's box b unless x's tile is resident (xres), on full[q %
// stages]; every consumer warp releases the stage on empty[] once its
// products are read.  With xres, the producer loads the next tile into x's
// buffer once the consumers release the last one (xempty) and after it has
// refilled the ring for that tile (the centroids do not wait for x), on
// xfull.
//
// A consumer warpgroup takes 64 points of the tile (warp w rows 16 w ...
// 16 w + 15 of them): for each chunk, each box's A fragments (x's TF32 hi
// and lo from shared memory) against the stage's images, twelve wgmma
// m64nNk8, then RowState::pick over the chunk (the window and the exact
// rechecks, whose rows come from x's resident tile or device memory).
template <int NT>
__global__ void __launch_bounds__(kWideThreads, 1)
search_wide_kernel(const __grid_constant__ CUtensorMap xmap,
                   const float* __restrict__ x,
                   const float* __restrict__ cpack, int n, int k, int d,
                   int stages, int xres, int how, int mode,
                   int* __restrict__ idx_out, float* __restrict__ val_out,
                   unsigned long long* __restrict__ stats) {
  extern __shared__ unsigned char smem_raw[];
  float* base = aligned_smem(smem_raw);
  const int bx = boxes(d);
  const int kc = 8 * NT, cf = chunk_floats(d, NT), img = image_floats(d, NT);
  const int nkc = (k + kc - 1) / kc;
  const int tiles = (n + kWideRows - 1) / kWideRows;
  const int sf = wide_stage_floats(NT, xres);
  // xres: x's tile (bx boxes of kWideRows rows), loaded as fp32 and made
  // its TF32 hi image in place, then its lo image
  float* xtile = base;
  float* ring = base + (xres ? 2 * (size_t)bx * kWideRows * kBoxCols : 0);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + (size_t)stages * sf);
  uint64_t* empty = full + stages;
  uint64_t* xfull = empty + stages;
  uint64_t* xempty = xfull + 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(smem_u32(full + s), 1);
      mbar_init(smem_u32(empty + s), 4 * kWideWG);
    }
    mbar_init(smem_u32(xfull), 1);
    mbar_init(smem_u32(xempty), 4 * kWideWG);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * kWideWG) {  // the producer
    const uint32_t cbytes = 2u * kc * 128;
    int q = 0, it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++it) {
      const int row0 = tile * kWideRows, steps = nkc * bx;
      const int xat = min(stages, steps);  // x after the tile's first steps
      for (int s = 0; s < steps; ++s, ++q) {
        const int st = q % stages, ch = s / bx, b = s % bx;
        mbar_wait(smem_u32(empty + st), ((q / stages) & 1) ^ 1);
        float* dst = ring + (size_t)st * sf;
        const uint32_t bar = smem_u32(full + st);
        if (!xres && how != kCopyTma) {
          wide_x_box_cp(x, n, d, row0, b, how, dst, lane);
          cp_async_mbar_arrive(bar);
        }
        __syncwarp();
        if (lane == 0) {
          const bool xt = !xres && how == kCopyTma;
          mbar_expect_tx(bar, cbytes + (xt ? kWideRows * 128u : 0u));
          if (xt) tma_load_2d(smem_u32(dst), &xmap, bar, b * kBoxCols, row0);
          float* cdst = dst + (xres ? 0 : kWideRows * kBoxCols);
          const float* src = cpack + (size_t)ch * cf + b * kc * kBoxCols;
          bulk_load(smem_u32(cdst), src, kc * 128u, bar);
          bulk_load(smem_u32(cdst + kc * kBoxCols), src + img, kc * 128u,
                    bar);
        }
        if (xres && s == xat - 1) {  // the tile's x, once the last is free
          mbar_wait(smem_u32(xempty), (it & 1) ^ 1);
          const uint32_t xb = smem_u32(xfull);
          if (how != kCopyTma) {
            for (int bb = 0; bb < bx; ++bb) {
              wide_x_box_cp(x, n, d, row0, bb, how,
                            xtile + (size_t)bb * kWideRows * kBoxCols, lane);
            }
            cp_async_mbar_arrive(xb);
          }
          __syncwarp();
          if (lane == 0) {
            if (how == kCopyTma) {
              mbar_expect_tx(xb, (uint32_t)bx * kWideRows * 128u);
              for (int bb = 0; bb < bx; ++bb) {
                tma_load_2d(
                    smem_u32(xtile + (size_t)bb * kWideRows * kBoxCols),
                    &xmap, xb, bb * kBoxCols, row0);
              }
            } else {
              mbar_arrive(xb);
            }
          }
        }
      }
    }
  } else {  // a consumer warpgroup
    search_wide_consumer<NT>(x, cpack, n, k, d, stages, xres, how, mode,
                             idx_out, val_out, stats, xtile, ring, full,
                             empty, xfull, xempty);
  }
}

// The consumer warpgroups of search_wide_kernel (see there).
template <int NT>
__device__ __forceinline__ void search_wide_consumer(
    const float* __restrict__ x, const float* __restrict__ cpack, int n,
    int k, int d, int stages, int xres, int how, int mode,
    int* __restrict__ idx_out, float* __restrict__ val_out,
    unsigned long long* __restrict__ stats, float* xtile, const float* ring,
    uint64_t* full, uint64_t* empty, uint64_t* xfull, uint64_t* xempty) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bx = boxes(d), ks_n = ksteps(d);
  const int kc = 8 * NT, cf = chunk_floats(d, NT), img = image_floats(d, NT);
  const int dc = row_stride(d), nkc = (k + kc - 1) / kc;
  const int sf = wide_stage_floats(NT, xres);
  const int g = lane >> 2, t = lane & 3;
  const int rw = 64 * (warp >> 2) + 16 * (warp & 3);  // the warp's rows
  Rechecks rc;
  float acc[4 * kMaxNT];
  const int tiles = (n + kWideRows - 1) / kWideRows;
  const size_t xfloats = (size_t)bx * kWideRows * kBoxCols;
  float* xlo = xtile + xfloats;
  const uint32_t xhi_s = smem_u32(xtile), xlo_s = smem_u32(xlo);
  const uint32_t arow = (uint32_t)(warp >> 2) * 64 * 128;  // the group's A
  unsigned long long* best =
      reinterpret_cast<unsigned long long*>(full + 2 * stages + 2) + rw;
  int* count = reinterpret_cast<int*>(best - rw + kWideRows) + rw;
  int q = 0, it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++it) {
    const int row0 = tile * kWideRows;
    const int valid = min(kWideRows, n - row0);
    // ||x||^2: lane l < 16 sums row rw + l in feature order
    float own = 0.f;
    WideRowState rs;
    if (lane < 16) {  // the warp's rows: no best yet
      best[lane] = ~0ull;
      count[lane] = 0;
    }
    __syncwarp();
    if (xres) {
      mbar_wait(smem_u32(xfull), it & 1);
      if (lane < 16) own = staged_norm(xtile, rw + lane, kWideRows, ks_n);
      rs.init(rw + g, __shfl_sync(0xffffffffu, own, g),
              __shfl_sync(0xffffffffu, own, g + 8));
      // every fp32 read is done: the tile becomes its TF32 hi image in
      // place and its lo image beside it, read by the tensor cores
      consumers_sync();
      for (size_t e = 4 * (size_t)threadIdx.x; e < xfloats;
           e += 4 * kThreads * kWideWG) {
        float4 v = *reinterpret_cast<const float4*>(xtile + e);
        float4 lo;
        split_tf32(v.x, lo.x);
        split_tf32(v.y, lo.y);
        split_tf32(v.z, lo.z);
        split_tf32(v.w, lo.w);
        *reinterpret_cast<float4*>(xtile + e) = v;
        *reinterpret_cast<float4*>(xlo + e) = lo;
      }
      fence_proxy_async();
      consumers_sync();
    }
    // exact(r, j): the exact score of tile row r against centroid j, from
    // x in device memory
    const auto exact = [&](int r, int j) {
      const int ch = j / kc, jj = j - ch * kc;
      const float* rows = cpack + (size_t)ch * cf + 2 * img;
      return exact_score_global(x + (size_t)(row0 + r) * d, rows + jj * dc,
                                __ldg(rows + kc * dc + jj), d,
                                how != kCopy4);
    };
    const auto emit = [&](int r, int j, float s, float xn) {
      idx_out[row0 + r] = j;
      val_out[row0 + r] = wide_value(mode, s, xn);
    };
    for (int ch = 0; ch < nkc; ++ch) {
      for (int b = 0; b < bx; ++b, ++q) {
        const int st = q % stages;
        mbar_wait(smem_u32(full + st), (q / stages) & 1);
        const float* stg = ring + (size_t)st * sf;
        const int kb = 4 * b, kn = min(4, ks_n - kb);
        const uint32_t hi_s =
            smem_u32(stg + (xres ? 0 : kWideRows * kBoxCols));
        const uint32_t lo_s = hi_s + kc * 128;
        if (xres) {  // A from x's images: box b, the group's 64 rows
          const uint32_t ao = (uint32_t)b * kWideRows * 128 + arow;
          fence_regs(acc);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint64_t dh = smem_desc(hi_s + kk * 32);
            const uint64_t ah = smem_desc(xhi_s + ao + kk * 32);
            wgmma_tf32_ss<NT>(acc, smem_desc(xlo_s + ao + kk * 32), dh,
                              kb + kk > 0);
            wgmma_tf32_ss<NT>(acc, ah, smem_desc(lo_s + kk * 32), 1);
            wgmma_tf32_ss<NT>(acc, ah, dh, 1);
          }
          wgmma_commit();
          wgmma_wait_all();
          fence_regs(acc);
        } else {  // A from registers: the stage's box of x
          if (ch == 0 && lane < 16) {
            for (int kk = 0; kk < kn; ++kk) {
              float4 x0, x1;
              staged_8(stg, rw + lane, kWideRows, kk, x0, x1);
              own = dot4(dot4(own, x0, x0), x1, x1);
            }
          }
          uint32_t ah[4][4], al[4][4];
          const float* box = stg + (rw + g) * kBoxCols + t;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            a_fragments(box, kk, g, kk < kn, ah[kk], al[kk]);
          }
          fence_regs(acc);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint64_t dh = smem_desc(hi_s + kk * 32);
            wgmma_tf32<NT>(acc, al[kk], dh, kb + kk > 0);
            wgmma_tf32<NT>(acc, ah[kk], smem_desc(lo_s + kk * 32), 1);
            wgmma_tf32<NT>(acc, ah[kk], dh, 1);
          }
          wgmma_commit();
          wgmma_wait_all();
          fence_regs(acc);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            fence_regs(ah[kk]);
            fence_regs(al[kk]);
          }
        }
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(smem_u32(empty + st));
          // after the tile's last products, x's images are free again
          if (xres && ch == nkc - 1 && b == bx - 1) {
            mbar_arrive(smem_u32(xempty));
          }
        }
      }
      if (!xres && ch == 0) {
        rs.init(rw + g, __shfl_sync(0xffffffffu, own, g),
                __shfl_sync(0xffffffffu, own, g + 8));
      }
      const float* cn = cpack + (size_t)ch * cf + 2 * img + kc * dc;
      const float4 win = *reinterpret_cast<const float4*>(cn + kc);
      const int cbase = ch * kc;
      // rows past n hold zeros and are never emitted: recheck nothing
      const uint32_t live =
          rw + g < valid ? live_columns<NT>(cbase, k, t) : 0u;
      const uint32_t live8 =
          rw + g + 8 < valid ? live : (live & 0x33333333u);
      rs.template pick<NT>(acc, cn, win, live8, cbase, t, exact);
    }
    rs.finish(valid, t, &rc,
              [&](int j) {
                return *reinterpret_cast<const float4*>(
                    cpack + (size_t)(j / kc) * cf + 2 * img + kc * dc + kc);
              },
              exact, emit, best, count);
  }
  rc.flush(stats);
}

// The exact form (k <= kExactK <= KP, KP a power of 2): lane j of each
// group of KP lanes scores point r against centroid j in the plain scan's
// arithmetic (products and sums rounded on their own, in feature order,
// ||c_j||^2 and ||x_r||^2 likewise), and the group keeps the first minimum
// (NaN first) by shuffles.  The stats count the n k exact scores as
// rechecks.
template <int KP>
__global__ void __launch_bounds__(kExactThreads)
exact_wide_kernel(const float* __restrict__ x, const float* __restrict__ c,
                  int n, int k, int d, int vec, int mode,
                  int* __restrict__ idx_out, float* __restrict__ val_out,
                  unsigned long long* __restrict__ stats) {
  const int j = threadIdx.x % KP;
  const long long r =
      (long long)blockIdx.x * (kExactThreads / KP) + threadIdx.x / KP;
  const bool row_ok = r < n;
  const float* xr = x + (size_t)(row_ok ? r : n - 1) * d;
  const float* cr = c + (size_t)min(j, k - 1) * d;
  float acc = 0.f, cn = 0.f, xn = 0.f;
  int f = 0;
  if (vec) {
    for (; f + 16 <= d; f += 16) {
      float4 a[4], b[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        a[u] = __ldg(reinterpret_cast<const float4*>(xr + f) + u);
        b[u] = __ldg(reinterpret_cast<const float4*>(cr + f) + u);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        acc = dot4(acc, a[u], b[u]);
        cn = dot4(cn, b[u], b[u]);
        xn = dot4(xn, a[u], a[u]);
      }
    }
  }
#pragma unroll 4
  for (; f < d; ++f) {
    const float a = __ldg(xr + f), b = __ldg(cr + f);
    acc = __fadd_rn(acc, __fmul_rn(a, b));
    cn = __fadd_rn(cn, __fmul_rn(b, b));
    xn = __fadd_rn(xn, __fmul_rn(a, a));
  }
  float s = __fsub_rn(cn, __fmul_rn(2.f, acc));
  int jj = j;
  if (j >= k) {  // no centroid: never the minimum
    s = INFINITY;
    jj = 0x7fffffff;
  }
#pragma unroll
  for (int o = 1; o < KP; o <<= 1) {
    const float os = __shfl_xor_sync(0xffffffffu, s, o);
    const int oj = __shfl_xor_sync(0xffffffffu, jj, o);
    if (precedes(os, oj, s, jj)) {
      s = os;
      jj = oj;
    }
  }
  if (j == 0 && row_ok) {
    idx_out[r] = jj;
    val_out[r] = wide_value(mode, s, xn);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {  // every pair: n k in all
    stats[0] = (unsigned long long)n * k;
    stats[1] = (unsigned long long)k;
  }
}

// --- host -------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_fn() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &found);
#endif
    return (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

inline int& last_encode_result() {
  static int r = 0;
  return r;
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// How the wide search's producer copies x: TMA when its rows are whole
// 128-byte boxes and it is 16-byte aligned, else 16-byte cp.async when
// they are whole 16-byte pieces, else 4-byte.
inline int wide_x_copy(const void* x, int d) {
  if (d % kBoxCols == 0 && aligned16(x)) return kCopyTma;
  return d % 4 == 0 && aligned16(x) ? kCopy16 : kCopy4;
}

// TMA takes x when its rows are whole 128-byte boxes and it is 16-byte
// aligned.
inline bool use_tma(const void* x, int d) {
  return d % kBoxCols == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
}

// A map {d, n} over fp32 x (n, d), boxes {32, tm}, 128-byte swizzle; rows
// past n read as zeros.
inline int encode_x(CUtensorMap* map, const void* x, int n, int d, int tm) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return kErrNoEncode;
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)n};
  const cuuint64_t strides[1] = {(cuuint64_t)d * 4};
  const cuuint32_t box[2] = {(cuuint32_t)kBoxCols, (cuuint32_t)tm};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                        const_cast<void*>(x), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  last_encode_result() = (int)r;
  return r == CUDA_SUCCESS ? 0 : kErrEncode;
}

inline const char* error_string(int err) {
  static char buf[96];
  if (err == kErrNoEncode)
    return "cuTensorMapEncodeTiled not found through cudaGetDriverEntryPoint";
  if (err == kErrEncode) {
    snprintf(buf, sizeof buf, "cuTensorMapEncodeTiled failed (CUresult %d)",
             last_encode_result());
    return buf;
  }
  return cudaGetErrorString((cudaError_t)err);
}


template <int NT>
int launch_search_wide(const void* x, int n, int k, int d, const Plan& p,
                       int mode, const void* cpack, void* idx, void* val,
                       void* stats, cudaStream_t s);

// The wide search of x (n, d) against c (k, d) on stream s (ops.plan's
// wide plan p, nt centroid groups a chunk): the exact form when
// p.stages == 0, else pack_centroids into cpack and search_wide_kernel.
// Writes idx (n,) and val (n,) = wide_value(mode, ...); stats gets the
// rechecks.  Returns 0 or an error code for error_string.
inline int launch_wide(const void* x, const void* c, int n, int k, int d,
                       int nt, const Plan& p, int mode, void* cpack,
                       void* idx, void* val, void* stats, cudaStream_t s) {
  if (p.stages == 0) {
    const int kp = k <= 1 ? 1 : k <= 2 ? 2 : k <= 4 ? 4 : 8;
    if ((long long)p.search_blocks * (kExactThreads / kp) < n) {
      return (int)cudaErrorInvalidValue;
    }
    const int vec = d % 4 == 0 && aligned16(x) && aligned16(c);
    const auto kernel = kp == 1   ? exact_wide_kernel<1>
                        : kp == 2 ? exact_wide_kernel<2>
                        : kp == 4 ? exact_wide_kernel<4>
                                  : exact_wide_kernel<8>;
    kernel<<<p.search_blocks, kExactThreads, 0, s>>>(
        (const float*)x, (const float*)c, n, k, d, vec, mode, (int*)idx,
        (float*)val, (unsigned long long*)stats);
    return (int)cudaGetLastError();
  }
  pack_centroids<<<(k + 8 * nt - 1) / (8 * nt), 256, 0, s>>>(
      (const float*)c, k, d, nt, (float*)cpack, (unsigned long long*)stats);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  switch (nt) {
    case 1: return launch_search_wide<1>(x, n, k, d, p, mode, cpack, idx,
                                         val, stats, s);
    case 2: return launch_search_wide<2>(x, n, k, d, p, mode, cpack, idx,
                                         val, stats, s);
    case 4: return launch_search_wide<4>(x, n, k, d, p, mode, cpack, idx,
                                         val, stats, s);
    default: return launch_search_wide<8>(x, n, k, d, p, mode, cpack, idx,
                                          val, stats, s);
  }
}

template <int NT>
int launch_search_wide(const void* x, int n, int k, int d, const Plan& p,
                       int mode, const void* cpack, void* idx, void* val,
                       void* stats, cudaStream_t s) {
  const int how = wide_x_copy(x, d);
  CUtensorMap xmap{};
  if (how == kCopyTma) {
    const int err = encode_x(&xmap, x, n, d, kWideRows);
    if (err) return err;
  }
  const size_t smem = wide_smem_bytes(d, NT, p.stages, p.xres);
  cudaError_t e = cudaFuncSetAttribute(
      search_wide_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  search_wide_kernel<NT><<<p.search_blocks, kWideThreads, smem, s>>>(
      xmap, (const float*)x, (const float*)cpack, n, k, d, p.stages, p.xres,
      how, mode, (int*)idx, (float*)val, (unsigned long long*)stats);
  return (int)cudaGetLastError();
}

}  // namespace repro_assign

extern "C" {

// Floats of the packed-centroid scratch: ceil(k / (8 nt)) chunks.
size_t centroid_pack_floats(int k, int d, int nt) {
  return (size_t)((k + 8 * nt - 1) / (8 * nt)) *
         repro_assign::chunk_floats(d, nt);
}

const char* kernel_error_string(int err) {
  return repro_assign::error_string(err);
}

}  // extern "C"
