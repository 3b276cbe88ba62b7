// Causal (or full) flash-attention forward on Hopper's tensor cores
// (sm_90a): wgmma on bf16 operands with fp32 accumulation, TMA-staged tiles.
//
// Replaces the TPU kernel in src/repro/kernels/attention/attention.py:
// _flash_kernel (:42; flash_attention_kernel :97, pallas_call :129).  The
// wrapper (kernels/attention/ops.py) routes a bf16 call here when D is 64,
// 96 or 128 and q, k, v meet TMA's alignment ("tc"); everything else (fp32,
// other widths, unaligned views) runs the CUDA-core kernel in attention.cu
// ("simt").
//
// What it computes, for batch b, query head h and query row i:
//   s_j = q_i . k_j, scaled by (1/sqrt(D)) * log2(e) in fp32
//   key j is masked (p = 0) when j >= Sk or, when causal, j > i
//   running max m, normaliser l and fp32 accumulator acc (online softmax,
//   base 2)
//   o_i = acc / max(l, 1e-30), cast to bf16
// reading KV head h / (H / KV), with q, k, v in their (B, S, heads, D)
// layout through strides (TMA tensor maps over the strided tensors): no
// copy, no transpose, no pad.  Unlike attention.cu and the reference, the
// probabilities are rounded to bf16 before P.V (the tensor cores' operand
// type); m, l and acc stay fp32.
//
// What bounds it on an H100: 2 * 2 * D operations per live (query, key)
// pair against q, k, v read once and o written once.  At the serving shape
// (OLMo-1B prefill: B 4, S 4096, H 16, D 128, causal) that is 2.75e11
// operations for 0.27 GB: operation-bound, 0.278 ms at the 989 TFLOP/s bf16
// dense tensor-core peak.  The design keeps the tensor cores fed:
// - A block owns 128 query rows of one (b, h): two consumer warpgroups of 64
//   rows (one wgmma M = 64 each) and a producer warpgroup, of which one
//   thread loads Q once and streams 128-key K and V tiles by TMA into a
//   three-stage ring in dynamic shared memory (Q 32 KB + 3 x (K 32 KB +
//   V 32 KB) = 224 KB at D = 128, 168 KB at D = 96), handed over with
//   mbarriers (full: TMA
//   bytes landed; empty: all eight consumer warps are done with the
//   stage).  setmaxnreg moves the producer's registers to the consumers
//   (24 / 240 a thread), which hold S, P and O at once without spilling.
// - S = Q K^T: wgmma m64n128k16, both operands from shared memory, K-major
//   (K lies (keys, D) as TMA writes it).  A tile is cut along D into boxes
//   one swizzle span wide: 64 columns under the 128-byte swizzle when D is
//   a multiple of 64 (D = 128: two boxes), else 32 columns under the
//   64-byte swizzle (D = 96, a 192-byte row: three boxes).
// - Online softmax on the accumulator fragments: a thread holds two rows;
//   row max and row sum over the 4 threads of a quad by __shfl_xor_sync over
//   1 and 2; exp2 is one MUFU.EX2 (ex2.approx.ftz); O is rescaled only when
//   some row's max moved.
// - O += P V: wgmma with P as the A operand from registers (the S
//   accumulator's layout is the A fragment's, converted to bf16 in place)
//   and V read from shared memory with the B transpose bit: V lies
//   (keys, D), N-contiguous, and is never copied or transposed.  N = D:
//   m64n128k16, m64n96k16 (over V's three 32-column boxes) or m64n64k16.
// - Overlap: a warpgroup issues S_t = Q K_t^T and O += P_{t-1} V_{t-1}
//   back to back and runs the softmax of S_t while P V is on the tensor
//   cores; named barriers make the two warpgroups take turns issuing, so
//   one's softmax runs under the other's products.
// - Causal: a block walks key tiles only up to its diagonal; the element
//   mask runs only on the diagonal tile and on a ragged last tile (TMA
//   fills rows past Sk with zeros, and those keys get p = 0).
// - Block order: blocks are dispatched in index order, which walks groups
//   of consecutive (b, h) whose K/V together fit 16 MB of the 50 MB L2 (at
//   OLMo-1B's shape 8 heads, at GLM4-9B's all 32, which share 2 KV heads),
//   each group's last (the heaviest causal) query tiles first: a K/V tile
//   is read from device memory about once per group, and the long rows
//   start first while the short ones fill the tail.
// - Epilogue: O / l in bf16 goes through shared memory (over the Q rows the
//   warpgroup no longer reads) and out by TMA, which drops rows past Sq.
// - Deterministic: no atomics, every sum in a fixed order, so two launches
//   give the same bits.
// Not yet done (see PERF.md): clusters that share K/V tiles between the
// query tiles of one head.
//
// Tensor maps are encoded on the host inside the C entry;
// cuTensorMapEncodeTiled is found through cudaGetDriverEntryPoint, so the
// library needs no -lcuda.

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <stdio.h>

#include <algorithm>

namespace {

constexpr int kBlockM = 128;  // query rows per block: 2 warpgroups x 64
constexpr int kBlockN = 128;  // keys per K/V tile
constexpr int kStages = 3;    // K/V ring depth
constexpr int kConsumerWarps = 8;
// + a producer warpgroup, of which one thread issues TMA: a whole
// warpgroup, so that setmaxnreg can move its registers to the consumers
constexpr int kThreads = kConsumerWarps * 32 + 128;
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
// K/V bytes a group of heads may stream at once: well inside the 50 MB L2
constexpr long long kL2Budget = 16ll << 20;
static_assert(kBlockM == kBlockN, "Q and K/V tiles share one box shape");
// C entry error codes past CUDA's: cuTensorMapEncodeTiled missing / failed
constexpr int kErrNoEncode = 10000;
constexpr int kErrEncode = 10001;

// A Q, K or V tile of 128 rows, cut along D into boxes one swizzle span
// wide: 128-byte rows of 64 columns when D is a multiple of 64, else
// 64-byte rows of 32 columns (D = 96 is three).  A box's rows lie one
// after another, each box a swizzle pattern of its own.
template <int D>
struct Tile {
  static constexpr int kRowBytes = D % 64 == 0 ? 128 : 64;  // a box's row
  static constexpr int kBoxCols = kRowBytes / 2;            // bf16 columns
  static constexpr int kBoxes = D / kBoxCols;
  static constexpr int kBoxBytes = kBlockN * kRowBytes;
  static constexpr int kBytes = kBoxes * kBoxBytes;  // one Q, K or V tile
  // Q, kStages K and V tiles, and slack to align the base to 1024 bytes
  static constexpr int kSmem = kBytes * (1 + 2 * kStages) + 1024;
  // bytes between 8-row groups, the swizzle's period
  static constexpr uint32_t kGroupBytes = 8 * kRowBytes;
  // wgmma descriptor layout type: 1 = 128-byte swizzle, 2 = 64-byte
  static constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : 2;
  static_assert(D % 32 == 0 && D % kBoxCols == 0, "whole boxes only");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- mbarriers ------------------------------------------------------------

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

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.
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

// --- TMA ------------------------------------------------------------------

// One box {box columns, 1 head, 128 rows, 1 batch} of a (B, S, heads, D)
// tensor into shared memory at `dst`, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int head,
                                         int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(head),
      "r"(row), "r"(batch)
      : "memory");
}

// A box {box columns, 1 head, 64 rows, 1 batch} from shared memory at
// `src` into a (B, S, heads, D) tensor; rows past S are dropped.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int col, int head, int row,
                                          int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(col), "r"(head), "r"(row), "r"(batch)
      : "memory");
}

// --- wgmma ----------------------------------------------------------------

// Shared-memory matrix descriptor of a swizzled tile (layout 1: 128-byte
// swizzle, 2: 64-byte).  K-major operands (Q, K): SBO = bytes between
// 8-row groups, LBO unused.  The N-contiguous V: LBO = bytes between boxes
// (one swizzle span of columns each), SBO = bytes between 8-key groups.
// Every tile base is 1024-byte aligned, so the base offset is 0.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of wgmma registers across
// the asynchronous window (fence ... wait).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D (64 x 128, fp32) (+)= A (64 x 16, shared) . B (128 x 16, shared)^T,
// both K-major; scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64],
                                                  uint64_t da, uint64_t db,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 128, fp32) += A (64 x 16, bf16 registers) . B (16 x 128, shared,
// N-contiguous: the transpose bit set).
__device__ __forceinline__ void wgmma_m64n128k16_rs_tn(float (&d)[64],
                                                     const uint32_t (&a)[4],
                                                     uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 96, fp32) += A (64 x 16, bf16 registers) . B (16 x 96, shared,
// N-contiguous: the transpose bit set).
__device__ __forceinline__ void wgmma_m64n96k16_rs_tn(float (&d)[48],
                                                    const uint32_t (&a)[4],
                                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 64, fp32) += A (64 x 16, bf16 registers) . B (16 x 64, shared,
// N-contiguous: the transpose bit set).
__device__ __forceinline__ void wgmma_m64n64k16_rs_tn(float (&d)[32],
                                                     const uint32_t (&a)[4],
                                                     uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in bits 0-15
  return *reinterpret_cast<uint32_t*>(&v);
}

// The accumulator fragment of wgmma m64nN (fp32): register i of a thread
// holds row (i & 2 ? 8 : 0) + 16 * warp + lane / 4 of the warpgroup's 64,
// column 8 * (i / 4) + 2 * (lane % 4) + (i & 1).
// 2^x in one MUFU.EX2 (exp2f adds a range check and two multiplies to keep
// results below 2^-126, which p never needs: they flush to 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The two query rows a thread holds: a for registers with i & 2 == 0, b
// for the others.
struct Rows {
  int a, b;
};

// Online softmax of a thread's two rows, in base 2: p = exp2(s c - m c)
// with c = scale * log2(e) applied to the fp32 scores.
struct Softmax {
  float m[2] = {-INFINITY, -INFINITY};  // running max of the raw scores
  float l[2] = {0.f, 0.f};              // the thread's share of the sums
  float alpha[2] = {1.f, 1.f};          // O's factor before the next P V

  // Mask (on an edge tile: kMask), update m and l, and leave p in s.
  template <bool kMask>
  __device__ __forceinline__ void step(float (&s)[64], int key0, Rows rows,
                                       int Sk, int causal, int lane,
                                       float c) {
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int r = (i >> 1) & 1;
      if constexpr (kMask) {
        const int key = key0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
        if (key >= Sk || (causal && key > (r ? rows.b : rows.a)))
          s[i] = -INFINITY;
      }
      mx[r] = fmaxf(mx[r], s[i]);
    }
    float ref[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mn = fmaxf(m[r], mx[r]);
      // a row with no live key yet keeps m = -inf; against 0 its p are 0
      ref[r] = mn == -INFINITY ? 0.f : mn * c;
      alpha[r] = mn == m[r] ? 1.f : fast_exp2(m[r] * c - ref[r]);
      m[r] = mn;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int r = (i >> 1) & 1;
      s[i] = fast_exp2(fmaf(s[i], c, -ref[r]));
      sum[r] += s[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
  }

  __device__ __forceinline__ void step(float (&s)[64], bool edge, int key0,
                                       Rows rows, int Sk, int causal,
                                       int lane, float c) {
    if (edge)
      step<true>(s, key0, rows, Sk, causal, lane, c);
    else
      step<false>(s, key0, rows, Sk, causal, lane, c);
  }

  // O *= alpha, skipped when no row of the warp moved its max.
  template <int N>
  __device__ __forceinline__ void rescale(float (&acc)[N]) const {
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int i = 0; i < N; ++i) acc[i] *= alpha[(i >> 1) & 1];
    }
  }

  // The whole row sum: the quad's shares, the same bits in all four.
  __device__ __forceinline__ float row_sum(int r) const {
    float x = l[r];
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    x += __shfl_xor_sync(0xffffffffu, x, 2);
    return x;
  }
};

// Issue S = Q K^T (64 x 128) for a warpgroup: D / 16 steps of 16, each 32
// bytes further along a box's row, then on to the next box.
template <int D>
__device__ __forceinline__ void qk(float (&s)[64], uint32_t q, uint32_t k) {
  using T = Tile<D>;
  constexpr int kSteps = T::kRowBytes / 32;  // k-steps in a box's row
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / kSteps) * T::kBoxBytes + (kk % kSteps) * 32;
    wgmma_m64n128k16_ss(s, smem_desc(q + off, 16, T::kGroupBytes, T::kLayout),
                        smem_desc(k + off, 16, T::kGroupBytes, T::kLayout),
                        kk > 0);
  }
  wgmma_commit();
}

// Issue O += P V: 8 steps of 16 keys (16 rows of each box of V).
template <int D>
__device__ __forceinline__ void pv(float (&acc)[D / 2],
                                   const uint32_t (&pa)[kBlockN / 16][4],
                                   uint32_t v) {
  using T = Tile<D>;
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBlockN / 16; ++kk) {
    const uint64_t dv = smem_desc(v + kk * 16 * T::kRowBytes, T::kBoxBytes,
                                  T::kGroupBytes, T::kLayout);
    if constexpr (D == 128)
      wgmma_m64n128k16_rs_tn(acc, pa[kk], dv);
    else if constexpr (D == 96)
      wgmma_m64n96k16_rs_tn(acc, pa[kk], dv);
    else
      wgmma_m64n64k16_rs_tn(acc, pa[kk], dv);
  }
  wgmma_commit();
}

// P as bf16 A fragments: k-step kk covers keys 16 kk ... 16 kk + 15, which
// are accumulator registers 8 kk ... 8 kk + 7.
__device__ __forceinline__ void pack_p(const float (&s)[64],
                                       uint32_t (&pa)[kBlockN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kBlockN / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      pa[kk][j] = pack_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
}

// Named barriers 1 and 2 take turns between the consumer warpgroups: one
// syncs (128 threads) until the other has arrived (128 more).
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;" ::"r"(id) : "memory");
}
// Named barriers 3 and 4: the 128 threads of one consumer warpgroup.
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;" ::"r"(3 + wg) : "memory");
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_sm90_kernel(__grid_constant__ const CUtensorMap tq,
                  __grid_constant__ const CUtensorMap tk,
                  __grid_constant__ const CUtensorMap tv,
                  __grid_constant__ const CUtensorMap to, int H, int group,
                  int Sk, int n_q, int heads_per_group, float scale_log2,
                  int causal) {
  using T = Tile<D>;
  extern __shared__ uint8_t smem_raw[];
  // bars: Q full, then per stage K full, V full, empty
  __shared__ __align__(8) uint64_t bars[1 + 3 * kStages];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_smem = base;
  auto k_smem = [&](int s) { return base + (uint32_t)((1 + s) * T::kBytes); };
  auto v_smem = [&](int s) {
    return base + (uint32_t)((1 + kStages + s) * T::kBytes);
  };
  const uint32_t bar_q = smem_u32(&bars[0]);
  auto k_full = [&](int s) { return smem_u32(&bars[1 + s]); };
  auto v_full = [&](int s) { return smem_u32(&bars[1 + kStages + s]); };
  auto empty = [&](int s) { return smem_u32(&bars[1 + 2 * kStages + s]); };

  // blocks walk groups of heads_per_group consecutive (b, h), each group's
  // query tiles heaviest first, so the group's K/V stays in L2 while it is
  // read
  const int n_bh = gridDim.x / n_q, per = n_q * heads_per_group;
  const int grp = blockIdx.x / per, r = blockIdx.x % per;
  const int g = min(heads_per_group, n_bh - grp * heads_per_group);
  const int bh = grp * heads_per_group + r % g;
  const int b = bh / H, h = bh % H, hk = h / group;
  const int q0 = (n_q - 1 - r / g) * kBlockM;
  const int k_end = causal ? min(Sk, q0 + kBlockM) : Sk;
  const int n_tiles = (k_end + kBlockN - 1) / kBlockN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (warp == kConsumerWarps && lane == 0) {
      mbar_expect_tx(bar_q, T::kBytes);
      for (int x = 0; x < T::kBoxes; ++x)
        tma_load(q_smem + x * T::kBoxBytes, &tq, bar_q, x * T::kBoxCols, h,
                 q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages, round = t / kStages;
        if (round > 0) mbar_wait(empty(s), (round - 1) & 1);
        mbar_expect_tx(k_full(s), T::kBytes);
        for (int x = 0; x < T::kBoxes; ++x)
          tma_load(k_smem(s) + x * T::kBoxBytes, &tk, k_full(s),
                   x * T::kBoxCols, hk, t * kBlockN, b);
        mbar_expect_tx(v_full(s), T::kBytes);
        for (int x = 0; x < T::kBoxes; ++x)
          tma_load(v_smem(s) + x * T::kBoxBytes, &tv, v_full(s),
                   x * T::kBoxCols, hk, t * kBlockN, b);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows q0 + 64 * wg ... + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  const int wg = warp >> 2;
  const int wg_row0 = q0 + wg * 64;
  Rows rows;
  rows.a = wg_row0 + (warp & 3) * 16 + (lane >> 2);
  rows.b = rows.a + 8;
  const uint32_t q_wg = q_smem + wg * 64 * T::kRowBytes;  // its rows
  // the diagonal tile (causal) and a ragged last tile need the mask
  auto edge = [&](int t) {
    const int key0 = t * kBlockN;
    return (causal && key0 + kBlockN - 1 > wg_row0) || key0 + kBlockN > Sk;
  };

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float s[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = 0.f;
  uint32_t pa[kBlockN / 16][4];
  Softmax sm;

  // the warpgroups take turns issuing tensor-core work (named barriers 1
  // and 2), warpgroup 0 first
  if (wg == 1) named_arrive(1);
  // tile 0: S only
  mbar_wait(bar_q, 0);
  mbar_wait(k_full(0), 0);
  named_sync(1 + wg);
  qk<D>(s, q_wg, k_smem(0));
  named_arrive(2 - wg);
  wgmma_wait<0>();
  fence_regs(s);
  sm.step(s, edge(0), 0, rows, Sk, causal, lane, scale_log2);
  pack_p(s, pa);
  // tile t: S_t = Q K_t^T and O += P_{t-1} V_{t-1} in flight together;
  // the softmax of S_t runs on the CUDA cores while P V runs on the
  // tensor cores
  for (int t = 1; t < n_tiles; ++t) {
    const int st = t % kStages, pst = (t - 1) % kStages;
    mbar_wait(k_full(st), (t / kStages) & 1);
    named_sync(1 + wg);
    qk<D>(s, q_wg, k_smem(st));
    sm.rescale(acc);  // by the previous tile's alpha
    mbar_wait(v_full(pst), ((t - 1) / kStages) & 1);
    pv<D>(acc, pa, v_smem(pst));
    named_arrive(2 - wg);
    wgmma_wait<1>();  // S_t has landed
    fence_regs(s);
    sm.step(s, edge(t), t * kBlockN, rows, Sk, causal, lane, scale_log2);
    wgmma_wait<0>();  // P_{t-1} V_{t-1} is done: stage pst is free
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(pst));
    pack_p(s, pa);
  }
  const int last = (n_tiles - 1) % kStages;
  sm.rescale(acc);
  mbar_wait(v_full(last), ((n_tiles - 1) / kStages) & 1);
  named_sync(1 + wg);
  pv<D>(acc, pa, v_smem(last));
  // warpgroup 1's opening arrival stands in for its last one
  if (wg == 0) named_arrive(2);
  wgmma_wait<0>();
  fence_regs(acc);

  // O = acc / l in bf16, through shared memory: the warpgroup writes its
  // 64 rows over its own rows of the Q tile (which it no longer reads), in
  // the swizzled layout TMA reads, and one thread stores them with TMA
  // (rows past Sq are dropped)
  const float inv_a = 1.f / fmaxf(sm.row_sum(0), 1e-30f);
  const float inv_b = 1.f / fmaxf(sm.row_sum(1), 1e-30f);
  const int ra = (warp & 3) * 16 + (lane >> 2);  // row a within the 64
  // the swizzle XORs a row's 16-byte chunk index with address bits 7 and
  // up: the row mod 8 for 128-byte rows, (row / 2) mod 4 for 64-byte ones;
  // rows ra and ra + 8 share it
  constexpr int kChunks = T::kRowBytes / 16;
  const int sw = T::kRowBytes == 128 ? (ra & 7) : ((ra >> 1) & 3);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    // columns 8 j ... 8 j + 7: chunk j % kChunks of box j / kChunks
    const uint32_t at = q_wg + (j / kChunks) * T::kBoxBytes +
                        (((j % kChunks) ^ sw) << 4) + 4 * (lane & 3);
    const uint32_t word_a =
        pack_bf16(acc[4 * j] * inv_a, acc[4 * j + 1] * inv_a);
    const uint32_t word_b =
        pack_bf16(acc[4 * j + 2] * inv_b, acc[4 * j + 3] * inv_b);
    asm volatile("st.shared.u32 [%0], %1;" ::"r"(at + ra * T::kRowBytes),
                 "r"(word_a));
    asm volatile("st.shared.u32 [%0], %1;" ::"r"(at + (ra + 8) *
                                                        T::kRowBytes),
                 "r"(word_b));
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  warpgroup_sync(wg);
  if ((threadIdx.x & 127) == 0) {
    for (int x = 0; x < T::kBoxes; ++x)
      tma_store(&to, q_wg + x * T::kBoxBytes, x * T::kBoxCols, h, wg_row0,
                b);
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    // shared memory must outlive the reads of the store
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  }
}

// --- host -----------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
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

int last_encode_result = 0;

// A 4-D map {D, heads, S, B} over a bf16 (B, S, heads, D) tensor with the
// given element strides; boxes of {Tile<D>::kBoxCols, 1, rows, 1} under
// Tile<D>'s swizzle; rows past S read as zeros and are not written.
template <int D>
int encode(CUtensorMap* map, const void* ptr, int B, int S, int heads,
           long long sb, long long ss, long long sh, int rows) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return kErrNoEncode;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)Tile<D>::kBoxCols, 1,
                             (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        Tile<D>::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                                  : CU_TENSOR_MAP_SWIZZLE_64B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  last_encode_result = (int)r;
  return r == CUDA_SUCCESS ? 0 : kErrEncode;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int KV, int Sq, int Sk, const long long* st, float scale,
           int causal, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, to;
  int err = encode<D>(&tq, q, B, Sq, H, st[0], st[1], st[2], kBlockM);
  if (!err) err = encode<D>(&tk, k, B, Sk, KV, st[3], st[4], st[5], kBlockN);
  if (!err) err = encode<D>(&tv, v, B, Sk, KV, st[6], st[7], st[8], kBlockN);
  // each consumer warpgroup stores its own 64 rows
  if (!err) err = encode<D>(&to, o, B, Sq, H, st[9], st[10], st[11], 64);
  if (err) return err;
  auto kernel = flash_sm90_kernel<D>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<D>::kSmem);
  if (e != cudaSuccess) return (int)e;
  // a group of query heads whose K/V together fit kL2Budget (whole KV
  // heads, so a GQA group is never split)
  const long long kv_bytes = 4ll * Sk * D;  // K and V of one KV head, bf16
  const long long kv_heads = std::max(1ll, kL2Budget / kv_bytes);
  const int heads_per_group =
      (int)std::min<long long>((long long)B * H, kv_heads * (H / KV));
  const int n_q = (Sq + kBlockM - 1) / kBlockM;
  kernel<<<B * H * n_q, kThreads, Tile<D>::kSmem, stream>>>(
      tq, tk, tv, to, H, H / KV, Sk, n_q, heads_per_group,
      scale * 1.4426950408889634f, causal);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// bf16 q (B, Sq, H, D), k and v (B, Sk, KV, D), o (B, Sq, H, D) on the
// current device, unit stride along D; the other strides are in elements,
// multiples of 8, and q, k, v start on 16-byte boundaries (TMA's rules).
// D is 64, 96 or 128, H % KV == 0, B * H * ceil(Sq / 128) < 2^31.  Launches on
// `stream` and returns 0 or an error code for kernel_error_string; does not
// synchronise.
int flash_sm90_fwd(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int KV, int Sq, int Sk, int d,
                   long long q_sb, long long q_ss, long long q_sh,
                   long long k_sb, long long k_ss, long long k_sh,
                   long long v_sb, long long v_ss, long long v_sh,
                   long long o_sb, long long o_ss, long long o_sh,
                   float scale, int causal, void* stream) {
  if (KV < 1 || H % KV != 0 || B < 1 || Sq < 1 || Sk < 1 ||
      (long long)B * H * ((Sq + kBlockM - 1) / kBlockM) >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const long long st[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                            v_sb, v_ss, v_sh, o_sb, o_ss, o_sh};
  cudaStream_t s = (cudaStream_t)stream;
  if (d == 128)
    return launch<128>(q, k, v, o, B, H, KV, Sq, Sk, st, scale, causal, s);
  if (d == 96)
    return launch<96>(q, k, v, o, B, H, KV, Sq, Sk, st, scale, causal, s);
  if (d == 64)
    return launch<64>(q, k, v, o, B, H, KV, Sq, Sk, st, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int err) {
  static char buf[96];
  if (err == kErrNoEncode)
    return "cuTensorMapEncodeTiled not found through cudaGetDriverEntryPoint";
  if (err == kErrEncode) {
    snprintf(buf, sizeof buf, "cuTensorMapEncodeTiled failed (CUresult %d)",
             last_encode_result);
    return buf;
  }
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
