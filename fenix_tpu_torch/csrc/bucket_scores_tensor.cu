// bucket_scores_tensor: the phase-1 kernel on the H100's tensor cores, for
// int8 corpora (K2: designs "tensor_int8" and "generic_int8") and bf16
// corpora (K1: "tensor_bf16" and "generic_bf16"); one frame templated over
// the element type and over the producer that fills its stages.
//
// tensor_int8 and generic_int8 replace kernel_int8 of
// fenix_tpu/ops/topk2.py:bucket_scores_pallas_bigq (fenix_tpu/ops/topk2.py:464).
// For corpus row i and query j they compute
//
//   s = f32(v8_i . q8_j) * aux_mul[i] + aux_add[i] * inv_sq[j]
//
// The integer sum is exact (127^2 * D < 2^31) and the epilogue spells its
// one FMA out (left to the compiler, a * b + c * d contracts either way).
//
// tensor_bf16 and generic_bf16 replace kernel_f32 of the same function on
// bf16 inputs (fenix_tpu/ops/topk2.py:453, which multiplies the bf16
// blocks with preferred_element_type=f32). They compute
//
//   s = f32(v16_i . q16_j) * aux_mul[i] + aux_add[i]
//
// with the bf16 products exact and summed in f32 inside the tensor cores.
//
// All four write out[j, b] = max over the `bucket` rows of bucket b
// (buckets of 1..128 rows), query-major [QT, N/bucket]. Rows at or past N
// score -inf; queries past QT are never written.
//
// What bounds it on an H100 (3.35 TB/s; 1,979 TOP/s int8 and 989 TFLOP/s
// bf16 on the tensor cores, ~590 and ~295 operations per byte where they
// meet the read): at small Q the read of V (2 Q operations per element of
// V); at Q = 1024 and D = 768 the products (int8: 6.6 TOP, 3.3 ms). Between
// them, at large Q and small D, the epilogue: every score costs a
// conversion (int8), a multiply, an FMA and its share of the maxima on the
// CUDA cores, and each row of V yields Q scores for D products, so at
// Q = 256 and D = 128 the epilogue, not the read or the products, takes
// most of the time. What the design does about each:
// - Tensor cores: wgmma.mma_async m64nNk32 s32.s8.s8 (int8) or m64nNk16
//   f32.bf16.bf16 (bf16): 32 bytes of k either way. The corpus tile is A
//   (rows on M) and the query tile B, both K-major as they lie in memory,
//   so nothing is transposed. N, the query tile, is picked from Q among
//   8..256; Q = 1..7 pads to 8 with the zero rows TMA fills past QT.
// - Copies: the stages form a ring of 128-byte-swizzled 128-byte k-slices
//   (128 int8 or 64 bf16 values) of a 128-row V tile and of the query
//   tile, each signalled by an mbarrier; two consumer warpgroups (64 rows
//   each) issue the products and free a stage as soon as its products
//   finish. TMA-fed, 3 to 8 stages (by query-tile width) keep 48-128 KB
//   in flight per SM. Two producers fill them:
//   * tensor_*: rows of a multiple of 16 bytes, which TMA can address. One
//     thread issues cp.async.bulk.tensor for V's slice and the query tile.
//   * generic_*: any other D (GloVe's 25..300, fastText's 300, a PCA cut),
//     read from V as it lies, [N, D], with no padded copy. TMA needs
//     16-byte row strides and boxes that start on a 16-byte boundary (a
//     box that does not faults), so one thread stages V ahead of the
//     stages: a tile's 128 rows, one contiguous run of bytes, by one bulk
//     copy (cp.async.bulk, completion on an mbarrier), where two tiles fit
//     in the staging space; else each k-slice in g = 2..16 TMA boxes of
//     super-rows (g rows, the fewest whose bytes are a multiple of 16), box
//     i bringing row i of each super-row from the 16-byte boundary below
//     its slice. The producer warpgroup's 128 threads then each shift one
//     row down by its misalignment (aligned shared-memory words joined by
//     funnel shifts), zero it past D and store it swizzled into the stage;
//     a proxy fence orders the stores before wgmma's reads. Rows past the
//     last whole copy (fewer than 16, in the last tile) are read byte by
//     byte, so nothing is read past the end of V. The query batch, QT x D
//     and small, comes zero-padded to 16-byte rows from the wrapper, by TMA
//     as above. The consumers and the epilogue are the same code for both
//     producers, so generic_int8 equals tensor_int8 bit for bit at every D
//     both serve.
//     Chosen by measurement on the card (PERF.md): producers whose threads
//     copied their own rows' 16-byte chunks (cp.async, or one bulk copy a
//     row) or copied them together, coalesced, were slower; what bounds
//     this one at small Q is the shifts: four warps, each waiting on its
//     loads' latency. The stage ring keeps 3 stages (they wait only for
//     the products) and gives the rest of shared memory to staged
//     entries, which keep V's reads in flight; where the consumers'
//     accumulators leave room (Q <= 128), the producer takes 56 registers
//     and loads a row's 33 words before it shifts any.
// - Grid: one persistent block per SM walks (row tile, query tile) items
//   with the query tile fastest, so a row tile's query tiles run together
//   on neighbouring blocks and V is read from device memory once (the
//   other reads of a row tile hit L2).
// - Epilogue in registers: aux_mul and aux_add of the tile's rows (and, for
//   int8, inv_sq of its queries) come by TMA with the item's last k-step,
//   so no consumer waits on a device-memory load; the per-row FMA on the
//   accumulator fragment (rows lane/4 and lane/4 + 8 of the warp's 16-row
//   slab), the max of the thread's two rows, then a max over lane bits 2-4
//   in which the partners split their values (56 shuffles for the 64
//   values of N = 256, not 192). For buckets of 16..128 rows the 16-row
//   maxima meet in shared memory and the bucket maxima are written from
//   there, a query's buckets contiguous; buckets of 1..8 rows reduce by
//   shuffles and write per row.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "common.cuh"

namespace fenix {
namespace {

constexpr int kConsumers = 2;  // warpgroups issuing wgmma, 64 rows each
constexpr int kConsumerThreads = 128 * kConsumers;
constexpr int kThreads = kConsumerThreads + 128;  // + the producer warpgroup
constexpr int kRows = 64 * kConsumers;            // corpus rows per tile
constexpr int kKb = 128;                          // bytes of k per stage: one swizzle row
constexpr int kVBytes = kRows * kKb;
constexpr int kGroups = kRows / 16;  // 16-row groups per tile, one per consumer warp
constexpr int kSmemMax = 232448;  // dynamic shared memory one block may use
constexpr int kEpBytes = 2048;    // per stage: aux_mul, aux_add of the rows, inv_sq
// The generic producer stages each 128-row V tile's k-slice as TMA brings
// it, a row of kStagedRow bytes (the 128-byte slice and the misalignment of
// its start).
constexpr int kStagedRow = kKb + 16;
constexpr int kStagedBytes = kRows * kStagedRow;
constexpr int kMaxSlots = 8;

// What the frame needs of an element type: the accumulator, whether the
// epilogue scales aux_add by inv_sq of the query, and TMA's element type.
template <typename T>
struct Elem;
template <>
struct Elem<int8_t> {
  using Acc = int;  // exact s32 sums
  static constexpr bool kInvSq = true;
  static constexpr CUtensorMapDataType kTma = CU_TENSOR_MAP_DATA_TYPE_UINT8;
};
template <>
struct Elem<__nv_bfloat16> {
  using Acc = float;  // f32 sums of exact bf16 products
  static constexpr bool kInvSq = false;
  static constexpr CUtensorMapDataType kTma = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};

// Shared memory of a BN-query tile: the stage ring (each stage: V, the
// query tile, and the epilogue's per-row and per-query factors, which come
// with an item's last k-step), the generic producer's staged entries
// (kCopyV), the double-buffered rows of 16-row maxima and the mbarriers,
// plus 1 KB to align the base to the 1024 bytes over which the 128-byte
// swizzle repeats; every tile starts on such a boundary. TMA-fed: as many
// stages as fit, up to 8. Generic: 3 stages, which wait only for the
// products, and the rest for staged entries, which keep V's reads in
// flight.
template <int BN, bool kCopyV>
struct Ring {
  static constexpr int kRs = BN + 4;  // floats per row of 16-row maxima (+4: banks of the reads)
  static constexpr int kEp = kVBytes + BN * kKb;
  static constexpr int kStage = kEp + kEpBytes;
  static constexpr int kRedBytes = 2 * kGroups * kRs * 4;
  static constexpr int kAvail = kSmemMax - 1024 - kRedBytes - (kCopyV ? kMaxSlots * 8 : 0);
  static constexpr int kFit = (kAvail - (kCopyV ? 2 * kStagedBytes : 0)) / (kStage + 16);
  static constexpr int kStages = kFit < (kCopyV ? 3 : 8) ? kFit : (kCopyV ? 3 : 8);
  static constexpr int kStaging = kStages * kStage;
  static constexpr int kStagingBytes = kCopyV ? (kAvail - kStages * (kStage + 16)) & ~1023 : 0;
  static constexpr int kRed = kStaging + kStagingBytes;
  static constexpr int kBar = kRed + kRedBytes;
  static constexpr int kBytes = kBar + 2 * kStages * 8 + (kCopyV ? kMaxSlots * 8 : 0) + 1024;
  static_assert(kStages >= 2 && kStagingBytes >= (kCopyV ? 2 * kStagedBytes : 0) && kBytes <= kSmemMax,
                "the ring does not fit");
};

// How the generic producer reads V: its rows, and the entries it stages.
// An entry holds a tile's rows whole, brought by one bulk copy (whole = 1,
// where two such entries fit), or one k-slice of them, brought as boxes of
// super-rows of 2^group_log2 rows (whole = 0).
struct Copy {
  const unsigned char* v;
  int64_t row_bytes;
  int group_log2;
  int whole;
  int entry_bytes;
  int slots;  // entries, at most kMaxSlots
};

// -- wgmma (PTX) ---------------------------------------------------------------

// wgmma descriptor of a K-major tile in 128-byte-swizzled shared memory:
// 8-row groups 1024 bytes apart (the leading offset is unused for it).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) | (uint64_t(1) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving the accumulators across an asynchronous
// wgmma (which reads and writes them behind its back).
template <int R>
__device__ __forceinline__ void fence_acc(int* acc) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(acc[i])::"memory");
}

template <int R>
__device__ __forceinline__ void fence_acc(float* acc) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(acc[i])::"memory");
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// D[64 x N] (+)= A[64 x 32 bytes] . B[N x 32 bytes]^T: s8 x s8 -> s32 on int
// accumulators, bf16 x bf16 -> f32 on float ones (both K-major: no
// transpose, unit scales); scale_d = 0 ignores the old D. d holds the
// thread's N/2 accumulators. FENIX_WGMMA defines both for one N from the
// names of its registers and of the three operands after them.
template <int N>
__device__ __forceinline__ void wgmma(int* d, uint64_t a, uint64_t b, int scale_d);
template <int N>
__device__ __forceinline__ void wgmma(float* d, uint64_t a, uint64_t b, int scale_d);

#define FENIX_D4(c, i) c(d[i]), c(d[i + 1]), c(d[i + 2]), c(d[i + 3])
#define FENIX_D8(c, i) FENIX_D4(c, i), FENIX_D4(c, i + 4)
#define FENIX_D16(c, i) FENIX_D8(c, i), FENIX_D8(c, i + 8)
#define FENIX_D32(c, i) FENIX_D16(c, i), FENIX_D16(c, i + 16)
#define FENIX_D64(c, i) FENIX_D32(c, i), FENIX_D32(c, i + 32)
#define FENIX_D128(c, i) FENIX_D64(c, i), FENIX_D64(c, i + 64)

#define FENIX_WGMMA(N, DN, REGS, A, B, P)                                                       \
  template <>                                                                                   \
  __device__ __forceinline__ void wgmma<N>(int* d, uint64_t a, uint64_t b, int scale_d) {       \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " P ", 0;\n"                                 \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k32.s32.s8.s8 {" REGS "}, " A ", " B    \
                 ", p;\n}\n"                                                                     \
                 : FENIX_D##DN("+r", 0)                                                         \
                 : "l"(a), "l"(b), "r"(scale_d));                                               \
  }                                                                                             \
  template <>                                                                                   \
  __device__ __forceinline__ void wgmma<N>(float* d, uint64_t a, uint64_t b, int scale_d) {     \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " P ", 0;\n"                                 \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" REGS "}, " A ", " B \
                 ", p, 1, 1, 0, 0;\n}\n"                                                         \
                 : FENIX_D##DN("+f", 0)                                                         \
                 : "l"(a), "l"(b), "r"(scale_d));                                               \
  }

FENIX_WGMMA(8, 4,
            "%0, %1, %2, %3",
            "%4", "%5", "%6")
FENIX_WGMMA(16, 8,
            "%0, %1, %2, %3, %4, %5, %6, %7",
            "%8", "%9", "%10")
FENIX_WGMMA(32, 16,
            "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15",
            "%16", "%17", "%18")
FENIX_WGMMA(64, 32,
            "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
            "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31",
            "%32", "%33", "%34")
FENIX_WGMMA(128, 64,
            "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
            "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
            "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
            "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63",
            "%64", "%65", "%66")
FENIX_WGMMA(256, 128,
            "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
            "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
            "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
            "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
            "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
            "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
            "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
            "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
            "%124, %125, %126, %127",
            "%128", "%129", "%130")

#undef FENIX_WGMMA
#undef FENIX_D128
#undef FENIX_D64
#undef FENIX_D32
#undef FENIX_D16
#undef FENIX_D8
#undef FENIX_D4

// -- epilogue helpers -------------------------------------------------------------

// Value k of the row-combined fragment (column 8 (k / 2) + 2 (lane % 4) +
// k % 2) lives in accumulator slot 4 (k / 2) + k % 2.
__host__ __device__ constexpr int slot(int k) { return 4 * (k >> 1) + (k & 1); }
__host__ __device__ constexpr int halved(int len) { return len > 1 ? len / 2 : 1; }

// An accumulator slot as f32: after the epilogue's FMA an int slot holds
// the score's bits, a float slot the score.
__device__ __forceinline__ float as_float(int x) { return __int_as_float(x); }
__device__ __forceinline__ float as_float(float x) { return x; }
__device__ __forceinline__ void put_float(int& x, float f) { x = __float_as_int(f); }
__device__ __forceinline__ void put_float(float& x, float f) { x = f; }

// Max over the two lanes that differ in lane bit `bit`, for the first L
// values. With L >= 2 the partners split the work: the lane with the bit
// set keeps the upper half of the values, its partner the lower, each
// sending the other half across, so the values halve.
template <int L, typename A>
__device__ __forceinline__ void lane_max(A* v, int lane, int bit) {
  if constexpr (L == 1) {
    const float x = as_float(v[0]);
    put_float(v[0], fmaxf(x, __shfl_xor_sync(0xffffffffu, x, bit)));
  } else {
    const bool up = (lane & bit) != 0;
#pragma unroll
    for (int i = 0; i < L / 2; ++i) {
      const float lo = as_float(v[slot(i)]), hi = as_float(v[slot(i + L / 2)]);
      const float got = __shfl_xor_sync(0xffffffffu, up ? lo : hi, bit);
      put_float(v[slot(i)], fmaxf(up ? hi : lo, got));
    }
  }
}

// The fused score of the thread's fragment, in place. Slot 4j + e is row
// r, column 8j + cb + e, slot 4j + 2 + e row r + 8; for int8, isq2 points
// at the pair of inv_sq of columns 8j + cb, 8j + cb + 1 for j = 0. A row
// past N has mul 0 and add -inf, so it scores -inf. kCombine keeps only
// the max of the two rows, in slot 4j + e.
template <typename T, int BN, bool kCombine>
__device__ __forceinline__ void fuse(typename Elem<T>::Acc* acc, const float2* isq2, float mul0, float add0,
                                     float mul1, float add1) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float s0, s1;
      if constexpr (Elem<T>::kInvSq) {  // generic_kernel's expression, FMA spelled out
        const float2 isq = isq2[4 * j];
        const float iq = e ? isq.y : isq.x;
        s0 = fmaf(static_cast<float>(acc[4 * j + e]), mul0, add0 * iq);
        s1 = fmaf(static_cast<float>(acc[4 * j + 2 + e]), mul1, add1 * iq);
      } else {
        s0 = fmaf(acc[4 * j + e], mul0, add0);
        s1 = fmaf(acc[4 * j + 2 + e], mul1, add1);
      }
      if constexpr (kCombine) {
        put_float(acc[4 * j + e], fmaxf(s0, s1));
      } else {
        put_float(acc[4 * j + e], s0);
        put_float(acc[4 * j + 2 + e], s1);
      }
    }
  }
}

// The consumer warpgroups' barrier for the rows of 16-row maxima (named
// barrier 1; 0 is __syncthreads).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumerThreads) : "memory");
}

// Where column `col` of a row of 16-row maxima is kept: bits 5-7 of the
// column flip bits 0, 3 and 4, so the 32 lanes of a warp, whose columns
// differ in bits 1-2 and in three bits at or above bit 3, store to 32
// different banks.
__device__ __forceinline__ int red_col(int col) {
  return col ^ ((col >> 5) & 1) ^ (((col >> 6) & 1) << 3) ^ (((col >> 7) & 1) << 4);
}

// -- the generic producer: rows TMA cannot address ---------------------------------

// Bytes of k-slice `ks` of a row: 128, or what is left of the row.
__device__ __forceinline__ int slice_len(int64_t row_bytes, int ks) {
  const int64_t left = row_bytes - static_cast<int64_t>(ks) * kKb;
  return left < kKb ? static_cast<int>(left) : kKb;
}

// Row r of the swizzled V tile `tile` from a staged row whose slice starts
// at its byte o (0..15): aligned words joined by funnel shifts, every byte
// from `len` on zero. kAll loads every word of the slice before it uses
// any (33 in flight: the loads' latency, not their count, bounds the
// shifts), where the producer has the registers for it.
template <bool kAll>
__device__ __forceinline__ void row_shift(unsigned char* tile, const unsigned char* staged_row, int r, int o,
                                          int len) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(staged_row) + (o >> 2);
  const int sh = 8 * (o & 3);
  uint4* to = reinterpret_cast<uint4*>(tile + r * kKb);
  uint32_t x[kAll ? kKb / 4 + 1 : 2];
  if constexpr (kAll) {
#pragma unroll
    for (int k = 0; k <= kKb / 4; ++k) x[k] = w[k];
  } else {
    x[0] = w[0];
  }
#pragma unroll
  for (int c = 0; c < kKb / 16; ++c) {
    uint32_t out[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = 4 * c + j;
      uint32_t lo, hi;
      if constexpr (kAll) {
        lo = x[k];
        hi = x[k + 1];
      } else {
        lo = x[k & 1];
        hi = x[(k + 1) & 1] = w[k + 1];
      }
      const uint32_t y = __funnelshift_r(lo, hi, sh);
      const int left = len - 4 * k;  // valid bytes from this word on
      out[j] = left >= 4 ? y : left <= 0 ? 0u : y & ((1u << (8 * left)) - 1u);
    }
    to[c ^ (r & 7)] = make_uint4(out[0], out[1], out[2], out[3]);
  }
}

// Row r of the swizzled V tile from `len` bytes of V at `p`, read byte by
// byte (the few rows of the last tile that no copy reaches: copies end on
// a 16-byte boundary, or on the last whole super-row).
__device__ __forceinline__ void row_direct(unsigned char* tile, const unsigned char* p, int r, int len) {
  uint4* to = reinterpret_cast<uint4*>(tile + r * kKb);
  for (int c = 0; c < kKb / 16; ++c) {
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int b = 0; b < 16; ++b)
      if (16 * c + b < len) w[b >> 2] |= uint32_t(p[16 * c + b]) << (8 * (b & 3));
    to[c ^ (r & 7)] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// The producer warpgroup's barrier (named barrier 2).
__device__ __forceinline__ void producers_sync() { asm volatile("bar.sync 2, 128;\n" ::: "memory"); }

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// -- the kernel ------------------------------------------------------------------------

// tm_isq is read for int8 only. ksteps counts 128-byte slices of a row.
// kCopyV: V is read as `copy` says (tm_v, for boxes, addresses V's bytes as
// super-rows of 2^group_log2 rows, the fewest whose bytes are a multiple
// of 16, so that TMA can address them); else tm_v addresses V's rows and
// `copy` is not read.
template <typename T, int BN, bool kCopyV>
__global__ void __launch_bounds__(kThreads, 1)
    tensor_kernel(const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_mul, const __grid_constant__ CUtensorMap tm_add,
                  const __grid_constant__ CUtensorMap tm_isq, const Copy copy, float* __restrict__ out,
                  int64_t qt, int64_t n, int ksteps, int bucket_log2) {
  using R = Ring<BN, kCopyV>;
  constexpr int kElems = kKb / static_cast<int>(sizeof(T));  // elements of k per stage
  constexpr int kFactorBytes = 2 * kRows * 4 + (Elem<T>::kInvSq ? BN * 4 : 0);
  constexpr int kRs = R::kRs, kStages = R::kStages;
  // bytes TMA brings a stage: V and the query tile, or the query tile alone
  constexpr int kTmaBytes = kCopyV ? BN * kKb : R::kEp;
  // Registers a producer and a consumer thread keep: the consumers take
  // what the producers give up of the 168 a thread starts with (384
  // threads, one block an SM). The generic producer's shifts keep a row's
  // words in flight, where the consumers' accumulators leave room.
  constexpr bool kWide = kCopyV && BN <= 128;
  constexpr int kProducerRegs = kWide ? 56 : 40, kConsumerRegs = kWide ? 224 : 232;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + (1024 - smem_addr(smem_raw) % 1024) % 1024;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + R::kBar);
  uint64_t* empty = full + kStages;
  const int tid = threadIdx.x;
  const int64_t qtiles = (qt + BN - 1) / BN;
  const int64_t work = qtiles * ((n + kRows - 1) / kRows);

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      // the TMA thread's arrive + the bytes (+ one arrive per producer warp)
      mbar_init(full + s, kCopyV ? 5 : 1);
      mbar_init(empty + s, kConsumerThreads / 32);  // one arrive per consumer warp
    }
    if constexpr (kCopyV)
      for (int s = 0; s < kMaxSlots; ++s) mbar_init(empty + kStages + s, 1);  // the TMA thread's arrive + the bytes
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumerThreads) {
    // Producer warpgroup.
    if constexpr (kCopyV) {
      // Thread 0 stages V slots - 1 entries ahead: a tile's rows whole by
      // one bulk copy (the rows lie one after the other), or, where two
      // such entries do not fit, a k-slice in 2^group_log2 = g TMA boxes:
      // box i holds row i of each of the tile's super-rows (rows i, i + g,
      // ...), its slice and the bytes before it back to a 16-byte boundary
      // (a box must start on one), so row g j + i of the tile is row
      // i * 128 / g + j of the entry, starting at its byte (i * row_bytes)
      // % 16. For each k-slice, thread 0 then issues the stage's query tile
      // and factors by TMA and thread pt shifts row pt of the slice into
      // the stage, zero past D.
      setmaxnreg_dec<kProducerRegs>();
      const int pt = tid - kConsumerThreads, lane = tid & 31;
      const int64_t rb = copy.row_bytes;
      const int g = copy.group_log2, slots = copy.slots;
      const int box_rows = kRows >> g;
      const int64_t v_end = (n * rb) & ~int64_t(15);  // bulk copies end on a 16-byte boundary
      // rows read by copies; the rows after them (fewer than 16) by plain loads
      const int64_t n_copied = copy.whole ? v_end / rb : n >> g << g;
      const int sub = pt & ((1 << g) - 1);
      const int src = copy.whole ? pt : sub * box_rows + (pt >> g);  // row pt's row in a box entry
      const int o = static_cast<int>(((copy.whole ? pt : sub) * rb) & 15);
      unsigned char* staging = smem + R::kStaging;  // entry s at s * entry_bytes
      uint64_t* staged = empty + kStages;           // per entry: it has landed
      auto advance = [&](int64_t& w, int& ks) {
        if (++ks == ksteps) {
          ks = 0;
          w += gridDim.x;
        }
      };
      auto next_entry = [&](int64_t& w, int& ks) {
        if (copy.whole)
          w += gridDim.x;
        else
          advance(w, ks);
      };
      auto load = [&](int64_t w, int ks, int slot) {  // thread 0
        unsigned char* dst = staging + slot * copy.entry_bytes;
        const int64_t row0 = (w / qtiles) * kRows;
        if (copy.whole) {
          const int64_t from = row0 * rb, left = v_end - from;
          const int bytes = static_cast<int>(left < kRows * rb ? (left > 0 ? left : 0) : kRows * rb);
          mbar_expect_tx(staged + slot, bytes);
          if (bytes > 0) bulk_load(dst, copy.v + from, bytes, staged + slot);
        } else {
          mbar_expect_tx(staged + slot, n_copied > 0 ? kStagedBytes : 0);
          if (n_copied > 0)
            for (int i = 0; i < (1 << g); ++i)
              tma_load(smem_addr(dst + i * box_rows * kStagedRow), &tm_v,
                       static_cast<int>((i * rb + static_cast<int64_t>(ks) * kKb) & ~int64_t(15)),
                       static_cast<int>(row0 >> g), staged + slot);
        }
      };
      int64_t wl = blockIdx.x;  // the entry the loads have reached
      int kl = 0;
      for (int s = 0; s < slots - 1 && wl < work; ++s, next_entry(wl, kl))
        if (pt == 0) load(wl, kl, s);
      int stage = 0, slot = 0, used = 0;
      uint32_t phase = 0;
      int64_t w = blockIdx.x;
      int ks = 0;
      while (w < work) {
        if (!copy.whole || ks == 0) {  // the entry's first slice
          producers_sync();            // every row of the entry loaded next has been shifted out
          if (wl < work) {
            if (pt == 0) load(wl, kl, slot == 0 ? slots - 1 : slot - 1);
            next_entry(wl, kl);
          }
          mbar_wait(staged + slot, (used / slots) & 1);
        }
        const int64_t row0 = (w / qtiles) * kRows;
        const int q0 = static_cast<int>(w % qtiles) * BN;
        const bool last = ks == ksteps - 1;
        mbar_wait(empty + stage, phase ^ 1);
        if (pt == 0) {
          const uint32_t st = smem_addr(smem + stage * R::kStage);
          mbar_expect_tx(full + stage, kTmaBytes + (last ? kFactorBytes : 0));
          tma_load(st + kVBytes, &tm_q, ks * kElems, q0, full + stage);
          if (last) {
            tma_load(st + R::kEp, &tm_mul, static_cast<int>(row0), full + stage);
            tma_load(st + R::kEp + kRows * 4, &tm_add, static_cast<int>(row0), full + stage);
            if constexpr (Elem<T>::kInvSq) tma_load(st + R::kEp + 2 * kRows * 4, &tm_isq, q0, full + stage);
          }
        }
        const int64_t row = row0 + pt;
        const int len = row < n ? slice_len(rb, ks) : 0;
        unsigned char* tile = smem + stage * R::kStage;
        if (row >= n_copied && row < n) {
          row_direct(tile, copy.v + row * rb + static_cast<int64_t>(ks) * kKb, pt, len);
        } else {
          const unsigned char* entry = staging + slot * copy.entry_bytes;
          row_shift<kWide>(tile, copy.whole ? entry + ((pt * rb + static_cast<int64_t>(ks) * kKb) & ~int64_t(15))
                                            : entry + src * kStagedRow, pt, o, len);
        }
        fence_proxy_async();  // the stores (and this thread's reads of the entry), in order with the async proxy
        __syncwarp();
        if (lane == 0) mbar_arrive(full + stage);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
        if (!copy.whole || last) {  // the entry's last slice
          if (++slot == slots) slot = 0;
          ++used;
        }
        advance(w, ks);
      }
    } else {
      // One thread issues every copy.
      setmaxnreg_dec<kProducerRegs>();
      if (tid == kConsumerThreads) {
        int stage = 0;
        uint32_t phase = 0;
        for (int64_t w = blockIdx.x; w < work; w += gridDim.x) {
          const int row0 = static_cast<int>(w / qtiles) * kRows;
          const int q0 = static_cast<int>(w % qtiles) * BN;
          for (int ks = 0; ks < ksteps; ++ks) {
            const bool last = ks == ksteps - 1;
            mbar_wait(empty + stage, phase ^ 1);
            const uint32_t st = smem_addr(smem + stage * R::kStage);
            mbar_expect_tx(full + stage, kTmaBytes + (last ? kFactorBytes : 0));
            tma_load(st, &tm_v, ks * kElems, row0, full + stage);
            tma_load(st + kVBytes, &tm_q, ks * kElems, q0, full + stage);
            if (last) {
              tma_load(st + R::kEp, &tm_mul, row0, full + stage);
              tma_load(st + R::kEp + kRows * 4, &tm_add, row0, full + stage);
              if constexpr (Elem<T>::kInvSq) tma_load(st + R::kEp + 2 * kRows * 4, &tm_isq, q0, full + stage);
            }
            if (++stage == kStages) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
    }
  } else {
    // Consumer warpgroups: products, then the epilogue of each item.
    setmaxnreg_inc<kConsumerRegs>();
    const int wg = tid >> 7;
    const int warp = (tid >> 5) & 3;
    const int lane = tid & 31;
    const int cb = 2 * (lane & 3);                    // the thread's first column in each 8-column group
    const int r = wg * 64 + warp * 16 + (lane >> 2);  // its rows in the tile: r and r + 8
    const uint32_t ring = smem_addr(smem);
    float* red = reinterpret_cast<float*>(smem + R::kRed);
    const int bucket = 1 << bucket_log2;
    const int64_t nb = n >> bucket_log2;

    typename Elem<T>::Acc acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    int stage = 0, buf = 0;
    uint32_t phase = 0;
    for (int64_t w = blockIdx.x; w < work; w += gridDim.x, buf ^= 1) {
      const int64_t row0 = (w / qtiles) * kRows;
      const int64_t q0 = (w % qtiles) * BN;
      int held = 0;  // the stage whose products may still be running
      for (int ks = 0; ks < ksteps; ++ks) {
        mbar_wait(full + stage, phase);
        const uint32_t a = ring + stage * R::kStage + wg * (64 * kKb);
        const uint32_t b = ring + stage * R::kStage + kVBytes;
        fence_acc<BN / 2>(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kKb / 32; ++kk)
          wgmma<BN>(acc, smem_desc(a + 32 * kk), smem_desc(b + 32 * kk), (ks | kk) != 0);
        wgmma_commit();
        fence_acc<BN / 2>(acc);
        wgmma_wait<1>();  // the products of the stage before are done: free it
        if (ks > 0) {
          __syncwarp();
          if (lane == 0) mbar_arrive(empty + held);
        }
        held = stage;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_acc<BN / 2>(acc);

      // Fused score in place, as float bits, from the factors in the last
      // stage, which is freed once they are read.
      const float* ep = reinterpret_cast<const float*>(smem + held * R::kStage + R::kEp);
      const float2* isq2 = reinterpret_cast<const float2*>(ep + 2 * kRows) + (cb >> 1);
      const bool live0 = row0 + r < n, live1 = row0 + r + 8 < n;
      const float mul0 = ep[r], add0 = live0 ? ep[kRows + r] : -INFINITY;  // TMA: mul 0 past N
      const float mul1 = ep[r + 8], add1 = live1 ? ep[kRows + r + 8] : -INFINITY;
      const bool combine = bucket >= 16;
      if (combine)
        fuse<T, BN, true>(acc, isq2, mul0, add0, mul1, add1);
      else
        fuse<T, BN, false>(acc, isq2, mul0, add0, mul1, add1);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + held);

      if (combine) {
        // the warp's 16 rows of each column, then the tile's rows of
        // 16-row maxima in shared memory
        constexpr int L1 = BN / 4, L2 = halved(L1), L3 = halved(L2), LF = halved(L3);
        lane_max<L1>(acc, lane, 4);
        lane_max<L2>(acc, lane, 8);
        lane_max<L3>(acc, lane, 16);
        const int first = ((L1 > 1 && (lane & 4)) ? L1 / 2 : 0) + ((L2 > 1 && (lane & 8)) ? L2 / 2 : 0) +
                          ((L3 > 1 && (lane & 16)) ? L3 / 2 : 0);
        float* rows = red + buf * kGroups * kRs;
        float* mine = rows + (wg * 4 + warp) * kRs;
#pragma unroll
        for (int i = 0; i < LF; ++i) {
          const int k = first + i;
          mine[red_col(8 * (k >> 1) + cb + (k & 1))] = as_float(acc[slot(i)]);
        }
        consumers_sync();
        // bucket maxima; a query's buckets are contiguous in `out`, so the
        // bucket index runs fastest
        const int per = bucket >> 4, tiles_log2 = 7 - bucket_log2;
        const int64_t b0 = row0 >> bucket_log2;
        for (int idx = tid; idx < (BN << tiles_log2); idx += kConsumerThreads) {
          const int bt = idx & ((1 << tiles_log2) - 1), c = idx >> tiles_log2;
          const float* src = rows + bt * per * kRs + red_col(c);
          float m = src[0];
          for (int h = 1; h < per; ++h) m = fmaxf(m, src[h * kRs]);
          if (q0 + c < qt && b0 + bt < nb) out[(q0 + c) * nb + b0 + bt] = m;
        }
      } else {
        // buckets of 1..8 rows lie in one 8-row half: lane bits 2..4
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          float x = as_float(acc[i]);
          for (int off = 4; off < (4 << bucket_log2); off <<= 1)
            x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
          put_float(acc[i], x);
        }
        if (((lane >> 2) & (bucket - 1)) == 0) {
          const int64_t left = qt - q0;
          const int qlim = static_cast<int>(left < BN ? left : BN) - cb;  // live: 8j + e < qlim
          const int64_t o0 = (row0 + r) >> bucket_log2, o1 = (row0 + r + 8) >> bucket_log2;
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              if (8 * j + e >= qlim) continue;
              float* row = out + (q0 + 8 * j + cb + e) * nb;
              if (live0) row[o0] = as_float(acc[4 * j + e]);
              if (live1) row[o1] = as_float(acc[4 * j + 2 + e]);
            }
          }
        }
      }
    }
  }
}

// -- host side ----------------------------------------------------------------------

// A row-major [rows, d] matrix of T as TMA boxes of box_rows rows x 128
// bytes of k, 128-byte swizzled; reads past either edge fill with zeros.
template <typename T>
bool encode_rows(CUtensorMap* map, const void* base, int64_t rows, int64_t d, int box_rows) {
  return fenix::encode_rows(map, Elem<T>::kTma, sizeof(T), base, rows, d, box_rows);
}

// Rows of a query batch of width d as the generic designs take it: padded
// to 16 bytes.
template <typename T>
int64_t padded_width(int64_t d) {
  constexpr int64_t per = 16 / sizeof(T);
  return (d + per - 1) / per * per;
}

template <typename T, int BN, bool kCopyV>
int launch_bn(const void* q, const void* v, const float* aux_mul, const float* aux_add,
              const float* inv_sq, float* out, int64_t qt, int64_t n, int64_t d, int bucket_log2,
              cudaStream_t stream) {
  auto kernel = tensor_kernel<T, BN, kCopyV>;
  using R = Ring<BN, kCopyV>;
  static Occupancy occ;
  int per_sm = 0, sms = 0;
  if (!launch_shape(occ, kernel, kThreads, R::kBytes, &per_sm, &sms))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  CUtensorMap tm_v, tm_q, tm_mul, tm_add, tm_isq;
  if (!encode_rows<T>(&tm_q, q, qt, kCopyV ? padded_width<T>(d) : d, BN) ||
      !encode_vector(&tm_mul, aux_mul, n, kRows) || !encode_vector(&tm_add, aux_add, n, kRows))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t row_bytes = d * static_cast<int64_t>(sizeof(T));
  Copy copy{static_cast<const unsigned char*>(v), row_bytes, 0, 0, kStagedBytes, 0};
  if constexpr (kCopyV) {
    // a tile's rows whole (and the bytes its last row's shifts read past
    // it), where two fit and the rows are not 16-byte strided (a warp's
    // reads of such rows would meet on a few banks); else k-slices in
    // boxes of super-rows
    const int64_t whole_bytes = (kRows * row_bytes + kStagedRow + 15) & ~int64_t(15);
    copy.whole = row_bytes % 16 != 0 && 2 * whole_bytes <= R::kStagingBytes;
    if (copy.whole) copy.entry_bytes = static_cast<int>(whole_bytes);
    copy.slots = std::min<int>(kMaxSlots, R::kStagingBytes / copy.entry_bytes);
    // super-rows of 2^group_log2 rows: the fewest whose bytes are a multiple of 16
    while (((row_bytes << copy.group_log2) & 15) != 0) ++copy.group_log2;
    // V's bytes as [N >> group_log2, row_bytes << group_log2]: whole
    // super-rows only, so no box reads past the end of V (the rows after
    // them go by plain loads)
    const int g = copy.group_log2;
    if (copy.whole || (n >> g) == 0)
      tm_v = tm_q;  // never read
    else if (!encode_bytes(&tm_v, v, n >> g, row_bytes << g, kStagedRow, kRows >> g))
      return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (!encode_rows<T>(&tm_v, v, n, d, kRows)) return static_cast<int>(cudaErrorInvalidValue);
  }
  if constexpr (Elem<T>::kInvSq) {
    if (!encode_vector(&tm_isq, inv_sq, qt, BN)) return static_cast<int>(cudaErrorInvalidValue);
  } else {
    tm_isq = tm_mul;  // never read
  }
  const int64_t work = (qt + BN - 1) / BN * ((n + kRows - 1) / kRows);
  const int64_t blocks = std::min(work, static_cast<int64_t>(per_sm) * sms);
  const int64_t ksteps = (row_bytes + kKb - 1) / kKb;
  kernel<<<static_cast<unsigned>(blocks), kThreads, R::kBytes, stream>>>(
      tm_v, tm_q, tm_mul, tm_add, tm_isq, copy, out, qt, n, static_cast<int>(ksteps), bucket_log2);
  return static_cast<int>(cudaGetLastError());
}

// The narrowest query tile that holds the batch; 256 and several tiles above.
// kCopyV: any d, q [qt, padded_width(d)]; else d of a multiple of 16 bytes.
template <typename T, bool kCopyV>
int launch_t(const void* q, const void* v, const float* aux_mul, const float* aux_add, const float* inv_sq,
             float* out, int64_t qt, int64_t n, int64_t d, int bucket_log2, cudaStream_t stream) {
  // TMA: 16-byte row strides, int32 box coordinates
  if ((!kCopyV && (d * static_cast<int64_t>(sizeof(T))) % 16 != 0) || n >= (int64_t(1) << 31) ||
      qt >= (int64_t(1) << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* a = aux_mul;
  const auto* b = aux_add;
  if (qt <= 8) return launch_bn<T, 8, kCopyV>(q, v, a, b, inv_sq, out, qt, n, d, bucket_log2, stream);
  if (qt <= 16) return launch_bn<T, 16, kCopyV>(q, v, a, b, inv_sq, out, qt, n, d, bucket_log2, stream);
  if (qt <= 32) return launch_bn<T, 32, kCopyV>(q, v, a, b, inv_sq, out, qt, n, d, bucket_log2, stream);
  if (qt <= 64) return launch_bn<T, 64, kCopyV>(q, v, a, b, inv_sq, out, qt, n, d, bucket_log2, stream);
  if (qt <= 128) return launch_bn<T, 128, kCopyV>(q, v, a, b, inv_sq, out, qt, n, d, bucket_log2, stream);
  return launch_bn<T, 256, kCopyV>(q, v, a, b, inv_sq, out, qt, n, d, bucket_log2, stream);
}

}  // namespace

int launch_tensor_int8(const void* q, const void* v, const float* aux_mul, const float* aux_add,
                       const float* inv_sq, float* out, int64_t qt, int64_t n, int64_t d,
                       int bucket_log2, cudaStream_t stream) {
  return launch_t<int8_t, false>(q, v, aux_mul, aux_add, inv_sq, out, qt, n, d, bucket_log2, stream);
}

int launch_tensor_bf16(const void* q, const void* v, const float* aux_mul, const float* aux_add, float* out,
                       int64_t qt, int64_t n, int64_t d, int bucket_log2, cudaStream_t stream) {
  return launch_t<__nv_bfloat16, false>(q, v, aux_mul, aux_add, nullptr, out, qt, n, d, bucket_log2, stream);
}

int launch_generic_int8(const void* q, const void* v, const float* aux_mul, const float* aux_add,
                        const float* inv_sq, float* out, int64_t qt, int64_t n, int64_t d,
                        int bucket_log2, cudaStream_t stream) {
  return launch_t<int8_t, true>(q, v, aux_mul, aux_add, inv_sq, out, qt, n, d, bucket_log2, stream);
}

int launch_generic_bf16(const void* q, const void* v, const float* aux_mul, const float* aux_add, float* out,
                        int64_t qt, int64_t n, int64_t d, int bucket_log2, cudaStream_t stream) {
  return launch_t<__nv_bfloat16, true>(q, v, aux_mul, aux_add, nullptr, out, qt, n, d, bucket_log2, stream);
}

}  // namespace fenix
