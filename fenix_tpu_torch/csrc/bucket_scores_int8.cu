// bucket_scores_int8: K2, the int8 phase-1 kernel, on the H100's tensor
// cores (design "tensor_int8").
//
// Replaces kernel_int8 of fenix_tpu/ops/topk2.py:bucket_scores_pallas_bigq
// (fenix_tpu/ops/topk2.py:464). For corpus row i and query j it computes
//
//   s = f32(v8_i . q8_j) * aux_mul[i] + aux_add[i] * inv_sq[j]
//
// and writes out[j, b] = max over the `bucket` rows of bucket b (buckets of
// 1..128 rows), query-major [QT, N/bucket]. Rows at or past N score -inf;
// queries past QT are never written. The integer sum is exact
// (127^2 * D < 2^31) and the epilogue is generic_kernel's expression
// (bucket_scores.cu), so the two designs give the same maxima.
//
// What bounds it on an H100 (3.35 TB/s; 1,979 TOP/s int8 on the tensor
// cores, ~590 operations per byte where the two meet): at small Q the read
// of V (2 Q operations per byte of V); at Q = 1024 and D = 768 the int8
// products (6.6 TOP, 3.3 ms). Between them, at large Q and small D, the
// epilogue: every score costs a conversion, a multiply, an FMA and its
// share of the maxima on the CUDA cores, and each byte of V yields Q / D
// scores, so at Q = 256 and D = 128 the epilogue, not the read or the
// products, takes most of the time. What the design does about each:
// - Tensor cores: wgmma.mma_async m64nNk32 s32.s8.s8. The corpus tile is A
//   (rows on M) and the query tile B, both K-major as v8 and q8 lie in
//   memory, so nothing is transposed. N, the query tile, is picked from Q
//   among 8..256; Q = 1..7 pads to 8 with the zero rows TMA fills past QT.
// - Copies: TMA (cp.async.bulk.tensor) moves 128-byte k-slices of a
//   128-row V tile and of the query tile into a ring of 128-byte-swizzled
//   stages, each signalled by an mbarrier. One producer thread issues them;
//   two consumer warpgroups (64 rows each) issue the products and free a
//   stage as soon as its products finish. 4 to 8 stages (by query-tile
//   width) keep 64-128 KB of V in flight per SM.
// - Grid: one persistent block per SM walks (row tile, query tile) items
//   with the query tile fastest, so a row tile's query tiles run together
//   on neighbouring blocks and V is read from device memory once (the
//   other reads of a row tile hit L2).
// - Epilogue in registers: aux_mul and aux_add of the tile's rows and inv_sq
//   of its queries come by TMA with the item's last k-step, so no consumer
//   waits on a device-memory load; the per-row FMA on the accumulator fragment
//   (rows lane/4 and lane/4 + 8 of the warp's 16-row slab), the max of the
//   thread's two rows, then a max over lane bits 2-4 in which the partners
//   split their values (56 shuffles for the 64 values of N = 256, not 192).
//   For buckets of 16..128 rows the 16-row maxima meet in shared memory
//   and the bucket maxima are written from there, a query's buckets
//   contiguous; buckets of 1..8 rows reduce by shuffles and write per row.
// - TMA needs 16-byte row strides, so only D that is a multiple of 16 is
//   served here; the wrapper sends any other D to generic_kernel.

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

// Shared memory of a BN-query tile: the stage ring (each stage: V, the
// query tile, and the epilogue's per-row and per-query factors, which come
// with an item's last k-step), the double-buffered rows of 16-row maxima
// and the mbarriers, plus 1 KB to align the base to the 1024 bytes over
// which the 128-byte swizzle repeats; every tile starts on such a
// boundary. As many stages as fit, up to 8.
template <int BN>
struct Ring {
  static constexpr int kRs = BN + 4;  // floats per row of 16-row maxima (+4: banks of the reads)
  static constexpr int kEp = kVBytes + BN * kKb;
  static constexpr int kStage = kEp + kEpBytes;
  static constexpr int kRedBytes = 2 * kGroups * kRs * 4;
  static constexpr int kStages = (kSmemMax - 1024 - kRedBytes) / (kStage + 16) < 8
                                     ? (kSmemMax - 1024 - kRedBytes) / (kStage + 16)
                                     : 8;
  static constexpr int kRed = kStages * kStage;
  static constexpr int kBar = kRed + kRedBytes;
  static constexpr int kBytes = kBar + 2 * kStages * 8 + 1024;
  static_assert(kStages >= 2 && kBytes <= kSmemMax, "the ring does not fit");
};

// -- mbarriers, TMA, wgmma (PTX) ------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Wait for the completion of the barrier's phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// One 2-D TMA tile, box origin (x bytes of k, row y), completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int x, int y,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(smem_addr(bar))
      : "memory");
}

// One 1-D TMA box from element x, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int x, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2}], [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(smem_addr(bar))
      : "memory");
}

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
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// D[64 x N] (+)= A[64 x 32] . B[N x 32]^T, s8 x s8 -> s32; scale_d = 0
// ignores the old D. d holds the thread's N/2 accumulators.
template <int N>
__device__ __forceinline__ void wgmma(int* d, uint64_t a, uint64_t b, int scale_d);

template <>
__device__ __forceinline__ void wgmma<8>(int* d, uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<16>(int* d, uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<32>(int* d, uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<64>(int* d, uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<128>(int* d, uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
        "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
        "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<256>(int* d, uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
      "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
      "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
      "%124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
        "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
        "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
        "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]),
        "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]),
        "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
        "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]), "+r"(d[96]), "+r"(d[97]),
        "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]),
        "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]), "+r"(d[120]), "+r"(d[121]),
        "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(a), "l"(b), "r"(scale_d));
}

// -- epilogue helpers -------------------------------------------------------------

// Value k of the row-combined fragment (column 8 (k / 2) + 2 (lane % 4) +
// k % 2) lives in accumulator slot 4 (k / 2) + k % 2.
__host__ __device__ constexpr int slot(int k) { return 4 * (k >> 1) + (k & 1); }
__host__ __device__ constexpr int halved(int len) { return len > 1 ? len / 2 : 1; }

// Max over the two lanes that differ in lane bit `bit`, for the first L
// values (as float bits). With L >= 2 the partners split the work: the lane
// with the bit set keeps the upper half of the values, its partner the
// lower, each sending the other half across, so the values halve.
template <int L>
__device__ __forceinline__ void lane_max(int* v, int lane, int bit) {
  if constexpr (L == 1) {
    const float x = __int_as_float(v[0]);
    v[0] = __float_as_int(fmaxf(x, __shfl_xor_sync(0xffffffffu, x, bit)));
  } else {
    const bool up = (lane & bit) != 0;
#pragma unroll
    for (int i = 0; i < L / 2; ++i) {
      const float lo = __int_as_float(v[slot(i)]), hi = __int_as_float(v[slot(i + L / 2)]);
      const float got = __shfl_xor_sync(0xffffffffu, up ? lo : hi, bit);
      v[slot(i)] = __float_as_int(fmaxf(up ? hi : lo, got));
    }
  }
}

// The fused score of the thread's fragment, in place as float bits. Slot
// 4j + e is row r, column 8j + cb + e, slot 4j + 2 + e row r + 8; isq2
// points at the pair of inv_sq of columns 8j + cb, 8j + cb + 1 for j = 0.
// A row past N has mul 0 and add -inf, so it scores -inf. kCombine keeps
// only the max of the two rows, in slot 4j + e.
template <int BN, bool kCombine>
__device__ __forceinline__ void fuse(int* acc, const float2* isq2, float mul0, float add0, float mul1,
                                     float add1) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const float2 isq = isq2[4 * j];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float iq = e ? isq.y : isq.x;
      const float s0 = static_cast<float>(acc[4 * j + e]) * mul0 + add0 * iq;
      const float s1 = static_cast<float>(acc[4 * j + 2 + e]) * mul1 + add1 * iq;
      if constexpr (kCombine) {
        acc[4 * j + e] = __float_as_int(fmaxf(s0, s1));
      } else {
        acc[4 * j + e] = __float_as_int(s0);
        acc[4 * j + 2 + e] = __float_as_int(s1);
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

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
    tensor_int8_kernel(const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_mul, const __grid_constant__ CUtensorMap tm_add,
                       const __grid_constant__ CUtensorMap tm_isq, float* __restrict__ out, int64_t qt,
                       int64_t n, int ksteps, int bucket_log2) {
  using R = Ring<BN>;
  constexpr int kRs = R::kRs, kStages = R::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + (1024 - smem_addr(smem_raw) % 1024) % 1024;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + R::kBar);
  uint64_t* empty = full + kStages;
  const int tid = threadIdx.x;
  const int64_t qtiles = (qt + BN - 1) / BN;
  const int64_t work = qtiles * ((n + kRows - 1) / kRows);

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);                        // the producer's arrive + the bytes
      mbar_init(empty + s, kConsumerThreads / 32);  // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumerThreads) {
    // Producer warpgroup: one thread issues every copy.
    setmaxnreg_dec<40>();
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
          mbar_expect_tx(full + stage, R::kEp + (last ? 2 * kRows * 4 + BN * 4 : 0));
          tma_load(st, &tm_v, ks * kKb, row0, full + stage);
          tma_load(st + kVBytes, &tm_q, ks * kKb, q0, full + stage);
          if (last) {
            tma_load(st + R::kEp, &tm_mul, row0, full + stage);
            tma_load(st + R::kEp + kRows * 4, &tm_add, row0, full + stage);
            tma_load(st + R::kEp + 2 * kRows * 4, &tm_isq, q0, full + stage);
          }
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // Consumer warpgroups: products, then the epilogue of each item.
    setmaxnreg_inc<232>();
    const int wg = tid >> 7;
    const int warp = (tid >> 5) & 3;
    const int lane = tid & 31;
    const int cb = 2 * (lane & 3);                    // the thread's first column in each 8-column group
    const int r = wg * 64 + warp * 16 + (lane >> 2);  // its rows in the tile: r and r + 8
    const uint32_t ring = smem_addr(smem);
    float* red = reinterpret_cast<float*>(smem + R::kRed);
    const int bucket = 1 << bucket_log2;
    const int64_t nb = n >> bucket_log2;

    int acc[BN / 2];
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
        fuse<BN, true>(acc, isq2, mul0, add0, mul1, add1);
      else
        fuse<BN, false>(acc, isq2, mul0, add0, mul1, add1);
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
          mine[red_col(8 * (k >> 1) + cb + (k & 1))] = __int_as_float(acc[slot(i)]);
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
          float x = __int_as_float(acc[i]);
          for (int off = 4; off < (4 << bucket_log2); off <<= 1)
            x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
          acc[i] = __float_as_int(x);
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
              if (live0) row[o0] = __int_as_float(acc[4 * j + e]);
              if (live1) row[o1] = __int_as_float(acc[4 * j + 2 + e]);
            }
          }
        }
      }
    }
  }
}

// -- host side ----------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API function; the runtime hands out
// its address, so the library needs no link to libcuda.
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A row-major [rows, d] int8 matrix as TMA boxes of box_rows rows x 128
// bytes of k, 128-byte swizzled; reads past either edge fill with zeros.
bool encode_rows(CUtensorMap* map, const void* base, int64_t rows, int64_t d, int box_rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(d)};
  const cuuint32_t box[2] = {kKb, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// An f32 vector of `len` as TMA boxes of `box` elements; zeros past its end.
bool encode_vector(CUtensorMap* map, const float* base, int64_t len, int box) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[1] = {static_cast<cuuint64_t>(len)};
  const cuuint64_t strides[1] = {4};  // unused for one dimension
  const cuuint32_t boxes[1] = {static_cast<cuuint32_t>(box)};
  const cuuint32_t unit[1] = {1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<float*>(base), dims, strides, boxes,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN>
int launch_bn(const void* q, const void* v, const float* aux_mul, const float* aux_add,
              const float* inv_sq, float* out, int64_t qt, int64_t n, int64_t d, int bucket_log2,
              cudaStream_t stream) {
  auto kernel = tensor_int8_kernel<BN>;
  static Occupancy occ;
  int per_sm = 0, sms = 0;
  if (!launch_shape(occ, kernel, kThreads, Ring<BN>::kBytes, &per_sm, &sms))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  CUtensorMap tm_v, tm_q, tm_mul, tm_add, tm_isq;
  if (!encode_rows(&tm_v, v, n, d, kRows) || !encode_rows(&tm_q, q, qt, d, BN) ||
      !encode_vector(&tm_mul, aux_mul, n, kRows) || !encode_vector(&tm_add, aux_add, n, kRows) ||
      !encode_vector(&tm_isq, inv_sq, qt, BN))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t work = (qt + BN - 1) / BN * ((n + kRows - 1) / kRows);
  const int64_t blocks = std::min(work, static_cast<int64_t>(per_sm) * sms);
  kernel<<<static_cast<unsigned>(blocks), kThreads, Ring<BN>::kBytes, stream>>>(
      tm_v, tm_q, tm_mul, tm_add, tm_isq, out, qt, n, static_cast<int>((d + kKb - 1) / kKb), bucket_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

int launch_tensor_int8(const void* q, const void* v, const float* aux_mul, const float* aux_add,
                       const float* inv_sq, float* out, int64_t qt, int64_t n, int64_t d,
                       int bucket_log2, cudaStream_t stream) {
  // TMA: 16-byte row strides, int32 box coordinates
  if (d % 16 != 0 || n >= (int64_t(1) << 31) || qt >= (int64_t(1) << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  // the narrowest query tile that holds the batch; 256 and several tiles above
  const auto* a = aux_mul;
  const auto* b = aux_add;
  if (qt <= 8) return launch_bn<8>(q, v, a, b, inv_sq, out, qt, n, d, bucket_log2, stream);
  if (qt <= 16) return launch_bn<16>(q, v, a, b, inv_sq, out, qt, n, d, bucket_log2, stream);
  if (qt <= 32) return launch_bn<32>(q, v, a, b, inv_sq, out, qt, n, d, bucket_log2, stream);
  if (qt <= 64) return launch_bn<64>(q, v, a, b, inv_sq, out, qt, n, d, bucket_log2, stream);
  if (qt <= 128) return launch_bn<128>(q, v, a, b, inv_sq, out, qt, n, d, bucket_log2, stream);
  return launch_bn<256>(q, v, a, b, inv_sq, out, qt, n, d, bucket_log2, stream);
}

}  // namespace fenix
