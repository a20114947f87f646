// Helpers shared by the phase-1 kernels: asynchronous 16-byte and bulk
// copies, mbarriers and TMA tiles, f32 shared-memory loads, the launch-shape
// queries the persistent kernels use, and the designs' entry points.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

namespace fenix {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy global -> shared that bypasses L1; only the first
// `src_bytes` (0..16) are read, the rest of the 16 bytes are zero-filled.
// The L2::128B hint lets L2 fetch whole 128-byte lines from device
// memory, which the row slices read in full.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// -- mbarriers and TMA (PTX) --------------------------------------------------

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

// One 2-D TMA tile, box origin (element x of k, row y), completing on `bar`.
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

// A bulk copy of `bytes` (a multiple of 16) from 16-byte-aligned global
// memory to 16-byte-aligned shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes), "r"(smem_addr(bar))
               : "memory");
}

// -- TMA descriptors (host) --------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API function; the runtime hands out
// its address, so the library needs no link to libcuda.
inline EncodeTiled encoder() {
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

// A row-major [rows, d] matrix of `elem_bytes`-byte elements as TMA boxes
// of box_rows rows x 128 bytes of k, 128-byte swizzled (16-byte chunk c of
// row r lands at chunk c ^ (r % 8) of its 128-byte row, the tile 1024-byte
// aligned); reads past either edge fill with zeros.
inline bool encode_rows(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes, const void* base,
                        int64_t rows, int64_t d, int box_rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(d * elem_bytes)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(128 / elem_bytes), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A row-major [rows, row_bytes] byte matrix as TMA boxes of box_rows rows x
// box_bytes, unswizzled (box rows box_bytes apart in shared memory); reads
// past either edge fill with zeros. Box origins must be 16-byte aligned.
inline bool encode_bytes(CUtensorMap* map, const void* base, int64_t rows, int64_t row_bytes, int box_bytes,
                         int box_rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(row_bytes), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(row_bytes)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_bytes), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// An f32 vector of `len` as TMA boxes of `box` elements; zeros past its end.
inline bool encode_vector(CUtensorMap* map, const float* base, int64_t len, int box) {
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

// Raw storage type of one element: the scalar (unaligned) load paths
// copy bits.
template <typename T>
struct Raw;
template <>
struct Raw<float> {
  using type = uint32_t;
};

// Four consecutive f32 at `p` in shared memory (16-byte aligned).
__device__ __forceinline__ void load4(const float* p, float* x) {
  const float4 w = *reinterpret_cast<const float4*>(p);
  x[0] = w.x;
  x[1] = w.y;
  x[2] = w.z;
  x[3] = w.w;
}

// The 16 bytes at `p` in shared memory: 4 f32.
__device__ __forceinline__ void load16(const float* p, float* x) { load4(p, x); }

// Blocks of `kernel` that fit one SM at `threads` threads and `smem`
// dynamic shared bytes, after raising the kernel's shared-memory cap.
// Returns 0 if the kernel cannot run at that shape.
template <typename Kernel>
int blocks_per_sm(Kernel kernel, int threads, int smem) {
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) != cudaSuccess)
    return 0;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem) != cudaSuccess)
    return 0;
  return blocks;
}

inline int sm_count(int dev) {
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  return sms;
}

constexpr int kMaxDevices = 64;

// The launch shape of one kernel instantiation, kept per device: the
// shared-memory cap that `blocks_per_sm` raises holds for the current
// device's context only, so each card raises it on its own first launch
// (a cap raised on the first card alone would refuse the launch on the
// next one).
struct Occupancy {
  std::once_flag once[kMaxDevices];
  int per_sm[kMaxDevices] = {};
  int sms[kMaxDevices] = {};
};

// Blocks per SM and SM count of `kernel` on the current device, computed
// on the first launch there. False if the kernel cannot run on it.
template <typename Kernel>
bool launch_shape(Occupancy& occ, Kernel kernel, int threads, int smem, int* per_sm, int* sms) {
  int dev = -1;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) return false;
  std::call_once(occ.once[dev], [&] {
    occ.per_sm[dev] = blocks_per_sm(kernel, threads, smem);
    occ.sms[dev] = sm_count(dev);
  });
  *per_sm = occ.per_sm[dev];
  *sms = occ.sms[dev];
  return *per_sm > 0 && *sms > 0;
}

// Entry points of the two f32 designs.
int launch_stream(const float* q, const void* v, const float* aux_mul, const float* aux_add, float* out,
                  int64_t qt, int64_t n, int64_t d, int bucket_log2, cudaStream_t stream);
int launch_tiled(const float* q, const void* v, const float* aux_mul, const float* aux_add, float* out,
                 int64_t qt, int64_t n, int64_t d, int bucket_log2, cudaStream_t stream);
// Entry points of the tensor-core designs (bucket_scores_tensor.cu): int8 q
// and v with D a multiple of 16 and bf16 q and v with D a multiple of 8
// (tensor_*), or int8 and bf16 at any D with q zero-padded to 16-byte rows,
// [QT, D rounded up to 16 bytes] (generic_*).
int launch_tensor_int8(const void* q, const void* v, const float* aux_mul, const float* aux_add,
                       const float* inv_sq, float* out, int64_t qt, int64_t n, int64_t d,
                       int bucket_log2, cudaStream_t stream);
int launch_tensor_bf16(const void* q, const void* v, const float* aux_mul, const float* aux_add, float* out,
                       int64_t qt, int64_t n, int64_t d, int bucket_log2, cudaStream_t stream);
int launch_generic_int8(const void* q, const void* v, const float* aux_mul, const float* aux_add,
                        const float* inv_sq, float* out, int64_t qt, int64_t n, int64_t d,
                        int bucket_log2, cudaStream_t stream);
int launch_generic_bf16(const void* q, const void* v, const float* aux_mul, const float* aux_add, float* out,
                        int64_t qt, int64_t n, int64_t d, int bucket_log2, cudaStream_t stream);

}  // namespace fenix
