// Helpers shared by the phase-1 kernels: asynchronous 16-byte copies,
// bf16 widening, the launch-shape queries the persistent kernels use, and
// the designs' entry points.

#pragma once

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

// Raw storage type of one element: the scalar (unaligned) load paths
// copy bits, so bf16 needs no arithmetic operators.
template <typename T>
struct Raw;
template <>
struct Raw<float> {
  using type = uint32_t;
};
template <>
struct Raw<__nv_bfloat16> {
  using type = uint16_t;
};

// Four consecutive elements at `p` in shared memory, widened to f32
// (16 bytes for f32, 8 for bf16; `p` aligned to that size).
__device__ __forceinline__ void load4(const float* p, float* x) {
  const float4 w = *reinterpret_cast<const float4*>(p);
  x[0] = w.x;
  x[1] = w.y;
  x[2] = w.z;
  x[3] = w.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* x) {
  // a bf16 is the high half of an f32: widening is a shift, exactly
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  x[0] = __uint_as_float(w.x << 16);
  x[1] = __uint_as_float(w.x & 0xffff0000u);
  x[2] = __uint_as_float(w.y << 16);
  x[3] = __uint_as_float(w.y & 0xffff0000u);
}

// The 16 bytes at `p` in shared memory (4 f32 or 8 bf16), widened to f32.
__device__ __forceinline__ void load16(const float* p, float* x) { load4(p, x); }

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* x) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(words[i] << 16);
    x[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
  }
}

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

// Entry points of the two f32/bf16 designs (q is f32 in both: the
// wrapper widens a bf16 query batch, which is QT x D and small).
int launch_stream(int dtype, const float* q, const void* v, const float* aux_mul,
                  const float* aux_add, float* out, int64_t qt, int64_t n, int64_t d,
                  int bucket_log2, cudaStream_t stream);
int launch_tiled(int dtype, const float* q, const void* v, const float* aux_mul,
                 const float* aux_add, float* out, int64_t qt, int64_t n, int64_t d,
                 int bucket_log2, cudaStream_t stream);
// Entry point of the int8 tensor-core design (int8 q and v, D a multiple
// of 16).
int launch_tensor_int8(const void* q, const void* v, const float* aux_mul, const float* aux_add,
                       const float* inv_sq, float* out, int64_t qt, int64_t n, int64_t d,
                       int bucket_log2, cudaStream_t stream);

}  // namespace fenix
