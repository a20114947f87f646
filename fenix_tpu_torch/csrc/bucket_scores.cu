// Phase 1 of the two-phase exact top-k search on Hopper: per-bucket
// maxima of the fused score, with only the maxima written to memory.
// This file holds the C entry point of all six phase-1 designs:
// - f32 corpora take bucket_scores_stream.cu (small Q) or
//   bucket_scores_tiled.cu (large Q), on the CUDA cores;
// - int8 and bf16 corpora take the tensor cores, in one frame
//   (bucket_scores_tensor.cu): "tensor_int8" / "tensor_bf16" for rows of a
//   multiple of 16 bytes, which TMA addresses, and "generic_int8" /
//   "generic_bf16" for every other D, whose rows the frame's second
//   producer copies. Which one serves a call is a shape rule of the caller
//   (fenix_tpu_torch/ops/kernels.py:kernel_for), not a fallback.
// Each source's note says which TPU kernel its designs replace, what
// bounds them on the card and what they do about it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

// dtype: 0 = float32, 1 = bfloat16, 2 = int8 (inv_sq required).
// kernel: 0 = stream, 1 = tiled (f32 corpus and queries),
//         2 = generic_int8, 3 = tensor_int8 (int8 corpus and queries; 3
//         needs D a multiple of 16), 4 = tensor_bf16 (bf16 corpus and
//         queries, D a multiple of 8), 5 = generic_bf16 (bf16 corpus and
//         queries); 2 and 5 take any D, with q zero-padded to 16-byte rows
//         ([QT, D rounded up to 16 bytes]).
// Returns the cudaError_t of the launch (0 = success).
extern "C" int fenix_bucket_scores(int dtype, int kernel, const void* q, const void* v,
                                   const float* aux_mul, const float* aux_add,
                                   const float* inv_sq, float* out, int64_t qt, int64_t n,
                                   int64_t d, int bucket_log2, void* stream) {
  if (qt <= 0 || n <= 0 || d <= 0 || bucket_log2 < 0 || bucket_log2 > 7)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((n & ((int64_t(1) << bucket_log2) - 1)) != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qf = static_cast<const float*>(q);
  if (kernel == 0 && dtype == 0)
    return fenix::launch_stream(qf, v, aux_mul, aux_add, out, qt, n, d, bucket_log2, s);
  if (kernel == 1 && dtype == 0)
    return fenix::launch_tiled(qf, v, aux_mul, aux_add, out, qt, n, d, bucket_log2, s);
  if (kernel == 2 && dtype == 2 && inv_sq != nullptr)
    return fenix::launch_generic_int8(q, v, aux_mul, aux_add, inv_sq, out, qt, n, d, bucket_log2, s);
  if (kernel == 3 && dtype == 2 && inv_sq != nullptr)
    return fenix::launch_tensor_int8(q, v, aux_mul, aux_add, inv_sq, out, qt, n, d, bucket_log2, s);
  if (kernel == 4 && dtype == 1)
    return fenix::launch_tensor_bf16(q, v, aux_mul, aux_add, out, qt, n, d, bucket_log2, s);
  if (kernel == 5 && dtype == 1)
    return fenix::launch_generic_bf16(q, v, aux_mul, aux_add, out, qt, n, d, bucket_log2, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
