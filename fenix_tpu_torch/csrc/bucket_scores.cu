// Phase 1 of the two-phase exact top-k search on Hopper: per-bucket
// maxima of the fused score, with only the maxima written to memory.
// This file holds the C entry point of all five phase-1 kernels and one
// of the two int8 designs, generic_kernel ("generic_int8"). The f32
// corpora take bucket_scores_stream.cu (small Q) or bucket_scores_tiled.cu
// (large Q); bf16 rows of a multiple of 16 bytes take the tensor-core
// design in bucket_scores_tensor.cu ("tensor_bf16") from the query count
// kernels.py sets, other bf16 rows stream/tiled; int8 rows of a multiple
// of 16 bytes take "tensor_int8" in the same file, faster at every query
// count measured. generic_kernel serves only int8 rows that TMA cannot
// address (D not a multiple of 16): a shape rule of the caller
// (fenix_tpu_torch/ops/kernels.py:kernel_for), not a fallback.
//
// generic_kernel replaces kernel_int8 of
// fenix_tpu/ops/topk2.py:bucket_scores_pallas_bigq (topk2.py:464) for
// those rows. For row i and query j it computes
//
//   s = f32(v8_i . q8_j) * aux_mul[i] + aux_add[i] * inv_sq[j]
//
// and writes out[j, b] = max over the `bucket` rows of bucket b,
// query-major [QT, N/bucket].
//
// Design (right and simple; the int8 path the engine's tables take is
// bucket_scores_tensor.cu):
// - One block computes a tile of BM corpus rows x BQ queries. Both
//   operand tiles are staged through shared memory in steps of KW
//   words of four int8 codes packed into an int32; each thread owns a
//   TM x TN register tile and accumulates with __dp4a into an exact
//   int32 sum (127^2 * D < 2^31 for any D the engine serves).
// - The epilogue applies the per-row FMA, stages the score tile in
//   shared memory (reusing the operand buffers) and reduces each bucket
//   with warp shuffles. Rows past N score -inf; queries past QT are
//   never written, so any QT works without padding the batch.
// - Blocks are numbered query tile fastest, so the query tiles of one
//   row tile run back to back and re-read that V tile from L2.
//
// What bounds it on an H100: at Q = 8 the read of V (bandwidth); at
// Q = 1024 the int8 dot rate, which __dp4a on the CUDA cores reaches only
// a small part of; each block holds one query tile, so V is re-read once
// per query tile.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWords = 32;  // KW: shared-memory words per k-step

// Word w (codes 4w .. 4w + 3) of row `row` of a row-major [rows, d]
// int8 matrix, packed into an int32; zero outside it.
__device__ __forceinline__ int load_word(const int8_t* x, int64_t row, int64_t rows, int64_t d,
                                         int64_t w) {
  const int64_t k = w * 4;
  if (row >= rows || k >= d) return 0;
  const int8_t* p = x + row * d + k;
  if ((d & 3) == 0) return *reinterpret_cast<const int*>(p);  // 4-byte aligned
  uint32_t packed = 0;
  for (int i = 0; i < 4; ++i) {
    if (k + i < d) packed |= static_cast<uint32_t>(static_cast<uint8_t>(p[i])) << (8 * i);
  }
  return static_cast<int>(packed);
}

template <int BM, int BQ, int TM, int TN>
__global__ void __launch_bounds__(kThreads)
generic_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ v,
               const float* __restrict__ aux_mul, const float* __restrict__ aux_add,
               const float* __restrict__ inv_sq, float* __restrict__ out, int64_t qt, int64_t n,
               int64_t d, int bucket_log2, int64_t n_qtiles) {
  constexpr int NTX = BQ / TN;  // thread columns (query groups)
  constexpr int NTY = BM / TM;  // thread rows (row groups)
  static_assert(NTX * NTY == kThreads, "tile does not match the block size");
  static_assert(BM % 32 == 0, "row tile must be whole warps of rows");

  // +1 pads keep the transposing shared-memory stores free of bank conflicts.
  struct Stage {
    int v[kWords][BM + 1];
    int q[kWords][BQ + 1];
  };
  struct Epilogue {
    float s[BQ][BM + 1];
  };
  __shared__ union {
    Stage st;
    Epilogue ep;
  } sm;

  const int64_t qtile = blockIdx.x % n_qtiles;
  const int64_t rtile = blockIdx.x / n_qtiles;
  const int64_t row0 = rtile * BM;
  const int64_t q0 = qtile * BQ;
  const int tid = threadIdx.x;
  const int tx = tid % NTX;
  const int ty = tid / NTX;
  const int64_t words = (d + 3) / 4;

  int acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;

  for (int64_t w0 = 0; w0 < words; w0 += kWords) {
    for (int idx = tid; idx < BM * kWords; idx += kThreads) {
      const int r = idx / kWords, kk = idx % kWords;
      sm.st.v[kk][r] = load_word(v, row0 + r, n, d, w0 + kk);
    }
    for (int idx = tid; idx < BQ * kWords; idx += kThreads) {
      const int c = idx / kWords, kk = idx % kWords;
      sm.st.q[kk][c] = load_word(q, q0 + c, qt, d, w0 + kk);
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kWords; ++kk) {
      int a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = sm.st.v[kk][ty + NTY * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = sm.st.q[kk][tx + NTX * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();  // operand tiles are dead past here; the epilogue reuses them
  }

  // Epilogue: per-row FMA into the staged [BQ, BM] score tile.
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = ty + NTY * i;
    const int64_t row = row0 + r;
    const bool live = row < n;
    const float mul = live ? aux_mul[row] : 0.0f;
    const float add = live ? aux_add[row] : -INFINITY;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = tx + NTX * j;
      const float isq = (q0 + c < qt) ? inv_sq[q0 + c] : 1.0f;
      const float s = fmaf(static_cast<float>(acc[i][j]), mul, add * isq);  // tensor_int8's, bit for bit
      sm.ep.s[c][r] = live ? s : -INFINITY;
    }
  }
  __syncthreads();

  // Bucket maxima: one warp reduces 32 consecutive rows of one query.
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr int kWarps = kThreads / 32;
  const int bucket = 1 << bucket_log2;
  const int64_t nb = n >> bucket_log2;
  if (bucket >= 32) {
    const int slices = bucket >> 5;
    const int per_tile = BM >> bucket_log2;
    for (int item = warp; item < BQ * per_tile; item += kWarps) {
      const int c = item / per_tile, b = item % per_tile;
      float m = -INFINITY;
      for (int s = 0; s < slices; ++s) m = fmaxf(m, sm.ep.s[c][b * bucket + s * 32 + lane]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      const int64_t gq = q0 + c;
      const int64_t gb = (row0 >> bucket_log2) + b;
      if (lane == 0 && gq < qt && gb < nb) out[gq * nb + gb] = m;
    }
  } else {
    constexpr int chunks = BM / 32;
    for (int item = warp; item < BQ * chunks; item += kWarps) {
      const int c = item / chunks, ch = item % chunks;
      float m = sm.ep.s[c][ch * 32 + lane];
      for (int off = bucket >> 1; off > 0; off >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      const int64_t gq = q0 + c;
      const int64_t row = row0 + ch * 32 + lane;
      if ((lane & (bucket - 1)) == 0 && gq < qt && row < n) out[gq * nb + (row >> bucket_log2)] = m;
    }
  }
}

template <int BM, int BQ, int TM, int TN>
int launch(const int8_t* q, const int8_t* v, const float* aux_mul, const float* aux_add,
           const float* inv_sq, float* out, int64_t qt, int64_t n, int64_t d, int bucket_log2,
           cudaStream_t stream) {
  if ((1 << bucket_log2) > BM) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n_qtiles = (qt + BQ - 1) / BQ;
  const int64_t n_rtiles = (n + BM - 1) / BM;
  const int64_t blocks = n_qtiles * n_rtiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  generic_kernel<BM, BQ, TM, TN><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      q, v, aux_mul, aux_add, inv_sq, out, qt, n, d, bucket_log2, n_qtiles);
  return static_cast<int>(cudaGetLastError());
}

int launch_generic(const void* q, const void* v, const float* aux_mul, const float* aux_add,
                   const float* inv_sq, float* out, int64_t qt, int64_t n, int64_t d,
                   int bucket_log2, cudaStream_t stream) {
  const auto* q8 = static_cast<const int8_t*>(q);
  const auto* v8 = static_cast<const int8_t*>(v);
  // Small batches take a narrow query tile so no dot is spent on
  // padding queries; larger ones a 128 x 64 tile.
  if (qt <= 8)
    return launch<256, 8, 8, 1>(q8, v8, aux_mul, aux_add, inv_sq, out, qt, n, d, bucket_log2,
                                stream);
  return launch<128, 64, 8, 4>(q8, v8, aux_mul, aux_add, inv_sq, out, qt, n, d, bucket_log2,
                               stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = int8 (inv_sq required).
// kernel: 0 = stream, 1 = tiled (f32/bf16 corpora, f32 queries),
//         2 = generic, 3 = tensor_int8 (int8 corpus and queries; 3 needs
//         D a multiple of 16), 4 = tensor_bf16 (bf16 corpus and queries,
//         D a multiple of 8); 3 and 4 in bucket_scores_tensor.cu.
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
  if (kernel == 0 && (dtype == 0 || dtype == 1))
    return fenix::launch_stream(dtype, qf, v, aux_mul, aux_add, out, qt, n, d, bucket_log2, s);
  if (kernel == 1 && (dtype == 0 || dtype == 1))
    return fenix::launch_tiled(dtype, qf, v, aux_mul, aux_add, out, qt, n, d, bucket_log2, s);
  if (kernel == 2 && dtype == 2 && inv_sq != nullptr)
    return launch_generic(q, v, aux_mul, aux_add, inv_sq, out, qt, n, d, bucket_log2, s);
  if (kernel == 3 && dtype == 2 && inv_sq != nullptr)
    return fenix::launch_tensor_int8(q, v, aux_mul, aux_add, inv_sq, out, qt, n, d, bucket_log2, s);
  if (kernel == 4 && dtype == 1)
    return fenix::launch_tensor_bf16(q, v, aux_mul, aux_add, out, qt, n, d, bucket_log2, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
