// bucket_scores_tiled: the phase-1 kernel for large query batches
// (f32 corpora), bound by fp32 FMA throughput. Its kernel is written over
// the element type; only f32 is instantiated (bf16 corpora take the tensor
// cores, bucket_scores_tensor.cu, at every row width).
//
// Replaces, for large Q: fenix_tpu/ops/topk2.py:453 (kernel_f32 of
// bucket_scores_pallas_bigq) and, at bucket 128, fenix_tpu/ops/topk2.py:357
// (bucket_scores_pallas, K3). It computes the same function as
// bucket_scores_stream.cu: out[j, b] = max over the `bucket` rows of
// bucket b of (v_i . q_j) * aux_mul[i] + aux_add[i], query-major.
//
// What bounds it on an H100: at Q = 1024 every byte of V is used for
// 512 flops, far above the 20 flop/byte where 67 TFLOP/s of fp32 and
// 3.35 TB/s meet. TF32 stays off (the engine's parity contract), so the
// bound is the CUDA cores' fp32 FMA rate. What the design does about it:
// - A block computes a 128-row x BQ-query tile (BQ = 128, or 64 for
//   batches that fill a 64-query tile better), 256 threads, each with an
//   8-row x TN-query register tile (TN = BQ / 16).
// - V and Q stay k-contiguous in shared memory, as they lie in device
//   memory, so 16-byte cp.async copies fill them; a thread reads 4 k of
//   each of its rows and queries with one 16-byte load:
//   16 loads per 256 FMAs at TN = 8. Rows and queries are padded by 16
//   bytes against bank conflicts.
// - Three stages of 64 k each form a ring; persistent blocks walk
//   (query tile, row tile) work items with the query tile fastest, so the
//   blocks that share a row tile run together and re-read it from L2,
//   and one tile's epilogue overlaps the next tile's copies.
// - The epilogue applies the per-row FMA to the register tile and takes
//   the bucket max in registers (8 rows), with one shuffle (16 rows) and
//   across warps through shared memory (32..128 rows). The score tile
//   never reaches device memory.
// - D that is not a multiple of 16 bytes (4 f32) takes the same
//   kernel with plain element loads into the stages (kAsync = false).

#include <algorithm>

#include "common.cuh"

namespace fenix {
namespace {

constexpr int kThreads = 256;
constexpr int kRows = 128;  // rows per tile
constexpr int kKc = 64;     // elements of k per stage
constexpr int kStages = 3;

template <typename T, int TN>
struct Shape {
  static constexpr int kBq = 16 * TN;  // queries per tile
  static constexpr int kVec = 16 / sizeof(T);
  static constexpr int kVStride = kKc + kVec;  // elements; +16 bytes of pad
  static constexpr int kQStride = kKc + 4;     // floats; +16 bytes of pad
  static constexpr int kV = kRows * kVStride * sizeof(T);
  static constexpr int kQ = kBq * kQStride * 4;
  static constexpr int kAux = 2 * kRows * 4;
  static constexpr int kStage = kV + kQ + kAux;  // each part a multiple of 16 bytes
  static constexpr int kBytes = kStages * kStage + (kThreads / 32) * kBq * 4;
};

struct Args {
  const float* q;
  const void* v;
  const float* aux_mul;
  const float* aux_add;
  float* out;
  int64_t qt, n, d;
  int bucket_log2;
  cudaStream_t stream;
};

template <typename T, int TN, bool kAsync>
__global__ void __launch_bounds__(kThreads, 1)
    tiled_kernel(const float* __restrict__ q, const T* __restrict__ v,
                 const float* __restrict__ aux_mul, const float* __restrict__ aux_add,
                 float* __restrict__ out, int64_t qt, int64_t n, int64_t d, int bucket_log2) {
  using S = Shape<T, TN>;
  constexpr int BQ = S::kBq, VS = S::kVStride, QS = S::kQStride, VEC = S::kVec;
  extern __shared__ __align__(16) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem + kStages * S::kStage);

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // queries tx + 16 j
  const int ty = tid >> 4;  // rows 8 ty + i
  const int64_t qtiles = (qt + BQ - 1) / BQ;
  const int64_t work = qtiles * ((n + kRows - 1) / kRows);
  const int64_t ksteps = (d + kKc - 1) / kKc;
  const int64_t mine = blockIdx.x < work ? (work - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int64_t items = mine * ksteps;

  // Two cursors walk the block's items: the copies kStages - 1 ahead of
  // the compute. A cursor divides only when it moves to a new work item.
  struct Cursor {
    int64_t w, ks, q0, row0;
    int stage;
  };
  auto locate = [&](Cursor& c) {
    c.q0 = (c.w % qtiles) * BQ;
    c.row0 = (c.w / qtiles) * kRows;
  };
  auto advance = [&](Cursor& c) {
    c.stage = c.stage + 1 == kStages ? 0 : c.stage + 1;
    if (++c.ks == ksteps) {
      c.ks = 0;
      c.w += gridDim.x;
      locate(c);
    }
  };

  // Issue the copies of the item at `cur` into its stage.
  auto load = [&](const Cursor& cur) {
    unsigned char* st = smem + cur.stage * S::kStage;
    T* vs = reinterpret_cast<T*>(st);
    float* qs = reinterpret_cast<float*>(st + S::kV);
    float* as = reinterpret_cast<float*>(st + S::kV + S::kQ);
    const int64_t ks = cur.ks, q0 = cur.q0, row0 = cur.row0;
    const int64_t k0 = ks * kKc;
    if constexpr (kAsync) {
      constexpr int kChunks = kKc / VEC;
#pragma unroll
      for (int i = 0; i < kRows * kChunks / kThreads; ++i) {
        const int c = tid + i * kThreads;
        const int r = c / kChunks, e = (c % kChunks) * VEC;
        const int64_t row = row0 + r, k = k0 + e;
        const bool ok = row < n && k < d;
        cp_async16(vs + r * VS + e, ok ? v + row * d + k : v, ok ? 16 : 0);
      }
      constexpr int kQChunks = kKc / 4;
#pragma unroll
      for (int i = 0; i < BQ * kQChunks / kThreads; ++i) {
        const int c = tid + i * kThreads;
        const int j = c / kQChunks, e = (c % kQChunks) * 4;
        const int64_t qi = q0 + j, k = k0 + e;
        const bool ok = qi < qt && k < d;
        cp_async16(qs + j * QS + e, ok ? q + qi * d + k : q, ok ? 16 : 0);
      }
      if (ks == ksteps - 1 && tid < kRows / 2) {  // aux_mul, aux_add of the tile
        const int half = tid / (kRows / 4), r = (tid % (kRows / 4)) * 4;
        const float* src = half ? aux_add : aux_mul;
        const int64_t row = row0 + r;
        const int bytes = row >= n ? 0 : (n - row >= 4 ? 16 : static_cast<int>(n - row) * 4);
        cp_async16(as + half * kRows + r, bytes ? src + row : src, bytes);
      }
    } else {
      using R = typename Raw<T>::type;
      R* vr = reinterpret_cast<R*>(vs);
      const R* src = reinterpret_cast<const R*>(v);
      for (int c = tid; c < kRows * kKc; c += kThreads) {
        const int r = c / kKc, e = c % kKc;
        const int64_t row = row0 + r, k = k0 + e;
        vr[r * VS + e] = (row < n && k < d) ? src[row * d + k] : R(0);
      }
      for (int c = tid; c < BQ * kKc; c += kThreads) {
        const int j = c / kKc, e = c % kKc;
        const int64_t qi = q0 + j, k = k0 + e;
        qs[j * QS + e] = (qi < qt && k < d) ? q[qi * d + k] : 0.0f;
      }
      if (ks == ksteps - 1 && tid < kRows) {
        const int64_t row = row0 + tid;
        as[tid] = row < n ? aux_mul[row] : 0.0f;
        as[kRows + tid] = row < n ? aux_add[row] : 0.0f;
      }
    }
  };

  float acc[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
  const int warp = tid >> 5;
  const int bucket = 1 << bucket_log2;
  const int64_t nb = n >> bucket_log2;

  Cursor lc{blockIdx.x, 0, 0, 0, 0};
  locate(lc);
  Cursor cc = lc;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < items) {
      load(lc);
      advance(lc);
    }
    cp_async_commit();
  }
  for (int64_t it = 0; it < items; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage it is in; stage it - 1 is free for reuse
    if (it + kStages - 1 < items) {
      load(lc);
      advance(lc);
    }
    cp_async_commit();

    const unsigned char* st = smem + cc.stage * S::kStage;
    const T* vs = reinterpret_cast<const T*>(st) + ty * 8 * VS;
    const float* qs = reinterpret_cast<const float*>(st + S::kV) + tx * QS;
#pragma unroll 2
    for (int kk = 0; kk < kKc; kk += 4) {
      float a[8][4], b[TN][4];
#pragma unroll
      for (int i = 0; i < 8; ++i) load4(vs + i * VS + kk, a[i]);
#pragma unroll
      for (int j = 0; j < TN; ++j) load4(qs + j * 16 * QS + kk, b[j]);
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i][u], b[j][u], acc[i][j]);
    }
    const bool last = cc.ks == ksteps - 1;
    const int64_t q0 = cc.q0, row0 = cc.row0;
    advance(cc);
    if (!last) continue;

    // Epilogue of the work item: fused score in place, then bucket maxima.
    const float* as = reinterpret_cast<const float*>(st + S::kV + S::kQ);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = ty * 8 + i;
      const bool live = row0 + r < n;
      const float mul = as[r], add = as[kRows + r];
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = live ? fmaf(acc[i][j], mul, add) : -INFINITY;
    }
    // maxima over 2, 4 and 8 of the thread's rows, left in acc[0, 2, 4, 6], acc[0, 4], acc[0]
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      if (bucket >= 2) {
        acc[0][j] = fmaxf(acc[0][j], acc[1][j]);
        acc[2][j] = fmaxf(acc[2][j], acc[3][j]);
        acc[4][j] = fmaxf(acc[4][j], acc[5][j]);
        acc[6][j] = fmaxf(acc[6][j], acc[7][j]);
      }
      if (bucket >= 4) {
        acc[0][j] = fmaxf(acc[0][j], acc[2][j]);
        acc[4][j] = fmaxf(acc[4][j], acc[6][j]);
      }
      if (bucket >= 8) acc[0][j] = fmaxf(acc[0][j], acc[4][j]);
    }
    if (bucket <= 8) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int64_t row = row0 + ty * 8 + i;
        if ((i & (bucket - 1)) == 0 && row < n) {
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            const int64_t qi = q0 + tx + 16 * j;
            if (qi < qt) out[qi * nb + (row >> bucket_log2)] = acc[i][j];
          }
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < TN; ++j)  // the partner thread ty ^ 1 holds the other 8 rows
        acc[0][j] = fmaxf(acc[0][j], __shfl_xor_sync(0xffffffffu, acc[0][j], 16));
      if (bucket == 16) {
        const int64_t row = row0 + ty * 8;
        if ((ty & 1) == 0 && row < n) {
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            const int64_t qi = q0 + tx + 16 * j;
            if (qi < qt) out[qi * nb + (row >> bucket_log2)] = acc[0][j];
          }
        }
      } else {  // warp w holds the maxima of rows 16 w .. 16 w + 15
        if ((ty & 1) == 0) {
#pragma unroll
          for (int j = 0; j < TN; ++j) red[warp * BQ + tx + 16 * j] = acc[0][j];
        }
        __syncthreads();
        const int wpb = bucket >> 4, per_tile = kRows >> bucket_log2;
        for (int idx = tid; idx < per_tile * BQ; idx += kThreads) {
          const int bt = idx / BQ, c = idx % BQ;
          float mm = -INFINITY;
          for (int k = 0; k < wpb; ++k) mm = fmaxf(mm, red[(bt * wpb + k) * BQ + c]);
          const int64_t b = (row0 >> bucket_log2) + bt;
          if (b < nb && q0 + c < qt) out[(q0 + c) * nb + b] = mm;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
  }
  cp_async_wait<0>();
}

template <typename T, int TN, bool kAsync>
int launch_tn(const Args& a) {
  using S = Shape<T, TN>;
  auto kernel = tiled_kernel<T, TN, kAsync>;
  static Occupancy occ;
  int per_sm = 0, sms = 0;
  if (!launch_shape(occ, kernel, kThreads, S::kBytes, &per_sm, &sms))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const int64_t work = ((a.qt + S::kBq - 1) / S::kBq) * ((a.n + kRows - 1) / kRows);
  const int64_t blocks = std::min(work, static_cast<int64_t>(per_sm) * sms);
  kernel<<<static_cast<unsigned>(blocks), kThreads, S::kBytes, a.stream>>>(
      a.q, static_cast<const T*>(a.v), a.aux_mul, a.aux_add, a.out, a.qt, a.n, a.d, a.bucket_log2);
  return static_cast<int>(cudaGetLastError());
}

// A 64-query tile where it pads the batch less than a 128-query tile.
template <typename T>
int launch_t(const Args& a) {
  const bool narrow = (a.qt + 63) / 64 * 64 < (a.qt + 127) / 128 * 128;
  if (a.d % (16 / static_cast<int64_t>(sizeof(T))) != 0)  // rows not 16-byte aligned
    return narrow ? launch_tn<T, 4, false>(a) : launch_tn<T, 8, false>(a);
  return narrow ? launch_tn<T, 4, true>(a) : launch_tn<T, 8, true>(a);
}

}  // namespace

int launch_tiled(const float* q, const void* v, const float* aux_mul, const float* aux_add, float* out,
                 int64_t qt, int64_t n, int64_t d, int bucket_log2, cudaStream_t stream) {
  return launch_t<float>(Args{q, v, aux_mul, aux_add, out, qt, n, d, bucket_log2, stream});
}

}  // namespace fenix
