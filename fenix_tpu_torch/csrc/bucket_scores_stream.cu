// bucket_scores_stream: the phase-1 kernel for small query batches
// (f32 and bf16 corpora), bound by the read of V.
//
// Replaces, for small Q: fenix_tpu/ops/topk2.py:453 (kernel_f32 of
// bucket_scores_pallas_bigq; on the TPU small batches took the XLA dot
// bucket_scores_xla beside it) and fenix_tpu/ops/topk2.py:357
// (bucket_scores_pallas, K3: the same function at bucket 128). For row i
// and query j it computes s = (v_i . q_j) * aux_mul[i] + aux_add[i] and
// writes out[j, b] = max over the `bucket` rows of bucket b (query-major
// [QT, N / bucket]); rows past N and -inf aux give -inf.
//
// What bounds it on an H100: at Q <= 8 every byte of V is used for 2Q
// flops, far below the 20 flop/byte where 67 TFLOP/s of fp32 and
// 3.35 TB/s meet, so the kernel can at best stream V once at the read
// rate. What the design does about it:
// - Persistent blocks (as many as fit the card) walk (query group, row
//   tile) work items; a tile is 128 rows, one row per thread.
// - Each tile streams through a ring of three shared-memory stages in
//   slices of each row (128 to 512 bytes, see Shape; cp.async, 16 bytes
//   a thread, neighbouring lanes on neighbouring addresses). Two stages
//   stay in flight while the third is computed, 64-140 KB per SM,
//   against the ~25 KB that 3.35 TB/s x ~1 us of latency needs per SM.
//   Per-item index arithmetic is kept out of the loop: cursors divide
//   once per tile, not once per stage.
// - A thread holds one accumulator per query of its group in registers
//   and reads its row from shared memory with 16-byte loads (the
//   +16-byte row pad keeps them conflict-free), the queries as 16-byte
//   broadcasts. The group size QB is instantiated exactly for 1..8
//   queries, so no FMA or shared read is spent on padding queries there;
//   above 8 it is 12, 16, 24 or 32, and more than 32 queries take several
//   groups (each re-reads V, from L2 when the groups of a tile run
//   together).
// - The aux vectors of a tile arrive with its last k-step's stage; the
//   bucket max is taken with warp shuffles, across warps through shared
//   memory for buckets of 64 and 128.
// - D that is not a multiple of 16 bytes (4 f32, 8 bf16) takes the same
//   kernel with plain element loads into the stages (kAsync = false).

#include <algorithm>

#include "common.cuh"

namespace fenix {
namespace {

constexpr int kRows = 128;   // rows per tile = threads per block
constexpr int kStages = 3;   // ring of shared-memory stages
constexpr int kMaxQ = 32;    // queries per block, at most

// A stage holds one slice of each of the tile's 128 rows. Few f32
// queries leave the SM idle between loads, so their slices are longer
// (512 bytes: a whole row at D = 128) for longer runs of device memory
// at one block per SM; more queries keep shorter slices and more blocks
// per SM (chosen from variants timed on an H100; see PERF.md).
template <typename T, int QB>
struct Shape {
  static constexpr int kSlice = sizeof(T) == 4 && QB <= 4 ? 512 : sizeof(T) == 4 && QB <= 8 ? 256 : 128;
  static constexpr int kVec = 16 / sizeof(T);    // elements per 16-byte copy
  static constexpr int kKc = kSlice / sizeof(T); // elements of a row per stage
  static constexpr int kRowStride = kKc + kVec;  // +16 bytes of pad
};

template <typename T, int QB>
struct Smem {
  using S = Shape<T, QB>;
  static constexpr int kV = kRows * S::kRowStride * sizeof(T);
  static constexpr int kQ = QB * S::kKc * 4;  // queries widened to f32
  static constexpr int kAux = 2 * kRows * 4;
  static constexpr int kStage = kV + kQ + kAux;  // each part a multiple of 16 bytes
  static constexpr int kBytes = kStages * kStage + (kRows / 32) * QB * 4;
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

template <typename T, int QB, bool kAsync>
__global__ void __launch_bounds__(kRows)
    stream_kernel(const float* __restrict__ q, const T* __restrict__ v,
                  const float* __restrict__ aux_mul, const float* __restrict__ aux_add,
                  float* __restrict__ out, int64_t qt, int64_t n, int64_t d, int bucket_log2) {
  using M = Smem<T, QB>;
  constexpr int KC = M::S::kKc, RS = M::S::kRowStride, VEC = M::S::kVec;
  extern __shared__ __align__(16) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem + kStages * M::kStage);

  const int tid = threadIdx.x;
  const int64_t groups = (qt + QB - 1) / QB;
  const int64_t work = groups * ((n + kRows - 1) / kRows);
  const int64_t ksteps = (d + KC - 1) / KC;
  const int64_t mine = blockIdx.x < work ? (work - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int64_t items = mine * ksteps;  // (work item, k-step) pairs, in order

  // Two cursors walk the block's items: the copies kStages - 1 ahead of
  // the compute. A cursor divides only when it moves to a new work item.
  struct Cursor {
    int64_t w, ks, q0, row0;
    int stage;
  };
  auto locate = [&](Cursor& c) {
    c.q0 = (c.w % groups) * QB;
    c.row0 = (c.w / groups) * kRows;
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
    unsigned char* st = smem + cur.stage * M::kStage;
    T* vs = reinterpret_cast<T*>(st);
    float* qs = reinterpret_cast<float*>(st + M::kV);
    float* as = reinterpret_cast<float*>(st + M::kV + M::kQ);
    const int64_t ks = cur.ks, q0 = cur.q0, row0 = cur.row0;
    const int64_t k0 = ks * KC;
    if constexpr (kAsync) {
      constexpr int kChunks = KC / VEC;  // 16-byte chunks per row slice
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {
        const int c = tid + i * kRows;
        const int r = c / kChunks, e = (c % kChunks) * VEC;
        const int64_t row = row0 + r, k = k0 + e;
        const bool ok = row < n && k < d;
        cp_async16(vs + r * RS + e, ok ? v + row * d + k : v, ok ? 16 : 0);
      }
      constexpr int kQChunks = KC / 4;
      for (int c = tid; c < QB * kQChunks; c += kRows) {
        const int j = c / kQChunks, e = (c % kQChunks) * 4;
        const int64_t qi = q0 + j, k = k0 + e;
        const bool ok = qi < qt && k < d;
        cp_async16(qs + j * KC + e, ok ? q + qi * d + k : q, ok ? 16 : 0);
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
      for (int c = tid; c < kRows * KC; c += kRows) {
        const int r = c / KC, e = c % KC;
        const int64_t row = row0 + r, k = k0 + e;
        vr[r * RS + e] = (row < n && k < d) ? src[row * d + k] : R(0);
      }
      for (int c = tid; c < QB * KC; c += kRows) {
        const int j = c / KC, e = c % KC;
        const int64_t qi = q0 + j, k = k0 + e;
        qs[j * KC + e] = (qi < qt && k < d) ? q[qi * d + k] : 0.0f;
      }
      if (ks == ksteps - 1) {
        const int64_t row = row0 + tid;
        as[tid] = row < n ? aux_mul[row] : 0.0f;
        as[kRows + tid] = row < n ? aux_add[row] : 0.0f;
      }
    }
  };

  float acc[QB];
#pragma unroll
  for (int j = 0; j < QB; ++j) acc[j] = 0.0f;
  const int lane = tid & 31, warp = tid >> 5;
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

    const unsigned char* st = smem + cc.stage * M::kStage;
    const T* vrow = reinterpret_cast<const T*>(st) + tid * RS;
    const float* qs = reinterpret_cast<const float*>(st + M::kV);
#pragma unroll
    for (int e = 0; e < KC; e += VEC) {
      float x[VEC];
      load16(vrow + e, x);
#pragma unroll
      for (int j = 0; j < QB; ++j) {
#pragma unroll
        for (int u = 0; u < VEC; u += 4) {
          const float4 b = *reinterpret_cast<const float4*>(qs + j * KC + e + u);
          acc[j] = fmaf(x[u], b.x, acc[j]);
          acc[j] = fmaf(x[u + 1], b.y, acc[j]);
          acc[j] = fmaf(x[u + 2], b.z, acc[j]);
          acc[j] = fmaf(x[u + 3], b.w, acc[j]);
        }
      }
    }
    const bool last = cc.ks == ksteps - 1;
    const int64_t q0 = cc.q0, row0 = cc.row0;
    advance(cc);
    if (!last) continue;

    // Epilogue of the work item: fused score, then the bucket maxima.
    const int64_t row = row0 + tid;
    const bool live = row < n;
    const float* as = reinterpret_cast<const float*>(st + M::kV + M::kQ);
    const float mul = as[tid], add = as[kRows + tid];
    float m[QB];
#pragma unroll
    for (int j = 0; j < QB; ++j) {
      m[j] = live ? fmaf(acc[j], mul, add) : -INFINITY;
      acc[j] = 0.0f;
    }
    for (int off = 1; off < min(bucket, 32); off <<= 1) {
#pragma unroll
      for (int j = 0; j < QB; ++j) m[j] = fmaxf(m[j], __shfl_xor_sync(0xffffffffu, m[j], off));
    }
    if (bucket <= 32) {
      if ((lane & (bucket - 1)) == 0 && live) {
#pragma unroll
        for (int j = 0; j < QB; ++j)
          if (q0 + j < qt) out[(q0 + j) * nb + (row >> bucket_log2)] = m[j];
      }
    } else {
      if (lane == 0) {
#pragma unroll
        for (int j = 0; j < QB; ++j) red[warp * QB + j] = m[j];
      }
      __syncthreads();
      const int wpb = bucket >> 5, per_tile = kRows >> bucket_log2;
      for (int idx = tid; idx < per_tile * QB; idx += kRows) {
        const int bt = idx / QB, j = idx % QB;
        float mm = -INFINITY;
        for (int k = 0; k < wpb; ++k) mm = fmaxf(mm, red[(bt * wpb + k) * QB + j]);
        const int64_t b = (row0 >> bucket_log2) + bt;
        if (b < nb && q0 + j < qt) out[(q0 + j) * nb + b] = mm;
      }
    }
  }
  cp_async_wait<0>();
}

template <typename T, int QB, bool kAsync>
int launch_qb(const Args& a) {
  using M = Smem<T, QB>;
  auto kernel = stream_kernel<T, QB, kAsync>;
  static Occupancy occ;
  int per_sm = 0, sms = 0;
  if (!launch_shape(occ, kernel, kRows, M::kBytes, &per_sm, &sms))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const int64_t work = ((a.qt + QB - 1) / QB) * ((a.n + kRows - 1) / kRows);
  const int64_t blocks = std::min(work, static_cast<int64_t>(per_sm) * sms);
  kernel<<<static_cast<unsigned>(blocks), kRows, M::kBytes, a.stream>>>(
      a.q, static_cast<const T*>(a.v), a.aux_mul, a.aux_add, a.out, a.qt, a.n, a.d, a.bucket_log2);
  return static_cast<int>(cudaGetLastError());
}

// Queries per block: the batch split into the fewest groups of at most
// kMaxQ, each group rounded up to the next instantiated size.
template <typename T>
int launch_t(const Args& a) {
  const int64_t groups = (a.qt + kMaxQ - 1) / kMaxQ;
  const int64_t per = (a.qt + groups - 1) / groups;
  if (a.d % (16 / static_cast<int64_t>(sizeof(T))) != 0) {  // rows not 16-byte aligned: element loads
    return per <= 8 ? launch_qb<T, 8, false>(a) : launch_qb<T, 32, false>(a);
  }
  switch (per) {
    case 1: return launch_qb<T, 1, true>(a);
    case 2: return launch_qb<T, 2, true>(a);
    case 3: return launch_qb<T, 3, true>(a);
    case 4: return launch_qb<T, 4, true>(a);
    case 5: return launch_qb<T, 5, true>(a);
    case 6: return launch_qb<T, 6, true>(a);
    case 7: return launch_qb<T, 7, true>(a);
    case 8: return launch_qb<T, 8, true>(a);
    default: break;
  }
  if (per <= 12) return launch_qb<T, 12, true>(a);
  if (per <= 16) return launch_qb<T, 16, true>(a);
  if (per <= 24) return launch_qb<T, 24, true>(a);
  return launch_qb<T, 32, true>(a);
}

}  // namespace

int launch_stream(int dtype, const float* q, const void* v, const float* aux_mul,
                  const float* aux_add, float* out, int64_t qt, int64_t n, int64_t d,
                  int bucket_log2, cudaStream_t stream) {
  const Args a{q, v, aux_mul, aux_add, out, qt, n, d, bucket_log2, stream};
  if (dtype == 0) return launch_t<float>(a);
  if (dtype == 1) return launch_t<__nv_bfloat16>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace fenix
