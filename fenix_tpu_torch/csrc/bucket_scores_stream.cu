// bucket_scores_stream: the phase-1 kernel for small query batches
// (f32 corpora), bound by the read of V. Its kernels are written over the
// element type; only f32 is instantiated (bf16 corpora take the tensor
// cores, bucket_scores_tensor.cu, at every row width).
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
// rate. At Q = 32 and f32 it is 16 flop/byte: the FMAs alone take 1.03 ms
// of the 1.31 ms read at 8M x 128, so they must run under the read. The
// batch is split into the fewest groups of at most 32 queries; two
// kernels serve the groups:
//
// stream_kernel, groups of 1..8 queries (instantiated exactly, so no FMA
// or shared read is spent on padding queries):
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
//   broadcasts: one shared-memory load per 4 FMAs at 8 queries.
// - The aux vectors of a tile arrive with its last k-step's stage; the
//   bucket max is taken with warp shuffles, across warps through shared
//   memory for buckets of 64 and 128.
// - D that is not a multiple of 16 bytes (4 f32) takes the same
//   kernel with plain element loads into the stages (kAsync = false), in
//   groups of 8 at any Q.
//
// outer_kernel, groups of 12, 16, 24 or 32 queries on rows of a multiple
// of 16 bytes. With one row a thread a group of 32 would cost one shared
// load per 4 FMAs, and loads, FMAs and the block-wide barrier of each
// cp.async stage together, not the read, bound the kernel (2.87 ms at
// Q = 32, 8M x 128 f32, against 1.31). Instead:
// - A thread holds an outer-product register tile of TM rows x QB/4
//   queries: a 16-byte load of a row feeds QB/4 x 4 FMAs and one of a
//   query TM x 4 (TM = 8 up to 24 queries, 4 at 32), so at QB = 32 a
//   thread issues 12 loads per 128 FMAs (f32). A warp holds 8 TM rows (a
//   thread rows r, r + 8, ...) by all QB queries (query lane g takes
//   queries g, g + 4, ...).
// - Copies: TMA moves 128-byte k-slices of the tile's rows and of the
//   group's (f32) queries into a ring of 128-byte-swizzled stages, each
//   signalled by an mbarrier, issued by one producer thread; eight
//   consumer warps compute and free a stage as soon as they are done with
//   it. No thread spends instructions on addresses of copies, and no
//   block-wide barrier stands between two stages. The swizzle puts the
//   8 rows a warp reads at once on 8 different banks.
// - The aux vectors come by TMA with the item's last k-step; the bucket
//   max is taken in registers (rows 8 apart), by shuffles (consecutive
//   rows) and across warps through shared memory.

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

// -- groups above 8 queries: the outer-product tile, fed by TMA --------------

constexpr int kOuterWarps = 8;                         // consumer warps
constexpr int kOuterThreads = 32 * (kOuterWarps + 1);  // + one producer warp
constexpr int kBox = 256;                              // most rows of one TMA box
constexpr int kSliceBytes = 128;                       // of a row per stage: one swizzled row
constexpr int kSmemMax = 232448;                       // dynamic shared memory one block may use

template <typename T>
constexpr CUtensorMapDataType kTmaType = sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;

// The tile of a QB-query group: TM rows x QB/4 queries a thread (8 rows up
// to 24 queries, 4 at 32, where 8 rows spill the register tile; chosen
// from variants timed on an H100, see PERF.md), 8 TM rows a warp. Its
// shared memory: the stage ring (V rows, the f32 query rows in boxes of 32
// values, and the aux of the rows, which come with an item's last k-step),
// the double-buffered rows of warp maxima and the mbarriers, plus 1 KB to
// align the base to the 1024 bytes over which the 128-byte swizzle
// repeats. As many stages as fit, up to 8.
template <typename T, int QB>
struct Outer {
  static constexpr int kTm = QB <= 24 ? 8 : 4;
  static constexpr int kRows = kOuterWarps * 8 * kTm;     // rows per tile
  static constexpr int kElems = kSliceBytes / sizeof(T);  // k per stage
  static constexpr int kVBoxes = kRows < kBox ? 1 : kRows / kBox;
  static constexpr int kBoxRows = kRows < kBox ? kRows : kBox;
  static constexpr int kQBoxes = kElems * 4 / kSliceBytes;  // 1 for f32
  static constexpr int kQBox = (QB * kSliceBytes + 1023) / 1024 * 1024;
  static constexpr int kV = kRows * kSliceBytes;
  static constexpr int kQ = kQBoxes * kQBox;
  static constexpr int kAux = 2 * kRows * 4;
  static constexpr int kStage = kV + kQ + kAux;  // a multiple of 1024
  static constexpr int kLoad = kV + kQBoxes * QB * kSliceBytes;  // bytes TMA moves a k-step
  static constexpr int kRedBytes = 2 * kOuterWarps * QB * 4;
  static constexpr int kStages = (kSmemMax - 1024 - kRedBytes) / (kStage + 16) < 8
                                     ? (kSmemMax - 1024 - kRedBytes) / (kStage + 16)
                                     : 8;
  static constexpr int kRed = kStages * kStage;
  static constexpr int kBar = kRed + kRedBytes;
  static constexpr int kBytes = kBar + 2 * kStages * 8 + 1024;
  static_assert(kStages >= 2 && kBytes <= kSmemMax, "the ring does not fit");
  static_assert(QB % 4 == 0 && QB <= kBox, "a group splits over 4 query lanes, in one box");
  static_assert(kRows % kBox == 0 || kRows < kBox, "a tile is whole TMA boxes");
};

// The consumer warps' barrier for the rows of warp maxima (named barrier
// 1; 0 is __syncthreads).
__device__ __forceinline__ void outer_consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kOuterWarps) : "memory");
}

template <typename T, int QB>
__global__ void __launch_bounds__(kOuterThreads, 1)
    outer_kernel(const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_mul, const __grid_constant__ CUtensorMap tm_add,
                 float* __restrict__ out, int64_t qt, int64_t n, int ksteps, int bucket_log2) {
  using O = Outer<T, QB>;
  constexpr int TM = O::kTm, TN = QB / 4, RW = 8 * TM, kRows = O::kRows, kStages = O::kStages;
  constexpr int VEC = 16 / sizeof(T);  // elements of one 16-byte chunk
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + (1024 - smem_addr(smem_raw) % 1024) % 1024;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + O::kBar);
  uint64_t* empty = full + kStages;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int64_t groups = (qt + QB - 1) / QB;
  const int64_t work = groups * ((n + kRows - 1) / kRows);

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);             // the producer's arrive + the bytes
      mbar_init(empty + s, kOuterWarps);  // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kOuterWarps) {
    // Producer warp: one thread issues every copy.
    if (lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int64_t w = blockIdx.x; w < work; w += gridDim.x) {
        const int row0 = static_cast<int>(w / groups) * kRows;
        const int q0 = static_cast<int>(w % groups) * QB;
        for (int ks = 0; ks < ksteps; ++ks) {
          const bool last = ks == ksteps - 1;
          mbar_wait(empty + stage, phase ^ 1);
          const uint32_t st = smem_addr(smem + stage * O::kStage);
          mbar_expect_tx(full + stage, O::kLoad + (last ? O::kAux : 0));
#pragma unroll
          for (int b = 0; b < O::kVBoxes; ++b)
            tma_load(st + b * O::kBoxRows * kSliceBytes, &tm_v, ks * O::kElems, row0 + b * O::kBoxRows,
                     full + stage);
#pragma unroll
          for (int h = 0; h < O::kQBoxes; ++h)
            tma_load(st + O::kV + h * O::kQBox, &tm_q, ks * O::kElems + h * 32, q0, full + stage);
          if (last) {
#pragma unroll
            for (int b = 0; b < O::kVBoxes; ++b) {
              const uint32_t aux = st + O::kV + O::kQ + b * O::kBoxRows * 4;
              tma_load(aux, &tm_mul, row0 + b * O::kBoxRows, full + stage);
              tma_load(aux + kRows * 4, &tm_add, row0 + b * O::kBoxRows, full + stage);
            }
          }
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // Consumer warps: rows warp * RW + rg + 8 i, queries qg + 4 j.
  const int rg = lane & 7, qg = lane >> 3;
  float* red = reinterpret_cast<float*>(smem + O::kRed);
  const int bucket = 1 << bucket_log2;
  const int64_t nb = n >> bucket_log2;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
  int stage = 0, buf = 0;
  uint32_t phase = 0;
  for (int64_t w = blockIdx.x; w < work; w += gridDim.x, buf ^= 1) {
    const int64_t row0 = (w / groups) * kRows;
    const int64_t q0 = (w % groups) * QB;
    float mul[TM], add[TM];
    for (int ks = 0; ks < ksteps; ++ks) {
      mbar_wait(full + stage, phase);
      const unsigned char* st = smem + stage * O::kStage;
      // chunk c of row r sits at chunk c ^ (r % 8): r % 8 is rg for every
      // row of the thread, and g + 4 j mod 8 for query row g + 4 j
      const unsigned char* vrow = st + (warp * RW + rg) * kSliceBytes;
#pragma unroll
      for (int c = 0; c < kSliceBytes / 16; ++c) {
        float x[TM][VEC];
#pragma unroll
        for (int i = 0; i < TM; ++i)
          load16(reinterpret_cast<const T*>(vrow + i * 8 * kSliceBytes + ((c ^ rg) << 4)), x[i]);
#pragma unroll
        for (int u = 0; u < VEC; u += 4) {
          const int kf = c * VEC + u;  // the first of the four f32 query values
          const unsigned char* qbox = st + O::kV + (kf / 32) * O::kQBox;
          float4 b[TN];
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            const int jr = qg + 4 * j;
            b[j] = *reinterpret_cast<const float4*>(qbox + jr * kSliceBytes + ((((kf % 32) / 4) ^ (jr & 7)) << 4));
          }
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) {
              acc[i][j] = fmaf(x[i][u], b[j].x, acc[i][j]);
              acc[i][j] = fmaf(x[i][u + 1], b[j].y, acc[i][j]);
              acc[i][j] = fmaf(x[i][u + 2], b[j].z, acc[i][j]);
              acc[i][j] = fmaf(x[i][u + 3], b[j].w, acc[i][j]);
            }
        }
      }
      if (ks == ksteps - 1) {
        const float* aux = reinterpret_cast<const float*>(st + O::kV + O::kQ);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          mul[i] = aux[warp * RW + rg + 8 * i];
          add[i] = aux[kRows + warp * RW + rg + 8 * i];
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + stage);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }

    // Epilogue of the work item: fused score, then the bucket maxima.
    float m[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const bool live = row0 + warp * RW + rg + 8 * i < n;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        m[i][j] = live ? fmaf(acc[i][j], mul[i], add[i]) : -INFINITY;
        acc[i][j] = 0.0f;
      }
    }
    // rows 8 apart lie in one thread, consecutive rows in lanes rg
    for (int off = 1; off < min(bucket, 8); off <<= 1) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) m[i][j] = fmaxf(m[i][j], __shfl_xor_sync(0xffffffffu, m[i][j], off));
    }
    if (bucket <= 8) {
      if ((rg & (bucket - 1)) == 0) {
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const int64_t row = row0 + warp * RW + rg + 8 * i;
          if (row >= n) continue;
#pragma unroll
          for (int j = 0; j < TN; ++j)
            if (q0 + qg + 4 * j < qt) out[(q0 + qg + 4 * j) * nb + (row >> bucket_log2)] = m[i][j];
        }
      }
      continue;
    }
    // a bucket's 8-row slabs meet in its first slab's registers
    const int slabs = bucket >> 3;
#pragma unroll
    for (int s = 1; s < TM; s <<= 1) {
      if (s >= slabs) break;
#pragma unroll
      for (int i = 0; i < TM; i += 2 * s)
#pragma unroll
        for (int j = 0; j < TN; ++j) m[i][j] = fmaxf(m[i][j], m[i + s][j]);
    }
    if (slabs <= TM) {
      if (rg == 0) {
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const int64_t row = row0 + warp * RW + 8 * i;
          if ((i & (slabs - 1)) != 0 || row >= n) continue;
#pragma unroll
          for (int j = 0; j < TN; ++j)
            if (q0 + qg + 4 * j < qt) out[(q0 + qg + 4 * j) * nb + (row >> bucket_log2)] = m[i][j];
        }
      }
      continue;
    }
    // a bucket spans warps: their maxima meet in shared memory
    float* rows = red + buf * kOuterWarps * QB;
    if (rg == 0) {
#pragma unroll
      for (int j = 0; j < TN; ++j) rows[warp * QB + qg + 4 * j] = m[0][j];
    }
    outer_consumers_sync();
    const int wpb = bucket / RW, per_tile = kRows >> bucket_log2;
    for (int idx = tid; idx < per_tile * QB; idx += 32 * kOuterWarps) {
      const int bt = idx / QB, j = idx % QB;
      float mm = -INFINITY;
      for (int k = 0; k < wpb; ++k) mm = fmaxf(mm, rows[(bt * wpb + k) * QB + j]);
      const int64_t b = (row0 >> bucket_log2) + bt;
      if (b < nb && q0 + j < qt) out[(q0 + j) * nb + b] = mm;
    }
  }
}

template <typename T, int QB>
int launch_outer(const Args& a) {
  using O = Outer<T, QB>;
  auto kernel = outer_kernel<T, QB>;
  static Occupancy occ;
  int per_sm = 0, sms = 0;
  if (!launch_shape(occ, kernel, kOuterThreads, O::kBytes, &per_sm, &sms))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  CUtensorMap tm_v, tm_q, tm_mul, tm_add;
  if (!encode_rows(&tm_v, kTmaType<T>, sizeof(T), a.v, a.n, a.d, O::kBoxRows) ||
      !encode_rows(&tm_q, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, a.q, a.qt, a.d, QB) ||
      !encode_vector(&tm_mul, a.aux_mul, a.n, O::kBoxRows) || !encode_vector(&tm_add, a.aux_add, a.n, O::kBoxRows))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t work = ((a.qt + QB - 1) / QB) * ((a.n + O::kRows - 1) / O::kRows);
  const int64_t blocks = std::min(work, static_cast<int64_t>(per_sm) * sms);
  const int64_t ksteps = (a.d * static_cast<int64_t>(sizeof(T)) + kSliceBytes - 1) / kSliceBytes;
  kernel<<<static_cast<unsigned>(blocks), kOuterThreads, O::kBytes, a.stream>>>(
      tm_v, tm_q, tm_mul, tm_add, a.out, a.qt, a.n, static_cast<int>(ksteps), a.bucket_log2);
  return static_cast<int>(cudaGetLastError());
}

// Queries per block: the batch split into the fewest groups of at most
// kMaxQ, each group rounded up to the next instantiated size; rows that
// are not 16-byte strided take groups of 8 through element loads.
template <typename T>
int launch_t(const Args& a) {
  const int64_t groups = (a.qt + kMaxQ - 1) / kMaxQ;
  const int64_t per = (a.qt + groups - 1) / groups;
  if (a.d % (16 / static_cast<int64_t>(sizeof(T))) != 0) return launch_qb<T, 8, false>(a);
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
  // TMA: int32 box coordinates
  if (a.n >= (int64_t(1) << 31) || a.qt >= (int64_t(1) << 31)) return static_cast<int>(cudaErrorInvalidValue);
  if (per <= 12) return launch_outer<T, 12>(a);
  if (per <= 16) return launch_outer<T, 16>(a);
  if (per <= 24) return launch_outer<T, 24>(a);
  return launch_outer<T, 32>(a);
}

}  // namespace

int launch_stream(const float* q, const void* v, const float* aux_mul, const float* aux_add, float* out,
                  int64_t qt, int64_t n, int64_t d, int bucket_log2, cudaStream_t stream) {
  return launch_t<float>(Args{q, v, aux_mul, aux_add, out, qt, n, d, bucket_log2, stream});
}

}  // namespace fenix
