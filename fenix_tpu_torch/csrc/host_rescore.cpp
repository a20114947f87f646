// Exact fp32 scores of per-query candidate windows over the host's fp32
// column, in one threaded pass: the host rescore of the int8-resident,
// probed-host and int8-stream routes (engine/residency.py).
//
//   out[q, w] = dot(host[ids[q, w]], queries[q]) * mul[id] + add[id]
//
// and -inf where the id lies outside [0, rows) or the row is masked off.
// Each candidate row is read once, straight from the column; nothing of
// size Q x W x D is written.
//
// Every row sums in one fixed order: kLanes running sums over the row's
// whole groups of kLanes elements, a fixed tree over them, then the tail
// in sequence. A (row, query) pair therefore scores bit for bit alike
// whatever the thread count or the slot it sits in. The order needs no
// reassociation, so it vectorises under -O3 -march=native without
// -ffast-math.
//
// Threads take contiguous runs of (query, slot) pairs; each prefetches
// the next row it will score while it sums the current one.
//
// Built by fenix_tpu_torch/ops/host_rescore.py with g++ on the machine
// that runs it, and bound with ctypes (a plain C interface).

#include <algorithm>
#include <cstdint>
#include <limits>
#include <system_error>
#include <thread>
#include <vector>

namespace {

constexpr int64_t kLanes = 16;             // fp32 partial sums of a row: one 64-byte line a step
constexpr int64_t kMinFloats = 1 << 16;    // least work a thread is started for (256 KB of rows)
constexpr float kNegInf = -std::numeric_limits<float>::infinity();

struct Window {
  const float* host;     // [rows, d] row-major
  int64_t rows;
  int64_t d;
  const int64_t* ids;    // [q, w]
  int64_t w;
  const float* queries;  // [q, d]
  const float* mul;      // [rows]
  const float* add;      // [rows]
  const uint8_t* mask;   // [rows] or null
  float* out;            // [q, w]
};

// dot(r, q) in the fixed order above; `next` (a row, or r itself) is
// prefetched a line beside each line of r.
inline float row_dot(const float* __restrict r, const float* __restrict q, int64_t d,
                     const float* next) {
  float acc[kLanes] = {};
  const int64_t body = d - d % kLanes;
  for (int64_t i = 0; i < body; i += kLanes) {
    __builtin_prefetch(next + i);
    for (int64_t l = 0; l < kLanes; ++l) acc[l] += r[i + l] * q[i + l];
  }
  for (int64_t half = kLanes / 2; half > 0; half /= 2)
    for (int64_t l = 0; l < half; ++l) acc[l] += acc[l + half];
  float s = acc[0];
  for (int64_t i = body; i < d; ++i) s += r[i] * q[i];
  return s;
}

// The first pair in [p, end) whose row is in range and not masked off,
// or end; the pairs skipped get -inf.
inline int64_t next_scored(const Window& a, int64_t p, int64_t end) {
  for (; p < end; ++p) {
    const int64_t id = a.ids[p];
    if (id >= 0 && id < a.rows && (a.mask == nullptr || a.mask[id])) return p;
    a.out[p] = kNegInf;
  }
  return end;
}

void score_range(const Window& a, int64_t begin, int64_t end) {
  int64_t p = next_scored(a, begin, end);
  while (p < end) {
    const int64_t n = next_scored(a, p + 1, end);
    const int64_t id = a.ids[p];
    const float* row = a.host + id * a.d;
    const float* next = n < end ? a.host + a.ids[n] * a.d : row;
    const float s = row_dot(row, a.queries + (p / a.w) * a.d, a.d, next);
    a.out[p] = s * a.mul[id] + a.add[id];
    p = n;
  }
}

}  // namespace

extern "C" {

// Scores a [q, w] window (see the top of the file) on up to `threads`
// threads. Returns 0, or 1 when a thread could not be started (`out` is
// then incomplete).
int fenix_window_scores(const float* host, int64_t rows, int64_t d, const int64_t* ids, int64_t q,
                        int64_t w, const float* queries, const float* mul, const float* add,
                        const uint8_t* mask, float* out, int64_t threads) {
  const Window a{host, rows, d, ids, w, queries, mul, add, mask, out};
  const int64_t total = q * w;
  if (total <= 0) return 0;
  const int64_t by_work = std::max<int64_t>(1, total * std::max<int64_t>(d, 1) / kMinFloats);
  const int64_t t = std::max<int64_t>(1, std::min(threads, std::min(by_work, total)));
  std::vector<std::thread> pool;
  int err = 0;
  try {
    for (int64_t i = 1; i < t; ++i) pool.emplace_back(score_range, std::cref(a), i * total / t, (i + 1) * total / t);
  } catch (const std::system_error&) {
    err = 1;
  }
  if (err == 0) score_range(a, 0, total / t);
  for (auto& th : pool) th.join();
  return err;
}

}  // extern "C"
