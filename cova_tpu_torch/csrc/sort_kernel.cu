// SORT over a chunk of windows, every GoP range at once, for Hopper
// (sm_90a): K7.
//
// Replaces the program XLA compiled on the TPU for the tracker of the
// all-device stage: the `jax.lax.scan` of `sort_step` over a chunk's F
// windows in cova_tpu/pipeline/compressed.py (`compressed_stage_step`,
// `per_range`), vmapped over the R ranges, with the auction's
// `jax.lax.while_loop` (cova_tpu/ops/assignment.py,
// `solve_assignment_overflow`) inside every step. There is no Pallas
// original. In plain PyTorch (ops/cuda/sort_kernel.py, `sort_scan_plain`)
// the scan is a Python loop of F steps of about a hundred small launches
// each, with the auction's stopping condition read on the host every few
// rounds: a chunk costs the host's launches, not the card's time.
//
// What bounds it: a chunk at R=8, F=128, MT=64, MD=32 moves about 4.4 MB
// (the outputs, 53 bytes a slot and window, the boxes and the state in and
// out), 1.3 us at 3.35 TB/s, and does some 2e8 float operations for the
// Kalman filter and the IoU costs plus the auction's rounds, about 6 us at
// the 33.5 TFLOP/s of float32 that rounds every operation (no FMA). Neither
// is the limit. The work is a recurrence: each window's step needs the
// previous window's state, and each auction round the previous round's
// prices; the lanes are independent, but there are only R of them. What
// bounds the kernel is latency: a chain of auction rounds in series, up to
// max_iters a window, F windows a lane, on R of the card's 132 SMs, where
// the rounds are 93-99.9 % of a launch. So the design shortens a round,
// and spreads what a window does besides the rounds over the whole block.
//
// Design: one block of 256 threads a lane (a range). Thread i owns track
// slot i, thread j < MD detection j; every thread takes a share of the
// window's pairs. The lane's state stays on chip for the whole chunk: a
// slot's ints and its mean in the owning thread's registers, its
// covariance (49 floats) in shared memory beside a second 49-float work
// area, so a window past the lane's real windows (`nwin`) can compute its
// outputs without touching the state. A window:
//  - its boxes were brought into one of two shared buffers by an
//    asynchronous copy (cp.async, 4 bytes a thread and word) issued at the
//    top of the window before, its valid flags by a load held in a
//    register since then (a window's flags are MD bytes at any alignment,
//    below cp.async's 4); the copy of the next window's boxes starts now,
//    into the other buffer;
//  - every slot thread predicts its slot (Kalman) and publishes the box;
//    then the block computes the profit matrix, -(weight - IoU) for the
//    pairs of an existing slot and a valid box, kNeg for the rest, a pair
//    a thread in turn;
//  - the auction, in rounds of two barriers: the __syncthreads_count of
//    the unassigned rows, which also stops the lane (0, or max_iters
//    rounds, as each lane's own while_loop does), and the one after the
//    bids. Only the warps that hold a row or a column run a round's work;
//    the others meet its two barriers and nothing else, so that they take
//    no issue slots from the rows' warps. (1) Every unassigned row searches
//    its row in one running pass: a value above the best moves the old
//    best into `second`, any other value goes to fmaxf(second, v). That is
//    the plain version's first argmax and masked maximum floored at the
//    overflow value, since a maximum and a comparison round nothing. At
//    the template widths (8 for graft_entry, 32 for the stage) the pass is
//    unrolled over the profit row, held in registers for the whole
//    auction; at any other width it reads shared memory. The row exits to
//    overflow when the best is no better than it, or bids with one 64-bit
//    atomicMax in shared memory at its column: key (bits(bid) << 32) |
//    (0xFFFFFFFF - row). A bid is at least eps > 0, so its bits order as
//    its value, and the highest key is the highest bid, the lowest row on
//    ties: the plain version's argmax over the rows. 0 is below every key:
//    a column with no bid. The keys alternate between two arrays by the
//    round's parity, and a round clears the array of the round before it,
//    so no third barrier is needed. (2) After the barrier every row
//    resolves itself: a row that owned a column that got a key loses it,
//    then a row whose key won takes its column and writes the column's
//    price;
//  - accept (IoU threshold), the Kalman update, the lifecycle and the
//    deaths, the death snapshots before any birth, a thread a slot;
//  - births: each warp publishes the ballot of its unmatched valid
//    detections and the count of its free slots; the free slot of rank k
//    takes the unmatched detection of rank k, found from the ballots, for
//    k below both counts, with the id id_counter + k;
//  - the outputs of every window go to device memory; the state is kept
//    only for windows below nwin.
// Five barriers a window besides the rounds. One launch a chunk, no host
// synchronisation inside it. What was tried on the H100 and left out: one
// bid a column from each warp (__match_any_sync and __reduce_max_sync over
// the column's lanes, or a full-warp __reduce_max_sync over the lowest
// bidder's column) before the atomicMax, slower than the atomics'
// contention it saves; the search as runs merged in a tree, no faster.
//
// Exactness: the plain version is held equal bit for bit. Every float
// operation is an explicitly rounded intrinsic (__fadd_rn, __fsub_rn,
// __fmul_rn, __fdiv_rn, __fsqrt_rn), so nvcc contracts nothing into a
// fused multiply-add, in the plain version's order: the Kalman filter of
// tracker/kalman.py (fixed-order sums, the elimination of its `_inverse`,
// the 7-term products over every term, zeros included), the IoU of
// ops/iou.py, the auction of ops/assignment.py. Torch's `x / 2.0` on the
// card is a multiply by 0.5, exact either way. The inputs are finite, so
// fmaxf stands for clamp (they differ only on NaN), and fminf/fmaxf for
// minimum/maximum (they may differ only in the sign of a zero, which no
// output reads: it reaches the IoU only as an intersection of 0).

#include <cuda_runtime.h>

#include <cstdint>

// The launch's arguments, in the order ops/cuda/sort_kernel.py's _SortArgs
// lists them. Outside the anonymous namespace: the exported C entry point
// takes it.
struct SortArgs {
  // Inputs: boxes (R, F, MD, 4) and valid (R, F, MD); ts0 and nwin (R,).
  const float* ltwh;
  const uint8_t* valid;
  const int32_t* ts0;
  const int32_t* nwin;
  // The state in: (R, MT, 7), (R, MT, 7, 7), then (R, MT) fields, then (R,).
  const float* mean;
  const float* cov;
  const uint8_t* exists;
  const uint8_t* active;
  const int32_t* track_id;
  const int32_t* start_ts;
  const int32_t* last_match;
  const int32_t* hits;
  const int32_t* hit_streak;
  const int32_t* time_since_update;
  const int32_t* age;
  const int32_t* id_counter;
  const int32_t* frame_count;
  // The state out, the same layout.
  float* mean_o;
  float* cov_o;
  uint8_t* exists_o;
  uint8_t* active_o;
  int32_t* track_id_o;
  int32_t* start_ts_o;
  int32_t* last_match_o;
  int32_t* hits_o;
  int32_t* hit_streak_o;
  int32_t* time_since_update_o;
  int32_t* age_o;
  int32_t* id_counter_o;
  int32_t* frame_count_o;
  // The outputs, (R, F, MT[, 4]) and det_track_id (R, F, MD).
  float* o_track_ltwh;
  int32_t* o_track_id;
  int32_t* o_track_id_post;
  uint8_t* o_exists;
  uint8_t* o_active;
  uint8_t* o_predicted;
  int64_t* o_matched_det;
  int32_t* o_det_track_id;
  uint8_t* o_death;
  int32_t* o_death_id;
  int32_t* o_death_start;
  int32_t* o_death_last_match;
  int32_t* o_death_tsu;
  uint8_t* o_death_active;
  // Optional (R, F): the auction's rounds of each lane and window, and its
  // searches (the rows unassigned at the start of a round, summed over
  // the rounds).
  int32_t* rounds;
  int32_t* searches;
  int32_t lanes, frames, mt, md, gamma, min_hits, max_age, max_iters, quirk;
  float iou_threshold, eps, overflow_cost;
};

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kAll = 0xffffffffu;
constexpr float kNeg = -1e9f;  // ops/assignment.py's _NEG
constexpr int kHitStreakConfirm = 5;

// Shared memory, in 4-byte words: the auction's two key arrays (64-bit),
// two windows' boxes, the measurements, the predicted boxes, the prices,
// the covariance and its work area, the profit matrix (column-major, so a
// row's loads meet no bank conflict), the detections' flags and ids, the
// slots' flags, and the warps' birth ballots and counts.
__host__ __device__ constexpr long shared_words(int mt, int md) {
  return 4L * md + 8L * md + 4L * md + 4L * mt + md + 2L * mt * 49 + (long)md * mt + 3L * md +
         mt + 2L * kWarps;
}

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

__device__ __constant__ float kQ[7] = {1.0f, 1.0f, 1.0f, 1.0f, 0.01f, 0.01f, 0.0001f};
__device__ __constant__ float kR[4] = {1.0f, 1.0f, 10.0f, 10.0f};
__device__ __constant__ float kP0[7] = {10.0f, 10.0f, 10.0f, 10.0f, 1e4f, 1e4f, 1e4f};

// A 4-byte copy from device to shared memory that does not wait
// (cp.async), and the wait for this thread's copies. A host compiler's
// pass, which never runs them, sees a plain copy.
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
#else
  *dst = *src;
#endif
}

__device__ __forceinline__ void copy_async_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// ops/iou.py's iou_pairwise on half-open ltwh rectangles.
__device__ __forceinline__ float iou(const float* a, const float* b) {
  const float ax2 = add(a[0], a[2]), ay2 = add(a[1], a[3]);
  const float bx2 = add(b[0], b[2]), by2 = add(b[1], b[3]);
  const float ix = fmaxf(sub(fminf(ax2, bx2), fmaxf(a[0], b[0])), 0.0f);
  const float iy = fmaxf(sub(fminf(ay2, by2), fmaxf(a[1], b[1])), 0.0f);
  const float inter = mul(ix, iy);
  const float uni = sub(add(mul(a[2], a[3]), mul(b[2], b[3])), inter);
  return uni > 0.0f ? dvd(inter, fmaxf(uni, 1e-12f)) : 0.0f;
}

// tracker/kalman.py's bbox_to_z.
__device__ __forceinline__ void bbox_to_z(const float* b, float* z) {
  z[0] = add(b[0], mul(b[2], 0.5f));
  z[1] = add(b[1], mul(b[3], 0.5f));
  z[2] = mul(b[2], b[3]);
  z[3] = dvd(b[2], fmaxf(b[3], 1e-12f));
}

// tracker/kalman.py's x_to_bbox.
__device__ __forceinline__ void x_to_bbox(const float (&x)[7], bool quirk, float (&o)[4]) {
  const float s = fmaxf(x[2], 1e-12f), r = fmaxf(x[3], 1e-12f);
  const float w = __fsqrt_rn(mul(s, r));
  const float h = dvd(s, fmaxf(w, 1e-12f));
  o[0] = sub(x[0], mul(w, 0.5f));
  o[1] = sub(x[1], mul(quirk ? w : h, 0.5f));
  o[2] = w;
  o[3] = h;
}

// tracker/kalman.py's kalman_predict: mean into mp, P (7x7, shared) into
// pp (7x7, shared).
__device__ __forceinline__ void kalman_predict(const float (&m)[7], const float* p,
                                               float (&mp)[7], float* pp) {
  const float m6 = add(m[6], m[2]) <= 0.0f ? 0.0f : m[6];
  mp[0] = add(m[0], m[4]);
  mp[1] = add(m[1], m[5]);
  mp[2] = add(m[2], m6);
  mp[3] = m[3];
  mp[4] = m[4];
  mp[5] = m[5];
  mp[6] = m6;
  float fp[49];
#pragma unroll
  for (int i = 0; i < 7; ++i)
#pragma unroll
    for (int j = 0; j < 7; ++j)
      fp[i * 7 + j] = i < 3 ? add(p[i * 7 + j], p[(i + 4) * 7 + j]) : p[i * 7 + j];
#pragma unroll
  for (int i = 0; i < 7; ++i)
#pragma unroll
    for (int j = 0; j < 7; ++j) {
      const float v = j < 3 ? add(fp[i * 7 + j], fp[i * 7 + j + 4]) : fp[i * 7 + j];
      pp[i * 7 + j] = i == j ? add(v, kQ[i]) : v;
    }
}

// tracker/kalman.py's kalman_update: the mean from mp into mn, P (7x7,
// shared) updated in place.
__device__ __forceinline__ void kalman_update(const float (&mp)[7], float* p, const float* z,
                                              float (&mn)[7]) {
  float y[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) y[a] = sub(z[a], mp[a]);
  // S = P[:4, :4] + R on the diagonal, and its inverse by `_inverse`.
  float m[4][4], rhs[4][4], x[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      m[r][c] = r == c ? add(p[r * 7 + c], kR[r]) : p[r * 7 + c];
      rhs[r][c] = r == c ? 1.0f : 0.0f;
    }
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int r = q + 1; r < 4; ++r) {
      const float f = dvd(m[r][q], m[q][q]);
#pragma unroll
      for (int c = q + 1; c < 4; ++c) m[r][c] = sub(m[r][c], mul(f, m[q][c]));
#pragma unroll
      for (int c = 0; c < 4; ++c) rhs[r][c] = sub(rhs[r][c], mul(f, rhs[q][c]));
    }
#pragma unroll
  for (int r = 3; r >= 0; --r)
#pragma unroll
    for (int col = 0; col < 4; ++col) {
      float acc = rhs[r][col];
#pragma unroll
      for (int c = r + 1; c < 4; ++c) acc = sub(acc, mul(m[r][c], x[c][col]));
      x[r][col] = dvd(acc, m[r][r]);
    }
  // K = (P·Hᵀ)·S⁻¹, the mean, then the Joseph form.
  float k[7][4];
#pragma unroll
  for (int i = 0; i < 7; ++i)
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float acc = mul(p[i * 7], x[0][a]);
#pragma unroll
      for (int b = 1; b < 4; ++b) acc = add(acc, mul(p[i * 7 + b], x[b][a]));
      k[i][a] = acc;
    }
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    float ky = mul(k[i][0], y[0]);
#pragma unroll
    for (int a = 1; a < 4; ++a) ky = add(ky, mul(k[i][a], y[a]));
    mn[i] = add(mp[i], ky);
  }
  float ikh[7][7];
#pragma unroll
  for (int i = 0; i < 7; ++i)
#pragma unroll
    for (int j = 0; j < 7; ++j) {
      const float delta = i == j ? 1.0f : 0.0f;
      ikh[i][j] = j < 4 ? sub(delta, k[i][j]) : delta;
    }
  float t[7][7];
#pragma unroll
  for (int i = 0; i < 7; ++i)
#pragma unroll
    for (int j = 0; j < 7; ++j) {
      float acc = mul(ikh[i][0], p[j]);
#pragma unroll
      for (int q = 1; q < 7; ++q) acc = add(acc, mul(ikh[i][q], p[q * 7 + j]));
      t[i][j] = acc;
    }
#pragma unroll
  for (int i = 0; i < 7; ++i)
#pragma unroll
    for (int j = 0; j < 7; ++j) {
      float v = mul(t[i][0], ikh[j][0]);
#pragma unroll
      for (int q = 1; q < 7; ++q) v = add(v, mul(t[i][q], ikh[j][q]));
      float w = mul(mul(k[i][0], kR[0]), k[j][0]);
#pragma unroll
      for (int a = 1; a < 4; ++a) w = add(w, mul(mul(k[i][a], kR[a]), k[j][a]));
      p[i * 7 + j] = add(v, w);
    }
}

// A row's search at the template width MD, its profit row in registers:
// the values profit - price, then one running pass. `second` starts at the
// overflow value `ovf`.
template <int MD>
__device__ __forceinline__ void search_row(const float (&prow)[MD], const float* s_price, float ovf,
                                           float& best, int& col, float& second) {
  static_assert(MD % 4 == 0, "the prices are read four at a time");
  float v[MD];
  const float4* p4 = reinterpret_cast<const float4*>(s_price);
#pragma unroll
  for (int q = 0; q < MD / 4; ++q) {
    const float4 p = p4[q];
    v[4 * q] = sub(prow[4 * q], p.x);
    v[4 * q + 1] = sub(prow[4 * q + 1], p.y);
    v[4 * q + 2] = sub(prow[4 * q + 2], p.z);
    v[4 * q + 3] = sub(prow[4 * q + 3], p.w);
  }
  best = v[0];
  col = 0;
  second = ovf;
#pragma unroll
  for (int j = 1; j < MD; ++j) {
    const bool up = v[j] > best;
    second = fmaxf(second, up ? best : v[j]);
    col = up ? j : col;
    best = up ? v[j] : best;
  }
}

// The same search at a width known only at run time, over shared memory.
__device__ __forceinline__ void search_row(const float* s_profit, int stride, const float* s_price,
                                           int md, float ovf, float& best, int& col,
                                           float& second) {
  best = sub(s_profit[0], s_price[0]);
  col = 0;
  second = ovf;
  for (int j = 1; j < md; ++j) {
    const float v = sub(s_profit[j * stride], s_price[j]);
    if (v > best) {
      second = fmaxf(second, best);
      best = v;
      col = j;
    } else {
      second = fmaxf(second, v);
    }
  }
}

// The position of the k-th set bit (from 0) of m; k < popc(m).
__device__ __forceinline__ int nth_set_bit(unsigned m, int k) {
  int pos = 0;
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const int c = __popc(m & ((1u << s) - 1u));
    if (k >= c) {
      k -= c;
      m >>= s;
      pos += s;
    }
  }
  return pos;
}

// MD > 0: the detections a window, a compile-time width; 0: a.md, any.
template <int MD>
__global__ void __launch_bounds__(kThreads) sort_scan_kernel(const SortArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int mt = a.mt, md = MD > 0 ? MD : a.md, nf = a.frames;
  const int lane_idx = blockIdx.x;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const bool slot = t < mt, det = t < md;

  unsigned long long* s_key = reinterpret_cast<unsigned long long*>(smem);  // 2 * md
  float* s_box = smem + 4 * md;                            // 2 * md * 4, two windows
  float* s_z = s_box + 8 * md;                             // md * 4
  float* s_pred = s_z + 4 * md;                            // mt * 4
  float* s_price = s_pred + 4 * mt;                        // md
  float* s_cov = s_price + md;                             // mt * 49
  float* s_work = s_cov + mt * 49;                         // mt * 49
  float* s_profit = s_work + mt * 49;                      // md * mt, [j][i]
  int* s_valid = reinterpret_cast<int*>(s_profit + md * mt);  // md
  int* s_matched = s_valid + md;                           // md
  int* s_dtid = s_matched + md;                            // md
  int* s_slot = s_dtid + md;                               // mt: 1 exists, 2 active
  unsigned* s_umask = reinterpret_cast<unsigned*>(s_slot + mt);  // kWarps
  int* s_nfree = reinterpret_cast<int*>(s_umask + kWarps);       // kWarps

  // The lane's state: a slot's fields in its thread's registers, its
  // covariance in shared memory.
  const long lb = (long)lane_idx * mt;
  for (int q = t; q < mt * 49; q += kThreads) s_cov[q] = a.cov[lb * 49 + q];
  float mean[7] = {};
  bool exists = false, active = false;
  int tid = 0, start = 0, lastm = 0, hits = 0, hs = 0, tsu = 0, age = 0;
  const long sl = lb + t;
  if (slot) {
#pragma unroll
    for (int q = 0; q < 7; ++q) mean[q] = a.mean[sl * 7 + q];
    exists = a.exists[sl] != 0;
    active = a.active[sl] != 0;
    tid = a.track_id[sl];
    start = a.start_ts[sl];
    lastm = a.last_match[sl];
    hits = a.hits[sl];
    hs = a.hit_streak[sl];
    tsu = a.time_since_update[sl];
    age = a.age[sl];
  }
  int id_counter = a.id_counter[lane_idx];
  int frame_count = a.frame_count[lane_idx];
  const int ts0 = a.ts0[lane_idx], nwin = a.nwin[lane_idx];
  const float ovf_v = -a.overflow_cost;

  // Window f's boxes into buffer f & 1, without waiting; its valid flag of
  // detection t into a register.
  const long lf0 = (long)lane_idx * nf;
  auto fetch = [&](int f) {
    const float* src = a.ltwh + (lf0 + f) * md * 4;
    float* dst = s_box + (f & 1) * md * 4;
    for (int q = t; q < md * 4; q += kThreads) copy_async(dst + q, src + q);
    return det ? a.valid[(lf0 + f) * md + t] : uint8_t{0};
  };
  uint8_t valid_next = fetch(0);

  for (int f = 0; f < nf; ++f) {
    const int ts = ts0 + f * a.gamma;
    const bool commit = f < nwin;
    const long lf = lf0 + f;
    const float* box = s_box + (f & 1) * md * 4;
    float* work = s_work + t * 49;
    const bool valid = valid_next != 0;
    copy_async_wait();
    __syncthreads();  // the window's boxes are in; the window before is done
    if (f + 1 < nf) valid_next = fetch(f + 1);

    if (det) {
      s_valid[t] = valid;
      bbox_to_z(box + t * 4, s_z + t * 4);
      s_matched[t] = 0;
      s_dtid[t] = -1;
      s_price[t] = 0.0f;
      s_key[t] = 0;
      s_key[md + t] = 0;
    }
    // Predict (the slots that exist; the others keep their state).
    float mp[7], pred[4];
    const long so = lf * mt + t;
    if (slot) {
      if (exists) {
        kalman_predict(mean, s_cov + t * 49, mp, work);
      } else {
#pragma unroll
        for (int q = 0; q < 7; ++q) mp[q] = mean[q];
      }
      x_to_bbox(mp, a.quirk != 0, pred);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        a.o_track_ltwh[so * 4 + q] = pred[q];
        s_pred[t * 4 + q] = pred[q];
      }
      s_slot[t] = (exists ? 1 : 0) | (active ? 2 : 0);
    }
    __syncthreads();  // the predictions and the detections are in

    // The profit matrix, a pair a thread in turn.
    for (int p = t; p < mt * md; p += kThreads) {
      const int i = p % mt, j = p / mt;
      const int k = s_slot[i];
      float profit = kNeg;
      if ((k & 1) && s_valid[j])
        profit = -sub((k & 2) ? 1.0f : 2.0f, iou(s_pred + i * 4, box + j * 4));
      s_profit[p] = profit;
    }

    // The auction, each round two barriers.
    int r2c = exists ? -1 : md;  // md: parked on overflow, not a row that bids
    int it = 0, searches = 0;
    int unassigned = __syncthreads_count(r2c < 0);  // the profit matrix is in
    float prow[MD > 0 ? MD : 1];
    if constexpr (MD > 0) {
      if (r2c < 0) {
#pragma unroll
        for (int j = 0; j < MD; ++j) prow[j] = s_profit[j * mt + t];
      }
    }
    if ((t & ~31) >= max(mt, md)) {
      // A warp with no row and no column only meets the rounds' barriers.
      while (unassigned > 0 && it < a.max_iters) {
        searches += unassigned;
        __syncthreads();
        ++it;
        if (it < a.max_iters) unassigned = __syncthreads_count(0);
      }
    }
    while (unassigned > 0 && it < a.max_iters) {
      searches += unassigned;
      unsigned long long* key = s_key + (it & 1) * md;
      // The other array was last read before this round's first barrier.
      if (det) s_key[((it + 1) & 1) * md + t] = 0;
      int bidcol = -1;
      float bid = 0.0f;
      if (r2c < 0) {
        float bv, second;
        int bj;
        if constexpr (MD > 0) {
          search_row<MD>(prow, s_price, ovf_v, bv, bj, second);
        } else {
          search_row(s_profit + t, mt, s_price, md, ovf_v, bv, bj, second);
        }
        if (bv <= ovf_v) {
          r2c = md;  // overflow beats every column: out for good
        } else {
          bidcol = bj;
          bid = add(add(s_price[bj], sub(bv, second)), a.eps);
          atomicMax(key + bj, (static_cast<unsigned long long>(__float_as_uint(bid)) << 32) |
                                  (kAll - static_cast<unsigned>(t)));
        }
      }
      __syncthreads();  // every bid is in
      const bool owns = r2c >= 0 && r2c < md;
      const unsigned long long kown = key[owns ? r2c : 0], kbid = key[bidcol >= 0 ? bidcol : 0];
      if (owns && kown != 0) r2c = -1;  // lost
      if (bidcol >= 0 && static_cast<unsigned>(kbid) == kAll - static_cast<unsigned>(t)) {
        r2c = bidcol;  // won
        s_price[bidcol] = bid;
      }
      ++it;
      if (it < a.max_iters) unassigned = __syncthreads_count(r2c < 0);
    }
    if (a.rounds != nullptr && t == 0) a.rounds[lf] = it;
    if (a.searches != nullptr && t == 0) a.searches[lf] = searches;

    // Accept, update, the lifecycle and the deaths.
    float mn[7];
    bool exists_n = false, active_n = false;
    int hits_n = 0, hs_n = 0, tsu_n = 0, lastm_n = 0, age_n = 0;
    if (slot) {
      const int col = r2c >= 0 && r2c < md ? r2c : -1;
      bool accept = false;
      if (exists && col >= 0 && s_valid[col]) {
        const float piou = iou(pred, box + col * 4);
        accept = piou >= a.iou_threshold && piou > 0.0f;
      }
      a.o_matched_det[so] = accept ? col : -1;
      if (accept) {
        s_matched[col] = 1;
        s_dtid[col] = tid;
        kalman_update(mp, work, s_z + col * 4, mn);
      } else {
#pragma unroll
        for (int q = 0; q < 7; ++q) mn[q] = mp[q];
      }
      hits_n = hits + (accept ? 1 : 0);
      hs_n = accept ? hs + 1 : 0;
      const bool confirm = accept && hs_n >= kHitStreakConfirm;
      tsu_n = confirm ? 0 : tsu + (exists ? 1 : 0);
      lastm_n = confirm ? ts : lastm;
      age_n = age + (exists ? 1 : 0);
      active_n = active || (exists && hs_n >= a.min_hits);
      const bool death = exists && tsu_n > a.max_age;
      exists_n = exists && !death;
      a.o_predicted[so] = exists;
      a.o_death[so] = death;
      a.o_death_id[so] = tid;
      a.o_death_start[so] = start;
      a.o_death_last_match[so] = lastm_n;
      a.o_death_tsu[so] = tsu_n;
      a.o_death_active[so] = active_n;
    }
    __syncthreads();  // every match is marked

    // Births: the free slot of rank k takes the unmatched detection of rank
    // k, both ranked in thread order by the warps' ballots.
    const unsigned umask = __ballot_sync(kAll, det && s_valid[t] && !s_matched[t]);
    const unsigned fmask = __ballot_sync(kAll, slot && !exists_n);
    if (lane == 0) {
      s_umask[warp] = umask;
      s_nfree[warp] = __popc(fmask);
    }
    if (det) a.o_det_track_id[lf * md + t] = s_dtid[t];
    __syncthreads();  // the ballots are in
    int n_unmatched = 0, n_free = 0, free_rank = __popc(fmask & ((1u << lane) - 1u));
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      n_unmatched += __popc(s_umask[w]);
      n_free += s_nfree[w];
      if (w < warp) free_rank += s_nfree[w];
    }
    if (slot) {
      int tid_n = tid, start_n = start;
      const bool born = !exists_n && free_rank < n_unmatched;
      if (born) {
        int k = free_rank, w = 0;
        while (k >= __popc(s_umask[w])) k -= __popc(s_umask[w++]);
        const int d = w * 32 + nth_set_bit(s_umask[w], k);
        exists_n = true;
        active_n = false;
#pragma unroll
        for (int q = 0; q < 4; ++q) mn[q] = s_z[d * 4 + q];
        mn[4] = mn[5] = mn[6] = 0.0f;
        for (int q = 0; q < 49; ++q) work[q] = q % 8 == 0 ? kP0[q / 8] : 0.0f;
        tid_n = id_counter + free_rank;
        start_n = ts;
        lastm_n = ts;
        hits_n = hs_n = tsu_n = age_n = 0;
      }
      a.o_track_id[so] = tid;
      a.o_track_id_post[so] = tid_n;
      a.o_exists[so] = exists_n;
      a.o_active[so] = active_n;
      if (commit) {
#pragma unroll
        for (int q = 0; q < 7; ++q) mean[q] = mn[q];
        // A slot that neither existed nor was born kept its covariance.
        if (exists || born)
          for (int q = 0; q < 49; ++q) s_cov[t * 49 + q] = work[q];
        exists = exists_n;
        active = active_n;
        tid = tid_n;
        start = start_n;
        lastm = lastm_n;
        hits = hits_n;
        hs = hs_n;
        tsu = tsu_n;
        age = age_n;
      }
    }
    if (commit) {
      id_counter += min(n_free, n_unmatched);
      frame_count += 1;
    }
  }

  // The state out.
  __syncthreads();  // every slot's covariance is in
  for (int q = t; q < mt * 49; q += kThreads) a.cov_o[lb * 49 + q] = s_cov[q];
  if (slot) {
#pragma unroll
    for (int q = 0; q < 7; ++q) a.mean_o[sl * 7 + q] = mean[q];
    a.exists_o[sl] = exists;
    a.active_o[sl] = active;
    a.track_id_o[sl] = tid;
    a.start_ts_o[sl] = start;
    a.last_match_o[sl] = lastm;
    a.hits_o[sl] = hits;
    a.hit_streak_o[sl] = hs;
    a.time_since_update_o[sl] = tsu;
    a.age_o[sl] = age;
  }
  if (t == 0) {
    a.id_counter_o[lane_idx] = id_counter;
    a.frame_count_o[lane_idx] = frame_count;
  }
}

}  // namespace

extern "C" {

// Run SORT over a chunk: one block a lane, on `stream`. The caller has
// checked 1 <= mt <= 256, 1 <= md <= 256 and the shared memory against the
// card's limit. Returns the first error of setting the kernel's shared
// memory or of the launch: nonzero when the launch was refused.
int cova_sort_scan(const SortArgs* args, void* stream) {
  void (*kernel)(const SortArgs) = args->md == 32  ? sort_scan_kernel<32>
                                   : args->md == 8 ? sort_scan_kernel<8>
                                                   : sort_scan_kernel<0>;
  const size_t bytes = 4 * (size_t)shared_words(args->mt, args->md);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  if (args->lanes == 0 || args->frames == 0) return cudaSuccess;
  kernel<<<args->lanes, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(*args);
  return cudaGetLastError();
}

}  // extern "C"
