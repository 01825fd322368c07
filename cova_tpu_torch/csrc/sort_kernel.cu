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
// bounds the kernel is latency: F steps in series a lane, each a chain of
// barriers (three a round of the auction), on R of the card's 132 SMs.
//
// Design: one block a lane (a range), its threads the track slots (thread
// i owns slot i) and, for the auction's column step and the births, the
// detections (thread j < MD owns detection j). The lane's state stays on
// chip for the whole chunk: a slot's ints and its mean in the owning
// thread's registers, its covariance (49 floats) in shared memory beside a
// second 49-float work area, so a window past the lane's real windows
// (`nwin`) can compute its outputs without touching the state. A window:
//  - the detections' boxes and measurements land in shared memory, and
//    every slot predicts (Kalman) and writes its IoU-based profit row;
//  - the auction, in rounds of three steps with a barrier between them:
//    (1) every unassigned row finds its best column (the first on ties),
//    the best value among the others floored at the overflow value, and
//    its bid, or exits to overflow when the best is no better than it;
//    (2) every column takes its highest bid, the lowest row on ties, and
//    records its new owner and price; (3) every row that owned a column
//    that was bid for loses it, then every winner takes its column. The
//    block stops when __syncthreads_count(row unassigned) is 0 or after
//    max_iters rounds, as each lane's own while_loop does;
//  - accept (IoU threshold), the Kalman update, the lifecycle and the
//    deaths, the death snapshots before any birth;
//  - births: block prefix sums (warp ballots) rank the unmatched valid
//    detections and the free slots; the free slot of rank k takes the
//    unmatched detection of rank k, for k below both counts, with the id
//    id_counter + k;
//  - the outputs of every window go to device memory; the state is kept
//    only for windows below nwin.
// One launch a chunk, no host synchronisation inside it.
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

#include <algorithm>
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

constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr float kNeg = -1e9f;  // ops/assignment.py's _NEG
constexpr int kHitStreakConfirm = 5;

// Shared memory, in 4-byte words: the covariance and its work area, the
// profit matrix (column-major, so a row's scan meets no bank conflict), the
// detections' boxes and measurements, the auction's columns and bids, the
// births' map and the scans' warp counts.
__host__ __device__ constexpr long shared_words(int mt, int md) {
  return 2L * mt * 49 + (long)md * mt + 8L * md + 7L * md + 2L * mt + 2L * kMaxWarps;
}

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

__device__ __constant__ float kQ[7] = {1.0f, 1.0f, 1.0f, 1.0f, 0.01f, 0.01f, 0.0001f};
__device__ __constant__ float kR[4] = {1.0f, 1.0f, 10.0f, 10.0f};
__device__ __constant__ float kP0[7] = {10.0f, 10.0f, 10.0f, 10.0f, 1e4f, 1e4f, 1e4f};

// ops/iou.py's iou_pairwise on half-open ltwh rectangles.
__device__ __forceinline__ float iou(const float (&a)[4], const float* b) {
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

// Exclusive ranks of two flags over the block's threads, and their totals.
// Every thread of the block calls it; it ends after a barrier.
__device__ __forceinline__ void block_ranks(bool fa, bool fb, int* s_warp, int& ra, int& rb,
                                            int& na, int& nb) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned ba = __ballot_sync(0xffffffffu, fa), bb = __ballot_sync(0xffffffffu, fb);
  const unsigned below = (1u << lane) - 1u;
  if (lane == 0) {
    s_warp[warp] = __popc(ba);
    s_warp[kMaxWarps + warp] = __popc(bb);
  }
  __syncthreads();
  ra = __popc(ba & below);
  rb = __popc(bb & below);
  na = 0;
  nb = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
    const int ca = s_warp[w], cb = s_warp[kMaxWarps + w];
    if (w < warp) {
      ra += ca;
      rb += cb;
    }
    na += ca;
    nb += cb;
  }
}

__global__ void __launch_bounds__(kMaxThreads) sort_scan_kernel(const SortArgs a) {
  extern __shared__ float smem[];
  const int mt = a.mt, md = a.md, nf = a.frames;
  const int lane_idx = blockIdx.x;
  const int t = threadIdx.x;
  const bool slot = t < mt, det = t < md;

  float* s_cov = smem;                       // mt * 49
  float* s_work = s_cov + mt * 49;           // mt * 49
  float* s_profit = s_work + mt * 49;        // md * mt, [j][i]
  float* s_box = s_profit + md * mt;         // md * 4
  float* s_z = s_box + md * 4;               // md * 4
  float* s_price = s_z + md * 4;             // md
  float* s_bid = s_price + md;               // mt
  int* s_valid = reinterpret_cast<int*>(s_bid + mt);  // md
  int* s_matched = s_valid + md;             // md
  int* s_dtid = s_matched + md;              // md
  int* s_rank2det = s_dtid + md;             // md
  int* s_c2r = s_rank2det + md;              // md
  int* s_colwin = s_c2r + md;                // md
  int* s_bidcol = s_colwin + md;             // mt
  int* s_warp = s_bidcol + mt;               // 2 * kMaxWarps

  // The lane's state: a slot's fields in its thread's registers, its
  // covariance in shared memory.
  float mean[7] = {};
  bool exists = false, active = false;
  int tid = 0, start = 0, lastm = 0, hits = 0, hs = 0, tsu = 0, age = 0;
  const long sl = (long)lane_idx * mt + t;
  if (slot) {
#pragma unroll
    for (int q = 0; q < 7; ++q) mean[q] = a.mean[sl * 7 + q];
    for (int q = 0; q < 49; ++q) s_cov[t * 49 + q] = a.cov[sl * 49 + q];
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

  for (int f = 0; f < nf; ++f) {
    const int ts = ts0 + f * a.gamma;
    const bool commit = f < nwin;
    const long lf = (long)lane_idx * nf + f;
    float* work = s_work + t * 49;
    __syncthreads();  // the previous window is done with the detections

    // The window's detections.
    if (det) {
      const long bi = lf * md + t;
#pragma unroll
      for (int q = 0; q < 4; ++q) s_box[t * 4 + q] = a.ltwh[bi * 4 + q];
      s_valid[t] = a.valid[bi] != 0;
      bbox_to_z(s_box + t * 4, s_z + t * 4);
      s_matched[t] = 0;
      s_dtid[t] = -1;
      s_price[t] = 0.0f;
      s_c2r[t] = -1;
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
        for (int q = 0; q < 49; ++q) work[q] = s_cov[t * 49 + q];
      }
      x_to_bbox(mp, a.quirk != 0, pred);
#pragma unroll
      for (int q = 0; q < 4; ++q) a.o_track_ltwh[so * 4 + q] = pred[q];
    }
    __syncthreads();  // the detections are in

    // The profit row: -(weight - IoU) for live pairs, kNeg for the rest.
    int r2c = md;  // parked on overflow: not a row that bids
    if (slot) {
      const float weight = active ? 1.0f : 2.0f;
      for (int j = 0; j < md; ++j) {
        const float cost = sub(weight, iou(pred, s_box + j * 4));
        s_profit[j * mt + t] = exists && s_valid[j] ? -cost : kNeg;
      }
      r2c = exists ? -1 : md;
    }

    // The auction, each round in three steps.
    int it = 0, searches = 0, unassigned = 0;
    while (it < a.max_iters && (unassigned = __syncthreads_count(slot && r2c < 0)) > 0) {
      searches += unassigned;
      int bidcol = -1;
      if (slot) {
        float bid = 0.0f;
        if (r2c < 0) {
          int bj = 0;
          float bv = sub(s_profit[t], s_price[0]);
          for (int j = 1; j < md; ++j) {
            const float v = sub(s_profit[j * mt + t], s_price[j]);
            if (v > bv) {
              bv = v;
              bj = j;
            }
          }
          float second = ovf_v;
          for (int j = 0; j < md; ++j)
            if (j != bj) second = fmaxf(second, sub(s_profit[j * mt + t], s_price[j]));
          if (bv <= ovf_v) {
            r2c = md;  // overflow beats every column: out for good
          } else {
            bidcol = bj;
            bid = add(add(s_price[bj], sub(bv, second)), a.eps);
          }
        }
        s_bidcol[t] = bidcol;
        s_bid[t] = bid;
      }
      __syncthreads();
      if (det) {
        float best = kNeg;
        int win = -1;
        for (int i = 0; i < mt; ++i)
          if (s_bidcol[i] == t && s_bid[i] > best) {
            best = s_bid[i];
            win = i;
          }
        if (win >= 0) {
          s_c2r[t] = win;
          s_price[t] = best;
        }
        s_colwin[t] = win;
      }
      __syncthreads();
      if (slot) {
        if (r2c >= 0 && r2c < md && s_colwin[r2c] >= 0) r2c = -1;  // lost
        if (bidcol >= 0 && s_colwin[bidcol] == t) r2c = bidcol;    // won
      }
      ++it;
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
        const float piou = iou(pred, s_box + col * 4);
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

    // Births: the free slot of rank k takes the unmatched detection of rank k.
    const bool unmatched = det && s_valid[t] && !s_matched[t];
    int det_rank, free_rank, n_unmatched, n_free;
    block_ranks(unmatched, slot && !exists_n, s_warp, det_rank, free_rank, n_unmatched, n_free);
    if (unmatched) s_rank2det[det_rank] = t;
    if (det) a.o_det_track_id[lf * md + t] = s_dtid[t];
    __syncthreads();  // the births' map is in
    if (slot) {
      int tid_n = tid, start_n = start;
      if (!exists_n && free_rank < n_unmatched) {
        const int d = s_rank2det[free_rank];
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
  if (slot) {
#pragma unroll
    for (int q = 0; q < 7; ++q) a.mean_o[sl * 7 + q] = mean[q];
    for (int q = 0; q < 49; ++q) a.cov_o[sl * 49 + q] = s_cov[t * 49 + q];
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
  const int threads = ((std::max(args->mt, args->md) + 31) / 32) * 32;
  const size_t bytes = 4 * (size_t)shared_words(args->mt, args->md);
  cudaError_t err = cudaFuncSetAttribute(sort_scan_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  if (args->lanes == 0 || args->frames == 0) return cudaSuccess;
  sort_scan_kernel<<<args->lanes, threads, bytes, static_cast<cudaStream_t>(stream)>>>(*args);
  return cudaGetLastError();
}

}  // extern "C"
