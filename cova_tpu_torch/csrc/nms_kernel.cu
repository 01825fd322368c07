// Greedy class-aware non-maximum suppression of a batch of images, for
// Hopper (sm_90a).
//
// Replaces the sequential suppression sweep of cova_tpu/ops/nms.py
// (`batched_nms`, a `fori_loop` of N dependent steps that XLA ran on the
// TPU; there was no Pallas kernel) and computes the same result as the
// plain version, cova_tpu_torch/ops/nms.py: a stable descending sort by
// score, `alive = score > score_threshold`, then for i = 0..N-1 in order
// an alive box i kills every later box j of its class whose IoU with it
// exceeds iou_threshold, and finally the survivors compacted in index
// order into max_out slots (zeros, class -1 and valid 0 after them).
//
// What bounds it: N <= 1024 candidates are a few KB, read once from
// device memory. The sweep is N dependent steps, each ended by a block
// barrier, so the kernel is bound by the latency of that chain, not by
// bytes or FLOPs. Translated literally into PyTorch, each step is several
// launches, and the sweep costs thousands of launches per image.
//
// Design: one thread block per image, one thread per candidate. The
// block ranks the scores (rank = number of higher scores plus equal
// scores at lower indices: the stable sort) and scatters the candidates
// into shared memory in sorted order. In step i every thread j > i tests
// its own box against box i. A step whose box i is dead writes nothing,
// and every thread reads the same alive[i], so the whole block skips it
// without a barrier. The compaction is a ballot-and-popcount prefix sum.
//
// Exactness: the IoU uses the plain version's formula on half-open
// rectangles, each operation rounded on its own (__fadd_rn, __fmul_rn,
// __fdiv_rn), so no fused multiply-add can move a box across the
// threshold, and the outputs equal the plain version's bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxN = 1024;

__device__ __forceinline__ float iou(float ax1, float ay1, float aw, float ah,
                                     float bx1, float by1, float bw,
                                     float bh) {
  const float ax2 = __fadd_rn(ax1, aw), ay2 = __fadd_rn(ay1, ah);
  const float bx2 = __fadd_rn(bx1, bw), by2 = __fadd_rn(by1, bh);
  const float ix = fmaxf(__fsub_rn(fminf(ax2, bx2), fmaxf(ax1, bx1)), 0.0f);
  const float iy = fmaxf(__fsub_rn(fminf(ay2, by2), fmaxf(ay1, by1)), 0.0f);
  const float inter = __fmul_rn(ix, iy);
  const float uni =
      __fsub_rn(__fadd_rn(__fmul_rn(aw, ah), __fmul_rn(bw, bh)), inter);
  return uni > 0.0f ? __fdiv_rn(inter, fmaxf(uni, 1e-12f)) : 0.0f;
}

__global__ void __launch_bounds__(kMaxN)
    nms_kernel(const float* __restrict__ ltwh, const float* __restrict__ scores,
               const int32_t* __restrict__ classes, int n, float iou_thr,
               float score_thr, int max_out, float* __restrict__ out_ltwh,
               float* __restrict__ out_scores, int32_t* __restrict__ out_cls,
               uint8_t* __restrict__ out_valid) {
  __shared__ float raw[kMaxN];
  __shared__ float bx[kMaxN], by[kMaxN], bw[kMaxN], bh[kMaxN], bs[kMaxN];
  __shared__ int32_t bc[kMaxN];
  __shared__ uint8_t alive[kMaxN];
  __shared__ int warp_off[kMaxN / 32 + 1];

  const int img = blockIdx.x;
  const int j = threadIdx.x;
  const float* in_box = ltwh + static_cast<int64_t>(img) * n * 4;
  const float* in_score = scores + static_cast<int64_t>(img) * n;
  const int32_t* in_cls = classes + static_cast<int64_t>(img) * n;

  if (j < n) raw[j] = in_score[j];
  __syncthreads();

  // Stable descending sort: candidate j lands at its rank.
  if (j < n) {
    const float s = raw[j];
    int rank = 0;
    for (int i = 0; i < n; ++i) {
      const float t = raw[i];
      rank += (t > s) || (t == s && i < j);
    }
    bx[rank] = in_box[4 * j + 0];
    by[rank] = in_box[4 * j + 1];
    bw[rank] = in_box[4 * j + 2];
    bh[rank] = in_box[4 * j + 3];
    bs[rank] = s;
    bc[rank] = in_cls[j];
  }
  __syncthreads();
  if (j < n) alive[j] = bs[j] > score_thr;
  __syncthreads();

  // The sweep. Thread j holds its own box in registers.
  float mx = 0.f, my = 0.f, mw = 0.f, mh = 0.f;
  int32_t mc = 0;
  if (j < n) {
    mx = bx[j];
    my = by[j];
    mw = bw[j];
    mh = bh[j];
    mc = bc[j];
  }
  for (int i = 0; i < n - 1; ++i) {
    if (!alive[i]) continue;  // the same value in every thread
    if (j > i && j < n && alive[j] && bc[i] == mc &&
        iou(bx[i], by[i], bw[i], bh[i], mx, my, mw, mh) > iou_thr) {
      alive[j] = 0;
    }
    __syncthreads();
  }

  // Compaction in index order: a prefix count of the survivors.
  const int a = j < n ? alive[j] : 0;
  const unsigned ballot = __ballot_sync(0xffffffffu, a);
  const int lane = j & 31, warp = j >> 5;
  if (lane == 0) warp_off[warp + 1] = __popc(ballot);
  __syncthreads();
  if (j == 0) {
    warp_off[0] = 0;
    for (int w = 1; w <= static_cast<int>(blockDim.x >> 5); ++w) {
      warp_off[w] += warp_off[w - 1];
    }
  }
  __syncthreads();
  const int total = warp_off[blockDim.x >> 5];
  const int pos = warp_off[warp] + __popc(ballot & ((1u << lane) - 1u));

  float* o_box = out_ltwh + static_cast<int64_t>(img) * max_out * 4;
  float* o_score = out_scores + static_cast<int64_t>(img) * max_out;
  int32_t* o_cls = out_cls + static_cast<int64_t>(img) * max_out;
  uint8_t* o_valid = out_valid + static_cast<int64_t>(img) * max_out;
  if (a && pos < max_out) {
    o_box[4 * pos + 0] = mx;
    o_box[4 * pos + 1] = my;
    o_box[4 * pos + 2] = mw;
    o_box[4 * pos + 3] = mh;
    o_score[pos] = bs[j];
    o_cls[pos] = mc;
    o_valid[pos] = 1;
  }
  for (int p = total + j; p < max_out; p += blockDim.x) {
    o_box[4 * p + 0] = 0.f;
    o_box[4 * p + 1] = 0.f;
    o_box[4 * p + 2] = 0.f;
    o_box[4 * p + 3] = 0.f;
    o_score[p] = 0.f;
    o_cls[p] = -1;
    o_valid[p] = 0;
  }
}

}  // namespace

extern "C" {

// NMS of `b` images of `n` candidates each (contiguous device memory:
// ltwh (b, n, 4) f32, scores (b, n) f32, classes (b, n) int32) into
// out_ltwh (b, max_out, 4) f32, out_scores (b, max_out) f32, out_cls
// (b, max_out) int32 and out_valid (b, max_out) u8 on `stream`. Needs
// n <= 1024 (the wrapper checks). Returns cudaGetLastError() after the
// launch: nonzero when the launch was refused.
int cova_nms(const void* ltwh, const void* scores, const void* classes, int b,
             int n, float iou_thr, float score_thr, int max_out,
             void* out_ltwh, void* out_scores, void* out_cls, void* out_valid,
             void* stream) {
  if (n < 0 || n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = n <= 32 ? 32 : ((n + 31) / 32) * 32;
  if (b > 0) {
    nms_kernel<<<b, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(ltwh), static_cast<const float*>(scores),
        static_cast<const int32_t*>(classes), n, iou_thr, score_thr, max_out,
        static_cast<float*>(out_ltwh), static_cast<float*>(out_scores),
        static_cast<int32_t*>(out_cls), static_cast<uint8_t*>(out_valid));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
