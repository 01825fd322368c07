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
// What bounds it: at the oracle's shape (N = 512, max_out = 64) the kernel
// reads 12 KB and writes 1.6 KB, 4 ns at 3.35 TB/s, and the same-class
// IoU tests are at most N(N-1)/2 = 130,816, about 2 MFLOP, 0.03 us at
// 67 TFLOP/s. Neither is the floor: a launch alone costs about a
// microsecond. What a kernel can lose is its own serial chain (a sweep
// that ends each of up to N-1 steps with a block barrier), so the design
// keeps that chain short and spreads the parallel work over several SMs,
// since one image would leave all but one SM idle.
//
// Design: one cluster of 8 blocks of 1024 threads per image (Hopper's
// thread block clusters), four phases separated by barriers; apart from
// the stages of the sort that unsorted input needs, no barrier inside any
// loop, and none per candidate.
//  1. Stable order, in every block of the cluster. If the scores are
//     already non-increasing (a neighbour compare and __syncthreads_and;
//     the oracle hands over its top 512 sorted), candidate j stays at j;
//     otherwise a bitonic sort of (score descending, index ascending)
//     keys in shared memory places them. The candidates land in shared
//     memory in that order, and a ballot gives the `dead` words (bit j:
//     j is not alive).
//  2. The suppression bitmask, all of it at once, spread over the 8 SMs
//     of the cluster and written into the shared memory of its first
//     block (distributed shared memory): bit b of word w of row i is set
//     when j = 32w + b > i, both are alive, cls[j] == cls[i] and
//     iou(i, j) > iou_threshold. A warp takes a tile of 32 rows by 32
//     columns: each lane holds its column's box in registers, the row's
//     box is broadcast from shared memory, and __ballot_sync makes the
//     row's word, which the row's own lane keeps and stores. Rows of dead
//     boxes are skipped (no scan reads them), and the class is tested
//     before the IoU. The row stride is odd, so neither the build's
//     stores nor the scan's loads meet a bank conflict.
//  3. The greedy scan, on one warp of the first block: every lane
//     follows the current word, and lane l holds word l of `removed |
//     dead` for the words after it. __ffs on the current word's
//     complement gives the next live box, which is kept (a box still
//     alive when the scan reaches it is final); its row's word is ORed
//     into the current word and the lanes' words. Dead and removed boxes
//     cost nothing, and the scan stops at the max_out-th kept box, which
//     settles the whole output: about max_out + N/32 short steps in all.
//  4. The kept indices are already in index order; every thread writes
//     its rows and the padding.
//
// Exactness: the IoU uses the plain version's formula on half-open
// rectangles, box i as the first argument, each operation rounded on its
// own (__fadd_rn, __fmul_rn, __fdiv_rn), so no fused multiply-add can move
// a box across the threshold, and the outputs equal the plain version's
// bit for bit.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kMaxN = 1024;
constexpr int kThreads = kMaxN;  // one thread per candidate in phase 1
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 8;      // blocks (SMs) that build one image's mask

// Row stride of the suppression mask in 32-bit words, odd: a warp's 32
// rows of one column, and a row's 32 words, each fall in 32 banks.
__host__ __device__ constexpr int mask_stride(int n) { return ((n + 31) / 32) | 1; }

constexpr size_t kMaxMaskBytes = size_t(kMaxN) * mask_stride(kMaxN) * 4;

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

// A key whose ascending order is the descending order of the scores as
// torch sorts them: -0.0 equals 0.0, and NaN comes after every number.
__device__ __forceinline__ uint32_t descending_key(float s) {
  if (s != s) return 0xffffffffu;
  const uint32_t u = __float_as_uint(s == 0.0f ? 0.0f : s);
  return (u & 0x80000000u) ? u : ~(u | 0x80000000u);
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
    nms_kernel(const float* __restrict__ ltwh, const float* __restrict__ scores,
               const int32_t* __restrict__ classes, int n, float iou_thr,
               float score_thr, int max_out, float* __restrict__ out_ltwh,
               float* __restrict__ out_scores, int32_t* __restrict__ out_cls,
               uint8_t* __restrict__ out_valid) {
  __shared__ float raw[kMaxN];
  __shared__ uint64_t key[kMaxN];
  __shared__ float4 box[kMaxN];
  __shared__ float score[kMaxN];
  __shared__ int32_t cls[kMaxN];
  __shared__ uint32_t dead[kWarps];
  __shared__ int32_t keep[kMaxN];
  __shared__ int num_kept;
  extern __shared__ uint32_t mask[];  // n rows of mask_stride(n) words

  cg::cluster_group cluster = cg::this_cluster();
  const int part = static_cast<int>(cluster.block_rank());
  const int img = blockIdx.x / kCluster;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int nw = (n + 31) / 32;
  const int stride = mask_stride(n);
  const float* in_box = ltwh + static_cast<int64_t>(img) * n * 4;
  const float* in_score = scores + static_cast<int64_t>(img) * n;
  const int32_t* in_cls = classes + static_cast<int64_t>(img) * n;

  // 1. Stable descending order. Already in it, candidate t keeps index t;
  // otherwise a bitonic sort of (score descending, index ascending) keys
  // gives the candidate at each position.
  const float s = t < n ? in_score[t] : 0.0f;
  if (t < n) raw[t] = s;
  __syncthreads();
  const bool in_order =
      __syncthreads_and(t + 1 >= n || raw[t] >= raw[t + 1]);
  int src = t;
  if (!in_order) {
    key[t] = t < n ? (static_cast<uint64_t>(descending_key(s)) << 32) | t : ~0ull;
    int size = 1;
    while (size < n) size <<= 1;
    __syncthreads();
    for (int k = 2; k <= size; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        const int other = t ^ j;
        if (other > t && other < size) {
          const uint64_t a = key[t], b = key[other];
          if ((a > b) == ((t & k) == 0)) {
            key[t] = b;
            key[other] = a;
          }
        }
        __syncthreads();
      }
    }
    src = static_cast<int>(key[t] & 0xffffffffu);
  }
  if (t < n) {
    box[t] = make_float4(in_box[4 * src + 0], in_box[4 * src + 1],
                         in_box[4 * src + 2], in_box[4 * src + 3]);
    score[t] = in_order ? s : raw[src];
    cls[t] = in_cls[src];
  }
  __syncthreads();
  const unsigned alive = __ballot_sync(0xffffffffu, t < n && score[t] > score_thr);
  if (lane == 0) dead[warp] = ~alive;
  cluster.sync();  // and every block of the cluster has started

  // 2. The suppression bitmask, built by the whole cluster into the
  // shared memory of its first block: tile p is column tile w, row tile
  // r <= w.
  uint32_t* mask0 = cluster.map_shared_rank(mask, 0);
  const int tiles = nw * (nw + 1) / 2;
  for (int p = part * kWarps + warp; p < tiles; p += kCluster * kWarps) {
    int w = static_cast<int>((sqrtf(8.0f * p + 1.0f) - 1.0f) * 0.5f);
    while ((w + 1) * (w + 2) / 2 <= p) ++w;
    while (w * (w + 1) / 2 > p) --w;
    const int r = p - w * (w + 1) / 2;
    const uint32_t rows = ~dead[r];
    if (rows == 0) continue;  // the same in every lane
    const int j = 32 * w + lane;
    const bool jlive = (~dead[w] >> lane) & 1u;
    const float4 bj = box[j];
    const int32_t cj = cls[j];
    uint32_t word = 0;
    for (uint32_t todo = rows; todo != 0; todo &= todo - 1) {
      const int k = __ffs(todo) - 1;  // the same in every lane
      const int i = 32 * r + k;
      const float4 bi = box[i];
      const bool hit = jlive && j > i && cls[i] == cj &&
                       iou(bi.x, bi.y, bi.z, bi.w, bj.x, bj.y, bj.z, bj.w) > iou_thr;
      const uint32_t bits = __ballot_sync(0xffffffffu, hit);
      if (lane == k) word = bits;
    }
    if ((rows >> lane) & 1u) mask0[(32 * r + lane) * stride + w] = word;
  }
  cluster.sync();
  if (part != 0) return;

  // 3. The greedy scan on warp 0, until max_out boxes are kept. Every lane
  // follows the current word w in `cur`; lane l keeps word l of later
  // words in `gone`.
  if (warp == 0) {
    uint32_t gone = lane < nw ? dead[lane] : 0xffffffffu;
    int kept = 0;
    for (int w = 0; w < nw && kept < max_out; ++w) {
      uint32_t cur = __shfl_sync(0xffffffffu, gone, w);
      while (cur != 0xffffffffu && kept < max_out) {
        const int b = __ffs(~cur) - 1;
        const int i = 32 * w + b;
        if (lane == 0) keep[kept] = i;
        ++kept;
        // Row i has words from its own tile w on; bits j <= i are clear.
        const uint32_t* row = mask + i * stride;
        cur |= row[w] | ((2u << b) - 1u);
        if (lane > w && lane < nw) gone |= row[lane];
      }
    }
    if (lane == 0) num_kept = kept;
  }
  __syncthreads();

  // 4. The kept rows in index order, then the padding.
  const int kept = num_kept;
  float* o_box = out_ltwh + static_cast<int64_t>(img) * max_out * 4;
  float* o_score = out_scores + static_cast<int64_t>(img) * max_out;
  int32_t* o_cls = out_cls + static_cast<int64_t>(img) * max_out;
  uint8_t* o_valid = out_valid + static_cast<int64_t>(img) * max_out;
  for (int q = t; q < max_out; q += kThreads) {
    if (q < kept) {
      const int i = keep[q];
      const float4 bi = box[i];
      o_box[4 * q + 0] = bi.x;
      o_box[4 * q + 1] = bi.y;
      o_box[4 * q + 2] = bi.z;
      o_box[4 * q + 3] = bi.w;
      o_score[q] = score[i];
      o_cls[q] = cls[i];
      o_valid[q] = 1;
    } else {
      o_box[4 * q + 0] = 0.f;
      o_box[4 * q + 1] = 0.f;
      o_box[4 * q + 2] = 0.f;
      o_box[4 * q + 3] = 0.f;
      o_score[q] = 0.f;
      o_cls[q] = -1;
      o_valid[q] = 0;
    }
  }
}

// Lets nms_kernel take the largest mask on the current device, once per
// device (setting it twice is harmless).
cudaError_t allow_large_mask() {
  static bool ready[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && ready[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(nms_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kMaxMaskBytes));
  if (err == cudaSuccess && dev < 64) ready[dev] = true;
  return err;
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
  const cudaError_t err = allow_large_mask();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = size_t(n) * mask_stride(n) * 4;
  if (b > 0) {
    nms_kernel<<<b * kCluster, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(ltwh), static_cast<const float*>(scores),
        static_cast<const int32_t*>(classes), n, iou_thr, score_thr, max_out,
        static_cast<float*>(out_ltwh), static_cast<float*>(out_scores),
        static_cast<int32_t*>(out_cls), static_cast<uint8_t*>(out_valid));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
