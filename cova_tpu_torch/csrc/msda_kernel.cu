// K11 ms_deform_attn: RT-DETR's multi-scale deformable cross-attention
// core, one launch a decoder layer, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no transformer detector.
// The port's RT-DETR-R50 oracle (models/rtdetr.py) runs it in each of its
// six decoder layers. In PyTorch the core is a dozen launches: the
// softmax of the attention logits, the sampling locations from the
// reference boxes and the raw offsets, the grid in [-1, 1], a
// `grid_sample` a level over permuted copies of the value, a stack, the
// weighted product and its sum. No one torch op computes it. This kernel
// takes the four raw inputs and writes the output once:
//
//   for each batch b, query q, head h and channel c:
//     w[s]   = softmax over the head's L * P logits[b, q, h, s]
//     loc[s] = box_xy + offset[b, q, h, s] / P * box_wh * 0.5  (s = l*P + p)
//     out[b, q, h*C + c] = sum_s w[s] * bilinear(value[b, level l, ., h, c], loc[s])
//
// with `grid_sample`'s arithmetic: the grid 2 * loc - 1, unnormalised as
// ((g + 1) * size - 1) / 2 (align_corners false) or ((g + 1) / 2) *
// (size - 1) (true), the four corners weighted and summed in its order
// (nw, ne, sw, se), a corner outside the map read as zero. The locations
// are rounded step by step as the separate torch ops round them, so the
// sampling coordinates equal the plain version's; the softmax and the
// weighted sum over the L * P samples round in another order, so the
// output agrees to a few ulps, not bit for bit.
//
// What bounds it: neither bytes nor operations at the published shape
// (8400 value tokens, 300 queries, 8 heads of 32 channels, 3 levels, 4
// points): 28,800 samples a launch gather 4 rows of 128 bytes each, a
// few MB that `value_proj` has just written and L2 still holds, and 9.2
// MFLOP. What it waits on is the dependent gathers.
//
// Design: a warp a (batch, query, head), a lane a channel (C = 32), so
// each corner of a sample is one coalesced 128-byte row of the value. The
// first L * P lanes each compute one sample's softmax weight and
// location (the warp reduces the max and the sum by shuffles); the warp
// then walks the samples, each lane taking a sample's coordinates and
// weight by shuffle, gathering its channel at the four corners and
// accumulating in a register. Nothing goes through shared memory; 2400
// warps at the published shape, all resident at once.
#include <cuda_runtime.h>
#include <climits>
#include <math.h>
#include <stdint.h>

// Channels a head: one a lane.
constexpr int kChannels = 32;
// Levels and samples a head the kernel holds (L * P lanes of a warp).
constexpr int kMaxLevels = 4;
constexpr int kMaxSamples = 32;

// Filled by ops/cuda/msda_kernel.py (`_Args`): keep the two in step.
struct MsdaArgs {
  const float* value;    // (batch, lv, heads, kChannels) contiguous
  const float* boxes;    // (batch, lq, 4) cx cy w h, contiguous
  const float* offsets;  // (batch, lq, heads, levels, points, 2) contiguous
  const float* logits;   // (batch, lq, heads, levels * points) contiguous
  float* out;            // (batch, lq, heads * kChannels) contiguous
  int batch, lq, lv, heads, levels, points;
  int map_h[kMaxLevels], map_w[kMaxLevels], start[kMaxLevels];
  int align_corners;
};

#ifndef COVA_HOST_STUB
#define LAUNCH(kernel, grid, block, smem, stream, ...) \
  kernel<<<(grid), (block), (smem), (stream)>>>(__VA_ARGS__)
#endif

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// grid_sample's unnormalisation (ATen/native/cuda/GridSampler.cuh), the
// same expression, so that nvcc contracts it the same way.
__device__ __forceinline__ float unnormalize(float coord, int size, bool align_corners) {
  if (align_corners) return ((coord + 1.f) / 2) * (size - 1);
  return ((coord + 1.f) * size - 1) / 2;
}

// grid_sample's guard before the float -> int conversion.
__device__ __forceinline__ float safe_downgrade(float x) {
  if (x > INT_MAX - 1 || x < INT_MIN || !isfinite(x)) return -100.0f;
  return x;
}

__device__ __forceinline__ bool inside(int y, int x, int h, int w) {
  return y >= 0 && y < h && x >= 0 && x < w;
}

__global__ void __launch_bounds__(kThreads) ms_deform_attn_kernel(MsdaArgs a) {
  const int lane = threadIdx.x & 31;
  const long long warp = (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const long long total = (long long)a.batch * a.lq * a.heads;
  if (warp >= total) return;
  const int h = int(warp % a.heads);
  const long long bq = warp / a.heads;  // b * lq + q
  const int b = int(bq / a.lq);
  const int n = a.levels * a.points;

  // Lane s < n: sample s's softmax weight and sampling coordinates.
  const float logit = lane < n ? a.logits[warp * n + lane] : -INFINITY;
  float m = logit;
  for (int d = 16; d > 0; d >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, d));
  const float e = lane < n ? expf(logit - m) : 0.f;
  float sum = e;
  for (int d = 16; d > 0; d >>= 1) sum += __shfl_xor_sync(kFull, sum, d);
  const float weight = e / sum;
  float ix = -100.0f, iy = -100.0f;
  if (lane < n) {
    const int l = lane / a.points;
    const float* box = a.boxes + bq * 4;
    const float* off = a.offsets + (warp * n + lane) * 2;
    const float p = float(a.points);
    // box_xy + ((offset / P) * box_wh) * 0.5, each step rounded.
    const float lx = __fadd_rn(box[0], __fmul_rn(__fmul_rn(__fdiv_rn(off[0], p), box[2]), 0.5f));
    const float ly = __fadd_rn(box[1], __fmul_rn(__fmul_rn(__fdiv_rn(off[1], p), box[3]), 0.5f));
    const float gx = __fsub_rn(__fmul_rn(2.f, lx), 1.f);
    const float gy = __fsub_rn(__fmul_rn(2.f, ly), 1.f);
    ix = safe_downgrade(unnormalize(gx, a.map_w[l], a.align_corners != 0));
    iy = safe_downgrade(unnormalize(gy, a.map_h[l], a.align_corners != 0));
  }

  const long long row = (long long)a.heads * kChannels;  // floats a value token
  const float* base = a.value + (long long)b * a.lv * row + h * kChannels + lane;
  float acc = 0.f;
#pragma unroll 4
  for (int s = 0; s < n; ++s) {
    const float x = __shfl_sync(kFull, ix, s);
    const float y = __shfl_sync(kFull, iy, s);
    const float w = __shfl_sync(kFull, weight, s);
    const int l = s / a.points;
    const int mh = a.map_h[l], mw = a.map_w[l];
    const float* v = base + (long long)a.start[l] * row;
    const float x_nw = floorf(x), y_nw = floorf(y);
    const float x_se = x_nw + 1, y_se = y_nw + 1;
    const float nw = (x_se - x) * (y_se - y);
    const float ne = (x - x_nw) * (y_se - y);
    const float sw = (x_se - x) * (y - y_nw);
    const float se = (x - x_nw) * (y - y_nw);
    const int x0 = int(x_nw), y0 = int(y_nw);
    float val = 0.f;
    if (inside(y0, x0, mh, mw)) val += v[(long long)(y0 * mw + x0) * row] * nw;
    if (inside(y0, x0 + 1, mh, mw)) val += v[(long long)(y0 * mw + x0 + 1) * row] * ne;
    if (inside(y0 + 1, x0, mh, mw)) val += v[(long long)((y0 + 1) * mw + x0) * row] * sw;
    if (inside(y0 + 1, x0 + 1, mh, mw)) val += v[(long long)((y0 + 1) * mw + x0 + 1) * row] * se;
    acc += val * w;
  }
  a.out[bq * row + h * kChannels + lane] = acc;
}

}  // namespace

extern "C" {

// Launch K11 on `stream` for the layer described by *args (device
// pointers; the wrapper has checked shapes, dtypes, devices and the
// limits: kChannels channels a head, at most kMaxLevels levels and
// kMaxSamples samples a head). Returns cudaGetLastError() after the
// launch: nonzero when it was refused.
int cova_ms_deform_attn(const MsdaArgs* args, void* stream) {
  const MsdaArgs& a = *args;
  const long long warps = (long long)a.batch * a.lq * a.heads;
  if (warps == 0) return static_cast<int>(cudaGetLastError());
  const unsigned grid = unsigned((warps + kThreads / 32 - 1) / (kThreads / 32));
  LAUNCH(ms_deform_attn_kernel, grid, kThreads, 0, static_cast<cudaStream_t>(stream), a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
