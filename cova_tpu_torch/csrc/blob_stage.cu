// K4 blob_stage: the tail of one BlobNet encoder stage, after its
// convolution, in one pass, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves the stage's tail to XLA
// (cova_tpu/models/blobnet.py, BlobNet.__call__: relu, BatchNorm, the 2x2
// max pool and its top/left zero pad, PointWiseTemporal). In PyTorch that
// tail is about a dozen launches a stage, each reading back what the one
// before wrote (relu, BatchNorm, the pool with its unread int64 indices,
// the pad, the einsum's permuted copies, two K = 4 products, three relus,
// the add, the copy of the final reshape). This kernel computes the same
// function from the convolution's output in one read and one write:
//
//   for each window b, channel c and pooled cell (py, px), per timestep t:
//     p[t] = max over the 2x2 cell of BN(relu(y[b*4 + t, c, ., .])),
//            0 where (py, px) lies in the top row / left column that the
//            pool's pad adds when H / W is odd;
//   h = p; for each mix M (4x4): h[s] = relu(sum_t h[t] * M[t][s]);
//   out[b, s, c, py, px] = relu(h[s] + p[s]).
//
// BatchNorm uses the running statistics (eval mode):
// (x - mean) * (weight / sqrt(var + eps)) + bias, each step rounded once,
// the last two fused. The mixes sum t = 0..3 in order with fused
// multiply-adds. Everything is float32; cuDNN's BatchNorm and cuBLAS's
// product round in their own orders, so the kernel agrees with the plain
// version (ops/cuda/blob_stage.py) to rounding, not bit for bit.
//
// What bounds it: bytes. A 68x120 window's four stages read 3.93 MB of
// convolution output and write 1.0 MB; the arithmetic is a few dozen
// operations a cell and timestep. The output is contiguous NCHW a
// (window, timestep), what the next stage's convolution reads.
//
// Design: a thread holds one (window, channel, pooled cell) for all four
// timesteps, so the temporal mixes run in registers and nothing but the
// output is written. The mixes sit in shared memory. Two layouts of the
// input, picked by the launcher from its strides:
//  - NCHW (stages 2-4): a thread a cell, x the fastest across a warp, the
//    two columns of a pooled cell loaded as one float2 where the strides
//    allow; the stores are coalesced as they are.
//  - channels-last (stage 1: the convolution of the permuted input runs
//    cuDNN's NHWC engine): a block holds a run of pooled cells of one
//    window and all channels, C the fastest across a warp, 4 channels a
//    thread loaded as one float4; the results go through shared memory
//    so that the NCHW stores are coalesced too. A channels-last input
//    whose taps are not float4-aligned goes to the NCHW kernel, which
//    reads any strides.
#include <cuda_runtime.h>
#include <stdint.h>

// Timesteps of a window (BlobNet's T) and temporal mixes a stage.
constexpr int kT = 4;
constexpr int kLayers = 2;

// Filled by ops/cuda/blob_stage.py (`_Args`): keep the two in step.
struct BlobStageArgs {
  const float* y;          // (batch * kT, c, h, w), strides below
  long long stride[4];     // y's strides in elements: n, c, h, w
  int batch, c, h, w;
  const float* bn_weight;  // (c,) each
  const float* bn_bias;
  const float* bn_mean;
  const float* bn_var;
  float eps;
  const float* mix[kLayers];  // (kT, kT) row-major each: mix[t][s]
  float* out;                 // (batch, kT, c, hp, wp) contiguous
};

#ifndef COVA_HOST_STUB
#define LAUNCH(kernel, grid, block, smem, stream, ...) \
  kernel<<<(grid), (block), (smem), (stream)>>>(__VA_ARGS__)
#endif

namespace {

constexpr int kThreads = 256;
// Channels a thread of the channels-last kernel (one float4).
constexpr int kVec = 4;

// What the launcher derives from the shape and strides.
struct Geom {
  int hp, wp;          // pooled and padded plane
  int pad_h, pad_w;    // 1 where H / W is odd: the zero row / column
  int groups;          // channels-last: threads a cell (c / kVec)
  int cells;           // channels-last: cells a block
  int blocks_a_window; // channels-last: blocks over one window's plane
};

struct Norm {
  float mean, mul, bias;
};

__device__ __forceinline__ Norm norm_of(const BlobStageArgs& a, int c) {
  Norm n;
  n.mean = a.bn_mean[c];
  n.mul = __fdiv_rn(a.bn_weight[c], __fsqrt_rn(__fadd_rn(a.bn_var[c], a.eps)));
  n.bias = a.bn_bias[c];
  return n;
}

// BatchNorm(relu(v)).
__device__ __forceinline__ float relu_norm(float v, const Norm& n) {
  return __fmaf_rn(__fsub_rn(fmaxf(v, 0.0f), n.mean), n.mul, n.bias);
}

__device__ __forceinline__ float pool4(float a, float b, float c, float d, const Norm& n) {
  return fmaxf(fmaxf(relu_norm(a, n), relu_norm(b, n)), fmaxf(relu_norm(c, n), relu_norm(d, n)));
}

// The stage's mixes, kT x kT each, into shared memory.
__device__ __forceinline__ void load_mix(const BlobStageArgs& a, float* m) {
#pragma unroll
  for (int l = 0; l < kLayers; ++l) {
    for (int i = threadIdx.x; i < kT * kT; i += blockDim.x) m[l * kT * kT + i] = a.mix[l][i];
  }
}

// PointWiseTemporal on one cell: p -> o over the kT timesteps.
__device__ __forceinline__ void temporal(const float (&p)[kT], const float* m, float (&o)[kT]) {
  float h[kT];
#pragma unroll
  for (int t = 0; t < kT; ++t) h[t] = p[t];
#pragma unroll
  for (int l = 0; l < kLayers; ++l) {
    const float* w = m + l * kT * kT;
    float n[kT];
#pragma unroll
    for (int s = 0; s < kT; ++s) {
      float acc = __fmul_rn(h[0], w[s]);
#pragma unroll
      for (int t = 1; t < kT; ++t) acc = __fmaf_rn(h[t], w[t * kT + s], acc);
      n[s] = fmaxf(acc, 0.0f);
    }
#pragma unroll
    for (int s = 0; s < kT; ++s) h[s] = n[s];
  }
#pragma unroll
  for (int s = 0; s < kT; ++s) o[s] = fmaxf(__fadd_rn(h[s], p[s]), 0.0f);
}

// NCHW-like input: a thread a (window, channel, cell), x fastest. kPair:
// the two columns of a cell are adjacent and 8-byte aligned.
template <bool kPair>
__global__ void __launch_bounds__(kThreads)
    blob_stage_nchw_kernel(const BlobStageArgs a, const Geom g) {
  __shared__ float mix[kLayers * kT * kT];
  load_mix(a, mix);
  __syncthreads();
  const unsigned cells = unsigned(a.batch) * a.c * g.hp * g.wp;
  const unsigned i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= cells) return;
  const int px = int(i % g.wp);
  unsigned r = i / g.wp;
  const int py = int(r % g.hp);
  r /= g.hp;
  const int c = int(r % a.c);
  const int b = int(r / a.c);
  float p[kT];
  if (py < g.pad_h || px < g.pad_w) {
#pragma unroll
    for (int t = 0; t < kT; ++t) p[t] = 0.0f;
  } else {
    const Norm n = norm_of(a, c);
    const long long sn = a.stride[0], sh = a.stride[2], sw = a.stride[3];
    const float* base = a.y + c * a.stride[1] + 2LL * (py - g.pad_h) * sh +
                        2LL * (px - g.pad_w) * sw + (long long)b * kT * sn;
    float v[kT][4];
#pragma unroll
    for (int t = 0; t < kT; ++t) {
      const float* q = base + t * sn;
      if constexpr (kPair) {
        const float2 top = *reinterpret_cast<const float2*>(q);
        const float2 bot = *reinterpret_cast<const float2*>(q + sh);
        v[t][0] = top.x, v[t][1] = top.y, v[t][2] = bot.x, v[t][3] = bot.y;
      } else {
        v[t][0] = q[0], v[t][1] = q[sw], v[t][2] = q[sh], v[t][3] = q[sh + sw];
      }
    }
#pragma unroll
    for (int t = 0; t < kT; ++t) p[t] = pool4(v[t][0], v[t][1], v[t][2], v[t][3], n);
  }
  float o[kT];
  temporal(p, mix, o);
  const long long plane = (long long)g.hp * g.wp;
  float* dst = a.out + ((long long)b * kT * a.c + c) * plane + py * g.wp + px;
#pragma unroll
  for (int s = 0; s < kT; ++s) dst[s * a.c * plane] = o[s];
}

// Channels-last input (stride of c is 1; c, the strides of n, h, w and
// the base aligned to kVec floats: cl_ok): a block holds
// g.cells pooled cells of one window and all channels, kVec channels a
// thread loaded as one float4; the outputs are gathered in shared memory,
// [s * c + ch][cell], and stored cell-fastest.
__global__ void __launch_bounds__(kThreads)
    blob_stage_cl_kernel(const BlobStageArgs a, const Geom g) {
  extern __shared__ float tile[];
  __shared__ float mix[kLayers * kT * kT];
  load_mix(a, mix);
  __syncthreads();
  const int plane = g.hp * g.wp;
  const int pitch = g.cells + 1;
  const int b = blockIdx.x / g.blocks_a_window;
  const int q0 = (blockIdx.x % g.blocks_a_window) * g.cells;
  const int k = threadIdx.x / g.groups;
  const int c0 = (threadIdx.x % g.groups) * kVec;
  const int q = q0 + k;
  if (q < plane) {
    const int py = q / g.wp, px = q % g.wp;
    float p[kVec][kT];
    if (py < g.pad_h || px < g.pad_w) {
#pragma unroll
      for (int j = 0; j < kVec; ++j)
#pragma unroll
        for (int t = 0; t < kT; ++t) p[j][t] = 0.0f;
    } else {
      Norm n[kVec];
#pragma unroll
      for (int j = 0; j < kVec; ++j) n[j] = norm_of(a, c0 + j);
      const long long sn = a.stride[0], sh = a.stride[2], sw = a.stride[3];
      const float* base = a.y + c0 + 2LL * (py - g.pad_h) * sh + 2LL * (px - g.pad_w) * sw +
                          (long long)b * kT * sn;
      float4 v[kT][4];  // the 2x2 taps of each timestep
#pragma unroll
      for (int t = 0; t < kT; ++t) {
        const float* q2 = base + t * sn;
        v[t][0] = *reinterpret_cast<const float4*>(q2);
        v[t][1] = *reinterpret_cast<const float4*>(q2 + sw);
        v[t][2] = *reinterpret_cast<const float4*>(q2 + sh);
        v[t][3] = *reinterpret_cast<const float4*>(q2 + sh + sw);
      }
#pragma unroll
      for (int t = 0; t < kT; ++t) {
        p[0][t] = pool4(v[t][0].x, v[t][1].x, v[t][2].x, v[t][3].x, n[0]);
        p[1][t] = pool4(v[t][0].y, v[t][1].y, v[t][2].y, v[t][3].y, n[1]);
        p[2][t] = pool4(v[t][0].z, v[t][1].z, v[t][2].z, v[t][3].z, n[2]);
        p[3][t] = pool4(v[t][0].w, v[t][1].w, v[t][2].w, v[t][3].w, n[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      float o[kT];
      temporal(p[j], mix, o);
#pragma unroll
      for (int s = 0; s < kT; ++s) tile[(s * a.c + c0 + j) * pitch + k] = o[s];
    }
  }
  __syncthreads();
  const int n = kT * a.c * g.cells;
  float* dst = a.out + (long long)b * kT * a.c * plane + q0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int kk = i % g.cells, row = i / g.cells;  // row = s * c + ch
    if (q0 + kk < plane) dst[(long long)row * plane + kk] = tile[row * pitch + kk];
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// Channels-last: every tap of a cell starts kVec floats aligned.
bool cl_ok(const BlobStageArgs& a) {
  return a.c % kVec == 0 && a.c / kVec <= kThreads && a.stride[0] % kVec == 0 &&
         a.stride[2] % kVec == 0 && a.stride[3] % kVec == 0 && aligned(a.y, 4 * kVec);
}

// NCHW: a cell's two columns are adjacent and start 8 bytes aligned (its
// first column is even, so strides n, c, h must be).
bool nchw_pair_ok(const BlobStageArgs& a) {
  return a.stride[3] == 1 && a.stride[0] % 2 == 0 && a.stride[1] % 2 == 0 &&
         a.stride[2] % 2 == 0 && aligned(a.y, 8);
}

}  // namespace

extern "C" {

// Launch K4 on `stream` for the stage described by *args (device
// pointers; the wrapper has checked shapes, dtypes and devices). Returns
// cudaGetLastError() after the launch: nonzero when it was refused. The
// layout is picked from the strides: the channels-last kernel where the
// stride of c is 1, that of w is not and the taps are float4-aligned;
// the NCHW kernel otherwise, which reads any strides.
int cova_blob_stage(const BlobStageArgs* args, void* stream) {
  const BlobStageArgs& a = *args;
  Geom g{};
  g.pad_h = a.h % 2;
  g.pad_w = a.w % 2;
  g.hp = a.h / 2 + g.pad_h;
  g.wp = a.w / 2 + g.pad_w;
  const long long plane = (long long)g.hp * g.wp;
  if (a.batch == 0 || a.c == 0 || plane == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.stride[1] == 1 && a.stride[3] != 1 && cl_ok(a)) {
    g.groups = a.c / kVec;
    g.cells = kThreads / g.groups;
    g.blocks_a_window = int((plane + g.cells - 1) / g.cells);
    const unsigned grid = unsigned(a.batch) * g.blocks_a_window;
    const int threads = g.cells * g.groups;
    const size_t smem = size_t(kT) * a.c * (g.cells + 1) * sizeof(float);
    LAUNCH(blob_stage_cl_kernel, grid, threads, smem, st, a, g);
  } else {
    const long long cells = (long long)a.batch * a.c * plane;  // < 2^31: the wrapper's check
    const unsigned grid = unsigned((cells + kThreads - 1) / kThreads);
    if (nchw_pair_ok(a)) {
      LAUNCH(blob_stage_nchw_kernel<true>, grid, kThreads, 0, st, a, g);
    } else {
      LAUNCH(blob_stage_nchw_kernel<false>, grid, kThreads, 0, st, a, g);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
