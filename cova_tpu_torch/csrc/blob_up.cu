// K12 blob_up: one upsampling block of BlobNet's decoder in one launch,
// for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves the decoder to XLA
// (cova_tpu/models/blobnet.py, BlobNet.__call__: relu, the 4x4 stride-2
// VALID ConvTranspose, the centre crop/pad, BatchNorm and the skip concat,
// or on the last block the 1x1 head and the sigmoid). In PyTorch a block is
// torch.cat, relu, cuDNN's backward-data engine for the transposed
// convolution (it computes the whole 2H+2 x 2W+2 output, a third of which
// the crop then drops), the bias in a pass of its own, the crop's copy and
// BatchNorm; the last block writes 16 channels only for the 1x1 head to
// read them back. This kernel computes, for one block in eval mode:
//
//   in  = relu(cat(x, skip))                    (read in place, no cat)
//   z   = ConvTranspose2d(in) at the kept positions, bias included, and 0
//         where the centre pad adds a position
//   out = BN(z)                                  (blocks with a BatchNorm)
//   out = sigmoid(head_bias + sum_c head[c] * z[c])  (the last block)
//
// The transposed convolution is four 2x2 sub-pixel phases. Write the full
// output coordinate as Y = 2 qy + e, X = 2 qx + f (e, f in {0, 1}); then
//   z[co, Y, X] = bias[co] + sum_{ci, a, b in {0,1}}
//                 in[ci, qy - a, qx - b] * W[ci, co, e + 2a, f + 2b]
// with W ConvTranspose2d's own weight (in, out, kh, kw) and in = 0 outside
// the input. Output (y, x) of the crop/pad is full (y + oy, x + ox); the
// offsets may be odd or negative (a pad), so the phase comes from the full
// coordinate.
//
// What bounds it: operations. A 68x120 window's decoder is 78 MFLOP
// against about 0.7 MB read and written; all arithmetic is float32 fused
// multiply-adds on the CUDA cores (no TF32). A slice's 4 kCs products are
// summed in order from 0 and then added to the running sum, so the kernel
// agrees with cuDNN's order to rounding, not bit for bit.
//
// Design: an implicit GEMM per phase, M = windows x phase pixels, N = 16
// output channels a block (a group; Cout / 16 groups on grid.y), K = 4 Cin.
// A block has four warps, one a phase, so a warp reads the same weights
// (broadcast float4s). A lane holds kPx pixels of one quad row, kPx x 16
// accumulators and as many slice sums in registers; its pixels lie nc quad
// columns apart, so that neighbouring lanes store neighbouring columns. A
// block covers wb windows, r quad rows and nc * kPx quad columns; the
// launcher picks (nc, r, wb) from the shapes so that a warp's 32 lanes are
// filled (narrow planes put several windows in a warp, planes of more than
// 32 * kPx quad columns go in column bands). Cin goes in slices of kCs
// channels: each slice's input tile (its r + 1 input rows, the columns
// with their halo; relu applied once in shared memory) and
// its weights (16 taps x 16 channels, one contiguous run of the packed
// weight, copied 16 bytes at a time) are copied to shared memory by
// cp.async, two slices in flight. What the chip showed: copying the
// weights in the module's own layout (a transpose into shared memory, 16
// ways on one bank) cost as much as the arithmetic, so the wrapper packs
// them once per weight version; three blocks an SM (168 registers, no
// unrolling of the channel loop) beat two at 240 registers.
#include <cuda_runtime.h>
#include <stdint.h>

// Filled by ops/cuda/blob_up.py (`_Args`): keep the two in step.
struct BlobUpArgs {
  const float* x;  // (batch, c1, h, w), strides below: the previous block's output
  long long x_stride[4];
  const float* skip;  // (batch, c2, h, w): the encoder's skip; c2 may be 0
  long long skip_stride[4];
  int batch, c1, c2, h, w;
  // The transposed convolution's weight as the kernel stages it: (cout /
  // 16, slices * kCs, 16 taps, 16 channels), zeros past c1 + c2; the
  // wrapper lays ConvTranspose2d's (c1 + c2, cout, 4, 4) out so once per
  // weight version.
  const float* weight;
  const float* bias;    // (cout,)
  int cout;
  // BatchNorm's running statistics, (cout,) each; null on the last block.
  const float* bn_weight;
  const float* bn_bias;
  const float* bn_mean;
  const float* bn_var;
  float eps;
  // The last block's 1x1 head: (cout,) weights and its bias (1,).
  const float* head_weight;
  const float* head_bias;
  int th, tw;  // output plane
  int oy, ox;  // full-output coordinate of output (0, 0)
  float* out;  // (batch, cout, th, tw), or (batch, th, tw) on the last block
};

#ifndef COVA_HOST_STUB
#define LAUNCH(kernel, grid, block, smem, stream, ...) \
  kernel<<<(grid), (block), (smem), (stream)>>>(__VA_ARGS__)
#endif

namespace {

constexpr int kThreads = 128;  // four warps: one a phase
constexpr int kLanes = 32;
constexpr int kPx = 4;         // pixels a lane
constexpr int kCt = 16;        // output channels a block
constexpr int kCs = 8;         // input channels a slice
constexpr int kTaps = 16;      // 4 x 4
constexpr int kWeights = kCs * kTaps * kCt;  // a slice's weights in shared memory
// Input elements a thread copies a channel: a block's tile holds at most
// 2 * 32 * (kPx + 1) of them (wb * r * nc <= 32 lanes, r + 1 <= 2 r).
constexpr int kSlots = (2 * kLanes * (kPx + 1) + kThreads - 1) / kThreads;

// What the launcher derives from the shapes.
struct Geom {
  int qy0, qx0;  // first quad row and column (full coordinate / 2, floored)
  int qr;        // quad rows
  int nc;        // lanes across a column band (cbands * nc * kPx >= quad columns)
  int cbands;    // blocks over the quad columns
  int r, wb;     // quad rows and windows a block
  int bands;     // blocks over the quad rows
  int used;      // lanes of a warp with a position: wb * r * nc
  int pitch;     // shared floats of a tile row: nc * (kPx + 1)
  int wstride;   // shared floats of a window's r + 1 rows, padded (see cova_blob_up)
  int plane;     // shared floats of a channel's tile: wb * wstride
  int count;     // input elements of a channel's tile: wb * (r + 1) * (nc * kPx + 1)
  int stage;     // shared floats a slice: kWeights + kCs * plane, rounded up to 4
  int slices;    // ceil((c1 + c2) / kCs)
};

__device__ __forceinline__ void copy_async(float* dst, const float* src, bool valid) {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
#else
  *dst = valid ? *src : 0.0f;
#endif
}

__device__ __forceinline__ void copy_async16(float4* dst, const float4* src) {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
#else
  *dst = *src;
#endif
}

__device__ __forceinline__ void copy_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

// Wait until at most `pending` of this thread's copy groups are in flight.
template <int kPending>
__device__ __forceinline__ void copy_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
#endif
}

// One slice's copies: the weights of input channels c0 .. c0 + kCs - 1 for
// this block's 16 output channels as [ci][tap][co] (a contiguous run of the
// packed weight), and the input tile as [ci][window][row][column], columns
// permuted (see the kernel).
__device__ __forceinline__ void stage_slice(const BlobUpArgs& a, const Geom& g, float* buf,
                                            int c0, const int (&src_x)[kSlots],
                                            const int (&src_s)[kSlots],
                                            const int (&dst)[kSlots]) {
  const int cin = a.c1 + a.c2;
  const float4* w = reinterpret_cast<const float4*>(
      a.weight + ((long long)blockIdx.y * g.slices * kCs + c0) * kTaps * kCt);
  for (int j = threadIdx.x; j < kWeights / 4; j += kThreads)
    copy_async16(reinterpret_cast<float4*>(buf) + j, w + j);
  float* in = buf + kWeights;
#pragma unroll
  for (int ci = 0; ci < kCs; ++ci) {
    const int c = c0 + ci;
    const bool from_x = c < a.c1;
    const bool ok_c = c < cin;
    const float* base = from_x ? a.x + (long long)c * a.x_stride[1]
                               : a.skip + (long long)(ok_c ? c - a.c1 : 0) * a.skip_stride[1];
#pragma unroll
    for (int m = 0; m < kSlots; ++m) {
      if (dst[m] < 0) continue;
      const int off = from_x ? src_x[m] : src_s[m];
      const bool ok = ok_c && off >= 0;
      copy_async(in + ci * g.plane + dst[m], ok ? base + off : a.weight, ok);
    }
  }
}

template <bool kHead>
__global__ void __launch_bounds__(kThreads, 3) blob_up_kernel(const BlobUpArgs a, const Geom g) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int warp = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int e = warp >> 1, f = warp & 1;  // the warp's phase
  const int co0 = blockIdx.y * kCt;
  const int cband = blockIdx.x % g.cbands, rest = blockIdx.x / g.cbands;
  const int wset = rest / g.bands, band = rest % g.bands;
  const int w0 = wset * g.wb;
  const int qyb = g.qy0 + band * g.r;            // the band's first quad row
  const int qxb = g.qx0 + cband * g.nc * kPx;    // and first quad column
  const bool active = lane < g.used;
  const int l = active ? lane : 0;
  const int tc = l % g.nc, r = (l / g.nc) % g.r, k = l / (g.nc * g.r);

  // The tile elements this thread copies, the same for every channel: the
  // element offsets of their window, row and column in x and in the skip
  // (-1 outside the input or past the batch) and their place in the tile.
  // Column cc (input column qxb - 1 + cc) sits at (cc % nc) * (kPx + 1) +
  // cc / nc, so that a lane's kPx columns, nc apart, are adjacent.
  int src_x[kSlots], src_s[kSlots], dst[kSlots];
  const int cols = g.nc * kPx + 1;
#pragma unroll
  for (int m = 0; m < kSlots; ++m) {
    const int idx = threadIdx.x + m * kThreads;
    src_x[m] = src_s[m] = dst[m] = -1;
    if (idx < g.count) {
      const int cc = idx % cols, t = idx / cols;
      const int rr = t % (g.r + 1), kk = t / (g.r + 1);
      const int wi = w0 + kk, iy = qyb - 1 + rr, ix = qxb - 1 + cc;
      if (wi < a.batch && iy >= 0 && iy < a.h && ix >= 0 && ix < a.w) {
        src_x[m] = int(wi * a.x_stride[0] + iy * a.x_stride[2] + ix * a.x_stride[3]);
        src_s[m] = int(wi * a.skip_stride[0] + iy * a.skip_stride[2] + ix * a.skip_stride[3]);
      }
      dst[m] = kk * g.wstride + rr * g.pitch + (cc % g.nc) * (kPx + 1) + cc / g.nc;
    }
  }

  float acc[kPx][kCt];
#pragma unroll
  for (int j = 0; j < kPx; ++j)
#pragma unroll
    for (int c = 0; c < kCt; ++c) acc[j][c] = 0.0f;

  // This lane's tile row qy - 1 (a = 1; the next row, qy, is a = 0) and
  // its columns qx - 1 (b = 1) and qx (b = 0) of pixel 0; pixel j is j on.
  const int row = k * g.wstride + r * g.pitch;
  const int col1 = tc * (kPx + 1);
  const int col0 = tc + 1 < g.nc ? (tc + 1) * (kPx + 1) : 1;
  const int tap0 = (e * 4 + f) * kCt;  // tap (e, f): a = b = 0

  stage_slice(a, g, smem, 0, src_x, src_s, dst);
  copy_commit();
  for (int s = 0; s < g.slices; ++s) {
    float* buf = smem + (s & 1) * g.stage;
    if (s + 1 < g.slices) {
      stage_slice(a, g, smem + ((s + 1) & 1) * g.stage, (s + 1) * kCs, src_x, src_s, dst);
      copy_commit();
      copy_wait<1>();
    } else {
      copy_wait<0>();
    }
    // relu on load: each thread on the elements it copied, once they
    // landed.
    float* in = buf + kWeights;
#pragma unroll
    for (int ci = 0; ci < kCs; ++ci)
#pragma unroll
      for (int m = 0; m < kSlots; ++m)
        if (dst[m] >= 0) in[ci * g.plane + dst[m]] = fmaxf(in[ci * g.plane + dst[m]], 0.0f);
    __syncthreads();
    // The slice's sums start from 0 and join the block's once the slice
    // is done: a sum over 4 Cin terms in runs of 32 stays within a few
    // ulps of the exact one (a single running sum of 512 terms does not).
    float part[kPx][kCt];
#pragma unroll
    for (int j = 0; j < kPx; ++j)
#pragma unroll
      for (int c = 0; c < kCt; ++c) part[j][c] = 0.0f;
#pragma unroll 1
    for (int ci = 0; ci < kCs; ++ci) {
      const float* top = in + ci * g.plane + row;  // input row qy - 1
      const float* bot = top + g.pitch;            // input row qy
      float t0[kPx], t1[kPx], b0[kPx], b1[kPx];
#pragma unroll
      for (int j = 0; j < kPx; ++j) {
        t0[j] = top[col0 + j];
        t1[j] = top[col1 + j];
        b0[j] = bot[col0 + j];
        b1[j] = bot[col1 + j];
      }
      const float* wc = buf + ci * kTaps * kCt + tap0;
#pragma unroll
      for (int ab = 0; ab < 4; ++ab) {
        const int ta = ab >> 1, tb = ab & 1;
        const float4* wq = reinterpret_cast<const float4*>(wc + (8 * ta + 2 * tb) * kCt);
        float wv[kCt];
#pragma unroll
        for (int q = 0; q < kCt / 4; ++q) {
          const float4 w4 = wq[q];
          wv[4 * q] = w4.x, wv[4 * q + 1] = w4.y, wv[4 * q + 2] = w4.z, wv[4 * q + 3] = w4.w;
        }
        const float* v = ta == 0 ? (tb == 0 ? b0 : b1) : (tb == 0 ? t0 : t1);
#pragma unroll
        for (int j = 0; j < kPx; ++j)
#pragma unroll
          for (int c = 0; c < kCt; ++c) part[j][c] = fmaf(v[j], wv[c], part[j][c]);
      }
    }
#pragma unroll
    for (int j = 0; j < kPx; ++j)
#pragma unroll
      for (int c = 0; c < kCt; ++c) acc[j][c] += part[j][c];
    __syncthreads();
  }

  // The epilogue: the bias where the full coordinate lies inside the
  // transposed convolution's output, then BatchNorm, or the head and the
  // sigmoid, stored once.
  const int wi = w0 + k;
  const int Y = 2 * (qyb + r) + e, y = Y - a.oy;
  if (!active || wi >= a.batch || y < 0 || y >= a.th) return;
  const bool in_y = Y >= 0 && Y < 2 * a.h + 2;
  if constexpr (kHead) {
    float hw[kCt];
#pragma unroll
    for (int c = 0; c < kCt; ++c) hw[c] = a.head_weight[c];
    const float hb = a.head_bias[0];
    float* dst_row = a.out + ((long long)wi * a.th + y) * a.tw;
#pragma unroll
    for (int j = 0; j < kPx; ++j) {
      const int X = 2 * (qxb + tc + g.nc * j) + f, x = X - a.ox;
      if (x < 0 || x >= a.tw) continue;
      const bool in = in_y && X >= 0 && X < 2 * a.w + 2;
      float z = hb;
#pragma unroll
      for (int c = 0; c < kCt; ++c) z = fmaf(in ? acc[j][c] + a.bias[c] : 0.0f, hw[c], z);
      dst_row[x] = 1.0f / (1.0f + expf(-z));
    }
  } else {
    const long long plane = (long long)a.th * a.tw;
    float* dst_px = a.out + ((long long)wi * a.cout + co0) * plane + (long long)y * a.tw;
#pragma unroll
    for (int c = 0; c < kCt; ++c) {
      const int co = co0 + c;
      const float mean = a.bn_mean[co], beta = a.bn_bias[co], bias = a.bias[co];
      const float mul = __fdiv_rn(a.bn_weight[co], __fsqrt_rn(__fadd_rn(a.bn_var[co], a.eps)));
#pragma unroll
      for (int j = 0; j < kPx; ++j) {
        const int X = 2 * (qxb + tc + g.nc * j) + f, x = X - a.ox;
        if (x < 0 || x >= a.tw) continue;
        const bool in = in_y && X >= 0 && X < 2 * a.w + 2;
        const float z = in ? acc[j][c] + bias : 0.0f;
        dst_px[c * plane + x] = fmaf(z - mean, mul, beta);
      }
    }
  }
}

int floor_div2(int v) { return v >= 0 ? v / 2 : -((1 - v) / 2); }

// (r, wb): the quad rows and windows a block, with wb * r * nc <= 32, that
// take the fewest warps over the batch; on a tie the taller band.
void pick_band(int qr, int nc, int batch, Geom& g) {
  long long best = -1;
  for (int r = 1; r <= qr && r * nc <= kLanes; ++r) {
    const int wb = kLanes / (r * nc) < batch ? kLanes / (r * nc) : batch;
    const long long warps = (long long)((batch + wb - 1) / wb) * ((qr + r - 1) / r);
    if (best < 0 || warps <= best) best = warps, g.r = r, g.wb = wb;
  }
}

template <bool kHead>
int launch(const BlobUpArgs& a, const Geom& g, cudaStream_t st) {
  const size_t smem = size_t(2) * g.stage * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        blob_up_kernel<kHead>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const dim3 grid(unsigned((a.batch + g.wb - 1) / g.wb) * g.bands * g.cbands,
                  unsigned(a.cout / kCt));
  LAUNCH(blob_up_kernel<kHead>, grid, kThreads, smem, st, a, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launch K12 on `stream` for the block described by *args (device
// pointers; the wrapper has checked shapes, dtypes, devices and the 32-bit
// offsets). The last block (head_weight set) writes probabilities. Returns
// cudaGetLastError() after the launch: nonzero when it was refused.
int cova_blob_up(const BlobUpArgs* args, void* stream) {
  const BlobUpArgs& a = *args;
  if (a.batch == 0 || a.th == 0 || a.tw == 0) return static_cast<int>(cudaGetLastError());
  Geom g{};
  g.qy0 = floor_div2(a.oy);
  g.qr = floor_div2(a.oy + a.th - 1) - g.qy0 + 1;
  g.qx0 = floor_div2(a.ox);
  // Lanes across all quad columns, split into the fewest column bands of
  // at most a warp each, of equal width.
  const int lanes = (floor_div2(a.ox + a.tw - 1) - g.qx0 + 1 + kPx - 1) / kPx;
  g.cbands = (lanes + kLanes - 1) / kLanes;
  g.nc = (lanes + g.cbands - 1) / g.cbands;
  if (a.cout % kCt != 0) return static_cast<int>(cudaErrorInvalidValue);
  pick_band(g.qr, g.nc, a.batch, g);
  g.bands = (g.qr + g.r - 1) / g.r;
  g.used = g.wb * g.r * g.nc;
  g.pitch = g.nc * (kPx + 1);
  // Lane l = tc + nc (r' + r k) reads its pixel j at (kPx + 1) l + j
  // (mod 32 banks) when a window's rows take (kPx + 1) nc r floats (mod
  // 32): kPx + 1 is odd, so the 32 lanes' loads fall in 32 banks.
  g.wstride = (g.r + 1) * g.pitch + (32 - g.pitch % 32) % 32;
  g.plane = g.wb * g.wstride;
  g.count = g.wb * (g.r + 1) * (g.nc * kPx + 1);
  g.stage = (kWeights + kCs * g.plane + 3) / 4 * 4;
  g.slices = (a.c1 + a.c2 + kCs - 1) / kCs;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return a.head_weight != nullptr ? launch<true>(a, g, st) : launch<false>(a, g, st);
}

}  // extern "C"
