// 8-connected components labelling of a batch of foreground masks, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel cova_tpu/ops/pallas/cc_kernel.py
// (`_cc_kernel`, launched by `connected_components_pallas`) and computes
// the same result: each foreground pixel gets the linear index (row * W +
// col) of its component's raster-first pixel, background gets H * W.
//
// What bounds it: a B=1024 batch of 45x80 frames is 3.7 MB of masks in and
// 14.7 MB of labels out, 5.5 us at 3.35 TB/s; the work per pixel is a
// handful of integer operations, so bytes bound it. All other traffic
// stays in shared memory. What the card spends beyond the bytes is
// instruction issue: a frame's work is small, and what a kernel can lose
// is a serial chain of block barriers whose length follows the
// components' shapes (propagation passes repeated until nothing changes),
// or shared-memory operations issued by a few lanes of a warp at a time.
//
// Design: one block of 512 threads per frame (a 1024-frame chunk fills all
// 132 SMs), a block union-find in shared memory after Playne & Hawick
// (2018) and Allegretti et al. (2019), in three phases separated by two
// barriers, whatever the geometry:
//  1. Init, a warp per row: each row's horizontal runs come from warp
//     ballots over the mask bytes, and every foreground pixel's parent is
//     its run's first pixel (the head, its own parent); background gets
//     H * W. Foreground is `parent != H * W`, so a frame needs 4 bytes of
//     shared memory a pixel and no separate mask, and the W neighbours are
//     joined without a single atomic.
//  2. Merge, a warp per strip of consecutive rows: each row is joined to
//     the one above once for every pair of runs that touch (8-connected),
//     the pairs found from the two rows' ballots: from the lower run's
//     pixel whose NE neighbour heads an upper run, from the lower head to
//     its N neighbour when that heads an upper run, and from the lower
//     head to its NW neighbour (the one upper run that can start left of
//     it). A warp queues its pairs in shared memory and unites them 32 at
//     a time, one a lane, so the unions' shared-memory operations run on
//     full warps. A union links the larger root under the smaller with a
//     compare-and-swap that holds only while it is still a root, and
//     starts again from the new roots when another thread got there
//     first, so every link points to a smaller index and each component's
//     root is its minimum index: the raster-first pixel. Finds point each
//     node they pass at its grandparent (Jaiganesh & Burtscher's ECL-CC,
//     2018), which keeps the trees shallow on large components. Parents
//     are read through volatile loads, never cached in registers.
//  3. Flatten: label[i] = find(i), stored 16 bytes at a time.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
// Pairs a warp queues before it unites 32 of them at once, one a lane.
constexpr int kQueue = 64;
// Largest shared memory one block may use on Hopper (bytes), and what is
// left of it for the frame beside the union queues.
constexpr int kMaxSmem = 232448;
constexpr int kMaxFrameSmem = kMaxSmem - kWarps * kQueue * 8;

// Root of x, halving the path on the way: each node passed is pointed at
// its grandparent. A node that is not a root only ever gets an ancestor
// written into it, so concurrent finds and unions stay valid.
__device__ __forceinline__ int find_root(volatile int32_t* parent, int x) {
  int curr = parent[x];
  if (curr == x) return x;
  int prev = x;
  int next;
  while (curr > (next = parent[curr])) {  // parent[v] <= v; equal at a root
    parent[prev] = next;
    prev = curr;
    curr = next;
  }
  return curr;
}

// Joins the trees of a and b: the larger root is linked under the smaller
// one by a compare-and-swap that succeeds only while it is still a root.
__device__ void unite(volatile int32_t* parent, int a, int b) {
  a = find_root(parent, a);
  b = find_root(parent, b);
  while (a != b) {
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicCAS(const_cast<int32_t*>(&parent[b]), b, a);
    if (old == b) return;
    // b was linked meanwhile: carry on from the roots as they are now.
    a = find_root(parent, a);
    b = find_root(parent, old);
  }
}

__global__ void __launch_bounds__(kThreads)
    cc_label_kernel(const uint8_t* __restrict__ masks,
                    int32_t* __restrict__ labels, int h, int w) {
  extern __shared__ int32_t parent[];
  __shared__ int2 queue[kWarps][kQueue];
  volatile int32_t* vp = parent;
  const int n = h * w;
  const uint8_t* m = masks + static_cast<int64_t>(blockIdx.x) * n;
  int32_t* out = labels + static_cast<int64_t>(blockIdx.x) * n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // 1. Init, a warp per row in 32-pixel chunks: a ballot of the chunk's
  // mask bytes, and each foreground pixel's run head from the highest
  // background bit below it (or the run carried in from the chunk before).
  for (int r = warp; r < h; r += kWarps) {
    const int row = r * w;
    int carry = -1;  // head of the run that reaches this chunk, or -1
    for (int c0 = 0; c0 < w; c0 += 32) {
      const int c = c0 + lane;
      const bool fg = c < w && m[row + c] != 0;
      const uint32_t bits = __ballot_sync(0xffffffffu, fg);
      const uint32_t gaps = ~bits & ((1u << lane) - 1u);
      const int start = carry >= 0 ? carry : row + c0;
      if (c < w) parent[row + c] = !fg ? n : gaps ? row + c0 + 32 - __clz(gaps) : start;
      const uint32_t gaps31 = ~bits & 0x7fffffffu;
      carry = !(bits >> 31) ? -1 : gaps31 ? row + c0 + 32 - __clz(gaps31) : start;
    }
  }
  __syncthreads();

  // 2. Merge, a warp per strip of consecutive rows: each row with the one
  // above, once for every pair of runs that touch. A warp queues its
  // pairs and unites them 32 at a time.
  const int per = (h + kWarps - 1) / kWarps;
  const int rbeg = warp * per, rend = min(h, rbeg + per);
  int2* q = queue[warp];
  int queued = 0;
  auto unite_queued = [&](int count) {
    __syncwarp();
    if (lane < count) unite(vp, q[lane].x, q[lane].y);
    const int2 rest = q[lane + 32];
    __syncwarp();
    q[lane] = rest;
    __syncwarp();
  };
  auto push = [&](bool want, int a, int b) {
    const uint32_t who = __ballot_sync(0xffffffffu, want);
    if (want) q[queued + __popc(who & ((1u << lane) - 1u))] = make_int2(a, b);
    queued += __popc(who);
    if (queued >= 32) {
      unite_queued(32);
      queued -= 32;
    }
  };
  for (int r = max(rbeg, 1); r < rend; ++r) {
    const int row = r * w, up = row - w;
    for (int c0 = 0; c0 < w; c0 += 32) {
      const int c = c0 + lane;
      const bool lf = c < w && vp[row + c] != n;
      const bool uf = c < w && vp[up + c] != n;
      const uint32_t lower = __ballot_sync(0xffffffffu, lf);
      const uint32_t upper = __ballot_sync(0xffffffffu, uf);
      if (lower == 0) continue;  // the same in every lane: nothing to unite
      const bool head = !(lane ? (lower >> (lane - 1)) & 1u : c0 > 0 && vp[row + c0 - 1] != n);
      const bool nw = lane ? (upper >> (lane - 1)) & 1u : c0 > 0 && vp[up + c0 - 1] != n;
      const bool ne = lane < 31 ? (upper >> (lane + 1)) & 1u : c0 + 32 < w && vp[up + c0 + 32] != n;
      const int above = !(lf && head) ? -1 : nw ? up + c - 1 : uf ? up + c : -1;
      push(above >= 0, row + c, above);
      push(lf && ne && !uf, row + c, up + c + 1);  // NE heads its run
    }
  }
  if (queued > 0) unite_queued(queued);
  __syncthreads();

  // 3. Flatten: no link changes any more, and the finds halve the paths
  // for each other.
  auto label = [&](int i) { return vp[i] == n ? n : find_root(vp, i); };
  if ((n & 3) == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0) {
    int4* o4 = reinterpret_cast<int4*>(out);
    for (int v = threadIdx.x; v < n / 4; v += blockDim.x) {
      const int i = 4 * v;
      o4[v] = make_int4(label(i), label(i + 1), label(i + 2), label(i + 3));
    }
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) out[i] = label(i);
  }
}

// Lets cc_label_kernel take frames above 48 KB of shared memory on the
// current device, once per device (setting it twice is harmless).
cudaError_t allow_large_frames() {
  static bool ready[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && ready[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(cc_label_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxFrameSmem);
  if (err == cudaSuccess && dev < 64) ready[dev] = true;
  return err;
}

}  // namespace

extern "C" {

// Label `b` frames of `h` x `w` u8/bool masks (contiguous, device memory)
// into int32 `labels` (same layout) on `stream`. Returns cudaGetLastError()
// after the launch: nonzero when the launch was refused.
int cova_cc_label(const void* masks, void* labels, int b, int h, int w,
                  void* stream) {
  // One int32 parent a pixel (the wrapper checks it against kMaxFrameSmem).
  const size_t smem = size_t(h) * w * 4;
  if (smem > 48 * 1024 - sizeof(int2) * kWarps * kQueue) {
    const cudaError_t err = allow_large_frames();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (b > 0 && smem > 0) {
    cc_label_kernel<<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(masks), static_cast<int32_t*>(labels), h,
        w);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
