// 8-connected components labelling of a batch of foreground masks, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel cova_tpu/ops/pallas/cc_kernel.py
// (`_cc_kernel`, launched by `connected_components_pallas`) and computes
// the same result: each foreground pixel gets the linear index (row * W +
// col) of its component's raster-first pixel, background gets H * W.
//
// What bounds it: one frame is a few KB (45x80 macroblocks), and the kernel
// reads its mask and writes its labels to device memory once each. All
// other traffic stays in shared memory, so it is bound by the latency of
// the propagation passes and the block barriers between them, not by bytes
// or FLOPs.
//
// Design: one thread block per frame (a 1024-frame chunk fills all 132
// SMs several times over). The frame's mask and label grid live in shared
// memory. The block repeats passes until one changes nothing
// (__syncthreads_or), each pass being
//   1. an 8-neighbour min hop, written in place, and
//   2. two pointer jumps, lab = lab[lab].
// A label is always the index of a foreground pixel of the same component,
// at or before the pixel itself, so reading a neighbour's label while its
// owner rewrites it yields an old or a new label, both valid: the in-place
// updates only speed convergence. A pass that changes nothing leaves every
// label equal to the min over its neighbours, hence constant over each
// component and equal to the component's minimum index. Every pass moves
// each component's minimum at least one pixel further, so H * W passes
// bound the loop; the TPU kernel's 256-sweep cap does not apply.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    cc_label_kernel(const uint8_t* __restrict__ masks,
                    int32_t* __restrict__ labels, int h, int w) {
  extern __shared__ int32_t smem[];
  const int n = h * w;
  int32_t* lab = smem;                                    // n labels
  uint8_t* fg = reinterpret_cast<uint8_t*>(smem + n);     // n mask bytes
  const uint8_t* m = masks + static_cast<int64_t>(blockIdx.x) * n;
  int32_t* out = labels + static_cast<int64_t>(blockIdx.x) * n;

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const uint8_t f = m[i] != 0;
    fg[i] = f;
    lab[i] = f ? i : n;
  }
  __syncthreads();

  for (int pass = 0; pass < n; ++pass) {
    int changed = 0;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      if (!fg[i]) continue;
      const int r = i / w;
      const int c = i - r * w;
      const int32_t old = lab[i];
      int32_t best = old;
      for (int dy = -1; dy <= 1; ++dy) {
        const int rr = r + dy;
        if (rr < 0 || rr >= h) continue;
        for (int dx = -1; dx <= 1; ++dx) {
          const int cc = c + dx;
          if (cc < 0 || cc >= w) continue;
          const int32_t v = lab[rr * w + cc];  // background holds n
          best = v < best ? v : best;
        }
      }
      best = lab[best];
      best = lab[best];
      if (best < old) {
        lab[i] = best;
        changed = 1;
      }
    }
    if (!__syncthreads_or(changed)) break;
  }

  for (int i = threadIdx.x; i < n; i += blockDim.x) out[i] = lab[i];
}

}  // namespace

extern "C" {

// Label `b` frames of `h` x `w` u8/bool masks (contiguous, device memory)
// into int32 `labels` (same layout) on `stream`. Returns cudaGetLastError()
// after the launch: nonzero when the launch was refused.
int cova_cc_label(const void* masks, void* labels, int b, int h, int w,
                  void* stream) {
  // Shared memory one frame needs: int32 labels plus one mask byte a pixel
  // (the wrapper checks it against the card's per-block limit).
  const int smem = h * w * 5;
  cudaError_t err = cudaFuncSetAttribute(
      cc_label_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b > 0) {
    cc_label_kernel<<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(masks), static_cast<int32_t*>(labels), h,
        w);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
