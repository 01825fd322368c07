// Shared by the H.264 reconstruction kernels K8 (h264_inter.cu), K9
// (h264_intra.cu) and K10 (h264_deblock.cu): the picture's syntax as the
// kernels read it, the spec's tables (generated from
// cova_tpu_torch/ops/h264/tables.py into h264_tables.h), and the
// dequantisation and inverse transforms (8.5.6-8.5.15) of one macroblock
// by one block of threads. The plain versions are in
// cova_tpu_torch/ops/h264/ (transform.py, inter.py, intra.py,
// deblock.py); the kernels compute the same integers.
#pragma once

#include <cstdint>

#include "h264_tables.h"

#ifndef COVA_HOST_STUB
#include <cuda_runtime.h>
#define LAUNCH(kernel, grid, block, stream, ...) \
  kernel<<<(grid), (block), 0, (stream)>>>(__VA_ARGS__)
#endif

// Macroblock flags (RecPicture::mb[0], csrc/rec/entdec.h).
constexpr int kDecoded = 1, kIntra = 2, kI16 = 4, kPcm = 8, kT8 = 16;
// Slice record layout (csrc/rec/syntax_api.cc pack_slice).
constexpr int kSliceInts = 11 + 3 * 64 + 2 * 192 + 96 + 128;
constexpr int kSDeblockIdc = 2, kSAlpha = 3, kSBeta = 4, kSWpMode = 5,
              kSLumaLog2Wd = 6, kSChromaLog2Wd = 7, kSRefPoc = 11 + 64,
              kSRefLt = 11 + 128, kSW = 11 + 192, kSO = kSW + 192;

// Everything a launch reads: device pointers into the tensors of
// ops/h264/picture.py's Picture, the frame pool and the launch's
// macroblock list. Global (not in an anonymous namespace) so that the C
// entry points that take it are exported.
struct RecArgs {
  uint8_t* pool;          // slots x plane bytes: Y, then Cb, then Cr
  long long plane;        // bytes a slot
  int cur;                // the slot being reconstructed
  int W, H, mb_w, mb_h;   // coded luma size, macroblock grid
  const int* mb;          // n x 8
  const int* cell;        // n x 16 x 6: ref_idx L0, L1, MV L0, MV L1
  const int* ipred;       // n x 16
  const int* coef;        // n x 384 levels
  const int* pcm_row;     // n: row of `pcm`, -1 if not I_PCM
  const uint8_t* pcm;     // rows of 384 samples
  const int* slices;      // S x kSliceInts
  const long long* slot_of;  // S x 2 x 32: pool slot of each reference
  const int* ls4;         // S x 6 x 6 x 16 LevelScale4x4
  const int* ls8;         // S x 2 x 6 x 64 LevelScale8x8
  int poc;                // the picture's POC
  const int* list;        // macroblocks of this launch, in ticket order (K8, K9)
  int n_list;
  int* done;              // K9: n, 1 once a macroblock is final; K10: mb_h,
                          // the macroblocks of each row filtered so far
  int* ticket;            // next ticket (K9), next row (K10)
};

__device__ __forceinline__ int clip255(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }
__device__ __forceinline__ int clip3(int lo, int hi, int v) {
  return v < lo ? lo : v > hi ? hi : v;
}

// 8.5.12.1 / 8.5.13.1: a level scaled by its LevelScale at qP.
__device__ __forceinline__ int dequant4(int c, int ls, int qp) {
  int q6 = qp / 6;
  return qp >= 24 ? (c * ls) << (q6 - 4) : (c * ls + (1 << (3 - q6))) >> (4 - q6);
}
__device__ __forceinline__ int dequant8(int c, int ls, int qp) {
  int q6 = qp / 6;
  return qp >= 36 ? (c * ls) << (q6 - 6) : (c * ls + (1 << (5 - q6))) >> (6 - q6);
}

// One row or column of the 4x4 / 8x8 inverse transform, in place over
// elements v[0], v[s], v[2s], ... (8.5.12.2, 8.5.13.2).
__device__ __forceinline__ void idct4_1d(int* v, int s) {
  int d0 = v[0], d1 = v[s], d2 = v[2 * s], d3 = v[3 * s];
  int e0 = d0 + d2, e1 = d0 - d2, e2 = (d1 >> 1) - d3, e3 = d1 + (d3 >> 1);
  v[0] = e0 + e3;
  v[s] = e1 + e2;
  v[2 * s] = e1 - e2;
  v[3 * s] = e0 - e3;
}
__device__ __forceinline__ void idct8_1d(int* v, int s) {
  int d[8];
  for (int k = 0; k < 8; k++) d[k] = v[k * s];
  int e0 = d[0] + d[4];
  int e1 = -d[3] + d[5] - d[7] - (d[7] >> 1);
  int e2 = d[0] - d[4];
  int e3 = d[1] + d[7] - d[3] - (d[3] >> 1);
  int e4 = (d[2] >> 1) - d[6];
  int e5 = -d[1] + d[7] + d[5] + (d[5] >> 1);
  int e6 = d[2] + (d[6] >> 1);
  int e7 = d[3] + d[5] + d[1] + (d[1] >> 1);
  int f0 = e0 + e6, f1 = e1 + (e7 >> 2), f2 = e2 + e4, f3 = e3 + (e5 >> 2);
  int f4 = e2 - e4, f5 = (e3 >> 2) - e5, f6 = e0 - e6, f7 = e7 - (e1 >> 2);
  v[0] = f0 + f7;
  v[s] = f2 + f5;
  v[2 * s] = f4 + f3;
  v[3 * s] = f6 + f1;
  v[4 * s] = f6 - f1;
  v[5 * s] = f4 - f3;
  v[6 * s] = f2 - f5;
  v[7 * s] = f0 - f7;
}

// Shared memory of one macroblock's residual.
struct MbResidual {
  int d[384];    // dequantised coefficients, then transformed in place
  int dc[24];    // dcY of the 16 luma blocks, then dcC of 2 x 4
  int res[384];  // residual samples: 16x16 luma, 8x8 Cb, 8x8 Cr rasters
};

// The residual samples of macroblock `m` into s->res, by the block's
// nthreads threads (tid), with __syncthreads between the steps: the DC
// transforms, dequantisation, the row pass and the column pass.
__device__ void mb_residual(const RecArgs& a, int m, MbResidual* s, int tid,
                            int nthreads) {
  const int* r = a.mb + m * 8;
  const int flags = r[0], sl = r[1], qp = r[2];
  const bool intra = flags & kIntra, i16 = flags & kI16, t8 = flags & kT8;
  const int* c = a.coef + (long long)m * 384;
  const int* ls4 = a.ls4 + sl * (6 * 6 * 16);
  const int* ls8 = a.ls8 + sl * (2 * 6 * 64);
  if (tid == 0 && i16) {
    // Intra16x16 DC (8.5.10): Hadamard rows then columns, then scaling.
    int f[16];
    for (int k = 0; k < 16; k++) f[k] = c[k * 16];
    for (int i = 0; i < 4; i++) {
      int* v = f + 4 * i;
      int p = v[0], q = v[1], u = v[2], w = v[3];
      v[0] = p + q + u + w; v[1] = p + q - u - w;
      v[2] = p - q - u + w; v[3] = p - q + u - w;
    }
    for (int j = 0; j < 4; j++) {
      int p = f[j], q = f[4 + j], u = f[8 + j], w = f[12 + j];
      f[j] = p + q + u + w; f[4 + j] = p + q - u - w;
      f[8 + j] = p - q - u + w; f[12 + j] = p - q + u - w;
    }
    int ls0 = ls4[(0 * 6 + qp % 6) * 16], q6 = qp / 6;
    for (int k = 0; k < 16; k++)
      s->dc[k] = qp >= 36 ? (f[k] * ls0) << (q6 - 6)
                          : (f[k] * ls0 + (1 << (5 - q6))) >> (6 - q6);
  }
  if (tid == 1 || tid == 2) {
    // Chroma DC (8.5.11.2, 4:2:0).
    int comp = tid - 1, qc = r[3 + comp];
    const int* cc = c + 256 + 64 * comp;
    int c0 = cc[0], c1 = cc[16], c2 = cc[32], c3 = cc[48];
    int f[4] = {c0 + c1 + c2 + c3, c0 - c1 + c2 - c3, c0 + c1 - c2 - c3,
                c0 - c1 - c2 + c3};
    int lst = (intra ? 1 : 4) + comp;
    int ls0 = ls4[(lst * 6 + qc % 6) * 16];
    for (int k = 0; k < 4; k++) s->dc[16 + 4 * comp + k] = ((f[k] * ls0) << (qc / 6)) >> 5;
  }
  __syncthreads();
  for (int k = tid; k < 384; k += nthreads) {
    int v = c[k], d;
    if (k < 256) {
      if (t8) {
        d = dequant8(v, ls8[((intra ? 0 : 1) * 6 + qp % 6) * 64 + (k & 63)], qp);
      } else if (i16 && (k & 15) == 0) {
        d = s->dc[k >> 4];
      } else {
        d = dequant4(v, ls4[((intra ? 0 : 3) * 6 + qp % 6) * 16 + (k & 15)], qp);
      }
    } else {
      int comp = (k - 256) >> 6, qc = r[3 + comp];
      if ((k & 15) == 0) {
        d = s->dc[16 + 4 * comp + ((k >> 4) & 3)];
      } else {
        int lst = (intra ? 1 : 4) + comp;
        d = dequant4(v, ls4[(lst * 6 + qc % 6) * 16 + (k & 15)], qc);
      }
    }
    s->d[k] = d;
  }
  __syncthreads();
  // Rows: luma 16 blocks x 4 rows (4 blocks x 8 rows under the 8x8
  // transform), chroma 8 blocks x 4 rows.
  for (int k = tid; k < 96; k += nthreads) {
    if (k < 64) {
      if (t8) {
        if (k < 32) idct8_1d(s->d + (k >> 3) * 64 + (k & 7) * 8, 1);
      } else {
        idct4_1d(s->d + (k >> 2) * 16 + (k & 3) * 4, 1);
      }
    } else {
      int j = k - 64;
      idct4_1d(s->d + 256 + (j >> 2) * 16 + (j & 3) * 4, 1);
    }
  }
  __syncthreads();
  // Columns, then (x + 32) >> 6 into the sample rasters.
  for (int k = tid; k < 96; k += nthreads) {
    if (k < 64) {
      if (t8) {
        if (k < 32) {
          int b = k >> 3, col = k & 7;
          int* v = s->d + b * 64 + col;
          idct8_1d(v, 8);
          for (int i = 0; i < 8; i++)
            s->res[((b >> 1) * 8 + i) * 16 + (b & 1) * 8 + col] = (v[i * 8] + 32) >> 6;
        }
      } else {
        int b = k >> 2, col = k & 3;
        int* v = s->d + b * 16 + col;
        idct4_1d(v, 4);
        for (int i = 0; i < 4; i++)
          s->res[((b >> 2) * 4 + i) * 16 + (b & 3) * 4 + col] = (v[i * 4] + 32) >> 6;
      }
    } else {
      int j = k - 64, comp = j >> 4, b = (j >> 2) & 3, col = j & 3;
      int* v = s->d + 256 + comp * 64 + b * 16 + col;
      idct4_1d(v, 4);
      for (int i = 0; i < 4; i++)
        s->res[256 + comp * 64 + ((b >> 1) * 4 + i) * 8 + (b & 1) * 4 + col] =
            (v[i * 4] + 32) >> 6;
    }
  }
  __syncthreads();
}

// A sample of the picture in the pool, read past the L1 cache (other
// blocks of the launch write the samples a wavefront kernel reads).
__device__ __forceinline__ int load_cg(const uint8_t* p) { return __ldcg(p); }

// Wait until another block of the launch publishes *flag (acquire). A
// wait that outlasts about ten seconds means a broken order: trap, so the
// launch fails instead of holding the card.
__device__ __forceinline__ void wait_flag(const int* flag) {
  volatile const int* f = flag;
  long long t0 = clock64();
  while (*f == 0) {
    if (clock64() - t0 > 20000000000LL) __trap();
  }
}
