// K10 h264_deblock: the loop filter (8.7) of one picture, in place, one
// launch a picture, after K8 and K9; the filtered picture then serves as
// a reference.
//
// Replaces: the JAX package has no device kernel for this; its pixels
// come from libavcodec's software decoder (cova_tpu/csrc/pixdec.cc), the
// role NVDEC plays in the reference. Plain version:
// cova_tpu_torch/ops/h264/deblock.py (deblock).
//
// Design: the spec filters macroblocks in raster order, each its vertical
// edges (V), then its horizontal ones (H). Macroblock (x, y) writes only
// its own samples and its left and top neighbours'; only H reads the row
// above, rows 12-15 of (x, y - 1), which (x + 1, y - 1)'s V changes last.
// A block takes a macroblock row from a global ticket and waits only on
// the row above, which a running block holds, so it cannot deadlock.
// Before any wait, all its threads work out the bS (8.7.2.1) of every
// 4-sample segment of the row's edges, with reference pictures compared
// by identity (their pool slots), and each edge's indexA and indexB, into
// shared memory. Then warp 0 walks the row's luma and warp 1 its chroma,
// left to right, each over a ring of four macroblock columns in shared
// memory: the left strip is there from the previous step, the
// macroblock's own samples were fetched during that step (no other
// macroblock writes them before it runs), and the top strip is fetched
// before H once the row above's counter reaches x + 2. Lanes 0-15 filter
// a line each (16 luma; 8 Cb and 8 Cr): across the vertical edges a line
// is a row, across the horizontal ones a column. After V(x) a step has
// written back all of macroblock x - 1, and warp 2 publishes x + 1
// (release) while the others go on; mb_w + 1 ends the row. A direction
// with no edge of bS > 0 is skipped, and so is the write-back of samples
// no filtered edge touched; a macroblock whose top edge is not filtered
// reads nothing of the row above and does not wait for it. Bound: the
// chain of macroblock steps where every top edge is filtered, each row
// one step behind the row above (124 at 720p, 44 of them handoffs
// between rows), not bytes.

#include "h264_common.cuh"

namespace {

constexpr int kThreads = 512;
// Named barriers of the walk (0 is __syncthreads): the filter warps'
// arrival at a publication and the publisher's acknowledgement, each
// alternating by step, for 96 threads (warps 0-2).
constexpr int kBarPub = 1, kBarAck = 3, kWalkThreads = 96;
// The rings: luma rows 0-3 hold the top strip, rows 4-19 the macroblock
// row's 16; 64 columns (four macroblocks) in 68 bytes a row, so that the
// 16 lanes that each read a row fall into distinct banks. Chroma: rows
// 0-1 the strip, 2-9 the row's 8; 32 columns in 36 bytes.
constexpr int kLStride = 68, kCStride = 36;
// Shared bytes a macroblock of the row: bS [direction][edge][segment],
// then indexA, indexB [left, top, inner edges][Y, Cb, Cr].
constexpr int kBsBytes = 32, kIxBytes = 18;

__device__ __forceinline__ uint32_t& word(uint8_t* p) {
  return *reinterpret_cast<uint32_t*>(p);
}
__device__ __forceinline__ uint16_t& half(uint8_t* p) {
  return *reinterpret_cast<uint16_t*>(p);
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(kWalkThreads) : "memory");
}
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(kWalkThreads) : "memory");
}

__device__ __forceinline__ bool far4(int ax, int ay, int bx, int by) {
  return abs(ax - bx) >= 4 || abs(ay - by) >= 4;
}

// bS of the edge between 4x4 cells cp (macroblock mp) and cq (mq).
__device__ int bs_of(const RecArgs& a, int mp, int cp, int mq, int cq, bool mb_edge) {
  const int fp = a.mb[mp * 8], fq = a.mb[mq * 8];
  if ((fp | fq) & kIntra) return mb_edge ? 4 : 3;
  if (((a.mb[mp * 8 + 7] >> cp) & 1) | ((a.mb[mq * 8 + 7] >> cq) & 1)) return 2;
  const int* P = a.cell + (mp * 16 + cp) * 6;
  const int* Q = a.cell + (mq * 16 + cq) * 6;
  const long long* sp = a.slot_of + a.mb[mp * 8 + 1] * 64;
  const long long* sq = a.slot_of + a.mb[mq * 8 + 1] * 64;
  long long p0 = P[0] >= 0 ? sp[P[0]] : -1, p1 = P[1] >= 0 ? sp[32 + P[1]] : -1;
  long long q0 = Q[0] >= 0 ? sq[Q[0]] : -1, q1 = Q[1] >= 0 ? sq[32 + Q[1]] : -1;
  // libavcodec's check_mv (vertical limit 4 for frame macroblocks).
  bool v = p0 != q0 || (p0 != -1 && far4(P[2], P[3], Q[2], Q[3]));
  v = v || p1 != q1 || far4(P[4], P[5], Q[4], Q[5]);
  if (!v) return 0;
  if (p0 != q1 || p1 != q0) return 1;
  return (far4(P[2], P[3], Q[4], Q[5]) || far4(P[4], P[5], Q[2], Q[3])) ? 1 : 0;
}

// Luma line filter (8.7.2.3-4) over s[0..7] = p3..p0, q0..q3.
__device__ void filter_luma(int* s, int bs, int ia, int ib) {
  int p3 = s[0], p2 = s[1], p1 = s[2], p0 = s[3], q0 = s[4], q1 = s[5], q2 = s[6],
      q3 = s[7];
  int alpha = kAlpha[ia], beta = kBeta[ib];
  if (!(abs(p0 - q0) < alpha && abs(p1 - p0) < beta && abs(q1 - q0) < beta)) return;
  bool ap = abs(p2 - p0) < beta, aq = abs(q2 - q0) < beta;
  if (bs < 4) {
    int tc0 = kTc0[ia * 3 + bs - 1], tc = tc0 + ap + aq;
    int delta = clip3(-tc, tc, (((q0 - p0) << 2) + (p1 - q1) + 4) >> 3);
    s[3] = clip255(p0 + delta);
    s[4] = clip255(q0 - delta);
    int avg = (p0 + q0 + 1) >> 1;
    if (ap) s[2] = p1 + clip3(-tc0, tc0, (p2 + avg - (p1 << 1)) >> 1);
    if (aq) s[5] = q1 + clip3(-tc0, tc0, (q2 + avg - (q1 << 1)) >> 1);
    return;
  }
  bool small = abs(p0 - q0) < ((alpha >> 2) + 2);
  if (ap && small) {
    s[3] = (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3;
    s[2] = (p2 + p1 + p0 + q0 + 2) >> 2;
    s[1] = (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3;
  } else {
    s[3] = (2 * p1 + p0 + q1 + 2) >> 2;
  }
  if (aq && small) {
    s[4] = (p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3;
    s[5] = (p0 + q0 + q1 + q2 + 2) >> 2;
    s[6] = (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3;
  } else {
    s[4] = (2 * q1 + q0 + p1 + 2) >> 2;
  }
}

// Chroma line filter over s[0..3] = p1, p0, q0, q1.
__device__ void filter_chroma(int* s, int bs, int ia, int ib) {
  int p1 = s[0], p0 = s[1], q0 = s[2], q1 = s[3];
  int alpha = kAlpha[ia], beta = kBeta[ib];
  if (!(abs(p0 - q0) < alpha && abs(p1 - p0) < beta && abs(q1 - q0) < beta)) return;
  if (bs < 4) {
    int tc = kTc0[ia * 3 + bs - 1] + 1;
    int delta = clip3(-tc, tc, (((q0 - p0) << 2) + (p1 - q1) + 4) >> 3);
    s[1] = clip255(p0 + delta);
    s[2] = clip255(q0 - delta);
  } else {
    s[1] = (2 * p1 + p0 + q1 + 2) >> 2;
    s[2] = (2 * q1 + q0 + p1 + 2) >> 2;
  }
}

// bS of segment k of edge e in direction d (0 vertical) of macroblock
// (mx, my): 0 where the edge is not filtered (picture border,
// disable_deblocking_filter_idc 1, or 2 across a slice border; the 8x8
// transform's inner edges).
__device__ int edge_bs(const RecArgs& a, int mx, int my, int d, int e, int k) {
  const int m = my * a.mb_w + mx;
  const int* r = a.mb + m * 8;
  const int sl = r[1];
  const int idc = a.slices[sl * kSliceInts + kSDeblockIdc];
  if (idc == 1) return 0;
  int pm = m;
  if (e == 0) {
    pm = d == 0 ? (mx > 0 ? m - 1 : -1) : (my > 0 ? m - a.mb_w : -1);
    if (pm < 0 || (idc == 2 && a.mb[pm * 8 + 1] != sl)) return 0;
  } else if ((r[0] & kT8) && (e & 1)) {
    return 0;
  }
  const int cq = d == 0 ? k * 4 + e : e * 4 + k;
  const int cp = d == 0 ? k * 4 + ((e + 3) & 3) : ((e + 3) & 3) * 4 + k;
  return bs_of(a, pm, cp, m, cq, e == 0);
}

// Lane 0 waits until the counter reaches `need` (acquire); every lane
// gets what it read. A wait that outlasts about ten seconds means a
// broken order: trap, so the launch fails instead of holding the card.
__device__ int wait_count(const int* count, int need, int lane) {
  int v = 0;
  if (lane == 0) {
    const long long t0 = clock64();
    for (;;) {
      asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(count) : "memory");
      if (v >= need) break;
      if (clock64() - t0 > 20000000000LL) __trap();
    }
  }
  __syncwarp();  // orders lane 0's acquire before the other lanes' reads
  return __shfl_sync(0xffffffffu, v, 0);
}

// One plane's walk along row y: luma (warp 0) or Cb and Cr (warp 1).
// Lanes 0-15 filter and fetch the macroblock's own rows; lanes 16-19
// fetch the top strip's rows. `ring` holds S + N rows of 4N columns a
// component, `stride` bytes a row.
template <bool kLuma>
__device__ void walk(const RecArgs& a, int y, const uint8_t* s_bs, const uint8_t* s_ix,
                     uint8_t* ring, int lane) {
  constexpr int N = kLuma ? 16 : 8, S = kLuma ? 4 : 2, stride = kLuma ? kLStride : kCStride;
  constexpr int ring_bytes = (N + S) * stride;
  const int mw = a.mb_w, W = a.W, Wc = W >> 1, Hc = a.H >> 1;
  uint8_t* const Yp = a.pool + a.cur * a.plane;
  // This lane's component, line, and the line of the top strip it fetches.
  const int comp = kLuma ? 0 : (lane >> 3) & 1, line = kLuma ? lane & 15 : lane & 7;
  const int pw = kLuma ? W : Wc;
  uint8_t* const plane = kLuma ? Yp : Yp + W * a.H + comp * Wc * Hc;
  const int scomp = kLuma ? 0 : (lane >> 1) & 1, sline = kLuma ? lane & 3 : lane & 1;
  uint8_t* const splane = kLuma ? Yp : Yp + W * a.H + scomp * Wc * Hc;
  uint8_t* const rc = ring + comp * ring_bytes;   // this lane's component
  uint8_t* const rs = ring + scomp * ring_bytes;  // its strip's component
  auto at = [&](uint8_t* r, int row, int col) { return r + row * stride + (col & (4 * N - 1)); };
  auto fetch = [&](const uint8_t* p) {
    if (kLuma) return __ldcg(reinterpret_cast<const uint4*>(p));
    const uint2 v = __ldcg(reinterpret_cast<const uint2*>(p));
    return make_uint4(v.x, v.y, 0, 0);
  };
  auto put = [&](uint8_t* p, uint4 v) {
    word(p) = v.x;
    word(p + 4) = v.y;
    if (kLuma) {
      word(p + 8) = v.z;
      word(p + 12) = v.w;
    }
  };
  // Macroblock x's own rows (lanes 0-15) and its top strip (lanes 16-19).
  auto fetch_tile = [&](int x) {
    return lane < 16 ? fetch(plane + (N * y + line) * pw + N * x) : make_uint4(0, 0, 0, 0);
  };
  auto put_tile = [&](int x, uint4 v) {
    if (lane < 16) put(at(rc, S + line, N * x), v);
  };
  auto fetch_strip = [&](int x) {
    return lane >= 16 && lane < 20 ? fetch(splane + (N * y - S + sline) * pw + N * x)
                                   : make_uint4(0, 0, 0, 0);
  };
  auto put_strip = [&](int x, uint4 v) {
    if (lane >= 16 && lane < 20) put(at(rs, sline, N * x), v);
  };
  // Publication x: all of macroblock x - 1 is written back (and V(x) done).
  auto publish = [&](int x) {
    if (x >= 2) bar_sync(kBarAck + (x & 1));
    bar_arrive(kBarPub + (x & 1));
  };

  // A macroblock's edges in each direction, from its bS: V, H, and H's
  // top edge (never in row 0). Where a direction has none, its filter
  // is skipped; a macroblock with no filtered top edge reads nothing of
  // the row above and need not wait for it.
  auto edges = [&](int x, int d) {
    const uint4 b = *reinterpret_cast<const uint4*>(s_bs + x * kBsBytes + 16 * d);
    return b.x | b.y | b.z | b.w;
  };
  auto top = [&](int x) { return *reinterpret_cast<const uint32_t*>(s_bs + x * kBsBytes + 16) != 0; };

  const int* above = a.done + (y > 0 ? y - 1 : 0);
  int seen = 0;         // the row above's count, as last read
  bool have = false;    // the step's top strip is in the ring
  bool dirty = false;   // the previous macroblock's samples changed
  put_tile(0, fetch_tile(0));
  __syncwarp();
  for (int x = 0; x < mw; x++) {
    const bool last = x + 1 == mw;
    const uint4 next = last ? make_uint4(0, 0, 0, 0) : fetch_tile(x + 1);
    const uint8_t* bsx = s_bs + x * kBsBytes;
    const uint8_t* ix = s_ix + x * kIxBytes;
    const bool v = edges(x, 0) != 0, h = edges(x, 1) != 0, t = top(x);
    // V: a line is a row, the left neighbour's last 4 (2) samples and
    // its own.
    if (v && lane < 16) {
      constexpr int K = kLuma ? 5 : 3;  // words from column N x - 4
      int s[4 * K];
#pragma unroll
      for (int k = 0; k < K; k++) {
        const uint32_t w = word(at(rc, S + line, N * x - 4 + 4 * k));
#pragma unroll
        for (int j = 0; j < 4; j++) s[4 * k + j] = (w >> (8 * j)) & 255;
      }
      if (kLuma) {
#pragma unroll
        for (int e = 0; e < 4; e++) {
          const int bs = bsx[e * 4 + (line >> 2)];
          const uint8_t* q = ix + (e == 0 ? 0 : 12);
          if (bs > 0) filter_luma(s + 4 * e, bs, q[0], q[1]);
        }
      } else {
#pragma unroll
        for (int c = 0; c < 2; c++) {
          const int bs = bsx[c * 8 + (line >> 1)];
          const uint8_t* q = ix + (c == 0 ? 0 : 12) + 2 + 2 * comp;
          if (bs > 0) filter_chroma(s + 2 + 4 * c, bs, q[0], q[1]);
        }
      }
#pragma unroll
      for (int k = 0; k < K; k++)
        word(at(rc, S + line, N * x - 4 + 4 * k)) =
            s[4 * k] | s[4 * k + 1] << 8 | s[4 * k + 2] << 16 | s[4 * k + 3] << 24;
    }
    __syncwarp();
    // The left neighbour is final: its last columns go back where they
    // changed, and with them all of it is.
    if (x > 0 && (dirty || v) && lane < 16) {
      uint8_t* g = plane + (N * y + line) * pw + N * x;
      if (kLuma)
        word(g - 4) = word(at(rc, S + line, N * x - 4));
      else
        half(g - 2) = half(at(rc, S + line, N * x - 2));
    }
    publish(x);
    // The top strip: (x, y - 1) is final once the row above has
    // published x + 2.
    if (t && !have) {
      if (seen < x + 2) seen = wait_count(above, x + 2, lane);
      put_strip(x, fetch_strip(x));
      __syncwarp();
    }
    have = false;
    uint4 strip = make_uint4(0, 0, 0, 0);
    if (!last && top(x + 1) && seen >= x + 3) {
      strip = fetch_strip(x + 1);
      have = true;
    }
    // H: a line is a column, the top strip's and its own.
    if (h && lane < 16) {
      const int X = N * x + line;
      int s[S + N];
#pragma unroll
      for (int k = 0; k < S + N; k++) s[k] = *at(rc, k, X);
      if (kLuma) {
#pragma unroll
        for (int e = 0; e < 4; e++) {
          const int bs = bsx[16 + e * 4 + (line >> 2)];
          const uint8_t* q = ix + (e == 0 ? 6 : 12);
          if (bs > 0) filter_luma(s + 4 * e, bs, q[0], q[1]);
        }
      } else {
#pragma unroll
        for (int c = 0; c < 2; c++) {
          const int bs = bsx[16 + c * 8 + (line >> 1)];
          const uint8_t* q = ix + (c == 0 ? 6 : 12) + 2 + 2 * comp;
          if (bs > 0) filter_chroma(s + 4 * c, bs, q[0], q[1]);
        }
      }
#pragma unroll
      for (int k = 1; k < S + N; k++) *at(rc, k, X) = (uint8_t)s[k];
    }
    __syncwarp();
    // Write back what changed and no later step of this row changes: its
    // own first 12 (6) columns, all at the last column, and the top
    // strip's rows that H may have changed (all but the first).
    dirty = v || h;
    if (kLuma) {
      if (dirty)
        for (int w = lane; w < 48; w += 32) {
          const int row = S + w / 3, col = N * x + 4 * (w % 3);
          word(plane + (N * y - S + row) * pw + col) = word(at(rc, row, col));
        }
      if (t && lane < 12) {
        const int row = 1 + lane / 4, col = N * x + 4 * (lane % 4);
        word(plane + (N * y - S + row) * pw + col) = word(at(rc, row, col));
      }
    } else {
      uint8_t* g = plane + (N * y + line) * pw + N * x;
      if (dirty) {
        if (lane < 16)
          word(g) = word(at(rc, S + line, N * x));
        else
          half(g + 4) = half(at(rc, S + line, N * x + 4));
      }
      if (t && lane >= 16 && lane < 20)
        word(splane + (N * y - 1) * pw + N * x + 4 * sline) =
            word(at(rs, S - 1, N * x + 4 * sline));
    }
    if (last && dirty && lane < 16) {
      uint8_t* g = plane + (N * y + line) * pw + N * x + N - 4;
      if (kLuma)
        word(g) = word(at(rc, S + line, N * x + N - 4));
      else
        half(g + 2) = half(at(rc, S + line, N * x + N - 2));
    }
    if (!last) {
      put_tile(x + 1, next);
      if (have) put_strip(x + 1, strip);
    }
    __syncwarp();
  }
  publish(mw);
  bar_sync(kBarAck + ((mw - 1) & 1));
  bar_sync(kBarAck + (mw & 1));
}

__global__ void __launch_bounds__(kThreads, 1) h264_deblock_kernel(RecArgs a) {
  extern __shared__ __align__(16) uint8_t s_edges[];
  __shared__ uint32_t ring_y[(4 + 16) * kLStride / 4];
  __shared__ uint32_t ring_c[2 * (2 + 8) * kCStride / 4];
  __shared__ int s_y;
  const int tid = threadIdx.x, mw = a.mb_w;
  if (tid == 0) s_y = atomicAdd(a.ticket, 1);
  __syncthreads();
  const int y = s_y;
  uint8_t* const s_bs = s_edges;
  uint8_t* const s_ix = s_edges + mw * kBsBytes;
  for (int i = tid; i < mw * kBsBytes; i += kThreads)
    s_bs[i] = edge_bs(a, i >> 5, y, (i >> 4) & 1, (i >> 2) & 3, i & 3);
  for (int i = tid; i < mw * 9; i += kThreads) {
    const int x = i / 9, kind = (i % 9) / 3, comp = i % 3;
    const int m = y * mw + x;
    const int* r = a.mb + m * 8;
    const int* slc = a.slices + r[1] * kSliceInts;
    int pm = m;
    if (kind == 0 && x > 0) pm = m - 1;
    if (kind == 1 && y > 0) pm = m - mw;
    const int qpav = (a.mb[pm * 8 + 2 + comp] + r[2 + comp] + 1) >> 1;
    s_ix[2 * i] = clip3(0, 51, qpav + slc[kSAlpha]);
    s_ix[2 * i + 1] = clip3(0, 51, qpav + slc[kSBeta]);
  }
  __syncthreads();
  const int warp = tid >> 5, lane = tid & 31;
  if (warp == 0) {
    walk<true>(a, y, s_bs, s_ix, reinterpret_cast<uint8_t*>(ring_y), lane);
  } else if (warp == 1) {
    walk<false>(a, y, s_bs, s_ix, reinterpret_cast<uint8_t*>(ring_c), lane);
  } else if (warp == 2) {
    // The publisher: the row's count, once warps 0 and 1 have arrived.
    for (int x = 0; x <= mw; x++) {
      bar_sync(kBarPub + (x & 1));
      if (lane == 0)
        asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(a.done + y), "r"(x + 1)
                     : "memory");
      bar_arrive(kBarAck + (x & 1));
    }
  }
}

}  // namespace

extern "C" int cova_h264_deblock(const RecArgs* args, void* stream) {
  if (args->mb_h == 0) return 0;
  const int smem = args->mb_w * (kBsBytes + kIxBytes);
  h264_deblock_kernel<<<args->mb_h, kThreads, smem, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
