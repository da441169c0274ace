// Device code shared by the projection kernels: the helpers of mono.cu
// (boxes up to 73 pixels a side) and wide.cu (larger boxes), and the pass
// engine of mono.cu's register kernels (K1/K2, K5, K6), which the pass
// attribution's instruction mixes (attrib.cu) run too, so that each mix
// is K1's pass less the part it ablates.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace scarlet {

constexpr int kUnroll = 4;  // passes per convergence test (MONO_UNROLL)
constexpr int kMaxThreads = 512;  // kernels.MONO_MAX_THREADS

// NEIGHBOR_OFFSETS[d] = (dy, dx), d = 0..7
__device__ __forceinline__ int dir_dy(int d) {
  return d < 3 ? -1 : (d < 5 ? 0 : 1);
}
__device__ __forceinline__ int dir_dx(int d) {
  return (d == 0 || d == 3 || d == 5) ? -1 : ((d == 1 || d == 6) ? 0 : 1);
}

// The max over the block of each thread's v; every thread gets it.
// `red`: 33 floats of shared memory.
__device__ __forceinline__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float u = lane < nwarps ? red[lane] : -CUDART_INF_F;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      u = fmaxf(u, __shfl_xor_sync(0xffffffffu, u, off));
    if (lane == 0) red[32] = u;
  }
  __syncthreads();
  return red[32];
}

// What one pass of mono_passes computes.  kK1 is the projection's own
// pass, which exits on its convergence test.  The others are the
// instruction mixes of the pass attribution (kernels.MONO_PASS_MIXES, in
// its numbering), each run to its pass count: their test is computed as
// K1's and never exits.
enum PassMix {
  kK1 = -1,
  kFull = 0,       // K1's pass
  kNoReduce = 1,   // no test: a __syncthreads after every pass
  kUnroll8 = 2,    // the test every 8 passes
  kNoRolls = 3,    // every tap reads the thread's own pixel
  kRollsOnly = 4,  // (up + down + left + right) * 0.25: 4 halo loads
  kAlu8 = 5,       // 8 chained fused multiply-adds, acc * 0.5 + w_t
  kBf16 = 6,       // kNoRolls in bf16x2 (attrib.cu, not mono_passes)
};

// This thread's part of one morphology (kernels.mono_geometry): the frame
// is the box, or its transpose (tr); frame pixel (r, c) lives at halo
// index (r + 1) * W2 + c + 1 of each tile.
struct Geom {
  int W, W2, ny, tr;
  int tx, ty;  // frame column and first row (ty >= ny: no pixels)
  int n;       // slots in use: rows ty + j * ny < H
  int own0;    // halo index of slot 0
  int step;    // halo distance between slots, ny * W2
};

__device__ __forceinline__ Geom geometry(int hb, int wb, int ny, int tr) {
  Geom g;
  const int H = tr ? wb : hb;
  g.W = tr ? hb : wb;
  g.W2 = g.W + 2;
  g.ny = ny;
  g.tr = tr;
  g.tx = threadIdx.x % g.W;
  g.ty = threadIdx.x / g.W;
  g.n = g.ty < ny ? (H - g.ty + ny - 1) / ny : 0;
  g.own0 = (g.ty + 1) * g.W2 + g.tx + 1;
  g.step = ny * g.W2;
  return g;
}

// box (y, x) of slot j
__device__ __forceinline__ void slot_yx(const Geom& g, int j, int& y,
                                        int& x) {
  const int r = g.ty + j * g.ny;
  y = g.tr ? g.tx : r;
  x = g.tr ? r : g.tx;
}

__device__ __forceinline__ int halo(const Geom& g, int y, int x) {
  const int r = g.tr ? x : y;
  const int c = g.tr ? y : x;
  return (r + 1) * g.W2 + c + 1;
}

// The selected table's taps of this thread's pixels, in registers.
template <int T, int P>
struct Taps {
  static constexpr int NW = T / 4;
  float w[P][T];
  unsigned off[P][NW];  // signed byte halo offset of each tap, 4 per word
  int keep_j;           // slot of the keep pixel, or -1
};

template <int T, int P>
__device__ __forceinline__ void load_taps(Taps<T, P>& tp, const Geom& g,
                                          const float* __restrict__ tw,
                                          const int* __restrict__ tcode,
                                          const int* __restrict__ centers,
                                          long long ci, int hb, int wb) {
  const long long base = ci * hb * wb;
#pragma unroll
  for (int j = 0; j < P; ++j) {
#pragma unroll
    for (int t = 0; t < T; ++t) tp.w[j][t] = 0.0f;
#pragma unroll
    for (int q = 0; q < Taps<T, P>::NW; ++q) tp.off[j][q] = 0u;
    if (j < g.n) {
      int y, x;
      slot_yx(g, j, y, x);
      const long long p = base + y * wb + x;
      const float4* wp = reinterpret_cast<const float4*>(tw + p * T);
#pragma unroll
      for (int q = 0; q < T / 4; ++q) {
        const float4 v = wp[q];
        tp.w[j][4 * q] = v.x;
        tp.w[j][4 * q + 1] = v.y;
        tp.w[j][4 * q + 2] = v.z;
        tp.w[j][4 * q + 3] = v.w;
      }
      const unsigned code = (unsigned)tcode[p];
      const int cnt = code & 15u;
#pragma unroll
      for (int t = 0; t < T; ++t) {
        if (t < cnt) {  // padded taps keep weight 0 and offset 0 (self)
          const int d = (code >> (4 + 3 * t)) & 7u;
          int dy = dir_dy(d), dx = dir_dx(d);
          if (g.tr) {
            const int s = dy;
            dy = dx;
            dx = s;
          }
          const unsigned o = (unsigned)(dy * g.W2 + dx) & 0xffu;
          tp.off[j][t / 4] |= o << (8 * (t % 4));
        }
      }
    }
  }
  const int c = centers[ci];
  const int cy = c / wb, cx = c - cy * wb;
  const int kr = g.tr ? cx : cy, kc = g.tr ? cy : cx;
  const int dr = kr - g.ty;
  tp.keep_j = (g.n > 0 && kc == g.tx && dr >= 0 && dr % g.ny == 0)
                  ? dr / g.ny : -1;
}

// Jacobi passes from x0s (cur holds a copy of it); returns the tile that
// holds the result.  Every thread of the block must call it.  MIX: kK1,
// or a mix of the pass attribution, which runs n_iter passes (a whole
// number of its blocks) at scale 1 and tol 0.
template <int T, int P, int MIX = kK1>
__device__ float* mono_passes(const Taps<T, P>& tp, const Geom& g,
                              float* cur, float* nxt, const float* x0s,
                              int n_iter, float scale, float tol) {
  constexpr int U = MIX == kUnroll8 ? 8 : kUnroll;
  constexpr bool kTest = MIX != kNoReduce;
  int t = 0;
  int changed = 1;
  while (changed && t < n_iter) {
    int flag = 0;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      // opaque to the compiler once per pass, so that it recomputes each
      // slot's halo index (one add) instead of holding P of them, and
      // their addresses in the two tiles, in registers across the passes
      // (128 registers a thread, and a slower pass)
      int h = g.own0, step = g.step, n = g.n;
      asm volatile("" : "+r"(h), "+r"(step), "+r"(n));
#pragma unroll
      for (int j = 0; j < P; ++j, h += step) {
        if (j < n) {
          float v;
          if constexpr (MIX == kRollsOnly) {
            // halo distances of the box's rows and columns
            const int drow = g.tr ? 1 : g.W2, dcol = g.tr ? g.W2 : 1;
            v = __fmul_rn(__fadd_rn(__fadd_rn(__fadd_rn(cur[h - drow],
                                                        cur[h + drow]),
                                              cur[h - dcol]),
                                    cur[h + dcol]),
                          0.25f);
          } else if constexpr (MIX == kAlu8) {
            float acc = cur[h];
#pragma unroll
            for (int k = 0; k < T; ++k)
              acc = __fmaf_rn(acc, 0.5f, tp.w[j][k]);
            v = acc;
          } else {
            float ref = 0.0f;
#pragma unroll
            for (int k = 0; k < T; ++k) {
              const int o =
                  MIX == kNoRolls
                      ? 0
                      : (int)(signed char)(tp.off[j][k / 4] >> (8 * (k % 4)));
              ref = __fadd_rn(ref, __fmul_rn(tp.w[j][k], cur[h + o]));
            }
            if (scale != 1.0f) ref = __fmul_rn(ref, scale);
            const float a = x0s[h];
            v = j == tp.keep_j ? a : fminf(a, ref);
          }
          nxt[h] = v;
          if (kTest && u == U - 1) {
            const float old = cur[h];
            flag |= tol > 0.0f ? (fabsf(v - old) > tol) : (v != old);
          }
        }
      }
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
      if (!kTest || u < U - 1) __syncthreads();
    }
    if constexpr (kTest) {
      changed = __syncthreads_or(flag);
      if constexpr (MIX != kK1) {
        // the test's result is used, so it is computed as K1 computes
        // it, and the passes run on to n_iter
        asm volatile("" : : "r"(changed));
        changed = 1;
      }
    }
    t += U;
  }
  return cur;
}

// Zero both x tiles (their borders stay 0), then copy this thread's
// pixels of x (box strides sy, sx) into x0s and cur.
__device__ __forceinline__ void load_x(const Geom& g, float* smem, int plane,
                                       const float* __restrict__ xin,
                                       long long sy, long long sx) {
  for (int i = threadIdx.x; i < 2 * plane; i += blockDim.x) smem[i] = 0.0f;
  __syncthreads();
  for (int j = 0; j < g.n; ++j) {
    int y, x;
    slot_yx(g, j, y, x);
    const float v = xin[y * sy + x * sx];
    const int h = g.own0 + j * g.step;
    smem[2 * plane + h] = v;
    smem[h] = v;
  }
}

}  // namespace scarlet
