// Radial monotonicity projection of a batch of morphologies, alone (K1/K2)
// or inside the morphology prox chain (K5) and the fused morphology
// update (K6) (Hopper, sm_90a).
//
// Replaces the TPU kernels of scarlet_tpu/ops/pallas_kernels.py:
//   `_mono_kernel`, reached through `batched_monotonic_prox` (K1) and
//   `monotonic_prox_packed` (K2): mono_kernel below.  It takes element
//   strides for (b, k, y, x), so the lane-packed (B, hb, K*wb) view is
//   read and written in place, with no copy;
//   `_mono_chain_kernel` (`monotonic_prox_packed_chain`, K5):
//   chain_kernel, the projection plus the rest of the prox chain;
//   `_fused_morph_kernel` (`fused_morph_update`, K6): fused_kernel, the
//   amsgrad moment update and step, then the candidate-center pick, the
//   projection and the chain.
//
// The projection, per morphology x0 with its candidate-center table `ci`:
//   x <- keep ? x0 : min(x0, scale * sum_d w_d * x(p + off_d))
// Jacobi passes over the 8 NEIGHBOR_OFFSETS, in blocks of 4 passes, until
// a block's last pass changes nothing (tol == 0: the exact fixed point of
// the depth-n_iter DAG) or moves no pixel by more than tol (tol > 0), or
// until n_iter passes have run.  The convergence test compares the last
// two passes of a block, as the TPU kernel does, so exits fall on the
// same 4-pass boundaries.
//
// The chain's epilogue (K5, K6), per morphology: x < thr -> 0, the center
// pixel raised to at least `floor`, division by the morphology's max, and
// the gate: a gated-off morphology keeps x_orig (K6: x, m, v and vhat
// keep their inputs).  K6's prologue: m' = (1-b1) g + b1 m,
// v' = (1-b2) g^2 + b2 v, vh' = max(vh, v'),
// x1 = (x - ds * m' / (sqrt(vh') + eps)) * box_mask, then the first
// maximum of x1 over the (2r+1)^2 center window (row-major, strict >)
// picks the table, and the projection runs to the exact fixed point.
//
// What bounds it on this card.  The least work per launch is one read and
// one write of each morphology (plus the tables), and per pass and pixel
// its nonzero taps: at most 4 of the 8 weights of the "angle" tables are
// nonzero (3.87 on average at box 59), so a pass costs ~8.7 flop per
// pixel.  At box 59 and 1920 morphologies, the fit's ~30 passes a launch
// are ~26 us of float32 issue against ~16 us of device-memory traffic:
// the bound is the arithmetic (a launch of ~4 passes, as at
// initialization, is bound by the traffic), and every pass depends on
// the one before, so the loop must stay on chip.  The cost that is not
// arithmetic is what the design cuts:
//   - the taps live in registers.  The host builds, once per table, the
//     nonzero weights of each pixel in `d` order (T = 4, or 8 for a table
//     with more) and their directions in one int (ops/kernels.py
//     `mono_taps`); each thread loads its pixels' taps once per launch
//     and turns the directions into signed byte offsets, so a tap is an
//     offset extract, one shared-memory load and a multiply and an add.
//     The keep flag is the candidate's center index, not a plane;
//   - x lives in two zero-bordered (H+2) x (W+2) ping-pong tiles and x0 in
//     a third (3 x 14.9 KB at box 59), so no load is bounds-checked;
//   - a 2-D thread map: thread i owns column i % W and rows
//     i / W + j * ny (j < P), of the box or of its transpose when the box
//     is wider than tall (W <= 73).  No division per pixel and pass;
//   - one block of 480 threads (15 warps, P = 8 slots a thread, ~100
//     registers, no spill) per SM at box 59.  Two blocks would fit the
//     shared memory, but not the registers: at the 64 registers a thread
//     that two 480-thread blocks allow, the 40 registers of a thread's
//     taps spill (104 B a thread), and the spill loads cost more than the
//     second block's latency hiding gains (on an H100, a pass took 0.30 of
//     T1's `full` pass, attrib.cu, as one uncapped block and 0.39 as two
//     blocks of 64 registers; chip_smoke.py, PERF.md).  Each pass
//     recomputes the slots' halo indices (one add each) rather than keep
//     P of them and their addresses in registers.
// The chain's epilogue (one block max reduction) and K6's prologue run on
// the same on-chip copy, so device memory is read once and written once
// per morphology (K6: six planes in, four out).
//
// Rounding: each product, sum, quotient and square root is rounded on its
// own (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn, no fused
// multiply-add), in the association of the plain PyTorch version, with
// the float32 coefficients that version multiplies by, so the results
// equal it bit for bit.  A max is exact in any order.  A zero weight
// times a finite neighbour adds +-0, which leaves the sum as it was (the
// sum starts at +0 and is never -0), so dropping the zero taps keeps the
// bits for finite morphologies.  Where a neighbour with weight 0 is inf or
// NaN the plain version's 0 * inf makes the pixel NaN and this kernel's
// stays finite, and fminf returns the number where the plain version's
// minimum returns NaN: inputs on every path of the port are finite (the
// stream sanitizes its stacks, the fit's steps are finite).
#include <cuda_runtime.h>
#include <math_constants.h>

#include "launch.cuh"

namespace {

constexpr int kUnroll = 4;       // passes per convergence test (MONO_UNROLL)
constexpr int kMaxThreads = 512;  // kernels.MONO_MAX_THREADS

// NEIGHBOR_OFFSETS[d] = (dy, dx), d = 0..7
__device__ __forceinline__ int dir_dy(int d) {
  return d < 3 ? -1 : (d < 5 ? 0 : 1);
}
__device__ __forceinline__ int dir_dx(int d) {
  return (d == 0 || d == 3 || d == 5) ? -1 : ((d == 1 || d == 6) ? 0 : 1);
}

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
// holds the result.  Every thread of the block must call it.
template <int T, int P>
__device__ float* mono_passes(const Taps<T, P>& tp, const Geom& g,
                              float* cur, float* nxt, const float* x0s,
                              int n_iter, float scale, float tol) {
  int t = 0;
  int changed = 1;
  while (changed && t < n_iter) {
    int flag = 0;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      // opaque to the compiler once per pass, so that it recomputes each
      // slot's halo index (one add) instead of holding P of them, and
      // their addresses in the two tiles, in registers across the passes
      // (128 registers a thread, and a slower pass)
      int h = g.own0, step = g.step, n = g.n;
      asm volatile("" : "+r"(h), "+r"(step), "+r"(n));
#pragma unroll
      for (int j = 0; j < P; ++j, h += step) {
        if (j < n) {
          float ref = 0.0f;
#pragma unroll
          for (int k = 0; k < T; ++k) {
            const int o = (int)(signed char)(tp.off[j][k / 4] >> (8 * (k % 4)));
            ref = __fadd_rn(ref, __fmul_rn(tp.w[j][k], cur[h + o]));
          }
          if (scale != 1.0f) ref = __fmul_rn(ref, scale);
          const float a = x0s[h];
          const float v = j == tp.keep_j ? a : fminf(a, ref);
          nxt[h] = v;
          if (u == kUnroll - 1) {
            const float old = cur[h];
            flag |= tol > 0.0f ? (fabsf(v - old) > tol) : (v != old);
          }
        }
      }
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
      if (u < kUnroll - 1) __syncthreads();
    }
    changed = __syncthreads_or(flag);
    t += kUnroll;
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

// The max over the block of each thread's v; every thread gets it.
__device__ float block_max(float v, float* red) {
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

// Threshold cut, center floor and max normalization of the result tile
// `res`, written to the contiguous (hb, wb) `xo`.  Every thread of the
// block must call it.
__device__ void chain_epilogue(const Geom& g, float* res, float* xo, int hb,
                               int wb, float thr, float floor, float* red) {
  const int center = (hb / 2) * wb + wb / 2;
  float lmax = -CUDART_INF_F;
  for (int j = 0; j < g.n; ++j) {
    int y, x;
    slot_yx(g, j, y, x);
    const int h = g.own0 + j * g.step;
    float v = res[h];
    v = v < thr ? 0.0f : v;
    if (y * wb + x == center) v = fmaxf(v, floor);
    res[h] = v;
    lmax = fmaxf(lmax, v);
  }
  const float mx = block_max(lmax, red);
  for (int j = 0; j < g.n; ++j) {
    int y, x;
    slot_yx(g, j, y, x);
    xo[y * wb + x] = __fdiv_rn(res[g.own0 + j * g.step], mx);
  }
}

template <int T, int P>
__global__ void __launch_bounds__(kMaxThreads)
mono_kernel(const float* __restrict__ x, float* __restrict__ out,
            const int* __restrict__ idx, const float* __restrict__ tw,
            const int* __restrict__ tcode, const int* __restrict__ centers,
            int ncand, int K, int hb, int wb, long long sb, long long sk,
            long long sy, long long sx, int n_iter, float scale, float tol,
            int ny, int tr) {
  extern __shared__ float smem[];
  const Geom g = geometry(hb, wb, ny, tr);
  const int plane = ((tr ? wb : hb) + 2) * g.W2;
  const int bk = blockIdx.x;
  const long long b = bk / K;
  const long long k = bk - b * K;
  // an out-of-range index is clamped, never read out of bounds
  const long long ci = min(max(idx[bk], 0), ncand - 1);

  Taps<T, P> tp;
  load_taps(tp, g, tw, tcode, centers, ci, hb, wb);
  load_x(g, smem, plane, x + b * sb + k * sk, sy, sx);
  __syncthreads();

  const float* res = mono_passes(tp, g, smem, smem + plane, smem + 2 * plane,
                                 n_iter, scale, tol);

  float* xo = out + b * sb + k * sk;
  for (int j = 0; j < g.n; ++j) {
    int y, xx;
    slot_yx(g, j, y, xx);
    xo[y * sy + xx * sx] = res[g.own0 + j * g.step];
  }
}

// K5: one block per (blend, slot) of contiguous (B*K, hb, wb) stacks.
template <int T, int P>
__global__ void __launch_bounds__(kMaxThreads)
chain_kernel(const float* __restrict__ xorig, const float* __restrict__ x,
             float* __restrict__ out, const int* __restrict__ idx,
             const float* __restrict__ thr,
             const unsigned char* __restrict__ gate,
             const float* __restrict__ tw, const int* __restrict__ tcode,
             const int* __restrict__ centers, int ncand, int hb, int wb,
             int n_iter, float scale, float floor, float tol, int ny,
             int tr) {
  extern __shared__ float smem[];
  __shared__ float red[33];
  const int npix = hb * wb;
  const long long bk = blockIdx.x;
  float* xo = out + bk * npix;

  if (!gate[bk]) {  // uniform over the block
    const float* xg = xorig + bk * npix;
    for (int p = threadIdx.x; p < npix; p += blockDim.x) xo[p] = xg[p];
    return;
  }
  const Geom g = geometry(hb, wb, ny, tr);
  const int plane = ((tr ? wb : hb) + 2) * g.W2;
  const long long ci = min(max(idx[bk], 0), ncand - 1);
  Taps<T, P> tp;
  load_taps(tp, g, tw, tcode, centers, ci, hb, wb);
  load_x(g, smem, plane, x + bk * npix, wb, 1);
  __syncthreads();
  float* res = mono_passes(tp, g, smem, smem + plane, smem + 2 * plane,
                           n_iter, scale, tol);
  chain_epilogue(g, res, xo, hb, wb, thr[bk], floor, red);
}

// K6: one block per (blend, slot) of contiguous (B*K, hb, wb) stacks.
template <int T, int P>
__global__ void __launch_bounds__(kMaxThreads)
fused_kernel(const float* __restrict__ x, const float* __restrict__ g_,
             const float* __restrict__ m, const float* __restrict__ v,
             const float* __restrict__ vh, const float* __restrict__ bm,
             const float* __restrict__ thr,
             const unsigned char* __restrict__ gate,
             const float* __restrict__ ds, const float* __restrict__ tw,
             const int* __restrict__ tcode, const int* __restrict__ centers,
             int ncand, int K, int hb, int wb, int n_iter, float scale, int r,
             float c1, float b1, float c2, float b2, float eps, float floor,
             float* __restrict__ xo, float* __restrict__ mo,
             float* __restrict__ vo, float* __restrict__ vho, int ny,
             int tr) {
  extern __shared__ float smem[];
  __shared__ float red[33];
  __shared__ int pick;
  const int npix = hb * wb;
  const long long bk = blockIdx.x;
  const long long off = bk * npix;

  if (!gate[bk]) {  // uniform over the block: every plane keeps its input
    for (int p = threadIdx.x; p < npix; p += blockDim.x) {
      xo[off + p] = x[off + p];
      mo[off + p] = m[off + p];
      vo[off + p] = v[off + p];
      vho[off + p] = vh[off + p];
    }
    return;
  }
  const Geom g = geometry(hb, wb, ny, tr);
  const int plane = ((tr ? wb : hb) + 2) * g.W2;
  float* cur = smem;
  float* x0s = smem + 2 * plane;
  for (int i = threadIdx.x; i < 2 * plane; i += blockDim.x) smem[i] = 0.0f;
  __syncthreads();

  // amsgrad moments and the step (optim.phi_psi / adaprox_step)
  const float step = ds[bk / K];
  for (int j = 0; j < g.n; ++j) {
    int y, xx;
    slot_yx(g, j, y, xx);
    const long long p = off + y * wb + xx;
    const float gp = g_[p];
    const float m2 = __fadd_rn(__fmul_rn(c1, gp), __fmul_rn(b1, m[p]));
    const float v2 = __fadd_rn(__fmul_rn(c2, __fmul_rn(gp, gp)),
                               __fmul_rn(b2, v[p]));
    const float vh2 = fmaxf(vh[p], v2);
    mo[p] = m2;
    vo[p] = v2;
    vho[p] = vh2;
    const float psi = __fadd_rn(__fsqrt_rn(vh2), eps);
    float x1 = __fsub_rn(x[p], __fdiv_rn(__fmul_rn(step, m2), psi));
    if (bm != nullptr) x1 = __fmul_rn(x1, bm[p]);
    const int h = g.own0 + j * g.step;
    x0s[h] = x1;
    cur[h] = x1;
  }
  __syncthreads();

  // candidate center: the first maximum of the window, row-major
  if (threadIdx.x == 0) {
    const int cy = hb / 2 - r;
    const int cx = wb / 2 - r;
    const int n = 2 * r + 1;
    float best = x0s[halo(g, cy, cx)];
    int ci = 0;
    for (int t = 1; t < n * n; ++t) {
      const float val = x0s[halo(g, cy + t / n, cx + t % n)];
      if (val > best) {
        best = val;
        ci = t;
      }
    }
    pick = min(ci, ncand - 1);
  }
  __syncthreads();
  Taps<T, P> tp;
  load_taps(tp, g, tw, tcode, centers, pick, hb, wb);

  float* res = mono_passes(tp, g, cur, smem + plane, x0s, n_iter, scale,
                           0.0f);
  chain_epilogue(g, res, xo + off, hb, wb, thr[bk], floor, red);
}

using scarlet::kernel_info;
using scarlet::set_smem;

int smem_bytes(int hb, int wb) { return 3 * (hb + 2) * (wb + 2) * 4; }

// The (T, P) instantiations the wrappers choose from (kernels.MONO_SLOTS);
// F<T, P>::run(args...) launches one.
template <template <int, int> class F, typename... A>
int dispatch(int T, int P, A... a) {
  if (T == 4) {
    if (P == 4) return F<4, 4>::run(a...);
    if (P == 8) return F<4, 8>::run(a...);
    if (P == 12) return F<4, 12>::run(a...);
  } else if (T == 8) {
    if (P == 4) return F<8, 4>::run(a...);
    if (P == 8) return F<8, 8>::run(a...);
    if (P == 12) return F<8, 12>::run(a...);
  }
  return (int)cudaErrorInvalidValue;
}

template <int T, int P>
struct MonoLaunch {
  static int run(const float* x, float* out, const int* idx, const float* tw,
                 const int* tcode, const int* centers, int ncand, int B,
                 int K, int hb, int wb, long long sb, long long sk,
                 long long sy, long long sx, int n_iter, float scale,
                 float tol, int ny, int tr, int threads, void* stream) {
    const int smem = smem_bytes(hb, wb);
    const int err = set_smem(mono_kernel<T, P>, smem);
    if (err != 0) return err;
    mono_kernel<T, P><<<B * K, threads, smem, (cudaStream_t)stream>>>(
        x, out, idx, tw, tcode, centers, ncand, K, hb, wb, sb, sk, sy, sx,
        n_iter, scale, tol, ny, tr);
    return (int)cudaGetLastError();
  }
};

template <int T, int P>
struct ChainLaunch {
  static int run(const float* xorig, const float* x, float* out,
                 const int* idx, const float* thr, const unsigned char* gate,
                 const float* tw, const int* tcode, const int* centers,
                 int ncand, int N, int hb, int wb, int n_iter, float scale,
                 float floor, float tol, int ny, int tr, int threads,
                 void* stream) {
    const int smem = smem_bytes(hb, wb);
    const int err = set_smem(chain_kernel<T, P>, smem);
    if (err != 0) return err;
    chain_kernel<T, P><<<N, threads, smem, (cudaStream_t)stream>>>(
        xorig, x, out, idx, thr, gate, tw, tcode, centers, ncand, hb, wb,
        n_iter, scale, floor, tol, ny, tr);
    return (int)cudaGetLastError();
  }
};

template <int T, int P>
struct FusedLaunch {
  static int run(const float* x, const float* g, const float* m,
                 const float* v, const float* vh, const float* bm,
                 const float* thr, const unsigned char* gate, const float* ds,
                 const float* tw, const int* tcode, const int* centers,
                 int ncand, int B, int K, int hb, int wb, int n_iter,
                 float scale, int r, float c1, float b1, float c2, float b2,
                 float eps, float floor, float* xo, float* mo, float* vo,
                 float* vho, int ny, int tr, int threads, void* stream) {
    const int smem = smem_bytes(hb, wb);
    const int err = set_smem(fused_kernel<T, P>, smem);
    if (err != 0) return err;
    fused_kernel<T, P><<<B * K, threads, smem, (cudaStream_t)stream>>>(
        x, g, m, v, vh, bm, thr, gate, ds, tw, tcode, centers, ncand, K, hb,
        wb, n_iter, scale, r, c1, b1, c2, b2, eps, floor, xo, mo, vo, vho, ny,
        tr);
    return (int)cudaGetLastError();
  }
};

template <int T, int P>
struct Info {
  static int run(int which, int threads, int smem, int* out) {
    if (which == 0) return kernel_info(mono_kernel<T, P>, threads, smem, out);
    if (which == 1) return kernel_info(chain_kernel<T, P>, threads, smem, out);
    return kernel_info(fused_kernel<T, P>, threads, smem, out);
  }
};

}  // namespace

// x, out: B*K morphologies at element strides (sb, sk, sy, sx); idx: (B*K,)
// int32 table index; tw (ncand, hb, wb, T), tcode (ncand, hb, wb),
// centers (ncand,): kernels.mono_taps; T, P, ny, tr, threads:
// kernels.mono_geometry.
extern "C" int scarlet_mono_prox(const float* x, float* out, const int* idx,
                                 const float* tw, const int* tcode,
                                 const int* centers, int ncand, int B, int K,
                                 int hb, int wb, long long sb, long long sk,
                                 long long sy, long long sx, int n_iter,
                                 float scale, float tol, int T, int P, int ny,
                                 int tr, int threads, void* stream) {
  return dispatch<MonoLaunch>(T, P, x, out, idx, tw, tcode, centers, ncand,
                              B, K, hb, wb, sb, sk, sy, sx, n_iter, scale,
                              tol, ny, tr, threads, stream);
}

// xorig, x, out: (N, hb, wb) contiguous, N = B*K; idx (N,) int32; thr (N,)
// float; gate (N,) bool; tables and geometry as above.
extern "C" int scarlet_prox_chain(const float* xorig, const float* x,
                                  float* out, const int* idx,
                                  const float* thr,
                                  const unsigned char* gate,
                                  const float* tw, const int* tcode,
                                  const int* centers, int ncand, int N,
                                  int hb, int wb, int n_iter, float scale,
                                  float floor, float tol, int T, int P,
                                  int ny, int tr, int threads, void* stream) {
  return dispatch<ChainLaunch>(T, P, xorig, x, out, idx, thr, gate, tw,
                               tcode, centers, ncand, N, hb, wb, n_iter,
                               scale, floor, tol, ny, tr, threads, stream);
}

// x, g, m, v, vh, bm (or null: no box mask), xo, mo, vo, vho: (B*K, hb, wb)
// contiguous; thr (B*K,) float; gate (B*K,) bool; ds (B,) float; tables
// and geometry as above.
extern "C" int scarlet_fused_morph(
    const float* x, const float* g, const float* m, const float* v,
    const float* vh, const float* bm, const float* thr,
    const unsigned char* gate, const float* ds, const float* tw,
    const int* tcode, const int* centers, int ncand, int B, int K, int hb,
    int wb, int n_iter, float scale, int r, float c1, float b1, float c2,
    float b2, float eps, float floor, float* xo, float* mo, float* vo,
    float* vho, int T, int P, int ny, int tr, int threads, void* stream) {
  return dispatch<FusedLaunch>(T, P, x, g, m, v, vh, bm, thr, gate, ds, tw,
                               tcode, centers, ncand, B, K, hb, wb, n_iter,
                               scale, r, c1, b1, c2, b2, eps, floor, xo, mo,
                               vo, vho, ny, tr, threads, stream);
}

// which: 0 mono_kernel, 1 chain_kernel, 2 fused_kernel, at (T, P); out[3]:
// registers per thread, local (spill) bytes per thread, blocks resident
// per SM at `threads` and `smem` dynamic shared bytes.
extern "C" int scarlet_mono_kernel_info(int which, int T, int P, int threads,
                                        int smem, int* out) {
  return dispatch<Info>(T, P, which, threads, smem, out);
}

extern "C" const char* scarlet_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
