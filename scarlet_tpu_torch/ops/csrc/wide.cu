// Radial monotonicity projection of boxes beyond mono.cu's register
// kernels (kernels.mono_geometry: more than 73 pixels a side), alone
// (K1/K2) or inside the morphology prox chain (K5) and the fused
// morphology update (K6), on one engine that spreads a morphology over a
// thread-block cluster (Hopper, sm_90a).
//
// Replaces, for those boxes, the TPU kernels of
// scarlet_tpu/ops/pallas_kernels.py, which take any box that fits in VMEM:
//   `_mono_kernel` (`batched_monotonic_prox`, K1; `monotonic_prox_packed`,
//   K2, through strides): mono_kernel_wide;
//   `_mono_chain_kernel` (`monotonic_prox_packed_chain`, K5):
//   chain_kernel_wide, the projection and the rest of the chain;
//   `_fused_morph_kernel` (`fused_morph_update`, K6): fused_kernel_wide,
//   the amsgrad step, the box mask, the candidate pick, the projection to
//   its exact fixed point and the chain.
// What they compute is mono.cu's kernels', pass for pass and operation
// for operation (the exit rule, the epilogue, the prologue: see there).
//
// What bounds it on this card.  A pass costs ~9 float32 operations a
// pixel and depends on the pass before, so the passes must stay on chip;
// a lone morphology of 128 x 128 pixels is ~16 k pixels a pass, work for
// many SMs but only if they can exchange their edges every pass.  The
// design:
//   - the frame (the box, transposed when it is wider than tall) is cut
//     into R bands of whole rows, one CTA each; the R CTAs of one
//     morphology are one thread-block cluster on neighbouring SMs.
//     kernels.wide_geometry picks R, a power of two up to 16: enough CTAs
//     to fill the SMs, and at least enough that a band fits one CTA (its
//     planes in shared memory and, where 16 CTAs can do that, its pixels
//     in the register slots below);
//   - each CTA keeps its band's zero-bordered cur, nxt and x0 planes, with
//     one halo row above and below, in its own shared memory, so a pass
//     reads only its own shared memory.  The only taps that cross a band
//     are those with dy = +-1: each CTA stores its first and last rows of
//     each new plane into the halo rows of the same plane of the CTAs
//     above and below (distributed shared memory, through
//     cooperative_groups' map_shared_rank), and then the cluster takes one
//     barrier.  The planes ping-pong, so no CTA writes a plane that a
//     neighbour may still read: one barrier a pass is enough;
//   - the 4-pass convergence test ORs the CTAs' __syncthreads_or flags:
//     each CTA stores its flag in every CTA before that pass's barrier, so
//     every CTA reads the same answer and exits on the same 4-pass
//     boundary as mono.cu's kernels;
//   - where a thread owns at most 12 pixels (mono.cu's map on the band: a
//     thread takes one frame column and every ny-th row; P slots), it
//     loads their taps into registers once per launch.  A box whose bands
//     are too large for that even at 16 CTAs (past 256 pixels) streams its
//     taps from L1/L2 each pass with 1024 threads (on an H100 the register
//     route took half the time of one streaming block per morphology at
//     512 morphologies of 81 pixels); a box whose bands do not fit 16
//     CTAs' shared memory (past 533 pixels) keeps its planes in a
//     device-memory workspace, where the same stores into the neighbours'
//     halo rows are global stores and the cluster barrier orders them;
//   - the chain's epilogue and K6's prologue run on the same on-chip copy,
//     so device memory is read once and written once per morphology; the
//     morphology's max is a cluster-wide reduction through distributed
//     shared memory (a max is exact in any order), and every CTA of K6
//     computes the candidate pick itself from device memory (the window
//     may straddle two bands), so all use the same table.
//
// Rounding: mono.cu's, tap for tap (__fmul_rn, __fadd_rn, no fused
// multiply-add, the plain version's association and coefficients), so the
// results equal the plain PyTorch versions bit for bit at every R; the
// same inf/NaN difference (a neighbour with weight 0 is never read).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "launch.cuh"
#include "mono.cuh"

namespace cg = cooperative_groups;

namespace {

using scarlet::block_max;
using scarlet::dir_dx;
using scarlet::dir_dy;
using scarlet::kUnroll;

constexpr int kMaxCluster = 16;      // kernels.WIDE_CLUSTERS[-1]
constexpr int kPortableCluster = 8;  // the portable cluster size

// The block size a P-slot instantiation is compiled for
// (kernels.WIDE_SLOT_THREADS; P = 0 streams its taps with
// kernels.WIDE_STREAM_THREADS).
__host__ __device__ constexpr int slot_threads(int P) {
  return P <= 4 ? 1024 : (P <= 8 ? 640 : 512);
}

// This CTA's band of one morphology (kernels.wide_geometry): frame rows
// [r0, r0 + rows), band r of R starting at r H / R.  Frame pixel (fr, c)
// lives at local halo index (fr - r0 + 1) * W2 + c + 1 of each of the
// CTA's planes, which are `plane` floats apart (room for nb + 2 rows).
struct Band {
  int H, W, W2, tr;
  int R, rank;
  int r0, rows, above;  // above: rows of the band above
  int plane;
};

__device__ __forceinline__ Band make_band(int hb, int wb, int tr, int R,
                                          int nb) {
  Band b;
  b.tr = tr;
  b.H = tr ? wb : hb;
  b.W = tr ? hb : wb;
  b.W2 = b.W + 2;
  b.R = R;
  b.rank = (int)(blockIdx.x % (unsigned)R);
  b.r0 = b.rank * b.H / R;
  b.rows = (b.rank + 1) * b.H / R - b.r0;
  b.above = b.rank > 0 ? b.r0 - (b.rank - 1) * b.H / R : 0;
  b.plane = (nb + 2) * b.W2;
  return b;
}

// box (y, x) and flat index of frame pixel (fr, c)
__device__ __forceinline__ void box_yx(const Band& b, int fr, int c, int& y,
                                       int& x) {
  y = b.tr ? c : fr;
  x = b.tr ? fr : c;
}
__device__ __forceinline__ int box_index(const Band& b, int fr, int c,
                                         int wb) {
  return b.tr ? c * wb + fr : fr * wb + c;
}

// The cluster barrier of a pass (a block barrier for R = 1).
__device__ __forceinline__ void band_sync(const Band& b) {
  if (b.R > 1)
    cg::this_cluster().sync();
  else
    __syncthreads();
}

// The OR over the morphology's CTAs of every thread's flag: this CTA's
// block OR goes to slot `rank` of each CTA's `slots`, then the cluster
// barrier.  Every thread of the cluster must call it.
__device__ __forceinline__ int band_any(int flag, const Band& b, int* slots) {
  const int blk = __syncthreads_or(flag);
  if (b.R == 1) return blk;
  cg::cluster_group cl = cg::this_cluster();
  if ((int)threadIdx.x < b.R)
    *cl.map_shared_rank(slots + b.rank, threadIdx.x) = blk;
  cl.sync();
  const volatile int* s = slots;
  int any = 0;
  for (int q = 0; q < b.R; ++q) any |= s[q];
  return any;
}

// The max over the morphology's CTAs of every thread's v, as band_any.
__device__ __forceinline__ float band_max(float v, const Band& b, float* red,
                                          float* slots) {
  const float blk = block_max(v, red);
  if (b.R == 1) return blk;
  cg::cluster_group cl = cg::this_cluster();
  if ((int)threadIdx.x < b.R)
    *cl.map_shared_rank(slots + b.rank, threadIdx.x) = blk;
  cl.sync();
  const volatile float* s = slots;
  float mx = -CUDART_INF_F;
  for (int q = 0; q < b.R; ++q) mx = fmaxf(mx, s[q]);
  return mx;
}

// Where this CTA's new rows land: the two x planes of the CTA above (its
// bottom halo row) and below (its top halo row), in the cluster's shared
// memory or in the workspace (planes 3 * plane floats per CTA).  A value
// at local halo index h of this CTA's first row lands at h + up_off above,
// of its last row at h + dn_off below.
struct Links {
  float* up[2];
  float* dn[2];
  int up_off, dn_off;
};

__device__ __forceinline__ Links make_links(const Band& b, float* base,
                                            bool work) {
  Links l;
  l.up_off = b.above * b.W2;
  l.dn_off = -b.rows * b.W2;
  for (int s = 0; s < 2; ++s) {
    float* mine = base + s * b.plane;
    l.up[s] = nullptr;
    l.dn[s] = nullptr;
    if (b.rank > 0)
      l.up[s] = work ? mine - 3 * b.plane
                     : cg::this_cluster().map_shared_rank(mine, b.rank - 1);
    if (b.rank < b.R - 1)
      l.dn[s] = work ? mine + 3 * b.plane
                     : cg::this_cluster().map_shared_rank(mine, b.rank + 1);
  }
  return l;
}

// Zero both x planes, then fill cur with value(fr, c, own) for the band's
// rows and its halo rows (those inside the frame) and x0 for its own rows;
// ends with the cluster barrier, after which neighbours may store into
// this CTA's planes.  Every thread of the cluster must call it.
template <class F>
__device__ __forceinline__ void load_band(const Band& b, float* base,
                                          F value) {
  for (int i = threadIdx.x; i < 2 * b.plane; i += blockDim.x) base[i] = 0.0f;
  __syncthreads();
  float* cur = base;
  float* x0s = base + 2 * b.plane;
  const int n = (b.rows + 2) * b.W;
  for (int q = threadIdx.x; q < n; q += blockDim.x) {
    const int lr = q / b.W - 1;
    const int c = q - (lr + 1) * b.W;
    const int fr = b.r0 + lr;
    if (fr < 0 || fr >= b.H) continue;
    const bool own = lr >= 0 && lr < b.rows;
    const float v = value(fr, c, own);
    const int h = (lr + 1) * b.W2 + c + 1;
    cur[h] = v;
    if (own) x0s[h] = v;
  }
  band_sync(b);
}

// ---- register route: P slots a thread, the taps in registers ----------

// This thread's part of the band: frame column tx, rows r0 + ty + j * ny
// for j < n (those below r0 + rows).
struct Slots {
  int tx, ty, ny, n, own0, step;
};

__device__ __forceinline__ Slots make_slots(const Band& b, int ny) {
  Slots s;
  s.ny = ny;
  s.tx = threadIdx.x % b.W;
  s.ty = threadIdx.x / b.W;
  s.n = s.ty < ny && s.ty < b.rows ? (b.rows - s.ty + ny - 1) / ny : 0;
  s.own0 = (s.ty + 1) * b.W2 + s.tx + 1;
  s.step = ny * b.W2;
  return s;
}

// The selected table's taps of this thread's slots.  The halo offsets are
// 16-bit (a wide frame's row is more than 127 floats), two a word.
template <int T, int P>
struct Taps {
  static constexpr int NW = T / 2;
  float w[P][T];
  unsigned off[P][NW];
  int keep_j;   // slot of the keep pixel, or -1
  int first_j;  // slot in the band's first row, if a band lies above
  int last_j;   // slot in the band's last row, if a band lies below
};

template <int T, int P>
__device__ __forceinline__ void load_taps(Taps<T, P>& tp, const Band& b,
                                          const Slots& s,
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
    if (j < s.n) {
      const long long p =
          base + box_index(b, b.r0 + s.ty + j * s.ny, s.tx, wb);
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
          if (b.tr) {
            const int sw = dy;
            dy = dx;
            dx = sw;
          }
          const unsigned o = (unsigned)(dy * b.W2 + dx) & 0xffffu;
          tp.off[j][t / 2] |= o << (16 * (t % 2));
        }
      }
    }
  }
  const int c = centers[ci];
  const int cy = c / wb, cx = c - cy * wb;
  const int kr = b.tr ? cx : cy, kc = b.tr ? cy : cx;
  const int dr = kr - b.r0 - s.ty;
  tp.keep_j = (s.n > 0 && kc == s.tx && dr >= 0 && dr % s.ny == 0)
                  ? dr / s.ny : -1;
  tp.first_j = (b.rank > 0 && s.n > 0 && s.ty == 0) ? 0 : -1;
  const int dl = b.rows - 1 - s.ty;
  tp.last_j = (b.rank < b.R - 1 && s.n > 0 && dl % s.ny == 0)
                  ? dl / s.ny : -1;
}

// Jacobi passes from x0s (cur holds a copy of it and the halo rows);
// returns the plane that holds the result.  Every thread of the cluster
// must call it.
template <int T, int P>
__device__ __forceinline__ float* slot_passes(
    const Taps<T, P>& tp, const Slots& s, const Band& b, const Links& lk,
    float* cur, float* nxt, const float* x0s, int n_iter, float scale,
    float tol, int* flags) {
  float* up_c = lk.up[0];
  float* up_n = lk.up[1];
  float* dn_c = lk.dn[0];
  float* dn_n = lk.dn[1];
  int t = 0;
  int changed = 1;
  while (changed && t < n_iter) {
    int flag = 0;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      // one add a slot per pass, as mono.cu's mono_passes
      int h = s.own0, step = s.step, n = s.n;
      asm volatile("" : "+r"(h), "+r"(step), "+r"(n));
#pragma unroll
      for (int j = 0; j < P; ++j, h += step) {
        if (j < n) {
          float ref = 0.0f;
#pragma unroll
          for (int k = 0; k < T; ++k) {
            const int o = (int)(short)(tp.off[j][k / 2] >> (16 * (k % 2)));
            ref = __fadd_rn(ref, __fmul_rn(tp.w[j][k], cur[h + o]));
          }
          if (scale != 1.0f) ref = __fmul_rn(ref, scale);
          const float a = x0s[h];
          const float v = j == tp.keep_j ? a : fminf(a, ref);
          nxt[h] = v;
          if (j == tp.first_j) up_n[h + lk.up_off] = v;
          if (j == tp.last_j) dn_n[h + lk.dn_off] = v;
          if (u == kUnroll - 1) {
            const float old = cur[h];
            flag |= tol > 0.0f ? (fabsf(v - old) > tol) : (v != old);
          }
        }
      }
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
      tmp = up_c;
      up_c = up_n;
      up_n = tmp;
      tmp = dn_c;
      dn_c = dn_n;
      dn_n = tmp;
      if (u < kUnroll - 1) band_sync(b);
    }
    changed = band_any(flag, b, flags);
    t += kUnroll;
  }
  return cur;
}

// ---- streamed route: any band, the taps read each pass -----------------

// One pass over the band's pixels q = threadIdx.x + i * blockDim.x
// (row-major in the frame): nxt from cur, each pixel's taps read from
// device memory (L1/L2); `check` adds the convergence test.  Returns the
// thread's flag.  The planes do not alias (restrict), so the compiler may
// start the next pixels' loads before this pixel's stores.
template <int T>
__device__ __forceinline__ int stream_pass(
    const float* __restrict__ cur, float* __restrict__ nxt,
    const float* __restrict__ x0s, float* __restrict__ up_n,
    float* __restrict__ dn_n, const Links& lk, const Band& b,
    const float* __restrict__ wt, const int* __restrict__ code, int keep,
    int wb, float scale, float tol, bool check) {
  const int stride = blockDim.x;
  const int npix = b.rows * b.W;
  const int sr = stride / b.W, sc = stride - sr * b.W;
  int lr = threadIdx.x / b.W, c = threadIdx.x - lr * b.W;
  int flag = 0;
#pragma unroll 4
  for (int q = threadIdx.x; q < npix; q += stride) {
    const int h = (lr + 1) * b.W2 + c + 1;
    const int p = box_index(b, b.r0 + lr, c, wb);
    const unsigned cd = (unsigned)code[p];
    const int cnt = cd & 15u;
    float w[T];
#pragma unroll
    for (int k = 0; k < T / 4; ++k) {
      const float4 v = reinterpret_cast<const float4*>(wt + (long long)p * T)[k];
      w[4 * k] = v.x;
      w[4 * k + 1] = v.y;
      w[4 * k + 2] = v.z;
      w[4 * k + 3] = v.w;
    }
    float ref = 0.0f;
#pragma unroll
    for (int k = 0; k < T; ++k) {
      if (k < cnt) {
        const int d = (cd >> (4 + 3 * k)) & 7u;
        const int o = b.tr ? dir_dx(d) * b.W2 + dir_dy(d)
                           : dir_dy(d) * b.W2 + dir_dx(d);
        ref = __fadd_rn(ref, __fmul_rn(w[k], cur[h + o]));
      }
    }
    if (scale != 1.0f) ref = __fmul_rn(ref, scale);
    const float a = x0s[h];
    const float v = p == keep ? a : fminf(a, ref);
    nxt[h] = v;
    if (lr == 0 && up_n != nullptr) up_n[h + lk.up_off] = v;
    if (lr == b.rows - 1 && dn_n != nullptr) dn_n[h + lk.dn_off] = v;
    if (check) {
      const float old = cur[h];
      flag |= tol > 0.0f ? (fabsf(v - old) > tol) : (v != old);
    }
    c += sc;
    lr += sr;
    if (c >= b.W) {
      c -= b.W;
      ++lr;
    }
  }
  return flag;
}

template <int T>
__device__ __forceinline__ float* stream_passes(
    const Band& b, const Links& lk, float* cur, float* nxt, const float* x0s,
    const float* wt, const int* code, int keep, int wb, int n_iter,
    float scale, float tol, int* flags) {
  float* up_c = lk.up[0];
  float* up_n = lk.up[1];
  float* dn_c = lk.dn[0];
  float* dn_n = lk.dn[1];
  int t = 0;
  int changed = 1;
  while (changed && t < n_iter) {
    int flag = 0;
    for (int u = 0; u < kUnroll; ++u) {
      flag |= stream_pass<T>(cur, nxt, x0s, up_n, dn_n, lk, b, wt, code, keep,
                             wb, scale, tol, u == kUnroll - 1);
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
      tmp = up_c;
      up_c = up_n;
      up_n = tmp;
      tmp = dn_c;
      dn_c = dn_n;
      dn_n = tmp;
      if (u < kUnroll - 1) band_sync(b);
    }
    changed = band_any(flag, b, flags);
    t += kUnroll;
  }
  return cur;
}

// The projection of the band loaded at `base` with table ci; returns the
// plane that holds the result.  Every thread of the cluster must call it.
template <int T, int P>
__device__ __forceinline__ float* project(
    const Band& b, float* base, bool work, const float* __restrict__ tw,
    const int* __restrict__ tcode, const int* __restrict__ centers,
    long long ci, int hb, int wb, int ny, int n_iter, float scale,
    float tol, int* flags) {
  const Links lk = make_links(b, base, work);
  float* cur = base;
  float* nxt = base + b.plane;
  const float* x0s = base + 2 * b.plane;
  if constexpr (P == 0) {
    const long long npix = (long long)hb * wb;
    return stream_passes<T>(b, lk, cur, nxt, x0s, tw + ci * npix * T,
                            tcode + ci * npix, centers[ci], wb, n_iter,
                            scale, tol, flags);
  } else {
    const Slots s = make_slots(b, ny);
    Taps<T, P> tp;
    load_taps(tp, b, s, tw, tcode, centers, ci, hb, wb);
    return slot_passes(tp, s, b, lk, cur, nxt, x0s, n_iter, scale, tol,
                       flags);
  }
}

// Threshold cut, center floor and max normalization of the band's rows of
// `res`, written to the contiguous (hb, wb) `xo`.  Every thread of the
// cluster must call it.
__device__ __forceinline__ void band_epilogue(const Band& b, float* res,
                                              float* xo, int hb, int wb,
                                              float thr, float floor,
                                              float* red, float* slots) {
  const int center = (hb / 2) * wb + wb / 2;
  const int n = b.rows * b.W;
  float lmax = -CUDART_INF_F;
  for (int q = threadIdx.x; q < n; q += blockDim.x) {
    const int lr = q / b.W, c = q - lr * b.W;
    const int h = (lr + 1) * b.W2 + c + 1;
    float v = res[h];
    v = v < thr ? 0.0f : v;
    if (box_index(b, b.r0 + lr, c, wb) == center) v = fmaxf(v, floor);
    res[h] = v;
    lmax = fmaxf(lmax, v);
  }
  const float mx = band_max(lmax, b, red, slots);
  for (int q = threadIdx.x; q < n; q += blockDim.x) {
    const int lr = q / b.W, c = q - lr * b.W;
    xo[box_index(b, b.r0 + lr, c, wb)] =
        __fdiv_rn(res[(lr + 1) * b.W2 + c + 1], mx);
  }
}

// The CTA's planes: its shared memory, or (streamed route only) its part
// of the workspace, 3 * plane floats per CTA in launch order.
template <int P>
__device__ __forceinline__ float* planes(float* smem, float* work,
                                         const Band& b) {
  if constexpr (P == 0) {
    if (work != nullptr) return work + (long long)blockIdx.x * 3 * b.plane;
  }
  return smem;
}

// K1/K2: morphologies at element strides (sb, sk, sy, sx), R CTAs each.
template <int T, int P>
__global__ void __launch_bounds__(slot_threads(P))
mono_kernel_wide(const float* __restrict__ x, float* __restrict__ out,
                 const int* __restrict__ idx, const float* __restrict__ tw,
                 const int* __restrict__ tcode,
                 const int* __restrict__ centers, int ncand, int K, int hb,
                 int wb, long long sb, long long sk, long long sy,
                 long long sx, int n_iter, float scale, float tol,
                 const float* __restrict__ tols, int ny, int tr, int R,
                 int nb, float* work) {
  extern __shared__ float smem[];
  __shared__ int flags[kMaxCluster];
  const Band b = make_band(hb, wb, tr, R, nb);
  const int bk = blockIdx.x / R;
  const long long bb = bk / K;
  const long long k = bk - bb * K;
  // an out-of-range index is clamped, never read out of bounds
  const long long ci = min(max(idx[bk], 0), ncand - 1);
  const float tb = tols != nullptr ? tols[bb] : tol;
  float* base = planes<P>(smem, work, b);
  const float* xin = x + bb * sb + k * sk;
  load_band(b, base, [&](int fr, int c, bool) {
    int y, xx;
    box_yx(b, fr, c, y, xx);
    return xin[y * sy + xx * sx];
  });
  const float* res = project<T, P>(b, base, work != nullptr, tw, tcode,
                                   centers, ci, hb, wb, ny, n_iter, scale, tb,
                                   flags);
  float* xo = out + bb * sb + k * sk;
  const int n = b.rows * b.W;
  for (int q = threadIdx.x; q < n; q += blockDim.x) {
    const int lr = q / b.W, c = q - lr * b.W;
    int y, xx;
    box_yx(b, b.r0 + lr, c, y, xx);
    xo[y * sy + xx * sx] = res[(lr + 1) * b.W2 + c + 1];
  }
}

// K5: contiguous (B*K, hb, wb) stacks, R CTAs a morphology.
template <int T, int P>
__global__ void __launch_bounds__(slot_threads(P))
chain_kernel_wide(const float* __restrict__ xorig,
                  const float* __restrict__ x, float* __restrict__ out,
                  const int* __restrict__ idx, const float* __restrict__ thr,
                  const unsigned char* __restrict__ gate,
                  const float* __restrict__ tw, const int* __restrict__ tcode,
                  const int* __restrict__ centers, int ncand, int hb, int wb,
                  int n_iter, float scale, float floor, float tol, int ny,
                  int tr, int R, int nb, float* work) {
  extern __shared__ float smem[];
  __shared__ float red[33];
  __shared__ int flags[kMaxCluster];
  __shared__ float maxes[kMaxCluster];
  const Band b = make_band(hb, wb, tr, R, nb);
  const long long bk = blockIdx.x / R;
  const long long npix = (long long)hb * wb;
  float* xo = out + bk * npix;
  if (!gate[bk]) {  // uniform over the cluster: no CTA touches another
    const float* xg = xorig + bk * npix;
    const int n = b.rows * b.W;
    for (int q = threadIdx.x; q < n; q += blockDim.x) {
      const int lr = q / b.W;
      const int p = box_index(b, b.r0 + lr, q - lr * b.W, wb);
      xo[p] = xg[p];
    }
    return;
  }
  const long long ci = min(max(idx[bk], 0), ncand - 1);
  float* base = planes<P>(smem, work, b);
  const float* xin = x + bk * npix;
  load_band(b, base, [&](int fr, int c, bool) {
    return xin[box_index(b, fr, c, wb)];
  });
  float* res = project<T, P>(b, base, work != nullptr, tw, tcode, centers,
                             ci, hb, wb, ny, n_iter, scale, tol, flags);
  band_epilogue(b, res, xo, hb, wb, thr[bk], floor, red, maxes);
}

// K6: contiguous (B*K, hb, wb) stacks, R CTAs a morphology.
template <int T, int P>
__global__ void __launch_bounds__(slot_threads(P))
fused_kernel_wide(const float* __restrict__ x, const float* __restrict__ g_,
                  const float* __restrict__ m, const float* __restrict__ v,
                  const float* __restrict__ vh, const float* __restrict__ bm,
                  const float* __restrict__ thr,
                  const unsigned char* __restrict__ gate,
                  const float* __restrict__ ds, const float* __restrict__ tw,
                  const int* __restrict__ tcode,
                  const int* __restrict__ centers, int ncand, int K, int hb,
                  int wb, int n_iter, float scale, int r, float c1, float b1,
                  float c2, float b2, float eps, float floor,
                  float* __restrict__ xo, float* __restrict__ mo,
                  float* __restrict__ vo, float* __restrict__ vho, int ny,
                  int tr, int R, int nb, float* work) {
  extern __shared__ float smem[];
  __shared__ float red[33];
  __shared__ int flags[kMaxCluster];
  __shared__ float maxes[kMaxCluster];
  __shared__ int pick;
  const Band b = make_band(hb, wb, tr, R, nb);
  const long long bk = blockIdx.x / R;
  const long long off = bk * (long long)hb * wb;

  if (!gate[bk]) {  // uniform over the cluster: every plane keeps its input
    const int n = b.rows * b.W;
    for (int q = threadIdx.x; q < n; q += blockDim.x) {
      const int lr = q / b.W;
      const long long p = off + box_index(b, b.r0 + lr, q - lr * b.W, wb);
      xo[p] = x[p];
      mo[p] = m[p];
      vo[p] = v[p];
      vho[p] = vh[p];
    }
    return;
  }
  // amsgrad moments and the step (optim.phi_psi / adaprox_step) at flat
  // pixel p; the moments are written for the band's own rows
  const float step = ds[bk / K];
  auto x1_at = [&](long long p, bool own) {
    const float gp = g_[p];
    const float m2 = __fadd_rn(__fmul_rn(c1, gp), __fmul_rn(b1, m[p]));
    const float v2 = __fadd_rn(__fmul_rn(c2, __fmul_rn(gp, gp)),
                               __fmul_rn(b2, v[p]));
    const float vh2 = fmaxf(vh[p], v2);
    if (own) {
      mo[p] = m2;
      vo[p] = v2;
      vho[p] = vh2;
    }
    const float psi = __fadd_rn(__fsqrt_rn(vh2), eps);
    float x1 = __fsub_rn(x[p], __fdiv_rn(__fmul_rn(step, m2), psi));
    if (bm != nullptr) x1 = __fmul_rn(x1, bm[p]);
    return x1;
  };
  float* base = planes<P>(smem, work, b);
  load_band(b, base, [&](int fr, int c, bool own) {
    return x1_at(off + box_index(b, fr, c, wb), own);
  });
  // candidate center: the first maximum of the window, row-major, from
  // device memory (the window may straddle bands)
  if (threadIdx.x == 0) {
    const int cy = hb / 2 - r;
    const int cx = wb / 2 - r;
    const int n = 2 * r + 1;
    float best = x1_at(off + cy * wb + cx, false);
    int ci = 0;
    for (int t = 1; t < n * n; ++t) {
      const float val = x1_at(off + (cy + t / n) * wb + cx + t % n, false);
      if (val > best) {
        best = val;
        ci = t;
      }
    }
    pick = min(ci, ncand - 1);
  }
  __syncthreads();
  float* res = project<T, P>(b, base, work != nullptr, tw, tcode, centers,
                             pick, hb, wb, ny, n_iter, scale, 0.0f, flags);
  band_epilogue(b, res, xo + off, hb, wb, thr[bk], floor, red, maxes);
}

// Launches `kernel` on grid blocks in clusters of R: the shared-memory
// allowance above 48 KB and, past the portable 8, the non-portable
// cluster size, each granted once per device and instantiation (the
// caller's `granted` and `wide`).  A refused launch returns its error.
template <typename... KArgs, typename... Args>
int cluster_launch(void (*kernel)(KArgs...), int* granted, int* wide,
                   int grid, int threads, int smem, int R, void* stream,
                   Args... args) {
  int err = scarlet::grant_smem(kernel, smem, granted);
  if (err != 0) return err;
  if (R > kPortableCluster) {
    int dev = 0;
    err = (int)cudaGetDevice(&dev);
    if (err != 0) return err;
    if (dev >= scarlet::kMaxDevices || !wide[dev]) {
      err = (int)cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != 0) return err;
      if (dev < scarlet::kMaxDevices) wide[dev] = 1;
    }
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = R;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = (int)cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != 0) return err;
  return (int)cudaGetLastError();
}

// The geometry of one launch (kernels.wide_geometry).
struct Geo {
  int ny, tr, R, rows, threads, smem;
};

template <int T, int P>
struct WideMono {
  static int run(const Geo& g, int grid, void* stream, const float* x,
                 float* out, const int* idx, const float* tw,
                 const int* tcode, const int* centers, int ncand, int K,
                 int hb, int wb, long long sb, long long sk, long long sy,
                 long long sx, int n_iter, float scale, float tol,
                 const float* tols, float* work) {
    static int granted[scarlet::kMaxDevices] = {};
    static int wide[scarlet::kMaxDevices] = {};
    return cluster_launch(mono_kernel_wide<T, P>, granted, wide, grid,
                          g.threads, g.smem, g.R, stream, x, out, idx, tw,
                          tcode, centers, ncand, K, hb, wb, sb, sk, sy, sx,
                          n_iter, scale, tol, tols, g.ny, g.tr, g.R, g.rows,
                          work);
  }
};

template <int T, int P>
struct WideChain {
  static int run(const Geo& g, int grid, void* stream, const float* xorig,
                 const float* x, float* out, const int* idx,
                 const float* thr, const unsigned char* gate,
                 const float* tw, const int* tcode, const int* centers,
                 int ncand, int hb, int wb, int n_iter, float scale,
                 float floor, float tol, float* work) {
    static int granted[scarlet::kMaxDevices] = {};
    static int wide[scarlet::kMaxDevices] = {};
    return cluster_launch(chain_kernel_wide<T, P>, granted, wide, grid,
                          g.threads, g.smem, g.R, stream, xorig, x, out, idx,
                          thr, gate, tw, tcode, centers, ncand, hb, wb, n_iter,
                          scale, floor, tol, g.ny, g.tr, g.R, g.rows, work);
  }
};

template <int T, int P>
struct WideFused {
  static int run(const Geo& g, int grid, void* stream, const float* x,
                 const float* gr, const float* m, const float* v,
                 const float* vh, const float* bm, const float* thr,
                 const unsigned char* gate, const float* ds, const float* tw,
                 const int* tcode, const int* centers, int ncand, int K,
                 int hb, int wb, int n_iter, float scale, int r, float c1,
                 float b1, float c2, float b2, float eps, float floor,
                 float* xo, float* mo, float* vo, float* vho, float* work) {
    static int granted[scarlet::kMaxDevices] = {};
    static int wide[scarlet::kMaxDevices] = {};
    return cluster_launch(fused_kernel_wide<T, P>, granted, wide, grid,
                          g.threads, g.smem, g.R, stream, x, gr, m, v, vh, bm,
                          thr, gate, ds, tw, tcode, centers, ncand, K, hb, wb,
                          n_iter, scale, r, c1, b1, c2, b2, eps, floor, xo, mo,
                          vo, vho, g.ny, g.tr, g.R, g.rows, work);
  }
};

// What the compiler made of one instantiation (scarlet::kernel_info) and
// out[3], the clusters of R that can be resident at once
// (cudaOccupancyMaxActiveClusters).
template <int T, int P>
struct WideInfo {
  template <typename Kernel>
  static int info(Kernel kernel, int R, int threads, int smem, int* out) {
    int err = scarlet::kernel_info(kernel, threads, smem, out);
    if (err != 0) return err;
    if (R > kPortableCluster) {
      err = (int)cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != 0) return err;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(R);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = R;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return (int)cudaOccupancyMaxActiveClusters(&out[3], (void*)kernel, &cfg);
  }
  static int run(int which, int R, int threads, int smem, int* out) {
    if (which == 0) return info(mono_kernel_wide<T, P>, R, threads, smem, out);
    if (which == 1)
      return info(chain_kernel_wide<T, P>, R, threads, smem, out);
    return info(fused_kernel_wide<T, P>, R, threads, smem, out);
  }
};

// The (T, P) instantiations the wrappers choose from (kernels.WIDE_SLOTS,
// and P = 0 for the streamed route).
template <template <int, int> class F, typename... A>
int dispatch(int T, int P, A... a) {
  if (T == 4) {
    switch (P) {
      case 0: return F<4, 0>::run(a...);
      case 1: return F<4, 1>::run(a...);
      case 2: return F<4, 2>::run(a...);
      case 4: return F<4, 4>::run(a...);
      case 8: return F<4, 8>::run(a...);
      case 12: return F<4, 12>::run(a...);
    }
  } else if (T == 8) {
    switch (P) {
      case 0: return F<8, 0>::run(a...);
      case 1: return F<8, 1>::run(a...);
      case 2: return F<8, 2>::run(a...);
      case 4: return F<8, 4>::run(a...);
      case 8: return F<8, 8>::run(a...);
      case 12: return F<8, 12>::run(a...);
    }
  }
  return (int)cudaErrorInvalidValue;
}

// a geometry the kernels cannot take
bool bad_geometry(int P, int R, int threads, const float* work) {
  return R < 1 || R > kMaxCluster || (P != 0 && work != nullptr) ||
         threads > (P == 0 ? 1024 : slot_threads(P)) || threads < 32;
}

}  // namespace

// The geometry that ends every entry point (kernels.wide_geometry): T
// (taps per pixel), P (slots; 0 streams the taps), ny, tr, R (CTAs per
// morphology, one cluster), rows (of the largest band), threads, smem
// (dynamic shared bytes per CTA), then `work`: null, or (streamed route
// only) B*K*R*3*(rows+2)*(W+2) floats of device memory
// (kernels.mono_wide_workspace), and the stream.
//
// x, out: B*K morphologies at element strides (sb, sk, sy, sx); idx, the
// tables, tol and tols as scarlet_mono_prox's (mono.cu).
extern "C" int scarlet_wide_prox(
    const float* x, float* out, const int* idx, const float* tw,
    const int* tcode, const int* centers, int ncand, int B, int K, int hb,
    int wb, long long sb, long long sk, long long sy, long long sx,
    int n_iter, float scale, float tol, const float* tols, int T, int P,
    int ny, int tr, int R, int rows, int threads, int smem, float* work,
    void* stream) {
  if (bad_geometry(P, R, threads, work)) return (int)cudaErrorInvalidValue;
  const Geo g = {ny, tr, R, rows, threads, smem};
  return dispatch<WideMono>(T, P, g, B * K * R, stream, x, out, idx, tw,
                            tcode, centers, ncand, K, hb, wb, sb, sk, sy, sx,
                            n_iter, scale, tol, tols, work);
}

// xorig, x, out: (N, hb, wb) contiguous; idx, thr, gate and the tables as
// scarlet_prox_chain's (mono.cu).
extern "C" int scarlet_wide_chain(
    const float* xorig, const float* x, float* out, const int* idx,
    const float* thr, const unsigned char* gate, const float* tw,
    const int* tcode, const int* centers, int ncand, int N, int hb, int wb,
    int n_iter, float scale, float floor, float tol, int T, int P, int ny,
    int tr, int R, int rows, int threads, int smem, float* work,
    void* stream) {
  if (bad_geometry(P, R, threads, work)) return (int)cudaErrorInvalidValue;
  const Geo g = {ny, tr, R, rows, threads, smem};
  return dispatch<WideChain>(T, P, g, N * R, stream, xorig, x, out, idx, thr,
                             gate, tw, tcode, centers, ncand, hb, wb, n_iter,
                             scale, floor, tol, work);
}

// Arguments as scarlet_fused_morph's (mono.cu), then the geometry.
extern "C" int scarlet_wide_fused(
    const float* x, const float* g, const float* m, const float* v,
    const float* vh, const float* bm, const float* thr,
    const unsigned char* gate, const float* ds, const float* tw,
    const int* tcode, const int* centers, int ncand, int B, int K, int hb,
    int wb, int n_iter, float scale, int r, float c1, float b1, float c2,
    float b2, float eps, float floor, float* xo, float* mo, float* vo,
    float* vho, int T, int P, int ny, int tr, int R, int rows, int threads,
    int smem, float* work, void* stream) {
  if (bad_geometry(P, R, threads, work)) return (int)cudaErrorInvalidValue;
  const Geo geo = {ny, tr, R, rows, threads, smem};
  return dispatch<WideFused>(T, P, geo, B * K * R, stream, x, g, m, v, vh,
                             bm, thr, gate, ds, tw, tcode, centers, ncand, K,
                             hb, wb, n_iter, scale, r, c1, b1, c2, b2, eps,
                             floor, xo, mo, vo, vho, work);
}

// which: 0 mono_kernel_wide, 1 chain_kernel_wide, 2 fused_kernel_wide, at
// (T, P); out[4]: registers per thread, local (spill) bytes per thread,
// blocks resident per SM at `threads` and `smem`, clusters of R resident
// at once.
extern "C" int scarlet_wide_kernel_info(int which, int T, int P, int R,
                                        int threads, int smem, int* out) {
  return dispatch<WideInfo>(T, P, which, R, threads, smem, out);
}
