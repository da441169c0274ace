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
// same 4-pass boundaries.  K1/K2 take the tolerance as a float or, for
// the scheduled tolerance (the TPU kernel's `dynamic_tol` mode, a traced
// SMEM scalar per call), from a device array with one value per blend:
// each block reads its blend's, so a schedule that switches needs no
// host read and no other build.
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
//     is wider than tall (W <= 73; a larger box runs wide.cu's kernels).
//     No division per pixel and pass;
//   - one block of 480 threads (15 warps, P = 8 slots a thread, ~100
//     registers, no spill) per SM at box 59.  Two blocks would fit the
//     shared memory, but not the registers: at the 64 registers a thread
//     that two 480-thread blocks allow, the 40 registers of a thread's
//     taps spill (104 B a thread), and the spill loads cost more than the
//     second block's latency hiding gains (on an H100, a pass took 0.30 of
//     the pass of a flat-loop design with the dense weight planes in
//     shared memory as one uncapped block, and 0.39 as two blocks of 64
//     registers; PERF.md).  Each pass recomputes the slots' halo indices
//     (one add each) rather than keep P of them and their addresses in
//     registers.
// The pass engine (Geom, Taps, load_taps, load_x, mono_passes) lives in
// mono.cuh, where the pass attribution's instruction mixes (attrib.cu)
// run it too.
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
#include "mono.cuh"

namespace {

using scarlet::block_max;
using scarlet::Geom;
using scarlet::geometry;
using scarlet::halo;
using scarlet::kMaxThreads;
using scarlet::load_taps;
using scarlet::load_x;
using scarlet::mono_passes;
using scarlet::slot_yx;
using scarlet::Taps;

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
            const float* __restrict__ tols, int ny, int tr) {
  extern __shared__ float smem[];
  const Geom g = geometry(hb, wb, ny, tr);
  const int plane = ((tr ? wb : hb) + 2) * g.W2;
  const int bk = blockIdx.x;
  const long long b = bk / K;
  const long long k = bk - b * K;
  // an out-of-range index is clamped, never read out of bounds
  const long long ci = min(max(idx[bk], 0), ncand - 1);
  // the blend's own exit tolerance where the caller gives one per blend
  const float tb = tols != nullptr ? tols[b] : tol;

  Taps<T, P> tp;
  load_taps(tp, g, tw, tcode, centers, ci, hb, wb);
  load_x(g, smem, plane, x + b * sb + k * sk, sy, sx);
  __syncthreads();

  const float* res = mono_passes(tp, g, smem, smem + plane, smem + 2 * plane,
                                 n_iter, scale, tb);

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
                 float tol, const float* tols, int ny, int tr, int threads,
                 void* stream) {
    const int smem = smem_bytes(hb, wb);
    const int err = set_smem(mono_kernel<T, P>, smem);
    if (err != 0) return err;
    mono_kernel<T, P><<<B * K, threads, smem, (cudaStream_t)stream>>>(
        x, out, idx, tw, tcode, centers, ncand, K, hb, wb, sb, sk, sy, sx,
        n_iter, scale, tol, tols, ny, tr);
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
// centers (ncand,): kernels.mono_taps; tols: (B,) float exit tolerance per
// blend, or null for `tol`; T, P, ny, tr, threads: kernels.mono_geometry.
extern "C" int scarlet_mono_prox(const float* x, float* out, const int* idx,
                                 const float* tw, const int* tcode,
                                 const int* centers, int ncand, int B, int K,
                                 int hb, int wb, long long sb, long long sk,
                                 long long sy, long long sx, int n_iter,
                                 float scale, float tol, const float* tols,
                                 int T, int P, int ny, int tr, int threads,
                                 void* stream) {
  return dispatch<MonoLaunch>(T, P, x, out, idx, tw, tcode, centers, ncand,
                              B, K, hb, wb, sb, sk, sy, sx, n_iter, scale,
                              tol, tols, ny, tr, threads, stream);
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
