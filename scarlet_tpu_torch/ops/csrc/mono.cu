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
// What bounds it on this card: each pass is 8 multiply-adds per pixel on
// values that the previous pass wrote, for up to n_iter (89 at box 59)
// passes.  From device memory that is ~9 reads of the stack per pass; the
// work per byte is tiny, so a pass-per-launch design would be bound by
// HBM bandwidth and launch latency, and an unfused chain or optimizer
// step adds a device-memory round trip (and a launch) per elementwise op.
// What the design does about it: one thread block owns one (blend,
// component) morphology and keeps everything on-chip for all passes --
// the selected 8-plane weight table (8*59*59*4 B = 111 KB at box 59), x0,
// the keep mask and two ping-pong x buffers, 167 KB at box 59 in dynamic
// shared memory.  The chain's epilogue (one block max reduction) and K6's
// prologue run on the same on-chip copy, so device memory is read once
// and written once per morphology (K6: six planes in, four out), the TPU
// kernels' "one HBM round trip".  The pass loop is then bound by
// shared-memory bandwidth (9 loads per pixel per pass) and by the barrier
// between passes; at box 59 one block fills an SM's shared memory, so
// occupancy is one block of 512 threads per SM.
//
// Rounding: each product, sum, quotient and square root is rounded on its
// own (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn, no fused
// multiply-add), in the association of the plain PyTorch version, with
// the float32 coefficients that version multiplies by, so the results
// equal it bit for bit.  A max is exact in any order.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kUnroll = 4;  // passes per convergence test (MONO_UNROLL)

__constant__ int kOffY[8] = {-1, -1, -1, 0, 0, 1, 1, 1};
__constant__ int kOffX[8] = {-1, 0, 1, -1, 1, -1, 0, 1};

struct Planes {  // the dynamic shared memory of one block
  float* w;      // 8 planes of npix: the selected weight table
  float* x0;
  float* keep;
  float* cur;
  float* nxt;
};

__device__ __forceinline__ Planes planes(float* smem, int npix) {
  Planes s;
  s.w = smem;
  s.x0 = s.w + 8 * npix;
  s.keep = s.x0 + npix;
  s.cur = s.keep + npix;
  s.nxt = s.cur + npix;
  return s;
}

__device__ __forceinline__ void load_table(const Planes& s,
                                           const float* wtab,
                                           const float* keeptab,
                                           long long ci, int npix) {
  const float* wsel = wtab + ci * 8 * npix;
  const float* ksel = keeptab + ci * npix;
  for (int p = threadIdx.x; p < 8 * npix; p += blockDim.x) s.w[p] = wsel[p];
  for (int p = threadIdx.x; p < npix; p += blockDim.x) s.keep[p] = ksel[p];
}

// Jacobi passes from s.x0 (s.cur holds a copy of it); returns the buffer
// that holds the result.  Every thread of the block must call it.
__device__ float* mono_passes(Planes s, int hb, int wb, int n_iter,
                              float scale, float tol) {
  const int npix = hb * wb;
  int t = 0;
  int changed = 1;
  while (changed && t < n_iter) {
    int flag = 0;
    for (int u = 0; u < kUnroll; ++u) {
      for (int p = threadIdx.x; p < npix; p += blockDim.x) {
        const int py = p / wb;
        const int px = p - py * wb;
        float ref = 0.0f;
#pragma unroll
        for (int d = 0; d < 8; ++d) {
          const int ny = py + kOffY[d];
          const int nx = px + kOffX[d];
          const float nv = (ny >= 0 && ny < hb && nx >= 0 && nx < wb)
                               ? s.cur[ny * wb + nx] : 0.0f;
          ref = __fadd_rn(ref, __fmul_rn(s.w[d * npix + p], nv));
        }
        if (scale != 1.0f) ref = __fmul_rn(ref, scale);
        const float a = s.x0[p];
        const float v = s.keep[p] > 0.5f ? a : fminf(a, ref);
        s.nxt[p] = v;
        if (u == kUnroll - 1) {
          const float old = s.cur[p];
          flag |= tol > 0.0f ? (fabsf(v - old) > tol) : (v != old);
        }
      }
      float* tmp = s.cur;
      s.cur = s.nxt;
      s.nxt = tmp;
      if (u < kUnroll - 1) __syncthreads();
    }
    changed = __syncthreads_or(flag);
    t += kUnroll;
  }
  return s.cur;
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

// Threshold cut, center floor and max normalization of `res` (on-chip),
// written to `xo`.  Every thread of the block must call it.
__device__ void chain_epilogue(float* res, float* xo, int hb, int wb,
                               float thr, float floor, float* red) {
  const int npix = hb * wb;
  const int center = (hb / 2) * wb + wb / 2;
  float lmax = -CUDART_INF_F;
  for (int p = threadIdx.x; p < npix; p += blockDim.x) {
    float v = res[p];
    v = v < thr ? 0.0f : v;
    if (p == center) v = fmaxf(v, floor);
    res[p] = v;
    lmax = fmaxf(lmax, v);
  }
  const float mx = block_max(lmax, red);
  for (int p = threadIdx.x; p < npix; p += blockDim.x)
    xo[p] = __fdiv_rn(res[p], mx);
}

__global__ void __launch_bounds__(512)
mono_kernel(const float* __restrict__ x, float* __restrict__ out,
            const int* __restrict__ idx, const float* __restrict__ wtab,
            const float* __restrict__ keeptab, int ncand, int K, int hb,
            int wb, long long sb, long long sk, long long sy, long long sx,
            int n_iter, float scale, float tol) {
  extern __shared__ float smem[];
  const int npix = hb * wb;
  const Planes s = planes(smem, npix);

  const int bk = blockIdx.x;
  const long long b = bk / K;
  const long long k = bk - b * K;
  // an out-of-range index is clamped, never read out of bounds
  const long long ci = min(max(idx[bk], 0), ncand - 1);
  const float* xin = x + b * sb + k * sk;
  float* xo = out + b * sb + k * sk;

  load_table(s, wtab, keeptab, ci, npix);
  for (int p = threadIdx.x; p < npix; p += blockDim.x) {
    const int py = p / wb;
    const int px = p - py * wb;
    const float v = xin[py * sy + px * sx];
    s.x0[p] = v;
    s.cur[p] = v;
  }
  __syncthreads();

  const float* res = mono_passes(s, hb, wb, n_iter, scale, tol);

  for (int p = threadIdx.x; p < npix; p += blockDim.x) {
    const int py = p / wb;
    const int px = p - py * wb;
    xo[py * sy + px * sx] = res[p];
  }
}

// K5: one block per (blend, slot) of contiguous (B*K, hb, wb) stacks.
__global__ void __launch_bounds__(512)
chain_kernel(const float* __restrict__ xorig, const float* __restrict__ x,
             float* __restrict__ out, const int* __restrict__ idx,
             const float* __restrict__ thr,
             const unsigned char* __restrict__ gate,
             const float* __restrict__ wtab,
             const float* __restrict__ keeptab, int ncand, int hb, int wb,
             int n_iter, float scale, float floor, float tol) {
  extern __shared__ float smem[];
  __shared__ float red[33];
  const int npix = hb * wb;
  const Planes s = planes(smem, npix);
  const long long bk = blockIdx.x;
  float* xo = out + bk * npix;

  if (!gate[bk]) {  // uniform over the block
    const float* xg = xorig + bk * npix;
    for (int p = threadIdx.x; p < npix; p += blockDim.x) xo[p] = xg[p];
    return;
  }
  const long long ci = min(max(idx[bk], 0), ncand - 1);
  const float* xin = x + bk * npix;
  load_table(s, wtab, keeptab, ci, npix);
  for (int p = threadIdx.x; p < npix; p += blockDim.x) {
    const float v = xin[p];
    s.x0[p] = v;
    s.cur[p] = v;
  }
  __syncthreads();
  float* res = mono_passes(s, hb, wb, n_iter, scale, tol);
  chain_epilogue(res, xo, hb, wb, thr[bk], floor, red);
}

// K6: one block per (blend, slot) of contiguous (B*K, hb, wb) stacks.
__global__ void __launch_bounds__(512)
fused_kernel(const float* __restrict__ x, const float* __restrict__ g,
             const float* __restrict__ m, const float* __restrict__ v,
             const float* __restrict__ vh, const float* __restrict__ bm,
             const float* __restrict__ thr,
             const unsigned char* __restrict__ gate,
             const float* __restrict__ ds, const float* __restrict__ wtab,
             const float* __restrict__ keeptab, int ncand, int K, int hb,
             int wb, int n_iter, float scale, int r, float c1, float b1,
             float c2, float b2, float eps, float floor,
             float* __restrict__ xo, float* __restrict__ mo,
             float* __restrict__ vo, float* __restrict__ vho) {
  extern __shared__ float smem[];
  __shared__ float red[33];
  __shared__ int pick;
  const int npix = hb * wb;
  const Planes s = planes(smem, npix);
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

  // amsgrad moments and the step (optim.phi_psi / adaprox_step)
  const float step = ds[bk / K];
  for (int p = threadIdx.x; p < npix; p += blockDim.x) {
    const float gp = g[off + p];
    const float m2 = __fadd_rn(__fmul_rn(c1, gp), __fmul_rn(b1, m[off + p]));
    const float v2 = __fadd_rn(__fmul_rn(c2, __fmul_rn(gp, gp)),
                               __fmul_rn(b2, v[off + p]));
    const float vh2 = fmaxf(vh[off + p], v2);
    mo[off + p] = m2;
    vo[off + p] = v2;
    vho[off + p] = vh2;
    const float psi = __fadd_rn(__fsqrt_rn(vh2), eps);
    float x1 = __fsub_rn(x[off + p], __fdiv_rn(__fmul_rn(step, m2), psi));
    if (bm != nullptr) x1 = __fmul_rn(x1, bm[off + p]);
    s.x0[p] = x1;
    s.cur[p] = x1;
  }
  __syncthreads();

  // candidate center: the first maximum of the window, row-major
  if (threadIdx.x == 0) {
    const int cy = hb / 2 - r;
    const int cx = wb / 2 - r;
    const int n = 2 * r + 1;
    float best = s.x0[cy * wb + cx];
    int ci = 0;
    for (int t = 1; t < n * n; ++t) {
      const float val = s.x0[(cy + t / n) * wb + cx + t % n];
      if (val > best) {
        best = val;
        ci = t;
      }
    }
    pick = min(ci, ncand - 1);
  }
  __syncthreads();
  load_table(s, wtab, keeptab, pick, npix);
  __syncthreads();

  float* res = mono_passes(s, hb, wb, n_iter, scale, 0.0f);
  chain_epilogue(res, xo + off, hb, wb, thr[bk], floor, red);
}

template <typename Kernel>
int set_smem(Kernel kernel, int smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

int threads_for(int npix) {
  int threads = ((npix + 31) / 32) * 32;
  return threads > 512 ? 512 : threads;
}

}  // namespace

extern "C" int scarlet_mono_smem_bytes(int hb, int wb) {
  return 12 * hb * wb * (int)sizeof(float);
}

// x, out: B*K morphologies at element strides (sb, sk, sy, sx); idx: (B*K,)
// int32 table index; wtab: (ncand, 8, hb, wb); keeptab: (ncand, hb, wb).
extern "C" int scarlet_mono_prox(const float* x, float* out, const int* idx,
                                 const float* wtab, const float* keeptab,
                                 int ncand, int B, int K, int hb, int wb,
                                 long long sb, long long sk, long long sy,
                                 long long sx,
                                 int n_iter, float scale, float tol,
                                 void* stream) {
  const int smem = scarlet_mono_smem_bytes(hb, wb);
  const int err = set_smem(mono_kernel, smem);
  if (err != 0) return err;
  mono_kernel<<<B * K, threads_for(hb * wb), smem, (cudaStream_t)stream>>>(
      x, out, idx, wtab, keeptab, ncand, K, hb, wb, sb, sk, sy, sx, n_iter,
      scale, tol);
  return (int)cudaGetLastError();
}

// xorig, x, out: (N, hb, wb) contiguous, N = B*K; idx (N,) int32; thr (N,)
// float; gate (N,) bool; tables as above.
extern "C" int scarlet_prox_chain(const float* xorig, const float* x,
                                  float* out, const int* idx,
                                  const float* thr,
                                  const unsigned char* gate,
                                  const float* wtab, const float* keeptab,
                                  int ncand, int N, int hb, int wb,
                                  int n_iter, float scale, float floor,
                                  float tol, void* stream) {
  const int smem = scarlet_mono_smem_bytes(hb, wb);
  const int err = set_smem(chain_kernel, smem);
  if (err != 0) return err;
  chain_kernel<<<N, threads_for(hb * wb), smem, (cudaStream_t)stream>>>(
      xorig, x, out, idx, thr, gate, wtab, keeptab, ncand, hb, wb, n_iter,
      scale, floor, tol);
  return (int)cudaGetLastError();
}

// x, g, m, v, vh, bm (or null: no box mask), xo, mo, vo, vho: (B*K, hb, wb)
// contiguous; thr (B*K,) float; gate (B*K,) bool; ds (B,) float.
extern "C" int scarlet_fused_morph(
    const float* x, const float* g, const float* m, const float* v,
    const float* vh, const float* bm, const float* thr,
    const unsigned char* gate, const float* ds, const float* wtab,
    const float* keeptab, int ncand, int B, int K, int hb, int wb,
    int n_iter, float scale, int r, float c1, float b1, float c2, float b2,
    float eps, float floor, float* xo, float* mo, float* vo, float* vho,
    void* stream) {
  const int smem = scarlet_mono_smem_bytes(hb, wb);
  const int err = set_smem(fused_kernel, smem);
  if (err != 0) return err;
  fused_kernel<<<B * K, threads_for(hb * wb), smem, (cudaStream_t)stream>>>(
      x, g, m, v, vh, bm, thr, gate, ds, wtab, keeptab, ncand, K, hb, wb,
      n_iter, scale, r, c1, b1, c2, b2, eps, floor, xo, mo, vo, vho);
  return (int)cudaGetLastError();
}

extern "C" const char* scarlet_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
