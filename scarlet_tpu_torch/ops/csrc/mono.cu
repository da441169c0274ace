// Radial monotonicity projection of a batch of morphologies (Hopper,
// sm_90a).
//
// Replaces the TPU kernel scarlet_tpu/ops/pallas_kernels.py
// `_mono_kernel`, reached through `batched_monotonic_prox` (K1) and
// `monotonic_prox_packed` (K2).  One kernel serves both layouts: it takes
// element strides for (b, k, y, x), so the lane-packed (B, hb, K*wb) view
// is read and written in place, with no copy.
//
// Computes, per morphology x0 with its candidate-center table `ci`:
//   x <- keep ? x0 : min(x0, scale * sum_d w_d * x(p + off_d))
// Jacobi passes over the 8 NEIGHBOR_OFFSETS, in blocks of 4 passes, until
// a block's last pass changes nothing (tol == 0: the exact fixed point of
// the depth-n_iter DAG) or moves no pixel by more than tol (tol > 0), or
// until n_iter passes have run.  The convergence test compares the last
// two passes of a block, as the TPU kernel does, so exits fall on the
// same 4-pass boundaries.
//
// What bounds it on this card: each pass is 8 multiply-adds per pixel on
// values that the previous pass wrote, for up to n_iter (89 at box 59)
// passes.  From device memory that is ~9 reads of the stack per pass; the
// work per byte is tiny, so a pass-per-launch design would be bound by
// HBM bandwidth and launch latency.
// What the design does about it: one thread block owns one (blend,
// component) morphology and keeps everything on-chip for all passes --
// the selected 8-plane weight table (8*59*59*4 B = 111 KB at box 59), x0,
// the keep mask and two ping-pong x buffers, 167 KB at box 59 in dynamic
// shared memory.  Device memory is read once and written once per
// morphology, the TPU kernel's "one HBM round trip".  The pass loop is
// then bound by shared-memory bandwidth (9 loads per pixel per pass) and
// by the barrier between passes; at box 59 one block fills an SM's shared
// memory, so occupancy is one block of 512 threads per SM.
//
// Rounding: each product and sum is rounded on its own (__fmul_rn,
// __fadd_rn, no fused multiply-add), summed in NEIGHBOR_OFFSETS order
// from 0, so the result equals the plain PyTorch version bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int kUnroll = 4;  // passes per convergence test (MONO_UNROLL)

__constant__ int kOffY[8] = {-1, -1, -1, 0, 0, 1, 1, 1};
__constant__ int kOffX[8] = {-1, 0, 1, -1, 1, -1, 0, 1};

__global__ void __launch_bounds__(512)
mono_kernel(const float* __restrict__ x, float* __restrict__ out,
            const int* __restrict__ idx, const float* __restrict__ wtab,
            const float* __restrict__ keeptab, int ncand, int K, int hb,
            int wb, long long sb, long long sk, long long sy, long long sx,
            int n_iter, float scale, float tol) {
  extern __shared__ float smem[];
  const int npix = hb * wb;
  float* w = smem;                // 8 planes of npix
  float* x0 = w + 8 * npix;
  float* keep = x0 + npix;
  float* cur = keep + npix;
  float* nxt = cur + npix;

  const int bk = blockIdx.x;
  const long long b = bk / K;
  const long long k = bk - b * K;
  // an out-of-range index is clamped, never read out of bounds
  const long long ci = min(max(idx[bk], 0), ncand - 1);
  const float* wsel = wtab + ci * 8 * npix;
  const float* ksel = keeptab + ci * npix;
  const float* xin = x + b * sb + k * sk;
  float* xo = out + b * sb + k * sk;

  for (int p = threadIdx.x; p < 8 * npix; p += blockDim.x) w[p] = wsel[p];
  for (int p = threadIdx.x; p < npix; p += blockDim.x) {
    const int py = p / wb;
    const int px = p - py * wb;
    const float v = xin[py * sy + px * sx];
    x0[p] = v;
    cur[p] = v;
    keep[p] = ksel[p];
  }
  __syncthreads();

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
                               ? cur[ny * wb + nx] : 0.0f;
          ref = __fadd_rn(ref, __fmul_rn(w[d * npix + p], nv));
        }
        if (scale != 1.0f) ref = __fmul_rn(ref, scale);
        const float a = x0[p];
        const float v = keep[p] > 0.5f ? a : fminf(a, ref);
        nxt[p] = v;
        if (u == kUnroll - 1) {
          const float old = cur[p];
          flag |= tol > 0.0f ? (fabsf(v - old) > tol) : (v != old);
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

  for (int p = threadIdx.x; p < npix; p += blockDim.x) {
    const int py = p / wb;
    const int px = p - py * wb;
    xo[py * sy + px * sx] = cur[p];
  }
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
  cudaError_t err = cudaFuncSetAttribute(
      mono_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int npix = hb * wb;
  int threads = ((npix + 31) / 32) * 32;
  if (threads > 512) threads = 512;
  mono_kernel<<<B * K, threads, smem, (cudaStream_t)stream>>>(
      x, out, idx, wtab, keeptab, ncand, K, hb, wb, sb, sk, sy, sx, n_iter,
      scale, tol);
  return (int)cudaGetLastError();
}

extern "C" const char* scarlet_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
