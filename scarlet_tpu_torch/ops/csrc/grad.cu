// Per-component gradient gather for a batch of blends (Hopper, sm_90a).
//
// Replaces the TPU kernel scarlet_tpu/ops/pallas_kernels.py
// `_grad_window_kernel` (wrapper `grad_gather`, K4).  For component k of
// blend b, with the window g = gpad[b, :, P+oy : P+oy+hb, P+ox : P+ox+wb]
// of the padded scene gradient:
//   g_morph[b, k] = sum_c sed_kc * g_c        (per pixel, in c order)
//   g_sed[b, k, c] = sum_hw g_c * morph_k     (block reduction)
//
// One thread block per (b, k).  Each thread walks pixels of the window,
// writes g_morph for them (the products and sums rounded one by one, c in
// order, so g_morph equals the plain PyTorch version bit for bit) and
// keeps C running partial sums of g_c * morph in registers; the block then
// reduces them with warp shuffles and one shared-memory round.  The
// reduction order differs from torch's sum, so g_sed agrees with the
// plain version to float32 roundoff of the sum, not bit for bit.
//
// What bounds it on this card: device-memory reads.  Each (b, k) reads a
// C x hb x wb window of gpad (mostly from L2: windows of one blend
// overlap) plus its morph, and writes hb x wb g_morph values; the
// arithmetic is 2C operations per pixel.  The design reads every window
// element once and never materializes the (B, K, C, hb, wb) window stack
// in device memory.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxC = 8;
constexpr int kThreads = 256;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
  return v;
}

__global__ void __launch_bounds__(kThreads)
grad_kernel(const float* __restrict__ gpad, const float* __restrict__ seds,
            const float* __restrict__ morphs, const int* __restrict__ origins,
            float* __restrict__ g_seds, float* __restrict__ g_morphs, int K,
            int C, int hb, int wb, int Hp, int Wp, int P) {
  __shared__ float red[kMaxC][kThreads / 32];
  const long long bk = blockIdx.x;
  const long long b = bk / K;
  const int oy = origins[2 * bk] + P;
  const int ox = origins[2 * bk + 1] + P;
  const int npix = hb * wb;
  const float* morph = morphs + bk * npix;
  float* gm = g_morphs + bk * npix;
  const float* gb = gpad + b * C * Hp * Wp;

  float s[kMaxC];
  float part[kMaxC];
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) {
    s[c] = c < C ? seds[bk * C + c] : 0.0f;
    part[c] = 0.0f;
  }

  for (int p = threadIdx.x; p < npix; p += blockDim.x) {
    const int ly = p / wb;
    const int lx = p - ly * wb;
    const int gy = oy + ly;
    const int gx = ox + lx;
    const bool in = gy >= 0 && gy < Hp && gx >= 0 && gx < Wp;
    const float m = morph[p];
    float acc = 0.0f;
#pragma unroll
    for (int c = 0; c < kMaxC; ++c) {
      if (c < C) {
        const float g = in ? gb[((long long)c * Hp + gy) * Wp + gx] : 0.0f;
        const float t = __fmul_rn(s[c], g);
        acc = c == 0 ? t : __fadd_rn(acc, t);
        part[c] = __fadd_rn(part[c], __fmul_rn(g, m));
      }
    }
    gm[p] = acc;
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) {
    if (c < C) {
      const float v = warp_sum(part[c]);
      if (lane == 0) red[c][warp] = v;
    }
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int c = 0; c < kMaxC; ++c) {
      if (c < C) {
        const float v = warp_sum(lane < nwarps ? red[c][lane] : 0.0f);
        if (lane == 0) g_seds[bk * C + c] = v;
      }
    }
  }
}

}  // namespace

extern "C" int scarlet_grad_max_bands() { return kMaxC; }

// gpad: (B, C, Hp, Wp); seds: (B, K, C); morphs: (B, K, hb, wb);
// origins: (B, K, 2) int32; g_seds: (B, K, C); g_morphs: (B, K, hb, wb).
// All contiguous; C <= kMaxC.
extern "C" int scarlet_grad_gather(const float* gpad, const float* seds,
                                   const float* morphs, const int* origins,
                                   float* g_seds, float* g_morphs, int B,
                                   int K, int C, int hb, int wb, int Hp,
                                   int Wp, int P, void* stream) {
  if (C > kMaxC) return (int)cudaErrorInvalidValue;
  grad_kernel<<<B * K, kThreads, 0, (cudaStream_t)stream>>>(
      gpad, seds, morphs, origins, g_seds, g_morphs, K, C, hb, wb, Hp, Wp,
      P);
  return (int)cudaGetLastError();
}
