// Scene assembly: sum of factorized components sed_k (x) morph_k placed at
// integer origins, for a batch of blends (Hopper, sm_90a).
//
// Replaces the TPU kernel scarlet_tpu/ops/pallas_kernels.py
// `_scene_kernel` (wrapper `scene_assembly`, K3), which scatter-adds each
// component's box into a zero scene padded by P and crops it.
//
// Written as a gather, not a scatter: each thread owns one output pixel
// (b, c, y, x) and sums active_k * sed_kc * morph_k[y - oy_k, x - ox_k]
// over the components whose box covers it, in order k = 0..K-1.  No
// atomics, deterministic, and each pixel's sum is taken in the same order
// with the same roundings as the plain PyTorch version (zero, then
// cur + (sed * morph) * active per component), so the two agree bit for
// bit.  Origins may be negative or overhang the scene: a box clips at the
// scene edge exactly as the padded scatter does, because only pixels
// inside the scene are ever computed.
//
// What bounds it on this card: device-memory traffic and latency.  The
// output (B*C*H*W floats) is written once; each thread reads K origins
// (from L1 after the first warp) and one morph value per covering
// component.  At B=128, C=5, 58x48 that is 1.8 M outputs, a few tens of
// microseconds at HBM bandwidth; the design keeps it a single pass with no
// intermediate (B, K, C, hb, wb) model stack in device memory.
#include <cuda_runtime.h>

namespace {

__global__ void scene_kernel(const float* __restrict__ seds,
                             const float* __restrict__ morphs,
                             const int* __restrict__ origins,
                             const unsigned char* __restrict__ active,
                             float* __restrict__ out, int K, int C, int hb,
                             int wb, int H, int W, long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int x = (int)(i % W);
  long long r = i / W;
  const int y = (int)(r % H);
  r /= H;
  const int c = (int)(r % C);
  const long long b = r / C;

  const int* org = origins + b * K * 2;
  float acc = 0.0f;
  for (int k = 0; k < K; ++k) {
    const int ly = y - org[2 * k];
    const int lx = x - org[2 * k + 1];
    if (ly >= 0 && ly < hb && lx >= 0 && lx < wb) {
      const long long bk = b * K + k;
      const float s = seds[bk * C + c];
      const float m = morphs[(bk * hb + ly) * wb + lx];
      const float on = active[bk] ? 1.0f : 0.0f;
      acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(s, m), on));
    }
  }
  out[i] = acc;
}

}  // namespace

// seds: (B, K, C); morphs: (B, K, hb, wb); origins: (B, K, 2) int32;
// active: (B, K) bool; out: (B, C, H, W).  All contiguous.
extern "C" int scarlet_scene_assembly(const float* seds, const float* morphs,
                                      const int* origins,
                                      const unsigned char* active, float* out,
                                      int B, int K, int C, int hb, int wb,
                                      int H, int W, void* stream) {
  const long long total = (long long)B * C * H * W;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  scene_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      seds, morphs, origins, active, out, K, C, hb, wb, H, W, total);
  return (int)cudaGetLastError();
}
