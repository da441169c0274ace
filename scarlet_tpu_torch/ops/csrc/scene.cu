// Scene assembly: sum of factorized components sed_k (x) morph_k placed at
// integer origins, for a batch of blends (Hopper, sm_90a).
//
// Replaces the TPU kernel scarlet_tpu/ops/pallas_kernels.py
// `_scene_kernel` (wrapper `scene_assembly`, K3), which scatter-adds each
// component's box into a zero scene padded by P and crops it.
//
// Written as a gather, not a scatter: each output value (b, c, y, x) is
// the sum of sed_kc * morph_k[y - oy_k, x - ox_k] over the active
// components whose box covers it, in order k = 0..K-1.  No atomics,
// deterministic.  Origins may be negative or overhang the scene: a box
// clips at the scene edge exactly as the padded scatter does, because
// only pixels inside the scene are ever computed.
//
// What bounds it on this card: bytes.  A launch must write the B*C*H*W
// output once and read each in-scene pixel of each active component's
// morphology once (7.1 MB and at most 22.8 MB at 128 blends x 16
// components, box 59, 5 x 58 x 48).  The design before this one ran one
// thread per output value, so the C bands of a pixel ran in threads H*W
// apart, in different blocks, and each read the morph value again (~114
// MB through L2 per launch), after four 64-bit divisions and a walk over
// every component's origin in device memory.  This one:
//   - a block takes one blend and a band of TY rows (and, for a scene
//     wider than TX * XV, a tile of columns), with a 2-D thread map: a
//     thread owns XV consecutive x of one row (XV = 4 where W is a
//     multiple of 4, so it stores a float4 per band) and all C bands of
//     them (kernels.scene_geometry).  No 64-bit index math per thread;
//   - the block puts its blend's K origins and K x C seds in shared
//     memory, and one warp lists, in ascending k with a ballot, the active
//     components whose box meets the block's rows and columns;
//   - a thread reads each covering component's morph value once and keeps
//     C x XV running sums in registers.  It issues the loads of kBatch
//     listed components before it adds any of them (in order), so several
//     loads are in flight per thread: one at a time left the kernel
//     waiting on device-memory latency.
//
// Rounding: each band's sum is taken in ascending k with each step rounded
// on its own, acc = acc + sed * morph (__fmul_rn, __fadd_rn), where the
// plain PyTorch version adds (sed * morph) * active: for an active
// component the multiply by 1.0 is exact, so the two agree bit for bit.
// The kernel skips inactive components, where the plain version adds
// (sed * morph) * 0 = +-0, which leaves its sum as it was (the sum starts
// at +0 and is never -0): the same bits for finite inputs.  Where an
// inactive component's sed or morphology holds inf or NaN, 0 * inf makes
// the plain version's pixels NaN inside the box it parks the component at
// (its origin moved to (-pad, -pad)); this kernel ignores the component.
// The port's paths keep inactive slots finite.
#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr int kMaxC = 8;
constexpr int kMaxThreads = 128;    // kernels.SCENE_THREADS
constexpr int kBatch = 4;           // components whose loads overlap

// Block (b, band, tile): blend b, rows [band * TY, band * TY + TY) and
// columns [tile * TX * XV, (tile + 1) * TX * XV) of the scene; thread t
// takes row t / TX of the band and x = (tile * TX + t % TX) * XV + v,
// v < XV.  Dynamic shared memory: origins (K, 2) int, the list (K) int,
// seds (K, C) float.
template <int XV>
__global__ void __launch_bounds__(kMaxThreads)
scene_kernel(const float* __restrict__ seds, const float* __restrict__ morphs,
             const int* __restrict__ origins,
             const unsigned char* __restrict__ active, float* __restrict__ out,
             int K, int C, int hb, int wb, int H, int W, int TX, int TY) {
  extern __shared__ int4 smem4[];
  int* org = reinterpret_cast<int*>(smem4);
  int* list = org + 2 * K;
  float* sed = reinterpret_cast<float*>(list + K);
  __shared__ int count;

  const int tid = threadIdx.x;
  const int y0 = blockIdx.y * TY;
  const int y1 = min(H, y0 + TY);
  const int xs0 = blockIdx.z * TX * XV;
  const int xs1 = min(W, xs0 + TX * XV);
  // this blend's inputs and output: 64-bit offsets once per block
  const long long b = blockIdx.x;
  const int* ob = origins + b * K * 2;
  const float* sb = seds + b * K * C;
  const unsigned char* ab = active + b * K;
  const float* mb = morphs + b * K * hb * wb;
  float* outb = out + b * C * H * W;

  for (int i = tid; i < 2 * K; i += blockDim.x) org[i] = ob[i];
  for (int i = tid; i < K * C; i += blockDim.x) sed[i] = sb[i];
  __syncthreads();
  if (tid < 32) {
    int n = 0;
    for (int kb = 0; kb < K; kb += 32) {
      const int k = kb + tid;
      bool take = false;
      if (k < K) {
        const int oy = org[2 * k];
        const int ox = org[2 * k + 1];
        take = ab[k] && oy < y1 && oy + hb > y0 && ox < xs1 && ox + wb > xs0;
      }
      const unsigned mask = __ballot_sync(0xffffffffu, take);
      if (take) list[n + __popc(mask & ((1u << tid) - 1u))] = k;
      n += __popc(mask);
    }
    if (tid == 0) count = n;
  }
  __syncthreads();

  const int ty = tid / TX;
  const int y = y0 + ty;
  const int x0 = xs0 + (tid - ty * TX) * XV;
  if (ty >= TY || y >= y1 || x0 >= xs1) return;

  float acc[kMaxC][XV];
#pragma unroll
  for (int c = 0; c < kMaxC; ++c)
#pragma unroll
    for (int v = 0; v < XV; ++v) acc[c][v] = 0.0f;

  // kBatch components at a time: their morph loads are in flight together
  const int n = count;
  for (int i0 = 0; i0 < n; i0 += kBatch) {
    int kk[kBatch];
    bool in[kBatch][XV];
    float m[kBatch][XV];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int k = i0 + u < n ? list[i0 + u] : list[i0];
      const int ly = y - org[2 * k];
      const bool row = i0 + u < n && (unsigned)ly < (unsigned)hb;
      const int lx = x0 - org[2 * k + 1];
      const float* mrow = mb + (k * hb + (row ? ly : 0)) * wb;
      kk[u] = k;
#pragma unroll
      for (int v = 0; v < XV; ++v) {
        in[u][v] = row && (unsigned)(lx + v) < (unsigned)wb;
        m[u][v] = in[u][v] ? mrow[lx + v] : 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
#pragma unroll
      for (int c = 0; c < kMaxC; ++c) {
        if (c < C) {
          const float s = sed[kk[u] * C + c];
#pragma unroll
          for (int v = 0; v < XV; ++v)
            if (in[u][v])
              acc[c][v] = __fadd_rn(acc[c][v], __fmul_rn(s, m[u][v]));
        }
      }
    }
  }

#pragma unroll
  for (int c = 0; c < kMaxC; ++c) {
    if (c < C) {
      float* o = outb + (c * H + y) * W + x0;
      if (XV == 4) {
        *reinterpret_cast<float4*>(o) =
            make_float4(acc[c][0], acc[c][XV > 1 ? 1 : 0],
                        acc[c][XV > 2 ? 2 : 0], acc[c][XV > 3 ? 3 : 0]);
      } else if (XV == 2) {
        *reinterpret_cast<float2*>(o) =
            make_float2(acc[c][0], acc[c][XV > 1 ? 1 : 0]);
      } else {
        o[0] = acc[c][0];
      }
    }
  }
}

template <int XV>
int launch(const float* seds, const float* morphs, const int* origins,
           const unsigned char* active, float* out, int B, int K, int C,
           int hb, int wb, int H, int W, int TX, int TY, int bands, int tiles,
           int threads, int smem, void* stream) {
  static int granted[scarlet::kMaxDevices] = {};
  const int err = scarlet::grant_smem(scene_kernel<XV>, smem, granted);
  if (err != 0) return err;
  scene_kernel<XV><<<dim3(B, bands, tiles), threads, smem,
                     (cudaStream_t)stream>>>(seds, morphs, origins, active,
                                             out, K, C, hb, wb, H, W, TX, TY);
  return (int)cudaGetLastError();
}

}  // namespace

// seds: (B, K, C); morphs: (B, K, hb, wb); origins: (B, K, 2) int32;
// active: (B, K) bool; out: (B, C, H, W).  All contiguous; C <= kMaxC.
// XV, TX, TY, bands, tiles, threads, smem: kernels.scene_geometry.
extern "C" int scarlet_scene_assembly(const float* seds, const float* morphs,
                                      const int* origins,
                                      const unsigned char* active, float* out,
                                      int B, int K, int C, int hb, int wb,
                                      int H, int W, int XV, int TX, int TY,
                                      int bands, int tiles, int threads,
                                      int smem, void* stream) {
  if (C > kMaxC || threads > kMaxThreads || threads < 32 ||
      TX * TY > threads || W % XV != 0 || bands > 65535 || tiles > 65535)
    return (int)cudaErrorInvalidValue;
  if (XV == 4)
    return launch<4>(seds, morphs, origins, active, out, B, K, C, hb, wb, H,
                     W, TX, TY, bands, tiles, threads, smem, stream);
  if (XV == 2)
    return launch<2>(seds, morphs, origins, active, out, B, K, C, hb, wb, H,
                     W, TX, TY, bands, tiles, threads, smem, stream);
  if (XV == 1)
    return launch<1>(seds, morphs, origins, active, out, B, K, C, hb, wb, H,
                     W, TX, TY, bands, tiles, threads, smem, stream);
  return (int)cudaErrorInvalidValue;
}

// out[3] as scarlet::kernel_info, for the XV instantiation.
extern "C" int scarlet_scene_kernel_info(int XV, int threads, int smem,
                                         int* out) {
  using scarlet::kernel_info;
  if (XV == 4) return kernel_info(scene_kernel<4>, threads, smem, out);
  if (XV == 2) return kernel_info(scene_kernel<2>, threads, smem, out);
  return kernel_info(scene_kernel<1>, threads, smem, out);
}
