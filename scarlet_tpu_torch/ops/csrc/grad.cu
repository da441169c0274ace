// Per-component gradient gather for a batch of blends (Hopper, sm_90a).
//
// Replaces the TPU kernel scarlet_tpu/ops/pallas_kernels.py
// `_grad_window_kernel` (wrapper `grad_gather`, K4).  For component k of
// blend b, with the window g = grad[b, :, P+oy : P+oy+hb, P+ox : P+ox+wb]
// of the scene gradient (window pixels outside the array read 0):
//   g_morph[b, k] = sum_c sed_kc * g_c        (per pixel, in c order)
//   g_sed[b, k, c] = sum_hw g_c * morph_k     (a block reduction)
//
// The gradient is read in place through its (b, c, y) strides, with unit
// column stride.  The fit passes the unpadded scene gradient, a strided
// crop of the inverse FFT, with P = 0: no padded copy and no contiguous
// copy is made.  A gradient zero-padded by P, with that P, gives the same
// results.
//
// What bounds it on this card: bytes.  A launch must read each blend's
// C x H x W gradient and each component's morphology once and write each
// g_morph once; the arithmetic is 4C operations per window pixel.  The
// components of a blend cover nearly the same pixels (box 59 on a 58 x 48
// scene), so a kernel that fetches each component's window from L2 moves
// the blend's gradient K times (the one-block-per-component design before
// this one: ~143 MB of L2 reads per launch at 128 blends x 16 components,
// for 7.1 MB of gradient).  This design:
//   - a block takes one blend and a group of G of its components
//     (kernels.grad_geometry picks G so that the grid fills the blocks
//     the card holds at once).  On the staged route the block first copies
//     the blend's gradient into shared memory with cp.async: 16-byte copies
//     where the band and row strides and the width are multiples of 4
//     floats (the plane shifted by the pointer's offset within 16 bytes,
//     so both sides of a copy are aligned), else 4-byte copies.  Each
//     gradient byte then crosses L2 -> SM once per group of G windows;
//   - the group's seds and origins are loaded into shared memory once, and
//     the morphologies stream through two shared buffers with cp.async,
//     the next component's copy in flight while one is walked: a walk
//     that waited on a global load per row or per component (one in
//     flight per warp) ran at device-memory latency, not bandwidth;
//   - the window walk has no division per pixel: row y of component k
//     falls to warp (k * hb + y) % kWarps, and a lane takes pixels x and
//     x + 32 of it together (two independent chains; wb = 59 is one pass),
//     so shared loads are conflict-free and g_morph stores coalesce.  The
//     map follows k, not k's place in its block's group, so a component's
//     g_sed sums in the same order whatever G the batch size gives (a
//     group-relative map made a blend's g_sed depend on the batch it was
//     fitted in, by an ulp).  The band count is a template parameter
//     (C <= kMaxC);
//   - more than kMaxC bands would not fit the registers (a seds, two
//     partial g_sed sums per band and thread): the grouped instantiation
//     walks each window once per group of kMaxC bands, in the same launch.
//     A thread carries g_morph from one group to the next through the
//     value it stored to g_morphs (the same thread walks the same pixel in
//     every group), so the running sum keeps its order and its bits;
//   - where two staged blocks do not fit an SM's shared memory
//     (kernels.grad_geometry), the direct route runs the same walk,
//     loading the strided gradient through the read-only cache, which
//     holds a blend's gradient when shared memory does not.
//
// Rounding: g_morph's products and sums are rounded one by one, c in order
// (__fmul_rn, __fadd_rn), so g_morph equals the plain PyTorch version bit
// for bit, in one group or several.  Each thread sums g_c * morph over its pixels in walk order,
// each warp reduces those sums in a fixed shuffle tree, and the warps'
// sums are added in warp order, so g_sed is the same bits from run to run;
// it agrees with torch's sum to float32 roundoff of its hb * wb terms.
#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr int kMaxC = 8;
constexpr int kThreads = 256;       // kernels.GRAD_THREADS
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 4;       // kernels.GRAD_BLOCKS_PER_SM

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

// Copies the blend's (C, H, W) gradient at gb (strides sc, sy, unit
// column stride) to plane[(c * H + y) * W + x], plane = stage + shift.
// With vec (sc, sy and W multiples of 4, shift the float offset of gb
// within 16 bytes) a row goes as its aligned groups of 4 floats, the
// partial first and last groups of a shifted row float by float.  A warp
// takes 32 / items rows at once where a row has at most 32 items.
__device__ void stage_grad(float* stage, const float* gb, int C, int H,
                           int W, long long sc, long long sy, int shift,
                           bool vec) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int items = vec ? W / 4 + (shift != 0) : W;
  const int rows = items <= 32 ? 32 / items : 1;
  const int sub = items <= 32 ? lane / items : 0;
  const int q0 = lane - sub * (items <= 32 ? items : 0);
  if (sub >= rows) return;
  for (int c = 0; c < C; ++c) {
    for (int y = warp * rows + sub; y < H; y += kWarps * rows) {
      const float* src = gb + c * sc + y * sy;
      float* dst = stage + shift + (c * H + y) * W;
      for (int q = q0; q < items; q += 32) {
        if (!vec) {
          cp_async4(dst + q, src + q);
          continue;
        }
        const int x0 = 4 * q - shift;
        if (x0 >= 0 && x0 + 4 <= W) {
          cp_async16(dst + x0, src + x0);
        } else {
          for (int x = max(x0, 0); x < min(x0 + 4, W); ++x)
            cp_async4(dst + x, src + x);
        }
      }
    }
  }
}

// Copies n contiguous floats from src to dst + shift, shift = src's float
// offset within 16 bytes (dst 16-byte aligned): the aligned groups of 4
// as 16-byte copies, a partial first or last group float by float.
// Returns shift.
__device__ int stage_span(float* dst, const float* src, int n) {
  const int shift =
      (int)((reinterpret_cast<unsigned long long>(src) >> 2) & 3);
  const int items = (shift + n + 3) / 4;
  for (int q = threadIdx.x; q < items; q += kThreads) {
    const int x0 = 4 * q - shift;
    if (x0 >= 0 && x0 + 4 <= n) {
      cp_async16(dst + shift + x0, src + x0);
    } else {
      for (int x = max(x0, 0); x < min(x0 + 4, n); ++x)
        cp_async4(dst + shift + x, src + x);
    }
  }
  return shift;
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits for all but the most recent committed group.
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// One window pixel over the bands c < nc of a group (grow at its first
// band): g_morph = acc + sum_c sed_c * g_c (rounded one by one, c in
// order; with first, the first term starts the sum and acc is unused) and
// part_c += g_c * m.  g_c = 0 where the pixel lies outside the gradient
// (in false).
template <bool kStaged, int kC>
__device__ __forceinline__ float pixel(const float* grow, int gx, bool in,
                                       float m, const float* s, float* part,
                                       int HW, long long sc, int nc,
                                       float acc, bool first) {
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    if (c < nc) {
      float g = 0.0f;
      if (in) g = kStaged ? grow[c * HW + gx] : __ldg(grow + c * sc + gx);
      const float t = __fmul_rn(s[c], g);
      acc = c == 0 && first ? t : __fadd_rn(acc, t);
      part[c] = __fadd_rn(part[c], __fmul_rn(g, m));
    }
  }
  return acc;
}

// Block (b, group): blend b, components k0 = group * G .. k0 + G - 1 (< K).
// Dynamic shared memory (kernels.grad_geometry's smem), in floats, each
// part a multiple of 4: the (G, C, kWarps) warp sums of g_sed; the group's
// seds (G, C) and origins (G, 2); two morphology buffers of mstride
// floats (component j in buffer j % 2, component j + 1's copy in flight
// while j is walked); on the staged route, the gradient plane.  C is the
// band count: kC, or with kGrouped any count, walked in groups of kC.
template <bool kStaged, int kC, bool kGrouped>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
grad_kernel(const float* __restrict__ grad, const float* __restrict__ seds,
            const float* __restrict__ morphs, const int* __restrict__ origins,
            float* __restrict__ g_seds, float* __restrict__ g_morphs, int K,
            int C_, int hb, int wb, int H, int W, int P, long long sb,
            long long sc, long long sy, int G, int vec) {
  const int C = kGrouped ? C_ : kC;
  extern __shared__ float4 smem4[];
  float* red = reinterpret_cast<float*>(smem4);
  float* sed = red + ((G * C * kWarps + 3) & ~3);
  int* org = reinterpret_cast<int*>(sed + ((G * C + 3) & ~3));
  float* mbuf = reinterpret_cast<float*>(org + ((2 * G + 3) & ~3));
  const int npix = hb * wb;
  const int mstride = (npix + 6) & ~3;
  const int b = blockIdx.x;
  const int k0 = blockIdx.y * G;
  const int n = min(G, K - k0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long bk0 = (long long)b * K + k0;
  const float* gb = grad + b * sb;

  for (int i = threadIdx.x; i < n * C; i += kThreads)
    sed[i] = seds[bk0 * C + i];
  for (int i = threadIdx.x; i < 2 * n; i += kThreads)
    org[i] = origins[2 * bk0 + i];
  const float* plane = gb;
  if (kStaged) {
    float* stage = mbuf + 2 * mstride;
    const int shift =
        vec ? (int)((reinterpret_cast<unsigned long long>(gb) >> 2) & 3) : 0;
    stage_grad(stage, gb, C, H, W, sc, sy, shift, vec != 0);
    plane = stage + shift;
  }
  int mshift = stage_span(mbuf, morphs + bk0 * npix, npix);
  cp_async_commit();
  const int HW = H * W;

  for (int j = 0; j < n; ++j) {
    int next_shift = 0;
    if (j + 1 < n)
      next_shift = stage_span(mbuf + ((j + 1) & 1) * mstride,
                              morphs + (bk0 + j + 1) * npix, npix);
    cp_async_commit();
    cp_async_wait_prior();
    __syncthreads();
    const int oy = org[2 * j] + P;
    const int ox = org[2 * j + 1] + P;
    const float* morph = mbuf + (j & 1) * mstride + mshift;
    float* gm = g_morphs + (bk0 + j) * npix;
    // the bands in groups of kC from c0 (one group unless kGrouped)
    for (int c0 = 0; c0 < C; c0 += kC) {
      const int nc = kGrouped ? min(kC, C - c0) : kC;
      const bool first = !kGrouped || c0 == 0;
      float s[kC], pa[kC], pb[kC];
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        s[c] = c < nc ? sed[j * C + c0 + c] : 0.0f;
        pa[c] = 0.0f;
        pb[c] = 0.0f;
      }
      const float* pc = plane + c0 * (kStaged ? (long long)H * W : sc);
      // a lane takes pixels x and x + 32 of a row together: two
      // independent chains, summed into g_sed as pa + pb
      for (int y = (warp - (k0 + j) * hb % kWarps + kWarps) % kWarps;
           y < hb; y += kWarps) {
        const int gy = oy + y;
        const bool row_in = gy >= 0 && gy < H;
        const float* grow =
            !row_in ? pc : (kStaged ? pc + gy * W : pc + gy * sy);
        const float* mrow = morph + y * wb;
        float* grow_out = gm + y * wb;
        for (int x = lane; x < wb; x += 64) {
          const int xb = x + 32;
          const bool has_b = xb < wb;
          const int gxa = ox + x;
          const int gxb = ox + xb;
          const bool ina = row_in && gxa >= 0 && gxa < W;
          const bool inb = has_b && row_in && gxb >= 0 && gxb < W;
          const float ma = mrow[x];
          const float mb = has_b ? mrow[xb] : 0.0f;
          // a later group continues the sum this thread stored
          const float a0 = first ? 0.0f : grow_out[x];
          const float b0 = first || !has_b ? 0.0f : grow_out[xb];
          // a missing pixel b adds 0 * 0 to pb
          const float acca = pixel<kStaged, kC>(grow, gxa, ina, ma, s, pa,
                                                HW, sc, nc, a0, first);
          const float accb = pixel<kStaged, kC>(grow, gxb, inb, mb, s, pb,
                                                HW, sc, nc, b0, first);
          grow_out[x] = acca;
          if (has_b) grow_out[xb] = accb;
        }
      }
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        if (c < nc) {
          const float v = warp_sum(__fadd_rn(pa[c], pb[c]));
          if (lane == 0) red[(j * C + c0 + c) * kWarps + warp] = v;
        }
      }
    }
    // buffer j % 2 takes component j + 2's copy in the next iteration
    __syncthreads();
    mshift = next_shift;
  }
  // g_sed of (j, c) = t = j * C + c: the warp sums in warp order
  for (int t = threadIdx.x; t < n * C; t += kThreads) {
    float v = red[t * kWarps];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) v = __fadd_rn(v, red[t * kWarps + w]);
    g_seds[bk0 * C + t] = v;
  }
}

template <bool kStaged, int kC, bool kGrouped>
int launch(const float* grad, const float* seds, const float* morphs,
           const int* origins, float* g_seds, float* g_morphs, int B, int K,
           int C, int hb, int wb, int H, int W, int P, long long sb,
           long long sc, long long sy, int G, int groups, int smem, int vec,
           void* stream) {
  static int granted[scarlet::kMaxDevices] = {};
  const int err = scarlet::grant_smem(grad_kernel<kStaged, kC, kGrouped>,
                                      smem, granted);
  if (err != 0) return err;
  grad_kernel<kStaged, kC, kGrouped><<<dim3(B, groups), kThreads, smem,
                                       (cudaStream_t)stream>>>(
      grad, seds, morphs, origins, g_seds, g_morphs, K, C, hb, wb, H, W, P,
      sb, sc, sy, G, vec);
  return (int)cudaGetLastError();
}

// The (route, C) instantiations: F<staged, C, false>::run(args...) runs one
// for C <= kMaxC, F<staged, kMaxC, true> (bands in groups) above.
template <template <bool, int, bool> class F, typename... A>
int dispatch(int staged, int C, A... a) {
  if (C > kMaxC)
    return staged ? F<true, kMaxC, true>::run(a...)
                  : F<false, kMaxC, true>::run(a...);
  switch (C * 2 + (staged ? 1 : 0)) {
#define SCARLET_GRAD_CASE(c)                          \
  case 2 * c: return F<false, c, false>::run(a...);   \
  case 2 * c + 1: return F<true, c, false>::run(a...);
    SCARLET_GRAD_CASE(1) SCARLET_GRAD_CASE(2) SCARLET_GRAD_CASE(3)
    SCARLET_GRAD_CASE(4) SCARLET_GRAD_CASE(5) SCARLET_GRAD_CASE(6)
    SCARLET_GRAD_CASE(7) SCARLET_GRAD_CASE(8)
#undef SCARLET_GRAD_CASE
  }
  return (int)cudaErrorInvalidValue;
}

template <bool kStaged, int kC, bool kGrouped>
struct Launch {
  template <typename... A>
  static int run(A... a) {
    return launch<kStaged, kC, kGrouped>(a...);
  }
};

template <bool kStaged, int kC, bool kGrouped>
struct Info {
  static int run(int smem, int* out) {
    return scarlet::kernel_info(grad_kernel<kStaged, kC, kGrouped>, kThreads,
                                smem, out);
  }
};

}  // namespace

// grad: B blends of (C, H, W) at element strides (sb, sc, sy, 1), the
// window of component k at (origins[k] + P); seds: (B, K, C); morphs:
// (B, K, hb, wb); origins: (B, K, 2) int32; g_seds: (B, K, C); g_morphs:
// (B, K, hb, wb), all but grad contiguous.  staged, G, groups, smem:
// kernels.grad_geometry.  C >= 1.
extern "C" int scarlet_grad_gather(const float* grad, const float* seds,
                                   const float* morphs, const int* origins,
                                   float* g_seds, float* g_morphs, int B,
                                   int K, int C, int hb, int wb, int H, int W,
                                   int P, long long sb, long long sc,
                                   long long sy, int staged, int G,
                                   int groups, int smem, void* stream) {
  if (C < 1 || G < 1 || (long long)groups * G < K || groups > 65535)
    return (int)cudaErrorInvalidValue;
  const int vec = sc % 4 == 0 && sy % 4 == 0 && W % 4 == 0;
  return dispatch<Launch>(staged, C, grad, seds, morphs, origins, g_seds,
                          g_morphs, B, K, C, hb, wb, H, W, P, sb, sc, sy, G,
                          groups, smem, vec, stream);
}

// The (route, C) instantiation's out[3], as scarlet::kernel_info.
extern "C" int scarlet_grad_kernel_info(int staged, int C, int smem,
                                        int* out) {
  return dispatch<Info>(staged, C, smem, out);
}
