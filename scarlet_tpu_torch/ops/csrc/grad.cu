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
// the blend's gradient K times.  A block takes one blend and a group of G
// of its components, and every gradient byte crosses L2 -> SM once per
// block, through shared memory, by one of two routes
// (kernels.grad_geometry picks it from the shape alone):
//
// Staged route (grad_kernel_staged; C <= kStagedC, where two blocks with
// the whole gradient fit an SM's shared memory):
//   - the block copies the blend's gradient into shared memory with
//     cp.async: 16-byte copies where the band and row strides and the
//     width are multiples of 4 floats (the plane shifted by the pointer's
//     offset within 16 bytes, so both sides of a copy are aligned), else
//     4-byte copies.  G fills the card's resident blocks in one wave;
//   - the morphologies stream through two shared buffers, the next
//     component's copy in flight while one is walked;
//   - row y of component k falls to warp (k * hb + y) % kWarps, and a lane
//     takes pixels x and x + 32 of it together (two chains).  The map
//     follows k, not k's place in its block's group, so a component's
//     g_sed sums in the same order whatever G the batch size gives.
//
// Tiled route (grad_kernel_tiled; every other shape: more than kStagedC
// bands, large scenes and boxes, padded gradients).  A blend's gradient
// does not fit a block's shared memory twice, so it streams through it:
//   - the block's G components share row tiles of the gradient: the scene
//     rows that any of their windows covers, cut into tiles of TR rows and
//     NB bands, each staged once into one of two buffers, the next tile's
//     copy in flight while the current one is walked.  The copies go to
//     the bulk copy engine (cp.async.bulk, completing on the buffer's
//     mbarrier): each gradient row, and each window's rows in the tile, as
//     the 16-byte granules that hold it (no row of a strided crop is
//     16-byte aligned), walked at its own offset in its slot (copies by
//     cp.async, one request a row, did not keep up with the walk:
//     tools/gather_parts.py).  No morphology is held whole: the tile sets
//     the bytes, and TR and NB shrink to fit any box;
//   - warp w walks component k0 + w / R and, of its window, the rows y
//     with y % R == w % R (R warps a component, G = kWarps / R, both set
//     by K and the box, never by B: two warps at least for rows past 64
//     pixels); a lane takes the columns x = lane mod 32 of a row, two at
//     a time, the bands in chunks of 8 whose shared loads issue together.
//     A thread's g_sed partial of each band is one register chain over all
//     its pixels, in row order across the tiles, so each window is walked
//     once for all NB <= kTileC bands and no sum leaves the registers
//     between tiles.  Its g_morph is one chain over the bands, written
//     once.  The partials are reduced at the end: each warp in a fixed
//     shuffle tree, the R warps of a component in order.  Neither G, R nor
//     the pixel order depends on B, so a blend's g_sed is the same bits
//     alone and in any batch;
//   - window rows outside the gradient need no tile: their g_morph is one
//     value a component (the chain of sed_c * 0), and they add 0 to g_sed
//     (NaN where a morphology value is not finite, as the plain version
//     does), their morphology loads issued 8 at a time;
//   - the band count is a template parameter (registers: kC seds and kC
//     partials a thread): exact up to 16 bands and at 24-64 in steps of 8,
//     with no test of the band count in the walk; a band group that does
//     not fill its instantiation runs a guarded one (kFull false).  Past
//     kTileC bands (or where one band group of a tile row does not fit
//     shared memory) the bands go in groups of NB, each group a walk of
//     the window over its own tiles; g_morph carries from one group to the
//     next through the value the same thread stored.
//
// Rounding: g_morph's products and sums are rounded one by one, c in order
// (__fmul_rn, __fadd_rn), so g_morph equals the plain PyTorch version bit
// for bit on both routes.  g_sed is summed in a fixed order on each route
// (the staged route: products rounded, then added, in two chains a lane;
// the tiled route: one fused multiply-add chain a lane), so it is the same
// bits from run to run and agrees with torch's sum to float32 roundoff of
// its hb * wb terms.
#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr int kStagedC = 8;         // kernels.GRAD_STAGED_BANDS

// tools/gather_parts.py builds with SCARLET_GRAD_PARTS defined: a switch,
// set at run time, that leaves parts of the tiled route out (bits: 1 the
// walk of the tiles, 2 the rows outside the gradient, 4 the copies and
// their waits, 8 the g_morph stores), to attribute its time; the results
// are then wrong.  The package's own build has no switch.
#ifdef SCARLET_GRAD_PARTS
__constant__ int kParts;
#define GRAD_SKIP(bit) (kParts & (bit))
#else
#define GRAD_SKIP(bit) false
#endif
constexpr int kTileC = 64;          // kernels.GRAD_TILE_BANDS
constexpr int kThreads = 256;       // kernels.GRAD_THREADS
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 4;       // kernels.GRAD_BLOCKS_PER_SM

// The tiled route's register bands for a band group of nb: exact up to
// 16, then the next multiple of 8 (kernels._tile_bands, with dispatch).
__host__ __device__ constexpr int tile_bands(int nb) {
  return nb <= 16 ? nb : (nb + 7) / 8 * 8;
}

// Blocks of the tiled route an SM must hold at once: the register budget
// of kC seds and kC partials a thread (kernels._tile_blocks_per_sm).
__host__ __device__ constexpr int tile_min_blocks(int kC) {
  return kC <= 12 ? 3 : (kC <= 40 ? 2 : 1);
}

__host__ __device__ constexpr int quad(int n) { return (n + 3) & ~3; }

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

__device__ __forceinline__ int float_shift(const float* p) {
  return (int)((reinterpret_cast<unsigned long long>(p) >> 2) & 3);
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
  const int shift = float_shift(src);
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

// ---------------------------------------------------------------------------
// Staged route
// ---------------------------------------------------------------------------

// One window pixel of the staged plane (grow its row): g_morph = sum_c
// sed_c * g_c (rounded one by one, c in order) and part_c += g_c * m.
// g_c = 0 where the pixel lies outside the gradient (in false).
template <int kC>
__device__ __forceinline__ float staged_pixel(const float* grow, int gx,
                                              bool in, float m,
                                              const float* s, float* part,
                                              int HW) {
  float acc = 0.0f;
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    const float g = in ? grow[c * HW + gx] : 0.0f;
    const float t = __fmul_rn(s[c], g);
    acc = c == 0 ? t : __fadd_rn(acc, t);
    part[c] = __fadd_rn(part[c], __fmul_rn(g, m));
  }
  return acc;
}

// Block (b, group): blend b, components k0 = group * G .. k0 + G - 1 (< K).
// Dynamic shared memory (kernels.grad_geometry's smem), in floats, each
// part a multiple of 4: the (G, kC, kWarps) warp sums of g_sed; the
// group's seds (G, kC) and origins (G, 2); two morphology buffers of
// mstride floats (component j in buffer j % 2, component j + 1's copy in
// flight while j is walked); the gradient plane.
template <int kC>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
grad_kernel_staged(const float* __restrict__ grad,
                   const float* __restrict__ seds,
                   const float* __restrict__ morphs,
                   const int* __restrict__ origins,
                   float* __restrict__ g_seds, float* __restrict__ g_morphs,
                   int K, int hb, int wb, int H, int W, int P, long long sb,
                   long long sc, long long sy, int G, int vec) {
  constexpr int C = kC;
  extern __shared__ float4 smem4[];
  float* red = reinterpret_cast<float*>(smem4);
  float* sed = red + quad(G * C * kWarps);
  int* org = reinterpret_cast<int*>(sed + quad(G * C));
  float* mbuf = reinterpret_cast<float*>(org + quad(2 * G));
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
  float* stage = mbuf + 2 * mstride;
  const int shift = vec ? float_shift(gb) : 0;
  stage_grad(stage, gb, C, H, W, sc, sy, shift, vec != 0);
  const float* plane = stage + shift;
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
    float s[kC], pa[kC], pb[kC];
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      s[c] = sed[j * C + c];
      pa[c] = 0.0f;
      pb[c] = 0.0f;
    }
    // a lane takes pixels x and x + 32 of a row together: two independent
    // chains, summed into g_sed as pa + pb
    for (int y = (warp - (k0 + j) * hb % kWarps + kWarps) % kWarps; y < hb;
         y += kWarps) {
      const int gy = oy + y;
      const bool row_in = gy >= 0 && gy < H;
      const float* grow = row_in ? plane + gy * W : plane;
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
        // a missing pixel b adds 0 * 0 to pb
        const float acca = staged_pixel<kC>(grow, gxa, ina, ma, s, pa, HW);
        const float accb = staged_pixel<kC>(grow, gxb, inb, mb, s, pb, HW);
        grow_out[x] = acca;
        if (has_b) grow_out[xb] = accb;
      }
    }
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const float v = warp_sum(__fadd_rn(pa[c], pb[c]));
      if (lane == 0) red[(j * C + c) * kWarps + warp] = v;
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

// ---------------------------------------------------------------------------
// Tiled route
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, int n) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(n)
               : "memory");
}

// This thread's arrival on bar, with `bytes` more to land by bulk copy.
__device__ __forceinline__ void mbar_arrive_tx(unsigned long long* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Waits for the phase of bar with this parity to complete.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Copies the 16-byte-aligned superset of n floats at src (the 16-byte
// granules that hold them, which never leave the allocation) to dst, a
// 16-byte-aligned buffer, by the bulk copy engine, completing on bar: src
// lands at dst + float_shift(src).  Returns the bytes copied.
__device__ __forceinline__ unsigned bulk_span(float* dst, const float* src,
                                              int n,
                                              unsigned long long* bar) {
  const int shift = float_shift(src);
  const unsigned bytes = 4u * quad(shift + n);
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src - shift), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
  return bytes;
}

// The first y >= y0 with y % R == r.
__device__ __forceinline__ int first_row(int y0, int r, int R) {
  return y0 + ((r - y0 % R) % R + R) % R;
}

// One window row of a band group inside the gradient: grow the row's band
// 0 in the tile (band stride bstride; band c at its own alignment offset
// (sh0 + c * sc3) % 4, sh0 band 0's and sc3 the band stride's offset
// within 16 bytes), mrow the morphology row in the tile, out the g_morph
// row.  A lane takes pixels x and x + 32 (two g_morph chains, one g_sed
// chain a band), the bands in chunks of 8 whose loads issue together;
// with first the first band starts the g_morph sum, else it continues the
// value stored by the previous band group.  With kFull the group fills
// the instantiation (nb == kC); else bands c >= nb read 0 against a sed
// of -0: their term is -0, which leaves any sum as it is, with no branch.
template <int kC, bool kFull>
__device__ __forceinline__ void tile_row(const float* grow, int bstride,
                                         int sh0, int sc3, const float* mrow,
                                         float* out, int ox, int W, int wb,
                                         int lane, const float* s,
                                         float* part, int nb, bool first) {
  constexpr int kChunk = kC < 8 ? kC : 8;
  for (int x = lane; x < wb; x += 64) {
    const int xb = x + 32;
    const bool has_b = xb < wb;
    const int gxa = ox + x;
    const int gxb = ox + xb;
    const bool ina = gxa >= 0 && gxa < W;
    const bool inb = has_b && gxb >= 0 && gxb < W;
    const float ma = mrow[x];
    const float mb = has_b ? mrow[xb] : 0.0f;
    float acca = first ? 0.0f : out[x];
    float accb = first || !has_b ? 0.0f : out[xb];
#pragma unroll
    for (int c0 = 0; c0 < kC; c0 += kChunk) {
      float ga[kChunk], gb[kChunk];
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        const int c = c0 + i;
        if (c >= kC) break;  // the last chunk of kC bands
        const float* g = grow + c * bstride + ((sh0 + c * sc3) & 3);
        const bool on = kFull || c < nb;
        ga[i] = ina && on ? g[gxa] : 0.0f;
        gb[i] = inb && on ? g[gxb] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        const int c = c0 + i;
        if (c >= kC) break;
        const float ta = __fmul_rn(s[c], ga[i]);
        const float tb = __fmul_rn(s[c], gb[i]);
        acca = c == 0 && first ? ta : __fadd_rn(acca, ta);
        accb = c == 0 && first ? tb : __fadd_rn(accb, tb);
        // a missing pixel b adds 0 * 0
        part[c] = __fmaf_rn(gb[i], mb, __fmaf_rn(ga[i], ma, part[c]));
      }
    }
    if (!GRAD_SKIP(8)) {
      out[x] = acca;
      if (has_b) out[xb] = accb;
    }
  }
}

// The window rows of one warp outside the gradient, [y0, y1) with y % R
// == r: every g reads 0, so every g_morph is the chain zero of sed_c * 0
// (one value a component, carried across band groups in the caller), and
// g_sed gains 0 * m, which is 0 unless m is not finite.  The morphology is
// read only into that test, the rows' pixels as one sequence, 8 loads a
// lane issued before any is used.
__device__ __forceinline__ float outside_rows(const float* mk, float* gm,
                                              int y0, int y1, int r, int R,
                                              int wb, int lane, float zero,
                                              float nonfinite) {
  const int yf = first_row(y0, r, R);
  const int total = yf < y1 ? (y1 - yf + R - 1) / R * wb : 0;
  for (int k0 = 0; k0 < total; k0 += 8 * 32) {
    float m[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int k = k0 + u * 32 + lane;
      const int q = k / wb;
      const int at = (yf + q * R) * wb + k - q * wb;
      m[u] = k < total ? __ldg(mk + at) : 0.0f;
      if (k < total) gm[at] = zero;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) nonfinite = __fmaf_rn(0.0f, m[u], nonfinite);
  }
  return nonfinite;
}

// Block (b, group): blend b, components k0 = group * G .. (< K), G =
// kWarps / R.  Dynamic shared memory (kernels.grad_geometry's smem), in
// floats, each part a multiple of 4: the two buffers' mbarriers; the
// (kWarps, NB) warp sums of g_sed; the group's origins (G, 2); two
// gradient tiles of gstride floats (NB bands of TR rows, each row a slot
// of quad(W + 3) floats holding the row at its alignment offset); two
// sets of G morphology spans of mstride floats (a tile's rows of each
// window, likewise shifted).
template <int kC, bool kFull>
__global__ void __launch_bounds__(kThreads, tile_min_blocks(kC))
grad_kernel_tiled(const float* __restrict__ grad,
                  const float* __restrict__ seds,
                  const float* __restrict__ morphs,
                  const int* __restrict__ origins,
                  float* __restrict__ g_seds, float* __restrict__ g_morphs,
                  int K, int C, int hb, int wb, int H, int W, int P,
                  long long sb, long long sc, long long sy, int R, int TR,
                  int NB) {
  const int G = kWarps / R;
  extern __shared__ float4 smem4[];
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(smem4);
  float* red = reinterpret_cast<float*>(smem4) + 4;
  int* org = reinterpret_cast<int*>(red + quad(kWarps * NB));
  float* gbuf = reinterpret_cast<float*>(org + quad(2 * G));
  const int Wq = quad(W + 3);
  const int gstride = NB * TR * Wq;
  const int mstride = quad(TR * wb + 3);
  float* mbuf = gbuf + 2 * gstride;
  const int npix = hb * wb;
  const int b = blockIdx.x;
  const int k0 = blockIdx.y * G;
  const int n = min(G, K - k0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long bk0 = (long long)b * K + k0;
  const float* gb = grad + b * sb;

  for (int i = threadIdx.x; i < 2 * n; i += kThreads)
    org[i] = origins[2 * bk0 + i] + P;
  if (threadIdx.x == 0) {
    mbar_init(&bars[0], kThreads);
    mbar_init(&bars[1], kThreads);
    // the barriers' initialization, visible to the bulk copy engine
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the gradient rows that any window of the group covers, in tiles
  int ylo = H, yhi = 0;
  for (int j = 0; j < n; ++j) {
    const int lo = max(org[2 * j], 0);
    const int hi = min(org[2 * j] + hb, H);
    if (lo < hi) {
      ylo = min(ylo, lo);
      yhi = max(yhi, hi);
    }
  }
  const int tiles = ylo < yhi ? (yhi - ylo + TR - 1) / TR : 0;
  const int steps = (C + NB - 1) / NB * tiles;

  // step s = (band group s / tiles, tile s % tiles) into buffer s % 2: the
  // tile's gradient rows, band by band, and each window's rows in the
  // tile, one bulk copy each, dealt out to the threads; every thread
  // arrives on the buffer's mbarrier with the bytes of its own copies
  auto stage = [&](int s) {
    const int c0 = s / tiles * NB;
    const int nb = min(NB, C - c0);
    const int r0 = ylo + s % tiles * TR;
    const int rows = min(r0 + TR, yhi) - r0;
    const int buf = s & 1;
    unsigned bytes = 0;
    for (int i = threadIdx.x; i < nb * rows + n; i += kThreads) {
      if (i < nb * rows) {
        const int c = i / rows;
        const int y = i - c * rows;
        bytes += bulk_span(gbuf + buf * gstride + (c * TR + y) * Wq,
                           gb + (c0 + c) * sc + (r0 + y) * sy, W,
                           &bars[buf]);
        continue;
      }
      const int j = i - nb * rows;
      const int oy = org[2 * j];
      const int ys = max(max(0, -oy), r0 - oy);
      const int ye = min(min(hb, H - oy), r0 + rows - oy);
      if (ys < ye)
        bytes += bulk_span(mbuf + (buf * G + j) * mstride,
                           morphs + (bk0 + j) * npix + ys * wb,
                           (ye - ys) * wb, &bars[buf]);
    }
    mbar_arrive_tx(&bars[buf], bytes);
  };

  // this warp's component j, and its rows y % R == r
  const int j = warp / R;
  const int r = warp % R;
  const bool active = j < n;
  const int oy = active ? org[2 * j] : 0;
  const int ox = active ? org[2 * j + 1] : 0;
  // the window rows inside the gradient: [ya, yb)
  const int ya = min(max(-oy, 0), hb);
  const int yb = max(min(H - oy, hb), ya);
  const float* mk = morphs + (bk0 + j) * npix;
  float* gm = g_morphs + (bk0 + j) * npix;

  if (steps > 0 && !GRAD_SKIP(4)) stage(0);
  int s = 0;
  float zero = 0.0f;  // g_morph outside the gradient
  for (int c0 = 0; c0 < C; c0 += NB) {
    const int nb = min(NB, C - c0);
    const bool first = c0 == 0;
    float sv[kC], part[kC];
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      sv[c] = !(active && c < nb) ? -0.0f : seds[(bk0 + j) * C + c0 + c];
      part[c] = 0.0f;
    }
    // the rows outside the gradient, while the first tile's copy is in
    // flight: g_morph there continues the chain of sed_c * 0 (zero), g_sed
    // gains 0 (or NaN where a morphology value is not finite)
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const float t = __fmul_rn(sv[c], 0.0f);
      zero = c == 0 && first ? t : __fadd_rn(zero, t);
    }
    if (active && !GRAD_SKIP(2)) {
      float nonfinite = outside_rows(mk, gm, 0, ya, r, R, wb, lane, zero,
                                     0.0f);
      nonfinite = outside_rows(mk, gm, yb, hb, r, R, wb, lane, zero,
                               nonfinite);
#pragma unroll
      for (int c = 0; c < kC; ++c) part[c] = __fadd_rn(part[c], nonfinite);
    }
    for (int t = 0; t < tiles; ++t, ++s) {
      // buffer (s + 1) % 2 was last read in step s - 1, before the
      // barrier that ended it: order those reads before the bulk writes
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      if (s + 1 < steps && !GRAD_SKIP(4)) stage(s + 1);
      if (!GRAD_SKIP(4)) mbar_wait(&bars[s & 1], (s >> 1) & 1);
      const int r0 = ylo + t * TR;
      const int ys = max(ya, r0 - oy);
      const int ye = min(yb, min(r0 + TR, yhi) - oy);
      if (active && ys < ye && !GRAD_SKIP(1)) {
        const int buf = s & 1;
        const float* gt = gbuf + buf * gstride;
        const float* mt = mbuf + (buf * G + j) * mstride +
                          float_shift(mk + ys * wb);
        const int sc3 = (int)(sc & 3);
        for (int y = first_row(ys, r, R); y < ye; y += R) {
          const int row = oy + y;
          tile_row<kC, kFull>(gt + (row - r0) * Wq, TR * Wq,
                       float_shift(gb + c0 * sc + row * sy), sc3,
                       mt + (y - ys) * wb, gm + y * wb, ox, W, wb, lane, sv,
                       part, nb, first);
        }
      }
      // buffer s % 2 takes step s + 2's copy in the next iteration
      __syncthreads();
    }
    // g_sed of the group's bands: each warp's lanes in a fixed tree, then
    // the R warps of a component in order
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      if (c < nb) {
        const float v = warp_sum(part[c]);
        if (lane == 0) red[warp * NB + c] = v;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n * nb; i += kThreads) {
      const int jj = i / nb;
      const int c = i - jj * nb;
      float v = red[jj * R * NB + c];
      for (int q = 1; q < R; ++q)
        v = __fadd_rn(v, red[(jj * R + q) * NB + c]);
      g_seds[(bk0 + jj) * C + c0 + c] = v;
    }
    // red takes the next group's sums
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// Launch and dispatch
// ---------------------------------------------------------------------------

struct Args {
  const float* grad;
  const float* seds;
  const float* morphs;
  const int* origins;
  float* g_seds;
  float* g_morphs;
  int B, K, C, hb, wb, H, W, P;
  long long sb, sc, sy;
  int G, groups, smem, R, TR, NB, vec;
  cudaStream_t stream;
};

// Each instantiation keeps its own record of the shared memory granted
// (the kernels of a route share one function type).
template <int kC>
struct Staged {
  static int launch(const Args& a) {
    static int granted[scarlet::kMaxDevices] = {};
    const int err =
        scarlet::grant_smem(grad_kernel_staged<kC>, a.smem, granted);
    if (err != 0) return err;
    grad_kernel_staged<kC>
        <<<dim3(a.B, a.groups), kThreads, a.smem, a.stream>>>(
        a.grad, a.seds, a.morphs, a.origins, a.g_seds, a.g_morphs, a.K, a.hb,
        a.wb, a.H, a.W, a.P, a.sb, a.sc, a.sy, a.G, a.vec);
    return (int)cudaGetLastError();
  }
  static int info(int smem, int* out) {
    return scarlet::kernel_info(grad_kernel_staged<kC>, kThreads, smem,
                                out);
  }
};

template <int kC, bool kFull>
struct Tiled {
  static int launch(const Args& a) {
    static int granted[scarlet::kMaxDevices] = {};
    const int err =
        scarlet::grant_smem(grad_kernel_tiled<kC, kFull>, a.smem, granted);
    if (err != 0) return err;
    grad_kernel_tiled<kC, kFull>
        <<<dim3(a.B, a.groups), kThreads, a.smem, a.stream>>>(
        a.grad, a.seds, a.morphs, a.origins, a.g_seds, a.g_morphs, a.K, a.C,
        a.hb, a.wb, a.H, a.W, a.P, a.sb, a.sc, a.sy, a.R, a.TR, a.NB);
    return (int)cudaGetLastError();
  }
  static int info(int smem, int* out) {
    return scarlet::kernel_info(grad_kernel_tiled<kC, kFull>, kThreads,
                                smem, out);
  }
};

// call(F{}) for the instantiation F of a route: Staged<C> (C = 1 ..
// kStagedC), or for the tiled route's band group NB of C bands,
// Tiled<tile_bands(NB), true> where every group fills it (NB ==
// tile_bands(NB) and NB divides C), else Tiled<max(tile_bands(NB), 16),
// false>.
template <typename Call>
int dispatch(int staged, int C, int NB, Call call) {
  if (staged) {
    switch (C) {
#define SCARLET_STAGED(c) \
  case c: return call(Staged<c>{});
      SCARLET_STAGED(1) SCARLET_STAGED(2) SCARLET_STAGED(3) SCARLET_STAGED(4)
      SCARLET_STAGED(5) SCARLET_STAGED(6) SCARLET_STAGED(7) SCARLET_STAGED(8)
#undef SCARLET_STAGED
    }
    return (int)cudaErrorInvalidValue;
  }
  if (NB < 1 || NB > kTileC || NB > C) return (int)cudaErrorInvalidValue;
  const int kC = tile_bands(NB);
  if (kC == NB && C % NB == 0) {
    switch (kC) {
#define SCARLET_FULL(c) \
  case c: return call(Tiled<c, true>{});
      SCARLET_FULL(1) SCARLET_FULL(2) SCARLET_FULL(3) SCARLET_FULL(4)
      SCARLET_FULL(5) SCARLET_FULL(6) SCARLET_FULL(7) SCARLET_FULL(8)
      SCARLET_FULL(9) SCARLET_FULL(10) SCARLET_FULL(11) SCARLET_FULL(12)
      SCARLET_FULL(13) SCARLET_FULL(14) SCARLET_FULL(15) SCARLET_FULL(16)
      SCARLET_FULL(24) SCARLET_FULL(32) SCARLET_FULL(40) SCARLET_FULL(48)
      SCARLET_FULL(56) SCARLET_FULL(64)
#undef SCARLET_FULL
    }
    return (int)cudaErrorInvalidValue;
  }
  switch (kC < 16 ? 16 : kC) {
#define SCARLET_PART(c) \
  case c: return call(Tiled<c, false>{});
    SCARLET_PART(16) SCARLET_PART(24) SCARLET_PART(32) SCARLET_PART(40)
    SCARLET_PART(48) SCARLET_PART(56) SCARLET_PART(64)
#undef SCARLET_PART
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// grad: B blends of (C, H, W) at element strides (sb, sc, sy, 1), the
// window of component k at (origins[k] + P); seds: (B, K, C); morphs:
// (B, K, hb, wb); origins: (B, K, 2) int32; g_seds: (B, K, C); g_morphs:
// (B, K, hb, wb), all but grad contiguous.  staged, G, groups, smem and,
// on the tiled route, R, TR, NB: kernels.grad_geometry.  C >= 1.
extern "C" int scarlet_grad_gather(const float* grad, const float* seds,
                                   const float* morphs, const int* origins,
                                   float* g_seds, float* g_morphs, int B,
                                   int K, int C, int hb, int wb, int H, int W,
                                   int P, long long sb, long long sc,
                                   long long sy, int staged, int G,
                                   int groups, int smem, int R, int TR,
                                   int NB, void* stream) {
  if (C < 1 || G < 1 || (long long)groups * G < K || groups > 65535)
    return (int)cudaErrorInvalidValue;
  if (!staged && (R < 1 || R * G != kWarps || TR < 1 || NB < 1 || NB > C))
    return (int)cudaErrorInvalidValue;
  const int vec = sc % 4 == 0 && sy % 4 == 0 && W % 4 == 0;
  const Args a{grad, seds, morphs, origins, g_seds, g_morphs, B, K, C, hb,
               wb, H, W, P, sb, sc, sy, G, groups, smem, R, TR, NB, vec,
               (cudaStream_t)stream};
  return dispatch(staged, C, NB,
                  [&](auto f) { return decltype(f)::launch(a); });
}

// The instantiation's out[3], as scarlet::kernel_info: the staged route's
// for C bands, or the tiled route's for C bands in groups of NB.
extern "C" int scarlet_grad_kernel_info(int staged, int C, int NB, int smem,
                                        int* out) {
  return dispatch(staged, C, NB,
                  [&](auto f) { return decltype(f)::info(smem, out); });
}

#ifdef SCARLET_GRAD_PARTS
extern "C" int scarlet_grad_set_parts(int bits) {
  return (int)cudaMemcpyToSymbol(kParts, &bits, sizeof(int));
}
#endif
