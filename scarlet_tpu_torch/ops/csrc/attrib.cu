// Instruction mixes of the monotonicity pass (K1's Jacobi loop), for
// attributing its per-pass cost on Hopper (sm_90a).
//
// Replaces the TPU kernel of tools/mono_pass_attrib.py (`make_kernel`,
// compiled by `build` through `pl.pallas_call` at :193): seven instruction
// mixes of one pass, run at a forced pass count so that the time's slope
// over the pass count is the cost of one pass.  Measurement scaffolding
// only, never a production path.
//
// Layout: the lane-packed (B, hb, K*hb) stack of the TPU tool; slot k of
// blend b is the morphology in columns [k*hb, (k+1)*hb), read and written
// in place through the strides K2 (`monotonic_prox_packed`) uses.  The
// wrapper turns the per-slot tables wsel (8, hb, K*hb) and keepsel
// (hb, K*hb) into K1's compact taps once per table (kernels.mono_taps,
// slot k as candidate k), and one block owns one morphology with K1's
// launch geometry (kernels.mono_geometry).
//
// Every f32 mix runs K1's pass engine (mono.cuh: the taps in registers,
// the zero-bordered halo tiles, the 2-D thread map, mono_passes), so each
// differs from K1's pass (mono.cu, mono_kernel) only in what it ablates:
//   full       K1's pass; its test every 4 passes is computed and never
//              exits, so the pass count is forced;
//   noreduce   no test: a __syncthreads after every pass
//              (the test = full - noreduce);
//   unroll8    the test every 8 passes;
//   norolls    every tap reads the thread's own pixel: no neighbour loads
//              (the neighbour loads = full - norolls);
//   rollsonly  (up + down + left + right) * 0.25 from the halo tile, no
//              taps and no x0: neighbour traffic with no stencil;
//   alu8       8 chained fused multiply-adds, acc = fma(acc, 0.5, w_d),
//              with the 8 dense weights of each pixel in registers (taps
//              of every direction, T = 8, as the wrapper builds them for
//              this mix: the compact taps skip zero weights, which would
//              change the result);
//   bf16       norolls in __nv_bfloat162 (bf16_kernel below): two of a
//              thread's slots per instruction, the tiles in bf16.
//
// What bounds it: K1's pass (mono.cu): the float32 issue of the taps and
// the barrier between passes, one block per morphology.  Rounding: the f32
// mixes round as K1 does (each product and sum on its own, the nonzero
// taps in d order), so full, noreduce, unroll8 and norolls equal their
// plain PyTorch versions bit for bit for finite inputs, and so does
// rollsonly; alu8's multiply by 0.5 is exact, so its fused multiply-add
// rounds as the plain version's two operations do (barring subnormals);
// bf16's mul.rn/add.rn.bf16x2 round each exact result to bf16 once, and
// so does the plain version (in float64, then to the nearest bf16:
// PyTorch's own bf16 operations round a float32 sum, a double rounding in
// rare sums, and with weights summing to ~1 a pixel that parts once
// drifts by several bf16 units over 8 passes).  A zero weight adds +-0 to
// the sum, so bf16's compact taps keep its bits too.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "launch.cuh"
#include "mono.cuh"

namespace {

using scarlet::Geom;
using scarlet::geometry;
using scarlet::kMaxThreads;
using scarlet::kUnroll;
using scarlet::load_taps;
using scarlet::load_x;
using scarlet::mono_passes;
using scarlet::slot_yx;
using scarlet::Taps;
using scarlet::set_smem;

// bf16x2 multiply and add, each rounded on its own (explicit .rn: with
// the __hmul2/__hadd2 of cuda_bf16.h the results were those of fused
// multiply-adds, up to 6 bf16 units off after 8 passes)
__device__ __forceinline__ __nv_bfloat162 mul_rn(__nv_bfloat162 a,
                                                 __nv_bfloat162 b) {
  unsigned d;
  asm("{ mul.rn.bf16x2 %0, %1, %2; }\n"
      : "=r"(d)
      : "r"(*reinterpret_cast<unsigned*>(&a)),
        "r"(*reinterpret_cast<unsigned*>(&b)));
  return *reinterpret_cast<__nv_bfloat162*>(&d);
}

__device__ __forceinline__ __nv_bfloat162 add_rn(__nv_bfloat162 a,
                                                 __nv_bfloat162 b) {
  unsigned d;
  asm("{ add.rn.bf16x2 %0, %1, %2; }\n"
      : "=r"(d)
      : "r"(*reinterpret_cast<unsigned*>(&a)),
        "r"(*reinterpret_cast<unsigned*>(&b)));
  return *reinterpret_cast<__nv_bfloat162*>(&d);
}

__device__ __forceinline__ unsigned bits(__nv_bfloat162 v) {
  return *reinterpret_cast<unsigned*>(&v);
}

// The f32 mixes: mono_kernel's block on slot k of blend b, with slot k's
// taps, at scale 1 and tol 0.
template <int MIX, int T, int P>
__global__ void __launch_bounds__(kMaxThreads)
mix_kernel(const float* __restrict__ x, float* __restrict__ out,
           const float* __restrict__ tw, const int* __restrict__ tcode,
           const int* __restrict__ centers, int K, int hb, int n_passes,
           int ny, int tr) {
  extern __shared__ float smem[];
  const Geom g = geometry(hb, hb, ny, tr);
  const int plane = (hb + 2) * g.W2;
  const long long b = blockIdx.x / K;
  const int k = blockIdx.x - (int)b * K;
  const long long gw = (long long)K * hb;
  const long long off = b * hb * gw + (long long)k * hb;

  Taps<T, P> tp;
  load_taps(tp, g, tw, tcode, centers, k, hb, hb);
  load_x(g, smem, plane, x + off, gw, 1);
  __syncthreads();

  const float* res = mono_passes<T, P, MIX>(
      tp, g, smem, smem + plane, smem + 2 * plane, n_passes, 1.0f, 0.0f);

  for (int j = 0; j < g.n; ++j) {
    int y, xx;
    slot_yx(g, j, y, xx);
    out[off + y * gw + xx] = res[g.own0 + j * g.step];
  }
}

// bf16: norolls on slot pairs.  Pair m of a thread holds its slots 2m (low
// half) and 2m + 1 (high half) at index m * blockDim.x + threadIdx.x of
// each bf16x2 tile (cur, next, x0); a slot past the thread's last holds 0
// with weight 0 and is never written out.
template <int T, int P>
__global__ void __launch_bounds__(kMaxThreads)
bf16_kernel(const float* __restrict__ x, float* __restrict__ out,
            const float* __restrict__ tw, const int* __restrict__ tcode,
            const int* __restrict__ centers, int K, int hb, int n_passes,
            int ny, int tr) {
  static_assert(P % 2 == 0, "slots pair up");
  constexpr int Q = P / 2;
  extern __shared__ __align__(16) unsigned char bsmem[];
  __nv_bfloat162* tiles = reinterpret_cast<__nv_bfloat162*>(bsmem);
  const int nt = blockDim.x;
  __nv_bfloat162* cur = tiles;
  __nv_bfloat162* nxt = tiles + Q * nt;
  __nv_bfloat162* x0s = tiles + 2 * Q * nt;
  const Geom g = geometry(hb, hb, ny, tr);
  const long long b = blockIdx.x / K;
  const int k = blockIdx.x - (int)b * K;
  const long long gw = (long long)K * hb;
  const long long off = b * hb * gw + (long long)k * hb;

  Taps<T, P> tp;
  load_taps(tp, g, tw, tcode, centers, k, hb, hb);
  __nv_bfloat162 w2[Q][T];
#pragma unroll
  for (int m = 0; m < Q; ++m) {
#pragma unroll
    for (int t = 0; t < T; ++t)
      w2[m][t] = __floats2bfloat162_rn(tp.w[2 * m][t], tp.w[2 * m + 1][t]);
    float v[2] = {0.0f, 0.0f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (2 * m + h < g.n) {
        int y, xx;
        slot_yx(g, 2 * m + h, y, xx);
        v[h] = x[off + y * gw + xx];
      }
    }
    const __nv_bfloat162 p = __floats2bfloat162_rn(v[0], v[1]);
    cur[m * nt + threadIdx.x] = p;
    x0s[m * nt + threadIdx.x] = p;
  }
  __syncthreads();

  int t = 0;
  int changed = 1;
  while (changed && t < n_passes) {
    int flag = 0;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      int q = threadIdx.x, n = g.n;
      asm volatile("" : "+r"(q), "+r"(n));
#pragma unroll
      for (int m = 0; m < Q; ++m, q += nt) {
        if (2 * m < n) {
          const __nv_bfloat162 c = cur[q];
          __nv_bfloat162 ref = __float2bfloat162_rn(0.0f);
#pragma unroll
          for (int s = 0; s < T; ++s) ref = add_rn(ref, mul_rn(w2[m][s], c));
          const __nv_bfloat162 a = x0s[q];
          const __nv_bfloat162 mn = __hmin2(a, ref);
          const __nv_bfloat162 v = __halves2bfloat162(
              2 * m == tp.keep_j ? __low2bfloat16(a) : __low2bfloat16(mn),
              2 * m + 1 == tp.keep_j ? __high2bfloat16(a)
                                     : __high2bfloat16(mn));
          nxt[q] = v;
          if (u == kUnroll - 1) flag |= bits(v) != bits(c);
        }
      }
      __nv_bfloat162* tmp = cur;
      cur = nxt;
      nxt = tmp;
      if (u < kUnroll - 1) __syncthreads();
    }
    changed = __syncthreads_or(flag);
    asm volatile("" : : "r"(changed));  // computed, never exits
    changed = 1;
    t += kUnroll;
  }

  for (int j = 0; j < g.n; ++j) {
    int y, xx;
    slot_yx(g, j, y, xx);
    const __nv_bfloat162 v = cur[(j / 2) * nt + threadIdx.x];
    out[off + y * gw + xx] =
        __bfloat162float(j % 2 ? __high2bfloat16(v) : __low2bfloat16(v));
  }
}

template <int MIX, int T, int P>
int launch(const float* x, float* out, const float* tw, const int* tcode,
           const int* centers, int B, int K, int hb, int n_passes, int ny,
           int tr, int threads, cudaStream_t stream) {
  if constexpr (MIX == scarlet::kBf16) {
    const int smem = 3 * (P / 2) * threads * (int)sizeof(__nv_bfloat162);
    const int err = set_smem(bf16_kernel<T, P>, smem);
    if (err != 0) return err;
    bf16_kernel<T, P><<<B * K, threads, smem, stream>>>(
        x, out, tw, tcode, centers, K, hb, n_passes, ny, tr);
  } else {
    const int smem = 3 * (hb + 2) * (hb + 2) * (int)sizeof(float);
    const int err = set_smem(mix_kernel<MIX, T, P>, smem);
    if (err != 0) return err;
    mix_kernel<MIX, T, P><<<B * K, threads, smem, stream>>>(
        x, out, tw, tcode, centers, K, hb, n_passes, ny, tr);
  }
  return (int)cudaGetLastError();
}

// The (T, P) instantiations of a mix (kernels.MONO_SLOTS); alu8 reads
// dense taps, T = 8 only.
template <int MIX, typename... A>
int dispatch(int T, int P, A... a) {
  if constexpr (MIX != scarlet::kAlu8) {
    if (T == 4) {
      if (P == 4) return launch<MIX, 4, 4>(a...);
      if (P == 8) return launch<MIX, 4, 8>(a...);
      if (P == 12) return launch<MIX, 4, 12>(a...);
    }
  }
  if (T == 8) {
    if (P == 4) return launch<MIX, 8, 4>(a...);
    if (P == 8) return launch<MIX, 8, 8>(a...);
    if (P == 12) return launch<MIX, 8, 12>(a...);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x, out: (B, hb, K*hb) contiguous; tw (K, hb, hb, T), tcode (K, hb, hb),
// centers (K,): the slots' taps (kernels.mono_pass_variant_taps); mix: the
// index in kernels.MONO_PASS_MIXES (scarlet::PassMix); n_passes: a whole
// number of the mix's blocks (8 passes for unroll8, else 4); P, ny, tr,
// threads: kernels.mono_geometry(hb, hb).
extern "C" int scarlet_mono_pass_variant(const float* x, float* out,
                                         const float* tw, const int* tcode,
                                         const int* centers, int B, int K,
                                         int hb, int mix, int n_passes,
                                         int T, int P, int ny, int tr,
                                         int threads, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (mix) {
    case scarlet::kFull:
      return dispatch<scarlet::kFull>(T, P, x, out, tw, tcode, centers, B,
                                      K, hb, n_passes, ny, tr, threads, s);
    case scarlet::kNoReduce:
      return dispatch<scarlet::kNoReduce>(T, P, x, out, tw, tcode, centers,
                                          B, K, hb, n_passes, ny, tr,
                                          threads, s);
    case scarlet::kUnroll8:
      return dispatch<scarlet::kUnroll8>(T, P, x, out, tw, tcode, centers,
                                         B, K, hb, n_passes, ny, tr, threads,
                                         s);
    case scarlet::kNoRolls:
      return dispatch<scarlet::kNoRolls>(T, P, x, out, tw, tcode, centers,
                                         B, K, hb, n_passes, ny, tr, threads,
                                         s);
    case scarlet::kRollsOnly:
      return dispatch<scarlet::kRollsOnly>(T, P, x, out, tw, tcode, centers,
                                           B, K, hb, n_passes, ny, tr,
                                           threads, s);
    case scarlet::kAlu8:
      return dispatch<scarlet::kAlu8>(T, P, x, out, tw, tcode, centers, B,
                                      K, hb, n_passes, ny, tr, threads, s);
    case scarlet::kBf16:
      return dispatch<scarlet::kBf16>(T, P, x, out, tw, tcode, centers, B,
                                      K, hb, n_passes, ny, tr, threads, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
