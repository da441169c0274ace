// Microkernel variants of the monotonicity pass (K1's Jacobi loop), for
// attributing its per-pass cost on Hopper (sm_90a).
//
// Replaces the TPU kernel of tools/mono_pass_attrib.py (`make_kernel`,
// compiled by `build` through `pl.pallas_call` at :193): seven instruction
// mixes of one pass, run at a forced pass count so that the time's slope
// over the pass count is the cost of one pass.  Measurement scaffolding
// only, never a production path.
//
// Layout: the lane-packed (B, hb, K*wb) stack of the TPU tool; slot k of
// blend b is the morphology in columns [k*wb, (k+1)*wb).  One thread block
// owns one morphology, as K1's mono_kernel does, and reads its slot of the
// per-slot tables wsel (8, hb, K*wb) and keepsel (hb, K*wb), which the
// caller gathers once.  On Hopper there are no rolls, so the tables are not
// pre-shifted as the TPU tool's are: w[d] is read at the pixel it weights.
//
// The mixes, each on the same on-chip copy as K1 (mono.cu, mono_passes):
//   full       K1's pass: 8 bounds-checked neighbour loads from shared
//              memory, x <- keep ? x0 : min(x0, sum_d w_d x(p + off_d)),
//              and a __syncthreads_or convergence test every 4 passes.
//              The test compares |new - old| with `never` (-1): it never
//              exits, so the pass count is forced;
//   noreduce   the same pass, a counter-only loop: no test, a plain
//              __syncthreads after every pass;
//   unroll8    the test every 8 passes;
//   norolls    full's arithmetic with all 8 taps reading the thread's own
//              pixel: no neighbour loads (neighbour cost = full - norolls);
//   rollsonly  4 neighbour loads, 3 adds and 1 multiply,
//              (x[y-1] + x[y+1] + x[x-1] + x[x+1]) * 0.25, zero outside the
//              box: neighbour traffic with no stencil;
//   alu8       8 chained fused multiply-adds, acc = fma(acc, 0.5, w_d);
//   bf16       norolls in __nv_bfloat162 packed math (8 multiplies and
//              8 adds, as norolls), two pixels per thread and instruction, planes stored in bf16 (half the
//              shared memory, so two blocks fit an SM where the f32 mixes
//              fit one).
//
// What bounds it: the same as K1, shared-memory loads and the barrier
// between passes, with one 512-thread block per SM at box 59 (167 KB);
// the variants exist to split that cost.  Rounding: the f32 stencil mixes
// round each product and sum on its own (__fmul_rn, __fadd_rn), in
// NEIGHBOR_OFFSETS order, so they equal their plain PyTorch versions bit
// for bit; alu8's multiply by 0.5 is exact, so its fused multiply-add
// rounds as the plain version's two operations do (barring subnormals);
// bf16's mul.rn/add.rn.bf16x2 round each exact result to bf16 once, and
// so does the plain version (in float64, then to the nearest bf16:
// PyTorch's own bf16 operations round a float32 sum, a double rounding in
// rare sums, and with weights summing to ~1 a pixel that parts once
// drifts by several bf16 units over 8 passes).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

enum Mix {
  kFull = 0,
  kNoReduce = 1,
  kUnroll8 = 2,
  kNoRolls = 3,
  kRollsOnly = 4,
  kAlu8 = 5,
  kBf16 = 6,
};

__constant__ int kOffY[8] = {-1, -1, -1, 0, 0, 1, 1, 1};
__constant__ int kOffX[8] = {-1, 0, 1, -1, 1, -1, 0, 1};

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

int threads_for(int n) {
  int threads = ((n + 31) / 32) * 32;
  return threads > 512 ? 512 : threads;
}

template <int MIX>
__global__ void __launch_bounds__(512)
f32_kernel(const float* __restrict__ x, float* __restrict__ out,
           const float* __restrict__ wsel, const float* __restrict__ keepsel,
           int K, int hb, int wb, int n_passes, float never) {
  constexpr bool kReduce = MIX != kNoReduce;
  constexpr int kUnroll = MIX == kUnroll8 ? 8 : 4;
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  const int npix = hb * wb;
  const long long gw = (long long)K * wb;
  float* w = reinterpret_cast<float*>(dyn_smem);
  float* x0 = w + 8 * npix;
  float* keep = x0 + npix;
  float* cur = keep + npix;
  float* nxt = cur + npix;

  const long long b = blockIdx.x / K;
  const int k = blockIdx.x - (int)b * K;
  const long long base = b * hb * gw + (long long)k * wb;
  for (int p = threadIdx.x; p < npix; p += blockDim.x) {
    const int py = p / wb;
    const int px = p - py * wb;
    const long long q = py * gw + (long long)k * wb + px;
#pragma unroll
    for (int d = 0; d < 8; ++d) w[d * npix + p] = wsel[d * hb * gw + q];
    keep[p] = keepsel[q];
    const float v = x[base + py * gw + px];
    x0[p] = v;
    cur[p] = v;
  }
  __syncthreads();

  int t = 0;
  int go = 1;
  while (go && t < n_passes) {
    int flag = 0;
    for (int u = 0; u < kUnroll; ++u) {
      for (int p = threadIdx.x; p < npix; p += blockDim.x) {
        const int py = p / wb;
        const int px = p - py * wb;
        float v;
        if constexpr (MIX == kRollsOnly) {
          const float up = py > 0 ? cur[p - wb] : 0.0f;
          const float down = py < hb - 1 ? cur[p + wb] : 0.0f;
          const float left = px > 0 ? cur[p - 1] : 0.0f;
          const float right = px < wb - 1 ? cur[p + 1] : 0.0f;
          v = __fmul_rn(__fadd_rn(__fadd_rn(__fadd_rn(up, down), left),
                                  right),
                        0.25f);
        } else if constexpr (MIX == kAlu8) {
          float acc = cur[p];
#pragma unroll
          for (int d = 0; d < 8; ++d)
            acc = __fmaf_rn(acc, 0.5f, w[d * npix + p]);
          v = acc;
        } else {
          float ref = 0.0f;
          if constexpr (MIX == kNoRolls) {
            const float c = cur[p];
#pragma unroll
            for (int d = 0; d < 8; ++d)
              ref = __fadd_rn(ref, __fmul_rn(w[d * npix + p], c));
          } else {
#pragma unroll
            for (int d = 0; d < 8; ++d) {
              const int ny = py + kOffY[d];
              const int nx = px + kOffX[d];
              const float nv = (ny >= 0 && ny < hb && nx >= 0 && nx < wb)
                                   ? cur[ny * wb + nx] : 0.0f;
              ref = __fadd_rn(ref, __fmul_rn(w[d * npix + p], nv));
            }
          }
          const float a = x0[p];
          v = keep[p] > 0.5f ? a : fminf(a, ref);
        }
        nxt[p] = v;
        if (kReduce && u == kUnroll - 1) flag |= fabsf(v - cur[p]) > never;
      }
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
      if (!kReduce || u < kUnroll - 1) __syncthreads();
    }
    if constexpr (kReduce) go = __syncthreads_or(flag);
    t += kUnroll;
  }

  for (int p = threadIdx.x; p < npix; p += blockDim.x) {
    const int py = p / wb;
    const int px = p - py * wb;
    out[base + py * gw + px] = cur[p];
  }
}

// norolls in packed bf16: pixel pair q holds flat pixels 2q and 2q + 1 of
// the morphology (an odd last pair is padded with a kept zero pixel).
__global__ void __launch_bounds__(512)
bf16_kernel(const float* __restrict__ x, float* __restrict__ out,
            const float* __restrict__ wsel,
            const float* __restrict__ keepsel, int K, int hb, int wb,
            int n_passes, float never) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  const int npix = hb * wb;
  const int nq = (npix + 1) / 2;
  const long long gw = (long long)K * wb;
  __nv_bfloat162* w = reinterpret_cast<__nv_bfloat162*>(dyn_smem);
  __nv_bfloat162* x0 = w + 8 * nq;
  __nv_bfloat162* cur = x0 + nq;
  __nv_bfloat162* nxt = cur + nq;
  unsigned char* keep = reinterpret_cast<unsigned char*>(nxt + nq);

  const long long b = blockIdx.x / K;
  const int k = blockIdx.x - (int)b * K;
  const long long base = b * hb * gw + (long long)k * wb;
  for (int q = threadIdx.x; q < nq; q += blockDim.x) {
    float wv[2][8], kv[2], xv[2];
    for (int h = 0; h < 2; ++h) {
      const int p = 2 * q + h;
      if (p < npix) {
        const int py = p / wb;
        const int px = p - py * wb;
        const long long s = py * gw + (long long)k * wb + px;
        for (int d = 0; d < 8; ++d) wv[h][d] = wsel[d * hb * gw + s];
        kv[h] = keepsel[s];
        xv[h] = x[base + py * gw + px];
      } else {
        for (int d = 0; d < 8; ++d) wv[h][d] = 0.0f;
        kv[h] = 1.0f;
        xv[h] = 0.0f;
      }
    }
    for (int d = 0; d < 8; ++d)
      w[d * nq + q] = __floats2bfloat162_rn(wv[0][d], wv[1][d]);
    keep[q] = (kv[0] > 0.5f ? 1 : 0) | (kv[1] > 0.5f ? 2 : 0);
    const __nv_bfloat162 v = __floats2bfloat162_rn(xv[0], xv[1]);
    x0[q] = v;
    cur[q] = v;
  }
  __syncthreads();

  int t = 0;
  int go = 1;
  while (go && t < n_passes) {
    int flag = 0;
    for (int u = 0; u < 4; ++u) {
      for (int q = threadIdx.x; q < nq; q += blockDim.x) {
        const __nv_bfloat162 c = cur[q];
        __nv_bfloat162 ref = __float2bfloat162_rn(0.0f);
#pragma unroll
        for (int d = 0; d < 8; ++d)
          ref = add_rn(ref, mul_rn(w[d * nq + q], c));
        const __nv_bfloat162 a = x0[q];
        const __nv_bfloat162 m = __hmin2(a, ref);
        const unsigned char kq = keep[q];
        const __nv_bfloat162 v = __halves2bfloat162(
            (kq & 1) ? __low2bfloat16(a) : __low2bfloat16(m),
            (kq & 2) ? __high2bfloat16(a) : __high2bfloat16(m));
        nxt[q] = v;
        if (u == 3) {
          const float2 fv = __bfloat1622float2(v);
          const float2 fc = __bfloat1622float2(c);
          flag |= (fabsf(fv.x - fc.x) > never) | (fabsf(fv.y - fc.y) > never);
        }
      }
      __nv_bfloat162* tmp = cur;
      cur = nxt;
      nxt = tmp;
      if (u < 3) __syncthreads();
    }
    go = __syncthreads_or(flag);
    t += 4;
  }

  for (int q = threadIdx.x; q < nq; q += blockDim.x) {
    const float2 v = __bfloat1622float2(cur[q]);
    for (int h = 0; h < 2; ++h) {
      const int p = 2 * q + h;
      if (p < npix) {
        const int py = p / wb;
        const int px = p - py * wb;
        out[base + py * gw + px] = h ? v.y : v.x;
      }
    }
  }
}

typedef void (*VariantKernel)(const float*, float*, const float*,
                              const float*, int, int, int, int, float);

VariantKernel variant_kernel(int mix) {
  switch (mix) {
    case kFull: return f32_kernel<kFull>;
    case kNoReduce: return f32_kernel<kNoReduce>;
    case kUnroll8: return f32_kernel<kUnroll8>;
    case kNoRolls: return f32_kernel<kNoRolls>;
    case kRollsOnly: return f32_kernel<kRollsOnly>;
    case kAlu8: return f32_kernel<kAlu8>;
    case kBf16: return bf16_kernel;
    default: return nullptr;
  }
}

}  // namespace

// Dynamic shared memory of one block of mix `mix` at box (hb, wb); -1 for
// an unknown mix.
extern "C" int scarlet_mono_pass_variant_smem_bytes(int mix, int hb,
                                                    int wb) {
  if (mix < kFull || mix > kBf16) return -1;
  const int npix = hb * wb;
  if (mix == kBf16) {
    const int nq = (npix + 1) / 2;
    return 11 * nq * (int)sizeof(__nv_bfloat162) + nq;
  }
  return 12 * npix * (int)sizeof(float);
}

// x, out: (B, hb, K*wb) contiguous; wsel: (8, hb, K*wb); keepsel:
// (hb, K*wb); mix: the Mix above.  Runs ceil(n_passes / unroll) blocks of
// unroll passes (unroll 8 for kUnroll8, else 4).
extern "C" int scarlet_mono_pass_variant(const float* x, float* out,
                                         const float* wsel,
                                         const float* keepsel, int B, int K,
                                         int hb, int wb, int mix,
                                         int n_passes, float never,
                                         void* stream) {
  const VariantKernel kernel = variant_kernel(mix);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  const int smem = scarlet_mono_pass_variant_smem_bytes(mix, hb, wb);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int work = mix == kBf16 ? (hb * wb + 1) / 2 : hb * wb;
  kernel<<<B * K, threads_for(work), smem, (cudaStream_t)stream>>>(
      x, out, wsel, keepsel, K, hb, wb, n_passes, never);
  return (int)cudaGetLastError();
}
