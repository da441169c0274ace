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
// only pixels inside the scene are ever computed.  The morphologies are
// read through their (blend, component, row) strides, unit column stride.
//
// What bounds it on this card: bytes.  A launch must write the B*C*H*W
// output once and read each in-scene pixel of each active component's
// morphology once (7.1 MB and at most 22.8 MB at 128 blends x 16
// components, box 59, 5 x 58 x 48); the arithmetic, 2 operations per
// band and covering pixel, is far below the card's rate, but it is
// issued as separate multiplies and adds (the plain version's rounding),
// so past 8 bands the instruction stream counts too.  A block takes one
// blend and a band of TY rows (and, for a scene wider than TX * XV, a
// tile of columns); a pixel thread owns XV consecutive x of one row (XV =
// 4 where W is a multiple of 4, so it stores a float4 per band).  Each
// block copies its blend's origins (and flags) to shared memory and one
// warp lists, in ascending k with a ballot, the active components whose
// box meets its rows and columns.  Two walks of that list
// (kernels.scene_geometry picks one from the band count):
//
// Direct walk (scene_kernel_direct; C <= 8, the one-group kernel of the
// design before the staged walk, on contiguous morphologies): one thread
// per pixel thread, holding all C bands x XV sums in registers, the
// blend's seds in shared memory; it reads each covering component's
// values from device memory itself, the loads of kBatch listed
// components in flight before it adds any of them.  Forced past 8 bands
// it would need more sums than the registers hold; at 3-8 bands the
// staged walk was slower (PERF.md).
//
// Staged walk (scene_kernel_staged; past 8 bands).  The walk before it
// kept 8 bands x XV sums a thread and, past 8 bands, walked the
// list once per group of 8 bands, one group after another in the same
// thread: each walk read the list, the origins and every covering
// morphology value again and waited out the same load latency again (at
// C = 10 the second walk did all the loads for 2 bands; at C = 40 a
// thread walked 5 times), and the threads of a launch did not grow with
// C.  This walk:
//   - the C bands split into NG = ceil(C / 8) balanced groups (10 -> 5 +
//     5, 9 -> 4 + 5, 40 -> 5 x 8) of CG or CG - 1 bands, CG the
//     instantiation;
//   - the block runs GT of the groups at once, each on its own set of P
//     pixel threads over the same pixels (GT = NG up to 16 groups, 128
//     bands): each thread walks the list once, for its group's bands.
//     Past 16 groups a thread takes its groups in turn;
//   - the listed components' values at the block's pixels are staged in
//     shared memory, S components at a time through two buffers, the
//     next S in flight (cp.async) while the current S are walked: each
//     value is read from device memory once per block, by the thread of
//     its pixel in set j % GT for the j-th component of a chunk, and
//     every set reads it from shared memory (a float4 where XV = 4).  A
//     value outside the component's box is staged as 0, so the walk adds
//     sed * 0 = +-0 there, which leaves a sum's bits as they were (it is
//     never -0): no box test in the walk.  The chunk's seds of each
//     set's group go beside the values (loaded while the chunk before is
//     walked); where one of them is not finite (sed * 0 would be NaN),
//     the block walks that chunk with the box tests;
//   - shared memory holds the two buffers, the origins, the list and the
//     flags, not the (K, C) seds: its limit, 12 K + K / 4 bytes beside
//     the buffers, is wider than the 4 K (3 + C) of the design before it
//     at every K and C.
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

constexpr int kBands = 8;           // kernels.SCENE_BANDS
constexpr int kMaxThreads = 512;    // kernels.SCENE_THREADS
constexpr int kMinBlocks = 2;       // a register budget of 64 a thread
constexpr int kDirectThreads = 128;  // kernels.SCENE_DIRECT_THREADS
constexpr int kChunk = 8;           // kernels.SCENE_CHUNK
constexpr int kBatch = 4;           // the direct walk: loads in flight

// tools/gather_parts.py builds with SCARLET_SCENE_PARTS defined: a switch,
// set at run time, that leaves parts of the staged walk out (bits: 1 the
// walk, 2 the stores, 4 the copies and their waits, 8 the list: no
// component listed), to attribute its time; the results are then wrong.
// The package's own build has no switch.
#ifdef SCARLET_SCENE_PARTS
__constant__ int kParts;
#define SCENE_SKIP(bit) (kParts & (bit))
#else
#define SCENE_SKIP(bit) false
#endif

// A valid, aligned source for the copies that only write zeros.
__device__ __align__(16) float kZeros[4];

// The staged walk's seds of one band group: CG rounded up to 4 floats.
__host__ __device__ constexpr int sed_slot(int CG) { return (CG + 3) & ~3; }

// cp.async of `bytes` (4, 8 or 16) to shared dst, of which the first
// `from` come from src and the rest are zero (src unread where from = 0).
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         int bytes, int from) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if (bytes == 16)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(from)
                 : "memory");
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
                 "l"(src), "r"(from)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(src), "r"(from)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// XV consecutive floats at o (aligned to XV floats).
template <int XV>
__device__ __forceinline__ void store(float* o, const float (&a)[XV]) {
  if constexpr (XV == 4)
    *reinterpret_cast<float4*>(o) = make_float4(a[0], a[1], a[2], a[3]);
  else if constexpr (XV == 2)
    *reinterpret_cast<float2*>(o) = make_float2(a[0], a[1]);
  else
    o[0] = a[0];
}

template <int N>
__device__ __forceinline__ void load(const float* s, float (&a)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 q = *reinterpret_cast<const float4*>(s + i);
      a[i] = q.x, a[i + 1] = q.y, a[i + 2] = q.z, a[i + 3] = q.w;
    }
  } else if constexpr (N == 2) {
    const float2 q = *reinterpret_cast<const float2*>(s);
    a[0] = q.x, a[1] = q.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) a[i] = s[i];
  }
}

// ---------------------------------------------------------------------------
// Direct walk (C <= kBands)
// ---------------------------------------------------------------------------

// Block (b, band, tile): blend b, rows [band * TY, band * TY + TY) and
// columns [tile * TX * XV, (tile + 1) * TX * XV) of the scene; thread t
// takes row t / TX of the band and x = (tile * TX + t % TX) * XV + v,
// v < XV, all C bands.  Morphologies contiguous.  Dynamic shared memory:
// origins (K, 2) int, the list (K) int, seds (K, C).
template <int XV>
__global__ void __launch_bounds__(kDirectThreads)
scene_kernel_direct(const float* __restrict__ seds,
                    const float* __restrict__ morphs,
                    const int* __restrict__ origins,
                    const unsigned char* __restrict__ active,
                    float* __restrict__ out, int K, int C, int hb, int wb,
                    int H, int W, int TX, int TY) {
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

  float acc[kBands][XV];
#pragma unroll
  for (int c = 0; c < kBands; ++c)
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
      for (int c = 0; c < kBands; ++c) {
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
  for (int c = 0; c < kBands; ++c)
    if (c < C) store<XV>(outb + (c * H + y) * W + x0, acc[c]);
}

// ---------------------------------------------------------------------------
// Staged walk (any C)
// ---------------------------------------------------------------------------

// One listed component's step of a thread's sums: its values at the
// thread's XV pixels (ms, 0 outside the box) and the group's seds (ss);
// with kMasked only the pixels inside the box (in) take it.
template <int XV, int CG, bool kMasked>
__device__ __forceinline__ void step(float (&acc)[CG][XV], const float* ms,
                                     const float* ss, const bool (&in)[XV]) {
  float m[XV], s[sed_slot(CG)];
  load<XV>(ms, m);
  load<sed_slot(CG)>(ss, s);
#pragma unroll
  for (int c = 0; c < CG; ++c)
#pragma unroll
    for (int v = 0; v < XV; ++v)
      if (!kMasked || in[v])
        acc[c][v] = __fadd_rn(acc[c][v], __fmul_rn(s[c], m[v]));
}

// Block (b, band, tile) as the direct walk's, with GT sets of P threads:
// thread t = g * P + p takes pixel thread p (row p / TX of the band,
// columns (tile * TX + p % TX) * XV + v, v < XV) for band groups g, g +
// GT, ... of the NG (group i: bands [i * C / NG, (i + 1) * C / NG)).
// Dynamic shared memory: two buffers, each of S slots of P * XV floats
// (slot j: the j-th component of the buffer's chunk at each pixel
// thread's place, 0 outside its box) and S x GT slots of sed_slot(CG)
// floats (the chunk's seds of each set's group, 0 past its bands); the
// origins (K, 2) int, the list (K) int and the active flags (K) bytes.
template <int XV, int CG>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
scene_kernel_staged(const float* __restrict__ seds,
                    const float* __restrict__ morphs,
                    const int* __restrict__ origins,
                    const unsigned char* __restrict__ active,
                    float* __restrict__ out, int K, int C, int NG, int hb,
                    int wb, long long msb, int hbs, int msy, int H, int W,
                    int TX, int TY, int P, int S) {
  constexpr int CS = sed_slot(CG);
  extern __shared__ int4 smem4[];
  const int GT = blockDim.x / P;
  float* stage = reinterpret_cast<float*>(smem4);
  float* sedbuf = stage + 2 * S * P * XV;
  int* org = reinterpret_cast<int*>(sedbuf + 2 * S * GT * CS);
  int* list = org + 2 * K;
  unsigned char* act = reinterpret_cast<unsigned char*>(list + K);
  __shared__ int count;

  const int tid = threadIdx.x;
  const int y0 = blockIdx.y * TY;
  const int y1 = min(H, y0 + TY);
  const int xs0 = blockIdx.z * TX * XV;
  const int xs1 = min(W, xs0 + TX * XV);
  const long long b = blockIdx.x;
  const int* ob = origins + b * K * 2;
  const unsigned char* ab = active + b * K;
  const float* sb = seds + b * K * C;
  const float* mb = morphs + b * msb;
  float* outb = out + b * C * H * W;

  // the list, from the origins and flags copied in one pass
  for (int i = tid; i < 2 * K; i += blockDim.x) org[i] = ob[i];
  for (int i = tid; i < K; i += blockDim.x) act[i] = ab[i];
  __syncthreads();
  if (tid < 32) {
    int n = 0;
    for (int kb = 0; kb < K; kb += 32) {
      const int k = kb + tid;
      bool take = false;
      if (k < K) {
        const int oy = org[2 * k];
        const int ox = org[2 * k + 1];
        take = act[k] && oy < y1 && oy + hb > y0 && ox < xs1 &&
               ox + wb > xs0 && !SCENE_SKIP(8);
      }
      const unsigned mask = __ballot_sync(0xffffffffu, take);
      if (take) list[n + __popc(mask & ((1u << tid) - 1u))] = k;
      n += __popc(mask);
    }
    if (tid == 0) count = n;
  }
  __syncthreads();
  const int n = count;

  const int g0 = tid / P;
  const int p = tid - g0 * P;
  const int ty = p / TX;
  const int y = y0 + ty;
  const int x0 = xs0 + (p - ty * TX) * XV;
  const bool live = ty < TY && y < y1 && x0 < xs1;

  // the chunk's values at this pixel thread's place, components j = g0,
  // g0 + GT, ... of it: a whole box row as one copy where it is aligned,
  // zeros outside the box
  auto stage_values = [&](int i0, int buf) {
    const int m = min(S, n - i0);
    if (!live || SCENE_SKIP(4)) return;
    for (int j = g0; j < m; j += GT) {
      const int k = list[i0 + j];
      const int ly = y - org[2 * k];
      const int lx = x0 - org[2 * k + 1];
      const bool row = (unsigned)ly < (unsigned)hb;
      const float* src = mb + (k * hbs + (row ? ly : 0)) * msy + lx;
      float* dst = stage + ((buf * S + j) * P + p) * XV;
      if (!row || lx + XV <= 0 || lx >= wb) {
        cp_async(dst, kZeros, 4 * XV, 0);
      } else if (lx >= 0 && lx + XV <= wb &&
                 (XV == 1 || (reinterpret_cast<unsigned long long>(src) &
                              (4 * XV - 1)) == 0)) {
        cp_async(dst, src, 4 * XV, 4 * XV);
      } else {
#pragma unroll
        for (int v = 0; v < XV; ++v) {
          const bool in = (unsigned)(lx + v) < (unsigned)wb;
          cp_async(dst + v, in ? src + v : kZeros, 4, in ? 4 : 0);
        }
      }
    }
  };
  // the chunk's seds of this set's group (bands c0 .. c0 + nc - 1): up to
  // two per thread, loaded here and stored (put_seds) after the walk
  // before them; sets past the groups (nc = 0) store zeros
  float sv[2];
  auto load_seds = [&](int i0, int c0, int nc) {
    const int m = min(S, n - i0);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int e = p + u * P;
      const int j = e / CS;
      const int c = e - j * CS;
      sv[u] = j < m && c < nc ? __ldg(sb + list[i0 + j] * C + c0 + c)
                              : 0.0f;
    }
  };
  auto put_seds = [&](int buf) {
    bool bad = false;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int e = p + u * P;
      if (e < S * CS) {
        const int j = e / CS;
        sedbuf[((buf * S + j) * GT + g0) * CS + e - j * CS] = sv[u];
        bad |= !isfinite(sv[u]);
      }
    }
    return bad;
  };

  const int walks = (NG + GT - 1) / GT;
  for (int w = 0; w < walks; ++w) {
    const int g = g0 + w * GT;
    const int c0 = (int)((long long)g * C / NG);
    const int nc = g < NG ? (int)((long long)(g + 1) * C / NG) - c0 : 0;
    float acc[CG][XV];
#pragma unroll
    for (int c = 0; c < CG; ++c)
#pragma unroll
      for (int v = 0; v < XV; ++v) acc[c][v] = 0.0f;

    bool bad = false;
    if (n > 0) {
      stage_values(0, 0);
      cp_async_commit();
      load_seds(0, c0, nc);
      bad = put_seds(0);
    }
    for (int i0 = 0, buf = 0; i0 < n; i0 += S, buf ^= 1) {
      // this chunk staged by every thread, the other buffer free: a
      // non-finite sed anywhere in the chunk takes the masked walk
      cp_async_wait_all();
      const bool masked = __syncthreads_or(bad);
      const bool more = i0 + S < n;
      if (more) {
        stage_values(i0 + S, buf ^ 1);
        cp_async_commit();
        load_seds(i0 + S, c0, nc);
      }
      const int m = min(S, n - i0);
      if (live && nc > 0 && !SCENE_SKIP(1)) {
        const float* ms = stage + (buf * S * P + p) * XV;
        const float* ss = sedbuf + (buf * S * GT + g0) * CS;
        if (!masked) {
          const bool all[XV] = {};
          for (int j = 0; j < m; ++j)
            step<XV, CG, false>(acc, ms + j * P * XV, ss + j * GT * CS, all);
        } else {
          for (int j = 0; j < m; ++j) {
            const int k = list[i0 + j];
            const int ly = y - org[2 * k];
            const int lx = x0 - org[2 * k + 1];
            bool in[XV];
#pragma unroll
            for (int v = 0; v < XV; ++v)
              in[v] = (unsigned)ly < (unsigned)hb &&
                      (unsigned)(lx + v) < (unsigned)wb;
            step<XV, CG, true>(acc, ms + j * P * XV, ss + j * GT * CS, in);
          }
        }
      }
      if (more) bad = put_seds(buf ^ 1);
    }

    if (live && nc > 0) {
      if (!SCENE_SKIP(2)) {
#pragma unroll
        for (int c = 0; c < CG; ++c)
          if (c < nc)
            store<XV>(outb + ((long long)(c0 + c) * H + y) * W + x0, acc[c]);
      } else {
        // the sums stay live without their stores
        unsigned h = 0;
#pragma unroll
        for (int c = 0; c < CG; ++c)
#pragma unroll
          for (int v = 0; v < XV; ++v) h ^= __float_as_uint(acc[c][v]);
        if (h == 0x7fc0beefu) outb[0] = 0.0f;
      }
    }
    if (w + 1 < walks) __syncthreads();  // the buffers before the next walk
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

struct Args {
  const float* seds;
  const float* morphs;
  const int* origins;
  const unsigned char* active;
  float* out;
  int B, K, C, hb, wb;
  long long msb;
  int hbs, msy;
  int H, W, TX, TY, P, NG, S, bands, tiles, threads, smem;
  cudaStream_t stream;
};

// Each instantiation keeps its own record of the shared memory granted.
template <int XV>
struct Direct {
  static int launch(const Args& a) {
    static int granted[scarlet::kMaxDevices] = {};
    const int err =
        scarlet::grant_smem(scene_kernel_direct<XV>, a.smem, granted);
    if (err != 0) return err;
    scene_kernel_direct<XV>
        <<<dim3(a.B, a.bands, a.tiles), a.threads, a.smem, a.stream>>>(
        a.seds, a.morphs, a.origins, a.active, a.out, a.K, a.C, a.hb, a.wb,
        a.H, a.W, a.TX, a.TY);
    return (int)cudaGetLastError();
  }
  static int info(int threads, int smem, int* out) {
    return scarlet::kernel_info(scene_kernel_direct<XV>, threads, smem, out);
  }
};

template <int XV, int CG>
struct Staged {
  static int launch(const Args& a) {
    static int granted[scarlet::kMaxDevices] = {};
    const int err =
        scarlet::grant_smem(scene_kernel_staged<XV, CG>, a.smem, granted);
    if (err != 0) return err;
    scene_kernel_staged<XV, CG>
        <<<dim3(a.B, a.bands, a.tiles), a.threads, a.smem, a.stream>>>(
        a.seds, a.morphs, a.origins, a.active, a.out, a.K, a.C, a.NG, a.hb,
        a.wb, a.msb, a.hbs, a.msy, a.H, a.W, a.TX, a.TY, a.P, a.S);
    return (int)cudaGetLastError();
  }
  static int info(int threads, int smem, int* out) {
    return scarlet::kernel_info(scene_kernel_staged<XV, CG>, threads, smem,
                                out);
  }
};

template <int XV, typename F>
int dispatch_cg(int CG, F f) {
  switch (CG) {
    case 1: return f(Staged<XV, 1>{});
    case 2: return f(Staged<XV, 2>{});
    case 3: return f(Staged<XV, 3>{});
    case 4: return f(Staged<XV, 4>{});
    case 5: return f(Staged<XV, 5>{});
    case 6: return f(Staged<XV, 6>{});
    case 7: return f(Staged<XV, 7>{});
    case 8: return f(Staged<XV, 8>{});
  }
  return (int)cudaErrorInvalidValue;
}

// f(instantiation) for the direct walk (staged 0) or the staged walk's
// (XV, CG) instantiation.
template <typename F>
int dispatch(int staged, int XV, int CG, F f) {
  if (!staged) {
    if (XV == 4) return f(Direct<4>{});
    if (XV == 2) return f(Direct<2>{});
    if (XV == 1) return f(Direct<1>{});
    return (int)cudaErrorInvalidValue;
  }
  if (XV == 4) return dispatch_cg<4>(CG, f);
  if (XV == 2) return dispatch_cg<2>(CG, f);
  if (XV == 1) return dispatch_cg<1>(CG, f);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// seds: (B, K, C) contiguous; morphs: (B, K, hb, wb) with strides (msb,
// hbs * msy, msy, 1), a blend's offsets within int (the direct walk:
// contiguous); origins: (B, K, 2) int32; active: (B, K) bool; out: (B, C,
// H, W).  C >= 1, K >= 1.  staged, XV, TX, TY, P, NG, CG, S, bands, tiles,
// threads, smem: kernels.scene_geometry.
extern "C" int scarlet_scene_assembly(
    const float* seds, const float* morphs, const int* origins,
    const unsigned char* active, float* out, int B, int K, int C, int hb,
    int wb, long long msb, int hbs, int msy, int H, int W, int staged,
    int XV, int TX, int TY, int P, int NG, int CG, int S, int bands,
    int tiles, int threads, int smem, void* stream) {
  if (C < 1 || K < 1 || W % XV != 0 || bands > 65535 || tiles > 65535 ||
      threads % 32 != 0 || TX * TY > (staged ? P : threads))
    return (int)cudaErrorInvalidValue;
  if (staged && (threads > kMaxThreads || P < 32 || threads % P != 0 ||
                 S < 1 || S > kChunk || CG < 1 || CG > kBands || NG < 1 ||
                 (C + NG - 1) / NG != CG))
    return (int)cudaErrorInvalidValue;
  if (!staged && (threads > kDirectThreads || C > kBands))
    return (int)cudaErrorInvalidValue;
  const Args a{seds, morphs, origins, active, out, B, K, C, hb, wb, msb,
               hbs, msy, H, W, TX, TY, P, NG, S, bands, tiles, threads, smem,
               (cudaStream_t)stream};
  return dispatch(staged, XV, CG,
                  [&](auto f) { return decltype(f)::launch(a); });
}

// out[3] as scarlet::kernel_info, for the direct walk (staged 0) or the
// staged walk's (XV, CG) instantiation.
extern "C" int scarlet_scene_kernel_info(int staged, int XV, int CG,
                                         int threads, int smem, int* out) {
  return dispatch(staged, XV, CG, [&](auto f) {
    return decltype(f)::info(threads, smem, out);
  });
}

#ifdef SCARLET_SCENE_PARTS
extern "C" int scarlet_scene_set_parts(int bits) {
  return (int)cudaMemcpyToSymbol(kParts, &bits, sizeof(int));
}
#endif
