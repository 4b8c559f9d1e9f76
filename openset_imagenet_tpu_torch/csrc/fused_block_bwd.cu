// K5 for Hopper: one pointwise-conv backward site of the fused bottleneck.
//
// Replaces the Pallas kernel `_bwd_kernel` of
// openset_imagenet_tpu/experimental/fused_block.py:111 (reached through
// `_bwd_pallas`).  What it computes, per row m of M = N*H*W and channel c
// (see ops/fused_block_bwd.py for the plain version it is held to):
//
//   gp     = g * gate        gate: the saved int8 mask, or recomputed as
//                            z*mul_o + add_o > 0 in the activation dtype
//   sums_o = [sum_m gp*z, sum_m gp]                              (f32)
//   dz     = (gp * mul_o) rounded to the activation dtype
//   dxa    = dz @ W^T  (f32 accumulate)  + ds
//   in_act: xa = relu(x*mul_i + add_i) in the activation dtype,
//           gin = dxa * (xa > 0), dx = gin*mul_i, sums_i = [sum gin*x, sum gin]
//   else:   xa = x, dx = dxa
//   dW     = xa^T @ dz  (f32)
//
// What bounds it on the H100: the two products are 4*M*ci*co flops; the
// bytes are g, z, mask, x, ds read and gp, dx written.  At the resnet50
// sites of stage 1 (M = 802,816, ci*co = 64*256) it is memory bound, at
// stage 4 (M = 12,544, ci*co = 512*2048) bound by the products.  The
// design keeps the elementwise gate work out of the product loops: the
// gate is evaluated once per element, and the product loops stream bf16
// tiles with 16-byte loads through shared memory into `nvcuda::wmma`
// (16x16x16, f32 accumulate).  wgmma/TMA pipelining is left to a later
// change.
//
// The TPU kernel runs its grid in order and carries dW and the channel sums
// in VMEM scratch from step to step.  Blocks here run in parallel in no
// order, so the work is four stages on one stream, with no float atomics,
// so two launches on the same inputs give the same bits:
//   0. site_gate over (row tile, channel tile): gp (written on request),
//      dz into a [M, co] scratch, and one sums_o partial per row tile;
//   1. site_rows over (M-tile, ci-tile): dxa = dz @ W^T, then dx and one
//      sums_i partial per M-tile;
//   2. site_dw over (ci-tile, co-tile, M-split): xa recomputed from x, one
//      f32 dW partial per split (the splits depend on the shape alone);
//   3. reduce_partials adds the partials of each output in a fixed order.
// Every site shape runs here, ragged M and channel counts included (edges
// are masked and padded with zeros in shared memory; 16-byte loads only
// where both channel counts are multiples of 8): the VMEM-budget fallback
// of `_pick_tm` has no counterpart.
//
// Rounding follows `_bwd_kernel`: the gate and xa are computed as
// round(round(v*mul) + add) in the activation dtype (explicit _rn
// intrinsics, so no FMA contraction changes a gate), dz and xa are rounded
// before the products, dxa, the sums and dW stay f32, dx is rounded once.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC; plain C entry points, bound with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int THREADS = 256;
constexpr int PAD = 8;
// site_gate: GR rows x GC channels per block (32 lanes x 8 channels).
constexpr int GR = 64, GC = 256;
// site_rows: output tile RM x RN of dxa, co consumed in chunks of RK.
constexpr int RM = 128, RN = 64, LDC = RN + 4;
// site_dw: output tile WI x WK of dW, M consumed in chunks of WM rows.
constexpr int WI = 64, WK = 128, LDX = WI + PAD, LDD = WK + PAD, LDW = WK + 4;
// reduce_partials: 32 outputs x 8 lanes per block; partials per program.
constexpr int RED_X = 32, RED_Y = 8, RED_CHUNK = 256;

// Depth of a product step: two 16-deep wmma steps per tile row of 64 bytes
// in f32, four in bf16 (shared memory stays within the 48 KB of a static
// allocation).
template <typename T> struct Depth { static constexpr int K = 64; };
template <> struct Depth<float> { static constexpr int K = 32; };

template <typename T> struct Num;
template <> struct Num<float> {
  static __device__ __forceinline__ float f(float v) { return v; }
  static __device__ __forceinline__ float r(float v) { return v; }
  static __device__ __forceinline__ float from(float v) { return v; }
};
template <> struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ float f(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ float r(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  static __device__ __forceinline__ __nv_bfloat16 from(float v) {
    return __float2bfloat16_rn(v);
  }
};

// round(round(v * mul) + add) in T, with mul and add already rounded to T.
template <typename T>
__device__ __forceinline__ float affine_t(float v, float mul_t, float add_t) {
  return Num<T>::r(__fadd_rn(Num<T>::r(__fmul_rn(v, mul_t)), add_t));
}

__host__ __device__ __forceinline__ long long cdiv(long long a, long long b) {
  return (a + b - 1) / b;
}

// Eight consecutive elements, 16-byte aligned at both ends.
template <typename T>
__device__ __forceinline__ void copy8(T* dst, const T* src) {
#pragma unroll
  for (int i = 0; i < (int)sizeof(T) / 2; ++i)
    reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
}
template <typename T>
__device__ __forceinline__ void zero8(T* dst) {
#pragma unroll
  for (int i = 0; i < (int)sizeof(T) / 2; ++i)
    reinterpret_cast<uint4*>(dst)[i] = make_uint4(0, 0, 0, 0);
}

// ---------------------------------------------------------------------------
// Block products.  Rows: C[RM][RN] += A[RM][K] (row-major, ld K+PAD) times
// B[K][RN] stored as [RN][K] (column-major, ld K+PAD).  Weights: C[WI][WK]
// += A[WI][K] stored as [K][WI] (column-major, ld LDX) times B[K][WK]
// (row-major, ld LDD).  bf16: 8 warps of 32x32 wmma tiles; f32: plain FMA,
// 32 outputs per thread.
// ---------------------------------------------------------------------------

template <typename T> struct RowsMma;
template <typename T> struct DwMma;

using frag_acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
using bf16 = __nv_bfloat16;

template <> struct RowsMma<bf16> {
  static constexpr int K = Depth<bf16>::K, LD = K + PAD;
  frag_acc c[2][2];
  __device__ void zero() {
    for (int i = 0; i < 2; ++i)
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(c[i][j], 0.f);
  }
  __device__ void step(const bf16* sA, const bf16* sB) {
    const int warp = threadIdx.x / 32, wm = warp / 2, wn = warp % 2;
#pragma unroll
    for (int kk = 0; kk < K; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b[2];
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], sA + (wm * 32 + i * 16) * LD + kk, LD);
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], sB + (wn * 32 + j * 16) * LD + kk, LD);
      for (int i = 0; i < 2; ++i)
        for (int j = 0; j < 2; ++j) wmma::mma_sync(c[i][j], a[i], b[j], c[i][j]);
    }
  }
  __device__ void store(float* sC) {
    const int warp = threadIdx.x / 32, wm = warp / 2, wn = warp % 2;
    for (int i = 0; i < 2; ++i)
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(sC + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16,
                                c[i][j], LDC, wmma::mem_row_major);
  }
};

template <> struct RowsMma<float> {
  static constexpr int K = Depth<float>::K, LD = K + PAD;
  float c[8][4];
  __device__ void zero() {
    for (int i = 0; i < 8; ++i)
      for (int j = 0; j < 4; ++j) c[i][j] = 0.f;
  }
  __device__ void step(const float* sA, const float* sB) {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
    for (int kk = 0; kk < K; ++kk) {
      float a[8], b[4];
      for (int i = 0; i < 8; ++i) a[i] = sA[(ty * 8 + i) * LD + kk];
      for (int j = 0; j < 4; ++j) b[j] = sB[(tx * 4 + j) * LD + kk];
      for (int i = 0; i < 8; ++i)
        for (int j = 0; j < 4; ++j) c[i][j] = fmaf(a[i], b[j], c[i][j]);
    }
  }
  __device__ void store(float* sC) {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
    for (int i = 0; i < 8; ++i)
      for (int j = 0; j < 4; ++j) sC[(ty * 8 + i) * LDC + tx * 4 + j] = c[i][j];
  }
};

template <> struct DwMma<bf16> {
  static constexpr int K = Depth<bf16>::K;
  frag_acc c[2][2];
  __device__ void zero() {
    for (int i = 0; i < 2; ++i)
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(c[i][j], 0.f);
  }
  __device__ void step(const bf16* sX, const bf16* sD) {
    const int warp = threadIdx.x / 32, wi = warp / 4, wk = warp % 4;
#pragma unroll
    for (int mm = 0; mm < K; mm += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], sX + mm * LDX + wi * 32 + i * 16, LDX);
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], sD + mm * LDD + wk * 32 + j * 16, LDD);
      for (int i = 0; i < 2; ++i)
        for (int j = 0; j < 2; ++j) wmma::mma_sync(c[i][j], a[i], b[j], c[i][j]);
    }
  }
  __device__ void store(float* sW) {
    const int warp = threadIdx.x / 32, wi = warp / 4, wk = warp % 4;
    for (int i = 0; i < 2; ++i)
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(sW + (wi * 32 + i * 16) * LDW + wk * 32 + j * 16,
                                c[i][j], LDW, wmma::mem_row_major);
  }
};

template <> struct DwMma<float> {
  static constexpr int K = Depth<float>::K;
  float c[8][4];
  __device__ void zero() {
    for (int i = 0; i < 8; ++i)
      for (int j = 0; j < 4; ++j) c[i][j] = 0.f;
  }
  __device__ void step(const float* sX, const float* sD) {
    const int ty = threadIdx.x / 32, tx = threadIdx.x % 32;
    for (int mm = 0; mm < K; ++mm) {
      float a[8], b[4];
      for (int i = 0; i < 8; ++i) a[i] = sX[mm * LDX + ty * 8 + i];
      for (int j = 0; j < 4; ++j) b[j] = sD[mm * LDD + tx * 4 + j];
      for (int i = 0; i < 8; ++i)
        for (int j = 0; j < 4; ++j) c[i][j] = fmaf(a[i], b[j], c[i][j]);
    }
  }
  __device__ void store(float* sW) {
    const int ty = threadIdx.x / 32, tx = threadIdx.x % 32;
    for (int i = 0; i < 8; ++i)
      for (int j = 0; j < 4; ++j) sW[(ty * 8 + i) * LDW + tx * 4 + j] = c[i][j];
  }
};

template <int A, int B> struct Max { static constexpr int value = A > B ? A : B; };

// Sum of red[q * width + lane] over q in order, for lane < width.
__device__ __forceinline__ float ordered_sum(const float* red, int groups,
                                             int width, int lane) {
  float v = red[lane];
  for (int q = 1; q < groups; ++q) v += red[q * width + lane];
  return v;
}

// ---------------------------------------------------------------------------
// Stage 0: gp, dz and the sums_o partials.  grid (ceil(M/GR), ceil(co/GC));
// thread (lane, row group) owns channels c0..c0+8 of rows row group + 8q.
// part_o [ceil(M/GR)][2][co].
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS)
site_gate(const T* __restrict__ g, const T* __restrict__ z,
          const int8_t* __restrict__ mask, const float* __restrict__ mul_o,
          const float* __restrict__ add_o, T* __restrict__ dz,
          T* __restrict__ gp_out, float* __restrict__ part_o, long long M,
          int co, int vec) {
  constexpr int GROUPS = THREADS / 32;
  __shared__ float red[2][GROUPS][GC];
  const int lane = threadIdx.x % 32, group = threadIdx.x / 32;
  const int c0 = blockIdx.y * GC + lane * 8;
  const long long m0 = (long long)blockIdx.x * GR;
  float mo[8], mo_t[8], ao_t[8], s_gz[8], s_g[8];
  for (int e = 0; e < 8; ++e) {
    const bool in = c0 + e < co;
    mo[e] = in ? mul_o[c0 + e] : 0.f;
    mo_t[e] = Num<T>::r(mo[e]);
    ao_t[e] = in ? Num<T>::r(add_o[c0 + e]) : 0.f;
    s_gz[e] = s_g[e] = 0.f;
  }
  if (c0 < co) {
    for (int r = group; r < GR; r += GROUPS) {
      const long long m = m0 + r;
      if (m >= M) break;
      const long long off = m * co + c0;
      __align__(16) T gv[8], zv[8], dzv[8], gpv[8];
      __align__(8) int8_t mv[8];
      if (vec) {
        copy8(gv, g + off);
        copy8(zv, z + off);
        if (mask)
          *reinterpret_cast<uint2*>(mv) =
              *reinterpret_cast<const uint2*>(mask + off);
      } else {
        for (int e = 0; e < 8; ++e) {
          const bool in = c0 + e < co;
          gv[e] = in ? g[off + e] : Num<T>::from(0.f);
          zv[e] = in ? z[off + e] : Num<T>::from(0.f);
          mv[e] = (in && mask) ? mask[off + e] : 0;
        }
      }
      for (int e = 0; e < 8; ++e) {
        const float gf = Num<T>::f(gv[e]), zf = Num<T>::f(zv[e]);
        const float gp = mask ? Num<T>::r(gf * (float)mv[e])
                              : (affine_t<T>(zf, mo_t[e], ao_t[e]) > 0.f
                                     ? gf : 0.f);
        s_gz[e] += gp * zf;
        s_g[e] += gp;
        gpv[e] = Num<T>::from(gp);
        dzv[e] = Num<T>::from(__fmul_rn(gp, mo[e]));
      }
      if (vec) {
        copy8(dz + off, dzv);
        if (gp_out) copy8(gp_out + off, gpv);
      } else {
        for (int e = 0; e < 8 && c0 + e < co; ++e) {
          dz[off + e] = dzv[e];
          if (gp_out) gp_out[off + e] = gpv[e];
        }
      }
    }
  }
  for (int e = 0; e < 8; ++e) {
    red[0][group][lane * 8 + e] = s_gz[e];
    red[1][group][lane * 8 + e] = s_g[e];
  }
  __syncthreads();
  const int c = blockIdx.y * GC + threadIdx.x;
  if (c < co) {
    float* p = part_o + (long long)blockIdx.x * 2 * co;
    p[c] = ordered_sum(&red[0][0][0], GROUPS, GC, threadIdx.x);
    p[co + c] = ordered_sum(&red[1][0][0], GROUPS, GC, threadIdx.x);
  }
}

// ---------------------------------------------------------------------------
// Stage 1: dxa tile, dx and the per-M-tile sums_i partials.
// grid (ceil(M/RM), ceil(ci/RN)); part_i [ceil(M/RM)][2][ci].
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS)
site_rows(const T* __restrict__ dz, const T* __restrict__ x,
          const T* __restrict__ ds, const T* __restrict__ w,
          const float* __restrict__ mul_i, const float* __restrict__ add_i,
          T* __restrict__ dx, float* __restrict__ part_i, long long M, int ci,
          int co, int in_act, int vec) {
  constexpr int K = RowsMma<T>::K, LD = RowsMma<T>::LD;
  constexpr int AB = (RM + RN) * LD * (int)sizeof(T);
  constexpr int CB = RM * LDC * (int)sizeof(float);
  __shared__ __align__(128) unsigned char smem[Max<AB, CB>::value];
  __shared__ float red[2][THREADS];
  T* sA = reinterpret_cast<T*>(smem);
  T* sB = sA + RM * LD;
  float* sC = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const long long m0 = (long long)blockIdx.x * RM;
  const int n0 = blockIdx.y * RN;
  const T zero_t = Num<T>::from(0.f);

  RowsMma<T> acc;
  acc.zero();
  for (int k0 = 0; k0 < co; k0 += K) {
    if (vec) {
      for (int e = tid; e < RM * K / 8; e += THREADS) {
        const int r = e / (K / 8), kv = e % (K / 8) * 8;
        const long long m = m0 + r;
        if (m < M && k0 + kv < co) copy8(sA + r * LD + kv, dz + m * co + k0 + kv);
        else zero8(sA + r * LD + kv);
      }
      for (int e = tid; e < RN * K / 8; e += THREADS) {
        const int n = e / (K / 8), kv = e % (K / 8) * 8;
        if (n0 + n < ci && k0 + kv < co)
          copy8(sB + n * LD + kv, w + (long long)(n0 + n) * co + k0 + kv);
        else zero8(sB + n * LD + kv);
      }
    } else {
      for (int e = tid; e < RM * K; e += THREADS) {
        const int r = e / K, kk = e % K;
        const long long m = m0 + r;
        sA[r * LD + kk] = (m < M && k0 + kk < co) ? dz[m * co + k0 + kk]
                                                  : zero_t;
      }
      for (int e = tid; e < RN * K; e += THREADS) {
        const int n = e / K, kk = e % K;
        sB[n * LD + kk] = (n0 + n < ci && k0 + kk < co)
                              ? w[(long long)(n0 + n) * co + k0 + kk] : zero_t;
      }
    }
    __syncthreads();
    acc.step(sA, sB);
    __syncthreads();
  }
  acc.store(sC);
  __syncthreads();

  // Epilogue: thread column nn, rows tid/RN + q*(THREADS/RN).
  const int nn = tid % RN, i = n0 + nn;
  float mi = 0.f, mi_t = 0.f, ai_t = 0.f;
  if (in_act && i < ci) {
    mi = mul_i[i];
    mi_t = Num<T>::r(mi);
    ai_t = Num<T>::r(add_i[i]);
  }
  float s_gx = 0.f, s_gi = 0.f;
  for (int r = tid / RN; r < RM; r += THREADS / RN) {
    const long long m = m0 + r;
    if (i >= ci || m >= M) continue;
    const long long off = m * ci + i;
    float d = sC[r * LDC + nn];
    if (ds) d = __fadd_rn(d, Num<T>::f(ds[off]));
    if (in_act) {
      const float xf = Num<T>::f(x[off]);
      const float gin = affine_t<T>(xf, mi_t, ai_t) > 0.f ? d : 0.f;
      dx[off] = Num<T>::from(__fmul_rn(gin, mi));
      s_gx += gin * xf;
      s_gi += gin;
    } else {
      dx[off] = Num<T>::from(d);
    }
  }
  if (in_act) {
    red[0][tid] = s_gx;
    red[1][tid] = s_gi;
    __syncthreads();
    if (tid < RN && i < ci) {
      float* p = part_i + (long long)blockIdx.x * 2 * ci;
      p[i] = ordered_sum(red[0], THREADS / RN, RN, tid);
      p[ci + i] = ordered_sum(red[1], THREADS / RN, RN, tid);
    }
  }
}

// ---------------------------------------------------------------------------
// Stage 2: dW partials.  grid (ceil(ci/WI), ceil(co/WK), splits); split s
// covers rows [s*rows, min(M, (s+1)*rows)); part_w [splits][ci][co].
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS)
site_dw(const T* __restrict__ dz, const T* __restrict__ x,
        const float* __restrict__ mul_i, const float* __restrict__ add_i,
        float* __restrict__ part_w, long long M, int ci, int co, int in_act,
        long long rows, int vec) {
  constexpr int K = DwMma<T>::K;
  constexpr int AB = K * (LDX + LDD) * (int)sizeof(T);
  constexpr int CB = WI * LDW * (int)sizeof(float);
  __shared__ __align__(128) unsigned char smem[Max<AB, CB>::value];
  T* sX = reinterpret_cast<T*>(smem);
  T* sD = sX + K * LDX;
  float* sW = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int i0 = blockIdx.x * WI, k0 = blockIdx.y * WK;
  const long long mbeg = (long long)blockIdx.z * rows;
  const long long mend = mbeg + rows < M ? mbeg + rows : M;
  const T zero_t = Num<T>::from(0.f);

  // The x columns a thread loads are fixed: 8 from iv (vector) or xi.
  const int iv = tid % (WI / 8) * 8, xi = tid % WI;
  float mi_t[8], ai_t[8];
  for (int e = 0; e < 8; ++e) {
    const int i = i0 + (vec ? iv + e : xi);
    const bool on = in_act && i < ci;
    mi_t[e] = on ? Num<T>::r(mul_i[i]) : 0.f;
    ai_t[e] = on ? Num<T>::r(add_i[i]) : 0.f;
  }
  auto act = [&](T v, int e) -> T {
    if (!in_act) return v;
    const float s = affine_t<T>(Num<T>::f(v), mi_t[e], ai_t[e]);
    return Num<T>::from(s > 0.f ? s : 0.f);
  };

  DwMma<T> acc;
  acc.zero();
  for (long long mc = mbeg; mc < mend; mc += K) {
    if (vec) {
      for (int e = tid; e < K * WI / 8; e += THREADS) {
        const int r = e / (WI / 8);
        const long long m = mc + r;
        T* d = sX + r * LDX + iv;
        if (m < mend && i0 + iv < ci) {
          __align__(16) T v[8];
          copy8(v, x + m * ci + i0 + iv);
          for (int q = 0; q < 8; ++q) v[q] = act(v[q], q);
          copy8(d, v);
        } else {
          zero8(d);
        }
      }
      for (int e = tid; e < K * WK / 8; e += THREADS) {
        const int r = e / (WK / 8), kv = e % (WK / 8) * 8;
        const long long m = mc + r;
        if (m < mend && k0 + kv < co) copy8(sD + r * LDD + kv, dz + m * co + k0 + kv);
        else zero8(sD + r * LDD + kv);
      }
    } else {
      for (int r = tid / WI; r < K; r += THREADS / WI) {
        const long long m = mc + r;
        sX[r * LDX + xi] = (m < mend && i0 + xi < ci)
                               ? act(x[m * ci + i0 + xi], 0) : zero_t;
      }
      for (int e = tid; e < K * WK; e += THREADS) {
        const int r = e / WK, kk = e % WK;
        const long long m = mc + r;
        sD[r * LDD + kk] = (m < mend && k0 + kk < co) ? dz[m * co + k0 + kk]
                                                      : zero_t;
      }
    }
    __syncthreads();
    acc.step(sX, sD);
    __syncthreads();
  }
  acc.store(sW);
  __syncthreads();
  float* p = part_w + (long long)blockIdx.z * ci * co;
  for (int e = tid; e < WI * WK; e += THREADS) {
    const int r = e / WK, c = e % WK;
    if (i0 + r < ci && k0 + c < co)
      p[(long long)(i0 + r) * co + k0 + c] = sW[r * LDW + c];
  }
}

// ---------------------------------------------------------------------------
// Stage 3: out[b][j] = sum over t in program b's chunk of part[t][j], in a
// fixed order (lane-strided, then the lanes in order).  grid (ceil(N/RED_X),
// programs), block (RED_X, RED_Y).
// ---------------------------------------------------------------------------
__global__ void reduce_partials(const float* __restrict__ part,
                                float* __restrict__ out, int S, long long N,
                                int chunk) {
  __shared__ float s[RED_Y][RED_X + 1];
  const long long j = (long long)blockIdx.x * RED_X + threadIdx.x;
  const int t0 = blockIdx.y * chunk;
  const int t1 = t0 + chunk < S ? t0 + chunk : S;
  float acc = 0.f;
  if (j < N)
    for (int t = t0 + threadIdx.y; t < t1; t += RED_Y)
      acc += part[(long long)t * N + j];
  s[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && j < N) {
    float v = s[0][threadIdx.x];
    for (int y = 1; y < RED_Y; ++y) v += s[y][threadIdx.x];
    out[(long long)blockIdx.y * N + j] = v;
  }
}

long long scratch_floats(long long S, long long N) {
  return S > RED_CHUNK ? cdiv(S, RED_CHUNK) * N : 0;
}

// sum over S partials [S][N] -> out [N]; two passes through scratch when S
// exceeds one program's chunk.
void reduce_all(const float* part, float* out, long long S, long long N,
                float* scratch, cudaStream_t stream) {
  const dim3 block(RED_X, RED_Y);
  const unsigned gx = (unsigned)cdiv(N, RED_X);
  if (S <= RED_CHUNK) {
    reduce_partials<<<dim3(gx, 1), block, 0, stream>>>(part, out, (int)S, N,
                                                       (int)S);
    return;
  }
  const long long P = cdiv(S, RED_CHUNK);
  reduce_partials<<<dim3(gx, (unsigned)P), block, 0, stream>>>(
      part, scratch, (int)S, N, RED_CHUNK);
  reduce_all(scratch, out, P, N, nullptr, stream);
}

template <typename T>
void launch_site(const void* g, const void* z, const void* mask, const void* x,
                 const void* ds, const void* w, const float* mul_o,
                 const float* add_o, const float* mul_i, const float* add_i,
                 void* dx, void* gp, float* dw, float* sums_o, float* sums_i,
                 void* dz, float* work, long long M, int ci, int co,
                 int in_act, int splits, int vec, cudaStream_t stream) {
  const long long n_gt = cdiv(M, GR), n_mt = cdiv(M, RM);
  float* part_w = work;
  float* part_o = part_w + (long long)splits * ci * co;
  float* part_i = part_o + n_gt * 2 * co;
  float* scratch = part_i + n_mt * 2 * ci;
  T* dzt = static_cast<T*>(dz);

  site_gate<T><<<dim3((unsigned)n_gt, (unsigned)cdiv(co, GC)), THREADS, 0,
                 stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(z),
      static_cast<const int8_t*>(mask), mul_o, add_o, dzt,
      static_cast<T*>(gp), part_o, M, co, vec);
  site_rows<T><<<dim3((unsigned)n_mt, (unsigned)cdiv(ci, RN)), THREADS, 0,
                 stream>>>(
      dzt, static_cast<const T*>(x), static_cast<const T*>(ds),
      static_cast<const T*>(w), mul_i, add_i, static_cast<T*>(dx), part_i, M,
      ci, co, in_act, vec);
  constexpr int K = DwMma<T>::K;
  const long long rows = cdiv(cdiv(M, splits), K) * K;
  const unsigned nsplit = (unsigned)cdiv(M, rows);
  site_dw<T><<<dim3((unsigned)cdiv(ci, WI), (unsigned)cdiv(co, WK), nsplit),
               THREADS, 0, stream>>>(dzt, static_cast<const T*>(x), mul_i,
                                     add_i, part_w, M, ci, co, in_act, rows,
                                     vec);
  reduce_all(part_w, dw, nsplit, (long long)ci * co, scratch, stream);
  reduce_all(part_o, sums_o, n_gt, 2LL * co, scratch, stream);
  if (in_act) reduce_all(part_i, sums_i, n_mt, 2LL * ci, scratch, stream);
}

}  // namespace

extern "C" {

// Floats of workspace fbb_site needs for this shape and split count.
long long fbb_workspace_floats(long long M, int ci, int co, int splits) {
  const long long n_gt = cdiv(M, GR), n_mt = cdiv(M, RM);
  long long scratch = scratch_floats(splits, (long long)ci * co);
  const long long so = scratch_floats(n_gt, 2LL * co);
  const long long si = scratch_floats(n_mt, 2LL * ci);
  scratch = scratch > so ? scratch : so;
  scratch = scratch > si ? scratch : si;
  return (long long)splits * ci * co + n_gt * 2 * co + n_mt * 2 * ci + scratch;
}

// One site on `stream`.  dtype: 0 float32, 1 bfloat16.  mask, ds, mul_i,
// add_i, gp and sums_i may be null (mul_i, add_i and sums_i are read only
// with in_act; gp is written when not null).  dz is an [M, co] scratch of
// the activation dtype.  vec: 16-byte loads (both channel counts multiples
// of 8, every pointer 16-byte aligned).  Returns cudaGetLastError().
int fbb_site(int dtype, const void* g, const void* z, const void* mask,
             const void* x, const void* ds, const void* w, const void* mul_o,
             const void* add_o, const void* mul_i, const void* add_i,
             void* dx, void* gp, void* dw, void* sums_o, void* sums_i,
             void* dz, void* work, long long M, int ci, int co, int in_act,
             int splits, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // Two reduction passes cover at most RED_CHUNK^2 row tiles.
  if (M <= 0 || cdiv(M, GR) > (long long)RED_CHUNK * RED_CHUNK || splits < 1)
    return (int)cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto fw = [](void* p) { return static_cast<float*>(p); };
  if (dtype == 1)
    launch_site<bf16>(g, z, mask, x, ds, w, f(mul_o), f(add_o), f(mul_i),
                      f(add_i), dx, gp, fw(dw), fw(sums_o), fw(sums_i), dz,
                      fw(work), M, ci, co, in_act, splits, vec, s);
  else if (dtype == 0)
    launch_site<float>(g, z, mask, x, ds, w, f(mul_o), f(add_o), f(mul_i),
                       f(add_i), dx, gp, fw(dw), fw(sums_o), fw(sums_i), dz,
                       fw(work), M, ci, co, in_act, splits, vec, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
