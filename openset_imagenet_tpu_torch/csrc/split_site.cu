// K6 for Hopper: the tail-site backward as four streaming kernels.
//
// Replaces the Pallas kernels `_k1_gate`, `_k2_dxa`, `_k3_dx` and `_k4_dw`
// of openset_imagenet_tpu/experimental/split_site.py:73,89,110,134 (reached
// through `tail_site_split`).  The site is the tail of a bottleneck (int8
// boundary gate, input activation, gp emitted); per row m of M = N*H*W and
// channel c (see experimental/split_site.py for the plain version it is
// held to):
//
//   k1 (g, mask -> gp)   gp = g * mask, and one [sum gp] partial per row tile
//   k2 (gp, z -> dxa)    dz = round(gp * mul_o), dxa = round(dz @ W^T)
//                        (f32 accumulate), and one [sum gp*z] partial per
//                        row tile
//   k3 (dxa, x -> dx)    xa = relu(round(round(x*mul_i) + add_i)),
//                        gin = dxa * (xa > 0), dx = round(gin * mul_i), and
//                        one [sum gin*x, sum gin] partial per row tile
//   k4 (gp, x -> dW)     xa and dz recomputed, one f32 dW partial per M-split
//
// then a fixed-order reduction of the partials (`reduce_partials`).  Each
// kernel makes at most two large reads and one large write, and dxa
// round-trips through device memory in the activation dtype: that structure
// is what the split form exists to measure against the unified site (K5,
// csrc/fused_block_bwd.cu), so it is kept and not fused back.
//
// What bounds it on the H100: bytes.  At the resnet50 stage-1 tail (M =
// 802,816, ci = 64, co = 256, bf16) the four kernels move 3,456 bytes a row
// (2.775 GB, 0.83 ms at 3.35 TB/s) against the 2,048 bytes a row that the
// function needs (1.644 GB, 0.49 ms); the 52.6 GFLOP of the two products
// take 0.05 ms at the bf16 tensor-core rate.  Design: k1 and k3 are
// elementwise passes with 16-byte loads, lanes across channels and rows
// across warps, sized so that a warp reads whole 512-byte runs; k2 and k4
// are the product loops of K5 (bf16 tiles through shared memory into
// `nvcuda::wmma` 16x16x16 with f32 accumulate; plain FMA in f32), with dz
// computed from gp while the tile is loaded.  W never has to fit in shared
// memory: k2 tiles ci and walks co in 64-deep steps, k4 tiles (ci, co,
// M-split), as K5 does.  wgmma/TMA pipelining is left to a later change.
//
// Blocks run in parallel in no order, so each channel sum and dW is written
// as partials and added in a fixed order: no float atomics, two launches on
// the same inputs give the same bits.  Every M and every channel count runs
// (edges are masked; 16-byte loads only where both channel counts are
// multiples of 8 and every pointer is 16-byte aligned).  Rounding as the
// JAX kernels: xa = round(round(x*mul_i) + add_i) with explicit _rn
// intrinsics, so no FMA contraction flips a gate; the gin gate compares in
// f32; dz, xa and dxa are rounded to the activation dtype; the sums and dW
// stay f32.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC; plain C entry points, bound with ctypes.

#include "site_common.cuh"

namespace {

// k1, k3: rows per thread (a block covers (THREADS / lanes) * RPT rows).
constexpr int RPT = 8;

// Eight elements from src[0..8) (vector) or from the ones below `left`
// (scalar, the rest 0).
template <typename T>
__device__ __forceinline__ void load8(T* dst, const T* src, int left, int vec) {
  if (vec) {
    copy8(dst, src);
  } else {
    for (int e = 0; e < 8; ++e) dst[e] = e < left ? src[e] : Num<T>::from(0.f);
  }
}
template <typename T>
__device__ __forceinline__ void store8(T* dst, const T* src, int left, int vec) {
  if (vec) {
    copy8(dst, src);
  } else {
    for (int e = 0; e < 8 && e < left; ++e) dst[e] = src[e];
  }
}

// Lanes across a row's 8-channel chunks in k1/k3: the chunks rounded up to
// a power of two, at most a warp.
int lanes(int channels) {
  const long long chunks = cdiv(channels, 8);
  int t = 1;
  while (t < chunks && t < 32) t *= 2;
  return t;
}

// ---------------------------------------------------------------------------
// k1: gp = g * mask and the [sum gp] partials.  grid (row tiles,
// ceil(ceil(co/8)/tx)); thread (lane, row) owns channels c0..c0+8 of rows
// row + q*(THREADS/tx).  part [row tiles][co].
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS)
k1_gate(const T* __restrict__ g, const int8_t* __restrict__ mask,
        T* __restrict__ gp, float* __restrict__ part, long long M, int co,
        int tx, int vec) {
  __shared__ float red[THREADS * 8];
  const int lane = threadIdx.x % tx, row = threadIdx.x / tx;
  const int ty = THREADS / tx, width = tx * 8;
  const int c0 = (blockIdx.y * tx + lane) * 8;
  const long long m0 = (long long)blockIdx.x * ty * RPT;
  float s[8];
  for (int e = 0; e < 8; ++e) s[e] = 0.f;
  if (c0 < co) {
    for (int q = 0; q < RPT; ++q) {
      const long long m = m0 + row + (long long)q * ty;
      if (m >= M) break;
      const long long off = m * co + c0;
      __align__(16) T gv[8], gpv[8];
      __align__(8) int8_t mv[8];
      load8(gv, g + off, co - c0, vec);
      if (vec) {
        *reinterpret_cast<uint2*>(mv) = *reinterpret_cast<const uint2*>(mask + off);
      } else {
        for (int e = 0; e < 8; ++e) mv[e] = c0 + e < co ? mask[off + e] : 0;
      }
      for (int e = 0; e < 8; ++e) {
        const float p = Num<T>::r(Num<T>::f(gv[e]) * (float)mv[e]);
        s[e] += p;
        gpv[e] = Num<T>::from(p);
      }
      store8(gp + off, gpv, co - c0, vec);
    }
  }
  for (int e = 0; e < 8; ++e) red[row * width + lane * 8 + e] = s[e];
  __syncthreads();
  const int c = blockIdx.y * width + threadIdx.x;
  if (threadIdx.x < width && c < co)
    part[(long long)blockIdx.x * co + c] = ordered_sum(red, ty, width, threadIdx.x);
}

// ---------------------------------------------------------------------------
// k2: dxa tile from dz = round(gp * mul_o), and (in the blocks of the first
// ci tile, the only ones that read z) the [sum gp*z] partials.
// grid (ceil(M/RM), ceil(ci/RN)); part [ceil(M/RM)][co].
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS)
k2_dxa(const T* __restrict__ gp, const T* __restrict__ z,
       const T* __restrict__ w, const float* __restrict__ mul_o,
       T* __restrict__ dxa, float* __restrict__ part, long long M, int ci,
       int co, int vec) {
  constexpr int K = RowsMma<T>::K, LD = RowsMma<T>::LD;
  constexpr int AB = (RM + RN) * LD * (int)sizeof(T);
  constexpr int CB = RM * LDC * (int)sizeof(float);
  __shared__ __align__(128) unsigned char smem[Max<AB, CB>::value];
  __shared__ float zred[THREADS * 8];
  T* sA = reinterpret_cast<T*>(smem);
  T* sB = sA + RM * LD;
  float* sC = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const long long m0 = (long long)blockIdx.x * RM;
  const int n0 = blockIdx.y * RN;
  const bool sums = blockIdx.y == 0;
  const T zero_t = Num<T>::from(0.f);
  // Threads that share one chunk column: the sums of channel k0 + kk are
  // zred[(lead + j*per) * 8 + comp] over j, added in order.
  const int per = vec ? K / 8 : K;

  RowsMma<T> acc;
  acc.zero();
  for (int k0 = 0; k0 < co; k0 += K) {
    float sgz[8];
    for (int q = 0; q < 8; ++q) sgz[q] = 0.f;
    if (vec) {
      for (int e = tid; e < RM * K / 8; e += THREADS) {
        const int r = e / (K / 8), kv = e % (K / 8) * 8;
        const long long m = m0 + r;
        if (m < M && k0 + kv < co) {
          const long long off = m * co + k0 + kv;
          __align__(16) T pv[8], dv[8], zv[8];
          copy8(pv, gp + off);
          if (sums) copy8(zv, z + off);
          for (int q = 0; q < 8; ++q) {
            const float p = Num<T>::f(pv[q]);
            dv[q] = Num<T>::from(__fmul_rn(p, mul_o[k0 + kv + q]));
            if (sums) sgz[q] += p * Num<T>::f(zv[q]);
          }
          copy8(sA + r * LD + kv, dv);
        } else {
          zero8(sA + r * LD + kv);
        }
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
        T d = zero_t;
        if (m < M && k0 + kk < co) {
          const long long off = m * co + k0 + kk;
          const float p = Num<T>::f(gp[off]);
          d = Num<T>::from(__fmul_rn(p, mul_o[k0 + kk]));
          if (sums) sgz[0] += p * Num<T>::f(z[off]);
        }
        sA[r * LD + kk] = d;
      }
      for (int e = tid; e < RN * K; e += THREADS) {
        const int n = e / K, kk = e % K;
        sB[n * LD + kk] = (n0 + n < ci && k0 + kk < co)
                              ? w[(long long)(n0 + n) * co + k0 + kk] : zero_t;
      }
    }
    if (sums)
      for (int q = 0; q < 8; ++q) zred[tid * 8 + q] = sgz[q];
    __syncthreads();
    if (sums && tid < K && k0 + tid < co) {
      const int lead = vec ? tid / 8 : tid, comp = vec ? tid % 8 : 0;
      float v = 0.f;
      for (int t = lead; t < THREADS; t += per) v += zred[t * 8 + comp];
      part[(long long)blockIdx.x * co + k0 + tid] = v;
    }
    acc.step(sA, sB);
    __syncthreads();
  }
  acc.store(sC);
  __syncthreads();
  const int nn = tid % RN, i = n0 + nn;
  for (int r = tid / RN; r < RM; r += THREADS / RN) {
    const long long m = m0 + r;
    if (i < ci && m < M) dxa[m * ci + i] = Num<T>::from(sC[r * LDC + nn]);
  }
}

// ---------------------------------------------------------------------------
// k3: dx and the [sum gin*x, sum gin] partials.  grid (row tiles,
// ceil(ceil(ci/8)/tx)), threads as k1.  part [row tiles][2][ci].
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS)
k3_dx(const T* __restrict__ dxa, const T* __restrict__ x,
      const float* __restrict__ mul_i, const float* __restrict__ add_i,
      T* __restrict__ dx, float* __restrict__ part, long long M, int ci,
      int tx, int vec) {
  __shared__ float red[2][THREADS * 8];
  const int lane = threadIdx.x % tx, row = threadIdx.x / tx;
  const int ty = THREADS / tx, width = tx * 8;
  const int c0 = (blockIdx.y * tx + lane) * 8;
  const long long m0 = (long long)blockIdx.x * ty * RPT;
  float mi[8], mi_t[8], ai_t[8], s_gx[8], s_gi[8];
  for (int e = 0; e < 8; ++e) {
    const bool in = c0 + e < ci;
    mi[e] = in ? mul_i[c0 + e] : 0.f;
    mi_t[e] = Num<T>::r(mi[e]);
    ai_t[e] = in ? Num<T>::r(add_i[c0 + e]) : 0.f;
    s_gx[e] = s_gi[e] = 0.f;
  }
  if (c0 < ci) {
    for (int q = 0; q < RPT; ++q) {
      const long long m = m0 + row + (long long)q * ty;
      if (m >= M) break;
      const long long off = m * ci + c0;
      __align__(16) T dv[8], xv[8], ov[8];
      load8(dv, dxa + off, ci - c0, vec);
      load8(xv, x + off, ci - c0, vec);
      for (int e = 0; e < 8; ++e) {
        const float xf = Num<T>::f(xv[e]);
        const float gin = affine_t<T>(xf, mi_t[e], ai_t[e]) > 0.f
                              ? Num<T>::f(dv[e]) : 0.f;
        ov[e] = Num<T>::from(__fmul_rn(gin, mi[e]));
        s_gx[e] += gin * xf;
        s_gi[e] += gin;
      }
      store8(dx + off, ov, ci - c0, vec);
    }
  }
  for (int e = 0; e < 8; ++e) {
    red[0][row * width + lane * 8 + e] = s_gx[e];
    red[1][row * width + lane * 8 + e] = s_gi[e];
  }
  __syncthreads();
  const int c = blockIdx.y * width + threadIdx.x;
  if (threadIdx.x < width && c < ci) {
    float* p = part + (long long)blockIdx.x * 2 * ci;
    p[c] = ordered_sum(red[0], ty, width, threadIdx.x);
    p[ci + c] = ordered_sum(red[1], ty, width, threadIdx.x);
  }
}

// ---------------------------------------------------------------------------
// k4: dW partials from xa (recomputed from x) and dz (recomputed from gp).
// grid (ceil(ci/WI), ceil(co/WK), splits); split s covers rows
// [s*rows, min(M, (s+1)*rows)); part_w [splits][ci][co].
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS)
k4_dw(const T* __restrict__ gp, const T* __restrict__ x,
      const float* __restrict__ mul_o, const float* __restrict__ mul_i,
      const float* __restrict__ add_i, float* __restrict__ part_w,
      long long M, int ci, int co, long long rows, int vec) {
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

  // The columns a thread loads are fixed: 8 from iv / kv (vector) or one,
  // xi / kk (scalar).
  const int iv = tid % (WI / 8) * 8, xi = tid % WI;
  const int kv = tid % (WK / 8) * 8, kk = tid % WK;
  float mi_t[8], ai_t[8], mo[8];
  for (int e = 0; e < 8; ++e) {
    const int i = i0 + (vec ? iv + e : xi);
    mi_t[e] = i < ci ? Num<T>::r(mul_i[i]) : 0.f;
    ai_t[e] = i < ci ? Num<T>::r(add_i[i]) : 0.f;
    const int c = k0 + (vec ? kv + e : kk);
    mo[e] = c < co ? mul_o[c] : 0.f;
  }
  auto act = [&](T v, int e) -> T {
    const float s = affine_t<T>(Num<T>::f(v), mi_t[e], ai_t[e]);
    return Num<T>::from(s > 0.f ? s : 0.f);
  };
  auto dz = [&](T v, int e) -> T {
    return Num<T>::from(__fmul_rn(Num<T>::f(v), mo[e]));
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
        const int r = e / (WK / 8);
        const long long m = mc + r;
        T* d = sD + r * LDD + kv;
        if (m < mend && k0 + kv < co) {
          __align__(16) T v[8];
          copy8(v, gp + m * co + k0 + kv);
          for (int q = 0; q < 8; ++q) v[q] = dz(v[q], q);
          copy8(d, v);
        } else {
          zero8(d);
        }
      }
    } else {
      for (int r = tid / WI; r < K; r += THREADS / WI) {
        const long long m = mc + r;
        sX[r * LDX + xi] = (m < mend && i0 + xi < ci)
                               ? act(x[m * ci + i0 + xi], 0) : zero_t;
      }
      for (int r = tid / WK; r < K; r += THREADS / WK) {
        const long long m = mc + r;
        sD[r * LDD + kk] = (m < mend && k0 + kk < co)
                               ? dz(gp[m * co + k0 + kk], 0) : zero_t;
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

// Row tiles of the elementwise kernels over C channels.
long long stream_tiles(long long M, int channels) {
  return cdiv(M, (long long)(THREADS / lanes(channels)) * RPT);
}

struct Layout {
  long long n1, n2, n3;           // partials of k1, k2, k3
  long long floats, scratch;      // workspace floats, of which scratch
};

Layout layout(long long M, int ci, int co, int splits) {
  Layout l;
  l.n1 = stream_tiles(M, co);
  l.n2 = cdiv(M, RM);
  l.n3 = stream_tiles(M, ci);
  long long s = scratch_floats(splits, (long long)ci * co);
  const long long s1 = scratch_floats(l.n1, co), s2 = scratch_floats(l.n2, co);
  const long long s3 = scratch_floats(l.n3, 2LL * ci);
  s = s > s1 ? s : s1;
  s = s > s2 ? s : s2;
  s = s > s3 ? s : s3;
  l.scratch = s;
  l.floats = (long long)splits * ci * co + (l.n1 + l.n2) * co +
             l.n3 * 2 * ci + s;
  return l;
}

template <typename T>
void launch_split(const void* g, const void* z, const void* mask,
                  const void* x, const void* w, const float* mul_o,
                  const float* mul_i, const float* add_i, void* dx, void* gp,
                  void* dxa, float* dw, float* sums_o, float* sums_i,
                  float* work, long long M, int ci, int co, int splits,
                  int vec, cudaStream_t stream) {
  const Layout l = layout(M, ci, co, splits);
  float* part_w = work;
  float* part_add = part_w + (long long)splits * ci * co;
  float* part_mul = part_add + l.n1 * co;
  float* part_i = part_mul + l.n2 * co;
  float* scratch = part_i + l.n3 * 2 * ci;
  T* gpt = static_cast<T*>(gp);
  T* dxat = static_cast<T*>(dxa);
  const int t1 = lanes(co), t3 = lanes(ci);

  k1_gate<T><<<dim3((unsigned)l.n1, (unsigned)cdiv(cdiv(co, 8), t1)), THREADS,
               0, stream>>>(static_cast<const T*>(g),
                            static_cast<const int8_t*>(mask), gpt, part_add,
                            M, co, t1, vec);
  k2_dxa<T><<<dim3((unsigned)l.n2, (unsigned)cdiv(ci, RN)), THREADS, 0,
              stream>>>(gpt, static_cast<const T*>(z),
                        static_cast<const T*>(w), mul_o, dxat, part_mul, M,
                        ci, co, vec);
  k3_dx<T><<<dim3((unsigned)l.n3, (unsigned)cdiv(cdiv(ci, 8), t3)), THREADS, 0,
             stream>>>(dxat, static_cast<const T*>(x), mul_i, add_i,
                       static_cast<T*>(dx), part_i, M, ci, t3, vec);
  constexpr int K = DwMma<T>::K;
  const long long rows = cdiv(cdiv(M, splits), K) * K;
  const unsigned nsplit = (unsigned)cdiv(M, rows);
  k4_dw<T><<<dim3((unsigned)cdiv(ci, WI), (unsigned)cdiv(co, WK), nsplit),
             THREADS, 0, stream>>>(gpt, static_cast<const T*>(x), mul_o,
                                   mul_i, add_i, part_w, M, ci, co, rows,
                                   vec);
  reduce_all(part_w, dw, nsplit, (long long)ci * co, scratch, stream);
  reduce_all(part_mul, sums_o, l.n2, co, scratch, stream);
  reduce_all(part_add, sums_o + co, l.n1, co, scratch, stream);
  reduce_all(part_i, sums_i, l.n3, 2LL * ci, scratch, stream);
}

}  // namespace

extern "C" {

// Floats of workspace ss_tail_site needs for this shape and split count.
long long ss_workspace_floats(long long M, int ci, int co, int splits) {
  return layout(M, ci, co, splits).floats;
}

// One tail site on `stream`.  dtype: 0 float32, 1 bfloat16.  Outputs: dx
// [M, ci], gp [M, co] (activation dtype), dw [ci, co], sums_o [2, co]
// (sum gp*z, sum gp), sums_i [2, ci] (sum gin*x, sum gin), all f32 but dx
// and gp.  dxa is an [M, ci] scratch of the activation dtype.  vec: 16-byte
// loads (both channel counts multiples of 8, every pointer 16-byte
// aligned).  Returns cudaGetLastError().
int ss_tail_site(int dtype, const void* g, const void* z, const void* mask,
                 const void* x, const void* w, const void* mul_o,
                 const void* mul_i, const void* add_i, void* dx, void* gp,
                 void* dxa, void* dw, void* sums_o, void* sums_i, void* work,
                 long long M, int ci, int co, int splits, int vec,
                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout l = layout(M > 0 ? M : 1, ci > 0 ? ci : 1, co > 0 ? co : 1,
                          splits > 0 ? splits : 1);
  // Two reduction passes cover at most RED_CHUNK^2 partials.
  const long long most = (long long)RED_CHUNK * RED_CHUNK;
  if (M <= 0 || ci <= 0 || co <= 0 || splits < 1 || l.n1 > most ||
      l.n2 > most || l.n3 > most || splits > most)
    return (int)cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto fw = [](void* p) { return static_cast<float*>(p); };
  if (dtype == 1)
    launch_split<bf16>(g, z, mask, x, w, f(mul_o), f(mul_i), f(add_i), dx,
                       gp, dxa, fw(dw), fw(sums_o), fw(sums_i), fw(work), M,
                       ci, co, splits, vec, s);
  else if (dtype == 0)
    launch_split<float>(g, z, mask, x, w, f(mul_o), f(mul_i), f(add_i), dx,
                        gp, dxa, fw(dw), fw(sums_o), fw(sums_i), fw(work), M,
                        ci, co, splits, vec, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
