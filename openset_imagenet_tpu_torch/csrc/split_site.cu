// K6 for Hopper: the tail-site backward as four streaming kernels.
//
// Replaces the Pallas kernels `_k1_gate`, `_k2_dxa`, `_k3_dx` and `_k4_dw`
// of openset_imagenet_tpu/experimental/split_site.py:73,89,110,134 (reached
// through `tail_site_split`).  The site is the tail of a bottleneck (int8
// boundary gate, input activation, gp emitted); per row m of M = N*H*W and
// channel c (see experimental/split_site.py for the plain version it is
// held to):
//
//   k1 (g, mask -> gp)   gp = g * mask, and its [sum gp] partials
//   k2 (gp, z -> dxa)    dz = round(gp * mul_o), dxa = round(dz @ W^T)
//                        (f32 accumulate), and the [sum gp*z] partials
//   k3 (dxa, x -> dx)    xa = relu(round(round(x*mul_i) + add_i)),
//                        gin = dxa * (xa > 0), dx = round(gin * mul_i), and
//                        the [sum gin*x, sum gin] partials
//   k4 (gp, x -> dW)     xa and dz recomputed, one f32 dW partial per M-split
//
// then one launch of `reduce_sets` adds the four sets of partials, each in
// a fixed order.  Each kernel makes at most two large reads and one large
// write, and dxa round-trips through device memory in the activation dtype:
// that structure is what the split form exists to measure against the
// unified site (K5, csrc/fused_block_bwd.cu), so it is kept and not fused
// back.
//
// What bounds it on the H100: bytes.  At the resnet50 stage-1 tail (M =
// 802,816, ci = 64, co = 256, bf16) the four kernels move 3,456 bytes a row
// (2.775 GB, 0.83 ms at 3.35 TB/s) against the 2,048 bytes a row that the
// function needs (1.644 GB, 0.49 ms); the 52.6 GFLOP of the two products
// take 0.05 ms at the bf16 tensor-core rate.  At the stage-4 tail (M =
// 12,544, ci = 512, co = 2048) the products weigh as much as the bytes.
//
// k1 and k3 (every route) are elementwise passes with 16-byte loads, lanes
// across channels and rows across warps; each thread issues the loads of
// its eight rows before it uses any, and each block walks a contiguous
// range of row tiles, so a block writes one partial however large M is.
// k2 and k4 take one of two routes, chosen by experimental/split_site.py
// (`_plan`) from the shape, the dtype and the alignment alone:
//
// tensor_cores (bf16, both channel counts multiples of 64, 16-byte aligned
//   rows; every resnet50 tail): the Hopper machinery of K5's tiled route
//   (csrc/hopper.cuh).  Each step's tiles arrive by TMA (128-byte swizzle,
//   the layout wgmma reads) into a three-slot ring; while one step's wgmma
//   group runs, the threads form the next step's operand in shared memory,
//   in place on the swizzled tile.
//   k2_dxa_tc: a persistent block walks its own contiguous range of
//     64-row tiles for a column tile of up to 256 of ci (gp is read once
//     at stages 1-3, twice at stage 4); dz = round(gp * mul_o) is formed
//     over the gp tile; the two warpgroups split the columns; each 64-deep
//     step starts from zero on the tensor cores and is added to the running
//     sum with a rounded f32 add (summed on the tensor cores through all of
//     co, dxa's rounding to bf16 moved the input-side sums 1.0e-4 from a
//     float64 product at stage 4, against 3.6e-5 for torch's product); dxa
//     leaves in bf16 by TMA stores.  Only the blocks of the first column
//     tile load z, for the [sum gp*z] partial, added per step across warps
//     in a fixed order into one partial per block.
//   k4_dw_tc: dW tiles of 128 (64 at ci = 64) x 256 channels per M-split,
//     xa and dz formed in place over the TMA'd x and gp tiles, both
//     products on wgmma; the splits fill one wave of one block per SM.
// generic (f32, and bf16 channel counts that are not multiples of 64):
//   k2_dxa and k4_dw, the product loops of K5's generic stages (bf16 tiles
//   through shared memory into `nvcuda::wmma`, FMA in f32), dz computed
//   from gp while the tile is loaded; every M and channel count.
//
// No float atomics: two launches on the same inputs give the same bits.
// Rounding as the JAX kernels: xa = round(round(x*mul_i) + add_i) with
// explicit _rn intrinsics, so no FMA contraction flips a gate; the gin gate
// compares in f32; dz, xa and dxa are rounded to the activation dtype; the
// sums and dW stay f32.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC; plain C entry points, bound with ctypes.

#include "hopper.cuh"
#include "site_common.cuh"

namespace {

// k1, k3: rows per thread in a row tile (a tile is (THREADS / lanes) * RPT
// rows).
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

// Row tiles of the elementwise kernels over C channels.
long long stream_tiles(long long M, int channels) {
  return cdiv(M, (long long)(THREADS / lanes(channels)) * RPT);
}

// ---------------------------------------------------------------------------
// k1: gp = g * mask and the [sum gp] partials.  grid (blocks, ceil(ceil(co/
// 8)/tx)); block b walks row tiles [b*tiles/blocks, (b+1)*tiles/blocks);
// thread (lane, row) owns channels c0..c0+8 of rows row + q*(THREADS/tx) of
// each tile.  part [blocks][co].
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS)
k1_gate(const T* __restrict__ g, const int8_t* __restrict__ mask,
        T* __restrict__ gp, float* __restrict__ part, long long M, int co,
        int tx, int vec, long long tiles) {
  __shared__ float red[THREADS * 8];
  const int lane = threadIdx.x % tx, row = threadIdx.x / tx;
  const int ty = THREADS / tx, width = tx * 8;
  const int c0 = (blockIdx.y * tx + lane) * 8;
  const long long t_begin = (long long)blockIdx.x * tiles / gridDim.x;
  const long long t_end = (long long)(blockIdx.x + 1) * tiles / gridDim.x;
  float s[8];
  for (int e = 0; e < 8; ++e) s[e] = 0.f;
  if (c0 < co) {
    for (long long t = t_begin; t < t_end; ++t) {
      const long long m0 = t * ty * RPT + row;
      __align__(16) T gv[RPT][8];
      __align__(8) int8_t mv[RPT][8];
#pragma unroll
      for (int q = 0; q < RPT; ++q) {   // every load before any use
        const long long m = m0 + (long long)q * ty, off = m * co + c0;
        if (m < M) {
          load8(gv[q], g + off, co - c0, vec);
          if (vec) {
            *reinterpret_cast<uint2*>(mv[q]) =
                *reinterpret_cast<const uint2*>(mask + off);
          } else {
            for (int e = 0; e < 8; ++e) mv[q][e] = c0 + e < co ? mask[off + e] : 0;
          }
        } else {
          for (int e = 0; e < 8; ++e) {
            gv[q][e] = Num<T>::from(0.f);
            mv[q][e] = 0;
          }
        }
      }
#pragma unroll
      for (int q = 0; q < RPT; ++q) {
        const long long m = m0 + (long long)q * ty;
        if (m >= M) break;
        __align__(16) T gpv[8];
        for (int e = 0; e < 8; ++e) {
          const float p = Num<T>::r(Num<T>::f(gv[q][e]) * (float)mv[q][e]);
          s[e] += p;
          gpv[e] = Num<T>::from(p);
        }
        store8(gp + m * co + c0, gpv, co - c0, vec);
      }
    }
  }
  for (int e = 0; e < 8; ++e) red[row * width + lane * 8 + e] = s[e];
  __syncthreads();
  const int c = blockIdx.y * width + threadIdx.x;
  if (threadIdx.x < width && c < co)
    part[(long long)blockIdx.x * co + c] = ordered_sum(red, ty, width, threadIdx.x);
}

// ---------------------------------------------------------------------------
// k3: dx and the [sum gin*x, sum gin] partials.  grid and threads as k1
// over ci.  part [blocks][2][ci].
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS)
k3_dx(const T* __restrict__ dxa, const T* __restrict__ x,
      const float* __restrict__ mul_i, const float* __restrict__ add_i,
      T* __restrict__ dx, float* __restrict__ part, long long M, int ci,
      int tx, int vec, long long tiles) {
  __shared__ float red[2][THREADS * 8];
  const int lane = threadIdx.x % tx, row = threadIdx.x / tx;
  const int ty = THREADS / tx, width = tx * 8;
  const int c0 = (blockIdx.y * tx + lane) * 8;
  const long long t_begin = (long long)blockIdx.x * tiles / gridDim.x;
  const long long t_end = (long long)(blockIdx.x + 1) * tiles / gridDim.x;
  float mi[8], mi_t[8], ai_t[8], s_gx[8], s_gi[8];
  for (int e = 0; e < 8; ++e) {
    const bool in = c0 + e < ci;
    mi[e] = in ? mul_i[c0 + e] : 0.f;
    mi_t[e] = Num<T>::r(mi[e]);
    ai_t[e] = in ? Num<T>::r(add_i[c0 + e]) : 0.f;
    s_gx[e] = s_gi[e] = 0.f;
  }
  if (c0 < ci) {
    for (long long t = t_begin; t < t_end; ++t) {
      const long long m0 = t * ty * RPT + row;
      __align__(16) T dv[RPT][8], xv[RPT][8];
#pragma unroll
      for (int q = 0; q < RPT; ++q) {   // every load before any use
        const long long m = m0 + (long long)q * ty, off = m * ci + c0;
        if (m < M) {
          load8(dv[q], dxa + off, ci - c0, vec);
          load8(xv[q], x + off, ci - c0, vec);
        } else {
          for (int e = 0; e < 8; ++e) dv[q][e] = xv[q][e] = Num<T>::from(0.f);
        }
      }
#pragma unroll
      for (int q = 0; q < RPT; ++q) {
        const long long m = m0 + (long long)q * ty;
        if (m >= M) break;
        __align__(16) T ov[8];
        for (int e = 0; e < 8; ++e) {
          const float xf = Num<T>::f(xv[q][e]);
          const float gin = affine_t<T>(xf, mi_t[e], ai_t[e]) > 0.f
                                ? Num<T>::f(dv[q][e]) : 0.f;
          ov[e] = Num<T>::from(__fmul_rn(gin, mi[e]));
          s_gx[e] += gin * xf;
          s_gi[e] += gin;
        }
        store8(dx + m * ci + c0, ov, ci - c0, vec);
      }
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
// Route "generic", k2: dxa tile from dz = round(gp * mul_o), and (in the
// blocks of the first ci tile, the only ones that read z) the [sum gp*z]
// partials.  grid (ceil(M/RM), ceil(ci/RN)); part [ceil(M/RM)][co].
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
// Route "generic", k4: dW partials from xa (recomputed from x) and dz
// (recomputed from gp).  grid (ceil(ci/WI), ceil(co/WK), splits); split s
// covers rows [s*rows, min(M, (s+1)*rows)); part_w [splits][ci][co].
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

// ---------------------------------------------------------------------------
// Route "tensor_cores".  A ring step is 64 rows (one wgmma M) by 64
// channels; each operand arrives as [64][64] bf16 atoms (8 KB, 128-byte
// swizzle) and is formed in place: a thread owns 8-channel granule tid % 8
// of rows tid/8 and tid/8 + 32 of each atom it touches.  The loop of both
// kernels: step s commits its wgmma group, the threads wait for step s+1's
// tiles and form its operand while the group runs, then wait for the group,
// pass a block barrier and refill the freed slot with step s+3.
// ---------------------------------------------------------------------------

constexpr int TR = 64;            // rows of a ring step
constexpr int ATOM = TR * 128;    // bytes of one swizzled [64][64] bf16 atom
constexpr int STAGES = 3;         // ring depth: in the products, formed, loading
constexpr int TC_THREADS = 256;   // two warpgroups
constexpr int SMEM_LIMIT = 232448;
constexpr int K4_CO = 256;        // co columns of a k4_dw_tc tile

// Byte offsets of k2_dxa_tc's shared memory from a 1024-aligned base: the
// ring (gp -> dz, z, W), the staged dxa tile, the block's [sum gp*z] over
// co, and two [8 warps][64] steps of warp sums.  experimental/split_site.py
// (`_k2_smem`) keeps the same sizes.
struct K2Layout {
  int a, z, b, slot, stage, sgz, red, total;
  __host__ __device__ K2Layout(int bn, int co) {
    a = 0;
    z = ATOM;
    b = 2 * ATOM;
    slot = b + bn * 128;
    stage = STAGES * slot;
    sgz = stage + bn * 128;
    red = sgz + co * 4;
    total = red + 2 * 8 * 64 * 4 + 1024;
  }
};

// dxa = round(dz @ W^T) for the 64-row tiles [t0, t1) of one block and the
// BN columns of ci from blockIdx.y * BN, co in 64-deep steps; with
// blockIdx.y == 0 also the block's [sum gp*z] partial.  grid (blocks,
// ceil(ci/BN)); part [blocks][co].
template <int BN>
__global__ void __launch_bounds__(TC_THREADS, 1)
k2_dxa_tc(const __grid_constant__ CUtensorMap mgp,
          const __grid_constant__ CUtensorMap mz,
          const __grid_constant__ CUtensorMap mw,
          const __grid_constant__ CUtensorMap mdxa,
          const float* __restrict__ mul_o, float* __restrict__ part,
          long long M, int co) {
  constexpr int NW = BN / 2;                  // columns of a warpgroup
  constexpr int NCOL = NW >= 64 ? 32 : 16;    // accumulators of one wgmma
  constexpr int NN = NW >= 64 ? NW / 64 : 1;  // wgmmas per 16-deep step
  constexpr int CW = NCOL * 2;                // columns of one wgmma
  extern __shared__ unsigned char raw[];
  __shared__ __align__(8) uint64_t full[STAGES];
  unsigned char* base = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
  const K2Layout L(BN, co);
  float* const sgz = reinterpret_cast<float*>(base + L.sgz);
  float* const red = reinterpret_cast<float*>(base + L.red);
  unsigned char* const stage = base + L.stage;
  const int tid = threadIdx.x, wg = tid / 128, warp = tid / 32;
  const int lane = tid % 32, gran = tid % 8;
  const bool sums = blockIdx.y == 0;
  const int n0 = blockIdx.y * BN, nk = co / 64;
  const long long tiles = cdiv(M, TR);
  const long long t0 = (long long)blockIdx.x * tiles / gridDim.x;
  const long long t1 = (long long)(blockIdx.x + 1) * tiles / gridDim.x;
  const long long n = (t1 - t0) * nk;
  auto slot = [&](long long s) { return base + (int)(s % STAGES) * L.slot; };
  auto issue = [&](long long s) {
    unsigned char* p = slot(s);
    uint64_t* bar = &full[s % STAGES];
    const int row = (int)((t0 + s / nk) * TR), col = (int)(s % nk) * 64;
    mbar_expect(bar, (sums ? 2 : 1) * ATOM + BN * 128);
    tma_load(p + L.a, &mgp, col, row, bar);
    if (sums) tma_load(p + L.z, &mz, col, row, bar);
    tma_load(p + L.b, &mw, col, n0, bar);
  };
  // dz = round(gp * mul_o) over step s's gp tile in place; with sums, each
  // warp's [sum gp*z] of its rows into red[s & 1][warp][64].
  auto form = [&](long long s) {
    unsigned char* p = slot(s);
    const int k0 = (int)(s % nk) * 64 + gran * 8;
    float mo[8], sg[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      mo[e] = __ldg(mul_o + k0 + e);
      sg[e] = 0.f;
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int off = swz(tid / 8 + 32 * q, gran);
      __align__(16) bf16 v[8], zv[8];
      *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(p + L.a + off);
      if (sums)
        *reinterpret_cast<uint4*>(zv) = *reinterpret_cast<const uint4*>(p + L.z + off);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float gv = Num<bf16>::f(v[e]);
        if (sums) sg[e] += gv * Num<bf16>::f(zv[e]);
        v[e] = Num<bf16>::from(__fmul_rn(gv, mo[e]));
      }
      *reinterpret_cast<uint4*>(p + L.a + off) = *reinterpret_cast<uint4*>(v);
    }
    if (sums) {
      // The warp's four row groups of one granule, in a fixed order.
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        sg[e] += __shfl_xor_sync(0xffffffffu, sg[e], 8);
        sg[e] += __shfl_xor_sync(0xffffffffu, sg[e], 16);
      }
      if (lane < 8)
#pragma unroll
        for (int e = 0; e < 8; ++e)
          red[((int)(s & 1) * 8 + warp) * 64 + lane * 8 + e] = sg[e];
    }
  };

  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) mbar_init(&full[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (long long s = 0; s < STAGES && s < n; ++s) issue(s);
  }
  for (int c = tid; c < co; c += TC_THREADS) sgz[c] = 0.f;
  float acc[NN][NCOL], tmp[NN][NCOL];
#pragma unroll
  for (int j = 0; j < NN; ++j)
#pragma unroll
    for (int k = 0; k < NCOL; ++k) acc[j][k] = 0.f;
  __syncthreads();
  if (n > 0) {
    mbar_wait(&full[0], 0);
    form(0);
  }
  fence_async_smem();
  __syncthreads();

  for (long long s = 0; s < n; ++s) {
    const unsigned char* p = slot(s);
    const int kc = (int)(s % nk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da = desc(p + L.a + kk * 32);
#pragma unroll
      for (int j = 0; j < NN; ++j) {
        const uint64_t db = desc(p + L.b + (wg * NW + j * CW) * 128 + kk * 32);
        if constexpr (NCOL == 32) wgmma_n64<0, 0>(tmp[j], da, db, kk > 0);
        else wgmma_n32<0, 0>(tmp[j], da, db, kk > 0);
      }
    }
    wgmma_commit();
    if (sums && tid < 64) {   // step s's warp sums, the warps in order
      const float* r = red + (int)(s & 1) * 8 * 64 + tid;
      float v = r[0];
      for (int w8 = 1; w8 < 8; ++w8) v += r[w8 * 64];
      sgz[kc * 64 + tid] += v;
    }
    if (s + 1 < n) {
      mbar_wait(&full[(s + 1) % STAGES], (uint32_t)(((s + 1) / STAGES) & 1));
      form(s + 1);
      fence_async_smem();
    }
    wgmma_wait();
#pragma unroll
    for (int j = 0; j < NN; ++j)
#pragma unroll
      for (int k = 0; k < NCOL; ++k) acc[j][k] = __fadd_rn(acc[j][k], tmp[j][k]);
    if (kc == nk - 1) {
      // The tile's dxa in bf16 into the staged tile, one TMA store per 64
      // columns (rows past M and columns past ci are not written).
#pragma unroll
      for (int j = 0; j < NN; ++j)
#pragma unroll
        for (int jj = 0; jj < CW / 8; ++jj)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = (warp % 4) * 16 + (lane >> 2) + h * 8;
            const int c = wg * NW + j * CW + jj * 8 + (lane & 3) * 2;
            *reinterpret_cast<__nv_bfloat162*>(stage + tile_off(r, c, ATOM)) =
                __floats2bfloat162_rn(acc[j][jj * 4 + h * 2],
                                      acc[j][jj * 4 + h * 2 + 1]);
            acc[j][jj * 4 + h * 2] = acc[j][jj * 4 + h * 2 + 1] = 0.f;
          }
      fence_async_smem();
      __syncthreads();
      if (tid == 0) {
        const int row = (int)((t0 + s / nk) * TR);
        for (int a = 0; a < BN / 64; ++a)
          tma_store(&mdxa, n0 + a * 64, row, stage + a * ATOM);
        bulk_commit();
        bulk_wait_read();   // the staged tile is free before the barrier
      }
    }
    __syncthreads();   // step s's slot is read by every warpgroup
    if (tid == 0 && s + STAGES < n) issue(s + STAGES);
  }
  if (tid == 0) bulk_wait();
  if (sums) {
    __syncthreads();
    for (int c = tid; c < co; c += TC_THREADS)
      part[(long long)blockIdx.x * co + c] = sgz[c];
  }
}

// Byte offsets of k4_dw_tc's shared memory from a 1024-aligned base: the
// ring (x -> xa, gp -> dz), then the rounded mul_i and add_i of the tile's
// ci columns and the mul_o of its co columns.  split_site.py (`_k4_smem`)
// keeps the same sizes.
struct K4Layout {
  int d, slot, vec, total;
  __host__ __device__ explicit K4Layout(int bi) {
    d = bi / 64 * ATOM;
    slot = d + K4_CO / 64 * ATOM;
    vec = STAGES * slot;
    total = vec + (2 * bi + K4_CO) * 4 + 1024;
  }
};

// The dW partial of one M-split for a BI x 256 tile of (ci, co): xa^T dz
// over 64-row steps.  BI = 128: warpgroup w takes ci rows 64w..64w+64 and
// all 256 columns; BI = 64: all 64 rows and columns 128w..128w+128.  grid
// (ceil(ci/BI), ceil(co/256), splits); split s covers rows [s*rows, min(M,
// (s+1)*rows)), rows a multiple of 64; part_w [splits][ci][co].
template <int BI>
__global__ void __launch_bounds__(TC_THREADS, 1)
k4_dw_tc(const __grid_constant__ CUtensorMap mx,
         const __grid_constant__ CUtensorMap mgp,
         const float* __restrict__ mul_o, const float* __restrict__ mul_i,
         const float* __restrict__ add_i, float* __restrict__ part_w,
         long long M, int ci, int co, long long rows) {
  constexpr int NX = BI / 64;                  // x atoms of a step
  constexpr int NA = NX + K4_CO / 64;          // atoms of a step
  constexpr int NB = BI == 128 ? 4 : 2;        // n64 products of a warpgroup
  extern __shared__ unsigned char raw[];
  __shared__ __align__(8) uint64_t full[STAGES];
  unsigned char* base = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
  const K4Layout L(BI);
  float* const smi = reinterpret_cast<float*>(base + L.vec);
  float* const sai = smi + BI;
  float* const smo = sai + BI;
  const int tid = threadIdx.x, wg = tid / 128, warp = tid / 32;
  const int lane = tid % 32, gran = tid % 8;
  const int i0 = blockIdx.x * BI, k0 = blockIdx.y * K4_CO;
  const long long mbeg = (long long)blockIdx.z * rows;
  const long long mend = mbeg + rows < M ? mbeg + rows : M;
  const long long n = mend > mbeg ? cdiv(mend - mbeg, TR) : 0;
  auto slot = [&](long long s) { return base + (int)(s % STAGES) * L.slot; };
  auto issue = [&](long long s) {
    unsigned char* p = slot(s);
    uint64_t* bar = &full[s % STAGES];
    const int row = (int)(mbeg + s * TR);
    mbar_expect(bar, NA * ATOM);
    for (int a = 0; a < NX; ++a) tma_load(p + a * ATOM, &mx, i0 + a * 64, row, bar);
    for (int a = 0; a < K4_CO / 64; ++a)
      tma_load(p + L.d + a * ATOM, &mgp, k0 + a * 64, row, bar);
  };
  // xa = relu(round(round(x*mul_i) + add_i)) and dz = round(gp * mul_o) in
  // place over step s's tiles (columns past ci or co stay 0).
  auto form = [&](long long s) {
    unsigned char* p = slot(s);
#pragma unroll
    for (int i = 0; i < 2 * NA; ++i) {
      const int a = i / 2, off = a * ATOM + swz(tid / 8 + 32 * (i % 2), gran);
      __align__(16) bf16 v[8];
      *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(p + off);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float f = Num<bf16>::f(v[e]);
        if (a < NX) {
          const int c = a * 64 + gran * 8 + e;
          const float t = affine_t<bf16>(f, smi[c], sai[c]);
          v[e] = Num<bf16>::from(t > 0.f ? t : 0.f);
        } else {
          v[e] = Num<bf16>::from(__fmul_rn(f, smo[(a - NX) * 64 + gran * 8 + e]));
        }
      }
      *reinterpret_cast<uint4*>(p + off) = *reinterpret_cast<uint4*>(v);
    }
  };

  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) mbar_init(&full[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (long long s = 0; s < STAGES && s < n; ++s) issue(s);
  }
  for (int c = tid; c < BI; c += TC_THREADS) {
    smi[c] = i0 + c < ci ? Num<bf16>::r(mul_i[i0 + c]) : 0.f;
    sai[c] = i0 + c < ci ? Num<bf16>::r(add_i[i0 + c]) : 0.f;
  }
  for (int c = tid; c < K4_CO; c += TC_THREADS)
    smo[c] = k0 + c < co ? mul_o[k0 + c] : 0.f;
  float acc[NB][32];
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int k = 0; k < 32; ++k) acc[j][k] = 0.f;
  __syncthreads();
  if (n > 0) {
    mbar_wait(&full[0], 0);
    form(0);
  }
  fence_async_smem();
  __syncthreads();

  for (long long s = 0; s < n; ++s) {
    const unsigned char* p = slot(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da = desc(p + (BI == 128 ? wg : 0) * ATOM + kk * 2048);
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const int atom = BI == 128 ? j : wg * 2 + j;
        wgmma_n64<1, 1>(acc[j], da, desc(p + L.d + atom * ATOM + kk * 2048));
      }
    }
    wgmma_commit();
    if (s + 1 < n) {
      mbar_wait(&full[(s + 1) % STAGES], (uint32_t)(((s + 1) / STAGES) & 1));
      form(s + 1);
      fence_async_smem();
    }
    wgmma_wait();
    __syncthreads();   // step s's slot is read by every warpgroup
    if (tid == 0 && s + STAGES < n) issue(s + STAGES);
  }
  float* pw = part_w + (long long)blockIdx.z * ci * co;
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = i0 + (BI == 128 ? wg * 64 : 0) + (warp % 4) * 16 +
                      (lane >> 2) + h * 8;
        const int c = k0 + (BI == 128 ? j : wg * 2 + j) * 64 + jj * 8 +
                      (lane & 3) * 2;
        if (i < ci && c < co)
          *reinterpret_cast<float2*>(pw + (long long)i * co + c) =
              make_float2(acc[j][jj * 4 + h * 2], acc[j][jj * 4 + h * 2 + 1]);
      }
}

// ---------------------------------------------------------------------------
// The four sets of partials in one launch: out_k[j] = sum over t of
// part_k[t][j], lane y of a column adding t = y, y+8, ... in order, then
// the eight lanes in order.  grid (the sets' column blocks), block (RED_X,
// RED_Y).
// ---------------------------------------------------------------------------

struct Sets {
  const float* part[4];
  float* out[4];
  long long parts[4];     // partials of each set
  long long n[4];         // outputs of each set
  long long first[5];     // the first column block of each set
};

__global__ void __launch_bounds__(RED_X * RED_Y)
reduce_sets(const Sets sets) {
  __shared__ float r[RED_Y][RED_X + 1];
  int k = 0;
  while (k < 3 && (long long)blockIdx.x >= sets.first[k + 1]) ++k;
  const long long n = sets.n[k];
  const long long j = ((long long)blockIdx.x - sets.first[k]) * RED_X + threadIdx.x;
  const float* part = sets.part[k];
  float acc = 0.f;
  if (j < n)
    for (long long t = threadIdx.y; t < sets.parts[k]; t += RED_Y)
      acc += part[t * n + j];
  r[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && j < n) {
    float v = r[0][threadIdx.x];
    for (int y = 1; y < RED_Y; ++y) v += r[y][threadIdx.x];
    sets.out[k][j] = v;
  }
}

// ---------------------------------------------------------------------------
// Host side.
// ---------------------------------------------------------------------------

struct Split {
  const void *g, *z, *mask, *x, *w;
  const float *mul_o, *mul_i, *add_i;
  void *dx, *gp, *dxa;
  float *dw, *sums_o, *sums_i, *work;
  long long M;
  int ci, co, g1, g3, p2, splits, bn, bi, vec;
  cudaStream_t stream;
};

// Floats of workspace: the dW partials [splits][ci][co], then those of k1
// [g1][co], k2 [p2][co] and k3 [g3][2][ci].
long long workspace(int ci, int co, int g1, int g3, int p2, int splits) {
  return (long long)splits * ci * co + ((long long)g1 + p2) * co +
         (long long)g3 * 2 * ci;
}

template <typename T>
void launch_k1(const Split& S, float* part_add) {
  const int t1 = lanes(S.co);
  k1_gate<T><<<dim3((unsigned)S.g1, (unsigned)cdiv(cdiv(S.co, 8), t1)),
               THREADS, 0, S.stream>>>(
      static_cast<const T*>(S.g), static_cast<const int8_t*>(S.mask),
      static_cast<T*>(S.gp), part_add, S.M, S.co, t1, S.vec,
      stream_tiles(S.M, S.co));
}

template <typename T>
void launch_k3(const Split& S, float* part_i) {
  const int t3 = lanes(S.ci);
  k3_dx<T><<<dim3((unsigned)S.g3, (unsigned)cdiv(cdiv(S.ci, 8), t3)), THREADS,
             0, S.stream>>>(
      static_cast<const T*>(S.dxa), static_cast<const T*>(S.x), S.mul_i,
      S.add_i, static_cast<T*>(S.dx), part_i, S.M, S.ci, t3, S.vec,
      stream_tiles(S.M, S.ci));
}

void launch_reduce(const Split& S, const float* part_w, long long nsplit,
                   const float* part_mul, const float* part_add,
                   const float* part_i) {
  Sets sets;
  const float* parts[4] = {part_w, part_mul, part_add, part_i};
  float* outs[4] = {S.dw, S.sums_o, S.sums_o + S.co, S.sums_i};
  const long long counts[4] = {nsplit, S.p2, S.g1, S.g3};
  const long long ns[4] = {(long long)S.ci * S.co, S.co, S.co, 2LL * S.ci};
  sets.first[0] = 0;
  for (int k = 0; k < 4; ++k) {
    sets.part[k] = parts[k];
    sets.out[k] = outs[k];
    sets.parts[k] = counts[k];
    sets.n[k] = ns[k];
    sets.first[k + 1] = sets.first[k] + cdiv(ns[k], RED_X);
  }
  reduce_sets<<<(unsigned)sets.first[4], dim3(RED_X, RED_Y), 0, S.stream>>>(sets);
}

template <typename T>
int launch_generic(const Split& S) {
  float* part_w = S.work;
  float* part_add = part_w + (long long)S.splits * S.ci * S.co;
  float* part_mul = part_add + (long long)S.g1 * S.co;
  float* part_i = part_mul + (long long)S.p2 * S.co;
  launch_k1<T>(S, part_add);
  k2_dxa<T><<<dim3((unsigned)S.p2, (unsigned)cdiv(S.ci, RN)), THREADS, 0,
              S.stream>>>(static_cast<const T*>(S.gp),
                          static_cast<const T*>(S.z),
                          static_cast<const T*>(S.w), S.mul_o,
                          static_cast<T*>(S.dxa), part_mul, S.M, S.ci, S.co,
                          S.vec);
  launch_k3<T>(S, part_i);
  constexpr int K = DwMma<T>::K;
  const long long rows = cdiv(cdiv(S.M, S.splits), K) * K;
  const long long nsplit = cdiv(S.M, rows);
  k4_dw<T><<<dim3((unsigned)cdiv(S.ci, WI), (unsigned)cdiv(S.co, WK),
                  (unsigned)nsplit), THREADS, 0, S.stream>>>(
      static_cast<const T*>(S.gp), static_cast<const T*>(S.x), S.mul_o,
      S.mul_i, S.add_i, part_w, S.M, S.ci, S.co, rows, S.vec);
  launch_reduce(S, part_w, nsplit, part_mul, part_add, part_i);
  return (int)cudaGetLastError();
}

template <int BN>
void launch_k2_tc(const Split& S, const CUtensorMap& mgp, const CUtensorMap& mz,
                  const CUtensorMap& mw, const CUtensorMap& mdxa,
                  float* part_mul, int smem) {
  auto kernel = k2_dxa_tc<BN>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  kernel<<<dim3((unsigned)S.p2, (unsigned)cdiv(S.ci, BN)), TC_THREADS, smem,
           S.stream>>>(mgp, mz, mw, mdxa, S.mul_o, part_mul, S.M, S.co);
}

template <int BI>
void launch_k4_tc(const Split& S, const CUtensorMap& mx, const CUtensorMap& mgp,
                  float* part_w, long long rows, long long nsplit, int smem) {
  auto kernel = k4_dw_tc<BI>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  kernel<<<dim3((unsigned)cdiv(S.ci, BI), (unsigned)cdiv(S.co, K4_CO),
                (unsigned)nsplit), TC_THREADS, smem, S.stream>>>(
      mx, mgp, S.mul_o, S.mul_i, S.add_i, part_w, S.M, S.ci, S.co, rows);
}

int launch_tensor_cores(const Split& S) {
  const int smem2 = K2Layout(S.bn, S.co).total, smem4 = K4Layout(S.bi).total;
  if (smem2 > SMEM_LIMIT || smem4 > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  CUtensorMap mgp, mz, mw, mdxa, mx;
  if (!(make_map(&mgp, S.gp, S.M, S.co, TR) && make_map(&mz, S.z, S.M, S.co, TR) &&
        make_map(&mw, S.w, S.ci, S.co, S.bn) &&
        make_map(&mdxa, S.dxa, S.M, S.ci, TR) && make_map(&mx, S.x, S.M, S.ci, TR)))
    return (int)cudaErrorInvalidValue;
  float* part_w = S.work;
  float* part_add = part_w + (long long)S.splits * S.ci * S.co;
  float* part_mul = part_add + (long long)S.g1 * S.co;
  float* part_i = part_mul + (long long)S.p2 * S.co;
  launch_k1<bf16>(S, part_add);
  if (S.bn == 256) launch_k2_tc<256>(S, mgp, mz, mw, mdxa, part_mul, smem2);
  else if (S.bn == 128) launch_k2_tc<128>(S, mgp, mz, mw, mdxa, part_mul, smem2);
  else launch_k2_tc<64>(S, mgp, mz, mw, mdxa, part_mul, smem2);
  launch_k3<bf16>(S, part_i);
  const long long rows = cdiv(cdiv(S.M, S.splits), TR) * TR;
  const long long nsplit = cdiv(S.M, rows);
  if (S.bi == 128) launch_k4_tc<128>(S, mx, mgp, part_w, rows, nsplit, smem4);
  else launch_k4_tc<64>(S, mx, mgp, part_w, rows, nsplit, smem4);
  launch_reduce(S, part_w, nsplit, part_mul, part_add, part_i);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of workspace ss_tail_site needs for these block and split counts.
long long ss_workspace_floats(int ci, int co, int g1, int g3, int p2,
                              int splits) {
  return workspace(ci, co, g1, g3, p2, splits);
}

// One tail site on `stream`.  dtype: 0 float32, 1 bfloat16; route: 0
// generic, 1 tensor_cores (bfloat16, vec, channel counts multiples of 64).
// Outputs: dx [M, ci], gp [M, co] (activation dtype), dw [ci, co], sums_o
// [2, co] (sum gp*z, sum gp), sums_i [2, ci] (sum gin*x, sum gin), all f32
// but dx and gp.  dxa is an [M, ci] scratch of the activation dtype.  g1,
// g3: blocks of k1 and k3; p2: blocks of k2 along M (generic: ceil(M/128));
// splits: M-splits of k4; bn, bi: the tensor-core route's k2 column tile
// (64, 128 or 256) and k4 ci tile (64 or 128).  vec: 16-byte loads (both
// channel counts multiples of 8, every pointer 16-byte aligned).  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for what the route does not
// take.
int ss_tail_site(int dtype, int route, const void* g, const void* z,
                 const void* mask, const void* x, const void* w,
                 const void* mul_o, const void* mul_i, const void* add_i,
                 void* dx, void* gp, void* dxa, void* dw, void* sums_o,
                 void* sums_i, void* work, long long M, int ci, int co,
                 int g1, int g3, int p2, int splits, int bn, int bi, int vec,
                 void* stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto fw = [](void* p) { return static_cast<float*>(p); };
  const Split S{g, z, mask, x, w, f(mul_o), f(mul_i), f(add_i), dx, gp, dxa,
                fw(dw), fw(sums_o), fw(sums_i), fw(work), M, ci, co, g1, g3,
                p2, splits, bn, bi, vec, static_cast<cudaStream_t>(stream)};
  if (M <= 0 || ci <= 0 || co <= 0 || g1 < 1 || g3 < 1 || p2 < 1 || splits < 1)
    return (int)cudaErrorInvalidValue;
  if (route == 1) {
    if (dtype != 1 || !vec || ci % 64 || co % 64 || M > 0x7fffffffLL ||
        (bn != 64 && bn != 128 && bn != 256) || (bi != 64 && bi != 128) ||
        p2 > cdiv(M, TR))
      return (int)cudaErrorInvalidValue;
    return launch_tensor_cores(S);
  }
  if (route != 0 || p2 != cdiv(M, RM)) return (int)cudaErrorInvalidValue;
  if (dtype == 1) return launch_generic<bf16>(S);
  if (dtype == 0) return launch_generic<float>(S);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
