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
// stage 4 (M = 12,544, ci*co = 512*2048) the products weigh as much as the
// bytes.  The TPU kernel is one pass over row tiles with W, dW and the sums
// resident in VMEM; on Hopper that sequential grid becomes a loop inside a
// persistent block.  Three routes, chosen by the wrapper from the shape:
//
// fused (bf16; ci, co and the form in a fixed set, W beside two row tiles
//   in shared memory -- the stage-1 sites and the stage-2 block-1 head, all
//   at M = 802,816): `site_fused`, one block per SM, each walking its own
//   contiguous range of 64-row tiles (a function of M and the block count
//   alone).  W is loaded once by TMA.  Each tile's g, z, x, ds arrive by
//   TMA (128-byte swizzle, the layout wgmma reads) and the int8 mask by a
//   bulk copy, into a ring of two slots, one tile ahead of the math.  Per
//   tile: the gate in registers, dz written over g in place (the same
//   swizzled address, so it is at once the K-major A of dxa and the
//   MN-major B of dW), gp over z, xa into its own buffer; dxa = dz W^T on
//   wgmma (two warpgroups split ci); dW += xa^T dz on wgmma into registers
//   that live across the whole range; the epilogue writes dx over x and
//   TMA stores dx and gp.  dz never reaches device memory and every input
//   is read once.  Each block writes one partial of dW and the sums; one
//   ordered reduction adds them.
// tiled (bf16, every other site whose channel counts are multiples of 64):
//   `site_gate` writes dz once to device memory; `site_rows_tc` (dxa on
//   wgmma over a 3-stage TMA ring, 128 x 128 tiles, then dx -- and xa
//   with in_act -- with 16-byte loads and stores) and `site_dw_tc` (dW on
//   wgmma, 128 x 128 tiles per M-split) read it back, two blocks to an
//   SM; the partials are added in order.
// generic (f32, and bf16 channel counts that are not multiples of 64):
//   the SIMT stages `site_gate`, `site_rows`, `site_dw` with wmma (bf16) or
//   FMA (f32) block products, every shape, ragged edges masked.
//
// No float atomics on any route: two launches on the same inputs give the
// same bits.  Rounding follows `_bwd_kernel`: the gate and xa are computed
// as round(round(v*mul) + add) in the activation dtype (explicit _rn
// intrinsics, so no FMA contraction changes a gate), dz and xa are rounded
// before the products, dxa, the sums and dW stay f32, dx is rounded once.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC; plain C entry points, bound with ctypes.
// The Hopper primitives (mbarriers, TMA, wgmma, the swizzled layout) and
// the tensor-map encoding are in csrc/hopper.cuh, shared with K6;
// cuTensorMapEncodeTiled (libcuda) is looked up at run time
// (cudaGetDriverEntryPoint), so the library needs no -lcuda.

#include "hopper.cuh"
#include "site_common.cuh"

namespace {

// site_gate: GR rows x GC channels per block (32 lanes x 8 channels).
constexpr int GR = 64, GC = 256;


// ---------------------------------------------------------------------------
// Route "generic" (and the tiled route's gate): the SIMT stages.
// ---------------------------------------------------------------------------

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
// Route "fused": one persistent block per SM over a contiguous range of
// 64-row tiles; see the header.  CI, CO and ACT (in_act) are compile-time;
// mask, ds and gp are flags.
// ---------------------------------------------------------------------------

constexpr int TM = 64;           // rows of a tile: one wgmma M
constexpr int FT = 256;          // two warpgroups
constexpr int ATOM = TM * 128;   // bytes of one swizzled [64][64] bf16 atom
constexpr int SMEM_LIMIT = 232448;

struct FusedArgs {
  const int8_t* mask;
  const float *mul_o, *add_o, *mul_i, *add_i;
  float* part;        // [blocks][ci*co + 2*co + 2*ci]
  long long M;
  int tiles;          // ceil(M / TM)
  int has_mask, has_ds, emit_gp;
};

// Byte offsets of site_fused's shared memory from a 1024-aligned base: W,
// then two slots (g, z, x, ds?, mask?), then xa when in_act.
struct FusedLayout {
  int g, z, x, ds, mask, slot, s0, xa, total;
  __host__ __device__ FusedLayout(int ci, int co, bool act, int has_mask,
                                  int has_ds) {
    g = 0;
    z = TM * 2 * co;
    x = z + TM * 2 * co;
    ds = x + TM * 2 * ci;
    mask = ds + (has_ds ? TM * 2 * ci : 0);
    slot = mask + (has_mask ? TM * co : 0);
    s0 = ci * co * 2;
    xa = s0 + 2 * slot;
    total = xa + (act ? TM * 2 * ci : 0) + 1024;
  }
};

template <int CI, int CO, bool ACT>
__global__ void __launch_bounds__(FT, 1)
site_fused(const __grid_constant__ CUtensorMap mg,
           const __grid_constant__ CUtensorMap mz,
           const __grid_constant__ CUtensorMap mx,
           const __grid_constant__ CUtensorMap mds,
           const __grid_constant__ CUtensorMap mw,
           const __grid_constant__ CUtensorMap mdx,
           const __grid_constant__ CUtensorMap mgp, const FusedArgs a) {
  constexpr int NCO = CO / 64, NCI = CI / 64;
  // dW in units of (64-row block of ci, 64-wide atom of co): half of them
  // per warpgroup, or with one unit, half of each tile's depth each.
  constexpr int UNITS = NCI * NCO;
  constexpr bool KSPLIT = UNITS == 1;
  constexpr int UW = KSPLIT ? 1 : UNITS / 2;
  // dxa: each warpgroup takes CI/2 columns, in passes of DN.
  constexpr int HALF = CI / 2, DN = HALF < 64 ? HALF : 64;
  constexpr int PASSES = HALF / DN;
  // The gate: thread owns channel granule gc of rows r0 + q*RS; the xa
  // transform likewise over ci.
  constexpr int GPR = CO / 8, RS = FT / GPR, NQ = TM / RS;
  constexpr int GPI = CI / 8, RSI = FT / GPI, NQI = TM / RSI;
  constexpr int NT = CI * CO + 2 * CO + 2 * CI;
  static_assert(FT % GPR == 0 && FT % GPI == 0, "channel granules");
  static_assert(KSPLIT || UNITS % 2 == 0, "dW units split in halves");
  static_assert(!ACT || PASSES == 1, "in_act takes one dxa pass");

  extern __shared__ unsigned char raw[];
  __shared__ __align__(8) uint64_t full[2];
  __shared__ __align__(8) uint64_t wbar;
  unsigned char* base = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
  const FusedLayout L(CI, CO, ACT, a.has_mask, a.has_ds);
  unsigned char* const sw = base;
  unsigned char* const sxa = base + L.xa;

  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int t_begin = (int)((long long)blockIdx.x * a.tiles / gridDim.x);
  const int t_end = (int)((long long)(blockIdx.x + 1) * a.tiles / gridDim.x);
  const uint32_t tile_bytes =
      (2u * NCO + NCI * (a.has_ds ? 2u : 1u)) * (uint32_t)ATOM;
  auto slot = [&](int s) { return base + L.s0 + s * L.slot; };
  auto issue = [&](int s, int tile) {
    unsigned char* p = slot(s);
    const long long row0 = (long long)tile * TM;
    const long long left = a.M - row0;
    const uint32_t rows = (uint32_t)(left < TM ? left : TM);
    mbar_expect(&full[s], tile_bytes + (a.has_mask ? rows * CO : 0u));
    for (int c = 0; c < NCO; ++c) {
      tma_load(p + L.g + c * ATOM, &mg, c * 64, tile * TM, &full[s]);
      tma_load(p + L.z + c * ATOM, &mz, c * 64, tile * TM, &full[s]);
    }
    for (int c = 0; c < NCI; ++c) {
      tma_load(p + L.x + c * ATOM, &mx, c * 64, tile * TM, &full[s]);
      if (a.has_ds)
        tma_load(p + L.ds + c * ATOM, &mds, c * 64, tile * TM, &full[s]);
    }
    if (a.has_mask)
      bulk_load(p + L.mask, a.mask + row0 * CO, rows * CO, &full[s]);
  };

  if (tid == 0) {
    mbar_init(&full[0], 1);
    mbar_init(&full[1], 1);
    mbar_init(&wbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect(&wbar, CI * CO * 2);
    for (int c = 0; c < NCO; ++c)
      tma_load(sw + c * CI * 128, &mw, c * 64, 0, &wbar);
    for (int s = 0; s < 2 && t_begin + s < t_end; ++s) issue(s, t_begin + s);
  }

  // Per-thread channels: the gate's, the xa transform's, the epilogue's.
  const int gc = tid % GPR, r0 = tid / GPR, c0 = gc * 8;
  float mo[8], mo_t[8], ao_t[8], s_gz[8], s_g[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    mo[e] = a.mul_o[c0 + e];
    mo_t[e] = Num<bf16>::r(mo[e]);
    ao_t[e] = Num<bf16>::r(a.add_o[c0 + e]);
    s_gz[e] = s_g[e] = 0.f;
  }
  const int gi = tid % GPI, ri0 = tid / GPI;
  constexpr int NC = DN / 4;     // epilogue columns of a thread (one pass)
  float xm_t[8], xa_t[8], mi[NC], mi_t[NC], ai_t[NC], s_gx[NC], s_gi[NC];
  if constexpr (ACT) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      xm_t[e] = Num<bf16>::r(a.mul_i[gi * 8 + e]);
      xa_t[e] = Num<bf16>::r(a.add_i[gi * 8 + e]);
    }
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int c = wg * HALF + (k / 2) * 8 + (lane & 3) * 2 + (k & 1);
      mi[k] = a.mul_i[c];
      mi_t[k] = Num<bf16>::r(mi[k]);
      ai_t[k] = Num<bf16>::r(a.add_i[c]);
      s_gx[k] = s_gi[k] = 0.f;
    }
  }
  float accw[UW][32];
#pragma unroll
  for (int u = 0; u < UW; ++u)
#pragma unroll
    for (int k = 0; k < 32; ++k) accw[u][k] = 0.f;
  float accx[DN / 2];

  mbar_wait(&wbar, 0);
  for (int tile = t_begin, i = 0; tile < t_end; ++tile, ++i) {
    const int s = i & 1;
    unsigned char* const p = slot(s);
    mbar_wait(&full[s], (i >> 1) & 1);

    // 1. The gate, in registers: dz over g, gp over z (same addresses).
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int r = r0 + q * RS;
      const int off = (gc >> 3) * ATOM + swz(r, gc & 7);
      __align__(16) bf16 gv[8], zv[8], dzv[8], gpv[8];
      __align__(8) int8_t mv[8];
      *reinterpret_cast<uint4*>(gv) = *reinterpret_cast<const uint4*>(p + L.g + off);
      *reinterpret_cast<uint4*>(zv) = *reinterpret_cast<const uint4*>(p + L.z + off);
      if (a.has_mask)
        *reinterpret_cast<uint2*>(mv) =
            *reinterpret_cast<const uint2*>(p + L.mask + r * CO + c0);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float gf = Num<bf16>::f(gv[e]), zf = Num<bf16>::f(zv[e]);
        const float gp = a.has_mask
                             ? Num<bf16>::r(gf * (float)mv[e])
                             : (affine_t<bf16>(zf, mo_t[e], ao_t[e]) > 0.f ? gf
                                                                           : 0.f);
        s_gz[e] += gp * zf;
        s_g[e] += gp;
        gpv[e] = Num<bf16>::from(gp);
        dzv[e] = Num<bf16>::from(__fmul_rn(gp, mo[e]));
      }
      *reinterpret_cast<uint4*>(p + L.g + off) = *reinterpret_cast<uint4*>(dzv);
      if (a.emit_gp)
        *reinterpret_cast<uint4*>(p + L.z + off) = *reinterpret_cast<uint4*>(gpv);
    }
    // 2. xa = relu(x*mul_i + add_i) into its own buffer, same layout.
    if constexpr (ACT) {
#pragma unroll
      for (int q = 0; q < NQI; ++q) {
        const int r = ri0 + q * RSI;
        const int off = (gi >> 3) * ATOM + swz(r, gi & 7);
        __align__(16) bf16 xv[8];
        *reinterpret_cast<uint4*>(xv) = *reinterpret_cast<const uint4*>(p + L.x + off);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float v = affine_t<bf16>(Num<bf16>::f(xv[e]), xm_t[e], xa_t[e]);
          xv[e] = Num<bf16>::from(v > 0.f ? v : 0.f);
        }
        *reinterpret_cast<uint4*>(sxa + off) = *reinterpret_cast<uint4*>(xv);
      }
    }
    fence_async_smem();
    __syncthreads();

    // 3. The products: dW += xa^T dz (both MN-major), dxa = dz W^T (both
    //    K-major), one commit.
    const unsigned char* const A = ACT ? sxa : p + L.x;
#pragma unroll
    for (int k = 0; k < DN / 2; ++k) accx[k] = 0.f;
    wgmma_fence();
    if constexpr (KSPLIT) {
#pragma unroll
      for (int k = 2 * wg; k < 2 * wg + 2; ++k)
        wgmma_n64<1, 1>(accw[0], desc(A + k * 2048), desc(p + L.g + k * 2048));
    } else {
#pragma unroll
      for (int u = 0; u < UW; ++u) {
        const int unit = wg * UW + u, mb = unit / NCO, nb = unit % NCO;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          wgmma_n64<1, 1>(accw[u], desc(A + mb * ATOM + k * 2048),
                          desc(p + L.g + nb * ATOM + k * 2048));
      }
    }
#pragma unroll
    for (int pass = 0; pass < PASSES; ++pass) {
      const int n0 = wg * HALF + pass * DN;
      if (pass > 0) {
#pragma unroll
        for (int k = 0; k < DN / 2; ++k) accx[k] = 0.f;
        wgmma_fence();
      }
#pragma unroll
      for (int k = 0; k < CO / 16; ++k) {
        const uint64_t da = desc(p + L.g + (k / 4) * ATOM + (k % 4) * 32);
        const uint64_t db = desc(sw + (k / 4) * CI * 128 + n0 * 128 + (k % 4) * 32);
        if constexpr (DN == 64) wgmma_n64<0, 0>(accx, da, db);
        else wgmma_n32<0, 0>(accx, da, db);
      }
      wgmma_commit();
      wgmma_wait();
      // Every warpgroup's dW has read x before dx overwrites it.
      if (pass == 0) __syncthreads();

      // 4. Epilogue: dx over x (the fragment's own elements), the sums.
#pragma unroll
      for (int j = 0; j < DN / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = warp * 16 + (lane >> 2) + h * 8;
          const int c = n0 + j * 8 + (lane & 3) * 2;
          const int off = tile_off(r, c, ATOM);
          float d[2] = {accx[j * 4 + h * 2], accx[j * 4 + h * 2 + 1]};
          if (a.has_ds) {
            const __nv_bfloat162 dv =
                *reinterpret_cast<const __nv_bfloat162*>(p + L.ds + off);
            d[0] = __fadd_rn(d[0], __low2float(dv));
            d[1] = __fadd_rn(d[1], __high2float(dv));
          }
          __nv_bfloat162 o;
          if constexpr (ACT) {
            const __nv_bfloat162 xv =
                *reinterpret_cast<const __nv_bfloat162*>(p + L.x + off);
            const float xf[2] = {__low2float(xv), __high2float(xv)};
            float out[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int k = j * 2 + e;
              const float gin =
                  affine_t<bf16>(xf[e], mi_t[k], ai_t[k]) > 0.f ? d[e] : 0.f;
              out[e] = __fmul_rn(gin, mi[k]);
              s_gx[k] += gin * xf[e];
              s_gi[k] += gin;
            }
            o = __floats2bfloat162_rn(out[0], out[1]);
          } else {
            o = __floats2bfloat162_rn(d[0], d[1]);
          }
          *reinterpret_cast<__nv_bfloat162*>(p + L.x + off) = o;
        }
      }
    }
    fence_async_smem();
    __syncthreads();
    if (tid == 0) {
      for (int c = 0; c < NCI; ++c)
        tma_store(&mdx, c * 64, tile * TM, p + L.x + c * ATOM);
      if (a.emit_gp)
        for (int c = 0; c < NCO; ++c)
          tma_store(&mgp, c * 64, tile * TM, p + L.z + c * ATOM);
      bulk_commit();
      bulk_wait_read();
      if (tile + 2 < t_end) issue(s, tile + 2);
    }
  }
  if (tid == 0) bulk_wait();
  __syncthreads();

  // This block's partials, each added across threads in a fixed order.
  float* red = reinterpret_cast<float*>(slot(0));
  float* part = a.part + (long long)blockIdx.x * NT;
  if constexpr (KSPLIT) {
    if (wg == 1)
#pragma unroll
      for (int k = 0; k < 32; ++k) red[k * 128 + tid - 128] = accw[0][k];
    __syncthreads();
    if (wg == 0)
#pragma unroll
      for (int k = 0; k < 32; ++k) accw[0][k] += red[k * 128 + tid];
    __syncthreads();
  }
  if (!KSPLIT || wg == 0) {
#pragma unroll
    for (int u = 0; u < UW; ++u) {
      const int unit = KSPLIT ? 0 : wg * UW + u, mb = unit / NCO, nb = unit % NCO;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = mb * 64 + warp * 16 + (lane >> 2) + h * 8;
          const int col = nb * 64 + j * 8 + (lane & 3) * 2;
          *reinterpret_cast<float2*>(part + row * CO + col) =
              make_float2(accw[u][j * 4 + h * 2], accw[u][j * 4 + h * 2 + 1]);
        }
    }
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    red[(r0 * 2) * CO + c0 + e] = s_gz[e];
    red[(r0 * 2 + 1) * CO + c0 + e] = s_g[e];
  }
  __syncthreads();
  for (int c = tid; c < CO; c += FT) {
    float v0 = 0.f, v1 = 0.f;
    for (int q = 0; q < RS; ++q) {
      v0 += red[(q * 2) * CO + c];
      v1 += red[(q * 2 + 1) * CO + c];
    }
    part[CI * CO + c] = v0;
    part[CI * CO + CO + c] = v1;
  }
  __syncthreads();
  if constexpr (ACT) {
    const int owner = warp * 8 + (lane >> 2);   // 32 threads share a column
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int c = wg * HALF + (k / 2) * 8 + (lane & 3) * 2 + (k & 1);
      red[(owner * 2) * CI + c] = s_gx[k];
      red[(owner * 2 + 1) * CI + c] = s_gi[k];
    }
    __syncthreads();
    for (int c = tid; c < CI; c += FT) {
      float v0 = 0.f, v1 = 0.f;
      for (int q = 0; q < 32; ++q) {
        v0 += red[(q * 2) * CI + c];
        v1 += red[(q * 2 + 1) * CI + c];
      }
      part[CI * CO + 2 * CO + c] = v0;
      part[CI * CO + 2 * CO + CI + c] = v1;
    }
  } else {
    for (int c = tid; c < 2 * CI; c += FT) part[CI * CO + 2 * CO + c] = 0.f;
  }
}

// ---------------------------------------------------------------------------
// Route "tiled": dxa and dW on wgmma over a TMA ring, dz from site_gate.
// Two blocks share an SM (97 KB of shared memory each), so one block's
// epilogue and barriers overlap the other's products.  In the main loop a
// step's wgmma group stays in flight while the next step's tile is waited
// for: step kc passes a block barrier (every warpgroup has retired group
// kc-2, whose slot is then free), issues the TMA load of step kc+1 into
// that slot, waits for step kc's tile, and commits its products, leaving
// at most one group outstanding.
// ---------------------------------------------------------------------------

constexpr int TB = 128;          // output tile rows and columns
constexpr int TSTAGES = 3;       // ring depth: in flight, current, loading
constexpr int TSTAGE = 4 * ATOM; // bytes of one ring stage (32 KB)
constexpr int LDE = TB + 4;      // f32 epilogue tile stride
constexpr int TILED_SMEM = TSTAGES * TSTAGE + 1024;
static_assert(TB * LDE * 4 + 2 * (FT / 16) * TB * 4 <= TSTAGES * TSTAGE,
              "site_rows_tc's epilogue fits in the ring");

// dxa = dz W^T for a 128-row x 128-column tile (co in 64-deep steps), then
// dx and the input-side sums with 16-byte loads and stores; with in_act it
// also writes xa = relu(x*mul_i + add_i), which site_dw_tc then reads in
// place of x (made once, not once per co tile).  grid (ceil(M/128),
// ceil(ci/128)); part_i [ceil(M/128)][2][ci].
__global__ void __launch_bounds__(FT, 2)
site_rows_tc(const __grid_constant__ CUtensorMap mdz,
             const __grid_constant__ CUtensorMap mw, const bf16* __restrict__ x,
             const bf16* __restrict__ ds, const float* __restrict__ mul_i,
             const float* __restrict__ add_i, bf16* __restrict__ dx,
             bf16* __restrict__ xa, float* __restrict__ part_i, long long M,
             int ci, int co, int in_act) {
  extern __shared__ unsigned char raw[];
  __shared__ __align__(8) uint64_t full[TSTAGES];
  unsigned char* base = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const long long m0 = (long long)blockIdx.x * TB;
  const int n0 = blockIdx.y * TB, nk = co / 64;
  auto issue = [&](int kc) {
    const int s = kc % TSTAGES;
    unsigned char* p = base + s * TSTAGE;
    mbar_expect(&full[s], 2 * TB * 128);
    tma_load(p, &mdz, kc * 64, (int)m0, &full[s]);
    tma_load(p + TB * 128, &mw, kc * 64, n0, &full[s]);
  };
  if (tid == 0) {
    for (int s = 0; s < TSTAGES; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    issue(0);
  }

  float acc[2][32];
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int k = 0; k < 32; ++k) acc[n][k] = 0.f;
  for (int kc = 0; kc < nk; ++kc) {
    __syncthreads();   // group kc-2 retired in every warpgroup
    if (tid == 0 && kc + 1 < nk) issue(kc + 1);
    const int s = kc % TSTAGES;
    mbar_wait(&full[s], (kc / TSTAGES) & 1);
    const unsigned char* p = base + s * TSTAGE;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da = desc(p + wg * 64 * 128 + kk * 32);
#pragma unroll
      for (int n = 0; n < 2; ++n)
        wgmma_n64<0, 0>(acc[n], da, desc(p + TB * 128 + n * 64 * 128 + kk * 32));
    }
    wgmma_commit();
    wgmma_wait_prev();
  }
  wgmma_wait();
  __syncthreads();   // every warpgroup's products have read the ring

  float* stage = reinterpret_cast<float*>(base);
  float* red = stage + TB * LDE;
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wg * 64 + warp * 16 + (lane >> 2) + h * 8;
        const int c = n * 64 + j * 8 + (lane & 3) * 2;
        *reinterpret_cast<float2*>(stage + r * LDE + c) =
            make_float2(acc[n][j * 4 + h * 2], acc[n][j * 4 + h * 2 + 1]);
      }
  __syncthreads();

  const int gcol = tid % 16, rr = tid / 16, i = n0 + gcol * 8;
  float mi[8], mi_t[8], ai_t[8], s_gx[8], s_gi[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const bool on = in_act && i < ci;
    mi[e] = on ? mul_i[i + e] : 0.f;
    mi_t[e] = Num<bf16>::r(mi[e]);
    ai_t[e] = on ? Num<bf16>::r(add_i[i + e]) : 0.f;
    s_gx[e] = s_gi[e] = 0.f;
  }
  if (i < ci) {
    for (int q = 0; q < TB / 16; ++q) {
      const int r = rr + q * 16;
      const long long m = m0 + r;
      if (m >= M) break;
      const long long off = m * ci + i;
      float d[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) d[e] = stage[r * LDE + gcol * 8 + e];
      __align__(16) bf16 v[8], o[8];
      if (ds) {
        copy8(v, ds + off);
#pragma unroll
        for (int e = 0; e < 8; ++e) d[e] = __fadd_rn(d[e], Num<bf16>::f(v[e]));
      }
      if (in_act) {
        copy8(v, x + off);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float xf = Num<bf16>::f(v[e]);
          const float t = affine_t<bf16>(xf, mi_t[e], ai_t[e]);
          const float gin = t > 0.f ? d[e] : 0.f;
          o[e] = Num<bf16>::from(__fmul_rn(gin, mi[e]));
          v[e] = Num<bf16>::from(t > 0.f ? t : 0.f);
          s_gx[e] += gin * xf;
          s_gi[e] += gin;
        }
        copy8(xa + off, v);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) o[e] = Num<bf16>::from(d[e]);
      }
      copy8(dx + off, o);
    }
  }
  if (in_act) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      red[(rr * 2) * TB + gcol * 8 + e] = s_gx[e];
      red[(rr * 2 + 1) * TB + gcol * 8 + e] = s_gi[e];
    }
    __syncthreads();
    if (tid < TB && n0 + tid < ci) {
      float v0 = 0.f, v1 = 0.f;
      for (int q = 0; q < FT / 16; ++q) {
        v0 += red[(q * 2) * TB + tid];
        v1 += red[(q * 2 + 1) * TB + tid];
      }
      float* pi = part_i + (long long)blockIdx.x * 2 * ci;
      pi[n0 + tid] = v0;
      pi[ci + n0 + tid] = v1;
    }
  }
}

// dW partial of one M-split for a 128 x 128 tile of (ci, co): xa^T dz over
// 64-row steps (xa: x, or the activation site_rows_tc wrote).  grid
// (ceil(ci/128), ceil(co/128), splits); split s covers rows [s*rows,
// min(M, (s+1)*rows)), rows a multiple of 64; part_w [splits][ci][co].
__global__ void __launch_bounds__(FT, 2)
site_dw_tc(const __grid_constant__ CUtensorMap mxa,
           const __grid_constant__ CUtensorMap mdz, float* __restrict__ part_w,
           long long M, int ci, int co, long long rows) {
  extern __shared__ unsigned char raw[];
  __shared__ __align__(8) uint64_t full[TSTAGES];
  unsigned char* base = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int i0 = blockIdx.x * TB, k0 = blockIdx.y * TB;
  const long long mbeg = (long long)blockIdx.z * rows;
  const long long mend = mbeg + rows < M ? mbeg + rows : M;
  const int nk = (int)cdiv(mend - mbeg, 64);
  auto issue = [&](int kc) {
    const int s = kc % TSTAGES;
    unsigned char* p = base + s * TSTAGE;
    const int row = (int)(mbeg + (long long)kc * 64);
    mbar_expect(&full[s], TSTAGE);
    tma_load(p, &mxa, i0, row, &full[s]);
    tma_load(p + ATOM, &mxa, i0 + 64, row, &full[s]);
    tma_load(p + 2 * ATOM, &mdz, k0, row, &full[s]);
    tma_load(p + 3 * ATOM, &mdz, k0 + 64, row, &full[s]);
  };
  if (tid == 0) {
    for (int s = 0; s < TSTAGES; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    issue(0);
  }

  float acc[2][32];
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int k = 0; k < 32; ++k) acc[n][k] = 0.f;
  for (int kc = 0; kc < nk; ++kc) {
    __syncthreads();   // group kc-2 retired in every warpgroup
    if (tid == 0 && kc + 1 < nk) issue(kc + 1);
    const int s = kc % TSTAGES;
    mbar_wait(&full[s], (kc / TSTAGES) & 1);
    const unsigned char* p = base + s * TSTAGE;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da = desc(p + wg * ATOM + kk * 2048);
#pragma unroll
      for (int n = 0; n < 2; ++n)
        wgmma_n64<1, 1>(acc[n], da, desc(p + (2 + n) * ATOM + kk * 2048));
    }
    wgmma_commit();
    wgmma_wait_prev();
  }
  wgmma_wait();
  float* pw = part_w + (long long)blockIdx.z * ci * co;
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = i0 + wg * 64 + warp * 16 + (lane >> 2) + h * 8;
        const int c = k0 + n * 64 + j * 8 + (lane & 3) * 2;
        if (i < ci && c < co)
          *reinterpret_cast<float2*>(pw + (long long)i * co + c) =
              make_float2(acc[n][j * 4 + h * 2], acc[n][j * 4 + h * 2 + 1]);
      }
}


// ---------------------------------------------------------------------------
// Host side.
// ---------------------------------------------------------------------------

struct Site {
  const void *g, *z, *mask, *x, *ds, *w;
  const float *mul_o, *add_o, *mul_i, *add_i;
  void *dx, *gp, *dz;
  float *out, *work;   // out: dw [ci*co] | sums_o [2][co] | sums_i [2][ci]
  long long M;
  int ci, co, in_act, parts, vec;
  cudaStream_t stream;
};

long long partials(long long M, int ci, int co, int route, int parts) {
  return route == 2 ? (long long)parts * (ci * (long long)co + 2 * co + 2 * ci)
                    : (long long)parts * ci * co + cdiv(M, GR) * 2 * co +
                          cdiv(M, route == 1 ? TB : RM) * 2 * ci;
}

long long workspace(long long M, int ci, int co, int route, int parts) {
  if (route == 2) return partials(M, ci, co, route, parts);
  long long s = scratch_floats(parts, (long long)ci * co);
  const long long so = scratch_floats(cdiv(M, GR), 2LL * co);
  const long long si = scratch_floats(cdiv(M, route == 1 ? TB : RM), 2LL * ci);
  s = s > so ? s : so;
  s = s > si ? s : si;
  return partials(M, ci, co, route, parts) + s;
}

template <int CI, int CO, bool ACT>
int launch_fused(const Site& S) {
  const int has_mask = S.mask != nullptr, has_ds = S.ds != nullptr;
  const int smem = FusedLayout(CI, CO, ACT, has_mask, has_ds).total;
  if (smem > SMEM_LIMIT - 64) return (int)cudaErrorInvalidValue;
  CUtensorMap mg, mz, mx, mds, mw, mdx, mgp;
  bool ok = make_map(&mg, S.g, S.M, CO, TM) && make_map(&mz, S.z, S.M, CO, TM) &&
            make_map(&mx, S.x, S.M, CI, TM) &&
            make_map(&mds, has_ds ? S.ds : S.x, S.M, CI, TM) &&
            make_map(&mw, S.w, CI, CO, CI) && make_map(&mdx, S.dx, S.M, CI, TM) &&
            make_map(&mgp, S.gp ? S.gp : S.z, S.M, CO, TM);
  if (!ok) return (int)cudaErrorInvalidValue;
  FusedArgs a;
  a.mask = static_cast<const int8_t*>(S.mask);
  a.mul_o = S.mul_o;
  a.add_o = S.add_o;
  a.mul_i = S.mul_i;
  a.add_i = S.add_i;
  a.part = S.work;
  a.M = S.M;
  a.tiles = (int)cdiv(S.M, TM);
  a.has_mask = has_mask;
  a.has_ds = has_ds;
  a.emit_gp = S.gp != nullptr;
  auto kernel = site_fused<CI, CO, ACT>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  kernel<<<S.parts, FT, smem, S.stream>>>(mg, mz, mx, mds, mw, mdx, mgp, a);
  reduce_all(S.work, S.out, S.parts, (long long)CI * CO + 2 * CO + 2 * CI,
             nullptr, S.stream);
  return (int)cudaGetLastError();
}

// The (ci, co, in_act) the fused route is compiled for; ops/fused_block_bwd.py
// keeps the same set.
int launch_fused_any(const Site& S) {
  const int ci = S.ci, co = S.co;
  if (S.in_act) {
    if (ci == 64 && co == 256) return launch_fused<64, 256, true>(S);
    if (ci == 64 && co == 64) return launch_fused<64, 64, true>(S);
  } else {
    if (ci == 64 && co == 256) return launch_fused<64, 256, false>(S);
    if (ci == 64 && co == 64) return launch_fused<64, 64, false>(S);
    if (ci == 256 && co == 64) return launch_fused<256, 64, false>(S);
    if (ci == 256 && co == 128) return launch_fused<256, 128, false>(S);
  }
  return (int)cudaErrorInvalidValue;
}

int launch_tiled(const Site& S) {
  const long long n_gt = cdiv(S.M, GR), n_mt = cdiv(S.M, TB);
  float* part_w = S.work;
  float* part_o = part_w + (long long)S.parts * S.ci * S.co;
  float* part_i = part_o + n_gt * 2 * S.co;
  float* scratch = part_i + n_mt * 2 * S.ci;
  bf16* dz = static_cast<bf16*>(S.dz);
  // With in_act, xa [M, ci] follows dz in the same scratch.
  bf16* xa = S.in_act ? dz + S.M * S.co : nullptr;
  CUtensorMap mdz_rows, mw, mxa, mdz;
  if (!(make_map(&mdz_rows, dz, S.M, S.co, TB) &&
        make_map(&mw, S.w, S.ci, S.co, TB) &&
        make_map(&mxa, S.in_act ? xa : S.x, S.M, S.ci, 64) &&
        make_map(&mdz, dz, S.M, S.co, 64)))
    return (int)cudaErrorInvalidValue;
  site_gate<bf16><<<dim3((unsigned)n_gt, (unsigned)cdiv(S.co, GC)), THREADS, 0,
                    S.stream>>>(
      static_cast<const bf16*>(S.g), static_cast<const bf16*>(S.z),
      static_cast<const int8_t*>(S.mask), S.mul_o, S.add_o, dz,
      static_cast<bf16*>(S.gp), part_o, S.M, S.co, 1);
  cudaFuncSetAttribute(site_rows_tc, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       TILED_SMEM);
  site_rows_tc<<<dim3((unsigned)n_mt, (unsigned)cdiv(S.ci, TB)), FT, TILED_SMEM,
                 S.stream>>>(mdz_rows, mw, static_cast<const bf16*>(S.x),
                             static_cast<const bf16*>(S.ds), S.mul_i, S.add_i,
                             static_cast<bf16*>(S.dx), xa, part_i, S.M, S.ci,
                             S.co, S.in_act);
  const long long rows = cdiv(cdiv(S.M, S.parts), 64) * 64;
  const unsigned nsplit = (unsigned)cdiv(S.M, rows);
  cudaFuncSetAttribute(site_dw_tc, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       TILED_SMEM);
  site_dw_tc<<<dim3((unsigned)cdiv(S.ci, TB), (unsigned)cdiv(S.co, TB), nsplit),
               FT, TILED_SMEM, S.stream>>>(mxa, mdz, part_w, S.M, S.ci, S.co,
                                           rows);
  reduce_all(part_w, S.out, nsplit, (long long)S.ci * S.co, scratch, S.stream);
  reduce_all(part_o, S.out + (long long)S.ci * S.co, n_gt, 2LL * S.co, scratch,
             S.stream);
  if (S.in_act)
    reduce_all(part_i, S.out + (long long)S.ci * S.co + 2 * S.co, n_mt,
               2LL * S.ci, scratch, S.stream);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_generic(const Site& S) {
  const long long n_gt = cdiv(S.M, GR), n_mt = cdiv(S.M, RM);
  float* part_w = S.work;
  float* part_o = part_w + (long long)S.parts * S.ci * S.co;
  float* part_i = part_o + n_gt * 2 * S.co;
  float* scratch = part_i + n_mt * 2 * S.ci;
  T* dz = static_cast<T*>(S.dz);
  site_gate<T><<<dim3((unsigned)n_gt, (unsigned)cdiv(S.co, GC)), THREADS, 0,
                 S.stream>>>(
      static_cast<const T*>(S.g), static_cast<const T*>(S.z),
      static_cast<const int8_t*>(S.mask), S.mul_o, S.add_o, dz,
      static_cast<T*>(S.gp), part_o, S.M, S.co, S.vec);
  site_rows<T><<<dim3((unsigned)n_mt, (unsigned)cdiv(S.ci, RN)), THREADS, 0,
                 S.stream>>>(
      dz, static_cast<const T*>(S.x), static_cast<const T*>(S.ds),
      static_cast<const T*>(S.w), S.mul_i, S.add_i, static_cast<T*>(S.dx),
      part_i, S.M, S.ci, S.co, S.in_act, S.vec);
  constexpr int K = DwMma<T>::K;
  const long long rows = cdiv(cdiv(S.M, S.parts), K) * K;
  const unsigned nsplit = (unsigned)cdiv(S.M, rows);
  site_dw<T><<<dim3((unsigned)cdiv(S.ci, WI), (unsigned)cdiv(S.co, WK), nsplit),
               THREADS, 0, S.stream>>>(dz, static_cast<const T*>(S.x), S.mul_i,
                                       S.add_i, part_w, S.M, S.ci, S.co,
                                       S.in_act, rows, S.vec);
  reduce_all(part_w, S.out, nsplit, (long long)S.ci * S.co, scratch, S.stream);
  reduce_all(part_o, S.out + (long long)S.ci * S.co, n_gt, 2LL * S.co, scratch,
             S.stream);
  if (S.in_act)
    reduce_all(part_i, S.out + (long long)S.ci * S.co + 2 * S.co, n_mt,
               2LL * S.ci, scratch, S.stream);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of workspace fbb_site needs: route 0 generic, 1 tiled, 2 fused;
// parts: the M-splits of the weight gradient (0, 1) or the blocks (2).
long long fbb_workspace_floats(int route, long long M, int ci, int co,
                               int parts) {
  return workspace(M, ci, co, route, parts);
}

// One site on `stream`.  dtype: 0 float32, 1 bfloat16 (routes 1 and 2 take
// bfloat16 only).  mask, ds, mul_i, add_i and gp may be null (mul_i and
// add_i are read only with in_act; gp is written when not null).  out is
// f32 [ci*co + 2*co + 2*ci]: dW, sums_o, sums_i (written with in_act).  dz
// is an [M, co] scratch of the activation dtype (routes 0 and 1), followed
// in route 1 with in_act by [M, ci] for xa.  vec
// (route 0): 16-byte loads (both channel counts multiples of 8, every
// pointer 16-byte aligned); routes 1 and 2 need that and channel counts
// that are multiples of 64.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for what the route does not take.
int fbb_site(int dtype, int route, const void* g, const void* z,
             const void* mask, const void* x, const void* ds, const void* w,
             const void* mul_o, const void* add_o, const void* mul_i,
             const void* add_i, void* dx, void* gp, void* out, void* dz,
             void* work, long long M, int ci, int co, int in_act, int parts,
             int vec, void* stream) {
  Site S{g, z, mask, x, ds, w,
         static_cast<const float*>(mul_o), static_cast<const float*>(add_o),
         static_cast<const float*>(mul_i), static_cast<const float*>(add_i),
         dx, gp, dz, static_cast<float*>(out), static_cast<float*>(work),
         M, ci, co, in_act, parts, vec, static_cast<cudaStream_t>(stream)};
  // Two reduction passes cover at most RED_CHUNK^2 partials.
  const long long most = (long long)RED_CHUNK * RED_CHUNK;
  if (M <= 0 || ci <= 0 || co <= 0 || parts < 1 || cdiv(M, GR) > most ||
      parts > most)
    return (int)cudaErrorInvalidValue;
  if (route != 0 && (dtype != 1 || !vec || ci % 64 || co % 64 ||
                     M > 0x7fffffffLL))
    return (int)cudaErrorInvalidValue;
  if (route == 2) return launch_fused_any(S);
  if (route == 1) return launch_tiled(S);
  if (route != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 1) return launch_generic<bf16>(S);
  if (dtype == 0) return launch_generic<float>(S);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
