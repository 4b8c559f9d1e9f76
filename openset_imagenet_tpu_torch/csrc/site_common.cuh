// Helpers shared by the port's CUDA C++ site kernels (K5,
// csrc/fused_block_bwd.cu, and K6, csrc/split_site.cu): the activation
// dtype's rounding, 16-byte copies, the wmma/FMA block products of the
// SIMT paths, and the ordered reduction of partials.  Everything sits in an
// anonymous namespace: each source that includes it is its own library.
// ops/_build.py hashes this header into the key of every source that names
// it, so an edit here rebuilds both.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int THREADS = 256;
constexpr int PAD = 8;
// Row products: output tile RM x RN of dxa, co consumed in chunks of the depth K.
constexpr int RM = 128, RN = 64, LDC = RN + 4;
// Weight products: output tile WI x WK of dW, M consumed in chunks of K rows.
constexpr int WI = 64, WK = 128, LDX = WI + PAD, LDD = WK + PAD, LDW = WK + 4;
// reduce_partials: 32 outputs x 8 lanes per block; partials per program.
constexpr int RED_X = 32, RED_Y = 8, RED_CHUNK = 256;

// Depth of a product step: 64 in bf16, 32 in f32 (shared memory stays
// within the 48 KB of a static allocation).
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

using frag_acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// Block products.  Rows: C[RM][RN] += A[RM][K]
// (row-major, ld K+PAD) times B[K][RN] stored as [RN][K].  Weights:
// C[WI][WK] += A[WI][K] stored as [K][WI] (ld LDX) times B[K][WK] (ld LDD).
// bf16: 8 warps of 32x32 wmma tiles; f32: plain FMA, 32 outputs a thread.
// In bf16 the dxa product starts each step from zero on the tensor
// cores and adds the step to the running sum with a rounded f32 add, one
// row half of the warp's tile at a time (the extra accumulators then cost
// few registers): accumulated on the tensor cores through all 2048 of co
// at stage 4, dxa drifted enough that its rounding to bf16 moved the
// input-side sums 1.0e-4 (in norm) from a float64 product, against 3.6e-5
// for torch's f32 product (K6's k2, the split site).  dW accumulates on
// the tensor cores.
// ---------------------------------------------------------------------------

template <typename T> struct RowsMma;
template <typename T> struct DwMma;

template <> struct RowsMma<bf16> {
  static constexpr int K = Depth<bf16>::K, LD = K + PAD;
  frag_acc c[2][2];
  __device__ void zero() {
    for (int i = 0; i < 2; ++i)
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(c[i][j], 0.f);
  }
  __device__ void step(const bf16* sA, const bf16* sB) {
    const int warp = threadIdx.x / 32, wm = warp / 2, wn = warp % 2;
    for (int i = 0; i < 2; ++i) {
      frag_acc t[2];
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(t[j], 0.f);
#pragma unroll
      for (int kk = 0; kk < K; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b[2];
        wmma::load_matrix_sync(a, sA + (wm * 32 + i * 16) * LD + kk, LD);
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(b[j], sB + (wn * 32 + j * 16) * LD + kk, LD);
        for (int j = 0; j < 2; ++j) wmma::mma_sync(t[j], a, b[j], t[j]);
      }
      for (int j = 0; j < 2; ++j)
        for (int e = 0; e < t[j].num_elements; ++e)
          c[i][j].x[e] = __fadd_rn(c[i][j].x[e], t[j].x[e]);
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

// Sum of red[q * width + lane] over q in order.
__device__ __forceinline__ float ordered_sum(const float* red, int groups,
                                             int width, int lane) {
  float v = red[lane];
  for (int q = 1; q < groups; ++q) v += red[q * width + lane];
  return v;
}

// ---------------------------------------------------------------------------
// out[b][j] = sum over t in program b's chunk of part[t][j], in a fixed
// order (lane-strided, then the lanes in order).  grid (ceil(N/RED_X),
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

}  // namespace
