// int8_conv: the int8 x int8 -> int32 convolution of the quantized serving
// graph, with its dequantizing epilogue, for Hopper (sm_90a).
//
// No TPU kernel stands behind it: the JAX package's QuantConv
// (openset_imagenet_tpu/models/quant.py:86) leaves the convolution to XLA
// (lax.conv_general_dilated on int8 operands, int32 accumulation).  PyTorch
// has no int8 convolution that accumulates in int32, so the port writes it.
//
//   y[m, c] = bf16( f32(acc[m, c]) * scale[c] + bias[c] ),
//   acc     = sum over the window and the group's input channels of
//             q[n, ih, iw, g*Cg + ci] * w[c, r, s, ci], in int32,
//
// with q NHWC int8 [B, H, W, Cin], w int8 [Cout, KH, KW, Cin/groups] (K is
// contiguous in both operands), scale and bias float32 [Cout], y NHWC bf16
// [B, Ho, Wo, Cout] (or float32 for a float32 model: the same epilogue
// without the last rounding); padding reads as zero.  The epilogue rounds
// the product and then the sum (__fmul_rn, __fadd_rn: no contraction into
// one FMA), as flax and the plain PyTorch version do, so the kernel's
// output has the plain version's bits: int32 sums are exact in any order.
//
// Routes (ops/int8_conv.py _plan picks one from the shape alone):
// * tc64 / tc128: an implicit GEMM per group, M = B*Ho*Wo rows, N = Cout/g
//   columns, K = KH*KW*Cg, on mma.sync.m16n8k32 s8 tensor cores.  A block
//   computes a 128 x BN tile (BN 64 or 128) with eight warps; 64-byte K
//   slices of both operands come through a three-stage cp.async ring in
//   shared memory (rows padded to 80 bytes: the fragment loads hit 32
//   distinct banks).  Each K slice lies in one filter tap because Cg is a
//   multiple of 64, so a row's 64 bytes are one contiguous read of q, or
//   zeros in the padding.  Needs Cg % 64 == 0, Ng % 8 == 0 and 16-byte
//   aligned operands: every resnet50 QuantConv.
// * simt: one thread an output, __dp4a over four channels where Cg % 4 ==
//   0 and the rows are 4-byte aligned, bytes otherwise: the grouped convs
//   of the ResNeXt variants (4 to 32 channels a group) and any other shape.
//
// The bound at the resnet50 shapes is operations at large M (2*M*N*K at
// 1979 TOP/s of int8 tensor cores) for the 3x3 and the wide 1x1 convs, and
// bytes for the narrow 1x1 convs; this first kernel has neither wgmma nor
// TMA (later work, ROADMAP Queue 2).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

struct Shape {
  int B, H, W, Cin, Ho, Wo, Cout, KH, KW, stride, pad, groups;
  int Cg, Ng, K;
  long long M;
};

constexpr int kBM = 128;
constexpr int kBK = 64;
constexpr int kPitch = 80;  // bytes a shared-memory row: 64 + 16 of padding
constexpr int kStages = 3;
constexpr int kThreads = 256;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = valid ? 16 : 0;  // 0: zero fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_s8(int* c, unsigned a0, unsigned a1,
                                       unsigned a2, unsigned a3, unsigned b0,
                                       unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float dequant(int acc, float scale, float bias) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), scale), bias);
}

// BN columns a block; the warps tile the 128 x BN block as WM x WN each.
template <int BN>
struct Tile {
  static constexpr int WN = 32;
  static constexpr int WARPS_N = BN / WN;        // 2 or 4
  static constexpr int WARPS_M = 8 / WARPS_N;    // 4 or 2
  static constexpr int WM = kBM / WARPS_M;       // 32 or 64
  static constexpr int MT = WM / 16;             // m16 tiles a warp
  static constexpr int NT = WN / 8;              // n8 tiles a warp
  static constexpr int A_CHUNKS = kBM * kBK / 16 / kThreads;  // 2
  static constexpr int B_CHUNKS = BN * kBK / 16 / kThreads;   // 1 or 2
  static constexpr int STAGE_BYTES = (kBM + BN) * kPitch;
  static constexpr int SMEM = kStages * STAGE_BYTES;
};

template <int BN>
__global__ void __launch_bounds__(kThreads)
    conv_tc(const int8_t* __restrict__ q, const int8_t* __restrict__ w,
            const float* __restrict__ scale, const float* __restrict__ bias,
            void* __restrict__ y, Shape sh, int out_f32) {
  using T = Tile<BN>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int warp_m = warp / T::WARPS_N, warp_n = warp % T::WARPS_N;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * BN;
  const int g = blockIdx.z;
  const int hw_out = sh.Ho * sh.Wo;

  // The rows of q this thread copies: fixed over the K loop.
  long long a_base[T::A_CHUNKS];
  int a_ih[T::A_CHUNKS], a_iw[T::A_CHUNKS], a_col[T::A_CHUNKS];
  int a_row[T::A_CHUNKS];
  bool a_ok[T::A_CHUNKS];
#pragma unroll
  for (int i = 0; i < T::A_CHUNKS; ++i) {
    const int chunk = tid + i * kThreads;
    a_row[i] = chunk >> 2;
    a_col[i] = (chunk & 3) * 16;
    const long long m = m0 + a_row[i];
    a_ok[i] = m < sh.M;
    const long long mm = a_ok[i] ? m : 0;
    const int n = static_cast<int>(mm / hw_out);
    const int rem = static_cast<int>(mm % hw_out);
    const int oh = rem / sh.Wo, ow = rem % sh.Wo;
    a_ih[i] = oh * sh.stride - sh.pad;
    a_iw[i] = ow * sh.stride - sh.pad;
    a_base[i] = static_cast<long long>(n) * sh.H * sh.W * sh.Cin +
                static_cast<long long>(g) * sh.Cg + a_col[i];
  }
  int b_row[T::B_CHUNKS], b_col[T::B_CHUNKS];
  bool b_ok[T::B_CHUNKS];
  long long b_base[T::B_CHUNKS];
#pragma unroll
  for (int i = 0; i < T::B_CHUNKS; ++i) {
    const int chunk = tid + i * kThreads;
    b_row[i] = chunk >> 2;
    b_col[i] = (chunk & 3) * 16;
    const int n = n0 + b_row[i];
    b_ok[i] = n < sh.Ng;
    b_base[i] = (static_cast<long long>(g) * sh.Ng + (b_ok[i] ? n : 0)) *
                    sh.K + b_col[i];
  }

  auto load_stage = [&](int stage, int kt) {
    unsigned char* As = smem + stage * T::STAGE_BYTES;
    unsigned char* Bs = As + kBM * kPitch;
    const int k0 = kt * kBK;
    const int tap = k0 / sh.Cg;
    const int c0 = k0 - tap * sh.Cg;
    const int r = tap / sh.KW, s = tap - (tap / sh.KW) * sh.KW;
#pragma unroll
    for (int i = 0; i < T::A_CHUNKS; ++i) {
      const int ih = a_ih[i] + r, iw = a_iw[i] + s;
      const bool ok = a_ok[i] && ih >= 0 && ih < sh.H && iw >= 0 &&
                      iw < sh.W;
      const int8_t* src =
          ok ? q + a_base[i] +
                   (static_cast<long long>(ih) * sh.W + iw) * sh.Cin + c0
             : q;
      cp_async16(As + a_row[i] * kPitch + a_col[i], src, ok);
    }
#pragma unroll
    for (int i = 0; i < T::B_CHUNKS; ++i) {
      const int8_t* src = b_ok[i] ? w + b_base[i] + k0 : w;
      cp_async16(Bs + b_row[i] * kPitch + b_col[i], src, b_ok[i]);
    }
  };

  int acc[T::MT][T::NT][4];
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < T::NT; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0;

  const int KT = sh.K / kBK;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < KT) load_stage(st, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nk = kt + kStages - 1;
    if (nk < KT) load_stage(nk % kStages, nk);
    cp_async_commit();
    const unsigned char* As = smem + (kt % kStages) * T::STAGE_BYTES;
    const unsigned char* Bs = As + kBM * kPitch;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      unsigned a[T::MT][4], b[T::NT][2];
#pragma unroll
      for (int i = 0; i < T::MT; ++i) {
        const unsigned char* p =
            As + (warp_m * T::WM + i * 16 + gid) * kPitch + kk + tig * 4;
        a[i][0] = *reinterpret_cast<const unsigned*>(p);
        a[i][1] = *reinterpret_cast<const unsigned*>(p + 8 * kPitch);
        a[i][2] = *reinterpret_cast<const unsigned*>(p + 16);
        a[i][3] = *reinterpret_cast<const unsigned*>(p + 8 * kPitch + 16);
      }
#pragma unroll
      for (int j = 0; j < T::NT; ++j) {
        const unsigned char* p =
            Bs + (warp_n * T::WN + j * 8 + gid) * kPitch + kk + tig * 4;
        b[j][0] = *reinterpret_cast<const unsigned*>(p);
        b[j][1] = *reinterpret_cast<const unsigned*>(p + 16);
      }
#pragma unroll
      for (int i = 0; i < T::MT; ++i)
#pragma unroll
        for (int j = 0; j < T::NT; ++j)
          mma_s8(acc[i][j], a[i][0], a[i][1], a[i][2], a[i][3], b[j][0],
                 b[j][1]);
    }
  }
  cp_async_wait<0>();

  // Epilogue: two channels a store (Ng % 8 == 0, so both are in range).
#pragma unroll
  for (int j = 0; j < T::NT; ++j) {
    const int n = n0 + warp_n * T::WN + j * 8 + tig * 2;
    if (n >= sh.Ng) continue;
    const int c = g * sh.Ng + n;
    const float s0 = scale[c], s1 = scale[c + 1];
    const float b0 = bias[c], b1 = bias[c + 1];
#pragma unroll
    for (int i = 0; i < T::MT; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long m = m0 + warp_m * T::WM + i * 16 + gid + h * 8;
        if (m >= sh.M) continue;
        const float v0 = dequant(acc[i][j][2 * h], s0, b0);
        const float v1 = dequant(acc[i][j][2 * h + 1], s1, b1);
        if (out_f32) {
          *reinterpret_cast<float2*>(static_cast<float*>(y) + m * sh.Cout +
                                     c) = make_float2(v0, v1);
        } else {
          __nv_bfloat162 v;
          v.x = __float2bfloat16_rn(v0);
          v.y = __float2bfloat16_rn(v1);
          *reinterpret_cast<__nv_bfloat162*>(
              static_cast<__nv_bfloat16*>(y) + m * sh.Cout + c) = v;
        }
      }
    }
  }
}

__global__ void conv_simt(const int8_t* __restrict__ q,
                          const int8_t* __restrict__ w,
                          const float* __restrict__ scale,
                          const float* __restrict__ bias,
                          void* __restrict__ y, Shape sh, int vec4,
                          int out_f32) {
  const long long total = sh.M * sh.Cout;
  const int hw_out = sh.Ho * sh.Wo;
  for (long long idx = static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
       idx < total; idx += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int c = static_cast<int>(idx % sh.Cout);
    const long long m = idx / sh.Cout;
    const int g = c / sh.Ng;
    const int n = static_cast<int>(m / hw_out);
    const int rem = static_cast<int>(m % hw_out);
    const int oh = rem / sh.Wo, ow = rem % sh.Wo;
    int acc = 0;
    for (int r = 0; r < sh.KH; ++r) {
      const int ih = oh * sh.stride - sh.pad + r;
      if (ih < 0 || ih >= sh.H) continue;
      for (int s = 0; s < sh.KW; ++s) {
        const int iw = ow * sh.stride - sh.pad + s;
        if (iw < 0 || iw >= sh.W) continue;
        const int8_t* xp =
            q + ((static_cast<long long>(n) * sh.H + ih) * sh.W + iw) *
                    sh.Cin +
            static_cast<long long>(g) * sh.Cg;
        const int8_t* wp =
            w + (static_cast<long long>(c) * sh.KH * sh.KW + r * sh.KW + s) *
                    sh.Cg;
        if (vec4) {
          for (int ci = 0; ci < sh.Cg; ci += 4)
            acc = __dp4a(*reinterpret_cast<const int*>(xp + ci),
                         *reinterpret_cast<const int*>(wp + ci), acc);
        } else {
          for (int ci = 0; ci < sh.Cg; ++ci)
            acc += static_cast<int>(xp[ci]) * static_cast<int>(wp[ci]);
        }
      }
    }
    const float v = dequant(acc, scale[c], bias[c]);
    if (out_f32)
      static_cast<float*>(y)[idx] = v;
    else
      static_cast<__nv_bfloat16*>(y)[idx] = __float2bfloat16_rn(v);
  }
}

template <int BN>
int launch_tc(const int8_t* q, const int8_t* w, const float* scale,
              const float* bias, void* y, const Shape& sh, int out_f32,
              cudaStream_t stream) {
  using T = Tile<BN>;
  cudaError_t err = cudaFuncSetAttribute(
      conv_tc<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(static_cast<unsigned>((sh.M + kBM - 1) / kBM),
            static_cast<unsigned>((sh.Ng + BN - 1) / BN),
            static_cast<unsigned>(sh.groups));
  conv_tc<BN><<<grid, kThreads, T::SMEM, stream>>>(q, w, scale, bias, y, sh,
                                                    out_f32);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// route: 0 simt, 1 tensor cores with 64-column tiles, 2 with 128-column
// tiles; vec4: the simt route's __dp4a loads; out_f32: a float32 output
// (the epilogue without the bfloat16 rounding) in place of bfloat16.
// Returns the CUDA error of the launch (0: launched).
int i8c_conv(const void* q, const void* w, const void* scale,
             const void* bias, void* y, int B, int H, int W, int Cin,
             int Cout, int KH, int KW, int stride, int pad, int groups,
             int route, int vec4, int out_f32, void* stream) {
  Shape sh;
  sh.B = B; sh.H = H; sh.W = W; sh.Cin = Cin; sh.Cout = Cout;
  sh.KH = KH; sh.KW = KW; sh.stride = stride; sh.pad = pad;
  sh.groups = groups;
  sh.Ho = (H + 2 * pad - KH) / stride + 1;
  sh.Wo = (W + 2 * pad - KW) / stride + 1;
  sh.Cg = Cin / groups;
  sh.Ng = Cout / groups;
  sh.K = KH * KW * sh.Cg;
  sh.M = static_cast<long long>(B) * sh.Ho * sh.Wo;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* qq = static_cast<const int8_t*>(q);
  const int8_t* ww = static_cast<const int8_t*>(w);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  if (route == 1) return launch_tc<64>(qq, ww, sc, bi, y, sh, out_f32, s);
  if (route == 2) return launch_tc<128>(qq, ww, sc, bi, y, sh, out_f32, s);
  const long long total = sh.M * Cout;
  long long blocks = (total + 255) / 256;
  if (blocks > 132LL * 64) blocks = 132LL * 64;
  conv_simt<<<static_cast<unsigned>(blocks), 256, 0, s>>>(qq, ww, sc, bi, y,
                                                          sh, vec4, out_f32);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
