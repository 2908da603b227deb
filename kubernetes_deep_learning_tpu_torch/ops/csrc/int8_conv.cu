// int8 convolutions of the w8a8 serving path, for Hopper (sm_90a):
//   Q1 int8_conv_kernel      -- a dense convolution (any kernel size, stride,
//       C_in and C_out; VALID, TF "SAME" or explicit pads; groups = 1) as an
//       implicit GEMM;
//   Q2 int8_depthwise_kernel -- a k x k depthwise convolution, k 3 or 5,
//       stride 1 or 2, TF "SAME" (the odd pixel of the padding after).
//
// Replaces no TPU kernel: the JAX package's w8a8 program
// (kubernetes_deep_learning_tpu/ops/quantize.py::build_w8a8_forward) runs
// each calibrated conv as XLA's conv_general_dilated(int8, int8,
// preferred_element_type=int32), outside any Pallas kernel, and PyTorch has
// no int8 convolution on CUDA.  The Python wrappers and their plain PyTorch
// version (int8_conv_reference) are in ../int8.py.
//
// Each kernel is one calibrated layer, f32 NHWC in and f32 NHWC out, bit
// equal to the plain version and to the JAX program's layer:
//   quantize-in   q = clamp(rint(x / s_act), -127, 127): IEEE division
//                 (__fdiv_rn; never build with --use_fast_math, which turns
//                 it into a multiply by the reciprocal) and round half to
//                 even, as jnp.round and torch.round;
//   accumulate    int32, exact (|acc| <= 127^2 * K, K = kh*kw*C_in < 2^17 for
//                 every layer of the served families, so < 2^31);
//   epilogue      y = float(acc) * out_scale[o] (+ bias[o]): __int2float_rn,
//                 then __fmul_rn / __fadd_rn so no multiply-add is fused;
//                 out_scale = s_act * s_w was computed in f32 on the host.
// A padding tap is code 0, which is exact under symmetric int8.
//
// What bounds them on the card: Q1 at Xception's pointwise shapes does
// 2*M*C_in*C_out int8 operations against 4*M*(C_in + C_out) bytes of f32
// activations in and out: 182 operations a byte at 728 -> 728, 439 at the
// widest (1536 -> 2048), all below the H100's int8 ridge (1,979 TOPS /
// 3.35 TB/s = 590), so every Xception shape is bound by bytes; Q2 does 18
// operations per output against 8 bytes: bound by bytes too.
//
// Q1's design (a first, simple kernel; wgmma s8 and TMA are later work):
//   * a block of 256 threads owns a 128 x 128 tile of (M = N*Ho*Wo pixels,
//     C_out channels) and walks K = kh*kw*C_in in steps of 64, the taps
//     ordered (dh, dw, c) so 4 consecutive k are 4 channels of one tap;
//   * A (the pixels' taps) is gathered from x by stride and padding with
//     16-byte loads when C_in is a multiple of 4 (4 consecutive k are then 4
//     channels of one tap), else with 4 predicated scalar loads whose k may
//     span two taps (ResNet's stem, C_in 3; EfficientNet's squeeze-excite
//     convs, C_in 34 and the like); quantized in registers and stored as
//     int8 in shared memory; the next step's loads are in flight while this
//     step computes.  The pads are explicit top/left offsets, the
//     bottom/right follow from Ho and Wo (a tap past the input reads 0);
//   * B is the weight pre-packed at build as int8 [C_out][K_pad] (K_pad a
//     multiple of 64, zero past K) and comes in by cp.async (zero-filled
//     past C_out);
//   * eight warps, each 64 x 32 of the tile, run
//     mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 on fragments read
//     with 32-bit shared loads; rows are 80 bytes apart, so those loads hit
//     32 different banks;
//   * the epilogue scales the int32 accumulators from registers and stores
//     f32, masked past M and C_out.
// Q2's design: one thread per (output pixel, 4 channels): the k*k
// neighbours' float4 (at stride s, from the SAME pads' top/left offset)
// through the read-only cache, quantized on load, k*k int8 taps a channel
// (packed [k*k][C] at build), int32 multiply-adds, the same epilogue; k is a
// template parameter (3 or 5) so the tap loops unroll.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"  // cp.async

namespace {

constexpr int BM = 128;       // pixels a block
constexpr int BN = 128;       // output channels a block
constexpr int BK = 64;        // k (bytes of int8) a step
constexpr int LDS = BK + 16;  // shared row stride in bytes: conflict-free fragment loads
constexpr int THREADS = 256;
constexpr int A_ITERS = BM / (THREADS / (BK / 4));     // rows a thread gathers: 8
constexpr int A_BYTES = BM * LDS;
constexpr int B_BYTES = BN * LDS;
static_assert(A_ITERS * (THREADS / (BK / 4)) == BM, "A gather covers the tile");
static_assert(2 * (A_BYTES + B_BYTES) + 3 * BM * 4 <= 48 * 1024, "static shared memory");
static_assert(BN * BK / 16 == 2 * THREADS, "B: two 16-byte chunks a thread");

struct ConvParams {
  const float* x;
  const int8_t* w;          // [C_out][K_pad]
  const float* out_scale;   // [C_out]
  const float* bias;        // [C_out] or null
  float* y;                 // [M][C_out]
  float s_act;
  int N, H, W, C;
  int Ho, Wo, C_out;
  int kh, kw, stride, pad_top, pad_left;
  int K, K_pad, M;
};

__device__ __forceinline__ int quantize(float v, float s) {
  float r = rintf(__fdiv_rn(v, s));
  r = fminf(fmaxf(r, -127.f), 127.f);
  return __float2int_rn(r);
}

__device__ __forceinline__ uint32_t quantize4(const float4& v, float s) {
  return (uint32_t)(quantize(v.x, s) & 0xff) | ((uint32_t)(quantize(v.y, s) & 0xff) << 8) |
         ((uint32_t)(quantize(v.z, s) & 0xff) << 16) | ((uint32_t)(quantize(v.w, s) & 0xff) << 24);
}

__device__ __forceinline__ float epilogue(int acc, float scale, const float* bias, int o) {
  const float y = __fmul_rn(__int2float_rn(acc), scale);
  return bias != nullptr ? __fadd_rn(y, bias[o]) : y;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// VEC: C % 4 == 0, so 4 consecutive k are 4 channels of one tap (one
// 16-byte load); else 4 scalar loads, each with its own tap.
template <bool VEC>
__global__ void __launch_bounds__(THREADS) int8_conv_kernel(ConvParams p) {
  __shared__ __align__(16) uint8_t sA[2][A_BYTES];
  __shared__ __align__(16) uint8_t sB[2][B_BYTES];
  __shared__ int row_base[BM];  // offset of the row's image in x
  __shared__ int row_ih[BM];    // the row's top-left input pixel (may lie outside)
  __shared__ int row_iw[BM];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  if (tid < BM) {
    const int m = m0 + tid;
    if (m < p.M) {
      const int wo = m % p.Wo;
      const int t = m / p.Wo;
      const int ho = t % p.Ho;
      const int n = t / p.Ho;
      row_base[tid] = n * p.H * p.W * p.C;
      row_ih[tid] = ho * p.stride - p.pad_top;
      row_iw[tid] = wo * p.stride - p.pad_left;
    } else {  // past M: every tap reads as padding
      row_base[tid] = 0;
      row_ih[tid] = -(1 << 28);
      row_iw[tid] = -(1 << 28);
    }
  }
  __syncthreads();

  // A: thread (g, r0) gathers k-group g (4 k) of rows r0 + 16 i.
  const int g = tid % (BK / 4);
  const int r0 = tid / (BK / 4);
  float4 a_regs[A_ITERS];

  auto gather = [&](int kt) {
    const int k = kt * BK + g * 4;
    if constexpr (VEC) {
      int dh = 0, dw = 0, c = 0;
      const bool k_ok = k < p.K;
      if (k_ok) {
        const int tap = k / p.C;
        c = k - tap * p.C;
        dh = tap / p.kw;
        dw = tap - dh * p.kw;
      }
#pragma unroll
      for (int i = 0; i < A_ITERS; ++i) {
        const int r = r0 + i * (THREADS / (BK / 4));
        const int ih = row_ih[r] + dh;
        const int iw = row_iw[r] + dw;
        if (k_ok && (unsigned)ih < (unsigned)p.H && (unsigned)iw < (unsigned)p.W) {
          const float* src = p.x + row_base[r] + ((long long)ih * p.W + iw) * p.C + c;
          a_regs[i] = __ldg(reinterpret_cast<const float4*>(src));
        } else {
          a_regs[i] = make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
    } else {
      int dh[4], dw[4], c[4];
      bool k_ok[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k + j;
        k_ok[j] = kj < p.K;
        const int tap = k_ok[j] ? kj / p.C : 0;
        c[j] = k_ok[j] ? kj - tap * p.C : 0;
        dh[j] = tap / p.kw;
        dw[j] = tap - dh[j] * p.kw;
      }
#pragma unroll
      for (int i = 0; i < A_ITERS; ++i) {
        const int r = r0 + i * (THREADS / (BK / 4));
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int ih = row_ih[r] + dh[j];
          const int iw = row_iw[r] + dw[j];
          v[j] = (k_ok[j] && (unsigned)ih < (unsigned)p.H && (unsigned)iw < (unsigned)p.W)
                     ? __ldg(p.x + row_base[r] + ((long long)ih * p.W + iw) * p.C + c[j])
                     : 0.f;
        }
        a_regs[i] = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
  };
  auto store_a = [&](int stage) {
#pragma unroll
    for (int i = 0; i < A_ITERS; ++i) {
      const int r = r0 + i * (THREADS / (BK / 4));
      *reinterpret_cast<uint32_t*>(&sA[stage][r * LDS + g * 4]) = quantize4(a_regs[i], p.s_act);
    }
  };
  auto load_b = [&](int kt, int stage) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int q = tid + j * THREADS;
      const int row = q / (BK / 16);
      const int col = (q % (BK / 16)) * 16;
      const bool ok = n0 + row < p.C_out;
      const int8_t* src = p.w + (long long)(ok ? n0 + row : 0) * p.K_pad + kt * BK + col;
      cp_async16(smem_addr(&sB[stage][row * LDS + col]), src, ok);
    }
    cp_async_commit();
  };

  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gid = lane / 4;
  const int tig = lane % 4;
  const int wm = (warp % 2) * 64;  // the warp's rows in the tile
  const int wn = (warp / 2) * 32;  // its channels
  int acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0;

  const int KT = p.K_pad / BK;
  gather(0);
  load_b(0, 0);
  store_a(0);
  cp_async_wait_all();
  __syncthreads();

  for (int kt = 0; kt < KT; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < KT;
    if (more) {
      load_b(kt + 1, cur ^ 1);
      gather(kt + 1);  // in flight while this step computes
    }
    const uint8_t* a_s = sA[cur];
    const uint8_t* b_s = sB[cur];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t b[4][2];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const uint8_t* bp = b_s + (wn + ni * 8 + gid) * LDS + kk + tig * 4;
        b[ni][0] = *reinterpret_cast<const uint32_t*>(bp);
        b[ni][1] = *reinterpret_cast<const uint32_t*>(bp + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const uint8_t* ap = a_s + (wm + mi * 16 + gid) * LDS + kk + tig * 4;
        const uint32_t a0 = *reinterpret_cast<const uint32_t*>(ap);
        const uint32_t a1 = *reinterpret_cast<const uint32_t*>(ap + 8 * LDS);
        const uint32_t a2 = *reinterpret_cast<const uint32_t*>(ap + 16);
        const uint32_t a3 = *reinterpret_cast<const uint32_t*>(ap + 8 * LDS + 16);
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a0, a1, a2, a3, b[ni][0], b[ni][1]);
      }
    }
    if (more) {
      store_a(cur ^ 1);
      cp_async_wait_all();
    }
    __syncthreads();
  }

  // Epilogue: rows gid and gid + 8 of each m16 tile, channels tig*2, +1.
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm + mi * 16 + gid + half * 8;
      if (m >= p.M) continue;
      float* out = p.y + (long long)m * p.C_out;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int o = n0 + wn + ni * 8 + tig * 2;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (o + j < p.C_out)
            out[o + j] = epilogue(acc[mi][ni][half * 2 + j], p.out_scale[o + j], p.bias, o + j);
        }
      }
    }
  }
}

struct DwParams {
  const float* x;
  const int8_t* w;  // [k*k][C]
  const float* out_scale;
  const float* bias;
  float* y;
  float s_act;
  int N, H, W, C;
  int Ho, Wo, stride, pad_top, pad_left;
};

template <int K>
__global__ void __launch_bounds__(256) int8_depthwise_kernel(DwParams p) {
  const int groups = p.C / 4;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long total = (long long)p.N * p.Ho * p.Wo * groups;
  if (idx >= total) return;
  const int c = (int)(idx % groups) * 4;
  const long long pix = idx / groups;  // the output pixel
  const int wo = (int)(pix % p.Wo);
  const int ho = (int)((pix / p.Wo) % p.Ho);
  const long long img = pix / ((long long)p.Wo * p.Ho);
  const int h0 = ho * p.stride - p.pad_top;
  const int w0 = wo * p.stride - p.pad_left;
  int acc[4] = {0, 0, 0, 0};
#pragma unroll
  for (int dh = 0; dh < K; ++dh) {
    const int ih = h0 + dh;
    if ((unsigned)ih >= (unsigned)p.H) continue;
#pragma unroll
    for (int dw = 0; dw < K; ++dw) {
      const int iw = w0 + dw;
      if ((unsigned)iw >= (unsigned)p.W) continue;
      const float4 v = __ldg(reinterpret_cast<const float4*>(
          p.x + ((img * p.H + ih) * p.W + iw) * p.C + c));
      const char4 t = __ldg(reinterpret_cast<const char4*>(p.w + (dh * K + dw) * p.C + c));
      acc[0] += quantize(v.x, p.s_act) * t.x;
      acc[1] += quantize(v.y, p.s_act) * t.y;
      acc[2] += quantize(v.z, p.s_act) * t.z;
      acc[3] += quantize(v.w, p.s_act) * t.w;
    }
  }
  float4 out;
  out.x = epilogue(acc[0], p.out_scale[c], p.bias, c);
  out.y = epilogue(acc[1], p.out_scale[c + 1], p.bias, c + 1);
  out.z = epilogue(acc[2], p.out_scale[c + 2], p.bias, c + 2);
  out.w = epilogue(acc[3], p.out_scale[c + 3], p.bias, c + 3);
  *reinterpret_cast<float4*>(p.y + pix * p.C + c) = out;
}

}  // namespace

// Q1: x (N,H,W,C) f32, w (C_out, K_pad) int8, out_scale (C_out) f32, bias
// (C_out) f32 or null -> y (N,Ho,Wo,C_out) f32.  Any C >= 1 and C_out >= 1;
// the top/left pads given, the bottom/right implied by Ho and Wo; x, w and
// y 16-byte aligned (the wrapper checks).
extern "C" int kdlt_int8_conv(const void* x, const void* w, const void* out_scale,
                              const void* bias, void* y, float s_act, int N, int H, int W,
                              int C, int Ho, int Wo, int C_out, int kh, int kw, int stride,
                              int pad_top, int pad_left, int K_pad, void* stream) {
  ConvParams p;
  p.x = static_cast<const float*>(x);
  p.w = static_cast<const int8_t*>(w);
  p.out_scale = static_cast<const float*>(out_scale);
  p.bias = static_cast<const float*>(bias);
  p.y = static_cast<float*>(y);
  p.s_act = s_act;
  p.N = N, p.H = H, p.W = W, p.C = C;
  p.Ho = Ho, p.Wo = Wo, p.C_out = C_out;
  p.kh = kh, p.kw = kw, p.stride = stride, p.pad_top = pad_top, p.pad_left = pad_left;
  p.K = kh * kw * C;
  p.K_pad = K_pad;
  p.M = N * Ho * Wo;
  if (C <= 0 || K_pad % BK || K_pad < p.K || p.M <= 0 || C_out <= 0 || stride <= 0 ||
      pad_top < 0 || pad_left < 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((p.M + BM - 1) / BM, (C_out + BN - 1) / BN);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C % 4 == 0)
    int8_conv_kernel<true><<<grid, THREADS, 0, s>>>(p);
  else
    int8_conv_kernel<false><<<grid, THREADS, 0, s>>>(p);
  return (int)cudaGetLastError();
}

// Q2: x (N,H,W,C) f32, w (k*k, C) int8, out_scale (C) f32, bias (C) f32 or
// null -> y (N,Ho,Wo,C) f32.  C a multiple of 4, k 3 or 5; the top/left
// pads given, the bottom/right implied by Ho and Wo.
extern "C" int kdlt_int8_depthwise(const void* x, const void* w, const void* out_scale,
                                   const void* bias, void* y, float s_act, int N, int H, int W,
                                   int C, int Ho, int Wo, int k, int stride, int pad_top,
                                   int pad_left, void* stream) {
  DwParams p;
  p.x = static_cast<const float*>(x);
  p.w = static_cast<const int8_t*>(w);
  p.out_scale = static_cast<const float*>(out_scale);
  p.bias = static_cast<const float*>(bias);
  p.y = static_cast<float*>(y);
  p.s_act = s_act;
  p.N = N, p.H = H, p.W = W, p.C = C;
  p.Ho = Ho, p.Wo = Wo, p.stride = stride, p.pad_top = pad_top, p.pad_left = pad_left;
  if (C % 4 || N <= 0 || H <= 0 || W <= 0 || Ho <= 0 || Wo <= 0 || stride <= 0 ||
      pad_top < 0 || pad_left < 0 || (k != 3 && k != 5))
    return (int)cudaErrorInvalidValue;
  const long long threads = (long long)N * Ho * Wo * (C / 4);
  const int block = 256;
  const unsigned grid = (unsigned)((threads + block - 1) / block);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k == 3)
    int8_depthwise_kernel<3><<<grid, block, 0, s>>>(p);
  else
    int8_depthwise_kernel<5><<<grid, block, 0, s>>>(p);
  return (int)cudaGetLastError();
}
