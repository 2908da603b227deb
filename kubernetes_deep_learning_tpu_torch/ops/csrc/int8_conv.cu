// int8 convolutions of the w8a8 serving path, for Hopper (sm_90a):
//   Q1 -- a dense convolution (any kernel size, stride, C_in and C_out;
//       VALID, TF "SAME" or explicit pads; groups = 1), two launches:
//       int8_codes_kernel quantizes the layer's input once into int8 codes,
//       int8_conv_kernel is an implicit GEMM on those codes (wgmma s8);
//   Q2 int8_depthwise_kernel -- a k x k depthwise convolution, k 3 or 5,
//       stride 1 or 2, TF "SAME" (the odd pixel of the padding after).
//
// Replaces no TPU kernel: the JAX package's w8a8 program
// (kubernetes_deep_learning_tpu/ops/quantize.py::build_w8a8_forward) runs
// each calibrated conv as XLA's conv_general_dilated(int8, int8,
// preferred_element_type=int32), outside any Pallas kernel, and PyTorch has
// no int8 convolution on CUDA.  The Python wrappers, their plain PyTorch
// version (int8_conv_reference) and the choice of Q1's instance by shape
// (q1_instance) are in ../int8.py.
//
// Each of Q1 and Q2 is one calibrated layer, f32 NHWC in and f32 NHWC out,
// bit equal to the plain version and to the JAX program's layer:
//   quantize-in   q = clamp(rint(x / s_act), -127, 127): IEEE division
//                 (__fdiv_rn; never build with --use_fast_math, which turns
//                 it into a multiply by the reciprocal) and round half to
//                 even, as jnp.round and torch.round;
//   accumulate    int32, exact (|acc| <= 127^2 * K, K = kh*kw*C_in < 2^17 for
//                 every layer of the served families, so < 2^31; wgmma s8
//                 and the integer multiply-adds of Q2 are exact);
//   epilogue      y = float(acc) * out_scale[o] (+ bias[o]): __int2float_rn,
//                 then __fmul_rn / __fadd_rn so no multiply-add is fused;
//                 out_scale = s_act * s_w was computed in f32 on the host.
// A padding tap is code 0, which is exact under symmetric int8.
//
// What bounds them on the card: bytes.  Q1 at Xception's pointwise shapes
// does 2*M*C_in*C_out int8 operations against 4*M*(C_in + C_out) bytes of
// f32 activations in and out: 182 operations a byte at 728 -> 728, 439 at
// the widest (1536 -> 2048), all below the H100's int8 ridge (1,979 TOPS /
// 3.35 TB/s = 590); Q2 does 2*k*k operations per output against 8 bytes.
// So what costs is activation traffic and the per-element quantize, and the
// design spends each input element's division once:
//   * int8_codes_kernel reads the f32 input once and writes its codes once
//     (16 bytes in and 4 out a thread), the channel stride padded to
//     C_pad, a multiple of 16, with code 0 (for a 1x1 conv only the pixels
//     it reads: a quarter of a 1x1/2 conv's input); the GEMM then reads
//     1-byte codes (from L2 for the most part: a layer's codes are 0.01-44
//     MB at batch 16, L2 50 MB) and divides nothing.  A layer moves
//     about 4 + 1 + 1 + 4 bytes an element against the bound's 8, where a
//     GEMM that quantized in its gather read 4 bytes and divided once for
//     every 128-channel N tile and every tap covering it;
//   * int8_conv_kernel: a block of one or two consumer warpgroups owns a
//     64- or 128-pixel M tile and 64 output channels (the wrapper picks the
//     warpgroups by shape: the bytes the busiest SM streams).  Wider N
//     tiles (128, and 104 = n96 + n8, an s8 wgmma's N being a multiple of
//     16 past 32, so that 728 = 7 x 104 has no empty column) were built
//     and measured: 64 was the fastest summed over each of the three w8a8
//     forwards (a wider tile won at three of ResNet50's shapes, by less
//     than it lost elsewhere), the smaller blocks hiding more of their
//     loads' and epilogue's latency.  K = kh*kw*C_pad, ordered (dh, dw, c), walks in
//     steps of 128 bytes through a ring of 3 stages: the weight (packed
//     int8 [C_out][K_pad]) by TMA, the codes by TMA as an [M][C_pad]
//     matrix for a 1x1 conv (its pixels, as sampled), else gathered as
//     16-byte runs by cp.async (a run never spans two taps: C_pad % 16 ==
//     0), both in wgmma's 128-byte-swizzled K-major layout; one stage
//     loads while one is multiplied and the one before finishes (deeper
//     rings were slower: a smaller block lets three share an SM);
//   * each warpgroup runs wgmma.mma_async m64n64k32 s32.s8.s8 on its 64
//     rows with both operands from shared memory, one group left in flight
//     (waiting for none was slower on the card);
//   * the epilogue scales the int32 accumulators in registers, stages the
//     f32 tile through shared memory and stores it in 16-byte coalesced
//     rows (scalar stores where C_out % 4).
// Q2's design: a block owns a band of output rows of one image and a group
// of up to 64 channels; it loads the band's input rows and their halo once,
// quantizing each element once on load into an int8 tile in shared memory
// (padding as code 0; a band's (k - stride) halo rows are read and
// quantized by the band beside it too) and the group's k*k weight taps
// beside it; each thread sums 4 channels' taps of its pixels from shared
// memory with int32 multiply-adds (a 3x3's 9 weight taps kept in
// registers), then the same epilogue, as 16-byte stores.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#include "hopper.cuh"  // mbarriers, cp.async, TMA, wgmma descriptors and fences, the map encoder

namespace {

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

// --- the quantize pass -------------------------------------------------------

struct CodesParams {
  const float* x;  // (N, H, W, C)
  int8_t* codes;   // (N, Hc, Wc, C_pad)
  float s_act;
  int H, W, C, C_pad;
  int Hc, Wc, stride, pad_top, pad_left;  // codes pixel (i, j) is x pixel (i*s - top, j*s - left)
  long long pixels;                       // N * Hc * Wc
};

constexpr int CODES_THREADS = 256;

// Thread t quantizes the 4 channels of quad t % (C_pad / 4) of codes pixel
// t / (C_pad / 4); channels past C, and pixels outside x, are code 0.  The
// codes hold < 2^31 bytes (the wrapper checks), so 32-bit index arithmetic
// serves (64-bit divisions made this pass measurably slower).
__global__ void __launch_bounds__(CODES_THREADS) int8_codes_kernel(const CodesParams p) {
  const int quads = p.C_pad / 4;
  const int idx = blockIdx.x * CODES_THREADS + threadIdx.x;
  if (idx >= (int)p.pixels * quads) return;
  const int pix = idx / quads;
  const int c = (idx - pix * quads) * 4;
  const int t = pix / p.Wc;
  const int ih = (t % p.Hc) * p.stride - p.pad_top;
  const int iw = (pix - t * p.Wc) * p.stride - p.pad_left;
  uint32_t word = 0;
  if ((unsigned)ih < (unsigned)p.H && (unsigned)iw < (unsigned)p.W) {
    const float* src = p.x + ((long long)((t / p.Hc) * p.H + ih) * p.W + iw) * p.C + c;
    if (p.C % 4 == 0) {
      if (c < p.C) word = quantize4(__ldg(reinterpret_cast<const float4*>(src)), p.s_act);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c + e < p.C) word |= (uint32_t)(quantize(__ldg(src + e), p.s_act) & 0xff) << (8 * e);
    }
  }
  *reinterpret_cast<uint32_t*>(p.codes + (long long)idx * 4) = word;
}

// --- Q1: the implicit GEMM on the codes ----------------------------------------

constexpr int BK = 128;      // K bytes a stage: one 128-byte swizzled row
constexpr int BN = 64;       // output channels a block: one wgmma N
constexpr int STAGES = 3;    // ring depth: one stage loads while one is multiplied
constexpr int ALIGN = 1024;  // a swizzle atom (8 rows x 128 B)
static_assert(STAGES >= 3, "a stage refills two steps after its product was issued");
// Epilogue staging row in floats: == 8 mod 32, so a half-warp's float2
// writes (8 rows x 4 column pairs) hit 32 different banks.
constexpr int LDE = BN + 8;

template <int WGS>
struct Tile {
  static constexpr int BM = 64 * WGS;  // one wgmma M per consumer warpgroup
  static constexpr int THREADS = 128 * WGS;
  static constexpr int A_BYTES = BM * BK;
  static constexpr int B_BYTES = BN * BK;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int RING = STAGES * STAGE_BYTES;
  static constexpr int EPI = BM * LDE * 4;
  static constexpr int SMEM = ALIGN + (RING > EPI ? RING : EPI);
  static constexpr int ROWS_A_PASS = THREADS / 8;  // rows a gather pass covers (8 units a row)
  static constexpr int A_ITERS = BM / ROWS_A_PASS;  // 4
};

struct GemmParams {
  const int8_t* codes;     // (N, H, W, C_pad)
  const float* out_scale;  // (C_out,)
  const float* bias;       // (C_out,) or null
  float* y;                // (M, C_out)
  int H, W, C_pad, Ho, Wo, C_out, kw, stride, pad_top, pad_left;
  int K;        // kh * kw * C_pad
  int k_steps;  // K_pad / BK
  int M;        // N * Ho * Wo
};

#define Q8_D8(d, o)                                                                         \
  "+r"(d[(o) + 0]), "+r"(d[(o) + 1]), "+r"(d[(o) + 2]), "+r"(d[(o) + 3]), "+r"(d[(o) + 4]), \
      "+r"(d[(o) + 5]), "+r"(d[(o) + 6]), "+r"(d[(o) + 7])

// D(64 x 64, s32) += A(64 x 32, K-major s8) * B(32 x 64, K-major s8), both
// from shared memory.  d[4j + 2h + e] is row 16 * warp + lane / 4 + 8h,
// column 8j + 2 * (lane % 4) + e, as for every wgmma accumulator.
__device__ __forceinline__ void wgmma_m64n64k32_s8(int (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p;\n}\n"
      : Q8_D8(d, 0), Q8_D8(d, 8), Q8_D8(d, 16), Q8_D8(d, 24)
      : "l"(a), "l"(b), "r"(1));
}

template <int N>
__device__ __forceinline__ void fence_acc_s32(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// TMA_A: a 1x1 conv on its sampled codes, whose A tile is rows m0.. of
// the codes read as an (M, C_pad) matrix; else the gather.
template <int WGS, bool TMA_A>
__global__ void __launch_bounds__(128 * WGS)
    int8_conv_kernel(const __grid_constant__ CUtensorMap b_map,
                     const __grid_constant__ CUtensorMap a_map, const GemmParams p) {
  using T = Tile<WGS>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[STAGES];
  unsigned char* ring = smem_raw + ((ALIGN - smem_u32(smem_raw) % ALIGN) % ALIGN);
  const uint32_t ring_u = smem_u32(ring);

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * T::BM;
  const int n0 = blockIdx.y * BN;

  // The gather: thread tid fills 16-byte unit j of rows tid / 8 + i *
  // ROWS_A_PASS; each row's image offset (in pixels) and top-left tap.
  const int j = tid % 8;
  int row_pix[T::A_ITERS], row_ih[T::A_ITERS], row_iw[T::A_ITERS];
  if constexpr (!TMA_A) {
#pragma unroll
    for (int i = 0; i < T::A_ITERS; ++i) {
      const int m = m0 + tid / 8 + i * T::ROWS_A_PASS;
      if (m < p.M) {
        const int wo = m % p.Wo;
        const int t = m / p.Wo;
        const int ho = t % p.Ho;
        row_pix[i] = (t / p.Ho) * p.H * p.W;
        row_ih[i] = ho * p.stride - p.pad_top;
        row_iw[i] = wo * p.stride - p.pad_left;
      } else {  // past M: every tap reads as padding
        row_pix[i] = 0;
        row_ih[i] = -(1 << 28);
        row_iw[i] = -(1 << 28);
      }
    }
  }

  // Step ks into stage ks % STAGES: the weight (and a 1x1's codes) by TMA
  // from thread 0, the gathered codes by cp.async from every thread (one
  // commit group a step, empty past the last, so the waits count alike).
  auto load = [&](int ks) {
    if (ks < p.k_steps) {
      const int s = ks % STAGES;
      const uint32_t a_s = ring_u + s * T::STAGE_BYTES;
      if (tid == 0) {
        const uint32_t bar = smem_u32(&full_bar[s]);
        mbar_expect_tx(bar, T::B_BYTES + (TMA_A ? T::A_BYTES : 0));
        tma_load(a_s + T::A_BYTES, &b_map, ks * BK, n0, bar);
        if constexpr (TMA_A) tma_load(a_s, &a_map, ks * BK, m0, bar);
      }
      if constexpr (!TMA_A) {
        const int k = ks * BK + j * 16;
        const bool k_ok = k < p.K;
        const int tap = k / p.C_pad;
        const int c = k - tap * p.C_pad;
        const int dh = tap / p.kw;
        const int dw = tap - dh * p.kw;
#pragma unroll
        for (int i = 0; i < T::A_ITERS; ++i) {
          const int r = tid / 8 + i * T::ROWS_A_PASS;
          const int ih = row_ih[i] + dh;
          const int iw = row_iw[i] + dw;
          const bool ok = k_ok && (unsigned)ih < (unsigned)p.H && (unsigned)iw < (unsigned)p.W;
          const int8_t* src =
              ok ? p.codes + ((long long)row_pix[i] + (long long)ih * p.W + iw) * p.C_pad + c
                 : p.codes;
          cp_async16(a_s + r * 128 + ((j ^ (r & 7)) << 4), src, ok);
        }
      }
    }
    if constexpr (!TMA_A) cp_async_commit();
  };

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) mbar_init(smem_u32(&full_bar[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();  // the barriers are initialised
#pragma unroll
  for (int ks = 0; ks < STAGES - 2; ++ks) load(ks);

  const int wg = tid / 128;
  int acc[BN / 2];
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) acc[e] = 0;
  fence_acc_s32(acc);

  for (int ks = 0; ks < p.k_steps; ++ks) {
    const int s = ks % STAGES;
    if constexpr (!TMA_A) {
      cp_async_wait<STAGES - 3>();  // this thread's runs of step ks have landed
      // Generic-proxy writes before the async proxy's (wgmma's) reads.
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    }
    // Every thread's runs of step ks are in; every warpgroup is done with
    // step ks - 2 (its wait below in step ks - 1), so that stage may refill.
    __syncthreads();
    mbar_wait(smem_u32(&full_bar[s]), (ks / STAGES) & 1);
    load(ks + STAGES - 2);
    wgmma_fence();
    const uint32_t a = ring_u + s * T::STAGE_BYTES + wg * 64 * BK;
    const uint32_t b = ring_u + s * T::STAGE_BYTES + T::A_BYTES;
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk)
      // Rows of 128 B, 8-row groups 1024 B apart; k32 = 32 B along the row.
      wgmma_m64n64k32_s8(acc, smem_desc(a + kk * 32, 16, 1024),
                         smem_desc(b + kk * 32, 16, 1024));
    wgmma_commit();
    wgmma_wait<1>();  // one group stays in flight; the one before it is done
  }
  wgmma_wait<0>();
  fence_acc_s32(acc);
  if constexpr (!TMA_A) cp_async_wait<0>();
  __syncthreads();  // every warpgroup is done with the ring: it stages the tile now

  // Epilogue: scale in registers, stage the f32 tile, store whole rows.
  float* tile = reinterpret_cast<float*>(ring);
  const int lane = tid % 32;
  const int row0 = wg * 64 + ((tid % 128) / 32) * 16 + lane / 4;
#pragma unroll
  for (int jn = 0; jn < BN / 8; ++jn) {
    const int col = 8 * jn + 2 * (lane % 4);
    const int o = n0 + col;
    const float sc0 = o < p.C_out ? __ldg(p.out_scale + o) : 0.f;
    const float sc1 = o + 1 < p.C_out ? __ldg(p.out_scale + o + 1) : 0.f;
    const float* bias = p.bias;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float v0 = o < p.C_out ? epilogue(acc[4 * jn + 2 * h], sc0, bias, o) : 0.f;
      const float v1 = o + 1 < p.C_out ? epilogue(acc[4 * jn + 2 * h + 1], sc1, bias, o + 1) : 0.f;
      *reinterpret_cast<float2*>(tile + (row0 + 8 * h) * LDE + col) = make_float2(v0, v1);
    }
  }
  __syncthreads();
  const int rows = min(T::BM, p.M - m0);
  const int cols = min(BN, p.C_out - n0);
  float* out = p.y + (long long)m0 * p.C_out + n0;
  if (p.C_out % 4 == 0) {
    for (int idx = tid; idx < rows * (BN / 4); idx += T::THREADS) {
      const int r = idx / (BN / 4);
      const int c = (idx - r * (BN / 4)) * 4;
      if (c < cols)
        *reinterpret_cast<float4*>(out + (long long)r * p.C_out + c) =
            *reinterpret_cast<const float4*>(tile + r * LDE + c);
    }
  } else {
    for (int idx = tid; idx < rows * BN; idx += T::THREADS) {
      const int r = idx / BN;
      const int c = idx - r * BN;
      if (c < cols) out[(long long)r * p.C_out + c] = tile[r * LDE + c];
    }
  }
}

// A 2-D int8 tensor map over a row-major (rows, cols) matrix, boxes of
// (box_rows, 128 columns), 128-byte swizzle, zero fill outside it.
bool encode_s8_map(EncodeTiled encode, CUtensorMap* map, const void* base, int rows, int cols,
                   int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int WGS, bool TMA_A>
int launch_conv(const GemmParams& p, const void* w, int K_pad, cudaStream_t stream) {
  using T = Tile<WGS>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  alignas(64) CUtensorMap b_map, a_map;
  if (!encode_s8_map(encode, &b_map, w, p.C_out, K_pad, BN)) return (int)cudaErrorInvalidValue;
  a_map = b_map;  // unused by the gather
  if (TMA_A && !encode_s8_map(encode, &a_map, p.codes, p.M, p.C_pad, T::BM))
    return (int)cudaErrorInvalidValue;
  const void* kernel = reinterpret_cast<const void*>(int8_conv_kernel<WGS, TMA_A>);
  const cudaError_t e = allow_max_dynamic_smem(kernel);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((p.M + T::BM - 1) / T::BM, (p.C_out + BN - 1) / BN);
  int8_conv_kernel<WGS, TMA_A><<<grid, T::THREADS, T::SMEM, stream>>>(b_map, a_map, p);
  return (int)cudaGetLastError();
}

// --- Q2 -------------------------------------------------------------------------

constexpr int DW_THREADS = 256;
constexpr int DW_SMEM = 46 * 1024;  // the band's int8 tile: with the taps, no opt-in needed
constexpr int DW_MAX_CG = 64;       // channels a block
constexpr int DW_MIN_ROWS = 8;      // output rows a band before the channel group narrows

struct DwParams {
  const float* x;
  const int8_t* w;  // [k*k][C]
  const float* out_scale;
  const float* bias;
  float* y;
  float s_act;
  int H, W, C;
  int Ho, Wo, stride, pad_top, pad_left;
  int cg;    // channels a block: 4, 8, 16, 32 or 64
  int rows;  // output rows a band
  int wp;    // staged input columns: (Wo - 1) * stride + k
};

// Four blocks an SM (the band's shared memory allows four): at most 64
// registers a thread, which the 3x3 fits without spilling.
template <int K>
__global__ void __launch_bounds__(DW_THREADS, 4) int8_depthwise_kernel(DwParams p) {
  extern __shared__ __align__(16) unsigned char dw_tile[];  // [in_rows][wp][cg] codes
  __shared__ char4 dw_taps[K * K * DW_MAX_CG / 4];          // [k*k][cg / 4]
  const int tid = threadIdx.x;
  const int qg = p.cg / 4;  // channel quads a block; divides DW_THREADS
  const int ho0 = blockIdx.x * p.rows;
  const int rows_out = min(p.rows, p.Ho - ho0);
  const int in_rows = (rows_out - 1) * p.stride + K;
  const int ih0 = ho0 * p.stride - p.pad_top;
  const int c0 = blockIdx.y * p.cg;
  const long long img = blockIdx.z;

  // The group's k*k taps, 4 channels a word.
  for (int i = tid; i < K * K * qg; i += DW_THREADS) {
    const int c = c0 + 4 * (i % qg);
    dw_taps[i] = c < p.C ? __ldg(reinterpret_cast<const char4*>(p.w + (i / qg) * p.C + c))
                         : make_char4(0, 0, 0, 0);
  }
  // The band's input, quantized once on load; padding and channels past C
  // are 0.  Four loads in flight a thread before their codes are stored.
  const int items = in_rows * p.wp * qg;
  for (int base = tid; base < items; base += 4 * DW_THREADS) {
    float4 v[4];
    int dst[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int idx = base + u * DW_THREADS;
      const int q = idx % qg;
      const int t = idx / qg;
      const int col = t % p.wp;
      const int r = t / p.wp;
      const int ih = ih0 + r;
      const int iw = col - p.pad_left;
      const int c = c0 + 4 * q;
      dst[u] = idx < items ? (r * p.wp + col) * p.cg + 4 * q : -1;
      v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (idx < items && (unsigned)ih < (unsigned)p.H && (unsigned)iw < (unsigned)p.W && c < p.C)
        v[u] = __ldg(reinterpret_cast<const float4*>(p.x + ((img * p.H + ih) * p.W + iw) * p.C + c));
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (dst[u] >= 0) *reinterpret_cast<uint32_t*>(dw_tile + dst[u]) = quantize4(v[u], p.s_act);
  }
  __syncthreads();

  const int q = tid % qg;
  const int c = c0 + 4 * q;
  if (c >= p.C) return;
  const float4 sc = __ldg(reinterpret_cast<const float4*>(p.out_scale + c));
  // 3x3: the taps in registers; 5x5: read from shared memory (25 more
  // registers cost the 5x5 kernel its occupancy).
  char4 reg_taps[K == 3 ? 9 : 1];
  if constexpr (K == 3) {
#pragma unroll
    for (int t = 0; t < 9; ++t) reg_taps[t] = dw_taps[t * qg + q];
  }
  for (int pix = tid / qg; pix < rows_out * p.Wo; pix += DW_THREADS / qg) {
    const int ro = pix / p.Wo;
    const int wo = pix - ro * p.Wo;
    int acc[4] = {0, 0, 0, 0};
    const auto tap_row = [&](int dh, auto tap) {
      const unsigned char* row =
          dw_tile + ((ro * p.stride + dh) * p.wp + wo * p.stride) * p.cg + 4 * q;
#pragma unroll
      for (int dw = 0; dw < K; ++dw) {
        const char4 v = *reinterpret_cast<const char4*>(row + dw * p.cg);
        const char4 t = tap(dh * K + dw);
        acc[0] += v.x * t.x;
        acc[1] += v.y * t.y;
        acc[2] += v.z * t.z;
        acc[3] += v.w * t.w;
      }
    };
    if constexpr (K == 3) {
#pragma unroll
      for (int dh = 0; dh < K; ++dh) tap_row(dh, [&](int i) { return reg_taps[i]; });
    } else {
#pragma unroll 1
      for (int dh = 0; dh < K; ++dh) tap_row(dh, [&](int i) { return dw_taps[i * qg + q]; });
    }
    float4 out;
    out.x = epilogue(acc[0], sc.x, p.bias, c);
    out.y = epilogue(acc[1], sc.y, p.bias, c + 1);
    out.z = epilogue(acc[2], sc.z, p.bias, c + 2);
    out.w = epilogue(acc[3], sc.w, p.bias, c + 3);
    *reinterpret_cast<float4*>(p.y + ((img * p.Ho + ho0 + ro) * p.Wo + wo) * p.C + c) = out;
  }
}

}  // namespace

// Q1's quantize pass: x (N,H,W,C) f32 -> codes (N,Hc,Wc,C_pad) int8, C_pad a
// multiple of 16 and >= C, the padding channels code 0; codes pixel (i, j)
// is x pixel (i * stride - pad_top, j * stride - pad_left), code 0 outside x
// (the pixels a 1x1 conv reads; Hc = H, Wc = W, stride 1, no pads for the
// others).  x and codes 16-byte aligned (the wrapper checks).
extern "C" int kdlt_int8_codes(const void* x, void* codes, float s_act, int N, int H, int W,
                               int C, int C_pad, int Hc, int Wc, int stride, int pad_top,
                               int pad_left, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || Hc <= 0 || Wc <= 0 || C <= 0 || C_pad < C || C_pad % 16 ||
      stride <= 0)
    return (int)cudaErrorInvalidValue;
  CodesParams p;
  p.x = static_cast<const float*>(x);
  p.codes = static_cast<int8_t*>(codes);
  p.s_act = s_act;
  p.H = H, p.W = W, p.C = C, p.C_pad = C_pad;
  p.Hc = Hc, p.Wc = Wc, p.stride = stride, p.pad_top = pad_top, p.pad_left = pad_left;
  p.pixels = (long long)N * Hc * Wc;
  if (p.pixels * C_pad >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((p.pixels * (C_pad / 4) + CODES_THREADS - 1) / CODES_THREADS);
  int8_codes_kernel<<<grid, CODES_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// Q1's GEMM: codes (N,H,W,C_pad) int8 from kdlt_int8_codes, w (C_out, K_pad)
// int8 packed (kh, kw, C_pad), out_scale (C_out) f32, bias (C_out) f32 or
// null -> y (N,Ho,Wo,C_out) f32.  The top/left pads given, the bottom/right
// implied by Ho and Wo.  The instance: `warpgroups` 1 or 2 (M tile 64 or
// 128), `tma_a` for a 1x1 stride-1 conv without pads (the wrapper chooses
// by shape; anything else is refused).  Every pointer 16-byte aligned.
extern "C" int kdlt_int8_conv(const void* codes, const void* w, const void* out_scale,
                              const void* bias, void* y, int N, int H, int W, int C_pad, int Ho,
                              int Wo, int C_out, int kh, int kw, int stride, int pad_top,
                              int pad_left, int K_pad, int warpgroups, int tma_a,
                              void* stream) {
  GemmParams p;
  p.codes = static_cast<const int8_t*>(codes);
  p.out_scale = static_cast<const float*>(out_scale);
  p.bias = static_cast<const float*>(bias);
  p.y = static_cast<float*>(y);
  p.H = H, p.W = W, p.C_pad = C_pad, p.Ho = Ho, p.Wo = Wo, p.C_out = C_out;
  p.kw = kw, p.stride = stride, p.pad_top = pad_top, p.pad_left = pad_left;
  p.K = kh * kw * C_pad;
  p.k_steps = K_pad / BK;
  p.M = N * Ho * Wo;
  if (C_pad <= 0 || C_pad % 16 || K_pad % BK || K_pad < p.K || p.M <= 0 || C_out <= 0 ||
      kh <= 0 || kw <= 0 || stride <= 0 || pad_top < 0 || pad_left < 0)
    return (int)cudaErrorInvalidValue;
  if (tma_a && (kh != 1 || kw != 1 || stride != 1 || pad_top || pad_left || Ho != H || Wo != W))
    return (int)cudaErrorInvalidValue;
  for (const void* ptr : {codes, w, out_scale, (const void*)y})
    if (ptr == nullptr || !aligned16(ptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (warpgroups == 1)
    return tma_a ? launch_conv<1, true>(p, w, K_pad, s) : launch_conv<1, false>(p, w, K_pad, s);
  if (warpgroups == 2)
    return tma_a ? launch_conv<2, true>(p, w, K_pad, s) : launch_conv<2, false>(p, w, K_pad, s);
  return (int)cudaErrorInvalidValue;
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
  p.H = H, p.W = W, p.C = C;
  p.Ho = Ho, p.Wo = Wo, p.stride = stride, p.pad_top = pad_top, p.pad_left = pad_left;
  if (C <= 0 || C % 4 || N <= 0 || N > 65535 || H <= 0 || W <= 0 || Ho <= 0 || Wo <= 0 ||
      stride <= 0 || pad_top < 0 || pad_left < 0 || (k != 3 && k != 5))
    return (int)cudaErrorInvalidValue;
  p.wp = (Wo - 1) * stride + k;
  // Output rows whose input fits in DW_SMEM at cg channels.
  const auto fit = [&](int cg) { return (DW_SMEM / (p.wp * cg) - k) / stride + 1; };
  p.cg = 4;
  while (p.cg < C && p.cg < DW_MAX_CG) p.cg *= 2;
  // Narrower groups on wide images, so a band's halo stays a small share.
  while (p.cg > 8 && fit(p.cg) < (Ho < DW_MIN_ROWS ? Ho : DW_MIN_ROWS)) p.cg /= 2;
  if (fit(p.cg) < 1) return (int)cudaErrorInvalidValue;
  const int groups = (C + p.cg - 1) / p.cg;
  const int row_bytes = p.wp * p.cg;
  p.rows = fit(p.cg) < Ho ? fit(p.cg) : Ho;
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  // Thinner bands until the grid fills the SMs twice (their halo is read again).
  while (p.rows > 1 && (long long)N * groups * ((Ho + p.rows - 1) / p.rows) < 2LL * sms)
    p.rows = (p.rows + 1) / 2;
  const int smem = ((p.rows - 1) * stride + k) * row_bytes;
  const dim3 grid((Ho + p.rows - 1) / p.rows, groups, N);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k == 3)
    int8_depthwise_kernel<3><<<grid, DW_THREADS, smem, s>>>(p);
  else
    int8_depthwise_kernel<5><<<grid, DW_THREADS, smem, s>>>(p);
  return (int)cudaGetLastError();
}
