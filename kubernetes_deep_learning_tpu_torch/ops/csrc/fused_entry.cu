// Xception entry-segment kernel for Hopper (sm_90a): K5.
//
//   conv2 3x3 VALID (C_in -> C_b) + BN + relu                    -> b
//   block2 residual 1x1 stride 2 (C_b -> C_out) + BN, on b        -> r
//   sepconv1 (C_b -> C_out) + BN + relu, on b                     -> c
//   sepconv2 (C_out -> C_out) + BN, on c                          -> d
//   out = max-pool 3x3/2 SAME (d) + r
//
// Replaces the TPU kernels fused_entry_block_t of
// kubernetes_deep_learning_tpu/ops/fused_entry.py (pallas_call at :283) and
// its prototype fused_entry of exp/fused_entry.py (pallas_call at :257),
// which compute the same function at Xception's geometry (149x149x32 ->
// 74x74x128).  The Python wrapper is fused_entry_block in ../fused_entry.py;
// its plain PyTorch version, entry_block_reference, defines the arithmetic
// this kernel reproduces, rounding point for rounding point:
//   b = bf16(relu(conv2 . s + t)), bf16 operands, f32 accumulation;
//   depthwise taps in f32 over bf16 inputs with f32 weights -> bf16 -> GEMM
//   with bf16 operands and f32 accumulation -> affine in f32 -> bf16;
//   r = bf16(f32(b[::2, ::2] @ res) * s + t);
//   out = bf16(max over the window of bf16 d + r), out-of-image taps -inf.
//
// What bounds it on the card: at batch 16 the four GEMMs are 31.2 GFLOP of
// bf16 products (conv2 12.75, pw1 5.66, pw2 11.33, res 1.44) -- 0.032 ms at
// 989 TFLOP/s -- plus 1.19 GFLOP of f32 depthwise taps (0.018 ms at 67
// TFLOP/s), against 22.7 MB in and 22.4 MB out (0.0135 ms at 3.35 TB/s):
// operations bound it, at ~0.05 ms.
//
// What this design does about it (first, simple version): four launches.
//   * conv2 is an implicit GEMM (M = pixels, K = 9 * C_in, N = C_b): each
//     block gathers its 64 pixels' 3x3 patches tap by tap straight from the
//     input into shared memory as the A operand (no im2col in device
//     memory), multiplies on tensor cores (wmma bf16 16x16x16, f32
//     accumulate) and applies affine + relu in the epilogue;
//   * the two sepconvs are the stage kernel of fused_sepconv.cu (K1/K2's),
//     which keeps each depthwise result in shared memory as its GEMM's A
//     operand;
//   * one last launch computes the residual 1x1/2 GEMM on b's even pixels
//     for a tile of output pixels and, in its epilogue, the 3x3/2 max over d
//     for the same pixels and the sum: r never touches device memory.
// Known costs left for later work: b, c and d (147x147x64..128 per image,
// the model's largest activations) go through device memory, where the TPU
// kernel keeps them on chip in row bands with halos; the loads are not
// pipelined (no cp.async / TMA); wmma instead of wgmma; the pool re-reads
// each d value up to four times (through L2).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stddef.h>

using namespace nvcuda;

// The sepconv stage kernel's entry point (fused_sepconv.cu, same library).
extern "C" int kdlt_sepconv_stage(const void* x, const void* dw, const void* pw,
                                  const void* scale, const void* shift, const void* residual,
                                  void* out, int B, int H, int W, int C_in, int C_out,
                                  int pre_relu, int post_relu, void* stream);

namespace {

constexpr int BM = 64;        // output pixels per block tile
constexpr int BN = 64;        // output channels per block tile
constexpr int BK = 32;        // input channels per K step
constexpr int THREADS = 128;  // 4 warps: 2 along M x 2 along N, 32x32 each
constexpr int A_LD = BK + 8;  // padded leading dims (bank spread; wmma needs
constexpr int B_LD = BN + 8;  //   multiples of 8 bf16 / 4 f32)
constexpr int C_LD = BN + 4;
constexpr int A_BYTES = BM * A_LD * 2;
constexpr int B_BYTES = BK * B_LD * 2;
constexpr int C_BYTES = BM * C_LD * 4;
constexpr int SMEM_BYTES = (A_BYTES + B_BYTES) > C_BYTES ? (A_BYTES + B_BYTES) : C_BYTES;
constexpr int A_VECS = BM * BK / 8 / THREADS;  // 16-byte vectors per thread per A tile: 2
constexpr int B_VECS = BK * BN / 8 / THREADS;  // the same for the B tile: 2

static_assert(A_BYTES % 32 == 0, "wmma pointers must be 32-byte aligned");
static_assert(A_VECS * THREADS * 8 == BM * BK && B_VECS * THREADS * 8 == BK * BN, "tiling");

enum Mode { CONV = 0, RES_POOL = 1 };

// One launch of the gathered GEMM.  Output pixel m = (n, i, j) of an
// (Bn, Ho, Wo) grid; its A row for tap t = (dh, dw) is the source pixel
//   CONV:     (n, i + dh, j + dw) of x (Bn, H, W, K), 9 taps;
//   RES_POOL: (n, 2i, 2j) of b (Bn, H, W, K), one tap.
struct Args {
  const __nv_bfloat16* src;   // x or b
  const __nv_bfloat16* w;     // (taps * K, N) bf16, taps (dh, dw)-major
  const float* scale;         // (N,)
  const float* shift;         // (N,)
  const __nv_bfloat16* pool;  // RES_POOL: d (Bn, H, W, N)
  __nv_bfloat16* out;         // (Bn, Ho, Wo, N)
  int Bn, H, W, Ho, Wo, K, N;
  int pad_top, pad_left;      // RES_POOL: the SAME pool's leading pads
};

template <int MODE>
__global__ void __launch_bounds__(THREADS) entry_gemm_kernel(Args p) {
  constexpr int TAPS = MODE == CONV ? 9 : 1;
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(smem + A_BYTES);
  float* Cs = reinterpret_cast<float*>(smem);

  const int HWo = p.Ho * p.Wo;
  const int M = p.Bn * HWo;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2;  // 0..1
  const int wn = warp % 2;  // 0..1

  // The source pixel (tap 0) of each A row this thread loads; -1 past M.
  int row_pix[A_VECS];
#pragma unroll
  for (int v = 0; v < A_VECS; ++v) {
    const int m = m0 + (tid + v * THREADS) / (BK / 8);
    if (m < M) {
      const int n = m / HWo, ij = m % HWo, i = ij / p.Wo, j = ij % p.Wo;
      row_pix[v] = MODE == CONV ? (n * p.H + i) * p.W + j : (n * p.H + 2 * i) * p.W + 2 * j;
    } else {
      row_pix[v] = -1;
    }
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int t = 0; t < TAPS; ++t) {
    const int tap_off = (t / 3) * p.W + (t % 3);  // CONV: (dh, dw) in source pixels
    for (int k0 = 0; k0 < p.K; k0 += BK) {
      // --- A tile: 16-byte vectors of 8 channels, zero past K or M ---
#pragma unroll
      for (int v = 0; v < A_VECS; ++v) {
        const int idx = tid + v * THREADS;
        const int r = idx / (BK / 8), q = idx % (BK / 8);
        const int k = k0 + q * 8;
        uint4 val = zero;
        if (row_pix[v] >= 0 && k < p.K)
          val = *reinterpret_cast<const uint4*>(
              p.src + (size_t)(row_pix[v] + tap_off) * p.K + k);
        *reinterpret_cast<uint4*>(As + r * A_LD + q * 8) = val;
      }
      // --- B tile: rows t*K + k0 .. of the weight matrix ---
#pragma unroll
      for (int v = 0; v < B_VECS; ++v) {
        const int idx = tid + v * THREADS;
        const int kr = idx / (BN / 8), q = idx % (BN / 8);
        const int k = k0 + kr, n = n0 + q * 8;
        uint4 val = zero;
        if (k < p.K && n < p.N)
          val = *reinterpret_cast<const uint4*>(p.w + (size_t)(t * p.K + k) * p.N + n);
        *reinterpret_cast<uint4*>(Bs + kr * B_LD + q * 8) = val;
      }
      __syncthreads();

      // --- tensor-core GEMM on the chunk ---
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(af[i], As + (wm * 32 + i * 16) * A_LD + kk, A_LD);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(bf[j], Bs + kk * B_LD + wn * 32 + j * 16, B_LD);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  // --- epilogue ---
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * C_LD + wn * 32 + j * 16, acc[i][j],
                              C_LD, wmma::mem_row_major);
  __syncthreads();
  for (int idx = tid; idx < BM * BN; idx += THREADS) {
    const int r = idx / BN, nc = idx % BN;
    const int m = m0 + r, n = n0 + nc;
    if (m >= M || n >= p.N) continue;
    const float z = Cs[r * C_LD + nc] * p.scale[n] + p.shift[n];
    if (MODE == CONV) {
      p.out[(size_t)m * p.N + n] = __float2bfloat16(fmaxf(z, 0.0f));
    } else {
      // SAME 3x3/2 max over d for output pixel (img, i, j): window rows
      // 2i - pad_top + 0..2, columns likewise; taps outside d are -inf.
      const int img = m / HWo, ij = m % HWo, i = ij / p.Wo, j = ij % p.Wo;
      float mx = __int_as_float(0xff800000);  // -inf
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const int hh = 2 * i - p.pad_top + a;
        if (hh < 0 || hh >= p.H) continue;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const int ww = 2 * j - p.pad_left + c;
          if (ww < 0 || ww >= p.W) continue;
          mx = fmaxf(mx, __bfloat162float(p.pool[((size_t)(img * p.H + hh) * p.W + ww) * p.N + n]));
        }
      }
      const float r_val = __bfloat162float(__float2bfloat16(z));
      p.out[(size_t)m * p.N + n] = __float2bfloat16(mx + r_val);
    }
  }
}

template <int MODE>
cudaError_t launch(const Args& p, cudaStream_t stream) {
  const long long M = (long long)p.Bn * p.Ho * p.Wo;
  dim3 grid((unsigned)((M + BM - 1) / BM), (p.N + BN - 1) / BN);
  entry_gemm_kernel<MODE><<<grid, THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

// TF "SAME" leading pad of a k=3, s=2 window along a side of `size`.
int same_pad_before(int size) {
  const int out = (size + 1) / 2;
  const int total = (out - 1) * 2 + 3 - size;
  return total > 0 ? total / 2 : 0;
}

}  // namespace

// K5: x (B, H, W, C_in) bf16 -> out (B, ceil((H-2)/2), ceil((W-2)/2), C_out)
// bf16.  conv2 (9*C_in, C_b), res (C_b, C_out), pw1 (C_b, C_out), pw2
// (C_out, C_out) bf16; dw1 (3,3,C_b), dw2 (3,3,C_out) and the affine pairs
// f32.  b_buf (B, H-2, W-2, C_b), c_buf and d_buf (B, H-2, W-2, C_out) bf16
// are scratch the caller allocates.  Every tensor contiguous; C_in, C_b and
// C_out multiples of 8.  Four launches on `stream`; returns the first
// cudaError_t that is not 0 (a refused launch never runs), else 0.
extern "C" int kdlt_entry_block(const void* x, const void* conv2, const void* conv2_s,
                                const void* conv2_b, const void* res, const void* res_s,
                                const void* res_b, const void* dw1, const void* pw1,
                                const void* bn1_s, const void* bn1_b, const void* dw2,
                                const void* pw2, const void* bn2_s, const void* bn2_b,
                                void* b_buf, void* c_buf, void* d_buf, void* out, int B, int H,
                                int W, int C_in, int C_b, int C_out, void* stream) {
  if (B <= 0 || H < 3 || W < 3 || C_in <= 0 || C_b <= 0 || C_out <= 0 || C_in % 8 ||
      C_b % 8 || C_out % 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int Hb = H - 2, Wb = W - 2;
  const auto* bf = static_cast<const __nv_bfloat16*>(b_buf);

  Args conv{static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(conv2),
            static_cast<const float*>(conv2_s), static_cast<const float*>(conv2_b), nullptr,
            static_cast<__nv_bfloat16*>(b_buf), B, H, W, Hb, Wb, C_in, C_b, 0, 0};
  int code = (int)launch<CONV>(conv, s);
  if (code) return code;
  code = kdlt_sepconv_stage(b_buf, dw1, pw1, bn1_s, bn1_b, nullptr, c_buf, B, Hb, Wb, C_b, C_out,
                            /*pre_relu=*/0, /*post_relu=*/1, stream);
  if (code) return code;
  code = kdlt_sepconv_stage(c_buf, dw2, pw2, bn2_s, bn2_b, nullptr, d_buf, B, Hb, Wb, C_out,
                            C_out, 0, 0, stream);
  if (code) return code;
  Args pool{bf, static_cast<const __nv_bfloat16*>(res), static_cast<const float*>(res_s),
            static_cast<const float*>(res_b), static_cast<const __nv_bfloat16*>(d_buf),
            static_cast<__nv_bfloat16*>(out), B, Hb, Wb, (Hb + 1) / 2, (Wb + 1) / 2, C_b, C_out,
            same_pad_before(Hb), same_pad_before(Wb)};
  return (int)launch<RES_POOL>(pool, s);
}
