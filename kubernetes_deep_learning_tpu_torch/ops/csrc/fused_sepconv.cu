// Separable-conv stage kernel for Hopper (sm_90a): relu -> 3x3 SAME
// depthwise -> 1x1 pointwise GEMM -> folded-BN affine (-> relu) (+ residual).
//
// Replaces the TPU kernels of kubernetes_deep_learning_tpu/ops/fused_sepconv.py:
//   fused_sepconv_block_t  (pallas_call at :192) -- Xception middle block,
//       3 stages + residual: three launches of this kernel, the third one
//       adding the block input in its epilogue;
//   fused_sepconv_chain_t  (pallas_call at :307) -- the exit-flow chains
//       (block13 728->728->1024, block14 1024->1536->2048): one launch per
//       stage.
// The Python wrappers are in ../fused_sepconv.py; their plain PyTorch
// versions (sepconv_block_reference, sepconv_chain_reference) define the
// arithmetic this kernel must reproduce, rounding point for rounding point:
//   depthwise taps in f32 over bf16 inputs -> round to bf16 -> GEMM with
//   bf16 operands and f32 accumulation -> z * scale + shift in f32 (-> relu)
//   -> round to bf16 (-> + residual in bf16).
//
// What bounds it on the card: at the middle-flow shape (19x19x728, batch 16)
// one block is 18.4 GFLOP of bf16 GEMM against ~20 MB of activations and
// weights, i.e. ~900 FLOP/byte -- above the H100's ~295 FLOP/byte ridge, so
// tensor-core throughput bounds it, not device memory.  The depthwise part
// (9 f32 multiply-adds per GEMM input element) runs on the CUDA cores.
//
// What this design does about it (first, simple version):
//   * the depthwise result never touches device memory: each block computes
//     the depthwise values of its 64-pixel x 32-channel K-chunk straight into
//     shared memory as the GEMM's A operand (the prologue), then multiplies
//     with tensor cores (wmma bf16 16x16x16, f32 accumulate);
//   * affine, relu, bf16 rounding and the residual are fused into the
//     epilogue, so each stage reads its input and writes its output once;
//   * tiles are 64 pixels x 128 output channels, 8 warps of 32x32 each; the
//     wide N tile keeps the depthwise recomputation (once per N tile) small
//     against the GEMM work.
// Known costs left for later work: the depthwise prologue is recomputed by
// every N tile of a row block, the loads are not pipelined (no cp.async /
// TMA), wmma instead of wgmma, and the stage intermediates of a block go
// through device memory (L2-resident at serving batches).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stddef.h>

using namespace nvcuda;

namespace {

constexpr int BM = 64;        // pixels per block tile
constexpr int BN = 128;       // output channels per block tile
constexpr int BK = 32;        // input channels per K step
constexpr int THREADS = 256;  // 8 warps: 2 along M x 4 along N, 32x32 each
constexpr int A_LD = BK + 8;  // padded leading dims (bank spread; wmma needs
constexpr int B_LD = BN + 8;  //   multiples of 8 bf16 / 4 f32)
constexpr int C_LD = BN + 4;
constexpr int A_BYTES = BM * A_LD * 2;
constexpr int B_BYTES = BK * B_LD * 2;
constexpr int C_BYTES = BM * C_LD * 4;
constexpr int SMEM_BYTES = (A_BYTES + B_BYTES) > C_BYTES ? (A_BYTES + B_BYTES) : C_BYTES;
constexpr int ROWS_PER_THREAD = BM * BK / THREADS;  // 8

static_assert(THREADS % BK == 0, "prologue maps one channel per lane");
static_assert(A_BYTES % 32 == 0, "wmma pointers must be 32-byte aligned");

__global__ void __launch_bounds__(THREADS)
sepconv_stage_kernel(const __nv_bfloat16* __restrict__ x,      // (B,H,W,C_in)
                     const float* __restrict__ dw,             // (3,3,C_in)
                     const __nv_bfloat16* __restrict__ pw,     // (C_in,C_out)
                     const float* __restrict__ scale,          // (C_out,)
                     const float* __restrict__ shift,          // (C_out,)
                     const __nv_bfloat16* __restrict__ residual,  // (B,H,W,C_out) or null
                     __nv_bfloat16* __restrict__ out,          // (B,H,W,C_out)
                     int B, int H, int W, int C_in, int C_out,
                     int pre_relu, int post_relu) {
  // A and B tiles during the K loop; the f32 accumulator tile afterwards.
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(smem + A_BYTES);
  float* Cs = reinterpret_cast<float*>(smem);

  const int HW = H * W;
  const int M = B * HW;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 4;  // 0..1
  const int wn = warp % 4;  // 0..3

  // Prologue mapping: lane -> one input channel of the K chunk (coalesced
  // NHWC reads), thread group -> rows r0, r0 + 8, ..., r0 + 56 of the tile.
  const int kc = tid % BK;
  const int r0 = tid / BK;
  int pix_base[ROWS_PER_THREAD];  // (b*H + h)*W + w, or -1 past the end
  int pix_h[ROWS_PER_THREAD];
  int pix_w[ROWS_PER_THREAD];
#pragma unroll
  for (int j = 0; j < ROWS_PER_THREAD; ++j) {
    const int m = m0 + r0 + 8 * j;
    if (m < M) {
      const int hw = m % HW;
      pix_h[j] = hw / W;
      pix_w[j] = hw % W;
      pix_base[j] = m;
    } else {
      pix_h[j] = 0;
      pix_w[j] = 0;
      pix_base[j] = -1;
    }
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < C_in; k0 += BK) {
    // --- A tile: depthwise 3x3 SAME of this K chunk, f32 taps, bf16 out ---
    const int c = k0 + kc;
    const bool c_ok = c < C_in;
    float tap[9];
#pragma unroll
    for (int t = 0; t < 9; ++t) tap[t] = c_ok ? dw[(size_t)t * C_in + c] : 0.0f;
#pragma unroll
    for (int j = 0; j < ROWS_PER_THREAD; ++j) {
      float s = 0.0f;
      if (c_ok && pix_base[j] >= 0) {
        const int h = pix_h[j];
        const int w = pix_w[j];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const int hh = h + a - 1;
          if (hh < 0 || hh >= H) continue;
#pragma unroll
          for (int b = 0; b < 3; ++b) {
            const int ww = w + b - 1;
            if (ww < 0 || ww >= W) continue;
            const size_t src = (size_t)(pix_base[j] + (a - 1) * W + (b - 1)) * C_in + c;
            float v = __bfloat162float(x[src]);
            if (pre_relu) v = fmaxf(v, 0.0f);
            s += v * tap[a * 3 + b];
          }
        }
      }
      As[(r0 + 8 * j) * A_LD + kc] = __float2bfloat16(s);
    }
    // --- B tile: pointwise weights, zero past C_in / C_out ---
    for (int idx = tid; idx < BK * BN; idx += THREADS) {
      const int kr = idx / BN;
      const int nc = idx % BN;
      const int k = k0 + kr;
      const int n = n0 + nc;
      Bs[kr * B_LD + nc] =
          (k < C_in && n < C_out) ? pw[(size_t)k * C_out + n] : __float2bfloat16(0.0f);
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

  // --- epilogue: affine (+relu) -> bf16 (+residual), masked store ---
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * C_LD + wn * 32 + j * 16, acc[i][j],
                              C_LD, wmma::mem_row_major);
  __syncthreads();
  for (int idx = tid; idx < BM * BN; idx += THREADS) {
    const int r = idx / BN;
    const int nc = idx % BN;
    const int m = m0 + r;
    const int n = n0 + nc;
    if (m >= M || n >= C_out) continue;
    float v = Cs[r * C_LD + nc] * scale[n] + shift[n];
    if (post_relu) v = fmaxf(v, 0.0f);
    __nv_bfloat16 o = __float2bfloat16(v);
    const size_t dst = (size_t)m * C_out + n;
    if (residual != nullptr) o = __float2bfloat16(__bfloat162float(residual[dst]) + __bfloat162float(o));
    out[dst] = o;
  }
}

}  // namespace

// Plain C interface, bound with ctypes (ops/_build.py).  Pointers are device
// pointers from tensor.data_ptr(); ``stream`` is a cudaStream_t.  Returns the
// cudaError_t of the launch (0 on success): a refused launch never runs.
extern "C" int kdlt_sepconv_stage(const void* x, const void* dw, const void* pw,
                                  const void* scale, const void* shift, const void* residual,
                                  void* out, int B, int H, int W, int C_in, int C_out,
                                  int pre_relu, int post_relu, void* stream) {
  const int M = B * H * W;
  if (M <= 0 || C_in <= 0 || C_out <= 0) return (int)cudaErrorInvalidValue;
  dim3 grid((M + BM - 1) / BM, (C_out + BN - 1) / BN);
  sepconv_stage_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(dw),
      static_cast<const __nv_bfloat16*>(pw), static_cast<const float*>(scale),
      static_cast<const float*>(shift), static_cast<const __nv_bfloat16*>(residual),
      static_cast<__nv_bfloat16*>(out), B, H, W, C_in, C_out, pre_relu, post_relu);
  return (int)cudaGetLastError();
}

extern "C" const char* kdlt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
