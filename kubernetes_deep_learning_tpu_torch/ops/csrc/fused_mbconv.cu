// Fused MBConv block kernels for Hopper (sm_90a): EfficientNet's stride-1
// inverted residual, 1x1 expand -> BN -> silu -> kxk SAME depthwise -> BN ->
// silu -> squeeze-excite gate -> 1x1 project -> BN (-> + residual).
//
// Replaces the TPU kernel kubernetes_deep_learning_tpu/ops/fused_mbconv.py::
// fused_mbconv_block_t (pallas_call at :244).  The Python wrapper is
// ../fused_mbconv.py; its plain PyTorch version, mbconv_block_reference,
// defines the arithmetic reproduced here rounding point for rounding point:
//   expand GEMM on bf16 operands with f32 sums -> affine -> silu (f32) -> bf16;
//   depthwise f32 taps over bf16 -> affine -> silu -> bf16;
//   f32 mean of those bf16 values -> bf16 -> reduce GEMM + bias -> silu ->
//   bf16 -> expand GEMM + bias -> sigmoid: the gate g (f32);
//   bf16(f32(y) * g) -> project GEMM (f32 sums) -> affine -> bf16 (-> + x in bf16).
// Exponentials use expf (full precision), not __expf.
//
// Why four launches: the gate needs the spatial mean of the whole image
// before the project GEMM can start, and an image's expanded activation
// (38*38*288 bf16 at EfficientNet-B3's largest fused stage, ~830 KB) does not
// fit the 227 KB of shared memory, as the TPU kernel's whole-image VMEM tile
// did.  So one block is:
//   1. expand: GEMM (B*H*W, C_in) x (C_in, C_mid) on bf16 tensor cores (wmma
//      16x16x16, f32 accumulate), affine + silu + bf16 store in the epilogue;
//   2. depthwise: a block stages a band of rows of one image (with the halo)
//      and its taps in shared memory; a thread owns 8 channels and walks
//      every 32nd pixel of the band, f32 taps, affine + silu + bf16 store,
//      and the block writes the band's f32 sums of the stored values (a
//      fixed-order reduction: deterministic, no float atomics);
//   3. squeeze-excite: one block per image sums the bands in order and runs
//      the two narrow GEMMs (S = 6..96 wide) on the CUDA cores, the reduce
//      split over (channel chunk, output) pairs so its weight reads coalesce;
//   4. project: the same GEMM kernel, gating its A operand with g[b, c]
//      while staging it into shared memory, affine + bf16 + residual in the
//      epilogue.
// The GEMM holds two shared-memory stages and loads the next K step into
// registers while the tensor cores work on the current one.
//
// What bounds it on the card: at B3's shapes (batch 16) the f32 depthwise
// taps on the CUDA cores (k*k FMAs per expanded element, 67 TFLOP/s) take
// longer than the bf16 GEMMs at tensor-core rate and than moving the block's
// input and output once; each call's bound is 2-7 us.  This first, simple
// version writes the expanded and depthwise activations to device memory
// (L2-resident at serving batches) and reloads them, stages its loads
// through registers (no cp.async / TMA), and uses wmma rather than wgmma;
// keeping the expanded tile on chip is the work left for later.
//
// Widths must be multiples of 8 (the wrapper checks): every 16-byte vector
// of 8 channels is then wholly inside or outside a row, so the K tails are
// zero-filled and the N tails masked a vector at a time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stddef.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

// ---- GEMM (expand and project) ---------------------------------------------
constexpr int GM = 64;         // rows (pixels) per block tile
constexpr int GN = 64;         // output channels per block tile
constexpr int GK = 32;         // input channels per K step
constexpr int GEMM_THREADS = 128;  // 4 warps: 2 along M x 2 along N, 32x32 each
constexpr int VEC = 8;         // bf16 values per 16-byte vector
constexpr int A_LD = GK + 8;   // padded leading dims (bank spread; wmma needs
constexpr int B_LD = GN + 8;   //   multiples of 8 bf16 / 4 f32)
constexpr int C_LD = GN + 4;
constexpr int A_BYTES = GM * A_LD * 2;
constexpr int B_BYTES = GK * B_LD * 2;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;  // one K step's A and B tiles
constexpr int C_BYTES = GM * C_LD * 4;
constexpr int GEMM_SMEM = 2 * STAGE_BYTES > C_BYTES ? 2 * STAGE_BYTES : C_BYTES;
constexpr int A_VECS = GM * GK / VEC / GEMM_THREADS;  // 16-byte vectors per thread per step
constexpr int B_VECS = GK * GN / VEC / GEMM_THREADS;

static_assert(A_BYTES % 128 == 0 && STAGE_BYTES % 128 == 0, "tiles stay 128-byte aligned");
static_assert((A_LD * 2) % 16 == 0 && (B_LD * 2) % 16 == 0, "16-byte vector stores");
static_assert(A_VECS * GEMM_THREADS * VEC == GM * GK && B_VECS * GEMM_THREADS * VEC == GK * GN,
              "every thread stages whole vectors");

// ---- depthwise and squeeze-excite ------------------------------------------
constexpr int DW_VECS = 8;      // channel vectors of 8 per depthwise block: 64 channels
constexpr int DW_CH = DW_VECS * VEC;
constexpr int DW_GROUPS = 32;   // pixel groups per depthwise block
constexpr int DW_THREADS = DW_VECS * DW_GROUPS;
constexpr int DW_MAX_SMEM = 96 * 1024;  // taps + input tile of one depthwise block
constexpr int SE_THREADS = 1024;

__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }
__device__ __forceinline__ float sigmoid(float v) { return 1.0f / (1.0f + expf(-v)); }
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ void unpack8(const uint4& v, float f[VEC]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float f[VEC]) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return v;
}

// One K step's A and B vectors of a thread, held in registers between the
// global loads and the shared-memory stores (the next step's loads are in
// flight while the tensor cores work on the current step).
struct Stage {
  uint4 a[A_VECS];
  uint4 b[B_VECS];
};

// Global -> registers: A rows m0.., columns k0.. (gated when gate != null),
// B rows k0.., columns n0..; zeros past M, K and N.
__device__ __forceinline__ void load_stage(Stage& st, const __nv_bfloat16* __restrict__ a,
                                           const float* __restrict__ gate,
                                           const __nv_bfloat16* __restrict__ w, int m0, int n0,
                                           int k0, int M, int hw, int K, int N) {
#pragma unroll
  for (int q = 0; q < A_VECS; ++q) {
    const int i = threadIdx.x + q * GEMM_THREADS;
    const int m = m0 + i / (GK / VEC);
    const int k = k0 + (i % (GK / VEC)) * VEC;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (m < M && k < K) {
      v = *reinterpret_cast<const uint4*>(a + (size_t)m * K + k);
      if (gate != nullptr) {
        const float4* g = reinterpret_cast<const float4*>(gate + (size_t)(m / hw) * K + k);
        const float4 g0 = g[0];
        const float4 g1 = g[1];
        float f[VEC];
        unpack8(v, f);
        f[0] *= g0.x;
        f[1] *= g0.y;
        f[2] *= g0.z;
        f[3] *= g0.w;
        f[4] *= g1.x;
        f[5] *= g1.y;
        f[6] *= g1.z;
        f[7] *= g1.w;
        v = pack8(f);
      }
    }
    st.a[q] = v;
  }
#pragma unroll
  for (int q = 0; q < B_VECS; ++q) {
    const int i = threadIdx.x + q * GEMM_THREADS;
    const int k = k0 + i / (GN / VEC);
    const int n = n0 + (i % (GN / VEC)) * VEC;
    st.b[q] = (k < K && n < N) ? *reinterpret_cast<const uint4*>(w + (size_t)k * N + n)
                               : make_uint4(0u, 0u, 0u, 0u);
  }
}

__device__ __forceinline__ void store_stage(const Stage& st, __nv_bfloat16* As,
                                            __nv_bfloat16* Bs) {
#pragma unroll
  for (int q = 0; q < A_VECS; ++q) {
    const int i = threadIdx.x + q * GEMM_THREADS;
    *reinterpret_cast<uint4*>(As + (i / (GK / VEC)) * A_LD + (i % (GK / VEC)) * VEC) = st.a[q];
  }
#pragma unroll
  for (int q = 0; q < B_VECS; ++q) {
    const int i = threadIdx.x + q * GEMM_THREADS;
    *reinterpret_cast<uint4*>(Bs + (i / (GN / VEC)) * B_LD + (i % (GN / VEC)) * VEC) = st.b[q];
  }
}

// out[m, n] = bf16(epilogue(sum_k A'[m, k] * w[k, n])) with
//   A'[m, k] = a[m, k], or bf16(f32(a[m, k]) * gate[m / hw, k]) when gate != null;
//   epilogue: v * scale[n] + shift[n], then silu when act_silu;
//   then + residual[m, n] in bf16 when residual != null.
// Two shared-memory stages: step t's tiles feed the tensor cores while step
// t + 1's are loaded into registers, then stored into the other stage.
__global__ void __launch_bounds__(GEMM_THREADS)
mbconv_gemm_kernel(const __nv_bfloat16* __restrict__ a,      // (M, K)
                   const float* __restrict__ gate,           // (M / hw, K) or null
                   const __nv_bfloat16* __restrict__ w,      // (K, N)
                   const float* __restrict__ scale,          // (N,)
                   const float* __restrict__ shift,          // (N,)
                   const __nv_bfloat16* __restrict__ residual,  // (M, N) or null
                   __nv_bfloat16* __restrict__ out,          // (M, N)
                   int M, int hw, int K, int N, int act_silu) {
  // Two stages of A and B tiles during the K loop; the f32 accumulator tile
  // afterwards.
  __shared__ __align__(128) unsigned char smem[GEMM_SMEM];
  float* Cs = reinterpret_cast<float*>(smem);

  const int m0 = blockIdx.x * GM;
  const int n0 = blockIdx.y * GN;
  const int warp = threadIdx.x / 32;
  const int wm = warp / 2;  // 0..1
  const int wn = warp % 2;  // 0..1

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  Stage st;
  load_stage(st, a, gate, w, m0, n0, 0, M, hw, K, N);
  store_stage(st, reinterpret_cast<__nv_bfloat16*>(smem),
              reinterpret_cast<__nv_bfloat16*>(smem + A_BYTES));
  __syncthreads();
  int cur = 0;
  for (int k0 = 0; k0 < K; k0 += GK) {
    const bool more = k0 + GK < K;
    if (more) load_stage(st, a, gate, w, m0, n0, k0 + GK, M, hw, K, N);
    const __nv_bfloat16* As = reinterpret_cast<const __nv_bfloat16*>(smem + cur * STAGE_BYTES);
    const __nv_bfloat16* Bs = As + A_BYTES / 2;
#pragma unroll
    for (int kk = 0; kk < GK; kk += 16) {
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
    if (more) {
      __nv_bfloat16* next = reinterpret_cast<__nv_bfloat16*>(smem + (cur ^ 1) * STAGE_BYTES);
      store_stage(st, next, next + A_BYTES / 2);
    }
    __syncthreads();
    cur ^= 1;
  }

  // --- epilogue: affine (+silu) -> bf16 (+residual), 8 channels a vector ---
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * C_LD + wn * 32 + j * 16, acc[i][j],
                              C_LD, wmma::mem_row_major);
  __syncthreads();
  for (int i = threadIdx.x; i < GM * (GN / VEC); i += GEMM_THREADS) {
    const int r = i / (GN / VEC);
    const int nv = (i % (GN / VEC)) * VEC;
    const int m = m0 + r;
    const int n = n0 + nv;
    if (m >= M || n >= N) continue;
    float f[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float v = Cs[r * C_LD + nv + j] * scale[n + j] + shift[n + j];
      f[j] = act_silu ? silu(v) : v;
    }
    const size_t dst = (size_t)m * N + n;
    if (residual != nullptr) {
      float res[VEC];
      unpack8(*reinterpret_cast<const uint4*>(residual + dst), res);
#pragma unroll
      for (int j = 0; j < VEC; ++j) f[j] = res[j] + round_bf16(f[j]);
    }
    *reinterpret_cast<uint4*>(out + dst) = pack8(f);
  }
}

// Depthwise KSxKS SAME -> affine -> silu -> bf16, plus the f32 sums of the
// stored values per (image, row band, channel).  Grid: (channel tiles of 64,
// row bands of ``rows`` rows, images).  The block stages its taps and its
// input tile (the band's rows and the halo rows, zero outside the image,
// 128 contiguous bytes a pixel) in shared memory, so each input value is
// read from device memory about once.  A thread owns 8 channels (one
// 16-byte vector) and walks every 32nd pixel of the band.
template <int KS>
__global__ void __launch_bounds__(DW_THREADS)
mbconv_dw_kernel(const __nv_bfloat16* __restrict__ y,  // (B, H, W, C)
                 const float* __restrict__ taps,       // (KS, KS, C)
                 const float* __restrict__ scale,      // (C,)
                 const float* __restrict__ shift,      // (C,)
                 __nv_bfloat16* __restrict__ out,      // (B, H, W, C)
                 float* __restrict__ sums,             // (B, bands, C)
                 int H, int W, int C, int rows) {
  constexpr int PAD = KS / 2;
  extern __shared__ __align__(16) unsigned char dw_smem[];
  float(*tap_s)[DW_CH] = reinterpret_cast<float(*)[DW_CH]>(dw_smem);  // [KS*KS][DW_CH]
  uint4* tile = reinterpret_cast<uint4*>(dw_smem + KS * KS * DW_CH * sizeof(float));
  __shared__ float part[DW_GROUPS][DW_CH];
  const int v = threadIdx.x % DW_VECS;
  const int grp = threadIdx.x / DW_VECS;
  const int c0 = blockIdx.x * DW_CH;
  const int c = c0 + v * VEC;  // this thread's first channel
  const int band = blockIdx.y;
  const int bands = gridDim.y;
  const int b = blockIdx.z;
  const int h0 = band * rows;
  const int h1 = min(H, h0 + rows);
  const size_t img = (size_t)b * H * W;

  for (int i = threadIdx.x; i < KS * KS * DW_CH; i += DW_THREADS) {
    const int t = i / DW_CH;
    const int cc = i % DW_CH;
    tap_s[t][cc] = c0 + cc < C ? taps[(size_t)t * C + c0 + cc] : 0.0f;
  }
  // Tile row r holds image row h0 - PAD + r; W pixels of DW_VECS vectors.
  const int tile_rows = h1 - h0 + 2 * PAD;
  for (int i = threadIdx.x; i < tile_rows * W * DW_VECS; i += DW_THREADS) {
    const int vv = i % DW_VECS;
    const int pix = i / DW_VECS;
    const int hh = h0 - PAD + pix / W;
    const int cc = c0 + vv * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (hh >= 0 && hh < H && cc < C)
      val = *reinterpret_cast<const uint4*>(y + (img + (size_t)hh * W + pix % W) * C + cc);
    tile[i] = val;
  }
  __syncthreads();

  float total[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) total[j] = 0.0f;
  if (c < C) {
    float s[VEC], sh[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      s[j] = scale[c + j];
      sh[j] = shift[c + j];
    }
    for (int p = h0 * W + grp; p < h1 * W; p += DW_GROUPS) {
      const int r = p / W - h0;  // output row within the band
      const int x = p % W;
      float acc[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] = 0.0f;
#pragma unroll
      for (int i = 0; i < KS; ++i) {
#pragma unroll
        for (int k = 0; k < KS; ++k) {
          const int ww = x + k - PAD;
          if (ww < 0 || ww >= W) continue;
          float f[VEC];
          unpack8(tile[((r + i) * W + ww) * DW_VECS + v], f);
          const float4* t = reinterpret_cast<const float4*>(&tap_s[i * KS + k][v * VEC]);
          const float4 t0 = t[0];
          const float4 t1 = t[1];
          acc[0] += f[0] * t0.x;
          acc[1] += f[1] * t0.y;
          acc[2] += f[2] * t0.z;
          acc[3] += f[3] * t0.w;
          acc[4] += f[4] * t1.x;
          acc[5] += f[5] * t1.y;
          acc[6] += f[6] * t1.z;
          acc[7] += f[7] * t1.w;
        }
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] = silu(acc[j] * s[j] + sh[j]);
      const uint4 o = pack8(acc);
      *reinterpret_cast<uint4*>(out + (img + p) * C + c) = o;
      unpack8(o, acc);  // the stored (bf16-rounded) values
#pragma unroll
      for (int j = 0; j < VEC; ++j) total[j] += acc[j];
    }
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j) part[grp][v * VEC + j] = total[j];
  __syncthreads();
  for (int cc = threadIdx.x; cc < DW_CH; cc += DW_THREADS) {
    if (c0 + cc >= C) continue;
    float t = 0.0f;
    for (int g = 0; g < DW_GROUPS; ++g) t += part[g][cc];
    sums[((size_t)b * bands + band) * C + c0 + cc] = t;
  }
}

// Dynamic shared memory of a depthwise block with ``rows`` output rows.
int dw_smem_bytes(int k, int rows, int W) {
  return k * k * DW_CH * (int)sizeof(float) + (rows + k - 1) * W * DW_VECS * (int)sizeof(uint4);
}

// Rows per depthwise band: enough bands for ~4 blocks per SM, and no more
// rows than let a band's input tile fit DW_MAX_SMEM (0: not even one row).
int dw_rows(int B, int H, int W, int C, int k, int sms) {
  const int tiles = (C + DW_CH - 1) / DW_CH;
  const int bands = min(H, max(1, (4 * sms + B * tiles - 1) / (B * tiles)));
  int rows = (H + bands - 1) / bands;
  while (rows > 0 && dw_smem_bytes(k, rows, W) > DW_MAX_SMEM) --rows;
  return rows;
}

template <int KS>
int launch_dw(const __nv_bfloat16* y, const float* taps, const float* scale, const float* shift,
              __nv_bfloat16* out, float* sums, int B, int H, int W, int C, int rows,
              cudaStream_t st) {
  const int smem = dw_smem_bytes(KS, rows, W);
  cudaError_t err = cudaFuncSetAttribute(mbconv_dw_kernel<KS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((C + DW_CH - 1) / DW_CH, (H + rows - 1) / rows, B);
  mbconv_dw_kernel<KS><<<grid, DW_THREADS, smem, st>>>(y, taps, scale, shift, out, sums, H, W, C,
                                                       rows);
  return (int)cudaGetLastError();
}

// Squeeze-excite gate of one image: mean over the bands' sums -> bf16 ->
// (C, S) GEMM + bias -> silu -> bf16 -> (S, C) GEMM + bias -> sigmoid.
__global__ void __launch_bounds__(SE_THREADS)
mbconv_se_kernel(const float* __restrict__ sums,           // (B, bands, C)
                 const __nv_bfloat16* __restrict__ rw,     // (C, S)
                 const float* __restrict__ rb,             // (S,)
                 const __nv_bfloat16* __restrict__ ew,     // (S, C)
                 const float* __restrict__ eb,             // (C,)
                 float* __restrict__ gate,                 // (B, C)
                 int C, int S, int bands, int hw) {
  extern __shared__ float se_smem[];  // C means, S reduce outputs, SE_THREADS partials
  float* mean = se_smem;
  float* r = se_smem + C;
  float* part = r + S;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;

  for (int c = tid; c < C; c += SE_THREADS) {
    float t = 0.0f;
    for (int k = 0; k < bands; ++k) t += sums[((size_t)b * bands + k) * C + c];
    mean[c] = round_bf16(t / (float)hw);
  }
  __syncthreads();
  // Reduce: thread (j, s) sums every chunks-th channel from j for output s,
  // so neighbouring threads read neighbouring weights; then the partials
  // are summed in chunk order (deterministic).  The weight loops are
  // unrolled so that several loads are in flight: one block per image
  // leaves most SMs idle, so each thread's load latency is the time.
  for (int s0 = 0; s0 < S; s0 += SE_THREADS) {
    const int width = min(S - s0, SE_THREADS);
    const int chunks = SE_THREADS / width;
    const int j = tid / width;
    const int s = tid % width;
    if (j < chunks) {
      float acc = 0.0f;
#pragma unroll 8
      for (int c = j; c < C; c += chunks)
        acc += mean[c] * __bfloat162float(rw[(size_t)c * S + s0 + s]);
      part[j * width + s] = acc;
    }
    __syncthreads();
    if (tid < width) {
      float t = 0.0f;
      for (int q = 0; q < chunks; ++q) t += part[q * width + tid];
      r[s0 + tid] = round_bf16(silu(t + rb[s0 + tid]));
    }
    __syncthreads();
  }
  // Expand: one thread per channel.
  for (int c = tid; c < C; c += SE_THREADS) {
    float acc = 0.0f;
#pragma unroll 8
    for (int s = 0; s < S; ++s) acc += r[s] * __bfloat162float(ew[(size_t)s * C + c]);
    gate[(size_t)b * C + c] = sigmoid(acc + eb[c]);
  }
}

int launched() { return (int)cudaGetLastError(); }

}  // namespace

// Plain C interface, bound with ctypes (ops/_build.py).  Pointers are device
// pointers from tensor.data_ptr(): the block input x, the weights in the
// order of weights.mbconv_block_weights, the scratch tensors the wrapper
// allocates (y_exp and y_dw (B,H,W,C_mid) bf16, sums (B,H,C_mid) f32, gate
// (B,C_mid) f32) and the output; ``sms`` is the card's SM count and
// ``stream`` a cudaStream_t.  Four launches on that stream; returns the
// first launch's cudaError_t that is not 0 (a refused launch never runs),
// else 0.
extern "C" int kdlt_mbconv_block(
    const void* x, const void* expand_w, const void* expand_s, const void* expand_b,
    const void* dw, const void* dw_s, const void* dw_b, const void* se_r_w, const void* se_r_b,
    const void* se_e_w, const void* se_e_b, const void* proj_w, const void* proj_s,
    const void* proj_b, void* y_exp, void* y_dw, void* sums, void* gate, void* out, int B, int H,
    int W, int C_in, int C_mid, int C_out, int S, int k, int sms, int residual, void* stream) {
  const int M = B * H * W;
  const int se_smem = (C_mid + S + SE_THREADS) * (int)sizeof(float);
  if (M <= 0 || S <= 0 || sms <= 0 || C_in <= 0 || C_mid <= 0 || C_out <= 0 || C_in % VEC ||
      C_mid % VEC || C_out % VEC || (k != 3 && k != 5) || se_smem > 48 * 1024 ||
      (residual && C_out != C_in))
    return (int)cudaErrorInvalidValue;
  const int rows = dw_rows(B, H, W, C_mid, k, sms);
  if (rows < 1) return (int)cudaErrorInvalidValue;  // one row's tile is too wide
  const int bands = (H + rows - 1) / rows;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  const bf* xb = static_cast<const bf*>(x);
  const auto f32 = [](const void* p) { return static_cast<const float*>(p); };
  int err;

  mbconv_gemm_kernel<<<dim3((M + GM - 1) / GM, (C_mid + GN - 1) / GN), GEMM_THREADS, 0, st>>>(
      xb, nullptr, static_cast<const bf*>(expand_w), f32(expand_s), f32(expand_b), nullptr,
      static_cast<bf*>(y_exp), M, H * W, C_in, C_mid, 1);
  if ((err = launched())) return err;

  err = (k == 3 ? launch_dw<3> : launch_dw<5>)(
      static_cast<const bf*>(y_exp), f32(dw), f32(dw_s), f32(dw_b), static_cast<bf*>(y_dw),
      static_cast<float*>(sums), B, H, W, C_mid, rows, st);
  if (err) return err;

  mbconv_se_kernel<<<B, SE_THREADS, se_smem, st>>>(
      f32(sums), static_cast<const bf*>(se_r_w), f32(se_r_b), static_cast<const bf*>(se_e_w),
      f32(se_e_b), static_cast<float*>(gate), C_mid, S, bands, H * W);
  if ((err = launched())) return err;

  mbconv_gemm_kernel<<<dim3((M + GM - 1) / GM, (C_out + GN - 1) / GN), GEMM_THREADS, 0, st>>>(
      static_cast<const bf*>(y_dw), f32(gate), static_cast<const bf*>(proj_w), f32(proj_s),
      f32(proj_b), residual ? xb : nullptr, static_cast<bf*>(out), M, H * W, C_mid, C_out, 0);
  return launched();
}
