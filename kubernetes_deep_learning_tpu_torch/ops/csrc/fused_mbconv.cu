// Fused MBConv block kernels for Hopper (sm_90a): EfficientNet's stride-1
// inverted residual, 1x1 expand -> BN -> silu -> kxk SAME depthwise -> BN ->
// silu -> squeeze-excite gate -> 1x1 project -> BN (-> + residual).
//
// Replaces the TPU kernel kubernetes_deep_learning_tpu/ops/fused_mbconv.py::
// fused_mbconv_block_t (pallas_call at :244).  The Python wrapper is
// ../fused_mbconv.py; its plain PyTorch version, mbconv_block_reference,
// defines the arithmetic reproduced here rounding point for rounding point:
//   expand GEMM on bf16 operands with f32 sums -> affine -> silu (f32) -> bf16;
//   depthwise f32 taps over bf16 (SAME zero padding of the expanded
//   activation) -> affine -> silu -> bf16;
//   f32 mean of those bf16 values -> bf16 -> reduce GEMM + bias -> silu ->
//   bf16 -> expand GEMM + bias -> sigmoid: the gate g (f32);
//   bf16(f32(y) * g) -> project GEMM (f32 sums) -> affine -> bf16 (-> + x in bf16).
// Exponentials use expf (full precision), not __expf; the divisions of
// silu and sigmoid are __fdividef's (2 ulp of f32, under the bf16 rounding
// that follows).  No float atomics and no racing sums: two calls on the
// same input give the same bits.
//
// What bounds it on the card: at B3's shapes (batch 16) the f32 depthwise
// taps on the CUDA cores (k*k FMAs per expanded element, 67 TFLOP/s) take
// longer than the bf16 GEMMs at tensor-core rate and than moving the block's
// input and output once; each call's bound is 2-7 us.  The gate needs the
// spatial mean of the whole image before the projection can start, and an
// image's expanded activation (38*38*288 bf16 at B3's largest fused stage,
// ~830 KB) does not fit 227 KB of shared memory, so a block is three
// launches:
//   1. expand + depthwise (mbconv_expand_dw_kernel).  A block owns one image,
//      a band of `rows` output rows and a tile of 64 expanded channels.  Its
//      producer warp streams, by TMA through a ring of 2-3 stages under
//      mbarriers, the band's input rows with the depthwise halo, [h0 - p,
//      h1 + p) clipped to the image, as 64-pixel x 64-channel boxes (a 2-D
//      map over x as (B*H*W, C_in), 128-byte swizzle, zero fill past C_in:
//      C_in = 48 or 136 fills the rest of the k16 step) two tiles at a time,
//      with the matching 64 x 64 box of expand_w (MN-major B, read through
//      wgmma's transpose bit).  Two warpgroups run wgmma m64n64k16, one on
//      each tile of a pair; the epilogue writes affine + silu, rounded to
//      bf16, into an expanded tile E in shared memory, (rows + 2p) x
//      (strips * L + k - 1) pixels of 144 bytes (64 channels and 16 bytes of
//      padding).  E's pixels outside the image are zero: the padding is of
//      the expanded activation, and the expand of a zero row would be
//      silu(expand_b), not 0.  Then a warp takes a strip of L output pixels
//      of one row (L = 5 or 8, whichever wastes less of W); a lane owns two
//      adjacent channels (bf16x2: a warp reads one pixel's 128 bytes, no
//      bank conflict) and holds their k*k taps in registers; it reads each E
//      row of the window once, k + L - 1 loads a tap row for L outputs, where
//      a pixel-by-pixel walk reads k*k.  Affine + silu, bf16, stored to y_dw;
//      the stored values summed per lane, then over the warps in a fixed
//      order, into the (image, band, channel) sums.  The halo rows' expand is
//      recomputed in every band: (rows + 2p) / rows of the expand GEMM and its
//      epilogue (17/13 at 38x38, k = 5; none where a band is the whole image).
//   2. squeeze-excite (mbconv_se_kernel): a cluster of up to 8 blocks an
//      image, each on a chunk of channels, so the card holds B x 8 blocks
//      where one block an image left it idle.  Bulk copies bring the chunk's
//      reduce and expand weights while its means are taken; each block's part
//      of the reduce is added to the others' in rank order through
//      distributed shared memory, then it computes its chunk of the gate.
//   3. gated projection (mbconv_proj_kernel).  A block owns 64 pixels and 64
//      output channels.  One producer thread streams y_dw's 64-channel chunks
//      and proj_w's 64 x 64 boxes by TMA, and the chunk's gate values of the
//      tile's images by bulk copies, through a ring of up to 4 stages under
//      mbarriers; 1, 2 or 4 consumer warpgroups split the chunks (their sums
//      added in order at the end); each gates its chunk in place (a row's
//      image is m / hw: a 64-row tile straddles images at 10x10), rounding
//      to bf16, then runs wgmma m64n64k16; the epilogue from registers:
//      affine, bf16, + x in bf16.
// The grids are shaped by waves: launch 1's band height minimises waves x a
// per-block instruction and latency model; launch 3's split minimises waves
// x the longer of a warpgroup's chain of chunks and the SM's throughput.
// Shared memory of launch 1: the ring (24 KB a stage) and E; the rows
// shrink until it fits, and two blocks share an SM where E allows.
//
// Widths must be multiples of 8 and every pointer 16-byte aligned (16-byte
// vectors, TMA strides); the launcher refuses anything else.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <algorithm>
#include <initializer_list>

#include "hopper.cuh"  // mbarriers, TMA, wgmma descriptors and fences, the map encoder

namespace {

using bf16 = __nv_bfloat16;

constexpr int CT = 64;                    // expanded channels per launch-1 block: one wgmma N
constexpr int BOX_BYTES = 64 * 128;       // a 64 x 64 bf16 TMA box: 64 rows of 128 B
constexpr int XD_CONSUMERS = 256;         // launch 1: two warpgroups, GEMM then depthwise
constexpr int XD_THREADS = XD_CONSUMERS + 32;  // and one producer warp
constexpr int XD_STAGE = 3 * BOX_BYTES;   // two band tiles of x and a chunk of expand_w
constexpr int XD_MAX_STAGES = 3;
// Bytes of an E pixel: 64 bf16 channels and 16 bytes of padding, so that the
// epilogue's eight rows a warp writes land in eight bank groups, while the
// depthwise's warp reads one pixel's 128 contiguous bytes.
constexpr int E_PIXEL = 144;
constexpr int XD_WARPS = XD_CONSUMERS / 32;
constexpr int SE_THREADS = 512;
constexpr int SE_SLICES = 16;             // launch 2: slices of S in a channel's expand sum
constexpr int PJ_STAGES = 4;              // launch 3's ring depth at most
constexpr int ALIGN = 1024;               // a swizzle atom (8 rows x 128 B)
constexpr int SMEM_LIMIT = 232448;        // 227 KB: the most one block may use
constexpr int SM_SMEM = 233472;           // 228 KB on an SM, 1 KB of it reserved a block

// expf is the full-precision exponential; the division is __fdividef's
// (within 2 ulp of f32's, far under the bf16 rounding that follows), for
// the IEEE division's ~10 instructions an element weighed on the epilogues.
__device__ __forceinline__ float silu(float v) { return __fdividef(v, 1.0f + expf(-v)); }
__device__ __forceinline__ float sigmoid(float v) { return __fdividef(1.0f, 1.0f + expf(-v)); }
__host__ __device__ __forceinline__ int ceil_div(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}
// v * s + b with the product and the sum rounded apart, as the plain version.
__device__ __forceinline__ float affine(float v, float s, float b) {
  return __fadd_rn(__fmul_rn(v, s), b);
}

// The named barrier of launch 1's consumer warps (the producer warp has left).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(XD_CONSUMERS) : "memory");
}

struct XdParams {
  const float* expand_s;  // (C_mid,)
  const float* expand_b;
  const float* taps;      // (k, k, C_mid)
  const float* dw_s;
  const float* dw_b;
  bf16* y_dw;             // (B, H, W, C_mid)
  float* sums;            // (B, bands, C_mid)
  int H, W, C_mid;
  int rows, bands;        // output rows per band, bands per image
  int k_chunks;           // ceil(C_in / 64)
  int stages;             // ring depth, 2..3
  int strips, ec;         // output strips of L per row; E's pixels per row
};

// Launch 1: expand GEMM of the band's input rows into E (shared memory),
// then the depthwise from E into y_dw and the band's channel sums.  Grid:
// (channel tiles, bands, images).  The GEMM walks the band's 64-pixel input
// tiles in pairs, one a warpgroup, and their K chunks: the producer warp
// streams (pair, chunk) items, two x boxes and one expand_w box each,
// through a ring of 2-3 stages by TMA, so that two blocks share an SM.
template <int KS, int L>
__global__ void __launch_bounds__(XD_THREADS, 2)
    mbconv_expand_dw_kernel(const __grid_constant__ CUtensorMap x_map,
                            const __grid_constant__ CUtensorMap ew_map, const XdParams p) {
  constexpr int PAD = KS / 2;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[XD_MAX_STAGES];
  __shared__ __align__(8) uint64_t empty_bar[XD_MAX_STAGES];
  __shared__ float part[XD_WARPS][CT];

  unsigned char* ring = smem_raw + ((ALIGN - smem_u32(smem_raw) % ALIGN) % ALIGN);
  unsigned char* es = ring + p.stages * XD_STAGE;
  const uint32_t ring_u = smem_u32(ring);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c0 = blockIdx.x * CT, band = blockIdx.y, b = blockIdx.z;
  const int h0 = band * p.rows, h1 = min(p.H, h0 + p.rows);
  const int hh0 = max(0, h0 - PAD), hh1 = min(p.H, h1 + PAD);  // input rows, in the image
  const int P = (hh1 - hh0) * p.W;                             // input pixels
  const int nt = (P + 63) / 64, pairs = (nt + 1) / 2;

  if (tid == XD_CONSUMERS) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(smem_u32(&full_bar[s]), 1);
      mbar_init(smem_u32(&empty_bar[s]), XD_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // E pixel q is image row h0 - PAD + q / ec, column q % ec - PAD: zero outside the image.
  const int e_pixels = (h1 - h0 + 2 * PAD) * p.ec;
  for (int i = tid; i < e_pixels * 8; i += XD_THREADS) {
    const int q = i / 8;
    const int hh = h0 - PAD + q / p.ec, ww = q % p.ec - PAD;
    if ((unsigned)hh >= (unsigned)p.H || (unsigned)ww >= (unsigned)p.W)
      *reinterpret_cast<uint4*>(es + q * E_PIXEL + (i % 8) * 16) = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();  // the barriers are initialised; from here the consumers sync apart

  if (tid >= XD_CONSUMERS) {  // producer warp: keep the ring full
    if (tid == XD_CONSUMERS) {
      const int pix0 = (b * p.H + hh0) * p.W;
      for (int i = 0; i < pairs * p.k_chunks; ++i) {
        const int slot = i % p.stages, pair = i / p.k_chunks, kc = i % p.k_chunks;
        if (i >= p.stages) mbar_wait(smem_u32(&empty_bar[slot]), ((i / p.stages) - 1) & 1);
        const bool two = 2 * pair + 1 < nt;
        const uint32_t bar = smem_u32(&full_bar[slot]), dst = ring_u + slot * XD_STAGE;
        mbar_expect_tx(bar, (two ? 3 : 2) * BOX_BYTES);
        tma_load(dst + 2 * BOX_BYTES, &ew_map, c0, kc * 64, bar);
        tma_load(dst, &x_map, kc * 64, pix0 + 2 * pair * 64, bar);
        if (two) tma_load(dst + BOX_BYTES, &x_map, kc * 64, pix0 + (2 * pair + 1) * 64, bar);
      }
    }
    return;
  }

  // --- expand: warpgroup g takes tile 2 * pair + g of every pair ---
  // (g through a shuffle: ptxas then knows it is warp-uniform and does not
  // serialise the wgmma; every branch below it is structured and the warp
  // meets again before the next wgmma.)
  const int g = __shfl_sync(0xffffffffu, tid / 128, 0), wl = (tid % 128) / 32;
  // The expand affine of this thread's 16 channels, loaded once a block.
  float2 ex_s[8], ex_b[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = c0 + 8 * j + 2 * (lane % 4);
    const bool in = n < p.C_mid;
    ex_s[j] = in ? __ldg(reinterpret_cast<const float2*>(p.expand_s + n)) : make_float2(0.f, 0.f);
    ex_b[j] = in ? __ldg(reinterpret_cast<const float2*>(p.expand_b + n)) : make_float2(0.f, 0.f);
  }
  for (int pair = 0, i = 0; pair < pairs; ++pair) {
    const int t = 2 * pair + g;
    float acc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = 0.0f;
    fence_acc(acc);
    for (int kc = 0; kc < p.k_chunks; ++kc, ++i) {
      const int slot = i % p.stages;
      mbar_wait(smem_u32(&full_bar[slot]), (i / p.stages) & 1);
      if (t < nt) {
        wgmma_fence();
        const uint32_t a = ring_u + slot * XD_STAGE + g * BOX_BYTES;
        const uint32_t w = ring_u + slot * XD_STAGE + 2 * BOX_BYTES;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          // A: 64 pixels of 128 B, 8-row groups 1024 B apart, k16 = 32 B along the row.
          // B: 64 K rows of 128 B (64 channels); k16 = 16 rows; MN-major.
          wgmma_m64n64k16(acc, smem_desc(a + k * 32, 16, 1024),
                          smem_desc(w + k * 2048, BOX_BYTES, 1024));
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(acc);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_u32(&empty_bar[slot]));
    }
    // acc[4j + 2h + e]: input pixel t * 64 + wl * 16 + lane / 4 + 8h, channel
    // c0 + 8j + 2 * (lane % 4) + e.
    if (t < nt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int pp = t * 64 + wl * 16 + lane / 4 + 8 * h;
        if (pp < P) {
          const int q = (hh0 + pp / p.W - h0 + PAD) * p.ec + pp % p.W + PAD;
          unsigned char* dst = es + q * E_PIXEL + (lane % 4) * 4;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int n = c0 + 8 * j + 2 * (lane % 4);
            __nv_bfloat162 v = __floats2bfloat162_rn(0.0f, 0.0f);
            if (n < p.C_mid)
              v = __floats2bfloat162_rn(silu(affine(acc[4 * j + 2 * h], ex_s[j].x, ex_b[j].x)),
                                        silu(affine(acc[4 * j + 2 * h + 1], ex_s[j].y, ex_b[j].y)));
            *reinterpret_cast<__nv_bfloat162*>(dst + j * 16) = v;
          }
        }
      }
    }
    __syncwarp();
  }
  consumers_sync();  // E is complete

  // --- depthwise: a warp takes (row, strip) items; a lane two channels ---
  const int c = c0 + 2 * lane;
  const bool live = c < p.C_mid;
  float2 tap[KS * KS];
#pragma unroll
  for (int i = 0; i < KS * KS; ++i)
    tap[i] = live ? __ldg(reinterpret_cast<const float2*>(p.taps + (size_t)i * p.C_mid + c))
                  : make_float2(0.0f, 0.0f);
  const float2 zero2 = make_float2(0.0f, 0.0f);
  const float2 sc = live ? __ldg(reinterpret_cast<const float2*>(p.dw_s + c)) : zero2;
  const float2 sh = live ? __ldg(reinterpret_cast<const float2*>(p.dw_b + c)) : zero2;
  float2 total = make_float2(0.0f, 0.0f);
  const int items = (h1 - h0) * p.strips;
  for (int it = warp; it < items; it += XD_WARPS) {
    const int r = it / p.strips, x0 = (it % p.strips) * L;
    float2 acc[L];
#pragma unroll
    for (int o = 0; o < L; ++o) acc[o] = make_float2(0.0f, 0.0f);
    // Tap order (i, then bb) as the plain version sums them.
#pragma unroll
    for (int i = 0; i < KS; ++i) {
      const unsigned char* src = es + ((r + i) * p.ec + x0) * E_PIXEL + lane * 4;
#pragma unroll
      for (int j = 0; j < L + KS - 1; ++j) {
        const float2 v =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(src + j * E_PIXEL));
#pragma unroll
        for (int bb = 0; bb < KS; ++bb) {
          const int o = j - bb;
          if (o >= 0 && o < L) {
            acc[o].x = fmaf(v.x, tap[i * KS + bb].x, acc[o].x);
            acc[o].y = fmaf(v.y, tap[i * KS + bb].y, acc[o].y);
          }
        }
      }
    }
    if (live) {
      bf16* row = p.y_dw + ((size_t)(b * p.H + h0 + r) * p.W) * p.C_mid + c;
#pragma unroll
      for (int o = 0; o < L; ++o) {
        if (x0 + o >= p.W) break;
        const __nv_bfloat162 out = __floats2bfloat162_rn(silu(affine(acc[o].x, sc.x, sh.x)),
                                                         silu(affine(acc[o].y, sc.y, sh.y)));
        *reinterpret_cast<__nv_bfloat162*>(row + (size_t)(x0 + o) * p.C_mid) = out;
        const float2 f = __bfloat1622float2(out);  // the stored values
        total.x += f.x;
        total.y += f.y;
      }
    }
  }
  part[warp][2 * lane] = total.x;
  part[warp][2 * lane + 1] = total.y;
  consumers_sync();
  if (tid < CT && c0 + tid < p.C_mid) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < XD_WARPS; ++w) s += part[w][tid];
    p.sums[((size_t)b * p.bands + band) * p.C_mid + c0 + tid] = s;
  }
}

// One contiguous copy of `bytes` (a multiple of 16) from device memory into
// this block's shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Launch 2: the squeeze-excite gate of image blockIdx.y, as a cluster of
// gridDim.x blocks; block (rank) q owns channels [q * chunk, +chunk).  Its
// rows of the reduce weights and columns of the expand weights come into
// shared memory by bulk copies while it takes the means of its channels
// (band sums added in band order, / hw, rounded to bf16).  Then its part of
// the reduce GEMM (warp w over its share of the channels, lanes over the S
// outputs, the warps added in order); the cluster's parts are added in rank
// order through distributed shared memory, so every block holds the same
// reduce output r = bf16(silu(. + rb)); then its channels of the expand
// GEMM + bias -> sigmoid, each thread on 8 channels of a slice of S, the
// slices added in order.
__global__ void __launch_bounds__(SE_THREADS)
    mbconv_se_kernel(const float* __restrict__ sums,  // (B, bands, C)
                     const bf16* __restrict__ rw,     // (C, S)
                     const float* __restrict__ rb,    // (S,)
                     const bf16* __restrict__ ew,     // (S, C)
                     const float* __restrict__ eb,    // (C,)
                     float* __restrict__ gate,        // (B, C)
                     int C, int S, int bands, int hw, int chunk) {
  constexpr int WARPS = SE_THREADS / 32;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), ranks = (int)cluster.num_blocks();
  const int b = blockIdx.y, tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c0 = rank * chunk, n = min(C, c0 + chunk) - c0;  // this block's channels
  const int groups = n / 8, slices = min(min(S, SE_SLICES), max(1, SE_THREADS / groups));
  extern __shared__ __align__(16) unsigned char se_raw[];
  __shared__ __align__(8) uint64_t wbar;
  bf16* rw_s = reinterpret_cast<bf16*>(se_raw);    // n x S
  bf16* ew_s = rw_s + chunk * S;                   // S x chunk
  float* mean = reinterpret_cast<float*>(ew_s + S * chunk);  // n
  float* part = mean + chunk;                      // S: this block's part of the reduce
  float* r = part + S;                             // S
  float* wpart = r + S;                            // WARPS x S, then SE_SLICES x chunk
  float* epart = wpart;

  if (tid == 0) {
    const uint32_t bar = smem_u32(&wbar);
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect_tx(bar, 4 * n * S);
    bulk_load(smem_u32(rw_s), rw + (size_t)c0 * S, 2 * n * S, bar);
    for (int s = 0; s < S; ++s)
      bulk_load(smem_u32(ew_s + s * chunk), ew + (size_t)s * C + c0, 2 * n, bar);
  }
  const float* s_img = sums + (size_t)b * bands * C + c0;
  for (int c = tid; c < n; c += SE_THREADS) {
    float t = 0.0f;
#pragma unroll 4
    for (int k = 0; k < bands; ++k) t += s_img[(size_t)k * C + c];
    mean[c] = round_bf16(t / (float)hw);
  }
  __syncthreads();  // the means, and the barrier's initialisation
  mbar_wait(smem_u32(&wbar), 0);
  const int per = (n + WARPS - 1) / WARPS, cb = min(n, warp * per), ce = min(n, cb + per);
  for (int s0 = 0; s0 < S; s0 += 32) {
    const int s = s0 + lane;
    if (s < S) {
      float acc = 0.0f;
#pragma unroll 8
      for (int c = cb; c < ce; ++c) acc += mean[c] * __bfloat162float(rw_s[c * S + s]);
      wpart[warp * S + s] = acc;
    }
  }
  __syncthreads();
  for (int s = tid; s < S; s += SE_THREADS) {
    float t = 0.0f;
    for (int w = 0; w < WARPS; ++w) t += wpart[w * S + s];
    part[s] = t;
  }
  cluster.sync();  // every block's part is written
  for (int s = tid; s < S; s += SE_THREADS) {
    float t = 0.0f;
    for (int q = 0; q < ranks; ++q) t += cluster.map_shared_rank(part, q)[s];
    r[s] = round_bf16(silu(t + rb[s]));
  }
  cluster.sync();  // r is complete, and no block reads another's part any more
  // Expand: thread (group, slice) sums 8 channels over s = slice, slice + slices, ...
  const int grp = tid % groups, slice = tid / groups;
  if (slice < slices) {
    float acc[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int s = slice; s < S; s += slices) {
      const uint4 u = *reinterpret_cast<const uint4*>(ew_s + s * chunk + 8 * grp);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
      const float rs = r[s];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(h[e]);
        acc[2 * e] += rs * f.x;
        acc[2 * e + 1] += rs * f.y;
      }
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) epart[slice * chunk + 8 * grp + e] = acc[e];
  }
  __syncthreads();
  for (int c = tid; c < n; c += SE_THREADS) {
    float t = 0.0f;
    for (int q = 0; q < slices; ++q) t += epart[q * chunk + c];
    gate[(size_t)b * C + c0 + c] = sigmoid(t + eb[c0 + c]);
  }
}

// Launch 2's cluster: G blocks an image (at most 8, the portable cluster
// size), each on a chunk of channels that is a multiple of 8; and its
// dynamic shared memory.
struct SePlan {
  int ranks, chunk, smem;
};

SePlan plan_se(int C, int S) {
  SePlan p;
  const int g = std::min(8, ceil_div(C, 128));
  p.chunk = ceil_div(ceil_div(C, g), 8) * 8;
  p.ranks = ceil_div(C, p.chunk);
  const int floats = p.chunk + 2 * S + std::max((SE_THREADS / 32) * S, SE_SLICES * p.chunk);
  p.smem = 4 * p.chunk * S + 4 * floats;  // the two weight slices (bf16), then the f32 work
  return p;
}

struct PjParams {
  const float* gate;      // (B, C_mid)
  const float* scale;     // (C_out,)
  const float* shift;     // (C_out,)
  const bf16* residual;   // (M, C_out) or null
  bf16* out;              // (M, C_out)
  int M, hw, C_mid, C_out;
  int k_chunks;           // ceil(C_mid / 64)
  int stages;             // ring depth
  int stage_bytes;        // y_dw's box, proj_w's box, the gate rows of the tile's images
};

// Launch 3: out[m, n] = bf16(affine(sum_k bf16(y_dw[m, k] * gate[m / hw, k])
// * proj_w[k, n])) (+ residual in bf16).  Grid: (64-pixel tiles, 64-channel
// output tiles).  KSPLIT consumer warpgroups split the K chunks round-robin
// (chunk i to warpgroup i % KSPLIT) and their sums are added in warpgroup
// order at the end, so the order is fixed.  A stage holds y_dw's chunk (64
// pixels x 64 channels, K-major A) and proj_w's box (64 K x 64 N, MN-major
// B), 128-byte swizzled by TMA, and the chunk's 64 gate values of every
// image the tile's rows touch (a 64-row tile straddles images at 10x10), by
// bulk copies; one producer thread keeps the ring full.  The warpgroup
// gates its chunk in place from those before its wgmma reads it.
template <int KSPLIT>
__global__ void __launch_bounds__(KSPLIT * 128 + 32, 1)
    mbconv_proj_kernel(const __grid_constant__ CUtensorMap y_map,
                       const __grid_constant__ CUtensorMap pw_map, const PjParams p) {
  constexpr int CONSUMERS = KSPLIT * 128;
  constexpr int VECS = 64 * 8 / 128;  // 16-byte vectors a consumer gates per chunk
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[PJ_STAGES];
  __shared__ __align__(8) uint64_t empty_bar[PJ_STAGES];

  unsigned char* ring = smem_raw + ((ALIGN - smem_u32(smem_raw) % ALIGN) % ALIGN);
  const uint32_t ring_u = smem_u32(ring);
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * 64, n0 = blockIdx.y * 64;
  const int img0 = m0 / p.hw, imgs = (min(p.M, m0 + 64) - 1) / p.hw - img0 + 1;
  const int stage_bytes = p.stage_bytes;

  if (tid == CONSUMERS) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(smem_u32(&full_bar[s]), 1);
      mbar_init(smem_u32(&empty_bar[s]), 4);  // the four warps of the chunk's warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {  // producer warp: keep the ring full
    if (tid == CONSUMERS) {
      for (int i = 0; i < p.k_chunks; ++i) {
        const int slot = i % p.stages;
        if (i >= p.stages) mbar_wait(smem_u32(&empty_bar[slot]), ((i / p.stages) - 1) & 1);
        const uint32_t bar = smem_u32(&full_bar[slot]), dst = ring_u + slot * stage_bytes;
        const int gate_bytes = 4 * min(64, p.C_mid - i * 64);
        mbar_expect_tx(bar, 2 * BOX_BYTES + imgs * gate_bytes);
        tma_load(dst, &y_map, i * 64, m0, bar);
        tma_load(dst + BOX_BYTES, &pw_map, n0, i * 64, bar);
        for (int j = 0; j < imgs; ++j)
          bulk_load(dst + 2 * BOX_BYTES + j * 256, p.gate + (size_t)(img0 + j) * p.C_mid + i * 64,
                    gate_bytes, bar);
      }
    }
    return;
  }

  const int g = __shfl_sync(0xffffffffu, tid / 128, 0);  // warp-uniform, as ptxas must see
  const int t = tid % 128, warp = t / 32, lane = tid % 32;
  float acc[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = 0.0f;
  fence_acc(acc);
  for (int kc = g; kc < p.k_chunks; kc += KSPLIT) {
    const int slot = kc % p.stages;
    // This thread's vectors of the chunk: 16-byte unit u = v % 8 of row
    // r = v / 8 holds channels kc * 64 + 8 * (u ^ (r % 8)).. (the 128-byte
    // swizzle).  Rows past M and channels past C_mid are TMA's zeros and
    // stay so.
    mbar_wait(smem_u32(&full_bar[slot]), (kc / p.stages) & 1);
    unsigned char* a = ring + slot * stage_bytes;
    const float* gs = reinterpret_cast<const float*>(a + 2 * BOX_BYTES);
#pragma unroll
    for (int i = 0; i < VECS; ++i) {
      const int v = t + 128 * i, r = v / 8, m = m0 + r, u8 = 8 * ((v % 8) ^ (r % 8));
      if (m < p.M && kc * 64 + u8 < p.C_mid) {
        uint4* ptr = reinterpret_cast<uint4*>(a + v * 16);
        uint4 u = *ptr;
        uint32_t* w = reinterpret_cast<uint32_t*>(&u);
        const float4 g0 = *reinterpret_cast<const float4*>(gs + (m / p.hw - img0) * 64 + u8);
        const float4 g1 = *reinterpret_cast<const float4*>(gs + (m / p.hw - img0) * 64 + u8 + 4);
        const float gv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[e]));
          const __nv_bfloat162 o =
              __floats2bfloat162_rn(__fmul_rn(f.x, gv[2 * e]), __fmul_rn(f.y, gv[2 * e + 1]));
          w[e] = *reinterpret_cast<const uint32_t*>(&o);
        }
        *ptr = u;
      }
    }
    // Generic-proxy writes before wgmma (the async proxy) reads them; the
    // warpgroup's threads have all gated their part.
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncwarp();
    asm volatile("bar.sync %0, 128;" ::"r"(1 + g) : "memory");
    wgmma_fence();
    const uint32_t a_u = ring_u + slot * stage_bytes, b_u = a_u + BOX_BYTES;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      wgmma_m64n64k16(acc, smem_desc(a_u + k * 32, 16, 1024),
                      smem_desc(b_u + k * 2048, BOX_BYTES, 1024));
    wgmma_commit();
    if (KSPLIT == 1) {
      // One group stays in flight; the one before it is done with its slot.
      wgmma_wait<1>();
      fence_acc(acc);
      if (kc > 0 && lane == 0) mbar_arrive(smem_u32(&empty_bar[(kc - 1) % p.stages]));
    } else {
      // The other warpgroups overlap this one's wait.  (Releasing the slot
      // only at the warpgroup's next chunk would deadlock a ring of KSPLIT
      // stages.)
      wgmma_wait<0>();
      fence_acc(acc);
      if (lane == 0) mbar_arrive(smem_u32(&empty_bar[slot]));
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);

  if (KSPLIT > 1) {
    // Every chunk has landed and been read: the ring takes the other
    // warpgroups' sums, which warpgroup 0 adds in warpgroup order.
    float* red = reinterpret_cast<float*>(ring);
    asm volatile("bar.sync %0, %1;" ::"r"(1 + KSPLIT), "r"(CONSUMERS) : "memory");
    if (g > 0) {
#pragma unroll
      for (int e = 0; e < 32; ++e) red[((g - 1) * 32 + e) * 128 + t] = acc[e];
    }
    asm volatile("bar.sync %0, %1;" ::"r"(1 + KSPLIT), "r"(CONSUMERS) : "memory");
    if (g > 0) return;
    for (int w = 0; w < KSPLIT - 1; ++w)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[e] += red[(w * 32 + e) * 128 + t];
  }

  // Epilogue from the registers: acc[4j + 2h + e] is row row0 + 8h, column
  // n0 + 8j + 2 * (lane % 4) + e.
  const int row0 = m0 + warp * 16 + lane / 4;
  const int n_base = n0 + 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = n_base + 8 * j;
    if (n < p.C_out) {  // C_out % 8 == 0: n + 1 is in range with n
      const float2 sc = __ldg(reinterpret_cast<const float2*>(p.scale + n));
      const float2 sh = __ldg(reinterpret_cast<const float2*>(p.shift + n));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = row0 + 8 * h;
        if (m < p.M) {
          __nv_bfloat162 o = __floats2bfloat162_rn(affine(acc[4 * j + 2 * h], sc.x, sh.x),
                                                   affine(acc[4 * j + 2 * h + 1], sc.y, sh.y));
          const size_t dst = (size_t)m * p.C_out + n;
          if (p.residual != nullptr) {
            const float2 r =
                __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p.residual + dst));
            const float2 f = __bfloat1622float2(o);
            o = __floats2bfloat162_rn(r.x + f.x, r.y + f.y);
          }
          *reinterpret_cast<__nv_bfloat162*>(p.out + dst) = o;
        }
      }
    }
  }
}

// Blocks of `threads` threads at `regs` registers each that one SM's
// register file holds (registers are allocated per warp in units of 256).
int blocks_by_registers(int regs, int threads) {
  if (regs <= 0) return 0;
  const int per_warp = (regs * 32 + 255) / 256 * 256;
  return 65536 / (per_warp * ((threads + 31) / 32));
}

int registers_of(const void* kernel) {
  cudaFuncAttributes attr;
  return cudaFuncGetAttributes(&attr, kernel) == cudaSuccess ? attr.numRegs : 0;
}

// Output pixels per depthwise strip: 8, or 5 where that wastes less of a
// row (W = 10 and 19 at B3's 10x10 and 19x19 stages).
int strip_len(int W) { return ceil_div(W, 8) * 8 - W <= ceil_div(W, 5) * 5 - W ? 8 : 5; }

struct XdPlan {
  int rows, stages, strips, ec, smem;
};

// Launch 1's band height and ring depth.  Over every band count (rows =
// ceil(H / bands)), the least waves x the time of a wave, from a model whose
// only use is this choice: the lane instructions of a block (the expand
// epilogue, ~14 an expanded element with its silu, over the band's input
// tiles; the depthwise, 2 k^2 FMAs, ~4 a loaded E pixel and ~28 of epilogue
// an output pixel, per lane and item) run at 128 lanes a clock by the
// blocks an SM holds, plus ~4,000 clocks a wave of TMA and barrier latency.
// Three stages where they cost no block an SM, else two.
bool plan_expand_dw(XdPlan& plan, int B, int H, int W, int C_mid, int k, int sms, int by_regs) {
  const int pad = k / 2, L = strip_len(W), tiles = ceil_div(C_mid, CT);
  const int strips = ceil_div(W, L), ec = strips * L + k - 1;
  const int static_smem = 2 * XD_MAX_STAGES * 8 + XD_WARPS * CT * 4;
  const double item = 32.0 * (2.0 * k * k * L + 4.0 * k * (L + k - 1) + 28.0 * L);
  double best = -1.0;
  for (int bands = 1; bands <= H; ++bands) {
    const int rows = ceil_div(H, bands);
    if (ceil_div(H, rows) != bands) continue;  // fewer bands give the same rows
    const int nt = ceil_div(std::min(H, rows + 2 * pad) * W, 64);
    const int e_bytes = (rows + 2 * pad) * ec * E_PIXEL;
    const auto per_sm_at = [&](int stages) {
      const int smem = ALIGN + stages * XD_STAGE + e_bytes;
      if (smem + static_smem > SMEM_LIMIT) return 0;
      const int n = SM_SMEM / (smem + static_smem + 1024);
      return std::min(std::min(n, 2048 / XD_THREADS), by_regs);
    };
    const int stages = per_sm_at(XD_MAX_STAGES) >= per_sm_at(2) ? XD_MAX_STAGES : 2;
    const int per_sm = per_sm_at(stages);
    if (per_sm < 1) continue;
    const long long blocks = (long long)B * tiles * bands;
    const long long slots = (long long)sms * per_sm;
    const long long waves = (blocks + slots - 1) / slots;
    const long long held = std::min<long long>(per_sm, (blocks + sms - 1) / sms);
    const double lanes = nt * 4096.0 * 14.0 + rows * strips * item;
    const double cost = waves * (held * lanes / 128.0 + 4000.0);
    if (best < 0.0 || cost < best) {
      best = cost;
      plan = {rows, stages, strips, ec, ALIGN + stages * XD_STAGE + e_bytes};
    }
  }
  return best >= 0.0;
}

// Launch 1's instantiation for depthwise size k and strip length L, and
// its registers a thread (read once each).
const void* expand_dw_kernel(int k, int L) {
  if (k == 3) return L == 5 ? (const void*)mbconv_expand_dw_kernel<3, 5>
                            : (const void*)mbconv_expand_dw_kernel<3, 8>;
  return L == 5 ? (const void*)mbconv_expand_dw_kernel<5, 5>
                : (const void*)mbconv_expand_dw_kernel<5, 8>;
}

int expand_dw_registers(int k, int L) {
  static int regs[2][2] = {{-1, -1}, {-1, -1}};
  int& r = regs[k == 5][L == 8];
  if (r < 0) r = registers_of(expand_dw_kernel(k, L));
  return r;
}

const void* proj_kernel(int ksplit) {
  return ksplit == 1 ? (const void*)mbconv_proj_kernel<1>
                     : ksplit == 2 ? (const void*)mbconv_proj_kernel<2>
                                   : (const void*)mbconv_proj_kernel<4>;
}

// Launch 3's K split (1, 2 or 4 warpgroups on one output tile): the least
// waves x the time of a wave, which is the longer of one warpgroup's chain
// of chunks (latency: a chunk's wait, its gating and its wgmma) and the
// SM's work on every chunk of the blocks it holds (0.45 of a chunk's
// latency each: the constant that picks, at every B3 shape, the split
// that an H100 ran fastest).  Fills p.stages; returns the dynamic shared memory.
int plan_proj(PjParams& p, int sms, int* ksplit) {
  static int regs[3] = {-1, -1, -1};
  const int tiles = ceil_div(p.M, 64) * ceil_div(p.C_out, 64);
  const int static_smem = 2 * PJ_STAGES * 8;
  p.stages = std::min(PJ_STAGES, p.k_chunks);
  // The most images a 64-row tile touches, each with 64 gate values (256 B).
  const int imgs = std::min(ceil_div(p.M, p.hw), 63 / p.hw + 2);
  p.stage_bytes = 2 * BOX_BYTES + ceil_div(imgs * 256, ALIGN) * ALIGN;
  const int bytes = ALIGN + p.stages * p.stage_bytes;
  if (bytes > SMEM_LIMIT - 2 * PJ_STAGES * 8) return -1;
  double best = -1.0;
  for (int ks = 1, i = 0; ks <= std::min(PJ_STAGES, p.k_chunks); ks *= 2, ++i) {
    if (regs[i] < 0) regs[i] = registers_of(proj_kernel(ks));
    const int threads = 128 * ks + 32;
    int per_sm = std::min(SM_SMEM / (bytes + static_smem + 1024), 2048 / threads);
    per_sm = std::min(per_sm, blocks_by_registers(regs[i], threads));
    if (per_sm < 1) continue;
    const long long slots = (long long)sms * per_sm;
    const long long waves = (tiles + slots - 1) / slots;
    const long long held = std::min<long long>(per_sm, (tiles + sms - 1) / sms);
    const double wave = std::max((double)ceil_div(p.k_chunks, ks), 0.45 * held * p.k_chunks);
    const double cost = waves * wave;
    if (best < 0.0 || cost < best) {
      best = cost;
      *ksplit = ks;
    }
  }
  return best < 0.0 ? -1 : bytes;
}

}  // namespace

// Plain C interface, bound with ctypes (ops/_build.py).  Pointers are device
// pointers from tensor.data_ptr(): the block input x, the weights in the
// order of weights.mbconv_block_weights, the scratch the wrapper allocates
// (y_dw (B,H,W,C_mid) bf16, sums (B,H,C_mid) f32, gate (B,C_mid) f32) and
// the output; ``sms`` is the card's SM count, ``phases`` a mask of the
// launches to make (1 expand + depthwise, 2 squeeze-excite, 4 projection;
// 7 for the block, a part alone only to time it) and ``stream`` a
// cudaStream_t.  Returns the first launch's cudaError_t that is not 0 (a
// refused launch never runs), else 0.
extern "C" int kdlt_mbconv_block(
    const void* x, const void* expand_w, const void* expand_s, const void* expand_b,
    const void* dw, const void* dw_s, const void* dw_b, const void* se_r_w, const void* se_r_b,
    const void* se_e_w, const void* se_e_b, const void* proj_w, const void* proj_s,
    const void* proj_b, void* y_dw, void* sums, void* gate, void* out, int B, int H, int W,
    int C_in, int C_mid, int C_out, int S, int k, int sms, int residual, int phases,
    void* stream) {
  const long long M = (long long)B * H * W;
  if (M <= 0 || M > (1LL << 30) || S <= 0 || sms <= 0 || C_in <= 0 || C_mid <= 0 ||
      C_out <= 0 || C_in % 8 || C_mid % 8 || C_out % 8 ||
      (k != 3 && k != 5) || (residual && C_out != C_in))
    return (int)cudaErrorInvalidValue;
  for (const void* ptr : {x, expand_w, expand_s, expand_b, dw, dw_s, dw_b, se_r_w, se_r_b,
                          se_e_w, se_e_b, proj_w, proj_s, proj_b, (const void*)y_dw,
                          (const void*)sums, (const void*)gate, (const void*)out})
    if (ptr == nullptr || !aligned16(ptr)) return (int)cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto f32 = [](const void* p) { return static_cast<const float*>(p); };
  // One plan for launch 1, whose band count launch 2 reads back.
  const int L = strip_len(W);
  XdPlan plan;
  if (!plan_expand_dw(plan, B, H, W, C_mid, k, sms,
                      blocks_by_registers(expand_dw_registers(k, L), XD_THREADS)))
    return (int)cudaErrorInvalidValue;
  const int bands = ceil_div(H, plan.rows);  // <= H: the sums' room

  if (phases & 1) {
    XdParams xp;
    xp.expand_s = f32(expand_s);
    xp.expand_b = f32(expand_b);
    xp.taps = f32(dw);
    xp.dw_s = f32(dw_s);
    xp.dw_b = f32(dw_b);
    xp.y_dw = static_cast<bf16*>(y_dw);
    xp.sums = static_cast<float*>(sums);
    xp.H = H;
    xp.W = W;
    xp.C_mid = C_mid;
    xp.rows = plan.rows;
    xp.bands = bands;
    xp.k_chunks = ceil_div(C_in, 64);
    xp.stages = plan.stages;
    xp.strips = plan.strips;
    xp.ec = plan.ec;
    alignas(64) CUtensorMap x_map, ew_map;
    if (!encode_map(encode, &x_map, x, (int)M, C_in, 64, CU_TENSOR_MAP_SWIZZLE_128B) ||
        !encode_map(encode, &ew_map, expand_w, C_in, C_mid, 64, CU_TENSOR_MAP_SWIZZLE_128B))
      return (int)cudaErrorInvalidValue;
    const void* kernel = expand_dw_kernel(k, L);
    cudaError_t e = allow_max_dynamic_smem(kernel);
    if (e != cudaSuccess) return (int)e;
    void* args[] = {&x_map, &ew_map, &xp};
    e = cudaLaunchKernel(kernel, dim3(ceil_div(C_mid, CT), bands, B), dim3(XD_THREADS), args,
                         plan.smem, st);
    if (e != cudaSuccess) return (int)e;
  }

  if (phases & 2) {
    const SePlan se = plan_se(C_mid, S);
    if (se.smem > 227 * 1024) return (int)cudaErrorInvalidValue;
    cudaError_t e = allow_max_dynamic_smem(reinterpret_cast<const void*>(mbconv_se_kernel));
    if (e != cudaSuccess) return (int)e;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(se.ranks, B);
    cfg.blockDim = dim3(SE_THREADS);
    cfg.dynamicSmemBytes = se.smem;
    cfg.stream = st;
    cudaLaunchAttribute cluster[1];
    cluster[0].id = cudaLaunchAttributeClusterDimension;
    cluster[0].val.clusterDim.x = se.ranks;
    cluster[0].val.clusterDim.y = 1;
    cluster[0].val.clusterDim.z = 1;
    cfg.attrs = cluster;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, mbconv_se_kernel, f32(sums), static_cast<const bf16*>(se_r_w),
                           f32(se_r_b), static_cast<const bf16*>(se_e_w), f32(se_e_b),
                           static_cast<float*>(gate), C_mid, S, bands, H * W, se.chunk);
    if (e != cudaSuccess) return (int)e;
  }

  if (phases & 4) {
    PjParams pp;
    pp.gate = f32(gate);
    pp.scale = f32(proj_s);
    pp.shift = f32(proj_b);
    pp.residual = residual ? static_cast<const bf16*>(x) : nullptr;
    pp.out = static_cast<bf16*>(out);
    pp.M = (int)M;
    pp.hw = H * W;
    pp.C_mid = C_mid;
    pp.C_out = C_out;
    pp.k_chunks = ceil_div(C_mid, 64);
    int ksplit = 0;
    const int smem = plan_proj(pp, sms, &ksplit);
    if (smem < 0) return (int)cudaErrorInvalidValue;
    alignas(64) CUtensorMap y_map, pw_map;
    if (!encode_map(encode, &y_map, y_dw, (int)M, C_mid, 64, CU_TENSOR_MAP_SWIZZLE_128B) ||
        !encode_map(encode, &pw_map, proj_w, C_mid, C_out, 64, CU_TENSOR_MAP_SWIZZLE_128B))
      return (int)cudaErrorInvalidValue;
    const void* kernel = proj_kernel(ksplit);
    cudaError_t e = allow_max_dynamic_smem(kernel);
    if (e != cudaSuccess) return (int)e;
    void* args[] = {&y_map, &pw_map, &pp};
    e = cudaLaunchKernel(kernel, dim3(ceil_div((int)M, 64), ceil_div(C_out, 64)),
                         dim3(128 * ksplit + 32), args, smem, st);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}
