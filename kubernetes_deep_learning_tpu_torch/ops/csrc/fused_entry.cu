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
//   depthwise taps in f32 over bf16 inputs with f32 weights, product and
//   sum rounded apart in (dh, dw) order -> bf16 -> GEMM with bf16 operands
//   and f32 accumulation -> affine in f32 -> bf16;
//   r = bf16(f32(b[::2, ::2] @ res) * s + t);
//   out = bf16(max over the window of bf16 d + r), out-of-image taps -inf.
//
// What bounds it on the card: at batch 16 the four GEMMs are 31.2 GFLOP of
// bf16 products (conv2 12.75, pw1 5.66, pw2 11.33, res 1.44) -- 0.032 ms at
// 989 TFLOP/s -- plus 1.19 GFLOP of f32 depthwise taps (0.018 ms at 67
// TFLOP/s), against 22.7 MB in and 22.4 MB out (0.0135 ms at 3.35 TB/s):
// operations bound it, at ~0.05 ms.  b, c and d (147x147x64..128 an image)
// are ten times the input and output together; a design that writes them
// to device memory is bound by that traffic instead.
//
// The design: one launch, and b, c and d never leave the SM.
//   * Work unit: (image, a strip of P <= 29 output columns, a segment of R
//     output rows).  Every row of b, c and d a strip needs spans 64 column
//     slots, one wgmma M: slot s is b/c/d column 2 * j0 - pad_left - 2 + s;
//     b is needed at slots 0..2P+4, c at 1..2P+3, d at 2..2P+2, so each
//     stage's halo is recomputed on the strip's two edges only.
//   * A block walks its segment downward one d row at a time: sub-step k
//     computes b row k + 2 (conv2: the 64 x 9*C_in im2col panel comes
//     straight from x by cp.async with zero fill, one copy of 16 bytes a
//     thread a tap; one warpgroup runs wgmma against conv2's weights),
//     c row k + 1 (the depthwise of b's three rows into a 128-byte-swizzled
//     K-major panel, then the pw1 GEMM, two warpgroups on 64 channels each)
//     and d row k (the same over c).  b and c live in rings of three rows
//     in shared memory; d only in the accumulators, where each thread
//     keeps the running max over the pool's three rows (bf16 pairs in
//     registers).  A segment starts four sub-steps early to fill the rings
//     (5 b rows, 3 c rows of warm-up).
//   * The depthwise reads its rows and taps from shared memory: a thread
//     computes 8 channels of 2 neighbouring slots for c and of 4 for d,
//     whose taps and overlapping rows it loads once.
//   * When a pool window's third row is done, the vertical max goes to a
//     pooled row in shared memory and the thread that owns output column
//     jj takes the max of its three slots 2 + 2jj.., adds r and stores.
//     r for output row i is computed at sub-step 2i, while b row 2i is in
//     the ring: its even slots are copied into a panel and multiplied by
//     res; r waits in registers (bf16 pairs) until row i is pooled.
//   * The border masks: b and c outside the image are 0 (the depthwise's
//     SAME padding; relu of the shift would not be), d outside it -inf
//     (the pool's padding), on rows and on columns alike.
//   * All four weight matrices stay in shared memory (TMA once a block,
//     128-byte swizzle, read by wgmma as MN-major B), with the affine pairs
//     and the depthwise taps; the grid is persistent, one block an SM, and
//     the launcher picks R by the least waves x (warm-up + 2R) sub-steps.
// What holds it now: a sub-step is a chain of phases (copy, conv2, c's
// depthwise, pw1, d's depthwise, pw2, pool or residual) with a barrier
// between each, and one block of 8 warps an SM overlaps none of them; the
// f32 depthwise (a product and a sum per tap, rounded apart) takes the
// largest share.  Overlapping the phases needs room that is not left.
// Shared memory: weights 100 KB (conv2 36, pw1 16, res 16, pw2 32), b ring
// 24 KB, c ring 48 KB, one A panel of 40 KB (im2col, depthwise and
// residual panels in turn; the pooled row shares its room), affines and
// taps 11 KB: 223 KB.  Widths: C_in <= 32, C_b <= 64, C_out <= 128, each a
// multiple of 8; every pointer 16-byte aligned.  The launcher refuses
// anything else.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <initializer_list>

#include "hopper.cuh"  // mbarriers, cp.async, TMA, wgmma descriptors and fences, the map encoder

namespace {

constexpr int SLOTS = 64;               // column slots of a row: one wgmma M
constexpr int MAX_P = (SLOTS - 5) / 2;  // output columns a strip: b spans 2P + 5 slots
constexpr int THREADS = 256;            // two warpgroups
constexpr int CHUNK = SLOTS * 128;      // 64 slots x 64 channels, 128-byte swizzled: 8 KB
constexpr int BOX = 64 * 128;           // a weight box, 64 K rows x 64 N: 8 KB
constexpr int MAX_C_IN = 32, MAX_C_B = 64, MAX_C_OUT = 128;
constexpr int PANEL_CHUNKS = (9 * MAX_C_IN + 63) / 64;  // the im2col panel: 5 chunks
constexpr int WARMUP = 4;               // sub-steps before a segment's first d row
// What the warm-up costs in full sub-steps: two make b alone, two b and c
// (entry_ablation.py times the kernel at each segment length; shapes the
// grid only).
constexpr double WARMUP_COST = 1.5;
// Shared memory, the swizzled parts on 1024-byte boundaries (a swizzle atom).
constexpr int W_CONV2 = 0;                          // conv2: 288 K rows (4 boxes and a half)
constexpr int W_PW1 = W_CONV2 + 9 * MAX_C_IN * 128; // pw1: 2 N boxes
constexpr int W_RES = W_PW1 + 2 * BOX;              // res: 2 N boxes
constexpr int W_PW2 = W_RES + 2 * BOX;              // pw2: (N box, K box) pairs
constexpr int B_RING = W_PW2 + 4 * BOX;             // 3 rows of b, a chunk each
constexpr int C_RING = B_RING + 3 * CHUNK;          // 3 rows of c, two chunks each
constexpr int PANEL = C_RING + 6 * CHUNK;           // the A operand: up to 5 chunks
constexpr int POOL = PANEL + 2 * CHUNK;             // the pooled row, beside the dw2 panel
// (scale, shift) of every channel of conv2, bn1, bn2 and res, f32 pairs
constexpr int AFFINE = PANEL + PANEL_CHUNKS * CHUNK;
constexpr int TAPS = AFFINE + 4 * MAX_C_OUT * 8;     // dw1 (9 x 64) and dw2 (9 x 128), f32
constexpr int SMEM_BYTES = TAPS + 9 * (MAX_C_B + MAX_C_OUT) * 4;
constexpr int ALIGN = 1024;
enum Affine { AFF_CONV2 = 0, AFF_BN1 = 1, AFF_BN2 = 2, AFF_RES = 3 };

static_assert(W_PW1 % ALIGN == 0, "conv2 ends on a swizzle atom");
static_assert(SMEM_BYTES + ALIGN <= 232448, "one block's shared memory");
static_assert(POOL + 2 * CHUNK <= AFFINE, "the pooled row fits in the panel's room");
static_assert(SLOTS / 2 * 8 == THREADS, "depthwise: one item a thread");

struct Params {
  const __nv_bfloat16* x;  // (B, H, W, C_in)
  const float *conv2_s, *conv2_b, *res_s, *res_b, *dw1, *bn1_s, *bn1_b, *dw2, *bn2_s, *bn2_b;
  __nv_bfloat16* out;      // (B, Ho, Wo, C_out)
  int H, W, C_in, C_b, C_out;
  int Hb, Wb, Ho, Wo, pad_top, pad_left;
  int P, strips, R, segments, units;
};

// Byte offset of 16-byte unit `u` of slot `s` in a 128-byte-swizzled chunk.
__device__ __forceinline__ int swz(int s, int u) { return s * 128 + ((u ^ (s & 7)) << 4); }

__device__ __forceinline__ int ring3(int r) { return ((r % 3) + 3) % 3; }

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t max2(uint32_t a, uint32_t b) {
  const __nv_bfloat162 m = __hmax2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                   *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&m);
}

__device__ __forceinline__ float affine(float v, float s, float t) {
  return __fadd_rn(__fmul_rn(v, s), t);  // rounded apart, as the reference computes it
}

// Scale and shift of channels n, n + 1 (n even) of affine `a`, from shared
// memory (0 past the layer's width).
__device__ __forceinline__ void affine_pair(const unsigned char* sm, int a, int n, float2& sc,
                                            float2& sh) {
  const float4 v = *reinterpret_cast<const float4*>(sm + AFFINE + (a * MAX_C_OUT + n) * 8);
  sc = make_float2(v.x, v.z);
  sh = make_float2(v.y, v.w);
}

// One depthwise row into panel chunks: the 3x3 taps over rows `rows[0..2]`
// (a ring's rows, their 64-channel chunks CHUNK apart; zero outside the
// image).  Thread t computes 8 channels of PX neighbouring slots, which
// share their tap rows' loads: chunk t / (8 * SLOTS / PX), channels
// 8 * (t % 8).., slots PX * ((t / 8) % (SLOTS / PX)).. (PX = 2: one chunk
// over the block; PX = 4: two, a warpgroup each, with half the tap loads an
// output).  Slots -1 and 64 lie outside the row and
// read as 0 (only slots 0 and 63 use them, and no later stage reads those).
// `taps`: (9, stride) f32 in shared memory, 0 past the layer's width, as
// the rings are: channels there come out 0.
template <int PX>
__device__ __forceinline__ void depthwise(const unsigned char* const (&rows)[3], unsigned char* dst,
                                          const float* taps, int stride) {
  constexpr int ITEMS = SLOTS / PX * 8;  // a chunk's items
  const int ch = threadIdx.x / ITEMS, run = (threadIdx.x % ITEMS) / 8, vv = threadIdx.x % 8;
  float acc[PX][8];
#pragma unroll
  for (int k = 0; k < PX; ++k)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[k][e] = 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float xr[PX + 2][8];
#pragma unroll
    for (int q = 0; q < PX + 2; ++q) {
      const int s = PX * run - 1 + q;
      if ((unsigned)s < (unsigned)SLOTS) {
        unpack8(*reinterpret_cast<const uint4*>(rows[a] + ch * CHUNK + swz(s, vv)), xr[q]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) xr[q][e] = 0.0f;
      }
    }
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      const float* wp = taps + (a * 3 + b) * stride + ch * 64 + 8 * vv;
      const float4 w0 = *reinterpret_cast<const float4*>(wp);
      const float4 w1 = *reinterpret_cast<const float4*>(wp + 4);
      const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int k = 0; k < PX; ++k)
#pragma unroll
        for (int e = 0; e < 8; ++e)
          // product and sum rounded apart, in tap order, as the reference computes them
          acc[k][e] = __fadd_rn(acc[k][e], __fmul_rn(xr[k + b][e], wv[e]));
    }
  }
#pragma unroll
  for (int k = 0; k < PX; ++k)
    *reinterpret_cast<uint4*>(dst + ch * CHUNK + swz(PX * run + k, vv)) = pack8(acc[k]);
}

// acc (one warpgroup's 64 x 64 f32 tile) += A (panel chunks from `a`,
// K-major) x B (boxes from `b`, MN-major), over `ksteps` k16 steps; k16
// step ks reads chunk ks / 4 of A and box ks / 4 of B.
__device__ __forceinline__ void gemm(float (&acc)[32], uint32_t a, uint32_t b, int ksteps) {
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = 0.0f;
  fence_acc(acc);
  wgmma_fence();
  for (int ks = 0; ks < ksteps; ++ks)
    // A: rows of 128 B, 8-row groups 1024 B apart, k16 = 32 B along the row.
    // B: one 64-wide box; k16 = 16 rows of 128 B, 8-row groups 1024 B apart.
    wgmma_m64n64k16(acc, smem_desc(a + (ks / 4) * CHUNK + (ks % 4) * 32, 16, 1024),
                    smem_desc(b + (ks / 4) * BOX + (ks % 4) * 2048, BOX, 1024));
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(acc);
}

__device__ __forceinline__ void proxy_fence_sync() {
  // Generic-proxy writes before the async proxy's (wgmma's) reads.
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS, 1)
    entry_walker_kernel(const __grid_constant__ CUtensorMap conv2_map,
                        const __grid_constant__ CUtensorMap conv2_tail_map,
                        const __grid_constant__ CUtensorMap pw1_map,
                        const __grid_constant__ CUtensorMap res_map,
                        const __grid_constant__ CUtensorMap pw2_map, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t w_bar;
  unsigned char* sm = smem_raw + ((ALIGN - smem_u32(smem_raw) % ALIGN) % ALIGN);
  const uint32_t sm_u = smem_u32(sm);

  const int tid = threadIdx.x;
  const int g = __shfl_sync(0xffffffffu, tid / 128, 0);  // warpgroup, known warp-uniform
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int row0 = warp * 16 + lane / 4;  // accumulator rows row0, row0 + 8
  const int colq = 2 * (lane % 4);        // acc[4j + 2h + e]: row row0 + 8h, column 8j + colq + e

  const int k_boxes = (9 * p.C_in + 63) / 64, n_boxes = (p.C_out + 63) / 64;
  if (tid == 0) {  // every weight, once: conv2's K boxes, then pw1's, res's and pw2's N boxes
    const uint32_t bar = smem_u32(&w_bar);
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    // conv2's fifth box (C_in = 32: K rows 256..287) is 32 rows deep.
    mbar_expect_tx(bar,
                   (min(k_boxes, 4) + n_boxes * (2 + n_boxes)) * BOX + (k_boxes > 4) * BOX / 2);
    for (int kb = 0; kb < k_boxes; ++kb)
      tma_load(sm_u + W_CONV2 + kb * BOX, kb < 4 ? &conv2_map : &conv2_tail_map, 0, kb * 64, bar);
    for (int nb = 0; nb < n_boxes; ++nb) {
      tma_load(sm_u + W_PW1 + nb * BOX, &pw1_map, nb * 64, 0, bar);
      tma_load(sm_u + W_RES + nb * BOX, &res_map, nb * 64, 0, bar);
      for (int kb = 0; kb < n_boxes; ++kb)
        tma_load(sm_u + W_PW2 + (nb * 2 + kb) * BOX, &pw2_map, nb * 64, kb * 64, bar);
    }
  }
  {  // the affine pairs and the depthwise taps, 0 past each layer's width
    float* aff = reinterpret_cast<float*>(sm + AFFINE);
    for (int i = tid; i < 4 * MAX_C_OUT; i += THREADS) {
      const int a = i / MAX_C_OUT, n = i % MAX_C_OUT;
      const float* sc = a == AFF_CONV2 ? p.conv2_s
                        : a == AFF_BN1 ? p.bn1_s
                        : a == AFF_BN2 ? p.bn2_s : p.res_s;
      const float* sh = a == AFF_CONV2 ? p.conv2_b
                        : a == AFF_BN1 ? p.bn1_b
                        : a == AFF_BN2 ? p.bn2_b : p.res_b;
      const bool ok = n < (a == AFF_CONV2 ? p.C_b : p.C_out);
      aff[2 * i] = ok ? sc[n] : 0.0f;
      aff[2 * i + 1] = ok ? sh[n] : 0.0f;
    }
    float* taps = reinterpret_cast<float*>(sm + TAPS);
    for (int i = tid; i < 9 * MAX_C_B; i += THREADS) {
      const int t = i / MAX_C_B, c = i % MAX_C_B;
      taps[i] = c < p.C_b ? p.dw1[t * p.C_b + c] : 0.0f;
    }
    for (int i = tid; i < 9 * MAX_C_OUT; i += THREADS) {
      const int t = i / MAX_C_OUT, c = i % MAX_C_OUT;
      taps[9 * MAX_C_B + i] = c < p.C_out ? p.dw2[t * p.C_out + c] : 0.0f;
    }
  }
  const float* taps1 = reinterpret_cast<const float*>(sm + TAPS);
  const float* taps2 = taps1 + 9 * MAX_C_B;
  __syncthreads();  // the barrier is initialised, affines and taps are in
  mbar_wait(smem_u32(&w_bar), 0);

  const int Q = p.C_in / 8;  // 16-byte units of an x pixel
  // This thread's im2col item: x unit xq of slot xs, for all nine taps (64 * Q <= THREADS).
  const bool x_item = tid < SLOTS * Q;
  const int xs = tid / Q, xq = tid - (tid / Q) * Q;
  const int K2 = 9 * p.C_in;
  const int ks_conv2 = (K2 + 15) / 16, ks_b = (p.C_b + 15) / 16, ks_out = (p.C_out + 15) / 16;
  const uint32_t minus_inf2 = 0xff80ff80u;

  for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
    const int img = u / (p.strips * p.segments);
    const int st = (u / p.segments) % p.strips, sg = u % p.segments;
    const int j0 = st * p.P, pj = min(p.P, p.Wo - j0);
    const int i0 = sg * p.R, i1 = min(p.Ho, i0 + p.R);
    const int cb0 = 2 * j0 - p.pad_left - 2;  // the image column of slot 0
    const int D0 = 2 * i0 - p.pad_top;        // the first pooled d row
    const int k_end = 2 * (i1 - 1) - p.pad_top + 2;
    const __nv_bfloat16* xi = p.x + (size_t)img * p.H * p.W * p.C_in;
    uint32_t vm[16], r[16];  // bf16 pairs: the window's running max of d; r of the next row
#pragma unroll
    for (int e = 0; e < 16; ++e) vm[e] = r[e] = 0u;

    for (int k = D0 - WARMUP; k <= k_end; ++k) {
      // ---- b row k + 2: conv2 on one warpgroup ----
      {
        const int kb = k + 2;
        if (x_item) {  // the im2col panel, taps (dh, dw)-major like conv2's rows
          const int xc0 = cb0 + xs;
          const __nv_bfloat16* src0 = xi + ((long long)kb * p.W + xc0) * p.C_in + 8 * xq;
          const uint32_t dst0 = sm_u + PANEL + xs * 128;
#pragma unroll
          for (int t = 0; t < 9; ++t) {
            const int dh = t / 3, dwc = t % 3;
            const bool ok =
                (unsigned)(kb + dh) < (unsigned)p.H && (unsigned)(xc0 + dwc) < (unsigned)p.W;
            const int kk = t * p.C_in + 8 * xq;
            cp_async16(dst0 + (kk >> 6) * CHUNK + ((((kk >> 3) & 7) ^ (xs & 7)) << 4),
                       ok ? src0 + (dh * p.W + dwc) * p.C_in : p.x, ok);
          }
        }
        if (K2 % 16)  // the last k16 step's tail: zero weights, so its A must be finite
          for (int s = tid; s < SLOTS; s += THREADS)
            *reinterpret_cast<uint4*>(sm + PANEL + (K2 / 64) * CHUNK + swz(s, (K2 % 64) / 8)) =
                make_uint4(0u, 0u, 0u, 0u);
        cp_async_commit();
        cp_async_wait_all();
        proxy_fence_sync();
        if (g == 0) {
          float acc[32];
          gemm(acc, sm_u + PANEL, sm_u + W_CONV2, ks_conv2);
          const bool row_ok = (unsigned)kb < (unsigned)p.Hb;
          unsigned char* dst = sm + B_RING + ring3(kb) * CHUNK;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int n = 8 * j + colq;
            const bool n_ok = n < p.C_b;  // C_b % 8 == 0: n + 1 is in range with n
            float2 sc, sh;
            affine_pair(sm, AFF_CONV2, n, sc, sh);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int s = row0 + 8 * h;
              const bool ok = row_ok && n_ok && (unsigned)(cb0 + s) < (unsigned)p.Wb;
              const float v0 = ok ? fmaxf(affine(acc[4 * j + 2 * h], sc.x, sh.x), 0.0f) : 0.0f;
              const float v1 = ok ? fmaxf(affine(acc[4 * j + 2 * h + 1], sc.y, sh.y), 0.0f) : 0.0f;
              *reinterpret_cast<uint32_t*>(dst + swz(s, j) + colq * 2) = pack2(v0, v1);
            }
          }
        }
        __syncthreads();  // b row k + 2 is in the ring
      }

      // ---- c row k + 1: depthwise of b, pw1, affine + relu ----
      if (k >= D0 - 2) {
        const int kc = k + 1;
        const unsigned char* const rows[3] = {sm + B_RING + ring3(kc - 1) * CHUNK,
                                              sm + B_RING + ring3(kc) * CHUNK,
                                              sm + B_RING + ring3(kc + 1) * CHUNK};
        depthwise<2>(rows, sm + PANEL, taps1, MAX_C_B);
        proxy_fence_sync();
        float acc[32];
        gemm(acc, sm_u + PANEL, sm_u + W_PW1 + g * BOX, ks_b);
        const bool row_ok = (unsigned)kc < (unsigned)p.Hb;
        unsigned char* dst = sm + C_RING + (ring3(kc) * 2 + g) * CHUNK;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int n = 64 * g + 8 * j + colq;
          const bool n_ok = n < p.C_out;
          float2 sc, sh;
          affine_pair(sm, AFF_BN1, n, sc, sh);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int s = row0 + 8 * h;
            const bool ok = row_ok && n_ok && (unsigned)(cb0 + s) < (unsigned)p.Wb;
            const float v0 = ok ? fmaxf(affine(acc[4 * j + 2 * h], sc.x, sh.x), 0.0f) : 0.0f;
            const float v1 = ok ? fmaxf(affine(acc[4 * j + 2 * h + 1], sc.y, sh.y), 0.0f) : 0.0f;
            *reinterpret_cast<uint32_t*>(dst + swz(s, j) + colq * 2) = pack2(v0, v1);
          }
        }
        __syncthreads();  // c row k + 1 is in the ring; the panel is free
      }

      if (k >= D0) {  // block-uniform, as every branch around a wgmma here
        // ---- d row k: depthwise of c, pw2, affine; the pool's running max ----
        const bool first = ((k - D0) & 1) == 0;  // the top row of a pool window
        const bool emit = first && k > D0;       // ... and the bottom row of the one before
        const bool residual = (k & 1) == 0 && k >= 2 * i0 && k < 2 * i1;
        {
          const unsigned char* const rows[3] = {sm + C_RING + ring3(k - 1) * 2 * CHUNK,
                                                sm + C_RING + ring3(k) * 2 * CHUNK,
                                                sm + C_RING + ring3(k + 1) * 2 * CHUNK};
          depthwise<4>(rows, sm + PANEL, taps2, MAX_C_OUT);
        }
        proxy_fence_sync();
        {
          float acc[32];
          gemm(acc, sm_u + PANEL, sm_u + W_PW2 + g * 2 * BOX, ks_out);
          const bool row_ok = (unsigned)k < (unsigned)p.Hb;
          unsigned char* pool = sm + POOL + g * CHUNK;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int n = 64 * g + 8 * j + colq;
            const bool n_ok = n < p.C_out;
            float2 sc, sh;
            affine_pair(sm, AFF_BN2, n, sc, sh);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int s = row0 + 8 * h;
              const bool ok = row_ok && n_ok && (unsigned)(cb0 + s) < (unsigned)p.Wb;
              const uint32_t d = ok ? pack2(affine(acc[4 * j + 2 * h], sc.x, sh.x),
                                            affine(acc[4 * j + 2 * h + 1], sc.y, sh.y))
                                    : minus_inf2;
              uint32_t& m = vm[2 * j + h];
              if (emit) *reinterpret_cast<uint32_t*>(pool + swz(s, j) + colq * 2) = max2(m, d);
              m = first ? d : max2(m, d);
            }
          }
        }
        __syncthreads();  // the pooled row is written; every wgmma on the dw2 panel is done

        // ---- output row (k + pad_top - 2) / 2: 3-wide max of the pooled row, + r ----
        if (emit) {
          const int i = (k + p.pad_top - 2) / 2;
          const unsigned char* pool = sm + POOL + g * CHUNK;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int jj = row0 + 8 * h;
            __nv_bfloat16* dst = p.out + ((size_t)(img * p.Ho + i) * p.Wo + j0 + jj) * p.C_out;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const int n = 64 * g + 8 * j + colq;
              if (jj < pj && n < p.C_out) {
                const unsigned char* q = pool + colq * 2;
                uint32_t m = *reinterpret_cast<const uint32_t*>(q + swz(2 + 2 * jj, j));
                m = max2(m, *reinterpret_cast<const uint32_t*>(q + swz(3 + 2 * jj, j)));
                m = max2(m, *reinterpret_cast<const uint32_t*>(q + swz(4 + 2 * jj, j)));
                const float2 pm = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&m));
                const float2 rr =
                    __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r[2 * j + h]));
                *reinterpret_cast<__nv_bfloat162*>(dst + n) =
                    __floats2bfloat162_rn(pm.x + rr.x, pm.y + rr.y);
              }
            }
          }
        }

        // ---- r of output row k / 2, from b row k's even columns ----
        if (residual) {
          const unsigned char* src = sm + B_RING + ring3(k) * CHUNK;
          for (int idx = tid; idx < SLOTS * 8; idx += THREADS) {
            const int jj = idx / 8, uu = idx % 8;
            const int s = 2 + p.pad_left + 2 * jj;  // b column 2 * (j0 + jj)
            *reinterpret_cast<uint4*>(sm + PANEL + swz(jj, uu)) =
                s < SLOTS ? *reinterpret_cast<const uint4*>(src + swz(s, uu))
                          : make_uint4(0u, 0u, 0u, 0u);
          }
          proxy_fence_sync();
          float acc[32];
          gemm(acc, sm_u + PANEL, sm_u + W_RES + g * BOX, ks_b);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int n = 64 * g + 8 * j + colq;
            float2 sc, sh;
            affine_pair(sm, AFF_RES, n, sc, sh);
#pragma unroll
            for (int h = 0; h < 2; ++h)
              r[2 * j + h] = pack2(affine(acc[4 * j + 2 * h], sc.x, sh.x),
                                   affine(acc[4 * j + 2 * h + 1], sc.y, sh.y));
          }
        }
        if (emit || residual) __syncthreads();  // the panel and the pooled row are free again
      }
    }
  }
}

// TF "SAME" leading pad of a k=3, s=2 window along a side of `size`.
int same_pad_before(int size) {
  const int out = (size + 1) / 2;
  const int total = (out - 1) * 2 + 3 - size;
  return total > 0 ? total / 2 : 0;
}

// The walk's plan: strips of P output columns, segments of R output rows.
// A block pays WARMUP_COST sub-steps a unit and two a row; units past the
// SMs' one block each run in later waves.  R (1..Ho) with the least waves
// x (WARMUP_COST + 2R), ties to the fewer units; `rows` > 0 forces R.
void plan(Params& p, int batch, int sms, int rows) {
  p.strips = (p.Wo + MAX_P - 1) / MAX_P;
  p.P = (p.Wo + p.strips - 1) / p.strips;
  double best = -1.0;
  for (int R = 1; R <= p.Ho; ++R) {
    const int segments = (p.Ho + R - 1) / R;
    if (rows > 0 ? R != rows : (p.Ho + segments - 1) / segments != R) continue;
    const long long units = (long long)batch * p.strips * segments;
    const long long waves = (units + sms - 1) / sms;
    const double cost = (double)waves * (WARMUP_COST + 2 * R);
    if (best < 0 || cost <= best) {  // later R: fewer units
      best = cost;
      p.R = R;
      p.segments = segments;
      p.units = (int)units;
    }
  }
}

int sm_count(int* sms) {
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  return (int)e;
}

Params geometry(int H, int W) {
  Params p{};
  p.H = H;
  p.W = W;
  p.Hb = H - 2;
  p.Wb = W - 2;
  p.Ho = (p.Hb + 1) / 2;
  p.Wo = (p.Wb + 1) / 2;
  p.pad_top = same_pad_before(p.Hb);
  p.pad_left = same_pad_before(p.Wb);
  return p;
}

}  // namespace

// K5: x (B, H, W, C_in) bf16 -> out (B, ceil((H-2)/2), ceil((W-2)/2), C_out)
// bf16.  conv2 (9*C_in, C_b), res (C_b, C_out), pw1 (C_b, C_out), pw2
// (C_out, C_out) bf16; dw1 (3,3,C_b), dw2 (3,3,C_out) and the affine pairs
// f32.  Every tensor contiguous and 16-byte aligned; C_in <= 32, C_b <= 64,
// C_out <= 128, each a multiple of 8.  `rows` > 0 forces the segment
// length (output rows a work unit), 0 lets the launcher choose.  One launch
// on `stream`; returns its cudaError_t (a refused launch never runs), else 0.
extern "C" int kdlt_entry_block(const void* x, const void* conv2, const void* conv2_s,
                                const void* conv2_b, const void* res, const void* res_s,
                                const void* res_b, const void* dw1, const void* pw1,
                                const void* bn1_s, const void* bn1_b, const void* dw2,
                                const void* pw2, const void* bn2_s, const void* bn2_b, void* out,
                                int B, int H, int W, int C_in, int C_b, int C_out, int rows,
                                void* stream) {
  if (B <= 0 || H < 3 || W < 3 || C_in <= 0 || C_b <= 0 || C_out <= 0 || C_in % 8 || C_b % 8 ||
      C_out % 8 || C_in > MAX_C_IN || C_b > MAX_C_B || C_out > MAX_C_OUT || rows < 0 ||
      (long long)B * H * W * C_in >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  for (const void* ptr : {x, conv2, conv2_s, conv2_b, res, res_s, res_b, dw1, pw1, bn1_s, bn1_b,
                          dw2, pw2, bn2_s, bn2_b, (const void*)out})
    if (ptr == nullptr || !aligned16(ptr)) return (int)cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;

  Params p = geometry(H, W);
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.conv2_s = static_cast<const float*>(conv2_s);
  p.conv2_b = static_cast<const float*>(conv2_b);
  p.res_s = static_cast<const float*>(res_s);
  p.res_b = static_cast<const float*>(res_b);
  p.dw1 = static_cast<const float*>(dw1);
  p.bn1_s = static_cast<const float*>(bn1_s);
  p.bn1_b = static_cast<const float*>(bn1_b);
  p.dw2 = static_cast<const float*>(dw2);
  p.bn2_s = static_cast<const float*>(bn2_s);
  p.bn2_b = static_cast<const float*>(bn2_b);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.C_in = C_in;
  p.C_b = C_b;
  p.C_out = C_out;
  int sms = 0;
  int code = sm_count(&sms);
  if (code) return code;
  if (rows > p.Ho) rows = p.Ho;
  plan(p, B, sms, rows);

  // Weights: boxes of 64 K rows x 64 N columns, 128-byte swizzle (wgmma's
  // MN-major B), zero fill past K and N.
  alignas(64) CUtensorMap conv2_map, conv2_tail_map, pw1_map, res_map, pw2_map;
  if (!encode_map(encode, &conv2_map, conv2, 9 * C_in, C_b, 64, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_map(encode, &conv2_tail_map, conv2, 9 * C_in, C_b, 32, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_map(encode, &pw1_map, pw1, C_b, C_out, 64, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_map(encode, &res_map, res, C_b, C_out, 64, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_map(encode, &pw2_map, pw2, C_out, C_out, 64, CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;

  const int smem = SMEM_BYTES + ALIGN;
  cudaError_t e = allow_max_dynamic_smem(reinterpret_cast<const void*>(entry_walker_kernel));
  if (e != cudaSuccess) return (int)e;
  const int grid = p.units < sms ? p.units : sms;
  entry_walker_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      conv2_map, conv2_tail_map, pw1_map, res_map, pw2_map, p);
  return (int)cudaGetLastError();
}

// The segment length (output rows a work unit) the launcher picks for a
// batch of H x W inputs on the current device, or -1.
extern "C" int kdlt_entry_block_rows(int B, int H, int W) {
  if (B <= 0 || H < 3 || W < 3) return -1;
  int sms = 0;
  if (sm_count(&sms)) return -1;
  Params p = geometry(H, W);
  plan(p, B, sms, 0);
  return p.R;
}
