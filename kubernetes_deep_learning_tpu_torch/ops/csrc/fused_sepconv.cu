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
// version (stage_reference) defines the arithmetic this kernel reproduces,
// rounding point for rounding point:
//   depthwise taps in f32 over bf16 inputs, summed in the reference's tap
//   order (an out-of-image tap adds zero) -> round to bf16 -> GEMM with bf16
//   operands and f32 accumulation -> z * scale + shift in f32 (-> relu) ->
//   round to bf16 (-> bf16(f32(residual) + f32(o))).
//
// What bounds it on the card: at the middle-flow shape (19x19x728, batch 16)
// one stage is 6.1 GFLOP of bf16 GEMM against ~17 MB of activations and
// weights: tensor-core throughput bounds it, not device memory.  The
// depthwise part (9 f32 multiply-adds per GEMM input element) runs on the
// CUDA cores.  What sets this design's time is streaming (stage_ablation.py
// on an NVIDIA H100 80GB HBM3 at 700 W: without its depthwise or without
// its wgmma a stage takes 78-89% of the whole at 728 channels): a 64-pixel
// band reads all of pw from L2, and the staged input and output pass
// through L2 too.
//
// The design (one launch per stage; the TPU kernel's whole-image VMEM tile
// does not fit: one 19x19x728 image is 525 KB against 227 KB of shared
// memory, so stage outputs go through L2):
//   * a block owns a band of 64 consecutive output pixels (linear over
//     (b, h, w): 2-D tiles would waste most of a 19x19 or 10x10 image) and a
//     group of N tiles of 128 output channels;
//   * it computes the band's depthwise result for ALL of C_in once, into a
//     shared-memory panel (64 x C_in bf16, zero past C_in up to a multiple
//     of 64) laid out as wgmma's 128-byte-swizzled K-major A operand, then
//     walks its N tiles against that one panel;
//   * the panel's input comes through shared memory: every 3x3 neighbour of
//     the band lies in the contiguous pixel range [m0 - W - 1, m0 + 64 + W],
//     so TMA stages that range 64 channels at a time (2-D tensor map over x,
//     zero fill outside the tensor) in a ring of up to 4 chunks.  A consumer
//     thread computes 8 channels (16-byte vectors) of 2 consecutive pixels,
//     which share their tap rows: 4 shared-memory loads a tap row;
//     out-of-image taps are masked to zero;
//   * the launcher splits C_out into N groups, each of which pays for the
//     panel once: the count with the least waves x (panel + tiles a block)
//     on this card's SMs (one group for the middle flow at batch 16: 91
//     blocks in one wave beat 182 in two; six at bucket 1);
//   * the pointwise weights stream through a ring of 2-4 stages of 64 K x
//     128 N, filled by TMA (a 2-D tensor map over pw, 128-byte swizzle, zero
//     fill past C_in and C_out) under mbarriers; one producer thread issues
//     every copy, the first weight stages while the panel is built where the
//     staging has room of its own;
//   * two consumer warpgroups, each on 64 channels of a tile, run wgmma
//     m64n64k16 (bf16 -> f32) with A (the panel) and B (its 64-channel box
//     of the stage; pw is C_out-contiguous, an MN-major B, read through
//     wgmma's transpose bit) from shared memory, one stage's group left in
//     flight while the next is issued;
//   * the epilogue works from the accumulator registers: scale/shift as
//     float2 per column pair, relu, bf16 rounding, residual, 4-byte stores,
//     masked at the M and N tails; the producer loads the next tile's
//     stages meanwhile.
// Shared memory: the panel is 8 KB per 64 input channels (96 KB at 728, 192
// KB at 1536, where two weight stages still fit and the input staging
// shares their room); C_in above 1536 is refused.  Every width must be a
// multiple of 8 and every pointer 16-byte aligned (16-byte vectors, TMA
// strides); the launcher refuses anything else.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <initializer_list>

#include "hopper.cuh"  // mbarriers, TMA, wgmma descriptors and fences, the map encoder

namespace {

constexpr int BM = 64;                    // output pixels per band: one wgmma M
constexpr int BN = 128;                   // output channels per N tile: wgmma N
constexpr int BK = 64;                    // input channels per chunk: one 128-byte row
constexpr int BOX_N = 64;                 // channels per TMA box (the 128-byte swizzle span)
constexpr int WG_N = 64;                  // output channels per consumer warpgroup a tile
constexpr int CONSUMERS = 128 * BN / WG_N;  // two warpgroups: depthwise, wgmma and epilogue
constexpr int THREADS = CONSUMERS + 32;   // and one producer warp
constexpr int CHUNK_BYTES = BM * 128;     // a 64 x 64 panel chunk: 8 KB
constexpr int BOX_BYTES = BK * 128;       // a 64 K x 64 N box: 8 KB
constexpr int STAGE_BYTES = BK * BN * 2;  // 16 KB
constexpr int MAX_STAGES = 4;             // weight stages
constexpr int MAX_X_STAGES = 4;           // staged input chunks
constexpr int X_BOX_ROWS = 256;           // the most pixels one TMA box may hold
constexpr int PX = 2;                     // consecutive pixels per depthwise item
constexpr int SMEM_LIMIT = 232448;        // 227 KB: the most one block may use
constexpr int SM_SMEM = 233472;           // 228 KB on an SM, 1 KB of it reserved a block
constexpr int ALIGN = 1024;               // a swizzle atom (8 rows x 128 B)
constexpr int STATIC_SMEM = (2 * MAX_STAGES + MAX_X_STAGES) * 8;  // the mbarriers
constexpr int BUDGET = SMEM_LIMIT - STATIC_SMEM - ALIGN;          // panel + ring + staging
constexpr int MAX_C_IN = (BUDGET - 2 * STAGE_BYTES) / CHUNK_BYTES * BK;  // 1536
// A band's panel costs about as much as 1.6 of its N tiles (64 pixels x 128
// channels each): stage_ablation.py's panel-free build of this kernel
// against the whole, at 19x19x728 batch 16 on an NVIDIA H100 80GB HBM3 at
// 700 W (0.017 ms of panel against 0.010 ms a tile).  Shapes the grid only.
constexpr double PANEL_TILES = 1.6;

static_assert(BN % BOX_N == 0 && WG_N == BOX_N, "a warpgroup reads one box of a stage");
static_assert((BM / PX) * (BK / 8) == CONSUMERS, "one depthwise item per consumer a chunk");

struct Params {
  const float* dw;                // (9, C_in)
  const float* scale;             // (C_out,)
  const float* shift;             // (C_out,)
  const __nv_bfloat16* residual;  // (M, C_out) or null
  __nv_bfloat16* out;             // (M, C_out)
  int H, W, M, C_in, C_out;
  int k_chunks;         // ceil(C_in / 64): panel chunks, weight stages per N tile
  int n_tiles;          // ceil(C_out / 128)
  int tiles_per_group;  // N tiles one block walks
  int stages;           // weight ring depth, 2..4
  int xs_rows;          // pixels per input box
  int xs_boxes;         // boxes per staged chunk (the range is 64 + 2W + 2 pixels)
  int x_stages;         // staged chunks in flight, 1..4
  int xs_offset;        // bytes from the weight ring to the staging; 0: they share it
  int pre_relu, post_relu;
};

// One 64-channel chunk of the band's depthwise panel, from the staged input
// (pixel m0 - W - 1 + s at row s of `xs`, 128 B a row).  Consumer thread t
// computes channels 8 * (t % 8).. of pixels m0 + 2 * (t / 8) + k, k < 2;
// neighbour (a, b) of pixel k is staged row 2 * (t / 8) + a * W + k + b, so
// the two pixels share a tap row's loads (4 for 6 taps).  The result goes to
// row r of the chunk, 16-byte unit (t % 8) ^ (r % 8) (the 128-byte
// swizzle).  ph/pw: each pixel's image row and column, ph < 0 for pixels
// past M, whose taps are all masked.
__device__ __forceinline__ void panel_chunk(const Params& p, const unsigned char* xs,
                                            unsigned char* chunk, int kc, const int (&ph)[PX],
                                            const int (&pw)[PX]) {
  const int run = threadIdx.x / 8, vv = threadIdx.x % 8;
  const int c = kc * BK + vv * 8;
  float acc[PX][8];
#pragma unroll
  for (int k = 0; k < PX; ++k)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[k][e] = 0.0f;
  if (c < p.C_in) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const unsigned char* src = xs + (size_t)(PX * run + a * p.W) * 128 + vv * 16;
      float xr[PX + 2][8];
#pragma unroll
      for (int q = 0; q < PX + 2; ++q) {
        unpack8(*reinterpret_cast<const uint4*>(src + q * 128), xr[q]);
        if (p.pre_relu)
#pragma unroll
          for (int e = 0; e < 8; ++e) xr[q][e] = fmaxf(xr[q][e], 0.0f);
      }
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        const float* wp = p.dw + (size_t)(a * 3 + b) * p.C_in + c;
        const float4 w0 = __ldg(reinterpret_cast<const float4*>(wp));
        const float4 w1 = __ldg(reinterpret_cast<const float4*>(wp + 4));
        const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int k = 0; k < PX; ++k) {
          const bool ok = (unsigned)(ph[k] + a - 1) < (unsigned)p.H &&
                          (unsigned)(pw[k] + b - 1) < (unsigned)p.W;
#pragma unroll
          for (int e = 0; e < 8; ++e)
            // product and sum rounded apart, in tap order, as the reference computes them
            acc[k][e] = __fadd_rn(acc[k][e], __fmul_rn(ok ? xr[k + b][e] : 0.0f, wv[e]));
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < PX; ++k) {
    const int r = PX * run + k;
    *reinterpret_cast<uint4*>(chunk + r * 128 + ((vv ^ (r % 8)) * 16)) = pack8(acc[k]);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
    sepconv_stage_kernel(const __grid_constant__ CUtensorMap pw_map,
                         const __grid_constant__ CUtensorMap x_map, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[MAX_STAGES];
  __shared__ __align__(8) uint64_t empty_bar[MAX_STAGES];
  __shared__ __align__(8) uint64_t x_bar[MAX_X_STAGES];

  unsigned char* panel = smem_raw + ((ALIGN - smem_u32(smem_raw) % ALIGN) % ALIGN);
  unsigned char* ring = panel + p.k_chunks * CHUNK_BYTES;
  unsigned char* xs = ring + p.xs_offset;
  const uint32_t panel_u = smem_u32(panel), ring_u = smem_u32(ring), xs_u = smem_u32(xs);
  const int xs_bytes = p.xs_boxes * p.xs_rows * 128;

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int tile0 = blockIdx.y * p.tiles_per_group;
  const int tile1 = min(tile0 + p.tiles_per_group, p.n_tiles);
  const int loads = (tile1 - tile0) * p.k_chunks;  // weight stages this block streams
  const bool early = p.xs_offset != 0;  // the staging has its own room: weights load meanwhile

  // Weight load i: N tile tile0 + i / k_chunks, K chunk i % k_chunks, into slot i % stages.
  auto issue = [&](int i) {
    const int slot = i % p.stages;
    const int n = (tile0 + i / p.k_chunks) * BN, k = (i % p.k_chunks) * BK;
    const uint32_t bar = smem_u32(&full_bar[slot]);
    mbar_expect_tx(bar, STAGE_BYTES);
#pragma unroll
    for (int c = 0; c < BN / BOX_N; ++c)
      tma_load(ring_u + slot * STAGE_BYTES + c * BOX_BYTES, &pw_map, n + c * BOX_N, k, bar);
  };
  // Input chunk kc: channels kc * 64.. of pixels m0 - W - 1.., into buffer kc % x_stages.
  auto issue_x = [&](int kc) {
    const int buf = kc % p.x_stages;
    const uint32_t bar = smem_u32(&x_bar[buf]);
    mbar_expect_tx(bar, xs_bytes);
    for (int i = 0; i < p.xs_boxes; ++i)
      tma_load(xs_u + buf * xs_bytes + i * p.xs_rows * 128, &x_map, kc * BK,
               m0 - p.W - 1 + i * p.xs_rows, bar);
  };

  if (tid == CONSUMERS) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(smem_u32(&full_bar[s]), 1);
      mbar_init(smem_u32(&empty_bar[s]), CONSUMERS / 32);
    }
    for (int s = 0; s < p.x_stages; ++s) mbar_init(smem_u32(&x_bar[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int kc = 0; kc < min(p.x_stages, p.k_chunks); ++kc) issue_x(kc);
    if (early)
      for (int i = 0; i < min(p.stages, loads); ++i) issue(i);  // the slots start empty
  }

  // This thread's depthwise pixels: the same in every chunk.
  const int HW = p.H * p.W;
  int ph[PX], pw[PX];
#pragma unroll
  for (int k = 0; k < PX; ++k) {
    const int m = m0 + PX * (tid / 8) + k;
    const int hw = m % HW;
    ph[k] = m < p.M ? hw / p.W : -3;
    pw[k] = hw % p.W;
  }
  __syncthreads();  // the barriers are initialised

  for (int kc = 0; kc < p.k_chunks; ++kc) {
    const int buf = kc % p.x_stages;
    mbar_wait(smem_u32(&x_bar[buf]), (kc / p.x_stages) & 1);
    if (tid < CONSUMERS) panel_chunk(p, xs + buf * xs_bytes, panel + kc * CHUNK_BYTES, kc, ph, pw);
    // Generic-proxy writes and reads before the async proxy's (wgmma, TMA) use.
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (tid == CONSUMERS && kc + p.x_stages < p.k_chunks) issue_x(kc + p.x_stages);
  }

  if (tid >= CONSUMERS) {  // producer warp: keep the weight ring full
    if (tid == CONSUMERS) {
      for (int i = early ? min(p.stages, loads) : 0; i < loads; ++i) {
        if (i >= p.stages) mbar_wait(smem_u32(&empty_bar[i % p.stages]), ((i / p.stages) - 1) & 1);
        issue(i);
      }
    }
    return;
  }

  // Consumer warpgroups: warpgroup g computes channels g * 64.. of each tile.
  const int g = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int row0 = m0 + warp * 16 + lane / 4;  // accumulator rows row0, row0 + 8
  int i = 0;
  for (int tile = tile0; tile < tile1; ++tile) {
    float acc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = 0.0f;
    fence_acc(acc);
    for (int kc = 0; kc < p.k_chunks; ++kc, ++i) {
      const int slot = i % p.stages;
      mbar_wait(smem_u32(&full_bar[slot]), (i / p.stages) & 1);
      wgmma_fence();
      const uint32_t a = panel_u + kc * CHUNK_BYTES;
      const uint32_t b = ring_u + slot * STAGE_BYTES + g * BOX_BYTES;
#pragma unroll
      for (int k = 0; k < BK / 16; ++k)
        // A: rows of 128 B, 8-row groups 1024 B apart, k16 = 32 B along the row.
        // B: this warpgroup's 64-channel box; k16 = 16 rows of 128 B, 8-row
        //    groups 1024 B apart (one box wide: the leading offset is unused).
        wgmma_m64n64k16(acc, smem_desc(a + k * 32, 16, 1024),
                        smem_desc(b + k * 2048, BOX_BYTES, 1024));
      wgmma_commit();
      // One group stays in flight; the one before it is done with its slot.
      wgmma_wait<1>();
      fence_acc(acc);
      if (kc > 0 && lane == 0) mbar_arrive(smem_u32(&empty_bar[(i - 1) % p.stages]));
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (lane == 0) mbar_arrive(smem_u32(&empty_bar[(i - 1) % p.stages]));

    // Epilogue from the registers: acc[4j + 2h + e] is row row0 + 8h,
    // column tile * 128 + g * 64 + 8j + 2 * (lane % 4) + e.
    const int n_base = tile * BN + g * WG_N + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < WG_N / 8; ++j) {
      const int n = n_base + 8 * j;
      if (n >= p.C_out) continue;  // C_out % 8 == 0: n + 1 is in range with n
      const float2 sc = __ldg(reinterpret_cast<const float2*>(p.scale + n));
      const float2 sh = __ldg(reinterpret_cast<const float2*>(p.shift + n));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = row0 + 8 * h;
        if (m >= p.M) continue;
        float v0 = __fadd_rn(__fmul_rn(acc[4 * j + 2 * h], sc.x), sh.x);
        float v1 = __fadd_rn(__fmul_rn(acc[4 * j + 2 * h + 1], sc.y), sh.y);
        if (p.post_relu) {
          v0 = fmaxf(v0, 0.0f);
          v1 = fmaxf(v1, 0.0f);
        }
        __nv_bfloat162 o = __floats2bfloat162_rn(v0, v1);
        const size_t dst = (size_t)m * p.C_out + n;
        if (p.residual != nullptr) {
          const float2 r = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(p.residual + dst));
          const float2 f = __bfloat1622float2(o);
          o = __floats2bfloat162_rn(r.x + f.x, r.y + f.y);
        }
        *reinterpret_cast<__nv_bfloat162*>(p.out + dst) = o;
      }
    }
  }
}

// Shared memory of a block that walks p.tiles_per_group N tiles: the panel,
// the weight ring (as many stages as fit, up to 4, and no more than the block
// streams) and the input staging (a band's pixel range, up to 4 chunks in
// flight).  The staging either has room of its own beside the ring, so the
// first weight stages load while the panel is built, or shares the ring's
// room, which it leaves before they load.  Sharing is taken where it puts
// more blocks on an SM and `crowded` says the grid has blocks to fill them
// (many bands of few channels: wide images such as 147x147).  Fills the ring and
// staging fields of p; returns the dynamic shared memory, or -1.
int plan_smem(Params& p, int W, bool crowded) {
  const int panel_bytes = p.k_chunks * CHUNK_BYTES;
  const int loads = p.tiles_per_group * p.k_chunks;
  p.stages = (BUDGET - panel_bytes) / STAGE_BYTES;
  if (p.stages > MAX_STAGES) p.stages = MAX_STAGES;
  if (p.stages > loads) p.stages = loads > 2 ? loads : 2;
  if (p.stages < 2) return -1;
  const int ring_bytes = p.stages * STAGE_BYTES;
  const int span = BM + 2 * W + 2;
  p.xs_boxes = (span + X_BOX_ROWS - 1) / X_BOX_ROWS;
  p.xs_rows = (span + p.xs_boxes - 1) / p.xs_boxes;
  const int xs_bytes = p.xs_boxes * p.xs_rows * 128;
  const int most = p.k_chunks < MAX_X_STAGES ? p.k_chunks : MAX_X_STAGES;
  const int least = most < 2 ? most : 2;
  int own = most;  // chunks in flight with room of their own
  while (own >= least && panel_bytes + ring_bytes + own * xs_bytes > BUDGET) --own;
  int shared = ring_bytes / xs_bytes;  // chunks in flight in the ring's room
  shared = shared < 1 ? 1 : (shared > most ? most : shared);
  const int shared_region = shared * xs_bytes > ring_bytes ? shared * xs_bytes : ring_bytes;
  const int own_region = ring_bytes + own * xs_bytes;
  const auto per_sm = [](int bytes) { return SM_SMEM / (bytes + ALIGN + STATIC_SMEM + 1024); };
  const bool share = own < least || (crowded && per_sm(panel_bytes + shared_region) >
                                                    per_sm(panel_bytes + own_region));
  if (share && panel_bytes + shared_region > BUDGET) return -1;
  p.x_stages = share ? shared : own;
  p.xs_offset = share ? 0 : ring_bytes;
  return ALIGN + panel_bytes + (share ? shared_region : own_region);
}

// Blocks of the kernel that the register file holds on one SM (registers
// are allocated per warp in units of 256).
int blocks_by_registers() {
  static const int n = [] {
    cudaFuncAttributes attr;
    if (cudaFuncGetAttributes(&attr, sepconv_stage_kernel) != cudaSuccess) return 0;
    const int per_warp = (attr.numRegs * 32 + 255) / 256 * 256;
    return 65536 / (per_warp * (THREADS / 32));
  }();
  return n;
}

}  // namespace

// Plain C interface, bound with ctypes (ops/_build.py).  Pointers are device
// pointers from tensor.data_ptr(); ``stream`` is a cudaStream_t.  C_in and
// C_out must be multiples of 8, C_in at most 1536, and every pointer 16-byte
// aligned.  Returns the cudaError_t of the launch (0 on success): a refused
// launch never runs.
extern "C" int kdlt_sepconv_stage(const void* x, const void* dw, const void* pw,
                                  const void* scale, const void* shift, const void* residual,
                                  void* out, int B, int H, int W, int C_in, int C_out,
                                  int pre_relu, int post_relu, void* stream) {
  const long long M = (long long)B * H * W;
  if (M <= 0 || M > (1LL << 30) || C_in <= 0 || C_out <= 0 || C_in % 8 || C_out % 8 ||
      C_in > MAX_C_IN)
    return (int)cudaErrorInvalidValue;
  for (const void* ptr : {x, dw, pw, scale, shift, (const void*)out})
    if (ptr == nullptr || !aligned16(ptr)) return (int)cudaErrorInvalidValue;
  if (residual != nullptr && !aligned16(residual)) return (int)cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;

  Params p;
  p.dw = static_cast<const float*>(dw);
  p.scale = static_cast<const float*>(scale);
  p.shift = static_cast<const float*>(shift);
  p.residual = static_cast<const __nv_bfloat16*>(residual);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.H = H;
  p.W = W;
  p.M = (int)M;
  p.C_in = C_in;
  p.C_out = C_out;
  p.k_chunks = (C_in + BK - 1) / BK;
  p.n_tiles = (C_out + BN - 1) / BN;
  p.pre_relu = pre_relu;
  p.post_relu = post_relu;

  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  const int by_regs = blocks_by_registers();
  if (by_regs <= 0) return (int)cudaErrorInvalidDeviceFunction;

  // Grid: bands x N groups.  A block pays for its band's panel once, then for
  // each of its N tiles; blocks past what the SMs hold at once run in later
  // waves.  Take the group count with the least waves x (panel + tiles a
  // block), the panel counted as PANEL_TILES tiles.
  const int bands = (int)((M + BM - 1) / BM);
  int groups = 0, smem = 0;
  double best = 0.0;
  for (int tpg = p.n_tiles; tpg >= 1; --tpg) {
    const int g = (p.n_tiles + tpg - 1) / tpg;
    if ((p.n_tiles + g - 1) / g != tpg) continue;  // g groups balance better with fewer tiles
    Params q = p;
    q.tiles_per_group = tpg;
    const int bytes = plan_smem(q, W, (long long)bands * g > sms);
    if (bytes < 0) continue;
    int per_sm = SM_SMEM / (bytes + STATIC_SMEM + 1024);
    if (per_sm > by_regs) per_sm = by_regs;
    if (per_sm < 1) continue;
    const long long slots = (long long)sms * per_sm;
    const long long waves = ((long long)bands * g + slots - 1) / slots;
    const double cost = (double)waves * (PANEL_TILES + tpg);
    if (groups == 0 || cost < best) {
      best = cost;
      groups = g;
      smem = bytes;
      p = q;
    }
  }
  if (groups == 0) return (int)cudaErrorInvalidValue;

  // pw (C_in, C_out): boxes of 64 K rows x 64 channels, 128-byte swizzle (wgmma's B).
  // x (M, C_in): boxes of xs_rows pixels x 64 channels, unswizzled.
  alignas(64) CUtensorMap pw_map, x_map;
  if (!encode_map(encode, &pw_map, pw, C_in, C_out, BK, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_map(encode, &x_map, x, p.M, C_in, p.xs_rows, CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;

  e = allow_max_dynamic_smem(reinterpret_cast<const void*>(sepconv_stage_kernel));
  if (e != cudaSuccess) return (int)e;
  sepconv_stage_kernel<<<dim3(bands, groups), THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      pw_map, x_map, p);
  return (int)cudaGetLastError();
}

extern "C" const char* kdlt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
