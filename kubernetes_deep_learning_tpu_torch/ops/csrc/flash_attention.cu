// Flash-attention forward for Hopper (sm_90a): K3, its partials form K3P,
// and K3G, K3 with several (batch, head) pairs per block.
//
// K3 replaces the TPU kernel _flash_kernel of
// kubernetes_deep_learning_tpu/ops/attention.py (pallas_call at :342; loop
// _flash_body :127-196, epilogue :199-212).  K3P replaces
// _flash_kernel_partials (pallas_call at :316, epilogue :215-226): the same
// loop, but the epilogue writes the raw f32 (acc, m, l) of the online
// softmax for a log-sum-exp merge instead of the normalised output.  The
// Python wrapper of both is flash_attention in ../attention.py
// (return_partials picks K3P); their plain PyTorch versions,
// flash_attention_reference and flash_attention_partials_reference, define
// what they compute, rounding point for rounding point:
//   S = Q.K^T with input-dtype operands and f32 accumulation, then * scale
//   in f32; keys at or past kv_len, and under `causal` keys with
//   q_row < k_col + k_offset, get NEG_INF; online max / sum / rescale in
//   f32; P cast to the input dtype for P.V, accumulated in f32; a row whose
//   max stays <= NEG_INF/2 (no visible key) outputs 0; the output is cast
//   to the input dtype.  K3P writes acc (f32, unnormalised), m and l (f32,
//   l summed from the f32 p before its cast); a row with no visible key
//   writes (0, NEG_INF, 0), so that finalize_partials gives 0 for it and a
//   log-sum-exp merge with any real partial returns that partial.  (The
//   TPU kernel leaves l there counting the masked keys of the tiles it
//   visited, a value that depends on its tile size.)
//
// Both forms keep the running max in raw score units (before `scale`):
// max(round(s * scale)) == round(max(s) * scale) for scale > 0, so the m
// that K3P writes is the plain version's, in natural-log units.  The
// exponentials fold scale * log2(e) into one FFMA before ex2.  Masking
// runs only on the KV tiles that straddle kv_len or the causal diagonal.
//
// What bounds them on the card, and what each form does about it:
//   * bf16 (K3 at ViT-B/16-384, batch 16: B*H = 192, S = 576, D = 64):
//     56.6 MB of q, k, v, o (~17 us of HBM), 16.3 GFLOP of bf16 products
//     (~16.5 us) and 63.7 M exponentials (~15 us): all three are close, so
//     only a loop that overlaps loads, MMA and softmax comes near them.
//     Design: warp-specialised and persistent.  One producer warp issues
//     TMA loads (one 4-D tensor map per operand over (D, S, H, B) with
//     the callers' three strides, so (B, S, H, D) projections are read in
//     place and a ragged tile is zero-filled at its own head's end, never
//     reading the next head) into a 3-stage mbarrier ring of 64-key K and
//     V tiles, and a double-buffered Q tile.  1-3 consumer warpgroups each
//     own 64 query rows: S = Q.K^T by wgmma m64n64k16 with Q and K both
//     K-major in shared memory; the softmax on the accumulator registers;
//     O += P.V by wgmma with P in registers (the S accumulator layout is
//     the A-fragment layout) and V an MN-major B through the transpose
//     bit, one instruction per 64-wide swizzle atom of D.  S_j is issued
//     with P_{j-1}.V_{j-1}, and the softmax of S_j runs while that P.V is
//     on the tensor cores.  The grid is the blocks the card holds at once;
//     each walks work items (a q-tile of a (batch, head) group), so the
//     next item's loads overlap this one's epilogue.  Swizzle: 128 B for
//     D = 64 and 128 (two atoms along D), 64 B for D = 32.  The launcher
//     picks the consumer count (the q-tile: 64, 128 or 192 rows) from the
//     card's occupancy (plan_bf16).  The mask is applied in one branch per
//     tile, never per score: per-score branches between the wgmma
//     instructions made ptxas wait for each one to finish before the next.
//     Encoding a tensor map costs ~0.2 us of host time on an H100 host
//     (kdlt_flash_map_encode_us, printed by chip_smoke.py), under 1 us for
//     a launch's three, so they are not cached.
//   * f32 (K3P in fit, batch 32: B*H = 384, S = 256, D = 64): 101.5 MB of
//     q, k, v, acc, m, l (~30 us) and 6.44 GFLOP of products.  On FMA
//     (67 TFLOP/s) the products alone take 96 us; here they run on the
//     tensor cores as 3xTF32 (CUTLASS's OpMultiplyAddFastF32): each operand
//     x is split into big = tf32(x) and small = tf32(x - big), and
//     small.big + big.small + big.big is accumulated in f32 (3 x 6.44 GFLOP
//     at 495 TFLOP/s: ~39 us).  The dropped small.small term and the tf32
//     rounding of small are ~2^-22 relative, near f32's own 2^-24 and far
//     inside the 1e-4 contract.  mma.sync m16n8k8 in the FlashAttention-2
//     register layout: a warp owns 16 query rows, Q is split once into
//     registers; 32-key K and V tiles stream through a cp.async double
//     buffer and are split once a tile, in place (big) and into a lo tile
//     (small), so no warp repeats the split; P is split in registers and
//     its k-order is permuted (fragment column t <-> key 2t, t + 4 <-> key
//     2t + 1) so that the S accumulator is P's A fragment with no shuffle;
//     V's B fragments follow the same permutation.  Not wgmma: TF32 wgmma
//     needs both shared-memory operands K-major, and V (keys x D, D
//     contiguous) is MN-major for P.V, so it would need a transpose pass;
//     that is later work.
//
// K3G replaces flash_gfold of exp/vit_attn_variants.py (pallas_call at
// :121): non-causal attention with g (batch, head) pairs per grid step,
// which cut the TPU's fixed per-step cost g-fold at D = 64.  Here it is
// K3's loop run for `pairs` pairs in turn on one q-tile (bf16: a work
// item of the persistent grid; f32: a block of the (q-tiles, B*H / pairs)
// grid); same numerics, same plain version (flash_attention_reference),
// wrapper flash_gfold in ../attention.py.  The mbarrier ring's and the Q
// buffers' phases carry over from one pair to the next.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <chrono>

#include "hopper.cuh"  // mbarriers, TMA, wgmma descriptors and fences, the map encoder

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;                                   // (B, H, Sq, D) contiguous; K3P: acc, f32
  float* m;                                  // K3P only: (B, H, Sq) f32 row max
  float* l;                                  // K3P only: (B, H, Sq) f32 row sum
  long long q_sb, q_sh, q_ss;                // element strides of batch, head, seq
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  int H, Sq, Sk, kv_len, causal, k_offset;   // kv_len <= Sk
  float scale;
  int pairs;                                 // (batch, head) pairs per block (K3G; else 1)
  int nc;                                    // bf16: consumer warpgroups per block
  int q_tiles, items;                        // bf16: query tiles a pair, work items
};

__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// KV tiles a query tile [q0, q0 + BQ) has to visit: none past kv_len and,
// under `causal`, none whose first key lies beyond the tile's last query
// (the JAX kernel's `hi`, _flash_body :183-191).
__device__ __forceinline__ int kv_tiles(const Params& p, int q0, int BQ, int BK) {
  int n = (p.kv_len + BK - 1) / BK;
  if (p.causal) n = min(n, max(floor_div(q0 + BQ - 1 - p.k_offset, BK) + 1, 0));
  return n;
}

__device__ __forceinline__ bool visible(const Params& p, int row, int col) {
  return col < p.kv_len && (!p.causal || row >= col + p.k_offset);
}

// Whether the KV tile [k0, k0 + BK) hides a key from a row >= row_lo: it
// straddles kv_len or, under `causal`, the diagonal.  Other tiles skip the
// per-score mask.
__device__ __forceinline__ bool needs_mask(const Params& p, int row_lo, int k0, int BK) {
  return k0 + BK > p.kv_len || (p.causal && k0 + BK - 1 + p.k_offset > row_lo);
}

// 2^x on the special-function unit (ex2.approx: ~2 ulp; -inf-like
// arguments give 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(FULL, x, 1));
  return fmaxf(x, __shfl_xor_sync(FULL, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(FULL, x, 1);
  return x + __shfl_xor_sync(FULL, x, 2);
}

// ----------------------------------------------------------------- f32 ----

constexpr int F_THREADS = 128;  // 4 warps x 16 query rows
constexpr int F_BQ = 64;
constexpr int F_BK = 32;

// Shared memory of the f32 body, in floats: a 2-stage ring of (K, V) tiles
// that cp.async fills and the split turns into their big halves in place,
// and one (K, V) pair of small-half tiles.  Rows padded by 4 floats: the
// fragment loads of a warp then hit 32 distinct banks.
template <int D>
constexpr int f32_smem_bytes() {
  return 6 * F_BK * (D + 4) * 4;
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small, both tf32 (big's low 13 bits are zero: a valid f32).
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = tf32(x);
  small = tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a.b in 3xTF32: the two cross terms first, then big.big.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&a_big)[4],
                                           const uint32_t (&a_small)[4], const float* b_big,
                                           const float* b_small, int b1_offset) {
  const uint32_t bb0 = __float_as_uint(b_big[0]), bb1 = __float_as_uint(b_big[b1_offset]);
  mma_tf32(c, a_small, bb0, bb1);
  mma_tf32(c, a_big, __float_as_uint(b_small[0]), __float_as_uint(b_small[b1_offset]));
  mma_tf32(c, a_big, bb0, bb1);
}

// Keys [k0, k0 + F_BK) of K and V into a ring stage; keys at or past Sk
// are zero-filled.
template <int D>
__device__ __forceinline__ void f32_load_tile(float* ks, float* vs, const float* kg,
                                              const float* vg, const Params& p, int k0) {
  constexpr int CH = D / 4, LD = D + 4;
  for (int i = threadIdx.x; i < F_BK * CH; i += F_THREADS) {
    const int r = i / CH, c = (i % CH) * 4;
    const bool ok = k0 + r < p.Sk;
    const long long row = ok ? k0 + r : 0;
    cp_async16(smem_u32(ks + r * LD + c), kg + row * p.k_ss + c, ok);
    cp_async16(smem_u32(vs + r * LD + c), vg + row * p.v_ss + c, ok);
  }
}

// A staged tile's big halves in place, its small halves into `lo`.
template <int D>
__device__ __forceinline__ void f32_split_tile(float* hi, float* lo) {
  constexpr int CH = D / 4, LD = D + 4;
  for (int i = threadIdx.x; i < F_BK * CH; i += F_THREADS) {
    const int off = (i / CH) * LD + (i % CH) * 4;
    float4 x = *reinterpret_cast<float4*>(hi + off);
    uint32_t b[4], s[4];
    split_tf32(x.x, b[0], s[0]);
    split_tf32(x.y, b[1], s[1]);
    split_tf32(x.z, b[2], s[2]);
    split_tf32(x.w, b[3], s[3]);
    *reinterpret_cast<uint4*>(hi + off) = make_uint4(b[0], b[1], b[2], b[3]);
    *reinterpret_cast<uint4*>(lo + off) = make_uint4(s[0], s[1], s[2], s[3]);
  }
}

// One (batch, head) pair `bh` for the query tile of blockIdx.x.
template <int D, bool PARTIALS>
__device__ __forceinline__ void flash_pair_f32(const Params& p, int bh, float* smem) {
  constexpr int LD = D + 4, TILE = F_BK * LD;
  float* ring = smem;  // stage s: K at ring + 2 s TILE, V one TILE further
  float* klo = smem + 4 * TILE;
  float* vlo = klo + TILE;

  const int b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.x * F_BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group, column
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;

  const int n_tiles = kv_tiles(p, q0, F_BQ, F_BK);
  if (n_tiles > 0) f32_load_tile<D>(ring, ring + TILE, kg, vg, p, 0);
  cp_async_commit();

  // This warp's 16 query rows as split A fragments, kept for the whole
  // loop: element e of step kk is row g + 8 (e & 1), column 8 kk + t + 4 (e >> 1).
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  uint32_t qb[D / 8][4], qs[D / 8][4];
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row[e & 1];
      const float x = r < p.Sq ? qg[(long long)r * p.q_ss + 8 * kk + t + 4 * (e >> 1)] : 0.f;
      split_tf32(x, qb[kk][e], qs[kk][e]);
    }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float mr[2] = {NEG_INF, NEG_INF};  // running max of the raw scores, rows g and g + 8
  float l[2] = {0.f, 0.f};           // this thread's share of the row sums
  const float c = p.scale * LOG2E;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * F_BK;
    float* kb = ring + (j & 1) * 2 * TILE;
    float* vb = kb + TILE;
    cp_async_wait_all();  // this thread's copies of tile j have landed
    __syncthreads();      // everyone's have; every warp is done with tile j - 1
    if (j + 1 < n_tiles)
      f32_load_tile<D>(ring + ((j + 1) & 1) * 2 * TILE, ring + ((j + 1) & 1) * 2 * TILE + TILE,
                       kg, vg, p, k0 + F_BK);
    cp_async_commit();
    f32_split_tile<D>(kb, klo);
    f32_split_tile<D>(vb, vlo);
    __syncthreads();

    // S = Q.K^T, raw: 16 rows x 32 keys, 4 accumulator tiles of 16 x 8.
    float s[F_BK / 8][4];
#pragma unroll
    for (int n = 0; n < F_BK / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const int off = (n * 8 + g) * LD + t;  // B fragment: key n 8 + g, columns t and t + 4
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk)
        mma_3xtf32(s[n], qb[kk], qs[kk], kb + off + 8 * kk, klo + off + 8 * kk, 4);
    }

    // Mask (straddling tiles only), the tile's row max, the rescale.
    if (needs_mask(p, q0, k0, F_BK)) {
#pragma unroll
      for (int n = 0; n < F_BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[n][e] = visible(p, row[e >> 1], k0 + n * 8 + 2 * t + (e & 1)) ? s[n][e] : NEG_INF;
    }
    float mx[2] = {mr[0], mr[1]};
#pragma unroll
    for (int n = 0; n < F_BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
    float mc[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      const float alpha = fast_exp2((mr[r] - mx[r]) * c);
      mr[r] = mx[r];
      mc[r] = mx[r] * c;
      l[r] *= alpha;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[n][2 * r] *= alpha;
        acc[n][2 * r + 1] *= alpha;
      }
    }

    // O += P.V, one k8 step per S tile n.  The thread holds P at keys
    // 2t, 2t + 1 of the tile: A column t is key 2t, column t + 4 key 2t + 1,
    // and the B fragment reads V's rows in the same order.
#pragma unroll
    for (int n = 0; n < F_BK / 8; ++n) {
      const float p0 = fast_exp2(fmaf(s[n][0], c, -mc[0]));
      const float p1 = fast_exp2(fmaf(s[n][1], c, -mc[0]));
      const float p2 = fast_exp2(fmaf(s[n][2], c, -mc[1]));
      const float p3 = fast_exp2(fmaf(s[n][3], c, -mc[1]));
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      uint32_t ab[4], as[4];
      split_tf32(p0, ab[0], as[0]);
      split_tf32(p2, ab[1], as[1]);
      split_tf32(p1, ab[2], as[2]);
      split_tf32(p3, ab[3], as[3]);
      const int off = (n * 8 + 2 * t) * LD + g;
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd)
        mma_3xtf32(acc[nd], ab, as, vb + off + 8 * nd, vlo + off + 8 * nd, LD);
    }
  }

  const long long row0 = (long long)bh * p.Sq;  // this (batch, head)'s first row
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    if (row[r] >= p.Sq) continue;
    const bool dead = mr[r] <= NEG_INF * 0.5f;
    float* orow = static_cast<float*>(p.o) + (row0 + row[r]) * D + 2 * t;
    const float denom = (PARTIALS || dead) ? 1.f : l[r];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      float2 val = make_float2(0.f, 0.f);
      if (!dead) val = make_float2(acc[n][2 * r] / denom, acc[n][2 * r + 1] / denom);
      *reinterpret_cast<float2*>(orow + 8 * n) = val;
    }
    if (PARTIALS && t == 0) {
      p.m[row0 + row[r]] = dead ? NEG_INF : mr[r] * p.scale;
      p.l[row0 + row[r]] = dead ? 0.f : l[r];
    }
  }
}

// Three blocks an SM at D <= 64 (at most 168 registers a thread).
template <int D, bool PARTIALS>
__global__ void __launch_bounds__(F_THREADS, D == 128 ? 1 : 3) flash_fwd_f32(Params p) {
  extern __shared__ float4 smem_f32[];
  for (int i = 0; i < p.pairs; ++i) {
    if (i) __syncthreads();  // every warp is done with the last pair's shared tiles
    flash_pair_f32<D, PARTIALS>(p, blockIdx.y * p.pairs + i, reinterpret_cast<float*>(smem_f32));
  }
}

// ---------------------------------------------------------------- bf16 ----

constexpr int BF_BK = 64;      // keys per K/V tile: wgmma N of Q.K^T
constexpr int BF_STAGES = 3;   // K/V ring depth
constexpr int BF_MAX_NC = 3;   // consumer warpgroups (64 query rows each) at most
// D = 128 holds 64 more accumulator registers a thread: at most two
// consumer warpgroups, so that 224 registers a thread fit.
template <int D>
constexpr int bf_max_nc() {
  return D == 128 ? 2 : BF_MAX_NC;
}
constexpr int ALIGN = 1024;    // a 128-byte swizzle atom (8 rows x 128 B)

// Shared-memory layout of a bf16 tile of R rows x D: D / AW column blocks
// ("atoms") of AW elements, each R rows of AW * 2 bytes, swizzled as TMA
// writes it and wgmma reads it.
template <int D>
struct Bf {
  static constexpr int AW = D < 64 ? D : 64;          // elements a swizzled row
  static constexpr int ROW_B = AW * 2;                 // 64 or 128 bytes
  static constexpr int NA = D / AW;                    // atoms along D
  static constexpr uint32_t LAYOUT = ROW_B == 128 ? 1 : 2;  // descriptor: 128 B / 64 B swizzle
  static constexpr uint32_t SBO = 8 * ROW_B;           // 8-row group stride
  static constexpr int ATOM = BF_BK * ROW_B;           // one atom of a K or V tile
  static constexpr int TILE = BF_BK * D * 2;           // a K or V tile
  // Alignment slack, two Q buffers, the K and V rings.
  static constexpr int smem_bytes(int nc) {
    return ALIGN + 2 * nc * 64 * D * 2 + 2 * BF_STAGES * TILE;
  }
};

#define KDLT_ACC16(d)                                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),          \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15])
#define KDLT_ACC32(d)                                                                          \
  KDLT_ACC16(d), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), \
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),           \
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define KDLT_REGS16                                                                            \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define KDLT_REGS32                                                                            \
  KDLT_REGS16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"

// S(64 x 64 keys) (+)= Q(64 x 16) . K(64 keys x 16)^T: both K-major bf16 in
// shared memory; `accumulate` 0 overwrites S.
__device__ __forceinline__ void wgmma_qk(float (&d)[32], uint64_t desc_q, uint64_t desc_k,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" KDLT_REGS32
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : KDLT_ACC32(d)
      : "l"(desc_q), "l"(desc_k), "r"(accumulate));
}

// O(64 x 64) += P(64 x 16 keys, registers) . V(16 keys x 64, MN-major in
// shared memory, read through the transpose bit).
__device__ __forceinline__ void wgmma_pv(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_v) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" KDLT_REGS32
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : KDLT_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_v), "r"(1));
}

// The same at 32 columns (D = 32).
__device__ __forceinline__ void wgmma_pv(float (&d)[16], const uint32_t (&a)[4], uint64_t desc_v) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {" KDLT_REGS16
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : KDLT_ACC16(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_v), "r"(1));
}

// Keeps P's registers alive (and unmoved) until the wgmma reading them is
// known to be done.
__device__ __forceinline__ void fence_regs(uint32_t (&r)[BF_BK / 16][4]) {
#pragma unroll
  for (int i = 0; i < BF_BK / 16; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A work item is one query tile (64 nc rows) of one group of p.pairs
// (batch, head) pairs; item w is q-tile w % q_tiles of group w / q_tiles.
struct Item {
  int q0, group;
};

__device__ __forceinline__ Item item_at(const Params& p, int w) {
  return {(w % p.q_tiles) * 64 * p.nc, w / p.q_tiles};
}

// Persistent: block b walks items b, b + gridDim.x, ...  Warps 0 .. 4 nc - 1
// are consumer warpgroups, warp 4 nc the producer, which loads the next
// item's Q (double-buffered) and K/V tiles while the consumers finish the
// current one.  Every ring and Q-buffer phase carries over from one pair
// and one item to the next.
template <int D, bool PARTIALS>
__global__ void __launch_bounds__(128 * bf_max_nc<D>() + 32, 1)
    flash_fwd_bf16(const __grid_constant__ CUtensorMap q_map,
                   const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map, const Params p) {
  using L = Bf<D>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t q_full[2], q_empty[2];
  __shared__ __align__(8) uint64_t k_full[BF_STAGES], v_full[BF_STAGES], empty[BF_STAGES];

  const int q_bytes = p.nc * 64 * D * 2;  // one Q buffer
  const uint32_t q_u = smem_u32(smem_raw) + (ALIGN - smem_u32(smem_raw) % ALIGN) % ALIGN;
  const uint32_t k_u = q_u + 2 * q_bytes;
  const uint32_t v_u = k_u + BF_STAGES * L::TILE;
  const int consumers = 128 * p.nc;

  if (threadIdx.x == consumers) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(smem_u32(&q_full[s]), 1);
      mbar_init(smem_u32(&q_empty[s]), consumers / 32);
    }
    for (int s = 0; s < BF_STAGES; ++s) {
      mbar_init(smem_u32(&k_full[s]), 1);
      mbar_init(smem_u32(&v_full[s]), 1);
      mbar_init(smem_u32(&empty[s]), consumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();  // the barriers are initialised

  if (threadIdx.x >= consumers) {  // producer warp: one thread issues every copy
    if (threadIdx.x == consumers) {
      int it = 0, qi = 0;  // K/V tiles and Q tiles loaded so far
      for (int w = blockIdx.x; w < p.items; w += gridDim.x) {
        const Item item = item_at(p, w);
        const int n_tiles = kv_tiles(p, item.q0, 64 * p.nc, BF_BK);
        for (int i = 0; n_tiles > 0 && i < p.pairs; ++i, ++qi) {
          const int bh = item.group * p.pairs + i, b = bh / p.H, h = bh % p.H;
          const int qb = qi & 1;
          if (qi >= 2) mbar_wait(smem_u32(&q_empty[qb]), ((qi >> 1) - 1) & 1);
          mbar_expect_tx(smem_u32(&q_full[qb]), q_bytes);
#pragma unroll
          for (int a = 0; a < L::NA; ++a)
            tma_load_4d(q_u + qb * q_bytes + a * p.nc * 64 * L::ROW_B, &q_map, a * L::AW,
                        item.q0, h, b, smem_u32(&q_full[qb]));
          for (int j = 0; j < n_tiles; ++j, ++it) {
            const int slot = it % BF_STAGES;
            if (it >= BF_STAGES) mbar_wait(smem_u32(&empty[slot]), ((it / BF_STAGES) - 1) & 1);
            const uint32_t kb = smem_u32(&k_full[slot]), vb = smem_u32(&v_full[slot]);
            mbar_expect_tx(kb, L::TILE);
#pragma unroll
            for (int a = 0; a < L::NA; ++a)
              tma_load_4d(k_u + slot * L::TILE + a * L::ATOM, &k_map, a * L::AW, j * BF_BK, h, b,
                          kb);
            mbar_expect_tx(vb, L::TILE);
#pragma unroll
            for (int a = 0; a < L::NA; ++a)
              tma_load_4d(v_u + slot * L::TILE + a * L::ATOM, &v_map, a * L::AW, j * BF_BK, h, b,
                          vb);
          }
        }
      }
    }
    return;
  }

  // Consumer warpgroup wg: rows 64 wg .. of each item's query tile.  This
  // thread's rows in the accumulator layout: s[4n + 2h + e] is row row[h],
  // key 8n + 2t + e.
  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const float c = p.scale * LOG2E;
  int it = 0, qi = 0;
  uint32_t pa[BF_BK / 16][4] = {};  // P's A fragments, one per k16 step of P.V

  // O += P.V of the tile in ring slot `slot`, left in flight.
  auto issue_pv = [&](float (&o)[L::NA][L::AW / 2], int slot, uint32_t parity) {
    mbar_wait(smem_u32(&v_full[slot]), parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BF_BK / 16; ++kk)
#pragma unroll
      for (int a = 0; a < L::NA; ++a)
        // 16 keys = 16 rows of the atom: two 8-row groups SBO apart.
        wgmma_pv(o[a], pa[kk],
                 smem_desc(v_u + slot * L::TILE + a * L::ATOM + kk * 16 * L::ROW_B, L::ATOM,
                           L::SBO, L::LAYOUT));
    wgmma_commit();
  };

  for (int w = blockIdx.x; w < p.items; w += gridDim.x) {
    const Item item = item_at(p, w);
    const int n_tiles = kv_tiles(p, item.q0, 64 * p.nc, BF_BK);
    const int row_lo = item.q0 + 64 * wg;
    const int row[2] = {row_lo + 16 * warp + g, row_lo + 16 * warp + g + 8};

    for (int i = 0; i < p.pairs; ++i) {
      const int bh = item.group * p.pairs + i;
      float o[L::NA][L::AW / 2];
#pragma unroll
      for (int a = 0; a < L::NA; ++a)
#pragma unroll
        for (int x = 0; x < L::AW / 2; ++x) o[a][x] = 0.f;
      float mr[2] = {NEG_INF, NEG_INF};  // running max of the raw scores
      float l[2] = {0.f, 0.f};           // this thread's share of the row sums
      const int qb = qi & 1;
      const uint32_t q_wg = q_u + qb * q_bytes + wg * 64 * L::ROW_B;
      if (n_tiles > 0) mbar_wait(smem_u32(&q_full[qb]), (qi >> 1) & 1);

      // Tile j: S_j = Q.K_j^T is issued, then P_{j-1}.V_{j-1}; the softmax
      // of S_j runs while that P.V is on the tensor cores, and only the
      // rescale of O and the new P wait for it.
      for (int j = 0; j < n_tiles; ++j, ++it) {
        const int slot = it % BF_STAGES;
        const int k0 = j * BF_BK;
        mbar_wait(smem_u32(&k_full[slot]), (it / BF_STAGES) & 1);

        // D / 16 k-steps; a step's 32 bytes lie in one swizzle atom.
        float s[BF_BK / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int a = kk * 16 / L::AW;
          const uint32_t off = (kk * 16 % L::AW) * 2;
          wgmma_qk(s, smem_desc(q_wg + a * p.nc * 64 * L::ROW_B + off, 16, L::SBO, L::LAYOUT),
                   smem_desc(k_u + slot * L::TILE + a * L::ATOM + off, 16, L::SBO, L::LAYOUT),
                   kk > 0);
        }
        wgmma_commit();
        if (j > 0) {
          issue_pv(o, (it - 1) % BF_STAGES, ((it - 1) / BF_STAGES) & 1);
          wgmma_wait<1>();  // S_j is done; P_{j-1}.V_{j-1} may still run
        } else {
          wgmma_wait<0>();
        }
        fence_acc(s);
        if (j == n_tiles - 1 && lane == 0) mbar_arrive(smem_u32(&q_empty[qb]));  // Q is free

        // Mask (straddling tiles only), row max, P = exp(S - m) in f32.
        if (needs_mask(p, row_lo, k0, BF_BK)) {
#pragma unroll
          for (int x = 0; x < BF_BK / 2; ++x)
            s[x] = visible(p, row[(x >> 1) & 1], k0 + 8 * (x >> 2) + 2 * t + (x & 1)) ? s[x]
                                                                                    : NEG_INF;
        }
        float mx[2] = {mr[0], mr[1]};
        float alpha[2], mc[2];
#pragma unroll
        for (int x = 0; x < BF_BK / 2; ++x) mx[(x >> 1) & 1] = fmaxf(mx[(x >> 1) & 1], s[x]);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          mx[hh] = quad_max(mx[hh]);
          alpha[hh] = fast_exp2((mr[hh] - mx[hh]) * c);
          mr[hh] = mx[hh];
          mc[hh] = mx[hh] * c;
          l[hh] *= alpha[hh];
        }
#pragma unroll
        for (int x = 0; x < BF_BK / 2; ++x) {
          s[x] = fast_exp2(fmaf(s[x], c, -mc[(x >> 1) & 1]));
          l[(x >> 1) & 1] += s[x];
        }

        // P_{j-1}.V_{j-1} done: its slot is free, O can be rescaled, P replaced.
        wgmma_wait<0>();
#pragma unroll
        for (int a = 0; a < L::NA; ++a) fence_acc(o[a]);
        fence_regs(pa);
        if (j > 0 && lane == 0) mbar_arrive(smem_u32(&empty[(it - 1) % BF_STAGES]));
#pragma unroll
        for (int a = 0; a < L::NA; ++a)
#pragma unroll
          for (int x = 0; x < L::AW / 2; ++x) o[a][x] *= alpha[(x >> 1) & 1];
        // Keys 16 kk .. of P: S tiles 2 kk (columns 2t, 2t+1) and 2 kk + 1 (+8).
#pragma unroll
        for (int kk = 0; kk < BF_BK / 16; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
      }
      if (n_tiles > 0) {
        const int last = it - 1;
        issue_pv(o, last % BF_STAGES, (last / BF_STAGES) & 1);
        wgmma_wait<0>();
#pragma unroll
        for (int a = 0; a < L::NA; ++a) fence_acc(o[a]);
        fence_regs(pa);
        if (lane == 0) mbar_arrive(smem_u32(&empty[last % BF_STAGES]));
        ++qi;
      }

      // Epilogue from the registers: o[a][4n + 2h + e] is row row[h],
      // column a AW + 8n + 2t + e.
      const long long row0 = (long long)bh * p.Sq;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        l[hh] = quad_sum(l[hh]);
        if (row[hh] >= p.Sq) continue;
        const bool dead = mr[hh] <= NEG_INF * 0.5f;
        if constexpr (PARTIALS) {
          float* orow = static_cast<float*>(p.o) + (row0 + row[hh]) * D + 2 * t;
#pragma unroll
          for (int a = 0; a < L::NA; ++a)
#pragma unroll
            for (int n = 0; n < L::AW / 8; ++n)
              *reinterpret_cast<float2*>(orow + a * L::AW + 8 * n) =
                  dead ? make_float2(0.f, 0.f)
                       : make_float2(o[a][4 * n + 2 * hh], o[a][4 * n + 2 * hh + 1]);
          if (t == 0) {
            p.m[row0 + row[hh]] = dead ? NEG_INF : mr[hh] * p.scale;
            p.l[row0 + row[hh]] = dead ? 0.f : l[hh];
          }
        } else {
          const float inv = dead ? 1.f : 1.f / l[hh];
          __nv_bfloat16* orow = static_cast<__nv_bfloat16*>(p.o) + (row0 + row[hh]) * D + 2 * t;
#pragma unroll
          for (int a = 0; a < L::NA; ++a)
#pragma unroll
            for (int n = 0; n < L::AW / 8; ++n) {
              const float a0 = dead ? 0.f : o[a][4 * n + 2 * hh] * inv;
              const float a1 = dead ? 0.f : o[a][4 * n + 2 * hh + 1] * inv;
              *reinterpret_cast<uint32_t*>(orow + a * L::AW + 8 * n) = pack_bf16(a0, a1);
            }
        }
      }
    }
  }
}

// ---------------------------------------------------------------- host ----

template <int D, bool PARTIALS>
cudaError_t launch_f32(const Params& p, int BH, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_f32<D, PARTIALS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      f32_smem_bytes<D>());
  if (attr != cudaSuccess) return attr;
  dim3 grid((p.Sq + F_BQ - 1) / F_BQ, BH / p.pairs);
  flash_fwd_f32<D, PARTIALS><<<grid, F_THREADS, f32_smem_bytes<D>(), stream>>>(p);
  return cudaGetLastError();
}

// A 4-D bf16 tensor map over one operand, (D, S, H, B) innermost first with
// the caller's byte strides; boxes of (AW, rows, 1, 1), zero fill past each
// dimension's own bound.  A dimension of size 1 is never stepped: it gets a
// stride that the encoder accepts whatever the caller's was.
bool encode_operand(EncodeTiled encode, CUtensorMap* map, const void* base, int D, int S, int H,
                    int B, long long ss, long long sh, long long sb, int aw, int rows) {
  if (H == 1) sh = ss * S;
  if (B == 1) sb = sh * H;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)aw, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                aw == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The bf16 launch's shape: consumer warpgroups per block (the q-tile is 64
// rows each) and resident blocks.
struct Plan {
  int nc, blocks;
};

// The consumer count with the least waves x warpgroups an SM holds, where
// a wave is the items the resident blocks take at once (registers, shared
// memory, threads); a tie goes to the smaller tile, whose last wave is the
// shorter.  nc = 0 on error.
// The SM count and the blocks of each consumer count (per_sm[nc]) that one
// SM holds: asked of the runtime once per instantiation (sms = 0 on error).
struct Occupancy {
  int sms, per_sm[BF_MAX_NC + 1];
};

template <int D, bool PARTIALS>
const Occupancy& occupancy() {
  static const Occupancy occ = [] {
    Occupancy o{0, {}};
    int device = 0, sms = 0;
    if (cudaGetDevice(&device) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
      return o;
    for (int nc = 1; nc <= bf_max_nc<D>(); ++nc)
      if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&o.per_sm[nc], flash_fwd_bf16<D, PARTIALS>,
                                                        128 * nc + 32, Bf<D>::smem_bytes(nc)) !=
          cudaSuccess)
        o.per_sm[nc] = 0;
    o.sms = sms;
    return o;
  }();
  return occ;
}

template <int D, bool PARTIALS>
Plan plan_bf16(int Sq, int groups) {
  Plan best{0, 0};
  const Occupancy& occ = occupancy<D, PARTIALS>();
  long long best_cost = 0;
  for (int nc = 1; occ.sms > 0 && nc <= bf_max_nc<D>(); ++nc) {
    const int per_sm = occ.per_sm[nc];
    if (per_sm < 1) continue;
    const long long items = (long long)((Sq + 64 * nc - 1) / (64 * nc)) * groups;
    const long long slots = (long long)occ.sms * per_sm;
    const long long cost = (items + slots - 1) / slots * per_sm * nc;
    if (best.nc == 0 || cost < best_cost) {
      best = {nc, (int)(items < slots ? items : slots)};
      best_cost = cost;
    }
  }
  return best;
}

template <int D, bool PARTIALS>
cudaError_t launch_bf16(Params p, int B, int BH, cudaStream_t stream) {
  using L = Bf<D>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_bf16<D, PARTIALS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::smem_bytes(bf_max_nc<D>()));
  if (attr != cudaSuccess) return attr;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  Plan plan = plan_bf16<D, PARTIALS>(p.Sq, BH / p.pairs);
  if (plan.nc == 0) return cudaErrorInvalidConfiguration;
  p.nc = plan.nc;
  p.q_tiles = (p.Sq + 64 * p.nc - 1) / (64 * p.nc);
  p.items = p.q_tiles * (BH / p.pairs);
  alignas(64) CUtensorMap q_map, k_map, v_map;
  if (!encode_operand(encode, &q_map, p.q, D, p.Sq, p.H, B, p.q_ss, p.q_sh, p.q_sb, L::AW,
                      64 * p.nc) ||
      !encode_operand(encode, &k_map, p.k, D, p.Sk, p.H, B, p.k_ss, p.k_sh, p.k_sb, L::AW, BF_BK) ||
      !encode_operand(encode, &v_map, p.v, D, p.Sk, p.H, B, p.v_ss, p.v_sh, p.v_sb, L::AW, BF_BK))
    return cudaErrorInvalidValue;
  flash_fwd_bf16<D, PARTIALS><<<plan.blocks, 128 * p.nc + 32, L::smem_bytes(p.nc), stream>>>(
      q_map, k_map, v_map, p);
  return cudaGetLastError();
}

template <bool PARTIALS>
int dispatch(const Params& p, int B, int H, int Sq, int Sk, int D, int kv_len, int is_bf16,
             void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || kv_len < 0 || kv_len > Sk || p.pairs <= 0 ||
      (B * H) % p.pairs || B * H / p.pairs > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int BH = B * H;
  cudaError_t e = cudaErrorInvalidValue;
  switch (D) {
    case 32:
      e = is_bf16 ? launch_bf16<32, PARTIALS>(p, B, BH, s) : launch_f32<32, PARTIALS>(p, BH, s);
      break;
    case 64:
      e = is_bf16 ? launch_bf16<64, PARTIALS>(p, B, BH, s) : launch_f32<64, PARTIALS>(p, BH, s);
      break;
    case 128:
      e = is_bf16 ? launch_bf16<128, PARTIALS>(p, B, BH, s) : launch_f32<128, PARTIALS>(p, BH, s);
      break;
  }
  return (int)e;
}

}  // namespace

// q, k, v: (B, H, S, D) read through the given element strides (the last
// dimension contiguous, every other stride a multiple of 16 bytes, the
// base 16-byte aligned); o: (B, H, Sq, D) contiguous.  `is_bf16` picks the
// bf16 (TMA + wgmma) or f32 (3xTF32 mma.sync) kernel.  Returns a
// cudaError_t (0 = launched).
extern "C" int kdlt_flash_attention(const void* q, const void* k, const void* v, void* o,
                                    int B, int H, int Sq, int Sk, int D,
                                    long long q_sb, long long q_sh, long long q_ss,
                                    long long k_sb, long long k_sh, long long k_ss,
                                    long long v_sb, long long v_sh, long long v_ss,
                                    int causal, int k_offset, int kv_len, int is_bf16,
                                    float scale, void* stream) {
  Params p{q, k, v, o, nullptr, nullptr, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
           H, Sq, Sk, kv_len, causal, k_offset, scale, 1, 0, 0, 0};
  return dispatch<false>(p, B, H, Sq, Sk, D, kv_len, is_bf16, stream);
}

// K3P: as kdlt_flash_attention, but writes acc (B, H, Sq, D), m and l
// (B, H, Sq), all f32 and contiguous, for either input dtype.
extern "C" int kdlt_flash_attention_partials(const void* q, const void* k, const void* v,
                                             float* acc, float* m, float* l,
                                             int B, int H, int Sq, int Sk, int D,
                                             long long q_sb, long long q_sh, long long q_ss,
                                             long long k_sb, long long k_sh, long long k_ss,
                                             long long v_sb, long long v_sh, long long v_ss,
                                             int causal, int k_offset, int kv_len, int is_bf16,
                                             float scale, void* stream) {
  Params p{q, k, v, acc, m, l, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
           H, Sq, Sk, kv_len, causal, k_offset, scale, 1, 0, 0, 0};
  return dispatch<true>(p, B, H, Sq, Sk, D, kv_len, is_bf16, stream);
}

// K3G: kdlt_flash_attention, non-causal, with `pairs` (batch, head) pairs
// per block; B*H must be a multiple of `pairs`.
extern "C" int kdlt_flash_attention_gfold(const void* q, const void* k, const void* v, void* o,
                                          int B, int H, int Sq, int Sk, int D,
                                          long long q_sb, long long q_sh, long long q_ss,
                                          long long k_sb, long long k_sh, long long k_ss,
                                          long long v_sb, long long v_sh, long long v_ss,
                                          int pairs, int is_bf16, float scale, void* stream) {
  Params p{q, k, v, o, nullptr, nullptr, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
           H, Sq, Sk, Sk, 0, 0, scale, pairs, 0, 0, 0};
  return dispatch<false>(p, B, H, Sq, Sk, D, Sk, is_bf16, stream);
}

// The query rows per block the bf16 kernel (K3, or K3G with `pairs`) takes
// for this shape on the current card; 0 on error.  For the record only.
extern "C" int kdlt_flash_attention_q_tile(int B, int H, int Sq, int D, int pairs) {
  if (B <= 0 || H <= 0 || pairs <= 0 || (B * H) % pairs) return 0;
  const int blocks = B * H / pairs;
  switch (D) {
    case 32: return 64 * plan_bf16<32, false>(Sq, blocks).nc;
    case 64: return 64 * plan_bf16<64, false>(Sq, blocks).nc;
    case 128: return 64 * plan_bf16<128, false>(Sq, blocks).nc;
    default: return 0;
  }
}

// Host microseconds per cuTensorMapEncodeTiled of one operand's 4-D map
// (the bf16 kernel encodes three a launch), averaged over `iters`; -1 on
// error.  `base`: a 16-byte aligned device pointer to (B, S, H, D) bf16.
extern "C" double kdlt_flash_map_encode_us(const void* base, int B, int S, int H, int D,
                                           int iters) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr || iters <= 0 || (D != 32 && D != 64 && D != 128)) return -1.0;
  alignas(64) CUtensorMap map;
  const auto start = std::chrono::steady_clock::now();
  for (int i = 0; i < iters; ++i)
    if (!encode_operand(encode, &map, base, D, S, H, B, (long long)H * D, D, (long long)S * H * D,
                        D < 64 ? D : 64, BF_BK))
      return -1.0;
  const std::chrono::duration<double, std::micro> took = std::chrono::steady_clock::now() - start;
  return took.count() / iters;
}
