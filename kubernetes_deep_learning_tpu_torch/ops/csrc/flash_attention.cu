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
// What bounds it on the card: at ViT-B/16-384, batch 16 (B*H = 192,
// S = 576, D = 64) one call moves 56.6 MB (q, k, v, o in bf16) and does
// 16.3 GFLOP of bf16 products and 63.7 M exponentials: ~17 us of HBM
// traffic, ~16.5 us of tensor-core work and about as much SFU work -- all
// three are close, so neither bytes nor FLOPs alone bound it.
//
// What this design does about it (first, simple version):
//   * bf16: FlashAttention-2 layout on mma.sync m16n8k16 (bf16 in, f32
//     accumulate).  A block of 4 warps owns 64 query rows (16 per warp, in
//     registers as A fragments for the whole loop) and streams 64-key K/V
//     tiles through shared memory.  Scores, softmax statistics and the
//     output accumulator never leave registers: the S accumulator fragment
//     is re-packed as P's A fragment for the P.V product, so the (S, S)
//     score matrix touches neither device nor shared memory;
//   * f32: plain FMA, since f32 has no tensor-core form that keeps exact
//     f32 products.  A warp owns 4 query rows; lane j scores key j of a
//     32-key tile, and the lanes split D for the P.V product;
//   * q, k, v are read through (batch, head, seq) strides, so the callers'
//     (B, S, H, D) projections need no transpose; ragged lengths and
//     Sq != Sk are masked by bounds (zero-filled tiles), no padded copy;
//   * under `causal` the KV loop stops at the diagonal tile; tiles past
//     kv_len are never loaded.
// Known costs left for later work: K/V loads are not pipelined (no
// cp.async / TMA double buffering), mma.sync instead of wgmma, V's B
// fragments are gathered 16 bits at a time instead of with ldmatrix.trans.
// K3P is a template flag on the epilogue (PARTIALS), so both forms share
// the loop and its numerics.  On the ViT-B/16 training path (batch 32:
// B*H = 384, S = 256, D = 64) one f32 call reads 75.5 MB of q, k, v and
// writes 25.2 MB of acc and 0.8 MB of m and l (~30 us of HBM traffic),
// but its 6.4 GFLOP of products take ~96 us at the 67 TFLOP/s FMA rate:
// the f32 form is bound by operations, the bf16 form (63.7 MB, ~19 us) by
// bytes.
//
// K3G replaces flash_gfold of exp/vit_attn_variants.py (pallas_call at
// :121): non-causal attention with g (batch, head) pairs per grid step,
// which cut the TPU's fixed per-step cost g-fold at D = 64.  Here it is
// K3's loop run for `pairs` pairs in turn by one block, over a grid of
// (q-tiles, B*H / pairs); same numerics, same plain version
// (flash_attention_reference), wrapper flash_gfold in ../attention.py.
// A block is cheap to schedule on the card, so folding only cuts the
// blocks in flight: on an H100 at E5's shape (32, 12, 256, 64) bf16,
// g = 4 takes ~1.15x and g = 8 ~1.8x the time of g = 1 (chip_smoke.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
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

// ---------------------------------------------------------------- bf16 ----

constexpr int BF_THREADS = 128;  // 4 warps x 16 query rows
constexpr int BF_BQ = 64;
constexpr int BF_BK = 64;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two bf16 values as one register, the first in the low half.
__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return uint32_t(__bfloat16_as_ushort(lo)) | (uint32_t(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Rows [r0, r0 + ROWS) of a (seq, D) bf16 slab with row stride `ss` into
// shared memory with row stride LD; rows at or past `limit` become zeros.
template <int D, int ROWS, int LD, int THREADS>
__device__ __forceinline__ void load_rows_bf16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                               long long ss, int r0, int limit) {
  constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < ROWS * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, c = i % CHUNKS;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < limit) val = *reinterpret_cast<const uint4*>(src + (r0 + r) * ss + c * 8);
    *reinterpret_cast<uint4*>(dst + r * LD + c * 8) = val;
  }
}

// One (batch, head) pair `bh` for the query tile of blockIdx.x.
template <int D, bool PARTIALS>
__device__ __forceinline__ void flash_pair_bf16(const Params& p, int bh) {
  constexpr int LD = D + 8;  // padded rows: fragment loads hit 32 distinct banks
  static_assert(BF_BQ == BF_BK, "the Q tile is staged through the K buffer");
  __shared__ __align__(16) __nv_bfloat16 Ks[BF_BK * LD];
  __shared__ __align__(16) __nv_bfloat16 Vs[BF_BK * LD];

  const int b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.x * BF_BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group, column pair
  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + h * p.v_sh;

  // This warp's 16 query rows as A fragments, kept for the whole loop.
  load_rows_bf16<D, BF_BQ, LD, BF_THREADS>(Ks, qg, p.q_ss, q0, p.Sq);
  __syncthreads();
  const int r0 = warp * 16 + g;
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    qf[kk][0] = ld32(&Ks[r0 * LD + kk * 16 + 2 * t]);
    qf[kk][1] = ld32(&Ks[(r0 + 8) * LD + kk * 16 + 2 * t]);
    qf[kk][2] = ld32(&Ks[r0 * LD + kk * 16 + 8 + 2 * t]);
    qf[kk][3] = ld32(&Ks[(r0 + 8) * LD + kk * 16 + 8 + 2 * t]);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};  // rows g and g + 8 of the warp's 16
  float l[2] = {0.f, 0.f};          // this thread's share of the row sums
  const int row[2] = {q0 + r0, q0 + r0 + 8};

  const int n_tiles = kv_tiles(p, q0, BF_BQ, BF_BK);
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BF_BK;
    __syncthreads();  // every warp is done with the previous tile (or Q)
    load_rows_bf16<D, BF_BK, LD, BF_THREADS>(Ks, kg, p.k_ss, k0, p.Sk);
    load_rows_bf16<D, BF_BK, LD, BF_THREADS>(Vs, vg, p.v_ss, k0, p.Sk);
    __syncthreads();

    // S = Q.K^T for 16 rows x 64 keys: 8 accumulator tiles of 16 x 8.
    float s[BF_BK / 8][4];
#pragma unroll
    for (int n = 0; n < BF_BK / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const __nv_bfloat16* krow = &Ks[(n * 8 + g) * LD + 2 * t];
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_bf16(s[n], qf[kk], ld32(krow + kk * 16), ld32(krow + kk * 16 + 8));
    }

    // Scale, mask, and the tile's row max (a row's 64 columns are spread
    // over the 4 threads of a quad).
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < BF_BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, col = k0 + n * 8 + 2 * t + (e & 1);
        const float x = visible(p, row[r], col) ? s[n][e] * p.scale : NEG_INF;
        s[n][e] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
      const float alpha = __expf(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[n][2 * r] *= alpha;
        acc[n][2 * r + 1] *= alpha;
      }
    }

    // P = exp(S - m) in f32, summed in f32, cast to bf16: two adjacent
    // 16x8 accumulator tiles form one 16x16 A fragment of P.
#pragma unroll
    for (int kk = 0; kk < BF_BK / 16; ++kk) {
      uint32_t pa[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float* sn = s[2 * kk + half];
        const float p0 = __expf(sn[0] - m[0]), p1 = __expf(sn[1] - m[0]);
        const float p2 = __expf(sn[2] - m[1]), p3 = __expf(sn[3] - m[1]);
        l[0] += p0 + p1;
        l[1] += p2 + p3;
        pa[2 * half] = pack_f32(p0, p1);
        pa[2 * half + 1] = pack_f32(p2, p3);
      }
      // O += P.V: the B fragment holds keys (2t, 2t+1) and (2t+8, 2t+9) of
      // this 16-key step at head-dim column g of each 8-wide tile.
      const __nv_bfloat16* vk = &Vs[(kk * 16 + 2 * t) * LD + g];
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const __nv_bfloat16* vc = vk + n * 8;
        mma_bf16(acc[n], pa, pack2(vc[0], vc[LD]), pack2(vc[8 * LD], vc[9 * LD]));
      }
    }
  }

  const long long row0 = (long long)bh * p.Sq;  // this (batch, head)'s first row
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(FULL, l[r], 1);
    l[r] += __shfl_xor_sync(FULL, l[r], 2);
    if (row[r] >= p.Sq) continue;
    const bool dead = m[r] <= NEG_INF * 0.5f;
    if constexpr (PARTIALS) {
      // Raw (acc, m, l) in f32 (_flash_kernel_partials :224-226); a row
      // that saw no visible key is (0, NEG_INF, 0).
      float2* arow = reinterpret_cast<float2*>(static_cast<float*>(p.o) +
                                               (row0 + row[r]) * D + 2 * t);
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        arow[n * 4] = dead ? make_float2(0.f, 0.f)
                           : make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
      if (t == 0) {
        p.m[row0 + row[r]] = dead ? NEG_INF : m[r];
        p.l[row0 + row[r]] = dead ? 0.f : l[r];
      }
    } else {
      // Normalise; a row that saw no visible key is 0 (_flash_kernel :206-212).
      const float denom = dead ? 1.f : l[r];
      uint32_t* orow = reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(p.o) +
                                                   (row0 + row[r]) * D + 2 * t);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const float a0 = dead ? 0.f : acc[n][2 * r] / denom;
        const float a1 = dead ? 0.f : acc[n][2 * r + 1] / denom;
        orow[n * 4] = pack_f32(a0, a1);
      }
    }
  }
}

// ----------------------------------------------------------------- f32 ----

constexpr int F_THREADS = 128;   // 4 warps
constexpr int F_ROWS = 4;        // query rows per warp
constexpr int F_BQ = 4 * F_ROWS;
constexpr int F_BK = 32;         // one key per lane

template <int D, bool PARTIALS>
__device__ __forceinline__ void flash_pair_f32(const Params& p, int bh) {
  constexpr int C = D / 32;  // head-dim columns per lane in the P.V product
  __shared__ __align__(16) float Qs[F_BQ][D];
  __shared__ __align__(16) float Ks[F_BK][D + 1];  // padded: lane j reads row j
  __shared__ __align__(16) float Vs[F_BK][D];

  const int b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.x * F_BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;

  constexpr int CHUNKS = D / 4;  // float4 per row
  for (int i = threadIdx.x; i < F_BQ * CHUNKS; i += F_THREADS) {
    const int r = i / CHUNKS, c = i % CHUNKS;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < p.Sq) val = *reinterpret_cast<const float4*>(qg + (q0 + r) * p.q_ss + c * 4);
    *reinterpret_cast<float4*>(&Qs[r][c * 4]) = val;
  }

  float acc[F_ROWS][C], m[F_ROWS], l[F_ROWS];
#pragma unroll
  for (int i = 0; i < F_ROWS; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.f;
  }

  const int n_tiles = kv_tiles(p, q0, F_BQ, F_BK);
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * F_BK;
    __syncthreads();
    for (int i = threadIdx.x; i < F_BK * CHUNKS; i += F_THREADS) {
      const int r = i / CHUNKS, c = i % CHUNKS;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (k0 + r < p.Sk) {
        kv = *reinterpret_cast<const float4*>(kg + (k0 + r) * p.k_ss + c * 4);
        vv = *reinterpret_cast<const float4*>(vg + (k0 + r) * p.v_ss + c * 4);
      }
      Ks[r][c * 4] = kv.x;
      Ks[r][c * 4 + 1] = kv.y;
      Ks[r][c * 4 + 2] = kv.z;
      Ks[r][c * 4 + 3] = kv.w;
      *reinterpret_cast<float4*>(&Vs[r][c * 4]) = vv;
    }
    __syncthreads();

    const int col = k0 + lane;
#pragma unroll
    for (int i = 0; i < F_ROWS; ++i) {
      const int rl = warp * F_ROWS + i;
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) s = fmaf(Qs[rl][d], Ks[lane][d], s);
      s = visible(p, q0 + rl, col) ? s * p.scale : NEG_INF;
      float mx = s;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float pj = expf(s - m_new);
      const float alpha = expf(m[i] - m_new);
      float sum = pj;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(FULL, sum, o);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[i][c] *= alpha;
#pragma unroll 8
      for (int jj = 0; jj < F_BK; ++jj) {
        const float pb = __shfl_sync(FULL, pj, jj);
#pragma unroll
        for (int c = 0; c < C; ++c) acc[i][c] = fmaf(pb, Vs[jj][c * 32 + lane], acc[i][c]);
      }
    }
  }

  const long long row0 = (long long)bh * p.Sq;
  float* og = static_cast<float*>(p.o) + row0 * D;
#pragma unroll
  for (int i = 0; i < F_ROWS; ++i) {
    const int row = q0 + warp * F_ROWS + i;
    if (row >= p.Sq) continue;
    const bool dead = m[i] <= NEG_INF * 0.5f;
#pragma unroll
    for (int c = 0; c < C; ++c)
      og[(long long)row * D + c * 32 + lane] =
          dead ? 0.f : (PARTIALS ? acc[i][c] : acc[i][c] / l[i]);
    if (PARTIALS && lane == 0) {
      p.m[row0 + row] = dead ? NEG_INF : m[i];
      p.l[row0 + row] = dead ? 0.f : l[i];
    }
  }
}

// K3/K3P (p.pairs == 1) and K3G: each block walks p.pairs (batch, head)
// pairs for one query tile, so the grid is (q-tiles, B*H / p.pairs).
template <int D, bool PARTIALS>
__global__ void __launch_bounds__(BF_THREADS) flash_fwd_bf16(Params p) {
  for (int i = 0; i < p.pairs; ++i) {
    if (i) __syncthreads();  // every warp is done with the last pair's shared tiles
    flash_pair_bf16<D, PARTIALS>(p, blockIdx.y * p.pairs + i);
  }
}

template <int D, bool PARTIALS>
__global__ void __launch_bounds__(F_THREADS) flash_fwd_f32(Params p) {
  for (int i = 0; i < p.pairs; ++i) {
    if (i) __syncthreads();
    flash_pair_f32<D, PARTIALS>(p, blockIdx.y * p.pairs + i);
  }
}

template <int D, bool PARTIALS>
cudaError_t launch(const Params& p, int BH, bool bf16, cudaStream_t stream) {
  if (bf16) {
    dim3 grid((p.Sq + BF_BQ - 1) / BF_BQ, BH / p.pairs);
    flash_fwd_bf16<D, PARTIALS><<<grid, BF_THREADS, 0, stream>>>(p);
  } else {
    dim3 grid((p.Sq + F_BQ - 1) / F_BQ, BH / p.pairs);
    flash_fwd_f32<D, PARTIALS><<<grid, F_THREADS, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

template <bool PARTIALS>
int dispatch(const Params& p, int B, int H, int Sq, int Sk, int D, int kv_len, int is_bf16,
             void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || kv_len < 0 || kv_len > Sk || p.pairs <= 0 ||
      (B * H) % p.pairs || B * H / p.pairs > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return (int)launch<32, PARTIALS>(p, B * H, is_bf16 != 0, s);
    case 64: return (int)launch<64, PARTIALS>(p, B * H, is_bf16 != 0, s);
    case 128: return (int)launch<128, PARTIALS>(p, B * H, is_bf16 != 0, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v: (B, H, S, D) read through the given element strides (the last
// dimension contiguous, rows 16-byte aligned); o: (B, H, Sq, D) contiguous.
// `is_bf16` picks the bf16 (tensor-core) or f32 (FMA) kernel.  Returns a
// cudaError_t (0 = launched).
extern "C" int kdlt_flash_attention(const void* q, const void* k, const void* v, void* o,
                                    int B, int H, int Sq, int Sk, int D,
                                    long long q_sb, long long q_sh, long long q_ss,
                                    long long k_sb, long long k_sh, long long k_ss,
                                    long long v_sb, long long v_sh, long long v_ss,
                                    int causal, int k_offset, int kv_len, int is_bf16,
                                    float scale, void* stream) {
  Params p{q, k, v, o, nullptr, nullptr, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
           H, Sq, Sk, kv_len, causal, k_offset, scale, 1};
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
           H, Sq, Sk, kv_len, causal, k_offset, scale, 1};
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
           H, Sq, Sk, Sk, 0, 0, scale, pairs};
  return dispatch<false>(p, B, H, Sq, Sk, D, Sk, is_bf16, stream);
}
