// Flash-attention backward (K3's backward) for Hopper (sm_90a).
//
// Replaces `_flash_bwd_rule` (src/repro/nn/attention.py), the hand-written
// `custom_vjp` backward of `flash_attention_jax`, whose forward the Pallas
// kernel `flash_attention_pallas` (src/repro/kernels/flash_attention.py)
// computes on the TPU.  From the forward's inputs, its output o, its row
// statistic lse = m + log l (float32, [B, Kv, G, Sq], written by
// `flash_attention_launch` when asked) and the output's gradient dO:
//
//   δ  = rowsum(dO ∘ o)
//   p  = exp(s · scale − lse),  s = q·kᵀ, masked entries 0
//   dS = p ∘ (dO·vᵀ − δ) · scale
//   dQ = dS · k,  dK = dSᵀ · q,  dV = pᵀ · dO
//
// with dK and dV summed over the G query heads of a kv head, p rounded to
// the input dtype before dV and dS before dK and dQ, as `_flash_bwd_rule`
// casts them (`p.astype(q.dtype)`, `ds.astype(q.dtype)`; the identity in
// float32).  The mask is the JAX one: qpos >= kpos, both counted from 0
// (not bottom-right aligned when Sq != Sk); ragged tails are masked here.
// Layouts are the JAX package's: q, o, dO, dQ [B, Sq, Kv, G, H]; k, v, dK,
// dV [B, Sk, Kv, H], contiguous; dtypes float32 or bfloat16 (all five
// alike), H in {16, 32, 64, 128}.
//
// Deterministic, no atomics: the two passes JAX itself takes, plus a
// pre-pass (`delta_kernel`, one warp per query row: δ in float32
// [B, Kv, G, Sq], the lanes' partial sums folded by a fixed butterfly).  A
// fused pass would need float atomics or a [tiles, Sq, H] buffer of
// partial dQ.  Every sum runs in float32 in a fixed order and the outputs
// are written once in the input dtype, so two launches give the same bits.
//
// Bound on the card: operations.  The five products above take
// 5 · 2 · Sq · Sk · H FLOP a query head (halved under the causal mask); in
// bf16 over 989 TFLOP/s dense (float32: 67 TFLOP/s on the FMA units) that
// is above the bytes (q, k, v, o, dO, lse in; dQ, dK, dV out) over
// 3.35 TB/s at the training shapes.  The two passes compute S and dP
// twice: seven products, 1.4x the five.
//
//   bfloat16: warp-specialised `wgmma` fed by TMA (the building blocks of
//     `hopper.cuh`, shared with the forward), p and dS never leave the
//     registers.
//     `dkdv_bf16_kernel`  one CTA per (batch · kv head, kv tile of 64 rows
//       a consumer warpgroup: two warpgroups, one at H = 128 where dK and
//       dV alone take 128 registers a thread), kv tile 0 (the heaviest
//       under the causal mask) first.  The producer warp loads K and V
//       once, then streams the q and dO tiles of every (query head g,
//       64-row query tile that sees the kv tile), g outer, through a
//       2-stage ring of "full" (copy bytes) and "empty" (one arrival a
//       consumer warp) mbarriers; its lanes copy the tile's lse and δ rows
//       into the same stage.  A warpgroup computes the transposes
//       directly, Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ (`wgmma` m64n64k16, both
//       operands K-major in shared memory), forms Pᵀ = 2^(s·scale·log2 e −
//       lse·log2 e) (one FFMA ahead of `ex2`; lse and δ indexed by the
//       accumulator's column) and dSᵀ = Pᵀ ∘ (dPᵀ − δ) · scale in the
//       accumulators, rounds both to bf16 A registers and runs dV += Pᵀ·dO
//       and dK += dSᵀ·Q with dO and Q read MN-major (the transpose bit, as
//       the forward reads V).  dK and dV stay in float32 registers over
//       every g and query tile.
//     `dq_bf16_kernel`  mirrors the forward: one CTA per (batch, kv head,
//       share of at most 3 of its G query heads (2 at H = 128), 64-row
//       query tile), heaviest first; one consumer warpgroup a query head
//       holds its q and dO tiles, lse and δ, and each K/V tile (64 rows,
//       2-stage ring) is loaded once for the share.  S = Q·Kᵀ and
//       dP = dO·Vᵀ are SS `wgmma`, dS forms in registers and dQ += dS·K
//       reads the same K tile MN-major.  dQ stays in float32 registers
//       over the kv tiles up to the last that holds a visible key.
//     In both, only tiles on the diagonal or a ragged edge pay for the
//     mask, and a warpgroup waits on its own `wgmma`s (S and dP are issued
//     together; the exponentials overlap dP): the other warpgroups of the
//     CTA fill its gaps.
//   float32: CUDA-core FMAs, so no TF32.  `dkdv_kernel` (one CTA per
//     (batch · kv head, 64-row kv tile)) and `dq_kernel` (one CTA per
//     (batch · kv head · g, 64-row query tile), heaviest first) recompute
//     p and dS a 64 x 64 tile pair at a time (4 x 4 entries a thread) into
//     shared memory, then take the products from there.
//
// What the design leaves on the table: the bf16 kernels wait on each
// `wgmma` group before the next step, so a warpgroup's exponentials and
// its products never overlap each other; ping-pong scheduling of two
// warpgroups on named barriers (as FlashAttention-3 does) and issuing the
// next tile's Sᵀ ahead of this tile's dV/dK are next.  Under the causal
// mask kv tile 0 of the dK/dV pass sees every query tile and the last one
// a single tile, and a CTA's share is not balanced between them; at
// qwen3's shape (B = 1, Kv = 4, S = 2048) the pass has 128 CTAs of one
// warpgroup for 132 SMs.  The float32 path stays on the FMA rate.
#include "hopper.cuh"  // TMA, mbarriers, `wgmma` (shared with the forward)

namespace {

constexpr int kTile = 64;                 // query and kv rows a tile
constexpr int kThreads = 256;             // 16 x 16 threads, 4 x 4 entries each
constexpr int kSide = 16;
constexpr int kPer = kTile / kSide;       // 4
constexpr int kPStride = kTile + 1;       // padded rows of the p / dS tiles
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

// Shared memory of a tile kernel: four [64][H + 1] float tiles (q, dO, k,
// v), the p and dS tiles [64][65], then lse and δ of the query tile.
template <int H>
struct Smem {
  static constexpr int kStride = H + 1;   // distinct banks down a column
  static constexpr int kTileFloats = kTile * kStride;
  static constexpr int kQ = 0;
  static constexpr int kDO = kQ + kTileFloats;
  static constexpr int kK = kDO + kTileFloats;
  static constexpr int kV = kK + kTileFloats;
  static constexpr int kP = kV + kTileFloats;
  static constexpr int kDS = kP + kTile * kPStride;
  static constexpr int kLse = kDS + kTile * kPStride;
  static constexpr int kDelta = kLse + kTile;
  static constexpr int kBytes = (kDelta + kTile) * (int)sizeof(float);
};

// rows row0 .. row0 + 63 of a [rows, H] view whose rows are `stride`
// elements apart, widened to float into `dst` [64][H + 1]; rows past
// `rows` are zero
template <int H, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long stride, int row0,
                                          int rows) {
  for (int i = threadIdx.x; i < kTile * H; i += kThreads) {
    const int r = i / H, c = i % H;
    const int row = row0 + r;
    dst[r * (H + 1) + c] =
        row < rows ? to_f32(src[(long long)row * stride + c]) : 0.0f;
  }
}

// lse and δ of query rows q0 .. q0 + 63 of one head (`stat` points at its
// [Sq] row); rows past Sq read 0 and are masked anyway
__device__ __forceinline__ void load_stats(float* lse_s, float* delta_s,
                                           const float* lse,
                                           const float* delta, int q0,
                                           int sq) {
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    const int row = q0 + r;
    lse_s[r] = row < sq ? lse[row] : 0.0f;
    delta_s[r] = row < sq ? delta[row] : 0.0f;
  }
}

// p and dS of one (query tile, kv tile) pair into shared memory.  Thread
// (ty, tx) owns query rows 4·ty .. 4·ty + 3 and kv columns tx + 16·j.
template <int H>
__device__ __forceinline__ void scores(float* smem, int q0, int k0, int sq,
                                       int sk, int causal, float scale,
                                       bool want_p) {
  using L = Smem<H>;
  const float* qs = smem + L::kQ;
  const float* dos = smem + L::kDO;
  const float* ks = smem + L::kK;
  const float* vs = smem + L::kV;
  const int tx = threadIdx.x % kSide, ty = threadIdx.x / kSide;
  float s[kPer][kPer], dp[kPer][kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) s[i][j] = dp[i][j] = 0.0f;
  }
#pragma unroll 4
  for (int h = 0; h < H; ++h) {
    float qa[kPer], da[kPer], kb[kPer], vb[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      qa[i] = qs[(ty * kPer + i) * L::kStride + h];
      da[i] = dos[(ty * kPer + i) * L::kStride + h];
      kb[i] = ks[(tx + kSide * i) * L::kStride + h];
      vb[i] = vs[(tx + kSide * i) * L::kStride + h];
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
        dp[i][j] = fmaf(da[i], vb[j], dp[i][j]);
      }
    }
  }
  float* ps = smem + L::kP;
  float* dss = smem + L::kDS;
  const float* lse_s = smem + L::kLse;
  const float* delta_s = smem + L::kDelta;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int r = ty * kPer + i;
    const int qpos = q0 + r;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int c = tx + kSide * j;
      const int kpos = k0 + c;
      const bool visible =
          qpos < sq && kpos < sk && (!causal || qpos >= kpos);
      const float p = visible ? expf(s[i][j] * scale - lse_s[r]) : 0.0f;
      if (want_p) ps[r * kPStride + c] = p;
      dss[r * kPStride + c] = p * (dp[i][j] - delta_s[r]) * scale;
    }
  }
}

// δ = rowsum(dO ∘ o), one warp a row (b, q, kv, g) of [B, Sq, Kv, G, H],
// written to [B, Kv, G, Sq]
template <typename T>
__global__ void __launch_bounds__(kThreads)
    delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                 float* __restrict__ delta, int batch, int sq, int kv_heads,
                 int group, int h) {
  const long long rows = (long long)batch * sq * kv_heads * group;
  const long long row =
      (long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const T* orow = o + row * h;
  const T* drow = dout + row * h;
  float acc = 0.0f;
  for (int c = lane; c < h; c += 32) {
    acc = fmaf(to_f32(drow[c]), to_f32(orow[c]), acc);
  }
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(kFullMask, acc, off);
  }
  if (lane == 0) {
    const int heads = kv_heads * group;
    const long long b = row / ((long long)sq * heads);
    const long long rem = row % ((long long)sq * heads);
    const long long q = rem / heads, hq = rem % heads;
    delta[(b * heads + hq) * sq + q] = acc;
  }
}

// dK and dV of one kv tile of one (batch, kv head), summed over the G
// query heads and every query tile that sees it
template <int H, typename T>
__global__ void __launch_bounds__(kThreads)
    dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dk,
                T* __restrict__ dv, int sq, int sk, int kv_heads, int group,
                float scale, int causal) {
  using L = Smem<H>;
  constexpr int kCols = H / kSide;        // head-dim columns a thread
  extern __shared__ __align__(16) float smem[];
  const int k0 = blockIdx.x * kTile;
  const int b = blockIdx.y / kv_heads;
  const int kvh = blockIdx.y % kv_heads;
  const int heads = kv_heads * group;
  const long long q_stride = (long long)heads * H;      // one query row
  const long long kv_stride = (long long)kv_heads * H;  // one kv row
  const long long kv_off = (long long)b * sk * kv_stride + (long long)kvh * H;
  load_tile<H>(smem + L::kK, k + kv_off, kv_stride, k0, sk);
  load_tile<H>(smem + L::kV, v + kv_off, kv_stride, k0, sk);

  const int tx = threadIdx.x % kSide, ty = threadIdx.x / kSide;
  float acc_k[kPer][kCols], acc_v[kPer][kCols];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc_k[i][j] = acc_v[i][j] = 0.0f;
  }
  // causal: query rows before the tile's first key see none of it
  const int q_begin = causal ? k0 : 0;
  const float* ps = smem + L::kP;
  const float* dss = smem + L::kDS;
  const float* qs = smem + L::kQ;
  const float* dos = smem + L::kDO;
  for (int g = 0; g < group; ++g) {
    const int hq = kvh * group + g;
    const long long q_off = (long long)b * sq * q_stride + (long long)hq * H;
    const long long stat = ((long long)b * heads + hq) * sq;
    for (int q0 = q_begin; q0 < sq; q0 += kTile) {
      __syncthreads();        // the previous pair's tiles are consumed
      load_tile<H>(smem + L::kQ, q + q_off, q_stride, q0, sq);
      load_tile<H>(smem + L::kDO, dout + q_off, q_stride, q0, sq);
      load_stats(smem + L::kLse, smem + L::kDelta, lse + stat, delta + stat,
                 q0, sq);
      __syncthreads();
      scores<H>(smem, q0, k0, sq, sk, causal, scale, true);
      __syncthreads();
      // dV += pᵀ·dO, dK += dSᵀ·q: kv rows 4·ty + i, columns tx + 16·j
#pragma unroll 4
      for (int r = 0; r < kTile; ++r) {
        float pr[kPer], dr[kPer];
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          pr[i] = ps[r * kPStride + ty * kPer + i];
          dr[i] = dss[r * kPStride + ty * kPer + i];
        }
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const float dov = dos[r * L::kStride + tx + kSide * j];
          const float qv = qs[r * L::kStride + tx + kSide * j];
#pragma unroll
          for (int i = 0; i < kPer; ++i) {
            acc_v[i][j] = fmaf(pr[i], dov, acc_v[i][j]);
            acc_k[i][j] = fmaf(dr[i], qv, acc_k[i][j]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int row = k0 + ty * kPer + i;
    if (row >= sk) continue;
    const long long at = kv_off + (long long)row * kv_stride;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      dk[at + tx + kSide * j] = from_f32<T>(acc_k[i][j]);
      dv[at + tx + kSide * j] = from_f32<T>(acc_v[i][j]);
    }
  }
}

// dQ of one query tile of one (batch, kv head, g)
template <int H, typename T>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, int sq, int sk, int kv_heads, int group,
              float scale, int causal) {
  using L = Smem<H>;
  constexpr int kCols = H / kSide;
  extern __shared__ __align__(16) float smem[];
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;   // heaviest first
  const int heads = kv_heads * group;
  const int b = blockIdx.y / heads;
  const int hq = blockIdx.y % heads;
  const int kvh = hq / group;
  const long long q_stride = (long long)heads * H;
  const long long kv_stride = (long long)kv_heads * H;
  const long long q_off = (long long)b * sq * q_stride + (long long)hq * H;
  const long long kv_off = (long long)b * sk * kv_stride + (long long)kvh * H;
  const long long stat = ((long long)b * heads + hq) * sq;
  load_tile<H>(smem + L::kQ, q + q_off, q_stride, q0, sq);
  load_tile<H>(smem + L::kDO, dout + q_off, q_stride, q0, sq);
  load_stats(smem + L::kLse, smem + L::kDelta, lse + stat, delta + stat, q0,
             sq);

  const int tx = threadIdx.x % kSide, ty = threadIdx.x / kSide;
  float acc[kPer][kCols];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.0f;
  }
  // causal: no kv tile past the tile's last query row holds a visible key
  const int kv_end = causal ? min(sk, q0 + kTile) : sk;
  const float* dss = smem + L::kDS;
  const float* ks = smem + L::kK;
  for (int k0 = 0; k0 < kv_end; k0 += kTile) {
    __syncthreads();          // the previous tile is consumed
    load_tile<H>(smem + L::kK, k + kv_off, kv_stride, k0, sk);
    load_tile<H>(smem + L::kV, v + kv_off, kv_stride, k0, sk);
    __syncthreads();
    scores<H>(smem, q0, k0, sq, sk, causal, scale, false);
    __syncthreads();
    // dQ += dS·k: query rows 4·ty + i, columns tx + 16·j
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float dr[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        dr[i] = dss[(ty * kPer + i) * kPStride + c];
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float kv = ks[c * L::kStride + tx + kSide * j];
#pragma unroll
        for (int i = 0; i < kPer; ++i) acc[i][j] = fmaf(dr[i], kv, acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int row = q0 + ty * kPer + i;
    if (row >= sq) continue;
    const long long at = q_off + (long long)row * q_stride;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      dq[at + tx + kSide * j] = from_f32<T>(acc[i][j]);
    }
  }
}

// ----------------------------------------------------------- bfloat16 path
constexpr int kRows = 64;     // rows of a wgmma operand: kv rows of a
                              // warpgroup, query rows of a tile
constexpr int kRing = 2;      // stages of each ring

// consumer warpgroups of a dK/dV CTA, 64 kv rows each
template <int H>
__host__ __device__ constexpr int dkdv_groups() { return H == 128 ? 1 : 2; }

// query heads a dQ CTA serves at most
template <int H>
__host__ __device__ constexpr int dq_max_share() { return H == 128 ? 2 : 3; }

// Shared memory of a dK/dV CTA: its K and V tiles, the ring's query and
// dO tiles, its lse and δ rows, then the mbarriers (kv_full, full[],
// empty[]).  Every tile is a multiple of 1024 bytes, so each starts on the
// boundary the 128-byte swizzle repeats on.
template <int H>
struct DkdvSmem {
  static constexpr int kKV = dkdv_groups<H>() * kRows * H * 2;
  static constexpr int kQ = kRows * H * 2;      // a query or dO tile
  static constexpr int kVOff = kKV;
  static constexpr int kQOff = 2 * kKV;
  static constexpr int kDOOff = kQOff + kRing * kQ;
  static constexpr int kLseOff = kDOOff + kRing * kQ;
  static constexpr int kDeltaOff = kLseOff + kRing * kRows * 4;
  static constexpr int kBarOff = kDeltaOff + kRing * kRows * 4;
  static constexpr int kAlloc = kBarOff + (1 + 2 * kRing) * 8 + 1024;
};

// Shared memory of a dQ CTA serving `NC` query heads: their query and dO
// tiles, the K and V rings, then the mbarriers (q_full, kv_full[],
// empty[]).
template <int H, int NC>
struct DqSmem {
  static constexpr int kT = kRows * H * 2;      // any one tile
  static constexpr int kDOOff = NC * kT;
  static constexpr int kKOff = 2 * NC * kT;
  static constexpr int kVOff = kKOff + kRing * kT;
  static constexpr int kBarOff = kVOff + kRing * kT;
  static constexpr int kAlloc = kBarOff + (1 + 2 * kRing) * 8 + 1024;
};

// `Wgmma<64>::ss` over the head dim: d = A·Bᵀ with A and B two 64-row
// tiles in shared memory, both K-major (k16 step kk reads 32 bytes of
// each row, in box kk·16 / 64 of a tile whose boxes are `a_box` and
// `b_box` bytes apart)
template <int H>
__device__ __forceinline__ void rows_by_rows(float (&d)[32], uint32_t a,
                                             uint32_t a_box, uint32_t b,
                                             uint32_t b_box) {
  constexpr int kBoxCols = box_row_bytes<H>() / 2;
#pragma unroll
  for (int kk = 0; kk < H / 16; ++kk) {
    const int box = kk * 16 / kBoxCols, col = (kk * 16) % kBoxCols;
    Wgmma<64>::ss(d, make_desc<H>(a + box * a_box + col * 2, 1),
                  make_desc<H>(b + box * b_box + col * 2, 1), kk > 0);
  }
}

// `WgmmaRs<H>::rs` over 64 rows: d += A·B with A the bf16 registers `a`
// (k16 step kk: columns 16kk .. 16kk + 15 of a 64 x 64 accumulator) and B
// a 64-row tile in shared memory read MN-major (k16 step kk: its rows
// 16kk .. 16kk + 15; a second 64-column box lies 64 rows further)
template <int H>
__device__ __forceinline__ void times_rows(float (&d)[H / 2],
                                           const uint32_t (&a)[4][4],
                                           uint32_t b) {
  constexpr int kRow = box_row_bytes<H>();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    WgmmaRs<H>::rs(d, a[kk], make_desc<H>(b + kk * 16 * kRow,
                                          kRows * kRow / 16));
  }
}

// Accumulator chunk j (columns 8j .. 8j + 7) as bf16 A registers of k16
// step j / 2, rounded to nearest even
__device__ __forceinline__ void pack_chunk(uint32_t (&a)[4][4], int j,
                                           float x0, float x1, float x2,
                                           float x3) {
  a[j >> 1][(j & 1) * 2 + 0] = pack_rn(x0, x1);
  a[j >> 1][(j & 1) * 2 + 1] = pack_rn(x2, x3);
}

// dK and dV of one (batch, kv head, kv tile), summed over the G query
// heads and every query tile that sees it.  Warps 0 .. 4·NW - 1 are the
// consumer warpgroups (warpgroup w owns kv rows k0 + 64w ..), warp 4·NW
// the producer.  See the head of this file.
template <int H>
__global__ void __launch_bounds__(dkdv_groups<H>() * 128 + 32, 1)
    dkdv_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_do,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int sq,
                     int sk, int kv_heads, int group, float scale,
                     float scale_log2, int causal) {
  using L = DkdvSmem<H>;
  constexpr int kNW = dkdv_groups<H>();
  constexpr int kRow = box_row_bytes<H>();
  constexpr int kBoxCols = kRow / 2;
  constexpr int kBoxes = H / kBoxCols;             // 2 for H = 128
  constexpr int kKVBox = kNW * kRows * kRow;       // one box of K or V
  constexpr int kQBox = kRows * kRow;              // one box of q or dO
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  unsigned char* aligned = smem_raw + (base - smem_addr(smem_raw));
  const uint32_t kv_full = base + L::kBarOff;
  const uint32_t full = kv_full + 8;               // [kRing]
  const uint32_t empty = full + 8 * kRing;         // [kRing]

  const int k0 = blockIdx.x * kNW * kRows;         // kv tile 0 first
  const int kvh = blockIdx.y % kv_heads;
  const int b = blockIdx.y / kv_heads;
  // causal: query rows before the tile's first key see none of it
  const int q_first = causal ? k0 : 0;
  const int q_tiles = sq > q_first ? (sq - q_first + kRows - 1) / kRows : 0;
  const int n_iters = group * q_tiles;
  const int warp = threadIdx.x >> 5;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
#pragma unroll
    for (int s = 0; s < kRing; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * kNW);           // each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * kNW) {
    // -------------------------------------------------------- producer warp
    // Lane 0 issues the TMA loads.  A query tile's lse and δ rows are
    // copied by the warp's lanes, two rows each (a TMA box of a [Sq] row
    // would have to start 16-byte aligned, which Sq % 4 != 0 breaks),
    // before lane 0's arrival publishes them with the tiles.
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      mbar_expect_tx(kv_full, 2 * L::kKV);
#pragma unroll
      for (int x = 0; x < kBoxes; ++x) {
        tma_load(base + x * kKVBox, &tm_k, kv_full, x * kBoxCols, kvh, k0,
                 b);
        tma_load(base + L::kVOff + x * kKVBox, &tm_v, kv_full, x * kBoxCols,
                 kvh, k0, b);
      }
    }
    for (int it = 0; it < n_iters; ++it) {
      const int s = it % kRing;
      if (it >= kRing) mbar_wait(empty + 8 * s, ((it / kRing) - 1) & 1);
      const int g = it / q_tiles;
      const int q0 = q_first + (it % q_tiles) * kRows;
      const long long stat =
          (((long long)b * kv_heads + kvh) * group + g) * sq;
      float* lse_d = reinterpret_cast<float*>(aligned + L::kLseOff) +
                     s * kRows;
      float* delta_d = reinterpret_cast<float*>(aligned + L::kDeltaOff) +
                       s * kRows;
      for (int r = lane; r < kRows; r += 32) {    // rows past Sq: masked
        const int row = q0 + r;
        lse_d[r] = row < sq ? lse[stat + row] : 0.0f;
        delta_d[r] = row < sq ? delta[stat + row] : 0.0f;
      }
      __syncwarp();
      if (lane != 0) continue;
      const uint32_t bar = full + 8 * s;
      mbar_expect_tx(bar, 2 * L::kQ);
#pragma unroll
      for (int x = 0; x < kBoxes; ++x) {
        tma_load(base + L::kQOff + s * L::kQ + x * kQBox, &tm_q, bar,
                 x * kBoxCols, g, kvh, q0, b);
        tma_load(base + L::kDOOff + s * L::kQ + x * kQBox, &tm_do, bar,
                 x * kBoxCols, g, kvh, q0, b);
      }
    }
    return;
  }

  // ---------------------------------------------- consumer warpgroup `wg`
  const int wg = warp >> 2;
  const int lane = threadIdx.x & 31;
  const int c = lane & 3;
  const int kw = k0 + wg * kRows;                  // this warpgroup's rows
  const int krow0 = kw + (warp & 3) * 16 + (lane >> 2);   // and krow0 + 8
  const uint32_t k_base = base + wg * kRows * kRow;
  const uint32_t v_base = base + L::kVOff + wg * kRows * kRow;

  float dk_acc[H / 2], dv_acc[H / 2];
#pragma unroll
  for (int i = 0; i < H / 2; ++i) dk_acc[i] = dv_acc[i] = 0.0f;

  mbar_wait(kv_full, 0);
  for (int it = 0; it < n_iters; ++it) {
    const int s = it % kRing;
    const int q0 = q_first + (it % q_tiles) * kRows;
    mbar_wait(full + 8 * s, (it / kRing) & 1);
    // a tile wholly before this warpgroup's first key, or a warpgroup
    // wholly past Sk, adds nothing
    if (kw < sk && (!causal || q0 + kRows - 1 >= kw)) {
      const uint32_t q_s = base + L::kQOff + s * L::kQ;
      const uint32_t do_s = base + L::kDOOff + s * L::kQ;
      const float* lse_s =
          reinterpret_cast<const float*>(aligned + L::kLseOff) + s * kRows;
      const float* delta_s =
          reinterpret_cast<const float*>(aligned + L::kDeltaOff) + s * kRows;

      // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, issued together
      float st[32], dpt[32];
      __syncwarp();
      wgmma_fence();
      rows_by_rows<H>(st, k_base, kKVBox, q_s, kQBox);
      wgmma_commit();
      rows_by_rows<H>(dpt, v_base, kKVBox, do_s, kQBox);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(st);

      // Pᵀ in place: register 4j + i is kv row krow0 + 8·(i >> 1), query
      // column q0 + 8j + 2c + (i & 1)
      const bool edge = (causal && q0 < kw + kRows - 1) || q0 + kRows > sq;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l2 =
            *reinterpret_cast<const float2*>(lse_s + 8 * j + 2 * c);
        const float nl[2] = {-l2.x * kLog2e, -l2.y * kLog2e};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float p = exp2_ftz(fmaf(st[4 * j + i], scale_log2, nl[i & 1]));
          if (edge) {
            const int qpos = q0 + 8 * j + 2 * c + (i & 1);
            const int kpos = krow0 + 8 * (i >> 1);
            p = qpos < sq && (!causal || qpos >= kpos) ? p : 0.0f;
          }
          st[4 * j + i] = p;
        }
      }
      wgmma_wait<0>();
      fence_regs(dpt);

      // dSᵀ = Pᵀ ∘ (dPᵀ − δ) · scale; both rounded to bf16 A registers
      uint32_t pa[4][4], da[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 d2 =
            *reinterpret_cast<const float2*>(delta_s + 8 * j + 2 * c);
        const float d[2] = {d2.x, d2.y};
        float ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ds[i] = st[4 * j + i] * (dpt[4 * j + i] - d[i & 1]) * scale;
        }
        pack_chunk(pa, j, st[4 * j], st[4 * j + 1], st[4 * j + 2],
                   st[4 * j + 3]);
        pack_chunk(da, j, ds[0], ds[1], ds[2], ds[3]);
      }

      // dV += Pᵀ·dO, dK += dSᵀ·Q: dO and Q MN-major
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      wgmma_fence();
      times_rows<H>(dv_acc, pa, do_s);
      times_rows<H>(dk_acc, da, q_s);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);     // this warp read stage s
  }

  const long long kv_stride = (long long)kv_heads * H;  // one kv row
  const long long at = (long long)b * sk * kv_stride + (long long)kvh * H +
                       2 * c;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = krow0 + 8 * h;
    if (row >= sk) continue;
    bf16* dkr = dk + at + row * kv_stride;
    bf16* dvr = dv + at + row * kv_stride;
#pragma unroll
    for (int j = 0; j < H / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dkr + j * 8) = __floats2bfloat162_rn(
          dk_acc[4 * j + 2 * h], dk_acc[4 * j + 2 * h + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dvr + j * 8) = __floats2bfloat162_rn(
          dv_acc[4 * j + 2 * h], dv_acc[4 * j + 2 * h + 1]);
    }
  }
}

// dQ of one query tile of the heads of one share.  Warps 0 .. 4·NC - 1 are
// the consumer warpgroups (warpgroup w serves query head g0 + w), warp
// 4·NC the producer.  See the head of this file.
template <int H, int NC>
__global__ void __launch_bounds__(NC * 128 + 32, 1)
    dq_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_do,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dq,
                   int sq, int sk, int kv_heads, int group, int shares,
                   float scale, float scale_log2, int causal) {
  using L = DqSmem<H, NC>;
  constexpr int kRow = box_row_bytes<H>();
  constexpr int kBoxCols = kRow / 2;
  constexpr int kBoxes = H / kBoxCols;
  constexpr int kBox = kRows * kRow;               // one box of any tile
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_full = base + L::kBarOff;
  const uint32_t kv_full = q_full + 8;             // [kRing]
  const uint32_t empty = kv_full + 8 * kRing;      // [kRing]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;   // heaviest first
  const int share = blockIdx.y % shares;
  const int kvh = (blockIdx.y / shares) % kv_heads;
  const int b = blockIdx.y / shares / kv_heads;
  const int g0 = share * NC;
  const int heads = min(NC, group - g0);           // heads of this share
  // causal: no kv tile past the tile's last query row holds a visible key
  const int kv_end = causal ? min(sk, q0 + kRows) : sk;
  const int n_tiles = (kv_end + kRows - 1) / kRows;
  const int warp = threadIdx.x >> 5;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < kRing; ++s) {
      mbar_init(kv_full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * heads);         // each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * NC) {
    // ------------------------------------------------ producer (one lane)
    if ((threadIdx.x & 31) != 0) return;
    mbar_expect_tx(q_full, 2 * heads * L::kT);
    for (int w = 0; w < heads; ++w) {
#pragma unroll
      for (int x = 0; x < kBoxes; ++x) {
        tma_load(base + w * L::kT + x * kBox, &tm_q, q_full, x * kBoxCols,
                 g0 + w, kvh, q0, b);
        tma_load(base + L::kDOOff + w * L::kT + x * kBox, &tm_do, q_full,
                 x * kBoxCols, g0 + w, kvh, q0, b);
      }
    }
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kRing;
      if (it >= kRing) mbar_wait(empty + 8 * s, ((it / kRing) - 1) & 1);
      const uint32_t bar = kv_full + 8 * s;
      mbar_expect_tx(bar, 2 * L::kT);
#pragma unroll
      for (int x = 0; x < kBoxes; ++x) {
        tma_load(base + L::kKOff + s * L::kT + x * kBox, &tm_k, bar,
                 x * kBoxCols, kvh, it * kRows, b);
        tma_load(base + L::kVOff + s * L::kT + x * kBox, &tm_v, bar,
                 x * kBoxCols, kvh, it * kRows, b);
      }
    }
    return;
  }

  // ---------------------------------------------- consumer warpgroup `wg`
  const int wg = warp >> 2;
  if (wg >= heads) return;                         // a short last share
  const int lane = threadIdx.x & 31;
  const int c = lane & 3;
  const int head = g0 + wg;
  const int row0 = q0 + (warp & 3) * 16 + (lane >> 2);    // and row0 + 8
  const uint32_t q_base = base + wg * L::kT;
  const uint32_t do_base = base + L::kDOOff + wg * L::kT;

  // lse and δ of this thread's two rows; rows past Sq are never stored
  const long long stat =
      (((long long)b * kv_heads + kvh) * group + head) * sq;
  float nl[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    nl[h] = row < sq ? -lse[stat + row] * kLog2e : 0.0f;
    dl[h] = row < sq ? delta[stat + row] : 0.0f;
  }

  float dq_acc[H / 2];
#pragma unroll
  for (int i = 0; i < H / 2; ++i) dq_acc[i] = 0.0f;

  mbar_wait(q_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kRing;
    const int k0 = it * kRows;
    const uint32_t k_s = base + L::kKOff + s * L::kT;
    const uint32_t v_s = base + L::kVOff + s * L::kT;
    mbar_wait(kv_full + 8 * s, (it / kRing) & 1);

    // S = Q·Kᵀ and dP = dO·Vᵀ, issued together
    float sc[32], dp[32];
    __syncwarp();
    wgmma_fence();
    rows_by_rows<H>(sc, q_base, kBox, k_s, kBox);
    wgmma_commit();
    rows_by_rows<H>(dp, do_base, kBox, v_s, kBox);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(sc);

    // P in place: register 4j + i is query row row0 + 8·(i >> 1), kv
    // column k0 + 8j + 2c + (i & 1)
    const bool edge = k0 + kRows > sk || (causal && k0 + kRows - 1 > q0);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float p = exp2_ftz(fmaf(sc[4 * j + i], scale_log2, nl[i >> 1]));
        if (edge) {
          const int kpos = k0 + 8 * j + 2 * c + (i & 1);
          const int qpos = row0 + 8 * (i >> 1);
          p = kpos < sk && (!causal || qpos >= kpos) ? p : 0.0f;
        }
        sc[4 * j + i] = p;
      }
    }
    wgmma_wait<0>();
    fence_regs(dp);

    // dS = P ∘ (dP − δ) · scale, rounded to bf16 A registers
    uint32_t da[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ds[i] = sc[4 * j + i] * (dp[4 * j + i] - dl[i >> 1]) * scale;
      }
      pack_chunk(da, j, ds[0], ds[1], ds[2], ds[3]);
    }

    // dQ += dS·K: the K tile MN-major
    fence_regs(dq_acc);
    wgmma_fence();
    times_rows<H>(dq_acc, da, k_s);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq_acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);     // this warp read stage s
  }

  const long long q_stride = (long long)kv_heads * group * H;  // one row
  bf16* dqh = dq + (long long)b * sq * q_stride +
              ((long long)kvh * group + head) * H + 2 * c;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= sq) continue;
    bf16* r = dqh + row * q_stride;
#pragma unroll
    for (int j = 0; j < H / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(r + j * 8) = __floats2bfloat162_rn(
          dq_acc[4 * j + 2 * h], dq_acc[4 * j + 2 * h + 1]);
    }
  }
}

// ------------------------------------------------------------------ launch
// δ = rowsum(dO ∘ o) into `delta`
template <typename T>
cudaError_t launch_delta(const void* o, const void* dout, float* delta,
                         int h, int batch, int sq, int kv_heads, int group,
                         cudaStream_t stream) {
  const long long rows = (long long)batch * sq * kv_heads * group;
  const unsigned warps = kThreads / 32;
  delta_kernel<T><<<(unsigned)((rows + warps - 1) / warps), kThreads, 0,
                    stream>>>(static_cast<const T*>(o),
                              static_cast<const T*>(dout), delta, batch, sq,
                              kv_heads, group, h);
  return cudaGetLastError();
}

template <int H>
int launch_f32(const void* q, const void* k, const void* v, const void* o,
               const float* lse, const void* dout, float* delta, void* dq,
               void* dk, void* dv, int batch, int sq, int sk, int kv_heads,
               int group, float scale, int causal, cudaStream_t stream) {
  using T = float;
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  cudaError_t err = launch_delta<T>(o, dout, delta, H, batch, sq, kv_heads,
                                    group, stream);
  if (err != cudaSuccess) return (int)err;

  constexpr int smem = Smem<H>::kBytes;
  err = cudaFuncSetAttribute(dkdv_kernel<H, T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dq_kernel<H, T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 kv_grid((unsigned)((sk + kTile - 1) / kTile),
                     (unsigned)(batch * kv_heads));
  dkdv_kernel<H, T><<<kv_grid, kThreads, smem, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      sq, sk, kv_heads, group, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 q_grid((unsigned)((sq + kTile - 1) / kTile),
                    (unsigned)(batch * kv_heads * group));
  dq_kernel<H, T><<<q_grid, kThreads, smem, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<T*>(dq), sq, sk, kv_heads,
      group, scale, causal);
  return (int)cudaGetLastError();
}

template <int H, int NC>
int launch_dq_share(const CUtensorMap& tm_q, const CUtensorMap& tm_do,
                    const CUtensorMap& tm_k, const CUtensorMap& tm_v,
                    const float* lse, const float* delta, bf16* dq,
                    int batch, int sq, int sk, int kv_heads, int group,
                    int shares, float scale, float scale_log2, int causal,
                    cudaStream_t stream) {
  using L = DqSmem<H, NC>;
  const cudaError_t err = cudaFuncSetAttribute(
      dq_bf16_kernel<H, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kAlloc);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((sq + kRows - 1) / kRows),
                  (unsigned)(batch * kv_heads * shares));
  dq_bf16_kernel<H, NC><<<grid, NC * 128 + 32, L::kAlloc, stream>>>(
      tm_q, tm_do, tm_k, tm_v, lse, delta, dq, sq, sk, kv_heads, group,
      shares, scale, scale_log2, causal);
  return (int)cudaGetLastError();
}

template <int H>
int launch_bf16(const void* q, const void* k, const void* v, const void* o,
                const float* lse, const void* dout, float* delta, void* dq,
                void* dk, void* dv, int batch, int sq, int sk, int kv_heads,
                int group, float scale, int causal, cudaStream_t stream) {
  constexpr cuuint32_t kBoxCols = box_row_bytes<H>() / 2;
  constexpr cuuint32_t kNW = dkdv_groups<H>();
  // q, dO [B, Sq, Kv, G, H] in boxes of one head's 64 query rows; k, v
  // [B, Sk, Kv, H] in boxes of a dK/dV CTA's kv rows and of a dQ tile's;
  const cuuint64_t q_dims[5] = {H, (cuuint64_t)group, (cuuint64_t)kv_heads,
                                (cuuint64_t)sq, (cuuint64_t)batch};
  const cuuint32_t q_box[5] = {kBoxCols, 1, 1, kRows, 1};
  const cuuint64_t kv_dims[4] = {H, (cuuint64_t)kv_heads, (cuuint64_t)sk,
                                 (cuuint64_t)batch};
  const cuuint32_t kv_box[4] = {kBoxCols, 1, kNW * kRows, 1};
  const cuuint32_t tile_box[4] = {kBoxCols, 1, kRows, 1};
  CUtensorMap tm_q, tm_do, tm_k, tm_v, tm_kt, tm_vt;
  if (!encode<H>(&tm_q, q, 5, q_dims, q_box) ||
      !encode<H>(&tm_do, dout, 5, q_dims, q_box) ||
      !encode<H>(&tm_k, k, 4, kv_dims, kv_box) ||
      !encode<H>(&tm_v, v, 4, kv_dims, kv_box) ||
      !encode<H>(&tm_kt, k, 4, kv_dims, tile_box) ||
      !encode<H>(&tm_vt, v, 4, kv_dims, tile_box)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = launch_delta<bf16>(o, dout, delta, H, batch, sq,
                                       kv_heads, group, stream);
  if (err != cudaSuccess) return (int)err;

  const float scale_log2 = scale * kLog2e;
  using L = DkdvSmem<H>;
  err = cudaFuncSetAttribute(dkdv_bf16_kernel<H>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L::kAlloc);
  if (err != cudaSuccess) return (int)err;
  const dim3 kv_grid((unsigned)((sk + kNW * kRows - 1) / (kNW * kRows)),
                     (unsigned)(batch * kv_heads));
  dkdv_bf16_kernel<H><<<kv_grid, kNW * 128 + 32, L::kAlloc, stream>>>(
      tm_q, tm_do, tm_k, tm_v, lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), sq, sk, kv_heads, group, scale, scale_log2,
      causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // ceil(G / max) shares of a kv head's query heads, as even as they go
  constexpr int kMax = dq_max_share<H>();
  const int shares = (group + kMax - 1) / kMax;
  const int per_share = (group + shares - 1) / shares;
  bf16* out = static_cast<bf16*>(dq);
  if (per_share == 1) {
    return launch_dq_share<H, 1>(tm_q, tm_do, tm_kt, tm_vt, lse, delta, out,
                                 batch, sq, sk, kv_heads, group, shares,
                                 scale, scale_log2, causal, stream);
  }
  if constexpr (kMax == 3) {
    if (per_share == 3) {
      return launch_dq_share<H, 3>(tm_q, tm_do, tm_kt, tm_vt, lse, delta,
                                   out, batch, sq, sk, kv_heads, group,
                                   shares, scale, scale_log2, causal, stream);
    }
  }
  return launch_dq_share<H, 2>(tm_q, tm_do, tm_kt, tm_vt, lse, delta, out,
                               batch, sq, sk, kv_heads, group, shares, scale,
                               scale_log2, causal, stream);
}

template <int H>
int launch_dtype(int dtype, const void* q, const void* k, const void* v,
                 const void* o, const float* lse, const void* dout,
                 float* delta, void* dq, void* dk, void* dv, int batch,
                 int sq, int sk, int kv_heads, int group, float scale,
                 int causal, cudaStream_t stream) {
  if (dtype == 0) {
    return launch_f32<H>(q, k, v, o, lse, dout, delta, dq, dk, dv, batch, sq,
                         sk, kv_heads, group, scale, causal, stream);
  }
  return launch_bf16<H>(q, k, v, o, lse, dout, delta, dq, dk, dv, batch, sq,
                        sk, kv_heads, group, scale, causal, stream);
}

}  // namespace

// Launches the three kernels on `stream` in order (δ, dK/dV, dQ); returns
// the first cudaError_t as an int (0 = launched).  `dtype` is 0 = float32,
// 1 = bfloat16; `head_dim` one of 16, 32, 64, 128.  The caller allocates
// `delta` (float32 [B, Kv, G, Sq], scratch), dq (q's shape and dtype), dk
// and dv (k's), and checks shapes, types, devices, contiguity and, for the
// bf16 TMA maps, 16-byte aligned q, k, v and dout.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const float* lse, const void* dout, float* delta, void* dq, void* dk,
    void* dv, int batch, int sq, int sk, int kv_heads, int group,
    int head_dim, int dtype, int causal, float scale, void* stream) {
  if (batch <= 0 || sq <= 0 || sk <= 0 || kv_heads <= 0 || group <= 0 ||
      (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16:
      return launch_dtype<16>(dtype, q, k, v, o, lse, dout, delta, dq, dk, dv,
                              batch, sq, sk, kv_heads, group, scale, causal,
                              s);
    case 32:
      return launch_dtype<32>(dtype, q, k, v, o, lse, dout, delta, dq, dk, dv,
                              batch, sq, sk, kv_heads, group, scale, causal,
                              s);
    case 64:
      return launch_dtype<64>(dtype, q, k, v, o, lse, dout, delta, dq, dk, dv,
                              batch, sq, sk, kv_heads, group, scale, causal,
                              s);
    case 128:
      return launch_dtype<128>(dtype, q, k, v, o, lse, dout, delta, dq, dk,
                               dv, batch, sq, sk, kv_heads, group, scale,
                               causal, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
