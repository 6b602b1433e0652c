// Flash-attention forward (blocked online softmax) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention.py, body `_kernel`) and its GQA
// wrapper `flash_attention` (src/repro/kernels/ops.py).  For every query
// row it computes the same function,
//
//   o = softmax(q·kᵀ / √H) · v,   causal mask qpos >= kpos (both from 0),
//
// with running m, l and acc in float32, p = exp(s − m) rounded to the
// input dtype before p·V (as `p.astype(v.dtype)` does on the TPU) while l
// sums the unrounded p, and o = acc / max(l, 1e-30) stored in the input
// dtype.  Masked scores are -1e30, not -inf, as in the TPU kernel.
//
// Layouts are the JAX package's: q and o [B, Sq, Kv, G, H], k and v
// [B, Sk, Kv, H], contiguous.  Query head (kv, g) reads kv head `kv` in
// place: the wrapper's broadcast copy of k/v (ops.py) is gone.  Any Sq and
// Sk: a ragged tail is masked here, not padded by the caller.
//
// Both kernels loop over kv tiles in place of the TPU's sequential grid
// axis; under the causal mask the loop stops at the last tile that holds a
// visible key of the CTA's query rows, as `pl.when(run)` skips the rest,
// and the heaviest query tiles are launched first.  The loop starts at the
// tile that holds key 0, so every row sees a visible key in its first
// tile and the finite -1e30 mask needs no -inf case.  Sums run in a fixed
// order, so two launches give the same bits.
//
// Given a float32 `lse` [B, Kv, G, Sq] (null when serving, which then
// writes nothing extra), both kernels store each query row's statistic
// lse = m + log l of the scaled scores there, after the loop: what the
// backward (`csrc/flash_attention_bwd.cu`) recomputes p from, in place of
// the JAX backward's saved (m, l).
//
// Bound on the card: operations.  4·Sq·Sk·H FLOP per head (halved under
// the causal mask) against 989 TFLOP/s bf16 dense (67 TFLOP/s float32);
// the bytes (q, k, v and o once each) take less time at 3.35 TB/s for
// every shape the LM path gives it.
//
//   bfloat16 (`flash_attention_bf16_wgmma_kernel`): warp-specialised
//     `wgmma` with TMA.  One CTA per (batch, kv head, share of its G query
//     heads, 64-row query tile): the G heads of a kv head are split into
//     ceil(G / 3) shares of at most 3, and a CTA loads each K/V tile once
//     for all heads of its share (G = 3, smollm-135m: once for the three).
//     One producer warp issues TMA loads: the share's query tiles once,
//     then K and V tiles into a 2-stage ring, each stage with a "full"
//     mbarrier per operand (completed by the copy's bytes) and an "empty"
//     one (an arrival from each consumer warp once its `wgmma`s have read
//     the stage).  One consumer warpgroup per query head of the share
//     holds its 64 rows: S = Q·Kᵀ is `wgmma.m64nNk16` with both operands
//     in shared memory (K-major); the S accumulators, masked and
//     exponentiated in place (the scale folded into one FFMA ahead of
//     `ex2`), are rounded to bf16 as the A registers of O += P·V, whose
//     B operand is the V tile in shared memory, MN-major (the transpose
//     bit).  Tiles are swizzled by the TMA to the width of their rows
//     (32, 64 or 128 bytes: H = 16, 32, 64; H = 128 as two 64-column
//     boxes) and the `wgmma` descriptors name the same swizzle.  kv tiles
//     are 128 rows (64 at H = 128, where O takes 64 registers a thread).
//     A warpgroup waits on its own `wgmma`s before each softmax and each
//     next tile; only the other warpgroups of the CTA (one CTA an SM: the
//     registers are counted in whole warpgroups) fill those gaps.  Issuing
//     S of tile j + 1 ahead of P·V of tile j, with or without warpgroups
//     taking turns on named barriers, measured slower on the H100 than
//     this simple order; so did a third ring stage.  The output is stored
//     from registers, not by TMA.
//   float32: CUDA-core FMAs, so no TF32.  One CTA per (b·kv·g head,
//     64-row query tile), 64-row K/V tiles staged through shared memory;
//     8 warps of 8 query rows, tiles in float32; lane j owns kv columns j,
//     j+32 of the scores (K rows padded to H+1 floats for distinct banks)
//     and output dims j, j+32, ...
#include "hopper.cuh"  // TMA, mbarriers, `wgmma` (shared with the backward)

namespace {

constexpr int kBlockQ = 64;                     // query rows per CTA
constexpr int kBlockK = 64;                     // kv rows per tile (f32)
constexpr float kNegInf = -1e30f;               // the TPU kernel's NEG_INF
constexpr unsigned kFullMask = 0xffffffffu;


// ------------------------------------------------------------ float32 path
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerWarp = kBlockQ / kWarps;  // 8
constexpr int kColsPerLane = kBlockK / 32;      // 2

__device__ __forceinline__ float warp_max(float x) {
  // butterfly: every lane ends with the same value (max and + commute)
  for (int off = 16; off > 0; off >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(kFullMask, x, off));
  }
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) {
    x += __shfl_xor_sync(kFullMask, x, off);
  }
  return x;
}

template <int H>
constexpr int f32_smem_bytes() {
  return (kBlockQ * H + kBlockK * (H + 1) + kBlockK * H +
          kWarps * kRowsPerWarp * kBlockK) * (int)sizeof(float);
}

template <int H>
__global__ void __launch_bounds__(kThreads)
    flash_attention_f32_kernel(const float* __restrict__ q,
                               const float* __restrict__ k,
                               const float* __restrict__ v,
                               float* __restrict__ o,
                               float* __restrict__ lse, int sq, int sk,
                               int kv_heads, int group, float scale,
                               int causal) {
  constexpr int kDimsPerLane = (H + 31) / 32;
  constexpr int kStrideK = H + 1;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                        // [kBlockQ][H]
  float* ks = qs + kBlockQ * H;            // [kBlockK][H + 1]
  float* vs = ks + kBlockK * kStrideK;     // [kBlockK][H]
  float* ps = vs + kBlockK * H;            // [kWarps][kRowsPerWarp][kBlockK]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int heads = kv_heads * group;
  const int head = blockIdx.y;             // b * heads + kv * group + g
  const int b = head / heads;
  const int hq = head % heads;             // kv * group + g
  const int kvh = hq / group;
  // heaviest causal tiles first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockQ;

  const long long q_stride = (long long)heads * H;     // one query row
  const long long kv_stride = (long long)kv_heads * H; // one kv row
  const float* qh = q + (long long)b * sq * q_stride + (long long)hq * H;
  const float* kh = k + (long long)b * sk * kv_stride + (long long)kvh * H;
  const float* vh = v + (long long)b * sk * kv_stride + (long long)kvh * H;
  float* oh = o + (long long)b * sq * q_stride + (long long)hq * H;

  for (int i = tid; i < kBlockQ * H; i += kThreads) {
    const int r = i / H, c = i % H;
    const int row = q0 + r;
    qs[i] = row < sq ? qh[row * q_stride + c] : 0.0f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp];
  float acc[kRowsPerWarp][kDimsPerLane];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int d = 0; d < kDimsPerLane; ++d) acc[r][d] = 0.0f;
  }

  const float* qw = qs + warp * kRowsPerWarp * H;
  float* pw = ps + warp * kRowsPerWarp * kBlockK;
  const int row0 = q0 + warp * kRowsPerWarp;
  // causal: no tile past the last query row of this CTA holds a visible key
  const int kv_end = causal ? min(sk, q0 + kBlockQ) : sk;

  for (int k0 = 0; k0 < kv_end; k0 += kBlockK) {
    __syncthreads();  // the previous tile is consumed (and qs is written)
    for (int i = tid; i < kBlockK * H; i += kThreads) {
      const int r = i / H, c = i % H;
      const int row = k0 + r;
      float kx = 0.0f, vx = 0.0f;
      if (row < sk) {
        kx = kh[row * kv_stride + c];
        vx = vh[row * kv_stride + c];
      }
      ks[r * kStrideK + c] = kx;
      vs[r * H + c] = vx;
    }
    __syncthreads();

    // s = q · kᵀ for this warp's rows and this lane's columns
    float s[kRowsPerWarp][kColsPerLane];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) s[r][j] = 0.0f;
    }
#pragma unroll 2
    for (int h = 0; h < H; h += 4) {
      float kc[4][kColsPerLane];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
#pragma unroll
        for (int j = 0; j < kColsPerLane; ++j) {
          kc[t][j] = ks[(lane + 32 * j) * kStrideK + h + t];
        }
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(qw + r * H + h);
#pragma unroll
        for (int j = 0; j < kColsPerLane; ++j) {
          float a = s[r][j];
          a = fmaf(qv.x, kc[0][j], a);
          a = fmaf(qv.y, kc[1][j], a);
          a = fmaf(qv.z, kc[2][j], a);
          a = fmaf(qv.w, kc[3][j], a);
          s[r][j] = a;
        }
      }
    }

    // mask, online softmax; p goes to this warp's rows of ps
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int qpos = row0 + r;
      float tile_max = kNegInf;
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) {
        const int kpos = k0 + lane + 32 * j;
        float x = s[r][j] * scale;
        const bool visible = kpos < sk && (!causal || qpos >= kpos);
        x = visible ? x : kNegInf;
        s[r][j] = x;
        tile_max = fmaxf(tile_max, x);
      }
      tile_max = warp_max(tile_max);
      const float m_new = fmaxf(m[r], tile_max);
      const float corr = expf(m[r] - m_new);
      float psum = 0.0f;
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) {
        const float p = expf(s[r][j] - m_new);
        psum += p;
        pw[r * kBlockK + lane + 32 * j] = p;
      }
      psum = warp_sum(psum);
      l[r] = l[r] * corr + psum;
      m[r] = m_new;
#pragma unroll
      for (int d = 0; d < kDimsPerLane; ++d) acc[r][d] *= corr;
    }
    __syncwarp();

    // acc += p · v, lane owns dims lane + 32·d
#pragma unroll 2
    for (int c = 0; c < kBlockK; c += 4) {
      float vv[4][kDimsPerLane];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
#pragma unroll
        for (int d = 0; d < kDimsPerLane; ++d) {
          const int col = lane + 32 * d;
          vv[t][d] = col < H ? vs[(c + t) * H + col] : 0.0f;
        }
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 p = *reinterpret_cast<const float4*>(pw + r * kBlockK + c);
#pragma unroll
        for (int d = 0; d < kDimsPerLane; ++d) {
          float a = acc[r][d];
          a = fmaf(p.x, vv[0][d], a);
          a = fmaf(p.y, vv[1][d], a);
          a = fmaf(p.z, vv[2][d], a);
          a = fmaf(p.w, vv[3][d], a);
          acc[r][d] = a;
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = row0 + r;
    if (row >= sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int d = 0; d < kDimsPerLane; ++d) {
      const int col = lane + 32 * d;
      if (col < H) oh[row * q_stride + col] = acc[r][d] / denom;
    }
    // m and l are the same in every lane (butterfly reductions)
    if (lse != nullptr && lane == 0) {
      lse[((long long)b * heads + hq) * sq + row] = m[r] + logf(denom);
    }
  }
}


// ----------------------------------------------------------- bfloat16 path
constexpr int kStages = 2;              // depth of the K/V ring
constexpr int kMaxShare = 3;            // query heads a CTA serves at most
constexpr float kLn2 = 0.6931471805599453f;

// kv rows a tile: 128 while O leaves the registers for a 64 x 128 S
template <int H>
__host__ __device__ constexpr int kv_tile() { return H <= 64 ? 128 : 64; }

// Shared memory of a CTA serving `NC` query heads: their query tiles, the
// K and V rings, then the mbarriers (q_full, k_full[], v_full[], empty[]).
// Every tile is a multiple of 1024 bytes, so each starts on the boundary
// the 128-byte swizzle repeats on.
template <int H, int NC>
struct Smem {
  static constexpr int kN = kv_tile<H>();
  static constexpr int kQ = kBlockQ * H * 2;    // one head's query tile
  static constexpr int kKV = kN * H * 2;        // one K or V tile
  static constexpr int kKOff = NC * kQ;
  static constexpr int kVOff = kKOff + kStages * kKV;
  static constexpr int kBarOff = kVOff + kStages * kKV;
  static constexpr int kAlloc = kBarOff + (1 + 3 * kStages) * 8 + 1024;
};

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFullMask, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFullMask, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFullMask, x, 1);
  return x + __shfl_xor_sync(kFullMask, x, 2);
}

// Online softmax of one tile's raw scores `sc` (accumulator layout of
// rows row0 and row0 + 8, kv positions from k0): masks them, updates the
// row maxima m and sums l, sets corr to the factor that rescales O to the
// new maxima, and writes p = exp(scale·s − m), as 2^x of one FFMA, rounded
// to bf16 into the A registers of P·V (score columns 16q .. 16q + 15,
// accumulator chunks 2q and 2q + 1, make k16 step q).  l sums p unrounded,
// in a fixed order.  The scale is positive, so maxima of raw and scaled
// scores agree.  Each p is packed as soon as it is made, so the scores'
// registers free as the packed ones fill.
template <int kN>
__device__ __forceinline__ void online_softmax(
    float (&sc)[kN / 2], uint32_t (&pa)[kN / 16][4], float (&m)[2],
    float (&l)[2], float (&corr)[2], int k0, int row0, int c, int q0, int sk,
    int causal, float scale_log2) {
  // only a tile past Sk or, causal, past the CTA's first query row masks
  if (k0 + kN > sk || (causal && k0 + kN - 1 > q0)) {
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kpos = k0 + j * 8 + 2 * c + (i & 1);
        const int qpos = row0 + 8 * (i >> 1);
        const bool visible = kpos < sk && (!causal || qpos >= kpos);
        sc[4 * j + i] = visible ? sc[4 * j + i] : kNegInf;
      }
    }
  }
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < kN / 8; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) mx[i >> 1] = fmaxf(mx[i >> 1], sc[4 * j + i]);
  }
  float neg_m[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float m_new = fmaxf(m[h], quad_max(mx[h]));
    corr[h] = exp2_ftz((m[h] - m_new) * scale_log2);
    neg_m[h] = -m_new * scale_log2;
    m[h] = m_new;
  }
  float psum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < kN / 8; ++j) {
    const float p0 = exp2_ftz(fmaf(sc[4 * j + 0], scale_log2, neg_m[0]));
    const float p1 = exp2_ftz(fmaf(sc[4 * j + 1], scale_log2, neg_m[0]));
    const float p2 = exp2_ftz(fmaf(sc[4 * j + 2], scale_log2, neg_m[1]));
    const float p3 = exp2_ftz(fmaf(sc[4 * j + 3], scale_log2, neg_m[1]));
    psum[0] += p0;
    psum[0] += p1;
    psum[1] += p2;
    psum[1] += p3;
    pa[j >> 1][(j & 1) * 2 + 0] = pack_rn(p0, p1);
    pa[j >> 1][(j & 1) * 2 + 1] = pack_rn(p2, p3);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + quad_sum(psum[h]);
}

// One CTA per (query tile, batch · kv head · share); warps 0 .. 4·NC - 1
// are the consumer warpgroups (warpgroup c serves query head g0 + c), warp
// 4·NC the producer.  See the head of this file.
template <int H, int NC>
__global__ void __launch_bounds__(NC * 128 + 32, 1)
    flash_attention_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                                      const __grid_constant__ CUtensorMap tm_k,
                                      const __grid_constant__ CUtensorMap tm_v,
                                      bf16* __restrict__ o,
                                      float* __restrict__ lse, int sq,
                                      int sk, int kv_heads, int group,
                                      int shares, float scale_log2,
                                      int causal) {
  using L = Smem<H, NC>;
  constexpr int kN = L::kN;
  constexpr int kRow = box_row_bytes<H>();
  constexpr int kBoxCols = kRow / 2;
  constexpr int kBoxes = H / kBoxCols;            // 2 for H = 128
  // V's second 64-column box is the next atom along its (MN) rows
  constexpr uint32_t kVLbo = kN * kRow / 16;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_full = base + L::kBarOff;
  const uint32_t k_full = q_full + 8;             // [kStages]
  const uint32_t v_full = k_full + 8 * kStages;   // [kStages]
  const uint32_t empty = v_full + 8 * kStages;    // [kStages]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockQ;  // heaviest first
  const int share = blockIdx.y % shares;
  const int kvh = (blockIdx.y / shares) % kv_heads;
  const int b = blockIdx.y / shares / kv_heads;
  const int g0 = share * NC;
  const int heads = min(NC, group - g0);          // heads of this share
  const int kv_end = causal ? min(sk, q0 + kBlockQ) : sk;
  const int n_tiles = (kv_end + kN - 1) / kN;
  const int warp = threadIdx.x >> 5;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * heads);        // each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * NC) {
    // ------------------------------------------------ producer (one lane)
    if ((threadIdx.x & 31) != 0) return;
    mbar_expect_tx(q_full, heads * L::kQ);
    for (int c = 0; c < heads; ++c) {
#pragma unroll
      for (int x = 0; x < kBoxes; ++x) {
        tma_load(base + c * L::kQ + x * kBlockQ * kRow, &tm_q, q_full,
                 x * kBoxCols, g0 + c, kvh, q0, b);
      }
    }
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      if (it >= kStages) mbar_wait(empty + 8 * s, ((it / kStages) - 1) & 1);
      const uint32_t kdst = base + L::kKOff + s * L::kKV;
      const uint32_t vdst = base + L::kVOff + s * L::kKV;
      mbar_expect_tx(k_full + 8 * s, L::kKV);
#pragma unroll
      for (int x = 0; x < kBoxes; ++x) {
        tma_load(kdst + x * kN * kRow, &tm_k, k_full + 8 * s, x * kBoxCols,
                 kvh, it * kN, b);
      }
      mbar_expect_tx(v_full + 8 * s, L::kKV);
#pragma unroll
      for (int x = 0; x < kBoxes; ++x) {
        tma_load(vdst + x * kN * kRow, &tm_v, v_full + 8 * s, x * kBoxCols,
                 kvh, it * kN, b);
      }
    }
    return;
  }

  // ---------------------------------------------- consumer warpgroup `wg`
  const int wg = warp >> 2;
  if (wg >= heads) return;                        // a short last share
  const int lane = threadIdx.x & 31;
  const int c = lane & 3;
  const int head = g0 + wg;
  const uint32_t q_base = base + wg * L::kQ;
  const int row0 = q0 + (warp & 3) * 16 + (lane >> 2);  // and row0 + 8

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f}, corr[2];
  float acc[H / 2];
#pragma unroll
  for (int i = 0; i < H / 2; ++i) acc[i] = 0.0f;

  mbar_wait(q_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages;
    const uint32_t parity = (it / kStages) & 1;
    const uint32_t k_base = base + L::kKOff + s * L::kKV;
    const uint32_t v_base = base + L::kVOff + s * L::kKV;

    // S = Q·Kᵀ: k16 step kk reads 32 bytes of each row, in box kk·16 / 64
    float sc[kN / 2];
    mbar_wait(k_full + 8 * s, parity);
    __syncwarp();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < H / 16; ++kk) {
      const int box = kk * 16 / kBoxCols, col = (kk * 16) % kBoxCols;
      Wgmma<kN>::ss(sc,
                    make_desc<H>(q_base + box * kBlockQ * kRow + col * 2, 1),
                    make_desc<H>(k_base + box * kN * kRow + col * 2, 1),
                    kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    uint32_t pa[kN / 16][4];
    online_softmax<kN>(sc, pa, m, l, corr, it * kN, row0, c, q0, sk, causal,
                       scale_log2);
#pragma unroll
    for (int j = 0; j < H / 8; ++j) {
      acc[4 * j + 0] *= corr[0];
      acc[4 * j + 1] *= corr[0];
      acc[4 * j + 2] *= corr[1];
      acc[4 * j + 3] *= corr[1];
    }

    // O += P·V: k16 step q reads V rows 16q .. 16q + 15
    mbar_wait(v_full + 8 * s, parity);
    __syncwarp();
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int q = 0; q < kN / 16; ++q) {
      WgmmaRs<H>::rs(acc, pa[q],
                     make_desc<H>(v_base + q * 16 * kRow, kVLbo));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);    // this warp read stage s
  }

  const long long q_stride = (long long)kv_heads * group * H;  // one row
  bf16* oh = o + (long long)b * sq * q_stride +
             ((long long)kvh * group + head) * H + 2 * c;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= sq) continue;
    const float denom = fmaxf(l[h], 1e-30f);
    bf16* orow = oh + row * q_stride;
#pragma unroll
    for (int j = 0; j < H / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8) = __floats2bfloat162_rn(
          acc[4 * j + 2 * h] / denom, acc[4 * j + 2 * h + 1] / denom);
    }
    // m holds raw scores and l sums exp2 of scaled ones; the quad's four
    // threads hold the same m and l
    if (lse != nullptr && c == 0) {
      lse[(((long long)b * kv_heads + kvh) * group + head) * sq + row] =
          m[h] * scale_log2 * kLn2 + logf(denom);
    }
  }
}

// ------------------------------------------------------------------ launch
template <int H>
int launch_f32(const float* q, const float* k, const float* v, float* o,
               float* lse, int batch, int sq, int sk, int kv_heads,
               int group, float scale, int causal, cudaStream_t stream) {
  const dim3 grid((unsigned)((sq + kBlockQ - 1) / kBlockQ),
                  (unsigned)(batch * kv_heads * group));
  const int smem = f32_smem_bytes<H>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_f32_kernel<H>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  flash_attention_f32_kernel<H><<<grid, kThreads, smem, stream>>>(
      q, k, v, o, lse, sq, sk, kv_heads, group, scale, causal);
  return (int)cudaGetLastError();
}

template <int H, int NC>
int launch_bf16_share(const CUtensorMap& tm_q, const CUtensorMap& tm_k,
                      const CUtensorMap& tm_v, bf16* o, float* lse,
                      int batch, int sq, int sk, int kv_heads, int group,
                      int shares, float scale_log2, int causal,
                      cudaStream_t stream) {
  using L = Smem<H, NC>;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_bf16_wgmma_kernel<H, NC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::kAlloc);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((sq + kBlockQ - 1) / kBlockQ),
                  (unsigned)(batch * kv_heads * shares));
  flash_attention_bf16_wgmma_kernel<H, NC>
      <<<grid, NC * 128 + 32, L::kAlloc, stream>>>(
          tm_q, tm_k, tm_v, o, lse, sq, sk, kv_heads, group, shares,
          scale_log2, causal);
  return (int)cudaGetLastError();
}

template <int H>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                float* lse, int batch, int sq, int sk, int kv_heads,
                int group, float scale, int causal, cudaStream_t stream) {
  constexpr cuuint32_t kBoxCols = box_row_bytes<H>() / 2;
  // q [B, Sq, Kv, G, H] in boxes of one head's 64 query rows; k, v
  // [B, Sk, Kv, H] in boxes of one kv head's kv tile
  const cuuint64_t q_dims[5] = {H, (cuuint64_t)group, (cuuint64_t)kv_heads,
                                (cuuint64_t)sq, (cuuint64_t)batch};
  const cuuint32_t q_box[5] = {kBoxCols, 1, 1, kBlockQ, 1};
  const cuuint64_t kv_dims[4] = {H, (cuuint64_t)kv_heads, (cuuint64_t)sk,
                                 (cuuint64_t)batch};
  const cuuint32_t kv_box[4] = {kBoxCols, 1, kv_tile<H>(), 1};
  CUtensorMap tm_q, tm_k, tm_v;
  if (!encode<H>(&tm_q, q, 5, q_dims, q_box) ||
      !encode<H>(&tm_k, k, 4, kv_dims, kv_box) ||
      !encode<H>(&tm_v, v, 4, kv_dims, kv_box)) {
    return (int)cudaErrorInvalidValue;
  }
  // ceil(G / 3) shares of a kv head's query heads, as even as they go
  const int shares = (group + kMaxShare - 1) / kMaxShare;
  const int per_share = (group + shares - 1) / shares;
  const float scale_log2 = scale * kLog2e;
  bf16* out = static_cast<bf16*>(o);
  switch (per_share) {
    case 1:
      return launch_bf16_share<H, 1>(tm_q, tm_k, tm_v, out, lse, batch, sq,
                                     sk, kv_heads, group, shares, scale_log2,
                                     causal, stream);
    case 2:
      return launch_bf16_share<H, 2>(tm_q, tm_k, tm_v, out, lse, batch, sq,
                                     sk, kv_heads, group, shares, scale_log2,
                                     causal, stream);
    default:
      return launch_bf16_share<H, 3>(tm_q, tm_k, tm_v, out, lse, batch, sq,
                                     sk, kv_heads, group, shares, scale_log2,
                                     causal, stream);
  }
}

template <int H>
int launch(const void* q, const void* k, const void* v, void* o,
           float* lse, int batch, int sq, int sk, int kv_heads, int group,
           float scale, int causal, int dtype, cudaStream_t stream) {
  if (dtype == 0) {
    return launch_f32<H>(static_cast<const float*>(q),
                         static_cast<const float*>(k),
                         static_cast<const float*>(v), static_cast<float*>(o),
                         lse, batch, sq, sk, kv_heads, group, scale, causal,
                         stream);
  }
  return launch_bf16<H>(q, k, v, o, lse, batch, sq, sk, kv_heads, group,
                        scale, causal, stream);
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of cudaGetLastError() as an
// int (0 = launched).  `dtype` is 0 = float32, 1 = bfloat16; `head_dim` is
// one of 16, 32, 64, 128.  The caller allocates `o` (q's shape and dtype)
// and, when it wants the row statistic, `lse` (float32 [B, Kv, G, Sq];
// null writes none), and checks shapes, types, devices, contiguity and
// 16-byte alignment.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, float* lse,
                                      int batch, int sq, int sk,
                                      int kv_heads, int group,
                                      int head_dim, int dtype, int causal,
                                      float scale, void* stream) {
  if (batch <= 0 || sq <= 0 || sk <= 0 || kv_heads <= 0 || group <= 0 ||
      (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16:
      return launch<16>(q, k, v, o, lse, batch, sq, sk, kv_heads, group,
                        scale, causal, dtype, s);
    case 32:
      return launch<32>(q, k, v, o, lse, batch, sq, sk, kv_heads, group,
                        scale, causal, dtype, s);
    case 64:
      return launch<64>(q, k, v, o, lse, batch, sq, sk, kv_heads, group,
                        scale, causal, dtype, s);
    case 128:
      return launch<128>(q, k, v, o, lse, batch, sq, sk, kv_heads, group,
                        scale, causal, dtype, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
