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
// Both kernels: one CTA per (b·kv·g head, 64-row query tile); the query
// tile and each 64-row K/V tile are staged through shared memory; a loop
// over kv tiles takes the place of the TPU's sequential grid axis, and
// under the causal mask it stops at the last tile that holds a visible
// key, as `pl.when(run)` skips the rest.  The loop starts at the tile that
// holds key 0, so every row sees a visible key in its first tile and the
// finite -1e30 mask needs no -inf case.  Sums run in a fixed order, so two
// launches give the same bits.
//
//   bfloat16: tensor cores.  4 warps of 16 query rows; both products are
//     `mma.sync.m16n8k16` bf16 x bf16 -> f32.  The score fragments are the
//     A fragments of p·V once rounded to bf16, so p never leaves
//     registers.  Row max and sum reduce over the 4 lanes of a quad.
//   float32: CUDA-core FMAs, so no TF32.  8 warps of 8 query rows, tiles
//     in float32; lane j owns kv columns j, j+32 of the scores (K rows
//     padded to H+1 floats for distinct banks) and output dims j, j+32, ...
//
// Bound on the card: operations.  4·Sq·Sk·H FLOP per head (halved under
// the causal mask) against 989 TFLOP/s bf16 dense (67 TFLOP/s float32);
// the bytes (q, k, v and o once each) take less time at 3.35 TB/s for
// every shape the LM path gives it.  What this simple design leaves on the
// table: wgmma (the only way to the full bf16 rate) and TMA/cp.async
// staging that overlaps the next tile's load with this tile's math;
// ldmatrix for the fragments; and the G query heads of one kv head
// sharing a K/V tile.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;                     // query rows per CTA
constexpr int kBlockK = 64;                     // kv rows per tile
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
                               float* __restrict__ o, int sq, int sk,
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
  }
}

// ----------------------------------------------------------- bfloat16 path
constexpr int kMmaWarps = kBlockQ / 16;         // 4 warps of 16 rows
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kScoreTiles = kBlockK / 8;        // n8 tiles of a score row

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two bf16 in one register, `lo` in the low half (the lower k index)
__device__ __forceinline__ uint32_t pack(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// round two floats to bf16 (nearest even, as `astype(bfloat16)`) and pack
__device__ __forceinline__ uint32_t pack_rn(float lo, float hi) {
  return pack(__float2bfloat16(lo), __float2bfloat16(hi));
}

// d += a · b for one 16x8x16 tile: a row-major 16x16, b col-major 16x8
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFullMask, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFullMask, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFullMask, x, 1);
  return x + __shfl_xor_sync(kFullMask, x, 2);
}

// Copies `rows` rows of H bf16 (global row stride `stride` elements) into
// shared rows of `kStride` elements, 16 bytes a thread; rows past `valid`
// are zero.
template <int H, int kStride>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           long long stride, int first,
                                           int valid, int rows) {
  constexpr int kVecs = H / 8;
  for (int i = threadIdx.x; i < rows * kVecs; i += kMmaThreads) {
    const int r = i / kVecs, c = (i % kVecs) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (first + r < valid) {
      val = *reinterpret_cast<const uint4*>(src + (first + r) * stride + c);
    }
    *reinterpret_cast<uint4*>(dst + r * kStride + c) = val;
  }
}

template <int H>
constexpr int bf16_smem_bytes() {
  return (kBlockQ + 2 * kBlockK) * (H + 8) * (int)sizeof(bf16);
}

// Fragment layouts are those of PTX `mma.m16n8k16` for bf16: with
// g = lane / 4 and t = lane % 4, A register j holds row g (+8 for j odd),
// k = 2t, 2t+1 (+8 for j >= 2); B register j holds k = 2t, 2t+1 (+8 for
// j = 1) of column g; C holds rows g (d0, d1) and g+8 (d2, d3), columns
// 2t, 2t+1.
template <int H>
__global__ void __launch_bounds__(kMmaThreads)
    flash_attention_bf16_kernel(const bf16* __restrict__ q,
                                const bf16* __restrict__ k,
                                const bf16* __restrict__ v,
                                bf16* __restrict__ o, int sq, int sk,
                                int kv_heads, int group, float scale,
                                int causal) {
  constexpr int kStride = H + 8;       // shared row, padded by 16 bytes
  constexpr int kChunks = H / 16;      // k16 chunks of the head dim
  constexpr int kDimTiles = H / 8;     // n8 tiles of an output row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // [kBlockQ][kStride]
  bf16* ks = qs + kBlockQ * kStride;               // [kBlockK][kStride]
  bf16* vs = ks + kBlockK * kStride;               // [kBlockK][kStride]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int heads = kv_heads * group;
  const int head = blockIdx.y;             // b * heads + kv * group + g
  const int b = head / heads;
  const int hq = head % heads;
  const int kvh = hq / group;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockQ;

  const long long q_stride = (long long)heads * H;
  const long long kv_stride = (long long)kv_heads * H;
  const bf16* qh = q + (long long)b * sq * q_stride + (long long)hq * H;
  const bf16* kh = k + (long long)b * sk * kv_stride + (long long)kvh * H;
  const bf16* vh = v + (long long)b * sk * kv_stride + (long long)kvh * H;
  bf16* oh = o + (long long)b * sq * q_stride + (long long)hq * H;

  stage_rows<H, kStride>(qs, qh, q_stride, q0, sq, kBlockQ);
  __syncthreads();
  // this warp's 16 query rows as A fragments, kept for the whole loop
  uint32_t qa[kChunks][4];
  const bf16* qw = qs + warp * 16 * kStride;
#pragma unroll
  for (int kk = 0; kk < kChunks; ++kk) {
    const int c = kk * 16 + 2 * t;
    qa[kk][0] = ld32(qw + g * kStride + c);
    qa[kk][1] = ld32(qw + (g + 8) * kStride + c);
    qa[kk][2] = ld32(qw + g * kStride + c + 8);
    qa[kk][3] = ld32(qw + (g + 8) * kStride + c + 8);
  }

  const int row_g = q0 + warp * 16 + g;    // rows g and g+8 of the warp
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  float acc[kDimTiles][4];
#pragma unroll
  for (int nd = 0; nd < kDimTiles; ++nd) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nd][i] = 0.0f;
  }
  const int kv_end = causal ? min(sk, q0 + kBlockQ) : sk;

  for (int k0 = 0; k0 < kv_end; k0 += kBlockK) {
    __syncthreads();  // every warp is done with the previous tile
    stage_rows<H, kStride>(ks, kh, kv_stride, k0, sk, kBlockK);
    stage_rows<H, kStride>(vs, vh, kv_stride, k0, sk, kBlockK);
    __syncthreads();

    // s = q · kᵀ: B[k][n] = K[n][k], so B registers are K rows in place
    float s[kScoreTiles][4];
#pragma unroll
    for (int nt = 0; nt < kScoreTiles; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < kChunks; ++kk) {
        const bf16* kr = ks + (nt * 8 + g) * kStride + kk * 16 + 2 * t;
        mma_bf16(s[nt], qa[kk], ld32(kr), ld32(kr + 8));
      }
    }

    // mask and row max (rows g and g+8 of this warp)
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < kScoreTiles; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kpos = k0 + nt * 8 + 2 * t + (i & 1);
        const int qpos = row_g + 8 * (i >> 1);
        float x = s[nt][i] * scale;
        const bool visible = kpos < sk && (!causal || qpos >= kpos);
        x = visible ? x : kNegInf;
        s[nt][i] = x;
        mx[i >> 1] = fmaxf(mx[i >> 1], x);
      }
    }
    float m_new[2], corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_new[r] = fmaxf(m[r], quad_max(mx[r]));
      corr[r] = expf(m[r] - m_new[r]);
    }

    // p = exp(s − m): l sums it in f32; rounded to bf16 it becomes the A
    // fragments of p·v (score tiles 2c and 2c+1 make k16 chunk c)
    uint32_t pa[kScoreTiles / 2][4];
    float psum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int nt = 0; nt < kScoreTiles; ++nt) {
      const float p0 = expf(s[nt][0] - m_new[0]);
      const float p1 = expf(s[nt][1] - m_new[0]);
      const float p2 = expf(s[nt][2] - m_new[1]);
      const float p3 = expf(s[nt][3] - m_new[1]);
      psum[0] += p0;
      psum[0] += p1;
      psum[1] += p2;
      psum[1] += p3;
      pa[nt >> 1][(nt & 1) * 2 + 0] = pack_rn(p0, p1);
      pa[nt >> 1][(nt & 1) * 2 + 1] = pack_rn(p2, p3);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = l[r] * corr[r] + quad_sum(psum[r]);
      m[r] = m_new[r];
    }
#pragma unroll
    for (int nd = 0; nd < kDimTiles; ++nd) {
      acc[nd][0] *= corr[0];
      acc[nd][1] *= corr[0];
      acc[nd][2] *= corr[1];
      acc[nd][3] *= corr[1];
    }

    // acc += p · v: B[k][n] = V[kv k][dim n], two rows a register
#pragma unroll
    for (int c = 0; c < kScoreTiles / 2; ++c) {
#pragma unroll
      for (int nd = 0; nd < kDimTiles; ++nd) {
        const bf16* vr = vs + (c * 16 + 2 * t) * kStride + nd * 8 + g;
        mma_bf16(acc[nd], pa[c], pack(vr[0], vr[kStride]),
                 pack(vr[8 * kStride], vr[9 * kStride]));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_g + 8 * r;
    if (row >= sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    bf16* orow = oh + row * q_stride + 2 * t;
#pragma unroll
    for (int nd = 0; nd < kDimTiles; ++nd) {
      *reinterpret_cast<__nv_bfloat162*>(orow + nd * 8) = __floats2bfloat162_rn(
          acc[nd][2 * r] / denom, acc[nd][2 * r + 1] / denom);
    }
  }
}

// ------------------------------------------------------------------ launch
template <int H>
int launch(const void* q, const void* k, const void* v, void* o, int batch,
           int sq, int sk, int kv_heads, int group, float scale, int causal,
           int dtype, cudaStream_t stream) {
  const dim3 grid((unsigned)((sq + kBlockQ - 1) / kBlockQ),
                  (unsigned)(batch * kv_heads * group));
  cudaError_t err;
  if (dtype == 0) {
    const int smem = f32_smem_bytes<H>();
    err = cudaFuncSetAttribute(flash_attention_f32_kernel<H>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    flash_attention_f32_kernel<H><<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), sq, sk,
        kv_heads, group, scale, causal);
  } else {
    const int smem = bf16_smem_bytes<H>();
    err = cudaFuncSetAttribute(flash_attention_bf16_kernel<H>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    flash_attention_bf16_kernel<H><<<grid, kMmaThreads, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(o), sq, sk,
        kv_heads, group, scale, causal);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of cudaGetLastError() as an
// int (0 = launched).  `dtype` is 0 = float32, 1 = bfloat16; `head_dim` is
// one of 16, 32, 64, 128.  The caller allocates `o` (q's shape and dtype),
// and checks shapes, types, devices, contiguity and 16-byte alignment.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int batch,
                                      int sq, int sk, int kv_heads, int group,
                                      int head_dim, int dtype, int causal,
                                      float scale, void* stream) {
  if (batch <= 0 || sq <= 0 || sk <= 0 || kv_heads <= 0 || group <= 0 ||
      (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16:
      return launch<16>(q, k, v, o, batch, sq, sk, kv_heads, group, scale,
                        causal, dtype, s);
    case 32:
      return launch<32>(q, k, v, o, batch, sq, sk, kv_heads, group, scale,
                        causal, dtype, s);
    case 64:
      return launch<64>(q, k, v, o, batch, sq, sk, kv_heads, group, scale,
                        causal, dtype, s);
    case 128:
      return launch<128>(q, k, v, o, batch, sq, sk, kv_heads, group, scale,
                         causal, dtype, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
