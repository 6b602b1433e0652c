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
// with dK and dV summed over the G query heads of a kv head.  The mask is
// the JAX one: qpos >= kpos, both counted from 0 (not bottom-right aligned
// when Sq != Sk); ragged tails are masked here.  Layouts are the JAX
// package's: q, o, dO, dQ [B, Sq, Kv, G, H]; k, v, dK, dV [B, Sk, Kv, H],
// contiguous; dtypes float32 or bfloat16 (all five alike), H in
// {16, 32, 64, 128}.
//
// Deterministic, no atomics: the two passes JAX itself takes, plus a
// pre-pass.
//   `delta_kernel`  one warp per query row: δ in float32 [B, Kv, G, Sq],
//                   the lanes' partial sums folded by a fixed butterfly.
//   `dkdv_kernel`   one CTA per (batch · kv head, 64-row kv tile): K and V
//                   stay in shared memory while the CTA loops over the G
//                   query heads and, for each, over the query tiles that
//                   see the kv tile (from the tile's own first row under
//                   the causal mask); dK and dV accumulate in registers.
//   `dq_kernel`     one CTA per (batch · kv head · g, 64-row query tile),
//                   heaviest causal tiles first: q, dO, lse and δ stay in
//                   shared memory while the CTA loops over the kv tiles
//                   up to the last one that holds a visible key.
// Both tile kernels recompute p and dS a tile pair at a time (scores and
// dO·vᵀ for a 64 x 64 pair, 4 x 4 entries a thread) into shared memory,
// then take the products from there.  Every sum runs in float32 in a fixed
// order and the outputs are written once in the input dtype, so two
// launches give the same bits.
//
// Bound on the card: operations.  The five products above take
// 5 · 2 · Sq · Sk · H FLOP a query head (halved under the causal mask);
// over 989 TFLOP/s bf16 dense (67 TFLOP/s float32 on the FMA units) that
// is far above the bytes (q, k, v, o, dO, lse in; dQ, dK, dV out) over
// 3.35 TB/s at the training shapes.
//
// What the design leaves on the table: every product runs on CUDA-core
// FMAs in float32 from shared memory (bf16 tiles are widened on load), so
// bf16 is held to the FMA rate, far below the tensor cores' 989 TFLOP/s;
// `wgmma` fed by TMA, as the forward has, is the redesign to come.  The
// dK/dV pass recomputes the scores the dQ pass also computes (JAX's two
// passes do the same; a fused pass would need atomics or a second
// reduction).  At H = 128 the four padded float tiles take 165 KB of
// shared memory, one CTA an SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;                 // query and kv rows a tile
constexpr int kThreads = 256;             // 16 x 16 threads, 4 x 4 entries each
constexpr int kSide = 16;
constexpr int kPer = kTile / kSide;       // 4
constexpr int kPStride = kTile + 1;       // padded rows of the p / dS tiles
constexpr unsigned kFullMask = 0xffffffffu;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

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

template <int H, typename T>
int launch(const void* q, const void* k, const void* v, const void* o,
           const float* lse, const void* dout, float* delta, void* dq,
           void* dk, void* dv, int batch, int sq, int sk, int kv_heads,
           int group, float scale, int causal, cudaStream_t stream) {
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  const long long rows = (long long)batch * sq * kv_heads * group;
  const unsigned warps = kThreads / 32;
  delta_kernel<T><<<(unsigned)((rows + warps - 1) / warps), kThreads, 0,
                    stream>>>(static_cast<const T*>(o), tdo, delta, batch, sq,
                              kv_heads, group, H);
  cudaError_t err = cudaGetLastError();
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

template <int H>
int launch_dtype(int dtype, const void* q, const void* k, const void* v,
                 const void* o, const float* lse, const void* dout,
                 float* delta, void* dq, void* dk, void* dv, int batch,
                 int sq, int sk, int kv_heads, int group, float scale,
                 int causal, cudaStream_t stream) {
  if (dtype == 0) {
    return launch<H, float>(q, k, v, o, lse, dout, delta, dq, dk, dv, batch,
                            sq, sk, kv_heads, group, scale, causal, stream);
  }
  return launch<H, bf16>(q, k, v, o, lse, dout, delta, dq, dk, dv, batch, sq,
                         sk, kv_heads, group, scale, causal, stream);
}

}  // namespace

// Launches the three kernels on `stream` in order (δ, dK/dV, dQ); returns
// the first cudaError_t as an int (0 = launched).  `dtype` is 0 = float32,
// 1 = bfloat16; `head_dim` one of 16, 32, 64, 128.  The caller allocates
// `delta` (float32 [B, Kv, G, Sq], scratch), dq (q's shape and dtype), dk
// and dv (k's), and checks shapes, types, devices and contiguity.
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
