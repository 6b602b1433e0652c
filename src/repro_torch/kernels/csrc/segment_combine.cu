// Scatter-Combine ⊕ over dst-sorted messages, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `segment_combine_pallas`
// (src/repro/kernels/segment_combine.py, body `_kernel`), on both of its
// routes: the dense every-edge scan and the gathered frontier tile
// (`tile_segment_combine_pallas`).  It computes the same function,
//
//   out[v, :] = ⊕_{e : seg_ptr[v] <= e < seg_ptr[v+1]} msgs[e, :]
//
// for ⊕ in {sum, min, max}; an empty segment holds the identity
// (0, +inf, -inf).  The TPU kernel's one-hot matmul, block table and dummy
// edge block are not carried over: on dst-sorted edges the block table
// collapses to a row pointer, `seg_ptr[v] = searchsorted(dst, v)`, so edges
// whose dst is >= num_segments (padding, sentinel tile lanes) lie past
// seg_ptr[num_segments] and are never read.
//
// Design: one warp per segment.
//   * D < 32: the lanes stride the segment's edge range, one column at a
//     time, and fold with a shuffle tree of fixed order;
//   * D >= 32: lanes own columns and walk the edges in order.
// Accumulation is float32, with no atomics and no tensor cores, so the order
// of every sum is fixed by the launch and two launches give the same bits.
//
// Bound on the card: bytes.  Each routed message is read once, plus the
// row pointer and the output, E*D*4 + (V+1)*4 + V*D*4 bytes over
// 3.35 TB/s (dst is never read); the arithmetic is one op per message
// element.  What this simple design leaves on the
// table: hub segments (R-MAT in-degrees of 1e4-1e5) serialise on one warp
// while the rest of the grid has drained; 1 < D < 32 reads a column at a
// time with a stride of D floats; loads are not staged through shared
// memory (cp.async / TMA).
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;

enum Op { kSum = 0, kMin = 1, kMax = 2 };

template <int OP>
__device__ __forceinline__ float identity() {
  if (OP == kSum) return 0.0f;
  if (OP == kMin) return CUDART_INF_F;
  return -CUDART_INF_F;
}

template <int OP>
__device__ __forceinline__ float combine(float a, float b) {
  if (OP == kSum) return a + b;
  if (OP == kMin) return fminf(a, b);
  return fmaxf(a, b);
}

template <int OP>
__global__ void segment_combine_kernel(const float* __restrict__ msgs,
                                       const int* __restrict__ seg_ptr,
                                       float* __restrict__ out,
                                       int num_segments, int d) {
  const int lane = threadIdx.x & 31;
  const long long seg =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (seg >= num_segments) return;  // whole warp exits together
  const long long start = seg_ptr[seg];
  const long long end = seg_ptr[seg + 1];
  float* row = out + seg * (long long)d;
  if (d < 32) {
    for (int c = 0; c < d; ++c) {
      float acc = identity<OP>();
      for (long long e = start + lane; e < end; e += 32) {
        acc = combine<OP>(acc, msgs[e * d + c]);
      }
      // fixed-order tree: lane 0 ends with ((l0 ⊕ l16) ⊕ (l8 ⊕ l24)) ⊕ ...
      for (int off = 16; off > 0; off >>= 1) {
        acc = combine<OP>(acc, __shfl_down_sync(kFullMask, acc, off));
      }
      if (lane == 0) row[c] = acc;
    }
  } else {
    for (int c = lane; c < d; c += 32) {
      float acc = identity<OP>();
      for (long long e = start; e < end; ++e) {
        acc = combine<OP>(acc, msgs[e * d + c]);
      }
      row[c] = acc;
    }
  }
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of cudaGetLastError() as an
// int (0 = launched).  `op` is 0 = sum, 1 = min, 2 = max.  The caller
// allocates `out [num_segments, d]` and checks shapes, types and devices.
extern "C" int segment_combine_launch(const float* msgs, const int* seg_ptr,
                                      float* out, int num_segments, int d,
                                      int op, void* stream) {
  if (num_segments <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid((unsigned)((num_segments + kWarpsPerBlock - 1) /
                             kWarpsPerBlock));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (op) {
    case kSum:
      segment_combine_kernel<kSum><<<grid, block, 0, s>>>(msgs, seg_ptr, out,
                                                          num_segments, d);
      break;
    case kMin:
      segment_combine_kernel<kMin><<<grid, block, 0, s>>>(msgs, seg_ptr, out,
                                                          num_segments, d);
      break;
    case kMax:
      segment_combine_kernel<kMax><<<grid, block, 0, s>>>(msgs, seg_ptr, out,
                                                          num_segments, d);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
