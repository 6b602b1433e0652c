// Scatter-Combine ⊕ over dst-sorted messages, and the tile route's lane
// compaction, for Hopper (sm_90a).
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
// Design: merge-path load balance (Merrill & Garland, SC'16).  The work is
// the path that merges the V row ends with the E routed edges: T = V + E
// items, a row end taken once every edge of its row is.  Each unit of work
// takes an equal share of the path; a first, small pass finds where every
// share starts by a search of seg_ptr on its diagonal, so an empty segment
// costs one path item (one coalesced write) and a hub is spread over as
// many units as its edges fill.  A unit writes
// every row that ends in its share; the partial of the row still open at
// its end is its carry-out.  A second, small kernel folds each row's
// carry-outs, in unit order, into the value its last unit wrote: a fixed
// order, with no atomics.  Shares are a function of (V, E, D) alone, so the
// order of every sum is fixed by the shapes and the row pointer, and two
// launches give the same bits.  Accumulation is float32; no tensor cores.
//
//   * D = 1: a CTA of 256 threads takes 3072 path items.  It stages its
//     row ends and its messages in shared memory (the messages with float4
//     loads); each thread walks 12 items of the merge and writes its
//     rows into shared memory; a segmented scan across the threads folds
//     the partials of rows cut between threads; the CTA then writes its
//     rows with coalesced stores (a share of mostly empty rows, as a
//     frontier tile's, is mostly stores).
//   * D >= 2: a warp takes 512 path items of one 32-column tile (grid.y),
//     lanes own columns, so every message row and every output row is one
//     128-byte access.  Message rows are loaded eight at a time, across row
//     ends, ahead of the fold.
//
// Bound on the card: bytes.  Each routed message is read once, plus the
// row pointer and the output, E*D*4 + (V+1)*4 + V*D*4 bytes over
// 3.35 TB/s (dst is never read); the arithmetic is one op per message
// element.  What this design still leaves on the table: a D = 1 CTA waits
// on two dependent reads (its share's start, then its data) with nothing
// of its own to overlap them, and its loads are not issued through
// cp.async or TMA (no pipeline across shares); 1 < D < 32 runs the column
// kernel with D of 32 lanes busy; the partition and the carry fold are two
// more launches, which cost about as much as a small combine (a tile's).
// The tile route's row pointer is a searchsorted over all V + 1 segments;
// a path that merges the sorted dst keys with the rows directly would not
// need it.
//
// The tile route's lane compaction (`compact_lanes_*`) keeps, in lane
// order, the lanes whose dst is < num_segments: a count for each round of
// 4096 lanes, one scan of the counts, and a write of each round's valid
// lanes at its offset (rounds with none are not read again).  It reads
// every lane's dst once (N*4 bytes) and writes 8 bytes per valid lane.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

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

// Rows whose end lies on the merge path before diagonal `d`: the least x in
// [max(0, d - E), min(d, V)] with seg_ptr[x+1] - e0 + x + 1 > d, or the
// upper end when there is none.  The warp's lanes form groups of `H` (a
// power of two up to 32); group g searches its own diagonal (given in each
// of its lanes) with H probes a round.  Every lane of the warp must call it.
template <int H>
__device__ __forceinline__ int merge_path_search(long long d,
                                                 const int* __restrict__ seg_ptr,
                                                 int e0, int num_rows,
                                                 int num_edges) {
  const int lane = threadIdx.x & 31;
  const int g = lane / H, hl = lane % H;
  const unsigned gmask = (H == 32) ? kFullMask : ((1u << H) - 1u);
  long long lo = d - num_edges > 0 ? d - num_edges : 0;
  long long hi = d < num_rows ? d : num_rows;
  for (;;) {
    const bool active = lo < hi;
    if (!__any_sync(kFullMask, active)) break;
    const long long step = active ? (hi - lo + H - 1) / H : 0;
    const long long p = lo + (hl + 1) * step - 1;
    const bool pred = active && p < hi &&
                      (long long)seg_ptr[p + 1] - e0 + p + 1 <= d;
    const unsigned bits = (__ballot_sync(kFullMask, pred) >> (g * H)) & gmask;
    if (active) {
      const int k = __popc(bits);
      const long long top = lo + (k + 1) * step - 1;
      lo += k * step;
      if (top < hi) hi = top;
    }
  }
  return (int)lo;
}

// The merge-path partition: row_at[k] = rows ended before diagonal
// min(k * share, T), for k in [0, num_units], one 8-lane group per
// diagonal.  Every unit then starts from two reads instead of a search.
constexpr int kPartWarps = 8;
constexpr int kPartGroup = 8;

__global__ void __launch_bounds__(32 * kPartWarps)
merge_path_partition_kernel(const int* __restrict__ seg_ptr, int num_rows,
                            int share, int num_units,
                            int* __restrict__ row_at) {
  const int e0 = seg_ptr[0];
  const int num_edges = seg_ptr[num_rows] - e0;
  const long long total = (long long)num_rows + num_edges;
  const long long k = ((long long)blockIdx.x * blockDim.x + threadIdx.x) /
                      kPartGroup;
  const long long want = k * share;
  const long long d = k <= num_units ? (want < total ? want : total) : total;
  const int x = merge_path_search<kPartGroup>(d, seg_ptr, e0, num_rows,
                                              num_edges);
  if (k <= num_units && threadIdx.x % kPartGroup == 0) row_at[k] = x;
}

// ---------------------------------------------------------------- D = 1
constexpr int kThreads1 = 256;
constexpr int kItems1 = 12;
constexpr int kShare1 = kThreads1 * kItems1;   // path items per CTA
constexpr int kWarps1 = kThreads1 / 32;

// Rows' ends and messages share one buffer, and 32 registers a thread
// suffice, so eight CTAs fit an SM (24.6 KB of shared memory each).
template <int OP>
__global__ void __launch_bounds__(kThreads1, 8)
combine_d1_kernel(const float* __restrict__ msgs,
                  const int* __restrict__ seg_ptr,
                  const int* __restrict__ row_at, float* __restrict__ out,
                  int* __restrict__ carry_row, float* __restrict__ carry_val,
                  int num_rows) {
  // rows' ends [0, nr) then messages [nr, nr + ne): nr + ne <= kShare1
  __shared__ int s_buf[kShare1];
  __shared__ float s_out[kShare1];
  int* const s_row = s_buf;
  __shared__ int s_wkey[kWarps1];
  __shared__ float s_wval[kWarps1];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int e0 = seg_ptr[0];
  const int num_edges = seg_ptr[num_rows] - e0;
  const long long total = (long long)num_rows + num_edges;
  const long long d0 = (long long)blockIdx.x * kShare1;
  if (d0 >= total) {  // past the path's end: nothing to carry
    if (tid == 0) {
      carry_row[blockIdx.x] = num_rows;
      carry_val[blockIdx.x] = identity<OP>();
    }
    return;
  }
  const long long d1 = d0 + kShare1 < total ? d0 + kShare1 : total;
  const int i0 = row_at[blockIdx.x], i1 = row_at[blockIdx.x + 1];
  const int j0 = (int)(d0 - i0), j1 = (int)(d1 - i1);
  const int nr = i1 - i0, ne = j1 - j0;
  float* const s_msg = reinterpret_cast<float*>(s_buf + nr);
  for (int k = tid; k < nr; k += kThreads1) {
    s_row[k] = seg_ptr[i0 + 1 + k] - e0 - j0;
  }
  {  // messages [e0 + j0, e0 + j1): float4 body, scalar head and tail
    const float* src = msgs + (long long)e0 + j0;
    int head = (int)((4 - (((uintptr_t)src >> 2) & 3)) & 3);
    if (head > ne) head = ne;
    const int nvec = (ne - head) >> 2;
    const float4* vsrc = reinterpret_cast<const float4*>(src + head);
    for (int k = tid; k < nvec; k += kThreads1) {
      const float4 q = __ldcs(vsrc + k);
      float* dstp = s_msg + head + 4 * k;
      dstp[0] = q.x; dstp[1] = q.y; dstp[2] = q.z; dstp[3] = q.w;
    }
    if (tid < head) s_msg[tid] = __ldcs(src + tid);
    const int tail = head + 4 * nvec;
    if (tail + tid < ne) s_msg[tail + tid] = __ldcs(src + tail + tid);
  }
  __syncthreads();
  // this thread's start on the local path [0, nr + ne)
  const int nitems = nr + ne;
  const int dl = tid * kItems1;
  int x = nr, y = ne;
  if (dl < nitems) {
    int lo = dl - ne > 0 ? dl - ne : 0, hi = dl < nr ? dl : nr;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (s_row[mid] + mid + 1 <= dl) lo = mid + 1; else hi = mid;
    }
    x = lo;
    y = dl - lo;
  }
  int first = -1;                 // local row of this thread's first end
  float acc = identity<OP>();
  const int stop = dl + kItems1 < nitems ? dl + kItems1 : nitems;
  for (int it = dl; it < stop; ++it) {
    if (x < nr && s_row[x] <= y) {
      s_out[x] = acc;
      if (first < 0) first = x;
      acc = identity<OP>();
      ++x;
    } else {
      acc = combine<OP>(acc, s_msg[y]);
      ++y;
    }
  }
  // inclusive segmented scan of (row open at the thread's end, partial);
  // rows ascend with the thread, so equal keys are contiguous
  const int key = x;
  float val = acc;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int k2 = __shfl_up_sync(kFullMask, key, off);
    const float v2 = __shfl_up_sync(kFullMask, val, off);
    if (lane >= off && k2 == key) val = combine<OP>(v2, val);
  }
  if (lane == 31) {
    s_wkey[warp] = key;
    s_wval[warp] = val;
  }
  __syncthreads();
  // inclusive value at the last thread of the previous warp
  float prev = identity<OP>();
  int prev_key = -1;
  for (int w = 0; w < warp; ++w) {
    prev = (s_wkey[w] == prev_key) ? combine<OP>(prev, s_wval[w]) : s_wval[w];
    prev_key = s_wkey[w];
  }
  if (warp > 0 && prev_key == key) val = combine<OP>(prev, val);
  // carry-in of this thread: the inclusive value of the thread before it,
  // whose open row is the row of this thread's first end
  float carry_in = __shfl_up_sync(kFullMask, val, 1);
  if (lane == 0) carry_in = prev;
  if (first >= 0 && tid > 0) s_out[first] = combine<OP>(carry_in, s_out[first]);
  __syncthreads();
  for (int k = tid; k < nr; k += kThreads1) out[(long long)i0 + k] = s_out[k];
  if (tid == kThreads1 - 1) {
    carry_row[blockIdx.x] = i1;
    carry_val[blockIdx.x] = val;
  }
}

// --------------------------------------------------------------- D >= 2
constexpr int kWarpsN = 8;
constexpr int kShareN = 512;      // path items per warp
constexpr int kAhead = 8;         // message rows loaded ahead of the fold

template <int OP>
__global__ void __launch_bounds__(32 * kWarpsN)
combine_cols_kernel(const float* __restrict__ msgs,
                    const int* __restrict__ seg_ptr,
                    const int* __restrict__ row_at, float* __restrict__ out,
                    int* __restrict__ carry_row, float* __restrict__ carry_val,
                    int num_units, int num_rows, int d) {
  const int lane = threadIdx.x & 31;
  const long long unit = (long long)blockIdx.x * kWarpsN + (threadIdx.x >> 5);
  if (unit >= num_units) return;  // whole warp: the grid's last block
  const int col = blockIdx.y * 32 + lane;
  const bool on = col < d;
  const int e0 = seg_ptr[0];
  const int num_edges = seg_ptr[num_rows] - e0;
  const long long total = (long long)num_rows + num_edges;
  const long long d0 = unit * kShareN;
  float* cval = carry_val + unit * d + col;
  if (d0 >= total) {
    if (blockIdx.y == 0 && lane == 0) carry_row[unit] = num_rows;
    if (on) *cval = identity<OP>();
    return;
  }
  const long long d1 = d0 + kShareN < total ? d0 + kShareN : total;
  const int i0 = row_at[unit], i1 = row_at[unit + 1];
  const int j0 = (int)(d0 - i0), j1 = (int)(d1 - i1);
  const float* m = msgs + (long long)e0 * d + col;
  // rows [i0, i1) end in this share; lane l holds the end of row rb + l
  int r = i0, rb = i0;
  int rend_l = (rb + lane < i1) ? seg_ptr[rb + lane + 1] - e0 : 0;
  int rend = r < i1 ? __shfl_sync(kFullMask, rend_l, 0) : j1;
  float acc = identity<OP>();
  // emit every row that ends at or before edge `e` (uniform across lanes)
  auto emit_until = [&](int e) {
    while (r < i1 && rend <= e) {
      if (on) out[(long long)r * d + col] = acc;
      acc = identity<OP>();
      ++r;
      if (r - rb == 32) {
        rb = r;
        rend_l = (rb + lane < i1) ? seg_ptr[rb + lane + 1] - e0 : 0;
      }
      rend = r < i1 ? __shfl_sync(kFullMask, rend_l, r - rb) : j1;
    }
  };
  for (int e = j0; e < j1; e += kAhead) {
    float v[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      v[u] = (on && e + u < j1) ? __ldcs(m + (long long)(e + u) * d)
                                : identity<OP>();
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (e + u < j1) {
        emit_until(e + u);
        acc = combine<OP>(acc, v[u]);
      }
    }
  }
  emit_until(j1);
  if (blockIdx.y == 0 && lane == 0) carry_row[unit] = i1;
  if (on) *cval = acc;
}

// ------------------------------------------------------ carry-out fold
// One warp per unit c.  The head of each run of units whose open row is r
// folds the run's carries, in unit order, ahead of the value the row's
// last unit wrote: out[r] = (c_first ⊕ ... ⊕ c_last) ⊕ out[r].
constexpr int kFixWarps = 8;

template <int OP>
__global__ void __launch_bounds__(32 * kFixWarps)
fold_carries_d1_kernel(const int* __restrict__ carry_row,
                       const float* __restrict__ carry_val,
                       float* __restrict__ out, int num_units, int num_rows) {
  const int lane = threadIdx.x & 31;
  const long long c = (long long)blockIdx.x * kFixWarps + (threadIdx.x >> 5);
  if (c >= num_units) return;
  const int r = carry_row[c];
  if (r >= num_rows || (c > 0 && carry_row[c - 1] == r)) return;
  // lanes stride the run; the lane sums then meet in a fixed shuffle tree
  float acc = identity<OP>();
  for (long long base = c;; base += 32) {
    const long long k = base + lane;
    const bool in = k < num_units && carry_row[k] == r;
    if (in) acc = combine<OP>(acc, carry_val[k]);
    if (__ballot_sync(kFullMask, in) != kFullMask) break;
  }
  for (int off = 16; off > 0; off >>= 1) {
    acc = combine<OP>(acc, __shfl_down_sync(kFullMask, acc, off));
  }
  if (lane == 0) out[r] = combine<OP>(acc, out[r]);
}

template <int OP>
__global__ void __launch_bounds__(32 * kFixWarps)
fold_carries_cols_kernel(const int* __restrict__ carry_row,
                         const float* __restrict__ carry_val,
                         float* __restrict__ out, int num_units, int num_rows,
                         int d) {
  const int lane = threadIdx.x & 31;
  const long long c = (long long)blockIdx.x * kFixWarps + (threadIdx.x >> 5);
  const int col = blockIdx.y * 32 + lane;
  const bool on = col < d;
  if (c >= num_units) return;
  const int r = carry_row[c];
  if (r >= num_rows || (c > 0 && carry_row[c - 1] == r)) return;
  // lanes own columns and fold the run in unit order
  float acc = identity<OP>();
  const float* v = carry_val + col;
  for (long long base = c;; base += 32) {
    const long long k = base + lane;
    const bool in = k < num_units && carry_row[k] == r;
    const unsigned bits = __ballot_sync(kFullMask, in);
    const int n = __popc(bits);  // the run is contiguous: a prefix of lanes
    int u = 0;
    for (; u + kAhead <= n; u += kAhead) {
      float w[kAhead];
#pragma unroll
      for (int q = 0; q < kAhead; ++q) {
        w[q] = on ? v[(base + u + q) * d] : identity<OP>();
      }
#pragma unroll
      for (int q = 0; q < kAhead; ++q) acc = combine<OP>(acc, w[q]);
    }
    for (; u < n; ++u) {
      if (on) acc = combine<OP>(acc, v[(base + u) * d]);
    }
    if (bits != kFullMask) break;
  }
  if (on) {
    float* o = out + (long long)r * d + col;
    *o = combine<OP>(acc, *o);
  }
}

template <int OP>
int launch_combine(const float* msgs, const int* seg_ptr, float* out,
                   int* row_at, int* carry_row, float* carry_val,
                   int num_units, int num_rows, int d, cudaStream_t s) {
  const long long groups = (long long)num_units + 1;
  const int per_block = 32 * kPartWarps / kPartGroup;
  merge_path_partition_kernel<<<(unsigned)((groups + per_block - 1) /
                                           per_block),
                                32 * kPartWarps, 0, s>>>(
      seg_ptr, num_rows, d == 1 ? kShare1 : kShareN, num_units, row_at);
  if (cudaPeekAtLastError() != cudaSuccess) return (int)cudaGetLastError();
  if (d == 1) {
    combine_d1_kernel<OP><<<num_units, kThreads1, 0, s>>>(
        msgs, seg_ptr, row_at, out, carry_row, carry_val, num_rows);
    if (cudaPeekAtLastError() != cudaSuccess) return (int)cudaGetLastError();
    const int fix_blocks = (num_units + kFixWarps - 1) / kFixWarps;
    fold_carries_d1_kernel<OP><<<fix_blocks, 32 * kFixWarps, 0, s>>>(
        carry_row, carry_val, out, num_units, num_rows);
    return (int)cudaGetLastError();
  }
  const unsigned tiles = (unsigned)((d + 31) / 32);
  const dim3 grid((unsigned)((num_units + kWarpsN - 1) / kWarpsN), tiles);
  combine_cols_kernel<OP><<<grid, 32 * kWarpsN, 0, s>>>(
      msgs, seg_ptr, row_at, out, carry_row, carry_val, num_units, num_rows,
      d);
  if (cudaPeekAtLastError() != cudaSuccess) return (int)cudaGetLastError();
  const dim3 fix((unsigned)((num_units + kFixWarps - 1) / kFixWarps), tiles);
  fold_carries_cols_kernel<OP><<<fix, 32 * kFixWarps, 0, s>>>(
      carry_row, carry_val, out, num_units, num_rows, d);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------ lane compaction
// A count block of the compaction is kRounds rounds of kRound lanes, with
// one count per round.
constexpr int kCompactThreads = 256;
constexpr int kRound = kCompactThreads * 16;
constexpr int kRounds = 4;
constexpr int kCompactChunk = kRound * kRounds;   // lanes per count block
constexpr int kScanThreads = 1024;
constexpr int kScanPer = 8;                       // counts per scan thread

// Exclusive scan of one int per thread across the CTA, in thread order;
// returns the thread's offset and sets `total` in every thread.
template <int THREADS>
__device__ __forceinline__ int block_exclusive_scan(int c, int* s_warp,
                                                    int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = c;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(kFullMask, incl, off);
    if (lane >= off) incl += o;
  }
  __syncthreads();                    // s_warp free from any earlier use
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) {
    if (w < warp) before += s_warp[w];
    total += s_warp[w];
  }
  return before + incl - c;
}

// counts[r] = valid lanes of round r (kRound lanes), for the kRounds
// rounds of this block.
__global__ void __launch_bounds__(kCompactThreads)
compact_count_kernel(const int* __restrict__ dst, long long n, int limit,
                     int vec, int* __restrict__ counts) {
  __shared__ int s_warp[kCompactThreads / 32];
  const long long base = (long long)blockIdx.x * kCompactChunk;
  constexpr int kVecPerRound = kRound / 4 / kCompactThreads;
  int c[kRounds];
  if (vec && base + kCompactChunk <= n) {
    const int4* v = reinterpret_cast<const int4*>(dst + base);
    int4 q[kRounds * kVecPerRound];
#pragma unroll
    for (int k = 0; k < kRounds * kVecPerRound; ++k) {
      q[k] = __ldcs(v + threadIdx.x + k * kCompactThreads);
    }
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      c[r] = 0;
#pragma unroll
      for (int k = r * kVecPerRound; k < (r + 1) * kVecPerRound; ++k) {
        c[r] += (q[k].x < limit) + (q[k].y < limit) + (q[k].z < limit) +
                (q[k].w < limit);
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      c[r] = 0;
      const long long lo = base + (long long)r * kRound;
      const long long hi = lo + kRound < n ? lo + kRound : n;
      for (long long i = lo + threadIdx.x; i < hi; i += kCompactThreads) {
        c[r] += __ldcs(dst + i) < limit;
      }
    }
  }
  const long long num_rounds = (n + kRound - 1) / kRound;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    int total;
    block_exclusive_scan<kCompactThreads>(c[r], s_warp, total);
    const long long idx = (long long)blockIdx.x * kRounds + r;
    if (threadIdx.x == 0 && idx < num_rounds) counts[idx] = total;
  }
}

// Exclusive scan of `counts` in one CTA, kScanThreads * kScanPer counts a
// tile.  Writes the total; a total other than `expected` (when >= 0) is a
// broken caller invariant and traps.
__global__ void __launch_bounds__(kScanThreads)
compact_scan_kernel(const int* __restrict__ counts, int num_blocks,
                    int* __restrict__ offsets, int* __restrict__ total,
                    long long expected) {
  constexpr int kTile = kScanThreads * kScanPer;
  __shared__ int s_warp[kScanThreads / 32];
  __shared__ int s_tile[kTile];
  const int tid = threadIdx.x;
  int run = 0;
  for (int base = 0; base < num_blocks; base += kTile) {
    // coalesced in and out through shared memory; each thread scans
    // kScanPer consecutive counts
#pragma unroll
    for (int k = 0; k < kScanPer; ++k) {
      const int i = base + tid + k * kScanThreads;
      s_tile[tid + k * kScanThreads] = i < num_blocks ? counts[i] : 0;
    }
    __syncthreads();
    int v[kScanPer];
    int c = 0;
#pragma unroll
    for (int q = 0; q < kScanPer; ++q) {
      v[q] = s_tile[tid * kScanPer + q];
      c += v[q];
    }
    int tile;
    int pos = run + block_exclusive_scan<kScanThreads>(c, s_warp, tile);
#pragma unroll
    for (int q = 0; q < kScanPer; ++q) {
      s_tile[tid * kScanPer + q] = pos;
      pos += v[q];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kScanPer; ++k) {
      const int i = base + tid + k * kScanThreads;
      if (i < num_blocks) offsets[i] = s_tile[tid + k * kScanThreads];
    }
    __syncthreads();                    // s_tile is read before the next tile
    run += tile;
  }
  if (threadIdx.x == 0) {
    *total = run;
    if (expected >= 0 && (long long)run != expected) __trap();
  }
}

// Rounds with no valid lane cost one read of their count.  A round is
// written in kRound / 1024 steps: in each, thread t takes 4 consecutive
// lanes with one coalesced load, so lane order is thread order.
__global__ void __launch_bounds__(kCompactThreads)
compact_write_kernel(const int* __restrict__ dst, long long n, int limit,
                     int vec, const int* __restrict__ counts,
                     const int* __restrict__ offsets,
                     int* __restrict__ dst_out, int* __restrict__ lane_out) {
  constexpr int kStep = kCompactThreads * 4;
  __shared__ int s_warp[kCompactThreads / 32];
  const long long num_rounds = (n + kRound - 1) / kRound;
  for (int round = 0; round < kRounds; ++round) {
    const long long idx = (long long)blockIdx.x * kRounds + round;
    if (idx >= num_rounds || counts[idx] == 0) continue;  // uniform
    int pos_base = offsets[idx];
    for (int step = 0; step < kRound / kStep; ++step) {
      const long long first = idx * kRound + (long long)step * kStep +
                              4LL * threadIdx.x;
      int v[4];
      if (vec && first + 4 <= n) {
        const int4 q = *reinterpret_cast<const int4*>(dst + first);
        v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q] = first + q < n ? dst[first + q] : limit;
      }
      const int c = (v[0] < limit) + (v[1] < limit) + (v[2] < limit) +
                    (v[3] < limit);
      int step_total;
      int pos = pos_base + block_exclusive_scan<kCompactThreads>(
                               c, s_warp, step_total);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (v[q] < limit) {
          dst_out[pos] = v[q];
          lane_out[pos] = (int)(first + q);
          ++pos;
        }
      }
      pos_base += step_total;
    }
  }
}

}  // namespace

// All launchers run on `stream` and return the cudaError_t of the last
// launch as an int (0 = launched).  The caller allocates every output and
// scratch buffer, at the sizes the `*_units`/`*_blocks` functions give, and
// checks shapes, types and devices.

// Units of work (carry-outs) of one combine over `num_edges` edges.
extern "C" long long segment_combine_units(int num_segments,
                                           long long num_edges, int d) {
  const long long items = (long long)num_segments + num_edges;
  const long long share = d == 1 ? kShare1 : kShareN;
  return (items + share - 1) / share;
}

// `op` is 0 = sum, 1 = min, 2 = max; `row_at [units + 1]` int32,
// `carry_row [units]` int32 and `carry_val [units, d]` float32 are scratch.
extern "C" int segment_combine_launch(const float* msgs, const int* seg_ptr,
                                      float* out, int* row_at, int* carry_row,
                                      float* carry_val, int num_units,
                                      int num_segments, int d, int op,
                                      void* stream) {
  if (num_segments <= 0 || d <= 0 || num_units <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (op) {
    case kSum:
      return launch_combine<kSum>(msgs, seg_ptr, out, row_at, carry_row,
                                  carry_val, num_units, num_segments, d, s);
    case kMin:
      return launch_combine<kMin>(msgs, seg_ptr, out, row_at, carry_row,
                                  carry_val, num_units, num_segments, d, s);
    case kMax:
      return launch_combine<kMax>(msgs, seg_ptr, out, row_at, carry_row,
                                  carry_val, num_units, num_segments, d, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Counts (rounds of kRound lanes) of the compaction over `n` lanes.
extern "C" long long compact_lanes_counts(long long n) {
  return (n + kRound - 1) / kRound;
}

// Count and scan: `counts`, `offsets [compact_lanes_counts(n)]` and
// `total [1]` int32.  `expected` >= 0 is the caller's count of valid lanes,
// checked on the card.
extern "C" int compact_lanes_count_launch(const int* dst, long long n,
                                          int limit, int* counts,
                                          int* offsets, int* total,
                                          long long expected, void* stream) {
  const long long num_counts = compact_lanes_counts(n);
  if (num_counts <= 0 || num_counts > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  const long long blocks = (n + kCompactChunk - 1) / kCompactChunk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = ((uintptr_t)dst & 15) == 0;
  compact_count_kernel<<<(unsigned)blocks, kCompactThreads, 0, s>>>(
      dst, n, limit, vec, counts);
  if (cudaPeekAtLastError() != cudaSuccess) return (int)cudaGetLastError();
  compact_scan_kernel<<<1, kScanThreads, 0, s>>>(
      counts, (int)num_counts, offsets, total, expected);
  return (int)cudaGetLastError();
}

// Write the valid lanes' dst and lane index in lane order.
extern "C" int compact_lanes_write_launch(const int* dst, long long n,
                                          int limit, const int* counts,
                                          const int* offsets, int* dst_out,
                                          int* lane_out, void* stream) {
  if (n <= 0 || compact_lanes_counts(n) > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  const long long blocks = (n + kCompactChunk - 1) / kCompactChunk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = ((uintptr_t)dst & 15) == 0;
  compact_write_kernel<<<(unsigned)blocks, kCompactThreads, 0, s>>>(
      dst, n, limit, vec, counts, offsets, dst_out, lane_out);
  return (int)cudaGetLastError();
}
