// EmbeddingBag for Hopper (sm_90a): a fused gather-weight-bag-sum forward
// and a sorted-run backward.
//
// Replaces the JAX package's `embedding_bag` (src/repro/kernels/ops.py:64):
// an XLA gather of the table rows, a per-id weight, then the Pallas
// segment combine (`segment_combine_pallas`) for the bag sum.  It computes
//
//   out[b, :] = Σ_{i : bags[i] = b} w[i] · table[ids[i], :]
//
// over `bags` sorted ascending, with w = 1 where no weights are given; an
// empty bag (trailing ones included) is a zero row, and positions whose
// bag is >= num_bags are dropped.  An id outside [0, num_rows) traps.
//
// Forward.  Merge-path load balance (Merrill & Garland, SC'16, as the
// combine kernel of csrc/segment_combine.cu) over the path that merges the
// num_bags bag ends with the n positions.  Position p lies at path index
// p + min(bags[p], num_bags), so a share's start is a search of `bags`
// itself: the op builds no row pointer.  A unit of work is a group of L
// lanes (L = the power of two at or above ceil(min(d, 128) / 4)); each lane
// holds 4 columns of a row, read with one 16-byte `ld.global.nc` where
// d % 4 = 0 (scalar loads else), so a warp runs 32 / L units and every
// unit keeps kAhead table rows in flight.  A unit takes `share` path items
// (positions and bag ends alike, so a hub bag and a run of empty bags are
// spread over as many units as their items fill).  It reads each of its
// positions' rows once, by id, scales it by its weight, sums in position
// order, and writes every bag that ends in its share once: no [n, d]
// intermediate.  The bag still open at its end is its carry-out; a second,
// small kernel folds each bag's carry-outs, in unit order, into the value
// the bag's last unit wrote.  No atomics.  Shares depend on (n, num_bags,
// d) alone, so the order of every sum is fixed by the shapes and the bag
// ids, and two launches give the same bits.  A warp finds its two ends
// with 16-ary searches, then each of its units its start with an L-ary
// search inside that range; columns past 128 are further grid rows.
//
// Backward (the table and weight gradients in one walk).  The table
// gradient is zeroed by one memset and the wrapper sorts the ids (a stable
// device sort: `sorted_ids`, `order`); then a unit walks `share` sorted
// positions.  Each run of equal ids sums w[order[j]] · cot[bags[order[j]]]
// in sorted order and writes its gradient row once; runs cut by a share end
// fold in unit order as in the forward.  In the same walk each position's
// weight gradient is <cot[bag], table[id]>: the table row is loaded once a
// run and the dot product is a fixed shuffle tree over the unit's lanes
// (plus a fixed-order sum over the column tiles where d > 128).  Only the
// gradients asked for are computed; without the table gradient there is no
// sort and the walk is in position order.
//
// Bound on the card: bytes.  Forward: ids, bag ids and weights once (4 to
// 8 bytes each a position), each distinct table row read once, the output
// written once, over 3.35 TB/s; one multiply-add a table element.
// Backward: those plus the cotangent, the whole [num_rows, d] table
// gradient written and the weight gradient.  What the design leaves on the
// table: a unit issues its next kAhead rows only after it has folded the
// last ones (no pipeline across batches); a random 64-byte row is two
// 32-byte sectors of a 128-byte line; the carry fold is a second launch.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;            // warps a block
constexpr int kThreads = 32 * kWarps;
// rows a unit loads ahead of its fold: on the H100, 2 ran 10-12% faster
// than 4 at d = 16 and 100 (40 registers a thread against 60, so more
// warps resident) and 8 slower still (tools/bench_embedding_bag.py)
constexpr int kAhead = 2;
constexpr int kTile = 128;           // columns a unit covers: 32 lanes x 4
constexpr int kSMs = 132;            // H100 SXM; shares follow the shapes only
constexpr int kMinShare = 16;
constexpr int kMaxShare = 512;
constexpr int kFoldWarps = 8;
constexpr int kDotThreads = 256;

__device__ __forceinline__ float4 zero4() {
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// Columns [col, col + 4) of `row` (col < d), zero past d.
__device__ __forceinline__ float4 load4(const float* __restrict__ row,
                                        int col, int d, int vec) {
  if (vec) return __ldg(reinterpret_cast<const float4*>(row + col));
  float4 q = zero4();
  q.x = __ldg(row + col);
  if (col + 1 < d) q.y = __ldg(row + col + 1);
  if (col + 2 < d) q.z = __ldg(row + col + 2);
  if (col + 3 < d) q.w = __ldg(row + col + 3);
  return q;
}

__device__ __forceinline__ void store4(float* row, int col, int d, int vec,
                                       float4 v) {
  if (vec) {
    *reinterpret_cast<float4*>(row + col) = v;
    return;
  }
  row[col] = v.x;
  if (col + 1 < d) row[col + 1] = v.y;
  if (col + 2 < d) row[col + 2] = v.z;
  if (col + 3 < d) row[col + 3] = v.w;
}

__device__ __forceinline__ float4 add_scaled(float4 acc, float w, float4 q) {
  acc.x += w * q.x;
  acc.y += w * q.y;
  acc.z += w * q.z;
  acc.w += w * q.w;
  return acc;
}

// The least y in [lo, hi] with y == hi or y + min(bags[y], num_bags) >= dg:
// the positions taken before diagonal dg of the merge path.  The warp's
// lanes form groups of H (a power of two up to 32); group g searches its
// own diagonal with H probes a round, which cut its range into H + 1 parts.
// Every lane of the warp must call it.
template <int H>
__device__ __forceinline__ long long path_search(long long dg, long long lo,
                                                 long long hi,
                                                 const int* __restrict__ bags,
                                                 int num_bags) {
  const int lane = threadIdx.x & 31;
  const int g = lane / H, hl = lane % H;
  const unsigned gmask = (H == 32) ? kFull : ((1u << H) - 1u);
  for (;;) {
    const bool active = lo < hi;
    if (!__any_sync(kFull, active)) break;
    const long long step = active ? (hi - lo + H) / (H + 1) : 0;
    const long long p = lo + (hl + 1) * step - 1;
    bool before = false;
    if (active && p < hi) {
      const int b = bags[p];
      before = p + (b < num_bags ? b : num_bags) < dg;
    }
    const unsigned bits = (__ballot_sync(kFull, before) >> (g * H)) & gmask;
    if (active) {
      const int k = __popc(bits);     // the probes before dg are a prefix
      const long long top = lo + (k + 1) * step - 1;   // probe k, if any
      lo += k * step;
      if (k < H && top < hi) hi = top;
    }
  }
  return lo;
}

struct Forward {
  const float* table;
  long long num_rows;
  int d, vec;
  const void* ids;                   // int32 or int64
  const float* weights;              // null: every weight is 1
  const int* bags;
  long long n;
  int num_bags, share;
  long long num_units;
  float* out;
  int* carry_row;
  float* carry_val;
};

template <int L, typename IdT>
__global__ void __launch_bounds__(kThreads)
embedding_bag_forward_kernel(const Forward a) {
  constexpr int P = 32 / L;          // units a warp
  const IdT* __restrict__ ids = static_cast<const IdT*>(a.ids);
  const int* __restrict__ bags = a.bags;
  const float* __restrict__ table = a.table;
  const int lane = threadIdx.x & 31, g = lane / L, c = lane % L;
  const long long first =
      ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * P;
  if (first >= a.num_units) return;  // the whole warp
  const long long total = (long long)a.num_bags + a.n;
  // the warp's two ends on the path: lanes 0-15 its start, 16-31 its end
  long long dw = (lane < 16 ? first : first + P) * a.share;
  if (dw > total) dw = total;
  const long long yw = path_search<16>(
      dw, dw - a.num_bags > 0 ? dw - a.num_bags : 0, dw < a.n ? dw : a.n,
      bags, a.num_bags);
  const long long yw0 = __shfl_sync(kFull, yw, 0);
  const long long yw1 = __shfl_sync(kFull, yw, 16);
  // this unit's start, inside the warp's range
  const long long unit = first + g;
  long long d0 = unit * a.share;
  if (d0 > total) d0 = total;
  long long y0 = yw0;
  if (P > 1) {
    long long lo = d0 - a.num_bags, hi = d0 < a.n ? d0 : a.n;
    if (lo < yw0) lo = yw0;
    if (hi > yw1) hi = yw1;
    y0 = path_search<L>(d0, lo, hi, bags, a.num_bags);
  }
  long long y1 = __shfl_down_sync(kFull, y0, L & 31);  // the next unit's
  if (g == P - 1) y1 = yw1;
  if (unit >= a.num_units) return;
  const long long d1 = d0 + a.share < total ? d0 + a.share : total;
  long long r = d0 - y0;             // bags that end before the share
  const long long x1 = d1 - y1;      // ... and before its end
  const int d = a.d, vec = a.vec;
  const int col = blockIdx.y * kTile + 4 * c;
  const bool on = col < d;
  float4 acc = zero4();
  for (long long y = y0; y < y1; y += kAhead) {
    float4 v[kAhead];
    int key[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const long long p = y + k;
      v[k] = zero4();
      key[k] = a.num_bags;
      if (p < y1) {
        const int b = bags[p];
        const long long id = (long long)ids[p];
        const float w = a.weights ? a.weights[p] : 1.0f;
        if (id < 0 || id >= a.num_rows) __trap();
        key[k] = b < a.num_bags ? b : a.num_bags;
        if (on && key[k] < a.num_bags) {
          v[k] = add_scaled(zero4(), w, load4(table + id * d, col, d, vec));
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (y + k < y1) {
        for (; r < key[k]; ++r) {    // bags that end before this position
          if (on) store4(a.out + r * d, col, d, vec, acc);
          acc = zero4();
        }
        acc.x += v[k].x;
        acc.y += v[k].y;
        acc.z += v[k].z;
        acc.w += v[k].w;
      }
    }
  }
  for (; r < x1; ++r) {              // bags that end after the last position
    if (on) store4(a.out + r * d, col, d, vec, acc);
    acc = zero4();
  }
  if (blockIdx.y == 0 && c == 0) a.carry_row[unit] = (int)x1;
  if (on) store4(a.carry_val + unit * d, col, d, vec, acc);
}

struct Backward {
  const float* table;
  long long num_rows;
  int d, vec;
  const void* sorted_ids;            // int32 or int64
  const long long* order;            // null: position order (no sort)
  const float* weights;
  const int* bags;
  const float* cot;
  long long n;
  int num_bags, share;
  long long num_units;
  float* grad_table;                 // null: not asked for
  float* dot_out;                    // null: not asked for; [tiles, n]
  int* carry_row;
  float* carry_val;
};

template <int L, typename IdT>
__global__ void __launch_bounds__(kThreads)
embedding_bag_backward_kernel(const Backward a) {
  constexpr int P = 32 / L;
  const IdT* __restrict__ sids = static_cast<const IdT*>(a.sorted_ids);
  const float* __restrict__ table = a.table;
  const float* __restrict__ cot = a.cot;
  const int lane = threadIdx.x & 31, g = lane / L, c = lane % L;
  const long long unit =
      ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * P + g;
  if (unit >= a.num_units) return;   // the unit's L lanes together
  const unsigned gmask = (L == 32) ? kFull : (((1u << L) - 1u) << (g * L));
  const int d = a.d, vec = a.vec;
  const int col = blockIdx.y * kTile + 4 * c;
  const bool on = col < d;
  const bool need_table = a.grad_table != nullptr;
  const bool need_w = a.dot_out != nullptr;
  float* dot_out = need_w ? a.dot_out + blockIdx.y * a.n : nullptr;
  const long long j0 = unit * a.share;
  const long long j1 = j0 + a.share < a.n ? j0 + a.share : a.n;
  long long cur = -1;                // the id of the open run
  float4 acc = zero4(), row = zero4();
  for (long long j = j0; j < j1; j += kAhead) {
    float4 cv[kAhead], tv[kAhead];
    long long id[kAhead], pos[kAhead];
    float w[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const long long jj = j + k;
      cv[k] = zero4();
      tv[k] = zero4();
      w[k] = 0.0f;
      id[k] = -1;
      pos[k] = 0;
      if (jj < j1) {
        pos[k] = a.order ? a.order[jj] : jj;
        id[k] = (long long)sids[jj];
        if (id[k] < 0 || id[k] >= a.num_rows) __trap();
        const int b = a.bags[pos[k]];
        w[k] = a.weights ? a.weights[pos[k]] : 1.0f;
        if (on && b >= 0 && b < a.num_bags) {
          cv[k] = load4(cot + (long long)b * d, col, d, vec);
        }
        const long long prev = k ? id[k - 1] : cur;
        if (need_w && on && id[k] != prev) {
          tv[k] = load4(table + id[k] * d, col, d, vec);   // once a run
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (j + k < j1) {
        if (id[k] != cur) {          // a run ends inside the share
          if (need_table && cur >= 0 && on) {
            store4(a.grad_table + cur * d, col, d, vec, acc);
          }
          cur = id[k];
          acc = zero4();
          row = tv[k];
        }
        if (need_table) acc = add_scaled(acc, w[k], cv[k]);
        if (need_w) {
          float s = cv[k].x * row.x + cv[k].y * row.y + cv[k].z * row.z +
                    cv[k].w * row.w;
#pragma unroll
          for (int off = L / 2; off > 0; off >>= 1) {
            s += __shfl_xor_sync(gmask, s, off);
          }
          if (c == 0) dot_out[pos[k]] = s;
        }
      }
    }
  }
  if (!need_table) return;
  // the last run: written here, or carried out when the next share goes on
  const bool open = cur >= 0 && j1 < a.n && (long long)sids[j1] == cur;
  if (cur >= 0 && !open && on) {
    store4(a.grad_table + cur * d, col, d, vec, acc);
  }
  if (blockIdx.y == 0 && c == 0) {
    a.carry_row[unit] = open ? (int)cur : (int)a.num_rows;
  }
  if (open && on) store4(a.carry_val + unit * d, col, d, vec, acc);
}

// One warp per unit u.  The head of each run of units whose carry row is r
// (< num_rows) folds the run's carries, in unit order, ahead of the value
// the row's last unit wrote: out[r] = (c_first + ... + c_last) + out[r].
__global__ void __launch_bounds__(32 * kFoldWarps)
embedding_bag_fold_kernel(const int* __restrict__ carry_row,
                          const float* __restrict__ carry_val,
                          float* __restrict__ out, long long num_units,
                          long long num_rows, int d) {
  const int lane = threadIdx.x & 31;
  const long long u = (long long)blockIdx.x * kFoldWarps + (threadIdx.x >> 5);
  if (u >= num_units) return;
  const int col = blockIdx.y * 32 + lane;
  const bool on = col < d;
  const long long r = carry_row[u];
  if (r >= num_rows || (u > 0 && carry_row[u - 1] == r)) return;
  float acc = 0.0f;
  for (long long base = u;; base += 32) {
    const long long k = base + lane;
    const bool in = k < num_units && carry_row[k] == r;
    const unsigned bits = __ballot_sync(kFull, in);
    const int m = __popc(bits);      // the run is contiguous: a prefix
    for (int q = 0; q < m; ++q) {
      if (on) acc += carry_val[(base + q) * d + col];
    }
    if (bits != kFull) break;
  }
  if (on) {
    float* o = out + r * d + col;
    *o = acc + *o;
  }
}

// The weight gradient where d > 128: the column tiles' dot products, summed
// in tile order.
__global__ void __launch_bounds__(kDotThreads)
embedding_bag_dot_tiles_kernel(const float* __restrict__ part, int tiles,
                               long long n, float* __restrict__ grad_w) {
  const long long p = (long long)blockIdx.x * kDotThreads + threadIdx.x;
  if (p >= n) return;
  float s = part[p];
  for (int t = 1; t < tiles; ++t) s += part[t * n + p];
  grad_w[p] = s;
}

int lanes_for(int d) {
  const int width = d < kTile ? d : kTile;
  int lanes = 1;
  while (4 * lanes < width) lanes <<= 1;
  return lanes;
}

int share_for(long long items, int d) {
  // about one unit for every L threads the card holds at once
  const long long want = (long long)kSMs * 2048 / lanes_for(d);
  long long s = (items + want - 1) / want;
  if (s < kMinShare) s = kMinShare;
  if (s > kMaxShare) s = kMaxShare;
  return (int)s;
}

long long units_for(long long items, int d) {
  const int s = share_for(items, d);
  return (items + s - 1) / s;
}

bool aligned(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <typename IdT>
void forward_by_lanes(int lanes, dim3 grid, cudaStream_t s, const Forward& a) {
  switch (lanes) {
    case 1: embedding_bag_forward_kernel<1, IdT><<<grid, kThreads, 0, s>>>(a); break;
    case 2: embedding_bag_forward_kernel<2, IdT><<<grid, kThreads, 0, s>>>(a); break;
    case 4: embedding_bag_forward_kernel<4, IdT><<<grid, kThreads, 0, s>>>(a); break;
    case 8: embedding_bag_forward_kernel<8, IdT><<<grid, kThreads, 0, s>>>(a); break;
    case 16: embedding_bag_forward_kernel<16, IdT><<<grid, kThreads, 0, s>>>(a); break;
    default: embedding_bag_forward_kernel<32, IdT><<<grid, kThreads, 0, s>>>(a); break;
  }
}

template <typename IdT>
void backward_by_lanes(int lanes, dim3 grid, cudaStream_t s, const Backward& a) {
  switch (lanes) {
    case 1: embedding_bag_backward_kernel<1, IdT><<<grid, kThreads, 0, s>>>(a); break;
    case 2: embedding_bag_backward_kernel<2, IdT><<<grid, kThreads, 0, s>>>(a); break;
    case 4: embedding_bag_backward_kernel<4, IdT><<<grid, kThreads, 0, s>>>(a); break;
    case 8: embedding_bag_backward_kernel<8, IdT><<<grid, kThreads, 0, s>>>(a); break;
    case 16: embedding_bag_backward_kernel<16, IdT><<<grid, kThreads, 0, s>>>(a); break;
    default: embedding_bag_backward_kernel<32, IdT><<<grid, kThreads, 0, s>>>(a); break;
  }
}

// The carry fold over `num_units` carries into `out` ([num_rows, d]).
int launch_fold(const int* carry_row, const float* carry_val, float* out,
                long long num_units, long long num_rows, int d,
                cudaStream_t s) {
  const dim3 grid((unsigned)((num_units + kFoldWarps - 1) / kFoldWarps),
                  (unsigned)((d + 31) / 32));
  embedding_bag_fold_kernel<<<grid, 32 * kFoldWarps, 0, s>>>(
      carry_row, carry_val, out, num_units, num_rows, d);
  return (int)cudaGetLastError();
}

dim3 walk_grid(long long num_units, int d) {
  const int per_block = kWarps * (32 / lanes_for(d));
  return dim3((unsigned)((num_units + per_block - 1) / per_block),
              (unsigned)((d + kTile - 1) / kTile));
}

}  // namespace

// Both launchers run on `stream` and return the cudaError_t of the last
// launch as an int (0 = launched).  The caller allocates every output and
// scratch buffer (carry_row [units] int32, carry_val [units, d] float32,
// units = embedding_bag_units(items, d)) and checks shapes, types and
// devices.

// Units of work (carry-outs) over `items` path items: num_bags + n for the
// forward, n for the backward.
extern "C" long long embedding_bag_units(long long items, int d) {
  return units_for(items, d);
}

// out [num_bags, d]; `ids64` says whether ids are int64 (else int32).
extern "C" int embedding_bag_forward_launch(
    const float* table, long long num_rows, int d, const void* ids,
    int ids64, const float* weights, const int* bags, long long n,
    int num_bags, float* out, int* carry_row, float* carry_val,
    void* stream) {
  const long long items = (long long)num_bags + n;
  if (num_bags <= 0 || d <= 0 || n < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Forward a;
  a.table = table;
  a.num_rows = num_rows;
  a.d = d;
  a.vec = d % 4 == 0 && aligned(table) && aligned(out) && aligned(carry_val);
  a.ids = ids;
  a.weights = weights;
  a.bags = bags;
  a.n = n;
  a.num_bags = num_bags;
  a.share = share_for(items, d);
  a.num_units = units_for(items, d);
  a.out = out;
  a.carry_row = carry_row;
  a.carry_val = carry_val;
  const dim3 grid = walk_grid(a.num_units, d);
  if (ids64) {
    forward_by_lanes<long long>(lanes_for(d), grid, s, a);
  } else {
    forward_by_lanes<int>(lanes_for(d), grid, s, a);
  }
  if (cudaPeekAtLastError() != cudaSuccess) return (int)cudaGetLastError();
  return launch_fold(carry_row, carry_val, out, a.num_units, num_bags, d, s);
}

// Zero `bytes` at `p` with one memset: the table gradient, before the ids
// are sorted, so that the sort's host work overlaps it.
extern "C" int embedding_bag_zero_launch(void* p, long long bytes,
                                         void* stream) {
  return (int)cudaMemsetAsync(p, 0, (size_t)bytes,
                              static_cast<cudaStream_t>(stream));
}

// The gradients asked for: grad_table [num_rows, d] (zeroed by
// embedding_bag_zero_launch; null: not asked for) over the stable
// ids-sorted order (`sorted_ids`, `order`), and grad_w [n] (null: not asked
// for; `dot_part` [ceil(d / 128), n] scratch where d > 128).  Without
// grad_table, `order` may be null and `sorted_ids` the ids in position
// order.
extern "C" int embedding_bag_backward_launch(
    const float* table, long long num_rows, int d, const void* sorted_ids,
    int ids64, const long long* order, const float* weights, const int* bags,
    const float* cot, long long n, int num_bags, float* grad_table,
    float* grad_w, float* dot_part, int* carry_row, float* carry_val,
    void* stream) {
  if (n <= 0 || d <= 0 || num_bags < 0) return (int)cudaErrorInvalidValue;
  const int tiles = (d + kTile - 1) / kTile;
  if (grad_w && tiles > 1 && !dot_part) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Backward a;
  a.table = table;
  a.num_rows = num_rows;
  a.d = d;
  a.vec = d % 4 == 0 && aligned(table) && aligned(cot) &&
          (!grad_table || (aligned(grad_table) && aligned(carry_val)));
  a.sorted_ids = sorted_ids;
  a.order = order;
  a.weights = weights;
  a.bags = bags;
  a.cot = cot;
  a.n = n;
  a.num_bags = num_bags;
  a.share = share_for(n, d);
  a.num_units = units_for(n, d);
  a.grad_table = grad_table;
  a.dot_out = grad_w ? (tiles > 1 ? dot_part : grad_w) : nullptr;
  a.carry_row = carry_row;
  a.carry_val = carry_val;
  const dim3 grid = walk_grid(a.num_units, d);
  if (ids64) {
    backward_by_lanes<long long>(lanes_for(d), grid, s, a);
  } else {
    backward_by_lanes<int>(lanes_for(d), grid, s, a);
  }
  if (cudaPeekAtLastError() != cudaSuccess) return (int)cudaGetLastError();
  if (grad_table) {
    const int rc = launch_fold(carry_row, carry_val, grad_table, a.num_units,
                               num_rows, d, s);
    if (rc != 0) return rc;
  }
  if (grad_w && tiles > 1) {
    embedding_bag_dot_tiles_kernel<<<(unsigned)((n + kDotThreads - 1) /
                                                kDotThreads),
                                     kDotThreads, 0, s>>>(dot_part, tiles, n,
                                                          grad_w);
  }
  return (int)cudaGetLastError();
}
