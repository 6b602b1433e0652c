// The dense Scatter-Combine scan's messages, for Hopper (sm_90a): one pass
// over the dst-sorted edge columns that writes each edge's message, ready
// for the combine kernel (csrc/segment_combine.cu).
//
// Replaces no TPU kernel.  The JAX package forms these messages with XLA's
// `jnp.take` and elementwise operations (src/repro/core/engine.py,
// `dense_scatter_combine`), which XLA fuses on the TPU; the port ran them
// as separate PyTorch passes (`index_select` of the values, of the
// activity, the message, the mask, the select), each a full read and write
// of the [E] edges.  This kernel is that fusion, and more.  It computes
//
//   dense frontier:  msg[e] = form(x[src[e]], prop[e])
//   otherwise:       msg[e] = active[src[e]] && edge_mask[e]
//                              ? form(x[src[e]], prop[e]) : identity
//
// with form one of copy (x), add_prop (x + prop, one round-to-nearest
// float32 add) and add_one (x + 1).  The output is a pure function of the
// inputs: no atomics, no order.
//
// Bound on the card: bytes.  The streamed columns (the source index, and
// prop and edge_mask where read) and the message write, E*(4 + 4 + [4] +
// [1]) bytes, plus the value table (and the activity bytes) once, over
// 3.35 TB/s.  What decides how close it comes is the gather: each edge
// reads 4 bytes at a data-dependent address, a 32-byte sector from DRAM
// on a miss, and a warp's 32 gathers touch up to 32 cache lines.  A
// Graph500 R-MAT graph at scale 24 reads a 67 MB value table, over the
// 50 MB L2, and its vertex ids are a random permutation, so the few hubs
// that most edges read are spread over as many sectors as there are hubs:
// gathered by slot, the pass reads near every sector from DRAM (3.36 ms
// for 263M edges on an H100, with the cache hints below; `index_select`
// 3.55 ms).  So:
//   * the caller gives a ranking of the source slots by how many edges
//     read them (`order`, and each edge's rank as its index, built once a
//     partition): a first kernel, `gather_table_kernel`, copies the values
//     (and activity flags) of the slots any edge reads into a table in
//     that order, and the edges gather from it.  The hubs' values then
//     share sectors and the hot part of the table stays in L2 (2.02 ms for
//     the same edges; 2.06 ms from a 1 MB table: what is left is the cost
//     of a warp's 32 scattered reads in L1 and L2);
//   * the main kernel is persistent, one CTA of 1024 threads an SM, and
//     each CTA first copies the table's first 192 KB, its hottest rows,
//     into shared memory: the edges that read them (~45% of R-MAT's) cost a
//     shared-memory read and no L1 request (1.53 ms);
//   * with activity, a table row is 8 bytes, the value and the flag, so an
//     edge costs one read for both;
//   * each thread takes 4 vectors of 4 consecutive edges a tile (16-byte
//     loads of the index and of prop, 4 bytes of edge_mask; the warp's
//     loads of one vector are one 512-byte run), and issues the reads of
//     its 16 edges before it uses any, so misses overlap;
//   * the streamed columns are read around L1 with an L2 evict-first
//     policy and the messages stored streaming (`st.global.cs`), while the
//     gathers go through the read-only path with an L2 evict-last policy;
//   * the form and the activity route are template parameters, so an edge
//     costs at most one select.
// Pointers that are not 16-byte aligned (4 for edge_mask) take the same
// walk one edge at a time.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;                // one resident CTA an SM
constexpr int kVecs = 4;                      // vectors of 4 edges a thread
constexpr int kEdgesPerThread = 4 * kVecs;
constexpr long long kEdgesPerTile = (long long)kThreads * kEdgesPerThread;
constexpr int kHotBytes = 192 * 1024;         // shared copy of the hot rows
constexpr int kTableThreads = 256;

enum Form { kCopy = 0, kAddProp = 1, kAddOne = 2 };

__device__ __forceinline__ uint64_t l2_policy_evict_first() {
  uint64_t p;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
      : "=l"(p));
  return p;
}

__device__ __forceinline__ uint64_t l2_policy_evict_last() {
  uint64_t p;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
      : "=l"(p));
  return p;
}

// ---- streamed loads: read once, around L1, evict-first in L2
__device__ __forceinline__ int4 stream_v4(const int* p, uint64_t pol) {
  int4 v;
  asm(
      "ld.global.nc.L1::no_allocate.L2::cache_hint.v4.s32 {%0, %1, %2, %3}, "
      "[%4], %5;"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p), "l"(pol));
  return v;
}

__device__ __forceinline__ float4 stream_v4(const float* p, uint64_t pol) {
  float4 v;
  asm(
      "ld.global.nc.L1::no_allocate.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, "
      "[%4], %5;"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p), "l"(pol));
  return v;
}

__device__ __forceinline__ uint32_t stream_u32(const uint8_t* p,
                                               uint64_t pol) {
  uint32_t v;
  asm("ld.global.nc.L1::no_allocate.L2::cache_hint.u32 %0, [%1], %2;"
      : "=r"(v)
      : "l"(p), "l"(pol));
  return v;
}

__device__ __forceinline__ int stream_s32(const int* p, uint64_t pol) {
  int v;
  asm("ld.global.nc.L1::no_allocate.L2::cache_hint.s32 %0, [%1], %2;"
      : "=r"(v)
      : "l"(p), "l"(pol));
  return v;
}

__device__ __forceinline__ float stream_f32(const float* p, uint64_t pol) {
  float v;
  asm("ld.global.nc.L1::no_allocate.L2::cache_hint.f32 %0, [%1], %2;"
      : "=f"(v)
      : "l"(p), "l"(pol));
  return v;
}

__device__ __forceinline__ uint32_t stream_u8(const uint8_t* p,
                                              uint64_t pol) {
  uint32_t v;
  asm("ld.global.nc.L1::no_allocate.L2::cache_hint.u8 %0, [%1], %2;"
      : "=r"(v)
      : "l"(p), "l"(pol));
  return v;
}

// ---- gathers: the read-only path, evict-last in L2
__device__ __forceinline__ float gather_f32(const float* p, uint64_t pol) {
  float v;
  asm("ld.global.nc.L2::cache_hint.f32 %0, [%1], %2;"
      : "=f"(v)
      : "l"(p), "l"(pol));
  return v;
}

__device__ __forceinline__ uint2 gather_u2(const uint2* p, uint64_t pol) {
  uint2 v;
  asm("ld.global.nc.L2::cache_hint.v2.u32 {%0, %1}, [%2], %3;"
      : "=r"(v.x), "=r"(v.y)
      : "l"(p), "l"(pol));
  return v;
}

template <int FORM>
__device__ __forceinline__ float form(float x, float w) {
  if (FORM == kAddProp) return __fadd_rn(x, w);
  if (FORM == kAddOne) return __fadd_rn(x, 1.0f);
  return x;
}

// Table rows: the value (ACT = false), or the value's bits and the
// activity flag (ACT = true).
template <bool ACT>
struct Row;
template <>
struct Row<false> {
  using type = float;
};
template <>
struct Row<true> {
  using type = uint2;
};

// Whether an edge whose mask byte is `m` is live, and its value, from its
// table row: row i of the CTA's shared copy where i < hot_rows, else a
// gather (made only where the mask lets the edge through).
template <bool ACT>
__device__ __forceinline__ bool lookup(const typename Row<ACT>::type* table,
                                       const typename Row<ACT>::type* hot,
                                       int hot_rows, int i, uint32_t m,
                                       uint64_t keep, float* value) {
  if (!ACT) {
    *value = i < hot_rows
                 ? reinterpret_cast<const float*>(hot)[i]
                 : gather_f32(reinterpret_cast<const float*>(table) + i, keep);
    return true;
  }
  if (m == 0u) return false;
  const uint2 row =
      i < hot_rows ? reinterpret_cast<const uint2*>(hot)[i]
                   : gather_u2(reinterpret_cast<const uint2*>(table) + i, keep);
  *value = __uint_as_float(row.x);
  return row.y != 0u;
}

// One edge's message: the walk of unaligned columns and the last 0-3 edges.
template <int FORM, bool ACT>
__device__ __forceinline__ float message1(
    long long e, const int* __restrict__ idx,
    const typename Row<ACT>::type* __restrict__ table,
    const typename Row<ACT>::type* hot, int hot_rows,
    const float* __restrict__ prop, const uint8_t* __restrict__ mask,
    float identity, uint64_t stream, uint64_t keep) {
  const int i = stream_s32(idx + e, stream);
  const uint32_t m = ACT ? stream_u8(mask + e, stream) : 1u;
  float x = 0.0f;
  if (!lookup<ACT>(table, hot, hot_rows, i, m, keep, &x)) return identity;
  const float w = FORM == kAddProp ? stream_f32(prop + e, stream) : 0.0f;
  return form<FORM>(x, w);
}

// The edges of tile t, [t * kEdgesPerTile, (t + 1) * kEdgesPerTile).  With
// `vec`, vector k of thread j is the tile's vector j + k * kThreads.
template <int FORM, bool ACT>
__device__ __forceinline__ void tile_messages(
    long long t, long long tiles, const int* __restrict__ idx,
    const typename Row<ACT>::type* __restrict__ table,
    const typename Row<ACT>::type* hot, int hot_rows,
    const float* __restrict__ prop, const uint8_t* __restrict__ mask,
    float* __restrict__ msgs, long long num_edges, float identity, int vec,
    uint64_t stream, uint64_t keep) {
  const long long base = t * kEdgesPerTile;
  if (!vec) {
#pragma unroll 4
    for (int k = 0; k < kEdgesPerThread; ++k) {
      const long long e = base + threadIdx.x + (long long)k * kThreads;
      if (e < num_edges) {
        __stcs(msgs + e,
               message1<FORM, ACT>(e, idx, table, hot, hot_rows, prop, mask,
                                   identity, stream, keep));
      }
    }
    return;
  }
  const long long num_vecs = num_edges / 4;
  const long long v0 = base / 4 + threadIdx.x;
  // the streamed columns of 16 edges, then every lookup, then the stores
  int si[kEdgesPerThread];
  float wi[kEdgesPerThread];
  uint32_t mi[kVecs];
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const long long v = v0 + (long long)k * kThreads;
    int4 s = make_int4(0, 0, 0, 0);
    float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
    mi[k] = 0u;
    if (v < num_vecs) {
      s = stream_v4(idx + 4 * v, stream);
      if (FORM == kAddProp) w = stream_v4(prop + 4 * v, stream);
      if (ACT) mi[k] = stream_u32(mask + 4 * v, stream);
    }
    si[4 * k] = s.x, si[4 * k + 1] = s.y, si[4 * k + 2] = s.z,
    si[4 * k + 3] = s.w;
    wi[4 * k] = w.x, wi[4 * k + 1] = w.y, wi[4 * k + 2] = w.z,
    wi[4 * k + 3] = w.w;
  }
  bool live[kEdgesPerThread];
  float xi[kEdgesPerThread];
#pragma unroll
  for (int i = 0; i < kEdgesPerThread; ++i) {
    xi[i] = 0.0f;
    live[i] = lookup<ACT>(table, hot, hot_rows, si[i],
                          (mi[i / 4] >> (8 * (i % 4))) & 0xffu, keep, &xi[i]);
  }
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const long long v = v0 + (long long)k * kThreads;
    float o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = 4 * k + j;
      o[j] = live[i] ? form<FORM>(xi[i], wi[i]) : identity;
    }
    if (v < num_vecs) {
      __stcs(reinterpret_cast<float4*>(msgs) + v,
             make_float4(o[0], o[1], o[2], o[3]));
    }
  }
  // the last 0-3 edges, past the last whole vector
  const long long e = num_vecs * 4 + threadIdx.x;
  if (t == tiles - 1 && threadIdx.x < 4 && e < num_edges) {
    __stcs(msgs + e, message1<FORM, ACT>(e, idx, table, hot, hot_rows, prop,
                                         mask, identity, stream, keep));
  }
}

// Persistent: each CTA copies the table's first `hot_rows` rows into shared
// memory, then walks the tiles blockIdx.x, blockIdx.x + gridDim.x, ...
template <int FORM, bool ACT>
__global__ void __launch_bounds__(kThreads, 1)
gather_messages_kernel(const int* __restrict__ idx,
                       const typename Row<ACT>::type* __restrict__ table,
                       int hot_rows, const float* __restrict__ prop,
                       const uint8_t* __restrict__ mask,
                       float* __restrict__ msgs, long long num_edges,
                       float identity, int vec) {
  using T = typename Row<ACT>::type;
  extern __shared__ __align__(16) unsigned char hot_bytes[];
  T* hot = reinterpret_cast<T*>(hot_bytes);
  for (int r = threadIdx.x; r < hot_rows; r += kThreads) hot[r] = table[r];
  __syncthreads();
  const uint64_t stream = l2_policy_evict_first();
  const uint64_t keep = l2_policy_evict_last();
  const long long tiles = (num_edges + kEdgesPerTile - 1) / kEdgesPerTile;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    tile_messages<FORM, ACT>(t, tiles, idx, table, hot, hot_rows, prop, mask,
                             msgs, num_edges, identity, vec, stream, keep);
  }
}

// table[r] = the row of slot order[r], for r < rows.
template <bool ACT>
__global__ void __launch_bounds__(kTableThreads)
gather_table_kernel(const float* __restrict__ x,
                    const uint8_t* __restrict__ active,
                    const int* __restrict__ order, long long rows,
                    typename Row<ACT>::type* __restrict__ table) {
  const long long r = (long long)blockIdx.x * kTableThreads + threadIdx.x;
  if (r >= rows) return;
  const int o = order[r];
  if (ACT) {   // an inactive row's value is never read
    const uint32_t live = __ldg(active + o);
    reinterpret_cast<uint2*>(table)[r] =
        make_uint2(live ? __float_as_uint(__ldg(x + o)) : 0u, live);
  } else {
    reinterpret_cast<float*>(table)[r] = __ldg(x + o);
  }
}

template <int FORM, bool ACT>
int launch(const int* idx, const float* x, const uint8_t* active,
           const int* order, long long rows, void* table, const float* prop,
           const uint8_t* mask, float* msgs, long long num_edges,
           float identity, int vec, cudaStream_t s) {
  using T = typename Row<ACT>::type;
  gather_table_kernel<ACT><<<
      (unsigned)((rows + kTableThreads - 1) / kTableThreads), kTableThreads, 0,
      s>>>(x, active, order, rows, static_cast<T*>(table));
  if (cudaPeekAtLastError() != cudaSuccess) return (int)cudaGetLastError();
  const long long cap = kHotBytes / (long long)sizeof(T);
  const int hot_rows = (int)(rows < cap ? rows : cap);
  // The shared-memory limit and the SM count belong to the current device:
  // set and read at every launch (each a host call of well under a
  // microsecond), so that a process may launch on any of its cards.
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(gather_messages_kernel<FORM, ACT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kHotBytes);
  }
  if (e != cudaSuccess) return (int)e;
  const long long tiles = (num_edges + kEdgesPerTile - 1) / kEdgesPerTile;
  const unsigned blocks = (unsigned)(tiles < sms ? tiles : (long long)sms);
  gather_messages_kernel<FORM, ACT>
      <<<blocks, kThreads, (size_t)hot_rows * sizeof(T), s>>>(
          idx, static_cast<const T*>(table), hot_rows, prop, mask, msgs,
          num_edges, identity, vec);
  return (int)cudaGetLastError();
}

template <int FORM>
int launch_form(const int* idx, const float* x, const uint8_t* active,
                const int* order, long long rows, void* table,
                const float* prop, const uint8_t* mask, float* msgs,
                long long num_edges, float identity, int vec,
                cudaStream_t s) {
  if (active != nullptr) {
    return launch<FORM, true>(idx, x, active, order, rows, table, prop, mask,
                              msgs, num_edges, identity, vec, s);
  }
  return launch<FORM, false>(idx, x, active, order, rows, table, prop, mask,
                             msgs, num_edges, identity, vec, s);
}

}  // namespace

// `msgs [num_edges]` float32.  Edge e reads row `idx[e]` (int32) of a table
// of `rows` rows built here from `order [rows]` int32, a ranking of the
// slots of `x [slots]` float32 that the edges read: row r holds slot
// order[r]'s value (and its activity flag).  `form` is 0 = copy,
// 1 = add_prop (reads `prop [num_edges]` float32), 2 = add_one.
// `active [slots]` and `mask [num_edges]` (bool bytes) are both given (the
// activity route) or both null (the dense frontier).  `table` is scratch
// of `rows` rows of 8 bytes with activity, 4 without.  `identity` is
// written where an edge is not live.  Runs on `stream`; returns the
// cudaError_t of the last launch as an int (0 = launched).  The caller
// allocates `msgs` and `table` and checks shapes, types and devices.
extern "C" int gather_messages_launch(const int* idx, const float* x,
                                      const int* order, long long rows,
                                      void* table, const float* prop,
                                      const void* active, const void* mask,
                                      float* msgs, long long num_edges,
                                      int form, float identity,
                                      void* stream) {
  const auto act = static_cast<const uint8_t*>(active);
  const auto msk = static_cast<const uint8_t*>(mask);
  if (num_edges <= 0 || rows <= 0 || order == nullptr || table == nullptr ||
      (act == nullptr) != (msk == nullptr) ||
      (form == kAddProp && prop == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const int vec = ((uintptr_t)idx % 16 == 0 && (uintptr_t)msgs % 16 == 0 &&
                   (form != kAddProp || (uintptr_t)prop % 16 == 0) &&
                   (msk == nullptr || (uintptr_t)msk % 4 == 0))
                      ? 1
                      : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cudaPeekAtLastError() != cudaSuccess) return (int)cudaGetLastError();
  switch (form) {
    case kCopy:
      return launch_form<kCopy>(idx, x, act, order, rows, table, prop, msk,
                                msgs, num_edges, identity, vec, s);
    case kAddProp:
      return launch_form<kAddProp>(idx, x, act, order, rows, table, prop,
                                   msk, msgs, num_edges, identity, vec, s);
    case kAddOne:
      return launch_form<kAddOne>(idx, x, act, order, rows, table, prop, msk,
                                  msgs, num_edges, identity, vec, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
