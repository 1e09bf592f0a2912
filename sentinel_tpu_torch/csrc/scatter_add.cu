// Scatter-add of an event stream into a counter table, for Hopper (sm_90a).
//
//     counters[key_i, event_i] += amount_i        for every stream element i
//
// Replaces the JAX package's Pallas TPU kernel
// sentinel_tpu/ops/pallas_kernels.py::_tile_kernel (launched by
// scatter_add_pallas). The TPU form is a one-hot matmul on the MXU over a
// (K/512, N/2048) grid with f32 partials per tile; it scans the whole stream
// once per K-tile. None of that carries over: here the stream is read once
// and every nonzero amount lands with an atomic, so the work is O(N) whatever
// K is.
//
// Semantics follow scatter_add_xla (the JAX package's reference form,
// ``counters.at[keys, events].add(amounts, mode="drop")``), not the MXU form:
//   * a negative key or event wraps ONCE (-1 -> K-1), as JAX normalises
//     negative indices before the scatter; anything still out of range after
//     that is dropped (keys >= K are the callers' padding convention).
//   * duplicates accumulate; zero amounts are skipped (they change no value).
//   * the table may be a strided view: row r starts at r * row_stride.
//   * the update is in place; nothing is allocated or synchronised.
//
// Payload mode (events == nullptr): each stream element is a row of E
// amounts, lane j landing in column j (``counters[key_i, :] += payload[i, :]``,
// the window's add_rows_vec and the one-lane tables: breaker counts, thread
// gauges, rt_sum).
//
// Exactness. int32 counters accumulate exactly and the result does not
// depend on the order the additions land in (integer addition is
// associative and wraps mod 2^32 like XLA's int32 add). The float32 form
// converts each int32 amount to float and adds in whatever order the warp
// combining, the shared-memory partials and the atomics produce: exact while
// every partial sum stays below 2^24, run-to-run dependent above that, as
// with index_add_. One sign case: a skipped zero (an amount of 0, or a
// per-block partial that sums to 0) leaves a -0.0 counter at -0.0 where the
// reference's +0.0 add gives +0.0. The window's rt_sum holds -0.0 only after
// refresh multiplied a negative sum by 0, which needs a negative rt_ms; the
// runtime's response times are never negative.
//
// What bounds it on an H100 (3.35 TB/s HBM3): the stream's bytes, read once,
// plus one 32-byte sector read and written back for each distinct sector of
// the table that a nonzero amount touches. At the main path's shapes
// (N = 2^19, 1/4 of the keys on 4096 hot rows, the rest uniform over
// R = 2^20 rows), as chip_smoke.py counts it from its inputs:
//   decide, int32 [R,8] slice of [R,2,8] (event mode)    27.3 MB   8.1 us
//   exit, payload E = 8 on the same slice                 39.9 MB  11.9 us
//   rt_hist int32 [R,32] (event mode)                     31.0 MB   9.3 us
//   rt_sum f32 [R,1], row stride 2 (payload E = 1)        15.5 MB   4.6 us
//   breaker counts int32 [1025,1] (payload E = 1)          4.2 MB   1.3 us
// Almost all of it is the distinct sectors: some 330k random 32-byte
// read-modify-writes on the large tables, which no schedule avoids and
// which HBM serves far below its streaming rate (one index_add_ takes as
// long, cold). What the design does about that bound:
//   * the stream is read with 16-byte streaming loads (__ldcs, evict-first,
//     so it does not push counter lines out of L2), several elements per
//     thread, every load issued before the first atomic, so each thread
//     keeps several independent atomics in flight;
//   * the mode and, in payload mode, E (1, 8, 32, or generic) are template
//     parameters, and index math is 32-bit when K * row_stride < 2^31 and
//     every stream position fits (launch() refuses a plan that claims 32
//     bits otherwise): no division or 64-bit multiply per element;
//   * zero amounts are skipped before any address is formed (an exit
//     payload row has 1-2 nonzero lanes of 8; 15/16 of the breaker lanes
//     are zeros on the ND row);
//   * warp combining turns a warp's equal addresses into one atomic
//     (__match_any_sync on the flat address, the group's sum by
//     __reduce_add_sync or shuffles, added by the group's leader), so a hot
//     key does not serialise 2^19 atomics on one L2 line. A neighbour probe
//     (one shuffle, one ballot) runs the match only in warps that hold a
//     duplicate: on a uniform stream the match finds nothing, and running
//     it on every amount added some 40% to the warm time;
//   * a small table (K * E * 4 <= 227 KB) whose private copies, one per
//     block, hold fewer cells than the stream has amounts is privatised:
//     each persistent block zero-fills a copy in shared memory, adds its
//     share of the stream with shared-memory atomics and flushes only its
//     nonzero cells, one global atomic each;
//   * the grid comes from the device's SM count
//     (cudaDevAttrMultiProcessorCount), not a constant.
// The launch plan (path, instantiation, index width, grid, block, shared
// bytes) is chosen by ops/scatter_add.py::plan and passed in.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libscatter_add.so scatter_add.cu
// (sentinel_tpu_torch/ops/_build.py does this at first use). The C functions
// launch on the stream they are given, allocate nothing, do not synchronise,
// and return cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kPathGlobal = 0;
constexpr int kPathShared = 1;
constexpr int kMaxBlock = 1024;

struct Args {
  void* counters;
  long long row_stride;
  int K;
  int E;
  const int32_t* keys;
  const int32_t* events;   // nullptr: payload mode
  const int32_t* amounts;
  long long n;             // stream elements (rows in payload mode)
  int vec;                 // every stream pointer is 16-byte aligned
};

// Stream elements (payload: rows) each thread loads before its first
// atomic. Mirrored by ops/scatter_add.py::units_per_thread.
__host__ __device__ constexpr int units(bool payload, int et) {
  return !payload ? 4 : et == 1 ? 4 : et == 8 ? 2 : 1;
}

__device__ __forceinline__ void atomic_add(int32_t* p, int32_t v) {
  atomicAdd(reinterpret_cast<int*>(p), static_cast<int>(v));
}

__device__ __forceinline__ void atomic_add(float* p, float v) {
  atomicAdd(p, v);
}

// Sum of ``a`` over the lanes of ``grp`` (all of which call this).
__device__ __forceinline__ int32_t group_sum(unsigned grp, int32_t a,
                                             const int32_t*) {
  return static_cast<int32_t>(
      __reduce_add_sync(grp, static_cast<unsigned>(a)));
}

__device__ __forceinline__ float group_sum(unsigned grp, int32_t a,
                                           const float*) {
  const float x = static_cast<float>(a);
  if ((grp & (grp - 1)) == 0) return x;
  float s = 0.0f;
  for (unsigned m = grp; m != 0; m &= m - 1)
    s += __shfl_sync(grp, x, __ffs(m) - 1);
  return s;
}

// One amount for flat cell ``addr`` of ``base``. Every lane of the warp
// calls this at the same point of the walk (the walk is warp-uniform). A
// warp in which some lane's address equals its neighbour's (one shuffle,
// one ballot) groups its equal addresses with __match_any_sync and adds each
// group's sum once; any other warp adds one atomic per amount, since the
// match costs far more than the probe and finds nothing on a uniform stream.
template <typename T, typename IDX>
__device__ __forceinline__ void emit(T* base, IDX addr, int32_t a, bool ok) {
  const unsigned live = __ballot_sync(kFull, ok);
  const unsigned lane = threadIdx.x & 31;
  const unsigned low = static_cast<unsigned>(addr);
  const unsigned next = __shfl_down_sync(kFull, low, 1);
  const bool dup = ok && lane < 31 && ((live >> (lane + 1)) & 1u) &&
                   next == low;
  if (__ballot_sync(kFull, dup) == 0) {
    if (ok) atomic_add(base + addr, static_cast<T>(a));
    return;
  }
  if (!ok) return;
  const unsigned grp = __match_any_sync(live, addr);
  const T sum = group_sum(grp, a, base);
  if (static_cast<int>(lane) == __ffs(grp) - 1) atomic_add(base + addr, sum);
}

__device__ __forceinline__ int4 ld4(const int32_t* p) {
  return __ldcs(reinterpret_cast<const int4*>(p));
}

__device__ __forceinline__ void put4(int32_t* d, int4 v) {
  d[0] = v.x;
  d[1] = v.y;
  d[2] = v.z;
  d[3] = v.w;
}

// Walk the stream in tiles of blockDim.x * U elements, grid-stride. Every
// thread of a block runs the same number of tiles (the bound is
// block-uniform), so warp collectives in emit() see full warps.
// ``base``/``stride``: the table the atomics land in (the counters, or the
// block's shared copy with stride E).
template <typename T, typename IDX, bool PAYLOAD, int ET>
__device__ __forceinline__ void walk(const Args& a, T* base, IDX stride) {
  constexpr int U = units(PAYLOAD, ET);
  constexpr int L = (PAYLOAD && ET > 0) ? ET : 1;   // lanes in registers
  const IDX n = static_cast<IDX>(a.n);
  const IDX K = static_cast<IDX>(a.K);
  const int E = a.E;
  const IDX tile = static_cast<IDX>(blockDim.x) * U;
  const IDX step = static_cast<IDX>(gridDim.x) * tile;
  for (IDX t0 = static_cast<IDX>(blockIdx.x) * tile; t0 < n; t0 += step) {
    const IDX first = t0 + static_cast<IDX>(threadIdx.x) * U;
    int32_t key[U];
    int32_t col[U];
    int32_t amt[U * L];
    const bool full = a.vec && first + U <= n;
    if constexpr (!PAYLOAD) {
      if (full) {
        put4(key, ld4(a.keys + first));
        put4(col, ld4(a.events + first));
        put4(amt, ld4(a.amounts + first));
      } else {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const bool in = first + u < n;
          key[u] = in ? __ldcs(a.keys + first + u) : 0;
          col[u] = in ? __ldcs(a.events + first + u) : 0;
          amt[u] = in ? __ldcs(a.amounts + first + u) : 0;
        }
      }
    } else if constexpr (ET == 1) {
      if (full) {
        put4(key, ld4(a.keys + first));
        put4(amt, ld4(a.amounts + first));
      } else {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const bool in = first + u < n;
          key[u] = in ? __ldcs(a.keys + first + u) : 0;
          amt[u] = in ? __ldcs(a.amounts + first + u) : 0;
        }
      }
    } else if constexpr (ET > 0) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const bool in = first + u < n;
        key[u] = in ? __ldcs(a.keys + first + u) : 0;
        const int32_t* row = a.amounts + (first + u) * ET;
#pragma unroll
        for (int q = 0; q < ET / 4; ++q) {
          if (!in) {
            put4(amt + u * ET + 4 * q, make_int4(0, 0, 0, 0));
          } else if (a.vec) {
            put4(amt + u * ET + 4 * q, ld4(row + 4 * q));
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              amt[u * ET + 4 * q + j] = __ldcs(row + 4 * q + j);
          }
        }
      }
    } else {
      key[0] = first < n ? __ldcs(a.keys + first) : 0;
    }

#pragma unroll
    for (int u = 0; u < U; ++u) {
      IDX k = static_cast<IDX>(key[u]);
      if (k < 0) k += K;
      const bool row_ok = k >= 0 && k < K;
      const IDX row = row_ok ? k * stride : 0;
      if constexpr (!PAYLOAD) {
        int c = col[u];
        if (c < 0) c += E;
        emit(base, row + c, amt[u], row_ok && amt[u] != 0 && c >= 0 && c < E);
      } else if constexpr (ET > 0) {
#pragma unroll
        for (int j = 0; j < ET; ++j) {
          const int32_t v = amt[u * ET + j];
          emit(base, row + j, v, row_ok && v != 0);
        }
      } else {
        const bool in = first < n;
        for (int j = 0; j < E; ++j) {
          const int32_t v = in ? __ldcs(a.amounts + first * E + j) : 0;
          emit(base, row + j, v, row_ok && v != 0);
        }
      }
    }
  }
}

template <typename T, typename IDX, bool PAYLOAD, int ET>
__global__ void __launch_bounds__(kMaxBlock)
    scatter_add_global(const Args a) {
  walk<T, IDX, PAYLOAD, ET>(a, static_cast<T*>(a.counters),
                            static_cast<IDX>(a.row_stride));
}

// Small tables: a private copy of the whole [K, E] table in shared memory
// per block, flushed once. Only planned when K * E * sizeof(T) fits, so the
// shared-memory index math is 32-bit.
template <typename T, bool PAYLOAD, int ET>
__global__ void __launch_bounds__(kMaxBlock)
    scatter_add_shared(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* tab = reinterpret_cast<T*>(smem);
  const int E = ET > 0 ? ET : a.E;
  const int cells = a.K * E;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) tab[i] = T(0);
  __syncthreads();
  walk<T, int, PAYLOAD, ET>(a, tab, E);
  __syncthreads();
  T* out = static_cast<T*>(a.counters);
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const T v = tab[i];
    if (v != T(0)) {
      const int r = i / E;
      atomic_add(out + static_cast<long long>(r) * a.row_stride + (i - r * E),
                 v);
    }
  }
}

using Kernel = void (*)(const Args);

template <typename T, typename IDX>
Kernel pick_global(bool payload, int e_inst) {
  if (!payload) return scatter_add_global<T, IDX, false, 0>;
  switch (e_inst) {
    case 1: return scatter_add_global<T, IDX, true, 1>;
    case 8: return scatter_add_global<T, IDX, true, 8>;
    case 32: return scatter_add_global<T, IDX, true, 32>;
    default: return scatter_add_global<T, IDX, true, 0>;
  }
}

template <typename T>
Kernel pick_shared(bool payload, int e_inst) {
  if (!payload) return scatter_add_shared<T, false, 0>;
  switch (e_inst) {
    case 1: return scatter_add_shared<T, true, 1>;
    case 8: return scatter_add_shared<T, true, 8>;
    case 32: return scatter_add_shared<T, true, 32>;
    default: return scatter_add_shared<T, true, 0>;
  }
}

// Whether 32-bit index math covers this launch's stream: every position the
// walk forms, one grid step past the end included, times the lanes.
bool stream_fits_32(long long n, int lanes, int grid, int block,
                    bool payload, int e_inst) {
  const long long step =
      static_cast<long long>(grid) * block * units(payload, e_inst);
  return (n + step) * lanes < (1LL << 31);
}

template <typename T>
int launch(void* counters, long long row_stride, int K, int E,
           const void* keys, const void* events, const void* amounts,
           long long n, int lanes, int path, int e_inst, int index_bits,
           int grid, int block, int smem_bytes, int vec, void* stream) {
  const bool payload = events == nullptr;
  if (n <= 0 || K <= 0 || E <= 0) return 0;
  if (lanes != (payload ? E : 1) || grid <= 0 || block <= 0 ||
      block > kMaxBlock || block % 32 != 0 || row_stride < E ||
      (e_inst != 0 && (!payload || e_inst != E)) ||
      (index_bits != 32 && index_bits != 64))
    return static_cast<int>(cudaErrorInvalidValue);
  // 32-bit index math (the shared path always uses it) only where it cannot
  // wrap: a plan that claims otherwise is refused, not run.
  const bool narrow = stream_fits_32(n, lanes, grid, block, payload, e_inst);
  if ((path == kPathShared && !narrow) ||
      (path == kPathGlobal && index_bits == 32 &&
       (!narrow || static_cast<long long>(K) * row_stride >= (1LL << 31))))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{counters, row_stride, K, E,
               static_cast<const int32_t*>(keys),
               static_cast<const int32_t*>(events),
               static_cast<const int32_t*>(amounts), n, vec};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == kPathShared) {
    if (static_cast<long long>(K) * E * sizeof(T) >
        static_cast<long long>(smem_bytes))
      return static_cast<int>(cudaErrorInvalidValue);
    const Kernel k = pick_shared<T>(payload, e_inst);
    const cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    k<<<grid, block, smem_bytes, s>>>(a);
  } else if (path == kPathGlobal) {
    const Kernel k = index_bits == 32 ? pick_global<T, int>(payload, e_inst)
                                      : pick_global<T, long long>(payload,
                                                                  e_inst);
    k<<<grid, block, 0, s>>>(a);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// counters: T[K, row_stride] (columns [0, E) are the table), keys/events:
// int32[n] (events may be null: payload mode), amounts: int32[n * lanes].
// path .. vec: the launch plan of ops/scatter_add.py::plan.
int sa_scatter_add_i32(void* counters, long long row_stride, int K, int E,
                       const void* keys, const void* events,
                       const void* amounts, long long n, int lanes, int path,
                       int e_inst, int index_bits, int grid, int block,
                       int smem_bytes, int vec, void* stream) {
  return launch<int32_t>(counters, row_stride, K, E, keys, events, amounts, n,
                         lanes, path, e_inst, index_bits, grid, block,
                         smem_bytes, vec, stream);
}

int sa_scatter_add_f32(void* counters, long long row_stride, int K, int E,
                       const void* keys, const void* events,
                       const void* amounts, long long n, int lanes, int path,
                       int e_inst, int index_bits, int grid, int block,
                       int smem_bytes, int vec, void* stream) {
  return launch<float>(counters, row_stride, K, E, keys, events, amounts, n,
                       lanes, path, e_inst, index_bits, grid, block,
                       smem_bytes, vec, stream);
}

// Streaming multiprocessors of ``device`` (cudaDevAttrMultiProcessorCount),
// or -1 with the error left for cudaGetLastError.
int sa_sm_count(int device) {
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
      cudaSuccess)
    return -1;
  return sms;
}

}  // extern "C"
