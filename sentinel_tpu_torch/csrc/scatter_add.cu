// Scatter-add of an event stream into a counter table, for Hopper (sm_90a).
//
//     counters[key_i, event_i] += amount_i        for every stream element i
//
// Replaces the JAX package's Pallas TPU kernel
// sentinel_tpu/ops/pallas_kernels.py::_tile_kernel (launched by
// scatter_add_pallas). The TPU form is a one-hot matmul on the MXU over a
// (K/512, N/2048) grid with f32 partials per tile; it scans the whole stream
// once per K-tile. None of that carries over: here one thread takes one
// stream element (or one lane of one element, in payload mode) and adds it
// with an atomic, so the work is O(N) whatever K is.
//
// Semantics follow scatter_add_xla (the JAX package's reference form,
// ``counters.at[keys, events].add(amounts, mode="drop")``), not the MXU form:
//   * a negative key or event wraps ONCE (-1 -> K-1), as JAX normalises
//     negative indices before the scatter; anything still out of range after
//     that is dropped (keys >= K are the callers' padding convention). The
//     Pallas form drops -1 instead; callers never pass negatives.
//   * duplicates accumulate.
//
// Exactness. int32 counters accumulate exactly and the result does not
// depend on the order the atomics land in (integer addition is associative,
// and it wraps mod 2^32 like XLA's int32 add). The Pallas form accumulated
// f32 partials per tile, so this exactness is the port's, not the TPU
// kernel's. The float32 variant is exact while every partial sum stays below
// 2^24 (the amounts are int32 and are converted to float first); above that
// the atomics' order makes it run-to-run dependent.
//
// Payload mode (events == nullptr): each stream element carries ``lanes``
// amounts, lane j landing in column j (``counters[key_i, :] += payload[i, :]``,
// the window's add_rows_vec). Zero amounts are skipped in either mode: adding
// 0 changes no int32 counter and no float counter's value, and an exit
// payload is mostly zeros.
//
// What bounds it on an H100 (3.35 TB/s HBM3): the stream's bytes (12 bytes
// per element: key, event, amount) plus one 32-byte sector read and written
// for each distinct counter row touched. At the engine's decide step
// (R = 2^20 rows, B = 2^19 events, 3/4 of them on distinct random rows) that
// is about 6.3 MB of stream and 2 x 10.6 MB of sectors (some 332k distinct
// rows), about 27.5 MB, or 8.2 us; chip_smoke.py recomputes the bound from
// the bytes it counts.
// What this first design leaves on the table: every element is its own
// global atomic, so the 4096 hot rows that take a quarter of the traffic
// contend on the same addresses, and nothing is privatised in shared memory
// first. Making it fast is later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libscatter_add.so scatter_add.cu
// (sentinel_tpu_torch/ops/_build.py does this at first use). The C functions
// launch on the stream they are given, allocate nothing, do not synchronise,
// and return cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 64;  // grid-stride beyond this

__device__ __forceinline__ void atomic_add(int32_t* p, int32_t v) {
  atomicAdd(reinterpret_cast<int*>(p), static_cast<int>(v));
}

__device__ __forceinline__ void atomic_add(float* p, int32_t v) {
  atomicAdd(p, static_cast<float>(v));
}

template <typename T>
__global__ void scatter_add_kernel(T* __restrict__ counters,
                                   long long row_stride, int K, int E,
                                   const int32_t* __restrict__ keys,
                                   const int32_t* __restrict__ events,
                                   const int32_t* __restrict__ amounts,
                                   long long total, int lanes) {
  long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (; t < total; t += step) {
    const int32_t amt = amounts[t];
    if (amt == 0) continue;
    const long long i = t / lanes;
    int key = keys[i];
    int ev = events != nullptr ? events[i] : static_cast<int>(t - i * lanes);
    if (key < 0) key += K;
    if (ev < 0) ev += E;
    if (key < 0 || key >= K || ev < 0 || ev >= E) continue;
    atomic_add(counters + static_cast<long long>(key) * row_stride + ev, amt);
  }
}

template <typename T>
int launch(void* counters, long long row_stride, int K, int E,
           const void* keys, const void* events, const void* amounts,
           long long n, int lanes, void* stream) {
  const long long total = n * lanes;
  if (total <= 0) return 0;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  scatter_add_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<T*>(counters), row_stride, K, E,
      static_cast<const int32_t*>(keys), static_cast<const int32_t*>(events),
      static_cast<const int32_t*>(amounts), total, lanes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// counters: T[K, row_stride] (columns [0, E) are the table), keys/events:
// int32[n] (events may be null: payload mode), amounts: int32[n * lanes].
int sa_scatter_add_i32(void* counters, long long row_stride, int K, int E,
                       const void* keys, const void* events,
                       const void* amounts, long long n, int lanes,
                       void* stream) {
  return launch<int32_t>(counters, row_stride, K, E, keys, events, amounts, n,
                         lanes, stream);
}

int sa_scatter_add_f32(void* counters, long long row_stride, int K, int E,
                       const void* keys, const void* events,
                       const void* amounts, long long n, int lanes,
                       void* stream) {
  return launch<float>(counters, row_stride, K, E, keys, events, amounts, n,
                       lanes, stream);
}

}  // extern "C"
