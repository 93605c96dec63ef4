// CSR-format SpMV for Hopper (sm_90a):
//   y[i] = sum_{p in [indptr[i], indptr[i+1])} data[p] * x[indices[p]].
//
// Replaces the Pallas TPU kernel repro/kernels/csr_spmv.py::csr_spmv
// (_csr_kernel, _segmented_cumsum). A TPU has no warp, so that kernel needs
// a per-entry row-id array and a segmented prefix sum to reduce each row;
// here a row is reduced by the lanes that read it, so neither exists: the
// kernel reads indptr directly. The TPU kernel walks each 256-row tile's
// whole nnz window in fixed chunks, so there a row costs its entries
// whatever its length; this kernel keeps that property with two schedules
// in one launch.
//
// What bounds it on an H100: bytes. One SpMV reads nnz column indices and
// values (8 bytes per entry in f32), indptr, x, and writes y, for 2 flops
// per entry (~0.25 flop per byte). The design keeps the stream coalesced
// and the longest dependent walk short:
//   * short rows, vector CSR: a sub-warp of VEC lanes (2..32, a power of
//     two chosen by the wrapper from the average row length) owns one row
//     of at most long_len entries; its lanes read consecutive
//     entries of the row together, so index and value loads are contiguous;
//     the x gathers are the only scattered reads, and for a banded matrix
//     they hit the same few cache lines;
//   * long rows (more than long_len entries: a power-law row, or row 0 of a
//     stacked part, which holds the part's capacity padding) are
//     cut into chunks of kChunk entries, listed by a plan the wrapper builds
//     on the device (chunk_end: the long rows' chunks up to each row;
//     chunk_row: each chunk's row). The first long_ctas blocks of the grid
//     walk that list one warp a chunk in a grid-stride loop, reading its
//     length from chunk_end[m - 1] on the device, so the grid depends only
//     on host-known bounds. A row of one chunk is written
//     by its warp. Otherwise each chunk's f32 partial goes to `partials`;
//     the warp that raises the row's arrival counter to its chunk count
//     (after __threadfence) sums the row's partials in a fixed order,
//     writes y and puts the counter back to 0 for the next call. The
//     counter orders the work and enters no sum;
//   * each lane sums a fixed strided subset of its row or chunk in f32,
//     then a fixed shuffle tree (__shfl_down_sync) combines the lanes:
//     no atomics in any sum, one summation order, so the result is bitwise
//     the same from run to run. Rows of at most long_len entries sum
//     exactly as the single-schedule kernel before the long-row pass did;
//   * rows stop at indptr[i+1]: capacity padding past indptr[-1] is never
//     read;
//   * column indices are clamped into [0, n), as the reference's
//     jnp.take(mode="clip") does.
// long_len, the plan's threshold, is the wrapper's (kernels/csr_spmv.py::
// long_threshold): 32 steps a lane (32 * VEC), which leaves every row of the
// HPCG stencil (27 entries, VEC = 4) on the short schedule, and at least 4x
// the average row, so that a matrix whose rows are all alike (the sparse
// weights: 1,024 or 4,096 entries a row at VEC = 32) keeps the one-row
// schedule that suits it. A plan's counters and partials serve one call at
// a time: calls that share a plan run in order on one stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;  // threads per block: 256 / VEC rows of VEC lanes
constexpr int kWarps = kBlock / 32;
// Entries a warp reduces of a long row: 8 steps a lane, a quarter of the
// 32 a short row may take, so that a padded part's one long row is spread
// over hundreds of warps at once. Must equal kernels/csr_spmv.py's CHUNK.
constexpr int kChunk = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float acc) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  return acc;  // lane 0 holds the sum
}

struct LongPlan {
  const int32_t* chunk_end;  // (m,) chunks of the long rows up to each row (inclusive)
  const int32_t* chunk_row;  // (k_max,) row of each chunk
  int32_t* arrive;           // (m,) chunks of the row done in this call, 0 between calls
  float* partials;           // (k_max,) f32 sum of each chunk
  int32_t long_len;          // a row of more entries is long
};

// One warp a chunk of a long row; blocks [0, long_ctas) run this. Both
// passes read every array but y, arrive and partials through the read-only
// cache path (__ldg): the stores through the plan's pointers would
// otherwise keep the compiler from proving those arrays read-only.
template <typename T>
__device__ void long_rows_pass(const int32_t* __restrict__ indptr,
                               const int32_t* __restrict__ indices,
                               const T* __restrict__ data, const T* __restrict__ x,
                               T* __restrict__ y, int64_t m, int32_t n, const LongPlan& plan,
                               int long_ctas) {
  const int lane = threadIdx.x & 31;
  const int32_t stride = long_ctas * kWarps;
  const int32_t nchunks = __ldg(plan.chunk_end + m - 1);
  for (int32_t q = blockIdx.x * kWarps + (threadIdx.x >> 5); q < nchunks; q += stride) {
    const int32_t row = __ldg(plan.chunk_row + q);
    const int32_t rb = __ldg(indptr + row), re = __ldg(indptr + row + 1);
    const int32_t nch = (re - rb - 1) / kChunk + 1;  // a long row is not empty
    const int32_t c0 = __ldg(plan.chunk_end + row) - nch;
    const int32_t beg = rb + (q - c0) * kChunk;
    const int32_t end = re - beg > kChunk ? beg + kChunk : re;  // never past re
    float acc = 0.f;
#pragma unroll 4
    for (int32_t p = beg + lane; p < end; p += 32) {
      const int32_t c = min(max(__ldg(indices + p), 0), n - 1);
      acc += to_f32(__ldg(data + p)) * to_f32(__ldg(x + c));
    }
    acc = warp_sum(acc);
    if (nch == 1) {
      if (lane == 0) y[row] = from_f32<T>(acc);
      continue;
    }
    int last = 0;
    if (lane == 0) {
      __stcg(plan.partials + q, acc);
      __threadfence();  // the partial is visible before the arrival is
      last = atomicAdd(plan.arrive + row, 1) == nch - 1;
    }
    if (!__shfl_sync(0xffffffffu, last, 0)) continue;
    __threadfence();  // every other chunk's partial is visible now
    float s = 0.f;
    for (int32_t k = lane; k < nch; k += 32) s += __ldcg(plan.partials + c0 + k);
    s = warp_sum(s);
    if (lane == 0) {
      y[row] = from_f32<T>(s);
      plan.arrive[row] = 0;  // ready for the next call on this stream
    }
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kBlock)
csr_spmv_vector(const int32_t* __restrict__ indptr, const int32_t* __restrict__ indices,
                const T* __restrict__ data, const T* __restrict__ x, T* __restrict__ y,
                int64_t m, int32_t n, LongPlan plan, int long_ctas) {
  if (static_cast<int>(blockIdx.x) < long_ctas) {
    long_rows_pass<T>(indptr, indices, data, x, y, m, n, plan, long_ctas);
    return;  // the whole block: its warps share no shuffle with a sub-warp
  }
  const int64_t tid = static_cast<int64_t>(blockIdx.x - long_ctas) * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & (VEC - 1);
  const int64_t row = tid / VEC;
  float acc = 0.f;
  bool mine = false;
  if (row < m) {
    const int32_t beg = __ldg(indptr + row), end = __ldg(indptr + row + 1);
    mine = end - beg <= plan.long_len;  // a longer row is the long pass's
    if (mine) {
      // Unrolling keeps each lane's order of sums and lets a lane's loads of
      // four steps be in flight together.
#pragma unroll 4
      for (int32_t p = beg + lane; p < end; p += VEC) {
        const int32_t c = min(max(__ldg(indices + p), 0), n - 1);
        acc += to_f32(__ldg(data + p)) * to_f32(__ldg(x + c));
      }
    }
  }
  // Every thread of the warp reaches the shuffles (no early return), so the
  // full mask is valid; `width = VEC` keeps each sub-warp's tree separate.
#pragma unroll
  for (int off = VEC / 2; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off, VEC);
  if (lane == 0 && mine) y[row] = from_f32<T>(acc);
}

template <typename T, int VEC>
cudaError_t launch_vec(const void* indptr, const void* indices, const void* data,
                       const void* x, void* y, int64_t m, int32_t n, const LongPlan& plan,
                       int long_ctas, cudaStream_t stream) {
  const int64_t threads = m * VEC;
  const int64_t grid = long_ctas + (threads + kBlock - 1) / kBlock;
  csr_spmv_vector<T, VEC><<<static_cast<unsigned>(grid), kBlock, 0, stream>>>(
      static_cast<const int32_t*>(indptr), static_cast<const int32_t*>(indices),
      static_cast<const T*>(data), static_cast<const T*>(x), static_cast<T*>(y), m, n, plan,
      long_ctas);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_width(const void* indptr, const void* indices, const void* data,
                         const void* x, void* y, int64_t m, int32_t n, int vec,
                         const LongPlan& plan, int long_ctas, cudaStream_t s) {
  switch (vec) {
    case 2: return launch_vec<T, 2>(indptr, indices, data, x, y, m, n, plan, long_ctas, s);
    case 4: return launch_vec<T, 4>(indptr, indices, data, x, y, m, n, plan, long_ctas, s);
    case 8: return launch_vec<T, 8>(indptr, indices, data, x, y, m, n, plan, long_ctas, s);
    case 16: return launch_vec<T, 16>(indptr, indices, data, x, y, m, n, plan, long_ctas, s);
    case 32: return launch_vec<T, 32>(indptr, indices, data, x, y, m, n, plan, long_ctas, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
int launch(const void* indptr, const void* indices, const void* data, const void* x,
           void* y, int64_t m, int32_t n, int vec, const void* chunk_end,
           const void* chunk_row, void* arrive, void* partials, int long_len, int long_ctas,
           int device, void* stream) {
  if (m == 0) return 0;
  if (long_ctas < 0 || long_len < 0) return static_cast<int>(cudaErrorInvalidValue);
  const LongPlan plan{static_cast<const int32_t*>(chunk_end),
                      static_cast<const int32_t*>(chunk_row), static_cast<int32_t*>(arrive),
                      static_cast<float*>(partials), long_len};
  // Launch on `device` and give the caller's thread its own device back.
  int prev = -1;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess) return static_cast<int>(err);
  err = launch_width<T>(indptr, indices, data, x, y, m, n, vec, plan, long_ctas,
                        static_cast<cudaStream_t>(stream));
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` without synchronising and returns
// cudaGetLastError() (0 on success). `vec` is the sub-warp width of a
// short row; a row of more than `long_len` entries is long, and the
// long-row plan (chunk_end, chunk_row, arrive, partials) is walked by the
// first `long_ctas` blocks (0 where no row can be long: the plan's pointers
// are then not read).
int csr_spmv_f32(const void* indptr, const void* indices, const void* data,
                 const void* x, void* y, int64_t m, int32_t n, int vec,
                 const void* chunk_end, const void* chunk_row, void* arrive, void* partials,
                 int long_len, int long_ctas, int device, void* stream) {
  return launch<float>(indptr, indices, data, x, y, m, n, vec, chunk_end, chunk_row, arrive,
                       partials, long_len, long_ctas, device, stream);
}

int csr_spmv_bf16(const void* indptr, const void* indices, const void* data,
                  const void* x, void* y, int64_t m, int32_t n, int vec,
                  const void* chunk_end, const void* chunk_row, void* arrive, void* partials,
                  int long_len, int long_ctas, int device, void* stream) {
  return launch<__nv_bfloat16>(indptr, indices, data, x, y, m, n, vec, chunk_end, chunk_row,
                               arrive, partials, long_len, long_ctas, device, stream);
}

const char* csr_spmv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
