// CSR-format SpMV for Hopper (sm_90a):
//   y[i] = sum_{p in [indptr[i], indptr[i+1])} data[p] * x[indices[p]].
//
// Replaces the Pallas TPU kernel repro/kernels/csr_spmv.py::csr_spmv
// (_csr_kernel, _segmented_cumsum). A TPU has no warp, so that kernel needs
// a per-entry row-id array and a segmented prefix sum to reduce each row;
// here a row is reduced by the lanes that read it, so neither exists: the
// kernel reads indptr directly.
//
// What bounds it on an H100: bytes. One SpMV reads nnz column indices and
// values (8 bytes per entry in f32), indptr, x, and writes y, for 2 flops
// per entry (~0.25 flop per byte). The design keeps the stream coalesced:
//   * vector CSR: a sub-warp of VEC lanes (2..32, a power of two chosen by
//     the wrapper from the average row length) owns one row; its lanes read
//     consecutive entries of the row together, so index and value loads are
//     contiguous; the x gathers are the only scattered reads, and for a
//     banded matrix they hit the same few cache lines;
//   * each lane sums a fixed strided subset of the row in f32, then a fixed
//     shuffle tree (__shfl_down_sync) combines the lanes: no atomics, one
//     summation order, so the result is bitwise the same from run to run;
//   * rows stop at indptr[i+1]: capacity padding past indptr[-1] is never
//     read;
//   * column indices are clamped into [0, n), as the reference's
//     jnp.take(mode="clip") does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;  // threads per block: 256 / VEC rows of VEC lanes

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T, int VEC>
__global__ void csr_spmv_vector(const int32_t* __restrict__ indptr,
                                const int32_t* __restrict__ indices,
                                const T* __restrict__ data,
                                const T* __restrict__ x,
                                T* __restrict__ y,
                                int64_t m, int32_t n) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & (VEC - 1);
  const int64_t row = tid / VEC;
  float acc = 0.f;
  if (row < m) {
    const int32_t end = indptr[row + 1];
    for (int32_t p = indptr[row] + lane; p < end; p += VEC) {
      const int32_t c = min(max(indices[p], 0), n - 1);
      acc += to_f32(data[p]) * to_f32(x[c]);
    }
  }
  // Every thread of the warp reaches the shuffles (no early return), so the
  // full mask is valid; `width = VEC` keeps each sub-warp's tree separate.
#pragma unroll
  for (int off = VEC / 2; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off, VEC);
  if (lane == 0 && row < m) y[row] = from_f32<T>(acc);
}

template <typename T, int VEC>
cudaError_t launch_vec(const void* indptr, const void* indices, const void* data,
                       const void* x, void* y, int64_t m, int32_t n, cudaStream_t stream) {
  const int64_t threads = m * VEC;
  const int64_t grid = (threads + kBlock - 1) / kBlock;
  csr_spmv_vector<T, VEC><<<static_cast<unsigned>(grid), kBlock, 0, stream>>>(
      static_cast<const int32_t*>(indptr), static_cast<const int32_t*>(indices),
      static_cast<const T*>(data), static_cast<const T*>(x), static_cast<T*>(y), m, n);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_width(const void* indptr, const void* indices, const void* data,
                         const void* x, void* y, int64_t m, int32_t n, int vec,
                         cudaStream_t s) {
  switch (vec) {
    case 2: return launch_vec<T, 2>(indptr, indices, data, x, y, m, n, s);
    case 4: return launch_vec<T, 4>(indptr, indices, data, x, y, m, n, s);
    case 8: return launch_vec<T, 8>(indptr, indices, data, x, y, m, n, s);
    case 16: return launch_vec<T, 16>(indptr, indices, data, x, y, m, n, s);
    case 32: return launch_vec<T, 32>(indptr, indices, data, x, y, m, n, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
int launch(const void* indptr, const void* indices, const void* data, const void* x,
           void* y, int64_t m, int32_t n, int vec, int device, void* stream) {
  if (m == 0) return 0;
  // Launch on `device` and give the caller's thread its own device back.
  int prev = -1;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess) return static_cast<int>(err);
  err = launch_width<T>(indptr, indices, data, x, y, m, n, vec,
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
// cudaGetLastError() (0 on success). `vec` is the sub-warp width per row.
int csr_spmv_f32(const void* indptr, const void* indices, const void* data,
                 const void* x, void* y, int64_t m, int32_t n, int vec, int device,
                 void* stream) {
  return launch<float>(indptr, indices, data, x, y, m, n, vec, device, stream);
}

int csr_spmv_bf16(const void* indptr, const void* indices, const void* data,
                  const void* x, void* y, int64_t m, int32_t n, int vec, int device,
                  void* stream) {
  return launch<__nv_bfloat16>(indptr, indices, data, x, y, m, n, vec, device, stream);
}

const char* csr_spmv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
