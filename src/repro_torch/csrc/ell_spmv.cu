// ELL-format SpMV for Hopper (sm_90a): y[i] = sum_k data[i, k] * x[cols[i, k]].
//
// Replaces the Pallas TPU kernel repro/kernels/ell_spmv.py::ell_spmv
// (_ell_kernel_row, _ell_kernel_col). There the `layout` knob picks the
// orientation of each (tm, K) tile in VMEM: rows along the reduction axis
// ("row") or transposed onto the lanes ("col").
//
// What bounds it on an H100: bytes. One SpMV reads the (M, K) column and
// value planes once (8 bytes per slot in f32, padding slots included), x,
// and writes y, for 2 flops per slot (~0.25 flop per byte). The planes are
// row-major, so one thread per row reading its own row directly would have
// the 32 threads of a warp read addresses K elements apart. The Hopper
// counterpart of the `layout` knob is a shared-memory transpose:
//   * a block owns a tile of kRows consecutive rows; for K <= kChunk the
//     tile is one contiguous run of kRows * K slots of each plane. Each warp
//     copies whole rows of it into shared memory, lane j taking slot j, so
//     one load instruction reads a row's K contiguous slots (108 bytes at
//     HPCG's K = 27); longer rows go through the tile in chunks of kChunk
//     slots per row. (A flat copy, consecutive threads on consecutive slots,
//     coalesces just as well but pays an integer division per slot to find
//     the row, and ran slower on the H100.)
//   * the shared tile is laid out with a row stride of kChunk + 1 words,
//     so the 32 threads of a warp, one per row, read 32 different banks;
//   * each thread then sums its own row in f32 in slot order, one rounding
//     to the output type: the result is bitwise the same from run to run;
//   * column indices are clamped into [0, n), as the reference's
//     jnp.take(mode="clip") does, so padding slots (col = -1, val = 0) read
//     x[0] and add nothing.
// K = 0 launches nothing: the wrapper returns zeros.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 128;   // rows (and threads) per block
constexpr int kChunk = 32;   // slots per row staged per pass (one per lane)
constexpr int kStride = kChunk + 1;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kRows)
ell_spmv_kernel(const int32_t* __restrict__ cols, const T* __restrict__ data,
                const T* __restrict__ x, T* __restrict__ y,
                int64_t m, int32_t n, int32_t k) {
  __shared__ int32_t s_cols[kRows * kStride];
  __shared__ float s_vals[kRows * kStride];
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRows;
  const int rows = static_cast<int>(min(static_cast<int64_t>(kRows), m - row0));
  const int64_t base = row0 * k;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float acc = 0.f;
  for (int k0 = 0; k0 < k; k0 += kChunk) {
    const int kc = min(kChunk, k - k0);
    __syncthreads();  // the previous chunk has been consumed
    for (int r = warp; r < rows; r += kRows / 32) {
      if (lane < kc) {
        const int64_t g = base + static_cast<int64_t>(r) * k + k0 + lane;
        s_cols[r * kStride + lane] = cols[g];
        s_vals[r * kStride + lane] = to_f32(data[g]);
      }
    }
    __syncthreads();
    if (threadIdx.x < rows) {
      const int off = threadIdx.x * kStride;
      for (int c = 0; c < kc; ++c) {
        const int32_t j = min(max(s_cols[off + c], 0), n - 1);
        acc += s_vals[off + c] * to_f32(x[j]);
      }
    }
  }
  if (threadIdx.x < rows) y[row0 + threadIdx.x] = from_f32<T>(acc);
}

template <typename T>
int launch(const void* cols, const void* data, const void* x, void* y,
           int64_t m, int32_t n, int32_t k, int device, void* stream) {
  if (m == 0 || k == 0 || n == 0) return 0;
  // Launch on `device` and give the caller's thread its own device back.
  int prev = -1;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess) return static_cast<int>(err);
  const int64_t grid = (m + kRows - 1) / kRows;
  ell_spmv_kernel<T><<<static_cast<unsigned>(grid), kRows, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(cols), static_cast<const T*>(data),
      static_cast<const T*>(x), static_cast<T*>(y), m, n, k);
  err = cudaGetLastError();
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` without synchronising and returns
// cudaGetLastError() (0 on success). cols/data are (m, k) row-major.
int ell_spmv_f32(const void* cols, const void* data, const void* x, void* y,
                 int64_t m, int32_t n, int32_t k, int device, void* stream) {
  return launch<float>(cols, data, x, y, m, n, k, device, stream);
}

int ell_spmv_bf16(const void* cols, const void* data, const void* x, void* y,
                  int64_t m, int32_t n, int32_t k, int device, void* stream) {
  return launch<__nv_bfloat16>(cols, data, x, y, m, n, k, device, stream);
}

const char* ell_spmv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
