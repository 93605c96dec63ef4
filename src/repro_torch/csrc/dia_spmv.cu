// DIA-format SpMV for Hopper (sm_90a): y[i] = sum_d data[d, i] * x[i + offsets[d]].
//
// Replaces the Pallas TPU kernel repro/kernels/dia_spmv.py::dia_spmv
// (_dia_kernel), which streams (ndiag, tm) tiles of the diagonal table
// through VMEM against a copy of x padded on both sides.
//
// What bounds it on an H100: bytes. One SpMV reads the diagonal table once
// (ndiag * M values), x once, writes y once, and does 2 flops per stored
// value: at 27 diagonals that is ~0.5 flop per byte, far below the card's
// ~20 f32 flops per byte of HBM bandwidth. So the design only has to keep
// every byte moving at full rate:
//   * one thread per row, consecutive threads on consecutive rows, so each
//     data[d, i0:i0+blockDim] read is one coalesced, fully used transaction;
//     the shifted x[i + off] reads are coalesced too, and the 27 windows of
//     one block overlap heavily in L1/L2, so x costs about one pass;
//   * the offsets are staged once per block in shared memory (in chunks, so
//     any number of diagonals fits) and broadcast to every thread;
//   * no padded copy of x: the column is bounds-checked instead (the TPU
//     kernel pads x by M + tm on each side, three copies of x per call);
//   * f32 accumulation in a register, in diagonal order, one rounding to
//     the output type: the result is bitwise the same from run to run.
// Rectangular matrices: data is (ndiag, M) row-major, x has N entries.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kOffsetChunk = 1024;  // offsets staged per pass (4 KB of shared memory)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void dia_spmv_kernel(const int32_t* __restrict__ offsets,
                                const T* __restrict__ data,
                                const T* __restrict__ x,
                                T* __restrict__ y,
                                int ndiag, int64_t m, int64_t n) {
  __shared__ int32_t s_off[kOffsetChunk];
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool active = i < m;  // no early return: every thread joins the barriers
  float acc = 0.f;
  for (int d0 = 0; d0 < ndiag; d0 += kOffsetChunk) {
    const int cnt = min(kOffsetChunk, ndiag - d0);
    __syncthreads();
    for (int t = threadIdx.x; t < cnt; t += blockDim.x) s_off[t] = offsets[d0 + t];
    __syncthreads();
    if (active) {
      const T* drow = data + static_cast<int64_t>(d0) * m + i;
      for (int t = 0; t < cnt; ++t) {
        const int64_t j = i + s_off[t];
        if (j >= 0 && j < n) acc += to_f32(drow[static_cast<int64_t>(t) * m]) * to_f32(x[j]);
      }
    }
  }
  if (active) y[i] = from_f32<T>(acc);
}

template <typename T>
int launch(const void* offsets, const void* data, const void* x, void* y,
           int ndiag, int64_t m, int64_t n, int block, int device, void* stream) {
  if (m == 0) return 0;
  // Launch on `device` and give the caller's thread its own device back.
  int prev = -1;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess) return static_cast<int>(err);
  const int64_t grid = (m + block - 1) / block;
  dia_spmv_kernel<T><<<static_cast<unsigned>(grid), block, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(offsets), static_cast<const T*>(data),
      static_cast<const T*>(x), static_cast<T*>(y), ndiag, m, n);
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
// cudaGetLastError() (0 on success).
int dia_spmv_f32(const void* offsets, const void* data, const void* x, void* y,
                 int ndiag, int64_t m, int64_t n, int block, int device, void* stream) {
  return launch<float>(offsets, data, x, y, ndiag, m, n, block, device, stream);
}

int dia_spmv_bf16(const void* offsets, const void* data, const void* x, void* y,
                  int ndiag, int64_t m, int64_t n, int block, int device, void* stream) {
  return launch<__nv_bfloat16>(offsets, data, x, y, ndiag, m, n, block, device, stream);
}

const char* dia_spmv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
