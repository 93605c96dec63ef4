// SELL-C-sigma SpMV for Hopper (sm_90a).
//
// Layout (repro_torch.core.formats.SELL): rows sorted by length inside
// sigma-windows, cut into slices of C sorted rows; slice s holds
// width_s = (ptrs[s+1] - ptrs[s]) / C planes, and plane j of slice s is C
// contiguous lanes at ptrs[s] + j*C, one entry of each of the slice's rows.
// perm[s*C + r] is the matrix row of lane r of slice s; ghost lanes past
// the last row carry perm == M.
//
// Replaces the Pallas TPU kernel repro/kernels/sell_spmv.py::sell_spmv
// (_sell_kernel, _pad_ptrs). That kernel writes y in sorted row order into
// a buffer and the wrapper scatters it back through perm in a second pass.
//
// What bounds it on an H100: bytes. One SpMV reads every stored slot once
// (column index and value, 8 bytes in f32), perm, the slice pointers, x,
// and writes y, for 2 flops per slot. The design:
//   * one thread per sorted lane: with C = 32 a slice is one warp, and each
//     plane is one coalesced 128-byte load of indices and one of values;
//     other values of C are just as correct (a warp then spans several
//     slices, or a slice several warps), only less regular;
//   * a lane walks its slice's own width, so the work is the slots stored
//     and no more (no global kmax as in ELL);
//   * the lane's row sum is written straight to y[perm[lane]]: no sorted
//     buffer and no second pass; perm is a permutation, so no two lanes
//     write one row and no atomics are needed; ghost lanes (perm outside
//     [0, M)) write nothing;
//   * f32 accumulation in plane order, one rounding to the output type:
//     the result is bitwise the same from run to run;
//   * column indices are clamped into [0, n), as the reference's
//     jnp.take(mode="clip") does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;  // lanes (threads) per block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kBlock)
sell_spmv_kernel(const int32_t* __restrict__ ptrs, const int32_t* __restrict__ cols,
                 const T* __restrict__ data, const int32_t* __restrict__ perm,
                 const T* __restrict__ x, T* __restrict__ y,
                 int64_t lanes, int32_t c, int64_t m, int32_t n) {
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  if (lane >= lanes) return;
  const int64_t s = lane / c;
  const int64_t r = lane - s * c;
  const int64_t begin = ptrs[s];
  const int64_t end = ptrs[s + 1];
  float acc = 0.f;
  for (int64_t p = begin + r; p < end; p += c) {
    const int32_t j = min(max(cols[p], 0), n - 1);
    acc += to_f32(data[p]) * to_f32(x[j]);
  }
  const int32_t row = perm[lane];
  if (row >= 0 && row < m) y[row] = from_f32<T>(acc);
}

template <typename T>
int launch(const void* ptrs, const void* cols, const void* data, const void* perm,
           const void* x, void* y, int64_t lanes, int32_t c, int64_t m, int32_t n,
           int device, void* stream) {
  if (lanes == 0 || m == 0 || n == 0) return 0;
  if (c <= 0) return static_cast<int>(cudaErrorInvalidValue);
  // Launch on `device` and give the caller's thread its own device back.
  int prev = -1;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess) return static_cast<int>(err);
  const int64_t grid = (lanes + kBlock - 1) / kBlock;
  sell_spmv_kernel<T><<<static_cast<unsigned>(grid), kBlock, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ptrs), static_cast<const int32_t*>(cols),
      static_cast<const T*>(data), static_cast<const int32_t*>(perm),
      static_cast<const T*>(x), static_cast<T*>(y), lanes, c, m, n);
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
// cudaGetLastError() (0 on success). `lanes` = nslices * c = len(perm).
int sell_spmv_f32(const void* ptrs, const void* cols, const void* data, const void* perm,
                  const void* x, void* y, int64_t lanes, int32_t c, int64_t m, int32_t n,
                  int device, void* stream) {
  return launch<float>(ptrs, cols, data, perm, x, y, lanes, c, m, n, device, stream);
}

int sell_spmv_bf16(const void* ptrs, const void* cols, const void* data, const void* perm,
                   const void* x, void* y, int64_t lanes, int32_t c, int64_t m, int32_t n,
                   int device, void* stream) {
  return launch<__nv_bfloat16>(ptrs, cols, data, perm, x, y, lanes, c, m, n, device,
                               stream);
}

const char* sell_spmv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
