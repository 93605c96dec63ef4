// Block-CSR (BSR) SpMM for Hopper (sm_90a): Y[M, K] = A @ B, B[N, K].
//
// A holds dense (bs x bs) blocks: blocks[p] is block column bcol[p] of the
// block row r with indptr[r] <= p < indptr[r+1]. Y, B and the blocks are
// row-major.
//
// Replaces the Pallas TPU kernel repro/kernels/bsr_spmm.py::bsr_spmm
// (_bsr_kernel). That kernel runs one MXU matmul per stored block over a
// sequential grid, revisiting the output tile of a block row across
// consecutive steps; it needs a per-block `brow` array (made on the host on
// every call) and every block row non-empty (the JAX wrapper falls back to
// the reference otherwise).
//
// What bounds it on an H100: bytes, at the widths the main path uses. bsr_spmv
// calls this with K = 1: one SpMV reads every stored block once (bs*bs
// values), its block column, indptr, x, and writes y, for 2 flops per
// stored value (~0.5 flop per byte in f32), far below the card's ~20 f32
// flops per byte of HBM bandwidth. The design:
//   * one thread per output element Y[i, k], consecutive threads on
//     consecutive elements of Y (the K outputs of a row, then the next
//     row), so Y is written and B's rows are read coalesced;
//   * the thread walks its own block row, indptr[r]..indptr[r+1], so there
//     is no brow array, no host work, and no ordering between blocks: an
//     empty block row sums nothing and writes zeros; blocks past indptr[-1]
//     (capacity padding) are never read;
//   * the bs threads of one block row that share k read one block's rows
//     as a tile, and the bs * K threads of the block row read the same block
//     within one warp or two, so a block is fetched from memory about once;
//     blocks are read from global memory (no shared-memory stage), so any
//     bs, 128 included, needs no 64 KB of shared memory;
//   * f32 accumulation in block then column order, one rounding to the
//     output type: no atomics, bitwise the same from run to run.
// Tensor cores (mma/wgmma) only pay at wide K; that is work for the SpMM
// slice.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;  // output elements (threads) per block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kBlock)
bsr_spmm_kernel(const int32_t* __restrict__ indptr, const int32_t* __restrict__ bcol,
                const T* __restrict__ blocks, const T* __restrict__ b,
                T* __restrict__ y, int64_t m, int64_t ncols, int32_t bs,
                int64_t nbcols) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  if (t >= m * ncols) return;
  const int64_t row = t / ncols;
  const int64_t k = t - row * ncols;
  const int64_t r = row / bs;
  const int64_t i = row - r * bs;
  const int64_t bsq = static_cast<int64_t>(bs) * bs;
  float acc = 0.f;
  const int32_t end = indptr[r + 1];
  for (int32_t p = indptr[r]; p < end; ++p) {
    const int64_t c = min(max(static_cast<int64_t>(bcol[p]), int64_t{0}), nbcols - 1);
    const T* blk = blocks + p * bsq + i * bs;
    const T* bt = b + c * bs * ncols + k;
    for (int32_t j = 0; j < bs; ++j)
      acc += to_f32(blk[j]) * to_f32(bt[j * ncols]);
  }
  y[t] = from_f32<T>(acc);
}

template <typename T>
int launch(const void* indptr, const void* bcol, const void* blocks, const void* b,
           void* y, int64_t m, int64_t ncols, int32_t bs, int64_t nbcols, int device,
           void* stream) {
  if (m == 0 || ncols == 0) return 0;
  if (bs <= 0 || nbcols <= 0) return static_cast<int>(cudaErrorInvalidValue);
  // Launch on `device` and give the caller's thread its own device back.
  int prev = -1;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess) return static_cast<int>(err);
  const int64_t grid = (m * ncols + kBlock - 1) / kBlock;
  bsr_spmm_kernel<T><<<static_cast<unsigned>(grid), kBlock, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(indptr), static_cast<const int32_t*>(bcol),
      static_cast<const T*>(blocks), static_cast<const T*>(b), static_cast<T*>(y),
      m, ncols, bs, nbcols);
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
// cudaGetLastError() (0 on success). m = element rows of A (a multiple of
// bs), ncols = K, nbcols = N / bs.
int bsr_spmm_f32(const void* indptr, const void* bcol, const void* blocks, const void* b,
                 void* y, int64_t m, int64_t ncols, int32_t bs, int64_t nbcols, int device,
                 void* stream) {
  return launch<float>(indptr, bcol, blocks, b, y, m, ncols, bs, nbcols, device, stream);
}

int bsr_spmm_bf16(const void* indptr, const void* bcol, const void* blocks, const void* b,
                  void* y, int64_t m, int64_t ncols, int32_t bs, int64_t nbcols, int device,
                  void* stream) {
  return launch<__nv_bfloat16>(indptr, bcol, blocks, b, y, m, ncols, bs, nbcols, device,
                               stream);
}

const char* bsr_spmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
