// CSR-format SpMM for Hopper (sm_90a), both rhs orientations:
//   csr_spmm:   Y (M, K) = A @ B,   B (N, K) row-major;
//   csr_spmm_t: Y (T, M) = X @ A^T, X (T, N) row-major (the serving layout:
//               activations stay row-major on both sides).
//
// Replaces the Pallas TPU kernels repro/kernels/csr_spmm.py::csr_spmm
// (_spmm_kernel) and repro/kernels/csr_spmm.py::csr_spmm_t (_spmm_t_kernel).
// Those walk row tiles in tk-entry chunks and reduce each row with a
// segmented prefix sum, since a TPU has no warp; here each row is reduced by
// the lanes that read it, from indptr directly, with no per-entry row ids.
//
// What bounds it on an H100: bytes at T = 1 (the 16.8M-entry minitron-8b MLP
// weight is 134 MB in f32, 0.040 ms at 3.35 TB/s), operations at T = 256
// (2 * nnz * T = 8.6 GFLOP, 0.128 ms at 67 TFLOP/s f32). Every stored entry
// feeds T multiply-adds, so the design loads each entry once per tile of
// the rhs and keeps the rhs tile close:
//   * csr_spmm_t (spmm_common.cuh::rows_spmm_t): a sub-warp of VEC lanes a
//     row (the width csr_spmv.cu picks from the row length), lanes on
//     consecutive entries (coalesced); each entry, loaded once, feeds a tile
//     of TT tokens (8 at prefill), gathered from X through L1 (a copy of
//     the tile in shared memory measured slower: it costs the 256-thread
//     blocks their occupancy); the blocks of one run of matrix rows follow
//     each other in the grid, so the matrix streams from HBM about once and
//     from L2 T/TT times;
//   * csr_spmm, K > 8: KW lanes (the smallest power of two >= K, at most
//     32) own one row, lane k on columns k, k + KW, ... (KJ of them): the
//     row's entries are read once by the whole group (one address: a
//     broadcast) and each B row segment is a coalesced load;
//   * csr_spmm, K <= 8 (decode-like widths): a sub-warp of VEC lanes a row
//     on consecutive entries, as csr_spmv.cu, each lane keeping KK sums
//     over B's K-wide rows; lanes along K would leave most of a warp idle
//     and read the entries one row per thread;
//   * sums in f32 in a fixed order (a butterfly of shuffles for the
//     sub-warp), one rounding to the output type: bitwise the same from run
//     to run; no atomics;
//   * rows stop at indptr[i+1]: capacity padding past indptr[-1] is never
//     read; an empty row writes zeros; columns clamp into [0, n), as the
//     reference's jnp.take(mode="clip") does;
//   * offsets into X, B and Y are int64: nnz * T and M * T pass 2^31 at
//     the serving shapes.

#include "spmm_common.cuh"

namespace {

using spmm::from_f32;
using spmm::kBlock;
using spmm::to_f32;

template <typename T, int KW, int KJ>
__global__ void __launch_bounds__(kBlock)
csr_spmm_kernel(const int32_t* __restrict__ indptr, const int32_t* __restrict__ indices,
                const T* __restrict__ data, const T* __restrict__ B, T* __restrict__ Y,
                int64_t m, int32_t n, int64_t k) {
  const int lane = threadIdx.x % KW;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kBlock / KW) + threadIdx.x / KW;
  const int64_t c0 = static_cast<int64_t>(blockIdx.y) * (KW * KJ) + lane;
  if (row >= m) return;
  float acc[KJ];
#pragma unroll
  for (int j = 0; j < KJ; ++j) acc[j] = 0.f;
  const int32_t end = indptr[row + 1];
  for (int32_t p = indptr[row]; p < end; ++p) {
    const int32_t c = min(max(indices[p], 0), n - 1);
    const float v = to_f32(data[p]);
    const T* brow = B + static_cast<int64_t>(c) * k;
#pragma unroll
    for (int j = 0; j < KJ; ++j) {
      const int64_t col = c0 + j * KW;
      if (col < k) acc[j] += v * to_f32(brow[col]);
    }
  }
#pragma unroll
  for (int j = 0; j < KJ; ++j) {
    const int64_t col = c0 + j * KW;
    if (col < k) Y[row * k + col] = from_f32<T>(acc[j]);
  }
}

// Y[i, :] for K <= KK: VEC lanes a row on consecutive entries, KK sums a
// lane, a butterfly of shuffles, lane j % VEC stores column j.
template <typename T, int VEC, int KK>
__global__ void __launch_bounds__(kBlock)
csr_spmm_rows(const int32_t* __restrict__ indptr, const int32_t* __restrict__ indices,
              const T* __restrict__ data, const T* __restrict__ B, T* __restrict__ Y,
              int64_t m, int32_t n, int64_t k) {
  const int lane = threadIdx.x & (VEC - 1);
  const int64_t row = (static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x) / VEC;
  float acc[KK];
#pragma unroll
  for (int j = 0; j < KK; ++j) acc[j] = 0.f;
  if (row < m) {
    const int32_t end = indptr[row + 1];
    for (int32_t p = indptr[row] + lane; p < end; p += VEC) {
      const int32_t c = min(max(indices[p], 0), n - 1);
      const float v = to_f32(data[p]);
      const T* brow = B + static_cast<int64_t>(c) * k;
#pragma unroll
      for (int j = 0; j < KK; ++j) acc[j] += v * to_f32(brow[min(static_cast<int64_t>(j), k - 1)]);
    }
  }
  // Every thread of the warp reaches the shuffles (no early return).
#pragma unroll
  for (int j = 0; j < KK; ++j) {
#pragma unroll
    for (int off = VEC / 2; off > 0; off >>= 1)
      acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], off, VEC);
  }
  if (row < m) {
#pragma unroll
    for (int j = 0; j < KK; ++j)
      if (j % VEC == lane && j < k) Y[row * k + j] = from_f32<T>(acc[j]);
  }
}

template <typename T, int VEC, int KK>
cudaError_t launch_rows(const void* indptr, const void* indices, const void* data,
                        const void* B, void* Y, int64_t m, int32_t n, int64_t k,
                        cudaStream_t stream) {
  const int64_t grid = (m * VEC + kBlock - 1) / kBlock;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  csr_spmm_rows<T, VEC, KK><<<static_cast<unsigned>(grid), kBlock, 0, stream>>>(
      static_cast<const int32_t*>(indptr), static_cast<const int32_t*>(indices),
      static_cast<const T*>(data), static_cast<const T*>(B), static_cast<T*>(Y), m, n, k);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t launch_rows_k(const void* indptr, const void* indices, const void* data,
                          const void* B, void* Y, int64_t m, int32_t n, int64_t k,
                          cudaStream_t s) {
  if (k <= 1) return launch_rows<T, VEC, 1>(indptr, indices, data, B, Y, m, n, k, s);
  if (k <= 2) return launch_rows<T, VEC, 2>(indptr, indices, data, B, Y, m, n, k, s);
  if (k <= 4) return launch_rows<T, VEC, 4>(indptr, indices, data, B, Y, m, n, k, s);
  return launch_rows<T, VEC, 8>(indptr, indices, data, B, Y, m, n, k, s);
}

template <typename T, int KW, int KJ>
cudaError_t launch_mm(const void* indptr, const void* indices, const void* data,
                      const void* B, void* Y, int64_t m, int32_t n, int64_t k,
                      cudaStream_t stream) {
  const int64_t gx = (m + kBlock / KW - 1) / (kBlock / KW);
  const int64_t gy = (k + KW * KJ - 1) / (KW * KJ);
  if (gx > 0x7fffffffLL || gy > 65535) return cudaErrorInvalidConfiguration;
  csr_spmm_kernel<T, KW, KJ><<<dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy)),
                               kBlock, 0, stream>>>(
      static_cast<const int32_t*>(indptr), static_cast<const int32_t*>(indices),
      static_cast<const T*>(data), static_cast<const T*>(B), static_cast<T*>(Y), m, n, k);
  return cudaGetLastError();
}

// K <= 8: `vec` lanes a row along its entries (csr_spmm_rows). Wider:
// lanes along K, the smallest power of two >= K up to 32; past 32 lanes
// each lane takes up to 8 columns (KJ), and the grid's y axis covers the
// rest.
template <typename T>
cudaError_t launch_mm_width(const void* indptr, const void* indices, const void* data,
                            const void* B, void* Y, int64_t m, int32_t n, int64_t k, int vec,
                            cudaStream_t s) {
  if (k <= 8) {
    switch (vec) {
      case 2: return launch_rows_k<T, 2>(indptr, indices, data, B, Y, m, n, k, s);
      case 4: return launch_rows_k<T, 4>(indptr, indices, data, B, Y, m, n, k, s);
      case 8: return launch_rows_k<T, 8>(indptr, indices, data, B, Y, m, n, k, s);
      case 16: return launch_rows_k<T, 16>(indptr, indices, data, B, Y, m, n, k, s);
      case 32: return launch_rows_k<T, 32>(indptr, indices, data, B, Y, m, n, k, s);
      default: return cudaErrorInvalidValue;
    }
  }
  if (k <= 16) return launch_mm<T, 16, 1>(indptr, indices, data, B, Y, m, n, k, s);
  if (k <= 32) return launch_mm<T, 32, 1>(indptr, indices, data, B, Y, m, n, k, s);
  if (k <= 64) return launch_mm<T, 32, 2>(indptr, indices, data, B, Y, m, n, k, s);
  if (k <= 128) return launch_mm<T, 32, 4>(indptr, indices, data, B, Y, m, n, k, s);
  return launch_mm<T, 32, 8>(indptr, indices, data, B, Y, m, n, k, s);
}

template <typename T>
int mm(const void* indptr, const void* indices, const void* data, const void* B, void* Y,
       int64_t m, int32_t n, int64_t k, int vec, int device, void* stream) {
  if (m == 0 || k == 0) return 0;
  return spmm::on_device(device, [&]() -> cudaError_t {
    return launch_mm_width<T>(indptr, indices, data, B, Y, m, n, k, vec,
                              static_cast<cudaStream_t>(stream));
  });
}

template <typename T>
int mm_t(const void* indptr, const void* indices, const void* data, const void* X, void* Y,
         int64_t m, int32_t n, int64_t t, int vec, int tt, int device, void* stream) {
  const spmm::CsrRows rows{static_cast<const int32_t*>(indptr)};
  return spmm::rows_spmm_t_launch<T>(rows, indices, data, X, Y, m, n, t, vec, tt, device,
                                     stream);
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` without synchronising and returns
// cudaGetLastError() (0 on success).
// csr_spmm: B is (n, k) row-major, Y (m, k); `vec` lanes a row (2..32)
// where k <= 8.
int csr_spmm_f32(const void* indptr, const void* indices, const void* data, const void* B,
                 void* Y, int64_t m, int32_t n, int64_t k, int vec, int device,
                 void* stream) {
  return mm<float>(indptr, indices, data, B, Y, m, n, k, vec, device, stream);
}

int csr_spmm_bf16(const void* indptr, const void* indices, const void* data, const void* B,
                  void* Y, int64_t m, int32_t n, int64_t k, int vec, int device,
                  void* stream) {
  return mm<__nv_bfloat16>(indptr, indices, data, B, Y, m, n, k, vec, device, stream);
}

// csr_spmm_t: X is (t, n) row-major, Y (t, m); `vec` lanes a row (2..32),
// token tiles of `tt` (1, 2, 4 or 8).
int csr_spmm_t_f32(const void* indptr, const void* indices, const void* data, const void* X,
                   void* Y, int64_t m, int32_t n, int64_t t, int vec, int tt, int device,
                   void* stream) {
  return mm_t<float>(indptr, indices, data, X, Y, m, n, t, vec, tt, device, stream);
}

int csr_spmm_t_bf16(const void* indptr, const void* indices, const void* data, const void* X,
                    void* Y, int64_t m, int32_t n, int64_t t, int vec, int tt, int device,
                    void* stream) {
  return mm_t<__nv_bfloat16>(indptr, indices, data, X, Y, m, n, t, vec, tt, device, stream);
}

const char* csr_spmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
