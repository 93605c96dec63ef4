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
//   * csr_spmm (spmm_common.cuh::rows_spmm_launch over CsrRows), K > 8: KW
//     lanes (the smallest power of two >= K, at most 32) own one row, lane
//     k on columns k, k + KW, ... (KJ of them): the row's entries are read
//     once by the whole group (one address: a broadcast) and each B row
//     segment is a coalesced load;
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

template <typename T>
int mm(const void* indptr, const void* indices, const void* data, const void* B, void* Y,
       int64_t m, int32_t n, int64_t k, int vec, int device, void* stream) {
  const spmm::CsrRows rows{static_cast<const int32_t*>(indptr)};
  return spmm::rows_spmm_launch<T>(rows, indices, data, B, Y, m, n, k, vec, device, stream);
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
