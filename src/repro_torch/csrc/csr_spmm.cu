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
// the rhs and keeps the rhs tile close. Three schedules for each kernel,
// picked by the wrappers' knobs (kernels/ops.py::default_config):
//   * csr_spmm_t, xt = 0 (spmm_common.cuh::rows_spmm_t, decode widths): a
//     sub-warp of VEC lanes a row (the width csr_spmv.cu picks from the row
//     length), lanes on consecutive entries (coalesced); each entry, loaded
//     once, feeds a tile of TT <= 8 tokens, gathered from X through L1; the
//     blocks of one run of matrix rows follow each other in the grid, so the
//     matrix streams from HBM about once and from L2 T/TT times. At T = 256
//     that gather is the limit (~32 sectors a load for 32 multiply-adds);
//   * csr_spmm_t, xt = 32/64/128 (spmm_common.cuh::tokens_spmm_t, prefill
//     widths): X turned token-major once a call, a block's xt tokens of it
//     staged in shared memory in column chunks, lanes along tokens, each
//     entry a broadcast feeding xt multiply-adds; bound by shared-memory
//     wavefronts (one an entry plus xt/32 of X, PERF.md);
//   * csr_spmm, xt = tc = 0 (spmm_common.cuh::rows_spmm_launch), K > 8: KW
//     lanes (the smallest power of two >= K, at most 32) own one row, lane
//     k on columns k, k + KW, ...: the row's entries are read once by the
//     whole group (a broadcast) and each B row segment is a coalesced load;
//     at K = 256 every entry pulls 1 KB of B through L1/L2 (~17 GB a call on
//     the up weight): L2-bound. K <= 8 (decode-like widths): a sub-warp of
//     VEC lanes a row on consecutive entries, as csr_spmv.cu, each lane
//     keeping K sums over B's short rows;
//   * csr_spmm, xt = 32/64/128 (tokens_spmm_t with AB): B (N, K) already is
//     the token-major layout, staged in place (or padded once), lanes along
//     xt columns of B, each entry a broadcast; the wavefront bound of
//     csr_spmm_t;
//   * csr_spmm, tc = 128 (spmm_common.cuh::tiles_spmm_ab): the rows'
//     entries scattered into dense 64 x 64 tiles of A in shared memory, B
//     panels staged by cp.async, the products on the tensor cores (bf16
//     m16n8k16, f32 as 3xTF32): B reused from registers, bound by the dense
//     tiles' tensor work, so it pays above a density (PERF.md);
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

template <typename T>
int mm_xt(const void* indptr, const void* indices, const void* data, const void* X, void* XT,
          void* Y, int64_t m, int32_t n, int64_t t, int xt, int device, void* stream) {
  const spmm::CsrRows rows{static_cast<const int32_t*>(indptr)};
  return spmm::tokens_spmm_launch<T, spmm::CsrRows, false>(
      rows, indices, data, X, XT, Y, m, m, n, t, 0, xt, device,
      stream);  // int32 row pointers: positions fit
}

template <typename T>
int mm_kxt(const void* indptr, const void* indices, const void* data, const void* B, void* BP,
           void* Y, int64_t m, int32_t n, int64_t kb, int xt, int device, void* stream) {
  const spmm::CsrRows rows{static_cast<const int32_t*>(indptr)};
  return spmm::tokens_spmm_launch<T, spmm::CsrRows, true>(rows, indices, data, B, BP, Y, m, m, n,
                                                         kb, 0, xt, device, stream);
}

template <typename T>
int mm_tc(const void* indptr, const void* indices, const void* data, const void* B, void* BP,
          void* Y, int64_t m, int32_t n, int64_t kb, int tc, int device, void* stream) {
  const spmm::CsrRows rows{static_cast<const int32_t*>(indptr)};
  return spmm::tiles_spmm_launch<T>(rows, indices, data, B, BP, Y, m, n, kb, 0, tc, device,
                                    stream);  // int32 row pointers: positions fit
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

// csr_spmm_t on the token-major schedule: token tiles of `xt` (32, 64 or
// 128); XT is scratch of (n, tp) elements, tp = t rounded up to xt.
int csr_spmm_xt_f32(const void* indptr, const void* indices, const void* data, const void* X,
                    void* XT, void* Y, int64_t m, int32_t n, int64_t t, int xt, int device,
                    void* stream) {
  return mm_xt<float>(indptr, indices, data, X, XT, Y, m, n, t, xt, device, stream);
}

int csr_spmm_xt_bf16(const void* indptr, const void* indices, const void* data, const void* X,
                     void* XT, void* Y, int64_t m, int32_t n, int64_t t, int xt, int device,
                     void* stream) {
  return mm_xt<__nv_bfloat16>(indptr, indices, data, X, XT, Y, m, n, t, xt, device, stream);
}

// csr_spmm on the token-major schedule: tiles of `xt` (32, 64 or 128)
// columns of B; BP is null where B is staged as it is (kb a multiple of xt,
// B 16-byte aligned), else scratch of (n, kbp) elements, kbp = kb rounded up
// to xt.
int csr_spmm_kxt_f32(const void* indptr, const void* indices, const void* data, const void* B,
                     void* BP, void* Y, int64_t m, int32_t n, int64_t kb, int xt, int device,
                     void* stream) {
  return mm_kxt<float>(indptr, indices, data, B, BP, Y, m, n, kb, xt, device, stream);
}

int csr_spmm_kxt_bf16(const void* indptr, const void* indices, const void* data, const void* B,
                      void* BP, void* Y, int64_t m, int32_t n, int64_t kb, int xt, int device,
                      void* stream) {
  return mm_kxt<__nv_bfloat16>(indptr, indices, data, B, BP, Y, m, n, kb, xt, device, stream);
}

// csr_spmm on the dense-tile schedule: strips of `tc` (128) columns of
// B; BP is null where B is multiplied in place (kb a whole number of 16-byte
// pieces, B 16-byte aligned), else scratch of (n, kbp) elements, kbp = kb
// rounded up to 16 bytes.
int csr_spmm_tc_f32(const void* indptr, const void* indices, const void* data, const void* B,
                    void* BP, void* Y, int64_t m, int32_t n, int64_t kb, int tc, int device,
                    void* stream) {
  return mm_tc<float>(indptr, indices, data, B, BP, Y, m, n, kb, tc, device, stream);
}

int csr_spmm_tc_bf16(const void* indptr, const void* indices, const void* data, const void* B,
                     void* BP, void* Y, int64_t m, int32_t n, int64_t kb, int tc, int device,
                     void* stream) {
  return mm_tc<__nv_bfloat16>(indptr, indices, data, B, BP, Y, m, n, kb, tc, device, stream);
}

const char* csr_spmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
