// ELL-format SpMM for Hopper (sm_90a), both rhs orientations, cols/data
// (M, K) row-major:
//   ell_spmm:   Y (M, Kb) = A @ B,   Y[i, :] = sum_k data[i, k] * B[cols[i, k], :],
//               B (N, Kb) row-major;
//   ell_spmm_t: Y (T, M) = X @ A^T, Y[t, i] = sum_k data[i, k] * X[t, cols[i, k]],
//               X (T, N) row-major.
//
// Replace the Pallas TPU kernels repro/kernels/ell_spmv.py::ell_spmm
// (_ell_spmm_kernel_row, _ell_spmm_kernel_col) and
// repro/kernels/ell_spmv.py::ell_spmm_t (_ell_spmm_t_kernel_row,
// _ell_spmm_t_kernel_col): a (tm, K) tile of the planes against a (tn, N)
// slab of the rhs, the `layout` knob choosing which axis lies on the lanes.
//
// What bounds it on an H100: bytes at T = 1 (8 bytes a live entry in f32),
// operations at T = 256 (2 flops per live entry and token). The kernel also
// reads and multiplies the padding slots (K = 1132 slots a row against
// ~1024 entries in the up weight: 10% more of both). Row i's slots are one
// contiguous run [i*K, (i+1)*K) of each plane, so both kernels are the
// row-walking kernels of csr_spmm.cu with implicit row pointers
// (spmm_common.cuh over EllRows, no row pointers read):
//   * ell_spmm_t, xt = 0 (rows_spmm_t, decode widths): a sub-warp of VEC
//     lanes a row reads the row's slots coalesced (the counterpart of the
//     Pallas `layout` choice, and of the shared-memory transpose in
//     ell_spmv.cu, which one thread a row needs); each slot, loaded once,
//     feeds a tile of TT <= 8 tokens gathered through L1 (L1-bound at
//     prefill: 2.67 ms on the up weight at T = 256);
//   * ell_spmm_t, xt = 32/64/128 (tokens_spmm_t, prefill widths): X
//     token-major in shared memory, lanes along xt tokens, each slot a
//     broadcast; bound by shared-memory wavefronts. A row's sorted slots
//     and its trailing padding are two runs of non-decreasing columns, each
//     walked once over the column chunks;
//   * ell_spmm, xt = 0 (rows_spmm_launch): for Kb > 8, KW lanes own a row
//     and lie along B's columns (each slot is a broadcast, each B row
//     segment a coalesced load); for Kb <= 8, VEC lanes lie along the row's
//     slots with Kb sums a lane. At Kb = 256 every slot reads 1 KB of B
//     from L2 (~17 GB a call on the up weight): L2-bound, 1.57 ms;
//   * ell_spmm, xt = 32/64/128 (tokens_spmm_t with AB, Kb >= 32): B (N, Kb)
//     is already token-major, so the same schedule runs with no transpose
//     (B staged straight from device memory, or once padded to a multiple
//     of xt columns), lanes along xt columns of B, each slot a broadcast,
//     and lane l stores its xt/32 sums as one vector along row i of Y;
//     bound by shared-memory wavefronts, as ell_spmm_t is;
//   * the lanes' f32 sums combine in a fixed order, one rounding to the
//     output type (bitwise the same from run to run, no atomics). Columns
//     clamp into [0, n), as the reference's jnp.take(mode="clip") does, so
//     padding slots (col = -1, val = 0) read column 0 and add nothing.
//     K = 0 launches nothing: the wrappers return zeros. Offsets are int64
//     (M * K * T and M * T pass 2^31 at the serving shapes).

#include "spmm_common.cuh"

namespace {

template <typename T>
int mm(const void* cols, const void* data, const void* B, void* Y, int64_t m, int32_t n,
       int32_t k, int64_t kb, int vec, int device, void* stream) {
  if (k == 0) return 0;
  const spmm::EllRows rows{k};
  return spmm::rows_spmm_launch<T>(rows, cols, data, B, Y, m, n, kb, vec, device, stream);
}

template <typename T>
int mm_t(const void* cols, const void* data, const void* X, void* Y, int64_t m, int32_t n,
         int32_t k, int64_t t, int vec, int tt, int device, void* stream) {
  if (k == 0) return 0;
  const spmm::EllRows rows{k};
  return spmm::rows_spmm_t_launch<T>(rows, cols, data, X, Y, m, n, t, vec, tt, device, stream);
}

template <typename T>
int mm_xt(const void* cols, const void* data, const void* X, void* XT, void* Y, int64_t m,
          int32_t n, int32_t k, int64_t t, int xt, int device, void* stream) {
  if (k == 0) return 0;
  const spmm::EllRows rows{k};
  return spmm::tokens_spmm_launch<T, spmm::EllRows, false>(rows, cols, data, X, XT, Y, m, m, n,
                                                          t, m * k, xt, device, stream);
}

template <typename T>
int mm_kxt(const void* cols, const void* data, const void* B, void* BP, void* Y, int64_t m,
           int32_t n, int32_t k, int64_t kb, int xt, int device, void* stream) {
  if (k == 0) return 0;
  const spmm::EllRows rows{k};
  return spmm::tokens_spmm_launch<T, spmm::EllRows, true>(rows, cols, data, B, BP, Y, m, m, n,
                                                         kb, m * k, xt, device, stream);
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` without synchronising and returns
// cudaGetLastError() (0 on success).
// ell_spmm: B is (n, kb) row-major, Y (m, kb); `vec` lanes a row (2..32)
// where kb <= 8.
int ell_spmm_f32(const void* cols, const void* data, const void* B, void* Y, int64_t m,
                 int32_t n, int32_t k, int64_t kb, int vec, int device, void* stream) {
  return mm<float>(cols, data, B, Y, m, n, k, kb, vec, device, stream);
}

int ell_spmm_bf16(const void* cols, const void* data, const void* B, void* Y, int64_t m,
                  int32_t n, int32_t k, int64_t kb, int vec, int device, void* stream) {
  return mm<__nv_bfloat16>(cols, data, B, Y, m, n, k, kb, vec, device, stream);
}

// ell_spmm_t: X is (t, n), Y (t, m); `vec` lanes a row (2..32), token tiles
// of `tt` (1, 2, 4 or 8).
int ell_spmm_t_f32(const void* cols, const void* data, const void* X, void* Y, int64_t m,
                   int32_t n, int32_t k, int64_t t, int vec, int tt, int device,
                   void* stream) {
  return mm_t<float>(cols, data, X, Y, m, n, k, t, vec, tt, device, stream);
}

int ell_spmm_t_bf16(const void* cols, const void* data, const void* X, void* Y, int64_t m,
                    int32_t n, int32_t k, int64_t t, int vec, int tt, int device,
                    void* stream) {
  return mm_t<__nv_bfloat16>(cols, data, X, Y, m, n, k, t, vec, tt, device, stream);
}

// ell_spmm_t on the token-major schedule: token tiles of `xt` (32, 64 or
// 128); XT is scratch of (n, tp) elements, tp = t rounded up to xt.
int ell_spmm_xt_f32(const void* cols, const void* data, const void* X, void* XT, void* Y,
                    int64_t m, int32_t n, int32_t k, int64_t t, int xt, int device,
                    void* stream) {
  return mm_xt<float>(cols, data, X, XT, Y, m, n, k, t, xt, device, stream);
}

int ell_spmm_xt_bf16(const void* cols, const void* data, const void* X, void* XT, void* Y,
                     int64_t m, int32_t n, int32_t k, int64_t t, int xt, int device,
                     void* stream) {
  return mm_xt<__nv_bfloat16>(cols, data, X, XT, Y, m, n, k, t, xt, device, stream);
}

// ell_spmm on the token-major schedule: tiles of `xt` (32, 64 or 128)
// columns of B; BP is null where B is staged as it is (kb a multiple of xt,
// B 16-byte aligned), else scratch of (n, kbp) elements, kbp = kb rounded up
// to xt.
int ell_spmm_kxt_f32(const void* cols, const void* data, const void* B, void* BP, void* Y,
                     int64_t m, int32_t n, int32_t k, int64_t kb, int xt, int device,
                     void* stream) {
  return mm_kxt<float>(cols, data, B, BP, Y, m, n, k, kb, xt, device, stream);
}

int ell_spmm_kxt_bf16(const void* cols, const void* data, const void* B, void* BP, void* Y,
                      int64_t m, int32_t n, int32_t k, int64_t kb, int xt, int device,
                      void* stream) {
  return mm_kxt<__nv_bfloat16>(cols, data, B, BP, Y, m, n, k, kb, xt, device, stream);
}

const char* ell_spmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
