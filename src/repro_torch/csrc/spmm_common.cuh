// Pieces shared by the SpMM kernels (csr_spmm.cu, ell_spmm.cu, sell_spmm.cu).
//
// The transposed-rhs kernels (Y = X @ A^T, X is (T, N) row-major, Y is
// (T, M) row-major) share one work split. A block owns a tile of TT rows of
// X ("tokens") and a run of matrix rows; each stored entry, loaded once,
// feeds TT multiply-adds. The row-walking kernels (CSR, ELL) gather X
// through L1, as the SpMV kernels do; the SELL kernel copies its tile into
// shared memory where it fits (sell_spmm.cu). Blocks are numbered token
// tile fastest, so the blocks that run together share their matrix rows in
// L2 while each reads its own X tile.
//
// The row-walking Y = A @ B kernels (B is (N, K) row-major, Y (M, K)) share
// two row schedules, picked by K (rows_spmm_launch): for K > 8, KW lanes own
// a row and lie along B's columns; for K <= 8, a sub-warp of VEC lanes lies
// along the row's entries with K sums a lane.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace spmm {

constexpr int kBlock = 256;  // threads per block in every SpMM kernel

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Rows of the transposed-rhs split: `t_tiles` token tiles, each cut into
// runs of `rows_per_split` matrix rows (a multiple of `granule`, the rows
// one pass of a block covers), about four blocks per resident block slot.
inline void split_rows(int64_t m, int64_t t_tiles, int resident, int granule,
                       int64_t* rows_per_split, int64_t* nblocks) {
  const int64_t want = std::max<int64_t>(1, (4LL * resident + t_tiles - 1) / t_tiles);
  int64_t rps = (m + want - 1) / want;
  rps = std::max<int64_t>(granule, ((rps + granule - 1) / granule) * granule);
  *rows_per_split = rps;
  *nblocks = ((m + rps - 1) / rps) * t_tiles;
}

// Resident blocks of `kernel` (`threads` a block) on the whole card at
// `smem` bytes of dynamic shared memory each (the kernel is first allowed
// that much).
template <typename Kern>
cudaError_t resident_blocks(Kern kernel, int threads, size_t smem, int device, int* out) {
  int sms = 0, per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  *out = std::max(1, per_sm) * sms;
  return cudaSuccess;
}

// Run `launch` with `device` current and give the caller's thread its own
// device back.
template <typename F>
int on_device(int device, F&& launch) {
  int prev = -1;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return static_cast<int>(err);
  err = launch();
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}

// Matrix rows of the row-walking formats: CSR (its row pointers) and ELL
// (K slots a row, row-major).
struct CsrRows {
  const int32_t* indptr;
  __device__ __forceinline__ int64_t begin(int64_t i) const { return indptr[i]; }
  __device__ __forceinline__ int64_t end(int64_t i) const { return indptr[i + 1]; }
};

struct EllRows {
  int32_t k;
  __device__ __forceinline__ int64_t begin(int64_t i) const { return i * k; }
  __device__ __forceinline__ int64_t end(int64_t i) const { return i * k + k; }
};

// Y[t, i] = sum_p val[p] * X[t, idx[p]] over row i's entries [begin, end).
// A sub-warp of VEC lanes owns a row: its lanes read consecutive entries
// (coalesced), each keeps TT f32 sums, a butterfly of shuffles combines
// the lanes (every lane ends with the same sums, bitwise), and lane
// tt % VEC stores Y[t0 + tt, i]. X is gathered in place through L1 (a
// shared-memory copy of the tile would cost these 256-thread blocks their
// occupancy); tokens past T read the tile's last row, and their sums are
// never stored. Columns clamp into [0, n).
template <typename T, typename Rows, int VEC, int TT>
__global__ void __launch_bounds__(kBlock)
rows_spmm_t(Rows rows, const int32_t* __restrict__ idx, const T* __restrict__ val,
            const T* __restrict__ X, T* __restrict__ Y, int64_t m, int32_t n, int64_t t,
            int64_t t_tiles, int64_t rows_per_split) {
  const int64_t t0 = (blockIdx.x % t_tiles) * TT;
  const int64_t split = blockIdx.x / t_tiles;
  const int last = static_cast<int>(min(static_cast<int64_t>(TT), t - t0)) - 1;
  const T* base = X + t0 * n;
  constexpr int kGroups = kBlock / VEC;
  const int lane = threadIdx.x & (VEC - 1);
  const int group = threadIdx.x / VEC;
  const int64_t r_begin = split * rows_per_split;
  const int64_t r_end = min(m, r_begin + rows_per_split);
  // Every warp runs the same passes (the shuffles need the whole warp).
  for (int64_t r0 = r_begin; r0 < r_end; r0 += kGroups) {
    const int64_t row = r0 + group;
    float acc[TT];
#pragma unroll
    for (int tt = 0; tt < TT; ++tt) acc[tt] = 0.f;
    if (row < r_end) {
      const int64_t e = rows.end(row);
      for (int64_t p = rows.begin(row) + lane; p < e; p += VEC) {
        const int32_t c = min(max(idx[p], 0), n - 1);
        const float v = to_f32(val[p]);
#pragma unroll
        for (int tt = 0; tt < TT; ++tt)
          acc[tt] += v * to_f32(base[static_cast<int64_t>(min(tt, last)) * n + c]);
      }
    }
#pragma unroll
    for (int tt = 0; tt < TT; ++tt) {
#pragma unroll
      for (int off = VEC / 2; off > 0; off >>= 1)
        acc[tt] += __shfl_xor_sync(0xffffffffu, acc[tt], off, VEC);
    }
    if (row < r_end) {
#pragma unroll
      for (int tt = 0; tt < TT; ++tt)
        if (tt % VEC == lane && tt <= last) Y[(t0 + tt) * m + row] = from_f32<T>(acc[tt]);
    }
  }
}

// Launch rows_spmm_t<T, Rows, VEC, TT> over (t, m) on `stream`.
template <typename T, typename Rows, int VEC, int TT>
cudaError_t launch_rows_t(Rows rows, const void* idx, const void* val, const void* X, void* Y,
                          int64_t m, int32_t n, int64_t t, int device, cudaStream_t stream) {
  auto kernel = rows_spmm_t<T, Rows, VEC, TT>;
  int resident = 0;
  cudaError_t err = resident_blocks(kernel, kBlock, 0, device, &resident);
  if (err != cudaSuccess) return err;
  const int64_t t_tiles = (t + TT - 1) / TT;
  int64_t rps = 0, nblocks = 0;
  split_rows(m, t_tiles, resident, kBlock / VEC, &rps, &nblocks);
  if (nblocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(nblocks), kBlock, 0, stream>>>(
      rows, static_cast<const int32_t*>(idx), static_cast<const T*>(val),
      static_cast<const T*>(X), static_cast<T*>(Y), m, n, t, t_tiles, rps);
  return cudaGetLastError();
}

template <typename T, typename Rows, int VEC>
cudaError_t launch_rows_t_tile(Rows rows, const void* idx, const void* val, const void* X,
                               void* Y, int64_t m, int32_t n, int64_t t, int tt, int device,
                               cudaStream_t s) {
  switch (tt) {
    case 1: return launch_rows_t<T, Rows, VEC, 1>(rows, idx, val, X, Y, m, n, t, device, s);
    case 2: return launch_rows_t<T, Rows, VEC, 2>(rows, idx, val, X, Y, m, n, t, device, s);
    case 4: return launch_rows_t<T, Rows, VEC, 4>(rows, idx, val, X, Y, m, n, t, device, s);
    case 8: return launch_rows_t<T, Rows, VEC, 8>(rows, idx, val, X, Y, m, n, t, device, s);
    default: return cudaErrorInvalidValue;
  }
}

// Y (t, m) = X @ A^T for a row-walking format, `vec` lanes a row and token
// tiles of `tt` (both powers of two, as the wrapper checks).
template <typename T, typename Rows>
int rows_spmm_t_launch(Rows rows, const void* idx, const void* val, const void* X, void* Y,
                       int64_t m, int32_t n, int64_t t, int vec, int tt, int device,
                       void* stream) {
  if (m == 0 || t == 0 || n == 0) return 0;
  return on_device(device, [&]() -> cudaError_t {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (vec) {
      case 2: return launch_rows_t_tile<T, Rows, 2>(rows, idx, val, X, Y, m, n, t, tt, device, s);
      case 4: return launch_rows_t_tile<T, Rows, 4>(rows, idx, val, X, Y, m, n, t, tt, device, s);
      case 8: return launch_rows_t_tile<T, Rows, 8>(rows, idx, val, X, Y, m, n, t, tt, device, s);
      case 16: return launch_rows_t_tile<T, Rows, 16>(rows, idx, val, X, Y, m, n, t, tt, device, s);
      case 32: return launch_rows_t_tile<T, Rows, 32>(rows, idx, val, X, Y, m, n, t, tt, device, s);
      default: return cudaErrorInvalidValue;
    }
  });
}


// Y[i, :] = sum_p val[p] * B[idx[p], :] for K > 8: KW lanes (a power of two,
// at most 32) own row i, lane l on columns c0 + l, c0 + l + KW, ... (KJ of
// them, c0 from the grid's y axis). The row's entries are read once by the
// whole group (one address: a broadcast) and each B row segment is a
// coalesced load. Columns clamp into [0, n); an empty row writes zeros.
template <typename T, typename Rows, int KW, int KJ>
__global__ void __launch_bounds__(kBlock)
rows_spmm_kw(Rows rows, const int32_t* __restrict__ idx, const T* __restrict__ val,
             const T* __restrict__ B, T* __restrict__ Y, int64_t m, int32_t n, int64_t k) {
  const int lane = threadIdx.x % KW;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kBlock / KW) + threadIdx.x / KW;
  const int64_t c0 = static_cast<int64_t>(blockIdx.y) * (KW * KJ) + lane;
  if (row >= m) return;
  float acc[KJ];
#pragma unroll
  for (int j = 0; j < KJ; ++j) acc[j] = 0.f;
  const int64_t end = rows.end(row);
  for (int64_t p = rows.begin(row); p < end; ++p) {
    const int32_t c = min(max(idx[p], 0), n - 1);
    const float v = to_f32(val[p]);
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
template <typename T, typename Rows, int VEC, int KK>
__global__ void __launch_bounds__(kBlock)
rows_spmm_vec(Rows rows, const int32_t* __restrict__ idx, const T* __restrict__ val,
              const T* __restrict__ B, T* __restrict__ Y, int64_t m, int32_t n, int64_t k) {
  const int lane = threadIdx.x & (VEC - 1);
  const int64_t row = (static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x) / VEC;
  float acc[KK];
#pragma unroll
  for (int j = 0; j < KK; ++j) acc[j] = 0.f;
  if (row < m) {
    const int64_t end = rows.end(row);
    for (int64_t p = rows.begin(row) + lane; p < end; p += VEC) {
      const int32_t c = min(max(idx[p], 0), n - 1);
      const float v = to_f32(val[p]);
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

template <typename T, typename Rows, int VEC, int KK>
cudaError_t launch_vec(Rows rows, const void* idx, const void* val, const void* B, void* Y,
                       int64_t m, int32_t n, int64_t k, cudaStream_t stream) {
  const int64_t grid = (m * VEC + kBlock - 1) / kBlock;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  rows_spmm_vec<T, Rows, VEC, KK><<<static_cast<unsigned>(grid), kBlock, 0, stream>>>(
      rows, static_cast<const int32_t*>(idx), static_cast<const T*>(val),
      static_cast<const T*>(B), static_cast<T*>(Y), m, n, k);
  return cudaGetLastError();
}

template <typename T, typename Rows, int VEC>
cudaError_t launch_vec_k(Rows rows, const void* idx, const void* val, const void* B, void* Y,
                         int64_t m, int32_t n, int64_t k, cudaStream_t s) {
  if (k <= 1) return launch_vec<T, Rows, VEC, 1>(rows, idx, val, B, Y, m, n, k, s);
  if (k <= 2) return launch_vec<T, Rows, VEC, 2>(rows, idx, val, B, Y, m, n, k, s);
  if (k <= 4) return launch_vec<T, Rows, VEC, 4>(rows, idx, val, B, Y, m, n, k, s);
  return launch_vec<T, Rows, VEC, 8>(rows, idx, val, B, Y, m, n, k, s);
}

template <typename T, typename Rows, int KW, int KJ>
cudaError_t launch_kw(Rows rows, const void* idx, const void* val, const void* B, void* Y,
                      int64_t m, int32_t n, int64_t k, cudaStream_t stream) {
  const int64_t gx = (m + kBlock / KW - 1) / (kBlock / KW);
  const int64_t gy = (k + KW * KJ - 1) / (KW * KJ);
  if (gx > 0x7fffffffLL || gy > 65535) return cudaErrorInvalidConfiguration;
  rows_spmm_kw<T, Rows, KW, KJ><<<dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy)),
                                  kBlock, 0, stream>>>(
      rows, static_cast<const int32_t*>(idx), static_cast<const T*>(val),
      static_cast<const T*>(B), static_cast<T*>(Y), m, n, k);
  return cudaGetLastError();
}

// Y (m, k) = A @ B for a row-walking format. K <= 8: `vec` lanes a row
// along its entries (rows_spmm_vec). Wider: lanes along K, the smallest
// power of two >= K up to 32; past 32 lanes each lane takes up to 8
// columns (KJ), and the grid's y axis covers the rest.
template <typename T, typename Rows>
int rows_spmm_launch(Rows rows, const void* idx, const void* val, const void* B, void* Y,
                     int64_t m, int32_t n, int64_t k, int vec, int device, void* stream) {
  if (m == 0 || k == 0) return 0;
  return on_device(device, [&]() -> cudaError_t {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (k <= 8) {
      switch (vec) {
        case 2: return launch_vec_k<T, Rows, 2>(rows, idx, val, B, Y, m, n, k, s);
        case 4: return launch_vec_k<T, Rows, 4>(rows, idx, val, B, Y, m, n, k, s);
        case 8: return launch_vec_k<T, Rows, 8>(rows, idx, val, B, Y, m, n, k, s);
        case 16: return launch_vec_k<T, Rows, 16>(rows, idx, val, B, Y, m, n, k, s);
        case 32: return launch_vec_k<T, Rows, 32>(rows, idx, val, B, Y, m, n, k, s);
        default: return cudaErrorInvalidValue;
      }
    }
    if (k <= 16) return launch_kw<T, Rows, 16, 1>(rows, idx, val, B, Y, m, n, k, s);
    if (k <= 32) return launch_kw<T, Rows, 32, 1>(rows, idx, val, B, Y, m, n, k, s);
    if (k <= 64) return launch_kw<T, Rows, 32, 2>(rows, idx, val, B, Y, m, n, k, s);
    if (k <= 128) return launch_kw<T, Rows, 32, 4>(rows, idx, val, B, Y, m, n, k, s);
    return launch_kw<T, Rows, 32, 8>(rows, idx, val, B, Y, m, n, k, s);
  });
}

}  // namespace spmm
