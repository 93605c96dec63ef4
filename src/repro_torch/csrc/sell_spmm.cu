// SELL-C-sigma SpMM for Hopper (sm_90a), both rhs orientations:
//   sell_spmm:   Y (M, Kb) = A @ B,   B (N, Kb) row-major;
//   sell_spmm_t: Y (T, M) = X @ A^T, X (T, N) row-major.
//
// Layout (repro_torch.core.formats.SELL, as in sell_spmv.cu): slice s holds
// (ptrs[s+1] - ptrs[s]) / C planes of C contiguous lanes, one entry of each
// of its sorted rows; perm[s*C + r] is the matrix row of lane r of slice s,
// and ghost lanes past the last row carry perm == M.
//
// Replaces the Pallas TPU kernels repro/kernels/sell_spmv.py::sell_spmm
// (_sell_spmm_kernel) and repro/kernels/sell_spmv.py::sell_spmm_t
// (_sell_spmm_t_kernel): (C, tn) / (tn, C) planes of multiply-adds into a
// sorted buffer, scattered through perm by the wrapper in a second pass.
//
// What bounds it on an H100: bytes at T = 1 (8 bytes a live entry in f32,
// plus perm and the slice pointers), operations at T = 256 (2 flops per live
// entry and token; the slices' padding, 1% of the slots at the serving
// shapes, costs its share too). The design:
//   * the slice kernel (sell_spmm_t, and sell_spmm for Kb <= 8): a block of
//     1024 threads owns one slice at a time: thread (r, g) takes lane r of
//     the slice and every G-th plane from plane g (G = 1024 / C plane
//     groups), so with C = 32 each warp reads whole planes (one coalesced
//     load of indices and one of values) and a slice of a pruned weight
//     (rows of ~1024 to ~4096 entries) is read by 32 warps at once, not by
//     one thread a row (which left the card nearly idle at the minitron-8b
//     shapes: 16384 or 4096 rows are too few threads). Any C up to 1024
//     works, only less regularly;
//   * the G partial sums of each (lane, token) meet in shared memory and
//     are added in group order by one thread each: no atomics, and the
//     result is bitwise the same from run to run;
//   * each slot, loaded once, feeds TT multiply-adds (8 tokens at
//     prefill; Kb sums for sell_spmm, read from one short row of B); for
//     sell_spmm_t with TT > 1 the block's tile of X (TT rows, contiguous in
//     X) is copied into shared memory wherever it fits the card's opt-in
//     limit (stage_x), which measured faster than gathering through L1
//     (these blocks hold 1024 threads anyway); a tile too large (the down
//     weight's 16384-wide X at 8 tokens) is gathered through L1;
//   * sell_spmm for Kb > 8 (sell_spmm_kw): KW lanes own one sorted row and
//     walk its slice's planes, lying along B's columns as csr_spmm.cu does:
//     each slot is a broadcast, each B row segment a coalesced load;
//   * the sums go straight to row perm[lane] of Y: no sorted buffer and no
//     second pass; perm is a permutation of the rows plus ghost lanes, so
//     every row is written exactly once (no zero fill); ghost lanes (perm
//     outside [0, M)) write nothing, so whatever they hold never shows;
//   * f32 sums, one rounding to the output type; columns clamp into [0, n),
//     as the reference's jnp.take(mode="clip") does; offsets are int64.

#include "spmm_common.cuh"

namespace {

using spmm::from_f32;
using spmm::to_f32;

// Copy rows [t0, t0 + TT) of X (t rows of n) into `sx`; rows past t are
// zero. The rows are one contiguous run of X: 16-byte copies where the
// run is aligned, element copies otherwise.
template <typename T, int TT>
__device__ void stage_x(T* sx, const T* __restrict__ X, int64_t t0, int64_t t, int32_t n) {
  const int64_t valid = min(static_cast<int64_t>(TT), t - t0) * n;
  const int64_t total = static_cast<int64_t>(TT) * n;
  const T* src = X + t0 * n;
  constexpr int kVec = 16 / sizeof(T);
  int64_t done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int64_t nvec = valid / kVec;
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(sx);
    for (int64_t i = threadIdx.x; i < nvec; i += blockDim.x) d4[i] = s4[i];
    done = nvec * kVec;
  }
  for (int64_t i = done + threadIdx.x; i < total; i += blockDim.x)
    sx[i] = i < valid ? src[i] : from_f32<T>(0.f);
}

// Token tt of rhs row c. TRANS (X (t, n)): X[t0 + tt, c] from the block's
// tile, the staged copy (rows past T are zero) or X itself (tokens past T
// read the tile's last row; their sums are never stored). Otherwise (B (n,
// kb), one tile): B[c, tt], columns past kb read column kb - 1 and are never
// stored.
template <typename T, bool STAGED, bool TRANS>
__device__ __forceinline__ float load_rhs(const T* base, int tt, int last, int32_t n,
                                          int64_t kb, int32_t c) {
  if (!TRANS) return to_f32(base[static_cast<int64_t>(c) * kb + min(tt, last)]);
  const int r = STAGED ? tt : min(tt, last);
  return to_f32(base[static_cast<int64_t>(r) * n + c]);
}

constexpr int kSellBlock = 1024;  // threads per block: 1024 / C plane groups

// Bytes of the partial-sum area (G * C * TT floats), rounded up to 16 so
// the X tile behind it stays aligned.
__host__ __device__ inline size_t partial_bytes(int32_t c, int tt) {
  const size_t b = static_cast<size_t>(kSellBlock / c) * c * tt * sizeof(float);
  return (b + 15) & ~static_cast<size_t>(15);
}

// The slice kernel. TRANS: Y (t, m) = X @ A^T over token tiles of TT.
// Otherwise Y (m, t) = A @ B for B (n, t) with t <= TT (one tile).
template <typename T, int TT, bool STAGED, bool TRANS>
__global__ void __launch_bounds__(kSellBlock)
sell_slices(const int32_t* __restrict__ ptrs, const int32_t* __restrict__ cols,
            const T* __restrict__ data, const int32_t* __restrict__ perm,
            const T* __restrict__ X, T* __restrict__ Y, int64_t nslices, int32_t c, int64_t m,
            int32_t n, int64_t t, int64_t t_tiles, int64_t slices_per_split) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int groups = kSellBlock / c;
  float* part = reinterpret_cast<float*>(smem_raw);  // [TT][groups][c]
  const int64_t t0 = (blockIdx.x % t_tiles) * TT;
  const int64_t split = blockIdx.x / t_tiles;
  const int last = static_cast<int>(min(static_cast<int64_t>(TT), t - t0)) - 1;
  const T* base;
  if (STAGED) {
    T* sx = reinterpret_cast<T*>(smem_raw + partial_bytes(c, TT));
    stage_x<T, TT>(sx, X, t0, t, n);
    __syncthreads();
    base = sx;
  } else {
    base = TRANS ? X + t0 * n : X;
  }
  const int r = threadIdx.x % c;
  const int g = threadIdx.x / c;
  const int64_t s_end = min(nslices, (split + 1) * slices_per_split);
  for (int64_t s = split * slices_per_split; s < s_end; ++s) {
    if (g < groups) {
      float acc[TT];
#pragma unroll
      for (int tt = 0; tt < TT; ++tt) acc[tt] = 0.f;
      const int64_t begin = ptrs[s];
      const int64_t width = (ptrs[s + 1] - begin) / c;
      for (int64_t j = g; j < width; j += groups) {
        const int64_t p = begin + j * c + r;
        const int32_t col = min(max(cols[p], 0), n - 1);
        const float v = to_f32(data[p]);
#pragma unroll
        for (int tt = 0; tt < TT; ++tt)
          acc[tt] += v * load_rhs<T, STAGED, TRANS>(base, tt, last, n, t, col);
      }
#pragma unroll
      for (int tt = 0; tt < TT; ++tt) part[(tt * groups + g) * c + r] = acc[tt];
    }
    __syncthreads();
    for (int o = threadIdx.x; o < c * TT; o += kSellBlock) {
      const int lane = o % c;
      const int tt = o / c;
      float sum = 0.f;
      for (int q = 0; q < groups; ++q) sum += part[(tt * groups + q) * c + lane];
      const int32_t row = perm[s * c + lane];
      if (tt <= last && row >= 0 && row < m)
        Y[TRANS ? (t0 + tt) * m + row : row * t + tt] = from_f32<T>(sum);
    }
    __syncthreads();  // the partials are consumed before the next slice
  }
}

template <typename T, int TT, bool STAGED, bool TRANS>
cudaError_t launch_slices(const void* ptrs, const void* cols, const void* data,
                          const void* perm, const void* X, void* Y, int64_t nslices, int32_t c,
                          int64_t m, int32_t n, int64_t t, int device, cudaStream_t stream) {
  auto kernel = sell_slices<T, TT, STAGED, TRANS>;
  const size_t smem = partial_bytes(c, TT) + (STAGED ? static_cast<size_t>(TT) * n * sizeof(T) : 0);
  int resident = 0;
  cudaError_t err = spmm::resident_blocks(kernel, kSellBlock, smem, device, &resident);
  if (err != cudaSuccess) return err;
  const int64_t t_tiles = (t + TT - 1) / TT;
  int64_t sps = 0, nblocks = 0;
  spmm::split_rows(nslices, t_tiles, resident, 1, &sps, &nblocks);
  if (nblocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(nblocks), kSellBlock, smem, stream>>>(
      static_cast<const int32_t*>(ptrs), static_cast<const int32_t*>(cols),
      static_cast<const T*>(data), static_cast<const int32_t*>(perm),
      static_cast<const T*>(X), static_cast<T*>(Y), nslices, c, m, n, t, t_tiles, sps);
  return cudaGetLastError();
}

// Token tiles of TT: staged for TT > 1 where the tile and the partial sums
// fit the card's opt-in shared memory per block.
template <typename T, int TT>
cudaError_t launch_tile(const void* ptrs, const void* cols, const void* data, const void* perm,
                        const void* X, void* Y, int64_t nslices, int32_t c, int64_t m,
                        int32_t n, int64_t t, int device, cudaStream_t s) {
  int optin = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  const size_t bytes = partial_bytes(c, TT) + static_cast<size_t>(TT) * n * sizeof(T);
  if (TT > 1 && bytes <= static_cast<size_t>(optin))
    return launch_slices<T, TT, true, true>(ptrs, cols, data, perm, X, Y, nslices, c, m, n, t,
                                            device, s);
  return launch_slices<T, TT, false, true>(ptrs, cols, data, perm, X, Y, nslices, c, m, n, t,
                                           device, s);
}

// Y[perm[q], :] = sum over sorted row q's slots of data[p] * B[cols[p], :]
// for Kb > 8: KW lanes (a power of two, at most 32) own sorted row q and
// walk its slice's planes (slot p = ptrs[s] + j*C + r), lane l on columns
// c0 + l, c0 + l + KW, ... (KJ of them, c0 from the grid's y axis). Ghost
// lanes read and write nothing.
template <typename T, int KW, int KJ>
__global__ void __launch_bounds__(spmm::kBlock)
sell_spmm_kw(const int32_t* __restrict__ ptrs, const int32_t* __restrict__ cols,
             const T* __restrict__ data, const int32_t* __restrict__ perm,
             const T* __restrict__ B, T* __restrict__ Y, int64_t lanes, int32_t c, int64_t m,
             int32_t n, int64_t k) {
  const int l = threadIdx.x % KW;
  const int64_t q = static_cast<int64_t>(blockIdx.x) * (spmm::kBlock / KW) + threadIdx.x / KW;
  if (q >= lanes) return;
  const int32_t row = perm[q];
  if (row < 0 || row >= m) return;
  const int64_t s = q / c;
  const int64_t end = ptrs[s + 1];
  const int64_t c0 = static_cast<int64_t>(blockIdx.y) * (KW * KJ) + l;
  float acc[KJ];
#pragma unroll
  for (int j = 0; j < KJ; ++j) acc[j] = 0.f;
  for (int64_t p = ptrs[s] + q % c; p < end; p += c) {
    const int32_t col = min(max(cols[p], 0), n - 1);
    const float v = to_f32(data[p]);
    const T* brow = B + static_cast<int64_t>(col) * k;
#pragma unroll
    for (int j = 0; j < KJ; ++j) {
      const int64_t cj = c0 + j * KW;
      if (cj < k) acc[j] += v * to_f32(brow[cj]);
    }
  }
#pragma unroll
  for (int j = 0; j < KJ; ++j) {
    const int64_t cj = c0 + j * KW;
    if (cj < k) Y[static_cast<int64_t>(row) * k + cj] = from_f32<T>(acc[j]);
  }
}

template <typename T, int KW, int KJ>
cudaError_t launch_kw(const void* ptrs, const void* cols, const void* data, const void* perm,
                      const void* B, void* Y, int64_t lanes, int32_t c, int64_t m, int32_t n,
                      int64_t k, cudaStream_t stream) {
  constexpr int kRows = spmm::kBlock / KW;
  const int64_t gx = (lanes + kRows - 1) / kRows;
  const int64_t gy = (k + KW * KJ - 1) / (KW * KJ);
  if (gx > 0x7fffffffLL || gy > 65535) return cudaErrorInvalidConfiguration;
  sell_spmm_kw<T, KW, KJ><<<dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy)),
                            spmm::kBlock, 0, stream>>>(
      static_cast<const int32_t*>(ptrs), static_cast<const int32_t*>(cols),
      static_cast<const T*>(data), static_cast<const int32_t*>(perm),
      static_cast<const T*>(B), static_cast<T*>(Y), lanes, c, m, n, k);
  return cudaGetLastError();
}

// Y (m, k) = A @ B: the slice kernel with Kb sums a lane for k <= 8, else
// KW lanes along the columns, the smallest power of two >= k up to 32,
// each taking up to 8 columns past 32 (the grid's y axis covers the rest).
template <typename T>
int mm(const void* ptrs, const void* cols, const void* data, const void* perm, const void* B,
       void* Y, int64_t lanes, int32_t c, int64_t m, int32_t n, int64_t k, int device,
       void* stream) {
  if (lanes == 0 || m == 0 || n == 0 || k == 0) return 0;
  if (c <= 0 || c > kSellBlock) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t nslices = lanes / c;
  return spmm::on_device(device, [&]() -> cudaError_t {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (k <= 1)
      return launch_slices<T, 1, false, false>(ptrs, cols, data, perm, B, Y, nslices, c, m, n,
                                               k, device, s);
    if (k <= 2)
      return launch_slices<T, 2, false, false>(ptrs, cols, data, perm, B, Y, nslices, c, m, n,
                                               k, device, s);
    if (k <= 4)
      return launch_slices<T, 4, false, false>(ptrs, cols, data, perm, B, Y, nslices, c, m, n,
                                               k, device, s);
    if (k <= 8)
      return launch_slices<T, 8, false, false>(ptrs, cols, data, perm, B, Y, nslices, c, m, n,
                                               k, device, s);
    if (k <= 16) return launch_kw<T, 16, 1>(ptrs, cols, data, perm, B, Y, lanes, c, m, n, k, s);
    if (k <= 32) return launch_kw<T, 32, 1>(ptrs, cols, data, perm, B, Y, lanes, c, m, n, k, s);
    if (k <= 64) return launch_kw<T, 32, 2>(ptrs, cols, data, perm, B, Y, lanes, c, m, n, k, s);
    if (k <= 128) return launch_kw<T, 32, 4>(ptrs, cols, data, perm, B, Y, lanes, c, m, n, k, s);
    return launch_kw<T, 32, 8>(ptrs, cols, data, perm, B, Y, lanes, c, m, n, k, s);
  });
}

template <typename T>
int mm_t(const void* ptrs, const void* cols, const void* data, const void* perm,
         const void* X, void* Y, int64_t lanes, int32_t c, int64_t m, int32_t n, int64_t t,
         int tt, int device, void* stream) {
  if (lanes == 0 || m == 0 || n == 0 || t == 0) return 0;
  if (c <= 0 || c > kSellBlock) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t nslices = lanes / c;
  return spmm::on_device(device, [&]() -> cudaError_t {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (tt) {
      case 1: return launch_tile<T, 1>(ptrs, cols, data, perm, X, Y, nslices, c, m, n, t, device, s);
      case 2: return launch_tile<T, 2>(ptrs, cols, data, perm, X, Y, nslices, c, m, n, t, device, s);
      case 4: return launch_tile<T, 4>(ptrs, cols, data, perm, X, Y, nslices, c, m, n, t, device, s);
      case 8: return launch_tile<T, 8>(ptrs, cols, data, perm, X, Y, nslices, c, m, n, t, device, s);
      default: return cudaErrorInvalidValue;
    }
  });
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` without synchronising and returns
// cudaGetLastError() (0 on success). `lanes` = nslices * c = len(perm)
// (c at most 1024).
// sell_spmm: B is (n, k) row-major, Y (m, k).
int sell_spmm_f32(const void* ptrs, const void* cols, const void* data, const void* perm,
                  const void* B, void* Y, int64_t lanes, int32_t c, int64_t m, int32_t n,
                  int64_t k, int device, void* stream) {
  return mm<float>(ptrs, cols, data, perm, B, Y, lanes, c, m, n, k, device, stream);
}

int sell_spmm_bf16(const void* ptrs, const void* cols, const void* data, const void* perm,
                   const void* B, void* Y, int64_t lanes, int32_t c, int64_t m, int32_t n,
                   int64_t k, int device, void* stream) {
  return mm<__nv_bfloat16>(ptrs, cols, data, perm, B, Y, lanes, c, m, n, k, device, stream);
}

// sell_spmm_t: X is (t, n), Y (t, m); token tiles of `tt` (1, 2, 4 or 8).
int sell_spmm_t_f32(const void* ptrs, const void* cols, const void* data, const void* perm,
                    const void* X, void* Y, int64_t lanes, int32_t c, int64_t m, int32_t n,
                    int64_t t, int tt, int device, void* stream) {
  return mm_t<float>(ptrs, cols, data, perm, X, Y, lanes, c, m, n, t, tt, device, stream);
}

int sell_spmm_t_bf16(const void* ptrs, const void* cols, const void* data, const void* perm,
                     const void* X, void* Y, int64_t lanes, int32_t c, int64_t m, int32_t n,
                     int64_t t, int tt, int device, void* stream) {
  return mm_t<__nv_bfloat16>(ptrs, cols, data, perm, X, Y, lanes, c, m, n, t, tt, device,
                             stream);
}

const char* sell_spmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
