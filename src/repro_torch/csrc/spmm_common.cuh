// Pieces shared by the SpMM kernels (csr_spmm.cu, ell_spmm.cu, sell_spmm.cu).
//
// The transposed-rhs kernels (Y = X @ A^T, X is (T, N) row-major, Y is
// (T, M) row-major) give a block a tile of tokens (rows of X) and a run of
// matrix rows; each stored entry, loaded once, feeds a tile's multiply-adds.
// The row-walking formats (CSR, ELL) have two schedules, picked by the
// wrappers' `xt` knob: rows_spmm_t (decode widths: TT <= 8 tokens, X
// gathered through L1, as the SpMV kernels do) and tokens_spmm_t (prefill
// widths: X turned token-major and staged in shared memory, 32 to 128
// tokens a block). SELL's slice kernel (sell_spmm.cu) copies its tile into
// shared memory where it fits; its prefill schedule is tokens_spmm_t over
// its slices repacked row-major. Blocks are numbered token tile fastest, so
// the blocks that run together share their matrix rows in L2.
//
// The row-walking Y = A @ B kernels (B is (N, K) row-major, Y (M, K)) share
// two row schedules, picked by K (rows_spmm_launch): for K > 8, KW lanes own
// a row and lie along B's columns; for K <= 8, a sub-warp of VEC lanes lies
// along the row's entries with K sums a lane. tokens_spmm_t with AB is the
// third, B staged in shared memory in place of XT (the `xt` knob of ELL,
// CSR and SELL); tiles_spmm_ab the fourth, dense tiles of A on the tensor
// cores (the `tc` knob of CSR and SELL).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

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
// (K slots a row, row-major): row i's entries are [begin(i), end(i)) of the
// matrix's arrays, and its sums are row out(i) of Y (none where out(i) < 0;
// sell_spmm.cu's SellRows is the third kind).
struct CsrRows {
  const int32_t* indptr;
  __device__ __forceinline__ int64_t begin(int64_t i) const { return indptr[i]; }
  __device__ __forceinline__ int64_t end(int64_t i) const { return indptr[i + 1]; }
  __device__ __forceinline__ int64_t out(int64_t i) const { return i; }
};

struct EllRows {
  int32_t k;
  __device__ __forceinline__ int64_t begin(int64_t i) const { return i * k; }
  __device__ __forceinline__ int64_t end(int64_t i) const { return i * k + k; }
  __device__ __forceinline__ int64_t out(int64_t i) const { return i; }
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

// ---------------------------------------------------------------------------
// The token-major schedule (prefill widths, T >= 32), for both rhs
// orientations: Y (T, M) = X @ A^T (the transposed rhs) and, with the
// template flag AB, Y (M, Kb) = A @ B.
//
// rows_spmm_t above gathers X (T, N) in place: the TT <= 8 tokens of one
// column lie in TT rows of X and the 32 lanes of a warp on 32 columns, so
// every load touches ~32 sectors to feed 32 multiply-adds (L1-bound), and
// the weight streams from L2 T/8 times. This schedule turns the rhs around:
//   * X (T, N) becomes XT (N, Tp) once per call (transpose_tokens; Tp is T
//     rounded up to the token tile, the extra tokens zero), so the tokens of
//     one column are contiguous. B (N, Kb) of A @ B already is that layout:
//     it is staged as it is where Kb is a multiple of the tile and its rows
//     16-byte aligned, else copied once into (N, Kbp) with zeros past Kb
//     (pad_columns);
//   * a block of kXtWarps warps owns 8 matrix rows a warp (4 or 2 where a
//     short matrix would leave SMs idle) and a tile of TT = 32 * TJ tokens
//     (columns of B); lane l holds tokens l*TJ .. l*TJ + TJ - 1, so one
//     stored entry (c, v) feeds TT multiply-adds: the weight streams from L2
//     Tp/TT times;
//   * XT's slice for the block's tokens is staged in shared memory in
//     column chunks of `nc` (stage_xt, cp.async into two buffers: the next
//     chunk lands while this one is consumed). A lane reads its TJ tokens of
//     column c in one vector load, conflict-free;
//   * a warp walks its rows in lock-step, one 32-entry window of each row a
//     step (its rows' loads in flight together); a window's entries in the
//     chunk are parked in a shared slot and read back as one broadcast load
//     each (a shuffle pair would take two);
//   * a row's entries must be contiguous (a 32-entry window is then one
//     coalesced load); SELL's sorted rows lie C apart in its planes, so its
//     slices are first repacked row-major into scratch (sell_spmm.cu), the
//     weight read and written once a call;
//   * what bounds it on an H100 is shared-memory wavefronts, not operations:
//     per entry, one broadcast and TJ wavefronts of X (4 bytes a f32
//     multiply-add, 2 in bf16): at one wavefront a clock on each of the
//     132 SMs, ~0.7 ms for the 16.8M-entry weight at T = 256 in f32,
//     against the 0.128 ms operation bound. Only reuse of X in registers (a tile of A
//     made dense for the tensor cores) would get under it;
//   * a row is walked chunk by chunk with a cursor: a run of entries whose
//     (clamped) columns do not decrease is consumed once over all chunks.
//     A row may be two such runs (ELL's and SELL's trailing padding, col -1,
//     clamps to column 0 after the sorted entries), each with its own
//     cursor; a row with more descents is filtered: each chunk scans the
//     whole row and takes the entries that fall in it. So any column order
//     is right, and sorted rows (what convert builds) cost one pass;
//   * each (row, token) sum is f32 in registers across the chunks, in a
//     fixed order (chunk by chunk, run A then run B, stored order within
//     each): no atomics, bitwise reruns;
//   * Y (T, M) is written through shared memory with lanes along M
//     (coalesced; SELL scatters each sum to row perm[q]), one rounding to
//     the output type; Y (M, Kb) straight from the registers, lane l's TJ
//     sums one vector store along the row (columns past Kb are not
//     stored).
// Columns clamp into [0, n), as in rows_spmm_t. Offsets into X, XT, B and Y
// are int64; positions in the matrix's arrays int32.

constexpr int kXtWarps = 16;
constexpr int kXtThreads = kXtWarps * 32;
constexpr int32_t kPastAll = 0x7fffffff;  // a column past every chunk

__device__ __forceinline__ int32_t clamp_col(int32_t c, int32_t n) {
  return min(max(c, 0), n - 1);
}

// XT (n, tp) = X (t, n)^T; tokens t..tp-1 are zero. 32x32 tiles through
// shared memory, both sides coalesced.
template <typename T>
__global__ void __launch_bounds__(256)
transpose_tokens(const T* __restrict__ X, T* __restrict__ XT, int64_t t, int32_t n,
                 int64_t tp) {
  __shared__ float tile[32][33];
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * 32;
  const int64_t t0 = static_cast<int64_t>(blockIdx.y) * 32;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int64_t tok = t0 + i, c = c0 + threadIdx.x;
    tile[i][threadIdx.x] = (tok < t && c < n) ? to_f32(X[tok * n + c]) : 0.f;
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int64_t c = c0 + i, tok = t0 + threadIdx.x;
    if (c < n) XT[c * tp + tok] = from_f32<T>(tile[threadIdx.x][i]);
  }
}

// BP (n, kp) = B (n, k) with zeros in columns k..kp-1.
template <typename T>
__global__ void __launch_bounds__(256)
pad_columns(const T* __restrict__ B, T* __restrict__ BP, int32_t n, int64_t k, int64_t kp) {
  const int64_t total = static_cast<int64_t>(n) * kp;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x; i < total;
       i += static_cast<int64_t>(gridDim.x) * 256) {
    const int64_t r = i / kp, c = i % kp;
    BP[i] = c < k ? B[r * k + c] : from_f32<T>(0.f);
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start copying columns [lo, hi) of the block's token slice of XT into
// `buf` ([hi - lo][TT], 16-byte pieces).
template <typename T, int TT>
__device__ __forceinline__ void stage_xt(T* buf, const T* __restrict__ XT, int64_t tp,
                                         int64_t t0, int32_t lo, int32_t hi) {
  constexpr int kPer = 16 / sizeof(T);  // elements a piece
  constexpr int kPieces = TT / kPer;    // pieces a column
  const int total = (hi - lo) * kPieces;
  for (int i = threadIdx.x; i < total; i += kXtThreads) {
    const int col = i / kPieces, piece = i % kPieces;
    cp_async16(buf + col * TT + piece * kPer,
               XT + (static_cast<int64_t>(lo) + col) * tp + t0 + piece * kPer);
  }
}

// TJ (1, 2 or 4) consecutive tokens of one staged column, as f32, in one
// vector load.
template <typename T, int TJ>
__device__ __forceinline__ void load_tokens(const T* p, float (&x)[TJ]) {
  static_assert(TJ == 1 || TJ == 2 || TJ == 4, "token tiles of 32, 64 or 128");
  if constexpr (std::is_same<T, float>::value) {
    if constexpr (TJ == 1) {
      x[0] = *p;
    } else if constexpr (TJ == 2) {
      const float2 f = *reinterpret_cast<const float2*>(p);
      x[0] = f.x; x[1] = f.y;
    } else {
      const float4 f = *reinterpret_cast<const float4*>(p);
      x[0] = f.x; x[1] = f.y; x[2] = f.z; x[3] = f.w;
    }
  } else if constexpr (TJ == 1) {
    x[0] = __bfloat162float(*p);
  } else {
    uint32_t raw[TJ / 2];  // bf16 pairs
    if constexpr (TJ == 2) {
      raw[0] = *reinterpret_cast<const uint32_t*>(p);
    } else {
      const uint2 u = *reinterpret_cast<const uint2*>(p);
      raw[0] = u.x; raw[1] = u.y;
    }
#pragma unroll
    for (int g = 0; g < TJ / 2; ++g) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw[g]));
      x[2 * g] = f.x; x[2 * g + 1] = f.y;
    }
  }
}

// Columns c0 .. c0 + TJ - 1 of one row of Y (M, k) from a lane's sums: one
// vector store where they are whole and aligned (k a multiple of TJ), else
// one element at a time; columns past k are not stored.
template <typename T, int TJ>
__device__ __forceinline__ void store_tokens(T* __restrict__ yrow, int64_t c0, int64_t k,
                                             const float (&a)[TJ]) {
  if constexpr (TJ > 1) {
    if (c0 + TJ <= k && k % TJ == 0) {
      if constexpr (std::is_same<T, float>::value) {
        if constexpr (TJ == 2)
          *reinterpret_cast<float2*>(yrow + c0) = make_float2(a[0], a[1]);
        else
          *reinterpret_cast<float4*>(yrow + c0) = make_float4(a[0], a[1], a[2], a[3]);
      } else {
        uint32_t raw[TJ / 2];  // bf16 pairs, rounded as from_f32 rounds
#pragma unroll
        for (int g = 0; g < TJ / 2; ++g) {
          const __nv_bfloat162 h = __floats2bfloat162_rn(a[2 * g], a[2 * g + 1]);
          raw[g] = *reinterpret_cast<const uint32_t*>(&h);
        }
        if constexpr (TJ == 2)
          *reinterpret_cast<uint32_t*>(yrow + c0) = raw[0];
        else
          *reinterpret_cast<uint2*>(yrow + c0) = make_uint2(raw[0], raw[1]);
      }
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < TJ; ++i)
    if (c0 + i < k) yrow[c0 + i] = from_f32<T>(a[i]);
}

// One window of a row, an entry (c, v) a lane: the entries of lanes with
// `in` (columns in this chunk) are parked in the warp's 32-entry slot, in
// lane order, as (offset of column c in the staged chunk, value bits), and
// each is read back as one broadcast load (a shuffle pair would take two),
// several at a time so the loads overlap: acc += v * XT_s[c - lo][lane's
// tokens]. Returns how many were taken. PREFIX: the lanes with `in` are a
// prefix of the warp (a window of a sorted run), so no lane needs its rank.
template <typename T, int TT, int TJ, bool PREFIX>
__device__ __forceinline__ int take_window(const T* xc, int2* slot, bool in, int32_t c,
                                           float v, int32_t lo, int lane, float (&acc)[TJ]) {
  const unsigned mask = __ballot_sync(0xffffffffu, in);
  __syncwarp();  // every lane is done with the slot's last window
  if constexpr (PREFIX)
    slot[lane] = make_int2(in ? (c - lo) * TT : 0, __float_as_int(v));
  else if (in)
    slot[__popc(mask & ((1u << lane) - 1u))] = make_int2((c - lo) * TT, __float_as_int(v));
  __syncwarp();
  const int cnt = __popc(mask);
  constexpr int kU = TJ >= 4 ? 4 : 8;  // entries in flight (4 keeps TJ = 4 in registers)
  int j = 0;
  for (; j + kU <= cnt; j += kU) {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int2 e = slot[j + u];
      float x[TJ];
      load_tokens<T, TJ>(xc + e.x, x);
      const float ev = __int_as_float(e.y);
#pragma unroll
      for (int i = 0; i < TJ; ++i) acc[i] += ev * x[i];
    }
  }
  for (; j < cnt; ++j) {
    const int2 e = slot[j];
    float x[TJ];
    load_tokens<T, TJ>(xc + e.x, x);
    const float ev = __int_as_float(e.y);
#pragma unroll
    for (int i = 0; i < TJ; ++i) acc[i] += ev * x[i];
  }
  return cnt;
}

// Consume the entries of the non-decreasing run [cur, end) with columns
// below `hi` (all >= lo: the earlier chunks took the rest), one window of
// 32 at a time; returns the new cursor. The entries of this chunk are a
// prefix of each window.
template <typename T, int TT, int TJ>
__device__ __forceinline__ int32_t take_run(const int32_t* __restrict__ idx,
                                            const T* __restrict__ val, const T* xc, int2* slot,
                                            int32_t cur, int32_t end, int32_t n, int32_t lo,
                                            int32_t hi, int lane, float (&acc)[TJ]) {
  while (cur < end) {
    const int32_t p = cur + lane;
    int32_t c = kPastAll;
    float v = 0.f;
    if (p < end) {
      c = clamp_col(idx[p], n);
      v = to_f32(val[p]);
    }
    const int cnt = take_window<T, TT, TJ, true>(xc, slot, c < hi, c, v, lo, lane, acc);
    cur += cnt;
    if (cnt < 32) break;
  }
  return cur;
}

// Take the entries of [b, e) in columns [lo, hi), in stored order (a row
// in no column order: the whole row is scanned every chunk).
template <typename T, int TT, int TJ>
__device__ __forceinline__ void take_filtered(const int32_t* __restrict__ idx,
                                              const T* __restrict__ val, const T* xc,
                                              int2* slot, int32_t b, int32_t e, int32_t n,
                                              int32_t lo, int32_t hi, int lane,
                                              float (&acc)[TJ]) {
  for (int32_t p0 = b; p0 < e; p0 += 32) {
    const int32_t p = p0 + lane;
    int32_t c = -1;
    float v = 0.f;
    if (p < e) {
      c = clamp_col(idx[p], n);
      v = to_f32(val[p]);
    }
    take_window<T, TT, TJ, false>(xc, slot, c >= lo && c < hi, c, v, lo, lane, acc);
  }
}

// The runs of rows first .. first + RPW - 1 (fewer past m), one warp, all
// RPW rows a window at a time: the first descent of the clamped columns
// splits a row in two; a second descent makes it a filtered row. Lane 0
// writes row q's state to cur_a[q], end_a[q] (-1: filtered, spanning
// [cur_a, end_b)), cur_b[q] and end_b[q].
template <int RPW, typename Rows>
__device__ __forceinline__ void scan_runs(Rows rows, const int32_t* __restrict__ idx, int32_t n,
                                          int64_t m, int64_t first, int lane, int32_t* cur_a,
                                          int32_t* end_a, int32_t* cur_b, int32_t* end_b) {
  int32_t b[RPW], e[RPW], split[RPW], prev[RPW];
  int desc[RPW];
  int32_t longest = 0;
#pragma unroll
  for (int q = 0; q < RPW; ++q) {
    const int64_t row = first + q;
    b[q] = e[q] = 0;
    if (row < m) {
      b[q] = static_cast<int32_t>(rows.begin(row));
      e[q] = static_cast<int32_t>(rows.end(row));
    }
    split[q] = e[q];
    prev[q] = -1;
    desc[q] = 0;
    longest = max(longest, e[q] - b[q]);
  }
  for (int32_t w = 0; w < longest; w += 32) {
    int32_t c[RPW];
#pragma unroll
    for (int q = 0; q < RPW; ++q) {
      const int32_t p = b[q] + w + lane;
      c[q] = p < e[q] ? clamp_col(idx[p], n) : kPastAll;
    }
#pragma unroll
    for (int q = 0; q < RPW; ++q) {
      int32_t before = __shfl_up_sync(0xffffffffu, c[q], 1);
      if (lane == 0) before = prev[q];
      prev[q] = __shfl_sync(0xffffffffu, c[q], 31);
      const unsigned mask = __ballot_sync(0xffffffffu, b[q] + w + lane < e[q] && c[q] < before);
      if (mask) {
        if (desc[q] == 0) split[q] = b[q] + w + __ffs(mask) - 1;
        desc[q] += __popc(mask);
      }
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < RPW; ++q) {
      cur_a[q] = b[q];
      end_a[q] = desc[q] >= 2 ? -1 : split[q];
      cur_b[q] = split[q];
      end_b[q] = e[q];
    }
  }
}

// Shared memory of tokens_spmm_t at `nc` columns a chunk: two chunks (for
// Y (T, M) at least the sums' tile), the rows' state and the warps' entry
// slots.
template <typename T, int TJ, int RPW, bool AB>
__host__ __device__ constexpr size_t xt_front(int nc) {
  constexpr int TT = 32 * TJ;
  const size_t chunks = 2 * static_cast<size_t>(nc) * TT * sizeof(T);
  const size_t sums = AB ? 0 : static_cast<size_t>(kXtWarps) * RPW * (TT + 4) * sizeof(float);
  return chunks > sums ? chunks : sums;
}

template <typename T, int TJ, int RPW, bool AB>
__host__ __device__ constexpr size_t xt_smem(int nc) {
  constexpr size_t rows = kXtWarps * RPW;
  return xt_front<T, TJ, RPW, AB>(nc) + 4 * rows * sizeof(int32_t) +
         kXtWarps * 32 * sizeof(int2);
}

// Y[t, out(i)] (AB: Y[out(i), t]) = sum_p val[p] * XT[idx[p], t] over the
// block's kXtWarps * RPW rows (RPW a warp) and TT = 32 * TJ tokens. Every
// warp walks its RPW rows in lock-step, one 32-entry window of each row a
// step (so RPW row loads are in flight at once), with the rows' sums in
// registers across the chunks; a window's entries in this chunk are parked in the warp's
// 32-entry slot (take_window). Shared memory: two XT chunks [nc][TT], the
// rows' state [4][rows] (run A cursor and end, run B cursor and end; run
// A's end is -1 for a filtered row, which spans [cursor A, end B)), and the
// slots [kXtWarps][32]. For Y (T, M) the sums leave through the chunk
// buffers ([rows][TT + 4] f32) at the end; for Y (M, Kb) straight from the
// registers. `m` rows are walked; Y (T, M) has `ym` columns, Y (M, Kb) rows
// of `t` columns. Positions are int32 (the launcher checks that they fit).
template <typename T, typename Rows, int TJ, int RPW, bool AB>
__global__ void __launch_bounds__(kXtThreads, 1)
tokens_spmm_t(Rows rows, const int32_t* __restrict__ idx, const T* __restrict__ val,
              const T* __restrict__ XT, T* __restrict__ Y, int64_t m, int64_t ym, int32_t n,
              int64_t t, int64_t tp, int64_t t_tiles, int nc) {
  constexpr int TT = 32 * TJ;
  constexpr int AS = TT + 4;  // row stride of the sums at the end (16-byte aligned)
  constexpr int R = kXtWarps * RPW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);
  int32_t* st = reinterpret_cast<int32_t*>(smem_raw + xt_front<T, TJ, RPW, AB>(nc));
  int32_t* cur_a = st;
  int32_t* end_a = st + R;
  int32_t* cur_b = st + 2 * R;
  int32_t* end_b = st + 3 * R;
  int2* slot = reinterpret_cast<int2*>(st + 4 * R) + (threadIdx.x >> 5) * 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t t0 = (blockIdx.x % t_tiles) * TT;
  const int64_t row0 = (blockIdx.x / t_tiles) * R;
  const int r0 = warp * RPW;
  const int nchunks = (n + nc - 1) / nc;

  stage_xt<T, TT>(xs, XT, tp, t0, 0, min(n, nc));  // lands during the row scan
  cp_async_commit();
  scan_runs<RPW>(rows, idx, n, m, row0 + r0, lane, cur_a + r0, end_a + r0, cur_b + r0,
                 end_b + r0);

  float acc[RPW][TJ];
#pragma unroll
  for (int q = 0; q < RPW; ++q)
#pragma unroll
    for (int i = 0; i < TJ; ++i) acc[q][i] = 0.f;

  for (int k = 0; k < nchunks; ++k) {
    const int32_t lo = k * nc, hi = min(n, lo + nc);
    if (k + 1 < nchunks) {
      stage_xt<T, TT>(xs + ((k + 1) & 1) * static_cast<size_t>(nc) * TT, XT, tp, t0, hi,
                      min(n, hi + nc));
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* xc = xs + (k & 1) * static_cast<size_t>(nc) * TT + lane * TJ;
    // run A of every row, in lock-step
    int32_t cur[RPW], end[RPW];
    unsigned live = 0;
#pragma unroll
    for (int q = 0; q < RPW; ++q) {
      cur[q] = cur_a[r0 + q];
      end[q] = end_a[r0 + q];
      if (cur[q] < end[q]) live |= 1u << q;
    }
    while (live) {
      int32_t c[RPW];
      float v[RPW];
#pragma unroll
      for (int q = 0; q < RPW; ++q) {
        const int32_t p = cur[q] + lane;
        c[q] = kPastAll;
        v[q] = 0.f;
        if (((live >> q) & 1u) && p < end[q]) {
          c[q] = clamp_col(idx[p], n);
          v[q] = to_f32(val[p]);
        }
      }
#pragma unroll
      for (int q = 0; q < RPW; ++q) {
        if ((live >> q) & 1u) {
          const int cnt =
              take_window<T, TT, TJ, true>(xc, slot, c[q] < hi, c[q], v[q], lo, lane, acc[q]);
          cur[q] += cnt;
          if (cnt < 32 || cur[q] >= end[q]) live &= ~(1u << q);
        }
      }
    }
    // run B, and the filtered rows
#pragma unroll
    for (int q = 0; q < RPW; ++q) {
      const int r = r0 + q;
      if (end[q] < 0) {
        take_filtered<T, TT, TJ>(idx, val, xc, slot, cur_a[r], end_b[r], n, lo, hi, lane,
                                 acc[q]);
      } else if (cur_b[r] < end_b[r]) {
        const int32_t cb = take_run<T, TT, TJ>(idx, val, xc, slot, cur_b[r], end_b[r], n, lo,
                                               hi, lane, acc[q]);
        __syncwarp();
        if (lane == 0) cur_b[r] = cb;
      }
    }
    __syncwarp();
    if (lane == 0) {
#pragma unroll
      for (int q = 0; q < RPW; ++q)
        if (end[q] >= 0) cur_a[r0 + q] = cur[q];
    }
    __syncthreads();  // the buffer of chunk k is refilled with chunk k + 2
  }

  if constexpr (AB) {
    // Y (m, t): lane l's TJ sums are columns t0 + l*TJ .. of the row
#pragma unroll
    for (int q = 0; q < RPW; ++q) {
      const int64_t row = row0 + r0 + q;
      if (row < m) {
        const int64_t o = rows.out(row);
        if (o >= 0) store_tokens<T, TJ>(Y + o * t, t0 + lane * TJ, t, acc[q]);
      }
    }
  } else {
    // Y (t, ym) through the chunk buffers: lanes along the rows, so each
    // store runs along M (SELL: to row perm[q], a scatter)
    float* acc_s = reinterpret_cast<float*>(smem_raw);
#pragma unroll
    for (int q = 0; q < RPW; ++q)
#pragma unroll
      for (int i = 0; i < TJ; ++i) acc_s[(r0 + q) * AS + lane * TJ + i] = acc[q][i];
    __syncthreads();
    for (int i = threadIdx.x; i < R * TT; i += kXtThreads) {
      const int tt = i / R, r = i % R;
      const int64_t row = row0 + r, tok = t0 + tt;
      if (row < m && tok < t) {
        const int64_t o = rows.out(row);
        if (o >= 0) Y[tok * ym + o] = from_f32<T>(acc_s[r * AS + tt]);
      }
    }
  }
}

constexpr int kXtRowsPerWarp = 8;  // at most; 4 or 2 on a matrix of few rows

template <typename T, typename Rows, int TJ, int RPW, bool AB>
cudaError_t launch_tokens_rpw(Rows rows, const void* idx, const void* val, const T* XT,
                              void* Y, int64_t m, int64_t ym, int32_t n, int64_t t, int64_t tp,
                              int64_t t_tiles, int nc, cudaStream_t stream) {
  constexpr int R = kXtWarps * RPW;
  const int64_t nblocks = ((m + R - 1) / R) * t_tiles;
  if (nblocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const size_t smem = xt_smem<T, TJ, RPW, AB>(nc);
  auto kernel = tokens_spmm_t<T, Rows, TJ, RPW, AB>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(nblocks), kXtThreads, smem, stream>>>(
      rows, static_cast<const int32_t*>(idx), static_cast<const T*>(val), XT,
      static_cast<T*>(Y), m, ym, n, t, tp, t_tiles, nc);
  return cudaGetLastError();
}

// Stage the rhs token-major, then launch tokens_spmm_t. Y (t, ym) = X @
// A^T: X (t, n) transposed into the scratch XT (n, tp). AB, Y (m, t) = A @
// B: B (n, t) staged as it is where XT is null (t a multiple of the tile, B
// 16-byte aligned), else copied into XT (n, tp) with zeros past t.
// The chunk width is what the card's opt-in shared memory leaves for two
// buffers, rounded down to 8 columns: it depends on the card, the dtype
// and TT only. A block takes kXtRowsPerWarp rows a warp, halved (down to
// 2) while the grid would leave more than half the SMs without a block.
template <typename T, typename Rows, int TJ, bool AB>
cudaError_t launch_tokens_t(Rows rows, const void* idx, const void* val, const void* rhs,
                            void* XT, void* Y, int64_t m, int64_t ym, int32_t n, int64_t t,
                            int64_t entries, int device, cudaStream_t stream) {
  constexpr int TT = 32 * TJ;
  if (entries > 0x7fffffffLL - 64) return cudaErrorInvalidValue;  // int32 positions
  const int64_t t_tiles = (t + TT - 1) / TT;
  const int64_t tp = t_tiles * TT;
  const T* xt = static_cast<const T*>(XT);
  cudaError_t err;
  if (!AB) {
    if (tp / 32 > 65535) return cudaErrorInvalidConfiguration;
    const dim3 tgrid(static_cast<unsigned>((n + 31) / 32), static_cast<unsigned>(tp / 32));
    transpose_tokens<T><<<tgrid, dim3(32, 8), 0, stream>>>(
        static_cast<const T*>(rhs), static_cast<T*>(XT), t, n, tp);
  } else if (XT == nullptr) {
    if (tp != t || (reinterpret_cast<uintptr_t>(rhs) & 15)) return cudaErrorInvalidValue;
    xt = static_cast<const T*>(rhs);
  } else {
    const int64_t blocks = std::min<int64_t>((static_cast<int64_t>(n) * tp + 255) / 256, 65536);
    pad_columns<T><<<static_cast<unsigned>(blocks), 256, 0, stream>>>(
        static_cast<const T*>(rhs), static_cast<T*>(XT), n, t, tp);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  int sms = 0, optin = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
      cudaSuccess)
    return err;
  if ((err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                    device)) != cudaSuccess)
    return err;
  constexpr int kRpw = kXtRowsPerWarp;
  const int64_t rest = static_cast<int64_t>(xt_smem<T, TJ, kRpw, true>(0));  // state, slots
  const int nc = static_cast<int>((optin - rest) / (2 * TT * sizeof(T))) / 8 * 8;
  if (nc < 8 || xt_smem<T, TJ, kRpw, AB>(nc) > static_cast<size_t>(optin))
    return cudaErrorInvalidConfiguration;
  int rpw = kRpw;
  while (rpw > 2 && ((m + kXtWarps * rpw - 1) / (kXtWarps * rpw)) * t_tiles * 2 <= sms)
    rpw /= 2;
  switch (rpw) {
    case 2:
      return launch_tokens_rpw<T, Rows, TJ, 2, AB>(rows, idx, val, xt, Y, m, ym, n, t, tp,
                                                   t_tiles, nc, stream);
    case 4:
      return launch_tokens_rpw<T, Rows, TJ, 4, AB>(rows, idx, val, xt, Y, m, ym, n, t, tp,
                                                   t_tiles, nc, stream);
    default:
      return launch_tokens_rpw<T, Rows, TJ, kRpw, AB>(rows, idx, val, xt, Y, m, ym, n, t, tp,
                                                      t_tiles, nc, stream);
  }
}

// The token-major schedule, token tiles of `xt` (32, 64 or 128), `entries`
// the positions the format's arrays hold (checked against int32). Y (t, ym)
// = X @ A^T over `m` rows (XT: the caller's (n, tp) scratch, tp = t rounded
// up to xt); AB: Y (m, t) = A @ B (XT: null, or the caller's (n, tp)
// scratch where B is not staged as it is).
template <typename T, typename Rows, bool AB>
int tokens_spmm_launch(Rows rows, const void* idx, const void* val, const void* rhs, void* XT,
                       void* Y, int64_t m, int64_t ym, int32_t n, int64_t t, int64_t entries,
                       int xt, int device, void* stream) {
  if (m == 0 || t == 0 || n == 0) return 0;
  return on_device(device, [&]() -> cudaError_t {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (xt) {
      case 32:
        return launch_tokens_t<T, Rows, 1, AB>(rows, idx, val, rhs, XT, Y, m, ym, n, t, entries,
                                               device, s);
      case 64:
        return launch_tokens_t<T, Rows, 2, AB>(rows, idx, val, rhs, XT, Y, m, ym, n, t, entries,
                                               device, s);
      case 128:
        return launch_tokens_t<T, Rows, 4, AB>(rows, idx, val, rhs, XT, Y, m, ym, n, t, entries,
                                               device, s);
      default: return cudaErrorInvalidValue;
    }
  });
}

// ---------------------------------------------------------------------------
// The dense-tile schedule (Y (M, Kb) = A @ B at wide B; the wrappers' `tc`
// knob), on the tensor cores.
//
// tokens_spmm_t with AB is bound by shared-memory wavefronts (one broadcast
// and Kb/32 wavefronts of B an entry, ~0.64-0.73 ms for the 16.8M-entry
// weight at Kb = 256 in f32, PERF.md), because nothing it loads serves more
// than one entry. This schedule gives up the sparsity inside a tile to reuse
// B in registers:
//   * a block of kTcWarps warps owns kTcRows = 64 rows of A (SELL: 64 sorted
//     rows of its repacked slices) and a strip of kTcStrip = `tc` = 128
//     columns of B and Y, and walks N in panels of kTcDepth = 64;
//   * per panel it zero-fills a 64 x 64 f32 tile of A in shared memory and
//     adds into it the stored entries of its rows that fall in the panel; a
//     panel with no entry in the block's rows is skipped, products and all;
//   * the B panels (64 x 128) are staged by cp.async tc_stages - 1 ahead, so
//     they land while earlier panels are multiplied; rows past N and columns
//     past B's data land as zeros;
//   * the products run on the tensor cores with mma.sync, the warps 2 x 4
//     over the block's 64 x 128 outputs, the sums in f32 registers across all
//     panels. bf16: m16n8k16 on the tile rounded to bf16, exact (every entry
//     is a bf16 value) unless a panel added two entries into one slot: then
//     the remainder lo = a - bf16(a) is multiplied too (lo, then hi). f32:
//     3xTF32 on m16n8k8, each value split into big = tf32(v) and small =
//     tf32(v - big), summed small*big + big*small + big*big in that order;
//   * densify_rows: a warp owns 8 rows, walked as tokens_spmm_t walks them (a
//     cursor a non-decreasing run, filtered rows scanned whole each panel), a
//     32-entry window a row a step, a lane an entry. Each row's next window
//     is loaded a panel ahead, while the current panel is multiplied. In a
//     sorted run each lane stores its own slot; a column repeated in the
//     panel (adjacent in the run) is added in stored order by one lane; run
//     B and filtered rows add, lanes whose columns meet summed in lane order
//     by the lowest of them first. No shared atomics: bitwise reruns;
//   * what bounds it: the tensor work of the dense tiles, 2 * M * N * Kb
//     multiply-adds (3x in f32) whatever the density, the densify, and the
//     staging of B, read from L2 once per 64 rows; the densify overlaps the
//     products only across the two blocks a multiprocessor holds. On an
//     H100 it beat tokens_spmm_t only in bf16, above a density, on a matrix
//     of many row tiles (kernels/ops.py::TC_*, PERF.md). A dense tile also
//     multiplies B's entries by
//     structural zeros: a non-finite B gives NaN where the other schedules'
//     gathered products give a finite sum;
//   * Y is stored once, straight from the accumulator fragments, a row's two
//     adjacent columns as one vector where Kb is even; rows past M, ghost
//     lanes and columns past Kb store nothing.
// Positions in the matrix's arrays are int32 (the launcher checks), offsets
// into B and Y int64.

constexpr int kTcWarps = 8;
constexpr int kTcThreads = kTcWarps * 32;
constexpr int kTcRows = 64;                         // rows of A a block (32 a warp row)
constexpr int kTcDepth = 64;                        // columns of A (rows of B) a panel
constexpr int kTcStrip = 128;                       // columns of B and Y a block (the `tc` knob)
constexpr int kTcRowsPerWarp = kTcRows / kTcWarps;  // densify_rows
static_assert(kTcRows == 32 * (kTcWarps / 4), "warps 4 wide, 32 rows a warp row");

// B panels in flight: 3 in bf16; 2 in f32, whose third would leave room
// for one block a multiprocessor.
template <typename T>
__host__ __device__ constexpr int tc_stages() {
  return std::is_same<T, float>::value ? 2 : 3;
}

// Row strides: A's tile in f32 words (4 mod 32 for tf32's single loads, 8
// mod 32 for bf16's pair loads: conflict-free), B's panel in elements
// (kTcBStride, 8 past the strip: conflict-free fragment loads and ldmatrix
// rows).
template <typename T>
__host__ __device__ constexpr int tc_a_stride() {
  return kTcDepth + (std::is_same<T, float>::value ? 4 : 8);
}
constexpr int kTcBStride = kTcStrip + 8;

// Shared memory: two A tiles, tc_stages B panels, the panels' flags
// [2][warps], the rows' run state [4][kTcRows] and the warps' window slots
// [warps][32].
template <typename T>
__host__ __device__ constexpr size_t tc_smem() {
  return 2 * static_cast<size_t>(kTcRows) * tc_a_stride<T>() * sizeof(float) +
         tc_stages<T>() * static_cast<size_t>(kTcDepth) * kTcBStride * sizeof(T) +
         (2 * kTcWarps + 4 * kTcRows) * sizeof(int32_t) + kTcWarps * 32 * sizeof(float);
}

// cp.async of 16 bytes, of which the first `bytes` (0 or 16) are read and
// the rest zero-filled.
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}

// Start copying rows [lo, lo + kTcDepth) and columns [c0, c0 + kTcStrip) of
// B (n rows of ldb elements, a whole number of 16-byte pieces) into `buf`
// ([kTcDepth][kTcBStride]); rows past n and columns past ldb land as zeros.
template <typename T>
__device__ __forceinline__ void stage_b(T* buf, const T* __restrict__ B, int32_t n, int64_t ldb,
                                        int32_t lo, int64_t c0) {
  constexpr int kPer = 16 / sizeof(T);
  constexpr int kPieces = kTcStrip / kPer;
  for (int i = threadIdx.x; i < kTcDepth * kPieces; i += kTcThreads) {
    const int r = i / kPieces, piece = i % kPieces;
    const int64_t row = static_cast<int64_t>(lo) + r, col = c0 + piece * kPer;
    const bool in = row < n && col < ldb;
    cp_async16_zfill(buf + r * kTcBStride + piece * kPer, in ? B + row * ldb + col : B,
                     in ? 16 : 0);
  }
}

template <typename T>
__device__ __forceinline__ void zero_tile(float* a) {
  constexpr int kVec = kTcRows * tc_a_stride<T>() / 4;
  float4* a4 = reinterpret_cast<float4*>(a);
  for (int i = threadIdx.x; i < kVec; i += kTcThreads) a4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// Add one window of a row (an entry a lane; `in`: its column falls in the
// panel, at offset `off`) to the row's tile slots `arow`. Lanes whose
// offsets meet are summed in lane order by the lowest of them first,
// through the warp's 32 slots. Sets `dup` where a slot takes a second
// entry. Returns the count taken (a prefix of the window in a sorted run).
__device__ __forceinline__ int add_window(float* arow, float* slot, bool in, int32_t off,
                                          float v, int lane, bool& dup) {
  const unsigned mask = __ballot_sync(0xffffffffu, in);
  if (mask == 0u) return 0;
  const unsigned grp = __match_any_sync(0xffffffffu, in ? off : -1 - lane);
  const bool lead = in && (grp & ((1u << lane) - 1u)) == 0u;
  float s = v;
  if (__any_sync(0xffffffffu, in && grp != (1u << lane))) {
    __syncwarp();  // every lane is done with the slots' last use
    slot[lane] = v;
    __syncwarp();
    if (lead) {
      s = 0.f;
      for (unsigned rest = grp; rest; rest &= rest - 1u) s += slot[__ffs(rest) - 1];
    }
    dup = true;
  }
  if (lead) {
    const float old = arow[off];
    arow[off] = old + s;
    dup |= old != 0.f;
  }
  return __popc(mask);
}

// Add one window of a sorted run to the row's tile slots: the entries in
// the panel (lanes with `in`) are a prefix of the window, and a column's
// repeats are adjacent. With no repeat each lane stores its own slot; a
// repeat (two lanes on one column, or lane 0 on a slot the run filled from
// an earlier window: non-zero, since the tile was zero) makes lane 0 add
// the window's entries in order, and sets `dup`. Returns the count taken.
__device__ __forceinline__ int add_run_window(float* arow, bool in, int32_t off, float v,
                                              int lane, bool& dup) {
  const unsigned mask = __ballot_sync(0xffffffffu, in);
  if (mask == 0u) return 0;
  const int cnt = __popc(mask);
  const int32_t before = __shfl_up_sync(0xffffffffu, off, 1);
  const bool rep = in && (lane == 0 ? arow[off] != 0.f : off == before);
  if (__any_sync(0xffffffffu, rep)) {
    for (int j = 0; j < cnt; ++j) {
      const int32_t o = __shfl_sync(0xffffffffu, off, j);
      const float x = __shfl_sync(0xffffffffu, v, j);
      if (lane == 0) arow[o] += x;
    }
    dup = true;
  } else if (in) {
    arow[off] = v;
  }
  return cnt;
}

// The window of run A at each row's cursor cur[q] (run end end[q]), an
// entry a lane: loaded one panel ahead, so the loads are in flight while
// the current panel is multiplied.
template <typename T>
__device__ __forceinline__ void load_windows(const int32_t* __restrict__ idx,
                                             const T* __restrict__ val, int32_t n,
                                             const int32_t (&cur)[kTcRowsPerWarp],
                                             const int32_t (&end)[kTcRowsPerWarp], int lane,
                                             int32_t (&c)[kTcRowsPerWarp],
                                             float (&v)[kTcRowsPerWarp]) {
#pragma unroll
  for (int q = 0; q < kTcRowsPerWarp; ++q) {
    const int32_t p = cur[q] + lane;
    c[q] = kPastAll;
    v[q] = 0.f;
    if (p < end[q]) {
      c[q] = clamp_col(idx[p], n);
      v[q] = to_f32(val[p]);
    }
  }
}

// Add the entries in columns [lo, hi) of the warp's kTcRowsPerWarp rows
// (tile rows r0 .., run state at cur_a[r0] ..) to tile `a`: run A of every
// row in lock-step, a window a row a step, the first window the one held in
// (c, v); then run B and the filtered rows (general windows). Leaves in
// (c, v) the windows of the next panel. Returns whether any entry fell in
// the panel (the same on every lane).
template <typename T>
__device__ bool densify_rows(const int32_t* __restrict__ idx, const T* __restrict__ val,
                             int32_t n, int32_t lo, int32_t hi, float* a, int32_t* cur_a,
                             int32_t* end_a, int32_t* cur_b, int32_t* end_b, float* slot, int r0,
                             int lane, int32_t (&c)[kTcRowsPerWarp], float (&v)[kTcRowsPerWarp],
                             bool& dup) {
  constexpr int RPW = kTcRowsPerWarp;
  constexpr int SA = tc_a_stride<T>();
  bool any = false;
  int32_t cur[RPW], end[RPW];
  unsigned live = 0;
#pragma unroll
  for (int q = 0; q < RPW; ++q) {
    cur[q] = cur_a[r0 + q];
    end[q] = end_a[r0 + q];
    if (cur[q] < end[q]) live |= 1u << q;
  }
  for (bool ahead = true; live; ahead = false) {
    if (!ahead) {  // a row whose whole window fell in the panel reads on
#pragma unroll
      for (int q = 0; q < RPW; ++q) {
        const int32_t p = cur[q] + lane;
        c[q] = kPastAll;
        v[q] = 0.f;
        if (((live >> q) & 1u) && p < end[q]) {
          c[q] = clamp_col(idx[p], n);
          v[q] = to_f32(val[p]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < RPW; ++q) {
      if ((live >> q) & 1u) {
        const int cnt = add_run_window(a + (r0 + q) * SA, c[q] < hi, c[q] - lo, v[q], lane, dup);
        any |= cnt > 0;
        cur[q] += cnt;
        if (cnt < 32 || cur[q] >= end[q]) live &= ~(1u << q);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < RPW; ++q) {
    const int r = r0 + q;
    float* arow = a + r * SA;
    if (end[q] < 0) {  // filtered: the whole row, every panel
      const int32_t e = end_b[r];
      for (int32_t p0 = cur_a[r]; p0 < e; p0 += 32) {
        const int32_t p = p0 + lane;
        int32_t cc = -1;
        float vv = 0.f;
        if (p < e) {
          cc = clamp_col(idx[p], n);
          vv = to_f32(val[p]);
        }
        any |= add_window(arow, slot, cc >= lo && cc < hi, cc - lo, vv, lane, dup) > 0;
      }
    } else if (cur_b[r] < end_b[r]) {
      int32_t cb = cur_b[r];
      const int32_t eb = end_b[r];
      while (cb < eb) {
        const int32_t p = cb + lane;
        int32_t cc = kPastAll;
        float vv = 0.f;
        if (p < eb) {
          cc = clamp_col(idx[p], n);
          vv = to_f32(val[p]);
        }
        const int cnt = add_window(arow, slot, cc < hi, cc - lo, vv, lane, dup);
        any |= cnt > 0;
        cb += cnt;
        if (cnt < 32) break;
      }
      __syncwarp();
      if (lane == 0) cur_b[r] = cb;
    }
  }
  __syncwarp();
  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < RPW; ++q)
      if (end[q] >= 0) cur_a[r0 + q] = cur[q];
  }
  load_windows<T>(idx, val, n, cur, end, lane, c, v);
  return any;
}

__device__ __forceinline__ void split_tf32(float v, uint32_t& big, uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(v));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(v - __uint_as_float(big)));
}

// Two adjacent f32 values of the tile as a bf16 pair (the lower column in
// the low half) and the pair of their remainders.
__device__ __forceinline__ void split_bf16(const float* p, uint32_t& hi, uint32_t& lo) {
  const float2 x = *reinterpret_cast<const float2*>(p);
  const __nv_bfloat162 h = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x.x - __low2float(h), x.y - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8x8 bf16 matrices of B's panel, transposed on the way: lane l gives
// the address of row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4_trans(const void* p, uint32_t& r0, uint32_t& r1,
                                                  uint32_t& r2, uint32_t& r3) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(s));
}

// acc += the warp's part of tile `a` (kTcRows x kTcDepth, f32) times panel
// `b` (kTcDepth x kTcStrip): warp (wm, wn) of 2 x 4 owns rows wm*32 .. +31
// and columns wn*kTcStrip/4 .., as 2 x kTcStrip/32 fragments of 16 x 8.
// `lo_pass` (bf16 only): a slot of the tile holds a sum, multiply its
// remainder too.
template <typename T>
__device__ __forceinline__ void mma_panel(const float* a, const T* b,
                                          float (&acc)[2][kTcStrip / 32][4],
                                          bool lo_pass, int warp, int lane) {
  constexpr int SA = tc_a_stride<T>(), SB = kTcBStride, NT = kTcStrip / 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = (warp >> 2) * 32, wn = (warp & 3) * (kTcStrip / 4);
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int kk = 0; kk < kTcDepth; kk += 8) {
      uint32_t ab[2][4], asm_[2][4], bb[NT][2], bsm[NT][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* p = a + (wm + mt * 16 + g) * SA + kk + t4;
        split_tf32(p[0], ab[mt][0], asm_[mt][0]);            // (g, t)
        split_tf32(p[8 * SA], ab[mt][1], asm_[mt][1]);       // (g + 8, t)
        split_tf32(p[4], ab[mt][2], asm_[mt][2]);            // (g, t + 4)
        split_tf32(p[8 * SA + 4], ab[mt][3], asm_[mt][3]);   // (g + 8, t + 4)
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const T* q = b + (kk + t4) * SB + wn + nt * 8 + g;
        split_tf32(q[0], bb[nt][0], bsm[nt][0]);       // (k = t, n = g)
        split_tf32(q[4 * SB], bb[nt][1], bsm[nt][1]);  // (k = t + 4, n = g)
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          mma_tf32(acc[mt][nt], asm_[mt], bb[nt]);
          mma_tf32(acc[mt][nt], ab[mt], bsm[nt]);
          mma_tf32(acc[mt][nt], ab[mt], bb[nt]);
        }
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < kTcDepth; kk += 16) {
      uint32_t ah[2][4], al[2][4], bf[NT][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* p = a + (wm + mt * 16 + g) * SA + kk + 2 * t4;
        split_bf16(p, ah[mt][0], al[mt][0]);                // (g, 2t ..)
        split_bf16(p + 8 * SA, ah[mt][1], al[mt][1]);       // (g + 8, 2t ..)
        split_bf16(p + 8, ah[mt][2], al[mt][2]);            // (g, 2t + 8 ..)
        split_bf16(p + 8 * SA + 8, ah[mt][3], al[mt][3]);   // (g + 8, 2t + 8 ..)
      }
      const int j = lane >> 3, r = lane & 7;
#pragma unroll
      for (int np = 0; np < NT / 2; ++np)
        ldmatrix_x4_trans(b + (kk + ((j & 1) << 3) + r) * SB + wn + np * 16 + ((j >> 1) << 3),
                          bf[2 * np][0], bf[2 * np][1], bf[2 * np + 1][0], bf[2 * np + 1][1]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          if (lo_pass) mma_bf16(acc[mt][nt], al[mt], bf[nt]);
          mma_bf16(acc[mt][nt], ah[mt], bf[nt]);
        }
    }
  }
}

// Columns col, col + 1 of one row of Y (k columns): one vector where both
// are in and k is even (so the pair is aligned), else each alone.
template <typename T>
__device__ __forceinline__ void store_pair(T* __restrict__ yrow, int64_t col, int64_t k,
                                           float v0, float v1) {
  if (col + 1 < k && (k & 1) == 0) {
    if constexpr (std::is_same<T, float>::value)
      *reinterpret_cast<float2*>(yrow + col) = make_float2(v0, v1);
    else
      *reinterpret_cast<__nv_bfloat162*>(yrow + col) = __floats2bfloat162_rn(v0, v1);
    return;
  }
  if (col < k) yrow[col] = from_f32<T>(v0);
  if (col + 1 < k) yrow[col + 1] = from_f32<T>(v1);
}

// Y[out(i), c0 + j] = sum over row i's entries of val[p] * B[idx[p], c0 + j]
// for the block's kTcRows rows and strip of kTcStrip columns (blocks numbered
// strip fastest: the blocks of one row tile run together and share its
// entries in L2). B is (n, ldb) row-major, the first kb columns data and the
// rest zero; Y (rows, kb). `m` rows are walked (SELL: sorted rows).
template <typename T, typename Rows>
__global__ void __launch_bounds__(kTcThreads, 2)
tiles_spmm_ab(Rows rows, const int32_t* __restrict__ idx, const T* __restrict__ val,
              const T* __restrict__ B, T* __restrict__ Y, int64_t m, int32_t n, int64_t kb,
              int64_t ldb, int64_t strips) {
  constexpr int SA = tc_a_stride<T>(), SB = kTcBStride, NT = kTcStrip / 32;
  constexpr int RPW = kTcRowsPerWarp, kStages = tc_stages<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* as = reinterpret_cast<float*>(smem_raw);  // [2][kTcRows][SA]
  T* bs = reinterpret_cast<T*>(smem_raw + 2 * kTcRows * SA * sizeof(float));  // [stages][kTcDepth][SB]
  int32_t* flags = reinterpret_cast<int32_t*>(bs + kStages * kTcDepth * SB);  // [2][kTcWarps]
  int32_t* st = flags + 2 * kTcWarps;                                          // [4][kTcRows]
  float* slots = reinterpret_cast<float*>(st + 4 * kTcRows);                   // [kTcWarps][32]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t c0 = (blockIdx.x % strips) * kTcStrip;
  const int64_t row0 = (blockIdx.x / strips) * kTcRows;
  const int npanels = (n + kTcDepth - 1) / kTcDepth;

  // B panels 0 .. kStages - 2 land during the row scan; every step then
  // commits one group (empty past the last panel), so panel k's group is
  // done once at most kStages - 2 younger ones are pending
#pragma unroll
  for (int s = 0; s + 1 < kStages; ++s) {
    if (s < npanels) stage_b<T>(bs + s * kTcDepth * SB, B, n, ldb, s * kTcDepth, c0);
    cp_async_commit();
  }
  zero_tile<T>(as);
  zero_tile<T>(as + kTcRows * SA);
  const int r0 = warp * RPW;
  scan_runs<RPW>(rows, idx, n, m, row0 + r0, lane, st + r0, st + kTcRows + r0,
                 st + 2 * kTcRows + r0, st + 3 * kTcRows + r0);
  __syncthreads();  // the tiles are zero, the run state written

  // run A's next window of each of the warp's rows, loaded a panel ahead
  int32_t wc[RPW], wcur[RPW], wend[RPW];
  float wv[RPW];
#pragma unroll
  for (int q = 0; q < RPW; ++q) {
    wcur[q] = st[r0 + q];
    wend[q] = st[kTcRows + r0 + q];
  }
  load_windows<T>(idx, val, n, wcur, wend, lane, wc, wv);

  // panel p's entries into tile `a`; each warp flags whether it took any
  // (bit 0) and whether a slot took two (bit 1)
  auto densify = [&](int p, float* a) {
    const int32_t lo = p * kTcDepth, hi = min(n, lo + kTcDepth);
    bool dup = false;
    const bool took = densify_rows<T>(idx, val, n, lo, hi, a, st, st + kTcRows,
                                      st + 2 * kTcRows, st + 3 * kTcRows, slots + warp * 32,
                                      r0, lane, wc, wv, dup);
    dup = __any_sync(0xffffffffu, dup);
    if (lane == 0) flags[(p & 1) * kTcWarps + warp] = (took ? 1 : 0) | (dup ? 2 : 0);
  };

  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  densify(0, as);
  bool prev_took = false;  // panel k - 1 left entries in its tile
  for (int k = 0; k < npanels; ++k) {
    const int cur = k & 1;
    float* a_nxt = as + (cur ^ 1) * kTcRows * SA;
    const int ahead = k + kStages - 1;  // its buffer was last read by panel k - 1
    if (ahead < npanels)
      stage_b<T>(bs + (ahead % kStages) * kTcDepth * SB, B, n, ldb, ahead * kTcDepth, c0);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    if (prev_took) zero_tile<T>(a_nxt);  // panel k - 1's tile, multiplied by every warp
    __syncthreads();  // panel k's B landed and its tile is whole; the other tile is zero
    int f = 0;
#pragma unroll
    for (int w = 0; w < kTcWarps; ++w) f |= flags[cur * kTcWarps + w];
    prev_took = (f & 1) != 0;
    if (prev_took)
      mma_panel<T>(as + cur * kTcRows * SA, bs + (k % kStages) * kTcDepth * SB, acc,
                       (f & 2) != 0, warp, lane);
    if (k + 1 < npanels) densify(k + 1, a_nxt);
    __syncthreads();  // panel k's tile and B are consumed; panel k + 1's tile is whole
  }

  const int g = lane >> 2, t4 = lane & 3;
  const int wm = (warp >> 2) * 32, wn = (warp & 3) * (kTcStrip / 4);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t row = row0 + wm + mt * 16 + g + h * 8;
      if (row >= m) continue;
      const int64_t o = rows.out(row);
      if (o < 0) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        store_pair<T>(Y + o * kb, c0 + wn + nt * 8 + 2 * t4, kb, acc[mt][nt][2 * h],
                      acc[mt][nt][2 * h + 1]);
    }
}

template <typename T, typename Rows>
cudaError_t launch_tiles(Rows rows, const void* idx, const void* val, const T* B, void* Y,
                         int64_t m, int32_t n, int64_t kb, int64_t ldb, cudaStream_t stream) {
  const int64_t strips = (kb + kTcStrip - 1) / kTcStrip;
  const int64_t nblocks = ((m + kTcRows - 1) / kTcRows) * strips;
  if (nblocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  constexpr size_t smem = tc_smem<T>();
  auto kernel = tiles_spmm_ab<T, Rows>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(nblocks), kTcThreads, smem, stream>>>(
      rows, static_cast<const int32_t*>(idx), static_cast<const T*>(val), B, static_cast<T*>(Y),
      m, n, kb, ldb, strips);
  return cudaGetLastError();
}

// The dense-tile schedule, strips of `tc` (128) columns: Y (rows,
// kb) = A @ B over `m` rows of A (SELL: its sorted rows), `entries` the
// positions the format's arrays hold (checked against int32). B (n, kb) is
// multiplied in place where BP is null (kb a whole number of 16-byte pieces,
// B 16-byte aligned), else first copied into BP (n, kbp), kbp = kb rounded
// up to 16 bytes, with zeros past kb.
template <typename T, typename Rows>
int tiles_spmm_launch(Rows rows, const void* idx, const void* val, const void* B, void* BP,
                      void* Y, int64_t m, int32_t n, int64_t kb, int64_t entries, int tc,
                      int device, void* stream) {
  if (m == 0 || kb == 0 || n == 0) return 0;
  if (entries > 0x7fffffffLL - 64) return static_cast<int>(cudaErrorInvalidValue);
  if (tc != kTcStrip) return static_cast<int>(cudaErrorInvalidValue);
  return on_device(device, [&]() -> cudaError_t {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    constexpr int64_t kPer = 16 / sizeof(T);
    const int64_t kbp = (kb + kPer - 1) / kPer * kPer;
    const T* b = static_cast<const T*>(B);
    if (BP == nullptr) {
      if (kbp != kb || (reinterpret_cast<uintptr_t>(B) & 15)) return cudaErrorInvalidValue;
    } else {
      const int64_t blocks = std::min<int64_t>((static_cast<int64_t>(n) * kbp + 255) / 256, 65536);
      pad_columns<T><<<static_cast<unsigned>(blocks), 256, 0, s>>>(b, static_cast<T*>(BP), n, kb,
                                                                   kbp);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return err;
      b = static_cast<const T*>(BP);
    }
    return launch_tiles<T, Rows>(rows, idx, val, b, Y, m, n, kb, kbp, s);
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
