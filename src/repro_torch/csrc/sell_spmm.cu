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
//   * the slice schedule (sell_spmm for Kb <= 8, sell_spmm_t at xt = 0, T
//     below 64 on the default route; tiles of TT = 1, 2, 4 or 8 rhs
//     columns; one token is sell_spmm's Kb = 1, since X (1, N) is B (N, 1)):
//     a block of 512 threads (1024 for C > 512, or where the staged tile
//     leaves room for one block an SM) takes one slice at a time; thread
//     (r, g) takes lane r and plane group g of G = threads / C, so with C =
//     32 each warp reads whole planes (one coalesced load of indices and
//     one of values), and all of a block's warps read one slice. The
//     launch is decided by the wrapper from the shapes, the SM count and
//     the opt-in shared-memory limit (kernels/sell_spmm.py::slice_plan) and
//     passed in: threads, stage, split and slices a block;
//   * the rhs tile is staged in shared memory (stage_x, 16-byte cp.async
//     copies) wherever it fits the opt-in limit and its copies cost no more
//     bytes than the weight the blocks stream: X's TT rows (contiguous in
//     X) for sell_spmm_t, B (N, Kb) as it lies for sell_spmm, T = 1 and Kb
//     = 1 included. On a magnitude-pruned weight a plane's 32 columns are
//     unrelated: gathered through L1 they touched ~29 cache lines a plane
//     (the old schedule read 51-55% of the bytes bound, PERF.md); from
//     shared memory they cost a few bank-conflict ways. A B of exactly TT
//     columns is read a row a lane in one vector (load_row): TT scalar
//     gathers would conflict TT ways. A tile that does not fit (the down
//     weight's 16384-wide X at 4 and 8 tokens in f32) is read through L1
//     on the same kernel (B's rows still one vector a lane where aligned);
//   * slices too few to fill the card (fewer than the SMs: the down weight
//     has 128 for 132) are split over a thread-block cluster of 2 or 4
//     blocks: rank q sums the q-th contiguous range of the slice's planes,
//     and rank 0 adds the cluster's sums through distributed shared memory
//     in rank order;
//   * each thread walks its planes kUnroll at a time, the kUnroll (column,
//     value) loads issued before the first multiply-add, so a 512-thread
//     block keeps 16 KB of the weight in flight;
//   * the G partial sums of each (lane, token) meet in shared memory and
//     are added in group order by one thread each, then the ranks' in rank
//     order: no atomics, and the result is bitwise the same from run to run
//     (the order depends on the plan, which depends only on the shapes and
//     the card);
//   * sell_spmm_t, xt = 32/64/128 (prefill widths, T >= 32): the token-major
//     schedule of csr_spmm.cu and ell_spmm.cu (spmm_common.cuh::
//     tokens_spmm_t over SellRows): X transposed once a call into scratch
//     XT, a block's xt tokens of it staged in shared memory in column
//     chunks, lanes along tokens, each slot a broadcast feeding xt
//     multiply-adds, the grid over the nslices * C sorted rows; bound by
//     shared-memory wavefronts, as theirs is. A sorted row's slots lie C
//     apart, so a window of 32 of them touches 32 sectors, on the same
//     L1/shared-memory data path that bounds the kernel: walked in place,
//     or loaded 8 rows by 4 planes a load from a window shared by a warp's
//     rows, SELL ran well above CSR's time (PERF.md). So each call first
//     repacks the slices row-major into scratch (repack_slices: the weight
//     read and written once; with the perm scatter, 0.2-0.25 ms a call above
//     CSR's time at the serving shapes, PERF.md), and the rows are then
//     walked as CSR's are. Ghost lanes are empty rows; each sum is stored to
//     Y[t, perm[q]] (a scatter: every row once, no zero fill). Positions
//     are int32 (capacity below 2^31 - 64);
//   * sell_spmm for Kb > 8, xt = tc = 0 (sell_spmm_kw): KW lanes own one
//     sorted row and walk its slice's planes, lying along B's columns as
//     csr_spmm.cu does: each slot is a broadcast, each B row segment a
//     coalesced load; at Kb = 256 each slot pulls 1 KB of B through L1/L2:
//     L2-bound;
//   * sell_spmm, xt = 32/64/128 (tokens_spmm_t with AB): the slices repacked
//     row-major as for sell_spmm_t, then the token-major schedule with B
//     staged in place of XT (ell_spmm.cu's A @ B form), each sum stored to
//     row perm[q]; bound by shared-memory wavefronts plus the repack;
//   * sell_spmm, tc = 128 (spmm_common.cuh::tiles_spmm_ab over SellRows):
//     the slices repacked as for xt, then 64 sorted rows a block scattered
//     into dense tiles of A in shared memory and multiplied on the tensor
//     cores against cp.async-staged panels of B. Reading the planes in
//     place (a lane a sorted row, the warp walking planes in lock-step, each
//     plane one coalesced load) ran slower than the repack plus CSR's row
//     walk on both weights (PERF.md): the lanes' cursors drift tens of
//     planes apart, so each panel walks many planes to take a few entries;
//   * the sums go straight to row perm[lane] of Y: no sorted buffer and no
//     second pass; perm is a permutation of the rows plus ghost lanes, so
//     every row is written exactly once (no zero fill); ghost lanes (perm
//     outside [0, M)) write nothing, so whatever they hold never shows;
//   * f32 sums, one rounding to the output type; columns clamp into [0, n),
//     as the reference's jnp.take(mode="clip") does; offsets are int64.

#include <cooperative_groups.h>

#include "spmm_common.cuh"

namespace {

namespace cg = cooperative_groups;
using spmm::from_f32;
using spmm::to_f32;

constexpr int kSellMaxBlock = 1024;  // threads a block of the slice kernel, at most
// Planes a thread has in flight: 4, and 8 for bf16 at one rhs column,
// where a plane is 192 bytes instead of 256 and the kernel has the
// registers. On an H100 at the minitron-8b weights (PERF.md) 8 took bf16 at
// width 1 from 0.059 to 0.044 ms, and cost 1-3% in f32 and 10-14% at
// width 2, where 4 stays.
template <typename T, int TT>
constexpr int kUnroll = TT == 1 && sizeof(T) == 2 ? 8 : 4;
constexpr int kMaxSplit = 4;         // blocks of a cluster that share a slice

__host__ __device__ inline size_t round16(size_t b) { return (b + 15) & ~static_cast<size_t>(15); }

// Shared memory of the slice kernel, in this order: the groups' partial
// sums [TT][groups][c] (f32), the block's sums [TT][c] (f32, read by the
// cluster's rank 0), then the staged rhs (rhs_elems elements). Each area
// starts 16-byte aligned. kernels/sell_spmm.py::slice_plan computes the same.
__host__ __device__ inline size_t partial_bytes(int threads, int32_t c, int tt) {
  return round16(static_cast<size_t>(threads / c) * c * tt * sizeof(float));
}
__host__ __device__ inline size_t sums_bytes(int32_t c, int tt) {
  return round16(static_cast<size_t>(c) * tt * sizeof(float));
}

// Copy `count` elements from `src` to `dst` (16-byte aligned) with every
// thread of the block: 16-byte cp.async copies where `src` is aligned,
// element copies for the rest. The caller waits (cp_async_wait<0>) and
// synchronises.
template <typename T>
__device__ void stage_x(T* dst, const T* __restrict__ src, int64_t count) {
  constexpr int kVec = 16 / sizeof(T);
  int64_t done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int64_t nvec = count / kVec;
    for (int64_t i = threadIdx.x; i < nvec; i += blockDim.x)
      spmm::cp_async16(dst + i * kVec, src + i * kVec);
    spmm::cp_async_commit();
    done = nvec * kVec;
  }
  for (int64_t i = done + threadIdx.x; i < count; i += blockDim.x) dst[i] = src[i];
}

// Rhs column tt of matrix column col, tt clamped to `last` (the tile's
// last valid token or column: the sums past it are never stored). TRANS:
// base is the tile's first row of X (n wide), staged or in place;
// otherwise base is B (n, kb) row-major, staged or in place.
template <typename T, bool TRANS>
__device__ __forceinline__ float load_rhs(const T* base, int tt, int last, int32_t n,
                                          int64_t kb, int32_t col) {
  const int r = min(tt, last);
  return to_f32(TRANS ? base[static_cast<int64_t>(r) * n + col]
                      : base[static_cast<int64_t>(col) * kb + r]);
}

// Element j of a 32-bit word of T values, as f32 (a bf16 is the high half
// of an f32).
template <typename T>
__device__ __forceinline__ float word_elem(uint32_t w, int j) {
  if constexpr (sizeof(T) == 4) return __uint_as_float(w);
  else return __uint_as_float(j ? w & 0xffff0000u : w << 16);
}

// Row `row` of a B of exactly TT columns (TT * sizeof(T) bytes, aligned to
// that or to 16) into out, in 4- to 16-byte loads: one vector a lane
// instead of TT scalar loads. Staged, the scalar gathers' banks (col * TT +
// tt) % 32 would take only 32 / TT values and conflict TT ways; in place,
// each would be a request of its own. The words are unpacked in registers.
template <typename T, int TT>
__device__ __forceinline__ void load_row(const T* row, float (&out)[TT]) {
  constexpr int kBytes = TT * static_cast<int>(sizeof(T));
  if constexpr (kBytes < 4) {
    out[0] = to_f32(row[0]);
  } else {
    constexpr int kWords = kBytes / 4;
    constexpr int kPer = 4 / static_cast<int>(sizeof(T));
    uint32_t w[kWords];
    if constexpr (kWords >= 4) {
#pragma unroll
      for (int i = 0; i < kWords / 4; ++i) {
        const uint4 v = reinterpret_cast<const uint4*>(row)[i];
        w[4 * i] = v.x;
        w[4 * i + 1] = v.y;
        w[4 * i + 2] = v.z;
        w[4 * i + 3] = v.w;
      }
    } else if constexpr (kWords == 2) {
      const uint2 v = *reinterpret_cast<const uint2*>(row);
      w[0] = v.x;
      w[1] = v.y;
    } else {
      w[0] = *reinterpret_cast<const uint32_t*>(row);
    }
#pragma unroll
    for (int i = 0; i < TT; ++i) out[i] = word_elem<T>(w[i / kPer], i % kPer);
  }
}

// acc[tt] += v * (rhs column tt of matrix column col) for every tt. `rows`:
// B has exactly TT columns and is staged or aligned (load_row); otherwise
// load_rhs.
template <typename T, int TT, bool TRANS>
__device__ __forceinline__ void fma_rhs(float (&acc)[TT], float v, const T* base, int last,
                                        int32_t n, int64_t kb, int32_t col, bool rows) {
  if (!TRANS && rows) {
    float r[TT];
    load_row<T, TT>(base + static_cast<int64_t>(col) * TT, r);
#pragma unroll
    for (int tt = 0; tt < TT; ++tt) acc[tt] += v * r[tt];
    return;
  }
#pragma unroll
  for (int tt = 0; tt < TT; ++tt) acc[tt] += v * load_rhs<T, TRANS>(base, tt, last, n, kb, col);
}

// The slice kernel. TRANS: Y (t, m) = X @ A^T over token tiles of TT.
// Otherwise Y (m, t) = A @ B for B (n, t) with t <= TT (one tile). Block b
// is rank b % split of its cluster and takes unit b / split: token tile
// unit % t_tiles (fastest, so the blocks that run together share their
// slices in L2) of slices [run * per, (run + 1) * per), run = unit /
// t_tiles; rank q sums planes [q * w / split, (q + 1) * w / split) of each
// w-plane slice.
template <typename T, int TT, bool STAGED, bool TRANS>
__global__ void __launch_bounds__(kSellMaxBlock)
sell_slices(const int32_t* __restrict__ ptrs, const int32_t* __restrict__ cols,
            const T* __restrict__ data, const int32_t* __restrict__ perm,
            const T* __restrict__ X, T* __restrict__ Y, int64_t nslices, int32_t c, int64_t m,
            int32_t n, int64_t t, int64_t t_tiles, int64_t per, int split) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int threads = blockDim.x;
  const int groups = threads / c;
  float* part = reinterpret_cast<float*>(smem_raw);  // [TT][groups][c]
  float* sums = reinterpret_cast<float*>(smem_raw + partial_bytes(threads, c, TT));  // [TT][c]
  const int rank = static_cast<int>(blockIdx.x % split);
  const int64_t unit = blockIdx.x / split;
  const int64_t t0 = (unit % t_tiles) * TT;
  const int64_t run = unit / t_tiles;
  const int last = static_cast<int>(min(static_cast<int64_t>(TT), t - t0)) - 1;
  const T* base = TRANS ? X + t0 * n : X;
  if (STAGED) {
    T* sx = reinterpret_cast<T*>(smem_raw + partial_bytes(threads, c, TT) + sums_bytes(c, TT));
    stage_x(sx, base, (TRANS ? last + 1 : t) * static_cast<int64_t>(n));
    spmm::cp_async_wait<0>();
    __syncthreads();
    base = sx;
  }
  // B of exactly TT columns, staged or aligned in place: a row a load
  constexpr int kRowBytes = TT * sizeof(T) < 16 ? TT * sizeof(T) : 16;
  const bool rows = !TRANS && t == TT &&
                    (STAGED || reinterpret_cast<uintptr_t>(X) % kRowBytes == 0);
  const int r = threadIdx.x % c;
  const int g = threadIdx.x / c;
  const int64_t s_end = min(nslices, (run + 1) * per);
  for (int64_t s = run * per; s < s_end; ++s) {
    if (g < groups) {
      float acc[TT];
#pragma unroll
      for (int tt = 0; tt < TT; ++tt) acc[tt] = 0.f;
      const int64_t begin = ptrs[s];
      const int64_t width = (ptrs[s + 1] - begin) / c;
      const int64_t j1 = width * (rank + 1) / split;
      const int32_t* lane_cols = cols + begin + r;
      const T* lane_data = data + begin + r;
      int64_t j = width * rank / split + g;
      // kUnroll planes a trip, their loads issued before the first use
      constexpr int kU = kUnroll<T, TT>;
      for (; j + (kU - 1) * groups < j1; j += kU * groups) {
        int32_t col[kU];
        T val[kU];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int64_t p = (j + u * groups) * c;
          col[u] = lane_cols[p];
          val[u] = lane_data[p];
        }
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          fma_rhs<T, TT, TRANS>(acc, to_f32(val[u]), base, last, n, t,
                                min(max(col[u], 0), n - 1), rows);
        }
      }
      for (; j < j1; j += groups) {
        const int64_t p = j * c;
        fma_rhs<T, TT, TRANS>(acc, to_f32(lane_data[p]), base, last, n, t,
                              min(max(lane_cols[p], 0), n - 1), rows);
      }
#pragma unroll
      for (int tt = 0; tt < TT; ++tt) part[(tt * groups + g) * c + r] = acc[tt];
    }
    __syncthreads();
    for (int o = threadIdx.x; o < c * TT; o += threads) {
      const int lane = o % c;
      const int tt = o / c;
      float sum = 0.f;
      for (int q = 0; q < groups; ++q) sum += part[(tt * groups + q) * c + lane];
      if (split > 1) {
        sums[o] = sum;
        continue;
      }
      const int32_t row = perm[s * c + lane];
      if (tt <= last && row >= 0 && row < m)
        Y[TRANS ? (t0 + tt) * m + row : row * t + tt] = from_f32<T>(sum);
    }
    if (split > 1) {
      cg::cluster_group cluster = cg::this_cluster();
      cluster.sync();  // every rank's sums are in its shared memory
      if (rank == 0) {
        for (int o = threadIdx.x; o < c * TT; o += threads) {
          const int lane = o % c;
          const int tt = o / c;
          float sum = sums[o];
          for (int q = 1; q < split; ++q) sum += cluster.map_shared_rank(sums, q)[o];
          const int32_t row = perm[s * c + lane];
          if (tt <= last && row >= 0 && row < m)
            Y[TRANS ? (t0 + tt) * m + row : row * t + tt] = from_f32<T>(sum);
        }
      }
      cluster.sync();  // rank 0 has read them: the ranks may go on or exit
    } else {
      __syncthreads();  // the partials are consumed before the next slice
    }
  }
}

// The launch a plan (kernels/sell_spmm.py::slice_plan) decided: `threads`
// a block (512 or 1024), the rhs tile staged or not, `split` blocks a
// cluster (1, 2 or 4) and `per` slices a block (1 where split > 1).
struct SlicePlan {
  int threads;
  int stage;
  int split;
  int64_t per;
};

template <typename T, int TT, bool STAGED, bool TRANS>
cudaError_t launch_slices(const void* ptrs, const void* cols, const void* data,
                          const void* perm, const void* X, void* Y, int64_t nslices, int32_t c,
                          int64_t m, int32_t n, int64_t t, SlicePlan plan, cudaStream_t stream) {
  auto kernel = sell_slices<T, TT, STAGED, TRANS>;
  const int64_t rhs_rows = TRANS ? TT : t;  // staged elements: rhs_rows * n
  const size_t smem = partial_bytes(plan.threads, c, TT) + sums_bytes(c, TT) +
                      (STAGED ? static_cast<size_t>(rhs_rows) * n * sizeof(T) : 0);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int64_t t_tiles = TRANS ? (t + TT - 1) / TT : 1;
  const int64_t nblocks = (nslices + plan.per - 1) / plan.per * t_tiles * plan.split;
  if (nblocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(nblocks));
  cfg.blockDim = dim3(static_cast<unsigned>(plan.threads));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(plan.split);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = plan.split > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const int32_t*>(ptrs), static_cast<const int32_t*>(cols),
      static_cast<const T*>(data), static_cast<const int32_t*>(perm),
      static_cast<const T*>(X), static_cast<T*>(Y), nslices, c, m, n, t, t_tiles, plan.per,
      plan.split);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T, int TT, bool TRANS>
cudaError_t launch_plan(const void* ptrs, const void* cols, const void* data, const void* perm,
                        const void* X, void* Y, int64_t nslices, int32_t c, int64_t m,
                        int32_t n, int64_t t, SlicePlan plan, cudaStream_t s) {
  if (plan.stage)
    return launch_slices<T, TT, true, TRANS>(ptrs, cols, data, perm, X, Y, nslices, c, m, n,
                                             t, plan, s);
  return launch_slices<T, TT, false, TRANS>(ptrs, cols, data, perm, X, Y, nslices, c, m, n, t,
                                            plan, s);
}

// A plan the kernel can run: a block holds a slice (threads a multiple of
// 32, at most 1024, >= c), a cluster of 1, 2 or 4 blocks, per >= 1 and 1
// where the slices are split.
bool plan_ok(const SlicePlan& p, int32_t c) {
  return p.threads >= c && p.threads <= kSellMaxBlock && p.threads % 32 == 0 &&
         (p.split == 1 || p.split == 2 || p.split == kMaxSplit) && p.per >= 1 &&
         (p.split == 1 || p.per == 1);
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

// Y (m, k) = A @ B: the slice kernel with Kb sums a lane for k <= 8 (on
// `plan`), else KW lanes along the columns, the smallest power of two >= k
// up to 32, each taking up to 8 columns past 32 (the grid's y axis covers
// the rest).
template <typename T>
int mm(const void* ptrs, const void* cols, const void* data, const void* perm, const void* B,
       void* Y, int64_t lanes, int32_t c, int64_t m, int32_t n, int64_t k, SlicePlan plan,
       int device, void* stream) {
  if (lanes == 0 || m == 0 || n == 0 || k == 0) return 0;
  if (c <= 0 || c > kSellMaxBlock) return static_cast<int>(cudaErrorInvalidValue);
  if (k <= 8 && !plan_ok(plan, c)) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t nslices = lanes / c;
  return spmm::on_device(device, [&]() -> cudaError_t {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (k <= 1)
      return launch_plan<T, 1, false>(ptrs, cols, data, perm, B, Y, nslices, c, m, n, k, plan, s);
    if (k <= 2)
      return launch_plan<T, 2, false>(ptrs, cols, data, perm, B, Y, nslices, c, m, n, k, plan, s);
    if (k <= 4)
      return launch_plan<T, 4, false>(ptrs, cols, data, perm, B, Y, nslices, c, m, n, k, plan, s);
    if (k <= 8)
      return launch_plan<T, 8, false>(ptrs, cols, data, perm, B, Y, nslices, c, m, n, k, plan, s);
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
         int tt, SlicePlan plan, int device, void* stream) {
  if (lanes == 0 || m == 0 || n == 0 || t == 0) return 0;
  if (c <= 0 || c > kSellMaxBlock || !plan_ok(plan, c))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t nslices = lanes / c;
  return spmm::on_device(device, [&]() -> cudaError_t {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (t == 1)  // X (1, n) is B (n, 1), and Y (1, m) is Y (m, 1): sell_spmm's Kb = 1
      return launch_plan<T, 1, false>(ptrs, cols, data, perm, X, Y, nslices, c, m, n, 1, plan,
                                      s);
    switch (tt) {
      case 1: return launch_plan<T, 1, true>(ptrs, cols, data, perm, X, Y, nslices, c, m, n, t, plan, s);
      case 2: return launch_plan<T, 2, true>(ptrs, cols, data, perm, X, Y, nslices, c, m, n, t, plan, s);
      case 4: return launch_plan<T, 4, true>(ptrs, cols, data, perm, X, Y, nslices, c, m, n, t, plan, s);
      case 8: return launch_plan<T, 8, true>(ptrs, cols, data, perm, X, Y, nslices, c, m, n, t, plan, s);
      default: return cudaErrorInvalidValue;
    }
  });
}

// Sorted rows of SELL-C-sigma after its slices were repacked row-major
// (repack_slices), for spmm_common.cuh::tokens_spmm_t: sorted row q, lane
// q % c of slice s = q / c, holds the slice's w = (ptrs[s+1] - ptrs[s]) / c
// slots at [ptrs[s] + (q % c) * w, + w). Its sums are row perm[q] of Y; a
// ghost lane (perm[q] outside [0, m)) has no entries and no row of Y.
struct SellRows {
  const int32_t* ptrs;
  const int32_t* perm;
  int32_t c;
  int64_t m;  // rows of Y
  __device__ __forceinline__ int64_t out(int64_t q) const {
    const int32_t r = perm[q];
    return r >= 0 && r < m ? r : -1;
  }
  __device__ __forceinline__ int64_t begin(int64_t q) const {
    const int64_t s = q / c;
    return ptrs[s] + (q % c) * ((ptrs[s + 1] - ptrs[s]) / c);
  }
  __device__ __forceinline__ int64_t end(int64_t q) const {
    const int64_t s = q / c;
    return out(q) < 0 ? begin(q) : begin(q) + (ptrs[s + 1] - ptrs[s]) / c;
  }
};

// pc/pd[ptrs[s] + r * w + j] = cols/data[ptrs[s] + j * c + r]: slice s's
// w = (ptrs[s+1] - ptrs[s]) / c planes of c lanes turned row-major, so each
// sorted row's slots are contiguous (SellRows). Block (s, y) takes slice
// s's tiles of 32 planes y, y + gridDim.y, ... through a 32x32 shared tile:
// the reads run along a plane, the writes along a row.
template <typename T>
__global__ void __launch_bounds__(256)
repack_slices(const int32_t* __restrict__ ptrs, const int32_t* __restrict__ cols,
              const T* __restrict__ data, int32_t* __restrict__ pc, T* __restrict__ pd,
              int32_t c) {
  __shared__ int32_t tc[32][33];
  __shared__ T td[32][33];
  const int64_t base = ptrs[blockIdx.x];
  const int64_t w = (ptrs[blockIdx.x + 1] - base) / c;
  for (int64_t j0 = static_cast<int64_t>(blockIdx.y) * 32; j0 < w;
       j0 += static_cast<int64_t>(gridDim.y) * 32) {
    for (int r0 = 0; r0 < c; r0 += 32) {
      for (int i = threadIdx.y; i < 32; i += 8) {  // plane j0 + i, lane r0 + x
        const int64_t j = j0 + i;
        const int r = r0 + threadIdx.x;
        if (j < w && r < c) {
          tc[i][threadIdx.x] = cols[base + j * c + r];
          td[i][threadIdx.x] = data[base + j * c + r];
        }
      }
      __syncthreads();
      for (int i = threadIdx.y; i < 32; i += 8) {  // row r0 + i, slot j0 + x
        const int r = r0 + i;
        const int64_t j = j0 + threadIdx.x;
        if (j < w && r < c) {
          pc[base + r * w + j] = tc[threadIdx.x][i];
          pd[base + r * w + j] = td[threadIdx.x][i];
        }
      }
      __syncthreads();
    }
  }
}

constexpr int kRepackSplit = 8;  // blocks a slice: the down weight has 128 slices

// The slices repacked row-major into the caller's scratch pc/pd (capacity
// slots each), on `stream`.
template <typename T>
int repack(const void* ptrs, const void* cols, const void* data, void* pc, void* pd,
           int64_t nslices, int32_t c, int device, void* stream) {
  return spmm::on_device(device, [&]() -> cudaError_t {
    repack_slices<T><<<dim3(static_cast<unsigned>(nslices), kRepackSplit), dim3(32, 8), 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(ptrs), static_cast<const int32_t*>(cols),
        static_cast<const T*>(data), static_cast<int32_t*>(pc), static_cast<T*>(pd), c);
    return cudaGetLastError();
  });
}

// The slices repacked, then over the nslices * c sorted rows the
// token-major schedule (TC false: AB false, Y (t, m) = X @ A^T with rhs = X,
// XT its scratch; AB true, Y (m, t) = A @ B with rhs = B, XT null or its
// padded copy; `knob` = xt) or the dense-tile one (TC: Y (m, t) = A @ B,
// `knob` = tc).
template <typename T, bool AB, bool TC = false>
int mm_rows(const void* ptrs, const void* cols, const void* data, const void* perm,
            const void* rhs, void* XT, void* pc, void* pd, void* Y, int64_t capacity,
            int64_t lanes, int32_t c, int64_t m, int32_t n, int64_t t, int knob, int device,
            void* stream) {
  if (lanes == 0 || m == 0 || n == 0 || t == 0) return 0;
  if (c <= 0 || c > kSellMaxBlock) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t nslices = lanes / c;
  if (nslices > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int err = repack<T>(ptrs, cols, data, pc, pd, nslices, c, device, stream);
  if (err) return err;
  const SellRows rows{static_cast<const int32_t*>(ptrs), static_cast<const int32_t*>(perm),
                      c, m};
  if constexpr (TC)
    return spmm::tiles_spmm_launch<T>(rows, pc, pd, rhs, XT, Y, lanes, n, t, capacity, knob,
                                      device, stream);
  return spmm::tokens_spmm_launch<T, SellRows, AB>(rows, pc, pd, rhs, XT, Y, lanes, m, n, t,
                                                  capacity, knob, device, stream);
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` without synchronising and returns
// cudaGetLastError() (0 on success). `lanes` = nslices * c = len(perm)
// (c at most 1024).
// sell_spmm: B is (n, k) row-major, Y (m, k). For k <= 8 the slice
// kernel runs the plan kernels/sell_spmm.py::slice_plan made: `threads` a
// block, `stage` (0 or 1) the rhs staged in shared memory, `split` blocks a
// cluster a slice, `per` slices a block; unread for k > 8.
int sell_spmm_f32(const void* ptrs, const void* cols, const void* data, const void* perm,
                  const void* B, void* Y, int64_t lanes, int32_t c, int64_t m, int32_t n,
                  int64_t k, int threads, int stage, int split, int64_t per, int device,
                  void* stream) {
  return mm<float>(ptrs, cols, data, perm, B, Y, lanes, c, m, n, k,
                   SlicePlan{threads, stage, split, per}, device, stream);
}

int sell_spmm_bf16(const void* ptrs, const void* cols, const void* data, const void* perm,
                   const void* B, void* Y, int64_t lanes, int32_t c, int64_t m, int32_t n,
                   int64_t k, int threads, int stage, int split, int64_t per, int device,
                   void* stream) {
  return mm<__nv_bfloat16>(ptrs, cols, data, perm, B, Y, lanes, c, m, n, k,
                           SlicePlan{threads, stage, split, per}, device, stream);
}

// sell_spmm_t: X is (t, n), Y (t, m); token tiles of `tt` (1, 2, 4 or 8),
// the slice kernel on a plan as for sell_spmm.
int sell_spmm_t_f32(const void* ptrs, const void* cols, const void* data, const void* perm,
                    const void* X, void* Y, int64_t lanes, int32_t c, int64_t m, int32_t n,
                    int64_t t, int tt, int threads, int stage, int split, int64_t per,
                    int device, void* stream) {
  return mm_t<float>(ptrs, cols, data, perm, X, Y, lanes, c, m, n, t, tt,
                     SlicePlan{threads, stage, split, per}, device, stream);
}

int sell_spmm_t_bf16(const void* ptrs, const void* cols, const void* data, const void* perm,
                     const void* X, void* Y, int64_t lanes, int32_t c, int64_t m, int32_t n,
                     int64_t t, int tt, int threads, int stage, int split, int64_t per,
                     int device, void* stream) {
  return mm_t<__nv_bfloat16>(ptrs, cols, data, perm, X, Y, lanes, c, m, n, t, tt,
                             SlicePlan{threads, stage, split, per}, device, stream);
}

// What slice_plan reads of the card: out[0] its SMs, out[1] the opt-in
// shared memory a block, out[2] the shared memory an SM.
int sell_spmm_limits(int device, int* out) {
  cudaError_t err = cudaDeviceGetAttribute(out, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(out + 1, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(out + 2, cudaDevAttrMaxSharedMemoryPerMultiprocessor, device);
  return static_cast<int>(err);
}

// sell_spmm_t on the token-major schedule: token tiles of `xt` (32, 64 or
// 128); XT is scratch of (n, tp) elements, tp = t rounded up to xt; pcols
// and pdata scratch of `capacity` slots each (the length of cols and data),
// where the slices are repacked row-major.
int sell_spmm_xt_f32(const void* ptrs, const void* cols, const void* data, const void* perm,
                     const void* X, void* XT, void* pcols, void* pdata, void* Y,
                     int64_t capacity, int64_t lanes, int32_t c, int64_t m, int32_t n,
                     int64_t t, int xt, int device, void* stream) {
  return mm_rows<float, false>(ptrs, cols, data, perm, X, XT, pcols, pdata, Y, capacity,
                                 lanes, c, m, n, t, xt, device, stream);
}

int sell_spmm_xt_bf16(const void* ptrs, const void* cols, const void* data, const void* perm,
                      const void* X, void* XT, void* pcols, void* pdata, void* Y,
                      int64_t capacity, int64_t lanes, int32_t c, int64_t m, int32_t n,
                      int64_t t, int xt, int device, void* stream) {
  return mm_rows<__nv_bfloat16, false>(ptrs, cols, data, perm, X, XT, pcols, pdata, Y,
                                         capacity, lanes, c, m, n, t, xt, device, stream);
}

// sell_spmm on the token-major schedule: tiles of `xt` (32, 64 or 128)
// columns of B; BP is null where B is staged as it is (kb a multiple of xt,
// B 16-byte aligned), else scratch of (n, kbp) elements, kbp = kb rounded up
// to xt; pcols and pdata as for sell_spmm_xt.
int sell_spmm_kxt_f32(const void* ptrs, const void* cols, const void* data, const void* perm,
                      const void* B, void* BP, void* pcols, void* pdata, void* Y,
                      int64_t capacity, int64_t lanes, int32_t c, int64_t m, int32_t n,
                      int64_t kb, int xt, int device, void* stream) {
  return mm_rows<float, true>(ptrs, cols, data, perm, B, BP, pcols, pdata, Y, capacity,
                                lanes, c, m, n, kb, xt, device, stream);
}

int sell_spmm_kxt_bf16(const void* ptrs, const void* cols, const void* data, const void* perm,
                       const void* B, void* BP, void* pcols, void* pdata, void* Y,
                       int64_t capacity, int64_t lanes, int32_t c, int64_t m, int32_t n,
                       int64_t kb, int xt, int device, void* stream) {
  return mm_rows<__nv_bfloat16, true>(ptrs, cols, data, perm, B, BP, pcols, pdata, Y,
                                        capacity, lanes, c, m, n, kb, xt, device, stream);
}

// sell_spmm on the dense-tile schedule: strips of `tc` (128) columns
// of B over the repacked slices; BP is null where B is multiplied in place
// (kb a whole number of 16-byte pieces, B 16-byte aligned), else scratch of
// (n, kbp) elements, kbp = kb rounded up to 16 bytes; pcols and pdata as for
// sell_spmm_xt.
int sell_spmm_tc_f32(const void* ptrs, const void* cols, const void* data, const void* perm,
                     const void* B, void* BP, void* pcols, void* pdata, void* Y,
                     int64_t capacity, int64_t lanes, int32_t c, int64_t m, int32_t n,
                     int64_t kb, int tc, int device, void* stream) {
  return mm_rows<float, true, true>(ptrs, cols, data, perm, B, BP, pcols, pdata, Y, capacity,
                                    lanes, c, m, n, kb, tc, device, stream);
}

int sell_spmm_tc_bf16(const void* ptrs, const void* cols, const void* data, const void* perm,
                      const void* B, void* BP, void* pcols, void* pdata, void* Y,
                      int64_t capacity, int64_t lanes, int32_t c, int64_t m, int32_t n,
                      int64_t kb, int tc, int device, void* stream) {
  return mm_rows<__nv_bfloat16, true, true>(ptrs, cols, data, perm, B, BP, pcols, pdata, Y,
                                            capacity, lanes, c, m, n, kb, tc, device, stream);
}

const char* sell_spmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
