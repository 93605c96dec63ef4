// CG's vector algebra for Hopper (sm_90a): the work XLA fuses into the body
// of the JAX package's device-side CG loop.
//
// Replaces no Pallas kernel. The JAX package runs cg and pcg as one
// jax.lax.while_loop (repro/core/solvers.py:96, :177) and cg_fixed_iters
// under lax.scan (:114); XLA fuses the dots, the axpys and the waxpby of
// each iteration around the SpMV. repro_torch/core/solvers.py runs the same
// iterations in blocks captured into a CUDA graph, and these kernels are
// that loop body's vector work:
//   dot       (a) block partials of x . y (p . Ap; PCG's r . z);
//   update    (b) alpha = rho / max(p . Ap, 1e-30) from the device scalars,
//                 x += alpha p, r -= alpha Ap, and the partials of r . r;
//   direction (c) beta = rho_new / max(rho, 1e-30), p = z + beta p (CG: z = r);
//   finish        rr and rho written, history[k + 1] = sqrt(rr), k + 1 and
//                 the next iteration's flag (rr > tol2 and k + 1 < maxiter).
// Every kernel reads the flag st[1] first and writes nothing when it is 0:
// an inactive iteration leaves x, r, p, the scalars, k and the history bit
// for bit as they were, as the JAX while_loop's cond does.
//
// What bounds it on an H100: bytes. An iteration reads p and Ap (a), x, r,
// p, Ap and writes x, r (b), reads z and p and writes p (c): 11 vectors,
// ~0.015 ms at 104^3 in f32 over 3.35 TB/s. So each kernel is one
// grid-stride pass with 16-byte loads and stores where every pointer is
// 16-byte aligned (the wrapper checks), f32 sums for bf16 vectors.
//
// Fixed summation order, no atomics: a dot writes one partial per block
// (each thread's elements in index order, then a shuffle tree and a tree
// over the warps); whoever needs the sum (update, direction, finish)
// adds the partials in index order within one block. Every block of update
// and direction does that same sum, so all use the same alpha and beta, and
// reruns are bitwise. The grid is a function of n alone.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;     // threads a block, every kernel

__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ double to_acc(double v) { return v; }

template <typename T, typename A> __device__ __forceinline__ T from_acc(A v);
template <> __device__ __forceinline__ float from_acc<float, float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_acc<__nv_bfloat16, float>(float v) {
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ double from_acc<double, double>(double v) { return v; }

template <typename T> struct AccOf { using type = float; };
template <> struct AccOf<double> { using type = double; };

// 16 bytes of T: one vector load or store.
template <typename T> struct alignas(16) Vec {
  static constexpr int N = 16 / sizeof(T);
  T v[N];
};

template <typename A> __device__ __forceinline__ A warp_sum(A v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// The block's sum, returned to every thread. `smem` holds 32 values.
template <typename A> __device__ A block_sum(A v, A* smem) {
  v = warp_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // the previous call's readers are done with smem
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (blockDim.x >> 5) ? smem[lane] : A(0);
    v = warp_sum(v);
    if (lane == 0) smem[0] = v;
  }
  __syncthreads();
  return smem[0];
}

// parts[0 .. nparts) summed in a fixed order by one block (every thread
// gets the sum): thread t adds parts t, t + blockDim, ... in order.
template <typename A> __device__ A sum_parts(const A* __restrict__ parts, int nparts, A* smem) {
  A s = A(0);
  for (int j = threadIdx.x; j < nparts; j += blockDim.x) s += parts[j];
  return block_sum(s, smem);
}

// (a) parts[blockIdx] = sum of x[i] * y[i] over this block's elements.
template <typename T>
__global__ void __launch_bounds__(kBlock) dot_kernel(const T* __restrict__ x,
                                                     const T* __restrict__ y, int64_t n,
                                                     int vec, typename AccOf<T>::type* parts) {
  using A = typename AccOf<T>::type;
  using V = Vec<T>;
  __shared__ A smem[32];
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t nthr = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t nv = vec ? n / V::N : 0;
  A s = A(0);
  for (int64_t c = tid; c < nv; c += nthr) {
    const V a = reinterpret_cast<const V*>(x)[c];
    const V b = reinterpret_cast<const V*>(y)[c];
#pragma unroll
    for (int j = 0; j < V::N; ++j) s += to_acc(a.v[j]) * to_acc(b.v[j]);
  }
  for (int64_t i = nv * V::N + tid; i < n; i += nthr) s += to_acc(x[i]) * to_acc(y[i]);
  s = block_sum(s, smem);
  if (threadIdx.x == 0) parts[blockIdx.x] = s;
}

// (b) When st[1]: alpha = sc[1] / max(sum(pap), 1e-30); x += alpha p;
// r -= alpha Ap; rr_parts[blockIdx] = this block's sum of r_new^2 (of the
// stored values). Otherwise nothing is written.
template <typename T>
__global__ void __launch_bounds__(kBlock) update_kernel(
    T* __restrict__ x, T* __restrict__ r, const T* __restrict__ p, const T* __restrict__ ap,
    int64_t n, const typename AccOf<T>::type* __restrict__ pap, int nparts,
    const typename AccOf<T>::type* __restrict__ sc, const int64_t* __restrict__ st, int vec,
    typename AccOf<T>::type* rr_parts) {
  using A = typename AccOf<T>::type;
  using V = Vec<T>;
  __shared__ A smem[32];
  if (st[1] == 0) return;  // uniform across the grid: no barrier is split
  const A d = sum_parts(pap, nparts, smem);
  const A alpha = sc[1] / (d < A(1e-30) ? A(1e-30) : d);  // NaN stays NaN, as clamp
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t nthr = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t nv = vec ? n / V::N : 0;
  A s = A(0);
  for (int64_t c = tid; c < nv; c += nthr) {
    V xv = reinterpret_cast<const V*>(x)[c];
    V rv = reinterpret_cast<const V*>(r)[c];
    const V pv = reinterpret_cast<const V*>(p)[c];
    const V av = reinterpret_cast<const V*>(ap)[c];
#pragma unroll
    for (int j = 0; j < V::N; ++j) {
      xv.v[j] = from_acc<T, A>(to_acc(xv.v[j]) + alpha * to_acc(pv.v[j]));
      rv.v[j] = from_acc<T, A>(to_acc(rv.v[j]) - alpha * to_acc(av.v[j]));
      const A rj = to_acc(rv.v[j]);
      s += rj * rj;
    }
    reinterpret_cast<V*>(x)[c] = xv;
    reinterpret_cast<V*>(r)[c] = rv;
  }
  for (int64_t i = nv * V::N + tid; i < n; i += nthr) {
    x[i] = from_acc<T, A>(to_acc(x[i]) + alpha * to_acc(p[i]));
    const T ri = from_acc<T, A>(to_acc(r[i]) - alpha * to_acc(ap[i]));
    r[i] = ri;
    s += to_acc(ri) * to_acc(ri);
  }
  s = block_sum(s, smem);
  if (threadIdx.x == 0) rr_parts[blockIdx.x] = s;
}

// (c) When st[1]: beta = sum(rho_parts) / max(sc[1], 1e-30); p = z + beta p.
template <typename T>
__global__ void __launch_bounds__(kBlock) direction_kernel(
    T* __restrict__ p, const T* __restrict__ z, int64_t n,
    const typename AccOf<T>::type* __restrict__ rho_parts, int nparts,
    const typename AccOf<T>::type* __restrict__ sc, const int64_t* __restrict__ st, int vec) {
  using A = typename AccOf<T>::type;
  using V = Vec<T>;
  __shared__ A smem[32];
  if (st[1] == 0) return;
  const A rho_new = sum_parts(rho_parts, nparts, smem);
  const A rho = sc[1];
  const A beta = rho_new / (rho < A(1e-30) ? A(1e-30) : rho);
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t nthr = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t nv = vec ? n / V::N : 0;
  for (int64_t c = tid; c < nv; c += nthr) {
    V pv = reinterpret_cast<const V*>(p)[c];
    const V zv = reinterpret_cast<const V*>(z)[c];
#pragma unroll
    for (int j = 0; j < V::N; ++j)
      pv.v[j] = from_acc<T, A>(to_acc(zv.v[j]) + beta * to_acc(pv.v[j]));
    reinterpret_cast<V*>(p)[c] = pv;
  }
  for (int64_t i = nv * V::N + tid; i < n; i += nthr)
    p[i] = from_acc<T, A>(to_acc(z[i]) + beta * to_acc(p[i]));
}

// The iteration's scalars, one block. When st[1]: rr = sum(rr_parts), rho =
// sum(rz_parts) (rr when rz_parts is null: CG), sc[0] = rr, sc[1] = rho,
// k = st[0] + 1, hist[k] = sqrt(rr), st[0] = k and st[1] = k < maxiter and
// (fixed or rr > sc[2]). Runs after direction, which reads the old sc[1].
template <typename T>
__global__ void __launch_bounds__(kBlock) finish_kernel(
    const typename AccOf<T>::type* __restrict__ rr_parts,
    const typename AccOf<T>::type* __restrict__ rz_parts, int nparts,
    typename AccOf<T>::type* sc, int64_t* st, T* hist, int64_t maxiter, int fixed) {
  using A = typename AccOf<T>::type;
  __shared__ A smem[32];
  if (st[1] == 0) return;
  const A rr = sum_parts(rr_parts, nparts, smem);
  const A rho = rz_parts ? sum_parts(rz_parts, nparts, smem) : rr;
  if (threadIdx.x == 0) {
    const int64_t k = st[0] + 1;
    sc[0] = rr;
    sc[1] = rho;
    hist[k] = from_acc<T, A>(sqrt(rr));
    st[0] = k;
    st[1] = (k < maxiter && (fixed || rr > sc[2])) ? 1 : 0;
  }
}

// Runs `launch` on `device` and gives the caller's thread its device back;
// returns cudaGetLastError() of the launch.
template <typename F> int on_device(int device, F launch) {
  int prev = -1;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess) return static_cast<int>(err);
  launch();
  err = cudaGetLastError();
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}

template <typename T>
int dot(const void* x, const void* y, int64_t n, void* parts, int grid, int vec, int device,
        void* stream) {
  using A = typename AccOf<T>::type;
  return on_device(device, [&] {
    dot_kernel<T><<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), static_cast<const T*>(y), n, vec, static_cast<A*>(parts));
  });
}

template <typename T>
int update(void* x, void* r, const void* p, const void* ap, int64_t n, const void* pap,
           int nparts, const void* sc, const void* st, void* rr_parts, int vec, int device,
           void* stream) {
  using A = typename AccOf<T>::type;
  return on_device(device, [&] {
    update_kernel<T><<<nparts, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<T*>(x), static_cast<T*>(r), static_cast<const T*>(p),
        static_cast<const T*>(ap), n, static_cast<const A*>(pap), nparts,
        static_cast<const A*>(sc), static_cast<const int64_t*>(st), vec,
        static_cast<A*>(rr_parts));
  });
}

template <typename T>
int direction(void* p, const void* z, int64_t n, const void* rho_parts, int nparts,
              const void* sc, const void* st, int vec, int device, void* stream) {
  using A = typename AccOf<T>::type;
  return on_device(device, [&] {
    direction_kernel<T><<<nparts, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<T*>(p), static_cast<const T*>(z), n, static_cast<const A*>(rho_parts),
        nparts, static_cast<const A*>(sc), static_cast<const int64_t*>(st), vec);
  });
}

template <typename T>
int finish(const void* rr_parts, const void* rz_parts, int nparts, void* sc, void* st,
           void* hist, int64_t maxiter, int fixed, int device, void* stream) {
  using A = typename AccOf<T>::type;
  return on_device(device, [&] {
    finish_kernel<T><<<1, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const A*>(rr_parts), static_cast<const A*>(rz_parts), nparts,
        static_cast<A*>(sc), static_cast<int64_t*>(st), static_cast<T*>(hist), maxiter, fixed);
  });
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` without synchronising and returns
// cudaGetLastError() (0 on success). Vectors of T, sums and scalars in A
// (float for f32 and bf16, double for f64), `st` int64. The caller picks the
// grid of a dot (a function of n: repro_torch/kernels/solver_vec.py::grid)
// and passes it as `nparts` to the kernels that read those partials; update
// and direction run on that same grid, so their partials line up too.

#define SOLVER_VEC_ENTRIES(SUF, T)                                                            \
  int solver_vec_dot_##SUF(const void* x, const void* y, int64_t n, void* parts, int grid,    \
                           int vec, int device, void* stream) {                               \
    return dot<T>(x, y, n, parts, grid, vec, device, stream);                                 \
  }                                                                                           \
  int solver_vec_update_##SUF(void* x, void* r, const void* p, const void* ap, int64_t n,     \
                              const void* pap, int nparts, const void* sc, const void* st,    \
                              void* rr_parts, int vec, int device, void* stream) {            \
    return update<T>(x, r, p, ap, n, pap, nparts, sc, st, rr_parts, vec, device, stream);     \
  }                                                                                           \
  int solver_vec_direction_##SUF(void* p, const void* z, int64_t n, const void* rho_parts,    \
                                 int nparts, const void* sc, const void* st, int vec,         \
                                 int device, void* stream) {                                  \
    return direction<T>(p, z, n, rho_parts, nparts, sc, st, vec, device, stream);             \
  }                                                                                           \
  int solver_vec_finish_##SUF(const void* rr_parts, const void* rz_parts, int nparts,         \
                              void* sc, void* st, void* hist, int64_t maxiter, int fixed,     \
                              int device, void* stream) {                                     \
    return finish<T>(rr_parts, rz_parts, nparts, sc, st, hist, maxiter, fixed, device,        \
                     stream);                                                                 \
  }

SOLVER_VEC_ENTRIES(f32, float)
SOLVER_VEC_ENTRIES(bf16, __nv_bfloat16)
SOLVER_VEC_ENTRIES(f64, double)

const char* solver_vec_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
