// The 1D block cyclic-reduction apply: x = A^-1 rhs from a prepared CR
// factorization, f32 and f64, every level in one launch.
//
// Replaces no Pallas kernel.  Its counterpart is the reference's
// gmpnp_tpu/solve/linear.py::block_tridiag_apply_cr, jnp that XLA fuses
// on the TPU.  In the port that apply ran as some 300 launch-sized torch
// operations (slices, a cat, two or three batched matrix-vector products,
// subtractions and a clamp per level, 13 levels down and 13 up at N =
// 5,991); here one launch walks the whole apply (ops/cr_apply.py holds
// the plain version, the former eager code):
//
//   down, level l = 0 .. L-1 (D_0 = rhs, rows past N zero; h = M / 2^(l+1)):
//     D_{l+1}[j] = clamp((D_l[2j] - alpha[j] D_l[2j-1]) - gamma[j] D_l[2j+1])
//                  (D_l[-1] = 0)
//   top:  x_L[0] = Binv_top D_L[0]                       (no clamp)
//   up, level l = L-1 .. 0:
//     r[j]          = clamp((D_l[2j+1] - A_od[j] x_{l+1}[j]) - C_od[j] x_{l+1}[j+1])
//     x_l[2j]       = x_{l+1}[j],  x_{l+1}[h] = 0
//     x_l[2j+1]     = clamp(Binv_od[j] r[j])
//   x = x_0[:N]
//
// clamp is ops/block_inv.py::range_clamp (+-1e16 in the working type) and
// passes NaN through as torch.clamp does.  Each f-term product is one FMA
// chain in the order k = 0 .. f-1, with no atomics, so the kernel is
// bitwise repeatable and each lane of a lane-batched call computes exactly
// what its single-lane call computes.  (It is not bitwise the eager path,
// whose cuBLAS products sum in their own order.)
//
// Bound: bytes.  An apply reads the factor once: five (h, f, f) blocks a
// level, (M - 1) f^2 values of each of the five (16.05 MB at M = 8,192,
// f = 7, f64), and the vectors; ~4.8 us at 3.35 TB/s, less where the
// chord's factor stays in the 50 MB L2 between applies.  The arithmetic
// (~4 MFLOP) is far below the FMA rate.  What stands between a launch and
// that bound is the chain of 2L dependent levels.
//
// Design: one thread-block cluster per lane (gridDim = (cluster, lanes)).
// A row of a level is f lanes of a warp (32 / f rows a warp), lane i
// computing component i: it loads row i of each f x f block it needs (f
// contiguous values, read-only path) before the vector, and takes the
// vector's components from its group by warp shuffles.  The levels wider
// than one block's pass (ops/cr_apply.py::cr_plan: `tail` of them) run
// over the whole cluster, each block a contiguous share of the rows, a
// cluster barrier (release / acquire) after each; their vectors go through
// a workspace in device memory (it stays in L2), D_1 .. D_tail at row
// M - 2 M / 2^l per lane, read with ld.global.cg (from L2, never a stale
// L1 line).  The narrower levels, the top solve and their upward levels
// run in block 0 alone, their vectors in its shared memory (the same
// layout, under 2 passes' rows), __syncthreads between them, while the
// other blocks wait at the next cluster barrier.  The upward sweep writes
// x_l over D_l in place (a row's odd value is read only by the thread
// that overwrites it), and x_0 into out.  The factor stays where CRFactors
// holds it: each level's five tensors by pointer, lane stride and row
// stride (the odd bands are strided views), in a by-value parameter
// struct that each block copies into its shared memory once.
//
// Measured (PERF.md section 6): a level costs about 0.75 us down and 1.25
// us up in one block even at one row, a cluster level about twice that
// plus its passes, so the apply is latency-bound by its 2L levels, not by
// its bytes.  Two variants moved nothing or lost, so the simpler design
// stays: the cluster levels' vectors in distributed shared memory in
// place of the workspace (72.9 against 72.7 us at (5,991, 7) f64), and
// each warp's blocks copied into shared memory coalesced (cp.async) in
// place of each thread's f strided loads (79.3 against 67.9 us).
//
// The kernel launches on the caller's stream, does not synchronise and
// allocates nothing (the wrapper passes the workspace); the C entry points
// return cudaGetLastError(), or cudaErrorInvalidValue for arguments they
// do not take.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;        // ops/cr_apply.py::THREADS
constexpr int kWarps = kThreads / 32;
constexpr int kMaxF = 16;            // ops/cr_apply.py::MAX_F
constexpr int kMaxLevels = 24;       // ops/cr_apply.py::MAX_LEVELS
constexpr int kMaxCluster = 16;      // ops/cr_apply.py::MAX_CLUSTER
constexpr int kPerLevel = 5;         // alpha, gamma, A_od, C_od, Binv_od
// the one-block levels' vectors in block 0's shared memory: fewer than two
// passes' rows, 2 kWarps (32 / f) f <= 1,024 values
// (ops/cr_apply.py::TAIL_VALUES)
constexpr int kTailValues = 2 * kWarps * 32;
constexpr unsigned int kFull = 0xffffffffu;

// one factor tensor: blocks of f x f contiguous values, `lane` and `row`
// elements apart
struct Mat {
  const void* p;
  long long lane;
  long long row;
};

struct Params {
  Mat mats[kMaxLevels * kPerLevel + 1];   // level by level, then Binv_top
  long long ws_lane;    // workspace elements a lane: (M - 1) f
  int levels;           // L, M = 2^L
  int n;                // rows of rhs and out
  int f;
  int tail;             // levels 0 .. tail-1 run over the cluster
};

template <typename T>
__device__ __forceinline__ T range_clamp(T x) {
  const T lim = static_cast<T>(1.0e16);
  return x < -lim ? -lim : (x > lim ? lim : x);   // NaN passes through
}

// one thread's row of an f x f block: its f values in registers, loaded
// ahead of the vector they multiply (F > 0), or read as they are used
// (F = 0, f at run time)
template <typename T, int F>
struct Row {
  T v[F > 0 ? F : 1];
  const T* p;

  __device__ __forceinline__ void load(const T* a, bool active) {
    p = a;
    if constexpr (F > 0) {
#pragma unroll
      for (int k = 0; k < F; ++k) v[k] = active ? __ldg(a + k) : T(0);
    }
  }

  __device__ __forceinline__ T at(int k) const {
    if constexpr (F > 0) {
      return v[k];
    } else {
      return __ldg(p + k);
    }
  }
};

// sum over k of row[k] * v_k in the order k = 0 .. f-1, v_k the value of v
// held by lane base + k; every lane of the warp takes part in the shuffles
template <typename T, int F>
__device__ __forceinline__ T dot(const Row<T, F>& row, bool active, T v,
                                 int base, int f) {
  T s = T(0);
#pragma unroll
  for (int k = 0; k < (F > 0 ? F : kMaxF); ++k) {
    if (F == 0 && k >= f) break;
    const T vk = __shfl_sync(kFull, v, base + k);
    if (active) s = fma(row.at(k), vk, s);
  }
  return s;
}

// where this thread sits: row slot gi of its warp, component i
struct Slot {
  int per_warp;   // rows a warp takes at once: 32 / f
  int gi;
  int i;
  int base;       // lane of the row's component 0
  bool lane_ok;   // lanes past per_warp * f hold no row
};

__device__ __forceinline__ Slot slot_of(int f) {
  const int lane = threadIdx.x & 31;
  Slot s;
  s.per_warp = 32 / f;
  s.gi = lane / f;
  s.i = lane - s.gi * f;
  s.base = s.gi * f;
  s.lane_ok = s.gi < s.per_warp;
  return s;
}

// rows of D_1 .. D_{l-1} (l >= 1): D_1 at 0, then M/2, M/4, ..
__device__ __forceinline__ long long ws_row(int levels, int l) {
  const long long M = 1ll << levels;
  return M - 2 * (M >> l);
}

template <typename T>
__device__ __forceinline__ const T* mat(const Mat& m, int v) {
  return static_cast<const T*>(m.p) + v * m.lane;
}

// where D_l (and x_l over it) lives: level 0 in rhs (x_0 in out), the
// cluster's levels in the workspace, the tail's in block 0's shared memory
template <typename T>
struct Vec {
  T* p;
  int rows;       // rows past these read as 0 (rhs past n)
  bool shared;

  __device__ __forceinline__ T get(int row, int i, int f) const {
    if (row >= rows) return T(0);
    return shared ? p[row * f + i] : __ldcg(p + row * f + i);
  }

  __device__ __forceinline__ void put(int row, int i, int f, T x) const {
    if (row < rows) p[row * f + i] = x;
  }
};

template <typename T>
__device__ __forceinline__ Vec<T> vec(const Params& P, int l, int v,
                                      T* level0, T* ws, T* tail) {
  const int f = P.f;
  if (l == 0)
    return Vec<T>{level0 + static_cast<long long>(v) * P.n * f, P.n, false};
  const int rows = (1 << P.levels) >> l;
  if (l > P.tail)
    return Vec<T>{tail + (ws_row(P.levels, l) -
                          ws_row(P.levels, P.tail + 1)) * f,
                  rows, true};
  return Vec<T>{ws + v * P.ws_lane + ws_row(P.levels, l) * f, rows, false};
}

// level l downward: D_{l+1}[j] for this part's rows j, a contiguous share
template <typename T, int F>
__device__ void down_level(const Params& P, const Mat* mats, int l, int v,
                           int part, int parts, const T* rhs, T* ws,
                           T* tail) {
  const int f = F > 0 ? F : P.f;
  const Slot s = slot_of(f);
  const int h = (1 << P.levels) >> (l + 1);
  const Vec<T> d = vec<T>(P, l, v, const_cast<T*>(rhs), ws, tail);
  const Vec<T> out = vec<T>(P, l + 1, v, nullptr, ws, tail);
  const Mat& ma = mats[l * kPerLevel];
  const Mat& mg = mats[l * kPerLevel + 1];
  const T* alpha = mat<T>(ma, v);
  const T* gamma = mat<T>(mg, v);
  const int per = h / parts;
  const int last = (part + 1) * per;
  const int warp = threadIdx.x >> 5;
#pragma unroll 1
  for (int j0 = part * per + warp * s.per_warp; j0 < last;
       j0 += kWarps * s.per_warp) {
    const int j = j0 + s.gi;
    const bool act = s.lane_ok && j < last;
    Row<T, F> ra, rg;
    ra.load(alpha + static_cast<long long>(j) * ma.row + s.i * f, act);
    rg.load(gamma + static_cast<long long>(j) * mg.row + s.i * f, act);
    T d_ev = T(0), d_od = T(0), d_left = T(0);
    if (act) {
      d_ev = d.get(2 * j, s.i, f);
      d_od = d.get(2 * j + 1, s.i, f);
      if (j > 0) d_left = d.get(2 * j - 1, s.i, f);
    }
    const T a = dot<T, F>(ra, act, d_left, s.base, f);
    const T g = dot<T, F>(rg, act, d_od, s.base, f);
    if (act) out.put(j, s.i, f, range_clamp((d_ev - a) - g));
  }
}

template <typename T, int F>
__device__ void top_solve(const Params& P, const Mat* mats, int v,
                          const T* rhs, T* out, T* ws, T* tail) {
  if (threadIdx.x >= 32) return;
  const int f = F > 0 ? F : P.f;
  const int i = threadIdx.x;
  const bool act = i < f;
  const Vec<T> d = vec<T>(P, P.levels, v, const_cast<T*>(rhs), ws, tail);
  const Vec<T> x = vec<T>(P, P.levels, v, out, ws, tail);
  Row<T, F> rt;
  rt.load(mat<T>(mats[P.levels * kPerLevel], v) + i * f, act);
  const T di = act ? d.get(0, i, f) : T(0);
  const T xi = dot<T, F>(rt, act, di, 0, f);
  if (act) x.put(0, i, f, xi);
}

// level l upward: x_l[2j], x_l[2j+1] for this part's rows j, written over
// D_l (level 0: into out)
template <typename T, int F>
__device__ void up_level(const Params& P, const Mat* mats, int l, int v,
                         int part, int parts, const T* rhs, T* out, T* ws,
                         T* tail) {
  const int f = F > 0 ? F : P.f;
  const Slot s = slot_of(f);
  const int h = (1 << P.levels) >> (l + 1);
  const Vec<T> d = vec<T>(P, l, v, const_cast<T*>(rhs), ws, tail);
  const Vec<T> x = vec<T>(P, l, v, out, ws, tail);
  const Vec<T> xin = vec<T>(P, l + 1, v, nullptr, ws, tail);
  const Mat& mA = mats[l * kPerLevel + 2];
  const Mat& mC = mats[l * kPerLevel + 3];
  const Mat& mB = mats[l * kPerLevel + 4];
  const T* A_od = mat<T>(mA, v);
  const T* C_od = mat<T>(mC, v);
  const T* Binv = mat<T>(mB, v);
  const int per = h / parts;
  const int last = (part + 1) * per;
  const int warp = threadIdx.x >> 5;
#pragma unroll 1
  for (int j0 = part * per + warp * s.per_warp; j0 < last;
       j0 += kWarps * s.per_warp) {
    const int j = j0 + s.gi;
    const bool act = s.lane_ok && j < last;
    Row<T, F> rA, rC, rB;
    rA.load(A_od + static_cast<long long>(j) * mA.row + s.i * f, act);
    rC.load(C_od + static_cast<long long>(j) * mC.row + s.i * f, act);
    rB.load(Binv + static_cast<long long>(j) * mB.row + s.i * f, act);
    T d_od = T(0), xj = T(0), xr = T(0);
    if (act) {
      d_od = d.get(2 * j + 1, s.i, f);
      xj = xin.get(j, s.i, f);
      xr = xin.get(j + 1, s.i, f);   // x_{l+1}[h] reads 0
    }
    const T a = dot<T, F>(rA, act, xj, s.base, f);
    const T c = dot<T, F>(rC, act, xr, s.base, f);
    const T r = range_clamp((d_od - a) - c);
    const T xo = range_clamp(dot<T, F>(rB, act, r, s.base, f));
    if (act) {
      x.put(2 * j, s.i, f, xj);
      x.put(2 * j + 1, s.i, f, xo);
    }
  }
}

template <typename T, int F>
__global__ void __launch_bounds__(kThreads)
cr_apply_kernel(const __grid_constant__ Params P, const T* __restrict__ rhs,
                T* __restrict__ out, T* ws) {
  __shared__ T tail[kTailValues];
  __shared__ Mat mats[kMaxLevels * kPerLevel + 1];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int parts = static_cast<int>(cluster.num_blocks());
  const int v = blockIdx.y;
  // the factor's table from the parameters into shared memory, once
  for (int t = threadIdx.x; t <= P.levels * kPerLevel; t += kThreads)
    mats[t] = P.mats[t];
  __syncthreads();
  for (int l = 0; l < P.tail; ++l) {
    down_level<T, F>(P, mats, l, v, rank, parts, rhs, ws, tail);
    cluster.sync();
  }
  if (rank == 0) {
    for (int l = P.tail; l < P.levels; ++l) {
      down_level<T, F>(P, mats, l, v, 0, 1, rhs, ws, tail);
      __syncthreads();
    }
    top_solve<T, F>(P, mats, v, rhs, out, ws, tail);
    for (int l = P.levels - 1; l >= P.tail; --l) {
      __syncthreads();
      up_level<T, F>(P, mats, l, v, 0, 1, rhs, out, ws, tail);
    }
  }
  for (int l = P.tail - 1; l >= 0; --l) {
    cluster.sync();
    up_level<T, F>(P, mats, l, v, rank, parts, rhs, out, ws, tail);
  }
}

template <typename T, int F>
int launch(const Params& P, const void* rhs, void* out, void* ws, int lanes,
           int cluster, cudaStream_t stream) {
  auto kernel = cr_apply_kernel<T, F>;
  static bool opted_in = false;   // the opt-in, once a kernel
  if (cluster > 8 && !opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, lanes, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, P, static_cast<const T*>(rhs), static_cast<T*>(out),
      static_cast<T*>(ws));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int cr_apply(const void* const* ptrs, const long long* strides, int levels,
             const void* rhs, void* out, void* ws, int n, int f, int lanes,
             int cluster, int tail, void* stream) {
  if (levels < 0 || levels > kMaxLevels || n < 1 ||
      static_cast<long long>(n) > (1ll << levels) || f < 1 || f > kMaxF ||
      lanes < 1 || lanes > 65535 || cluster < 1 || cluster > kMaxCluster ||
      (cluster & (cluster - 1)) != 0 || tail < 0 || tail > levels ||
      (tail > 0 && ((1ll << levels) >> tail) < cluster) ||
      (((1ll << levels) >> tail) - 1) * f > kTailValues ||
      ptrs == nullptr || strides == nullptr || rhs == nullptr ||
      out == nullptr || (tail > 0 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long M = 1ll << levels;
  Params P = {};
  for (int t = 0; t <= levels * kPerLevel; ++t)
    P.mats[t] = Mat{ptrs[t], strides[2 * t], strides[2 * t + 1]};
  P.ws_lane = (M - 1) * f;
  P.levels = levels;
  P.n = n;
  P.f = f;
  P.tail = tail;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f == 7) return launch<T, 7>(P, rhs, out, ws, lanes, cluster, s);
  if (f == 5) return launch<T, 5>(P, rhs, out, ws, lanes, cluster, s);
  return launch<T, 0>(P, rhs, out, ws, lanes, cluster, s);
}

}  // namespace

// ptrs: the factor's 5 L + 1 device pointers, level by level alpha, gamma,
// A_od, C_od, Binv_od, then Binv_top; strides: each one's lane and row
// strides in elements (host memory); rhs, out: (lanes, n, f) contiguous;
// ws: lanes x (2^L - 1) x f scratch (may be null when tail is 0); cluster:
// blocks a lane, a power of two; tail: the levels that run over the
// cluster (ops/cr_apply.py::cr_plan)
extern "C" int cr_apply_f32(const void* const* ptrs, const long long* strides,
                            int levels, const void* rhs, void* out, void* ws,
                            int n, int f, int lanes, int cluster, int tail,
                            void* stream) {
  return cr_apply<float>(ptrs, strides, levels, rhs, out, ws, n, f, lanes,
                         cluster, tail, stream);
}

extern "C" int cr_apply_f64(const void* const* ptrs, const long long* strides,
                            int levels, const void* rhs, void* out, void* ws,
                            int n, int f, int lanes, int cluster, int tail,
                            void* stream) {
  return cr_apply<double>(ptrs, strides, levels, rhs, out, ws, n, f, lanes,
                          cluster, tail, stream);
}
