// Block-ELL sparse matrix-vector product with the neighbour gather fused in.
//
// Replaces gmpnp_tpu/ops/ell_spmv.py::ell_block_contract_pallas (the Pallas
// TPU kernel, body _acc_kernel).  That kernel took the gathered operand
// xg = x[adj] (N, K, f) and relaid blocks (N, K, f, f), both built by XLA
// outside it.  Here the matrix is read in BlockELL's native layout and the
// gather happens in the kernel, so neither temporary exists:
//
//     y[n, r] = sum_k sum_c flat[n, r, k*f + c] * x[adj[n, k], c]
//
//     flat (N, f, K*f), adj (N, K) int32, x (N, f), y (N, f); T = float|double
//
// Bound: bytes.  Every matrix entry is read once and used once (2 flops per
// 4 or 8 bytes), so the least time is (flat + adj + x + y) bytes over the
// H100's 3.35 TB/s: at the 3D pore main path (N=2,501, K=15, f=9) 12,484,992
// B = 3.73 us in f32 and 24,819,924 B = 7.41 us in f64.  The matrix (12 / 24
// MB) is a fraction of what the card must have in flight to reach that rate,
// and a launch costs a few us whatever it does, so the design's job is to
// put every byte of the matrix in flight at once, on all 132 SMs, with as
// little work per byte as possible.  Measured times: PERF.md section 6.
//
// Design.  A vertex's block row is one contiguous run of f*K*f values.  One
// block of 128 threads owns a tile of `tile` consecutive vertices, chosen by
// the wrapper (ops/ell_spmv.py::launch_plan) so that tile*f*K*f*sizeof(T)
// is a multiple of 16 bytes (at f=9, K=15 a row is 4,860 B in f32 and 9,720
// B in f64, multiples of 4 and 8 only: tiles of 4 vertices in both types).
// Then every tile starts on a 16-byte boundary and
//   1. thread 0 issues ONE 1D bulk copy (cp.async.bulk, completion counted
//      on an mbarrier) of the whole tile into shared memory: coalesced by
//      construction, no registers or address arithmetic spent on it, and
//      with the main path's 626 tiles of 19 KB (f32) or 39 KB (f64) all
//      resident in one wave the whole matrix is requested at once;
//   2. while it flies, the block gathers x[adj[n, :]] once per vertex into
//      shared memory (K*f values; x is 90-180 KB and sits in L1/L2);
//   3. the sums, in one of three modes (the wrapper picks one per f and K):
//      - kVertexWarp, f in {5, 7, 9} known at compile time: one warp per
//        vertex keeps the f row sums in registers, lanes stride the K*f
//        columns (bank-conflict free) and the f loads of an iteration are
//        independent.  At f=9 a butterfly of shuffles finishes each row;
//        at f=5 and f=7 (K*f >= 33: the 3D reaction-diffusion pore's 105)
//        a folding reduction does: lanes 16, 8 and 4 apart swap half of
//        their (up to 8) sums and add the half they keep, then a butterfly
//        over 2 and 1 finishes one row per group of 4 lanes: 9 dependent
//        shuffles for all rows, not f butterflies of 5;
//      - kRowThread, f in {5, 7} with K*f <= 32 (the 1D meshes' K=3: 21
//        and 15 values): one thread per output row sums its K*f products
//        in one FMA chain, no shuffle; a tile holds as many vertices as
//        128 threads have rows.  The row stride K*f is odd, so the
//        threads of a warp read distinct banks (f32) or bank pairs (f64);
//      - kRowWarp, any other f (at run time): one warp per output row,
//        the same lane stride, one butterfly per row.
// The ragged last tile (N % tile vertices, a size that need not be a
// multiple of 16 bytes) bulk-copies its 16-byte chunks and moves the
// remainder with element-sized cp.async; a matrix whose base pointer is
// not 16-byte aligned (a view with a storage offset) or a tile size the
// wrapper could not align goes through element-sized cp.async entirely.
// Tried on the card against this at f=9: per-thread 16-byte cp.async over
// the same tiles (a little slower in both types), 256 threads or larger
// tiles (fewer blocks in flight: slower), and f64 tiles of 2 vertices
// (slower than 4: two of the four warps have no vertex).
//
// The order of summation is fixed (register loops, then shuffles in a set
// pattern): no atomics, two launches give the same bits.  Products and
// sums stay in the working type (FMA).  No tensor cores: a 9-wide block
// times one vector has no reuse to feed wgmma, TF32 would break the f32
// parity bands, and the kernel is bound by bytes, not operations.
//
// Lanes.  One launch may multiply V matrices of one sparsity (the lanes of
// a batched sweep: flat (V, N, f, K*f), x and y (V, N, f), adj shared), as
// the reference's vmap of the Pallas kernel adds a batch axis to its grid:
// blockIdx.y picks the lane, whose matrix starts lane_stride values after
// the previous one's.  Tiles start at vertex 0 in every lane, so a lane's
// sums are those of a one-lane launch, bit for bit.  A lane whose matrix
// does not start on a 16-byte boundary (N*f*K*f values that are no
// multiple of 16 bytes, with no padding between lanes) takes the
// element-sized copies; the wrapper pads the lane stride where it builds
// lane matrices (ops/ell_spmv.py::lane_aligned), so none does on the paths.
//
// Padded ELL slots alias the row's own vertex with zero blocks and need no
// special case.  The kernel launches on the caller's stream, does not
// synchronise and allocates nothing; the C entry points return
// cudaGetLastError() (or the error of cudaFuncSetAttribute where a tile
// needs more than 48 KB of shared memory), and cudaErrorInvalidValue for a
// mode that has no kernel at that f.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// the modes of ops/ell_spmv.py::launch_plan
enum Mode { kRowWarp = 0, kVertexWarp = 1, kRowThread = 2 };

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// element-sized asynchronous copy, for tails and misaligned matrices
template <typename T>
__device__ __forceinline__ void cp_async_elem(T* dst, const T* src) {
  if constexpr (sizeof(T) == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                 :: "r"(smem_u32(dst)), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(smem_u32(dst)), "l"(src) : "memory");
  }
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// One folding step of warp_sum_rows: lanes 4*HALF apart swap HALF of their
// 2*HALF sums; each keeps the half its lane bit selects and adds the
// partner's copy of it.
template <int HALF, typename T>
__device__ __forceinline__ void fold(T (&v)[8], int lane) {
  const bool upper = lane & (4 * HALF);
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const T send = upper ? v[i] : v[i + HALF];
    const T keep = upper ? v[i + HALF] : v[i];
    v[i] = keep + __shfl_xor_sync(kFull, send, 4 * HALF);
  }
}

// The warp's sums of F <= 8 rows, each held as 32 per-lane partial sums:
// lane l returns the whole sum of row l / 4 (rows >= F are zero).
template <int F, typename T>
__device__ __forceinline__ T warp_sum_rows(const T (&acc)[F], int lane) {
  static_assert(F <= 8, "warp_sum_rows folds at most 8 rows");
  T v[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) v[r] = r < F ? acc[r] : T(0);
  fold<4>(v, lane);
  fold<2>(v, lane);
  fold<1>(v, lane);
  v[0] += __shfl_xor_sync(kFull, v[0], 2);
  v[0] += __shfl_xor_sync(kFull, v[0], 1);
  return v[0];
}

// F > 0: f known at compile time; F == 0: f at run time (kRowWarp only).
// aligned != 0: a tile is a whole number of 16-byte units, so every tile
// starts on a 16-byte boundary where its lane's matrix does.
template <typename T, int F, int MODE>
__global__ void __launch_bounds__(kThreads)
ell_spmv_kernel(const T* __restrict__ flat, const int* __restrict__ adj,
                const T* __restrict__ x, T* __restrict__ y,
                int N, int K, int f_rt, int tile, int aligned,
                long long lane_stride) {
  static_assert(MODE == kRowWarp || F > 0, "vertex modes need f fixed");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) unsigned long long bar;
  constexpr int kPer16 = 16 / static_cast<int>(sizeof(T));
  const int f = F ? F : f_rt;
  const int Kf = K * f;
  const int row_len = f * Kf;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n0 = blockIdx.x * tile;
  const int nv = min(tile, N - n0);
  // the sweep lane (blockIdx.y): its matrix starts lane_stride values after
  // the previous lane's, its x and y N*f values after; adj is shared
  const long long lane_nf = static_cast<long long>(blockIdx.y) * N * f;
  flat += static_cast<long long>(blockIdx.y) * lane_stride;
  x += lane_nf;
  y += lane_nf;
  aligned = aligned && reinterpret_cast<uintptr_t>(flat) % 16 == 0;

  T* a_s = reinterpret_cast<T*>(smem);
  T* xg_s = a_s + (tile * row_len + kPer16 - 1) / kPer16 * kPer16;

  const T* src = flat + static_cast<size_t>(n0) * row_len;
  const int total = nv * row_len;
  const int bulk = aligned ? total / kPer16 * kPer16 : 0;  // values
  const uint32_t bar_a = smem_u32(&bar);

  if (bulk > 0) {
    if (tid == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                   :: "r"(bar_a), "r"(1) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      const uint32_t bytes = static_cast<uint32_t>(bulk) * sizeof(T);
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                   :: "r"(bar_a), "r"(bytes) : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n"
          :: "r"(smem_u32(a_s)), "l"(src), "r"(bytes), "r"(bar_a)
          : "memory");
    }
  }
  for (int i = bulk + tid; i < total; i += kThreads)
    cp_async_elem(a_s + i, src + i);
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  // gather x[adj[n, :]] once per vertex while the matrix is in flight:
  // value i of the tile is x[adj[n0 + i / Kf, (i % Kf) / f], i % f], and
  // (n0 + i / Kf) * K + (i % Kf) / f = n0 * K + i / f.  At f=5 and f=7 a
  // tile's copy is short, so a thread issues the loads of kBatch values
  // before it waits on any (adj, then x, then the stores).
  constexpr int kBatch = (F == 5 || F == 7) ? 4 : 1;
  const int* adj_t = adj + static_cast<size_t>(n0) * K;
  const int ng = nv * Kf;
  for (int i0 = tid; i0 < ng; i0 += kThreads * kBatch) {
    int at[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int i = i0 + b * kThreads;
      const int q = i / f;
      at[b] = i < ng ? adj_t[q] * f + (i - q * f) : -1;
    }
    T xv[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) xv[b] = at[b] >= 0 ? x[at[b]] : T(0);
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
      if (at[b] >= 0) xg_s[i0 + b * kThreads] = xv[b];
  }

  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();  // gathered x, copied tails and the barrier's init
  if (bulk > 0) {
    uint32_t done = 0;
    while (!done) {
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done) : "r"(bar_a), "r"(0) : "memory");
    }
  }

  if constexpr (MODE == kVertexWarp) {
    for (int v = warp; v < nv; v += kWarps) {
      const T* a = a_s + v * row_len;
      const T* xs = xg_s + v * Kf;
      T acc[F];
#pragma unroll
      for (int r = 0; r < F; ++r) acc[r] = T(0);
      for (int j = lane; j < Kf; j += 32) {
        const T xv = xs[j];
#pragma unroll
        for (int r = 0; r < F; ++r) acc[r] = fma(a[r * Kf + j], xv, acc[r]);
      }
      T* yv = y + static_cast<size_t>(n0 + v) * F;
      if constexpr (F == 9) {
#pragma unroll
        for (int r = 0; r < F; ++r) acc[r] = warp_sum(acc[r]);
        T out = acc[0];
#pragma unroll
        for (int r = 1; r < F; ++r)
          if (lane == r) out = acc[r];
        if (lane < F) yv[lane] = out;
      } else {
        const T out = warp_sum_rows<F>(acc, lane);
        if ((lane & 3) == 0 && (lane >> 2) < F) yv[lane >> 2] = out;
      }
    }
  } else if constexpr (MODE == kRowThread) {
    for (int row = tid; row < nv * F; row += kThreads) {
      const T* a = a_s + row * Kf;
      const T* xs = xg_s + row / F * Kf;
      T acc = T(0);
      for (int j = 0; j < Kf; ++j) acc = fma(a[j], xs[j], acc);
      y[static_cast<size_t>(n0) * F + row] = acc;
    }
  } else {
    const int rows = nv * f;
    for (int row = warp; row < rows; row += kWarps) {
      const T* a = a_s + row * Kf;
      const T* xs = xg_s + (row / f) * Kf;
      T acc = T(0);
      for (int j = lane; j < Kf; j += 32) acc = fma(a[j], xs[j], acc);
      acc = warp_sum(acc);
      if (lane == 0) y[static_cast<size_t>(n0) * f + row] = acc;
    }
  }
}

template <typename T, int F, int MODE>
int launch_f(const void* flat, const void* adj, const void* x, void* y,
             int N, int K, int f, int tile, int lanes, long long lane_stride,
             void* stream) {
  constexpr long long kPer16 = 16 / sizeof(T);
  const long long row_len = static_cast<long long>(f) * K * f;
  const long long a_vals = (tile * row_len + kPer16 - 1) / kPer16 * kPer16;
  const long long smem = (a_vals + static_cast<long long>(tile) * K * f)
                         * static_cast<long long>(sizeof(T));
  // whole tiles of 16-byte units; each lane checks its own base pointer
  const int aligned = (tile * row_len * sizeof(T)) % 16 == 0;
  auto kernel = ell_spmv_kernel<T, F, MODE>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 blocks(static_cast<unsigned int>((N + tile - 1) / tile),
                    static_cast<unsigned int>(lanes));
  kernel<<<blocks, kThreads, static_cast<size_t>(smem),
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(flat), static_cast<const int*>(adj),
      static_cast<const T*>(x), static_cast<T*>(y), N, K, f, tile, aligned,
      lane_stride);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* flat, const void* adj, const void* x, void* y,
           int N, int K, int f, int tile, int mode, int lanes,
           long long lane_stride, void* stream) {
  if (tile < 1 || lanes < 1 || lanes > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (mode) {
    case kVertexWarp:
      if (f == 9)
        return launch_f<T, 9, kVertexWarp>(flat, adj, x, y, N, K, f, tile,
                                           lanes, lane_stride, stream);
      if (f == 7)
        return launch_f<T, 7, kVertexWarp>(flat, adj, x, y, N, K, f, tile,
                                           lanes, lane_stride, stream);
      if (f == 5)
        return launch_f<T, 5, kVertexWarp>(flat, adj, x, y, N, K, f, tile,
                                           lanes, lane_stride, stream);
      break;
    case kRowThread:
      if (f == 7)
        return launch_f<T, 7, kRowThread>(flat, adj, x, y, N, K, f, tile,
                                          lanes, lane_stride, stream);
      if (f == 5)
        return launch_f<T, 5, kRowThread>(flat, adj, x, y, N, K, f, tile,
                                          lanes, lane_stride, stream);
      break;
    case kRowWarp:
      return launch_f<T, 0, kRowWarp>(flat, adj, x, y, N, K, f, tile, lanes,
                                      lane_stride, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// lanes >= 1 matrices of one sparsity: lane l reads flat + l * lane_stride,
// x + l*N*f and writes y + l*N*f (one lane: lane_stride is not read)
extern "C" int ell_spmv_f32(const void* flat, const void* adj, const void* x,
                            void* y, int N, int K, int f, int tile, int mode,
                            int lanes, long long lane_stride, void* stream) {
  return launch<float>(flat, adj, x, y, N, K, f, tile, mode, lanes,
                       lane_stride, stream);
}

extern "C" int ell_spmv_f64(const void* flat, const void* adj, const void* x,
                            void* y, int N, int K, int f, int tile, int mode,
                            int lanes, long long lane_stride, void* stream) {
  return launch<double>(flat, adj, x, y, N, K, f, tile, mode, lanes,
                        lane_stride, stream);
}
