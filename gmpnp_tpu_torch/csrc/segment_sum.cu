// Sorted-segment sum of FEM assembly: the reduction of element residuals
// and element Jacobian blocks onto vertices and (vertex, neighbour) slots.
//
// Replaces gmpnp_tpu/fem/assembly.py::_segment_reduce (jnp code that XLA
// fuses on the TPU: a sorted gather, a cumulative sum and a prefix
// difference).  The port's plain version (ops/segment_sum.py::
// segment_sum_reference) is that formulation as torch ops; on the card its
// dim-0 cumsum of an (M, d) tensor with small d runs one thread per column,
// each walking all M rows in turn, and took about half of the pore's device
// time.  Here each destination row is summed where it is needed:
//
//     out[l, i, c] = sum_{j = start[i]}^{end[i]-1} values[l, order[j], c]
//
//     values (lanes, M, d), order (M,), start and end (n_dest,) int64,
//     out (lanes, n_dest, d); T = float|double
//
// Bound: bytes.  Every value is read once and added once, so the least
// time is (values + order + start + end + out) bytes over the H100's 3.35
// TB/s: at the GMPNP pore Jacobian (L=50 nm, R=5 nm: M=184,320 element
// block entries of d=81 onto n_dest=37,515 slots, f64) 145,823,880 B =
// 43.5 us; at its residual (46,080 x 9 onto 2,501 vertices) 3,906,488 B =
// 1.17 us, under the launch floor (~1.6 us).  The additions (M*d) are far
// below the card's f64 rate.
//
// Two paths, chosen by ops/segment_sum.py::segment_plan:
//
// Warp per row (d > 16: the Jacobians' 25, 49, 81).  One warp per
// destination row, lanes across the d columns, so each gathered value row
// is one coalesced read; up to 128 columns a warp keeps ceil(d/32) sums in
// registers, wider rows take more warps along blockIdx.z.  The warp loads
// up to 32 of its row's `order` entries at once and hands them out by
// shuffle.  At d=81 this reaches 0.62 of the bound (NVIDIA H100 80GB HBM3,
// 700 W: 70.4 us cold at the pore Jacobian).
//
// Packed rows (d <= 16: the residuals' 9, 7 and 5).  The warp-per-row path
// lost to index_add_ at the pore residuals (7.33 us cold against 6.75 at
// d=9, 6.90 against 6.08 at d=7, same card): 23 or 25 of 32 lanes idle,
// and a row of ~18 entries paid about five dependent memory round trips
// (start/end, order, then value loads four at a time) where the bytes take
// 1.2 us.  Here a warp packs floor(32/d) rows, lane (r, c) = (lane / d,
// lane % d), and each lane walks its row in chunks of DEPTH entries: it
// loads the chunk's `order` entries all at once (the same addresses for
// the d lanes of a row: one request), then every value of the chunk into a
// register buffer, and only then adds them in order.  A row of up to DEPTH
// entries takes three dependent round trips (start/end, order, values);
// longer rows take two more per chunk.  The loads go out in groups of
// kGroup, each issued only where the row reaches it, so a row of two
// entries (the 1D meshes) does not pay for DEPTH.  No lane waits on
// another (no shuffles), so the lanes of a short row leave early.  Cold,
// in turns against the warp-per-row path on the same card: 4.6 against
// 7.4 us at the pore residual, 4.2 against 7.1 at d=7, 2.5-2.7 against
// 2.8 at the EDL residual (11,980 x 7 onto 5,991).
//
// Both paths sum over j left to right from 0.0: the order is fixed (no
// atomics), two launches give the same bits, and every sum is bitwise the
// sequential sum in sorted order (an addition is never contracted into an
// FMA; the loads may be reordered, the additions are not).  The cumsum
// twin rounds otherwise: its error is about eps * |prefix|, which
// chip_smoke.py bounds.  blockIdx.y is the lane of a lane-batched call
// (the sweep lanes of FemSpace.residual_lanes / jacobian_lanes): every lane
// sums as a one-lane launch does.
//
// The kernels launch on the caller's stream, do not synchronise and
// allocate nothing; the C entry points return cudaGetLastError(), or
// cudaErrorInvalidValue for a plan they do not take.  The tables are
// trusted as FemSpace builds them: 0 <= order[j] < M < 2^31 (the packed
// path reads the low 32-bit word of each entry) and 0 <= start[i] <=
// end[i] <= M.

#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunks = 4;                 // 32-column chunks per warp
constexpr int kWarpCols = 32 * kMaxChunks;    // columns per warp, at most
constexpr int kMaxPackedWidth = 16;           // widest row the packed path takes
constexpr int kDepth = 32;                    // the packed path's buffer
constexpr int kGroup = 8;                     // its loads, issued by groups
constexpr unsigned kFull = 0xffffffffu;

template <typename T, int CHUNKS>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const T* __restrict__ values,
                   const long long* __restrict__ order,
                   const long long* __restrict__ start,
                   const long long* __restrict__ end, T* __restrict__ out,
                   long long n_dest, int d, long long lane_values,
                   long long lane_out) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= n_dest) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  const int col0 = blockIdx.z * kWarpCols + lane;
  const T* v = values + blockIdx.y * lane_values;
  T acc[CHUNKS];
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) acc[c] = T(0);
  const long long s = start[row], e = end[row];
  for (long long j0 = s; j0 < e; j0 += 32) {
    const int cnt = e - j0 < 32 ? static_cast<int>(e - j0) : 32;
    const long long mine = lane < cnt ? order[j0 + lane] : 0;
#pragma unroll 4
    for (int t = 0; t < cnt; ++t) {
      const T* src = v + __shfl_sync(kFull, mine, t) * d;
#pragma unroll
      for (int c = 0; c < CHUNKS; ++c) {
        const int col = col0 + 32 * c;
        if (col < d) acc[c] = acc[c] + __ldg(src + col);
      }
    }
  }
  T* dst = out + blockIdx.y * lane_out + row * d;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int col = col0 + 32 * c;
    if (col < d) dst[col] = acc[c];
  }
}

// floor(32 / d) rows per warp, lane (r, c); up to DEPTH entries of a row
// in flight at once, issued in groups of kGroup so that a short row issues
// only the groups it fills
template <typename T, int DEPTH>
__global__ void __launch_bounds__(kThreads)
segment_sum_packed_kernel(const T* __restrict__ values,
                          const long long* __restrict__ order,
                          const long long* __restrict__ start,
                          const long long* __restrict__ end,
                          T* __restrict__ out, long long n_dest, int d,
                          int rows, long long lane_values,
                          long long lane_out) {
  static_assert(DEPTH % kGroup == 0, "DEPTH is a number of groups");
  const int lane = threadIdx.x & 31;
  const int r = lane / d;
  const int c = lane - r * d;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const long long row = warp * rows + r;
  if (r >= rows || row >= n_dest) return;
  const T* v = values + blockIdx.y * lane_values + c;
  // the low words of the int64 entries (little-endian; order[j] < 2^31)
  const int* low = reinterpret_cast<const int*>(order);
  const long long s = start[row], e = end[row];
  T acc = T(0);
  for (long long j0 = s; j0 < e; j0 += DEPTH) {
    const int n = e - j0 < DEPTH ? static_cast<int>(e - j0) : DEPTH;
    int idx[DEPTH];
    T buf[DEPTH];
#pragma unroll
    for (int g = 0; g < DEPTH; g += kGroup) {
      if (g < n) {
#pragma unroll
        for (int t = g; t < g + kGroup; ++t)
          idx[t] = t < n ? __ldg(low + 2 * (j0 + t)) : 0;
      }
    }
#pragma unroll
    for (int g = 0; g < DEPTH; g += kGroup) {
      if (g < n) {
#pragma unroll
        for (int t = g; t < g + kGroup; ++t)
          buf[t] = t < n ? __ldg(v + static_cast<long long>(idx[t]) * d)
                         : T(0);
      }
    }
#pragma unroll
    for (int g = 0; g < DEPTH; g += kGroup) {
      if (g < n) {
#pragma unroll
        for (int t = g; t < g + kGroup; ++t)
          if (t < n) acc = acc + buf[t];
      }
    }
  }
  out[blockIdx.y * lane_out + row * d + c] = acc;
}

template <typename T>
int launch_rows(const T* v, const long long* o, const long long* st,
                const long long* en, T* y, long long n_dest, int d,
                int lanes, long long lane_values, long long lane_out,
                cudaStream_t s) {
  const long long blocks = (n_dest + kWarps - 1) / kWarps;
  const int zblocks = (d + kWarpCols - 1) / kWarpCols;
  if (blocks > INT_MAX || zblocks > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = d >= kWarpCols ? kMaxChunks : (d + 31) / 32;
  const dim3 grid(static_cast<unsigned>(blocks), lanes, zblocks);
  switch (chunks) {
    case 1:
      segment_sum_kernel<T, 1><<<grid, kThreads, 0, s>>>(
          v, o, st, en, y, n_dest, d, lane_values, lane_out);
      break;
    case 2:
      segment_sum_kernel<T, 2><<<grid, kThreads, 0, s>>>(
          v, o, st, en, y, n_dest, d, lane_values, lane_out);
      break;
    case 3:
      segment_sum_kernel<T, 3><<<grid, kThreads, 0, s>>>(
          v, o, st, en, y, n_dest, d, lane_values, lane_out);
      break;
    default:
      segment_sum_kernel<T, 4><<<grid, kThreads, 0, s>>>(
          v, o, st, en, y, n_dest, d, lane_values, lane_out);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_packed(const T* v, const long long* o, const long long* st,
                  const long long* en, T* y, long long n_dest, int d,
                  int rows, int lanes, long long lane_values,
                  long long lane_out, cudaStream_t s) {
  const long long warps = (n_dest + rows - 1) / rows;
  const long long blocks = (warps + kWarps - 1) / kWarps;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks), lanes);
  segment_sum_packed_kernel<T, kDepth><<<grid, kThreads, 0, s>>>(
      v, o, st, en, y, n_dest, d, rows, lane_values, lane_out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* values, const void* order, const void* start,
           const void* end, void* out, long long n_dest, int d, int lanes,
           long long lane_values, long long lane_out, int rows_per_warp,
           int depth, void* stream) {
  if (n_dest < 0 || d < 1 || lanes < 1 || lanes > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  // the plans of segment_plan: a warp per row, or floor(32/d) packed rows
  // with a buffer of kDepth entries
  const bool packed = depth == kDepth && d <= kMaxPackedWidth &&
                      rows_per_warp == 32 / d;
  if (!packed && !(depth == 0 && rows_per_warp == 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_dest == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* v = static_cast<const T*>(values);
  const long long* o = static_cast<const long long*>(order);
  const long long* st = static_cast<const long long*>(start);
  const long long* en = static_cast<const long long*>(end);
  T* y = static_cast<T*>(out);
  if (packed)
    return launch_packed<T>(v, o, st, en, y, n_dest, d, rows_per_warp, lanes,
                            lane_values, lane_out, s);
  return launch_rows<T>(v, o, st, en, y, n_dest, d, lanes, lane_values,
                        lane_out, s);
}

}  // namespace

// lanes >= 1 value tensors of one table: lane l reads values + l *
// lane_values and writes out + l * lane_out; (rows_per_warp, depth) from
// ops/segment_sum.py::segment_plan
extern "C" int segment_sum_f32(const void* values, const void* order,
                               const void* start, const void* end, void* out,
                               long long n_dest, int d, int lanes,
                               long long lane_values, long long lane_out,
                               int rows_per_warp, int depth, void* stream) {
  return launch<float>(values, order, start, end, out, n_dest, d, lanes,
                       lane_values, lane_out, rows_per_warp, depth, stream);
}

extern "C" int segment_sum_f64(const void* values, const void* order,
                               const void* start, const void* end, void* out,
                               long long n_dest, int d, int lanes,
                               long long lane_values, long long lane_out,
                               int rows_per_warp, int depth, void* stream) {
  return launch<double>(values, order, start, end, out, n_dest, d, lanes,
                        lane_values, lane_out, rows_per_warp, depth, stream);
}
