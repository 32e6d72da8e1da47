// Sorted-segment sum of FEM assembly: the reduction of element residuals
// and element Jacobian blocks onto vertices and (vertex, neighbour) slots.
//
// Replaces gmpnp_tpu/fem/assembly.py::_segment_reduce (jnp code that XLA
// fuses on the TPU: a sorted gather, a cumulative sum and a prefix
// difference).  The port's plain version (ops/segment_sum.py::
// segment_sum_reference) is that formulation as torch ops; on the card its
// dim-0 cumsum of an (M, d) tensor with small d runs one thread per column,
// each walking all M rows in turn (81 threads over 184,320 rows for the
// GMPNP pore's Jacobian), and took about half of the pore's device time.
// Here each destination row is summed where it is needed:
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
// 1.17 us, under the launch floor.  The additions (M*d) are far below the
// card's f64 rate.
//
// Design.  One warp per destination row, lanes across the d columns, so
// each gathered value row (d contiguous values) is one coalesced read; up
// to 128 columns a warp keeps ceil(d/32) sums in registers, wider rows
// take more warps along blockIdx.z.  The warp loads up to 32 of its row's
// `order` entries at once (one per lane) and hands them out by shuffle, so
// the value loads of a row do not wait on an index load each.  The sum
// runs over j left to right from 0.0: the order is fixed (no atomics), two
// launches give the same bits, and every sum is bitwise the sequential
// sum in sorted order (an addition is never contracted into an FMA).  The
// cumsum twin rounds otherwise: its error is about eps * |prefix|, which
// chip_smoke.py bounds.  blockIdx.y is the lane of a lane-batched call
// (the sweep lanes of FemSpace.residual_lanes / jacobian_lanes): every lane
// sums as a one-lane launch does.
//
// The kernel launches on the caller's stream, does not synchronise and
// allocates nothing; the C entry points return cudaGetLastError().  The
// tables are trusted as FemSpace builds them: 0 <= order[j] < M and
// 0 <= start[i] <= end[i] <= M.

#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunks = 4;                 // 32-column chunks per warp
constexpr int kWarpCols = 32 * kMaxChunks;    // columns per warp, at most
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

template <typename T>
int launch(const void* values, const void* order, const void* start,
           const void* end, void* out, long long n_dest, int d, int lanes,
           long long lane_values, long long lane_out, void* stream) {
  if (n_dest < 0 || d < 1 || lanes < 1 || lanes > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_dest == 0) return 0;
  const long long blocks = (n_dest + kWarps - 1) / kWarps;
  const int zblocks = (d + kWarpCols - 1) / kWarpCols;
  if (blocks > INT_MAX || zblocks > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = d >= kWarpCols ? kMaxChunks : (d + 31) / 32;
  const dim3 grid(static_cast<unsigned>(blocks), lanes, zblocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* v = static_cast<const T*>(values);
  const long long* o = static_cast<const long long*>(order);
  const long long* st = static_cast<const long long*>(start);
  const long long* en = static_cast<const long long*>(end);
  T* y = static_cast<T*>(out);
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

}  // namespace

// lanes >= 1 value tensors of one table: lane l reads values + l *
// lane_values and writes out + l * lane_out
extern "C" int segment_sum_f32(const void* values, const void* order,
                               const void* start, const void* end, void* out,
                               long long n_dest, int d, int lanes,
                               long long lane_values, long long lane_out,
                               void* stream) {
  return launch<float>(values, order, start, end, out, n_dest, d, lanes,
                       lane_values, lane_out, stream);
}

extern "C" int segment_sum_f64(const void* values, const void* order,
                               const void* start, const void* end, void* out,
                               long long n_dest, int d, int lanes,
                               long long lane_values, long long lane_out,
                               void* stream) {
  return launch<double>(values, order, start, end, out, n_dest, d, lanes,
                        lane_values, lane_out, stream);
}
