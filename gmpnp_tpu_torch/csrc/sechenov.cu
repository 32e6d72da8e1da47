// The 3D pore's Sechenov CO2 Dirichlet value from four exact medians, f64.
//
// Replaces no Pallas kernel.  Its counterpart is the reference's per-step
// update (gmpnp_tpu/models/pore_3d.py, _theta_of_carry: jnp.median of four
// fields, then chem/henry.py::co2_saturation_conc), which XLA fuses on the
// TPU.  In the port that update ran as four torch.sort calls of N strided
// values (a one-block radix sort each, ~37 us at N=2,501) and some 40
// launch-sized scalar operations.  Here one launch of one cluster of four
// blocks computes, from u (N, f) row-major:
//
//   med_r = (s_r[(N-1)/2] + s_r[N/2]) * 0.5     s_r: u[:, col[r]] sorted
//   c_r   = med_r * bc0[r]
//   cat   = c_3 (GMPNP), or ((c_1 + 2 c_2) + c_0) - c_3 (rxn-diff: the
//           cation by electroneutrality, c_3 the protons)
//   s     = sum over OH, HCO3, CO32, cat of h * (c / 1000), in that order
//   out   = A * 10^(-s) / bc0_CO2                A = fugacity K_H 1000
//
// every operation rounded as the plain path rounds it on the card
// (ops/sechenov.py::sechenov_co2_reference): explicit _rn intrinsics, so
// nothing is contracted into an FMA, and a division by a host scalar as a
// multiplication by its reciprocal, which is how torch divides a CUDA
// tensor by a Python float.  The two give the same bits.
//
// Order: torch.sort's ascending order for N > 32, which is cub's radix
// order: keys are the doubles' bits made order-preserving, -0.0 takes
// +0.0's key (the two are equal and keep their input order), and NaNs sort
// by their bits, one with the sign bit before -inf, one without after
// +inf.  For N <= 32 torch.sort runs a bitonic network that puts every NaN
// last and keeps no order among equal keys: the medians differ from it only
// where a negative NaN, or zeros of both signs, hold a middle rank.
//
// Selection: radix select, most significant digit first, 8 bits a pass,
// from the first byte in which the column's keys differ (the block's AND
// and OR of its keys, taken while staging them; an all-equal column takes
// no pass).  Each pass builds a 256-bin shared histogram of the keys that
// share the prefix found so far (shared atomics aggregated per warp with
// __match_any_sync), clearing the next pass's histogram meanwhile; one warp
// scans it for the digit that holds the rank.
// Once 32 keys or fewer share the prefix, one warp gathers and ranks them.
// The rank N/2 key of an even N is the rank (N-1)/2 key again when enough
// keys equal it, else the least key above it (one block min-reduction).  A
// median at the zero key takes the zero of its rank in input order (one
// more pass), so that its sign is torch.sort's.
//
// Keys: staged in shared memory up to kMaxStaged values (196,608 B); past
// that each pass reads the column from device memory again, so no N is
// refused below 2^31.
//
// Bound: latency.  At the GMPNP pore (N=2,501, f=9) the four columns are
// 80 KB of the 180 KB of u, 0.03 us at 3.35 TB/s; the time is the chain of
// passes, each a few block barriers long, and the launch.  So the design
// takes the four medians at once on four SMs and leaves the passes short:
// a bucket of the pore's concentrations falls under 32 keys after about
// three passes.
//
// Combine: after cluster.sync() block 0 reads the other three medians from
// their shared memory (distributed shared memory); one thread evaluates the
// value and writes it, and a second cluster.sync() keeps the other blocks'
// shared memory alive until then.  No global atomics and no counters.
//
// The kernel launches on the caller's stream, does not synchronise and
// allocates nothing; the C entry point returns cudaGetLastError(), or
// cudaErrorInvalidValue for shapes and constants it does not take.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <climits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kColumns = 4;               // medians: one block each
constexpr int kBins = 256;                // 8-bit digits
constexpr int kSmall = 32;                // one warp ranks a bucket this small
constexpr long long kMaxStaged = 24576;   // keys in shared memory: 192 KB
constexpr int kConsts = 3 * kColumns + 3; // ops/sechenov.py::N_CONSTS
constexpr unsigned int kFull = 0xffffffffu;
constexpr unsigned long long kSign = 0x8000000000000000ull;

struct Consts {
  int col[kColumns];     // OH, HCO3, CO32, then the cation (GMPNP) or H
  double bc0[kColumns];  // their bulk concentrations
  double h[kColumns];    // h_ion + h_CO2 of OH, HCO3, CO32 and the cation
  int gmpnp;
  double A;              // fugacity_CO2 * K_H * 1000
  double bc0_co2;
};

// order-preserving key of a double (cub's radix order, -0.0 as +0.0)
__device__ __forceinline__ unsigned long long to_key(double v) {
  unsigned long long b =
      static_cast<unsigned long long>(__double_as_longlong(v));
  if (b == kSign) b = 0;
  return (b & kSign) ? ~b : (b | kSign);
}

__device__ __forceinline__ double from_key(unsigned long long k) {
  const unsigned long long b = (k & kSign) ? (k ^ kSign) : ~k;
  return __longlong_as_double(static_cast<long long>(b));
}

// one column of u: its keys from shared memory when staged, else from u;
// the leading bytes that every key shares (mask, prefix) and the shift of
// the first digit after them (-8: every key is equal)
struct Column {
  const double* p;
  long long n;
  int f;
  const unsigned long long* staged;
  unsigned long long mask;
  unsigned long long prefix;
  int shift;

  __device__ __forceinline__ unsigned long long key(long long i) const {
    return staged ? staged[i] : to_key(p[i * f]);
  }
};

struct Shared {
  unsigned int hist[2][kBins];  // one pass builds one while clearing the other
  unsigned long long small[kSmall];
  unsigned long long part[kWarps];
  unsigned long long part_or[kWarps];
  unsigned int warp_count[kWarps];
  unsigned int small_n;
  int found;
  // the selection: its key (during the passes, the digit), the keys under
  // it and the keys equal to it (during the passes, the bucket's)
  unsigned long long key;
  long long below;
  long long count;
  double value;
};

// The key of rank k (from 0) of the column, with the number of keys below
// it and equal to it: S.key, S.below, S.count on return, seen by every
// thread.  S.hist[0] is zero on entry.
__device__ void select_rank(const Column& col, long long k, Shared& S) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  unsigned long long prefix = col.prefix, mask = col.mask;
  long long below = 0, count = col.n;
  int pass = 0;
  for (int shift = col.shift; shift >= 0 && count > kSmall;
       shift -= 8, ++pass) {
    unsigned int* hist = S.hist[pass & 1];
    unsigned int* next = S.hist[(pass + 1) & 1];
    for (int b = tid; b < kBins; b += kThreads) next[b] = 0;
    for (long long base = 0; base < col.n; base += kThreads) {
      const long long i = base + tid;
      unsigned long long x = 0;
      bool in = false;
      if (i < col.n) {
        x = col.key(i);
        in = (x & mask) == prefix;
      }
      const unsigned int voters = __ballot_sync(kFull, in);
      if (in) {
        const unsigned int d = static_cast<unsigned int>(x >> shift) & 0xffu;
        const unsigned int peers = __match_any_sync(voters, d);
        if (lane == __ffs(peers) - 1) atomicAdd(&hist[d], __popc(peers));
      }
    }
    __syncthreads();
    if (warp == 0) {
      // lane l scans bins 8l .. 8l + 7
      unsigned int c[kBins / 32];
      unsigned int sum = 0;
#pragma unroll
      for (int j = 0; j < kBins / 32; ++j) {
        c[j] = hist[lane * (kBins / 32) + j];
        sum += c[j];
      }
      unsigned int incl = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned int t = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += t;
      }
      const long long t = k - below;
      long long acc = incl - sum;
      bool done = !(acc <= t && t < acc + sum);
#pragma unroll
      for (int j = 0; j < kBins / 32; ++j) {
        if (!done && t < acc + c[j]) {
          S.key = static_cast<unsigned long long>(lane * (kBins / 32) + j);
          S.below = below + acc;
          S.count = c[j];
          done = true;
        }
        acc += c[j];
      }
    }
    __syncthreads();
    prefix |= S.key << shift;
    mask |= 0xffull << shift;
    below = S.below;
    count = S.count;
  }
  __syncthreads();
  if (mask == ~0ull) {
    // every digit fixed: the bucket is the key's run of equal keys
    if (tid == 0) {
      S.key = prefix;
      S.below = below;
      S.count = count;
    }
  } else {
    // count <= kSmall keys share the prefix: one warp ranks them
    if (tid == 0) S.small_n = 0;
    __syncthreads();
    for (long long i = tid; i < col.n; i += kThreads) {
      const unsigned long long x = col.key(i);
      if ((x & mask) == prefix) S.small[atomicAdd(&S.small_n, 1u)] = x;
    }
    __syncthreads();
    if (warp == 0) {
      const int m = static_cast<int>(count);
      const unsigned long long mine = lane < m ? S.small[lane] : 0;
      int less = 0, eq = 0;
      for (int j = 0; j < m; ++j) {
        const unsigned long long o = __shfl_sync(kFull, mine, j);
        less += o < mine;
        eq += o == mine;
      }
      const long long t = k - below;
      const bool hit = lane < m && less <= t && t < less + eq;
      const unsigned int hits = __ballot_sync(kFull, hit);
      if (lane == __ffs(hits) - 1) {
        S.key = mine;
        S.below = below + less;
        S.count = eq;
      }
    }
  }
  __syncthreads();
}

// The least key of the column above `key` (one exists: the caller asks
// only when a rank lies above key's run).
__device__ unsigned long long min_above(const Column& col,
                                        unsigned long long key, Shared& S) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  unsigned long long m = ~0ull;
  for (long long i = tid; i < col.n; i += kThreads) {
    const unsigned long long x = col.key(i);
    if (x > key && x < m) m = x;
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    const unsigned long long t = __shfl_xor_sync(kFull, m, o);
    m = t < m ? t : m;
  }
  if (lane == 0) S.part[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < kWarps ? S.part[lane] : ~0ull;
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      const unsigned long long t = __shfl_xor_sync(kFull, m, o);
      m = t < m ? t : m;
    }
    if (lane == 0) S.key = m;
  }
  __syncthreads();
  const unsigned long long out = S.key;
  __syncthreads();
  return out;
}

// The value of rank `below + j` whose key is `key`: the key's own double,
// or for the zero key the j-th zero (from 0) in input order, with its sign.
__device__ double value_of(const Column& col, unsigned long long key,
                           long long j, Shared& S) {
  if (key != kSign) return from_key(key);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) S.found = 0;
  __syncthreads();
  long long seen = 0;
  for (long long base = 0; base < col.n; base += kThreads) {
    const long long i = base + tid;
    const bool eq = i < col.n && col.key(i) == key;
    const unsigned int votes = __ballot_sync(kFull, eq);
    if (lane == 0) S.warp_count[warp] = __popc(votes);
    __syncthreads();
    long long before = seen + __popc(votes & ((1u << lane) - 1u));
    long long total = 0;
    for (int w = 0; w < kWarps; ++w) {
      const unsigned int c = S.warp_count[w];
      if (w < warp) before += c;
      total += c;
    }
    if (eq && before == j) {
      S.value = col.p[i * col.f];
      S.found = 1;
    }
    seen += total;
    __syncthreads();
    if (S.found) break;
  }
  const double v = S.value;
  __syncthreads();
  return v;
}

// jnp.median's midpoint rule, (lo + hi) * 0.5, over the column
__device__ double median(const Column& col, Shared& S) {
  const long long k = (col.n - 1) / 2;
  select_rank(col, k, S);
  const unsigned long long key = S.key;
  const long long below = S.below, count = S.count;
  __syncthreads();
  const double lo = value_of(col, key, k - below, S);
  double hi = lo;
  if ((col.n & 1) == 0) {
    if (below + count > k + 1) {
      hi = value_of(col, key, k + 1 - below, S);
    } else {
      hi = value_of(col, min_above(col, key, S), 0, S);
    }
  }
  return __dmul_rn(__dadd_rn(lo, hi), 0.5);
}

__global__ void __cluster_dims__(kColumns, 1, 1) __launch_bounds__(kThreads)
sechenov_co2_kernel(const double* __restrict__ u, long long n, int f,
                    Consts c, double* __restrict__ out,
                    double* __restrict__ medians) {
  extern __shared__ unsigned long long staged[];
  __shared__ Shared S;
  __shared__ double s_median;
  cg::cluster_group cluster = cg::this_cluster();
  const int r = static_cast<int>(cluster.block_rank());
  // selects, not c.col[r]: an indexed parameter would copy c to the stack
  const int column = r == 0 ? c.col[0] : r == 1 ? c.col[1]
                   : r == 2 ? c.col[2] : c.col[3];
  const double* p = u + column;
  const bool stage = n <= kMaxStaged;
  // stage the keys and find the leading bytes they all share: the passes
  // start after them (none at all where every key is equal)
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned long long all_and = ~0ull, all_or = 0;
  for (long long i = threadIdx.x; i < n; i += kThreads) {
    const unsigned long long x = to_key(p[i * f]);
    if (stage) staged[i] = x;
    all_and &= x;
    all_or |= x;
  }
  for (int b = threadIdx.x; b < kBins; b += kThreads) S.hist[0][b] = 0;
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    all_and &= __shfl_xor_sync(kFull, all_and, o);
    all_or |= __shfl_xor_sync(kFull, all_or, o);
  }
  if (lane == 0) {
    S.part[warp] = all_and;
    S.part_or[warp] = all_or;
  }
  __syncthreads();
  all_and = ~0ull;
  all_or = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    all_and &= S.part[w];
    all_or |= S.part_or[w];
  }
  const int shared_bytes =
      __clzll(static_cast<long long>(all_and ^ all_or)) >> 3;
  const unsigned long long mask =
      shared_bytes == 0 ? 0ull : ~0ull << (64 - 8 * shared_bytes);
  const Column col{p, n, f, stage ? staged : nullptr, mask, all_and & mask,
                   56 - 8 * shared_bytes};
  const double med = median(col, S);
  if (threadIdx.x == 0) {
    s_median = med;
    if (medians) medians[r] = med;
  }
  cluster.sync();
  if (r == 0 && threadIdx.x == 0) {
    double conc[kColumns];
#pragma unroll
    for (int q = 0; q < kColumns; ++q)
      conc[q] = __dmul_rn(*cluster.map_shared_rank(&s_median, q), c.bc0[q]);
    if (!c.gmpnp)
      conc[3] = __dsub_rn(
          __dadd_rn(__dadd_rn(conc[1], __dmul_rn(conc[2], 2.0)), conc[0]),
          conc[3]);
    const double per_kilo = __ddiv_rn(1.0, 1000.0);
    double s = 0.0;
#pragma unroll
    for (int q = 0; q < kColumns; ++q)
      s = __dadd_rn(s, __dmul_rn(c.h[q], __dmul_rn(conc[q], per_kilo)));
    const double eq = __dmul_rn(c.A, pow(10.0, -s));
    *out = __dmul_rn(eq, __ddiv_rn(1.0, c.bc0_co2));
  }
  cluster.sync();
}

}  // namespace

// u: (n, f) f64, row-major; consts: kConsts doubles in host memory
// (ops/sechenov.py::SechenovConstants.pack): the four columns, their bulk
// concentrations, the four h_ion + h_CO2, the GMPNP flag, A and bc0_CO2;
// out: one double; medians: four doubles, or null
extern "C" int sechenov_co2_f64(const void* u, void* out, void* medians,
                                long long n, int f, const double* consts,
                                void* stream) {
  if (n < 1 || n > INT_MAX || f < 1 || consts == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Consts c;
  for (int q = 0; q < kColumns; ++q) {
    const double col = consts[q];
    if (!(col >= 0.0 && col < f) || col != static_cast<int>(col))
      return static_cast<int>(cudaErrorInvalidValue);
    c.col[q] = static_cast<int>(col);
    c.bc0[q] = consts[kColumns + q];
    c.h[q] = consts[2 * kColumns + q];
  }
  c.gmpnp = consts[kConsts - 3] != 0.0;
  c.A = consts[kConsts - 2];
  c.bc0_co2 = consts[kConsts - 1];
  const long long smem =
      n <= kMaxStaged ? n * static_cast<long long>(sizeof(double)) : 0;
  // over 48 KB of static and dynamic shared memory takes the opt-in
  if (smem + static_cast<long long>(sizeof(Shared)) + 64 > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sechenov_co2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kMaxStaged * sizeof(double)));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  sechenov_co2_kernel<<<kColumns, kThreads, static_cast<size_t>(smem),
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(u), n, f, c, static_cast<double*>(out),
      static_cast<double*>(medians));
  return static_cast<int>(cudaGetLastError());
}
