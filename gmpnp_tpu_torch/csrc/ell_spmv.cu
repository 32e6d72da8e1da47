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
// 4 or 8 bytes).  At the 3D pore main path (N=2,501, K=15, f=9) the f32
// matrix is 2,501*9*135*4 B ~ 12 MB per product, so at this N the kernel is
// bound by launch latency and by the latency of its dependent loads rather
// than by bandwidth.  The fused gather is the design's answer:
// one launch, one pass over the matrix, x (90 KB) served from L1/L2.
//
// Design (first, simple version): one thread per output row (n, r); the
// K*f sum stays in a register in the working type.  Padded ELL slots alias
// the row's own vertex with zero blocks and need no special case.  The
// kernel launches on the caller's stream, does not synchronise and
// allocates nothing; the C entry points return cudaGetLastError().

#include <cuda_runtime.h>

namespace {

template <typename T>
__global__ void ell_spmv_kernel(const T* __restrict__ flat,
                                const int* __restrict__ adj,
                                const T* __restrict__ x,
                                T* __restrict__ y,
                                int N, int K, int f) {
  const long long row = static_cast<long long>(blockIdx.x) * blockDim.x
                        + threadIdx.x;
  const long long rows = static_cast<long long>(N) * f;
  if (row >= rows) return;
  const int n = static_cast<int>(row / f);
  const long long Kf = static_cast<long long>(K) * f;
  const T* a = flat + row * Kf;
  const int* nb = adj + static_cast<long long>(n) * K;
  T acc = T(0);
  for (int k = 0; k < K; ++k) {
    const T* xs = x + static_cast<long long>(nb[k]) * f;
    const T* ak = a + k * f;
    for (int c = 0; c < f; ++c) {
      acc += ak[c] * xs[c];
    }
  }
  y[row] = acc;
}

template <typename T>
int launch(const void* flat, const void* adj, const void* x, void* y,
           int N, int K, int f, void* stream) {
  const long long rows = static_cast<long long>(N) * f;
  const int threads = 256;
  const long long blocks = (rows + threads - 1) / threads;
  ell_spmv_kernel<T><<<static_cast<unsigned int>(blocks), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(flat), static_cast<const int*>(adj),
      static_cast<const T*>(x), static_cast<T*>(y), N, K, f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ell_spmv_f32(const void* flat, const void* adj, const void* x,
                            void* y, int N, int K, int f, void* stream) {
  return launch<float>(flat, adj, x, y, N, K, f, stream);
}

extern "C" int ell_spmv_f64(const void* flat, const void* adj, const void* x,
                            void* y, int N, int K, int f, void* stream) {
  return launch<double>(flat, adj, x, y, N, K, f, stream);
}
