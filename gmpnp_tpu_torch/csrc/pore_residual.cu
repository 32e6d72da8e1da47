// Element residuals of the 3D pore's volume form on P1 tetrahedra, f64.
//
// Replaces no Pallas kernel.  Its counterpart is the jnp element residual
// of gmpnp_tpu/fem/assembly.py (FemSpace._local_volume_residual under
// vmap, which XLA fuses on the TPU).  In the port that path is
// torch.func: vmap over elements and quadrature points of the form's
// volume integrand, some 75 device operations per call, most of them tiny
// batched matrix products (inner dimension 3 or 4) that run as f64 GEMMs.
// Here one launch computes, for each element c and field i,
//
//     r[l, c, a, i] = vol[c] * sum_q wq[q] * (N[q, a] * fval_i(q)
//                                             + gradN[c, a] . fgrad_i(q))
//
//     u, u_prev (lanes, N, f); cells (C, 4) int64; gradN (C, 4, 3);
//     vols (C,); Nq (Q, 4); wq (Q,); out (lanes, C, 4, f)
//
// with the pore integrand of models/pore_3d.py (PoreVolumeSpec.volume,
// its torch form, serves every other path): the time term, the buffer
// kinetics (chem/reactions.py::buffer_rates) and diffusion, and with the
// GMPNP flag the Nernst-Planck migration, the steric term with its clip,
// the Poisson source and the hydration-dependent permittivity.  The
// sorted-segment sum (csrc/segment_sum.cu) then reduces r onto vertices.
//
// Bound: bytes, and under them the launch.  At the GMPNP pore (L=50 nm,
// R=5 nm: 11,520 tets, N=2,501, f=9, Q=4) the call reads the cells
// (368,640 B), gradients (1,105,920 B), volumes (92,160 B), u and u_prev
// (360,144 B) and writes r (3,317,760 B): 5,244,624 B, 1.57 us at 3.35
// TB/s.  Its arithmetic, about 64 f + 40 f64 operations per element and
// quadrature point (28 MFLOP), takes 0.8 us at the card's 34 TFLOP/s f64
// rate.  What it does take is latency: two dependent gathers (cells, then
// u) and a chain of f64 operations per thread; a launch of one element
// takes 3.7-4.0 us of device time where the segment sum's takes 1.6
// (NVIDIA H100 80GB HBM3, 700 W).  So the design cuts each thread's chain
// and keeps every intermediate on chip: one launch for the whole volume
// term (and one for all lanes of a batched sweep).
//
// Threads: one per (element, field).  A warp packs floor(32/f) elements
// (3 at f=9, 4 at f=7), lane (e, i) = (lane / f, lane % f); a thread per
// element would hold 2 x 36 inputs and 36 sums and spill.  Each thread
// gathers its field of u and u_prev at the 4 vertices, forms its gradient
// and stages both in shared memory; then the element's lanes split what
// the fields share: (2) lanes 0-6 each take one of the GMPNP sums over
// species (at a vertex, scale_vol . u and z c0 . u, linear in u and so
// interpolated to the points; along an axis, scale_vol . grad u), (3)
// lanes 0..Q-1 each take one quadrature point's buffer reaction rates,
// steric factor (one division), Poisson source and permittivity, and (4)
// every lane runs its own field over the points with those.  Every lane
// sums in a fixed order.  The spare lanes of a warp (5 at f=9) mirror
// lane 0 and store nothing.  Cold at the GMPNP pore, in the order tried
// (same card): every lane computing every shared term, with a compare
// chain over the species and three divisions per point, 20.7 us; one
// division per point and the sums at the vertices, 14.0; shuffles
// replaced by shared memory with unrolled loops, 16.5 (204 registers);
// this split, 13.3.
//
// Each thread sums over q in order from 0.0 and writes its 4 entries; no
// atomics, so two launches give the same bits.  The plain version rounds
// otherwise (other summation orders, FMA contraction and reciprocals
// here), within 1e-15 relative per field at the paths' shapes.
// blockIdx.y is the lane of a lane-batched call (FemSpace.residual_lanes):
// every lane computes what a one-lane launch computes.  dt is a host
// scalar, or per lane on the device (dt_lanes).
//
// The kernel launches on the caller's stream, does not synchronise and
// allocates nothing; the C entry point returns cudaGetLastError(), or
// cudaErrorInvalidValue for shapes it does not take.  The tables are
// trusted as FemSpace builds them: 0 <= cells < N.

#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kNv = 4;           // vertices of a P1 tetrahedron
constexpr int kDim = 3;
constexpr int kMaxFields = 16;   // ops/pore_residual.py::MAX_FIELDS
constexpr int kMaxQ = 16;        // ops/pore_residual.py::MAX_POINTS
constexpr int kMinFields = 7;    // lanes 0-6 take the GMPNP sums; MIN_FIELDS
constexpr int kMaxElems = 32 / kMinFields;   // elements a warp packs
// an element's sums: scale_vol . u at the vertices, scale_vol . grad u,
// z c0 . u at the vertices; a point's shared terms
constexpr int kElemP = kNv + kDim, kElemVals = kElemP + kNv;
enum : int { kRw = 0, kRa, kRb, kSteric, kPoisson, kEps, kPointVals };

// the spec's packed constants (ops/pore_residual.py::pack_constants):
// a header of small integers held as doubles, the scalars, then one row of
// kMaxFields per per-species table
enum : int {
  kF = 0, kNs, kGmpnp, kClipOn, kH, kOH, kHCO3, kCO32, kCO2, kCat, kProton,
  kKw1, kKw2, kKa1, kKa2, kKb1, kKb2,
  kQ, kClip, kWCat, kC0Cat, kWH, kC0H, kEpsRel,
  kZ, kScaleVol = kZ + kMaxFields, kC0 = kScaleVol + kMaxFields,
  kScaleR = kC0 + kMaxFields, kZC0 = kScaleR + kMaxFields,
  kConsts = kZC0 + kMaxFields
};

__global__ void __launch_bounds__(kThreads)
pore_volume_residual_kernel(const double* __restrict__ u,
                            const double* __restrict__ u_prev,
                            const double* __restrict__ dt_lanes,
                            double dt_value,
                            const long long* __restrict__ cells,
                            const double* __restrict__ gradN,
                            const double* __restrict__ vols,
                            const double* __restrict__ Nq,
                            const double* __restrict__ wq,
                            const double* __restrict__ consts,
                            double* __restrict__ out, long long n_cells,
                            int Q, int f, long long lane_state,
                            long long lane_out) {
  __shared__ double sc[kConsts];
  __shared__ double sN[kMaxQ * kNv];
  __shared__ double sw[kMaxQ];
  // what the lanes of an element hand each other: each lane's field at the
  // vertices and its gradient; the element's sums at the vertices; and at
  // each point the terms every field shares
  __shared__ double stage[kWarps][32][kNv + kDim];
  __shared__ double elem[kWarps][kMaxElems][kElemVals];
  __shared__ double point[kWarps][kMaxElems][kMaxQ][kPointVals];
  for (int t = threadIdx.x; t < kConsts; t += kThreads) sc[t] = consts[t];
  for (int t = threadIdx.x; t < Q * kNv; t += kThreads) sN[t] = Nq[t];
  for (int t = threadIdx.x; t < Q; t += kThreads) sw[t] = wq[t];

  const int per_warp = 32 / f;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  int e = lane / f;
  int i = lane - e * f;
  const bool spare = e >= per_warp;
  if (spare) e = i = 0;
  const int base = e * f;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  long long c = warp * per_warp + e;
  const bool store = !spare && c < n_cells;
  if (c >= n_cells) c = n_cells - 1;   // past the end: compute, store nothing

  // every load of the element before the first wait
  const double* ul = u + blockIdx.y * lane_state;
  const double* upl = u_prev + blockIdx.y * lane_state;
  long long vtx[kNv];
  double g[kNv][kDim];
#pragma unroll
  for (int a = 0; a < kNv; ++a) {
    vtx[a] = __ldg(cells + c * kNv + a);
#pragma unroll
    for (int d = 0; d < kDim; ++d)
      g[a][d] = __ldg(gradN + (c * kNv + a) * kDim + d);
  }
  const double vol = __ldg(vols + c);
  const double dt = dt_lanes != nullptr ? __ldg(dt_lanes + blockIdx.y)
                                        : dt_value;
  double ua[kNv], upa[kNv];
#pragma unroll
  for (int a = 0; a < kNv; ++a) {
    ua[a] = __ldg(ul + vtx[a] * f + i);
    upa[a] = __ldg(upl + vtx[a] * f + i);
  }
  __syncthreads();

  const int ns = static_cast<int>(sc[kNs]);
  const bool gmpnp = sc[kGmpnp] != 0.0;
  const bool species = i < ns;   // else the GMPNP potential's row

  // (1) this lane's field: its gradient (constant on the element), staged
  // with its vertex values for the element's other lanes
  double gi[kDim];
#pragma unroll
  for (int d = 0; d < kDim; ++d) {
    gi[d] = ((ua[0] * g[0][d] + ua[1] * g[1][d]) + ua[2] * g[2][d]) +
            ua[3] * g[3][d];
    stage[w][lane][kNv + d] = gi[d];
  }
#pragma unroll
  for (int a = 0; a < kNv; ++a) stage[w][lane][a] = ua[a];
  __syncwarp();

  // (2) GMPNP: the sums over species, one per lane of the element: at
  // vertex a (lanes 0-3) sum_j scale_vol_j u_j and sum_j z_j c0_j u_j,
  // along axis d (lanes 4-6) sum_j scale_vol_j grad_d u_j
  if (gmpnp && !spare && i < kNv + kDim) {
    double s0 = 0.0, s1 = 0.0;
    for (int j = 0; j < ns; ++j) {
      const double v = stage[w][base + j][i];
      s0 = s0 + sc[kScaleVol + j] * v;
      s1 = s1 + sc[kZC0 + j] * v;
    }
    elem[w][e][i] = s0;
    if (i < kNv) elem[w][e][kElemP + i] = s1;
  }
  __syncwarp();

  // (3) what every field shares at point q, one point per lane (q = i,
  // i + f, ...): the three buffer reaction rates and, with GMPNP, the
  // steric factor 1 / max(1 - sum_j scale_vol_j u_j, clip), the Poisson
  // source and the permittivity
  if (!spare) {
    for (int q = i; q < Q; q += f) {
      const double* N = sN + q * kNv;
      auto at = [&](int j) {
        const double* r = stage[w][base + j];
        return ((N[0] * r[0] + N[1] * r[1]) + N[2] * r[2]) + N[3] * r[3];
      };
      const int iH = static_cast<int>(sc[kH]);
      const int iOH = static_cast<int>(sc[kOH]);
      const int iHCO3 = static_cast<int>(sc[kHCO3]);
      const int iCO32 = static_cast<int>(sc[kCO32]);
      const int iCO2 = static_cast<int>(sc[kCO2]);
      const double cOH = at(iOH) * sc[kC0 + iOH];
      const double cHCO3 = at(iHCO3) * sc[kC0 + iHCO3];
      const double cCO32 = at(iCO32) * sc[kC0 + iCO32];
      const double cCO2 = at(iCO2) * sc[kC0 + iCO2];
      double* pv = point[w][e][q];
      pv[kRw] = iH >= 0
          ? (sc[kKw2] * (at(iH) * sc[kC0 + iH])) * cOH - sc[kKw1] : 0.0;
      pv[kRa] = (sc[kKa1] * cHCO3) * cOH - sc[kKa2] * cCO32;
      pv[kRb] = (sc[kKb1] * cCO2) * cOH - sc[kKb2] * cHCO3;
      if (gmpnp) {
        const double* el = elem[w][e];
        double denom = 1.0 - (((N[0] * el[0] + N[1] * el[1]) +
                               N[2] * el[2]) + N[3] * el[3]);
        if (sc[kClipOn] != 0.0 && denom < sc[kClip])
          denom = sc[kClip];  // NaN stays
        pv[kSteric] = 1.0 / denom;
        pv[kPoisson] = sc[kQ] * ((((N[0] * el[kElemP] +
                                    N[1] * el[kElemP + 1]) +
                                   N[2] * el[kElemP + 2]) +
                                  N[3] * el[kElemP + 3]));
        const double hyd =
            ((sc[kWCat] * at(static_cast<int>(sc[kCat]))) * sc[kC0Cat] +
             (sc[kWH] * at(static_cast<int>(sc[kProton]))) * sc[kC0H]) *
            1.0e-3;
        pv[kEps] = (sc[kEpsRel] * (55.0 - hyd) + 6.0 * hyd) * (1.0 / 55.0);
      }
    }
  }
  __syncwarp();

  // (4) this lane's field at every point.  Its rate as buffer_rates forms
  // it: -scale_R * (cw r_w + ca r_a + cb r_b), the coefficients 0 or +-1
  const int iH = static_cast<int>(sc[kH]), iOH = static_cast<int>(sc[kOH]);
  const int iHCO3 = static_cast<int>(sc[kHCO3]);
  const int iCO32 = static_cast<int>(sc[kCO32]);
  const int iCO2 = static_cast<int>(sc[kCO2]);
  const double cw = (i == iH || i == iOH) ? 1.0 : 0.0;
  const double ca = (i == iOH || i == iHCO3) ? 1.0 : i == iCO32 ? -1.0 : 0.0;
  const double cb = (i == iOH || i == iCO2) ? 1.0 : i == iHCO3 ? -1.0 : 0.0;
  const double sR = species ? sc[kScaleR + i] : 0.0;
  const double zi = species ? sc[kZ + i] : 0.0;
  const double rdt = 1.0 / dt;
  double gp[kDim] = {0.0, 0.0, 0.0}, common[kDim] = {0.0, 0.0, 0.0};
  if (gmpnp) {
#pragma unroll
    for (int d = 0; d < kDim; ++d) {
      gp[d] = stage[w][base + ns][kNv + d];
      common[d] = elem[w][e][kNv + d];
    }
  }
  // sum_q wq N_qa fval and sum_q wq fgrad: the residual's two parts
  double F[kNv] = {0.0, 0.0, 0.0, 0.0}, G[kDim] = {0.0, 0.0, 0.0};
  for (int q = 0; q < Q; ++q) {
    const double* N = sN + q * kNv;
    const double* pv = point[w][e][q];
    const double uq = ((N[0] * ua[0] + N[1] * ua[1]) + N[2] * ua[2]) +
                      N[3] * ua[3];
    const double upq = ((N[0] * upa[0] + N[1] * upa[1]) + N[2] * upa[2]) +
                       N[3] * upa[3];
    const double R = -sR * ((cw * pv[kRw] + ca * pv[kRa]) + cb * pv[kRb]);
    double fval = (uq - upq) * rdt - R;
    double fg[kDim] = {gi[0], gi[1], gi[2]};
    if (gmpnp) {
      if (species) {
        const double steric = uq * pv[kSteric];
#pragma unroll
        for (int d = 0; d < kDim; ++d)
          fg[d] = (gi[d] + (zi * uq) * gp[d]) + steric * common[d];
      } else {
        fval = pv[kPoisson];
#pragma unroll
        for (int d = 0; d < kDim; ++d) fg[d] = -pv[kEps] * gp[d];
      }
    }
    const double wf = sw[q] * fval;
#pragma unroll
    for (int a = 0; a < kNv; ++a) F[a] = F[a] + wf * N[a];
#pragma unroll
    for (int d = 0; d < kDim; ++d) G[d] = G[d] + sw[q] * fg[d];
  }
  if (store) {
    double* dst = out + blockIdx.y * lane_out + c * kNv * f + i;
#pragma unroll
    for (int a = 0; a < kNv; ++a) {
      // gradN again (from L1): no registers held through the point loop
      const double* ga = gradN + (c * kNv + a) * kDim;
      dst[a * f] = vol * (F[a] + ((__ldg(ga) * G[0] + __ldg(ga + 1) * G[1]) +
                                  __ldg(ga + 2) * G[2]));
    }
  }
}

}  // namespace

// lanes >= 1 states of one mesh: lane l reads u + l * lane_state (and
// u_prev, dt_lanes[l] unless dt_lanes is null) and writes out + l *
// lane_out; consts: kConsts doubles on the device (pack_constants)
extern "C" int pore_volume_residual_f64(
    const void* u, const void* u_prev, const void* dt_lanes, double dt_value,
    const void* cells, const void* gradN, const void* vols, const void* Nq,
    const void* wq, const void* consts, void* out, long long n_cells, int Q,
    int f, int lanes, long long lane_state, long long lane_out,
    void* stream) {
  if (n_cells < 0 || f < kMinFields || f > kMaxFields || Q < 1 ||
      Q > kMaxQ || lanes < 1 || lanes > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_cells == 0) return 0;
  const long long per_warp = 32 / f;
  const long long warps = (n_cells + per_warp - 1) / per_warp;
  const long long blocks = (warps + kWarps - 1) / kWarps;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks), lanes);
  pore_volume_residual_kernel<<<grid, kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(u), static_cast<const double*>(u_prev),
      static_cast<const double*>(dt_lanes), dt_value,
      static_cast<const long long*>(cells), static_cast<const double*>(gradN),
      static_cast<const double*>(vols), static_cast<const double*>(Nq),
      static_cast<const double*>(wq), static_cast<const double*>(consts),
      static_cast<double*>(out), n_cells, Q, f, lane_state, lane_out);
  return static_cast<int>(cudaGetLastError());
}
