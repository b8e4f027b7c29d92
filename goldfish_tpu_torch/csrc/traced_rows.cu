// K5 traced_rows: rational NURBS basis rows of many points at once (both
// sides of every moving intersection point; the VLM lattice's corners).
//
// Replaces the JAX device programs
//   goldfish_tpu/ops/bspline_jax.py: _find_span, _basis_values,
//     surface_basis (and the rows of surface_point / field_at),
//   goldfish_tpu/physics/coupling_mi.py: _rational_rows (R0 and
//     R1 = jax.jacfwd(R0)) as traced by _point_contributions,
//     penalty_energy_mi and interface_hessians_mi.
//
// Output, for points m (patch ip[m], coordinates xi[m]):
//   conn (M, L) int32    flat CP index of each local basis function,
//   R    (3, M, L)       R0, dR/dxi_u, dR/dxi_v.
// The moving-intersection caller orders the points (side, intersection,
// point), so that R[j, side] is directly the (I, N, L) table of
// physics/coupling.py's InterfaceStack.
//
// What bounds it on the H100: latency. A launch has 34 (the T-beam), 280
// (the tube's four seams) or 1105 points (the 16 x 64 lattice); the work
// is ~300 f64 operations and ~1 KB of reads a point. The design shortens
// each point's dependent chain and spreads it over lanes: half a warp a
// point (bspline_rows.cuh: the span by ballots over the span starts, 16
// at a time, not a scan a thread; A2.3's values and derivatives in plain
// doubles, not a Dual recursion; the weights' sums by shuffles), and lane
// l stores entry l of the point's rows, so each half-warp writes L
// consecutive values of conn, R0, Ru and Rv. Knots, span starts and
// weights are read straight from global memory: the 16 lanes' reads of a
// start or a knot are one broadcast, and a block's points share their
// patch's lines in L1. 64 threads (4 points) a block, so that even 34
// points spread over 9 SMs.
#include "bspline_rows.cuh"

namespace gf {
namespace {

constexpr int ROWS_THREADS = 64;

__global__ void __launch_bounds__(ROWS_THREADS)
traced_rows_kernel(SurfSetArgs ss, const int* ip_, const double* xi, int M,
                   int* conn, double* R) {
  const size_t t = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if ((t & ~size_t(31)) / 16 >= size_t(M)) return;  // a whole idle warp
  const size_t m_raw = t / 16;
  const bool act = m_raw < size_t(M);
  const size_t m = act ? m_raw : size_t(M) - 1;  // idle half: redo the last
  const int l = threadIdx.x & 15;
  const LaneRow r = lane_row(ss, ip_[m], xi[2 * m], xi[2 * m + 1]);
  const int L = (ss.p + 1) * (ss.q + 1);
  if (!act || l >= L) return;
  conn[m * L + l] = r.conn;
  R[(0 * size_t(M) + m) * L + l] = r.R0;
  R[(1 * size_t(M) + m) * L + l] = r.Ru;
  R[(2 * size_t(M) + m) * L + l] = r.Rv;
}

}  // namespace
}  // namespace gf

extern "C" int gf_traced_rows(const double* knots_u, const double* knots_v,
                              const double* su_vals, const int* su_ids,
                              const double* sv_vals, const int* sv_ids,
                              const double* w, const int* n_v, const int* ip,
                              const double* xi, int* conn, double* R,
                              int Ku, int Kv, int Su, int Sv, int C, int p,
                              int q, int M, void* stream) {
  using namespace gf;
  if (p < 1 || q < 1 || p > PMAX || q > PMAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  SurfSetArgs ss{knots_u, knots_v, su_vals, su_ids, sv_vals, sv_ids,
                 w,       n_v,     Ku,      Kv,     Su,      Sv,
                 C,       p,       q};
  const unsigned blocks =
      unsigned((size_t(M) * 16 + ROWS_THREADS - 1) / ROWS_THREADS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  traced_rows_kernel<<<blocks, ROWS_THREADS, 0, st>>>(ss, ip, xi, M, conn, R);
  return launch_status();
}
