// K5 traced_rows: rational NURBS basis rows of both sides of every moving
// intersection point, at the current intersection coordinates xi.
//
// Replaces the JAX device programs
//   goldfish_tpu/ops/bspline_jax.py: _find_span, _basis_values,
//     surface_basis (and the rows of surface_point / field_at),
//   goldfish_tpu/physics/coupling_mi.py: _rational_rows (R0 and
//     R1 = jax.jacfwd(R0)) as traced by _point_contributions,
//     penalty_energy_mi and interface_hessians_mi.
//
// One thread per evaluation point m (patch ip[m], coordinates xi[m]). The
// thread finds the knot spans, runs the Cox-de Boor recursion of
// bspline.cuh at a dual xi and writes
//   conn (M, L) int32    flat CP index of each local basis function,
//   R    (3, M, L)       R0, dR/dxi_u, dR/dxi_v.
// The moving-intersection caller orders the points (side, intersection,
// point), so that R[j, side] is directly the (I, N, L) table of
// physics/coupling.py's InterfaceStack.
//
// What bounds it on the H100: launch latency. At the T-beam's size (one
// intersection of 17 points, L = 16) the kernel reads a few KB of knots and
// weights and writes 34 x 16 rows (~20 KB); its ~10^4 flops per thread are
// nothing. One thread per point keeps it simple; the rows are consumed by
// K2, K3 and K4 exactly like the fixed-intersection tables.
#include "bspline.cuh"

namespace gf {
namespace {

__global__ void traced_rows_kernel(SurfSetArgs ss, const int* ip_,
                                   const double* xi, int M, int* conn,
                                   double* R) {
  const size_t m = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (m >= size_t(M)) return;
  const int ip = ip_[m];
  const int L = (ss.p + 1) * (ss.q + 1);
  int c[LMAX];
  typedef Dual<double, 2> S;
  S u(xi[2 * m]), v(xi[2 * m + 1]), Rl[LMAX];
  u.g[0] = 1.0;
  v.g[1] = 1.0;
  rational_rows(ss, ip, u, v, c, Rl);
  int* conn_o = conn + m * L;
  double* R0 = R + (0 * size_t(M) + m) * L;
  double* Ru = R + (1 * size_t(M) + m) * L;
  double* Rv = R + (2 * size_t(M) + m) * L;
  for (int l = 0; l < L; ++l) {
    conn_o[l] = c[l];
    R0[l] = Rl[l].v;
    Ru[l] = Rl[l].g[0];
    Rv[l] = Rl[l].g[1];
  }
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
  if (p > PMAX || q > PMAX) return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  SurfSetArgs ss{knots_u, knots_v, su_vals, su_ids, sv_vals, sv_ids,
                 w,       n_v,     Ku,      Kv,     Su,      Sv,
                 C,       p,       q};
  traced_rows_kernel<<<unsigned((size_t(M) + 127) / 128), 128, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      ss, ip, xi, M, conn, R);
  return launch_status();
}
