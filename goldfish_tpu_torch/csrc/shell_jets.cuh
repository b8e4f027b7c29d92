// Jets of a control-point field at a shell quadrature point, shared by K1
// shell_qp and K8 pressure_qp.
//
// A jet is the field's value or derivative at the qp through one basis table
// R (P, E, Q, L) of the patch stack: out[3 j + x] = sum_l R_j[qi, l]
// f[p, conn[ei, l], x]. K1 gathers (R10, R01, R20, R11, R02), K8
// (R00, R10, R01).
#pragma once

#include "dual.cuh"

namespace gf {

// out (3 NR) = the jets of the (P, C, 3) field f at qp qi = ei * Q + q of
// element ei of patch p through the NR tables R[0..NR-1]
template <int NR>
__device__ inline void gather_rows(const double* const* R, const int* conn,
                                   const double* f, int p, int ei, int qi,
                                   int L, int C, double* out) {
#pragma unroll
  for (int i = 0; i < 3 * NR; ++i) out[i] = 0.0;
  for (int l = 0; l < L; ++l) {
    const double* c = f + (size_t(p) * C + conn[size_t(ei) * L + l]) * 3;
    double c0 = c[0], c1 = c[1], c2 = c[2];
#pragma unroll
    for (int j = 0; j < NR; ++j) {
      double r = R[j][size_t(qi) * L + l];
      out[3 * j] += r * c0;
      out[3 * j + 1] += r * c1;
      out[3 * j + 2] += r * c2;
    }
  }
}

}  // namespace gf
