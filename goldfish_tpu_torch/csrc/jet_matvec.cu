// K4 jet_matvec: exact tangent-vector product K(d) v from per-qp jet
// Hessians, without assembling K.
//
// Replaces the matvec of the JAX device programs
//   goldfish_tpu/solver/system.py: tangent_matvec (jvp of the residual),
//   used by solver/devicechol.py: _jvp_ir_solve / _jvp_ir_dir for every
//   iterative-refinement sweep.
//
// Exact: H_q is the Hessian of the energy density in the displacement jet at
// the current state d (from shell_qp / penalty_qp mode 1), so
//   K(d) v = sum_q B_q^T H_q B_q v
// is the same product as the jvp of the residual (the dead load is linear in
// d and adds nothing). Masked on both sides as system.py:108-110: v is read
// as v * free, and only free dofs receive output.
//
// Groups as in jet_assemble.cu (an element with nq qps and nj = 5 jets, or
// an interface qp with nq = 1 and nj = 6 jets over 2L locals). One thread
// per (group, qp): gather the jets of v, apply the (3 nj)^2 Hessian, scatter
// B^T back with f64 atomicAdd. What bounds it on the H100: reading H_q
// (32 MB at wing20 for the shell part) once per sweep, i.e. memory
// bandwidth; the gathers and atomics of 17,920 + 992 threads are secondary.
#include "dual.cuh"

namespace gf {
namespace {

constexpr int MAX_NZ = 18;

__global__ void jet_matvec_kernel(const double* __restrict__ H,
                                  const double* __restrict__ R,
                                  const int* __restrict__ gi,
                                  const double* __restrict__ free_,
                                  const double* __restrict__ v, double* y,
                                  int G, int nq, int nj, int nloc) {
  size_t t = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= size_t(G) * nq) return;
  size_t g = t / nq;
  const int nz = 3 * nj;
  const double* Rq = R + t * nj * nloc;
  const double* Hq = H + t * nz * nz;
  const int* gig = gi + g * 3 * nloc;

  double z[MAX_NZ];
  for (int i = 0; i < nz; ++i) z[i] = 0.0;
  for (int l = 0; l < nloc; ++l) {
    double vl[3];
#pragma unroll
    for (int x = 0; x < 3; ++x) {
      int ga = gig[3 * l + x];
      vl[x] = v[ga] * free_[ga];
    }
    for (int j = 0; j < nj; ++j) {
      double r = Rq[j * nloc + l];
      z[3 * j] += r * vl[0];
      z[3 * j + 1] += r * vl[1];
      z[3 * j + 2] += r * vl[2];
    }
  }
  double w[MAX_NZ];
  for (int a = 0; a < nz; ++a) {
    double s = 0.0;
    for (int b = 0; b < nz; ++b) s += Hq[a * nz + b] * z[b];
    w[a] = s;
  }
  for (int l = 0; l < nloc; ++l) {
    double acc[3] = {0.0, 0.0, 0.0};
    for (int j = 0; j < nj; ++j) {
      double r = Rq[j * nloc + l];
      acc[0] += r * w[3 * j];
      acc[1] += r * w[3 * j + 1];
      acc[2] += r * w[3 * j + 2];
    }
#pragma unroll
    for (int x = 0; x < 3; ++x) {
      int ga = gig[3 * l + x];
      if (free_[ga] != 0.0) atomicAdd(y + ga, acc[x]);
    }
  }
}

}  // namespace
}  // namespace gf

extern "C" int gf_jet_matvec(const double* H, const double* R, const int* gi,
                             const double* free_, const double* v, double* y,
                             int G, int nq, int nj, int nloc, void* stream) {
  using namespace gf;
  if (G == 0) return 0;
  if (3 * nj > MAX_NZ) return static_cast<int>(cudaErrorInvalidValue);
  size_t n = size_t(G) * nq;
  jet_matvec_kernel<<<unsigned((n + 127) / 128), 128, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      H, R, gi, free_, v, y, G, nq, nj, nloc);
  return launch_status();
}
