// K3 jet_assemble: dense BC-reduced tangent K from per-qp jet Hessians.
//
// Replaces the JAX device programs
//   goldfish_tpu/solver/system.py: assemble_K (one-hot matmul assembly,
//     _patch_dof_onehot) and devicechol.py: dense64_from_blocks,
//   and the B^T H B einsums that end kl_shell.element_hessians and
//   coupling.interface_hessians.
//
// Generic over "groups": a group g is an element (nq = Q qps, nj = 5 jets of
// the element's L locals) or an interface qp (nq = 1, nj = 6 jets over the
// 2L stacked locals of its two sides, rows zero-padded on the other side).
// For every group
//   K[gi[a], gi[b]] += sum_q sum_{j,k} R[q,j,l(a)] H_q[(j,x(a)),(k,y(b))] R[q,k,m(b)]
// for a = 3 l + x, b = 3 m + y, skipped where either dof is not free (the
// caller zero-fills K and adds diag(1 - free), system.py:260-262).
//
// One block per group. The group's basis rows and jet Hessians are staged
// in shared memory (39 KB for a p=3 element); each thread owns one local
// pair (l, m) and its 3x3 dof block, and adds it to K with f64 atomicAdd.
// What bounds it on the H100: the atomics into the 348 MB dense K (2.6 M
// element and 9.1 M interface adds at wing20) and the shared-memory reads of
// the O(nq nj^2) inner sum; no tensor-core path for f64 is used yet.
#include "dual.cuh"

namespace gf {
namespace {

__global__ void jet_assemble_kernel(const double* __restrict__ H,
                                    const double* __restrict__ R,
                                    const int* __restrict__ gi,
                                    const double* __restrict__ free_,
                                    double* K, int nq, int nj, int nloc,
                                    long long ndof) {
  extern __shared__ double sm[];
  const int g = blockIdx.x;
  const int nz = 3 * nj;
  const int nR = nq * nj * nloc;
  const int nH = nq * nz * nz;
  double* sR = sm;
  double* sH = sm + nR;
  const double* Rg = R + size_t(g) * nR;
  const double* Hg = H + size_t(g) * nH;
  for (int i = threadIdx.x; i < nR; i += blockDim.x) sR[i] = Rg[i];
  for (int i = threadIdx.x; i < nH; i += blockDim.x) sH[i] = Hg[i];
  __syncthreads();

  const int* gig = gi + size_t(g) * 3 * nloc;
  for (int lm = threadIdx.x; lm < nloc * nloc; lm += blockDim.x) {
    int l = lm / nloc;
    int m = lm % nloc;
    double acc[3][3] = {{0.0, 0.0, 0.0}, {0.0, 0.0, 0.0}, {0.0, 0.0, 0.0}};
    for (int q = 0; q < nq; ++q) {
      const double* Rq = sR + q * nj * nloc;
      const double* Hq = sH + q * nz * nz;
      for (int j = 0; j < nj; ++j) {
        double rl = Rq[j * nloc + l];
        if (rl == 0.0) continue;
        for (int k = 0; k < nj; ++k) {
          double w = rl * Rq[k * nloc + m];
          if (w == 0.0) continue;
          const double* Hjk = Hq + (3 * j) * nz + 3 * k;
#pragma unroll
          for (int x = 0; x < 3; ++x)
#pragma unroll
            for (int y = 0; y < 3; ++y) acc[x][y] += w * Hjk[x * nz + y];
        }
      }
    }
#pragma unroll
    for (int x = 0; x < 3; ++x) {
      int ga = gig[3 * l + x];
      if (free_[ga] == 0.0) continue;
#pragma unroll
      for (int y = 0; y < 3; ++y) {
        int gb = gig[3 * m + y];
        if (free_[gb] == 0.0) continue;
        atomicAdd(K + size_t(ga) * ndof + gb, acc[x][y]);
      }
    }
  }
}

}  // namespace
}  // namespace gf

extern "C" int gf_jet_assemble(const double* H, const double* R, const int* gi,
                               const double* free_, double* K, int G, int nq,
                               int nj, int nloc, long long ndof, void* stream) {
  using namespace gf;
  if (G == 0) return 0;
  size_t smem = (size_t(nq) * nj * nloc + size_t(nq) * 9 * nj * nj) *
                sizeof(double);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        jet_assemble_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  jet_assemble_kernel<<<G, 256, smem, static_cast<cudaStream_t>(stream)>>>(
      H, R, gi, free_, K, nq, nj, nloc, ndof);
  return launch_status();
}
