// K10 pair_assemble: batched dense sub-blocks of K from per-qp jet Hessians.
//
// Replaces the JAX device programs
//   goldfish_tpu/solver/krylov.py: PairSchwarz.assemble (:177, the (I, 6C, 6C)
//     interface-pair blocks) and patch_block_precond (:59, the (P, 3C, 3C)
//     patch blocks), i.e. their element_hessians / interface_hessians B^T H B
//     einsums and the per-block scatters.
//
// The groups are those of K3 (jet_assemble.cu): an element (nq = Q qps, nj =
// 5 jets over L locals) or an interface qp (nq = 1, nj = 6 jets over the 2L
// stacked locals). A group adds its sum_q B_q^T H_q B_q to each of its
// destination slots, listed in CSR form: slots slot_ptr[g] .. slot_ptr[g+1]-1
// of group g, slot s writing into block slot_block[s] of `out` (B, nb, nb)
// through its row map slot_map[s, 3 nloc]: local dof a = 3 l + x goes to
// block-local dof slot_map[s, a], or nowhere when that is -1 (a fixed or
// padding dof, or the other side's half for an interface quadrant). For every
// slot s of group g
//   out[blk, map[a], map[b]] += sum_q sum_{j,k} R[q,j,l] H_q[(j,x),(k,y)] R[q,k,m]
// for a = 3 l + x, b = 3 m + y with both map entries >= 0. The identity on
// fixed dofs is added by the caller.
//
// One block per group: the group's basis rows and jet Hessians are staged in
// shared memory (39 KB for a p=3 element), each thread owns one local pair
// (l, m), sums its 3x3 dof block once and adds it to every slot of the group
// with f64 atomicAdd (an element lands in 4-5 pair blocks of the box wing, an
// interface qp in up to 9).
#include "dual.cuh"

namespace gf {
namespace {

__global__ void pair_assemble_kernel(const double* __restrict__ H,
                                     const double* __restrict__ R,
                                     const int* __restrict__ slot_ptr,
                                     const int* __restrict__ slot_block,
                                     const int* __restrict__ slot_map,
                                     double* out, int nq, int nj, int nloc,
                                     int nb) {
  const int g = blockIdx.x;
  const int s0 = slot_ptr[g];
  const int s1 = slot_ptr[g + 1];
  if (s0 == s1) return;  // uniform over the block: no barrier is skipped
  extern __shared__ double sm[];
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

  const size_t nbb = size_t(nb) * nb;
  const int n3 = 3 * nloc;
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
    for (int s = s0; s < s1; ++s) {
      const int* map = slot_map + size_t(s) * n3;
      double* blk = out + size_t(slot_block[s]) * nbb;
#pragma unroll
      for (int x = 0; x < 3; ++x) {
        int a = map[3 * l + x];
        if (a < 0) continue;
#pragma unroll
        for (int y = 0; y < 3; ++y) {
          int b = map[3 * m + y];
          if (b < 0) continue;
          atomicAdd(blk + size_t(a) * nb + b, acc[x][y]);
        }
      }
    }
  }
}

}  // namespace
}  // namespace gf

extern "C" int gf_pair_assemble(const double* H, const double* R,
                                const int* slot_ptr, const int* slot_block,
                                const int* slot_map, double* out, int G,
                                int nq, int nj, int nloc, int nb,
                                void* stream) {
  using namespace gf;
  if (G == 0) return 0;
  size_t smem = (size_t(nq) * nj * nloc + size_t(nq) * 9 * nj * nj) *
                sizeof(double);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        pair_assemble_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  pair_assemble_kernel<<<G, 256, smem, static_cast<cudaStream_t>(stream)>>>(
      H, R, slot_ptr, slot_block, slot_map, out, nq, nj, nloc, nb);
  return launch_status();
}
