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
// Runs: consecutive groups with the same dof map (gi row) add to the same
// entries of K, so their sum is formed first and added once. One block per
// group. A block whose row equals the previous group's exits unless it
// lies M or more groups into its run (M = max(1, 32 / nq): at most 32 qps
// summed by one block; such a block takes its own group alone, as long
// runs are the padded elements of a stack, whose H is zero); a run head
// sums its group and the next ones with its row, up to M groups. The
// run's qps are contiguous in R and H and are staged through shared
// memory in batches of up to 64 KB.
// Threads: one column b = (m, y) of the (3 nloc)^2 block per thread and
// LPT locals l (rows 3 l + x, x = 0..2) of it; RY = ceil(nloc / LPT)
// threads share a column. Per qp a thread forms its column of T = H_q B_q
// in registers (nz values, nj FMAs each; the jet count NJ is a template
// parameter, so that every register index is known to the compiler), then
// adds R_q[j, l] T[3 j + x] to its 3 LPT sums: no shared-memory exchange
// and no barrier within a batch. The block is then added with one f64
// atomicAdd per nonzero entry between free dofs: lanes of a warp on
// consecutive columns of one row of the block, which are the few
// contiguous runs of (p + 1) * 3 doubles that one row of K holds for an
// element's locals. Interface qps on the same element pair lie
// consecutively in the table (992 groups in 403 runs at the 20-patch
// wing); shell, pressure and contact own-side groups are distinct
// elements (runs of one) but for padding. Atomics issued at wing20
// (chip_smoke.py's count, before the zero and free skips): interface 9.14
// M one per group (the design before this one), 3.71 M one per run.
// What bounds it on the H100: the bytes of K, zero-filled by the caller and
// then touched sector by sector by the atomics (348 MB at wing20); the
// f64 operations (2 nj 3nloc (nz + 3nloc) a qp, times RY for the columns
// of T) are a small share. On an H100 80GB HBM3 (700 W) at wing20 the
// zero-fill and K3 take 0.29 ms (0.47 before), the byte bound 0.118 ms
// (chip_smoke.py). No tensor-core path for f64 is used.
#include <cuda_pipeline.h>

#include "dual.cuh"

namespace gf {
namespace {

constexpr int RUN_QPS = 32;         // qps one block sums at most
constexpr size_t SMEM = 64 * 1024;  // staging budget of a block
constexpr int MAX_THREADS = 512;

__host__ __device__ constexpr size_t even(size_t n) {
  return (n + 1) & ~size_t(1);
}

// copy n doubles global -> shared with cp.async, 16 B chunks where both
// ends allow it
__device__ void stage(double* dst, const double* src, int n, int tid,
                      int nt) {
  if (((reinterpret_cast<size_t>(src) | reinterpret_cast<size_t>(dst)) &
       15) == 0) {
    const int n2 = n / 2;
    for (int i = tid; i < n2; i += nt)
      __pipeline_memcpy_async(dst + 2 * i, src + 2 * i, 16);
    if ((n & 1) && tid == 0)
      __pipeline_memcpy_async(dst + n - 1, src + n - 1, 8);
  } else {
    for (int i = tid; i < n; i += nt)
      __pipeline_memcpy_async(dst + i, src + i, 8);
  }
}

template <int NJ, int LPT>
__global__ void jet_assemble_kernel(const double* __restrict__ H,
                                    const double* __restrict__ R,
                                    const int* __restrict__ gi,
                                    const double* __restrict__ free_,
                                    double* K, int G, int nq, int nloc,
                                    long long ndof, int qb) {
  constexpr int NZ = 3 * NJ;
  extern __shared__ double sm[];
  __shared__ int s_ne[2 * RUN_QPS + 1];  // row g + k differs, k = -M..M
  const int g = blockIdx.x;
  const int n3 = 3 * nloc, RY = blockDim.y;
  const int tid = threadIdx.y * n3 + threadIdx.x, nt = n3 * RY;
  const int nR = NJ * nloc, nH = NZ * NZ;
  const int M = max(1, RUN_QPS / nq);
  const int* gig = gi + size_t(g) * n3;
  double* sR = sm;                          // qb x NJ x nloc
  double* sH = sR + even(size_t(qb) * nR);  // qb x NZ x NZ
  const size_t q0 = size_t(g) * nq;
  // this block's own group is needed unless the block exits: its copy
  // runs while the run is found
  const int first = min(nq, qb);
  stage(sR, R + q0 * nR, first * nR, tid, nt);
  stage(sH, H + q0 * nH, first * nH, tid, nt);
  __pipeline_commit();
  // the run around g, up to M groups each way
  for (int k = tid; k <= 2 * M; k += nt) s_ne[k] = 0;
  __syncthreads();
  for (int t = tid; t < 2 * M * n3; t += nt) {
    const int k = t / n3, i = t - k * n3;
    const int off = k < M ? k - M : k - M + 1;  // -M..-1, 1..M
    const int gg = g + off;
    if (gg < 0 || gg >= G || gi[size_t(gg) * n3 + i] != gig[i])
      s_ne[M + off] = 1;
  }
  __syncthreads();
  int back = 0, len = 1;
  while (back < M && !s_ne[M - back - 1]) ++back;
  if (back > 0 && back < M) {  // inside a run head's groups
    __pipeline_wait_prior(0);
    return;
  }
  if (back == 0)
    while (len < M && !s_ne[M + len]) ++len;

  const int b = threadIdx.x, m = b / 3, y = b - 3 * m;
  double acc[LPT][3];
#pragma unroll
  for (int k = 0; k < LPT; ++k)
#pragma unroll
    for (int x = 0; x < 3; ++x) acc[k][x] = 0.0;
  const int nqr = len * nq;
  for (int b0 = 0; b0 < nqr; b0 += qb) {
    const int nb = min(qb, nqr - b0);
    const int have = b0 == 0 ? first : 0;  // qps already in flight
    if (b0 > 0) __syncthreads();  // the previous batch's readers are done
    if (nb > have) {
      const size_t qs = q0 + b0 + have;
      stage(sR + have * nR, R + qs * nR, (nb - have) * nR, tid, nt);
      stage(sH + have * nH, H + qs * nH, (nb - have) * nH, tid, nt);
      __pipeline_commit();
    }
    __pipeline_wait_prior(0);
    __syncthreads();
    for (int q = 0; q < nb; ++q) {
      const double* Rq = sR + q * nR;
      const double* Hq = sH + q * nH + y;
      // this thread's column of T = H_q B_q: T[r] = sum_k H[r, 3k+y] R[k, m]
      double rm[NJ], T[NZ];
#pragma unroll
      for (int k = 0; k < NJ; ++k) rm[k] = Rq[k * nloc + m];
#pragma unroll
      for (int r = 0; r < NZ; ++r) {
        double s = 0.0;
#pragma unroll
        for (int k = 0; k < NJ; ++k) s += Hq[r * NZ + 3 * k] * rm[k];
        T[r] = s;
      }
#pragma unroll
      for (int k = 0; k < LPT; ++k) {
        const int l = threadIdx.y + k * RY;
        if (l < nloc) {
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const double rl = Rq[j * nloc + l];
#pragma unroll
            for (int x = 0; x < 3; ++x) acc[k][x] += rl * T[3 * j + x];
          }
        }
      }
    }
  }
  const int gb = gig[b];
  if (free_[gb] == 0.0) return;
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    const int l = threadIdx.y + k * RY;
    if (l >= nloc) continue;
#pragma unroll
    for (int x = 0; x < 3; ++x) {
      if (acc[k][x] == 0.0) continue;
      const int ga = gig[3 * l + x];
      if (free_[ga] != 0.0) atomicAdd(K + size_t(ga) * ndof + gb, acc[k][x]);
    }
  }
}

template <int NJ, int LPT>
int launch(const double* H, const double* R, const int* gi,
           const double* free_, double* K, int G, int nq, int nloc,
           long long ndof, cudaStream_t st) {
  const size_t n3 = 3 * size_t(nloc), nz = 3 * NJ;
  const int RY = (nloc + LPT - 1) / LPT;
  const size_t per_qp = (size_t(NJ) * nloc + nz * nz) * sizeof(double);
  // qps staged at once: as many as the budget holds, at most a run's
  const size_t most = size_t(nq) * (RUN_QPS / nq > 1 ? RUN_QPS / nq : 1);
  size_t qb = per_qp + 8 <= SMEM ? (SMEM - 8) / per_qp : 1;
  if (qb > most) qb = most;
  const size_t smem = (even(qb * NJ * nloc) + qb * nz * nz) * sizeof(double);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        jet_assemble_kernel<NJ, LPT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  jet_assemble_kernel<NJ, LPT><<<G, dim3(unsigned(n3), RY), smem, st>>>(
      H, R, gi, free_, K, G, nq, nloc, ndof, int(qb));
  return launch_status();
}

// the fewest locals a thread (4, 8 or 16) that keeps a block within
// MAX_THREADS threads
template <int NJ>
int launch_nj(const double* H, const double* R, const int* gi,
              const double* free_, double* K, int G, int nq, int nloc,
              long long ndof, cudaStream_t st) {
  const int n3 = 3 * nloc;
  if (n3 * ((nloc + 3) / 4) <= MAX_THREADS)
    return launch<NJ, 4>(H, R, gi, free_, K, G, nq, nloc, ndof, st);
  if (n3 * ((nloc + 7) / 8) <= MAX_THREADS)
    return launch<NJ, 8>(H, R, gi, free_, K, G, nq, nloc, ndof, st);
  if (n3 * ((nloc + 15) / 16) <= 1024)
    return launch<NJ, 16>(H, R, gi, free_, K, G, nq, nloc, ndof, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace gf

// nj: 1 (contact own-side sums), 3 (pressure), 5 (shell), 6 (interface)
extern "C" int gf_jet_assemble(const double* H, const double* R, const int* gi,
                               const double* free_, double* K, int G, int nq,
                               int nj, int nloc, long long ndof, void* stream) {
  using namespace gf;
  if (G == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (nj) {
    case 1: return launch_nj<1>(H, R, gi, free_, K, G, nq, nloc, ndof, st);
    case 3: return launch_nj<3>(H, R, gi, free_, K, G, nq, nloc, ndof, st);
    case 5: return launch_nj<5>(H, R, gi, free_, K, G, nq, nloc, ndof, st);
    case 6: return launch_nj<6>(H, R, gi, free_, K, G, nq, nloc, ndof, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
