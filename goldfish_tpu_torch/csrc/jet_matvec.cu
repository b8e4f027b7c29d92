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
// Groups as in jet_assemble.cu (an element with nq qps and nj jets over
// nloc locals, or an interface qp with nq = 1 and nj = 6 jets over 2L
// locals). What bounds it on the H100: reading every H_q and R_q once per
// product (48.8 MB at wing20: H_e 32.3, R_e 11.5, H_i 2.6, R_i 1.5), i.e.
// memory bandwidth. The design is element-tiled: one group a tile, its
// H and R blocks (contiguous: nq (3 nj)^2 and nq nj nloc doubles, 28.8 KB
// and 10.2 KB for a p = 3 shell element) streamed into shared memory by
// coalesced cp.async copies (16 B where the block is 16 B aligned, else
// 8 B), R first so that z_q = B_q v_e for all qps of the tile runs while H
// is in flight; v * free and the dof indices gathered once a tile; then
// w_q = H_q z_q row by row from shared memory, y_e = sum_q B_q^T w_q
// reduced in shared memory (the qps split over the idle threads, partial
// sums added in a fixed order), and one f64 atomicAdd per (group, free
// local dof). A tile is 128 threads (one group) for elements, one warp for
// interface qps (four groups a block). The shapes the paths pass are
// compile-time instantiations (every loop bound a constant); any other
// shape runs the same kernel with runtime bounds. At wing20 the shell
// and interface launches take 0.037 and 0.012 ms with the L2 flushed
// before each (the one-thread-per-qp kernel before it: 0.117 and 0.148),
// 0.048 ms together against the 0.0145 ms byte bound (NVIDIA H100 80GB
// HBM3, 700 W; scripts/torch_port_kernel_ab.py, PERF.md).
#include <cuda_pipeline.h>

#include "dual.cuh"

namespace gf {
namespace {

__host__ __device__ constexpr int even(int n) { return n + (n & 1); }

// doubles of shared memory a group takes (each section 16 B aligned)
__host__ __device__ constexpr int slot_doubles(int nq, int nj, int nloc) {
  return even(nq * 9 * nj * nj) + even(nq * nj * nloc) + 4 * even(3 * nloc) +
         2 * even(nq * 3 * nj) + even((3 * nloc + 1) / 2);
}

// copy n doubles global -> shared with cp.async, 16 B chunks where both
// ends allow it; called by the `tpg` threads of one group
__device__ void stage(double* dst, const double* src, int n, int tid,
                      int tpg) {
  if ((reinterpret_cast<size_t>(src) & 15) == 0) {
    const int n2 = n / 2;
    for (int i = tid; i < n2; i += tpg)
      __pipeline_memcpy_async(dst + 2 * i, src + 2 * i, 16);
    if ((n & 1) && tid == 0)
      __pipeline_memcpy_async(dst + n - 1, src + n - 1, 8);
  } else {
    for (int i = tid; i < n; i += tpg)
      __pipeline_memcpy_async(dst + i, src + i, 8);
  }
}

// NQ, NJ, NLOC: the group shape (0 = read the runtime argument); TPG
// threads a group, blockDim / TPG groups a block
template <int NQ, int NJ, int NLOC, int TPG>
__global__ void __launch_bounds__(128)
    jet_matvec_tile(const double* __restrict__ H, const double* __restrict__ R,
                    const int* __restrict__ gi,
                    const double* __restrict__ free_,
                    const double* __restrict__ v, double* y, int G, int nq_,
                    int nj_, int nloc_) {
  const int nq = NQ ? NQ : nq_;
  const int nj = NJ ? NJ : nj_;
  const int nloc = NLOC ? NLOC : nloc_;
  const int nz = 3 * nj, nd = 3 * nloc;
  const int nH = nq * nz * nz, nR = nq * nj * nloc;
  extern __shared__ __align__(16) double sm_[];
  const int tid = threadIdx.x % TPG;
  const size_t g = size_t(blockIdx.x) * (blockDim.x / TPG) + threadIdx.x / TPG;
  const bool valid = g < size_t(G);
  double* sH = sm_ + (threadIdx.x / TPG) * slot_doubles(nq, nj, nloc);
  double* sR = sH + even(nH);
  double* sv = sR + even(nR);            // (v * free)[gi]
  double* sf = sv + even(nd);            // free[gi]
  double* sy = sf + even(nd);            // y_e partial sums (2 nd)
  double* sz = sy + 2 * even(nd);        // z_q (nq, nz)
  double* sw = sz + even(nq * nz);       // w_q (nq, nz)
  int* sg = reinterpret_cast<int*>(sw + even(nq * nz));   // gi
  if (valid) {
    stage(sR, R + g * nR, nR, tid, TPG);
    __pipeline_commit();
    stage(sH, H + g * nH, nH, tid, TPG);
    __pipeline_commit();
    for (int i = tid; i < nd; i += TPG) {
      int ga = gi[g * nd + i];
      double f = free_[ga];
      sv[i] = v[ga] * f;
      sf[i] = f;
      sg[i] = ga;
    }
    __pipeline_wait_prior(1);   // R has landed
  }
  __syncthreads();
  // z_q = B_q v_e: z[q][3 j + x] = sum_l R[q][j][l] v_e[3 l + x]
  if (valid)
    for (int it = tid; it < nq * nz; it += TPG) {
      const int q = it / nz, c = it % nz, j = c / 3, x = c % 3;
      const double* Rr = sR + (q * nj + j) * nloc;
      double s = 0.0;
#pragma unroll 4
      for (int l = 0; l < nloc; ++l) s += Rr[l] * sv[3 * l + x];
      sz[it] = s;
    }
  if (valid) __pipeline_wait_prior(0);   // H has landed
  __syncthreads();
  // w_q = H_q z_q, one row a thread
  if (valid)
    for (int it = tid; it < nq * nz; it += TPG) {
      const double* Hr = sH + it * nz;
      const double* zq = sz + (it / nz) * nz;
      double s = 0.0;
#pragma unroll
      for (int b = 0; b < nz; ++b) s += Hr[b] * zq[b];
      sw[it] = s;
    }
  __syncthreads();
  // y_e = sum_q B_q^T w_q: local dof (l, x), the qps split in `parts`
  const int parts = TPG / nd >= 2 && nq >= 2 ? 2 : 1;
  const int half = (nq + 1) / 2;
  if (valid)
    for (int it = tid; it < parts * nd; it += TPG) {
      const int part = it / nd, i = it % nd, l = i / 3, x = i % 3;
      const int qa = parts == 1 ? 0 : part * half;
      const int qb = parts == 1 ? nq : (part == 0 ? half : nq);
      double s = 0.0;
      for (int q = qa; q < qb; ++q)
#pragma unroll
        for (int j = 0; j < nj; ++j)
          s += sR[(q * nj + j) * nloc + l] * sw[q * nz + 3 * j + x];
      sy[it] = s;
    }
  __syncthreads();
  if (valid)
    for (int i = tid; i < nd; i += TPG) {
      const double f = sf[i];
      if (f != 0.0) {
        const double s = parts == 1 ? sy[i] : sy[i] + sy[nd + i];
        atomicAdd(y + sg[i], s * f);
      }
    }
}

template <int NQ, int NJ, int NLOC, int TPG>
int launch_tile(const double* H, const double* R, const int* gi,
                const double* free_, const double* v, double* y, int G,
                int nq, int nj, int nloc, cudaStream_t s) {
  const int gpb = 128 / TPG;
  const size_t smem = size_t(gpb) * slot_doubles(nq, nj, nloc) *
                      sizeof(double);
  auto kern = jet_matvec_tile<NQ, NJ, NLOC, TPG>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<unsigned((size_t(G) + gpb - 1) / gpb), 128, smem, s>>>(
      H, R, gi, free_, v, y, G, nq, nj, nloc);
  return launch_status();
}

// the compile-time shapes (nq, nj, nloc), those the paths of chip_smoke.py
// pass (it prints them after each path): shell elements of p = 3 (wing,
// T-beam, box wing, VLM wing), p = 2 (plate, press) and degree (3, 2)
// (tubes); the tubes' follower-pressure group; interfaces of L = 16, 9 and
// 12. With every bound a constant they run ~10% faster than the
// runtime-shape instantiation at wing20 (0.048 vs 0.053 ms with the L2
// flushed; NVIDIA H100 80GB HBM3, 700 W; scripts/torch_port_kernel_ab.py,
// which builds this file with an empty table to time that one alone)
#ifndef GF_MATVEC_SHAPES
#define GF_MATVEC_SHAPES(X)                                               \
  X(0, 16, 5, 16) X(1, 9, 5, 9) X(2, 12, 5, 12) X(3, 12, 3, 12)           \
  X(4, 1, 6, 32) X(5, 1, 6, 18) X(6, 1, 6, 24)
#endif

}  // namespace
}  // namespace gf

// index of the compile-time instantiation that serves (nq, nj, nloc), -1
// for the runtime-shape one
extern "C" int gf_jet_matvec_variant(int nq, int nj, int nloc) {
#define GF_MATCH(i, a, b, c) \
  if (nq == a && nj == b && nloc == c) return i;
  GF_MATVEC_SHAPES(GF_MATCH)
#undef GF_MATCH
  return -1;
}

extern "C" int gf_jet_matvec(const double* H, const double* R, const int* gi,
                             const double* free_, const double* v, double* y,
                             int G, int nq, int nj, int nloc, void* stream) {
  using namespace gf;
  if (G == 0) return 0;
  if (nq < 1 || nj < 1 || nloc < 1) return static_cast<int>(
      cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GF_LAUNCH(i, a, b, c)                                               \
  if (nq == a && nj == b && nloc == c)                                    \
    return launch_tile<a, b, c, (a == 1 ? 32 : 128)>(H, R, gi, free_, v, y, \
                                                     G, nq, nj, nloc, s);
  GF_MATVEC_SHAPES(GF_LAUNCH)
#undef GF_LAUNCH
  if (nq == 1)
    return launch_tile<0, 0, 0, 32>(H, R, gi, free_, v, y, G, nq, nj, nloc,
                                    s);
  return launch_tile<0, 0, 0, 128>(H, R, gi, free_, v, y, G, nq, nj, nloc, s);
}
