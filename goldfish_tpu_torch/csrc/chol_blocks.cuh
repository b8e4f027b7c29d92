// Pieces shared by K13 chol_subst.cu and K14 chol_factor.cu: the 64-row
// block, the hand-off between thread blocks of one launch (tickets, flags
// published with release and read with acquire), cp.async, and the f64
// tensor-core product (mma.sync m8n8k4) of a 64 x 64 tile of A, k-major,
// with a 64 x 128 tile of B, k-major, that both kernels run.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace gf {
namespace {

constexpr int NB = 64;           // rows of a block (cholesky.NB)
constexpr int THREADS = 256;
constexpr int CT = 128;          // columns of a 64 x 128 product tile
constexpr int APF = NB + 8;      // pitch of a k-major A tile
constexpr int APB = NB + 4;      // pitch of an m-major A tile
constexpr int BP = CT + 8;       // pitch of a k-major B tile
constexpr int ASZ = NB * APF;    // doubles of an A stage (>= NB * APB)
constexpr int BSZ = NB * BP;     // doubles of a B stage
static_assert(NB * APB <= ASZ, "m-major A tile exceeds its stage");

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// Spin until *f is set. A block waits only on earlier tickets, so the wait
// ends; a wait that outlasts 2^24 polls (seconds) can only be a fault, and
// traps (a launch error the wrapper raises) rather than hang the card.
__device__ __forceinline__ void spin(const int* f) {
  for (long n = 0; ld_acquire(f) == 0; ++n)
    if (n > (1l << 24)) __trap();
}

// Publish: every thread's stores are done (barrier), then one fence and a
// release store of the flag.
__device__ __forceinline__ void publish(int* f) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    st_release(f, 1);
  }
}

__device__ __forceinline__ int take_ticket(int* ticket) {
  __shared__ int s_ticket;
  if (threadIdx.x == 0) s_ticket = atomicAdd(ticket, 1);
  __syncthreads();
  return s_ticket;
}

// d += a b on the f64 tensor cores: one m8n8k4 product of the warp. Lane
// (g = lane / 4, t = lane % 4) holds A[g][t], B[t][g] and D[g][2t],
// D[g][2t+1].
__device__ __forceinline__ void dmma(double& d0, double& d1, double a,
                                     double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, "
      "{%0, %1};\n"
      : "+d"(d0), "+d"(d1)
      : "d"(a), "d"(b));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async8(double* dst, const double* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(double* dst, const double* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N_>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N_) : "memory");
}

// A(m, k) of a staged A tile: k-major (As[k * AP + m]) or m-major
// (As[m * APB + k]).
template <bool MMAJOR, int AP = APF>
__device__ __forceinline__ double a_at(const double* As, int m, int k) {
  return MMAJOR ? As[m * APB + k] : As[k * AP + m];
}

// acc += A (64 x 64, staged) B (64 x CT, staged, Bs[k * BPITCH + n]) for
// the warp's 32 x 32 outputs (rows wm.., columns wn..), k in order. K13
// stages with the pitches APF and BP, K14's update with its own.
template <bool MMAJOR, int AP = APF, int BPITCH = BP>
__device__ __forceinline__ void tile_mma(const double* As, const double* Bs,
                                         double (&acc)[4][4][2], int wm,
                                         int wn) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tt = lane & 3;
#pragma unroll 4
  for (int k0 = 0; k0 < NB; k0 += 4) {
    double a[4], bb[4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
      a[mt] = a_at<MMAJOR, AP>(As, wm + mt * 8 + g, k0 + tt);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      bb[nt] = Bs[(k0 + tt) * BPITCH + wn + nt * 8 + g];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        dmma(acc[mt][nt][0], acc[mt][nt][1], a[mt], bb[nt]);
  }
}

}  // namespace
}  // namespace gf
