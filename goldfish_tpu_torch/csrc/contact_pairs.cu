// K12 contact_pairs: the shell-shell contact pair potential, its force, its
// Hessian-vector product and its stiffness, in closed form per qp pair.
//
// Replaces the JAX device programs
//   goldfish_tpu/physics/contact.py: contact_energy (:58) and
//     contact_hessians (:79, jax.hessian: 6C forward-over-reverse passes of
//     the pair energy per patch pair), the gradient of contact_energy inside
//     jax.grad of the total potential (solver/system.py:76), and the contact
//     quadrants of assemble_K (system.py:244-257).
//
// For a patch pair (A, B) with deformed qp positions x (cp + d on the R00
// rows) and weights w = |X_u x X_v| wq (0 on padded qps):
//   W_c = sum_{a in A, b in B} phi(r_ab) w_a w_b,
//   phi(r) = k/6 (r_max - r)^3_+, phi' = -k/2 (r_max - r)^2,
//   phi'' = k (r_max - r), r = sqrt(|x_a - x_b|^2 + 1e-30) (the JAX
//   regularization), rhat = (x_a - x_b) / r,
//   H_ab = w_a w_b [phi'' rhat rhat^T + (phi'/r)(I - rhat rhat^T)]
// (d^2 W / dx_a^2 of the pair; d^2 / dx_b^2 is the same block and the mixed
// block is -H_ab).
//
// Modes:
//   0 value_grad, 1 hvp: a 16 x 16 tile of (qp a, qp b) per block, one
//     thread per pair, row and column sums in shared memory, then f64
//     atomics into per-qp outputs of both patches:
//     0: G_a += sum_b w_a w_b phi' rhat, G_b -= the same; U_a += sum_b phi
//        w_b, U_b += sum_a phi w_a (U = dW_c/dw, and W_c = 1/2 sum w U);
//     1: for the qp field v, y = H_ab (v_a - v_b): Y_a += sum_b y, Y_b -=
//        sum_a y; t = phi' rhat . (v_a - v_b): T_a += sum_b t w_b, T_b +=
//        sum_a t w_a (T is the w-cotangent of v . dW_c/dx, the cp pullback
//        of the adjoint through the weights);
//   2 hess: one block per element pair (e_A, e_B): the Q x Q blocks H_ab in
//     shared memory; the own-side sums S_a += sum_b H_ab, S_b += sum_a H_ab
//     (3 x 3 per qp, which the caller assembles through K3 as a one-jet
//     group on the R00 rows); and the cross quadrant -R_a^T H_ab R_b of the
//     element pair, added with f64 atomics into the dense K at (gi_A, gi_B)
//     and, transposed, at (gi_B, gi_A), over free dofs only.
// A tile or element pair whose bounding boxes lie more than r_max apart
// contributes exactly zero (every pair distance is then past the cubic's
// cutoff) and is skipped; so is one whose weights are all zero. Within a
// self pair (A == B) the pair of a qp with itself has a constant potential
// and no Hessian; the hess mode leaves it out.
//
// What bounds it on the H100: the f64 operations of the pairs within r_max
// (~40 per pair in mode 0, ~60 in mode 1, ~20 plus the 2 Q L^2 9 of the
// element-pair product in mode 2); inputs and outputs are a few MB. Skipped
// tiles still cost a block launch and a bounding box each.
#include "dual.cuh"

namespace gf {
namespace {

constexpr int CT = 16;  // qps per tile side (modes 0 and 1)

// phi, phi', phi'' at the pair separation dx; false past the cutoff
__device__ inline bool pair_pot(const double* dx, double k, double rmax,
                                double& r, double& phi, double& dphi,
                                double& ddphi) {
  const double d2 = (dx[0] * dx[0] + dx[1] * dx[1]) + dx[2] * dx[2];
  r = sqrt(d2 + 1e-30);
  const double gap = rmax - r;
  if (!(gap > 0.0)) return false;
  phi = (k / 6.0) * gap * gap * gap;
  dphi = -0.5 * k * gap * gap;
  ddphi = k * gap;
  return true;
}

// bounding box of n points (x: n x 3) and whether any weight is nonzero
__device__ inline bool bbox(const double* x, const double* w, int n,
                            double* lo, double* hi) {
  bool any = false;
  for (int c = 0; c < 3; ++c) {
    lo[c] = x[c];
    hi[c] = x[c];
  }
  for (int i = 0; i < n; ++i) {
    any = any || (w[i] != 0.0);
    for (int c = 0; c < 3; ++c) {
      lo[c] = fmin(lo[c], x[3 * i + c]);
      hi[c] = fmax(hi[c], x[3 * i + c]);
    }
  }
  return any;
}

// true when every pair between the boxes is past the cutoff: the squared
// box distance is summed in the order of pair_pot's d2 (rounding is
// monotone, so each pair's d2 is at least it), with a relative margin
__device__ inline bool boxes_apart(const double* loa, const double* hia,
                                   const double* lob, const double* hib,
                                   double rmax) {
  double g[3];
  for (int c = 0; c < 3; ++c)
    g[c] = fmax(0.0, fmax(lob[c] - hia[c], loa[c] - hib[c]));
  const double s = (g[0] * g[0] + g[1] * g[1]) + g[2] * g[2];
  return s > rmax * rmax * (1.0 + 1e-12);
}

template <int MODE>
__global__ void pair_tile_kernel(const double* __restrict__ x,
                                 const double* __restrict__ w,
                                 const double* __restrict__ v,
                                 const int* __restrict__ pa,
                                 const int* __restrict__ pb,
                                 const double* __restrict__ kpen,
                                 const double* __restrict__ rmax, int EQ,
                                 double* vec, double* scal, int* active) {
  __shared__ double sx[2][CT * 3], sw[2][CT], sv[2][CT * 3];
  __shared__ double sh[CT][CT][5];
  __shared__ int skip;
  const int k = blockIdx.z;
  const int A = pa[k], B = pb[k];
  const double kk = kpen[k], rm = rmax[k];
  const int tx = threadIdx.x, ty = threadIdx.y;  // tx: qp of B, ty: of A
  const int tid = ty * CT + tx;
  const int a0 = blockIdx.y * CT, b0 = blockIdx.x * CT;
  const int na = min(CT, EQ - a0), nb = min(CT, EQ - b0);
  if (tid < 2 * CT) {
    const int side = tid / CT, i = tid % CT;
    const int n = side ? nb : na;
    const size_t q = size_t(side ? B : A) * EQ + (side ? b0 : a0) +
                     (i < n ? i : 0);
    for (int c = 0; c < 3; ++c) {
      sx[side][3 * i + c] = x[3 * q + c];
      if (MODE == 1) sv[side][3 * i + c] = v[3 * q + c];
    }
    sw[side][i] = i < n ? w[q] : 0.0;
  }
  __syncthreads();
  if (tid == 0) {
    double loa[3], hia[3], lob[3], hib[3];
    const bool wa = bbox(sx[0], sw[0], na, loa, hia);
    const bool wb = bbox(sx[1], sw[1], nb, lob, hib);
    skip = !wa || !wb || boxes_apart(loa, hia, lob, hib, rm);
    if (!skip && active != nullptr) atomicAdd(active, 1);
  }
  __syncthreads();
  if (skip) return;  // uniform over the block

  double loc[5] = {0.0, 0.0, 0.0, 0.0, 0.0};
  const double wa = sw[0][ty], wb = sw[1][tx];
  double dx[3];
  for (int c = 0; c < 3; ++c) dx[c] = sx[0][3 * ty + c] - sx[1][3 * tx + c];
  double r, phi, dphi, ddphi;
  if (wa * wb != 0.0 && pair_pot(dx, kk, rm, r, phi, dphi, ddphi)) {
    if (MODE == 0) {
      const double c = wa * wb * dphi / r;
      for (int i = 0; i < 3; ++i) loc[i] = c * dx[i];
      loc[3] = phi * wb;
      loc[4] = phi * wa;
    } else {
      double rh[3], dv[3];
      for (int i = 0; i < 3; ++i) {
        rh[i] = dx[i] / r;
        dv[i] = sv[0][3 * ty + i] - sv[1][3 * tx + i];
      }
      const double s = (rh[0] * dv[0] + rh[1] * dv[1]) + rh[2] * dv[2];
      const double ww = wa * wb;
      const double t = dphi / r;
      for (int i = 0; i < 3; ++i)
        loc[i] = ww * (ddphi * s * rh[i] + t * (dv[i] - s * rh[i]));
      loc[3] = dphi * s * wb;
      loc[4] = dphi * s * wa;
    }
  }
  for (int i = 0; i < 5; ++i) sh[ty][tx][i] = loc[i];
  __syncthreads();
  // 64 row tasks (16 qps of A x {3 vector comps, scalar}) and 64 column
  // tasks (16 qps of B), one per thread
  if (tid < 4 * CT) {
    const int i = tid / 4, c = tid % 4;
    if (i < na) {
      double s = 0.0;
      for (int j = 0; j < CT; ++j) s += sh[i][j][c];
      const size_t q = size_t(A) * EQ + a0 + i;
      if (s != 0.0) atomicAdd(c < 3 ? vec + 3 * q + c : scal + q, s);
    }
  } else if (tid < 8 * CT) {
    const int i = (tid - 4 * CT) / 4, c = (tid - 4 * CT) % 4;
    if (i < nb) {
      double s = 0.0;
      for (int j = 0; j < CT; ++j) s += sh[j][i][c < 3 ? c : 4];
      const size_t q = size_t(B) * EQ + b0 + i;
      if (s != 0.0) atomicAdd(c < 3 ? vec + 3 * q + c : scal + q,
                              c < 3 ? -s : s);
    }
  }
}

__global__ void pair_hess_kernel(const double* __restrict__ x,
                                 const double* __restrict__ w,
                                 const double* __restrict__ R,
                                 const int* __restrict__ gi,
                                 const double* __restrict__ free_,
                                 const int* __restrict__ pa,
                                 const int* __restrict__ pb,
                                 const double* __restrict__ kpen,
                                 const double* __restrict__ rmax, int E,
                                 int Q, int L, long long ndof, double* S,
                                 double* K, int* active) {
  extern __shared__ double sm[];
  __shared__ int skip;
  const int k = blockIdx.z;
  const int A = pa[k], B = pb[k];
  const int eA = blockIdx.y, eB = blockIdx.x;
  const double kk = kpen[k], rm = rmax[k];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int QL = Q * L, L3 = 3 * L;
  double* sxa = sm;             // Q x 3
  double* sxb = sxa + 3 * Q;    // Q x 3
  double* swa = sxb + 3 * Q;    // Q
  double* swb = swa + Q;        // Q
  double* sRa = swb + Q;        // Q x L
  double* sRb = sRa + QL;       // Q x L
  double* sH = sRb + QL;        // Q x Q x 9
  double* sT = sH + 9 * Q * Q;  // Q x L x 9
  int* sga = reinterpret_cast<int*>(sT + 9 * QL);  // 3L
  int* sgb = sga + L3;                             // 3L
  const size_t gA = size_t(A) * E + eA, gB = size_t(B) * E + eB;
  for (int i = tid; i < 3 * Q; i += nt) {
    sxa[i] = x[gA * 3 * Q + i];
    sxb[i] = x[gB * 3 * Q + i];
  }
  for (int i = tid; i < Q; i += nt) {
    swa[i] = w[gA * Q + i];
    swb[i] = w[gB * Q + i];
  }
  for (int i = tid; i < QL; i += nt) {
    sRa[i] = R[gA * QL + i];
    sRb[i] = R[gB * QL + i];
  }
  for (int i = tid; i < L3; i += nt) {
    sga[i] = gi[gA * L3 + i];
    sgb[i] = gi[gB * L3 + i];
  }
  __syncthreads();
  if (tid == 0) {
    double loa[3], hia[3], lob[3], hib[3];
    const bool wa = bbox(sxa, swa, Q, loa, hia);
    const bool wb = bbox(sxb, swb, Q, lob, hib);
    skip = !wa || !wb || boxes_apart(loa, hia, lob, hib, rm);
    if (!skip && active != nullptr) atomicAdd(active, 1);
  }
  __syncthreads();
  if (skip) return;  // uniform over the block

  const bool self = (A == B) && (eA == eB);
  for (int p = tid; p < Q * Q; p += nt) {
    const int qa = p / Q, qb = p % Q;
    double* h = sH + 9 * p;
    for (int c = 0; c < 9; ++c) h[c] = 0.0;
    const double ww = swa[qa] * swb[qb];
    double dx[3];
    for (int c = 0; c < 3; ++c) dx[c] = sxa[3 * qa + c] - sxb[3 * qb + c];
    double r, phi, dphi, ddphi;
    if (ww != 0.0 && !(self && qa == qb) &&
        pair_pot(dx, kk, rm, r, phi, dphi, ddphi)) {
      double rh[3];
      for (int c = 0; c < 3; ++c) rh[c] = dx[c] / r;
      const double t = dphi / r;
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j)
          h[3 * i + j] = ww * ((ddphi - t) * rh[i] * rh[j] +
                               (i == j ? t : 0.0));
    }
  }
  __syncthreads();
  // own-side sums: 9 Q row tasks (qps of e_A) and 9 Q column tasks (e_B)
  for (int tk = tid; tk < 18 * Q; tk += nt) {
    const int side = tk / (9 * Q), i = (tk % (9 * Q)) / 9, c = tk % 9;
    double s = 0.0;
    for (int j = 0; j < Q; ++j)
      s += side ? sH[9 * (j * Q + i) + c] : sH[9 * (i * Q + j) + c];
    if (s != 0.0)
      atomicAdd(S + ((side ? gB : gA) * Q + i) * 9 + c, s);
  }
  // T[qa, m] = sum_qb H_ab R_b[qb, m]
  for (int tk = tid; tk < 9 * QL; tk += nt) {
    const int qa = tk / (9 * L), m = (tk / 9) % L, c = tk % 9;
    double s = 0.0;
    for (int qb = 0; qb < Q; ++qb)
      s += sH[9 * (qa * Q + qb) + c] * sRb[qb * L + m];
    sT[tk] = s;
  }
  __syncthreads();
  // the cross quadrant -sum_qa R_a[qa, l] T[qa, m] and its transpose
  for (int tk = tid; tk < 9 * L * L; tk += nt) {
    const int l = tk / (9 * L), m = (tk / 9) % L, c = tk % 9;
    double s = 0.0;
    for (int qa = 0; qa < Q; ++qa)
      s += sRa[qa * L + l] * sT[(qa * L + m) * 9 + c];
    if (s == 0.0) continue;
    const int ga = sga[3 * l + c / 3], gb = sgb[3 * m + c % 3];
    if (free_[ga] == 0.0 || free_[gb] == 0.0) continue;
    atomicAdd(K + size_t(ga) * ndof + gb, -s);
    atomicAdd(K + size_t(gb) * ndof + ga, -s);
  }
}

}  // namespace
}  // namespace gf

// mode 0: vec = G (P, EQ, 3), scal = U (P, EQ); mode 1: vec = Y, scal = T,
// from the qp field v; mode 2: S (P, E Q, 9) and the cross quadrants into K
// (N, N). Outputs are zeroed (S, vec, scal) or hold the rest of K on entry.
// `active` (optional) counts the blocks that were not skipped.
extern "C" int gf_contact_pairs(int mode, const double* x, const double* w,
                                const double* v, const int* pa,
                                const int* pb, const double* kpen,
                                const double* rmax, const double* R,
                                const int* gi, const double* free_,
                                double* vec, double* scal, double* S,
                                double* K, int* active, int n_pairs, int E,
                                int Q, int L, long long ndof, void* stream) {
  using namespace gf;
  if (n_pairs == 0 || E == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == 0 || mode == 1) {
    const int EQ = E * Q;
    const dim3 block(CT, CT);
    const dim3 grid((EQ + CT - 1) / CT, (EQ + CT - 1) / CT, n_pairs);
    if (mode == 0)
      pair_tile_kernel<0><<<grid, block, 0, st>>>(x, w, v, pa, pb, kpen, rmax,
                                                  EQ, vec, scal, active);
    else
      pair_tile_kernel<1><<<grid, block, 0, st>>>(x, w, v, pa, pb, kpen, rmax,
                                                  EQ, vec, scal, active);
    return launch_status();
  }
  const size_t smem = (size_t(8) * Q + 2 * size_t(Q) * L + 9 * size_t(Q) * Q +
                       9 * size_t(Q) * L) * sizeof(double) +
                      6 * size_t(L) * sizeof(int);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        pair_hess_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(E, E, n_pairs);
  pair_hess_kernel<<<grid, 128, smem, st>>>(x, w, R, gi, free_, pa, pb, kpen,
                                            rmax, E, Q, L, ndof, S, K, active);
  return launch_status();
}
