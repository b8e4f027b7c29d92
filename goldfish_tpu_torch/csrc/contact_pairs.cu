// K12 contact_pairs: the shell-shell contact pair potential, its force, its
// Hessian-vector product, its stiffness and its forward design tangent, in
// closed form per qp pair.
//
// Replaces the JAX device programs
//   goldfish_tpu/physics/contact.py: contact_energy (:58) and
//     contact_hessians (:79, jax.hessian: 6C forward-over-reverse passes of
//     the pair energy per patch pair), the gradient of contact_energy inside
//     jax.grad of the total potential (solver/system.py:76), the contact
//     quadrants of assemble_K (system.py:244-257), and the contact part of
//     the residual's jax.jvp in cp (operations/disp_imop.py:68, :134-141).
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
// The work is listed before it runs. A cell is a run of `nc` consecutive
// qps of a patch (an element when nc = Q, as the package calls it); a cell
// pair (k, a, b) holds the nc x nc qp pairs of cell a of patch pa[k] and
// cell b of patch pb[k].
//   cull (gf_contact_cull): one thread per cell computes its bounding box
//     and whether any of its weights is nonzero; then one thread per cell
//     pair, on a grid sized to the card, drops the pair when either cell
//     has only zero weights or the boxes lie more than r_max apart (every
//     qp pair distance is then past the cubic's cutoff, so the pair adds
//     exactly zero); the survivors go into a device list, (k ncell + a)
//     ncell + b, through warp-aggregated atomics on a device counter. The
//     list has room for every cell pair, so it cannot overflow, and the
//     host never reads its length.
//   0 value_grad, 1 hvp: blocks of a fixed grid sized to the card stride
//     over the list (its length read on the device); a block takes
//     max(1, 256 / nc^2) cell pairs at once, one thread per qp pair, row
//     and column sums in shared memory, then f64 atomics into per-qp
//     outputs of both patches:
//     0: G_a += sum_b w_a w_b phi' rhat, G_b -= the same; U_a += sum_b phi
//        w_b, U_b += sum_a phi w_a (U = dW_c/dw, and W_c = 1/2 sum w U);
//     1: for the qp field v, y = H_ab (v_a - v_b): Y_a += sum_b y, Y_b -=
//        sum_a y; t = phi' rhat . (v_a - v_b): T_a += sum_b t w_b, T_b +=
//        sum_a t w_a (T is the w-cotangent of v . dW_c/dx, the cp pullback
//        of the adjoint through the weights);
//     3: the force's tangent along (v, dw) = (dx, dw) of a design change
//        that moves both the qps and their weights: y = H_ab (v_a - v_b) +
//        (dw_a w_b + w_a dw_b) phi' rhat, Y_a += sum_b y, Y_b -= sum_a y
//        (the contact part of the residual's forward tangent in cp; the
//        list depends on x only, so the caller's list of mode 0 serves);
//   2 hess: cells are elements; blocks of a fixed grid stride over the
//     listed element pairs (e_A, e_B): the Q x Q blocks H_ab in shared
//     memory; the own-side sums S_a += sum_b H_ab, S_b += sum_a H_ab (3 x 3
//     per qp, which the caller assembles through K3 as a one-jet group on
//     the R00 rows); and the cross quadrant -R_a^T H_ab R_b of the element
//     pair, added with f64 atomics into the dense K at (gi_A, gi_B) and,
//     transposed, at (gi_B, gi_A), over free dofs only.
// Within a self pair (A == B) the list holds both (e, f) and (f, e), as
// the full double sum does, and the pair of a qp with itself has a
// constant potential and no Hessian: the hess mode leaves it out.
//
// What bounds it on the H100: the f64 operations of the qp pairs within
// r_max (~32 per pair in mode 0, ~55 in mode 1, ~50 plus the 2 * 9 Q L
// (Q + L) of the element-pair product in mode 2) and the per-qp atomics;
// inputs and outputs are a few MB (mode 2 adds K's zero-fill). Until this
// design every cell pair, ~98% of them past the cutoff at the press,
// cost a block launch, its staging and a serial bounding box: 331,776
// blocks of 16 x 16 qps (modes 0, 1) and 1,048,576 element-pair blocks
// (mode 2) at the num_el=32 press. Now the cull costs one thread a cell
// pair, and only listed pairs are staged; a caller that holds (x, w)
// fixed over many hvps (the tangent of one Newton step) builds the list
// once and passes it to each. On an H100 80GB HBM3 (700 W) at that press
// (9705 element pairs listed, chip_smoke.py): the cull 0.016 ms, value
// 0.057 with its cull, hvp on a list 0.034, hess 0.31 with K's zero-fill
// (before: 1.39, 1.41, 3.26): the latency of the list walk and K's bytes
// bound them now, not the pairs' operations (< 0.001 ms).
#include "dual.cuh"

namespace gf {
namespace {

constexpr int WORK_THREADS = 256;  // modes 0 and 1
constexpr int HESS_THREADS = 128;  // mode 2
constexpr int CULL_THREADS = 256;

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
// monotone, so each pair's d2 is at least it), with a relative margin;
// rounded products and sums (no FMA contraction), so that the plain twin
// (contact.candidate_pairs) takes the same decision bit for bit
__device__ inline bool boxes_apart(const double* loa, const double* hia,
                                   const double* lob, const double* hib,
                                   double rmax) {
  double g[3];
  for (int c = 0; c < 3; ++c)
    g[c] = fmax(0.0, fmax(lob[c] - hia[c], loa[c] - hib[c]));
  const double s = __dadd_rn(__dadd_rn(__dmul_rn(g[0], g[0]),
                                       __dmul_rn(g[1], g[1])),
                             __dmul_rn(g[2], g[2]));
  return s > __dmul_rn(__dmul_rn(rmax, rmax), 1.0 + 1e-12);
}

// one thread per cell: its box (lo, hi) and its any-weight flag; zeroes
// the list counter for the cull that follows on the stream
__global__ void cell_box_kernel(const double* __restrict__ x,
                                const double* __restrict__ w, int P, int EQ,
                                int nc, int ncell, double* box, int* flag,
                                int* count) {
  if (blockIdx.x == 0 && threadIdx.x == 0) *count = 0;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= P * ncell) return;
  const int p = c / ncell, q0 = (c % ncell) * nc;
  const size_t off = size_t(p) * EQ + q0;
  double lo[3], hi[3];
  flag[c] = bbox(x + 3 * off, w + off, min(nc, EQ - q0), lo, hi);
  for (int i = 0; i < 3; ++i) {
    box[6 * size_t(c) + i] = lo[i];
    box[6 * size_t(c) + 3 + i] = hi[i];
  }
}

// one thread per cell pair, grid-stride by whole warps; survivors are
// appended with one atomic per warp
__global__ void cull_kernel(const double* __restrict__ box,
                            const int* __restrict__ flag,
                            const int* __restrict__ pa,
                            const int* __restrict__ pb,
                            const double* __restrict__ rmax, int n_pairs,
                            int ncell, int* list, int* count) {
  const long long nn = (long long)ncell * ncell;
  const long long total = nn * n_pairs;
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long base = (long long)blockIdx.x * blockDim.x +
                        (threadIdx.x & ~31);
       base < total; base += stride) {
    const long long i = base + lane;
    bool keep = false;
    if (i < total) {
      const int k = int(i / nn);
      const int rem = int(i - k * nn);
      const int ca = pa[k] * ncell + rem / ncell;
      const int cb = pb[k] * ncell + rem % ncell;
      if (flag[ca] && flag[cb]) {
        const double* ba = box + 6 * size_t(ca);
        const double* bb = box + 6 * size_t(cb);
        keep = !boxes_apart(ba, ba + 3, bb, bb + 3, rmax[k]);
      }
    }
    const unsigned m = __ballot_sync(0xffffffffu, keep);
    if (m == 0u) continue;
    int off = 0;
    if (lane == 0) off = atomicAdd(count, __popc(m));
    off = __shfl_sync(0xffffffffu, off, 0);
    if (keep) list[off + __popc(m & ((1u << lane) - 1u))] = int(i);
  }
}

// doubles of shared memory a cell pair of modes 0, 1 and 3 takes: x, w, v
// (and dw in mode 3) of both cells, and nc^2 x 5 pair terms
__host__ __device__ constexpr int list_slot(int mode, int nc) {
  return (mode == 3 ? 16 : 14) * nc + 5 * nc * nc;
}

// modes 0, 1 and 3 over the listed cell pairs; `per` cell pairs a block
// at once, each on WORK_THREADS / per threads
template <int MODE>
__global__ void pair_list_kernel(const double* __restrict__ x,
                                 const double* __restrict__ w,
                                 const double* __restrict__ v,
                                 const double* __restrict__ dw,
                                 const int* __restrict__ pa,
                                 const int* __restrict__ pb,
                                 const double* __restrict__ kpen,
                                 const double* __restrict__ rmax,
                                 const int* __restrict__ list,
                                 const int* __restrict__ count, int EQ,
                                 int nc, int ncell, int per, double* vec,
                                 double* scal, int* active) {
  extern __shared__ double sm[];
  const int n = *count;
  if (active != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    atomicAdd(active, n);
  const int tps = blockDim.x / per;
  const int slot = threadIdx.x / tps, lt = threadIdx.x % tps;
  const int nn = nc * nc;
  double* sx = sm + size_t(min(slot, per - 1)) * list_slot(MODE, nc);
  double* sw = sx + 6 * nc;  // 2 x nc (A, B)
  double* sv = sw + 2 * nc;  // 2 x 3 nc
  double* sh = sv + 6 * nc;  // nc x nc x 5
  double* sd = sh + 5 * nn;  // 2 x nc (mode 3: dw)
  for (int base = blockIdx.x * per; base < n; base += gridDim.x * per) {
    const int e = base + slot;
    const bool live = slot < per && e < n;
    int A = 0, B = 0, a0 = 0, b0 = 0, na = 0, nb = 0;
    double kk = 0.0, rm = 0.0;
    if (live) {
      const int i = list[e];
      const int k = i / (ncell * ncell);
      const int rem = i - k * (ncell * ncell);
      A = pa[k];
      B = pb[k];
      kk = kpen[k];
      rm = rmax[k];
      a0 = (rem / ncell) * nc;
      b0 = (rem % ncell) * nc;
      na = min(nc, EQ - a0);
      nb = min(nc, EQ - b0);
      for (int t = lt; t < 2 * nc; t += tps) {
        const int side = t / nc, j = t % nc;
        const int ns = side ? nb : na;
        const size_t q = size_t(side ? B : A) * EQ + (side ? b0 : a0) +
                         (j < ns ? j : 0);
        for (int c = 0; c < 3; ++c) {
          sx[3 * t + c] = x[3 * q + c];
          if (MODE != 0) sv[3 * t + c] = v[3 * q + c];
        }
        sw[t] = j < ns ? w[q] : 0.0;
        if (MODE == 3) sd[t] = j < ns ? dw[q] : 0.0;
      }
    }
    __syncthreads();
    if (live) {
      for (int p = lt; p < nn; p += tps) {
        const int ia = p / nc, ib = nc + p % nc;
        double loc[5] = {0.0, 0.0, 0.0, 0.0, 0.0};
        const double wa = sw[ia], wb = sw[ib];
        double dx[3];
        for (int c = 0; c < 3; ++c) dx[c] = sx[3 * ia + c] - sx[3 * ib + c];
        double r, phi, dphi, ddphi;
        if (wa * wb != 0.0 && pair_pot(dx, kk, rm, r, phi, dphi, ddphi)) {
          if (MODE == 0) {
            const double c = wa * wb * dphi / r;
            for (int i = 0; i < 3; ++i) loc[i] = c * dx[i];
            loc[3] = phi * wb;
            loc[4] = phi * wa;
          } else if (MODE == 3) {
            // a qp with itself (r ~ 1e-15, dx = dv = 0) adds exactly 0
            double rh[3], dv[3];
            for (int i = 0; i < 3; ++i) {
              rh[i] = dx[i] / r;
              dv[i] = sv[3 * ia + i] - sv[3 * ib + i];
            }
            const double s = (rh[0] * dv[0] + rh[1] * dv[1]) + rh[2] * dv[2];
            const double ww = wa * wb;
            const double t = dphi / r;
            const double cw = (sd[ia] * wb + wa * sd[ib]) * t;
            for (int i = 0; i < 3; ++i)
              loc[i] = ww * (ddphi * s * rh[i] + t * (dv[i] - s * rh[i])) +
                       cw * dx[i];
          } else {
            double rh[3], dv[3];
            for (int i = 0; i < 3; ++i) {
              rh[i] = dx[i] / r;
              dv[i] = sv[3 * ia + i] - sv[3 * ib + i];
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
        for (int c = 0; c < 5; ++c) sh[5 * p + c] = loc[c];
      }
    }
    __syncthreads();
    // 4 nc row tasks (qps of cell a x {3 vector comps, scalar}) and 4 nc
    // column tasks (qps of cell b)
    if (live) {
      for (int t = lt; t < 8 * nc; t += tps) {
        const bool col = t >= 4 * nc;
        const int i = (col ? t - 4 * nc : t) / 4, c = t % 4;
        if (i >= (col ? nb : na) || (MODE == 3 && c == 3)) continue;
        double s = 0.0;
        if (col)
          for (int j = 0; j < nc; ++j)
            s += sh[5 * (j * nc + i) + (c < 3 ? c : 4)];
        else
          for (int j = 0; j < nc; ++j) s += sh[5 * (i * nc + j) + c];
        if (s == 0.0) continue;
        const size_t q =
            col ? size_t(B) * EQ + b0 + i : size_t(A) * EQ + a0 + i;
        atomicAdd(c < 3 ? vec + 3 * q + c : scal + q,
                  (col && c < 3) ? -s : s);
      }
    }
    __syncthreads();
  }
}

// mode 2 over the listed element pairs
__global__ void pair_hess_kernel(const double* __restrict__ x,
                                 const double* __restrict__ w,
                                 const double* __restrict__ R,
                                 const int* __restrict__ gi,
                                 const double* __restrict__ free_,
                                 const int* __restrict__ pa,
                                 const int* __restrict__ pb,
                                 const double* __restrict__ kpen,
                                 const double* __restrict__ rmax,
                                 const int* __restrict__ list,
                                 const int* __restrict__ count, int E,
                                 int Q, int L, long long ndof, double* S,
                                 double* K, int* active) {
  extern __shared__ double sm[];
  const int n = *count;
  if (active != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    atomicAdd(active, n);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int QL = Q * L, L3 = 3 * L, EE = E * E;
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
  for (int it = blockIdx.x; it < n; it += gridDim.x) {
    const int i = list[it];
    const int k = i / EE;
    const int rem = i - k * EE;
    const int A = pa[k], B = pb[k];
    const int eA = rem / E, eB = rem % E;
    const double kk = kpen[k], rm = rmax[k];
    const size_t gA = size_t(A) * E + eA, gB = size_t(B) * E + eB;
    __syncthreads();  // the previous pair's readers are done
    for (int j = tid; j < 3 * Q; j += nt) {
      sxa[j] = x[gA * 3 * Q + j];
      sxb[j] = x[gB * 3 * Q + j];
    }
    for (int j = tid; j < Q; j += nt) {
      swa[j] = w[gA * Q + j];
      swb[j] = w[gB * Q + j];
    }
    for (int j = tid; j < QL; j += nt) {
      sRa[j] = R[gA * QL + j];
      sRb[j] = R[gB * QL + j];
    }
    for (int j = tid; j < L3; j += nt) {
      sga[j] = gi[gA * L3 + j];
      sgb[j] = gi[gB * L3 + j];
    }
    __syncthreads();

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
        for (int a = 0; a < 3; ++a)
          for (int b = 0; b < 3; ++b)
            h[3 * a + b] = ww * ((ddphi - t) * rh[a] * rh[b] +
                                 (a == b ? t : 0.0));
      }
    }
    __syncthreads();
    // own-side sums: 9 Q row tasks (qps of e_A) and 9 Q column tasks (e_B)
    for (int tk = tid; tk < 18 * Q; tk += nt) {
      const int side = tk / (9 * Q), q = (tk % (9 * Q)) / 9, c = tk % 9;
      double s = 0.0;
      for (int j = 0; j < Q; ++j)
        s += side ? sH[9 * (j * Q + q) + c] : sH[9 * (q * Q + j) + c];
      if (s != 0.0)
        atomicAdd(S + ((side ? gB : gA) * Q + q) * 9 + c, s);
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
}

// blocks of a grid sized to the card: `per_sm` resident blocks on each SM
int card_grid(int per_sm) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms * per_sm;
}

cudaError_t allow_smem(const void* fn, size_t smem) {
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              int(smem));
}

}  // namespace
}  // namespace gf

// The cull: cells of nc consecutive qps (ncell = ceil(EQ / nc) a patch);
// box (P ncell 6) and flag (P ncell) are scratch; list (n_pairs ncell^2)
// and count (1) receive the cell pairs that may hold a qp pair within
// r_max, (k ncell + a) ncell + b, in no particular order.
extern "C" int gf_contact_cull(const double* x, const double* w,
                               const int* pa, const int* pb,
                               const double* rmax, double* box, int* flag,
                               int* list, int* count, int n_pairs, int P,
                               int EQ, int nc, void* stream) {
  using namespace gf;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nc <= 0 || EQ <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int ncell = (EQ + nc - 1) / nc;
  const int cells = P * ncell;
  cell_box_kernel<<<(cells + 127) / 128, 128, 0, st>>>(x, w, P, EQ, nc,
                                                       ncell, box, flag,
                                                       count);
  int rc = launch_status();
  if (rc != 0 || n_pairs == 0) return rc;
  const long long total = (long long)ncell * ncell * n_pairs;
  const long long need = (total + CULL_THREADS - 1) / CULL_THREADS;
  const int cap = card_grid(8);
  const int grid = need < cap ? int(need) : cap;
  cull_kernel<<<grid, CULL_THREADS, 0, st>>>(box, flag, pa, pb, rmax,
                                             n_pairs, ncell, list, count);
  return launch_status();
}

// The work on a cull's list. mode 0: vec = G (P, EQ, 3), scal = U (P, EQ);
// mode 1: vec = Y, scal = T, from the qp field v; mode 3: vec = the force's
// tangent along (v, dw) (P, EQ, 3), scal unused; cells of nc qps, ncell a
// patch. mode 2: cells are elements (ncell = E, nc = Q, EQ = E Q): S (P,
// E Q, 9) and the cross quadrants into K (N, N). Outputs are zeroed (S,
// vec, scal) or hold the rest of K on entry. `active` (optional) gains the
// list's length: the cell pairs that ran.
extern "C" int gf_contact_pairs(int mode, const double* x, const double* w,
                                const double* v, const double* dw,
                                const int* pa,
                                const int* pb, const double* kpen,
                                const double* rmax, const double* R,
                                const int* gi, const double* free_,
                                double* vec, double* scal, double* S,
                                double* K, const int* list, const int* count,
                                int* active, int n_pairs, int ncell, int nc,
                                int EQ, int L, long long ndof, void* stream) {
  using namespace gf;
  if (n_pairs == 0 || ncell == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == 0 || mode == 1 || mode == 3) {
    const int nn = nc * nc;
    const int per = nn >= WORK_THREADS ? 1 : WORK_THREADS / nn;
    const size_t smem = size_t(per) * list_slot(mode, nc) * sizeof(double);
    const void* fn =
        mode == 0   ? reinterpret_cast<const void*>(pair_list_kernel<0>)
        : mode == 1 ? reinterpret_cast<const void*>(pair_list_kernel<1>)
                    : reinterpret_cast<const void*>(pair_list_kernel<3>);
    cudaError_t e = allow_smem(fn, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int grid = card_grid(4);
    if (mode == 0)
      pair_list_kernel<0><<<grid, WORK_THREADS, smem, st>>>(
          x, w, v, dw, pa, pb, kpen, rmax, list, count, EQ, nc, ncell, per,
          vec, scal, active);
    else if (mode == 1)
      pair_list_kernel<1><<<grid, WORK_THREADS, smem, st>>>(
          x, w, v, dw, pa, pb, kpen, rmax, list, count, EQ, nc, ncell, per,
          vec, scal, active);
    else
      pair_list_kernel<3><<<grid, WORK_THREADS, smem, st>>>(
          x, w, v, dw, pa, pb, kpen, rmax, list, count, EQ, nc, ncell, per,
          vec, scal, active);
    return launch_status();
  }
  if (mode != 2) return static_cast<int>(cudaErrorInvalidValue);
  const int Q = nc, E = ncell;
  const size_t smem = (size_t(8) * Q + 2 * size_t(Q) * L + 9 * size_t(Q) * Q +
                       9 * size_t(Q) * L) * sizeof(double) +
                      6 * size_t(L) * sizeof(int);
  cudaError_t e = allow_smem(reinterpret_cast<const void*>(pair_hess_kernel),
                             smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  pair_hess_kernel<<<card_grid(8), HESS_THREADS, smem, st>>>(
      x, w, R, gi, free_, pa, pb, kpen, rmax, list, count, E, Q, L, ndof, S,
      K, active);
  return launch_status();
}
