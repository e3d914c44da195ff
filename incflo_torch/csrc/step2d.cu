// The whole time step of a 2D, fully periodic, constant-density MOL deck
// (the tgv2d class) as ONE cooperative kernel launch, for NVIDIA Hopper
// (sm_90a).  Plain C interface, bound from incflo_torch/ops/
// step2d_kernels.py with ctypes:
//
//   step2d_launch  replaces incflo_tpu/ops/pallas_step2d.py:
//                  FusedStep._kernel (:501, pallas_call at :563), which
//                  evaluates Simulation._advance_impl in one Pallas program
//
// What it computes: one call of the plain step, step2d_kernels.step_plain
// (Simulation._advance_impl with the fixed-trip tensor CG):
//   compute_dt  (a max reduction, then the scalar rules of
//               incflo_tpu/simulation.py:146-222)
//   predictor   MOL face velocities (MC slopes, upwind select), the MAC
//               projection (divergence, direct solve, face-gradient
//               correction), upwind fluxes and the convective rate, the
//               velocity update, the implicit (or Crank-Nicolson) tensor
//               velocity solve: one direct solve of the anisotropic
//               Helmholtz operator, then up to `trips` CG trips on the
//               cross coupling, each an operator apply, two dots, a
//               max-norm and a direct preconditioner solve; the nodal
//               projection (nodal divergence, direct solve with the
//               mask-form zero mode, the gp/p update)
//   corrector   the same pieces on the predicted state, with the two
//               convective terms averaged.
// Every direct solve is a fast diagonalization with per-axis n x n
// transforms h'[k] = sum_j m[k,j] h[j]; this kernel computes them with its
// own threads, one output element per thread, a dot of length n.
//
// Design.  The Pallas kernel holds the ~2.6 MB working set in VMEM and
// evaluates the step's jaxpr in struct-of-arrays form; its Tup splitting,
// unit reshapes, one-hot component stacks and per-component contractions
// answer Mosaic's vector layouts and have no counterpart here.  On Hopper
// the working set (about 25 arrays of n cells) sits in the 50 MB L2, and
// the step is a sequence of grid-stride phases over cells separated by
// grid-wide barriers (cooperative_groups::this_grid().sync()).  A thread
// owns the same cells in every phase, so an elementwise phase that only
// reads what the same thread wrote needs no barrier; a stencil or a
// transform reads other threads' cells and needs one.
//
// Reductions are deterministic and uniform: each block writes its partial
// to a fixed slot, and after the barrier every block combines all
// partials in the same fixed order, so every thread holds bit-identical
// dt, alpha, beta and the CG's live / improved flags and all blocks take
// the same branch.  No float atomics.  A CG trip whose live flag is false
// changes nothing (the masked form of incflo_tpu/ops/diffusion.py:
// 640-661), so the loop ends at the first such trip.
//
// What bounds it on an H100: the grid barriers (46 + 7 per CG trip per
// step; counted and returned) and the latency of the transforms' length-n
// dots.  The bytes (the state read once and written once, 0.7 MB at 128^2
// f32) would take 0.2 us and the operations (0.28 GFLOP, nearly all in
// the transforms) 4 us.  Elementwise parts repeat the
// plain version's operation order and are built without FMA contraction,
// so they round as it does; the reductions sum in another order than
// torch.sum, and the transforms' dots accumulate in double (contract0).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 8;
// partial-sum slots: each reduction has its own, and between the read of
// a slot and its next write there is always a barrier
enum Slot { kConvCfl, kForcCfl, kRhoInv, kMean, kRhsMax, kResMax, kDotRZ,
            kDotPAp };

// pointer table shared with ops/step2d_kernels.py (PTR_NAMES)
enum Ptr {
  // inputs: the state and its scalars
  P_VEL, P_RHO, P_GP, P_T, P_DT, P_PREV_DT, P_PREV_PREV_DT, P_STEP,
  // MAC symbol: axis-0 forward / inverse, axis-1 forward / inverse
  // (transposed), eigenvalues
  P_MF0, P_MV0, P_MF1T, P_MV1T, P_MLAM,
  // velocity Helmholtz symbol (two components), and its constant acoef
  P_DF0, P_DV0, P_DF1T, P_DV1T, P_DLAM, P_DA0,
  // nodal symbol
  P_NF0, P_NV0, P_NF1T, P_NV1T, P_NLAM,
  // outputs
  P_VEL_OUT, P_GP_OUT, P_P_OUT, P_MACPHI_OUT, P_SCAL_OUT, P_STEP_OUT,
  P_CG_OUT, P_DIAG_OUT,
  // workspace: cell fields (1 = n cells, 2 = 2n)
  W_UMAC0, W_UMAC1, W_PHI, W_SRHS, W_H1, W_H2, W_RHS, W_X, W_R, W_P, W_Z,
  W_XB, W_AP, W_CONV, W_DTAU, W_VSTAR, W_GPSTAR, W_PSTAR, W_VPROJ, W_VIN,
  W_PART,
  NPTR
};

// double parameters (FPAR_NAMES), cast to T as torch casts a Python float
enum FPar {
  F_DX0, F_DX1, F_DXI0, F_DXI1, F_TWO_CFL, F_CFL, F_MU, F_FALLBACK,
  F_PER, F_STOP, F_FIXED, F_RTOL, F_ATOL, F_GP00, F_GP01, F_G0, F_G1,
  F_MACB0, F_MACB1, F_DACOEF, F_DB00, F_DB01, F_DB10, F_DB11,
  NFPAR
};

// int parameters (IPAR_NAMES)
enum IPar { I_NX, I_NY, I_CN, I_TENSOR, I_TCORR, I_TRIPS, I_PPE, I_STOPON,
            I_FIXEDON, NIPAR };

template <typename T>
struct Args {
  int nx, ny, nblk;
  int cn, tensor, tcorr, trips, ppe, stop_on, fixed_on;
  T dx0, dx1, dxi0, dxi1, two_cfl, cfl, mu, fallback, per, stop_time,
      fixed_dt, rtol, atol, gp0[2], grav[2], macb[2], dacoef, db[2][2];
  void* p[NPTR];
};

template <typename T> struct Lim;
template <> struct Lim<float> { static constexpr float eps = FLT_EPSILON; };
template <> struct Lim<double> { static constexpr double eps = DBL_EPSILON; };

__device__ __forceinline__ int wrap(int i, int n) {
  return i < 0 ? i + n : (i >= n ? i - n : i);
}

template <typename T> __device__ __forceinline__ T tmin(T a, T b) {
  return a < b ? a : b;
}
template <typename T> __device__ __forceinline__ T tmax(T a, T b) {
  return a > b ? a : b;
}

template <typename T> __device__ __forceinline__ T warp_sum(T v) {
  for (int o = 16; o > 0; o >>= 1) v = v + __shfl_down_sync(0xffffffffu, v, o);
  return v;
}
template <typename T> __device__ __forceinline__ T warp_max(T v) {
  for (int o = 16; o > 0; o >>= 1) v = tmax(v, __shfl_down_sync(0xffffffffu, v, o));
  return v;
}

// The block's partial of v (sum or max) into part[slot][blockIdx.x].
template <typename T, bool MAX>
__device__ void block_partial(T v, T* part, int slot, int nblk, T* sm) {
  v = MAX ? warp_max(v) : warp_sum(v);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) sm[w] = v;
  __syncthreads();
  if (w == 0) {
    T u = lane < kWarps ? sm[lane] : T(0);
    u = MAX ? warp_max(u) : warp_sum(u);
    if (lane == 0) part[slot * nblk + blockIdx.x] = u;
  }
}

// All partials of a slot combined in one fixed order: the same value in
// every thread of every block.
template <typename T, bool MAX>
__device__ T finish(const T* part, int slot, int nblk, T* sm) {
  __syncthreads();
  if (threadIdx.x < 32) {
    T v = T(0);
    for (int b = threadIdx.x; b < nblk; b += 32) {
      const T q = __ldcg(part + slot * nblk + b);
      v = MAX ? tmax(v, q) : v + q;
    }
    v = MAX ? warp_max(v) : warp_sum(v);
    if (threadIdx.x == 0) sm[kWarps] = v;
  }
  __syncthreads();
  return sm[kWarps];
}

// monotonized-central limited slope (stencil.mc_slope)
template <typename T>
__device__ __forceinline__ T mc_slope(T qm, T q, T qp) {
  const T dl = T(2) * (q - qm);
  const T dr = T(2) * (qp - q);
  const T dc = T(0.5) * (qp - qm);
  T s = tmin(tmin(fabs(dl), fabs(dc)), fabs(dr));
  s = dl * dr > T(0) ? s : T(0);
  return dc > T(0) ? s : -s;
}

// The predicted face velocity between cells q1 and q2 (mol.
// predict_vels_on_faces); q0..q3 are cells f-2..f+1 along the face normal.
template <typename T>
__device__ __forceinline__ T mol_face_vel(T q0, T q1, T q2, T q3) {
  const T sv = T(1.0e-10);
  const T upls = q2 - T(0.5) * mc_slope(q1, q2, q3);
  const T umns = q1 + T(0.5) * mc_slope(q0, q1, q2);
  const T avg = T(0.5) * (upls + umns);
  const T sel = avg >= sv ? umns : (avg <= -sv ? upls : T(0));
  return (umns >= T(0) || upls <= T(0)) ? sel : T(0);
}

// The upwind flux of q at a face moving at um (mol.
// compute_convective_fluxes); q0..q3 as above.
template <typename T>
__device__ __forceinline__ T mol_flux(T q0, T q1, T q2, T q3, T um) {
  const T sv = T(1.0e-10);
  const T qpls = q2 - T(0.5) * mc_slope(q1, q2, q3);
  const T qmns = q1 + T(0.5) * mc_slope(q0, q1, q2);
  const T qs = um > sv ? qmns : (um < -sv ? qpls : T(0.5) * (qmns + qpls));
  return qs * um;
}

template <typename T>
struct Step {
  const Args<T>& a;
  cg::grid_group grid;
  T* sm;
  int nx, ny, n, gtid, gstride, nblk;
  int barriers;

  __device__ Step(const Args<T>& args, T* smem)
      : a(args), grid(cg::this_grid()), sm(smem), nx(args.nx), ny(args.ny),
        n(args.nx * args.ny), nblk(args.nblk), barriers(0) {
    gtid = blockIdx.x * blockDim.x + threadIdx.x;
    gstride = gridDim.x * blockDim.x;
  }

  __device__ int* iptr(int k) const { return static_cast<int*>(a.p[k]); }
  __device__ T* f(int k) const { return static_cast<T*>(a.p[k]); }

  __device__ void sync() {
    grid.sync();
    ++barriers;
  }

  // ------------------------------------------------------------------
  // per-axis transforms of the fast diagonalization
  // ------------------------------------------------------------------
  // The dots accumulate in double whatever T is: one float accumulator
  // over n terms gathers ~sqrt(n) ulps, which at 256^2 left the float
  // step's gp three times further from a double step than step_plain's
  // (cuBLAS sums in blocks); a product of two floats is exact in double,
  // so the float dot is rounded once.
  // out[k, j, c] = sum_i M[k, i] (in[i, j, c] - sub)
  template <int C>
  __device__ void contract0(const T* M, const T* in, T* out, T sub) {
    for (int idx = gtid; idx < n; idx += gstride) {
      const int k = idx / ny, j = idx - k * ny;
      const T* m = M + (size_t)k * nx;
      double acc[C];
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] = 0.0;
#pragma unroll 4
      for (int i = 0; i < nx; ++i) {
        const double mv = m[i];
        const T* h = in + ((size_t)i * ny + j) * C;
#pragma unroll
        for (int c = 0; c < C; ++c)
          acc[c] = acc[c] + mv * static_cast<double>(h[c] - sub);
      }
#pragma unroll
      for (int c = 0; c < C; ++c)
        out[(size_t)idx * C + c] = static_cast<T>(acc[c]);
    }
  }

  // out[i, k, c] = epi(sum_j M[k, j] in[i, j, c]) with Mt = M transposed.
  // mode 0: no epilogue; 1: divide by the singular symbol lam with the
  // mask-form zero mode; 2: divide by a0[c] + dtd * lam[., c].
  template <int C>
  __device__ void contract1(const T* Mt, const T* in, T* out, int mode,
                            const T* lam, const T* a0, T dtd,
                            const T* dot_with, T* dot_acc) {
    for (int idx = gtid; idx < n; idx += gstride) {
      const int i = idx / ny, k = idx - i * ny;
      const T* h = in + (size_t)i * ny * C;
      double acc[C];
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] = 0.0;
#pragma unroll 4
      for (int j = 0; j < ny; ++j) {
        const double mv = Mt[(size_t)j * ny + k];
#pragma unroll
        for (int c = 0; c < C; ++c)
          acc[c] = acc[c] + mv * static_cast<double>(h[j * C + c]);
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        T v = static_cast<T>(acc[c]);
        if (mode == 1) {
          const T m = idx == 0 ? T(1) : T(0);
          const T s = T(1) * lam[idx];
          v = (v * (T(1) - m)) / (s * (T(1) - m) + m);
        } else if (mode == 2) {
          v = v / (a0[c] + dtd * lam[(size_t)idx * C + c]);
        }
        out[(size_t)idx * C + c] = v;
        if (dot_with) *dot_acc = *dot_acc + dot_with[(size_t)idx * C + c] * v;
      }
    }
  }

  // A direct solve x = L^-1 rhs as four transforms with three barriers
  // between them (the caller puts one before and one after).  C = 1: the
  // singular MAC / nodal operator, whose rhs has its mean `sub` removed
  // on the fly; C = 2: the velocity Helmholtz operator at beta = dtd.
  // With dot_with, dot_acc gathers this thread's part of sum(dot_with*x).
  template <int C>
  __device__ void direct_solve(int F0, int V0, int F1T, int V1T, int LAM,
                              const T* rhs, T sub, T* x, T dtd,
                              const T* dot_with, T* dot_acc) {
    T* h1 = f(W_H1);
    T* h2 = f(W_H2);
    const T* a0 = C == 2 ? f(P_DA0) : nullptr;
    contract0<C>(f(F0), rhs, h1, sub);
    sync();
    contract1<C>(f(F1T), h1, h2, C == 1 ? 1 : 2, f(LAM), a0, dtd, nullptr,
                 nullptr);
    sync();
    contract0<C>(f(V0), h2, h1, T(0));
    sync();
    contract1<C>(f(V1T), h1, x, 0, nullptr, nullptr, T(0), dot_with,
                 dot_acc);
  }

  // ------------------------------------------------------------------
  // forces and stencils
  // ------------------------------------------------------------------
  // -(gp + gp0) / rho + gravity, with 1/rho as torch's reciprocal
  __device__ __forceinline__ T force(T gp, T rinv, int c) const {
    return (-(gp + a.gp0[c])) * rinv + a.grav[c];
  }

  // the cross-coupling part of the transpose term (diffusion.
  // _transpose_term with cross_only) of u at cell (i, j), component c
  __device__ T cross(const T* u, int i, int j, int c) const {
    const T mu = a.mu;
    if (c == 0) {   // d/dy (eta d u1/dx) on y faces
      T g[3];
      const int ip = wrap(i + 1, nx), im = wrap(i - 1, nx);
#pragma unroll
      for (int o = 0; o < 3; ++o) {
        const int jj = wrap(j + o - 1, ny);
        g[o] = (T(0.5) * (u[((size_t)ip * ny + jj) * 2 + 1]
                          - u[((size_t)im * ny + jj) * 2 + 1])) / a.dx0;
      }
      const T flo = mu * (T(0.5) * (g[0] + g[1]));
      const T fhi = mu * (T(0.5) * (g[1] + g[2]));
      return (fhi - flo) / a.dx1;
    }
    T g[3];   // d/dx (eta d u0/dy) on x faces
    const int jp = wrap(j + 1, ny), jm = wrap(j - 1, ny);
#pragma unroll
    for (int o = 0; o < 3; ++o) {
      const int ii = wrap(i + o - 1, nx);
      g[o] = (T(0.5) * (u[((size_t)ii * ny + jp) * 2]
                        - u[((size_t)ii * ny + jm) * 2])) / a.dx1;
    }
    const T flo = mu * (T(0.5) * (g[0] + g[1]));
    const T fhi = mu * (T(0.5) * (g[1] + g[2]));
    return (fhi - flo) / a.dx0;
  }

  // the diagonal part d/dx_c (eta d u_c/dx_c) of the transpose term
  __device__ T tdiag(const T* u, int i, int j, int c) const {
    const T mu = a.mu;
    if (c == 0) {
      const T um = u[((size_t)wrap(i - 1, nx) * ny + j) * 2];
      const T u0 = u[((size_t)i * ny + j) * 2];
      const T up = u[((size_t)wrap(i + 1, nx) * ny + j) * 2];
      return (mu * ((up - u0) / a.dx0) - mu * ((u0 - um) / a.dx0)) / a.dx0;
    }
    const T um = u[((size_t)i * ny + wrap(j - 1, ny)) * 2 + 1];
    const T u0 = u[((size_t)i * ny + j) * 2 + 1];
    const T up = u[((size_t)i * ny + wrap(j + 1, ny)) * 2 + 1];
    return (mu * ((up - u0) / a.dx1) - mu * ((u0 - um) / a.dx1)) / a.dx1;
  }

  // the full transpose term, summed as diffusion._transpose_term sums it
  __device__ T transpose_full(const T* u, int i, int j, int c) const {
    return c == 0 ? tdiag(u, i, j, 0) + cross(u, i, j, 0)
                  : cross(u, i, j, 1) + tdiag(u, i, j, 1);
  }

  // the anisotropic Helmholtz operator of the velocity solve at beta =
  // dtd (multigrid.cell_apply of the prebuilt solver's level 0)
  __device__ T helm(const T* x, int i, int j, int c, T dtd) const {
    const T xc = x[((size_t)i * ny + j) * 2 + c];
    const T xw = x[((size_t)wrap(i - 1, nx) * ny + j) * 2 + c];
    const T xe = x[((size_t)wrap(i + 1, nx) * ny + j) * 2 + c];
    const T xs = x[((size_t)i * ny + wrap(j - 1, ny)) * 2 + c];
    const T xn = x[((size_t)i * ny + wrap(j + 1, ny)) * 2 + c];
    T out = a.dacoef * xc;
    const T b0 = a.db[0][c], b1 = a.db[1][c];
    const T div0 = (b0 * ((xe - xc) * a.dxi0) - b0 * ((xc - xw) * a.dxi0))
                   * a.dxi0;
    out = out - dtd * div0;
    const T div1 = (b1 * ((xn - xc) * a.dxi1) - b1 * ((xc - xs) * a.dxi1))
                   * a.dxi1;
    return out - dtd * div1;
  }

  // div(eta grad u_c), the scalar part of compute_divtau
  __device__ T lap(const T* u, int i, int j, int c) const {
    const T mu = a.mu;
    const T xc = u[((size_t)i * ny + j) * 2 + c];
    const T xw = u[((size_t)wrap(i - 1, nx) * ny + j) * 2 + c];
    const T xe = u[((size_t)wrap(i + 1, nx) * ny + j) * 2 + c];
    const T xs = u[((size_t)i * ny + wrap(j - 1, ny)) * 2 + c];
    const T xn = u[((size_t)i * ny + wrap(j + 1, ny)) * 2 + c];
    T o = T(0);
    o = o - (mu * ((xe - xc) * a.dxi0) - mu * ((xc - xw) * a.dxi0)) * a.dxi0;
    o = o - (mu * ((xn - xc) * a.dxi1) - mu * ((xc - xs) * a.dxi1)) * a.dxi1;
    return -o;
  }

  // divtau / rho of the old or predicted state (compute_divtau)
  __device__ T divtau(const T* u, int i, int j, int c, T rho) const {
    if (a.tcorr) return transpose_full(u, i, j, c) / rho;
    T d = lap(u, i, j, c);
    if (a.tensor) d = d + transpose_full(u, i, j, c);
    return d / rho;
  }

  // ------------------------------------------------------------------
  // phases
  // ------------------------------------------------------------------
  // MOL face velocities of `vel`: umac0 on x faces, umac1 on y faces
  // (face f sits between cells f-1 and f; face n is face 0)
  __device__ void mol_faces(const T* vel) {
    T* u0 = f(W_UMAC0);
    T* u1 = f(W_UMAC1);
    for (int idx = gtid; idx < n; idx += gstride) {
      const int i = idx / ny, j = idx - i * ny;
      T q[4];
#pragma unroll
      for (int o = 0; o < 4; ++o)
        q[o] = vel[((size_t)wrap(i + o - 2, nx) * ny + j) * 2];
      u0[idx] = mol_face_vel(q[0], q[1], q[2], q[3]);
#pragma unroll
      for (int o = 0; o < 4; ++o)
        q[o] = vel[((size_t)i * ny + wrap(j + o - 2, ny)) * 2 + 1];
      u1[idx] = mol_face_vel(q[0], q[1], q[2], q[3]);
    }
  }

  // the MAC projection's rhs -div(umac) into W_SRHS; partial sum for the
  // mean (the solver removes it: the operator is singular)
  __device__ void mac_rhs() {
    const T* u0 = f(W_UMAC0);
    const T* u1 = f(W_UMAC1);
    T* rhs = f(W_SRHS);
    T acc = T(0);
    for (int idx = gtid; idx < n; idx += gstride) {
      const int i = idx / ny, j = idx - i * ny;
      const T t0 = (u0[(size_t)wrap(i + 1, nx) * ny + j] - u0[idx]) * a.dxi0;
      const T t1 = (u1[(size_t)i * ny + wrap(j + 1, ny)] - u1[idx]) * a.dxi1;
      const T r = -(t0 + t1);
      rhs[idx] = r;
      acc = acc + r;
    }
    block_partial<T, false>(acc, f(W_PART), kMean, nblk, sm);
  }

  // the MAC projection of the face velocities of `vel` (phi into
  // phi_out); ends with phi complete
  __device__ void mac_project(const T* vel, T* phi_out) {
    mol_faces(vel);
    sync();
    mac_rhs();
    sync();
    const T mean = finish<T, false>(f(W_PART), kMean, nblk, sm) / T(n);
    direct_solve<1>(P_MF0, P_MV0, P_MF1T, P_MV1T, P_MLAM, f(W_SRHS), mean,
                    phi_out, T(0), nullptr, nullptr);
    sync();
  }

  // the corrected face velocity of x face f / y face f of row / column
  // (umac - beta grad phi)
  __device__ __forceinline__ T umac0c(const T* phi, int fi, int j) const {
    const int fm = wrap(fi - 1, nx);
    const T g = (phi[(size_t)fi * ny + j] - phi[(size_t)fm * ny + j]) * a.dxi0;
    return f(W_UMAC0)[(size_t)fi * ny + j] - a.macb[0] * g;
  }
  __device__ __forceinline__ T umac1c(const T* phi, int i, int fj) const {
    const int fm = wrap(fj - 1, ny);
    const T g = (phi[(size_t)i * ny + fj] - phi[(size_t)i * ny + fm]) * a.dxi1;
    return f(W_UMAC1)[(size_t)i * ny + fj] - a.macb[1] * g;
  }

  // the convective rate of component c of vel at (i, j) with the
  // projected face velocities
  __device__ T conv_rate(const T* vel, const T* phi, int i, int j,
                         int c) const {
    T q[5];
#pragma unroll
    for (int o = 0; o < 5; ++o)
      q[o] = vel[((size_t)wrap(i + o - 2, nx) * ny + j) * 2 + c];
    const int ip = wrap(i + 1, nx);
    const T fx0 = mol_flux(q[0], q[1], q[2], q[3], umac0c(phi, i, j));
    const T fx1 = mol_flux(q[1], q[2], q[3], q[4], umac0c(phi, ip, j));
#pragma unroll
    for (int o = 0; o < 5; ++o)
      q[o] = vel[((size_t)i * ny + wrap(j + o - 2, ny)) * 2 + c];
    const int jp = wrap(j + 1, ny);
    const T fy0 = mol_flux(q[0], q[1], q[2], q[3], umac1c(phi, i, j));
    const T fy1 = mol_flux(q[1], q[2], q[3], q[4], umac1c(phi, i, jp));
    return (fx0 - fx1) * a.dxi0 + (fy0 - fy1) * a.dxi1;
  }

  // the convective term and the velocity update before the solve:
  // rhs = rho * (vel_o + dt * dv); partial max |rhs| for the CG tolerance.
  // corrector: `star` is the predicted state, whose gp gives the forces
  __device__ void velocity_rhs(bool corrector, const T* src, const T* phi,
                               const T* gpsrc, T dt) {
    const T* vel_o = f(P_VEL);
    const T* rho = f(P_RHO);
    T* rhs = f(W_RHS);
    T* conv = f(W_CONV);
    T* dtau = f(W_DTAU);
    T acc = T(0);
    for (int idx = gtid; idx < n; idx += gstride) {
      const int i = idx / ny, j = idx - i * ny;
      const T r = rho[idx];
      const T rinv = T(1) / r;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const size_t e = (size_t)idx * 2 + c;
        const T cu = conv_rate(src, phi, i, j, c);
        const T vf = force(gpsrc[e], rinv, c);
        T dv;
        if (!corrector) {
          conv[e] = cu;
          dv = cu + vf;
          if (a.cn || a.tcorr) {
            const T d = divtau(vel_o, i, j, c, r);
            dtau[e] = d;
            dv = a.cn ? dv + T(0.5) * d : dv + d;
          }
        } else {
          dv = T(0.5) * (cu + conv[e]) + vf;
          if (a.cn) dv = dv + T(0.5) * dtau[e];
          else if (a.tcorr) dv = dv + divtau(src, i, j, c, r);
        }
        const T v = vel_o[e] + dt * dv;
        const T b = r * v;
        rhs[e] = b;
        acc = tmax(acc, fabs(b));
      }
    }
    block_partial<T, true>(acc, f(W_PART), kRhsMax, nblk, sm);
  }

  // CG residual rhs + dtd cross(x) - A(x) (diffusion._tensor_pcg)
  __device__ void cg_residual(T dtd) {
    const T* x = f(W_X);
    const T* rhs = f(W_RHS);
    T* r = f(W_R);
    T* xb = f(W_XB);
    T acc = T(0);
    for (int idx = gtid; idx < n; idx += gstride) {
      const int i = idx / ny, j = idx - i * ny;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const size_t e = (size_t)idx * 2 + c;
        const T v = (rhs[e] + dtd * cross(x, i, j, c)) - helm(x, i, j, c, dtd);
        r[e] = v;
        xb[e] = x[e];
        acc = tmax(acc, fabs(v));
      }
    }
    block_partial<T, true>(acc, f(W_PART), kResMax, nblk, sm);
  }

  // The velocity solve of rhs (W_RHS): a direct solve of the
  // anisotropic part, then the fixed-trip tensor CG on the cross
  // coupling.  Leaves the result in W_XB (W_X without the CG) and the
  // best residual / tolerance in res / tol.  Ends without a barrier: the
  // next phase reads only its own cells of the result.
  __device__ const T* diffuse(T dtd, T* res, T* tol, int* trips_run) {
    sync();   // rhs complete
    direct_solve<2>(P_DF0, P_DV0, P_DF1T, P_DV1T, P_DLAM, f(W_RHS), T(0),
                    f(W_X), dtd, nullptr, nullptr);
    *trips_run = 0;
    if (!a.tensor) {
      *res = T(0);
      *tol = T(INFINITY);
      return f(W_X);
    }
    const T tl = tmax(a.rtol * finish<T, true>(f(W_PART), kRhsMax, nblk, sm),
                      a.atol);
    sync();
    cg_residual(dtd);
    sync();
    T rb = finish<T, true>(f(W_PART), kResMax, nblk, sm);
    T dacc = T(0);
    direct_solve<2>(P_DF0, P_DV0, P_DF1T, P_DV1T, P_DLAM, f(W_R), T(0),
                    f(W_P), dtd, f(W_R), &dacc);
    block_partial<T, false>(dacc, f(W_PART), kDotRZ, nblk, sm);
    sync();
    T rz = finish<T, false>(f(W_PART), kDotRZ, nblk, sm);
    int bad = 0;
    T* x = f(W_X);
    T* r = f(W_R);
    T* p = f(W_P);
    T* z = f(W_Z);
    T* xb = f(W_XB);
    T* ap = f(W_AP);
    for (int t = 0; t < a.trips; ++t) {
      if (!(rb > tl && bad < 5)) break;   // a dead trip changes nothing
      ++*trips_run;
      T pap = T(0);
      for (int idx = gtid; idx < n; idx += gstride) {
        const int i = idx / ny, j = idx - i * ny;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const size_t e = (size_t)idx * 2 + c;
          const T v = helm(p, i, j, c, dtd) - dtd * cross(p, i, j, c);
          ap[e] = v;
          pap = pap + p[e] * v;
        }
      }
      block_partial<T, false>(pap, f(W_PART), kDotPAp, nblk, sm);
      sync();
      const T denom = finish<T, false>(f(W_PART), kDotPAp, nblk, sm);
      const T alpha = rz / (denom == T(0) ? T(1) : denom);
      T rmax = T(0);
      for (int idx = gtid; idx < n; idx += gstride) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const size_t e = (size_t)idx * 2 + c;
          x[e] = x[e] + alpha * p[e];
          const T v = r[e] - alpha * ap[e];
          r[e] = v;
          rmax = tmax(rmax, fabs(v));
        }
      }
      block_partial<T, true>(rmax, f(W_PART), kResMax, nblk, sm);
      sync();
      T rzacc = T(0);
      direct_solve<2>(P_DF0, P_DV0, P_DF1T, P_DV1T, P_DLAM, r, T(0), z, dtd,
                      r, &rzacc);
      block_partial<T, false>(rzacc, f(W_PART), kDotRZ, nblk, sm);
      sync();
      const T rzn = finish<T, false>(f(W_PART), kDotRZ, nblk, sm);
      const T new_res = finish<T, true>(f(W_PART), kResMax, nblk, sm);
      const T beta = rzn / (rz == T(0) ? T(1) : rz);
      const bool improved = new_res < T(0.999) * rb;
      for (int idx = gtid; idx < n; idx += gstride) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const size_t e = (size_t)idx * 2 + c;
          p[e] = z[e] + beta * p[e];
          if (improved) xb[e] = x[e];
        }
      }
      sync();
      rz = rzn;
      rb = tmin(rb, new_res);
      bad = improved ? 0 : bad + 1;
    }
    *res = rb;
    *tol = tl;
    return xb;
  }

  // The nodal projection of the solved velocity u (Simulation.
  // apply_projection, not incremental): velocity into vel_dst, phi into
  // p_dst, grad phi into gp_dst.
  __device__ void project(const T* u, const T* gpsrc, T dt, T small,
                          T* vel_dst, T* p_dst, T* gp_dst) {
    const T* vel_o = f(P_VEL);
    const T* rho = f(P_RHO);
    T* vproj = f(W_VPROJ);
    T* vin = f(W_VIN);
    for (int idx = gtid; idx < n; idx += gstride) {
      const T sc = dt / rho[idx];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const size_t e = (size_t)idx * 2 + c;
        const T v = u[e] + gpsrc[e] * sc;
        vproj[e] = v;
        vin[e] = v - small * vel_o[e];
      }
    }
    sync();
    // nodal divergence at node (I, J), the low corner of cell (I, J)
    T* nrhs = f(W_SRHS);
    T acc = T(0);
    for (int idx = gtid; idx < n; idx += gstride) {
      const int I = idx / ny, J = idx - I * ny;
      const int Im = wrap(I - 1, nx), Jm = wrap(J - 1, ny);
      const T u0a = vin[((size_t)I * ny + Jm) * 2] - vin[((size_t)Im * ny + Jm) * 2];
      const T u0b = vin[((size_t)I * ny + J) * 2] - vin[((size_t)Im * ny + J) * 2];
      const T t0 = T(0.5) * (u0a / a.dx0 + u0b / a.dx0);
      const T u1a = vin[((size_t)Im * ny + J) * 2 + 1]
                    - vin[((size_t)Im * ny + Jm) * 2 + 1];
      const T u1b = vin[((size_t)I * ny + J) * 2 + 1]
                    - vin[((size_t)I * ny + Jm) * 2 + 1];
      const T t1 = T(0.5) * (u1a / a.dx1 + u1b / a.dx1);
      const T r = (t0 + t1) / dt;
      nrhs[idx] = r;
      acc = acc + r;
    }
    block_partial<T, false>(acc, f(W_PART), kMean, nblk, sm);
    sync();
    const T mean = finish<T, false>(f(W_PART), kMean, nblk, sm) / T(n);
    direct_solve<1>(P_NF0, P_NV0, P_NF1T, P_NV1T, P_NLAM, nrhs, mean, p_dst,
                    T(0), nullptr, nullptr);
    sync();
    for (int idx = gtid; idx < n; idx += gstride) {
      const int i = idx / ny, j = idx - i * ny;
      const int ip = wrap(i + 1, nx), jp = wrap(j + 1, ny);
      const T p00 = p_dst[(size_t)i * ny + j], p10 = p_dst[(size_t)ip * ny + j];
      const T p01 = p_dst[(size_t)i * ny + jp], p11 = p_dst[(size_t)ip * ny + jp];
      const T g0 = T(0.5) * ((p10 - p00) / a.dx0 + (p11 - p01) / a.dx0);
      const T g1 = T(0.5) * ((p01 - p00) / a.dx1 + (p11 - p10) / a.dx1);
      const T sigma = dt / rho[idx];
      const size_t e = (size_t)idx * 2;
      vel_dst[e] = vproj[e] - sigma * g0;
      vel_dst[e + 1] = vproj[e + 1] - sigma * g1;
      gp_dst[e] = g0;
      gp_dst[e + 1] = g1;
    }
  }

  // compute_dt: the max reductions, then the scalar rules (every thread)
  __device__ T compute_dt(T* small_out) {
    const T* vel = f(P_VEL);
    const T* rho = f(P_RHO);
    const T* gp = f(P_GP);
    T cmax = T(0), fmax_ = T(0), rmax = T(0);
    const T dxi[2] = {a.dxi0, a.dxi1};
    for (int idx = gtid; idx < n; idx += gstride) {
      const T rinv = T(1) / rho[idx];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const size_t e = (size_t)idx * 2 + c;
        cmax = tmax(cmax, fabs(vel[e]) * dxi[c]);
        fmax_ = tmax(fmax_, fabs(force(gp[e], rinv, c)) * dxi[c]);
      }
      rmax = tmax(rmax, rinv);
    }
    T* part = f(W_PART);
    block_partial<T, true>(cmax, part, kConvCfl, nblk, sm);
    block_partial<T, true>(fmax_, part, kForcCfl, nblk, sm);
    block_partial<T, true>(rmax, part, kRhoInv, nblk, sm);
    sync();
    const T conv = finish<T, true>(part, kConvCfl, nblk, sm);
    const T forc = finish<T, true>(part, kForcCfl, nblk, sm);
    const T rinv_max = finish<T, true>(part, kRhoInv, nblk, sm);
    const T eps = Lim<T>::eps;
    const double tiny_d = 1e-300;   // 0 in float, as torch casts it
    const T tiny = T(tiny_d);
    const T s_t = f(P_T)[0], s_dt = f(P_DT)[0];
    const T prev = f(P_PREV_DT)[0], pprev = f(P_PREV_PREV_DT)[0];
    const T cd = conv;
    const T comb = cd + sqrt(cd * cd + T(4) * forc);
    T dtn = (T(1) / tmax(comb, tiny)) * a.two_cfl;
    const T diff_any = ((rinv_max * a.mu) * T(2))
                       * (a.dxi0 * a.dxi0 + a.dxi1 * a.dxi1);
    const T fallback = diff_any > eps ? (T(1) / tmax(diff_any, tiny)) * a.cfl
                                      : a.fallback;
    if (comb <= eps) dtn = s_dt > T(0) ? T(0.5) * s_dt : fallback;
    const T cap = a.ppe ? (prev < pprev ? tmax(prev, pprev) : s_dt) : s_dt;
    if (s_dt > T(0)) dtn = tmin(dtn, T(1.1) * cap);
    if (a.ppe) {
      const bool crossing = trunc((s_t + dtn + eps) / a.per)
                            > trunc((s_t + eps) / a.per);
      if (crossing) dtn = trunc((s_t + dtn) / a.per) * a.per - s_t;
    }
    if (a.stop_on && s_t + dtn > a.stop_time) dtn = a.stop_time - s_t;
    if (dtn < eps) dtn = T(0.5) * s_dt;
    if (a.fixed_on) dtn = a.fixed_dt;
    *small_out = (s_t > T(0) && dtn < T(0.1) * s_dt) ? T(1) : T(0);
    return dtn;
  }

  __device__ void run() {
    T small;
    const T dt = compute_dt(&small);
    const T dtd = a.cn ? T(0.5) * dt : dt;
    T res[2], tol[2];
    int trips[2];
    // predictor on the old state
    mac_project(f(P_VEL), f(W_PHI));
    velocity_rhs(false, f(P_VEL), f(W_PHI), f(P_GP), dt);
    const T* u = diffuse(dtd, &res[0], &tol[0], &trips[0]);
    project(u, f(P_GP), dt, small, f(W_VSTAR), f(W_PSTAR), f(W_GPSTAR));
    sync();
    // corrector on the predicted state
    mac_project(f(W_VSTAR), f(P_MACPHI_OUT));
    velocity_rhs(true, f(W_VSTAR), f(P_MACPHI_OUT), f(W_GPSTAR), dt);
    u = diffuse(dtd, &res[1], &tol[1], &trips[1]);
    project(u, f(W_GPSTAR), dt, small, f(P_VEL_OUT), f(P_P_OUT),
            f(P_GP_OUT));
    if (gtid == 0) {
      T* sc = f(P_SCAL_OUT);
      sc[0] = f(P_T)[0] + dt;
      sc[1] = dt;
      sc[2] = f(P_DT)[0];
      sc[3] = f(P_PREV_DT)[0];
      iptr(P_STEP_OUT)[0] = iptr(P_STEP)[0] + 1;
      T* cgo = f(P_CG_OUT);
      cgo[0] = res[0];
      cgo[1] = tol[0];
      cgo[2] = res[1];
      cgo[3] = tol[1];
      int* dg = iptr(P_DIAG_OUT);
      dg[0] = barriers;
      dg[1] = trips[0];
      dg[2] = trips[1];
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads) step2d_kernel(Args<T> a) {
  __shared__ T sm[kWarps + 1];
  Step<T> s(a, sm);
  s.run();
}

// The most blocks a cooperative launch may have on the current device:
// cooperative launch supported, occupancy x SM count.  Asked once per
// device and type (the answers do not change).
template <typename T>
int max_blocks(int* out) {
  constexpr int kDevices = 64;
  static int cache[kDevices] = {0};
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && dev < kDevices && cache[dev] > 0) {
    *out = cache[dev];
    return 0;
  }
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, step2d_kernel<T>, kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  if (!coop || per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  *out = per_sm * sms;
  if (dev < kDevices) cache[dev] = *out;
  return 0;
}

template <typename T>
int launch(const void* const* ptrs, const double* fp, const int* ip,
           int* nblk_out, cudaStream_t st) {
  Args<T> a;
  a.nx = ip[I_NX];
  a.ny = ip[I_NY];
  a.cn = ip[I_CN];
  a.tensor = ip[I_TENSOR];
  a.tcorr = ip[I_TCORR];
  a.trips = ip[I_TRIPS];
  a.ppe = ip[I_PPE];
  a.stop_on = ip[I_STOPON];
  a.fixed_on = ip[I_FIXEDON];
  a.dx0 = T(fp[F_DX0]);
  a.dx1 = T(fp[F_DX1]);
  a.dxi0 = T(fp[F_DXI0]);
  a.dxi1 = T(fp[F_DXI1]);
  a.two_cfl = T(fp[F_TWO_CFL]);
  a.cfl = T(fp[F_CFL]);
  a.mu = T(fp[F_MU]);
  a.fallback = T(fp[F_FALLBACK]);
  a.per = T(fp[F_PER]);
  a.stop_time = T(fp[F_STOP]);
  a.fixed_dt = T(fp[F_FIXED]);
  a.rtol = T(fp[F_RTOL]);
  a.atol = T(fp[F_ATOL]);
  a.gp0[0] = T(fp[F_GP00]);
  a.gp0[1] = T(fp[F_GP01]);
  a.grav[0] = T(fp[F_G0]);
  a.grav[1] = T(fp[F_G1]);
  a.macb[0] = T(fp[F_MACB0]);
  a.macb[1] = T(fp[F_MACB1]);
  a.dacoef = T(fp[F_DACOEF]);
  a.db[0][0] = T(fp[F_DB00]);
  a.db[0][1] = T(fp[F_DB01]);
  a.db[1][0] = T(fp[F_DB10]);
  a.db[1][1] = T(fp[F_DB11]);
  for (int k = 0; k < NPTR; ++k) a.p[k] = const_cast<void*>(ptrs[k]);
  if (a.nx < 4 || a.ny < 4 || a.trips < 0) return (int)cudaErrorInvalidValue;
  int cap = 0;
  int e = max_blocks<T>(&cap);
  if (e) return e;
  const int n = a.nx * a.ny;
  // no more blocks than can be resident (the cooperative contract), and
  // none beyond one cell per thread: an idle block only slows every
  // barrier
  int nblk = (n + kThreads - 1) / kThreads;
  if (nblk > cap) nblk = cap;
  a.nblk = nblk;
  *nblk_out = nblk;
  void* args[] = {&a};
  cudaError_t r = cudaLaunchCooperativeKernel(
      (const void*)step2d_kernel<T>, dim3(nblk), dim3(kThreads), args, 0, st);
  if (r != cudaSuccess) return (int)r;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int step2d_layout(int* nptr, int* nfpar, int* nipar, int* slots,
                             int* threads) {
  *nptr = NPTR;
  *nfpar = NFPAR;
  *nipar = NIPAR;
  *slots = kSlots;
  *threads = kThreads;
  return 0;
}

// The most blocks a cooperative launch of the kernel may have on this
// card (occupancy x SM count), or an error code.
extern "C" int step2d_max_blocks(int dtype, int* out) {
  if (dtype == 0) return max_blocks<float>(out);
  if (dtype == 1) return max_blocks<double>(out);
  return (int)cudaErrorInvalidValue;
}

extern "C" int step2d_launch(int dtype, const void* const* ptrs,
                             const double* fpar, const int* ipar,
                             int* nblk_out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(ptrs, fpar, ipar, nblk_out, st);
  if (dtype == 1) return launch<double>(ptrs, fpar, ipar, nblk_out, st);
  return (int)cudaErrorInvalidValue;
}
