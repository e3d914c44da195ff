// The whole time step of a 2D, fully periodic, constant-density MOL deck
// (the tgv2d class) as ONE cooperative kernel launch, for NVIDIA Hopper
// (sm_90a).  Plain C interface, bound from incflo_torch/ops/
// step2d_kernels.py with ctypes:
//
//   step2d_launch  replaces incflo_tpu/ops/pallas_step2d.py:
//                  FusedStep._kernel (:501, pallas_call at :563), which
//                  evaluates Simulation._advance_impl in one Pallas program
//   step2d_launch_probe  the same step with block 0 stamping the time of
//                  every segment (a compile-time instantiation, never on
//                  the main path)
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
// Every direct solve is a fast diagonalization: per-axis n x n transforms
// h'[k] = sum_j m[k, j] h[j] around a pointwise eigenvalue divide.
//
// What bounds it on an H100, and the design.  An earlier form of this
// kernel gave each thread one output of a transform, a length-n chain of
// double FMAs from L2; its probe found those transforms 0.78 (128^2) and
// 0.83 (256^2) of the step and its 60 grid barriers 0.12-0.14.  Here:
//   * Panels.  A CTA owns row panels (kPanel = 4 rows) and column panels
//     (4 columns), one CTA a panel: 32 CTAs at 128^2, 64 at 256^2, up to
//     the cooperative limit (past it a CTA walks several panels).  Every
//     elementwise or stencil phase runs on the CTA's own rows, the same
//     cells by the same threads in every phase.  (8-row panels, half the
//     CTAs, ran 1.3-1.4x slower; 2-row ones about as fast.)
//   * Transforms on the FP64 tensor cores.  A transform is the product of
//     the streamed n x n matrix with a panel (4 rows or columns, both
//     components of a velocity field: n x 4C), mma.sync m16n8k16 f64
//     (m8n8k4 ran 1.5x slower): each warp owns up to two 16-row tiles of
//     the output; the matrix arrives in k-tiles (64 deep in float32, 32
//     in float64) by cp.async into two shared-memory stages, in T (a
//     float is widened where its A fragment is read, so products of
//     floats stay exact and the sums stay in double: a float accumulator
//     over n terms gathers ~sqrt(n) ulps); a matrix is a constant, so its
//     first k-tile is sent for before the grid barrier or the panel load
//     that precedes its product.  The panel sits in shared memory in
//     double.  Ragged edges (axes not a multiple of 8 or 16, 4-cell axes)
//     are zeros in shared memory.  A solve is a function of its own, not
//     inlined into the step, so its k-loops do not run among the whole
//     step's live values and their spills.
//   * Solves in row and column phases.  Transforms along different axes
//     commute and the divide is pointwise, so a solve is a row phase (the
//     axis-1 forward transform of the CTA's rows, the mean removed as the
//     rhs is loaded), a grid barrier, a column phase (axis-0 forward, the
//     divide, axis-0 inverse, all three in shared memory), a barrier, and
//     a row phase (axis-1 inverse, the CG dot in its epilogue): two
//     barriers a solve where the earlier form had three around four L2
//     round trips.
//   * Grid barriers only where another CTA's rows are read.  Elementwise
//     work that feeds a row phase runs on the CTA's rows and needs a
//     block barrier only; a stencil reads other CTAs' rows after a grid
//     barrier, each of which names what it waits for.  The MAC rhs
//     recomputes the face velocity of row i + 1 instead of waiting for
//     it, the CG's next search direction is formed where the operator
//     apply reads it (ping-pong buffers), and the nodal divergence forms
//     the projected velocity of its 4 cells on the fly: 37 grid barriers
//     a step at 1 + 1 CG trips (the earlier form: 60), 4 a trip (7).
// The bytes (the state read once and written once, 0.7 MB at 128^2 f32)
// would take 0.2 us; the transforms' 0.28 GFLOP (128^2; 2.2 at 256^2)
// 4 us (33 us) at the DMMA rate of all 132 SMs (67 TFLOP/s), 8 us (66 us)
// at the FP64 FMA rate (34 TFLOP/s).  What bounds the kernel instead is
// each CTA streaming every n x n matrix through its SM, 40 products a
// step: the probe finds the k-loops 0.37-0.55 of the step, each split
// about evenly between issuing the k-tiles' copies (the SM's L2 bandwidth)
// and the products, then the panels' loads, the elementwise phases and
// the 37 barriers (scripts/step2d_probe.py).
// Elementwise parts repeat the plain version's operation order and are
// built without FMA contraction, so they round as it does; the reductions
// sum in another order than torch.sum, and the transforms in double.
//
// Reductions are deterministic: each block writes its partial to a fixed
// slot, and after the barrier every block combines all partials in the
// same fixed order, so every thread holds bit-identical dt, alpha, beta
// and the CG's live / improved flags and all blocks take the same branch.
// No float atomics.  A CG trip whose live flag is false changes nothing
// (the masked form of incflo_tpu/ops/diffusion.py:640-661), so the loop
// ends at the first such trip.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 8;
constexpr int kPanel = 4;     // rows of a row panel, columns of a column one
// depth of a staged k-tile of a matrix (four or two m16n8k16 steps), and
// its row pitch in elements: 4 (mod 32 words) makes the A fragments'
// loads conflict-free
template <typename T>
constexpr int kKT = sizeof(T) == 4 ? 64 : 32;
template <typename T>
constexpr int kKTP = kKT<T> + 4;
constexpr int kNSP = 20;      // a panel's row pitch (doubles): free B
constexpr int kMaxAxis = 256; // spectral.FASTDIAG_MAX_AXIS
constexpr int kMTW = kMaxAxis / 16 / kWarps;  // 16-row output tiles a warp
// 8-column tiles of a panel of C-component fields
template <int C>
constexpr int kNT = (kPanel * C + 7) / 8;

// partial-sum slots: each reduction has its own, and between the read of
// a slot and its next write there is always a barrier
enum Slot { kConvCfl, kForcCfl, kRhoInv, kMean, kRhsMax, kResMax, kDotRZ,
            kDotPAp };

// pointer table shared with ops/step2d_kernels.py (PTR_NAMES)
enum Ptr {
  // inputs: the state and its scalars
  P_VEL, P_RHO, P_GP, P_T, P_DT, P_PREV_DT, P_PREV_PREV_DT, P_STEP,
  // each symbol: axis-0 forward / inverse, axis-1 forward / inverse,
  // eigenvalues (in this order: a solve takes the first slot).  MAC:
  P_MF0, P_MV0, P_MF1, P_MV1, P_MLAM,
  // velocity Helmholtz symbol (two components), and its constant acoef
  P_DF0, P_DV0, P_DF1, P_DV1, P_DLAM, P_DA0,
  // nodal symbol
  P_NF0, P_NV0, P_NF1, P_NV1, P_NLAM,
  // outputs
  P_VEL_OUT, P_GP_OUT, P_P_OUT, P_MACPHI_OUT, P_SCAL_OUT, P_STEP_OUT,
  P_CG_OUT, P_DIAG_OUT,
  // workspace: cell fields (1 = n cells, 2 = 2n)
  W_UMAC0, W_UMAC1, W_PHI, W_SRHS, W_H1, W_H2, W_RHS, W_X, W_R, W_P, W_P2,
  W_Z, W_XB, W_AP, W_CONV, W_DTAU, W_VSTAR, W_GPSTAR, W_PSTAR, W_VPROJ,
  W_PART,
  NPTR
};
// a symbol's slots from its first
enum SymSlot { S_F0, S_V0, S_F1, S_V1, S_LAM };

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

// the launch plan (step2d_kernels.launch_plan): panel, k-tile depth, CTAs
// (one a panel), dynamic shared-memory bytes
enum PlanField { L_PANEL, L_KTILE, L_CTAS, L_SMEM, NPLAN };

template <typename T>
struct Args {
  int nx, ny;
  int cn, tensor, tcorr, trips, ppe, stop_on, fixed_on;
  T dx0, dx1, dxi0, dxi1, two_cfl, cfl, mu, fallback, per, stop_time,
      fixed_dt, rtol, atol, gp0[2], grav[2], macb[2], dacoef, db[2][2];
  void* p[NPTR];
  long long* probe;   // the probe's records (kProbe only)
  int probe_cap;
};

// Probe records (step2d_launch_probe): after each segment of the step,
// block 0 stamps {kind, %globaltimer ns, clock64} once its threads are
// done; a grid barrier is stamped before and after its wait.  The
// interval before a record belongs to the record's kind.  A transform is
// stamped in three parts: the panel's load (kLoad), the k-loop of tensor
// core products (kTransform) and the epilogue (kEpilogue).
enum Seg { kStart, kTransform, kBarrier, kElem, kFinish, kLoad, kEpilogue,
           NSEG };

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// k-tile stages of the streamed matrix: one in use, one in flight
constexpr int kStages = 2;

// Dynamic shared memory: the panel P and the column phase's spectral
// panel Q (doubles, round_up(n, kKT<T>) rows of kNSP), then the k-tile
// stages of a matrix (T, round_up(n, 16) rows of kKTP<T>), n the longer axis.
template <typename T>
constexpr int smem_bytes(int nx, int ny) {
  const int n = nx > ny ? nx : ny;
  return 2 * round_up(n, kKT<T>) * kNSP * 8 +
         kStages * round_up(n, 16) * kKTP<T> * (int)sizeof(T);
}

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
__device__ void block_partial(T v, T* part, int slot, T* sm) {
  v = MAX ? warp_max(v) : warp_sum(v);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) sm[w] = v;
  __syncthreads();
  if (w == 0) {
    T u = lane < kWarps ? sm[lane] : T(0);
    u = MAX ? warp_max(u) : warp_sum(u);
    if (lane == 0) part[slot * gridDim.x + blockIdx.x] = u;
  }
}

// All partials of a slot combined in one fixed order: the same value in
// every thread of every block.
template <typename T, bool MAX>
__device__ T finish(const T* part, int slot, T* sm) {
  __syncthreads();
  if (threadIdx.x < 32) {
    T v = T(0);
    for (int b = threadIdx.x; b < (int)gridDim.x; b += 32) {
      const T q = __ldcg(part + slot * gridDim.x + b);
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

// d += a b for a 16x8x16 double tile: mma.sync m16n8k16 .f64, the FP64
// tensor cores' widest shape on sm_90 (the fragments as PTX lays them
// out, g = lane / 4, q = lane % 4: a[i] = A[g + 8 (i % 2)][q + 4 (i / 2)],
// b[i] = B[q + 4 i][g], d[i] = D[g + 8 (i / 2)][2 q + i % 2])
__device__ __forceinline__ void dmma16(double (&d)[4], const double (&a)[8],
                                       const double (&b)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, "
      "{%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
        "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

// a load from shared memory at a shared-window address (the compiler
// would otherwise emit generic loads for pointers it cannot place)
template <typename T> __device__ __forceinline__ T lds(unsigned addr);
template <> __device__ __forceinline__ float lds<float>(unsigned addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}
template <> __device__ __forceinline__ double lds<double>(unsigned addr) {
  double v;
  asm volatile("ld.shared.f64 %0, [%1];\n" : "=d"(v) : "r"(addr));
  return v;
}

// cp.async of N bytes from global to shared memory, its groups, and a
// wait for all but the newest N groups
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(d), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                 :: "r"(d), "l"(src), "n"(N) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// a two-component cell field read at (i, j, c): an array, or the CG's
// next search direction z + beta p formed where it is read
template <typename T>
struct Field2 {
  const T* u;
  int ny;
  __device__ __forceinline__ T operator()(int i, int j, int c) const {
    return u[((size_t)i * ny + j) * 2 + c];
  }
};
template <typename T>
struct NextDir {
  const T* z;
  const T* p;
  T beta;
  int ny;
  __device__ __forceinline__ T operator()(int i, int j, int c) const {
    const size_t e = ((size_t)i * ny + j) * 2 + c;
    return z[e] + beta * p[e];
  }
};

template <typename T, bool kProbe>
struct Step {
  const Args<T>& a;
  cg::grid_group grid;
  T* sm;
  double* P;      // panel operand (k rows of kNSP)
  double* Q;      // the column phase's divided spectral panel
  T* stages;      // kStages k-tiles of the streamed matrix
  int slot;       // elements of a stage
  const T* pend;  // the matrix whose first k-tiles are in flight, if any
  int nx, ny, n, nrp, ncp;
  int barriers, nrec;
  long long wait_cyc, kloop_cyc, issue_cyc, mma_cyc;  // the probe's
                                                      // k-loop clocks

  __device__ Step(const Args<T>& args, T* red, unsigned char* dyn)
      : a(args), grid(cg::this_grid()), sm(red), nx(args.nx), ny(args.ny),
        n(args.nx * args.ny), pend(nullptr), barriers(0), nrec(0),
        wait_cyc(0), kloop_cyc(0), issue_cyc(0), mma_cyc(0) {
    nrp = (nx + kPanel - 1) / kPanel;
    ncp = (ny + kPanel - 1) / kPanel;
    const int nmax = nx > ny ? nx : ny;
    const int kp = round_up(nmax, kKT<T>) * kNSP;
    P = reinterpret_cast<double*>(dyn);
    Q = P + kp;
    stages = reinterpret_cast<T*>(Q + kp);
    slot = round_up(nmax, 16) * kKTP<T>;
  }

  __device__ int* iptr(int k) const { return static_cast<int*>(a.p[k]); }
  __device__ T* f(int k) const { return static_cast<T*>(a.p[k]); }

  // the probe's stamp of a segment of `kind` that ends here
  __device__ void mark(int kind) {
    if constexpr (kProbe) {
      __syncthreads();
      if (blockIdx.x == 0 && threadIdx.x == 0 && nrec < a.probe_cap) {
        unsigned long long t;
        asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
        long long* r = a.probe + 3 * nrec;
        r[0] = kind;
        r[1] = (long long)t;
        r[2] = clock64();
      }
      ++nrec;
    }
  }

  // a grid barrier after a segment of `kind`
  __device__ void sync(int kind = kElem) {
    mark(kind);
    grid.sync();
    ++barriers;
    mark(kBarrier);
  }

  // a reduction's partials combined (finish), stamped
  template <bool MAX>
  __device__ T fin(int slot) {
    const T v = finish<T, MAX>(f(W_PART), slot, sm);
    mark(kFinish);
    return v;
  }

  template <bool MAX>
  __device__ void partial(T v, int slot) {
    block_partial<T, MAX>(v, f(W_PART), slot, sm);
  }

  // fn(idx, i, j) on every cell of the CTA's rows, each by the same
  // thread in every phase
  template <class F>
  __device__ void own_cells(F&& fn) const {
    for (int p = blockIdx.x; p < nrp; p += gridDim.x) {
      const int c1 = min((p + 1) * kPanel, nx) * ny;
      for (int idx = p * kPanel * ny + threadIdx.x; idx < c1;
           idx += kThreads)
        fn(idx, idx / ny, idx % ny);
    }
  }

  // ------------------------------------------------------------------
  // transforms: the streamed matrix times a panel, on the tensor cores
  // ------------------------------------------------------------------
  // k-tile kt of Mat (M x K, row-major) into buf: rows [0, round_up(M,
  // 16)), columns [kt kKT<T>, +kKT<T>), zeros outside Mat
  __device__ void stage_tile(const T* Mat, int M, int K, int kt,
                             T* buf) const {
    const int m16 = round_up(M, 16), k0 = kt * kKT<T>;
    constexpr int V = 16 / (int)sizeof(T);   // elements of a 16-byte copy
    if (K % V == 0) {   // rows 16-byte aligned: whole 16-byte chunks
      constexpr int CH = kKT<T> / V;
      for (int e = threadIdx.x; e < m16 * CH; e += kThreads) {
        const int m = e / CH, kk = (e - m * CH) * V;
        T* dst = buf + m * kKTP<T> + kk;
        if (m < M && k0 + kk < K)
          cp_async<16>(dst, Mat + (size_t)m * K + k0 + kk);
        else
          *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    } else {
      for (int e = threadIdx.x; e < m16 * kKT<T>; e += kThreads) {
        const int m = e / kKT<T>, kk = e - m * kKT<T>;
        T* dst = buf + m * kKTP<T> + kk;
        if (m < M && k0 + kk < K)
          cp_async<sizeof(T)>(dst, Mat + (size_t)m * K + k0 + kk);
        else
          *dst = T(0);
      }
    }
  }

  // Start the first kStages - 1 k-tiles of Mat (M x K) on their way,
  // one cp.async group each: a matrix is a constant, so this runs ahead
  // of a grid barrier or a panel's load.
  __device__ void prefetch(const T* Mat, int M, int K) {
    const int nkt = (K + kKT<T> - 1) / kKT<T>;
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < nkt) stage_tile(Mat, M, K, s, stages + s * slot);
      cp_commit();
    }
    pend = Mat;
  }

  // epi(m, col, sum_k Mat[m, k] Pm[k, col], aux(m, col)) for m < M,
  // col < 8 NT: Mat (M x K, global) streamed through the stages, Pm (K
  // rows of kNSP doubles in shared memory, rows >= K zero); the warp
  // holds output tiles w, w + 8 of 16 rows, a k-tile is one m16n8k16
  // product a tile and 8 columns.  aux, the epilogue's global loads (a
  // divisor, a dot's other factor), is loaded before the k-loop, so
  // those loads overlap it instead of waiting one L2 round trip each
  // between the epilogue's stores.  The k-loop ends with a block barrier.
  template <int NT, class Aux, class Epi>
  __device__ void gemm(const T* Mat, int M, int K, const double* Pm,
                       Aux&& aux, Epi&& epi) {
    if (pend != Mat) {
      if (pend != nullptr) {   // another matrix's tiles: let them land
        cp_wait<0>();
        __syncthreads();
      }
      prefetch(Mat, M, K);
    }
    pend = nullptr;
    double acc[kMTW][NT][4];
#pragma unroll
    for (int j = 0; j < kMTW; ++j)
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][t][i] = 0.0;
    const int nkt = (K + kKT<T> - 1) / kKT<T>, nmt = (M + 15) / 16;
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int g = lane >> 2, q = lane & 3;
    constexpr int S = kStages;
    // the output element of accumulator i of tile (j, t)
    auto row = [&](int j, int i) {
      return (w + j * kWarps) * 16 + g + 8 * (i >> 1);
    };
    auto col = [&](int t, int i) { return t * 8 + 2 * q + (i & 1); };
    T ax[kMTW][NT][4];
#pragma unroll
    for (int j = 0; j < kMTW; ++j)
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          ax[j][t][i] = row(j, i) < M ? aux(row(j, i), col(t, i)) : T(0);
    mark(kLoad);
    // shared-memory addresses of the thread's A and B fragment elements
    const unsigned a_s = static_cast<unsigned>(__cvta_generic_to_shared(
        stages)) + ((w * 16 + g) * kKTP<T> + q) * (unsigned)sizeof(T);
    const unsigned b_s = static_cast<unsigned>(__cvta_generic_to_shared(Pm))
                         + (q * kNSP + g) * 8u;
    long long t0 = 0, tw = 0;
    if constexpr (kProbe) t0 = clock64();
    for (int kt = 0; kt < nkt; ++kt) {
      if constexpr (kProbe) tw = clock64();
      if (kt + S - 1 < nkt)
        stage_tile(Mat, M, K, kt + S - 1, stages + ((kt + S - 1) % S) * slot);
      cp_commit();
      if constexpr (kProbe) {
        issue_cyc += clock64() - tw;
        tw = clock64();
      }
      cp_wait<S - 1>();
      __syncthreads();   // k-tile kt (and the panel) visible to all warps
      if constexpr (kProbe) {
        wait_cyc += clock64() - tw;
        tw = clock64();
      }
#pragma unroll
      for (int s16 = 0; s16 < kKT<T> / 16; ++s16) {
        const unsigned a_k = a_s + ((kt % S) * slot + s16 * 16)
                                   * (unsigned)sizeof(T);
        const unsigned b_k = b_s + (kt * kKT<T> + s16 * 16) * kNSP * 8u;
        double b[NT][4];
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            b[t][i] = lds<double>(b_k + (4 * i * kNSP + t * 8) * 8u);
#pragma unroll
        for (int j = 0; j < kMTW; ++j) {
          if (w + j * kWarps < nmt) {   // warp-uniform
            double a[8];
#pragma unroll
            for (int i = 0; i < 8; ++i)
              a[i] = static_cast<double>(lds<T>(
                  a_k + ((j * kWarps * 16 + 8 * (i & 1)) * kKTP<T>
                         + 4 * (i >> 1)) * (unsigned)sizeof(T)));
#pragma unroll
            for (int t = 0; t < NT; ++t) dmma16(acc[j][t], a, b[t]);
          }
        }
      }
      if constexpr (kProbe) mma_cyc += clock64() - tw;
      __syncthreads();   // this stage free for k-tile kt + S
    }
    if constexpr (kProbe) kloop_cyc += clock64() - t0;
    mark(kTransform);
#pragma unroll
    for (int j = 0; j < kMTW; ++j)
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (row(j, i) < M)
            epi(row(j, i), col(t, i), acc[j][t][i], ax[j][t][i]);
    mark(kEpilogue);
  }

  // The panel P[at(e, v)] = v for e < total, at most PER elements a
  // thread: every load first, then every store (P is not known to the
  // compiler not to alias the loads' arrays, so interleaved they would
  // wait one L2 round trip each).
  template <int PER, class At>
  __device__ __forceinline__ void fill(int total, At&& at) {
    constexpr int B = PER < 8 ? PER : 8;   // loads in flight
#pragma unroll 1
    for (int u0 = 0; u0 < PER; u0 += B) {
      double v[B];
      int o[B];
#pragma unroll
      for (int u = 0; u < B; ++u) {
        const int e = threadIdx.x + (u0 + u) * kThreads;
        o[u] = e < total ? at(e, v[u]) : -1;
      }
#pragma unroll
      for (int u = 0; u < B; ++u)
        if (o[u] >= 0) P[o[u]] = v[u];
    }
  }

  // Row phase: out[i, k, c] = sum_j Mat[k, j] in[i, j, c] on the CTA's
  // rows, in[i, j, c] = load(i, j, c) and store(i, k, c, out, aux(i, k,
  // c)).  The panel's columns are (row, component) pairs.
  template <int C, class Load, class Aux, class Store>
  __device__ void row_phase(const T* Mat, Load&& load, Aux&& aux,
                            Store&& store) {
    const int kp = round_up(ny, kKT<T>);
    for (int p = blockIdx.x; p < nrp; p += gridDim.x) {
      const int i0 = p * kPanel, r = min(kPanel, nx - i0);
      fill<kPanel * kMaxAxis * C / kThreads>(kPanel * kp * C,
          [&](int e, double& v) {
        const int il = e / (kp * C), rem = e - il * kp * C;
        const int j = rem / C, c = rem - j * C;
        v = (il < r && j < ny) ? load(i0 + il, j, c) : 0.0;
        return j * kNSP + il * C + c;
      });
      gemm<kNT<C>>(
          Mat, ny, ny, P,
          [&](int k, int col) {
            const int il = col / C;
            return il < r ? aux(i0 + il, k, col - il * C) : T(0);
          },
          [&](int k, int col, double v, T au) {
            const int il = col / C;
            if (il < r) store(i0 + il, k, col - il * C, v, au);
          });
    }
  }

  // Column phase of the symbol at slot `sym`: on the CTA's columns, the
  // axis-0 forward transform, the eigenvalue divide (C = 1: the singular
  // symbol with the mask-form zero mode; C = 2: a0[c] + dtd lam[., c])
  // and the inverse, all in shared memory; src -> dst.
  template <int C>
  __device__ void col_phase(int sym, const T* src, T* dst, T dtd) {
    const T* lam = f(sym + S_LAM);
    const T* a0 = f(P_DA0);
    const int kp = round_up(nx, kKT<T>);
    constexpr int W = kPanel * C;
    for (int p = blockIdx.x; p < ncp; p += gridDim.x) {
      const int j0 = p * kPanel, r = min(kPanel, ny - j0);
      fill<kMaxAxis * W / kThreads>(kp * W, [&](int e, double& v) {
        const int i = e / W, col = e - i * W, jl = col / C;
        v = (i < nx && jl < r)
                ? static_cast<double>(src[((size_t)i * ny + j0) * C + col])
                : 0.0;
        return i * kNSP + col;
      });
      for (int e = threadIdx.x; e < (kp - nx) * W; e += kThreads)
        Q[(nx + e / W) * kNSP + e % W] = 0.0;
      const T a0c[2] = {a0[0], a0[C - 1]};
      gemm<kNT<C>>(
          f(sym + S_F0), nx, nx, P,
          [&](int k0, int col) {   // the divisor
            const int jl = col / C, c = col - jl * C;
            if (jl >= r) return T(1);
            const T l = lam[((size_t)k0 * ny + j0 + jl) * C + c];
            return C == 1 ? l : a0c[c] + dtd * l;
          },
          [&](int k0, int col, double v, T den) {
            const int jl = col / C;
            const bool zero = jl >= r || (C == 1 && k0 == 0 && j0 + jl == 0);
            Q[k0 * kNSP + col] = zero ? 0.0 : v / static_cast<double>(den);
          });
      prefetch(f(sym + S_V0), nx, nx);
      __syncthreads();   // Q complete
      gemm<kNT<C>>(
          f(sym + S_V0), nx, nx, Q, [](int, int) { return T(0); },
          [&](int m, int col, double v, T) {
            if (col / C < r)
              dst[((size_t)m * ny + j0) * C + col] = static_cast<T>(v);
          });
    }
  }

  // A direct solve x = L^-1 (rhs - sub) with the symbol at slot `sym`:
  // row phase, barrier, column phase, barrier, row phase.  The caller
  // makes the CTA's rows of rhs visible (a block barrier) and knows sub.
  // With dot_with, dot_acc gathers this thread's part of
  // sum(dot_with * x).
  // Not inlined: one body per C, compiled with the registers to itself
  // (inlined into the step, the transforms' k-loops ran among the whole
  // step's live values and their spills).
  template <int C>
  __device__ __noinline__ void solve(int sym, const T* rhs, T sub, T* x,
                                     T dtd, const T* dot_with, T* dot_acc) {
    T* h1 = f(W_H1);
    T* h2 = f(W_H2);
    if ((int)blockIdx.x < nrp) prefetch(f(sym + S_F1), ny, ny);
    row_phase<C>(
        f(sym + S_F1),
        [&](int i, int j, int c) {
          return static_cast<double>(rhs[((size_t)i * ny + j) * C + c] - sub);
        },
        [](int, int, int) { return T(0); },
        [&](int i, int k, int c, double v, T) {
          h1[((size_t)i * ny + k) * C + c] = static_cast<T>(v);
        });
    if ((int)blockIdx.x < ncp) prefetch(f(sym + S_F0), nx, nx);
    sync(kTransform);   // h1 complete: a column panel reads every row
    col_phase<C>(sym, h1, h2, dtd);
    if ((int)blockIdx.x < nrp) prefetch(f(sym + S_V1), ny, ny);
    sync(kTransform);   // h2 complete: a row panel reads every column
    row_phase<C>(
        f(sym + S_V1),
        [&](int i, int j, int c) {
          return static_cast<double>(h2[((size_t)i * ny + j) * C + c]);
        },
        [&](int i, int k, int c) {
          return dot_with ? dot_with[((size_t)i * ny + k) * C + c] : T(0);
        },
        [&](int i, int k, int c, double v, T dw) {
          const T xv = static_cast<T>(v);
          x[((size_t)i * ny + k) * C + c] = xv;
          if (dot_with) *dot_acc = *dot_acc + dw * xv;
        });
    mark(kTransform);
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
  template <class U>
  __device__ T cross(const U& u, int i, int j, int c) const {
    const T mu = a.mu;
    if (c == 0) {   // d/dy (eta d u1/dx) on y faces
      T g[3];
      const int ip = wrap(i + 1, nx), im = wrap(i - 1, nx);
#pragma unroll
      for (int o = 0; o < 3; ++o) {
        const int jj = wrap(j + o - 1, ny);
        g[o] = (T(0.5) * (u(ip, jj, 1) - u(im, jj, 1))) / a.dx0;
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
      g[o] = (T(0.5) * (u(ii, jp, 0) - u(ii, jm, 0))) / a.dx1;
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
    const Field2<T> uf{u, ny};
    return c == 0 ? tdiag(u, i, j, 0) + cross(uf, i, j, 0)
                  : cross(uf, i, j, 1) + tdiag(u, i, j, 1);
  }

  // the anisotropic Helmholtz operator of the velocity solve at beta =
  // dtd (multigrid.cell_apply of the prebuilt solver's level 0)
  template <class U>
  __device__ T helm(const U& x, int i, int j, int c, T dtd) const {
    const T xc = x(i, j, c);
    const T xw = x(wrap(i - 1, nx), j, c);
    const T xe = x(wrap(i + 1, nx), j, c);
    const T xs = x(i, wrap(j - 1, ny), c);
    const T xn = x(i, wrap(j + 1, ny), c);
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
  // MOL face velocity of x face i / y face j of `vel` (face f sits
  // between cells f-1 and f)
  __device__ T face0(const T* vel, int i, int j) const {
    T q[4];
#pragma unroll
    for (int o = 0; o < 4; ++o)
      q[o] = vel[((size_t)wrap(i + o - 2, nx) * ny + j) * 2];
    return mol_face_vel(q[0], q[1], q[2], q[3]);
  }
  __device__ T face1(const T* vel, int i, int j) const {
    T q[4];
#pragma unroll
    for (int o = 0; o < 4; ++o)
      q[o] = vel[((size_t)i * ny + wrap(j + o - 2, ny)) * 2 + 1];
    return mol_face_vel(q[0], q[1], q[2], q[3]);
  }

  // MOL face velocities of `vel` on the CTA's rows (umac0 on x faces,
  // umac1 on y faces) and the MAC projection's rhs -div(umac) into
  // W_SRHS, with its partial sum for the mean (the solver removes it:
  // the operator is singular).  The face of row i + 1 is recomputed
  // here, as its owner computes it, instead of read after a barrier.
  __device__ void mac_rhs(const T* vel) {
    T* u0 = f(W_UMAC0);
    T* u1 = f(W_UMAC1);
    T* rhs = f(W_SRHS);
    T acc = T(0);
    own_cells([&](int idx, int i, int j) {
      const T f0 = face0(vel, i, j), f1 = face1(vel, i, j);
      u0[idx] = f0;
      u1[idx] = f1;
      const T t0 = (face0(vel, wrap(i + 1, nx), j) - f0) * a.dxi0;
      const T t1 = (face1(vel, i, wrap(j + 1, ny)) - f1) * a.dxi1;
      const T r = -(t0 + t1);
      rhs[idx] = r;
      acc = acc + r;
    });
    partial<false>(acc, kMean);
  }

  // the MAC solve of W_SRHS (its mean's partials complete) into phi_out;
  // ends with phi complete
  __device__ void mac_solve(T* phi_out) {
    const T mean = fin<false>(kMean) / T(n);
    solve<1>(P_MF0, f(W_SRHS), mean, phi_out, T(0), nullptr, nullptr);
    sync(kTransform);   // phi complete: the convective term reads row i + 1
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

  // the convective term and the velocity update before the solve, on the
  // CTA's rows: rhs = rho * (vel_o + dt * dv); partial max |rhs| for the
  // CG tolerance.  corrector: `src` is the predicted state, whose gp
  // gives the forces
  __device__ void velocity_rhs(bool corrector, const T* src, const T* phi,
                               const T* gpsrc, T dt) {
    const T* vel_o = f(P_VEL);
    const T* rho = f(P_RHO);
    T* rhs = f(W_RHS);
    T* conv = f(W_CONV);
    T* dtau = f(W_DTAU);
    T acc = T(0);
    own_cells([&](int idx, int i, int j) {
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
    });
    partial<true>(acc, kRhsMax);
  }

  // The velocity solve of rhs (W_RHS, on the CTA's rows): a direct solve
  // of the anisotropic part, then the fixed-trip tensor CG on the cross
  // coupling.  Returns the result, complete on every row: W_X, or W_XB,
  // the best iterate -- but the last trip does not copy its improved
  // iterate into W_XB (a neighbour may be reading W_XB): it returns W_X.
  // The best residual and the tolerance go to res and tol.
  __device__ const T* diffuse(T dtd, T* res, T* tol, int* trips_run) {
    mark(kElem);
    __syncthreads();   // the CTA's rows of the rhs
    T* x = f(W_X);
    solve<2>(P_DF0, f(W_RHS), T(0), x, dtd, nullptr, nullptr);
    *trips_run = 0;
    sync(kTransform);   // x complete: the residual's (without the CG, the
                        // nodal divergence's) stencil reads rows i +- 1
    if (!a.tensor) {
      *res = T(0);
      *tol = T(INFINITY);
      return x;
    }
    const T tl = tmax(a.rtol * fin<true>(kRhsMax), a.atol);
    const T* rhs = f(W_RHS);
    T* r = f(W_R);
    T* z = f(W_Z);
    T* xb = f(W_XB);
    T* ap = f(W_AP);
    T* pbuf[2] = {f(W_P), f(W_P2)};
    // CG residual rhs + dtd cross(x) - A(x) (diffusion._tensor_pcg)
    T rmax = T(0);
    const Field2<T> xf{x, ny};
    own_cells([&](int idx, int i, int j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const size_t e = (size_t)idx * 2 + c;
        const T v = (rhs[e] + dtd * cross(xf, i, j, c))
                    - helm(xf, i, j, c, dtd);
        r[e] = v;
        xb[e] = x[e];
        rmax = tmax(rmax, fabs(v));
      }
    });
    partial<true>(rmax, kResMax);
    mark(kElem);
    __syncthreads();   // the CTA's rows of r
    T dacc = T(0);
    solve<2>(P_DF0, r, T(0), pbuf[0], dtd, r, &dacc);
    partial<false>(dacc, kDotRZ);
    sync(kTransform);   // p complete: A p reads rows i +- 1; the r.z and
                        // residual partials
    T rb = fin<true>(kResMax);
    T rz = fin<false>(kDotRZ);
    T beta = T(0);
    int bad = 0;
    bool from_x = false;
    bool live = a.trips > 0 && rb > tl && bad < 5;
    for (int t = 0; live; ++t) {
      ++*trips_run;
      // A p and p.Ap; after the first trip p = z + beta p_prev is formed
      // where it is read, and the CTA's rows of it stored
      T* p = pbuf[t & 1];
      const T* pprev = pbuf[(t + 1) & 1];
      T pap = T(0);
      auto apply = [&](const auto& pf) {
        own_cells([&](int idx, int i, int j) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const size_t e = (size_t)idx * 2 + c;
            const T v = helm(pf, i, j, c, dtd) - dtd * cross(pf, i, j, c);
            const T pe = pf(i, j, c);
            if (t > 0) p[e] = pe;
            ap[e] = v;
            pap = pap + pe * v;
          }
        });
      };
      if (t == 0) apply(Field2<T>{p, ny});
      else apply(NextDir<T>{z, pprev, beta, ny});
      partial<false>(pap, kDotPAp);
      sync();   // the p.Ap partials
      const T denom = fin<false>(kDotPAp);
      const T alpha = rz / (denom == T(0) ? T(1) : denom);
      T rm = T(0);
      own_cells([&](int idx, int, int) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const size_t e = (size_t)idx * 2 + c;
          x[e] = x[e] + alpha * p[e];
          const T v = r[e] - alpha * ap[e];
          r[e] = v;
          rm = tmax(rm, fabs(v));
        }
      });
      partial<true>(rm, kResMax);
      mark(kElem);
      __syncthreads();   // the CTA's rows of r
      T rzacc = T(0);
      solve<2>(P_DF0, r, T(0), z, dtd, r, &rzacc);
      partial<false>(rzacc, kDotRZ);
      sync(kTransform);   // z complete (the next A p forms p from it on
                          // rows i +- 1); the r.z and residual partials
      const T rzn = fin<false>(kDotRZ);
      const T new_res = fin<true>(kResMax);
      beta = rzn / (rz == T(0) ? T(1) : rz);
      const bool improved = new_res < T(0.999) * rb;
      rz = rzn;
      rb = tmin(rb, new_res);
      bad = improved ? 0 : bad + 1;
      live = t + 1 < a.trips && rb > tl && bad < 5;
      if (live) {
        if (improved)
          own_cells([&](int idx, int, int) {
            xb[(size_t)idx * 2] = x[(size_t)idx * 2];
            xb[(size_t)idx * 2 + 1] = x[(size_t)idx * 2 + 1];
          });
      } else {
        from_x = improved;   // the best iterate is this trip's x
      }
    }
    *res = rb;
    *tol = tl;
    return from_x ? x : xb;
  }

  // The nodal projection of the solved velocity u (Simulation.
  // apply_projection, not incremental): velocity into vel_dst, phi into
  // p_dst, grad phi into gp_dst.  u is complete on every row.
  __device__ void project(const T* u, const T* gpsrc, T dt, T small,
                          T* vel_dst, T* p_dst, T* gp_dst) {
    const T* vel_o = f(P_VEL);
    const T* rho = f(P_RHO);
    T* vproj = f(W_VPROJ);
    // the velocity the divergence sees: the projected one less small x
    // the old one, formed where it is read
    auto vin = [&](int i, int j, int c) {
      const size_t e = ((size_t)i * ny + j) * 2 + c;
      const T sc = dt / rho[(size_t)i * ny + j];
      const T v = u[e] + gpsrc[e] * sc;
      return v - small * vel_o[e];
    };
    // the projected velocity on the CTA's rows, and the nodal divergence
    // at node (I, J), the low corner of cell (I, J)
    T* nrhs = f(W_SRHS);
    T acc = T(0);
    own_cells([&](int idx, int I, int J) {
      const T sc = dt / rho[idx];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const size_t e = (size_t)idx * 2 + c;
        vproj[e] = u[e] + gpsrc[e] * sc;
      }
      const int Im = wrap(I - 1, nx), Jm = wrap(J - 1, ny);
      const T u0a = vin(I, Jm, 0) - vin(Im, Jm, 0);
      const T u0b = vin(I, J, 0) - vin(Im, J, 0);
      const T t0 = T(0.5) * (u0a / a.dx0 + u0b / a.dx0);
      const T u1a = vin(Im, J, 1) - vin(Im, Jm, 1);
      const T u1b = vin(I, J, 1) - vin(I, Jm, 1);
      const T t1 = T(0.5) * (u1a / a.dx1 + u1b / a.dx1);
      const T r = (t0 + t1) / dt;
      nrhs[idx] = r;
      acc = acc + r;
    });
    partial<false>(acc, kMean);
    sync();   // the nodal rhs mean's partials
    const T mean = fin<false>(kMean) / T(n);
    solve<1>(P_NF0, nrhs, mean, p_dst, T(0), nullptr, nullptr);
    sync(kTransform);   // p complete: the gradient reads rows i and i + 1
    own_cells([&](int idx, int i, int j) {
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
    });
  }

  // compute_dt's max reductions on the CTA's rows
  __device__ void dt_partials() {
    const T* vel = f(P_VEL);
    const T* rho = f(P_RHO);
    const T* gp = f(P_GP);
    T cmax = T(0), fmax_ = T(0), rmax = T(0);
    const T dxi[2] = {a.dxi0, a.dxi1};
    own_cells([&](int idx, int, int) {
      const T rinv = T(1) / rho[idx];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const size_t e = (size_t)idx * 2 + c;
        cmax = tmax(cmax, fabs(vel[e]) * dxi[c]);
        fmax_ = tmax(fmax_, fabs(force(gp[e], rinv, c)) * dxi[c]);
      }
      rmax = tmax(rmax, rinv);
    });
    partial<true>(cmax, kConvCfl);
    partial<true>(fmax_, kForcCfl);
    partial<true>(rmax, kRhoInv);
  }

  // compute_dt's scalar rules (every thread), its partials complete
  __device__ T dt_rules(T* small_out) {
    const T conv = fin<true>(kConvCfl);
    const T forc = fin<true>(kForcCfl);
    const T rinv_max = fin<true>(kRhoInv);
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
    mark(kStart);
    dt_partials();
    mac_rhs(f(P_VEL));
    sync();   // the dt reductions' and the MAC rhs mean's partials
    T small;
    const T dt = dt_rules(&small);
    const T dtd = a.cn ? T(0.5) * dt : dt;
    T res[2], tol[2];
    int trips[2];
    // predictor on the old state
    mac_solve(f(W_PHI));
    velocity_rhs(false, f(P_VEL), f(W_PHI), f(P_GP), dt);
    const T* u = diffuse(dtd, &res[0], &tol[0], &trips[0]);
    project(u, f(P_GP), dt, small, f(W_VSTAR), f(W_PSTAR), f(W_GPSTAR));
    sync();   // vstar and gpstar complete: the corrector's faces read rows
              // i - 2 .. i + 2, its nodal divergence gpstar of row i - 1
    // corrector on the predicted state
    mac_rhs(f(W_VSTAR));
    sync();   // the MAC rhs mean's partials
    mac_solve(f(P_MACPHI_OUT));
    velocity_rhs(true, f(W_VSTAR), f(P_MACPHI_OUT), f(W_GPSTAR), dt);
    u = diffuse(dtd, &res[1], &tol[1], &trips[1]);
    project(u, f(W_GPSTAR), dt, small, f(P_VEL_OUT), f(P_P_OUT),
            f(P_GP_OUT));
    if (blockIdx.x == 0 && threadIdx.x == 0) {
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
    mark(kElem);
    if constexpr (kProbe) {
      // the last record: block 0 thread 0's clocks in the k-loops, and
      // of them those spent waiting for a k-tile
      if (blockIdx.x == 0 && threadIdx.x == 0 && nrec < a.probe_cap) {
        long long* r = a.probe + 3 * (a.probe_cap - 2);
        r[0] = -1;
        r[1] = wait_cyc;
        r[2] = kloop_cyc;
        r[3] = -2;
        r[4] = issue_cyc;
        r[5] = mma_cyc;
      }
    }
  }
};

template <typename T, bool kProbe>
__global__ void __launch_bounds__(kThreads, 1)
    step2d_kernel(const __grid_constant__ Args<T> a) {
  __shared__ T red[kWarps + 1];
  extern __shared__ __align__(16) unsigned char dyn[];
  Step<T, kProbe> s(a, red, dyn);
  s.run();
}

// The most blocks a cooperative launch of the kernel with `smem` bytes
// of dynamic shared memory may have on the current device: cooperative
// launch supported, occupancy x SM count (which also allows the kernel
// that shared memory).  The last answer is kept per instantiation.
template <typename T, bool kProbe>
int max_blocks(int smem, int* out) {
  static int last_dev = -1, last_smem = -1, last_out = 0;
  int dev = 0, sms = 0, coop = 0, per_sm = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev == last_dev && smem == last_smem) {
    *out = last_out;
    return 0;
  }
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess && smem > optin) e = cudaErrorInvalidValue;
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(step2d_kernel<T, kProbe>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, step2d_kernel<T, kProbe>, kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  if (!coop || per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  *out = per_sm * sms;
  last_dev = dev;
  last_smem = smem;
  last_out = *out;
  return 0;
}

template <typename T, bool kProbe = false>
int launch(const void* const* ptrs, const double* fp, const int* ip,
           const int* plan, int* nblk_out, long long* probe, int probe_cap,
           cudaStream_t st) {
  Args<T> a;
  a.probe = probe;
  a.probe_cap = probe_cap;
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
  if (a.nx < 4 || a.ny < 4 || a.nx > kMaxAxis || a.ny > kMaxAxis ||
      a.trips < 0)
    return (int)cudaErrorInvalidValue;
  // the wrapper's plan must be this source's
  const int nmax = a.nx > a.ny ? a.nx : a.ny;
  const int panels = (nmax + kPanel - 1) / kPanel;
  const int smem = smem_bytes<T>(a.nx, a.ny);
  if (plan[L_PANEL] != kPanel || plan[L_KTILE] != kKT<T> ||
      plan[L_CTAS] != panels || plan[L_SMEM] != smem)
    return (int)cudaErrorInvalidValue;
  int cap = 0;
  int e = max_blocks<T, kProbe>(smem, &cap);
  if (e) return e;
  // one CTA a panel, no more than can be resident (the cooperative
  // contract); past that a CTA walks several panels
  const int nblk = panels < cap ? panels : cap;
  *nblk_out = nblk;
  void* args[] = {&a};
  cudaError_t r = cudaLaunchCooperativeKernel(
      (const void*)step2d_kernel<T, kProbe>, dim3(nblk), dim3(kThreads),
      args, (size_t)smem, st);
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

// The most blocks a cooperative launch of the kernel with `smem` bytes of
// dynamic shared memory may have on this card (occupancy x SM count), or
// an error code.
extern "C" int step2d_max_blocks(int dtype, int smem, int* out) {
  if (dtype == 0) return max_blocks<float, false>(smem, out);
  if (dtype == 1) return max_blocks<double, false>(smem, out);
  return (int)cudaErrorInvalidValue;
}

// plan: panel, k-tile depth, CTAs, dynamic shared-memory bytes
// (step2d_kernels.launch_plan), checked against this source.
extern "C" int step2d_launch(int dtype, const void* const* ptrs,
                             const double* fpar, const int* ipar,
                             const int* plan, int* nblk_out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(ptrs, fpar, ipar, plan, nblk_out, nullptr, 0, st);
  if (dtype == 1)
    return launch<double>(ptrs, fpar, ipar, plan, nblk_out, nullptr, 0, st);
  return (int)cudaErrorInvalidValue;
}

// The probe instantiation: the same step, block 0 stamping each segment
// into probe (probe_cap records of 3 long longs: kind, %globaltimer ns,
// clock64; kinds kStart, kTransform, kBarrier, kElem, kFinish).  Never on
// the main path: step2d_kernels.FusedStep.probe calls it.
extern "C" int step2d_launch_probe(int dtype, const void* const* ptrs,
                                   const double* fpar, const int* ipar,
                                   const int* plan, int* nblk_out,
                                   void* probe, int probe_cap,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  long long* pr = static_cast<long long*>(probe);
  if (dtype == 0)
    return launch<float, true>(ptrs, fpar, ipar, plan, nblk_out, pr,
                               probe_cap, st);
  if (dtype == 1)
    return launch<double, true>(ptrs, fpar, ipar, plan, nblk_out, pr,
                                probe_cap, st);
  return (int)cudaErrorInvalidValue;
}
