// Red-black multigrid smoothers on 3D grids, for NVIDIA Hopper (sm_90a).
// Two kernel families with a plain C interface, bound from
// incflo_torch/ops/smoother_kernels.py with ctypes:
//
//   smoother_cell   replaces incflo_tpu/ops/pallas_cell.py:_smooth_kernel
//                   and :_tiled_kernel (one function at two sizes there)
//                   on fully periodic levels, and
//                   incflo_tpu/ops/pallas_smoother.py:_rb_kernel on levels
//                   with a Neumann or Dirichlet side on any axis
//   smoother_nodal  replaces incflo_tpu/ops/pallas_nodal.py:_smooth_kernel
//                   and :_tiled_kernel (fully periodic levels)
//
// Each entry runs `nsweeps` red-black sweeps and, when `res` is not null,
// the residual b - L(x), as a sequence of launches on the caller's
// stream: one per colour pass and one for the residual.  A launch is a
// grid-wide barrier, which is what a colour pass needs; the TPU kernels'
// whole-level-in-VMEM form and their x-slab tiling with a shrinking halo
// are answers to a 16 MB fast memory and do not carry over, so one
// family covers every level size.  Both are bound by memory traffic:
// per pass the cell smoother moves 8 arrays (x, b, diag, dinv, three
// face coefficients in, x out), the nodal one 5, against 20 and ~400
// operations per point.
//
// Cell operator (diag-extracted form, face coefficients pre-scaled by
// beta/dx^2; F_ax(i) is the coefficient of the face between i and
// i + e_ax, so the low face of i is F_ax(i - e_ax)):
//     L(x) = diag*x - sum_ax (F_ax(i) x(i+e_ax) + F_ax(i-e_ax) x(i-e_ax))
// A cell's 7-point stencil touches only the other colour, so a pass
// updates in place -- except across the wrap of a periodic axis with an
// odd number of cells, whose first and last cell share a colour: such a
// level is smoothed out of place, between two buffers.  Arrays are (nx, ny, nz, nc) with the nc components
// last and uncoloured; one thread per element, so neighbouring threads
// read neighbouring addresses for any nc.
//
// Walls (the kWalls instantiation).  Each side of each axis is periodic
// (0), Neumann (1) or Dirichlet (2).  In the diag-extracted form a wall
// changes only the two neighbour coefficients of the cells that touch
// it; `diag` already carries the wall face with factor 0 (Neumann) or 3
// (Dirichlet, from the maxorder-3 ghost -2*x0 + x1/3):
//     Neumann:   no neighbour across the wall (coefficient 0);
//     Dirichlet: none either, and the ghost's x1/3 adds a third of the
//                wall face's coefficient to the OPPOSITE neighbour.
// The opposite neighbour has the other colour, so a pass still updates in
// place, on every axis alike: the ghosts a pass sees are always those of
// the current iterate.  F_ax(n-1) is the high wall face; the low wall
// face, which the wrap of a periodic axis would find at F_ax(n-1), comes
// as a separate plane W_ax of shape (.., 1, ..).  The Pallas kernel's
// merged (y, z) lane axis, its x slabs of TBx+8 rows at 8-aligned
// offsets, its nine DMA copies and its red pass on a slab+1 ring answer
// VMEM and Mosaic's tiling rules and have no counterpart here; nor has
// its stale ghost at a non-periodic x boundary, which that x tiling
// caused.
//
// Nodal operator (Q1 finite elements, sigma at cells, phi at nodes; node
// i is the low corner of cell i):
//     L(phi) = sum_p A_p^T (C_p sigma . (A_p phi))
// over the 7 patterns p in {s,d}^3 \ {sss}; A_p contracts a cell's 8
// corner nodes with (lo+hi) on an `s` axis and (lo-hi) on a `d` axis,
// A_p^T scatters back with the same signs.  The 27-point stencil couples
// nodes of one colour (an offset (1,1,0) keeps the parity), so a pass
// reads the old x everywhere and writes a second buffer.  One thread per
// node gathers its 27 neighbours and the 8 surrounding sigmas and walks
// the contraction and scatter trees in the order of the plain version
// (x, y, z down; z, y, x up; (ts+td) + shifted (ts-td) at each merge).
//
// Build with -fmad=false: no multiply-add is contracted, every operation
// rounds as the plain PyTorch version's does, and the two agree to the
// last bits.  Periodic neighbours come from index wrap; an axis of 2
// cells, where both neighbours are the same cell, needs no special case.
// Each entry returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr int kNoColor = 2;  // a pass that updates nothing: a copy
constexpr int kPeriodic = 0;
constexpr int kDirichlet = 2;
constexpr double kThird = 1.0 / 3.0;

struct Dim {
  int n[3];
  int nc;     // trailing components (1 for a scalar field)
  int total;  // nx * ny * nz * nc
};

__device__ __forceinline__ int up(int i, int n) { return i + 1 == n ? 0 : i + 1; }
__device__ __forceinline__ int dn(int i, int n) { return i == 0 ? n - 1 : i - 1; }

__device__ __forceinline__ int elem(const Dim& g, int i, int j, int k, int c) {
  return ((i * g.n[1] + j) * g.n[2] + k) * g.nc + c;
}

// this thread's element e = (p[0], p[1], p[2], c); false past the end
__device__ __forceinline__ bool thread_elem(const Dim& g, int& e, int p[3],
                                            int& c) {
  e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= g.total) return false;
  c = e % g.nc;
  int r = e / g.nc;
  p[2] = r % g.n[2];
  r /= g.n[2];
  p[1] = r % g.n[1];
  p[0] = r / g.n[1];
  return true;
}

// ---------------------------------------------------------------------
// cell smoother
// ---------------------------------------------------------------------

template <typename T>
struct CellArgs {
  Dim g;
  const T* src;  // may alias dst (in-place pass)
  T* dst;
  const T* b;
  const T* diag;
  const T* dinv;
  const T* F[3];
  const T* W[3];  // low wall face plane of a walled axis, else null
  int bc[3][2];   // [axis][lo, hi]: 0 periodic, 1 Neumann, 2 Dirichlet
  int color;
};

// element of the plane W_ax (extent 1 along ax) under cell p
template <typename T>
__device__ __forceinline__ int wall_elem(const CellArgs<T>& a, int ax,
                                         const int p[3], int c) {
  const Dim& g = a.g;
  const int n1 = ax == 1 ? 1 : g.n[1], n2 = ax == 2 ? 1 : g.n[2];
  const int i = ax == 0 ? 0 : p[0], j = ax == 1 ? 0 : p[1],
            k = ax == 2 ? 0 : p[2];
  return ((i * n1 + j) * n2 + k) * g.nc + c;
}

template <typename T, bool kWalls>
__device__ __forceinline__ T cell_apply(const CellArgs<T>& a, const T* x,
                                        int e, const int p[3], int c) {
  const Dim& g = a.g;
  T out = a.diag[e] * x[e];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    int q[3] = {p[0], p[1], p[2]};
    q[ax] = up(p[ax], g.n[ax]);
    const int eE = elem(g, q[0], q[1], q[2], c);
    q[ax] = dn(p[ax], g.n[ax]);
    const int eW = elem(g, q[0], q[1], q[2], c);
    T chi = a.F[ax][e];    // coefficient of x(i + e_ax)
    T clo = a.F[ax][eW];   // coefficient of x(i - e_ax)
    if (kWalls && a.bc[ax][0] != kPeriodic) {
      // the wrapped neighbour of a wall cell is still read, times 0
      if (p[ax] == g.n[ax] - 1) {
        const T fwall = chi;
        chi = T(0);
        if (a.bc[ax][1] == kDirichlet) clo = clo + fwall * T(kThird);
      }
      if (p[ax] == 0) {
        clo = T(0);
        if (a.bc[ax][0] == kDirichlet)
          chi = chi + a.W[ax][wall_elem(a, ax, p, c)] * T(kThird);
      }
    }
    out = out - (chi * x[eE] + clo * x[eW]);
  }
  return out;
}

template <typename T, bool kWalls>
__global__ void __launch_bounds__(kBlock) cell_pass(const CellArgs<T> a) {
  int e, p[3], c;
  if (!thread_elem(a.g, e, p, c)) return;
  if (((p[0] + p[1] + p[2]) & 1) == a.color) {
    const T x = a.src[e];
    a.dst[e] =
        x + (a.b[e] - cell_apply<T, kWalls>(a, a.src, e, p, c)) * a.dinv[e];
  } else if (a.src != a.dst) {
    a.dst[e] = a.src[e];
  }
}

template <typename T, bool kWalls>
__global__ void __launch_bounds__(kBlock) cell_residual(const CellArgs<T> a) {
  int e, p[3], c;
  if (!thread_elem(a.g, e, p, c)) return;
  a.dst[e] = a.b[e] - cell_apply<T, kWalls>(a, a.src, e, p, c);
}

// ---------------------------------------------------------------------
// nodal smoother
// ---------------------------------------------------------------------

template <typename T>
struct NodalArgs {
  Dim g;
  const T* src;  // never aliases dst
  T* dst;
  const T* b;
  const T* sig;
  const T* dinv;
  T C[8];  // pattern p0*4 + p1*2 + p2, bit set = `d`; C[0] unused
  int color;
};

// C_p sigma . (A_p phi) of the cell whose low corner is v[la][lb][lc]
template <typename T>
__device__ __forceinline__ void cell_terms(const T (&v)[3][3][3], int la,
                                           int lb, int lc, T sg,
                                           const T (&C)[8], T (&t)[8]) {
  T a0[2][2][2], a1[2][2][2];
#pragma unroll
  for (int b = 0; b < 2; ++b)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const T lo = v[la][lb + b][lc + c], hi = v[la + 1][lb + b][lc + c];
      a0[0][b][c] = lo + hi;
      a0[1][b][c] = lo - hi;
    }
#pragma unroll
  for (int p0 = 0; p0 < 2; ++p0)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      a1[p0][0][c] = a0[p0][0][c] + a0[p0][1][c];
      a1[p0][1][c] = a0[p0][0][c] - a0[p0][1][c];
    }
#pragma unroll
  for (int p0 = 0; p0 < 2; ++p0)
#pragma unroll
    for (int p1 = 0; p1 < 2; ++p1) {
      const int i = p0 * 4 + p1 * 2;
      const T ys = a1[p0][p1][0] + a1[p0][p1][1];
      const T yd = a1[p0][p1][0] - a1[p0][p1][1];
      t[i] = i == 0 ? T(0) : (C[i] * sg) * ys;
      t[i + 1] = (C[i + 1] * sg) * yd;
    }
}

template <typename T>
__device__ __forceinline__ T nodal_apply(const NodalArgs<T>& a, const T* x,
                                         const int p[3]) {
  const Dim& g = a.g;
  int im[3][3];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    im[ax][0] = dn(p[ax], g.n[ax]);
    im[ax][1] = p[ax];
    im[ax][2] = up(p[ax], g.n[ax]);
  }
  T v[3][3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int k = 0; k < 3; ++k)
        v[i][j][k] = x[elem(g, im[0][i], im[1][j], im[2][k], 0)];
  // o = 0: the cell at this node's index, o = 1: the one below it
  T wy[2][2];
#pragma unroll
  for (int oi = 0; oi < 2; ++oi) {
    T wz[2][2][2];
#pragma unroll
    for (int oj = 0; oj < 2; ++oj) {
      T t[2][8];
#pragma unroll
      for (int ok = 0; ok < 2; ++ok) {
        const T sg = a.sig[elem(g, im[0][1 - oi], im[1][1 - oj],
                                im[2][1 - ok], 0)];
        cell_terms(v, 1 - oi, 1 - oj, 1 - ok, sg, a.C, t[ok]);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)  // q = p0 * 2 + p1
        wz[oj][q >> 1][q & 1] = (t[0][2 * q] + t[0][2 * q + 1]) +
                                (t[1][2 * q] - t[1][2 * q + 1]);
    }
#pragma unroll
    for (int p0 = 0; p0 < 2; ++p0)
      wy[oi][p0] = (wz[0][p0][0] + wz[0][p0][1]) +
                   (wz[1][p0][0] - wz[1][p0][1]);
  }
  return (wy[0][0] + wy[0][1]) + (wy[1][0] - wy[1][1]);
}

template <typename T>
__global__ void __launch_bounds__(kBlock) nodal_pass(const NodalArgs<T> a) {
  int e, p[3], c;
  if (!thread_elem(a.g, e, p, c)) return;
  T x = a.src[e];
  if (((p[0] + p[1] + p[2]) & 1) == a.color)
    x = x + (a.b[e] - nodal_apply(a, a.src, p)) * a.dinv[e];
  a.dst[e] = x;
}

template <typename T>
__global__ void __launch_bounds__(kBlock) nodal_residual(const NodalArgs<T> a) {
  int e, p[3], c;
  if (!thread_elem(a.g, e, p, c)) return;
  a.dst[e] = a.b[e] - nodal_apply(a, a.src, p);
}

// ---------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------

template <typename Args>
int launch(void (*kernel)(Args), const Args& a, cudaStream_t st) {
  const unsigned int blocks = (unsigned int)((a.g.total + kBlock - 1) / kBlock);
  kernel<<<blocks, kBlock, 0, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, bool kWalls>
int run_cell(const void* x, const void* b, const void* diag, const void* dinv,
             const void* f0, const void* f1, const void* f2,
             const void* const w[3], const int* bc, void* out, void* tmp,
             void* res, const Dim& g, int nsweeps, cudaStream_t st) {
  CellArgs<T> a;
  a.g = g;
  for (int ax = 0; ax < 3; ++ax) {
    a.W[ax] = static_cast<const T*>(w[ax]);
    a.bc[ax][0] = bc[2 * ax];
    a.bc[ax][1] = bc[2 * ax + 1];
  }
  a.b = static_cast<const T*>(b);
  a.diag = static_cast<const T*>(diag);
  a.dinv = static_cast<const T*>(dinv);
  a.F[0] = static_cast<const T*>(f0);
  a.F[1] = static_cast<const T*>(f1);
  a.F[2] = static_cast<const T*>(f2);
  a.src = static_cast<const T*>(x);
  a.dst = static_cast<T*>(out);
  int rc = 0;
  if (nsweeps == 0) {
    a.color = kNoColor;
    rc = launch(cell_pass<T, kWalls>, a, st);
  }
  // the first pass copies the other colour from x to out; later passes
  // update out in place.  With `tmp` (an odd periodic axis, where the
  // wrap couples two cells of one colour) every pass writes the other
  // buffer instead, tmp for s even and out for s odd, so that it reads
  // the previous pass's values everywhere, as the plain version does.
  T* bufs[2] = {static_cast<T*>(tmp ? tmp : out), static_cast<T*>(out)};
  for (int s = 0; s < 2 * nsweeps && !rc; ++s) {
    a.color = s & 1;
    a.dst = bufs[s & 1];
    rc = launch(cell_pass<T, kWalls>, a, st);
    a.src = a.dst;
  }
  if (!rc && res) {
    a.src = static_cast<const T*>(out);
    a.dst = static_cast<T*>(res);
    rc = launch(cell_residual<T, kWalls>, a, st);
  }
  return rc;
}

// bc holds (lo, hi) per axis.  A walled axis is non-periodic on both
// sides, has at least 2 cells, and brings its low wall plane when that
// side is Dirichlet.  Sets `walls` when any axis is walled and `odd_wrap`
// when a periodic axis has an odd number (> 1) of cells.
bool check_bc(const int* bc, const void* const w[3], const Dim& g,
              bool& walls, bool& odd_wrap) {
  walls = odd_wrap = false;
  for (int ax = 0; ax < 3; ++ax) {
    const int lo = bc[2 * ax], hi = bc[2 * ax + 1];
    if (lo < 0 || lo > 2 || hi < 0 || hi > 2) return false;
    if ((lo == kPeriodic) != (hi == kPeriodic)) return false;
    if (lo == kPeriodic) {
      if (g.n[ax] > 1 && g.n[ax] % 2) odd_wrap = true;
      continue;
    }
    walls = true;
    if (g.n[ax] < 2) return false;
    if (lo == kDirichlet && !w[ax]) return false;
  }
  return true;
}

template <typename T>
int run_nodal(const void* x, const void* b, const void* sig, const void* dinv,
              const double* coef, void* out, void* tmp, void* res,
              const Dim& g, int nsweeps, cudaStream_t st) {
  NodalArgs<T> a;
  a.g = g;
  a.b = static_cast<const T*>(b);
  a.sig = static_cast<const T*>(sig);
  a.dinv = static_cast<const T*>(dinv);
  for (int i = 0; i < 8; ++i) a.C[i] = static_cast<T>(coef[i]);
  T* bufs[2] = {static_cast<T*>(tmp), static_cast<T*>(out)};
  a.src = static_cast<const T*>(x);
  int rc = 0;
  if (nsweeps == 0) {
    a.dst = bufs[1];
    a.color = kNoColor;
    rc = launch(nodal_pass<T>, a, st);
  }
  // pass s writes tmp (s even) or out (s odd): the last pass writes out
  for (int s = 0; s < 2 * nsweeps && !rc; ++s) {
    a.dst = bufs[s & 1];
    a.color = s & 1;
    rc = launch(nodal_pass<T>, a, st);
    a.src = a.dst;
  }
  if (!rc && res) {
    a.src = static_cast<const T*>(out);
    a.dst = static_cast<T*>(res);
    rc = launch(nodal_residual<T>, a, st);
  }
  return rc;
}

bool make_dim(int nx, int ny, int nz, int nc, Dim& g) {
  if (nx < 1 || ny < 1 || nz < 1 || nc < 1) return false;
  g.n[0] = nx;
  g.n[1] = ny;
  g.n[2] = nz;
  g.nc = nc;
  g.total = nx * ny * nz * nc;
  return true;
}

}  // namespace

// dtype: 0 = float32, 1 = float64.  All arrays are dense (nx, ny, nz, nc);
// `res` may be null (no residual); `out` and `res` alias no input.  `bc`
// points at 6 ints on the host, (lo, hi) per axis; w0..w2 are the low
// wall face planes of the walled axes, dense with extent 1 along their
// axis, and may be null on periodic axes.  `tmp` is scratch of the size
// of x, needed (and used) only when a periodic axis has an odd number of
// cells and nsweeps > 0.  The caller guarantees nx*ny*nz*nc < 2^31.
// Returns a cudaError_t value.
extern "C" int smoother_cell(int dtype, const void* x, const void* b,
                             const void* diag, const void* dinv,
                             const void* f0, const void* f1, const void* f2,
                             const void* w0, const void* w1, const void* w2,
                             const int* bc, void* out, void* tmp, void* res,
                             int nx, int ny, int nz, int nc, int nsweeps,
                             void* stream) {
  Dim g;
  const void* const w[3] = {w0, w1, w2};
  bool walls = false, odd_wrap = false;
  if (!make_dim(nx, ny, nz, nc, g) || nsweeps < 0 || !bc ||
      !check_bc(bc, w, g, walls, odd_wrap))
    return (int)cudaErrorInvalidValue;
  if (odd_wrap && nsweeps > 0 && !tmp) return (int)cudaErrorInvalidValue;
  if (!odd_wrap) tmp = nullptr;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return walls ? run_cell<float, true>(x, b, diag, dinv, f0, f1, f2, w, bc,
                                         out, tmp, res, g, nsweeps, st)
                 : run_cell<float, false>(x, b, diag, dinv, f0, f1, f2, w,
                                          bc, out, tmp, res, g, nsweeps, st);
  if (dtype == 1)
    return walls ? run_cell<double, true>(x, b, diag, dinv, f0, f1, f2, w,
                                          bc, out, tmp, res, g, nsweeps, st)
                 : run_cell<double, false>(x, b, diag, dinv, f0, f1, f2, w,
                                           bc, out, tmp, res, g, nsweeps, st);
  return (int)cudaErrorInvalidValue;
}

// `coef` points at 8 doubles on the host: the pattern coefficients C_p.
// `tmp` is scratch of the size of x (unused when nsweeps == 0).
extern "C" int smoother_nodal(int dtype, const void* x, const void* b,
                              const void* sig, const void* dinv,
                              const double* coef, void* out, void* tmp,
                              void* res, int nx, int ny, int nz, int nsweeps,
                              void* stream) {
  Dim g;
  if (!make_dim(nx, ny, nz, 1, g) || nsweeps < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run_nodal<float>(x, b, sig, dinv, coef, out, tmp, res, g, nsweeps,
                            st);
  if (dtype == 1)
    return run_nodal<double>(x, b, sig, dinv, coef, out, tmp, res, g, nsweeps,
                             st);
  return (int)cudaErrorInvalidValue;
}
