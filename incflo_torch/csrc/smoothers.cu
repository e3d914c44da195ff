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
//                   and :_tiled_kernel on fully periodic levels, and the
//                   jnp sweep incflo_tpu runs on levels with walls
//                   (incflo_tpu/ops/multigrid.py:1018)
//
// Each entry runs `nsweeps` red-black sweeps and, when `res` is not null,
// the residual b - L(x), in ONE launch on the caller's stream, in one of
// two regimes:
//
//   resident  a small level (1024 cells or 128 nodes of each colour, so
//             that a cell thread owns one of each): one CTA loads x into
//             shared memory, runs every colour pass with __syncthreads()
//             between them, and writes x and the residual once.  Every
//             bottom smooth takes it.  Above these sizes one SM's passes
//             take longer than the grid's barriers cost (measured).
//   grid      a cooperative launch of at most the co-resident number of
//             CTAs, grid.sync() between dependent passes; x moves between
//             passes through global memory, which stays in L2.
//
// What bounds them on an H100 is latency, not bytes or operations: a
// 2-sweep call with residual at 128x128x32 moves ~19 MB (cell, 6 us at
// HBM rate) and a coarse level far less, while each launch and each grid
// barrier costs microseconds (more CTAs, a dearer barrier).  So a call is
// one launch and a pass a barrier; a multi-sweep call gains the most.
// Besides:
//   - a pass enumerates only the cells or nodes of the colour it updates
//     (colour-compact slots: along the fastest axis a row holds ceil(n/2)
//     slots of each colour), so no lane of a warp idles on the colour
//     test;
//   - cell: each thread owns fixed slots for the whole call; for its
//     first `keep` slots of each colour the coefficients (b, dinv, diag
//     and the six neighbour coefficients, walls folded in) and the packed
//     position are read once into shared memory and held across every
//     pass, the rest stream from L2 every pass; a pass takes two slots at
//     a time so that their loads are in flight together.  Grid CTAs have
//     1024 threads where the level gives every SM one (fewer CTAs, a
//     cheaper barrier), else 64-256, spread over the SMs;
//   - nodal: both regimes walk bricks of nodes.  Every pass stages a
//     brick's x plus a one-node halo in shared memory, computes the seven
//     terms C_p sigma . (A_p phi) of each of its cells once (not once for
//     each of a cell's 8 corner nodes), merged pairwise as the scatter
//     tree's first level, and scatters them to the nodes of the colour it
//     updates.  The brick's sigma tile is staged once and held across
//     every pass when every CTA owns one brick; b and dinv are read
//     through the read-only cache.  Tile loops walk their boxes with
//     carries instead of a division per point.
//
// Cell operator (diag-extracted form, face coefficients pre-scaled by
// beta/dx^2; F_ax(i) is the coefficient of the face between i and
// i + e_ax, so the low face of i is F_ax(i - e_ax)):
//     L(x) = diag*x - sum_ax (F_ax(i) x(i+e_ax) + F_ax(i-e_ax) x(i-e_ax))
// A cell's 7-point stencil touches only the other colour, so a pass
// updates in place -- except across the wrap of a periodic axis with an
// odd number of cells, whose first and last cell share a colour: such a
// level is smoothed out of place, between two buffers.  Arrays are (nx,
// ny, nz, nc) with the nc components last and uncoloured.
//
// Walls of the cell operator (the kWalls instantiation).  Each side of
// each axis is periodic (0), Neumann (1) or Dirichlet (2).  In the
// diag-extracted form a wall changes only the two neighbour coefficients
// of the cells that touch it; `diag` already carries the wall face with
// factor 0 (Neumann) or 3 (Dirichlet, from the maxorder-3 ghost -2*x0 +
// x1/3):
//     Neumann:   no neighbour across the wall (coefficient 0);
//     Dirichlet: none either, and the ghost's x1/3 adds a third of the
//                wall face's coefficient to the OPPOSITE neighbour.
// The opposite neighbour has the other colour, so a pass still updates in
// place.  F_ax(n-1) is the high wall face; the low wall face comes as a
// separate plane W_ax of shape (.., 1, ..).
//
// A periodic axis may carry such a plane too: then the coefficient of
// x(n-1) in the row of cell 0 is W_ax and not F_ax(n-1).  The cut-cell
// velocity operator of an EB deck has it (incflo_tpu's viscosity at the
// face centroids of face 0 and face n of a periodic axis differ, and its
// operator reads each), so the kernel applies the operator the flux form
// of incflo_tpu's sweep applies.
//
// On a rank's extended x slab of such a level (the slab forms: x open,
// Neumann codes) the level's cell 0 lies inside the array: at plane lo on
// the first rank, at plane lo + nxl (the right halo) on the last.  The x
// wrap plane XW then gives the coefficient of x(i-1) in the rows of those
// planes (xw_at, -1 for none), where F_0 of the plane before holds face n.
//
// Nodal operator (Q1 finite elements, sigma at cells, phi at nodes; node
// i is the low corner of cell i):
//     L(phi) = sum_p A_p^T (C_p sigma . (A_p phi))
// over the 7 patterns p in {s,d}^3 \ {sss}; A_p contracts a cell's 8
// corner nodes with (lo+hi) on an `s` axis and (lo-hi) on a `d` axis,
// A_p^T scatters back with the same signs.  The 27-point stencil couples
// nodes of one colour, so a pass reads the old x everywhere and writes a
// second buffer.  The contraction and scatter trees are walked in the
// order of the plain version (x, y, z down; z, y, x up; (ts+td) +
// shifted (ts-td) at each merge).  On a walled axis the level has n+1
// nodes for n cells; sigma outside the domain and x beyond the last node
// are zero, which makes each merge the plain version's a[i] + b[i-1]
// with exact zeros at both ends; a node on a Dirichlet side is an
// identity row (L = x).
//
// Build with -fmad=false: no multiply-add is contracted, every operation
// rounds as the plain PyTorch version's does, and the two agree to the
// last bits whatever thread computes a point and when.  Each entry returns
// a cudaError_t value and reports the launches it enqueued.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int kPeriodic = 0;
constexpr int kDirichlet = 2;
constexpr double kThird = 1.0 / 3.0;
constexpr int kCellThreads = 1024;   // most threads of a cell CTA
constexpr int kNodalThreads = 512;   // most threads of a nodal CTA
constexpr int kNodalResident = 128;  // most nodes of a colour, resident
constexpr int kCellCoefs = 9;  // b, dinv, diag, hi[3], lo[3]
constexpr int kMaxKeep = 8;

enum Regime { kAuto = 0, kResident = 1, kGrid = 2 };

struct Dim {
  int n[3];
  int nc;     // trailing components (1 for a scalar field)
  int total;  // nx * ny * nz * nc
  int h;      // slots of one colour in a row along z: ceil(nz / 2)
  int slots;  // slots of one colour: nx * ny * h * nc
};

__device__ __forceinline__ int up(int i, int n) { return i + 1 == n ? 0 : i + 1; }
__device__ __forceinline__ int dn(int i, int n) { return i == 0 ? n - 1 : i - 1; }

__device__ __forceinline__ int elem(const Dim& g, int i, int j, int k, int c) {
  return ((i * g.n[1] + j) * g.n[2] + k) * g.nc + c;
}

// Slot t (< g.slots) of colour `color`: its element e = (p, c).  False for
// the idle slot at the end of a row of odd length.
__device__ __forceinline__ bool slot_elem(const Dim& g, int color, int t,
                                          int& e, int p[3], int& c) {
  c = t % g.nc;
  const int u = t / g.nc;
  const int r = u / g.h;
  const int m = u - r * g.h;
  p[0] = r / g.n[1];
  p[1] = r - p[0] * g.n[1];
  p[2] = 2 * m + ((color + p[0] + p[1]) & 1);
  if (p[2] >= g.n[2]) return false;
  e = elem(g, p[0], p[1], p[2], c);
  return true;
}

// ---------------------------------------------------------------------
// cell smoother
// ---------------------------------------------------------------------

template <typename T>
struct CellArgs {
  Dim g;
  const T* x;  // input, never written
  T* out;
  T* tmp;      // second buffer of the grid regime on an odd periodic axis
  T* res;      // null: no residual
  const T* b;
  const T* diag;
  const T* dinv;
  const T* F[3];
  const T* W[3];  // low face plane: of a walled axis; of a periodic axis
                  // whose face 0 differs from face n; else null
  const T* XW;    // x wrap plane at interior x planes xw_at, or null
  int xw_at[2];
  int bc[3][2];   // [axis][lo, hi]: 0 periodic, 1 Neumann, 2 Dirichlet
  int nsweeps;
  int odd_wrap;   // a periodic axis of odd length: passes out of place
  int keep;       // slots of each colour held in shared memory
};

template <typename T>
struct CellCoef {
  T b, dinv, diag, hi[3], lo[3];
};

// A held slot's position, packed: 10 bits per axis and 2 for the
// component (the host holds slots only on levels where they fit).
constexpr unsigned kNoSlot = 0xffffffffu;

__device__ __forceinline__ unsigned pack(const int p[3], int c) {
  return unsigned(p[0]) | unsigned(p[1]) << 10 | unsigned(p[2]) << 20 |
         unsigned(c) << 30;
}

__device__ __forceinline__ int unpack(const Dim& g, unsigned w, int p[3],
                                      int& c) {
  p[0] = w & 1023u;
  p[1] = (w >> 10) & 1023u;
  p[2] = (w >> 20) & 1023u;
  c = w >> 30;
  return elem(g, p[0], p[1], p[2], c);
}

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

// the read-only coefficients of element e, walls folded into the
// neighbour coefficients as the plain version's cell_neighbour_coefs does
template <typename T, bool kWalls>
__device__ __forceinline__ void cell_coef(const CellArgs<T>& a, int e,
                                          const int p[3], int c,
                                          CellCoef<T>& k) {
  const Dim& g = a.g;
  k.b = a.b[e];
  k.dinv = a.dinv[e];
  k.diag = a.diag[e];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    int q[3] = {p[0], p[1], p[2]};
    q[ax] = dn(p[ax], g.n[ax]);
    T chi = a.F[ax][e];                                 // of x(i + e_ax)
    T clo = a.F[ax][elem(g, q[0], q[1], q[2], c)];      // of x(i - e_ax)
    // a periodic axis whose face 0 differs from face n: the wrap plane
    if (a.bc[ax][0] == kPeriodic && a.W[ax] && p[ax] == 0)
      clo = a.W[ax][wall_elem(a, ax, p, c)];
    // the level's x wrap inside an extended slab
    if (ax == 0 && a.XW && (p[0] == a.xw_at[0] || p[0] == a.xw_at[1]))
      clo = a.XW[wall_elem(a, 0, p, c)];
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
    k.hi[ax] = chi;
    k.lo[ax] = clo;
  }
}

// What a thread holds of its first `keep` slots of each colour, in shared
// memory: the coefficients [slot q][colour][coefficient][thread] and the
// packed positions [slot q][colour][thread].
template <typename T>
struct Held {
  T* coef;
  unsigned* pos;
  __device__ __forceinline__ T& at(int q, int color, int v) const {
    return coef[((q * 2 + color) * kCellCoefs + v) * blockDim.x + threadIdx.x];
  }
  __device__ __forceinline__ unsigned& where(int q, int color) const {
    return pos[(q * 2 + color) * blockDim.x + threadIdx.x];
  }
};

// slot q (the thread's slot t) of colour `color`: its element, or false
template <typename T>
__device__ __forceinline__ bool find_slot(const CellArgs<T>& a,
                                          const Held<T>& h, int q, int color,
                                          int t, int& e, int p[3], int& c) {
  if (q < a.keep) {
    const unsigned w = h.where(q, color);
    if (w == kNoSlot) return false;
    e = unpack(a.g, w, p, c);
    return true;
  }
  return t < a.g.slots && slot_elem(a.g, color, t, e, p, c);
}

template <typename T, bool kWalls>
__device__ __forceinline__ void coef_of(const CellArgs<T>& a,
                                        const Held<T>& h, int q, int color,
                                        int e, const int p[3], int c,
                                        CellCoef<T>& k) {
  if (q >= a.keep) {
    cell_coef<T, kWalls>(a, e, p, c, k);
    return;
  }
  k.b = h.at(q, color, 0);
  k.dinv = h.at(q, color, 1);
  k.diag = h.at(q, color, 2);
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    k.hi[ax] = h.at(q, color, 3 + ax);
    k.lo[ax] = h.at(q, color, 6 + ax);
  }
}

// L(x) at element e; x is shared (resident) or global (grid) memory
template <typename T>
__device__ __forceinline__ T cell_apply(const Dim& g, const CellCoef<T>& k,
                                        const T* x, int e, const int p[3],
                                        int c) {
  T out = k.diag * x[e];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    int q[3] = {p[0], p[1], p[2]};
    q[ax] = up(p[ax], g.n[ax]);
    const int eE = elem(g, q[0], q[1], q[2], c);
    q[ax] = dn(p[ax], g.n[ax]);
    const int eW = elem(g, q[0], q[1], q[2], c);
    out = out - (k.hi[ax] * x[eE] + k.lo[ax] * x[eW]);
  }
  return out;
}

// Thread `gid` of `nthreads` owns slot gid + q*nthreads of each colour,
// for q = 0, 1, ...: the same slots in every pass.  A pass takes them two
// at a time, so that the loads of both are in flight together.
template <typename T, bool kWalls, bool kResident>
__global__ void __launch_bounds__(kCellThreads) cell_kernel(const CellArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Dim& g = a.g;
  const int nthreads = gridDim.x * blockDim.x;
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  const int nq = (g.slots + nthreads - 1) / nthreads;
  T* base = reinterpret_cast<T*>(smem);
  const int nbuf = kResident ? (a.odd_wrap ? 2 : 1) : 0;
  Held<T> h;
  h.coef = base + nbuf * g.total;
  h.pos = reinterpret_cast<unsigned*>(h.coef + a.keep * 2 * kCellCoefs *
                                                   blockDim.x);
  for (int q = 0; q < a.keep; ++q)
    for (int col = 0; col < 2; ++col) {
      const int t = gid + q * nthreads;
      int e, p[3], c;
      unsigned w = kNoSlot;
      if (t < g.slots && slot_elem(g, col, t, e, p, c)) {
        CellCoef<T> k;
        cell_coef<T, kWalls>(a, e, p, c, k);
        h.at(q, col, 0) = k.b;
        h.at(q, col, 1) = k.dinv;
        h.at(q, col, 2) = k.diag;
#pragma unroll
        for (int ax = 0; ax < 3; ++ax) {
          h.at(q, col, 3 + ax) = k.hi[ax];
          h.at(q, col, 6 + ax) = k.lo[ax];
        }
        w = pack(p, c);
      }
      h.where(q, col) = w;
    }
  // pass s writes bufs[s & 1]: the last pass (s odd) writes bufs[1]
  const T* src;
  T* bufs[2];
  if (kResident) {
    for (int i = threadIdx.x; i < g.total; i += blockDim.x) base[i] = a.x[i];
    __syncthreads();
    src = base;
    bufs[0] = a.odd_wrap ? base + g.total : base;
    bufs[1] = base;
  } else {
    src = a.x;
    bufs[0] = a.odd_wrap ? a.tmp : a.out;
    bufs[1] = a.out;
  }
  for (int s = 0; s < 2 * a.nsweeps; ++s) {
    const int col = s & 1;
    T* dst = bufs[col];
    for (int q0 = 0; q0 < nq; q0 += 2) {
      int e[2], p[2][3], c[2];
      bool ok[2];
      CellCoef<T> k[2];
      T r[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int q = q0 + u;
        ok[u] = q < nq &&
                find_slot(a, h, q, col, gid + q * nthreads, e[u], p[u], c[u]);
        if (ok[u]) coef_of<T, kWalls>(a, h, q, col, e[u], p[u], c[u], k[u]);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u)
        if (ok[u])
          r[u] = src[e[u]] +
                 (k[u].b - cell_apply(g, k[u], src, e[u], p[u], c[u])) *
                     k[u].dinv;
#pragma unroll
      for (int u = 0; u < 2; ++u)
        if (ok[u]) dst[e[u]] = r[u];
      // out of place (the first grid pass reads x, or an odd wrap):
      // the other colour is carried over
      if (src != dst)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int q = q0 + u;
          int ee, pp[3], cc;
          if (q < nq &&
              find_slot(a, h, q, col ^ 1, gid + q * nthreads, ee, pp, cc))
            dst[ee] = src[ee];
        }
    }
    if (kResident)
      __syncthreads();
    else
      cg::this_grid().sync();
    src = dst;
  }
  // src holds the final iterate: in shared memory (resident), in out
  // (grid, after a sweep) or x itself (grid, no sweep)
  const bool copy_out = kResident || a.nsweeps == 0;
  if (!copy_out && !a.res) return;
  for (int q = 0; q < nq; ++q)
    for (int col = 0; col < 2; ++col) {
      int e, p[3], c;
      if (!find_slot(a, h, q, col, gid + q * nthreads, e, p, c)) continue;
      if (copy_out) a.out[e] = src[e];
      if (a.res) {
        CellCoef<T> k;
        coef_of<T, kWalls>(a, h, q, col, e, p, c, k);
        a.res[e] = k.b - cell_apply(g, k, src, e, p, c);
      }
    }
}

// ---------------------------------------------------------------------
// nodal smoother
// ---------------------------------------------------------------------

template <typename T>
struct NodalArgs {
  Dim g;           // nodes; nc = 1
  int m[3];        // cells: n on a periodic axis, n - 1 on a walled one
  int wall[3];     // the axis has walls
  int dir[3][2];   // [axis][lo, hi] is a Dirichlet side
  const T* x;      // input, never written
  T* out;
  T* tmp;          // grid regime: pass s writes tmp (s even) or out (s odd)
  T* res;          // null: no residual
  const T* b;
  const T* sig;    // (m0, m1, m2)
  const T* dinv;
  T C[8];          // pattern p0*4 + p1*2 + p2, bit set = `d`; C[0] unused
  int nsweeps;
  int B[3];        // brick extents (a last brick may be short)
  int nb[3];       // bricks per axis
  int hold;        // one brick per CTA: its sigma tile staged once
};

template <typename T>
__device__ __forceinline__ bool dirichlet_node(const NodalArgs<T>& a,
                                               const int p[3]) {
  bool d = false;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax)
    d = d || (a.dir[ax][0] && p[ax] == 0) ||
        (a.dir[ax][1] && p[ax] == a.g.n[ax] - 1);
  return d;
}

// node index q along ax, or -1 past a wall
template <typename T>
__device__ __forceinline__ int node_at(const NodalArgs<T>& a, int ax, int q) {
  const int n = a.g.n[ax];
  if (a.wall[ax]) return q < 0 || q >= n ? -1 : q;
  return q < 0 ? q + n : q >= n ? q - n : q;
}

// cell index q along ax, or -1 outside the domain
template <typename T>
__device__ __forceinline__ int cell_at(const NodalArgs<T>& a, int ax, int q) {
  const int m = a.m[ax];
  if (a.wall[ax]) return q < 0 || q >= m ? -1 : q;
  return q < 0 ? q + m : q >= m ? q - m : q;
}

// one brick: low corner o, extents e
struct Brick {
  int o[3], e[3];
};

template <typename T>
__device__ __forceinline__ Brick brick_of(const NodalArgs<T>& a, int id) {
  Brick br;
  const int ib[3] = {id / (a.nb[1] * a.nb[2]), (id / a.nb[2]) % a.nb[1],
                     id % a.nb[2]};
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    br.o[ax] = ib[ax] * a.B[ax];
    br.e[ax] = min(a.B[ax], a.g.n[ax] - br.o[ax]);
  }
  return br;
}

// A brick's shared-memory tiles.  Its x with a one-node halo, xt, is
// (e0+2, e1+2, e2+2): tile index = node - (o - 1).  Its cells and their
// halo, o-1 .. o+e-1, are (e0+1, e1+1, e2+1): the cell whose low corner
// is tile node l has index l; st holds their sigma (zero outside the
// domain) and tt[2q], tt[2q+1] the sum and the difference (ts + td, ts -
// td) of the terms C_p sigma . (A_p phi) of the patterns p = 2q (ts; zero
// for q = 0) and 2q + 1 (td), q = p0*2 + p1.
template <typename T>
struct Tiles {
  T* xt;
  T* st;
  T* tt;
  int t1, t2, s1, s2, ns;
  __device__ __forceinline__ void shape(const Brick& br) {
    t1 = br.e[1] + 2;
    t2 = br.e[2] + 2;
    s1 = br.e[1] + 1;
    s2 = br.e[2] + 1;
    ns = (br.e[0] + 1) * s1 * s2;
  }
};

// tiles for bricks of at most B: x, sigma, 8 merged terms
__host__ __device__ __forceinline__ long long tile_elems(const int B[3]) {
  const long long cells = (B[0] + 1LL) * (B[1] + 1) * (B[2] + 1);
  return (B[0] + 2LL) * (B[1] + 2) * (B[2] + 2) + 9 * cells;
}

template <typename T>
__device__ __forceinline__ Tiles<T> tiles_at(const NodalArgs<T>& a, T* base) {
  Tiles<T> w;
  const long long cells = (a.B[0] + 1LL) * (a.B[1] + 1) * (a.B[2] + 1);
  w.xt = base;
  w.st = w.xt + (a.B[0] + 2) * (a.B[1] + 2) * (a.B[2] + 2);
  w.tt = w.st + cells;
  return w;
}

// The points idx = threadIdx.x, + blockDim.x, ... of a row-major box
// (n0, n1, n2), walked as (i, j, k) with one division at the start and
// carries after it.
struct BoxWalk {
  int n1, n2, i, j, k, di, dj, dk, idx;
  __device__ __forceinline__ BoxWalk(int n1_, int n2_) : n1(n1_), n2(n2_) {
    i = threadIdx.x / (n1 * n2);
    j = (threadIdx.x / n2) % n1;
    k = threadIdx.x % n2;
    di = blockDim.x / (n1 * n2);
    dj = (blockDim.x / n2) % n1;
    dk = blockDim.x % n2;
    idx = threadIdx.x;
  }
  __device__ __forceinline__ void next() {
    idx += blockDim.x;
    k += dk;
    const int ck = k >= n2;
    k -= ck ? n2 : 0;
    j += dj + ck;
    const int cj = j >= n1;
    j -= cj ? n1 : 0;
    i += di + cj;
  }
};

// sigma of the brick's cell with tile index (l0, l1, l2): cell o-1+l,
// zero outside the domain
template <typename T>
__device__ __forceinline__ T sigma_at(const NodalArgs<T>& a, const Brick& br,
                                      int l0, int l1, int l2) {
  const int c0 = cell_at(a, 0, br.o[0] - 1 + l0);
  const int c1 = cell_at(a, 1, br.o[1] - 1 + l1);
  const int c2 = cell_at(a, 2, br.o[2] - 1 + l2);
  return c0 < 0 || c1 < 0 || c2 < 0
             ? T(0)
             : __ldg(a.sig + (c0 * a.m[1] + c1) * a.m[2] + c2);
}

// stage the brick's sigma (zero outside the domain)
template <typename T>
__device__ void stage_sigma(const NodalArgs<T>& a, const Brick& br,
                            const Tiles<T>& w) {
#pragma unroll 4
  for (BoxWalk q(w.s1, w.s2); q.idx < w.ns; q.next())
    w.st[q.idx] = sigma_at(a, br, q.i, q.j, q.k);
}

// stage the brick's x with a one-node halo (wrapped on a periodic axis,
// zero past a wall) from src, global (grid) or shared (resident) memory
template <typename T>
__device__ void stage_x(const NodalArgs<T>& a, const Brick& br, const T* src,
                        const Tiles<T>& w) {
  const int nt = (br.e[0] + 2) * w.t1 * w.t2;
#pragma unroll 4
  for (BoxWalk q(w.t1, w.t2); q.idx < nt; q.next()) {
    const int q0 = node_at(a, 0, br.o[0] - 1 + q.i);
    const int q1 = node_at(a, 1, br.o[1] - 1 + q.j);
    const int q2 = node_at(a, 2, br.o[2] - 1 + q.k);
    w.xt[q.idx] =
        q0 < 0 || q1 < 0 || q2 < 0 ? T(0) : src[elem(a.g, q0, q1, q2, 0)];
  }
}

// the 7 terms of every cell of the tiles: the contraction tree down the
// axes (x, y, z) over the cell's 8 corners, times C_p sigma
template <typename T>
__device__ void cell_terms(const NodalArgs<T>& a, const Brick& br,
                           const Tiles<T>& w) {
  for (BoxWalk q(w.s1, w.s2); q.idx < w.ns; q.next()) {
    const int i = q.idx, l0 = q.i, l1 = q.j, l2 = q.k;
    T a0[2][2][2], a1[2][2][2];
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const T lo = w.xt[(l0 * w.t1 + l1 + b) * w.t2 + l2 + c];
        const T hi = w.xt[((l0 + 1) * w.t1 + l1 + b) * w.t2 + l2 + c];
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
    const T sg = w.st[i];
#pragma unroll
    for (int p0 = 0; p0 < 2; ++p0)
#pragma unroll
      for (int p1 = 0; p1 < 2; ++p1) {
        const int q = p0 * 2 + p1, pat = 2 * q;
        const T ys = a1[p0][p1][0] + a1[p0][p1][1];
        const T yd = a1[p0][p1][0] - a1[p0][p1][1];
        const T ts = pat ? (a.C[pat] * sg) * ys : T(0);
        const T td = (a.C[pat + 1] * sg) * yd;
        // the first merge of the scatter tree, (ts + td) and (ts - td)
        w.tt[(2 * q) * w.ns + i] = ts + td;
        w.tt[(2 * q + 1) * w.ns + i] = ts - td;
      }
  }
}

// L at brick-local node l: the scatter tree back up (z, y, x) over the 8
// cells node - (oi, oj, ok): (ts + td) of the cell + (ts - td) of the
// cell below it, then the same along y and x
template <typename T>
__device__ __forceinline__ T nodal_scatter(const Tiles<T>& w, const int l[3]) {
  T wy[2][2];
#pragma unroll
  for (int oi = 0; oi < 2; ++oi) {
    T wz[2][2][2];
#pragma unroll
    for (int oj = 0; oj < 2; ++oj) {
      // the cell at the node's z and the one below it
      const int cell =
          ((l[0] + 1 - oi) * w.s1 + l[1] + 1 - oj) * w.s2 + l[2] + 1;
#pragma unroll
      for (int q = 0; q < 4; ++q)  // q = p0 * 2 + p1
        wz[oj][q >> 1][q & 1] = w.tt[(2 * q) * w.ns + cell] +
                                w.tt[(2 * q + 1) * w.ns + cell - 1];
    }
#pragma unroll
    for (int p0 = 0; p0 < 2; ++p0)
      wy[oi][p0] = (wz[0][p0][0] + wz[0][p0][1]) +
                   (wz[1][p0][0] - wz[1][p0][1]);
  }
  return (wy[0][0] + wy[0][1]) + (wy[1][0] - wy[1][1]);
}

// The brick's node of colour `color` in slot (l0, l1, m) of the box
// (e0, e1, ceil(e2/2)): local node l, global node p, its element e;
// false for the idle slot of an odd row
template <typename T>
__device__ __forceinline__ bool brick_node(const NodalArgs<T>& a,
                                           const Brick& br, int color,
                                           const BoxWalk& q, int l[3], int p[3],
                                           int& e) {
  l[0] = q.i;
  l[1] = q.j;
  p[0] = br.o[0] + l[0];
  p[1] = br.o[1] + l[1];
  l[2] = 2 * q.k + ((color + p[0] + p[1] + br.o[2]) & 1);
  if (l[2] >= br.e[2]) return false;
  p[2] = br.o[2] + l[2];
  e = elem(a.g, p[0], p[1], p[2], 0);
  return true;
}

// Both regimes walk bricks: each pass stages a brick's x tile, computes
// the terms of its cells once, and scatters them to the nodes of the
// colour it updates.  Grid: the CTAs share the bricks, x lives in global
// memory (x, then tmp and out in turn) and a grid barrier ends a pass.
// Resident: one CTA takes every brick, x lives in two level buffers in
// shared memory and a block barrier ends a pass.
template <typename T, bool kResident>
__global__ void __launch_bounds__(kNodalThreads) nodal_kernel(const NodalArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* base = reinterpret_cast<T*>(smem);
  const int total = a.g.total;
  Tiles<T> w = tiles_at(a, kResident ? base + 2 * total : base);
  const int nbricks = a.nb[0] * a.nb[1] * a.nb[2];
  const int passes = 2 * a.nsweeps;
  const T* src = a.x;
  T* bufs[2] = {a.tmp, a.out};
  if (kResident) {
    for (int i = threadIdx.x; i < total; i += blockDim.x) base[i] = a.x[i];
    __syncthreads();
    src = base;
    bufs[0] = base + total;
    bufs[1] = base;
  }
  // pass s < passes updates colour s & 1 into bufs[s & 1]; s == passes
  // writes the residual (and out, where x is not there yet)
  const bool copy_out = kResident || a.nsweeps == 0;
  for (int s = 0; s <= passes; ++s) {
    const bool last = s == passes;
    if (last && !a.res && !copy_out) break;
    T* dst = last ? nullptr : bufs[s & 1];
    for (int id = blockIdx.x; id < nbricks; id += gridDim.x) {
      const Brick br = brick_of(a, id);
      w.shape(br);
      if (!a.hold || s == 0) stage_sigma(a, br, w);
      stage_x(a, br, src, w);
      __syncthreads();
      cell_terms(a, br, w);
      __syncthreads();
      const int e1 = br.e[1], e2 = br.e[2], h = (e2 + 1) >> 1;
      const int nslot = br.e[0] * e1 * h;
      for (BoxWalk q(e1, h); q.idx < nslot; q.next())
        for (int col = 0; col < 2; ++col) {
          int l[3], p[3], e;
          if (!brick_node(a, br, col, q, l, p, e)) continue;
          const T xe = w.xt[((l[0] + 1) * w.t1 + l[1] + 1) * w.t2 + l[2] + 1];
          if (last) {
            if (copy_out) a.out[e] = xe;
            if (a.res)
              a.res[e] = __ldg(a.b + e) -
                         (dirichlet_node(a, p) ? xe : nodal_scatter(w, l));
          } else if (col == (s & 1)) {
            const T L = dirichlet_node(a, p) ? xe : nodal_scatter(w, l);
            dst[e] = xe + (__ldg(a.b + e) - L) * __ldg(a.dinv + e);
          } else {
            dst[e] = xe;
          }
        }
      __syncthreads();  // the tiles are restaged for the next brick
    }
    if (!last) {
      if (kResident)
        __syncthreads();
      else
        cg::this_grid().sync();
      src = dst;
    }
  }
}

// ---------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------

struct DeviceInfo {
  int sms, smem_optin;
};

constexpr int kCache = 512;
struct Occ {
  const void* fn;
  int dev, threads, smem, per_sm;
};
std::mutex g_mu;
Occ g_occ[kCache];
int g_nocc = 0;
const void* g_raised[kCache];  // kernels allowed the opt-in shared memory
int g_raised_dev[kCache];
int g_nraised = 0;

// SM count and opt-in shared memory of the current device, asked once
// per device (the answers do not change)
int device_info(DeviceInfo& d, int& dev) {
  constexpr int kDevices = 64;
  static DeviceInfo known[kDevices] = {};
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  std::lock_guard<std::mutex> lock(g_mu);
  if (dev < kDevices && known[dev].sms > 0) {
    d = known[dev];
    return 0;
  }
  int coop = 0;
  e = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&d.smem_optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return (int)cudaErrorNotSupported;
  if (dev < kDevices) known[dev] = d;
  return 0;
}

// CTAs of `fn` that fit on one SM with `threads` threads and `smem` bytes
// of dynamic shared memory; the first call for a kernel on a device
// allows it the opt-in shared memory.  Cached.
int occupancy(const void* fn, int dev, const DeviceInfo& d, int threads,
              int smem, int& per_sm) {
  std::lock_guard<std::mutex> lock(g_mu);
  for (int i = 0; i < g_nocc; ++i)
    if (g_occ[i].fn == fn && g_occ[i].dev == dev &&
        g_occ[i].threads == threads && g_occ[i].smem == smem) {
      per_sm = g_occ[i].per_sm;
      return 0;
    }
  bool raised = false;
  for (int i = 0; i < g_nraised; ++i)
    raised = raised || (g_raised[i] == fn && g_raised_dev[i] == dev);
  if (!raised) {
    cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, d.smem_optin);
    if (e != cudaSuccess) return (int)e;
    if (g_nraised < kCache) {
      g_raised[g_nraised] = fn;
      g_raised_dev[g_nraised++] = dev;
    }
  }
  per_sm = 0;
  if (smem <= d.smem_optin) {
    cudaError_t e =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (g_nocc < kCache) g_occ[g_nocc++] = {fn, dev, threads, smem, per_sm};
  return 0;
}

int round_up(int v, int m) { return (v + m - 1) / m * m; }
int div_up(long long v, long long m) { return (int)((v + m - 1) / m); }

// plan[0..3]: regime (1 resident, 2 grid), CTAs, threads per CTA, and the
// slots held per colour (cell) or 1 when every CTA holds its brick (nodal)
void set_plan(int* plan, int regime, int blocks, int threads, int kept) {
  if (!plan) return;
  plan[0] = regime;
  plan[1] = blocks;
  plan[2] = threads;
  plan[3] = kept;
}

// shared memory of one held slot of each colour, per thread: 9
// coefficients and a packed position, twice
template <typename T>
constexpr long long held_bytes() {
  return 2LL * (kCellCoefs * sizeof(T) + sizeof(unsigned));
}

template <typename T, bool kWalls>
int run_cell(CellArgs<T> a, int regime, int* launches, int* plan,
             cudaStream_t st) {
  const Dim& g = a.g;
  DeviceInfo d;
  int dev = 0, per_sm = 0, rc = device_info(d, dev);
  if (rc) return rc;
  const long long xbytes = (a.odd_wrap ? 2LL : 1LL) * g.total * sizeof(T);
  // a held slot's position packs into 10 bits per axis and 2 for c
  const bool packs = g.n[0] <= 1024 && g.n[1] <= 1024 && g.n[2] <= 1024 &&
                     g.nc <= 4;
  // resident: one CTA whose threads own at most one slot of each colour
  const bool resident =
      regime == kResident ||
      (regime == kAuto && g.slots <= kCellThreads && xbytes <= d.smem_optin);
  if (resident) {
    const void* fn = (const void*)cell_kernel<T, kWalls, true>;
    if (xbytes > d.smem_optin) return (int)cudaErrorInvalidValue;
    const int threads = std::min(kCellThreads, round_up(g.slots, 32));
    const long long per = held_bytes<T>() * threads;
    const int keep =
        packs ? (int)std::min<long long>({kMaxKeep, (d.smem_optin - xbytes) / per,
                                          div_up(g.slots, threads)})
              : 0;
    const int smem = (int)(xbytes + keep * per);
    if ((rc = occupancy(fn, dev, d, threads, smem, per_sm))) return rc;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    a.keep = keep;
    cell_kernel<T, kWalls, true><<<1, threads, smem, st>>>(a);
    if ((rc = (int)cudaGetLastError())) return rc;
    ++*launches;
    set_plan(plan, kResident, 1, threads, keep);
    return 0;
  }
  // grid: CTAs of 1024 threads where the level gives every SM one, else
  // of 64 to 256, enough of them to spread over the SMs
  const void* fn = (const void*)cell_kernel<T, kWalls, false>;
  const int threads =
      g.slots >= d.sms * kCellThreads
          ? kCellThreads
          : std::min(256, std::max(64, round_up(div_up(g.slots, d.sms), 32)));
  const long long per = held_bytes<T>() * threads;
  const int wanted = div_up(g.slots, threads);
  int keep = 0, smem = 0, nblk = 0;
  // the fewest held slots that hold all of a thread's, else as many as fit
  for (int k = 1; packs && k <= kMaxKeep && k * per <= d.smem_optin; ++k) {
    if ((rc = occupancy(fn, dev, d, threads, (int)(k * per), per_sm)))
      return rc;
    if (per_sm < 1) break;
    keep = k;
    smem = (int)(k * per);
    nblk = std::min(per_sm * d.sms, wanted);
    if (div_up(g.slots, (long long)nblk * threads) <= k) break;
  }
  if (!keep) {
    if ((rc = occupancy(fn, dev, d, threads, 0, per_sm))) return rc;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    nblk = std::min(per_sm * d.sms, wanted);
  }
  a.keep = keep;
  void* args[] = {&a};
  cudaError_t e = cudaLaunchCooperativeKernel(fn, dim3(nblk), dim3(threads),
                                              args, smem, st);
  if (e != cudaSuccess) return (int)e;
  ++*launches;
  set_plan(plan, kGrid, nblk, threads, keep);
  return 0;
}

// largest extent <= bmax that splits n into equal bricks but the last
int balanced(int n, int bmax) { return div_up(n, div_up(n, bmax)); }

// brick faces (x, y) and depths (z), smallest first, before balancing
// against the level
constexpr int kFaces[][2] = {{8, 8}, {8, 16}, {16, 16}};
constexpr int kDepths[] = {8, 12, 16, 20, 24, 32};
constexpr int kShapes = 18;

void brick_shape(int i, int shape[3]) {
  shape[0] = kFaces[i / 6][0];
  shape[1] = kFaces[i / 6][1];
  shape[2] = kDepths[i % 6];
}

template <typename T>
void set_bricks(NodalArgs<T>& a, const int shape[3]) {
  for (int ax = 0; ax < 3; ++ax) {
    a.B[ax] = balanced(a.g.n[ax], shape[ax]);
    a.nb[ax] = div_up(a.g.n[ax], a.B[ax]);
  }
}

template <typename T>
int run_nodal(NodalArgs<T> a, int regime, int* launches, int* plan,
              cudaStream_t st) {
  const Dim& g = a.g;
  DeviceInfo d;
  int dev = 0, per_sm = 0, rc = device_info(d, dev);
  if (rc) return rc;
  const long long tb = sizeof(T);
  const long long xbytes = 2LL * g.total * tb;
  // resident: one CTA, on the levels where it beats the grid (measured:
  // 8x8x2 nodes, not 16x16x4)
  const bool resident =
      regime == kResident || (regime == kAuto && g.slots <= kNodalResident);
  if (resident) {
    const void* fn = (const void*)nodal_kernel<T, true>;
    // the whole level one brick where its tiles fit beside the two level
    // buffers, else the largest brick shape that fits
    int shape[3] = {g.n[0], g.n[1], g.n[2]};
    set_bricks(a, shape);
    for (int i = kShapes - 1;
         i >= 0 && xbytes + tb * tile_elems(a.B) > d.smem_optin; --i) {
      brick_shape(i, shape);
      set_bricks(a, shape);
    }
    const long long smem = xbytes + tb * tile_elems(a.B);
    if (smem > d.smem_optin) return (int)cudaErrorInvalidValue;
    a.hold = a.nb[0] * a.nb[1] * a.nb[2] == 1;
    // the staging and the cell terms take a thread per tile point
    const int threads =
        std::min(kNodalThreads, std::max(256, round_up(g.slots, 32)));
    if ((rc = occupancy(fn, dev, d, threads, (int)smem, per_sm))) return rc;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    nodal_kernel<T, true><<<1, threads, (int)smem, st>>>(a);
    if ((rc = (int)cudaGetLastError())) return rc;
    ++*launches;
    set_plan(plan, kResident, 1, threads, a.hold);
    return 0;
  }
  // grid: of the brick shapes that give each co-resident CTA one brick,
  // the one with the most bricks; else the shape with the least tile work
  // per CTA and pass
  const void* fn = (const void*)nodal_kernel<T, false>;
  NodalArgs<T> best = a;
  long long best_cost = -1;
  int best_blk = 0, best_thr = 0, best_smem = 0;
  for (int i = 0; i < kShapes; ++i) {
    NodalArgs<T> c = a;
    int shape[3];
    brick_shape(i, shape);
    set_bricks(c, shape);
    const long long bytes = tb * tile_elems(c.B);
    const int threads = c.B[0] * c.B[1] * c.B[2] >= 2048 ? 512 : 256;
    if (bytes > d.smem_optin) continue;
    if ((rc = occupancy(fn, dev, d, threads, (int)bytes, per_sm))) return rc;
    if (per_sm < 1) continue;
    const int cap = per_sm * d.sms;
    const int nbricks = c.nb[0] * c.nb[1] * c.nb[2];
    c.hold = nbricks <= cap;
    // held: fewer bricks cost more; else: tile cells per CTA and pass
    const long long cost =
        c.hold ? -nbricks
               : div_up(nbricks, cap) * (c.B[0] + 1LL) * (c.B[1] + 1) *
                     (c.B[2] + 1);
    const bool better = best_blk == 0 || (c.hold && !best.hold) ||
                        (c.hold == best.hold && cost < best_cost);
    if (better) {
      best = c;
      best_cost = cost;
      best_blk = std::min(cap, nbricks);
      best_thr = threads;
      best_smem = (int)bytes;
    }
  }
  if (!best_blk) return (int)cudaErrorInvalidConfiguration;
  void* args[] = {&best};
  cudaError_t e = cudaLaunchCooperativeKernel(fn, dim3(best_blk), dim3(best_thr),
                                              args, best_smem, st);
  if (e != cudaSuccess) return (int)e;
  ++*launches;
  set_plan(plan, kGrid, best_blk, best_thr, best.hold);
  return 0;
}

bool make_dim(int nx, int ny, int nz, int nc, Dim& g) {
  if (nx < 1 || ny < 1 || nz < 1 || nc < 1) return false;
  g.n[0] = nx;
  g.n[1] = ny;
  g.n[2] = nz;
  g.nc = nc;
  g.total = nx * ny * nz * nc;
  g.h = (nz + 1) / 2;
  g.slots = nx * ny * g.h * nc;
  return true;
}

// bc holds (lo, hi) per axis.  A walled axis is non-periodic on both
// sides and has at least `min_walled` points.  Sets `walls` when any axis
// is walled and `odd_wrap` when a periodic axis has an odd number (> 1)
// of points.
bool check_bc(const int* bc, const Dim& g, int min_walled, bool& walls,
              bool& odd_wrap) {
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
    if (g.n[ax] < min_walled) return false;
  }
  return true;
}

}  // namespace

// dtype: 0 = float32, 1 = float64.  All arrays are dense (nx, ny, nz, nc);
// `res` may be null (no residual); `out` and `res` alias no input.  `bc`
// points at 6 ints on the host, (lo, hi) per axis; w0..w2 are the low
// wall face planes of the walled axes, dense with extent 1 along their
// axis; on a periodic axis null, or the plane of face 0 where it differs
// from face n.  xw: null, or an x wrap plane (extent 1 along x) that
// gives the coefficient of x(i-1) in the rows of the interior x planes
// xw0 and xw1 (-1: none; 0 < plane < nx - 1).  `tmp` is scratch of the size
// of x, needed when a periodic axis has an odd number of cells and
// nsweeps > 0.  `regime`: 0 chooses (resident where one CTA's threads
// own at most one point of each colour); 1 (resident) and 2 (grid) force
// a regime for tests and measurements.  `launches` (required) is set to
// 0 and raised by one at each launch enqueued; `plan` (4 ints,
// may be null) what was launched.  The caller guarantees
// nx*ny*nz*nc < 2^31.  Returns a cudaError_t value.
extern "C" int smoother_cell(int dtype, const void* x, const void* b,
                             const void* diag, const void* dinv,
                             const void* f0, const void* f1, const void* f2,
                             const void* w0, const void* w1, const void* w2,
                             const void* xw, int xw0, int xw1,
                             const int* bc, void* out, void* tmp, void* res,
                             int nx, int ny, int nz, int nc, int nsweeps,
                             int regime, int* launches,
                             int* plan, void* stream) {
  Dim g;
  const void* w[3] = {w0, w1, w2};
  bool walls = false, odd_wrap = false;
  if (!launches) return (int)cudaErrorInvalidValue;
  *launches = 0;
  if (!make_dim(nx, ny, nz, nc, g) || nsweeps < 0 || !bc || regime < 0 ||
      regime > 2 || !check_bc(bc, g, 2, walls, odd_wrap))
    return (int)cudaErrorInvalidValue;
  for (int ax = 0; ax < 3; ++ax)
    if (bc[2 * ax] == kDirichlet && !w[ax]) return (int)cudaErrorInvalidValue;
  if (odd_wrap && nsweeps > 0 && !tmp) return (int)cudaErrorInvalidValue;
  const int xw_at[2] = {xw0, xw1};
  for (int k = 0; k < 2; ++k)
    if (xw_at[k] != -1 && (!xw || xw_at[k] < 1 || xw_at[k] > nx - 2))
      return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
#define CELL_ARGS(T)                                     \
  CellArgs<T> a;                                         \
  a.g = g;                                               \
  a.x = static_cast<const T*>(x);                        \
  a.out = static_cast<T*>(out);                          \
  a.tmp = static_cast<T*>(tmp);                          \
  a.res = static_cast<T*>(res);                          \
  a.b = static_cast<const T*>(b);                        \
  a.diag = static_cast<const T*>(diag);                  \
  a.dinv = static_cast<const T*>(dinv);                  \
  a.F[0] = static_cast<const T*>(f0);                    \
  a.F[1] = static_cast<const T*>(f1);                    \
  a.F[2] = static_cast<const T*>(f2);                    \
  for (int ax = 0; ax < 3; ++ax) {                       \
    a.W[ax] = static_cast<const T*>(w[ax]);              \
    a.bc[ax][0] = bc[2 * ax];                            \
    a.bc[ax][1] = bc[2 * ax + 1];                        \
  }                                                      \
  a.XW = static_cast<const T*>(xw);                      \
  a.xw_at[0] = xw0;                                      \
  a.xw_at[1] = xw1;                                      \
  a.nsweeps = nsweeps;                                   \
  a.odd_wrap = odd_wrap && nsweeps > 0;                  \
  a.keep = 0;
  if (dtype == 0) {
    CELL_ARGS(float)
    rc = walls ? run_cell<float, true>(a, regime, launches, plan, st)
               : run_cell<float, false>(a, regime, launches, plan, st);
  } else if (dtype == 1) {
    CELL_ARGS(double)
    rc = walls ? run_cell<double, true>(a, regime, launches, plan, st)
               : run_cell<double, false>(a, regime, launches, plan, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef CELL_ARGS
  return rc;
}

// x, b, dinv: the level's nodes (nx, ny, nz), n + 1 along a walled axis of
// n cells; sig: its cells.  `coef` points at 8 doubles on the host: the
// pattern coefficients C_p.  `bc` as for smoother_cell; a walled axis has
// at least 3 nodes.  `tmp` is scratch of the size of x (unused when
// nsweeps == 0).  regime, launches and plan as for
// smoother_cell.
extern "C" int smoother_nodal(int dtype, const void* x, const void* b,
                              const void* sig, const void* dinv,
                              const double* coef, const int* bc, void* out,
                              void* tmp, void* res, int nx, int ny, int nz,
                              int nsweeps, int regime, int* launches,
                              int* plan, void* stream) {
  Dim g;
  bool walls = false, odd_wrap = false;
  if (!launches) return (int)cudaErrorInvalidValue;
  *launches = 0;
  if (!make_dim(nx, ny, nz, 1, g) || nsweeps < 0 || !bc || !coef ||
      regime < 0 || regime > 2 || !check_bc(bc, g, 3, walls, odd_wrap))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
#define NODAL_ARGS(T)                                             \
  NodalArgs<T> a;                                                 \
  a.g = g;                                                        \
  for (int ax = 0; ax < 3; ++ax) {                                \
    a.wall[ax] = bc[2 * ax] != kPeriodic;                         \
    a.m[ax] = g.n[ax] - (a.wall[ax] ? 1 : 0);                     \
    a.dir[ax][0] = bc[2 * ax] == kDirichlet;                      \
    a.dir[ax][1] = bc[2 * ax + 1] == kDirichlet;                  \
    a.B[ax] = a.nb[ax] = 1;                                       \
  }                                                               \
  a.x = static_cast<const T*>(x);                                 \
  a.out = static_cast<T*>(out);                                   \
  a.tmp = static_cast<T*>(tmp);                                   \
  a.res = static_cast<T*>(res);                                   \
  a.b = static_cast<const T*>(b);                                 \
  a.sig = static_cast<const T*>(sig);                             \
  a.dinv = static_cast<const T*>(dinv);                           \
  for (int i = 0; i < 8; ++i) a.C[i] = static_cast<T>(coef[i]);   \
  a.nsweeps = nsweeps;                                            \
  a.hold = 0;
  if (dtype == 0) {
    NODAL_ARGS(float)
    rc = run_nodal<float>(a, regime, launches, plan, st);
  } else if (dtype == 1) {
    NODAL_ARGS(double)
    rc = run_nodal<double>(a, regime, launches, plan, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef NODAL_ARGS
  return rc;
}

// The kernel nodes of a captured CUDA graph (cudaGraph_t), for the tests
// that a wrapper call is one device launch.
extern "C" int smoother_graph_kernels(void* graph, int* n) {
  size_t count = 0;
  cudaGraph_t gr = static_cast<cudaGraph_t>(graph);
  cudaError_t e = cudaGraphGetNodes(gr, nullptr, &count);
  if (e != cudaSuccess) return (int)e;
  cudaGraphNode_t* nodes = new cudaGraphNode_t[count ? count : 1];
  e = cudaGraphGetNodes(gr, nodes, &count);
  int kernels = 0;
  for (size_t i = 0; e == cudaSuccess && i < count; ++i) {
    cudaGraphNodeType type;
    e = cudaGraphNodeGetType(nodes[i], &type);
    if (e == cudaSuccess && type == cudaGraphNodeTypeKernel) ++kernels;
  }
  delete[] nodes;
  *n = kernels;
  return (int)e;
}
