// Godunov corner-transport-upwind chain on fully periodic 3D grids, for
// NVIDIA Hopper (sm_90a).  Three kernels with a plain C interface, bound
// from incflo_torch/ops/godunov_kernels.py with ctypes:
//
//   godunov_uad        replaces incflo_tpu/ops/pallas_godunov.py:_uad_kernel
//   godunov_predict_d  replaces incflo_tpu/ops/pallas_godunov.py:_predict_d_kernel
//   godunov_advect     replaces incflo_tpu/ops/pallas_godunov.py:_advect_kernel
//
// They compute what the Pallas kernels compute, with the same limiters
// (vanLeer, order-4 MC, the PPM clip/flattening branches), SMALL_VEL and
// operation order, so they agree with the plain PyTorch versions in
// godunov_kernels.py to rounding.  Build with -fmad=false so that no
// multiply-add is contracted: every operation then rounds as the plain
// version's does.
//
// Layout: cell fields are (nx, ny, nz) planes, z fastest, read with an
// element stride (3 for a velocity component inside (nx,ny,nz,3)); face
// arrays are the standard (n+1)-along-own-axis tensors.  One thread per
// cell; periodic neighbours by index arithmetic on compile-time axes.
//
// Halo-slab mode (Geo<H>, H = kHalo = 4: a compile-time parameter, so the
// periodic kernels carry no test of the mode; replaces the per-shard
// kernel calls of incflo_tpu/ops/pallas_godunov.py:predict_sharded
// (:525) and advect_sharded (:572)): one rank's x slab of a periodic
// level, its inputs grown by H rows of each x neighbour (nxl + 2 H rows,
// an x face array holding the low face of each of those rows).  x does
// not wrap: the x neighbour of row i at offset s is row i + s, clamped to
// the padded rows.  The intermediate stages sweep every padded row; the
// CTU chain reaches 3 cells along x (4 with the halo'd uad), so the
// clamped values of the outermost rows feed no output.  The output
// stages (uad, the last predict and advect stages) sweep the nxl rows of
// the slab [H, nxl + H) and write (nxl, ny, nz)-shaped outputs: the x
// face array gets the slab's nxl low faces (its high face is the right
// neighbour's face 0), the y and z face arrays their wrap faces as in
// the periodic mode.  y and z stay periodic.  Each output equals the
// periodic kernels' output on the same rows bit for bit, as the same
// operations run on the same values.
// The floor on an H100 is memory traffic (400-550 operations per cell
// over 6-8 fields: 3.8-5.0 us per launch at 128x128x32 f32).  The CTU
// chain reaches 3-4 cells along every axis, so each kernel runs as a
// sequence of stages, one thread per cell each, and every stage stores
// one intermediate in a scratch plane the wrapper allocates instead of
// recomputing its neighbours' values:
//   traces Im/Ip along x, y, z
//   corner corrections of each cell (dt/6, dt/3 conservative)
//   corner-coupled transverse edge states ("inter")
//   transverse corrections (advect; predict folds them into the last)
//   face states, Riemann select or upwind
//   flux divergence (advect)
// dt is read from device memory.  Each entry returns cudaGetLastError().

#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kBlock = 256;

constexpr int kHalo = 4;  // x rows of each neighbour in a halo slab

// H = 0: a periodic level.  H = kHalo: a halo slab, whose output stages
// write the rows [H, n[0] - H).
template <int H>
struct Geo {
  int n[3];      // extents of the planes the stages sweep (x: padded rows
                 // of a halo slab)
  double dx[3];
  int ncell;     // n[0] n[1] n[2]
  int nout;      // cells an output stage writes
};

struct Pos {
  int c[3];
};

// neighbour along compile-time axis AX: periodic (|s| <= 2 * n), or
// along x of a halo slab clamped to the padded rows
template <int AX, int H>
__device__ __forceinline__ Pos sh(const Geo<H>& g, Pos p, int s) {
  const int n = g.n[AX];
  int v = p.c[AX] + s;
  if constexpr (AX == 0 && H > 0) {
    v = v < 0 ? 0 : (v >= n ? n - 1 : v);
  } else {
    v = v < 0 ? v + n : v;
    v = v < 0 ? v + n : v;
    v = v >= n ? v - n : v;
    v = v >= n ? v - n : v;
  }
  p.c[AX] = v;
  return p;
}

template <int H>
__device__ __forceinline__ int cell_index(const Geo<H>& g, const Pos& p) {
  return (p.c[0] * g.n[1] + p.c[1]) * g.n[2] + p.c[2];
}

// face array with n+1 entries along its own axis AX
template <int AX, int H>
__device__ __forceinline__ int face_index(const Geo<H>& g, const Pos& p) {
  const int m1 = g.n[1] + (AX == 1), m2 = g.n[2] + (AX == 2);
  return (p.c[0] * m1 + p.c[1]) * m2 + p.c[2];
}

template <typename T>
struct Strided {  // cell field read with an element stride
  const T* p;
  int s;
  template <int H>
  __device__ __forceinline__ T operator()(const Geo<H>& g,
                                          const Pos& q) const {
    return p[cell_index(g, q) * s];
  }
};

template <typename T, int H>
__device__ __forceinline__ T at(const T* plane, const Geo<H>& g,
                                const Pos& q) {
  return plane[cell_index(g, q)];
}

template <int H>
__device__ __forceinline__ bool thread_cell(const Geo<H>& g, Pos& p, int& i) {
  i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= g.ncell) return false;
  p.c[2] = i % g.n[2];
  const int r = i / g.n[2];
  p.c[1] = r % g.n[1];
  p.c[0] = r / g.n[1];
  return true;
}

// the output cell of an output stage's thread: p in the planes' rows, o
// its index in the (n[0] - 2 H, n[1], n[2]) output
template <int H>
__device__ __forceinline__ bool thread_out(const Geo<H>& g, Pos& p, int& o) {
  if constexpr (H == 0) return thread_cell(g, p, o);
  o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= g.nout) return false;
  p.c[2] = o % g.n[2];
  const int r = o / g.n[2];
  p.c[1] = r % g.n[1];
  p.c[0] = r / g.n[1] + H;
  return true;
}

// compile-time loop: f(std::integral_constant<int, I>) for I in [B, E)
template <int B, int E, typename F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (B < E) {
    f(std::integral_constant<int, B>{});
    static_for<B + 1, E>(f);
  }
}

// index of axis t among the two axes != d, in ascending order
__host__ __device__ constexpr int tslot(int d, int t) { return t < d ? t : t - 1; }

// ---------------------------------------------------------------------
// limiters and selections (pallas_godunov.py:88-173)
// ---------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ T sgn(T x) {
  return x > T(0) ? T(1) : (x < T(0) ? T(-1) : T(0));
}

template <typename T>
__device__ __forceinline__ T tmin(T a, T b) { return a < b ? a : b; }
template <typename T>
__device__ __forceinline__ T tmax(T a, T b) { return a > b ? a : b; }
template <typename T>
__device__ __forceinline__ T tabs(T a) { return a < T(0) ? -a : a; }

template <typename T>
__device__ __forceinline__ T small_vel() { return T(1.0e-8); }

// vanLeer(center, plus, minus)
template <typename T>
__device__ __forceinline__ T van_leer(T a, T b, T c) {
  const T dsc = T(0.5) * (b - c);
  const T dsl = T(2.0) * (a - c);
  const T dsr = T(2.0) * (b - a);
  const T lim = sgn(dsc) * tmin(tabs(dsc), tmin(tabs(dsl), tabs(dsr)));
  return (dsl * dsr > T(1.0e-20)) ? lim : T(0);
}

template <typename T>
__device__ __forceinline__ void mc2_parts(T a, T b, T c, T& dc, T& dlim) {
  const T dl = T(2.0) * (b - a);
  const T dr = T(2.0) * (c - b);
  dc = T(0.5) * (c - a);
  dlim = (dl * dr >= T(0)) ? tmin(tabs(dl), tabs(dr)) : T(0);
}

template <typename T>
__device__ __forceinline__ T mc4(T qm2, T qm1, T q0, T qp1, T qp2) {
  T dcm, dlimm, dcp, dlimp, dc, dlim;
  mc2_parts(qm2, qm1, q0, dcm, dlimm);
  const T sm = sgn(dcm) * tmin(tabs(dcm), dlimm);
  mc2_parts(q0, qp1, qp2, dcp, dlimp);
  const T sp = sgn(dcp) * tmin(tabs(dcp), dlimp);
  mc2_parts(qm1, q0, qp1, dc, dlim);
  const T dq = T(4.0 / 3.0) * dc - T(1.0 / 6.0) * (sp + sm);
  return sgn(dq) * tmin(tabs(dq), dlim);
}

template <typename T>
__device__ __forceinline__ T upwind(T lo, T hi, T w) {
  const T st = (w >= T(0)) ? lo : hi;
  return (tabs(w) < small_vel<T>()) ? T(0.5) * (hi + lo) : st;
}

template <typename T>
__device__ __forceinline__ T riemann(T stl, T sth) {
  const T st = (stl + sth >= T(0)) ? stl : sth;
  const bool ltm = (stl <= T(0) && sth >= T(0)) ||
                   (tabs(stl + sth) < small_vel<T>());
  return ltm ? T(0) : st;
}

template <typename T>
__device__ __forceinline__ T clip(T x, T lo, T hi) {
  return tmin(tmax(x, lo), hi);
}

// Characteristic traces (Im, Ip) of q at cell p along AX, with wave
// speeds wlo / whi at the cell's lo / hi faces.
template <int AX, typename T, int H>
__device__ __forceinline__ void traces(const Geo<H>& g, const Strided<T>& q,
                                       const Pos& p, T wlo, T whi, T dtdx,
                                       bool ppm, T& Im, T& Ip) {
  const T sm2 = q(g, sh<AX>(g, p, -2));
  const T sm1 = q(g, sh<AX>(g, p, -1));
  const T s0 = q(g, p);
  const T sp1 = q(g, sh<AX>(g, p, 1));
  const T sp2 = q(g, sh<AX>(g, p, 2));
  if (!ppm) {
    const T slp = mc4(sm2, sm1, s0, sp1, sp2);
    Im = s0 + T(0.5) * (T(-1.0) - wlo * dtdx) * slp;
    Ip = s0 + T(0.5) * (T(1.0) - whi * dtdx) * slp;
    return;
  }
  const T d1 = van_leer(s0, sp1, sm1);
  const T d2 = van_leer(sm1, s0, sm2);
  T sedge1 = T(0.5) * (s0 + sm1) - T(1.0 / 6.0) * (d1 - d2);
  sedge1 = clip(sedge1, tmin(s0, sm1), tmax(s0, sm1));
  const T d1p = van_leer(sp1, sp2, s0);
  T sedge2 = T(0.5) * (sp1 + s0) - T(1.0 / 6.0) * (d1p - d1);
  sedge2 = clip(sedge2, tmin(s0, sp1), tmax(s0, sp1));

  const bool flat = (sedge2 - s0) * (s0 - sedge1) < T(0);
  const bool big_p = tabs(sedge2 - s0) >= T(2.0) * tabs(sedge1 - s0);
  const bool big_m = tabs(sedge1 - s0) >= T(2.0) * tabs(sedge2 - s0);
  const T sp = flat ? s0 : (big_p ? T(3.0) * s0 - T(2.0) * sedge1 : sedge2);
  const T sm = flat ? s0
                    : ((!big_p && big_m) ? T(3.0) * s0 - T(2.0) * sedge2
                                         : sedge1);
  const T s6 = T(6.0) * s0 - T(3.0) * (sm + sp);
  const T sig_p = tabs(whi) * dtdx;
  const T sig_m = tabs(wlo) * dtdx;
  Ip = (whi > small_vel<T>())
           ? sp - T(0.5) * sig_p *
                      ((sp - sm) - (T(1.0) - T(2.0 / 3.0) * sig_p) * s6)
           : s0;
  Im = (wlo < -small_vel<T>())
           ? sm + T(0.5) * sig_m *
                      ((sp - sm) + (T(1.0) - T(2.0 / 3.0) * sig_m) * s6)
           : s0;
}

// ---------------------------------------------------------------------
// uad: Riemann-selected own-component face velocity on every axis
// ---------------------------------------------------------------------

template <typename T, int H>
struct UadArgs {
  Geo<H> g;
  Strided<T> vel[3];
  T* out[3];
  const T* dt;
  bool ppm;
};

template <typename T, int H>
__global__ void uad_kernel(UadArgs<T, H> a) {
  Pos p;
  int i;
  if (!thread_out(a.g, p, i)) return;
  const T dt = *a.dt;
  static_for<0, 3>([&](auto ax) {
    constexpr int AX = decltype(ax)::value;
    const Strided<T>& v = a.vel[AX];
    const T dtdx = dt / T(a.g.dx[AX]);
    const Pos pm = sh<AX>(a.g, p, -1);
    T Im, Ip, Im_m, Ip_m;
    const T w = v(a.g, p), wm = v(a.g, pm);
    traces<AX>(a.g, v, p, w, w, dtdx, a.ppm, Im, Ip);
    traces<AX>(a.g, v, pm, wm, wm, dtdx, a.ppm, Im_m, Ip_m);
    a.out[AX][i] = riemann(Ip_m, Im);
  });
}

// ---------------------------------------------------------------------
// predict_d: MAC face velocity for direction D (component D)
// scratch planes: 0-2 Im along x,y,z; 3-5 Ip; 6-7 corner correction
// from the two axes o != D; 8-9 inter of the two axes t != D
// ---------------------------------------------------------------------

constexpr int kPredictPlanes = 10;

template <typename T, int H>
struct PredictArgs {
  Geo<H> g;
  Strided<T> vel[3];
  const T* uad[3];
  Strided<T> force;  // p == nullptr: no forces
  T* s[kPredictPlanes];
  T* out;
  const T* dt;
  bool ppm;
};

template <typename T, int D, int H>
__global__ void predict_traces(PredictArgs<T, H> a) {
  Pos p;
  int i;
  if (!thread_cell(a.g, p, i)) return;
  const T dt = *a.dt;
  static_for<0, 3>([&](auto ax) {
    constexpr int AX = decltype(ax)::value;
    const T w = a.vel[AX](a.g, p);
    T Im, Ip;
    traces<AX>(a.g, a.vel[D], p, w, w, dt / T(a.g.dx[AX]), a.ppm, Im, Ip);
    a.s[AX][i] = Im;
    a.s[3 + AX][i] = Ip;
  });
}

// dt/6 corner correction of each cell from axis o != D
template <typename T, int D, int H>
__global__ void predict_corner(PredictArgs<T, H> a) {
  Pos p;
  int i;
  if (!thread_cell(a.g, p, i)) return;
  const T dt = *a.dt;
  static_for<0, 3>([&](auto o_c) {
    constexpr int O = decltype(o_c)::value;
    if constexpr (O != D) {
      const auto& g = a.g;
      const Pos pm = sh<O>(g, p, -1), ph = sh<O>(g, p, 1);
      const T u_lo = at(a.uad[O], g, p), u_hi = at(a.uad[O], g, ph);
      const T e_lo = upwind(at(a.s[3 + O], g, pm), at(a.s[O], g, p), u_lo);
      const T e_hi = upwind(at(a.s[3 + O], g, p), at(a.s[O], g, ph), u_hi);
      a.s[6 + tslot(D, O)][i] =
          dt / T(6.0 * g.dx[O]) * (u_hi + u_lo) * (e_hi - e_lo);
    }
  });
}

// corner-coupled t-face states, upwinded with u_ad
template <typename T, int D, int H>
__global__ void predict_inter(PredictArgs<T, H> a) {
  Pos p;
  int i;
  if (!thread_cell(a.g, p, i)) return;
  static_for<0, 3>([&](auto t_c) {
    constexpr int TT = decltype(t_c)::value;
    if constexpr (TT != D) {
      constexpr int O = 3 - D - TT;
      const auto& g = a.g;
      const T* corr = a.s[6 + tslot(D, O)];
      const Pos pm = sh<TT>(g, p, -1);
      const T lo = at(a.s[3 + TT], g, pm) - at(corr, g, pm);
      const T hi = at(a.s[TT], g, p) - at(corr, g, p);
      a.s[8 + tslot(D, TT)][i] = upwind(lo, hi, at(a.uad[TT], g, p));
    }
  });
}

template <typename T, int D, int H>
__global__ void predict_final(PredictArgs<T, H> a) {
  Pos p;
  int i;
  if (!thread_out(a.g, p, i)) return;
  const T dt = *a.dt;
  const auto& g = a.g;
  const Pos pm = sh<D>(g, p, -1);
  T stl = at(a.s[3 + D], g, pm);
  T sth = at(a.s[D], g, p);
  static_for<0, 3>([&](auto t_c) {
    constexpr int TT = decltype(t_c)::value;
    if constexpr (TT != D) {
      const T* inter = a.s[8 + tslot(D, TT)];
      const T* u = a.uad[TT];
      const T c = dt / T(4.0 * g.dx[TT]);
      const Pos pmh = sh<TT>(g, pm, 1), ph = sh<TT>(g, p, 1);
      const T corr_m = c * (at(u, g, pmh) + at(u, g, pm)) *
                       (at(inter, g, pmh) - at(inter, g, pm));
      const T corr_p = c * (at(u, g, ph) + at(u, g, p)) *
                       (at(inter, g, ph) - at(inter, g, p));
      stl = stl - corr_m;
      sth = sth - corr_p;
    }
  });
  if (a.force.p != nullptr) {
    stl = stl + T(0.5) * dt * a.force(g, pm);
    sth = sth + T(0.5) * dt * a.force(g, p);
  }
  const T v = riemann(stl, sth);
  Pos q = p;  // output rows
  q.c[0] -= H;
  a.out[face_index<D>(g, q)] = v;
  if (q.c[D] == 0 && (D != 0 || H == 0)) {  // periodic face n == face 0
    q.c[D] = g.n[D];
    a.out[face_index<D>(g, q)] = v;
  }
}

// ---------------------------------------------------------------------
// advect: dq/dt of one component
// scratch planes: 0-2 Im; 3-5 Ip; 6-8 corner correction from axis o;
// 9-14 inter of the pair (d, t) at 9 + 2 d + tslot(d, t); 15-20 the
// transverse correction of (d, t), same order; 21-23 face state along d
// ---------------------------------------------------------------------

constexpr int kAdvectPlanes = 24;
constexpr int kCorner = 6, kInter = 9, kTrans = 15, kFace = 21;

template <typename T, int H>
struct AdvectArgs {
  Geo<H> g;
  Strided<T> q;
  const T* mac[3];
  Strided<T> force;  // p == nullptr: no forces
  T* s[kAdvectPlanes];
  T* out;
  int out_stride;
  const T* dt;
  bool ppm;
  bool icons;
};

// MAC velocity on the lo face of cell p along AX; face n coincides with
// face 0 and is not read (pallas_godunov.py:435-437)
template <int AX, typename T, int H>
__device__ __forceinline__ T mac(const AdvectArgs<T, H>& a, const Pos& p) {
  return a.mac[AX][face_index<AX>(a.g, p)];
}

template <typename T, int H>
__global__ void advect_traces(AdvectArgs<T, H> a) {
  Pos p;
  int i;
  if (!thread_cell(a.g, p, i)) return;
  const T dt = *a.dt;
  static_for<0, 3>([&](auto ax) {
    constexpr int AX = decltype(ax)::value;
    T Im, Ip;
    traces<AX>(a.g, a.q, p, mac<AX>(a, p), mac<AX>(a, sh<AX>(a.g, p, 1)),
               dt / T(a.g.dx[AX]), a.ppm, Im, Ip);
    a.s[AX][i] = Im;
    a.s[3 + AX][i] = Ip;
  });
}

// corner correction of each cell from axis o (dt/3 conservative, dt/6 not)
template <typename T, int H>
__global__ void advect_corner(AdvectArgs<T, H> a) {
  Pos p;
  int i;
  if (!thread_cell(a.g, p, i)) return;
  const T dt = *a.dt;
  const auto& g = a.g;
  static_for<0, 3>([&](auto o_c) {
    constexpr int O = decltype(o_c)::value;
    const Pos pm = sh<O>(g, p, -1), ph = sh<O>(g, p, 1);
    const T mlo = mac<O>(a, p), mhi = mac<O>(a, ph);
    const T e_lo = upwind(at(a.s[3 + O], g, pm), at(a.s[O], g, p), mlo);
    const T e_hi = upwind(at(a.s[3 + O], g, p), at(a.s[O], g, ph), mhi);
    T corr;
    if (a.icons) {
      corr = dt / T(3.0 * g.dx[O]) *
             ((e_hi * mhi - e_lo * mlo) - a.q(g, p) * (mhi - mlo));
    } else {
      corr = dt / T(6.0 * g.dx[O]) * (mhi + mlo) * (e_hi - e_lo);
    }
    a.s[kCorner + O][i] = corr;
  });
}

template <typename T, int H>
__global__ void advect_inter(AdvectArgs<T, H> a) {
  Pos p;
  int i;
  if (!thread_cell(a.g, p, i)) return;
  const auto& g = a.g;
  static_for<0, 3>([&](auto d_c) {
    constexpr int D = decltype(d_c)::value;
    static_for<0, 3>([&](auto t_c) {
      constexpr int TT = decltype(t_c)::value;
      if constexpr (TT != D) {
        constexpr int O = 3 - D - TT;
        const T* corr = a.s[kCorner + O];
        const Pos pm = sh<TT>(g, p, -1);
        const T lo = at(a.s[3 + TT], g, pm) - at(corr, g, pm);
        const T hi = at(a.s[TT], g, p) - at(corr, g, p);
        a.s[kInter + 2 * D + tslot(D, TT)][i] =
            upwind(lo, hi, mac<TT>(a, p));
      }
    });
  });
}

// transverse correction of each cell for face direction d from axis t
template <typename T, int H>
__global__ void advect_trans(AdvectArgs<T, H> a) {
  Pos p;
  int i;
  if (!thread_cell(a.g, p, i)) return;
  const T dt = *a.dt;
  const auto& g = a.g;
  static_for<0, 3>([&](auto d_c) {
    constexpr int D = decltype(d_c)::value;
    static_for<0, 3>([&](auto t_c) {
      constexpr int TT = decltype(t_c)::value;
      if constexpr (TT != D) {
        constexpr int K = 2 * D + tslot(D, TT);
        const T* inter = a.s[kInter + K];
        const Pos ph = sh<TT>(g, p, 1);
        const T i_lo = at(inter, g, p), i_hi = at(inter, g, ph);
        const T mlo = mac<TT>(a, p), mhi = mac<TT>(a, ph);
        T corr;
        if (a.icons) {
          corr = dt / T(2.0 * g.dx[TT]) *
                 ((i_hi * mhi - i_lo * mlo) - a.q(g, p) * (mhi - mlo));
        } else {
          corr = dt / T(4.0 * g.dx[TT]) * (mhi + mlo) * (i_hi - i_lo);
        }
        a.s[kTrans + K][i] = corr;
      }
    });
  });
}

// upwinded state on the lo face of each cell along d
template <typename T, int H>
__global__ void advect_faces(AdvectArgs<T, H> a) {
  Pos p;
  int i;
  if (!thread_cell(a.g, p, i)) return;
  const T dt = *a.dt;
  const auto& g = a.g;
  static_for<0, 3>([&](auto d_c) {
    constexpr int D = decltype(d_c)::value;
    const Pos pm = sh<D>(g, p, -1);
    T stl = at(a.s[3 + D], g, pm);
    T sth = at(a.s[D], g, p);
    static_for<0, 3>([&](auto t_c) {
      constexpr int TT = decltype(t_c)::value;
      if constexpr (TT != D) {
        const T* corr = a.s[kTrans + 2 * D + tslot(D, TT)];
        stl = stl - at(corr, g, pm);
        sth = sth - at(corr, g, p);
      }
    });
    if (a.force.p != nullptr) {
      stl = stl + T(0.5) * dt * a.force(g, pm);
      sth = sth + T(0.5) * dt * a.force(g, p);
    }
    a.s[kFace + D][i] = upwind(stl, sth, mac<D>(a, p));
  });
}

template <typename T, int H>
__global__ void advect_rate(AdvectArgs<T, H> a) {
  Pos p;
  int i;
  if (!thread_out(a.g, p, i)) return;
  const auto& g = a.g;
  T rate = T(0);
  static_for<0, 3>([&](auto d_c) {
    constexpr int D = decltype(d_c)::value;
    const Pos ph = sh<D>(g, p, 1);
    const T qf = at(a.s[kFace + D], g, p);
    const T qf_hi = at(a.s[kFace + D], g, ph);
    const T mlo = mac<D>(a, p), mhi = mac<D>(a, ph);
    const T term = a.icons ? (mlo * qf - mhi * qf_hi) / T(g.dx[D])
                           : T(0.5) * (mlo + mhi) * (qf - qf_hi) /
                                 T(g.dx[D]);
    rate = (D == 0) ? term : rate + term;
  });
  a.out[i * a.out_stride] = rate;
}

// ---------------------------------------------------------------------
// host entries
// ---------------------------------------------------------------------

// nx counts the padded rows of a halo slab (H > 0)
template <int H>
Geo<H> make_geo(int nx, int ny, int nz, double dx0, double dx1,
                double dx2) {
  Geo<H> g;
  g.n[0] = nx;
  g.n[1] = ny;
  g.n[2] = nz;
  g.dx[0] = dx0;
  g.dx[1] = dx1;
  g.dx[2] = dx2;
  g.ncell = nx * ny * nz;
  g.nout = (nx - 2 * H) * ny * nz;
  return g;
}

// f(T(), std::integral_constant<int, H>()) for the element type and the
// mode asked for
template <typename F>
int dispatch(int dtype, int halo, F&& f) {
  using Periodic = std::integral_constant<int, 0>;
  using Slab = std::integral_constant<int, kHalo>;
  if (halo != 0 && halo != kHalo) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return halo ? f(float(), Slab()) : f(float(), Periodic());
  if (dtype == 1) return halo ? f(double(), Slab()) : f(double(), Periodic());
  return (int)cudaErrorInvalidValue;
}

enum Sweep { kPlanes, kOutput };

// launch one stage on the caller's stream, one thread per cell of the
// planes (intermediate stages) or of the output (output stages)
template <typename Args>
int launch(void (*kernel)(Args), const Args& a, cudaStream_t st,
           Sweep sweep = kPlanes) {
  const int cells = sweep == kPlanes ? a.g.ncell : a.g.nout;
  kernel<<<(unsigned int)((cells + kBlock - 1) / kBlock), kBlock, 0, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int H>
int run_uad(const void* vel, int vs, void* u0, void* u1, void* u2,
            const void* dt, const Geo<H>& g, int ppm, cudaStream_t st) {
  const T* v = static_cast<const T*>(vel);
  UadArgs<T, H> a;
  a.g = g;
  for (int c = 0; c < 3; ++c) a.vel[c] = Strided<T>{v + c, vs};
  a.out[0] = static_cast<T*>(u0);
  a.out[1] = static_cast<T*>(u1);
  a.out[2] = static_cast<T*>(u2);
  a.dt = static_cast<const T*>(dt);
  a.ppm = ppm != 0;
  return launch(uad_kernel<T, H>, a, st, kOutput);
}

template <typename T, int D, int H>
int run_predict(const PredictArgs<T, H>& a, cudaStream_t st) {
  int rc = launch(predict_traces<T, D, H>, a, st);
  if (!rc) rc = launch(predict_corner<T, D, H>, a, st);
  if (!rc) rc = launch(predict_inter<T, D, H>, a, st);
  if (!rc) rc = launch(predict_final<T, D, H>, a, st, kOutput);
  return rc;
}

template <typename T, int H>
int run_predict_d(int d, const void* vel, int vs, const void* u0,
                  const void* u1, const void* u2, const void* force, int fs,
                  void* out, void* scratch, const void* dt, const Geo<H>& g,
                  int ppm, cudaStream_t st) {
  const T* v = static_cast<const T*>(vel);
  PredictArgs<T, H> a;
  a.g = g;
  for (int c = 0; c < 3; ++c) a.vel[c] = Strided<T>{v + c, vs};
  a.uad[0] = static_cast<const T*>(u0);
  a.uad[1] = static_cast<const T*>(u1);
  a.uad[2] = static_cast<const T*>(u2);
  a.force = Strided<T>{static_cast<const T*>(force), fs};
  for (int f = 0; f < kPredictPlanes; ++f)
    a.s[f] = static_cast<T*>(scratch) + (long long)f * g.ncell;
  a.out = static_cast<T*>(out);
  a.dt = static_cast<const T*>(dt);
  a.ppm = ppm != 0;
  if (d == 0) return run_predict<T, 0, H>(a, st);
  if (d == 1) return run_predict<T, 1, H>(a, st);
  return run_predict<T, 2, H>(a, st);
}

template <typename T, int H>
int run_advect(const void* q, int qs, const void* m0, const void* m1,
               const void* m2, const void* force, int fs, void* out, int os,
               void* scratch, const void* dt, const Geo<H>& g, int ppm,
               int icons, cudaStream_t st) {
  AdvectArgs<T, H> a;
  a.g = g;
  a.q = Strided<T>{static_cast<const T*>(q), qs};
  a.mac[0] = static_cast<const T*>(m0);
  a.mac[1] = static_cast<const T*>(m1);
  a.mac[2] = static_cast<const T*>(m2);
  a.force = Strided<T>{static_cast<const T*>(force), fs};
  for (int f = 0; f < kAdvectPlanes; ++f)
    a.s[f] = static_cast<T*>(scratch) + (long long)f * g.ncell;
  a.out = static_cast<T*>(out);
  a.out_stride = os;
  a.dt = static_cast<const T*>(dt);
  a.ppm = ppm != 0;
  a.icons = icons != 0;
  int rc = launch(advect_traces<T, H>, a, st);
  if (!rc) rc = launch(advect_corner<T, H>, a, st);
  if (!rc) rc = launch(advect_inter<T, H>, a, st);
  if (!rc) rc = launch(advect_trans<T, H>, a, st);
  if (!rc) rc = launch(advect_faces<T, H>, a, st);
  if (!rc) rc = launch(advect_rate<T, H>, a, st, kOutput);
  return rc;
}

}  // namespace

// dtype: 0 = float32, 1 = float64.  halo: 0 for a periodic level, or
// kHalo for a halo slab, whose nx counts its padded rows.  Returns a
// cudaError_t value.  The caller guarantees ncell * stride < 2^31
// (32-bit indices).
extern "C" int godunov_uad(int dtype, const void* vel, int vs, void* u0,
                           void* u1, void* u2, const void* dt, int nx,
                           int ny, int nz, double dx0, double dx1,
                           double dx2, int halo, int use_ppm,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, halo, [&](auto t, auto h) {
    using T = decltype(t);
    constexpr int H = decltype(h)::value;
    return run_uad<T, H>(vel, vs, u0, u1, u2, dt,
                         make_geo<H>(nx, ny, nz, dx0, dx1, dx2), use_ppm,
                         st);
  });
}

extern "C" int godunov_predict_d(int dtype, int d, const void* vel, int vs,
                                 const void* u0, const void* u1,
                                 const void* u2, const void* force, int fs,
                                 void* out, void* scratch, const void* dt,
                                 int nx, int ny, int nz, double dx0,
                                 double dx1, double dx2, int halo,
                                 int use_ppm, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d < 0 || d > 2) return (int)cudaErrorInvalidValue;
  return dispatch(dtype, halo, [&](auto t, auto h) {
    using T = decltype(t);
    constexpr int H = decltype(h)::value;
    return run_predict_d<T, H>(d, vel, vs, u0, u1, u2, force, fs, out,
                               scratch, dt,
                               make_geo<H>(nx, ny, nz, dx0, dx1, dx2),
                               use_ppm, st);
  });
}

extern "C" int godunov_advect(int dtype, const void* q, int qs,
                              const void* m0, const void* m1, const void* m2,
                              const void* force, int fs, void* out, int os,
                              void* scratch, const void* dt, int nx, int ny,
                              int nz, double dx0, double dx1, double dx2,
                              int halo, int use_ppm, int icons,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, halo, [&](auto t, auto h) {
    using T = decltype(t);
    constexpr int H = decltype(h)::value;
    return run_advect<T, H>(q, qs, m0, m1, m2, force, fs, out, os, scratch,
                            dt, make_geo<H>(nx, ny, nz, dx0, dx1, dx2),
                            use_ppm, icons, st);
  });
}
