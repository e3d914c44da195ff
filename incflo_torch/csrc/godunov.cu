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

struct Geo {
  int n[3];
  double dx[3];
  int ncell;
};

struct Pos {
  int c[3];
};

// neighbour along compile-time axis AX, periodic; |s| <= 2 * n
template <int AX>
__device__ __forceinline__ Pos sh(const Geo& g, Pos p, int s) {
  const int n = g.n[AX];
  int v = p.c[AX] + s;
  v = v < 0 ? v + n : v;
  v = v < 0 ? v + n : v;
  v = v >= n ? v - n : v;
  v = v >= n ? v - n : v;
  p.c[AX] = v;
  return p;
}

__device__ __forceinline__ int cell_index(const Geo& g, const Pos& p) {
  return (p.c[0] * g.n[1] + p.c[1]) * g.n[2] + p.c[2];
}

// face array with n+1 entries along its own axis AX
template <int AX>
__device__ __forceinline__ int face_index(const Geo& g, const Pos& p) {
  const int m1 = g.n[1] + (AX == 1), m2 = g.n[2] + (AX == 2);
  return (p.c[0] * m1 + p.c[1]) * m2 + p.c[2];
}

template <typename T>
struct Strided {  // cell field read with an element stride
  const T* p;
  int s;
  __device__ __forceinline__ T operator()(const Geo& g, const Pos& q) const {
    return p[cell_index(g, q) * s];
  }
};

template <typename T>
__device__ __forceinline__ T at(const T* plane, const Geo& g, const Pos& q) {
  return plane[cell_index(g, q)];
}

__device__ __forceinline__ bool thread_cell(const Geo& g, Pos& p, int& i) {
  i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= g.ncell) return false;
  p.c[2] = i % g.n[2];
  const int r = i / g.n[2];
  p.c[1] = r % g.n[1];
  p.c[0] = r / g.n[1];
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
template <int AX, typename T>
__device__ __forceinline__ void traces(const Geo& g, const Strided<T>& q,
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

template <typename T>
struct UadArgs {
  Geo g;
  Strided<T> vel[3];
  T* out[3];
  const T* dt;
  bool ppm;
};

template <typename T>
__global__ void uad_kernel(UadArgs<T> a) {
  Pos p;
  int i;
  if (!thread_cell(a.g, p, i)) return;
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

template <typename T>
struct PredictArgs {
  Geo g;
  Strided<T> vel[3];
  const T* uad[3];
  Strided<T> force;  // p == nullptr: no forces
  T* s[kPredictPlanes];
  T* out;
  const T* dt;
  bool ppm;
};

template <typename T, int D>
__global__ void predict_traces(PredictArgs<T> a) {
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
template <typename T, int D>
__global__ void predict_corner(PredictArgs<T> a) {
  Pos p;
  int i;
  if (!thread_cell(a.g, p, i)) return;
  const T dt = *a.dt;
  static_for<0, 3>([&](auto o_c) {
    constexpr int O = decltype(o_c)::value;
    if constexpr (O != D) {
      const Geo& g = a.g;
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
template <typename T, int D>
__global__ void predict_inter(PredictArgs<T> a) {
  Pos p;
  int i;
  if (!thread_cell(a.g, p, i)) return;
  static_for<0, 3>([&](auto t_c) {
    constexpr int TT = decltype(t_c)::value;
    if constexpr (TT != D) {
      constexpr int O = 3 - D - TT;
      const Geo& g = a.g;
      const T* corr = a.s[6 + tslot(D, O)];
      const Pos pm = sh<TT>(g, p, -1);
      const T lo = at(a.s[3 + TT], g, pm) - at(corr, g, pm);
      const T hi = at(a.s[TT], g, p) - at(corr, g, p);
      a.s[8 + tslot(D, TT)][i] = upwind(lo, hi, at(a.uad[TT], g, p));
    }
  });
}

template <typename T, int D>
__global__ void predict_final(PredictArgs<T> a) {
  Pos p;
  int i;
  if (!thread_cell(a.g, p, i)) return;
  const T dt = *a.dt;
  const Geo& g = a.g;
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
  a.out[face_index<D>(g, p)] = v;
  if (p.c[D] == 0) {  // periodic face n == face 0
    Pos pn = p;
    pn.c[D] = g.n[D];
    a.out[face_index<D>(g, pn)] = v;
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

template <typename T>
struct AdvectArgs {
  Geo g;
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
template <int AX, typename T>
__device__ __forceinline__ T mac(const AdvectArgs<T>& a, const Pos& p) {
  return a.mac[AX][face_index<AX>(a.g, p)];
}

template <typename T>
__global__ void advect_traces(AdvectArgs<T> a) {
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
template <typename T>
__global__ void advect_corner(AdvectArgs<T> a) {
  Pos p;
  int i;
  if (!thread_cell(a.g, p, i)) return;
  const T dt = *a.dt;
  const Geo& g = a.g;
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

template <typename T>
__global__ void advect_inter(AdvectArgs<T> a) {
  Pos p;
  int i;
  if (!thread_cell(a.g, p, i)) return;
  const Geo& g = a.g;
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
template <typename T>
__global__ void advect_trans(AdvectArgs<T> a) {
  Pos p;
  int i;
  if (!thread_cell(a.g, p, i)) return;
  const T dt = *a.dt;
  const Geo& g = a.g;
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
template <typename T>
__global__ void advect_faces(AdvectArgs<T> a) {
  Pos p;
  int i;
  if (!thread_cell(a.g, p, i)) return;
  const T dt = *a.dt;
  const Geo& g = a.g;
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

template <typename T>
__global__ void advect_rate(AdvectArgs<T> a) {
  Pos p;
  int i;
  if (!thread_cell(a.g, p, i)) return;
  const Geo& g = a.g;
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

Geo make_geo(int nx, int ny, int nz, double dx0, double dx1, double dx2) {
  Geo g;
  g.n[0] = nx;
  g.n[1] = ny;
  g.n[2] = nz;
  g.dx[0] = dx0;
  g.dx[1] = dx1;
  g.dx[2] = dx2;
  g.ncell = nx * ny * nz;
  return g;
}

unsigned int nblocks(const Geo& g) {
  return (unsigned int)((g.ncell + kBlock - 1) / kBlock);
}

// launch one stage, one thread per cell, on the caller's stream
template <typename Args>
int launch(void (*kernel)(Args), const Args& a, cudaStream_t st) {
  kernel<<<nblocks(a.g), kBlock, 0, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int run_uad(const void* vel, int vs, void* u0, void* u1, void* u2,
            const void* dt, const Geo& g, int ppm, cudaStream_t st) {
  const T* v = static_cast<const T*>(vel);
  UadArgs<T> a;
  a.g = g;
  for (int c = 0; c < 3; ++c) a.vel[c] = Strided<T>{v + c, vs};
  a.out[0] = static_cast<T*>(u0);
  a.out[1] = static_cast<T*>(u1);
  a.out[2] = static_cast<T*>(u2);
  a.dt = static_cast<const T*>(dt);
  a.ppm = ppm != 0;
  return launch(uad_kernel<T>, a, st);
}

template <typename T, int D>
int run_predict(const PredictArgs<T>& a, cudaStream_t st) {
  int rc = launch(predict_traces<T, D>, a, st);
  if (!rc) rc = launch(predict_corner<T, D>, a, st);
  if (!rc) rc = launch(predict_inter<T, D>, a, st);
  if (!rc) rc = launch(predict_final<T, D>, a, st);
  return rc;
}

template <typename T>
int run_predict_d(int d, const void* vel, int vs, const void* u0,
                  const void* u1, const void* u2, const void* force, int fs,
                  void* out, void* scratch, const void* dt, const Geo& g,
                  int ppm, cudaStream_t st) {
  const T* v = static_cast<const T*>(vel);
  PredictArgs<T> a;
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
  if (d == 0) return run_predict<T, 0>(a, st);
  if (d == 1) return run_predict<T, 1>(a, st);
  return run_predict<T, 2>(a, st);
}

template <typename T>
int run_advect(const void* q, int qs, const void* m0, const void* m1,
               const void* m2, const void* force, int fs, void* out, int os,
               void* scratch, const void* dt, const Geo& g, int ppm,
               int icons, cudaStream_t st) {
  AdvectArgs<T> a;
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
  int rc = launch(advect_traces<T>, a, st);
  if (!rc) rc = launch(advect_corner<T>, a, st);
  if (!rc) rc = launch(advect_inter<T>, a, st);
  if (!rc) rc = launch(advect_trans<T>, a, st);
  if (!rc) rc = launch(advect_faces<T>, a, st);
  if (!rc) rc = launch(advect_rate<T>, a, st);
  return rc;
}

}  // namespace

// dtype: 0 = float32, 1 = float64.  Returns a cudaError_t value.  The
// caller guarantees ncell * stride < 2^31 (32-bit indices).
extern "C" int godunov_uad(int dtype, const void* vel, int vs, void* u0,
                           void* u1, void* u2, const void* dt, int nx,
                           int ny, int nz, double dx0, double dx1,
                           double dx2, int use_ppm, void* stream) {
  const Geo g = make_geo(nx, ny, nz, dx0, dx1, dx2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return run_uad<float>(vel, vs, u0, u1, u2, dt, g, use_ppm, st);
  if (dtype == 1) return run_uad<double>(vel, vs, u0, u1, u2, dt, g, use_ppm, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int godunov_predict_d(int dtype, int d, const void* vel, int vs,
                                 const void* u0, const void* u1,
                                 const void* u2, const void* force, int fs,
                                 void* out, void* scratch, const void* dt,
                                 int nx, int ny, int nz, double dx0,
                                 double dx1, double dx2, int use_ppm,
                                 void* stream) {
  const Geo g = make_geo(nx, ny, nz, dx0, dx1, dx2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d < 0 || d > 2) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return run_predict_d<float>(d, vel, vs, u0, u1, u2, force, fs, out,
                                scratch, dt, g, use_ppm, st);
  if (dtype == 1)
    return run_predict_d<double>(d, vel, vs, u0, u1, u2, force, fs, out,
                                 scratch, dt, g, use_ppm, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int godunov_advect(int dtype, const void* q, int qs,
                              const void* m0, const void* m1, const void* m2,
                              const void* force, int fs, void* out, int os,
                              void* scratch, const void* dt, int nx, int ny,
                              int nz, double dx0, double dx1, double dx2,
                              int use_ppm, int icons, void* stream) {
  const Geo g = make_geo(nx, ny, nz, dx0, dx1, dx2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run_advect<float>(q, qs, m0, m1, m2, force, fs, out, os, scratch,
                             dt, g, use_ppm, icons, st);
  if (dtype == 1)
    return run_advect<double>(q, qs, m0, m1, m2, force, fs, out, os,
                              scratch, dt, g, use_ppm, icons, st);
  return (int)cudaErrorInvalidValue;
}
