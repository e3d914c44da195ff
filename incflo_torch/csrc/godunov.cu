// Godunov corner-transport-upwind chain on fully periodic 3D grids, for
// NVIDIA Hopper (sm_90a).  Three kernels with a plain C interface, bound
// from incflo_torch/ops/godunov_kernels.py with ctypes:
//
//   godunov_uad        replaces incflo_tpu/ops/pallas_godunov.py:_uad_kernel
//   godunov_predict_d  replaces incflo_tpu/ops/pallas_godunov.py:
//                      _predict_d_kernel
//   godunov_advect     replaces incflo_tpu/ops/pallas_godunov.py:_advect_kernel
//
// They compute what the Pallas kernels compute, with the same limiters
// (vanLeer, order-4 MC, the PPM clip/flattening branches), SMALL_VEL and
// operation order, so they agree with the plain PyTorch versions in
// godunov_kernels.py bit for bit.  Build with -fmad=false so that no
// multiply-add is contracted: every operation then rounds as the plain
// version's does.
//
// Layout: cell fields are (nx, ny, nz) planes, z fastest, read with an
// element stride (3 for a velocity component inside (nx,ny,nz,3)); face
// arrays are the standard (n+1)-along-own-axis tensors.
//
// All three kernels: ONE launch a call, the work on chip.  A CTA
// owns a kTileY x kTileZ (8 x 32) column of output cells and marches
// along x over a chunk of output rows, one thread per cell of a stage's
// plane (the column and a 1-cell y-z halo: 10 x 34 cells, 352 threads, z
// fastest).  The inputs' x planes arrive by cp.async into rings of
// shared-memory planes ahead of use: the advected field with a 3-cell
// y-z halo, and the MAC velocities (u_ad and the other components'
// speeds for predict_d) and forces with a 1-cell halo.  Each stage of
// the chain writes its x plane into a ring that the next stages read:
// traces (k); corner corrections and corner-coupled edge states "inter"
// (k - 1); advect's upwinded faces, each with its transverse corrections
// computed at the cell and its lo neighbour, and predict_d's transverse
// corrections, forces and Riemann select (k - 2); advect's flux
// divergence (k - 3).  The lags follow the chain's x reach, so a stage
// reads only planes already made, and no intermediate touches device
// memory.  A thread computes every field of a stage for its cell, as
// independent chains, and stores them all; a field is read only on the
// cells where its inputs exist (the region rules below), so a halo
// cell's garbage is never read, and a halo cell's value, recomputed from
// the same inputs by the same operations as its owner's, has its bits.
// uad stages the three velocity components of each x plane together into
// one ring, de-interleaved (x reach -3..+2, a 3-cell y-z halo), computes
// each cell's trace pair once per axis and selects each lo face from the
// lo neighbour's Ip: along x a register of the previous plane, along y
// and z a shared plane.  Global loads wrap modulo n for any offset, so
// axes shorter than a tile and its halo work; ragged tiles compute
// wrapped cells and write only the real ones.  The wrapper's plan
// (godunov_kernels.tile_plan) passes the tile, the chunk and the
// shared-memory bytes; the entries check them against this file's.
//
// What bounds them on an H100: uad, bytes (its three trace pairs and
// selects, about 250 operations a cell, come close); predict_d and
// advect, operations.  About 300 (predict_d) and 550 (advect) a cell,
// with no FMA (-fmad=false, which bit-equality needs, halves the
// reachable f32 rate to 33.5 TFLOP/s); min, max and abs issue as single
// instructions.  The halo and a chunk's first planes are
// recomputed: at 128 x 128 x 32 (8-row chunks, 256 CTAs, 2 an SM) the
// traces run 1.66x as often as the outputs need; at 256 x 256 x 64
// (64-row chunks) 1.37x.  Device memory sees each input read once (the
// planes of a tile's halo again from L2) and each output written once.
//
// Halo-slab mode (template H, H = kHalo = 4: a compile-time parameter,
// so the periodic kernels carry no test of the mode; replaces the
// per-shard kernel calls of incflo_tpu/ops/pallas_godunov.py:
// predict_sharded (:525) and advect_sharded (:572)): one rank's x slab of
// a periodic level, its inputs grown by H rows of each x neighbour (nxl +
// 2 H rows, an x face array holding the low face of each of those rows).
// x does not wrap.  The kernels march over the output rows [H, nxl + H)
// only; they reach 3 rows of input beyond them, all inside the padded
// rows.  Outputs are (nxl, ny, nz)-shaped:
// the x face array gets the slab's nxl low faces (its high face is the
// right neighbour's face 0), the y and z face arrays their wrap faces as
// in the periodic mode.  y and z stay periodic.  Each output equals the
// periodic kernels' output on the same rows bit for bit, as the same
// operations run on the same values.
//
// dt is read from device memory.  Each entry returns cudaGetLastError().

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kHalo = 4;  // x rows of each neighbour in a halo slab

// compile-time loop: f(std::integral_constant<int, I>) for I in [B, E)
template <int B, int E, typename F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (B < E) {
    f(std::integral_constant<int, B>{});
    static_for<B + 1, E>(f);
  }
}

// index of axis t among the two axes != d, in ascending order, and back
__host__ __device__ constexpr int tslot(int d, int t) {
  return t < d ? t : t - 1;
}
__host__ __device__ constexpr int t_of(int d, int s) {
  return s < d ? s : s + 1;
}

// ---------------------------------------------------------------------
// limiters and selections (pallas_godunov.py:88-173)
// ---------------------------------------------------------------------

// sgn(d) * m for a number m >= 0, as a select: d > 0 gives m, d < 0 -m,
// else +0, the bits of the product
template <typename T>
__device__ __forceinline__ T sgn_times(T d, T m) {
  return d > T(0) ? m : (d < T(0) ? -m : T(0));
}

// min, max and abs as single instructions (FMNMX, an |x| operand): for
// numbers they agree with the plain version's torch.minimum, maximum and
// abs up to the sign of a zero result, which no later operation tells
// apart (no division by it, comparisons treat -0 == +0)
__device__ __forceinline__ float tmin(float a, float b) {
  return fminf(a, b);
}
__device__ __forceinline__ double tmin(double a, double b) {
  return fmin(a, b);
}
__device__ __forceinline__ float tmax(float a, float b) {
  return fmaxf(a, b);
}
__device__ __forceinline__ double tmax(double a, double b) {
  return fmax(a, b);
}
__device__ __forceinline__ float tabs(float a) { return fabsf(a); }
__device__ __forceinline__ double tabs(double a) { return fabs(a); }

template <typename T>
__device__ __forceinline__ T small_vel() { return T(1.0e-8); }

// vanLeer(center, plus, minus)
template <typename T>
__device__ __forceinline__ T van_leer(T a, T b, T c) {
  const T dsc = T(0.5) * (b - c);
  const T dsl = T(2.0) * (a - c);
  const T dsr = T(2.0) * (b - a);
  const T lim =
      sgn_times(dsc, tmin(tabs(dsc), tmin(tabs(dsl), tabs(dsr))));
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
  const T sm = sgn_times(dcm, tmin(tabs(dcm), dlimm));
  mc2_parts(q0, qp1, qp2, dcp, dlimp);
  const T sp = sgn_times(dcp, tmin(tabs(dcp), dlimp));
  mc2_parts(qm1, q0, qp1, dc, dlim);
  const T dq = T(4.0 / 3.0) * dc - T(1.0 / 6.0) * (sp + sm);
  return sgn_times(dq, tmin(tabs(dq), dlim));
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

// Characteristic traces (Im, Ip) of a cell from its five values along
// the axis (s[2] the cell's own), with wave speeds wlo / whi at its lo /
// hi faces.
template <typename T>
__device__ __forceinline__ void trace_pair(const T (&s)[5], T wlo, T whi,
                                           T dtdx, bool ppm, T& Im, T& Ip) {
  const T sm2 = s[0], sm1 = s[1], s0 = s[2], sp1 = s[3], sp2 = s[4];
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
// predict_d and advect: the fused march.  Tile, planes and rings.
// ---------------------------------------------------------------------

constexpr int kTileY = 8, kTileZ = 32;  // output cells of a CTA's column
// a stage's plane, one cell a thread: local y in [-1, kTileY], z in
// [-1, kTileZ]
constexpr int kNZ = kTileZ + 2, kNP = (kTileY + 2) * kNZ;
constexpr int kThreads = (kNP + 31) / 32 * 32;
// a staged input plane (MAC velocities, u_ad, speeds, forces): [-1, T + 1]
constexpr int kIZ = kTileZ + 3, kIP = (kTileY + 3) * kIZ;
// a plane of the advected field: [-3, T + 2]
constexpr int kWY = kTileY + 6, kWZ = kTileZ + 6, kWP = kWY * kWZ;
// elements before and after the planes: a halo cell's stage reads its
// neighbours' cells, one row or column outside its plane
constexpr int kMargin = 64;

// Shared-memory layouts, in elements of T, from kMargin.  Fields are
// kept in ring groups: a ring of R x-plane slots (the planes its readers
// reach, and one in flight for an input), each slot holding the group's
// fields one after another, so that all fields of one x plane share one
// base address.  Then the y and z wrap tables (ints).
//
// advect: q 7 slots (k-3..k+2, +1), mac x 6 (k-3..k+1, +1), mac y and z
// 5 (k-3..k, +1), force 3 (k-3..k-2, +1); Im, Ip along x 4 (k-3..k);
// along y and z, and inter (faces reach k-3..k-1), 3; corner and faces 2
constexpr int kAdvQ = kMargin;                 // 7 x 1 q plane
constexpr int kAdvMx = kAdvQ + 7 * kWP;        // 6 x 1 input plane
constexpr int kAdvMyz = kAdvMx + 6 * kIP;      // 5 x 2
constexpr int kAdvF = kAdvMyz + 5 * 2 * kIP;   // 3 x 1
constexpr int kAdvTx = kAdvF + 3 * kIP;        // 4 x 2 stage planes
constexpr int kAdv3 = kAdvTx + 4 * 2 * kNP;    // 3 x (4 traces, 6 inter)
constexpr int kAdv2 = kAdv3 + 3 * 10 * kNP;    // 2 x (3 corner, 3 faces)
constexpr int kAdvEnd = kAdv2 + 2 * 6 * kNP + kMargin;
// predict_d, whose inputs arrive two planes ahead: q (component D) 7
// (k-2..k+2, +2), the two other components' speeds 3 (k, +2), u_ad 6
// (k-3..k, +2), force 4 (k-3..k-2, +2); Im, Ip along x 4; along y and z,
// and inter, 3; corner 2
constexpr int kPrQ = kMargin;                  // 7 x 1 q plane
constexpr int kPrW = kPrQ + 7 * kWP;           // 3 x 2 input planes
constexpr int kPrU = kPrW + 3 * 2 * kIP;       // 6 x 3
constexpr int kPrF = kPrU + 6 * 3 * kIP;       // 4 x 1
constexpr int kPrTx = kPrF + 4 * kIP;          // 4 x 2 stage planes
constexpr int kPr3 = kPrTx + 4 * 2 * kNP;      // 3 x (4 traces, 2 inter)
constexpr int kPr2 = kPr3 + 3 * 6 * kNP;       // 2 x 2 corner
constexpr int kPrEnd = kPr2 + 2 * 2 * kNP + kMargin;

template <typename T>
constexpr int smem_bytes(int end) {
  return end * (int)sizeof(T) + (kWY + kWZ) * (int)sizeof(int);
}

// plane kinds: a stage plane, a staged input plane, a q plane
enum Kind { kStage, kInput, kWide };

// a cell relative to the thread's own: x plane offset, y, z offsets
struct Nb {
  int dj, dy, dz;
};

template <int A>
__device__ __forceinline__ constexpr Nb sh3(Nb c, int s) {
  return Nb{c.dj + (A == 0 ? s : 0), c.dy + (A == 1 ? s : 0),
            c.dz + (A == 2 ? s : 0)};
}

// The region rules (cells [lo, T - 1 + hi] of an axis of extent T).
// Every field is read only on the cells below, so a stage stores each
// field on its whole plane and its readers never see the values of
// the halo cells that lack an input (a halo cell's stage reads the
// neighbouring planes' garbage, in bounds thanks to kMargin).  The x
// extent is the chunk's rows, and a stage runs on a plane of x when any
// of its fields is read there.  advect:
//   traces of any axis      [-1, T]
//   corner of o             [0, T-1] along o, [-1, T] across
//   inter (d, t)            [-1, T] along d, [0, T] along t, else [0, T-1]
//   face d                  [0, T] along d, else [0, T-1]
//   rate                    [0, T-1]
// (faces compute the transverse corrections of (d, t) at p and p - e_d
// from inter.)  predict_d along D (o, t: the axes != D):
//   traces of D             [-1, T-1] along D, else [0, T-1]
//   traces of t             [-1, T-1] along D, else [-1, T]
//   corner of o             [0, T-1] along o, [-1, T-1] along D, else [-1, T]
//   inter of t              [0, T] along t, [-1, T-1] along D, else [0, T-1]
//   the face                [0, T-1]

// one CTA's march: its tile, its chunk of rows and its shared memory
template <typename T, int H>
struct March {
  T* sm;
  const int* wy;  // wrapped global y of local y in [-3, kTileY + 2]
  const int* wz;
  int nx, ny, nz;
  int y0, z0;
  int X0, X1;     // the rows it writes, in input rows (H added)
  int jb;         // ring base: plane j sits in slot (j - jb) % R
  int k;          // the iteration's plane, and (k - jb) % R for R = 2..7
  unsigned sk[8];
  int ni, ii, wi; // the thread's cell in a stage, input and q plane
  // offsets within an x row of the array elements the thread copies into
  // a wide plane (oq), an input plane (oi; oz of a face array along z)
  int oq[2], oi[2], oz[2];

  __device__ void init(unsigned char* smem, int end, int nx_, int ny_,
                       int nz_, int nxo, int chunk, int nty, int ntz) {
    sm = reinterpret_cast<T*>(smem);
    int* tab = reinterpret_cast<int*>(sm + end);
    wy = tab;
    wz = tab + kWY;
    nx = nx_;
    ny = ny_;
    nz = nz_;
    int b = blockIdx.x;
    z0 = (b % ntz) * kTileZ;
    b /= ntz;
    y0 = (b % nty) * kTileY;
    b /= nty;
    X0 = H + b * chunk;
    X1 = H + min((b + 1) * chunk, nxo);
    jb = X0 - 8;
    const int t = threadIdx.x < kNP ? threadIdx.x : kNP - 1;
    const int ly = t / kNZ - 1, lz = t % kNZ - 1;
    ni = t;
    ii = (ly + 1) * kIZ + lz + 1;
    wi = (ly + 3) * kWZ + lz + 3;
    for (int i = threadIdx.x; i < kWY + kWZ; i += kThreads) {
      const int v = i < kWY ? y0 + i - 3 : z0 + (i - kWY) - 3;
      const int n = i < kWY ? ny : nz;
      const int w = v % n;
      tab[i] = w < 0 ? w + n : w;
    }
    __syncthreads();
    for (int e = 0; e < 2; ++e) {
      const int i = threadIdx.x + e * kThreads;
      const int wq = min(i, kWP - 1), wn = min(i, kIP - 1);
      const int qy = wy[wq / kWZ], qz = wz[wq % kWZ];
      const int iy = wy[wn / kIZ + 2], iz = wz[wn % kIZ + 2];
      oq[e] = qy * nz + qz;
      oi[e] = iy * nz + iz;
      oz[e] = iy * (nz + 1) + iz;
    }
  }

  // input row of plane j: wrapped on a periodic level, as is in a slab
  // (j lies in [X0 - 3, X1 + 3], so one wrap is enough where nx >= 4)
  __device__ __forceinline__ int gx(int j) const {
    if constexpr (H > 0) {
      return j;
    } else {
      if (nx >= 4) return j < 0 ? j + nx : (j >= nx ? j - nx : j);
      const int w = j % nx;
      return w < 0 ? w + nx : w;
    }
  }
  // start iteration k: one modulo per ring depth
  __device__ __forceinline__ void at(int k_) {
    k = k_;
    static_for<2, 8>([&](auto rc) {
      constexpr int R = decltype(rc)::value;
      sk[R] = (unsigned)(k - jb) % R;
    });
  }
  // slot of plane j in a ring of R: in the stages j - k is a constant,
  // so its residue folds and one compare is left
  template <int R>
  __device__ __forceinline__ int slot_of(int j) const {
    const int v = (int)sk[R] + ((j - k) % R + R) % R;
    return v >= R ? v - R : v;
  }
  // field f of the ring group at `off` (R slots of NF planes of kind
  // K), plane j, cell c
  template <int K, int R>
  __device__ __forceinline__ T& el(int off, int NF, int f, int j,
                                   Nb c) const {
    constexpr int P = K == kStage ? kNP : (K == kInput ? kIP : kWP);
    constexpr int RZ = K == kStage ? kNZ : (K == kInput ? kIZ : kWZ);
    const int own = K == kStage ? ni : (K == kInput ? ii : wi);
    return sm[off + slot_of<R>(j + c.dj) * (NF * P) + f * P + own +
              c.dy * RZ + c.dz];
  }
  // the five values of a q plane's field along AX around c
  template <int AX, int R>
  __device__ __forceinline__ void five(int off, int j, Nb c,
                                       T (&s)[5]) const {
    static_for<0, 5>([&](auto oc) {
      constexpr int O = decltype(oc)::value;
      s[O] = el<kWide, R>(off, 1, 0, j, sh3<AX>(c, O - 2));
    });
  }
  // Start copying plane j of a strided array into a ring plane of NPL
  // elements: each thread copies elements t and t + kThreads, whose
  // offsets o0, o1 within an array's x row init() found; `row` is the
  // row's first element.
  template <int NPL>
  __device__ __forceinline__ void copy(T* dst, const T* src, int stride,
                                       int row, int o0, int o1) const {
    const int t = threadIdx.x;
    __pipeline_memcpy_async(dst + t, src + (row + o0) * stride, sizeof(T));
    if (t + kThreads < NPL)
      __pipeline_memcpy_async(dst + t + kThreads, src + (row + o1) * stride,
                              sizeof(T));
  }
  // plane of field f in the ring group at `off` (R slots of NF planes of
  // P elements)
  template <int R>
  __device__ __forceinline__ T* slot(int off, int NF, int P, int f,
                                     int j) const {
    return sm + off + slot_of<R>(j) * (NF * P) + f * P;
  }
  // an input plane ([-1, T + 1]) of a cell array or a face array along x,
  // y (EY) or z (EZ)
  template <int R, int EY = 0, int EZ = 0>
  __device__ __forceinline__ void load_in(int off, int NF, int f,
                                          const T* src, int stride,
                                          int j) const {
    copy<kIP>(slot<R>(off, NF, kIP, f, j), src, stride,
              gx(j) * (ny + EY) * (nz + EZ), EZ ? oz[0] : oi[0],
              EZ ? oz[1] : oi[1]);
  }
  // a wide plane ([-3, T + 2]) of a cell array, a ring of single planes
  template <int R>
  __device__ __forceinline__ void load_q(int off, const T* src, int stride,
                                         int j) const {
    copy<kWP>(slot<R>(off, 1, kWP, 0, j), src, stride, gx(j) * ny * nz,
              oq[0], oq[1]);
  }
  // output cell of the thread in plane j, or false for a halo cell or a
  // ragged tile's extra one
  __device__ __forceinline__ bool out_cell(int& gy, int& gz) const {
    const int ly = ni / kNZ - 1, lz = ni % kNZ - 1;
    gy = y0 + ly;
    gz = z0 + lz;
    return threadIdx.x < kNP && ly >= 0 && ly < kTileY && lz >= 0 &&
           lz < kTileZ && gy < ny && gz < nz;
  }
};

// ---------------------------------------------------------------------
// uad: Riemann-selected own-component face velocity on every axis
// ---------------------------------------------------------------------

// uad's shared memory: a ring of 6 x-plane slots (k-2..k+2 read, k+3 in
// flight), each the three velocity components' wide planes, de-interleaved
// as they are staged; then Ip along y and along z of the iteration's
// stage plane
constexpr int kUadV = kMargin;
constexpr int kUadS = kUadV + 6 * 3 * kWP;
constexpr int kUadEnd = kUadS + 2 * kNP + kMargin;

template <typename T, int H>
struct UadArgs {
  int nx, ny, nz, nxo;  // input rows (padded for a slab), output rows
  double dx[3];
  const T* vel;         // (nx, ny, nz, 3)
  T* out[3];
  const T* dt;
  int chunk, nty, ntz;
  bool ppm;
};

// A CTA marches its tile along x over its chunk of output rows.  At plane
// k a thread computes, for its cell of the stage plane, the trace pair of
// u along x (the tile's cells), of v along y (local y in [-1, T-1]) and
// of w along z (local z in [-1, T-1]), each once; Ip along y and z go to
// shared planes, Ip along x stays in a register for plane k + 1.  The
// face at the cell's lo side along axis d is riemann(Ip of the lo
// neighbour, Im of the cell): along x the register of plane k - 1, along
// y and z the shared plane's neighbour.
template <typename T, int H>
__global__ void __launch_bounds__(kThreads)
    uad_kernel(const UadArgs<T, H> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  March<T, H> m;
  m.init(smem, kUadEnd, a.nx, a.ny, a.nz, a.nxo, a.chunk, a.nty, a.ntz);
  const int X0 = m.X0, X1 = m.X1;
  const T dt = *a.dt;
  T dtdx[3];
  for (int d = 0; d < 3; ++d) dtdx[d] = dt / T(a.dx[d]);
  // component f at plane j, cell c of the thread's own
  auto vel = [&](int f, int j, Nb c) {
    return m.template el<kWide, 6>(kUadV, 3, f, j, c);
  };
  T* ip_y = m.sm + kUadS;
  T* ip_z = ip_y + kNP;
  // the three components of plane j, each into its own wide plane
  auto load = [&](int j) {
    static_for<0, 3>([&](auto fc) {
      constexpr int F = decltype(fc)::value;
      m.template copy<kWP>(m.template slot<6>(kUadV, 3, kWP, F, j),
                           a.vel + F, 3, m.gx(j) * a.ny * a.nz, m.oq[0],
                           m.oq[1]);
    });
  };
  const bool cell = threadIdx.x < kNP;
  const int ly = m.ni / kNZ - 1, lz = m.ni % kNZ - 1;
  const bool in_y = ly >= 0 && ly < kTileY, in_z = lz >= 0 && lz < kTileZ;
  // the five values of component F along axis F around the cell
  auto five = [&](auto fc, int j, T (&s)[5]) {
    constexpr int F = decltype(fc)::value;
    static_for<0, 5>([&](auto oc) {
      constexpr int O = decltype(oc)::value;
      s[O] = vel(F, j, sh3<F>(Nb{0, 0, 0}, O - 2));
    });
  };
  m.at(X0 - 1);
  for (int j = X0 - 3; j <= X0 + 1; ++j) load(j);
  __pipeline_commit();
  T ipx_prev = T(0);
  for (int k = X0 - 1; k < X1; ++k) {
    m.at(k);
    __pipeline_wait_prior(0);
    __syncthreads();
    if (k + 3 <= X1 + 1) load(k + 3);
    __pipeline_commit();
    // u along x, the tile's cells
    T imx = T(0), ipx = T(0);
    if (cell && in_y && in_z) {
      T s[5];
      five(std::integral_constant<int, 0>{}, k, s);
      trace_pair(s, s[2], s[2], dtdx[0], a.ppm, imx, ipx);
    }
    if (k >= X0) {
      // v along y and w along z, with the lo halo row / column
      T imy = T(0), imz = T(0);
      if (cell && ly < kTileY && in_z) {
        T s[5], ipv;
        five(std::integral_constant<int, 1>{}, k, s);
        trace_pair(s, s[2], s[2], dtdx[1], a.ppm, imy, ipv);
        ip_y[m.ni] = ipv;
      }
      if (cell && in_y && lz < kTileZ) {
        T s[5], ipw;
        five(std::integral_constant<int, 2>{}, k, s);
        trace_pair(s, s[2], s[2], dtdx[2], a.ppm, imz, ipw);
        ip_z[m.ni] = ipw;
      }
      __syncthreads();
      int gy, gz;
      if (m.out_cell(gy, gz)) {
        const int o = ((k - H) * a.ny + gy) * a.nz + gz;
        a.out[0][o] = riemann(ipx_prev, imx);
        a.out[1][o] = riemann(ip_y[m.ni - kNZ], imy);
        a.out[2][o] = riemann(ip_z[m.ni - 1], imz);
      }
    }
    ipx_prev = ipx;
  }
}

// ---------------------------------------------------------------------
// advect: dq/dt of one component
// ---------------------------------------------------------------------

template <typename T, int H>
struct AdvectArgs {
  int nx, ny, nz, nxo;  // input rows (padded for a slab), output rows
  double dx[3];
  const T* q;
  int qs;
  const T* mac[3];
  const T* force;  // nullptr: no forces
  int fs;
  T* out;
  int os;
  const T* dt;
  int chunk, nty, ntz;
  bool ppm, icons;
};

template <typename T, int H>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 2 : 1)
    advect_kernel(const AdvectArgs<T, H> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr Nb kP{0, 0, 0};  // the thread's own cell
  March<T, H> m;
  m.init(smem, kAdvEnd, a.nx, a.ny, a.nz, a.nxo, a.chunk, a.nty, a.ntz);
  const int X0 = m.X0, X1 = m.X1;
  const T dt = *a.dt;
  const T half_dt = T(0.5) * dt;
  T dtdx[3], c2[3], c3[3], c4[3], c6[3], dx[3];
  for (int d = 0; d < 3; ++d) {
    dtdx[d] = dt / T(a.dx[d]);
    c2[d] = dt / T(2.0 * a.dx[d]);
    c3[d] = dt / T(3.0 * a.dx[d]);
    c4[d] = dt / T(4.0 * a.dx[d]);
    c6[d] = dt / T(6.0 * a.dx[d]);
    dx[d] = T(a.dx[d]);
  }
  auto q = [&](int j, Nb c) {
    return m.template el<kWide, 7>(kAdvQ, 1, 0, j, c);
  };
  auto mac = [&](int ax, int j, Nb c) {
    return ax == 0 ? m.template el<kInput, 6>(kAdvMx, 1, 0, j, c)
                   : m.template el<kInput, 5>(kAdvMyz, 2, ax - 1, j, c);
  };
  auto force = [&](int j, Nb c) {
    return m.template el<kInput, 3>(kAdvF, 1, 0, j, c);
  };
  // the traces Im (side 0) and Ip (side 1) along ax
  auto tr = [&](int ax, int side, int j, Nb c) -> T& {
    return ax == 0 ? m.template el<kStage, 4>(kAdvTx, 2, side, j, c)
                   : m.template el<kStage, 3>(kAdv3, 10, 2 * (ax - 1) + side,
                                           j, c);
  };
  auto Im = [&](int ax, int j, Nb c) -> T& { return tr(ax, 0, j, c); };
  auto Ip = [&](int ax, int j, Nb c) -> T& { return tr(ax, 1, j, c); };
  auto inter = [&](int k, int j, Nb c) -> T& {
    return m.template el<kStage, 3>(kAdv3, 10, 4 + k, j, c);
  };
  auto corner = [&](int o, int j, Nb c) -> T& {
    return m.template el<kStage, 2>(kAdv2, 6, o, j, c);
  };
  auto face = [&](int d, int j, Nb c) -> T& {
    return m.template el<kStage, 2>(kAdv2, 6, 3 + d, j, c);
  };
  const bool cell = threadIdx.x < kNP;

  auto load_mac_yz = [&](int j) {
    m.template load_in<5, 1, 0>(kAdvMyz, 2, 0, a.mac[1], 1, j);
    m.template load_in<5, 0, 1>(kAdvMyz, 2, 1, a.mac[2], 1, j);
  };
  m.at(X0 - 1);
  for (int j = X0 - 3; j <= X0 + 1; ++j)
    m.template load_q<7>(kAdvQ, a.q, a.qs, j);
  for (int j = X0 - 1; j <= X0; ++j)
    m.template load_in<6>(kAdvMx, 1, 0, a.mac[0], 1, j);
  load_mac_yz(X0 - 1);
  __pipeline_commit();
  for (int k = X0 - 1; k <= X1 + 2; ++k) {
    m.at(k);
    __pipeline_wait_prior(0);
    __syncthreads();
    if (k + 3 <= X1 + 2) m.template load_q<7>(kAdvQ, a.q, a.qs, k + 3);
    if (k + 2 <= X1 + 1)
      m.template load_in<6>(kAdvMx, 1, 0, a.mac[0], 1, k + 2);
    if (k + 1 <= X1) load_mac_yz(k + 1);
    if (a.force != nullptr && k - 1 <= X1)
      m.template load_in<3>(kAdvF, 1, 0, a.force, a.fs, k - 1);
    __pipeline_commit();

    // traces at the MAC speeds, planes [X0 - 1, X1]
    if (cell && k <= X1) {
      static_for<0, 3>([&](auto ac) {
        constexpr int AX = decltype(ac)::value;
        T s[5];
        m.template five<AX, 7>(kAdvQ, k, kP, s);
        T im, ip;
        trace_pair(s, mac(AX, k, kP), mac(AX, k, sh3<AX>(kP, 1)), dtdx[AX],
                   a.ppm, im, ip);
        Im(AX, k, kP) = im;
        Ip(AX, k, kP) = ip;
      });
    }
    __syncthreads();

    // corner correction of each cell from axis o (dt/3 conservative,
    // dt/6 not), planes [X0 - 1, X1]
    const int j1 = k - 1;
    const bool on1 = cell && j1 >= X0 - 1 && j1 <= X1;
    if (on1) {
      static_for<0, 3>([&](auto oc) {
        constexpr int O = decltype(oc)::value;
        constexpr Nb pm = sh3<O>(kP, -1), ph = sh3<O>(kP, 1);
        const T mlo = mac(O, j1, kP), mhi = mac(O, j1, ph);
        const T e_lo = upwind(Ip(O, j1, pm), Im(O, j1, kP), mlo);
        const T e_hi = upwind(Ip(O, j1, kP), Im(O, j1, ph), mhi);
        corner(O, j1, kP) =
            a.icons ? c3[O] * ((e_hi * mhi - e_lo * mlo) -
                               q(j1, kP) * (mhi - mlo))
                    : c6[O] * (mhi + mlo) * (e_hi - e_lo);
      });
    }
    __syncthreads();

    // corner-coupled t-face states of direction d, upwinded, planes
    // [X0 - 1, X1]
    if (on1) {
      static_for<0, 6>([&](auto kc) {
        constexpr int K = decltype(kc)::value, D = K / 2, TT = t_of(D, K % 2);
        constexpr int O = 3 - D - TT;
        constexpr Nb pm = sh3<TT>(kP, -1);
        const T lo = Ip(TT, j1, pm) - corner(O, j1, pm);
        const T hi = Im(TT, j1, kP) - corner(O, j1, kP);
        inter(K, j1, kP) = upwind(lo, hi, mac(TT, j1, kP));
      });
    }
    __syncthreads();

    // upwinded state on the lo face of each cell along d, with the
    // transverse corrections of (d, t) at the cell and its lo neighbour,
    // planes [X0, X1]
    const int j2 = k - 2;
    if (cell && j2 >= X0 && j2 <= X1) {
      static_for<0, 3>([&](auto dc) {
        constexpr int D = decltype(dc)::value;
        constexpr Nb pm = sh3<D>(kP, -1);
        // transverse correction of direction D from axis TT at cell c
        auto trans = [&](auto tc, Nb c) {
          constexpr int TT = decltype(tc)::value;
          constexpr int K = 2 * D + tslot(D, TT);
          const Nb ch = sh3<TT>(c, 1);
          const T i_lo = inter(K, j2, c), i_hi = inter(K, j2, ch);
          const T mlo = mac(TT, j2, c), mhi = mac(TT, j2, ch);
          return a.icons ? c2[TT] * ((i_hi * mhi - i_lo * mlo) -
                                     q(j2, c) * (mhi - mlo))
                         : c4[TT] * (mhi + mlo) * (i_hi - i_lo);
        };
        T stl = Ip(D, j2, pm);
        T sth = Im(D, j2, kP);
        static_for<0, 2>([&](auto sc) {
          constexpr int TT = t_of(D, decltype(sc)::value);
          const std::integral_constant<int, TT> tc;
          stl = stl - trans(tc, pm);
          sth = sth - trans(tc, kP);
        });
        if (a.force != nullptr) {
          stl = stl + half_dt * force(j2, pm);
          sth = sth + half_dt * force(j2, kP);
        }
        face(D, j2, kP) = upwind(stl, sth, mac(D, j2, kP));
      });
    }
    __syncthreads();

    // flux divergence, planes [X0, X1 - 1]
    const int j3 = k - 3;
    int gy, gz;
    if (j3 >= X0 && m.out_cell(gy, gz)) {
      T rate = T(0);
      static_for<0, 3>([&](auto dc) {
        constexpr int D = decltype(dc)::value;
        constexpr Nb ph = sh3<D>(kP, 1);
        const T qf = face(D, j3, kP), qf_hi = face(D, j3, ph);
        const T mlo = mac(D, j3, kP), mhi = mac(D, j3, ph);
        const T term = a.icons ? (mlo * qf - mhi * qf_hi) / dx[D]
                               : T(0.5) * (mlo + mhi) * (qf - qf_hi) / dx[D];
        rate = (D == 0) ? term : rate + term;
      });
      a.out[(((j3 - H) * a.ny + gy) * a.nz + gz) * a.os] = rate;
    }
  }
}

// ---------------------------------------------------------------------
// predict_d: MAC face velocity for direction D (component D)
// ---------------------------------------------------------------------

template <typename T, int H>
struct PredictArgs {
  int nx, ny, nz, nxo;
  double dx[3];
  const T* vel;
  int vs;
  const T* uad[3];
  const T* force;  // component D, or nullptr: no forces
  int fs;
  T* out;
  const T* dt;
  int chunk, nty, ntz;
  bool ppm;
};

template <typename T, int D, int H>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 2 : 1)
    predict_kernel(const PredictArgs<T, H> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr Nb kP{0, 0, 0};  // the thread's own cell
  March<T, H> m;
  m.init(smem, kPrEnd, a.nx, a.ny, a.nz, a.nxo, a.chunk, a.nty, a.ntz);
  const int X0 = m.X0, X1 = m.X1;
  const T dt = *a.dt;
  const T half_dt = T(0.5) * dt;
  T dtdx[3], c4[3], c6[3];
  for (int d = 0; d < 3; ++d) {
    dtdx[d] = dt / T(a.dx[d]);
    c4[d] = dt / T(4.0 * a.dx[d]);
    c6[d] = dt / T(6.0 * a.dx[d]);
  }
  // speed of axis ax at the cell: component D is the advected field
  auto speed = [&](int ax, int j) {
    return ax == D ? m.template el<kWide, 7>(kPrQ, 1, 0, j, kP)
                   : m.template el<kInput, 3>(kPrW, 2, tslot(D, ax), j, kP);
  };
  auto uad = [&](int ax, int j, Nb c) {
    return m.template el<kInput, 6>(kPrU, 3, ax, j, c);
  };
  auto force = [&](int j, Nb c) {
    return m.template el<kInput, 4>(kPrF, 1, 0, j, c);
  };
  auto tr = [&](int ax, int side, int j, Nb c) -> T& {
    return ax == 0 ? m.template el<kStage, 4>(kPrTx, 2, side, j, c)
                   : m.template el<kStage, 3>(kPr3, 6, 2 * (ax - 1) + side,
                                           j, c);
  };
  auto Im = [&](int ax, int j, Nb c) -> T& { return tr(ax, 0, j, c); };
  auto Ip = [&](int ax, int j, Nb c) -> T& { return tr(ax, 1, j, c); };
  auto inter = [&](int t, int j, Nb c) -> T& {   // t != D
    return m.template el<kStage, 3>(kPr3, 6, 4 + tslot(D, t), j, c);
  };
  auto corner = [&](int o, int j, Nb c) -> T& {  // o != D
    return m.template el<kStage, 2>(kPr2, 2, tslot(D, o), j, c);
  };
  auto load_speeds = [&](int j) {
    static_for<0, 2>([&](auto sc) {
      constexpr int S = decltype(sc)::value;
      m.template load_in<3>(kPrW, 2, S, a.vel + t_of(D, S), a.vs, j);
    });
  };
  auto load_uad = [&](int j) {
    static_for<0, 3>([&](auto ac) {
      constexpr int AX = decltype(ac)::value;
      m.template load_in<6>(kPrU, 3, AX, a.uad[AX], 1, j);
    });
  };
  const bool cell = threadIdx.x < kNP;

  // the inputs of the first two iterations, then an empty group: the
  // loop keeps two groups in flight
  m.at(X0 - 1);
  for (int j = X0 - 3; j <= X0 + 2; ++j)
    m.template load_q<7>(kPrQ, a.vel + D, a.vs, j);
  load_speeds(X0 - 1);
  load_speeds(X0);
  load_uad(X0 - 1);
  load_uad(X0);
  __pipeline_commit();
  __pipeline_commit();
  for (int k = X0 - 1; k <= X1 + 1; ++k) {
    m.at(k);
    __pipeline_wait_prior(1);
    __syncthreads();
    if (k + 4 <= X1 + 2) m.template load_q<7>(kPrQ, a.vel + D, a.vs, k + 4);
    if (k + 2 <= X1) load_speeds(k + 2);
    if (k + 2 <= X1 + 1) load_uad(k + 2);
    if (a.force != nullptr && k <= X1)
      m.template load_in<4>(kPrF, 1, 0, a.force, a.fs, k);
    __pipeline_commit();

    // traces of component D along each axis at that axis's speed,
    // planes [X0 - 1, X1]
    if (cell && k <= X1) {
      static_for<0, 3>([&](auto ac) {
        constexpr int AX = decltype(ac)::value;
        T s[5];
        m.template five<AX, 7>(kPrQ, k, kP, s);
        const T w = speed(AX, k);
        T im, ip;
        trace_pair(s, w, w, dtdx[AX], a.ppm, im, ip);
        Im(AX, k, kP) = im;
        Ip(AX, k, kP) = ip;
      });
    }
    __syncthreads();

    // dt/6 corner correction of each cell from axis o != D, planes
    // [X0 - 1, X1]
    const int j1 = k - 1;
    if (cell && j1 >= X0 - 1) {
      static_for<0, 2>([&](auto sc) {
        constexpr int O = t_of(D, decltype(sc)::value);
        constexpr Nb pm = sh3<O>(kP, -1), ph = sh3<O>(kP, 1);
        const T u_lo = uad(O, j1, kP), u_hi = uad(O, j1, ph);
        const T e_lo = upwind(Ip(O, j1, pm), Im(O, j1, kP), u_lo);
        const T e_hi = upwind(Ip(O, j1, kP), Im(O, j1, ph), u_hi);
        corner(O, j1, kP) = c6[O] * (u_hi + u_lo) * (e_hi - e_lo);
      });
    }
    __syncthreads();

    // corner-coupled t-face states, upwinded with u_ad
    if (cell && j1 >= X0 - 1) {
      static_for<0, 2>([&](auto sc) {
        constexpr int TT = t_of(D, decltype(sc)::value);
        constexpr int O = 3 - D - TT;
        constexpr Nb pm = sh3<TT>(kP, -1);
        const T lo = Ip(TT, j1, pm) - corner(O, j1, pm);
        const T hi = Im(TT, j1, kP) - corner(O, j1, kP);
        inter(TT, j1, kP) = upwind(lo, hi, uad(TT, j1, kP));
      });
    }
    __syncthreads();

    // transverse corrections, forces, Riemann select, planes [X0, X1 - 1]
    const int j2 = k - 2;
    int gy, gz;
    if (j2 >= X0 && m.out_cell(gy, gz)) {
      constexpr Nb pm = sh3<D>(kP, -1);
      T stl = Ip(D, j2, pm);
      T sth = Im(D, j2, kP);
      static_for<0, 2>([&](auto sc) {
        constexpr int TT = t_of(D, decltype(sc)::value);
        constexpr Nb pmh = sh3<TT>(pm, 1), ph = sh3<TT>(kP, 1);
        const T corr_m = c4[TT] * (uad(TT, j2, pmh) + uad(TT, j2, pm)) *
                         (inter(TT, j2, pmh) - inter(TT, j2, pm));
        const T corr_p = c4[TT] * (uad(TT, j2, ph) + uad(TT, j2, kP)) *
                         (inter(TT, j2, ph) - inter(TT, j2, kP));
        stl = stl - corr_m;
        sth = sth - corr_p;
      });
      if (a.force != nullptr) {
        stl = stl + half_dt * force(j2, pm);
        sth = sth + half_dt * force(j2, kP);
      }
      const T v = riemann(stl, sth);
      int o[3] = {j2 - H, gy, gz};
      const int n[3] = {a.nxo, a.ny, a.nz};
      auto at = [&]() {
        return (o[0] * (a.ny + (D == 1)) + o[1]) * (a.nz + (D == 2)) + o[2];
      };
      a.out[at()] = v;
      if (o[D] == 0 && (D != 0 || H == 0)) {  // periodic face n == face 0
        o[D] = n[D];
        a.out[at()] = v;
      }
    }
  }
}

// ---------------------------------------------------------------------
// host entries
// ---------------------------------------------------------------------

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

// The wrapper's plan: the tile (kTileY, kTileZ), x rows a CTA marches
// over, and the dynamic shared memory of the kernel for this type.
struct Plan {
  int tile_y, tile_z, chunk, smem;
};

// check the plan, fill the args' grid fields, allow the kernel its
// shared memory and launch it: one CTA per tile and chunk
template <typename Args>
int launch_fused(void (*kernel)(Args), Args a, const Plan& pl, int smem,
                 cudaStream_t st) {
  if (pl.tile_y != kTileY || pl.tile_z != kTileZ || pl.smem != smem ||
      pl.chunk < 1 || a.nxo < 1)
    return (int)cudaErrorInvalidValue;
  a.chunk = pl.chunk;
  a.nty = (a.ny + kTileY - 1) / kTileY;
  a.ntz = (a.nz + kTileZ - 1) / kTileZ;
  const long long blocks =
      (long long)((a.nxo + pl.chunk - 1) / pl.chunk) * a.nty * a.ntz;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned int)blocks, kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int H, typename Args>
void fill_geo(Args& a, int nx, int ny, int nz, double dx0, double dx1,
              double dx2) {
  a.nx = nx;
  a.ny = ny;
  a.nz = nz;
  a.nxo = nx - 2 * H;
  a.dx[0] = dx0;
  a.dx[1] = dx1;
  a.dx[2] = dx2;
}

template <typename T, int H>
int run_uad(const void* vel, void* u0, void* u1, void* u2, const void* dt,
            int nx, int ny, int nz, double dx0, double dx1, double dx2,
            int ppm, const Plan& pl, cudaStream_t st) {
  UadArgs<T, H> a;
  fill_geo<T, H>(a, nx, ny, nz, dx0, dx1, dx2);
  a.vel = static_cast<const T*>(vel);
  a.out[0] = static_cast<T*>(u0);
  a.out[1] = static_cast<T*>(u1);
  a.out[2] = static_cast<T*>(u2);
  a.dt = static_cast<const T*>(dt);
  a.ppm = ppm != 0;
  return launch_fused(uad_kernel<T, H>, a, pl, smem_bytes<T>(kUadEnd), st);
}

template <typename T, int H>
int run_predict_d(int d, const void* vel, int vs, const void* u0,
                  const void* u1, const void* u2, const void* force, int fs,
                  void* out, const void* dt, int nx, int ny, int nz,
                  double dx0, double dx1, double dx2, int ppm,
                  const Plan& pl, cudaStream_t st) {
  PredictArgs<T, H> a;
  fill_geo<T, H>(a, nx, ny, nz, dx0, dx1, dx2);
  a.vel = static_cast<const T*>(vel);
  a.vs = vs;
  a.uad[0] = static_cast<const T*>(u0);
  a.uad[1] = static_cast<const T*>(u1);
  a.uad[2] = static_cast<const T*>(u2);
  a.force = static_cast<const T*>(force);
  a.fs = fs;
  a.out = static_cast<T*>(out);
  a.dt = static_cast<const T*>(dt);
  a.ppm = ppm != 0;
  const int smem = smem_bytes<T>(kPrEnd);
  if (d == 0) return launch_fused(predict_kernel<T, 0, H>, a, pl, smem, st);
  if (d == 1) return launch_fused(predict_kernel<T, 1, H>, a, pl, smem, st);
  return launch_fused(predict_kernel<T, 2, H>, a, pl, smem, st);
}

template <typename T, int H>
int run_advect(const void* q, int qs, const void* m0, const void* m1,
               const void* m2, const void* force, int fs, void* out, int os,
               const void* dt, int nx, int ny, int nz, double dx0,
               double dx1, double dx2, int ppm, int icons, const Plan& pl,
               cudaStream_t st) {
  AdvectArgs<T, H> a;
  fill_geo<T, H>(a, nx, ny, nz, dx0, dx1, dx2);
  a.q = static_cast<const T*>(q);
  a.qs = qs;
  a.mac[0] = static_cast<const T*>(m0);
  a.mac[1] = static_cast<const T*>(m1);
  a.mac[2] = static_cast<const T*>(m2);
  a.force = static_cast<const T*>(force);
  a.fs = fs;
  a.out = static_cast<T*>(out);
  a.os = os;
  a.dt = static_cast<const T*>(dt);
  a.ppm = ppm != 0;
  a.icons = icons != 0;
  return launch_fused(advect_kernel<T, H>, a, pl, smem_bytes<T>(kAdvEnd), st);
}

}  // namespace

// dtype: 0 = float32, 1 = float64.  halo: 0 for a periodic level, or
// kHalo for a halo slab, whose nx counts its padded rows.  Returns a
// cudaError_t value.  The caller guarantees ncell * stride < 2^31
// (32-bit indices).
extern "C" int godunov_uad(int dtype, const void* vel, void* u0, void* u1,
                           void* u2, const void* dt, int nx, int ny, int nz,
                           double dx0, double dx1, double dx2, int halo,
                           int use_ppm, int tile_y, int tile_z, int chunk,
                           int smem, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Plan pl{tile_y, tile_z, chunk, smem};
  return dispatch(dtype, halo, [&](auto t, auto h) {
    using T = decltype(t);
    constexpr int H = decltype(h)::value;
    return run_uad<T, H>(vel, u0, u1, u2, dt, nx, ny, nz, dx0, dx1, dx2,
                         use_ppm, pl, st);
  });
}

// plan: tile y, tile z, chunk (output rows a CTA marches over), dynamic
// shared-memory bytes (godunov_kernels.tile_plan)
extern "C" int godunov_predict_d(int dtype, int d, const void* vel, int vs,
                                 const void* u0, const void* u1,
                                 const void* u2, const void* force, int fs,
                                 void* out, const void* dt, int nx, int ny,
                                 int nz, double dx0, double dx1, double dx2,
                                 int halo, int use_ppm, int tile_y,
                                 int tile_z, int chunk, int smem,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d < 0 || d > 2) return (int)cudaErrorInvalidValue;
  const Plan pl{tile_y, tile_z, chunk, smem};
  return dispatch(dtype, halo, [&](auto t, auto h) {
    using T = decltype(t);
    constexpr int H = decltype(h)::value;
    return run_predict_d<T, H>(d, vel, vs, u0, u1, u2, force, fs, out, dt,
                               nx, ny, nz, dx0, dx1, dx2, use_ppm, pl, st);
  });
}

extern "C" int godunov_advect(int dtype, const void* q, int qs,
                              const void* m0, const void* m1, const void* m2,
                              const void* force, int fs, void* out, int os,
                              const void* dt, int nx, int ny, int nz,
                              double dx0, double dx1, double dx2, int halo,
                              int use_ppm, int icons, int tile_y, int tile_z,
                              int chunk, int smem, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Plan pl{tile_y, tile_z, chunk, smem};
  return dispatch(dtype, halo, [&](auto t, auto h) {
    using T = decltype(t);
    constexpr int H = decltype(h)::value;
    return run_advect<T, H>(q, qs, m0, m1, m2, force, fs, out, os, dt, nx,
                            ny, nz, dx0, dx1, dx2, use_ppm, icons, pl, st);
  });
}
