// EB cut-cell integrator of incflo_torch (a copy of incflo_tpu's
// native/eb_geometry.cpp, so that the port builds its own): the host-side
// geometry precompute.
//
// Computes fluid volume fractions of every cell from level-set values on
// an s-refined node lattice, using the exact planar-cut formula per
// sub-box.  incflo_torch/eb/geometry.py builds it with g++ at first use
// and holds it against _box_fraction_plain, its numpy form, which
// allocates (cells x 2^d x s^d) temporaries.  OpenMP over x.
//
// C ABI (ctypes):
//   incflo_box_fractions_3d(node_phi, nx, ny, nz, s, out_vfrac)
//     node_phi: (s*nx+1, s*ny+1, s*nz+1) C-contiguous double
//     out_vfrac: (nx, ny, nz) double
//   incflo_box_fractions_2d(...) analogous.

#include <algorithm>
#include <cmath>
#include <cstdint>

namespace {

inline double cube(double v) { return v * v * v; }
inline double sq(double v) { return v * v; }

// Fraction of the unit box where the least-squares plane of the corner
// values is negative (exact for linear phi).
inline double plane_fraction_3d(const double c[8]) {
    // uniform-sign sub-boxes are exactly full/empty; the eps-guarded
    // plane formula below returns ~0.99x garbage when one gradient
    // component vanishes (e.g. an axis-aligned cylinder), minting
    // spurious cut cells deep inside the fluid
    double mn = c[0], mx = c[0];
    for (int i = 1; i < 8; ++i) {
        mn = std::min(mn, c[i]);
        mx = std::max(mx, c[i]);
    }
    if (mx <= 0.0) return 1.0;
    if (mn >= 0.0) return 0.0;
    double mean = 0.0;
    for (int i = 0; i < 8; ++i) mean += c[i];
    mean *= 0.125;
    double gx = 0.25 * ((c[4] + c[5] + c[6] + c[7]) - (c[0] + c[1] + c[2] + c[3]));
    double gy = 0.25 * ((c[2] + c[3] + c[6] + c[7]) - (c[0] + c[1] + c[4] + c[5]));
    double gz = 0.25 * ((c[1] + c[3] + c[5] + c[7]) - (c[0] + c[2] + c[4] + c[6]));
    double ax = std::fabs(gx), ay = std::fabs(gy), az = std::fabs(gz);
    double eps = 1e-12 * std::max(std::fabs(mean), 1.0);
    ax = std::max(ax, eps); ay = std::max(ay, eps); az = std::max(az, eps);
    double vol = 0.0;
    for (int sx = 0; sx <= 1; ++sx)
    for (int sy = 0; sy <= 1; ++sy)
    for (int sz = 0; sz <= 1; ++sz) {
        double phi = mean + (sx - 0.5) * ax + (sy - 0.5) * ay + (sz - 0.5) * az;
        double t = std::max(0.0, -phi);
        double sign = ((sx + sy + sz) & 1) ? -1.0 : 1.0;
        vol += sign * cube(t);
    }
    vol /= 6.0 * ax * ay * az;
    return std::min(1.0, std::max(0.0, vol));
}

inline double plane_fraction_2d(const double c[4]) {
    double mn = std::min(std::min(c[0], c[1]), std::min(c[2], c[3]));
    double mx = std::max(std::max(c[0], c[1]), std::max(c[2], c[3]));
    if (mx <= 0.0) return 1.0;
    if (mn >= 0.0) return 0.0;
    double mean = 0.25 * (c[0] + c[1] + c[2] + c[3]);
    double gx = 0.5 * ((c[2] + c[3]) - (c[0] + c[1]));
    double gy = 0.5 * ((c[1] + c[3]) - (c[0] + c[2]));
    double ax = std::fabs(gx), ay = std::fabs(gy);
    double eps = 1e-12 * std::max(std::fabs(mean), 1.0);
    ax = std::max(ax, eps); ay = std::max(ay, eps);
    double area = 0.0;
    for (int sx = 0; sx <= 1; ++sx)
    for (int sy = 0; sy <= 1; ++sy) {
        double phi = mean + (sx - 0.5) * ax + (sy - 0.5) * ay;
        double t = std::max(0.0, -phi);
        double sign = ((sx + sy) & 1) ? -1.0 : 1.0;
        area += sign * sq(t);
    }
    area /= 2.0 * ax * ay;
    return std::min(1.0, std::max(0.0, area));
}

}  // namespace

extern "C" {

void incflo_box_fractions_3d(const double* node_phi,
                             int64_t nx, int64_t ny, int64_t nz,
                             int s, double* out_vfrac) {
    const int64_t py = (int64_t)s * ny + 1;
    const int64_t pz = (int64_t)s * nz + 1;
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < nx; ++i) {
        for (int64_t j = 0; j < ny; ++j) {
            for (int64_t k = 0; k < nz; ++k) {
                double acc = 0.0;
                for (int oi = 0; oi < s; ++oi)
                for (int oj = 0; oj < s; ++oj)
                for (int ok = 0; ok < s; ++ok) {
                    const int64_t bi = i * s + oi;
                    const int64_t bj = j * s + oj;
                    const int64_t bk = k * s + ok;
                    double c[8];
                    for (int sx = 0; sx <= 1; ++sx)
                    for (int sy = 0; sy <= 1; ++sy)
                    for (int sz = 0; sz <= 1; ++sz) {
                        c[4 * sx + 2 * sy + sz] =
                            node_phi[((bi + sx) * py + (bj + sy)) * pz
                                     + (bk + sz)];
                    }
                    acc += plane_fraction_3d(c);
                }
                out_vfrac[(i * ny + j) * nz + k] = acc / (double)(s * s * s);
            }
        }
    }
}

void incflo_box_fractions_2d(const double* node_phi,
                             int64_t nx, int64_t ny,
                             int s, double* out_vfrac) {
    const int64_t py = (int64_t)s * ny + 1;
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < nx; ++i) {
        for (int64_t j = 0; j < ny; ++j) {
            double acc = 0.0;
            for (int oi = 0; oi < s; ++oi)
            for (int oj = 0; oj < s; ++oj) {
                const int64_t bi = i * s + oi;
                const int64_t bj = j * s + oj;
                double c[4];
                for (int sx = 0; sx <= 1; ++sx)
                for (int sy = 0; sy <= 1; ++sy) {
                    c[2 * sx + sy] = node_phi[(bi + sx) * py + (bj + sy)];
                }
                acc += plane_fraction_2d(c);
            }
            out_vfrac[i * ny + j] = acc / (double)(s * s);
        }
    }
}

}  // extern "C"
