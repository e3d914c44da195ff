"""Godunov corner-transport-upwind chain on 3D grids: the three
hand-written CUDA kernels of incflo_torch/csrc/godunov.cu for fully
periodic grids, and the plain PyTorch versions for periodic and walled
grids.

Contract (the same as incflo_tpu/ops/pallas_godunov.py:391-448):
  predict(grid, vel, forces, dt, use_ppm) -> [umac_x, umac_y, umac_z]
      vel (nx,ny,nz,3) interior cells, forces the same or None.  Face
      arrays in the standard layout, n+1 along their own axis, with the
      periodic face n equal to face 0.
  advect(grid, q, umac, forces, dt, iconserv, use_ppm) -> dq/dt
      q (nx,ny,nz,ncomp); umac as predict returns it (face n is not
      read: it coincides with face 0); forces (nx,ny,nz,ncomp) or None.
  dt is a 0-d tensor (a float is accepted and converted); the kernels
  read it from device memory, so a step never syncs for it.

Kernels (one wrapper and one launch counter each; the counter counts
calls of the wrapper that reach the card):

  uad        replaces pallas_godunov.py:_uad_kernel (:195).  For each
             axis, PPM/PLM traces of that velocity component at its own
             speed and a Riemann select -> transverse face velocity.
  predict_d  replaces pallas_godunov.py:_predict_d_kernel (:210).  MAC
             face velocity for direction d: traces on three axes,
             u_ad-upwinded edges, dt/6 corner and dt/4 transverse
             corrections, +0.5 dt forces, Riemann select.
  advect     replaces pallas_godunov.py:_advect_kernel (:264).  dq/dt of
             one component: traces at the MAC speeds, corner-transport
             corrections (conservative or convective form), upwinded
             faces, flux divergence.

What bounds them on an H100.  uad: bytes (6 fields at 128x128x32 f32,
3.8 us at 3.35 TB/s).  predict_d and advect: operations, about 300 and
550 a cell, with no FMA (the build's -fmad=false, which bit-equality
needs, halves the reachable f32 rate to 33.5 TFLOP/s).  Design: ONE
launch a call, the work on chip.  A CTA owns a TILE = 8 x 32 (y, z)
column of output cells and marches along x over a chunk of output rows,
one thread per cell of the column and its 1-cell halo; the inputs' x
planes arrive by cp.async into rings of shared-memory planes ahead of
use, and each stage (traces, corner corrections, corner-coupled states,
faces with their transverse corrections, flux divergence or Riemann
select) keeps its last few x planes in shared memory for the next
stages, so no intermediate touches device memory.  uad stages the
three velocity components of a plane together, de-interleaved,
computes each cell's trace pair once per axis and takes the lo
neighbour's Ip from a shared plane (y, z) or the previous plane (x).
Halo cells of a tile and a chunk's first planes are recomputed,
bit-equal to their owners'.  tile_plan is the launch plan the wrappers
pass (the tile, the x rows a CTA marches over, the shared-memory bytes);
the C entries check it against csrc/godunov.cu.
The TPU-only parts of the Pallas design (merged (y,z) lane layout,
x-slab DMA, the 4-launch split forced by 16 MB of VMEM, the m % 128 == 0
scope rule) do not carry over.

Halo-slab kernels (B8: pallas_godunov.py:predict_sharded (:525),
advect_sharded (:572) and _halo_x (:502)).  On a level split along x
over the ranks of a SlabMesh (incflo_torch/parallel/mesh.py), each rank
runs the same three kernels in the halo-slab mode of csrc/godunov.cu on
its (nxl + 2 HALO)-row slab after a HALO-row x exchange with its
neighbours: uad_halo, predict_d_halo and advect_comp_halo, whose plain
versions uad_slab_plain, predict_d_slab_plain and advect_comp_slab_plain
run the periodic algebra above on the padded rows (their x neighbours
wrap inside the padded slab, which only the outermost rows see; no output
row reads those).  predict_sharded and advect_sharded are the per-rank
schedule of the reference: halo the velocity, uad on the slab, halo uad,
predict_d three times; halo q, the MAC velocities and the forces, then
advect each component.  Every output row equals the unsharded kernel's
(and the unsharded plain version's) on the same row bit for bit.

Every wrapper takes the plain version only for tensors on the CPU.  On
a CUDA tensor it launches the kernel or raises: outside the kernels'
scope (not 3D, not fully periodic, use_forces_in_trans, a dtype other
than float32/float64) there is no fallback: ops/godunov.py sends 2D
grids, walled grids, use_forces_in_trans and use_mac_phi_in_godunov to
the plain chain on grown arrays before any wrapper sees them.

Grids with a wall: predict_plain and advect_plain, given arrays grown by
ng ghost cells and the components' BC records, run the wall forms of the
chain (ops/godunov_walls.py) on either device.  incflo_tpu runs walled
decks through its jnp Godunov, never through the Pallas kernels, so no
TPU kernel stands behind that path; ops/godunov.py takes it openly for
every grid that is not fully periodic, and the wrappers above go on
refusing such a grid.  Walls in csrc/godunov.cu are open work.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import List, NamedTuple, Sequence, Tuple

import torch

from incflo_torch.grid import Grid
from incflo_torch.ops import cuda_build
from incflo_torch.ops.cuda_build import DT_CODE as _DT_CODE
from incflo_torch.ops.cuda_build import check_rc
from incflo_torch.ops.cuda_build import ptr as _ptr
from incflo_torch.ops.cuda_build import stream as _stream
from incflo_torch.parallel.mesh import HALO

SMALL_VEL = 1.0e-8          # reference incflo_godunov_ppm.H:16

SOURCE = cuda_build.CSRC_DIR / "godunov.cu"


# launch counters: one per kernel, raised by the wrapper where it
# launches the kernel and nowhere else; *_halo count the halo-slab mode
LAUNCHES = {"uad": 0, "predict_d": 0, "advect": 0,
            "uad_halo": 0, "predict_d_halo": 0, "advect_halo": 0}

# TPU kernel each CUDA kernel replaces (file:line of the Pallas body; the
# halo-slab mode: of the sharded wrapper that runs it per shard)
REPLACES = {
    "uad": "incflo_tpu/ops/pallas_godunov.py:195",
    "predict_d": "incflo_tpu/ops/pallas_godunov.py:210",
    "advect": "incflo_tpu/ops/pallas_godunov.py:264",
    "uad_halo": "incflo_tpu/ops/pallas_godunov.py:525",
    "predict_d_halo": "incflo_tpu/ops/pallas_godunov.py:525",
    "advect_halo": "incflo_tpu/ops/pallas_godunov.py:572",
}

# The fused kernels' launch plan (csrc/godunov.cu kTileY, kTileZ and the
# shared-memory layouts kAdv*, kPr*)
TILE = (8, 32)            # output cells (y, z) of a CTA's column
# one thread per cell of a stage's plane ((ty + 2) x (tz + 2)), whole warps
THREADS = -(-(TILE[0] + 2) * (TILE[1] + 2) // 32) * 32
# planes of each kind a kernel keeps in shared memory, ring slots x
# fields summed over its rings: wide (the advected field, (ty + 6) x
# (tz + 6)), staged inputs ((ty + 3) x (tz + 3): MAC velocities, u_ad,
# speeds, forces) and stage planes ((ty + 2) x (tz + 2): traces, corner,
# inter, faces)
_PLANES = {"advect": (7, 6 + 5 + 5 + 3, 2 * 4 + 4 * 3 + 3 * 2 + 6 * 3
                      + 3 * 2),
           "predict_d": (7, 3 * 2 + 6 * 3 + 4, 2 * 4 + 4 * 3 + 2 * 2
                         + 2 * 3),
           # 6 ring slots of the three velocity components; Ip along y, z
           "uad": (6 * 3, 0, 2)}
_MARGIN = 64              # elements before and after the planes
REACH = 3                 # input rows a chunk reads beyond its output rows
SMEM_BLOCK = 232448       # H100: shared memory one CTA may take (227 KB)
SMEM_SM = 233472          # shared memory of a multiprocessor (228 KB)
SMEM_RESERVED = 1024      # what the runtime keeps of it per CTA
THREADS_SM = 2048
SMS = 132                 # multiprocessors of an H100 SXM
MIN_CHUNK_UAD = 8         # output rows of a uad CTA at least


class Plan(NamedTuple):
    tile: Tuple[int, int]      # output cells (y, z) of a CTA
    chunk: int                 # output rows (x) a CTA marches over
    grid: Tuple[int, int, int]  # CTAs: chunks, y tiles, z tiles
    smem: int                  # dynamic shared-memory bytes of a CTA
    ctas_per_sm: int           # as shared memory and threads allow


def smem_bytes(kind: str, itemsize: int) -> int:
    """Dynamic shared memory of a fused kernel's CTA (csrc/godunov.cu
    smem_bytes): the rings of planes and the y and z wrap tables."""
    ty, tz = TILE
    wide, staged, stage = _PLANES[kind]
    elems = (2 * _MARGIN + wide * (ty + 6) * (tz + 6)
             + staged * (ty + 3) * (tz + 3) + stage * (ty + 2) * (tz + 2))
    return itemsize * elems + 4 * ((ty + 6) + (tz + 6))


def tile_plan(kind: str, out_cells, itemsize: int, sms: int = SMS) -> Plan:
    """Launch plan of a fused kernel ("advect", "predict_d" or "uad") for an
    output of out_cells = (rows, ny, nz) cells: one CTA per y-z tile and
    chunk of rows.  The chunk is the shortest that keeps every CTA slot of
    the card (sms x CTAs a multiprocessor holds) busy in one wave, but
    uad's at least MIN_CHUNK_UAD rows while that leaves a CTA for every
    multiprocessor: its few operations a plane leave the 5 planes a
    chunk loads before its first output to dominate a shorter one."""
    nx, ny, nz = out_cells
    ty, tz = TILE
    smem = smem_bytes(kind, itemsize)
    per_sm = min(THREADS_SM // THREADS, SMEM_SM // (smem + SMEM_RESERVED))
    tiles = (-(-ny // ty), -(-nz // tz))
    nchunks = max(1, min(nx, sms * per_sm // (tiles[0] * tiles[1])))
    chunk = -(-nx // nchunks)
    if kind == "uad":
        one_an_sm = -(-nx * tiles[0] * tiles[1] // sms)
        chunk = min(nx, max(chunk, min(MIN_CHUNK_UAD, one_an_sm)))
    return Plan(TILE, chunk, (-(-nx // chunk),) + tiles, smem, per_sm)


_SMS = {}


def _plan(kind, grid, t):
    """The plan for the output rows of `grid` (a slab's nxl) on t's card."""
    dev = t.device
    if dev not in _SMS:
        _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return tile_plan(kind, grid.n_cell, t.element_size(), _SMS[dev])


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------
# plain PyTorch versions: the periodic algebra of pallas_godunov._traces,
# _riemann, _upwind and the three kernel bodies, on (nx, ny, nz) tensors
# ---------------------------------------------------------------------

def _sh(a, ax, s):
    """a(idx + s e_ax), periodic."""
    return a if s == 0 else torch.roll(a, -s, dims=ax)


def _div(a, c):
    """a / c for a Python float c, as the kernels divide: PyTorch divides
    a CUDA tensor by a Python float as a product with its reciprocal,
    which rounds differently; by a 0-d tensor it divides."""
    return a / torch.full((), c, dtype=a.dtype, device=a.device)


def _van_leer(a, b, c):
    """vanLeer(center, plus, minus) (godunov_ppm.H:18-28)."""
    dsc = 0.5 * (b - c)
    dsl = 2.0 * (a - c)
    dsr = 2.0 * (b - a)
    lim = torch.sign(dsc) * torch.minimum(
        dsc.abs(), torch.minimum(dsl.abs(), dsr.abs()))
    return torch.where(dsl * dsr > 1.0e-20, lim, 0.0)


def _mc2_parts(a, b, c):
    dl = 2.0 * (b - a)
    dr = 2.0 * (c - b)
    dc = 0.5 * (c - a)
    dlim = torch.where(dl * dr >= 0.0, torch.minimum(dl.abs(), dr.abs()),
                       0.0)
    return dc, dlim


def _mc4(qm2, qm1, q0, qp1, qp2):
    """Order-4 MC slope (amrex_calc_xslope order 4, periodic interior)."""
    dcm, dlimm = _mc2_parts(qm2, qm1, q0)
    sm = torch.sign(dcm) * torch.minimum(dcm.abs(), dlimm)
    dcp, dlimp = _mc2_parts(q0, qp1, qp2)
    sp = torch.sign(dcp) * torch.minimum(dcp.abs(), dlimp)
    dc, dlim = _mc2_parts(qm1, q0, qp1)
    dq = (4.0 / 3.0) * dc - (1.0 / 6.0) * (sp + sm)
    return torch.sign(dq) * torch.minimum(dq.abs(), dlim)


def _upwind(lo, hi, w):
    st = torch.where(w >= 0.0, lo, hi)
    return torch.where(w.abs() < SMALL_VEL, 0.5 * (hi + lo), st)


def _riemann(stl, sth):
    st = torch.where(stl + sth >= 0.0, stl, sth)
    ltm = ((stl <= 0.0) & (sth >= 0.0)) | ((stl + sth).abs() < SMALL_VEL)
    return torch.where(ltm, 0.0, st)


def _traces(q, ax, wlo, whi, dtdx, use_ppm):
    """Per-cell characteristic traces (Im, Ip) along `ax` with wave speeds
    wlo/whi at the cell's lo/hi faces."""
    sm2, sm1, s0, sp1, sp2 = (_sh(q, ax, s) for s in (-2, -1, 0, 1, 2))
    if not use_ppm:
        slp = _mc4(sm2, sm1, s0, sp1, sp2)
        Im = s0 + 0.5 * (-1.0 - wlo * dtdx) * slp
        Ip = s0 + 0.5 * (1.0 - whi * dtdx) * slp
        return Im, Ip
    d1 = _van_leer(s0, sp1, sm1)
    d2 = _van_leer(sm1, s0, sm2)
    sedge1 = 0.5 * (s0 + sm1) - (1.0 / 6.0) * (d1 - d2)
    sedge1 = torch.clamp(sedge1, torch.minimum(s0, sm1),
                         torch.maximum(s0, sm1))
    d1p = _van_leer(sp1, sp2, s0)
    sedge2 = 0.5 * (sp1 + s0) - (1.0 / 6.0) * (d1p - d1)
    sedge2 = torch.clamp(sedge2, torch.minimum(s0, sp1),
                         torch.maximum(s0, sp1))
    flat = (sedge2 - s0) * (s0 - sedge1) < 0.0
    big_p = (sedge2 - s0).abs() >= 2.0 * (sedge1 - s0).abs()
    big_m = (sedge1 - s0).abs() >= 2.0 * (sedge2 - s0).abs()
    sp = torch.where(flat, s0,
                     torch.where(big_p, 3.0 * s0 - 2.0 * sedge1, sedge2))
    sm = torch.where(flat, s0,
                     torch.where(~big_p & big_m, 3.0 * s0 - 2.0 * sedge2,
                                 sedge1))
    s6 = 6.0 * s0 - 3.0 * (sm + sp)
    sig_p = whi.abs() * dtdx
    sig_m = wlo.abs() * dtdx
    Ip = torch.where(whi > SMALL_VEL,
                     sp - 0.5 * sig_p * ((sp - sm)
                                         - (1.0 - 2.0 / 3.0 * sig_p) * s6),
                     s0)
    Im = torch.where(wlo < -SMALL_VEL,
                     sm + 0.5 * sig_m * ((sp - sm)
                                         + (1.0 - 2.0 / 3.0 * sig_m) * s6),
                     s0)
    return Im, Ip


def _faces_full(a, d):
    """Cell-shaped lo-face array -> standard n+1 layout along d."""
    return torch.cat([a, a.narrow(d, 0, 1)], dim=d)


def uad_plain(grid: Grid, vel, dt, use_ppm: bool) -> List[torch.Tensor]:
    """Plain version of the `uad` kernel: three cell-shaped face arrays
    (entry i = the lo face of cell i)."""
    out = []
    for ax in range(3):
        v = vel[..., ax]
        Im, Ip = _traces(v, ax, v, v, _div(dt, grid.dx[ax]), use_ppm)
        out.append(_riemann(_sh(Ip, ax, -1), Im))
    return out


def predict_d_plain(grid: Grid, vel, uad, force_d, dt, d: int,
                    use_ppm: bool) -> torch.Tensor:
    """Plain version of the `predict_d` kernel: the MAC face velocity of
    direction d in the standard n+1 layout."""
    dx = grid.dx
    comp = [vel[..., c] for c in range(3)]
    xlo, xhi, edge = {}, {}, {}
    for ax in range(3):
        Im, Ip = _traces(comp[d], ax, comp[ax], comp[ax], _div(dt, dx[ax]),
                         use_ppm)
        xlo[ax] = _sh(Ip, ax, -1)
        xhi[ax] = Im
        edge[ax] = _upwind(xlo[ax], xhi[ax], uad[ax])
    stl, sth = xlo[d], xhi[d]
    for t in (a for a in range(3) if a != d):
        o = 3 - d - t
        corr_o = (_div(dt, 6.0 * dx[o]) * (_sh(uad[o], o, 1) + uad[o])
                  * (_sh(edge[o], o, 1) - edge[o]))
        inter = _upwind(xlo[t] - _sh(corr_o, t, -1), xhi[t] - corr_o,
                        uad[t])
        corr_t = (_div(dt, 4.0 * dx[t]) * (_sh(uad[t], t, 1) + uad[t])
                  * (_sh(inter, t, 1) - inter))
        stl = stl - _sh(corr_t, d, -1)
        sth = sth - corr_t
    if force_d is not None:
        stl = stl + 0.5 * dt * _sh(force_d, d, -1)
        sth = sth + 0.5 * dt * force_d
    return _faces_full(_riemann(stl, sth), d)


def advect_comp_plain(grid: Grid, q, umac, force_q, dt, icons: bool,
                      use_ppm: bool) -> torch.Tensor:
    """Plain version of the `advect` kernel: dq/dt of one component."""
    dx = grid.dx
    mac = [umac[ax].narrow(ax, 0, grid.n_cell[ax]) for ax in range(3)]
    mac_hi = [_sh(mac[ax], ax, 1) for ax in range(3)]
    xlo, xhi, edge = {}, {}, {}
    for ax in range(3):
        Im, Ip = _traces(q, ax, mac[ax], mac_hi[ax], _div(dt, dx[ax]),
                         use_ppm)
        xlo[ax] = _sh(Ip, ax, -1)
        xhi[ax] = Im
        edge[ax] = _upwind(xlo[ax], xhi[ax], mac[ax])
    rate = None
    for d in range(3):
        stl, sth = xlo[d], xhi[d]
        for t in (a for a in range(3) if a != d):
            o = 3 - d - t
            e_lo, e_hi = edge[o], _sh(edge[o], o, 1)
            if icons:
                corr_o = (_div(dt, 3.0 * dx[o])
                          * ((e_hi * mac_hi[o] - e_lo * mac[o])
                             - q * (mac_hi[o] - mac[o])))
            else:
                corr_o = (_div(dt, 6.0 * dx[o])
                          * (mac_hi[o] + mac[o]) * (e_hi - e_lo))
            inter = _upwind(xlo[t] - _sh(corr_o, t, -1), xhi[t] - corr_o,
                            mac[t])
            i_hi = _sh(inter, t, 1)
            if icons:
                corr_t = (_div(dt, 2.0 * dx[t])
                          * ((i_hi * mac_hi[t] - inter * mac[t])
                             - q * (mac_hi[t] - mac[t])))
            else:
                corr_t = (_div(dt, 4.0 * dx[t])
                          * (mac_hi[t] + mac[t]) * (i_hi - inter))
            stl = stl - _sh(corr_t, d, -1)
            sth = sth - corr_t
        if force_q is not None:
            stl = stl + 0.5 * dt * _sh(force_q, d, -1)
            sth = sth + 0.5 * dt * force_q
        qf = _upwind(stl, sth, mac[d])
        qf_hi = _sh(qf, d, 1)
        if icons:
            term = _div(mac[d] * qf - mac_hi[d] * qf_hi, dx[d])
        else:
            term = _div(0.5 * (mac[d] + mac_hi[d]) * (qf - qf_hi), dx[d])
        rate = term if rate is None else rate + term
    return rate


def _check_walled(grid: Grid, field, ng: int, bcrecs):
    if bcrecs is None or ng < 3:
        raise ValueError("the wall forms need the components' BC records "
                         "and fields grown by ng >= 3 ghost cells")
    if field.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"Godunov takes float32/float64, got {field.dtype}")
    if tuple(field.shape[:grid.ndim]) != tuple(n + 2 * ng
                                               for n in grid.n_cell):
        raise ValueError(f"field shape {tuple(field.shape)} is not the "
                         f"grid {grid.n_cell} grown by {ng}")


def predict_plain(grid: Grid, vel, forces, dt, use_ppm: bool,
                  bcrecs=None, ng: int = 0, use_forces_in_trans=False,
                  gmacphi=None) -> List[torch.Tensor]:
    """Plain version of predict(): uad, then predict_d for d = 0, 1, 2.
    With ng > 0 the general form of the chain (ops/godunov_walls.py),
    2D or 3D, any mix of walls: `vel` is grown by ng >= 3 ghost cells
    filled by the physical BCs, `forces` by 1, and `bcrecs` (nd, nd, 2)
    holds the BCType of each component on each side of each axis; it
    alone takes use_forces_in_trans and the MAC-phi face gradient
    `gmacphi` of use_mac_phi_in_godunov."""
    if (ng > 0 or grid.ndim != 3 or not all(grid.periodic)
            or use_forces_in_trans or gmacphi is not None):
        from incflo_torch.ops.godunov_walls import WindowedGodunov
        _check_walled(grid, vel, ng, bcrecs)
        return WindowedGodunov(grid, use_ppm, use_forces_in_trans).predict(
            vel, forces, _dt_tensor(dt, vel), ng, bcrecs, gmacphi)
    _check_scope(grid, vel)
    dt = _dt_tensor(dt, vel)
    uad = uad_plain(grid, vel, dt, use_ppm)
    return [predict_d_plain(grid, vel, uad,
                            None if forces is None else forces[..., d],
                            dt, d, use_ppm) for d in range(3)]


def advect_plain(grid: Grid, q, umac, forces, dt, iconserv: Sequence[int],
                 use_ppm: bool, bcrecs=None, ng: int = 0,
                 is_velocity: bool = False,
                 use_forces_in_trans=False) -> torch.Tensor:
    """Plain version of advect(): one advect per component.  With ng > 0
    the general form, on grown arrays as for predict_plain;
    `is_velocity` then selects the normal-velocity forms at ext_dir
    faces."""
    if (ng > 0 or grid.ndim != 3 or not all(grid.periodic)
            or use_forces_in_trans):
        from incflo_torch.ops.godunov_walls import WindowedGodunov
        _check_walled(grid, q, ng, bcrecs)
        return WindowedGodunov(grid, use_ppm, use_forces_in_trans).advect(
            q, umac, forces, _dt_tensor(dt, q), ng, bcrecs, iconserv,
            is_velocity)
    _check_scope(grid, q)
    dt = _dt_tensor(dt, q)
    return torch.stack(
        [advect_comp_plain(grid, q[..., n], umac,
                           None if forces is None else forces[..., n], dt,
                           bool(iconserv[n]), use_ppm)
         for n in range(q.shape[-1])], dim=-1)


# ---------------------------------------------------------------------
# scope and argument checks
# ---------------------------------------------------------------------

def _check_scope(grid: Grid, field, use_forces_in_trans: bool = False):
    if grid.ndim != 3 or not all(grid.periodic):
        raise NotImplementedError(
            "incflo_torch Godunov kernels cover 3D fully periodic grids; "
            "2D and walled grids take predict_plain / advect_plain on "
            "grown arrays")
    if use_forces_in_trans:
        raise NotImplementedError(
            "the Godunov kernels add the forces after the transverse "
            "stages: use_forces_in_trans takes predict_plain / "
            "advect_plain on grown arrays")
    if field.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"Godunov kernels take float32/float64, got "
                        f"{field.dtype}")
    if tuple(field.shape[:3]) != tuple(grid.n_cell):
        raise ValueError(f"field shape {tuple(field.shape)} does not match "
                         f"the grid {grid.n_cell}")


def _dt_tensor(dt, like):
    if isinstance(dt, torch.Tensor):
        return dt.to(device=like.device, dtype=like.dtype).reshape(())
    return torch.tensor(dt, dtype=like.dtype, device=like.device)


def _check_index_range(cells, ncomp):
    """The kernels index with 32-bit integers."""
    n = 1
    for m in cells:
        n *= m + 1
    if n * max(ncomp, 1) >= 2 ** 31:
        raise ValueError(f"grid {tuple(cells)} x {ncomp} components is "
                         "too large for the kernels' 32-bit indices")


def _cuda_checked(name, t, shape, dtype, device):
    if t.device != device or t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype} on {device}, got "
                         f"{t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    return t.contiguous()


# ---------------------------------------------------------------------
# build and bind (ops/cuda_build.py): built at first use
# ---------------------------------------------------------------------

_LIB = None


def build(ptxas_verbose: bool = False) -> Path:
    """Compile csrc/godunov.cu unless this source's library exists."""
    return cuda_build.build(SOURCE, ptxas_verbose)


def _lib():
    global _LIB
    if _LIB is None:
        lib = cuda_build.load(SOURCE)
        P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        geo = [I, I, I, D, D, D, I]
        plan = [I, I, I, I]     # tile y, tile z, chunk, shared-memory bytes
        lib.godunov_uad.argtypes = [I, P, P, P, P, P] + geo + [I] + plan + [P]
        lib.godunov_predict_d.argtypes = (
            [I, I, P, I, P, P, P, P, I, P, P] + geo + [I] + plan + [P])
        lib.godunov_advect.argtypes = (
            [I, P, I, P, P, P, P, I, P, I, P] + geo + [I, I] + plan + [P])
        for f in (lib.godunov_uad, lib.godunov_predict_d,
                  lib.godunov_advect):
            f.restype = I
        _LIB = lib
    return _LIB


def _geo(grid, halo=0):
    """(nx, ny, nz, dx, dy, dz, halo) of the C entries: a halo slab
    passes its padded rows."""
    n = (grid.n_cell[0] + 2 * halo,) + tuple(grid.n_cell[1:])
    return (*n, *(float(d) for d in grid.dx), halo)


# ---------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------

def _padded(grid, halo):
    """Cell extents of the arrays a kernel reads: the slab's rows and
    `halo` rows of each x neighbour."""
    return (grid.n_cell[0] + 2 * halo,) + tuple(grid.n_cell[1:])


def _face_shape(cells, ax, halo):
    """A face array along ax: n+1 faces on its own axis, but a halo
    slab's x faces are the low faces of its rows."""
    own = 0 if (halo and ax == 0) else 1
    return tuple(m + (own if a == ax else 0) for a, m in enumerate(cells))


def _launch_uad(grid, vel, dt, use_ppm, halo, key):
    pn = _padded(grid, halo)
    _check_index_range(pn, 3)
    vel = _cuda_checked("vel", vel, pn + (3,), vel.dtype, vel.device)
    out = [torch.empty(grid.n_cell, dtype=vel.dtype, device=vel.device)
           for _ in range(3)]
    lib = _lib()
    pl = _plan("uad", grid, vel)
    rc = lib.godunov_uad(_DT_CODE[vel.dtype], _ptr(vel),
                         *(_ptr(u) for u in out), _ptr(dt),
                         *_geo(grid, halo), int(use_ppm), *pl.tile, pl.chunk,
                         pl.smem, _stream(vel))
    check_rc(key, rc)
    LAUNCHES[key] += 1
    return out


def _launch_predict_d(grid, vel, uad_faces, forces, dt, d, use_ppm, halo,
                      key):
    dev, dty = vel.device, vel.dtype
    pn = _padded(grid, halo)
    _check_index_range(pn, 3)
    vel = _cuda_checked("vel", vel, pn + (3,), dty, dev)
    uad_faces = [_cuda_checked("uad", u, pn, dty, dev) for u in uad_faces]
    if forces is not None:
        forces = _cuda_checked("forces", forces, pn + (3,), dty, dev)
    out = torch.empty(_face_shape(grid.n_cell, d, halo), dtype=dty,
                      device=dev)
    lib = _lib()
    pl = _plan("predict_d", grid, vel)
    fptr = _ptr(forces, d) if forces is not None else None
    rc = lib.godunov_predict_d(_DT_CODE[dty], d, _ptr(vel), 3,
                                  *(_ptr(u) for u in uad_faces), fptr, 3,
                                  _ptr(out), _ptr(dt), *_geo(grid, halo),
                                  int(use_ppm), *pl.tile, pl.chunk, pl.smem,
                                  _stream(vel))
    check_rc(key, rc)
    LAUNCHES[key] += 1
    return out


def _launch_advect(grid, q, n, umac, forces, dt, icons, use_ppm, out, halo,
                   key):
    dev, dty = q.device, q.dtype
    ncomp = q.shape[-1]
    pn = _padded(grid, halo)
    _check_index_range(pn, ncomp)
    q = _cuda_checked("q", q, pn + (ncomp,), dty, dev)
    mac = [_cuda_checked(f"umac[{ax}]", umac[ax], _face_shape(pn, ax, halo),
                         dty, dev) for ax in range(3)]
    if forces is not None:
        forces = _cuda_checked("forces", forces, pn + (ncomp,), dty, dev)
    shape = tuple(grid.n_cell) + (ncomp,)
    if out is None:
        out = torch.empty(shape, dtype=dty, device=dev)
    elif not (out.is_contiguous() and tuple(out.shape) == shape
              and out.dtype == dty and out.device == dev):
        raise ValueError(f"{key}: `out` must be a contiguous {dty} tensor "
                         f"of shape {shape} on {dev}")
    lib = _lib()
    pl = _plan("advect", grid, q)
    fptr = _ptr(forces, n) if forces is not None else None
    rc = lib.godunov_advect(_DT_CODE[dty], _ptr(q, n), ncomp,
                               *(_ptr(m) for m in mac), fptr, ncomp,
                               _ptr(out, n), ncomp, _ptr(dt),
                               *_geo(grid, halo), int(use_ppm), int(icons),
                               *pl.tile, pl.chunk, pl.smem, _stream(q))
    check_rc(key, rc)
    LAUNCHES[key] += 1
    return out[..., n]


def uad(grid: Grid, vel, dt, use_ppm: bool) -> List[torch.Tensor]:
    """`uad` kernel: the three transverse face velocities, cell-shaped."""
    _check_scope(grid, vel)
    dt = _dt_tensor(dt, vel)
    if vel.device.type == "cpu":
        return uad_plain(grid, vel, dt, use_ppm)
    return _launch_uad(grid, vel, dt, use_ppm, 0, "uad")


def predict_d(grid: Grid, vel, uad_faces, forces, dt, d: int,
              use_ppm: bool) -> torch.Tensor:
    """`predict_d` kernel: MAC face velocity of direction d (n+1 layout).
    `forces` is the full (nx,ny,nz,3) force field or None."""
    _check_scope(grid, vel)
    dt = _dt_tensor(dt, vel)
    if vel.device.type == "cpu":
        return predict_d_plain(grid, vel, uad_faces,
                               None if forces is None else forces[..., d],
                               dt, d, use_ppm)
    return _launch_predict_d(grid, vel, uad_faces, forces, dt, d, use_ppm,
                             0, "predict_d")


def advect_comp(grid: Grid, q, n: int, umac, forces, dt, icons: bool,
                use_ppm: bool, out=None) -> torch.Tensor:
    """`advect` kernel: dq/dt of component n of q (nx,ny,nz,ncomp).  On
    the card it writes into out[..., n] when `out` is given and returns
    the (nx,ny,nz) result."""
    _check_scope(grid, q)
    dt = _dt_tensor(dt, q)
    if q.device.type == "cpu":
        r = advect_comp_plain(grid, q[..., n], umac,
                              None if forces is None else forces[..., n],
                              dt, icons, use_ppm)
        if out is not None:
            out[..., n] = r
        return r
    return _launch_advect(grid, q, n, umac, forces, dt, icons, use_ppm, out,
                          0, "advect")


# ---------------------------------------------------------------------
# the halo-slab kernels (B8) and their plain versions.  `grid` is the
# slab's geometry: n_cell its cells (nxl along x), dx the level's (a
# parallel.mesh.SlabGrid).  The inputs carry HALO extra x rows on each
# side; an x face array holds the low face of each of its rows.
# ---------------------------------------------------------------------

class _Rows:
    """The padded rows of a slab as a periodic grid of the plain
    versions, which read only n_cell and dx."""

    def __init__(self, grid):
        self.n_cell = _padded(grid, HALO)
        self.dx = tuple(grid.dx)


def _slab_rows(a, grid):
    return a.narrow(0, HALO, grid.n_cell[0])


def uad_slab_plain(grid, vel_p, dt, use_ppm: bool) -> List[torch.Tensor]:
    """Plain version of `uad_halo`: uad_plain on the padded rows, the
    slab's rows kept."""
    return [_slab_rows(u, grid)
            for u in uad_plain(_Rows(grid), vel_p, dt, use_ppm)]


def predict_d_slab_plain(grid, vel_p, uad_p, force_p, dt, d: int,
                         use_ppm: bool) -> torch.Tensor:
    """Plain version of `predict_d_halo` (force_p: component d or
    None): the slab's rows of predict_d_plain on the padded rows."""
    return _slab_rows(predict_d_plain(_Rows(grid), vel_p, uad_p, force_p,
                                      dt, d, use_ppm), grid)


def advect_comp_slab_plain(grid, q_p, mac_p, force_p, dt, icons: bool,
                           use_ppm: bool) -> torch.Tensor:
    """Plain version of `advect_comp_halo` on one component's padded
    plane q_p (force_p likewise or None)."""
    return _slab_rows(advect_comp_plain(_Rows(grid), q_p, mac_p, force_p,
                                        dt, icons, use_ppm), grid)


def _check_slab(grid, field):
    if grid.ndim != 3 or not all(grid.periodic):
        raise ValueError(
            "the halo-slab Godunov kernels cover x slabs of 3D fully "
            "periodic levels; a 2D or walled slab takes the plain chain "
            "(ops/godunov.py dispatches it to ops/godunov_walls.py)")
    if field.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"Godunov kernels take float32/float64, got "
                        f"{field.dtype}")
    if tuple(field.shape[:3]) != _padded(grid, HALO):
        raise ValueError(f"halo slab shape {tuple(field.shape)} is not the "
                         f"slab {grid.n_cell} grown by {HALO} x rows a side")


def uad_halo(grid, vel_p, dt, use_ppm: bool) -> List[torch.Tensor]:
    """`uad` in the halo-slab mode: vel_p (nxl + 2 HALO, ny, nz, 3) ->
    the three (nxl, ny, nz) face arrays of the slab's rows."""
    _check_slab(grid, vel_p)
    dt = _dt_tensor(dt, vel_p)
    if vel_p.device.type == "cpu":
        return uad_slab_plain(grid, vel_p, dt, use_ppm)
    return _launch_uad(grid, vel_p, dt, use_ppm, HALO, "uad_halo")


def predict_d_halo(grid, vel_p, uad_p, forces_p, dt, d: int,
                   use_ppm: bool) -> torch.Tensor:
    """`predict_d` in the halo-slab mode: padded velocity, uad and forces
    (all components, or None) -> the MAC velocity of direction d on the
    slab's rows: x faces (nxl, ny, nz), the slab's low faces; y and z
    faces with their wrap face."""
    _check_slab(grid, vel_p)
    dt = _dt_tensor(dt, vel_p)
    if vel_p.device.type == "cpu":
        return predict_d_slab_plain(
            grid, vel_p, uad_p, None if forces_p is None else forces_p[..., d],
            dt, d, use_ppm)
    return _launch_predict_d(grid, vel_p, uad_p, forces_p, dt, d, use_ppm,
                             HALO, "predict_d_halo")


def advect_comp_halo(grid, q_p, n: int, mac_p, forces_p, dt, icons: bool,
                     use_ppm: bool, out=None) -> torch.Tensor:
    """`advect` in the halo-slab mode: dq/dt of component n of the padded
    q_p (nxl + 2 HALO, ny, nz, ncomp) on the slab's rows.  mac_p: the
    padded x faces (one per row), y and z faces (with their wrap face);
    forces_p padded like q_p or None.  On the card it writes into
    out[..., n] when `out` is given."""
    _check_slab(grid, q_p)
    dt = _dt_tensor(dt, q_p)
    if q_p.device.type == "cpu":
        r = advect_comp_slab_plain(
            grid, q_p[..., n], mac_p,
            None if forces_p is None else forces_p[..., n], dt, icons,
            use_ppm)
        if out is not None:
            out[..., n] = r
        return r
    return _launch_advect(grid, q_p, n, mac_p, forces_p, dt, icons, use_ppm,
                          out, HALO, "advect_halo")


def predict_sharded(grid, vel, forces, dt, use_ppm: bool
                    ) -> List[torch.Tensor]:
    """predict() on this rank's x slab (pallas_godunov.py:525-569): halo
    the velocity and forces, uad on the slab, halo uad, predict_d for
    d = 0, 1, 2.  Returns the slab's face arrays: nxl + 1 x faces (the
    last is the right neighbour's face 0, as the reference appends face
    n == face 0 outside its shard map), y and z faces with their wrap
    face.  `grid` is the rank's SlabGrid."""
    mesh = grid.mesh
    dt = _dt_tensor(dt, vel)
    ins = [vel] + ([] if forces is None else [forces])
    padded = mesh.halo_x(ins, HALO)
    vel_p = padded[0]
    forces_p = None if forces is None else padded[1]
    uad_p = mesh.halo_x(uad_halo(grid, vel_p, dt, use_ppm), HALO)
    out = [predict_d_halo(grid, vel_p, uad_p, forces_p, dt, d, use_ppm)
           for d in range(3)]
    out[0] = mesh.halo_x(out[0], 0, 1)
    return out


def advect_sharded(grid, q, umac, forces, dt, iconserv: Sequence[int],
                   use_ppm: bool) -> torch.Tensor:
    """advect() on this rank's x slab (pallas_godunov.py:572-612): umac
    as predict_sharded returns it; its last x face (the right
    neighbour's face 0) is dropped, and q, the MAC velocities and the
    forces are haloed in one exchange, then one advect_halo launch per
    component."""
    mesh = grid.mesh
    dt = _dt_tensor(dt, q)
    nxl = grid.n_cell[0]
    ins = [q, umac[0].narrow(0, 0, nxl), umac[1], umac[2]]
    if forces is not None:
        ins.append(forces)
    padded = mesh.halo_x(ins, HALO)
    q_p, mac_p = padded[0], padded[1:4]
    forces_p = None if forces is None else padded[4]
    out = torch.empty(tuple(q.shape), dtype=q.dtype, device=q.device)
    for n in range(q.shape[-1]):
        advect_comp_halo(grid, q_p, n, mac_p, forces_p, dt,
                         bool(iconserv[n]), use_ppm, out=out)
    return out


def predict(grid: Grid, vel, forces, dt, use_ppm: bool,
            use_forces_in_trans: bool = False) -> List[torch.Tensor]:
    """Half-time MAC velocities: one `uad` launch, then three
    `predict_d` launches (d = 0, 1, 2)."""
    _check_scope(grid, vel, use_forces_in_trans)
    if vel.device.type == "cpu":
        return predict_plain(grid, vel, forces, dt, use_ppm)
    dt = _dt_tensor(dt, vel)
    vel = vel.contiguous()
    if forces is not None:
        forces = forces.contiguous()
    u = uad(grid, vel, dt, use_ppm)
    return [predict_d(grid, vel, u, forces, dt, d, use_ppm)
            for d in range(3)]


def advect(grid: Grid, q, umac, forces, dt, iconserv: Sequence[int],
           use_ppm: bool, use_forces_in_trans: bool = False
           ) -> torch.Tensor:
    """dq/dt on the interior: one `advect` launch per component."""
    _check_scope(grid, q, use_forces_in_trans)
    if q.device.type == "cpu":
        return advect_plain(grid, q, umac, forces, dt, iconserv, use_ppm)
    dt = _dt_tensor(dt, q)
    q = q.contiguous()
    if forces is not None:
        forces = forces.contiguous()
    out = torch.empty_like(q)
    for n in range(q.shape[-1]):
        advect_comp(grid, q, n, umac, forces, dt, bool(iconserv[n]),
                    use_ppm, out=out)
    return out
