"""x-slab decomposition of one level over R ranks: the counterpart of
incflo_tpu/parallel/mesh.py and of the mesh registry of
incflo_tpu/ops/pallas_guard.py.

incflo_tpu lays a level out on a device mesh and lets GSPMD derive the
communication; only its Godunov kernels exchange halos by hand
(pallas_godunov.py:502, ppermute).  PyTorch has no GSPMD, so the port
writes the decomposition out.  Rank r of R holds the x rows
[r nxl, (r + 1) nxl) of every cell and node field (nxl = nx / R) and
the faces of its cells: nxl + 1 x faces, its own low faces and the right
neighbour's first.  Node n of a periodic x is node 0, so node fields
split like cell fields there; a level whose x ends in walls, inflow or
outflow has nx + 1 x nodes, and the last rank also holds node nx (the
owner layout: every node has one owner, so dots, norms and means count
each node once).

A level whose nx does not split into R equal slabs at least HALO cells
wide (SlabMesh.splits) is held whole on every rank: the Simulation on it
takes no mesh, so its solves, reductions and kernels run as on one
device, the same bits on every rank, with no exchange.  It is
incflo_tpu's replicated axis (incflo_tpu/parallel/mesh.py:44-57), which
incflo_tpu takes only where an axis does not divide its mesh: it shards
down to one cell a device, but the port's Godunov halo needs HALO
cells.  The drivers above a level
keep the run's mesh, to say which rank writes its files.

The level's x is periodic or ends in boundaries on both sides.  Where
it ends in boundaries, the first rank's low side and the last rank's
high side are the level's own x faces (SlabGrid.x_edge, SlabMesh.ends):
no rows cross them, and the caller fills what lies beyond (the physical
ghost fill, an operator's boundary pad).  What crosses ranks:

  halo_x            the x ghosts of a slab from its neighbours, of any
                    depth up to the slab's width: every ghost fill
                    (bcs.grow), the one-cell pads of the operators
                    (multigrid._cell_pad, ...), the 4-cell Godunov
                    halos (godunov_kernels.predict_sharded /
                    advect_sharded) and the deep halos of the slab
                    smoothers (smoother_kernels.cell_smooth_slab /
                    nodal_smooth_slab)
  all_reduce_*      the maxima of compute_dt, of the residual norms and of
                    the smoothers' diagonals, the dots of the CGs, the
                    sum and count of a singular right-hand side's mean
  reduce_scatter_x  the x contraction of the fast-diagonalization solves
                    (spectral.solve)
  all_gather_x      a whole coarse level on every rank, in rank order, so
                    that every rank holds the same bits: the multigrid
                    levels too narrow for their smoothers' halos
                    (multigrid.CellSolver, NodalSolver)
  slab / gather     whole fields in and out (tests, diagnostics, a state
                    carried over from one rank, checkpoints)

Static arrays that every rank holds whole -- the cut-cell geometry of an
embedded boundary and the EB nodal stencils, built on every rank from
the deck -- need no exchange: cut_x takes a rank's rows of them, ghost
rows included, from the whole array.

The exchanges go through torch.distributed: NCCL where each rank has its
own GPU, gloo on the CPU.  NCCL refuses two ranks on one device, so ranks
that share a card use gloo, which moves data between host buffers: each
exchange then copies its tensors to the host and back (`via_host`, which
`describe()` states).  gloo's send and receive check neither dtype nor
size, so the first halo exchange of each set of shapes compares a header
with both neighbours and raises on a mismatch.

`stats` counts each kind of exchange, its calls and bytes; with `timed`
set it also brackets each call with device synchronisations and adds up
its host-clock seconds (an instrumented run: the synchronisations cost
time of their own).
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import time
from typing import List, Optional, Sequence, Union

import torch

from incflo_torch.grid import Grid

# x halo rows of a slab for the Godunov chain (pallas_godunov.HALO; kHalo
# in csrc/godunov.cu): the CTU chain's reach, and so the narrowest slab a
# mesh splits a level into
HALO = 4
_KINDS = ("halo", "all_reduce", "reduce_scatter", "all_gather", "gather")
_HEADER_TAG = 1 << 20


def mesh_of(grid) -> Optional["SlabMesh"]:
    """The mesh a grid is split over, or None for a whole level."""
    return getattr(grid, "mesh", None)


@dataclasses.dataclass(frozen=True)
class SlabGrid(Grid):
    """Rank `mesh.rank`'s x slab of a level: n_cell counts the slab's
    cells (nxl along x); prob_lo, prob_hi and dx are the whole level's.
    Fields on it hold the level's x rows [x0, x0 + nxl)."""

    mesh: Optional["SlabMesh"] = dataclasses.field(default=None,
                                                   compare=False,
                                                   repr=False)
    nx_full: int = 0

    @property
    def full(self) -> Grid:
        return Grid((self.nx_full,) + tuple(self.n_cell[1:]), self.prob_lo,
                    self.prob_hi, self.periodic, self.domain_lo,
                    self.domain_hi)

    @property
    def dx(self):
        return self.full.dx

    @property
    def x0(self) -> int:
        return self.mesh.rank * self.n_cell[0]

    def x_edge(self, side: int) -> bool:
        """True where the slab's x side `side` (0 low, 1 high) is the
        level's own x boundary: the first rank's low side and the last
        rank's high side of a level whose x is not periodic."""
        return self.mesh.ends(self.periodic[0])[side]

    def edge(self, axis: int, side: int) -> bool:
        return self.x_edge(side) if axis == 0 else super().edge(axis, side)


class SlabMesh:
    """This process's place in an x-slab mesh of the default
    torch.distributed process group, and the exchanges between its
    ranks.  `device` is where the rank's fields live: None means the
    card, cuda:{rank % device_count} (raises where there is none); pass
    "cpu" for the CPU."""

    def __init__(self, device=None):
        import torch.distributed as dist
        if not dist.is_initialized():
            raise RuntimeError("SlabMesh needs an initialised "
                               "torch.distributed process group "
                               "(incflo_torch.parallel.launch starts one "
                               "per rank)")
        self.rank = dist.get_rank()
        self.size = dist.get_world_size()
        self.backend = str(dist.get_backend())
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "SlabMesh: device None means the card, but torch.cuda "
                    "is not available; pass device='cpu' to run on the CPU")
            device = f"cuda:{self.rank % torch.cuda.device_count()}"
        self.device = torch.device(device)
        if self.backend == "nccl" and self.device.type != "cuda":
            raise ValueError("an NCCL mesh keeps its fields on a GPU")
        self.via_host = self.backend != "nccl" and self.device.type != "cpu"
        self.timed = False
        self.stats = {}
        self.reset_stats()
        self._checked = set()

    # ------------------------------------------------------------------
    @property
    def left(self) -> int:
        return (self.rank - 1) % self.size

    @property
    def right(self) -> int:
        return (self.rank + 1) % self.size

    def ends(self, periodic: bool):
        """(low, high): which x sides of this rank's slab are the level's
        own x boundary -- none where x is periodic, else the low side of
        the first rank and the high side of the last."""
        if periodic:
            return False, False
        return self.rank == 0, self.rank == self.size - 1

    def depths(self, lo: int, hi: int, periodic: bool):
        """The rows a halo of (lo, hi) takes from the neighbours: none
        across the level's own x boundary."""
        low, high = self.ends(periodic)
        return (0 if low else lo), (0 if high else hi)

    def rows(self, n: int):
        """(start, count) of this rank's x rows of a whole-level field of
        n rows: n = R nxl (cells; nodes of a periodic x) splits evenly, and
        n = R nxl + 1 (the nodes of an x that ends in boundaries) gives the
        last rank one row more."""
        nxl, extra = divmod(n, self.size)
        if extra > 1:
            raise ValueError(f"{n} rows do not split over {self.size} "
                             f"ranks")
        last = self.rank == self.size - 1
        return self.rank * nxl, nxl + (extra if last else 0)

    def describe(self) -> str:
        where = ("ranks share a card: exchanges go through host buffers"
                 if self.via_host else
                 "one GPU a rank" if self.backend == "nccl" else "CPU")
        return (f"{self.backend}, {self.size} ranks, rank {self.rank} on "
                f"{self.device} ({where})")

    def reset_stats(self) -> None:
        self.stats = {k: {"calls": 0, "bytes": 0, "s": 0.0} for k in _KINDS}

    def splits(self, grid: Grid) -> bool:
        """Whether `grid`'s level splits into R equal x slabs at least
        HALO cells wide.  A level that does not is held whole on every
        rank (the module docstring): its Simulation takes no mesh."""
        nx = grid.n_cell[0]
        return nx % self.size == 0 and nx // self.size >= HALO

    def local_grid(self, grid: Grid) -> SlabGrid:
        """This rank's slab of `grid`, a level that splits (splits)."""
        if grid.ndim not in (2, 3):
            raise ValueError(f"an x-slab mesh splits 2D and 3D levels, "
                             f"not {grid.ndim}D")
        if not self.splits(grid):
            raise ValueError(f"nx = {grid.n_cell[0]} does not split into "
                             f"{self.size} slabs of at least {HALO} cells")
        nx = grid.n_cell[0]
        nxl = nx // self.size
        return SlabGrid(n_cell=(nxl,) + tuple(grid.n_cell[1:]),
                        prob_lo=grid.prob_lo, prob_hi=grid.prob_hi,
                        periodic=grid.periodic, domain_lo=grid.domain_lo,
                        domain_hi=grid.domain_hi, mesh=self, nx_full=nx)

    # ------------------------------------------------------------------
    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def _tally(self, kind, nbytes):
        st = self.stats[kind]
        st["calls"] += 1
        st["bytes"] += int(nbytes)
        if self.timed:
            self._sync()
            t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.timed:
                self._sync()
                st["s"] += time.perf_counter() - t0

    def _wire(self, t):
        """t where the backend reads it: the host for gloo."""
        return t.cpu() if self.via_host else t

    # ------------------------------------------------------------------
    def halo_x(self, t: Union[torch.Tensor, Sequence[torch.Tensor]],
               lo: int, hi: Optional[int] = None, periodic: bool = True,
               ends=None):
        """x halo of a slab (x first): (n, ...) -> (lo + n + hi, ...)
        holding the left neighbour's last `lo` rows, t, and the right
        neighbour's first `hi` rows; a periodic x wraps rank 0 to rank
        R - 1.  periodic False: the level's x ends in boundaries, and no
        rows cross them (depths): `ends`, a pair of functions of a slab
        (or None) that give the rows beyond the level's low and high x
        side, fills them there, else they are left out.  A list of
        tensors goes in one batch of messages and comes back as a
        list."""
        hi = lo if hi is None else hi
        single = isinstance(t, torch.Tensor)
        ts = [x.contiguous() for x in ([t] if single else t)]
        for x in ts:
            if not (0 <= lo <= x.shape[0] and 0 <= hi <= x.shape[0]):
                raise ValueError(f"halo_x: a halo of ({lo}, {hi}) rows "
                                 f"does not fit a slab of {x.shape[0]}")
        dlo, dhi = self.depths(lo, hi, periodic)
        nbytes = sum((dlo + dhi) * x[:1].numel() * x.element_size()
                     for x in ts)
        with self._tally("halo", nbytes):
            if self.size == 1:
                out = [torch.cat([x.narrow(0, x.shape[0] - dlo, dlo), x,
                                  x.narrow(0, 0, dhi)], dim=0) for x in ts]
            else:
                out = self._exchange(ts, lo, hi, periodic)
        low, high = self.ends(periodic)
        if ends is not None and (low or high):
            out = [torch.cat(([ends[0](x)] if low and ends[0] else [])
                             + [e] + ([ends[1](x)] if high and ends[1]
                                      else []), dim=0)
                   for x, e in zip(ts, out)]
        return out[0] if single else out

    def _exchange(self, ts: List[torch.Tensor], lo: int, hi: int,
                  periodic: bool):
        """The neighbours' rows of a halo of (lo, hi): each rank sends its
        last lo rows to the right and its first hi rows to the left, and
        nothing crosses the level's own x boundary."""
        import torch.distributed as dist
        rlo, rhi = self.depths(lo, hi, periodic)
        low, high = self.ends(periodic)
        slo, shi = (0 if high else lo), (0 if low else hi)
        self._check_peers(ts, lo, hi, periodic)
        ops, recv = [], []
        for k, x in enumerate(ts):
            n = x.shape[0]
            wire = self._wire(x)
            from_left = wire.new_empty((rlo,) + tuple(x.shape[1:]))
            from_right = wire.new_empty((rhi,) + tuple(x.shape[1:]))
            if slo:
                ops.append(dist.P2POp(dist.isend, wire.narrow(0, n - slo, slo),
                                      self.right, tag=2 * k))
            if rlo:
                ops.append(dist.P2POp(dist.irecv, from_left, self.left,
                                      tag=2 * k))
            if shi:
                ops.append(dist.P2POp(dist.isend, wire.narrow(0, 0, shi),
                                      self.left, tag=2 * k + 1))
            if rhi:
                ops.append(dist.P2POp(dist.irecv, from_right, self.right,
                                      tag=2 * k + 1))
            recv.append((from_left, from_right))
        if ops:
            for w in dist.batch_isend_irecv(ops):
                w.wait()
        return [torch.cat([a.to(x.device), x, b.to(x.device)], dim=0)
                for x, (a, b) in zip(ts, recv)]

    def _check_peers(self, ts, lo, hi, periodic=True):
        """Compare what each neighbour is about to send with what this
        rank expects, once for each set of shapes and dtypes."""
        import torch.distributed as dist
        sig = repr((lo, hi, periodic, [(str(x.dtype), tuple(x.shape[1:]))
                                       for x in ts]))
        if sig in self._checked:
            return
        digest = hashlib.sha256(sig.encode()).digest()
        head = torch.tensor([int.from_bytes(digest[i:i + 7], "little")
                             for i in (0, 7, 14)], dtype=torch.int64)
        head = head.to(self.device if self.backend == "nccl" else "cpu")
        low, high = self.ends(periodic)
        got, ops = [], []
        if not high:
            got.append(torch.empty_like(head))
            ops += [dist.P2POp(dist.isend, head, self.right,
                               tag=_HEADER_TAG),
                    dist.P2POp(dist.irecv, got[-1], self.right,
                               tag=_HEADER_TAG + 1)]
        if not low:
            got.append(torch.empty_like(head))
            ops += [dist.P2POp(dist.irecv, got[-1], self.left,
                               tag=_HEADER_TAG),
                    dist.P2POp(dist.isend, head, self.left,
                               tag=_HEADER_TAG + 1)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        if not all(torch.equal(g, head) for g in got):
            raise RuntimeError(f"halo_x on rank {self.rank}: a neighbour "
                               f"exchanges other shapes or dtypes than "
                               f"{sig}")
        self._checked.add(sig)

    # ------------------------------------------------------------------
    def _all_reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        import torch.distributed as dist
        with self._tally("all_reduce", t.numel() * t.element_size()):
            if self.size == 1:
                return t
            x = t.detach().reshape(-1).to(
                "cpu" if self.via_host else t.device, copy=True)
            dist.all_reduce(x, op=op)
            return x.to(t.device).reshape(t.shape)

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist
        return self._all_reduce(t, dist.ReduceOp.SUM)

    def all_reduce_max(self, t: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist
        return self._all_reduce(t, dist.ReduceOp.MAX)

    def reduce_scatter_x(self, t: torch.Tensor) -> torch.Tensor:
        """t of R nxl rows, a partial sum on every rank -> the sum over
        ranks of rows [rank nxl, (rank + 1) nxl)."""
        import torch.distributed as dist
        n = t.shape[0]
        if n % self.size:
            raise ValueError(f"reduce_scatter_x: {n} rows do not split "
                             f"over {self.size} ranks")
        with self._tally("reduce_scatter", t.numel() * t.element_size()):
            if self.size == 1:
                return t
            x = self._wire(t.contiguous())
            out = x.new_empty((n // self.size,) + tuple(t.shape[1:]))
            dist.reduce_scatter_tensor(out, x, op=dist.ReduceOp.SUM)
            return out.to(t.device)

    # ------------------------------------------------------------------
    def slab(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's x rows of a whole-level cell or node field (rows)."""
        start, count = self.rows(full.shape[0])
        return full.narrow(0, start, count)

    def cut_x(self, full, lo: int = 0, hi: Optional[int] = None,
              layout: str = "cell", periodic: bool = True,
              beyond: str = "edge", axis: int = 0):
        """This rank's rows of a static whole-level array (a tensor every
        rank holds whole; no exchange) along `axis`, with lo and hi ghost
        rows taken from the whole array.  layout: "cell" (nx rows),
        "face" (nx + 1 x faces: the slab's nxl + 1), "node" (nx rows, or
        nx + 1 where x ends in boundaries: the last rank's nxl + 1) or
        "octant" (the 2 nx rows of the 2x lattice: 2 nxl).  Across a
        periodic x the ghost rows wrap; across the level's own x faces
        `beyond` says what they hold: "edge" the level's first or last
        row (eb/ops._pad_geom), "zero" zeros, "none" no rows at all
        (SlabMesh.depths)."""
        hi = lo if hi is None else hi
        n = full.shape[axis]
        nx = {"cell": n, "face": n - 1, "octant": n // 2,
              "node": n if periodic else n - 1}[layout]
        if nx % self.size:
            raise ValueError(f"cut_x: {n} {layout} rows do not split over "
                             f"{self.size} ranks")
        scale = 2 if layout == "octant" else 1
        nxl = nx // self.size * scale
        last = self.rank == self.size - 1
        count = nxl + (1 if layout == "face" or (
            layout == "node" and not periodic and last) else 0)
        if (lo or hi) and layout == "face":
            raise ValueError("cut_x: ghost rows of a face array")
        start = self.rank * nxl
        if beyond == "none" and not periodic:
            lo, hi = self.depths(lo, hi, False)
        idx = torch.arange(start - lo, start + count + hi,
                           device=full.device)
        if periodic:
            return full.index_select(axis, idx % n)
        out = full.index_select(axis, idx.clamp(0, n - 1))
        if beyond == "zero":
            keep = ((idx >= 0) & (idx < n)).to(full.dtype)
            shape = [1] * full.dim()
            shape[axis] = -1
            out = out * keep.reshape(shape)
        return out

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The whole level's field from every rank's slab (a collective:
        every rank calls it and gets the whole field): the tests',
        diagnostics' and checkpoints' form, tallied as "gather".  The
        slabs may differ in rows (the last rank's extra node row):
        their counts are exchanged first."""
        if self.size == 1:
            return self._all_gather(t, "gather")[0]
        import torch.distributed as dist
        where = self.device if self.backend == "nccl" else "cpu"
        n = torch.tensor([t.shape[0]], dtype=torch.int64, device=where)
        counts = [torch.empty_like(n) for _ in range(self.size)]
        dist.all_gather(counts, n)
        counts = [int(c) for c in counts]
        pad = max(counts) - t.shape[0]
        if pad:
            t = torch.cat([t, t.new_zeros((pad,) + tuple(t.shape[1:]))])
        parts = self._all_gather(t, "gather")
        return torch.cat([p.narrow(0, 0, c) for p, c in zip(parts, counts)],
                         dim=0)

    def all_gather_x(self, t: torch.Tensor, faces: bool = False,
                     extra_last: bool = False, ghosts: int = 0
                     ) -> torch.Tensor:
        """The whole level from every rank's slab, in rank order, on
        every rank (a collective), tallied as "all_gather".  faces: t
        holds the slab's nxl + 1 x faces (its own low faces and the right
        neighbour's first), and the result the level's nx + 1, the last
        from the last rank.  extra_last: the last rank holds one row more
        than the others (the nodes of an x that ends in boundaries); the
        others send a row of padding, which is dropped.  ghosts: t holds
        that many ghost rows on each x side, and the result the level's
        rows between the first rank's low ghosts and the last rank's high
        ones."""
        last = self.rank == self.size - 1
        if extra_last and not last and self.size > 1:
            t = torch.cat([t, t.new_zeros((1,) + tuple(t.shape[1:]))])
        parts = self._all_gather(t, "all_gather")
        if ghosts:
            n = parts[0].shape[0]
            parts = [p.narrow(0, 0 if k == 0 else ghosts,
                              n - ghosts * ((k > 0) + (k < len(parts) - 1)))
                     for k, p in enumerate(parts)]
        if faces or extra_last:
            parts = [p.narrow(0, 0, p.shape[0] - 1) for p in parts[:-1]] \
                + parts[-1:]
        return torch.cat(parts, dim=0)

    def _all_gather(self, t: torch.Tensor, kind: str) -> List[torch.Tensor]:
        import torch.distributed as dist
        with self._tally(kind, t.numel() * t.element_size()):
            if self.size == 1:
                return [t]
            x = self._wire(t.contiguous())
            parts = [torch.empty_like(x) for _ in range(self.size)]
            dist.all_gather(parts, x)
            return [p.to(t.device) for p in parts]

    def barrier(self) -> None:
        import torch.distributed as dist
        dist.barrier()
