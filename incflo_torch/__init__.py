"""incflo_torch: the PyTorch/CUDA port of incflo_tpu.

The same incompressible Navier-Stokes engine (Godunov and MOL advection,
MAC and nodal projections, Crank-Nicolson and implicit tensor
diffusion), written with PyTorch tensors and hand-written CUDA kernels
for NVIDIA Hopper (csrc/godunov.cu, csrc/smoothers.cu, csrc/step2d.cu).
It imports neither JAX nor incflo_tpu.

Scope today: 2D and 3D, Godunov or MOL, every boundary type, constant or
variable density, tracers, Newtonian and non-Newtonian fluids, explicit,
Crank-Nicolson or implicit diffusion, and embedded boundaries (eb/: the
cut-cell geometry on the host, MOL-EB and the cut-cell solvers on the
device) -- all five decks of bench.py.  AMR: the patch tree of
amr_patch.py (slab or box patches, coarse-fine ghosts and solver
closures, average_down, the composite pressure sync, regrid with
hysteresis) and the dense fine level of amr.py.  A 2D
periodic constant-density MOL deck (tgv2d) steps on the card in one
launch of the fused step kernel.  I/O and the CLI: checkpoints and
plotfiles in incflo_tpu's on-disk format, restart from either package's
checkpoint, per-rank checkpoints on a mesh (utils/io.py), derived fields
(ops/derive.py), diagnostics (utils/diagnostics.py), and the driver
`python -m incflo_torch.main <inputs> [key=value ...]` (main.py), AMR
decks included; AMR with embedded boundaries too (each patch builds its
own cut-cell geometry, the cut cells are tagged for refinement).  Split
over an x-slab mesh (parallel/) every deck runs, 2D and 3D, one level or
either AMR driver, with or without embedded boundaries; a level that
does not split into equal slabs at least 4 cells wide is held whole on
every rank, and a solve whose direct form is rfftn runs V-cycles on the
slabs.

Float32 matrix products run in full precision: importing the package
sets `torch.backends.cuda.matmul.allow_tf32 = False` and
`torch.set_float32_matmul_precision("highest")` (the direct solves of
ops/spectral.py lose their accuracy under TF32).
"""

__version__ = "0.1.0"

from incflo_torch.ops.spectral import set_matmul_precision

set_matmul_precision()

from incflo_torch.parmparse import ParmParse  # noqa: E402
from incflo_torch.grid import Grid  # noqa: E402
from incflo_torch.config import IncfloConfig  # noqa: E402
from incflo_torch.simulation import Simulation  # noqa: E402

__all__ = ["ParmParse", "Grid", "IncfloConfig", "Simulation"]
