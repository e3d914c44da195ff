"""incflo_torch: the PyTorch/CUDA port of incflo_tpu.

The same incompressible Navier-Stokes engine (Godunov and MOL advection,
MAC and nodal projections, Crank-Nicolson and implicit tensor
diffusion), written with PyTorch tensors and hand-written CUDA kernels
for NVIDIA Hopper (csrc/godunov.cu, csrc/smoothers.cu, csrc/step2d.cu).
It imports neither JAX nor incflo_tpu.

Scope today: one level, Newtonian.  3D Godunov decks whose axes are
periodic or end in slip or no-slip walls -- shear3d with constant density
(direct solves) or with variable density and tracers (multigrid
V-cycles), and the walled Rayleigh-Taylor deck rt (gravity, variable
density, a tracer; multigrid on levels with walls).  2D fully periodic
constant-density MOL decks -- tgv2d, whose step on the card is one launch
of the fused step kernel.  Other decks raise NotImplementedError naming
the ROADMAP item that ports them.

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
