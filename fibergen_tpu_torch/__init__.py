"""fibergen_tpu_torch: the PyTorch/CUDA port of fibergen_tpu for one NVIDIA
H100.

The port runs the linear Lippmann-Schwinger solvers (CG, basic,
polarization) on the staggered and the collocated grid with trivial
boundary conditions, in the modes elasticity, heat, porous flow and
viscosity (the Delta dual scheme), and finite-strain hyperelasticity by
Newton-Krylov.  On a card every step runs hand-written CUDA kernels
(``csrc/``, built with ``nvcc`` at first use); on the CPU the same
functions run as plain PyTorch.  ``parallel`` splits a linear solve into
x-slabs over a mesh of devices driven by this one process
(``LSSolver(..., sharding=parallel.field_sharding(mesh))``).
"""
from . import convert, parallel
from .core.grid import Grid
from .materials.laws import (GOLDBERG_LAWS, LinearIsotropic, NeoHooke,
                             NeoHooke2, SaintVenantKirchhoff,
                             ScalarLinearIsotropic)
from .materials.mixing import Phase, VoigtMixed
from .solvers.ls import LSSolver, SolverOptions

__all__ = ["Grid", "Phase", "LinearIsotropic", "ScalarLinearIsotropic",
           "SaintVenantKirchhoff", "NeoHooke", "NeoHooke2", "GOLDBERG_LAWS",
           "VoigtMixed", "SolverOptions", "LSSolver", "convert", "parallel"]
