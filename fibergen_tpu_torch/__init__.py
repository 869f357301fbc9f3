"""fibergen_tpu_torch: the PyTorch/CUDA port of fibergen_tpu for one NVIDIA
H100.

The port runs the linear Lippmann-Schwinger CG on the staggered grid with
trivial boundary conditions, in the modes elasticity, heat, porous flow and
viscosity (the Delta dual scheme).  On a card every CG step runs
hand-written CUDA kernels (``csrc/``, built with ``nvcc`` at first use); on
the CPU the same functions run as plain PyTorch.
"""
from . import convert
from .core.grid import Grid
from .materials.laws import LinearIsotropic, ScalarLinearIsotropic
from .materials.mixing import Phase, VoigtMixed
from .solvers.ls import LSSolver, SolverOptions

__all__ = ["Grid", "Phase", "LinearIsotropic", "ScalarLinearIsotropic",
           "VoigtMixed", "SolverOptions", "LSSolver", "convert"]
