"""fibergen_tpu_torch: the PyTorch/CUDA port of fibergen_tpu for one NVIDIA
H100.

This slice ports the main path: linear-elastic Lippmann-Schwinger CG on the
staggered grid with trivial boundary conditions.  On a card every CG step
runs three hand-written CUDA kernels (``csrc/``, built with ``nvcc`` at
first use); on the CPU the same functions run as plain PyTorch.
"""
from . import convert
from .core.grid import Grid
from .materials.laws import LinearIsotropic
from .materials.mixing import Phase, VoigtMixed
from .solvers.ls import LSSolver, SolverOptions

__all__ = ["Grid", "Phase", "LinearIsotropic", "VoigtMixed", "SolverOptions",
           "LSSolver", "convert"]
