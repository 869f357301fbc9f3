"""fibergen_tpu_torch: the PyTorch/CUDA port of fibergen_tpu for one NVIDIA
H100.

The port runs the linear Lippmann-Schwinger solvers (CG, basic,
polarization) on the staggered and the collocated grid, in the modes
elasticity, heat, porous flow and viscosity (the Delta dual scheme), and
finite-strain hyperelasticity by Newton-Krylov.  The linear materials are
isotropic, general (6x6), transversely isotropic and anisotropic (3x3 for
heat and porous flow) phases under the Voigt, Reuss, Maximum, Random,
50-50, Split and Iso mixing rules and the interface rules (laminate,
infinity-laminate, fluidity) (``materials``), on the voxel grid or on the
doubly-fine grid of the half/full staggered schemes (``materials.dfg``).  Load cases: mixed
boundary conditions (a strain-control projector and a prescribed mean
stress), loadsteps with solution extrapolation, and the batched
multi-right-hand-side CG (``LSSolver.run_batched``) of the effective
properties.  On a card every step runs hand-written CUDA kernels
(``csrc/``, built with ``nvcc`` at first use); on the CPU the same
functions run as plain PyTorch.  ``parallel`` splits a solve into x-slabs
over a mesh of devices driven by this one process
(``LSSolver(..., sharding=parallel.field_sharding(mesh))``): every linear
path and method of the unsharded solver and Newton-Krylov, the multigrid
G0 (``g0_solver="multigrid"``) with its levels split over the slabs; a
mesh whose nx or ny does not divide it raises, or under
``sharding_fallback="warn"`` warns and solves whole on the mesh's first
device.  ``parallel.SlabFFT`` and ``parallel.scalar_sharding`` are the JAX
package's slab transforms and replicated sharding.

``FG`` is the XML front end (``api.py``): it reads a project, evaluates its
Python expressions, generates or places the fibres and mesh primitives on
the host, voxelizes them into phase fields on the solver's device
(``geometry/``), builds the solver and runs the project's actions (load
cases, effective properties, the raw, VTK, PNG and text readers and
writers of ``io/``, fibre detection, checkpoints); ``python -m
fibergen_tpu_torch.cli project.xml`` runs a project, and ``experiment``
sweeps a project's settings over value grids.  ``gui`` is the project
IDE and slice viewer on ``FG`` (PyQt5, or a headless stub without it):
``python -m fibergen_tpu_torch.gui.app [--device cpu|cuda] project.xml``
runs a project and views its fields (``gui.app.run_project_and_view(path,
show=False)`` draws nothing and imports no matplotlib).

A float32 CG below tol 3e-7 ends with mixed-precision refinement
(``solvers/refine.py``); ``low_mem`` solves grids the plain CG's fields
would not fit (``solvers/lowmem.py``); ``g0_solver="multigrid"`` applies
the staggered G0 by multigrid Poisson solves (``solvers/multigrid.py``).
"""
from . import api, convert, experiment, parallel
from .api import FG, isotropic_laminate_stiffness
from .core.grid import Grid
from .materials.laws import (GOLDBERG_LAWS, LinearGeneral, LinearIsotropic,
                             LinearTransverselyIsotropic,
                             MatrixLinearAnisotropic, NeoHooke, NeoHooke2,
                             SaintVenantKirchhoff, ScalarLinearIsotropic,
                             make_law)
from .materials.dfg import DfgMaterial
from .materials.laminate import (FluidityMixed, InfinityLaminateMixed,
                                 LaminateMixed)
from .materials.mixing import (MIXING_RULES, FiftyFiftyMixed, IsoMixed,
                               MaximumMixed, MixedMaterial, Phase,
                               RandomMixed, ReussMixed, SplitMixed,
                               VoigtMixed, make_mixed)
from .solvers.ls import LSSolver, SolverOptions

__all__ = ["Grid", "Phase", "LinearIsotropic", "ScalarLinearIsotropic",
           "LinearGeneral", "MatrixLinearAnisotropic",
           "LinearTransverselyIsotropic", "make_law", "SaintVenantKirchhoff",
           "NeoHooke", "NeoHooke2", "GOLDBERG_LAWS", "MixedMaterial",
           "VoigtMixed", "ReussMixed", "MaximumMixed", "RandomMixed",
           "FiftyFiftyMixed", "SplitMixed", "IsoMixed", "MIXING_RULES",
           "LaminateMixed", "InfinityLaminateMixed", "FluidityMixed",
           "DfgMaterial", "make_mixed", "SolverOptions", "LSSolver", "api",
           "convert", "experiment", "parallel", "FG",
           "isotropic_laminate_stiffness"]
