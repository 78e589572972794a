"""networks_fenicsx_tpu — array-native hydraulic network finite elements.

A from-scratch JAX/XLA re-implementation of the capabilities of
``networks_fenicsx`` (an MPI/DOLFINx/PETSc finite-element solver for
Hagen–Poiseuille flow on 1D networks): graph → array-native interval mesh,
batched closed-form assembly of the dual-mixed saddle-point system (per-edge
fluxes, global pressure, bifurcation Lagrange multipliers), and on-device
solvers built around exact per-edge static condensation to an SPD
bifurcation-graph Schur complement — replacing UFL/FFCx codegen, PETSc
assembly and the MUMPS direct solve.

Public API mirrors the reference package facade
(reference ``src/networks_fenicsx/__init__.py:15-25``):
``NetworkMesh``, ``HydraulicNetworkAssembler``, ``Solver``,
``network_generation``, ``post_processing``.
"""

import jax as _jax

# Float64 is the numerical contract of this library (the reference computes
# in PETSc double precision); enable it before any arrays are created.
_jax.config.update("jax_enable_x64", True)

# Version from installed metadata when available (mirrors the reference,
# ``src/networks_fenicsx/__init__.py:5-13``); source-tree fallback otherwise.
try:
    from importlib.metadata import PackageNotFoundError, version as _version

    __version__ = _version("networks_fenicsx_tpu")
except PackageNotFoundError:
    __version__ = "0.1.0"
__author__ = "networks-fenicsx-tpu developers"
__license__ = "MIT"
__program_name__ = "networks_fenicsx_tpu"

from . import batch, network_generation, post_processing  # noqa: E402
from .batch import solve_sweep  # noqa: E402
from .assembly import HydraulicNetworkAssembler, PressureFunction, compute_integration_data  # noqa: E402
from .function import FunctionSpace, NetworkFunction  # noqa: E402
from .mesh import ArrayNetwork, NetworkMesh, color_graph  # noqa: E402
from .solver import Solver  # noqa: E402
from .utils.config import ShardingOptions, SolverOptions  # noqa: E402

__all__ = [
    "HydraulicNetworkAssembler",
    "NetworkMesh",
    "post_processing",
    "Solver",
    "network_generation",
    "PressureFunction",
    "compute_integration_data",
    "FunctionSpace",
    "NetworkFunction",
    "ArrayNetwork",
    "color_graph",
    "SolverOptions",
    "ShardingOptions",
    "batch",
    "solve_sweep",
]
