"""Domain-decomposed PDE solver framework in JAX.

A JAX/XLA framework with the capabilities of the
Trilinos/MPI reference ``LouisJenkinsCS/Domain-Decomposed-PDE-Solver``:

- Exodus-II mesh ingest/egress (pure Python over netCDF3; no SEACAS needed)
  replacing the ExodusII C API usage in ``ExodusIO.hpp:88-114``.
- Nodeset-based Dirichlet elimination + graph-Laplacian assembly with the
  exact reference semantics (``ExodusIO.hpp:116-723``).
- Mesh partitioning via coordinate RCB + greedy graph refinement, replacing
  ParMETIS/METIS/Zoltan2 (``ExodusIO.hpp:644-656, :919, :1615``).
- Sharded halo-exchange SpMV over a ``jax.sharding.Mesh`` replacing Tpetra
  Import/Export and MPI one-sided windows (``ExodusIO.hpp:429-576``).
- CG/GMRES Krylov solvers with Jacobi/Chebyshev/smoothed-aggregation-AMG
  preconditioning replacing Belos + Ifpack2 ILUT + (intended) MueLu
  (``BelosMueLuSolver.cpp:87-139``).

Subpackages
-----------
- ``io``: Exodus-II reader/writer and the in-memory mesh model.
- ``models``: PDE problem definitions (steady-state heat, full-mesh Laplacian).
- ``ops``: sparse formats (CSR host / ELL device) and SpMV kernels (jnp).
- ``solvers``: Krylov methods, eigen utilities, and preconditioners.
- ``parallel``: partitioners, halo plans, and multi-device sharded operators.
- ``utils``: config/flags, deterministic logging, timers.
- ``cli``: command-line drivers mirroring the reference executables.
"""

__version__ = "0.1.0"

# Host allocator tuning: on the fault-bound VMs this framework targets,
# glibc's default mmap threshold makes every large NumPy temporary re-pay
# first-touch page faults (~250x slower than heap reuse).  Enabled at
# import; opt out with DDPS_NO_MALLOC_TUNING=1.  See utils/hostmem.py for
# the measurements.
from .utils.hostmem import enable_malloc_reuse as _emr  # noqa: E402

_emr()
del _emr

from . import io, models, ops, parallel, solvers, utils  # noqa: F401,E402
from .api import SteadyHeatSolver  # noqa: F401,E402
