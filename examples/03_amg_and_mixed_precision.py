"""AMG preconditioning and mixed-precision refinement.

Shows the two levers that make large solves fast:
  - SA-AMG: h-independent iteration counts (~10 regardless of mesh size);
  - iterative refinement: f64-accurate answers from an f32 device solver.

Run:  python examples/03_amg_and_mixed_precision.py
"""

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

from domain_decomposed_pde_solver.io import box_mesh
from domain_decomposed_pde_solver.models import assemble_heat_system
from domain_decomposed_pde_solver.ops import choose_operator, pad_vector
from domain_decomposed_pde_solver.solvers import (
    cg_solve,
    iterative_refinement_solve,
    jacobi_preconditioner,
    smoothed_aggregation_setup,
)

system = assemble_heat_system(box_mesh(24, 24, 24, elem_type="TETRA4"))
A = choose_operator(system.A, dtype=jnp.float64)
b = pad_vector(system.b, A.n_pad)

# Jacobi vs AMG iteration counts.
r_j = cg_solve(A, b, jnp.zeros_like(b), precond=jacobi_preconditioner(A),
               tol=1e-10, maxiter=3000)
M = smoothed_aggregation_setup(system.A, dtype=jnp.float64)
r_a = cg_solve(A, b, jnp.zeros_like(b), precond=M, tol=1e-10, maxiter=300)
print(f"CG+Jacobi: {int(r_j.iterations)} iterations")
print(f"CG+AMG:    {int(r_a.iterations)} iterations "
      f"({len(M.levels) + 1} levels)")

# Mixed precision: the device works in f32, answers come out f64-accurate.
res = iterative_refinement_solve(system.A, system.b, tol=1e-10)
print(f"f32 device + refinement: relres {res.relres:.2e} "
      f"in {res.refinements} sweeps / {res.inner_iterations} inner iterations")
