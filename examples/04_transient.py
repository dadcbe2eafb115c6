"""Transient heat flow with per-step Exodus animation output.

The physical version of the reference's convergence animation: implicit
Euler time stepping with one Exodus timestep per physical step.

Run:  python examples/04_transient.py
"""

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

from domain_decomposed_pde_solver.io import ExodusSolutionWriter, box_mesh
from domain_decomposed_pde_solver.models import (
    assemble_heat_system,
    transient_heat_solve,
)
from domain_decomposed_pde_solver.ops import choose_operator
from domain_decomposed_pde_solver.solvers import lanczos_extremes

mesh = box_mesh(12, 12, 12, elem_type="TETRA4")
system = assemble_heat_system(mesh)
A = choose_operator(system.A, dtype=jnp.float64)

# Spectrum edges -> decay time scale of the flow.
z0 = np.zeros(A.n_pad)
z0[: system.n_free] = np.random.default_rng(0).standard_normal(system.n_free)
spec = lanczos_extremes(A, jnp.asarray(z0), k=40)
print(f"spectrum: [{float(spec.lmin):.3f}, {float(spec.lmax):.3f}] "
      f"(condition {float(spec.condition):.0f}); slowest decay "
      f"~{1.0 / float(spec.lmin):.1f} time units")

with ExodusSolutionWriter("/tmp/transient.exo", mesh) as writer:
    writer.write_boundary_timestep()
    res = transient_heat_solve(
        system, A, dt=0.2, n_steps=40, tol=1e-10,
        # Physical time as the Exodus time value (writer floats it).
        callback=lambda k, t, u: writer.write_solution(
            u, system.free_to_node, t
        ),
    )
print(f"integrated 40 steps with {res.total_cg_iterations} total CG "
      f"iterations (warm starts); wrote /tmp/transient.exo")
