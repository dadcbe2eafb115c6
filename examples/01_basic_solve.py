"""Basic end-to-end solve: mesh -> assembly -> CG -> Exodus output.

The library-level equivalent of
``mpirun exec/BelosMueLuSolver --input mesh.exo --solution out.exo``.

Run:  python examples/01_basic_solve.py [mesh.exo]
"""

import sys

import jax

jax.config.update("jax_platforms", "cpu")  # or leave default for the GPU
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

from domain_decomposed_pde_solver.io import (
    ExodusSolutionWriter,
    box_mesh,
    read_exodus,
)
from domain_decomposed_pde_solver.models import assemble_heat_system
from domain_decomposed_pde_solver.ops import choose_operator, pad_vector, unpad_vector
from domain_decomposed_pde_solver.solvers import cg_solve, jacobi_preconditioner

# 1. Mesh: a bundled Exodus file, or a generated box.
mesh = (
    read_exodus(sys.argv[1])
    if len(sys.argv) > 1
    else box_mesh(20, 20, 20, elem_type="TETRA4")
)
print(f"mesh: {mesh.num_nodes} nodes, {mesh.num_elem} elements")

# 2. Assemble the reduced Laplacian (nodeset-based Dirichlet elimination).
system = assemble_heat_system(mesh)
print(f"system: {system.n_free} DOF, nnz={system.A.nnz}")

# 3. Device operator: DIA for structured meshes, ELL otherwise.
A = choose_operator(system.A, dtype=jnp.float64)
print(f"format: {type(A).__name__}")

# 4. Solve with preconditioned CG.
b = pad_vector(system.b, A.n_pad)
res = cg_solve(
    A, b, jnp.zeros_like(b), precond=jacobi_preconditioner(A),
    tol=1e-12, maxiter=1000,
)
x = unpad_vector(res.x, system.n_free)
print(f"converged={bool(res.converged)} in {int(res.iterations)} iterations")

# 5. Write the solution (timestep 0 = boundary snapshot, like the reference).
with ExodusSolutionWriter("/tmp/example_solution.exo", mesh) as w:
    w.write_solution(x, system.free_to_node, int(res.iterations))
print("wrote /tmp/example_solution.exo")
