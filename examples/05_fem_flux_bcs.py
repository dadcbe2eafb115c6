"""P1 FEM Poisson with Neumann and Robin boundary conditions.

The reference solves only the graph-Laplacian heat problem with Dirichlet
nodesets; this example shows the real-PDE direction it left open
(``ExodusIO.hpp:725-732``): a true P1 stiffness matrix with sideset-driven
flux (Neumann) and impedance (Robin) boundaries, solved with the
framework's CG+AMG stack and checked against the exact linear solution.

Run:  python examples/05_fem_flux_bcs.py
"""

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

from domain_decomposed_pde_solver.io import box_mesh
from domain_decomposed_pde_solver.io.mesh import NodeSet, SideSet
from domain_decomposed_pde_solver.io.sides import side_local_nodes
from domain_decomposed_pde_solver.models import assemble_poisson_fem
from domain_decomposed_pde_solver.ops import (
    choose_operator,
    pad_vector,
    unpad_vector,
)
from domain_decomposed_pde_solver.solvers import (
    cg_solve,
    smoothed_aggregation_setup,
)


def plane_sideset(mesh, ss_id, xval):
    """All tet faces on the plane x == xval, as an Exodus-style sideset."""
    elems, sides = [], []
    off = 0
    for blk in mesh.blocks:
        on = np.isclose(mesh.coords[:, 0], xval)
        for s in range(1, 5):
            idx = list(side_local_nodes("TETRA4", s))
            hit = on[blk.conn[:, idx]].all(axis=1)
            e = np.nonzero(hit)[0]
            elems.append(e + off)
            sides.append(np.full(e.size, s))
        off += blk.conn.shape[0]
    return SideSet(
        id=ss_id, elems=np.concatenate(elems), sides=np.concatenate(sides),
        name="", dist_factors=None,
    )


mesh = box_mesh(12, 10, 10, elem_type="TETRA4")
# Dirichlet u = 5 on the x=0 face; flux du/dn = g on the x=1 face.
x0 = np.nonzero(np.isclose(mesh.coords[:, 0], 0.0))[0]
mesh.node_sets = [NodeSet(id=5, nodes=x0.astype(np.int64), name="",
                          dist_factors=None)]
mesh.side_sets = [plane_sideset(mesh, 77, 1.0)]

g = 3.25
system = assemble_poisson_fem(mesh, neumann={77: g})
A = choose_operator(system.A, dtype=jnp.float64)
M = smoothed_aggregation_setup(system.A, dtype=jnp.float64)
b = pad_vector(system.b, A.n_pad)
res = cg_solve(A, b, jnp.zeros_like(b), precond=M, tol=1e-13, maxiter=400)
u = unpad_vector(res.x, system.n_free)

exact = 5.0 + g * mesh.coords[system.free_to_node, 0]
print(f"Neumann: CG+AMG {int(res.iterations)} iterations, "
      f"max |u - (5 + {g} x)| = {np.abs(u - exact).max():.2e}")

# Robin: du/dn = -alpha (u - u_env) at x=1 -> u = 5 + c x with
# c = alpha (u_env - 5) / (1 + alpha).
alpha, u_env = 2.0, 11.0
system_r = assemble_poisson_fem(mesh, robin={77: (alpha, u_env)})
A_r = choose_operator(system_r.A, dtype=jnp.float64)
M_r = smoothed_aggregation_setup(system_r.A, dtype=jnp.float64)
b_r = pad_vector(system_r.b, A_r.n_pad)
res_r = cg_solve(A_r, b_r, jnp.zeros_like(b_r), precond=M_r, tol=1e-13,
                 maxiter=400)
u_r = unpad_vector(res_r.x, system_r.n_free)
c = alpha * (u_env - 5.0) / (1.0 + alpha)
exact_r = 5.0 + c * mesh.coords[system_r.free_to_node, 0]
print(f"Robin:   CG+AMG {int(res_r.iterations)} iterations, "
      f"max |u - (5 + {c:.3f} x)| = {np.abs(u_r - exact_r).max():.2e}")
