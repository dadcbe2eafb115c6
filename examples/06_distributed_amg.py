"""Sharded GLOBAL SA-AMG: P-independent iteration counts over a device mesh.

Block-Schwarz preconditioners (example 02's strategies) trade iteration
count for zero communication; the sharded *global* hierarchy
(`parallel/slabamg.py`) keeps the single-device count exactly: the fine
level is slab-sharded (ppermute halos), the brick grid transfers stay
node-local, and the tiny coarse levels are replicated on every device.

Run (8 virtual devices on CPU):
  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python examples/06_distributed_amg.py
"""

import os

os.environ.setdefault(
    "XLA_FLAGS",
    (os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"),
)

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

from domain_decomposed_pde_solver.io import box_mesh
from domain_decomposed_pde_solver.models import assemble_heat_system
from domain_decomposed_pde_solver.ops import choose_operator
from domain_decomposed_pde_solver.parallel import build_slab_amg, slab_amg_cg_solve
from domain_decomposed_pde_solver.solvers import cg_solve
from domain_decomposed_pde_solver.solvers.precond.amg import (
    infer_free_grid,
    smoothed_aggregation_setup,
)


def main():
    mesh = box_mesh(30, 30, 48, elem_type="TETRA4")
    system = assemble_heat_system(mesh)
    dims = infer_free_grid(mesh, system.free_to_node)
    print(f"{system.n_free} free DOF, free grid {dims}")

    b = (system.b / np.abs(system.b).max()).astype(np.float32)

    # Single-device reference hierarchy.
    M1 = smoothed_aggregation_setup(system.A, dtype=jnp.float32, grid_dims=dims)
    A1 = choose_operator(system.A, dtype=jnp.float32, grid_dims=dims)
    bj = A1.put_vector(b)
    r1 = cg_solve(A1, bj, jnp.zeros_like(bj), precond=M1, tol=1e-6, maxiter=100)
    print(f"single device : {int(r1.iterations)} iterations")

    # The SAME hierarchy, sharded over P devices.
    for P in (2, 4, 8):
        if len(jax.devices()) < P:
            continue
        samg = build_slab_amg(system.A, dims, P)
        if samg is None:
            print(f"P={P}: slab layout unavailable for these dims")
            continue
        x, res = slab_amg_cg_solve(samg, b, np.zeros_like(b), tol=1e-6, maxiter=100)
        print(f"P={P} sharded  : {int(res.iterations)} iterations "
              f"(relres {float(res.relres):.1e})")


if __name__ == "__main__":
    main()
