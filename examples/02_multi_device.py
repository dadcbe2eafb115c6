"""Domain-decomposed multi-device solve over a jax.sharding.Mesh.

Two sharding strategies:
  (a) general graph partition + all_to_all halo exchange (any mesh);
  (b) contiguous slab + ppermute neighbor strips (banded/structured).

Run (8 virtual devices on CPU):
  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python examples/02_multi_device.py
"""

import os

os.environ.setdefault(
    "XLA_FLAGS",
    (os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"),
)

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

from domain_decomposed_pde_solver.io import box_mesh
from domain_decomposed_pde_solver.models import assemble_heat_system
from domain_decomposed_pde_solver.ops import coo_to_csr
from domain_decomposed_pde_solver.parallel import (
    ShardedOperator,
    build_halo_plan,
    build_slab_plan,
    make_device_mesh,
    partition_graph,
    sharded_cg_solve,
    slab_cg_solve,
)

P = min(8, len(jax.devices()))
mesh = box_mesh(16, 16, 16, elem_type="TETRA4")
system = assemble_heat_system(mesh)
print(f"{system.n_free} DOF over {P} devices")

# (a) General path: graph partition + halo plan + SPMD CG.
A = system.A
rows = np.repeat(np.arange(A.n_rows), A.row_lengths())
off = rows != A.indices
adj = coo_to_csr(rows[off], A.indices[off], np.ones(int(off.sum())), A.shape,
                 sum_dups=False)
parts = partition_graph(adj, P, coords=mesh.coords[system.free_to_node])
plan = build_halo_plan(A, parts, P)
op = ShardedOperator.from_plan(plan, make_device_mesh(P))
b = op.put_vector(system.b)
res = sharded_cg_solve(
    op, b, jnp.zeros_like(b), precond_diag=op.put_vector(1.0 / system.degree),
    cheb_lmax=2.0,  # exact bound for normalized graph Laplacians
    tol=1e-11, maxiter=2000,
)
x = op.get_vector(res.x)
print(f"(a) halo-exchange CG: {int(res.iterations)} iterations, "
      f"relres {float(res.relres):.2e}")

# (b) Slab path (structured/banded operators).
splan = build_slab_plan(A, P, dtype=np.float64)
if splan is not None:
    x2, res2 = slab_cg_solve(splan, system.b, np.zeros(A.n_rows),
                             tol=1e-11, maxiter=2000)
    print(f"(b) slab-DIA CG: {int(res2.iterations)} iterations, "
          f"halo width {splan.halo} per neighbor")
