"""Distributed global SA-AMG over general (unstructured) halo partitions.

The unstructured counterpart of test_slabamg: CG preconditioned by the
sharded GLOBAL greedy hierarchy must match the single-device iteration
count (block-Schwarz needed 35 vs 10 at P=4 in round 1 — this is the
P-independent construction, on the reference's actual workload class).
"""

import pathlib

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from domain_decomposed_pde_solver.io import read_exodus
from domain_decomposed_pde_solver.models import assemble_heat_system
from domain_decomposed_pde_solver.ops import choose_operator, coo_to_csr
from domain_decomposed_pde_solver.parallel import (
    ShardedOperator,
    build_halo_plan,
    make_device_mesh,
    partition_graph,
)
from domain_decomposed_pde_solver.parallel.haloamg import (
    build_halo_amg,
    halo_amg_cg_solve,
)
from domain_decomposed_pde_solver.solvers import cg_solve
from domain_decomposed_pde_solver.solvers.precond.amg import (
    smoothed_aggregation_setup,
)

@pytest.fixture(scope="module")
def brick(data_dir):
    mesh = read_exodus(data_dir / "brick.exo")
    sy = assemble_heat_system(mesh)
    A = sy.A
    rows = np.repeat(np.arange(A.n_rows), A.row_lengths())
    off = rows != A.indices
    adj = coo_to_csr(
        rows[off], A.indices[off], np.ones(int(off.sum())), A.shape,
        sum_dups=False,
    )
    return mesh, sy, adj


def _single_iters(sy):
    M = smoothed_aggregation_setup(sy.A, dtype=jnp.float32)
    A = choose_operator(sy.A, dtype=jnp.float32)
    b = A.put_vector((sy.b / np.abs(sy.b).max()).astype(np.float32))
    r = cg_solve(A, b, jnp.zeros_like(b), precond=M, tol=1e-6, maxiter=100)
    return int(r.iterations)


@pytest.mark.parametrize("nparts", [2, 4, 8])
def test_unstructured_iterations_match_single_device(brick, nparts):
    if len(jax.devices()) < nparts:
        pytest.skip("needs virtual devices")
    mesh, sy, adj = brick
    it1 = _single_iters(sy)
    parts = partition_graph(adj, nparts, coords=mesh.coords[sy.free_to_node])
    plan = build_halo_plan(sy.A, parts, nparts, dtype=np.float32)
    op = ShardedOperator.from_plan(plan, make_device_mesh(nparts))
    hamg = build_halo_amg(sy.A, plan)
    assert hamg is not None
    bb = (sy.b / np.abs(sy.b).max()).astype(np.float32)
    x, res = halo_amg_cg_solve(op, hamg, bb, np.zeros_like(bb),
                               tol=1e-6, maxiter=100)
    assert bool(res.converged)
    assert abs(int(res.iterations) - it1) <= 2, (int(res.iterations), it1)
    import scipy.sparse as sp

    S = sp.csr_matrix((sy.A.data, sy.A.indices, sy.A.indptr), shape=sy.A.shape)
    relres = np.linalg.norm(S @ x.astype(np.float64) - bb) / np.linalg.norm(bb)
    assert relres < 1e-5


