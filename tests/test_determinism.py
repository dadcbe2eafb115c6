"""Bit-reproducibility tests.

The reference enforces determinism structurally (barriers + timestamp
merges) so multi-rank dumps can be diffed (SURVEY §4).  This framework
makes the stronger guarantee testable: identical inputs produce bit-identical
outputs — assembly, partitioning, and whole solves, single- and multi-device.
"""

import jax.numpy as jnp
import numpy as np

from domain_decomposed_pde_solver.io import box_mesh, read_exodus
from domain_decomposed_pde_solver.models import assemble_heat_system
from domain_decomposed_pde_solver.ops import coo_to_csr, ell_from_csr, pad_vector
from domain_decomposed_pde_solver.parallel import (
    ShardedOperator,
    build_halo_plan,
    make_device_mesh,
    partition_graph,
    sharded_cg_solve,
)
from domain_decomposed_pde_solver.solvers import cg_solve, jacobi_preconditioner


def test_assembly_bitwise_deterministic(data_dir):
    mesh = read_exodus(str(data_dir / "brick.exo"))
    a = assemble_heat_system(mesh)
    b = assemble_heat_system(mesh)
    np.testing.assert_array_equal(a.A.indptr, b.A.indptr)
    np.testing.assert_array_equal(a.A.indices, b.A.indices)
    np.testing.assert_array_equal(a.A.data, b.A.data)
    np.testing.assert_array_equal(a.b, b.b)


def test_partition_bitwise_deterministic(data_dir):
    mesh = read_exodus(str(data_dir / "brick.exo"))
    sys_ = assemble_heat_system(mesh)
    A = sys_.A
    rows = np.repeat(np.arange(A.n_rows), A.row_lengths())
    off = rows != A.indices
    adj = coo_to_csr(rows[off], A.indices[off], np.ones(int(off.sum())), A.shape,
                     sum_dups=False)
    coords = mesh.coords[sys_.free_to_node]
    p1 = partition_graph(adj, 4, coords=coords)
    p2 = partition_graph(adj, 4, coords=coords)
    np.testing.assert_array_equal(p1, p2)


def test_cg_solve_bitwise_deterministic(data_dir):
    sys_ = assemble_heat_system(read_exodus(str(data_dir / "brick.exo")))
    A = ell_from_csr(sys_.A, dtype=jnp.float64)
    b = pad_vector(sys_.b, A.n_pad)
    M = jacobi_preconditioner(A)
    r1 = cg_solve(A, b, jnp.zeros_like(b), precond=M, tol=1e-11, maxiter=2000)
    r2 = cg_solve(A, b, jnp.zeros_like(b), precond=M, tol=1e-11, maxiter=2000)
    np.testing.assert_array_equal(np.asarray(r1.x), np.asarray(r2.x))
    assert int(r1.iterations) == int(r2.iterations)


def test_sharded_solve_bitwise_deterministic():
    sys_ = assemble_heat_system(box_mesh(10, 10, 10, elem_type="TETRA4"))
    A = sys_.A
    rows = np.repeat(np.arange(A.n_rows), A.row_lengths())
    off = rows != A.indices
    adj = coo_to_csr(rows[off], A.indices[off], np.ones(int(off.sum())), A.shape,
                     sum_dups=False)
    parts = partition_graph(adj, 4, coords=None)
    plan = build_halo_plan(A, parts, 4)
    op = ShardedOperator.from_plan(plan, make_device_mesh(4))
    b = op.put_vector(sys_.b)
    inv_d = op.put_vector(1.0 / sys_.degree)
    outs = [
        np.asarray(
            sharded_cg_solve(
                op, b, jnp.zeros_like(b), precond_diag=inv_d, tol=1e-10,
                maxiter=1000,
            ).x
        )
        for _ in range(2)
    ]
    np.testing.assert_array_equal(outs[0], outs[1])
