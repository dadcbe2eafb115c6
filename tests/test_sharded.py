"""Multi-device halo-exchange SpMV and distributed solver tests.

These run on 8 virtual CPU devices (conftest) — the framework's replacement
for the reference's ``mpirun -n K`` testing (SURVEY §4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from domain_decomposed_pde_solver.io import read_exodus
from domain_decomposed_pde_solver.models import (
    assemble_full_laplacian,
    assemble_heat_system,
)
from domain_decomposed_pde_solver.ops import coo_to_csr
from domain_decomposed_pde_solver.parallel import (
    ShardedOperator,
    build_halo_plan,
    make_device_mesh,
    partition_graph,
    sharded_cg_solve,
    sharded_gmres_solve,
    sharded_power_method,
)
from jax.sharding import PartitionSpec as P


def make_system(data_dir, name="brick.exo"):
    mesh = read_exodus(str(data_dir / name))
    sys_ = assemble_heat_system(mesh)
    A = sys_.A
    rows = np.repeat(np.arange(A.n_rows), A.row_lengths())
    off = rows != A.indices
    adj = coo_to_csr(
        rows[off], A.indices[off], np.ones(int(off.sum())), A.shape, sum_dups=False
    )
    coords = mesh.coords[sys_.free_to_node]
    return mesh, sys_, adj, coords


@pytest.mark.parametrize("nparts", [2, 4, 8])
def test_halo_plan_spmv_matches_host(data_dir, nparts):
    """Sharded SpMV must equal host CSR matvec exactly (no tolerance games)."""
    _, sys_, adj, coords = make_system(data_dir)
    parts = partition_graph(adj, nparts, coords=coords)
    plan = build_halo_plan(sys_.A, parts, nparts)
    mesh_dev = make_device_mesh(nparts)
    op = ShardedOperator.from_plan(plan, mesh_dev)

    x = np.random.default_rng(1).standard_normal(sys_.A.n_rows)
    xs = op.put_vector(x)

    from domain_decomposed_pde_solver.parallel.sharded import AXIS, _local_spmv

    def body(cols, vals, send_idx, x_blk):
        return _local_spmv(cols[0], vals[0], send_idx[0], x_blk[0])[None]

    y = jax.shard_map(
        body,
        mesh=mesh_dev,
        in_specs=(P(AXIS),) * 4,
        out_specs=P(AXIS),
        check_vma=False,
    )(op.cols, op.vals, op.send_idx, xs)
    np.testing.assert_allclose(
        op.get_vector(y), sys_.A.matvec(x), rtol=1e-13, atol=1e-10
    )


@pytest.mark.parametrize("nparts", [2, 8])
def test_sharded_cg_matches_dense(data_dir, nparts):
    _, sys_, adj, coords = make_system(data_dir)
    parts = partition_graph(adj, nparts, coords=coords)
    plan = build_halo_plan(sys_.A, parts, nparts)
    op = ShardedOperator.from_plan(plan, make_device_mesh(nparts))
    b = op.put_vector(sys_.b)
    inv_d = op.put_vector(1.0 / sys_.degree)
    res = sharded_cg_solve(
        op, b, jnp.zeros_like(b), precond_diag=inv_d, tol=1e-12, maxiter=2000
    )
    assert bool(res.converged)
    x = op.get_vector(res.x)
    xd = np.linalg.solve(sys_.A.to_dense(), sys_.b)
    assert np.abs(x - xd).max() / np.abs(xd).max() < 1e-8


def test_sharded_iteration_counts_device_invariant(data_dir):
    """CG must converge in the same #iterations on 2 vs 8 devices — the
    deterministic-across-rank-counts property the reference could only
    eyeball via ordered printf diffs (``mpi_output_combiner.py:1-10``)."""
    _, sys_, adj, coords = make_system(data_dir)
    iters = []
    for nparts in (2, 8):
        parts = partition_graph(adj, nparts, coords=coords)
        plan = build_halo_plan(sys_.A, parts, nparts)
        op = ShardedOperator.from_plan(plan, make_device_mesh(nparts))
        b = op.put_vector(sys_.b)
        res = sharded_cg_solve(
            op, b, jnp.zeros_like(b),
            precond_diag=op.put_vector(1.0 / sys_.degree),
            tol=1e-10, maxiter=2000,
        )
        iters.append(int(res.iterations))
    assert iters[0] == iters[1]


def test_sharded_gmres(data_dir):
    _, sys_, adj, coords = make_system(data_dir)
    nparts = 4
    parts = partition_graph(adj, nparts, coords=coords)
    plan = build_halo_plan(sys_.A, parts, nparts)
    op = ShardedOperator.from_plan(plan, make_device_mesh(nparts))
    b = op.put_vector(sys_.b)
    res = sharded_gmres_solve(
        op, b, jnp.zeros_like(b), precond_diag=op.put_vector(1.0 / sys_.degree),
        restart=40, tol=1e-10, maxiter=3000,
    )
    assert bool(res.converged)
    x = op.get_vector(res.x)
    xd = np.linalg.solve(sys_.A.to_dense(), sys_.b)
    assert np.abs(x - xd).max() / np.abs(xd).max() < 1e-6


def test_sharded_power_method_full_laplacian(data_dir):
    """Distributed power method on the full-mesh Laplacian: parity with
    ``ExodusMatrixTest`` under mpirun (>= 2 ranks)."""
    mesh = read_exodus(str(data_dir / "2blocks.exo"))
    L = assemble_full_laplacian(mesh)
    rows = np.repeat(np.arange(L.n_rows), L.row_lengths())
    off = rows != L.indices
    adj = coo_to_csr(
        rows[off], L.indices[off], np.ones(int(off.sum())), L.shape, sum_dups=False
    )
    nparts = 2
    parts = partition_graph(adj, nparts, coords=mesh.coords)
    plan = build_halo_plan(L, parts, nparts)
    op = ShardedOperator.from_plan(plan, make_device_mesh(nparts))
    z0 = op.put_vector(np.random.default_rng(0).uniform(size=L.n_rows))
    res = sharded_power_method(op, z0, maxiter=2000, tol=1e-6, check_every=10)
    lam_true = np.linalg.eigvalsh(L.to_dense()).max()
    assert abs(float(res.eigenvalue) - lam_true) <= max(float(res.residual), 1e-6)


def test_sharded_chebyshev_preconditioner(data_dir):
    """Distributed Chebyshev: each polynomial term is a halo-exchange SpMV."""
    _, sys_, adj, coords = make_system(data_dir)
    nparts = 4
    parts = partition_graph(adj, nparts, coords=coords)
    plan = build_halo_plan(sys_.A, parts, nparts)
    op = ShardedOperator.from_plan(plan, make_device_mesh(nparts))
    b = op.put_vector(sys_.b)
    inv_d = op.put_vector(1.0 / sys_.degree)
    rj = sharded_cg_solve(op, b, jnp.zeros_like(b), precond_diag=inv_d,
                          tol=1e-10, maxiter=2000)
    rc = sharded_cg_solve(op, b, jnp.zeros_like(b), precond_diag=inv_d,
                          cheb_lmax=1.9, cheb_degree=4, tol=1e-10, maxiter=2000)
    assert bool(rc.converged)
    assert int(rc.iterations) < int(rj.iterations)
    x = op.get_vector(rc.x)
    xd = np.linalg.solve(sys_.A.to_dense(), sys_.b)
    assert np.abs(x - xd).max() / np.abs(xd).max() < 1e-7


def test_block_schwarz_amg(data_dir):
    """Communication-free per-device AMG V-cycles: fewer iterations than
    Jacobi (between Jacobi and global AMG, the classical Schwarz trade)."""
    from domain_decomposed_pde_solver.parallel.schwarz import build_block_amg

    _, sys_, adj, coords = make_system(data_dir)
    nparts = 4
    parts = partition_graph(adj, nparts, coords=coords)
    plan = build_halo_plan(sys_.A, parts, nparts)
    op = ShardedOperator.from_plan(plan, make_device_mesh(nparts))
    b = op.put_vector(sys_.b)
    inv_d = op.put_vector(1.0 / sys_.degree)
    rj = sharded_cg_solve(op, b, jnp.zeros_like(b), precond_diag=inv_d,
                          tol=1e-10, maxiter=3000)
    M = build_block_amg(sys_.A, plan, dtype=jnp.float64)
    assert M is not None
    ra = sharded_cg_solve(op, b, jnp.zeros_like(b), block_amg=M,
                          tol=1e-10, maxiter=1000)
    assert bool(ra.converged)
    assert int(ra.iterations) < int(rj.iterations)
    x = op.get_vector(ra.x)
    xd = np.linalg.solve(sys_.A.to_dense(), sys_.b)
    assert np.abs(x - xd).max() / np.abs(xd).max() < 1e-7


def test_two_level_schwarz(data_dir):
    """Two-level Schwarz (block-AMG + partition-constant coarse solve):
    must stay correct and not regress the one-level iteration count."""
    import jax
    from jax.sharding import NamedSharding
    from domain_decomposed_pde_solver.parallel.schwarz import (
        build_block_amg,
        build_coarse_correction,
    )

    _, sys_, adj, coords = make_system(data_dir)
    nparts = 4
    parts = partition_graph(adj, nparts, coords=coords)
    plan = build_halo_plan(sys_.A, parts, nparts)
    op = ShardedOperator.from_plan(plan, make_device_mesh(nparts))
    b = op.put_vector(sys_.b)
    M = build_block_amg(sys_.A, plan, dtype=jnp.float64)
    Ac_inv = build_coarse_correction(sys_.A, plan)
    valid = jax.device_put(
        plan.row_valid.astype(np.float64), NamedSharding(op.mesh, P("parts"))
    )
    r1 = sharded_cg_solve(op, b, jnp.zeros_like(b), block_amg=M,
                          tol=1e-10, maxiter=1000)
    r2 = sharded_cg_solve(op, b, jnp.zeros_like(b), block_amg=M,
                          coarse_inv=Ac_inv, row_valid=valid,
                          tol=1e-10, maxiter=1000)
    assert bool(r2.converged)
    assert int(r2.iterations) <= int(r1.iterations)
    x = op.get_vector(r2.x)
    xd = np.linalg.solve(sys_.A.to_dense(), sys_.b)
    assert np.abs(x - xd).max() / np.abs(xd).max() < 1e-7


