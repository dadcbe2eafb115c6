"""Distributed additive-Schwarz ILU(0)/ILUT tests.

The reference's production run is ``mpirun -n P`` Belos GMRES + Ifpack2
ILUT, and Ifpack2 factors each rank's LOCAL diagonal block with no
preconditioner communication (``BelosMueLuSolver.cpp:92-106``).  These
tests validate the framework's literal analogue
(:mod:`domain_decomposed_pde_solver.parallel.schwarzilu`): per-part
ILUT factors stacked to uniform shapes, applied inside ``shard_map`` with
level-scheduled triangular sweeps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from domain_decomposed_pde_solver.io import read_exodus
from domain_decomposed_pde_solver.models import assemble_heat_system
from domain_decomposed_pde_solver.ops import choose_operator, coo_to_csr
from domain_decomposed_pde_solver.parallel import (
    ShardedOperator,
    build_block_ilu,
    build_halo_plan,
    make_device_mesh,
    partition_graph,
    sharded_gmres_solve,
)
from domain_decomposed_pde_solver.parallel.schwarz import (
    _local_diagonal_block,
)
from domain_decomposed_pde_solver.solvers import gmres_solve
from domain_decomposed_pde_solver.solvers.precond.ilu import (
    ilut_preconditioner,
)


def make_plan(data_dir, name, nparts):
    mesh = read_exodus(str(data_dir / name))
    sys_ = assemble_heat_system(mesh)
    A = sys_.A
    rows = np.repeat(np.arange(A.n_rows), A.row_lengths())
    off = rows != A.indices
    adj = coo_to_csr(
        rows[off], A.indices[off], np.ones(int(off.sum())), A.shape,
        sum_dups=False,
    )
    coords = mesh.coords[sys_.free_to_node]
    parts = partition_graph(adj, nparts, coords=coords)
    plan = build_halo_plan(A, parts, nparts, dtype=np.float64)
    return sys_, plan


def test_stacked_apply_matches_per_part(data_dir):
    """The padded/stacked block-ILUT apply must equal each part's own
    (unpadded) ILUT preconditioner exactly — the padding slots are no-ops."""
    sys_, plan = make_plan(data_dir, "brick.exo", 4)
    Ms = build_block_ilu(sys_.A, plan, dtype=jnp.float64)
    assert Ms is not None
    rows = np.repeat(np.arange(sys_.A.n_rows), sys_.A.row_lengths())
    pr = plan.part_of_row[rows]
    pc = plan.part_of_row[sys_.A.indices]
    rng = np.random.default_rng(0)
    r = rng.standard_normal((plan.nparts, plan.n_local))
    for p in range(plan.nparts):
        local = _local_diagonal_block(sys_.A, plan, p, rows, pr, pc)
        m_ref = ilut_preconditioner(local, n_pad=plan.n_local, dtype=jnp.float64)
        m_stk = jax.tree_util.tree_map(lambda leaf: leaf[p], Ms)
        got = np.asarray(m_stk(jnp.asarray(r[p])))
        want = np.asarray(m_ref(jnp.asarray(r[p])))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("nparts", [4, 8])
def test_sharded_gmres_block_ilut(data_dir, nparts):
    """GMRES + distributed block-ILUT converges and needs no more
    iterations than GMRES + Jacobi (the preconditioner must help)."""
    sys_, plan = make_plan(data_dir, "brick.exo", nparts)
    op = ShardedOperator.from_plan(plan, make_device_mesh(nparts))
    b = op.put_vector(sys_.b)
    x0 = jnp.zeros_like(b)
    deg = np.where(sys_.degree > 0, sys_.degree, 1.0)

    r_j = sharded_gmres_solve(
        op, b, x0, precond_diag=op.put_vector(1.0 / deg),
        restart=30, tol=1e-8, maxiter=1000,
    )
    Ms = build_block_ilu(sys_.A, plan, dtype=jnp.float64)
    assert Ms is not None
    r_i = sharded_gmres_solve(
        op, b, x0, block_precond=Ms, restart=30, tol=1e-8, maxiter=1000,
    )
    assert bool(r_i.converged)
    x = op.get_vector(r_i.x)
    rel = np.linalg.norm(
        sys_.A.matvec(x.astype(np.float64)) - sys_.b
    ) / np.linalg.norm(sys_.b)
    assert rel < 1e-6
    assert int(r_i.iterations) <= int(r_j.iterations)


@pytest.mark.slow
def test_block_ilut_within_2x_of_single_device(data_dir):
    """VERDICT r3 criterion: distributed block-ILUT iteration counts within
    ~2x of single-device ILUT on tet-cube at P=4 (the additive-Schwarz
    degradation the reference itself pays under mpirun)."""
    sys_, plan = make_plan(data_dir, "tet-cube-heat.exo", 4)
    nparts = 4
    op = ShardedOperator.from_plan(plan, make_device_mesh(nparts))
    b = op.put_vector(sys_.b)

    # Single-device ILUT GMRES on the same operator (f64 end to end).
    A1 = choose_operator(sys_.A, dtype=jnp.float64)
    M1 = ilut_preconditioner(sys_.A, n_pad=A1.n_pad, dtype=jnp.float64)
    b1 = A1.put_vector(sys_.b.astype(np.float64))
    r1 = gmres_solve(
        A1, b1, jnp.zeros_like(b1), precond=M1, restart=50, tol=1e-6,
        maxiter=600,
    )
    assert bool(r1.converged)

    Ms = build_block_ilu(sys_.A, plan, dtype=jnp.float64)
    assert Ms is not None
    r_i = sharded_gmres_solve(
        op, b, jnp.zeros_like(b), block_precond=Ms, restart=50, tol=1e-6,
        maxiter=600,
    )
    assert bool(r_i.converged)
    assert int(r_i.iterations) <= 2 * int(r1.iterations) + 5, (
        f"distributed ILUT {int(r_i.iterations)} vs single-device "
        f"{int(r1.iterations)}"
    )


def test_compare_preconditioners_schwarz_row(data_dir):
    """The comparison harness grows a schwarz_ilut row when given a plan."""
    from domain_decomposed_pde_solver.utils.compare import (
        compare_preconditioners,
    )

    sys_, plan = make_plan(data_dir, "brick.exo", 4)
    out = compare_preconditioners(
        sys_.A, sys_.b, tol=1e-8, maxiter=600, plan=plan
    )
    assert "schwarz_ilut" in out
    row = out["schwarz_ilut"]
    assert row["converged"]
    assert row["nparts"] == 4
    # Stronger than Jacobi, weaker than (or equal to) global ILUT.
    assert row["iterations"] <= out["jacobi"]["iterations"]
    assert row["iterations"] >= out["ilut"]["iterations"] - 2
