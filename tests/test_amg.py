"""Smoothed-aggregation AMG tests (the CG+AMG north-star path)."""

import jax.numpy as jnp
import numpy as np
import pytest

from domain_decomposed_pde_solver.io import read_exodus
from domain_decomposed_pde_solver.io.boxmesh import box_mesh
from domain_decomposed_pde_solver.models import assemble_heat_system
from domain_decomposed_pde_solver.ops import ell_from_csr, ell_spmv, pad_vector, unpad_vector
from domain_decomposed_pde_solver.solvers import (
    cg_solve,
    jacobi_preconditioner,
    smoothed_aggregation_setup,
)
from domain_decomposed_pde_solver.solvers.precond.amg import aggregate_greedy


def test_aggregation_covers_all_nodes(data_dir):
    mesh = read_exodus(str(data_dir / "brick.exo"))
    sys_ = assemble_heat_system(mesh)
    agg = aggregate_greedy(sys_.A)
    assert agg.min() >= 0
    n_agg = agg.max() + 1
    # Aggressive coarsening: aggregates average >= 4 nodes on a tet mesh.
    assert n_agg * 4 <= sys_.A.n_rows
    # Every aggregate nonempty.
    assert (np.bincount(agg, minlength=n_agg) > 0).all()


def test_amg_hierarchy_shrinks(data_dir):
    mesh = read_exodus(str(data_dir / "brick.exo"))
    sys_ = assemble_heat_system(mesh)
    M = smoothed_aggregation_setup(sys_.A, dtype=jnp.float64)
    sizes = [l.n_rows for l in M.levels]
    assert all(a > b * 2 for a, b in zip(sizes, sizes[1:] + [M.coarse_inv.shape[0] // 2]))


def test_amg_cg_beats_jacobi_and_matches_dense(data_dir):
    mesh = read_exodus(str(data_dir / "brick.exo"))
    sys_ = assemble_heat_system(mesh)
    A = ell_from_csr(sys_.A, dtype=jnp.float64)
    b = pad_vector(sys_.b, A.n_pad)
    M = smoothed_aggregation_setup(sys_.A, dtype=jnp.float64)
    res_j = cg_solve(A, b, jnp.zeros_like(b), precond=jacobi_preconditioner(A),
                     tol=1e-10, maxiter=3000)
    res_a = cg_solve(A, b, jnp.zeros_like(b), precond=M,
                     tol=1e-10, maxiter=300)
    assert bool(res_a.converged)
    assert int(res_a.iterations) < int(res_j.iterations) // 3
    x = unpad_vector(res_a.x, sys_.n_free)
    xd = np.linalg.solve(sys_.A.to_dense(), sys_.b)
    assert np.abs(x - xd).max() / np.abs(xd).max() < 1e-8


def test_amg_scalable_iteration_count():
    """AMG iteration counts must stay ~flat as the mesh refines (the whole
    point of multigrid; Jacobi degrades with h)."""
    iters = []
    for n in (10, 20):
        mesh = box_mesh(n, n, n, elem_type="TETRA4")
        sys_ = assemble_heat_system(mesh)
        A = ell_from_csr(sys_.A, dtype=jnp.float64)
        b = pad_vector(sys_.b, A.n_pad)
        M = smoothed_aggregation_setup(sys_.A, dtype=jnp.float64)
        res = cg_solve(A, b, jnp.zeros_like(b),
                       precond=M, tol=1e-10, maxiter=300)
        assert bool(res.converged)
        iters.append(int(res.iterations))
    assert iters[1] <= iters[0] + 6  # near-constant across 8x DOF growth


def test_amg_f32_preconditioner_f64_cg(data_dir):
    """Mixed precision: f32 V-cycle preconditioning an f64 CG still converges
    to f64 accuracy (preconditioner quality, not accuracy, is what matters)."""
    mesh = read_exodus(str(data_dir / "brick.exo"))
    sys_ = assemble_heat_system(mesh)
    A = ell_from_csr(sys_.A, dtype=jnp.float64)
    b = pad_vector(sys_.b, A.n_pad)
    from domain_decomposed_pde_solver.solvers.precond.wrappers import (
        CastPreconditioner,
    )

    M32 = smoothed_aggregation_setup(sys_.A, dtype=jnp.float32)
    M = CastPreconditioner(inner=M32, dtype=jnp.float32)
    res = cg_solve(A, b, jnp.zeros_like(b),
                   precond=M, tol=1e-10, maxiter=300)
    assert bool(res.converged)
    x = unpad_vector(res.x, sys_.n_free)
    xd = np.linalg.solve(sys_.A.to_dense(), sys_.b)
    assert np.abs(x - xd).max() / np.abs(xd).max() < 1e-8


def test_factored_transfers_match_explicit():
    """The factored P=(I-wD^-1A)T application must equal the explicit ELL
    P/R application to rounding error (same preconditioner, two encodings)."""
    from domain_decomposed_pde_solver.solvers.precond.amg import (
        FactoredProlongator,
    )

    mesh = box_mesh(10, 9, 8, elem_type="TETRA4")
    sys_ = assemble_heat_system(mesh)
    M_fact = smoothed_aggregation_setup(sys_.A, dtype=jnp.float64)
    M_expl = smoothed_aggregation_setup(
        sys_.A, dtype=jnp.float64, factored_transfers=False
    )
    assert isinstance(M_fact.levels[0].P, FactoredProlongator)
    assert not isinstance(M_expl.levels[0].P, FactoredProlongator)
    lf, le = M_fact.levels[0], M_expl.levels[0]
    rng = np.random.default_rng(0)
    xc = jnp.asarray(rng.standard_normal(le.R.n_pad))
    np.testing.assert_allclose(
        np.asarray(lf.P.matvec(xc)), np.asarray(le.P.matvec(xc)),
        rtol=1e-11, atol=1e-11,
    )
    rf = jnp.asarray(rng.standard_normal(lf.A.n_pad))
    np.testing.assert_allclose(
        np.asarray(lf.R.matvec(rf)), np.asarray(le.R.matvec(rf)),
        rtol=1e-11, atol=1e-11,
    )
    # Whole-preconditioner action identical.
    np.testing.assert_allclose(
        np.asarray(M_fact(rf)), np.asarray(M_expl(rf)), rtol=1e-10, atol=1e-10
    )


def test_aggressive_coarsening_converges():
    """aggressive_levels composes two aggregation rounds on the finest
    level: much smaller level 1 (the gather-bound level), solution
    still correct to the CG tolerance."""
    from domain_decomposed_pde_solver.ops import choose_operator

    mesh = box_mesh(14, 14, 14, elem_type="TETRA4")
    sys_ = assemble_heat_system(mesh)
    M0 = smoothed_aggregation_setup(
        sys_.A, dtype=jnp.float64, aggressive_levels=0
    )
    M1 = smoothed_aggregation_setup(
        sys_.A, dtype=jnp.float64, aggressive_levels=1
    )
    # Two composed rounds coarsen much harder than one.
    n1_normal = M0.levels[1].A.n_rows if len(M0.levels) > 1 else 0
    n1_aggr = M1.levels[1].A.n_rows if len(M1.levels) > 1 else 0
    if n1_normal and n1_aggr:
        assert n1_aggr * 4 <= n1_normal
    A = choose_operator(sys_.A, dtype=jnp.float64)
    b = pad_vector(sys_.b, A.n_pad)
    res = cg_solve(
        A, b, jnp.zeros_like(b), precond=M1, tol=1e-12, maxiter=500
    )
    assert bool(res.converged)
    import scipy.sparse.linalg as spla

    xd = spla.spsolve(sys_.A.to_scipy().tocsc(), sys_.b)
    x = unpad_vector(res.x, sys_.n_free)
    assert np.abs(x - xd).max() / np.abs(xd).max() < 1e-9


def test_brick_transfers_on_structured_grid():
    """Gather-free brick transfers: same algebra as the factored selection
    transfers, implemented as reshapes; P/R must stay exact transposes and
    the preconditioned solve must reach the direct solution."""
    import jax.numpy as jnp

    from domain_decomposed_pde_solver.ops import choose_operator
    from domain_decomposed_pde_solver.solvers.precond.amg import (
        BrickProlongator,
        infer_free_grid,
    )

    mesh = box_mesh(14, 12, 13, elem_type="TETRA4")
    sys_ = assemble_heat_system(mesh)
    dims = infer_free_grid(mesh, sys_.free_to_node)
    assert dims is not None and int(np.prod(dims)) == sys_.n_free
    M = smoothed_aggregation_setup(
        sys_.A, dtype=jnp.float64, aggressive_levels=1,
        grid_dims=dims, brick=4,
    )
    P = M.levels[0].P
    assert isinstance(P, BrickProlongator)
    # R == P^T: <P xc, w> == <xc, R w> for random vectors.
    rng = np.random.default_rng(0)
    xc = jnp.asarray(rng.standard_normal(P.n_pad_c))
    w = jnp.asarray(rng.standard_normal(P.n_pad_f))
    lhs = float(jnp.vdot(P.matvec(xc), w))
    rhs = float(jnp.vdot(xc, P.rmatvec(w)))
    np.testing.assert_allclose(lhs, rhs, rtol=1e-12)
    A = choose_operator(sys_.A, dtype=jnp.float64)
    b = pad_vector(sys_.b, A.n_pad)
    res = cg_solve(A, b, jnp.zeros_like(b), precond=M, tol=1e-12, maxiter=500)
    assert bool(res.converged)
    import scipy.sparse.linalg as spla

    xd = spla.spsolve(sys_.A.to_scipy().tocsc(), sys_.b)
    x = unpad_vector(res.x, sys_.n_free)
    assert np.abs(x - xd).max() / np.abs(xd).max() < 1e-9


def test_infer_free_grid_rejects_unstructured(data_dir):
    from domain_decomposed_pde_solver.solvers.precond.amg import (
        infer_free_grid,
    )

    mesh = read_exodus(str(data_dir / "tet-cube-heat.exo"))
    sys_ = assemble_heat_system(mesh)
    assert infer_free_grid(mesh, sys_.free_to_node) is None


