"""Edge-case coverage: small maxiter, tiny systems, odd sizes, caps."""

import jax.numpy as jnp
import numpy as np
import pytest

from domain_decomposed_pde_solver.io import box_mesh, read_exodus
from domain_decomposed_pde_solver.models import assemble_heat_system
from domain_decomposed_pde_solver.ops import (
    coo_to_csr,
    ell_from_csr,
    pad_vector,
    unpad_vector,
)
from domain_decomposed_pde_solver.solvers import (
    cg_solve,
    cg_solve_with_state,
    gmres_solve,
    jacobi_preconditioner,
)


@pytest.fixture(scope="module")
def system(data_dir):
    return assemble_heat_system(read_exodus(str(data_dir / "brick.exo")))


def test_gmres_maxiter_smaller_than_restart(system):
    """maxiter < restart must terminate promptly (one cycle) and report a
    sane partial result."""
    A = ell_from_csr(system.A, dtype=jnp.float64)
    b = pad_vector(system.b, A.n_pad)
    res = gmres_solve(A, b, jnp.zeros_like(b), restart=30, tol=1e-14, maxiter=5)
    assert not bool(res.converged)
    assert np.isfinite(float(res.relres))
    assert float(res.relres) < 1.0  # made progress


def test_cg_maxiter_zero(system):
    A = ell_from_csr(system.A, dtype=jnp.float64)
    b = pad_vector(system.b, A.n_pad)
    res = cg_solve(A, b, jnp.zeros_like(b), tol=1e-14, maxiter=0)
    assert int(res.iterations) == 0
    np.testing.assert_array_equal(np.asarray(res.x), 0.0)


def test_cg_state_chunks_match_continuous(system):
    """Running CG as 5-iteration state-threaded chunks must reproduce the
    continuous run exactly (same iterate after the same iteration count)."""
    A = ell_from_csr(system.A, dtype=jnp.float64)
    b = pad_vector(system.b, A.n_pad)
    M = jacobi_preconditioner(A)
    ref, _ = cg_solve_with_state(A, b, jnp.zeros_like(b), precond=M,
                                 tol=1e-30, maxiter=20)
    x = jnp.zeros_like(b)
    state = None
    for _ in range(4):
        res, state = cg_solve_with_state(A, b, x, state=state, precond=M,
                                         tol=1e-30, maxiter=5)
        x = res.x
    np.testing.assert_allclose(np.asarray(x), np.asarray(ref.x),
                               rtol=1e-12, atol=1e-12)


def test_one_dof_system():
    """A 1-DOF reduced system (everything else Dirichlet) must solve."""
    from domain_decomposed_pde_solver.io.mesh import NodeSet
    import dataclasses

    mesh = box_mesh(2, 2, 2, elem_type="TETRA4")
    # Make every node but the center Dirichlet.
    center = np.argmin(((mesh.coords - 0.5) ** 2).sum(axis=1))
    others = np.setdiff1d(np.arange(mesh.num_nodes), [center])
    mesh = dataclasses.replace(
        mesh, node_sets=[NodeSet(id=5, nodes=others)]
    )
    s = assemble_heat_system(mesh)
    assert s.n_free == 1
    A = ell_from_csr(s.A, dtype=jnp.float64)
    b = pad_vector(s.b, A.n_pad)
    res = cg_solve(A, b, jnp.zeros_like(b), tol=1e-14, maxiter=10)
    assert bool(res.converged)
    x = unpad_vector(res.x, 1)
    np.testing.assert_allclose(x[0], s.b[0] / s.degree[0])


def test_hyb_max_diags_cap(data_dir):
    from domain_decomposed_pde_solver.ops.hyb import hyb_from_csr, rcm_permute

    sys_ = assemble_heat_system(read_exodus(str(data_dir / "brick.exo")))
    Ap, _ = rcm_permute(sys_.A)
    H = hyb_from_csr(Ap, dtype=jnp.float64, min_occupancy=0.0, max_diags=8)
    assert H.dia.ndiags <= 8
    x = np.random.default_rng(0).standard_normal(Ap.n_rows)
    y = unpad_vector(H.matvec(pad_vector(x, H.n_pad)), Ap.n_rows)
    np.testing.assert_allclose(y, Ap.matvec(x), rtol=1e-12, atol=1e-10)


def test_slab_odd_sizes():
    """Slab plan with n not divisible by P and odd padding."""
    from domain_decomposed_pde_solver.parallel import (
        build_slab_plan,
        slab_cg_solve,
    )

    mesh = box_mesh(13, 11, 9, elem_type="TETRA4")
    s = assemble_heat_system(mesh)
    plan = build_slab_plan(s.A, 3, dtype=np.float64)
    if plan is None:
        pytest.skip("bandwidth too large for 3 slabs on this mesh")
    x, res = slab_cg_solve(plan, s.b, np.zeros(s.A.n_rows), tol=1e-11,
                           maxiter=3000)
    assert bool(res.converged)
    r = s.A.matvec(x) - s.b
    assert np.abs(r).max() / np.abs(s.b).max() < 1e-9
