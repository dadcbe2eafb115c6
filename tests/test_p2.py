"""P2 (quadratic tet) element tests: exactness on quadratic solutions."""

import numpy as np
import pytest

from domain_decomposed_pde_solver.io.boxmesh import box_mesh
from domain_decomposed_pde_solver.models import (
    assemble_poisson_p2,
    elevate_to_p2,
)


def test_elevation_counts_and_boundary():
    mesh = box_mesh(5, 5, 5, elem_type="TETRA4")
    coords, conn, bnd = elevate_to_p2(mesh)
    assert conn.shape[1] == 10
    assert coords.shape[0] > mesh.num_nodes
    # every midpoint sits exactly between its edge endpoints
    mids = conn[:, 4:]
    pairs = conn[:, [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]]
    expect = 0.5 * (coords[pairs[..., 0]] + coords[pairs[..., 1]])
    np.testing.assert_allclose(coords[mids], expect, atol=1e-14)
    # boundary must include all 8 cube corners and no strictly-interior node
    interior = (
        (coords > 1e-9).all(axis=1) & (coords < 1 - 1e-9).all(axis=1)
    )
    assert not (bnd & interior).any()


@pytest.mark.parametrize(
    "u_exact, f",
    [
        (lambda c: c[:, 0] ** 2 + 2 * c[:, 1] ** 2 - 3 * c[:, 2] ** 2, None),
        (lambda c: c[:, 0] ** 2, lambda c: np.full(c.shape[0], -2.0)),
        (
            lambda c: c[:, 0] * c[:, 1] + 4.0 * c[:, 2],
            None,
        ),
    ],
    ids=["harmonic-quadratic", "sourced-x2", "bilinear"],
)
def test_p2_exact_on_quadratics(u_exact, f):
    """P2 reproduces any quadratic solution exactly (degree-2 Gauss rule);
    the discrete solve must hit machine precision, not just converge."""
    import scipy.sparse.linalg as spla

    mesh = box_mesh(6, 5, 5, elem_type="TETRA4")
    coords, conn, bnd = elevate_to_p2(mesh)
    sys_ = assemble_poisson_p2(mesh, dirichlet=u_exact, f=f)
    u = spla.spsolve(sys_.A.to_scipy().tocsc(), sys_.b)
    err = np.abs(u - u_exact(coords[sys_.free_to_node])).max()
    assert err < 1e-12


def test_p2_system_solves_with_framework_cg():
    import jax.numpy as jnp

    from domain_decomposed_pde_solver.ops import (
        choose_operator,
        pad_vector,
        unpad_vector,
    )
    from domain_decomposed_pde_solver.solvers import (
        cg_solve,
        smoothed_aggregation_setup,
    )

    mesh = box_mesh(6, 5, 5, elem_type="TETRA4")
    coords, conn, bnd = elevate_to_p2(mesh)
    u_exact = lambda c: c[:, 0] ** 2 + 2 * c[:, 1] ** 2 - 3 * c[:, 2] ** 2
    sys_ = assemble_poisson_p2(mesh, dirichlet=u_exact)
    A = choose_operator(sys_.A, dtype=jnp.float64)
    M = smoothed_aggregation_setup(sys_.A, dtype=jnp.float64)
    b = pad_vector(sys_.b, A.n_pad)
    res = cg_solve(A, b, jnp.zeros_like(b), precond=M, tol=1e-13, maxiter=600)
    assert bool(res.converged)
    u = unpad_vector(res.x, sys_.n_free)
    assert np.abs(u - u_exact(coords[sys_.free_to_node])).max() < 1e-10


def test_p2_rejects_hex():
    mesh = box_mesh(4, 4, 4, elem_type="HEX8")
    with pytest.raises(ValueError, match="TETRA4 only"):
        elevate_to_p2(mesh)
