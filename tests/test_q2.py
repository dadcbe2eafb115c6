"""Q2 (triquadratic hex) elements: elevation topology + patch tests."""

import numpy as np
import scipy.sparse as sp

from domain_decomposed_pde_solver.io.boxmesh import box_mesh
from domain_decomposed_pde_solver.models.q2 import (
    assemble_poisson_q2,
    elevate_to_q2,
)


def _solve(sy):
    S = sp.csr_matrix((sy.A.data, sy.A.indices, sy.A.indptr), shape=sy.A.shape)
    return sp.linalg.spsolve(S.tocsc(), sy.b)


def test_elevation_counts():
    """DOF count = nodes + unique edges + unique faces + elements."""
    nx, ny, nz = 3, 2, 4
    mesh = box_mesh(nx, ny, nz, elem_type="HEX8")
    coords, conn, bnd = elevate_to_q2(mesh)
    mxn, myn, mzn = nx + 1, ny + 1, nz + 1
    n_nodes = mxn * myn * mzn
    n_edges = (
        nx * myn * mzn + mxn * ny * mzn + mxn * myn * nz
    )
    n_faces = (
        nx * ny * mzn + nx * myn * nz + mxn * ny * nz
    )
    n_elems = nx * ny * nz
    assert coords.shape[0] == n_nodes + n_edges + n_faces + n_elems
    assert conn.shape == (n_elems, 27)
    # Every element's 27 DOFs are distinct.
    assert all(len(set(row)) == 27 for row in conn.tolist())


def test_boundary_classification():
    """Boundary DOFs = everything in the outer shell, nothing interior;
    body centers are never boundary."""
    mesh = box_mesh(3, 3, 3, elem_type="HEX8")
    coords, conn, bnd = elevate_to_q2(mesh)
    on_shell = (
        np.isclose(coords[:, 0], 0) | np.isclose(coords[:, 0], 1)
        | np.isclose(coords[:, 1], 0) | np.isclose(coords[:, 1], 1)
        | np.isclose(coords[:, 2], 0) | np.isclose(coords[:, 2], 1)
    )
    np.testing.assert_array_equal(bnd, on_shell)


def test_patch_test_quadratic_exact():
    """u = x^2 + 2y^2 + 3z^2 - xy with f = -laplace(u) = -12 is reproduced
    to machine precision (the defining Q2 property)."""
    mesh = box_mesh(4, 3, 3, elem_type="HEX8")
    coords, conn, bnd = elevate_to_q2(mesh)
    u = lambda c: c[:, 0] ** 2 + 2 * c[:, 1] ** 2 + 3 * c[:, 2] ** 2 - c[:, 0] * c[:, 1]
    sy = assemble_poisson_q2(
        mesh, dirichlet=u, f=lambda c: np.full(c.shape[0], -12.0)
    )
    x = _solve(sy)
    np.testing.assert_allclose(x, u(coords[sy.free_to_node]), atol=1e-12)


def test_linear_exact_no_source():
    mesh = box_mesh(3, 4, 3, elem_type="HEX8")
    coords, conn, bnd = elevate_to_q2(mesh)
    u = lambda c: 1 + 2 * c[:, 0] - c[:, 1] + 0.5 * c[:, 2]
    sy = assemble_poisson_q2(mesh, dirichlet=u)
    x = _solve(sy)
    np.testing.assert_allclose(x, u(coords[sy.free_to_node]), atol=1e-12)


def test_convergence_order_on_smooth_solution():
    """At least O(h^3) nodal error decay on a smooth non-polynomial exact
    solution (measured ~h^4 nodal superconvergence on the tensor grid;
    plain cubics like x^3 are nodally exact and can't measure order)."""
    errs = []
    for nx in (4, 8):
        mesh = box_mesh(nx, nx, nx, elem_type="HEX8")
        coords, conn, bnd = elevate_to_q2(mesh)
        u = lambda c: np.sin(np.pi * c[:, 0]) * c[:, 1] ** 2
        f = lambda c: -(
            -np.pi ** 2 * np.sin(np.pi * c[:, 0]) * c[:, 1] ** 2
            + 2 * np.sin(np.pi * c[:, 0])
        )
        sy = assemble_poisson_q2(mesh, dirichlet=u, f=f)
        x = _solve(sy)
        errs.append(
            np.sqrt(np.mean((x - u(coords[sy.free_to_node])) ** 2))
        )
    # Halving h cuts the error ~15x here; require at least ~O(h^3)-ish.
    assert errs[1] < errs[0] / 5.0


def test_rejects_tets():
    import pytest

    mesh = box_mesh(2, 2, 2, elem_type="TETRA4")
    with pytest.raises(ValueError, match="HEX8 only"):
        elevate_to_q2(mesh)


def test_q2_system_solves_with_cg():
    """The Q2 system is SPD and drops into the framework CG."""
    import jax.numpy as jnp

    from domain_decomposed_pde_solver.ops import ell_from_csr, pad_vector
    from domain_decomposed_pde_solver.solvers import (
        cg_solve,
        jacobi_preconditioner,
    )

    mesh = box_mesh(3, 3, 3, elem_type="HEX8")
    coords, conn, bnd = elevate_to_q2(mesh)
    u = lambda c: c[:, 0] ** 2 - c[:, 2] ** 2  # harmonic: f = 0
    sy = assemble_poisson_q2(mesh, dirichlet=u)
    A = ell_from_csr(sy.A, dtype=jnp.float64)
    b = pad_vector(sy.b, A.n_pad)
    res = cg_solve(A, b, jnp.zeros_like(b), precond=jacobi_preconditioner(A),
                   tol=1e-12, maxiter=2000)
    assert bool(res.converged)
    x = np.asarray(res.x)[: sy.n_free]
    np.testing.assert_allclose(x, u(coords[sy.free_to_node]), atol=1e-9)


def test_vertex_solution_roundtrip(tmp_path):
    """Quadratic solves write through the standard Exodus pipeline via the
    vertex projection."""
    from domain_decomposed_pde_solver.io import (
        ExodusSolutionWriter,
        read_nodal_vars,
    )
    from domain_decomposed_pde_solver.models.q2 import vertex_solution

    mesh = box_mesh(3, 3, 3, elem_type="HEX8")
    coords, conn, bnd = elevate_to_q2(mesh)
    u = lambda c: c[:, 0] ** 2 - 0.5 * c[:, 2] ** 2
    sy = assemble_poisson_q2(
        mesh, dirichlet=u, f=lambda c: np.full(c.shape[0], -1.0)
    )
    x = _solve(sy)
    field = vertex_solution(mesh, sy, x, u, coords)
    assert field.shape == (mesh.num_nodes,)
    path = str(tmp_path / "q2.exo")
    w = ExodusSolutionWriter(path, mesh)
    # A full nodal field is "free values" over the identity map.
    w.write_solution(field, np.arange(mesh.num_nodes), 1)
    w.close()
    names, times, vals = read_nodal_vars(path)
    np.testing.assert_allclose(vals[-1][0], field, rtol=1e-6)
