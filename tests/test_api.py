"""Session API tests: build-once/solve-many with BC overrides."""

import numpy as np
import pytest

from domain_decomposed_pde_solver.api import SteadyHeatSolver
from domain_decomposed_pde_solver.io import read_nodal_vars


@pytest.fixture(scope="module")
def solver(data_dir):
    return SteadyHeatSolver.from_file(
        str(data_dir / "brick.exo"), precond="amg"
    )


def test_default_solve_matches_direct(solver):
    u, res = solver.solve(tol=1e-11)
    assert bool(res.converged)
    import scipy.sparse.linalg as spla

    ud = spla.spsolve(solver.system.A.to_scipy().tocsc(), solver.system.b)
    assert np.abs(u - ud).max() / np.abs(ud).max() < 1e-8


def test_bc_override_solves_new_problem(solver):
    """Overridden boundary temperatures: with a single nodeset set to a
    constant T, the harmonic solution is exactly T everywhere."""
    ids = [ns.id for ns in solver.mesh.node_sets]
    bc = {ids[0]: 42.0}
    u, res = solver.solve(bc=bc, tol=1e-11)
    assert bool(res.converged)
    if len(ids) == 1:
        np.testing.assert_allclose(u, 42.0, rtol=1e-8)
    # Linearity: scaling all BCs scales the solution.
    u2, _ = solver.solve(bc={i: 84.0 for i in ids}, tol=1e-11,
                         warm_start=False)
    u1, _ = solver.solve(bc={i: 42.0 for i in ids}, tol=1e-11,
                         warm_start=False)
    np.testing.assert_allclose(u2, 2 * u1, rtol=1e-7, atol=1e-7)


def test_warm_start_cuts_iterations(solver):
    sid = solver.mesh.node_sets[0].id
    _, res_cold = solver.solve(bc={sid: 100.0}, tol=1e-11, warm_start=False)
    # Tiny perturbation of the BC: warm start should converge much faster.
    _, res_warm = solver.solve(bc={sid: 100.001}, tol=1e-11, warm_start=True)
    assert int(res_warm.iterations) < int(res_cold.iterations)


def test_rhs_for_matches_assembly(solver):
    """rhs_for with no overrides must equal the assembled reference RHS."""
    np.testing.assert_allclose(solver.rhs_for(), solver.system.b)


def test_write_solution_roundtrip(solver, tmp_path):
    sid = solver.mesh.node_sets[0].id
    u, _ = solver.solve(bc={sid: 7.0}, tol=1e-10)
    out = str(tmp_path / "api_sol.exo")
    solver.write_solution(out, u, bc={sid: 7.0}, timestep=3)
    names, times, vals = read_nodal_vars(out)
    assert names == ["Steady-State Heat Solution"]
    # Boundary nodes carry the overridden temperature.
    ns = solver.mesh.node_sets[0]
    np.testing.assert_allclose(vals[-1, 0][ns.nodes], 7.0)
