"""Transient heat model tests."""

import jax.numpy as jnp
import numpy as np
import pytest

from domain_decomposed_pde_solver.io import box_mesh
from domain_decomposed_pde_solver.models import assemble_heat_system
from domain_decomposed_pde_solver.models.transient import transient_heat_solve
from domain_decomposed_pde_solver.ops import choose_operator


@pytest.fixture(scope="module")
def system():
    s = assemble_heat_system(box_mesh(8, 8, 8, elem_type="TETRA4"))
    A = choose_operator(s.A, dtype=jnp.float64)
    return s, A


def test_single_step_matches_direct_solve(system):
    """One implicit-Euler step == direct solve of (I + dt A) u1 = u0 + dt b."""
    s, A = system
    dt = 0.1
    rng = np.random.default_rng(0)
    u0 = rng.uniform(0, 100, size=s.n_free)
    res = transient_heat_solve(s, A, dt=dt, n_steps=1, u0=u0, tol=1e-13)
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    S = s.A.to_scipy()
    lhs = sp.eye(s.n_free) + dt * S
    u1 = spla.spsolve(lhs.tocsc(), u0 + dt * s.b)
    np.testing.assert_allclose(res.u, u1, rtol=1e-9, atol=1e-9)


def test_flows_toward_steady_state(system):
    """Residual of the steady equation must decrease monotonically in time
    and approach the reference steady solution."""
    s, A = system
    import scipy.sparse.linalg as spla

    u_inf = spla.spsolve(s.A.to_scipy().tocsc(), s.b)
    res = transient_heat_solve(s, A, dt=0.1, n_steps=150, tol=1e-11,
                               record=True)
    errs = np.abs(res.history - u_inf).max(axis=1)
    # Slowest mode decays like exp(-lmin t): t=15, lmin~0.4 -> ~400x.
    assert errs[-1] < errs[0] * 2e-2
    # Monotone decay (implicit Euler on an SPD flow is a contraction).
    assert np.all(np.diff(errs) <= 1e-9)


def test_warm_start_reduces_iterations(system):
    """Later steps must need far fewer CG iterations than early ones."""
    s, A = system
    counts = []
    res = transient_heat_solve(
        s, A, dt=0.05, n_steps=30, tol=1e-10,
        callback=lambda k, t, u: None,
    )
    # Average <= 10 iterations/step once warm (total across 30 steps small).
    assert res.total_cg_iterations < 30 * 25


def test_callback_fires_each_step(system):
    s, A = system
    seen = []
    transient_heat_solve(
        s, A, dt=0.1, n_steps=5,
        callback=lambda k, t, u: seen.append((k, round(t, 10), u.shape)),
    )
    assert [k for k, _, _ in seen] == [1, 2, 3, 4, 5]
    assert all(sh == (s.n_free,) for _, _, sh in seen)
