"""Uniform refinement and checkpoint/resume tests."""

import jax.numpy as jnp
import numpy as np
import pytest

from domain_decomposed_pde_solver.io import box_mesh, read_exodus, refine_uniform
from domain_decomposed_pde_solver.models import assemble_heat_system
from domain_decomposed_pde_solver.ops import ell_from_csr, pad_vector, unpad_vector
from domain_decomposed_pde_solver.solvers import (
    cg_solve,
    cg_solve_resumable,
    jacobi_preconditioner,
)
from domain_decomposed_pde_solver.utils.checkpoint import (
    CGCheckpoint,
    load_checkpoint,
    save_checkpoint,
)


def tet_volume(coords, conn):
    a = coords[conn[:, 1]] - coords[conn[:, 0]]
    b = coords[conn[:, 2]] - coords[conn[:, 0]]
    c = coords[conn[:, 3]] - coords[conn[:, 0]]
    return np.abs(np.einsum("ij,ij->i", a, np.cross(b, c))) / 6


def test_tet_refine_counts_and_volume(data_dir):
    mesh = read_exodus(str(data_dir / "2blocks.exo"))
    r = refine_uniform(mesh, 1)
    assert r.num_elem == 8 * mesh.num_elem
    v0 = sum(tet_volume(mesh.coords, b.conn).sum() for b in mesh.blocks)
    v1 = sum(tet_volume(r.coords, b.conn).sum() for b in r.blocks)
    assert abs(v0 - v1) < 1e-9 * v0
    r.validate()


def test_hex_refine_matches_direct_box():
    """Refining a 4^3 hex box must give exactly the 8^3 hex box problem."""
    r = refine_uniform(box_mesh(4, 4, 4, elem_type="HEX8"), 1)
    direct = box_mesh(8, 8, 8, elem_type="HEX8")
    assert r.num_nodes == direct.num_nodes
    assert r.num_elem == direct.num_elem
    sr = assemble_heat_system(r)
    sd = assemble_heat_system(direct)
    assert sr.n_free == sd.n_free
    # Same spectrum up to permutation: compare sorted eigenvalues cheaply via
    # trace and Frobenius norm.
    Ar, Ad = sr.A.to_scipy(), sd.A.to_scipy()
    assert Ar.diagonal().sum() == Ad.diagonal().sum()
    assert abs((Ar.data**2).sum() - (Ad.data**2).sum()) < 1e-9


def test_tri_refine_dirichlet_preserved(data_dir):
    mesh = read_exodus(str(data_dir / "rectangle-tris-boundary.exo"))
    r = refine_uniform(mesh, 2)
    s = assemble_heat_system(r)
    import scipy.sparse.linalg as spla

    x = spla.spsolve(s.A.to_scipy().tocsc(), s.b)
    # Maximum principle with nodeset ids 50/200 as BC values.
    assert x.min() >= 50 - 1e-8 and x.max() <= 200 + 1e-8


def test_refined_solution_converges_to_pde():
    """Graph-Laplacian solutions on refined boxes stay bounded by the BCs and
    the interior midpoint value is between them (discrete harmonicity)."""
    for n in (4, 8):
        mesh = box_mesh(n, n, n, elem_type="TETRA4")
        s = assemble_heat_system(mesh)
        import scipy.sparse.linalg as spla

        x = spla.spsolve(s.A.to_scipy().tocsc(), s.b)
        assert 100 <= x.min() and x.max() <= 1000


def test_checkpoint_roundtrip(tmp_path):
    path = str(tmp_path / "state.npz")
    ck = CGCheckpoint(
        x=np.arange(5.0),
        r=np.ones(5),
        p=np.zeros(5),
        rz=3.25,
        iteration=17,
        meta={"tol": 1e-10},
    )
    save_checkpoint(path, ck)
    back = load_checkpoint(path)
    np.testing.assert_array_equal(back.x, ck.x)
    assert back.iteration == 17 and back.rz == 3.25
    assert back.meta["tol"] == 1e-10
    assert load_checkpoint(str(tmp_path / "missing.npz")) is None


def test_cg_resume_matches_uninterrupted(data_dir, tmp_path):
    """Run 40 iters with checkpointing, 'crash', resume: the final answer
    must match a straight-through solve to machine precision."""
    mesh = read_exodus(str(data_dir / "brick.exo"))
    s = assemble_heat_system(mesh)
    A = ell_from_csr(s.A, dtype=jnp.float64)
    b = pad_vector(s.b, A.n_pad)
    x0 = jnp.zeros_like(b)
    M = jacobi_preconditioner(A)
    path = str(tmp_path / "cg.npz")

    # Phase 1: stop early at 40 iterations (simulated crash after ckpt).
    res1 = cg_solve_resumable(
        A, b, x0, checkpoint_path=path, checkpoint_every=10,
        precond=M, tol=1e-12, maxiter=40,
    )
    assert not bool(res1.converged)
    assert load_checkpoint(path).iteration == 40

    # Phase 2: resume to convergence.
    res2 = cg_solve_resumable(
        A, b, x0, checkpoint_path=path, checkpoint_every=10,
        precond=M, tol=1e-12, maxiter=2000,
    )
    assert bool(res2.converged)

    # Straight-through reference.
    ref = cg_solve(A, b, x0, precond=M, tol=1e-12, maxiter=2000)
    x_resumed = unpad_vector(res2.x, s.n_free)
    x_ref = unpad_vector(ref.x, s.n_free)
    assert int(res2.iterations) == int(ref.iterations)
    np.testing.assert_allclose(x_resumed, x_ref, rtol=1e-12, atol=1e-9)
