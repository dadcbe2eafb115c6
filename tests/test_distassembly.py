"""Distributed assembly: per-rank slices -> per-rank rows, no global CSR.

The strongest possible check: the plan blocks packed by the distributed
pipeline (``parallel/distassembly.py``) must be BIT-IDENTICAL to the
corresponding slices of ``build_halo_plan`` run on the globally assembled
matrix with the same deterministic RCB partition — same extended-local
columns, same values, same send schedules.  Plus an end-to-end sharded CG
solve on the distributed-assembled operator against the dense solution.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from domain_decomposed_pde_solver.io import read_exodus
from domain_decomposed_pde_solver.io.boxmesh import box_mesh
from domain_decomposed_pde_solver.io.exodus import write_exodus
from domain_decomposed_pde_solver.models import assemble_heat_system
from domain_decomposed_pde_solver.parallel.distassembly import (
    assemble_heat_distributed,
    dist_local_phase,
)
from domain_decomposed_pde_solver.parallel.halo import build_halo_plan
from domain_decomposed_pde_solver.parallel.sharded import (
    ShardedOperator,
    make_device_mesh,
    sharded_cg_solve,
)


@pytest.fixture(scope="module")
def tet_cube(data_dir):
    return str(data_dir / "tet-cube-heat.exo")


def _box_path(tmp_path, nx=6, ny=5, nz=4, elem_type="HEX8"):
    mesh = box_mesh(nx, ny, nz, elem_type=elem_type)
    p = str(tmp_path / f"box_{elem_type}.exo")
    write_exodus(p, mesh)
    return p


@pytest.mark.parametrize("nranks,nparts", [(2, 2), (2, 4), (4, 4), (3, 3)])
def test_plan_parity_tet_cube(nranks, nparts, tet_cube):
    plan_d, b_d, state = assemble_heat_distributed(tet_cube, nranks, nparts)

    mesh = read_exodus(tet_cube)
    sys_ = assemble_heat_system(mesh)
    # Same deterministic partition the distributed path derived.
    plan_g = build_halo_plan(sys_.A, state.owner_free, nparts)

    assert plan_d.n_global == plan_g.n_global == sys_.A.n_rows
    assert plan_d.n_local == plan_g.n_local
    assert plan_d.halo_width == plan_g.halo_width
    np.testing.assert_array_equal(plan_d.perm, plan_g.perm)
    np.testing.assert_array_equal(plan_d.local_of_row, plan_g.local_of_row)
    np.testing.assert_array_equal(plan_d.row_valid, plan_g.row_valid)
    # The money assertions: bit-identical packed blocks + send schedules.
    np.testing.assert_array_equal(plan_d.ell_cols, plan_g.ell_cols)
    np.testing.assert_array_equal(plan_d.ell_vals, plan_g.ell_vals)
    np.testing.assert_array_equal(plan_d.send_idx, plan_g.send_idx)
    # RHS parity (original free-row order).
    np.testing.assert_allclose(b_d, sys_.b, rtol=0, atol=0)


def test_plan_parity_box_hex(tmp_path):
    path = _box_path(tmp_path, elem_type="HEX8")
    plan_d, b_d, state = assemble_heat_distributed(path, 4, 8)
    mesh = read_exodus(path)
    sys_ = assemble_heat_system(mesh)
    plan_g = build_halo_plan(sys_.A, state.owner_free, 8)
    np.testing.assert_array_equal(plan_d.ell_cols, plan_g.ell_cols)
    np.testing.assert_array_equal(plan_d.ell_vals, plan_g.ell_vals)
    np.testing.assert_array_equal(plan_d.send_idx, plan_g.send_idx)
    np.testing.assert_allclose(b_d, sys_.b, rtol=0, atol=0)


def test_plan_parity_box_tet(tmp_path):
    path = _box_path(tmp_path, nx=4, ny=4, nz=3, elem_type="TETRA4")
    plan_d, b_d, state = assemble_heat_distributed(path, 2, 8)
    mesh = read_exodus(path)
    sys_ = assemble_heat_system(mesh)
    plan_g = build_halo_plan(sys_.A, state.owner_free, 8)
    np.testing.assert_array_equal(plan_d.ell_cols, plan_g.ell_cols)
    np.testing.assert_array_equal(plan_d.ell_vals, plan_g.ell_vals)
    np.testing.assert_array_equal(plan_d.send_idx, plan_g.send_idx)
    np.testing.assert_allclose(b_d, sys_.b, rtol=0, atol=0)


def test_slice_union_covers_global_edges(tet_cube):
    """Per-slice unique edges union to the global unique edge set (the
    dedup-at-owner premise)."""
    from domain_decomposed_pde_solver.models.heat import (
        unique_element_edges,
    )

    mesh = read_exodus(tet_cube)
    gu, gv = unique_element_edges(mesh)
    gkeys = gu * np.int64(mesh.num_nodes) + gv
    states = [dist_local_phase(tet_cube, r, 3, 3) for r in range(3)]
    # Reconstruct the union of exchanged keys (sources are free rows only).
    free_src = ~mesh.boundary_value_per_node()[0][gu]
    n2f = states[0].node_to_free
    expect = np.unique(
        n2f[gu[free_src]] * np.int64(mesh.num_nodes) + gv[free_src]
    )
    got = np.unique(
        np.concatenate([k for s in states for k in s.send_keys])
    )
    np.testing.assert_array_equal(got, expect)


def test_distributed_solve_end_to_end(tet_cube):
    """Sharded CG on the distributed-assembled operator reaches the same
    solution as the dense solve — no global CSR ever built."""
    plan, b, state = assemble_heat_distributed(tet_cube, 4, 4)
    mesh = make_device_mesh(4)
    op = ShardedOperator.from_plan(plan, mesh)
    b_s = op.put_vector(b)
    x0 = op.put_vector(np.zeros_like(b))
    diag = plan.gather_vector(
        np.take_along_axis(
            plan.ell_vals,
            # extended-local diagonal slot: col == local row id
            np.argmax(
                plan.ell_cols
                == np.arange(plan.n_local, dtype=np.int32)[None, :, None],
                axis=2,
            )[..., None],
            axis=2,
        )[..., 0]
    )
    dinv = op.put_vector(1.0 / diag)
    res = sharded_cg_solve(op, b_s, x0, precond_diag=dinv, tol=1e-10, maxiter=600)
    x = op.get_vector(res.x)

    mesh_m = read_exodus(tet_cube)
    sys_ = assemble_heat_system(mesh_m)
    r = sys_.A.to_scipy() @ x - sys_.b
    assert np.linalg.norm(r) / np.linalg.norm(sys_.b) < 1e-8
