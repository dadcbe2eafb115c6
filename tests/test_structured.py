"""Closed-form structured (box) assembly — bit-identity with the element
path (models/structured.py).

The lattice tables are derived from a probe box assembled by the
reference-semantics element scan, so these tests are the guarantee that the
scan-free path cannot drift: CSR (indptr/indices/data), b, degree, and the
index maps must be IDENTICAL at every size/parity/element type.
"""

import numpy as np
import pytest

from domain_decomposed_pde_solver.io.boxmesh import box_mesh
from domain_decomposed_pde_solver.models import assemble_heat_system
from domain_decomposed_pde_solver.models.structured import (
    box_lattice_tables,
    structured_box_parts,
    structured_box_system,
)


CASES = [
    (8, 8, 8, "TETRA4"),
    (9, 8, 7, "TETRA4"),   # odd/even mixes cover all parity classes
    (16, 10, 12, "TETRA4"),
    (13, 9, 11, "TETRA4"),
    (8, 9, 10, "HEX8"),
    (11, 11, 11, "HEX8"),
]


@pytest.mark.parametrize("nx,ny,nz,et", CASES)
def test_structured_system_bit_identical(nx, ny, nz, et):
    ref = assemble_heat_system(box_mesh(nx, ny, nz, elem_type=et))
    got = structured_box_system(nx, ny, nz, elem_type=et)
    np.testing.assert_array_equal(
        np.asarray(ref.A.indptr), np.asarray(got.A.indptr)
    )
    np.testing.assert_array_equal(
        np.asarray(ref.A.indices), np.asarray(got.A.indices)
    )
    np.testing.assert_array_equal(
        np.asarray(ref.A.data), np.asarray(got.A.data)
    )
    np.testing.assert_array_equal(ref.b, got.b)
    np.testing.assert_array_equal(ref.degree, got.degree)
    np.testing.assert_array_equal(ref.free_to_node, got.free_to_node)
    np.testing.assert_array_equal(ref.node_to_free, got.node_to_free)
    # Boundary-edge pairs reconstruct b exactly (the rhs_for contract).
    bv = np.zeros(ref.A.n_rows)
    _, bval = box_mesh(nx, ny, nz, elem_type=et).boundary_value_per_node()
    np.add.at(bv, got.bdry_rows, bval[got.bdry_cols])
    np.testing.assert_array_equal(bv, ref.b)


def test_structured_custom_bc_ids():
    ref = assemble_heat_system(box_mesh(9, 8, 8, elem_type="TETRA4",
                                        bc_ids=(7, 42)))
    got = structured_box_system(9, 8, 8, elem_type="TETRA4", bc_ids=(7, 42))
    np.testing.assert_array_equal(ref.b, got.b)
    np.testing.assert_array_equal(
        np.asarray(ref.A.data), np.asarray(got.A.data)
    )


def test_structured_small_grid_falls_back():
    """min free dim < 7 is outside the verified stencil territory: the
    builder must fall back to the element path (still exact)."""
    ref = assemble_heat_system(box_mesh(5, 5, 5, elem_type="TETRA4"))
    got = structured_box_system(5, 5, 5, elem_type="TETRA4")
    np.testing.assert_array_equal(
        np.asarray(ref.A.data), np.asarray(got.A.data)
    )
    np.testing.assert_array_equal(ref.b, got.b)


@pytest.mark.parametrize("device", [False, True])
@pytest.mark.parametrize("nx,ny,nz,et", [
    (8, 8, 8, "TETRA4"), (16, 10, 12, "TETRA4"), (8, 9, 10, "HEX8"),
])
def test_device_parts_bit_identical(nx, ny, nz, et, device):
    """The device-side parts (corr/b computed on device, zero host-sized
    arrays) must equal the host pipeline's stencil parts + b exactly."""
    import jax.numpy as jnp

    from domain_decomposed_pde_solver.ops.dia import pack_dia_host
    from domain_decomposed_pde_solver.ops.stencil import (
        stencil_parts_from_packed,
    )
    from domain_decomposed_pde_solver.solvers.precond.amg import (
        infer_free_grid,
    )

    mesh = box_mesh(nx, ny, nz, elem_type=et)
    sy = assemble_heat_system(mesh)
    dims = infer_free_grid(mesh, sy.free_to_node)
    uniq, data = pack_dia_host(sy.A, dtype=np.float32)
    ref_parts = stencil_parts_from_packed(uniq, data, sy.n_free, dims)
    assert ref_parts is not None

    out = structured_box_parts(nx, ny, nz, elem_type=et, device=device)
    assert out is not None
    parts = out["parts"]
    assert parts["taps"] == ref_parts["taps"]
    assert parts["dims"] == ref_parts["dims"]
    assert parts["period"] == ref_parts["period"]
    assert parts["groups"] == ref_parts["groups"]
    assert parts["group_const"] == ref_parts["group_const"]
    np.testing.assert_array_equal(parts["pats"], ref_parts["pats"])
    np.testing.assert_array_equal(
        parts["const_vals"], ref_parts["const_vals"]
    )
    np.testing.assert_array_equal(
        np.asarray(parts["corr_pad"]), ref_parts["corr_pad"]
    )
    # Device b == assembled b (padded), device degree == system degree.
    n = sy.n_free
    np.testing.assert_array_equal(
        np.asarray(out["b"])[:n], sy.b.astype(np.float32)
    )
    np.testing.assert_array_equal(
        np.asarray(out["degree"])[:n], sy.degree.astype(np.float32)
    )
    # And the operator built from the device parts IS the matrix.
    from domain_decomposed_pde_solver.ops.stencil import (
        stencil_from_parts,
    )

    op = stencil_from_parts(parts)
    x = np.random.default_rng(0).standard_normal(n).astype(np.float32)
    y = np.asarray(op.matvec(op.put_vector(x)))[:n]
    yref = sy.A.matvec(x.astype(np.float64))
    assert np.abs(y - yref).max() / np.abs(yref).max() < 1e-6


def test_lattice_tables_cached():
    t1 = box_lattice_tables("TETRA4")
    t2 = box_lattice_tables("TETRA4")
    assert t1 is t2
