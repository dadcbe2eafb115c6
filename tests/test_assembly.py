"""Assembly golden tests.

The vectorized assembly is checked against a *naive emulator* that follows
the reference's dict-of-sets algorithm literally (``ExodusIO.hpp:342-378,
:591-608, :671-687``): per-element double loops inserting into
``adjacency[u].insert(v)``, ascending-id nodeset scan with break for the
RHS.  Agreement on every bundled mesh is the parity evidence.
"""

import numpy as np
import pytest

from domain_decomposed_pde_solver.io import read_exodus
from domain_decomposed_pde_solver.models import (
    assemble_full_laplacian,
    assemble_heat_system,
)


def naive_assemble(mesh):
    """Literal reimplementation of the reference's assemble() on one rank."""
    n = mesh.num_nodes
    nodeset_map = {}  # id -> set of nodes, ascending id iteration like std::map
    for ns in mesh.node_sets:
        nodeset_map.setdefault(ns.id, set()).update(int(x) for x in ns.nodes)
    boundary = set().union(*nodeset_map.values()) if nodeset_map else set()

    free = [i for i in range(n) if i not in boundary]
    red = {g: i for i, g in enumerate(free)}

    adjacency = {}  # free node -> set of neighbor nodes (free or boundary)
    for blk in mesh.blocks:
        for elem in blk.conn:
            for k in elem:
                k = int(k)
                if k in boundary:
                    continue
                for l in elem:
                    l = int(l)
                    if l != k:
                        adjacency.setdefault(k, set()).add(l)

    nf = len(free)
    A = np.zeros((nf, nf))
    b = np.zeros(nf)
    for u, nbrs in adjacency.items():
        ru = red[u]
        A[ru, ru] = len(nbrs)  # total degree incl. boundary (ExodusIO.hpp:606)
        ssum = 0.0
        for v in nbrs:
            if v in boundary:
                # ascending-id scan with break (ExodusIO.hpp:675-682)
                for sid in sorted(nodeset_map):
                    if v in nodeset_map[sid]:
                        ssum += sid
                        break
            else:
                A[ru, red[v]] = -1.0
        b[ru] = ssum
    return A, b, np.array(free)


MESHES = [
    "rectangle-tris-boundary.exo",
    "2blocks.exo",
    "brick.exo",
    pytest.param("lbracket.exo", marks=pytest.mark.slow),
]


@pytest.mark.parametrize("name", MESHES)
def test_assembly_matches_naive_reference(data_dir, name):
    mesh = read_exodus(str(data_dir / name))
    sys_ = assemble_heat_system(mesh)
    A_naive, b_naive, free = naive_assemble(mesh)
    np.testing.assert_array_equal(sys_.free_to_node, free)
    np.testing.assert_allclose(sys_.A.to_dense(), A_naive)
    np.testing.assert_allclose(sys_.b, b_naive)


def test_toy_laplacian_hand_check(data_dir):
    """The 9-node mesh is small enough to check by hand (SURVEY §4)."""
    mesh = read_exodus(str(data_dir / "rectangle-tris-boundary.exo"))
    sys_ = assemble_heat_system(mesh)
    assert sys_.n_free == 3
    np.testing.assert_array_equal(sys_.free_to_node, [2, 3, 5])
    np.testing.assert_allclose(
        sys_.A.to_dense(),
        [[5.0, 0.0, -1.0], [0.0, 4.0, -1.0], [-1.0, -1.0, 5.0]],
    )
    np.testing.assert_allclose(sys_.b, [500.0, 450.0, 300.0])


def test_tet_cube_structure(data_dir):
    mesh = read_exodus(str(data_dir / "tet-cube-heat.exo"))
    sys_ = assemble_heat_system(mesh)
    # 20539 nodes, 2 nodesets x 645 distinct boundary nodes.
    assert sys_.n_free == 20539 - 2 * 645
    S = sys_.A.to_scipy()
    assert abs(S - S.T).max() == 0  # symmetric
    d = S.diagonal()
    assert (d > 0).all()
    # Diagonal dominance: diag = total degree >= free-neighbor count.
    offdiag_rowsum = np.asarray(abs(S).sum(axis=1)).ravel() - d
    assert (d >= offdiag_rowsum).all()
    # Rows adjacent to boundary are strictly dominant; with two 645-node
    # nodesets the RHS must have nonzeros.
    assert (sys_.b != 0).sum() > 0


def test_full_laplacian_rowsums_zero(data_dir):
    mesh = read_exodus(str(data_dir / "2blocks.exo"))
    L = assemble_full_laplacian(mesh)
    S = L.to_scipy()
    np.testing.assert_allclose(np.asarray(S.sum(axis=1)).ravel(), 0.0)
    assert abs(S - S.T).max() == 0


@pytest.mark.parametrize("name", ["tet-cube-heat.exo", "2blocks.exo",
                                  "brick.exo"])
def test_native_assembly_bit_identical_to_numpy(data_dir, name, monkeypatch):
    """The native single-scan assembly (ddps_native.cpp::assemble_reduced)
    must reproduce the vectorized NumPy path bit-for-bit: CSR structure,
    values, RHS, degree, and the boundary-edge lists."""
    import domain_decomposed_pde_solver.models.heat as heat

    mesh = read_exodus(str(data_dir / name))
    s_nat = heat.assemble_heat_system(mesh)
    monkeypatch.setattr(heat, "_adjacency_csr_native", lambda *a: None)
    s_np = heat.assemble_heat_system(mesh)
    np.testing.assert_array_equal(s_nat.A.indptr, s_np.A.indptr)
    np.testing.assert_array_equal(s_nat.A.indices, s_np.A.indices)
    np.testing.assert_array_equal(s_nat.A.data, s_np.A.data)
    np.testing.assert_array_equal(s_nat.b, s_np.b)
    np.testing.assert_array_equal(s_nat.degree, s_np.degree)
    # boundary edge lists: same multiset per row (order within a row may
    # differ between the scan and the masked-edge form)
    def key(r, c):
        return np.sort(r.astype(np.int64) * (mesh.num_nodes + 1) + c)

    np.testing.assert_array_equal(
        key(s_nat.bdry_rows, s_nat.bdry_cols),
        key(s_np.bdry_rows, s_np.bdry_cols),
    )
