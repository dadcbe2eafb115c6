"""Box-mesh generator, sideset resolution, and node-ownership tests."""

import numpy as np
import pytest

from domain_decomposed_pde_solver.io import (
    box_mesh,
    nodesets_from_sidesets,
    read_exodus,
    side_local_nodes,
    sideset_nodes,
)
from domain_decomposed_pde_solver.models import assemble_heat_system
from domain_decomposed_pde_solver.parallel import (
    node_ownership_from_element_partition,
    partition_mesh_elements,
)


@pytest.mark.parametrize("et", ["HEX8", "TETRA4"])
def test_box_mesh_structure(et):
    m = box_mesh(4, 3, 2, elem_type=et)
    assert m.num_nodes == 5 * 4 * 3
    ncells = 4 * 3 * 2
    assert m.num_elem == (ncells if et == "HEX8" else 5 * ncells)
    m.validate()
    # Nodeset faces: (ny+1)(nz+1) nodes each.
    assert m.node_sets[0].nodes.size == 4 * 3
    assert m.node_sets[1].nodes.size == 4 * 3
    np.testing.assert_allclose(m.coords[m.node_sets[0].nodes, 0], 0.0)
    np.testing.assert_allclose(m.coords[m.node_sets[1].nodes, 0], 1.0)


def test_box_tet_mesh_is_conformal():
    """The 5-tet split must produce a connected, solvable Laplacian: CG on it
    must reach a solution bounded by the BC values (maximum principle)."""
    m = box_mesh(6, 6, 6, elem_type="TETRA4")
    s = assemble_heat_system(m)
    import scipy.sparse.linalg as spla

    x = spla.spsolve(s.A.to_scipy().tocsc(), s.b)
    assert x.min() >= 100.0 - 1e-8 and x.max() <= 1000.0 + 1e-8


def test_side_local_nodes_tables():
    assert side_local_nodes("TETRA4", 1) == (0, 1, 3)
    assert side_local_nodes("TETRA", 4) == (0, 2, 1)
    assert side_local_nodes("HEX8", 6) == (4, 5, 6, 7)
    assert side_local_nodes("TRI3", 3) == (2, 0)
    with pytest.raises(ValueError):
        side_local_nodes("TETRA4", 5)


def test_sideset_nodes_rectangle(data_dir):
    """The rectangle mesh's single sideset covers the whole outer boundary;
    its resolved nodes must be exactly the 8 perimeter nodes (all but the
    center node of the 3x3 grid)."""
    mesh = read_exodus(str(data_dir / "rectangle-tris-boundary.exo"))
    ss = mesh.side_sets[0]
    nodes = sideset_nodes(mesh, ss)
    # Identify the interior node by coordinates (center of the 3x3 grid).
    c = mesh.coords[:, :2]
    center = np.argmin(((c - c.mean(axis=0)) ** 2).sum(axis=1))
    expected = np.setdiff1d(np.arange(9), [center])
    np.testing.assert_array_equal(nodes, expected)


def test_nodesets_from_sidesets_assembly(data_dir):
    """BASELINE config 2: 2D heat with Dirichlet *sideset* BCs — resolving
    sidesets to nodesets and assembling must give a solvable SPD system."""
    mesh = read_exodus(str(data_dir / "rectangle-tris.exo"))  # no nodesets
    assert not mesh.node_sets and mesh.side_sets  # precondition of the test
    m2 = nodesets_from_sidesets(mesh, values={mesh.side_sets[0].id: 77})
    s = assemble_heat_system(m2)
    assert 0 < s.n_free < mesh.num_nodes
    x = np.linalg.solve(s.A.to_dense(), s.b)
    # Constant-BC harmonic solution is the constant.
    np.testing.assert_allclose(x, 77.0, rtol=1e-10)


def test_node_ownership_frequency_rule(data_dir):
    mesh = read_exodus(str(data_dir / "2blocks.exo"))
    parts = partition_mesh_elements(mesh, 3)
    owner = node_ownership_from_element_partition(mesh, parts, 3)
    assert owner.shape == (mesh.num_nodes,)
    assert set(np.unique(owner)) <= {0, 1, 2}
    # Brute-force check the rule on every node.
    freq = np.zeros((mesh.num_nodes, 3), dtype=int)
    off = mesh.global_elem_offsets()
    for b, o in zip(mesh.blocks, off):
        for e, elem in enumerate(b.conn):
            for nd in elem:
                freq[nd, parts[o + e]] += 1
    for nd in range(mesh.num_nodes):
        best = np.flatnonzero(freq[nd] == freq[nd].max())[0]
        assert owner[nd] == best
