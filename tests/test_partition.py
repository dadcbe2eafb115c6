"""Partitioner quality/determinism and decompose-writer tests."""

import numpy as np
import pytest

from domain_decomposed_pde_solver.io import read_exodus
from domain_decomposed_pde_solver.models import assemble_heat_system
from domain_decomposed_pde_solver.ops import coo_to_csr
from domain_decomposed_pde_solver.parallel import (
    build_dual_graph,
    decompose_mesh,
    edgecut,
    partition_graph,
    partition_mesh_elements,
    partition_rcb,
    partition_stats,
    refine_partition,
    write_decomposition,
)


def adjacency_of(system):
    A = system.A
    rows = np.repeat(np.arange(A.n_rows), A.row_lengths())
    off = rows != A.indices
    return coo_to_csr(
        rows[off], A.indices[off], np.ones(int(off.sum())), A.shape, sum_dups=False
    )


@pytest.mark.parametrize("nparts", [2, 3, 4, 8])
def test_rcb_balance_and_determinism(nparts):
    rng = np.random.default_rng(0)
    coords = rng.standard_normal((1000, 3))
    p1 = partition_rcb(coords, nparts)
    p2 = partition_rcb(coords, nparts)
    np.testing.assert_array_equal(p1, p2)  # deterministic
    sizes = np.bincount(p1, minlength=nparts)
    assert sizes.max() - sizes.min() <= max(2, nparts // 2)
    assert set(np.unique(p1)) == set(range(nparts))


def test_refinement_reduces_edgecut(data_dir):
    mesh = read_exodus(str(data_dir / "brick.exo"))
    sys_ = assemble_heat_system(mesh)
    adj = adjacency_of(sys_)
    coords = mesh.coords[sys_.free_to_node]
    p0 = partition_rcb(coords, 4)
    p1 = refine_partition(adj, p0, 4)
    assert edgecut(adj, p1) <= edgecut(adj, p0)
    sizes = np.bincount(p1, minlength=4)
    assert sizes.max() <= np.ceil(adj.n_rows / 4 * 1.05)


def test_partition_graph_without_coords(data_dir):
    mesh = read_exodus(str(data_dir / "brick.exo"))
    sys_ = assemble_heat_system(mesh)
    adj = adjacency_of(sys_)
    parts = partition_graph(adj, 4, coords=None)
    assert set(np.unique(parts)) <= set(range(4))
    st = partition_stats(adj, parts, 4)
    assert st.sizes.sum() == adj.n_rows


def test_dual_graph_toy(data_dir):
    """8-triangle rectangle: dual neighbors share an edge (2 nodes)."""
    mesh = read_exodus(str(data_dir / "rectangle-tris-boundary.exo"))
    dual = build_dual_graph(mesh)
    assert dual.shape == (8, 8)
    S = dual.to_scipy()
    assert abs(S - S.T).max() == 0
    # Each triangle has 1-3 edge-neighbors in a 2x2 quad split into tris.
    deg = np.asarray(S.sum(axis=1)).ravel()
    assert deg.min() >= 1 and deg.max() <= 3
    # Verify against brute force: count shared nodes >= 2.
    conn = mesh.blocks[0].conn
    for i in range(8):
        for j in range(8):
            if i == j:
                continue
            shared = len(set(conn[i]) & set(conn[j]))
            assert (S[i, j] != 0) == (shared >= 2)


def test_partition_mesh_elements_covers_all(data_dir):
    mesh = read_exodus(str(data_dir / "2blocks.exo"))
    parts = partition_mesh_elements(mesh, 3)
    assert parts.shape == (mesh.num_elem,)
    assert set(np.unique(parts)) <= set(range(3))


def test_decompose_roundtrip(data_dir, tmp_path):
    """Block-per-partition output must preserve every element and node."""
    mesh = read_exodus(str(data_dir / "brick.exo"))
    out = str(tmp_path / "decomp.exo")
    dec = write_decomposition(out, mesh, 4)
    back = read_exodus(out)
    assert back.num_nodes == mesh.num_nodes
    assert back.num_elem == mesh.num_elem
    assert len(back.blocks) >= 2  # nonempty partitions become blocks
    np.testing.assert_allclose(back.coords, mesh.coords)
    # Every original element's node set must appear exactly once.
    def elem_keys(m):
        keys = []
        for b in m.blocks:
            keys.append(np.sort(b.conn, axis=1))
        return np.sort(np.concatenate(keys, axis=0), axis=0)

    np.testing.assert_array_equal(
        np.sort(elem_keys(mesh), axis=0), np.sort(elem_keys(back), axis=0)
    )
    # Nodesets copied verbatim.
    for a, b in zip(mesh.node_sets, back.node_sets):
        assert a.id == b.id
        np.testing.assert_array_equal(np.sort(a.nodes), np.sort(b.nodes))
    # Sidesets remapped: same (element-node-set, side) pairs.
    assert len(back.side_sets) == len(mesh.side_sets)


def test_decompose_partition_blocks_disjoint(data_dir, tmp_path):
    mesh = read_exodus(str(data_dir / "2blocks.exo"))
    dec = decompose_mesh(mesh, 2)
    total = sum(b.num_elem for b in dec.blocks)
    assert total == mesh.num_elem
