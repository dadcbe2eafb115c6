"""Seeded mesh generator: published counts, valid conforming tets, seeds."""

import numpy as np
import pytest

from domain_decomposed_pde_solver.io.tetmesh import (
    REFERENCE_MESHES,
    delaunay_box_mesh,
    rectangle_tris_mesh,
)

# name -> (nodes, nodeset sizes or None, domain volume, block count)
PUBLISHED = {
    "tet-cube-heat.exo": (20539, (645, 645), 1.0, 1),
    "brick.exo": (1983, None, 2.0, 1),
    "lbracket.exo": (7531, None, 1.5, 1),
    "2blocks.exo": (34, None, 2.0, 2),
}


def _signed_volumes(mesh):
    conn = np.concatenate([b.conn for b in mesh.blocks]).astype(np.int64)
    p = mesh.coords[conn]
    vol = np.einsum(
        "ij,ij->i",
        np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]),
        p[:, 3] - p[:, 0],
    ) / 6.0
    return conn, vol


@pytest.mark.parametrize("name", sorted(PUBLISHED))
def test_generated_mesh_matches_published_shape(name):
    nodes, sets, volume, nblocks = PUBLISHED[name]
    mesh = REFERENCE_MESHES[name]()
    assert mesh.num_nodes == nodes
    assert len(mesh.blocks) == nblocks
    if sets is not None:
        assert tuple(ns.nodes.size for ns in mesh.node_sets) == sets
    conn, vol = _signed_volumes(mesh)
    # Every tet positively oriented, the tets tile the domain exactly, and
    # every node belongs to some tet.
    assert (vol > 0).all()
    np.testing.assert_allclose(vol.sum(), volume, rtol=1e-12)
    assert np.unique(conn).size == nodes
    # Conforming: no triangular face is shared by more than two tets.
    faces = np.sort(
        np.concatenate([conn[:, [0, 1, 2]], conn[:, [0, 1, 3]],
                        conn[:, [0, 2, 3]], conn[:, [1, 2, 3]]]),
        axis=1,
    )
    _, counts = np.unique(faces, axis=0, return_counts=True)
    assert counts.max() == 2


def test_generator_is_seeded():
    a = delaunay_box_mesh(300, face_nodes=30, seed=3)
    b = delaunay_box_mesh(300, face_nodes=30, seed=3)
    c = delaunay_box_mesh(300, face_nodes=30, seed=4)
    np.testing.assert_array_equal(a.coords, b.coords)
    np.testing.assert_array_equal(a.blocks[0].conn, b.blocks[0].conn)
    assert not np.array_equal(a.coords, c.coords)


def test_face_nodesets_lie_on_their_faces():
    mesh = delaunay_box_mesh(500, (2.0, 1.0, 1.0), face_nodes=40,
                             bc_faces=((0, 0.0), (0, 2.0)), seed=1)
    lo, hi = mesh.node_sets
    assert lo.nodes.size == hi.nodes.size == 40
    np.testing.assert_array_equal(mesh.coords[lo.nodes, 0], 0.0)
    np.testing.assert_array_equal(mesh.coords[hi.nodes, 0], 2.0)


def test_rectangle_toy_without_nodesets():
    mesh = rectangle_tris_mesh(nodesets=False)
    assert mesh.num_nodes == 9 and mesh.num_elem == 8
    assert not mesh.node_sets and len(mesh.side_sets) == 1
