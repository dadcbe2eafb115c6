"""Seeded unstructured test meshes (Delaunay tets) and the 9-node toy.

These stand in for the reference's bundled Exodus inputs (SURVEY §2.3).
The generated meshes match the published node and nodeset counts exactly;
element counts follow from the triangulation.

Construction of the 3-D meshes: a lattice of spacing ``h`` over the domain's
bounding box, each coordinate jittered by up to ``0.3 h`` unless it lies on
a domain plane (outer faces and, for the L-bracket, the re-entrant faces),
so face nodes stay exactly on their faces.  Seeded random nodes are dropped
until each Dirichlet face and the whole mesh hit their target counts (box
corners are never dropped).  ``scipy.spatial.Delaunay`` then triangulates
each convex box of the domain (one for a box, three for the L-bracket), and
flat tets (zero volume, from coplanar face nodes) are removed.

Shapes assumed where the published counts say nothing (the reference meshes
are not available):

- ``tet-cube-heat``: unit cube; nodesets 100 on x=0 and 1000 on x=1,
  645 nodes each; 20,539 nodes.
- ``brick``: 2 x 1 x 1 box; nodesets 100 on x=0 and 1000 on x=2 (every
  lattice node on those faces); 1,983 nodes.
- ``lbracket``: 2 x 2 x 0.5 box minus the notch ``x > 1, y > 1``;
  nodesets 100 on x=0 and 1000 on y=0 (every lattice node on those faces);
  7,531 nodes.
- ``2blocks``: 2 x 1 x 1 box with tets split into blocks 1 (centroid
  x < 1) and 2; nodesets 100 on x=0 and 1000 on x=2; 34 nodes.
- ``rectangle-tris-boundary``: the 9-node, 8-triangle 2-D toy whose
  reduced system is free nodes [2, 3, 5], ``A = [[5,0,-1],[0,4,-1],
  [-1,-1,5]]``, ``b = [500, 450, 300]``; nodesets 50 = {0, 1, 4} and
  200 = {6, 7, 8}; one sideset over the 8 perimeter edges (shell side
  numbers, as in a 2-D mesh written with 3-D coordinates).
  ``rectangle-tris`` is the same mesh with no nodesets.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from .mesh import ElemBlock, MeshModel, NodeSet, SideSet

__all__ = [
    "delaunay_box_mesh",
    "tet_cube_heat_mesh",
    "brick_mesh",
    "lbracket_mesh",
    "two_blocks_mesh",
    "rectangle_tris_mesh",
    "REFERENCE_MESHES",
    "write_reference_meshes",
]


def _lattice(extent, h, notch):
    axes = [np.linspace(0.0, e, int(round(e / h)) + 1) for e in extent]
    g = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, 3)
    if notch is not None:
        nx, ny = notch
        g = g[~((g[:, 0] > nx + 1e-12) & (g[:, 1] > ny + 1e-12))]
    return g


def delaunay_box_mesh(
    num_nodes: int,
    extent: Sequence[float] = (1.0, 1.0, 1.0),
    face_nodes: Optional[int] = None,
    *,
    notch: Optional[Tuple[float, float]] = None,
    bc_faces: Tuple[Tuple[int, float], Tuple[int, float]] = ((0, 0.0), (0, 1.0)),
    bc_ids: Tuple[int, int] = (100, 1000),
    block_split_x: Optional[float] = None,
    seed: int = 0,
    title: str = "generated Delaunay tet mesh",
) -> MeshModel:
    """Jittered-lattice Delaunay TETRA4 mesh with exactly ``num_nodes`` nodes.

    ``bc_faces``: two ``(axis, value)`` planes carrying nodesets
    ``bc_ids``; with ``face_nodes`` each holds exactly that many nodes,
    otherwise every lattice node on the plane.  ``notch=(x0, y0)`` removes
    ``x > x0, y > y0`` (an L-shaped domain).  ``block_split_x`` splits the
    tets into two element blocks at that x (by centroid).
    """
    from scipy.spatial import Delaunay

    extent = np.asarray(extent, dtype=np.float64)
    planes = [(a, 0.0) for a in range(3)] + [(a, float(extent[a])) for a in range(3)]
    if notch is not None:
        planes += [(0, float(notch[0])), (1, float(notch[1]))]

    # Coarsest lattice (k cells per unit length, so unit-spaced planes such
    # as the notch are lattice planes) that covers the target counts.
    k = 1
    while True:
        h = 1.0 / k
        pts = _lattice(extent, h, notch)
        on_face = [np.isclose(pts[:, a], v) for a, v in bc_faces]
        need_face = face_nodes or 0
        if len(pts) >= num_nodes and all(m.sum() >= need_face for m in on_face):
            break
        k += 1

    # A coordinate on a domain plane is never jittered; a node on a plane in
    # every axis is a corner of a convex piece and is never dropped.
    frozen = np.zeros(pts.shape, dtype=bool)
    for a, v in planes:
        frozen[:, a] |= np.isclose(pts[:, a], v)
    corner = frozen.all(axis=1)
    rng = np.random.default_rng(seed)
    keep = np.ones(len(pts), dtype=bool)
    if face_nodes is not None:
        for m in on_face:
            cand = np.flatnonzero(m & ~corner)
            n_drop = int(m.sum()) - face_nodes
            keep[rng.choice(cand, size=n_drop, replace=False)] = False
    on_any_face = np.logical_or.reduce(on_face)
    cand = np.flatnonzero(keep & ~on_any_face & ~corner)
    n_drop = int(keep.sum()) - num_nodes
    if n_drop < 0 or n_drop > cand.size:
        raise ValueError("lattice cannot meet the requested node counts")
    keep[rng.choice(cand, size=n_drop, replace=False)] = False
    pts, frozen = pts[keep], frozen[keep]
    on_face = [m[keep] for m in on_face]
    jit = rng.uniform(-0.3 * h, 0.3 * h, size=pts.shape)
    coords = np.where(frozen, pts, pts + jit)

    # Triangulate each convex box on its own.  Boxes meet in whole faces,
    # and both sides reproduce the 2-D Delaunay of a shared face's nodes,
    # so the pieces conform.
    if notch is None:
        pieces = [np.arange(len(coords))]
    else:
        lo_x = pts[:, 0] <= notch[0] + 1e-12
        lo_y = pts[:, 1] <= notch[1] + 1e-12
        hi_x = pts[:, 0] >= notch[0] - 1e-12
        hi_y = pts[:, 1] >= notch[1] - 1e-12
        pieces = [np.flatnonzero(lo_x & lo_y), np.flatnonzero(lo_x & hi_y),
                  np.flatnonzero(hi_x & lo_y)]
    tets = np.concatenate(
        [idx[Delaunay(coords[idx]).simplices] for idx in pieces]
    ).astype(np.int64)
    p = coords[tets]
    vol = np.einsum(
        "ij,ij->i",
        np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]),
        p[:, 3] - p[:, 0],
    ) / 6.0
    keep_t = np.abs(vol) > 1e-9 * h**3
    cen = p.mean(axis=1)
    tets, vol, cen = tets[keep_t], vol[keep_t], cen[keep_t]
    # Positive orientation (Exodus TETRA4 convention).
    neg = vol < 0
    tets[neg] = tets[neg][:, [0, 2, 1, 3]]
    if np.unique(tets).size != num_nodes:
        raise ValueError("triangulation left nodes outside every element")

    conn = tets.astype(np.int32)
    if block_split_x is None:
        blocks = [ElemBlock(id=1, elem_type="TETRA4", conn=conn, name="block_1")]
    else:
        left = cen[:, 0] < block_split_x
        blocks = [
            ElemBlock(id=1, elem_type="TETRA4", conn=conn[left], name="block_1"),
            ElemBlock(id=2, elem_type="TETRA4", conn=conn[~left], name="block_2"),
        ]
    node_sets = [
        NodeSet(id=int(i), nodes=np.flatnonzero(m).astype(np.int64), name=f"ns{i}")
        for i, m in zip(bc_ids, on_face)
    ]
    mesh = MeshModel(
        coords=coords, blocks=blocks, node_sets=node_sets, title=title, num_dim=3
    )
    mesh.validate()
    return mesh


def tet_cube_heat_mesh(seed: int = 0) -> MeshModel:
    """Unit cube, 20,539 nodes, nodesets 100 / 1000 of 645 nodes each."""
    return delaunay_box_mesh(20539, (1.0, 1.0, 1.0), face_nodes=645, seed=seed,
                             title="tet-cube-heat")


def brick_mesh(seed: int = 0) -> MeshModel:
    """2 x 1 x 1 brick, 1,983 nodes, nodesets 100 (x=0) / 1000 (x=2)."""
    return delaunay_box_mesh(1983, (2.0, 1.0, 1.0),
                             bc_faces=((0, 0.0), (0, 2.0)), seed=seed,
                             title="brick")


def lbracket_mesh(seed: int = 0) -> MeshModel:
    """L-bracket (2 x 2 x 0.5 minus ``x > 1, y > 1``), 7,531 nodes,
    nodesets 100 (x=0) / 1000 (y=0)."""
    return delaunay_box_mesh(7531, (2.0, 2.0, 0.5), notch=(1.0, 1.0),
                             bc_faces=((0, 0.0), (1, 0.0)), seed=seed,
                             title="lbracket")


def two_blocks_mesh(seed: int = 0) -> MeshModel:
    """2 x 1 x 1 box, 34 nodes, two element blocks split at x = 1."""
    return delaunay_box_mesh(34, (2.0, 1.0, 1.0),
                             bc_faces=((0, 0.0), (0, 2.0)),
                             block_split_x=1.0, seed=seed, title="2blocks")


def rectangle_tris_mesh(nodesets: bool = True) -> MeshModel:
    """The 9-node, 8-triangle 2-D toy on a 3 x 3 node grid.

    Node layout (row y=2 on top)::

        0 --- 2 --- 6
        | \\   | \\   |
        1 --- 5 --- 7
        |   / | \\   |
        4 --- 3 --- 8
    """
    # x, y and z = 0: the 2-D mesh in 3-D space, as mesh generators write it.
    coords = np.array(
        [
            [0.0, 2.0, 0.0], [0.0, 1.0, 0.0], [1.0, 2.0, 0.0],
            [1.0, 0.0, 0.0], [0.0, 0.0, 0.0], [1.0, 1.0, 0.0],
            [2.0, 2.0, 0.0], [2.0, 1.0, 0.0], [2.0, 0.0, 0.0],
        ]
    )
    conn = np.array(
        [
            [0, 1, 2], [1, 5, 2],  # top-left square, diagonal 1-2
            [2, 7, 6], [2, 5, 7],  # top-right, diagonal 2-7
            [4, 3, 5], [4, 5, 1],  # bottom-left, diagonal 4-5
            [3, 8, 7], [3, 7, 5],  # bottom-right, diagonal 3-7
        ],
        dtype=np.int32,
    )
    # Perimeter edges as (element, 1-based side).  In a 3-D file TRI3 sides
    # follow the shell numbering: sides 1-2 are faces, side k+2 joins local
    # nodes k-1 and k (mod 3).
    perim = [(0, 3), (0, 5), (2, 5), (2, 4), (4, 3), (5, 5), (6, 3), (6, 4)]
    side_sets = [
        SideSet(
            id=1,
            elems=np.array([e for e, _ in perim], dtype=np.int64),
            sides=np.array([s for _, s in perim], dtype=np.int64),
            name="perimeter",
        )
    ]
    node_sets = (
        [
            NodeSet(id=50, nodes=np.array([4, 0, 1]), name="left"),
            NodeSet(id=200, nodes=np.array([8, 6, 7]), name="right"),
        ]
        if nodesets
        else []
    )
    mesh = MeshModel(
        coords=coords,
        blocks=[ElemBlock(id=1, elem_type="TRI3", conn=conn, name="block_1")],
        node_sets=node_sets,
        side_sets=side_sets,
        title="rectangle-tris-boundary" if nodesets else "rectangle-tris",
        num_dim=3,
    )
    mesh.validate()
    return mesh


REFERENCE_MESHES: Dict[str, Callable[[], MeshModel]] = {
    "rectangle-tris-boundary.exo": lambda: rectangle_tris_mesh(True),
    "rectangle-tris.exo": lambda: rectangle_tris_mesh(False),
    "2blocks.exo": two_blocks_mesh,
    "brick.exo": brick_mesh,
    "lbracket.exo": lbracket_mesh,
    "tet-cube-heat.exo": tet_cube_heat_mesh,
}


def write_reference_meshes(directory: str, names=None) -> Dict[str, str]:
    """Write the generated meshes as Exodus files; returns name -> path."""
    from .exodus import write_exodus

    os.makedirs(directory, exist_ok=True)
    out = {}
    for name in names or REFERENCE_MESHES:
        path = os.path.join(directory, name)
        write_exodus(path, REFERENCE_MESHES[name]())
        out[name] = path
    return out
