"""Exodus-II reader/writer tests against the generated reference meshes."""

import numpy as np
import pytest
from scipy.io import netcdf_file

from domain_decomposed_pde_solver.io import (
    ExodusSolutionWriter,
    read_exodus,
    read_nodal_vars,
    write_exodus,
)

MESHES = [
    "rectangle-tris-boundary.exo",
    "rectangle-tris.exo",
    "2blocks.exo",
    "brick.exo",
    "lbracket.exo",
    "tet-cube-heat.exo",
]


@pytest.mark.parametrize("name", MESHES)
def test_read_matches_netcdf_header(data_dir, name):
    path = str(data_dir / name)
    mesh = read_exodus(path)
    nc = netcdf_file(path, "r", mmap=False)
    try:
        assert mesh.num_nodes == int(nc.dimensions["num_nodes"])
        assert mesh.num_elem == int(nc.dimensions.get("num_elem", 0) or 0)
        assert len(mesh.blocks) == int(nc.dimensions.get("num_el_blk", 0) or 0)
        assert len(mesh.node_sets) == int(nc.dimensions.get("num_node_sets", 0) or 0)
        assert len(mesh.side_sets) == int(nc.dimensions.get("num_side_sets", 0) or 0)
        for i, b in enumerate(mesh.blocks, start=1):
            assert b.num_elem == int(nc.dimensions[f"num_el_in_blk{i}"])
            assert b.nodes_per_elem == int(nc.dimensions[f"num_nod_per_el{i}"])
    finally:
        nc.close()
    mesh.validate()


@pytest.mark.parametrize("name", ["rectangle-tris-boundary.exo", "2blocks.exo", "brick.exo"])
def test_roundtrip(data_dir, tmp_path, name):
    mesh = read_exodus(str(data_dir / name))
    out = str(tmp_path / "rt.exo")
    write_exodus(out, mesh)
    m2 = read_exodus(out)
    np.testing.assert_allclose(mesh.coords, m2.coords)
    assert len(mesh.blocks) == len(m2.blocks)
    for b1, b2 in zip(mesh.blocks, m2.blocks):
        assert b1.id == b2.id and b1.elem_type == b2.elem_type
        np.testing.assert_array_equal(b1.conn, b2.conn)
    for s1, s2 in zip(mesh.node_sets, m2.node_sets):
        assert s1.id == s2.id
        np.testing.assert_array_equal(s1.nodes, s2.nodes)
    for s1, s2 in zip(mesh.side_sets, m2.side_sets):
        assert s1.id == s2.id
        np.testing.assert_array_equal(s1.elems, s2.elems)
        np.testing.assert_array_equal(s1.sides, s2.sides)
    np.testing.assert_array_equal(mesh.node_id_map, m2.node_id_map)


def test_solution_writer_contract(data_dir, tmp_path):
    """Timestep 0 must be the boundary snapshot (node value = nodeset id,
    ``ExodusIO.hpp:1979-1989, :2030-2040``); later steps carry solutions."""
    mesh = read_exodus(str(data_dir / "rectangle-tris-boundary.exo"))
    out = str(tmp_path / "sol.exo")
    free = np.array([2, 3, 5])
    with ExodusSolutionWriter(out, mesh) as w:
        w.write_solution(np.array([1.5, 2.5, 3.5]), free, 0)
        w.write_solution(np.array([1.0, 2.0, 3.0]), free, 1)
    names, times, vals = read_nodal_vars(out)
    assert names == ["Steady-State Heat Solution"]
    np.testing.assert_allclose(times, [0.0, 0.0, 1.0])
    # Boundary snapshot: nodesets 50 -> {4,0,1}, 200 -> {8,6,7}; free = 0.
    expected0 = np.zeros(9)
    expected0[[4, 0, 1]] = 50.0
    expected0[[8, 6, 7]] = 200.0
    np.testing.assert_allclose(vals[0, 0], expected0)
    # Solutions scattered to free nodes, boundary values retained.
    assert vals[1, 0, 2] == 1.5 and vals[2, 0, 2] == 1.0
    assert vals[2, 0, 4] == 50.0 and vals[2, 0, 8] == 200.0


def test_boundary_tiebreaks(data_dir):
    """Smallest nodeset id feeds the RHS; largest wins the timestep-0 write."""
    mesh = read_exodus(str(data_dir / "rectangle-tris-boundary.exo"))
    # Inject an overlapping nodeset artificially.
    from domain_decomposed_pde_solver.io.mesh import NodeSet

    mesh.node_sets.append(NodeSet(id=7, nodes=np.array([4])))
    is_b, bval = mesh.boundary_value_per_node()
    assert bval[4] == 7.0  # min id (7 < 50): RHS tie-break (ExodusIO.hpp:675-682)
    wvals = mesh.boundary_write_values()
    assert wvals[4] == 50.0  # max id: write tie-break (ExodusIO.hpp:1979-1989)


@pytest.mark.parametrize("name", MESHES)
def test_every_input_mesh_reads_and_assembles(data_dir, name):
    """Coverage sweep: every generated input mesh must read, validate, and
    assemble (matching the reference's any-mesh robustness; meshes without
    nodesets produce a full-DOF system with zero RHS)."""
    import warnings

    from domain_decomposed_pde_solver.models import assemble_heat_system

    mesh = read_exodus(str(data_dir / name))
    mesh.validate()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # nodeset-free mesh: singular
        sys_ = assemble_heat_system(mesh)
    assert sys_.A.n_rows == sys_.n_free
    assert np.isfinite(sys_.b).all()
    if mesh.node_sets:
        assert sys_.n_free < mesh.num_nodes
        assert (sys_.b != 0).any()
    else:
        assert sys_.n_free == mesh.num_nodes
        assert not sys_.b.any()


def test_multiblock_multinodeset_mesh(data_dir, tmp_path):
    """2blocks.exo plus two overlapping nodesets: 2 TETRA blocks + 4
    nodesets, written and read back, assembles to a symmetric, diagonally
    dominant system."""
    from domain_decomposed_pde_solver.io.mesh import NodeSet
    from domain_decomposed_pde_solver.models import assemble_heat_system

    mesh = read_exodus(str(data_dir / "2blocks.exo"))
    low_y = np.flatnonzero(mesh.coords[:, 1] == 0.0)
    high_z = np.flatnonzero(mesh.coords[:, 2] == 1.0)
    mesh.node_sets += [NodeSet(id=300, nodes=low_y), NodeSet(id=500, nodes=high_z)]
    write_exodus(str(tmp_path / "tm.exo"), mesh)
    mesh = read_exodus(str(tmp_path / "tm.exo"))
    assert len(mesh.blocks) == 2 and len(mesh.node_sets) == 4
    sys_ = assemble_heat_system(mesh)
    S = sys_.A.to_scipy()
    assert abs(S - S.T).max() == 0
    d = S.diagonal()
    offdiag = np.asarray(abs(S).sum(axis=1)).ravel() - d
    assert (d >= offdiag).all()


class TestCorruptFiles:
    """Reader robustness: corrupt/truncated inputs raise one predictable
    exception type (ExodusReadError) that names the file; a missing file
    stays FileNotFoundError."""

    def _good_bytes(self, tmp_path):
        from domain_decomposed_pde_solver.io import box_mesh, write_exodus

        p = tmp_path / "good.exo"
        write_exodus(str(p), box_mesh(4, 4, 4, elem_type="TETRA4"))
        return p.read_bytes()

    @pytest.mark.parametrize(
        "mangle",
        [
            lambda b: b"",
            lambda b: b"not a netcdf file" * 8,
            lambda b: b[:20],
            lambda b: b[: len(b) // 2],
            lambda b: b"XDF" + b[3:],
        ],
        ids=["empty", "garbage", "truncated-header", "truncated-body",
             "bad-magic"],
    )
    def test_corrupt_raises_exodus_read_error(self, tmp_path, mangle):
        from domain_decomposed_pde_solver.io import (
            ExodusReadError,
            read_exodus,
        )

        p = tmp_path / "bad.exo"
        p.write_bytes(mangle(self._good_bytes(tmp_path)))
        with pytest.raises(ExodusReadError) as exc:
            read_exodus(str(p))
        assert "bad.exo" in str(exc.value)

    def test_missing_file_raises_file_not_found(self, tmp_path):
        from domain_decomposed_pde_solver.io import read_exodus

        with pytest.raises(FileNotFoundError):
            read_exodus(str(tmp_path / "missing.exo"))

    def test_nodeset_free_mesh_warns_singular(self):
        import warnings

        from domain_decomposed_pde_solver.io import box_mesh
        from domain_decomposed_pde_solver.models import (
            assemble_heat_system,
        )

        mesh = box_mesh(4, 4, 4, elem_type="TETRA4")
        mesh.node_sets = []
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            assemble_heat_system(mesh)
        assert any("singular" in str(x.message) for x in w)


def test_read_exodus_partial_covers_full_mesh(data_dir):
    """Union of all parts' element slices == the full mesh; node ids and
    coordinates of every referenced node match the full read."""
    from domain_decomposed_pde_solver.io import (
        read_exodus,
        read_exodus_partial,
    )

    path = str(data_dir / "tet-cube-heat.exo")
    full = read_exodus(path)
    all_conn = np.concatenate([b.conn for b in full.blocks])
    nparts = 4
    got = []
    total = 0
    for p in range(nparts):
        sl = read_exodus_partial(path, p, nparts)
        assert sl.num_elem_global == all_conn.shape[0]
        lo, hi = sl.elem_range
        total += hi - lo
        for b in sl.blocks:
            got.append(b.conn)
        # Coordinates of referenced nodes match the full read.
        np.testing.assert_allclose(sl.coords, full.coords[sl.node_ids])
    assert total == all_conn.shape[0]
    np.testing.assert_array_equal(np.concatenate(got), all_conn)


def test_read_exodus_partial_multiblock(data_dir):
    """Element slicing crosses block boundaries correctly (2blocks.exo)."""
    from domain_decomposed_pde_solver.io import (
        read_exodus,
        read_exodus_partial,
    )

    path = str(data_dir / "2blocks.exo")
    full = read_exodus(path)
    all_conn = np.concatenate([b.conn for b in full.blocks])
    parts = [read_exodus_partial(path, p, 3) for p in range(3)]
    got = np.concatenate(
        [b.conn for sl in parts for b in sl.blocks]
    )
    np.testing.assert_array_equal(got, all_conn)
    # The middle slice should straddle the two blocks.
    assert any(len(sl.blocks) == 2 for sl in parts) or len(full.blocks) == 1
