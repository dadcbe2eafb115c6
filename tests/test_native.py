"""Native C++ kernel tests: must agree exactly with the NumPy fallbacks."""

import os

import numpy as np
import pytest

from domain_decomposed_pde_solver.io import read_exodus
from domain_decomposed_pde_solver.utils.native import (
    aggregate_greedy_native,
    dual_graph_native,
    native_available,
    node_adjacency_native,
    pack_ell_native,
    rcm_order_native,
)

pytestmark = pytest.mark.skipif(
    not native_available(), reason="native library unavailable (no toolchain)"
)


def numpy_edges(conn, n):
    npe = conn.shape[1]
    k, l = np.nonzero(~np.eye(npe, dtype=bool))
    u = conn[:, k].reshape(-1).astype(np.int64)
    v = conn[:, l].reshape(-1).astype(np.int64)
    keys = np.unique(u * n + v)
    return keys // n, keys % n


def test_node_adjacency_matches_numpy(data_dir):
    mesh = read_exodus(str(data_dir / "brick.exo"))
    conn = mesh.blocks[0].conn
    n = mesh.num_nodes
    indptr, indices = node_adjacency_native(conn, n)
    u_np, v_np = numpy_edges(conn, n)
    u_na = np.repeat(np.arange(n), np.diff(indptr))
    np.testing.assert_array_equal(u_na, u_np)
    np.testing.assert_array_equal(indices, v_np)


def test_dual_graph_matches_bruteforce(data_dir):
    mesh = read_exodus(str(data_dir / "rectangle-tris-boundary.exo"))
    conn = mesh.blocks[0].conn
    indptr, indices = dual_graph_native(conn, mesh.num_nodes, 2)
    for i in range(conn.shape[0]):
        nbrs = set(indices[indptr[i] : indptr[i + 1]].tolist())
        expected = {
            j
            for j in range(conn.shape[0])
            if j != i and len(set(conn[i]) & set(conn[j])) >= 2
        }
        assert nbrs == expected


def test_aggregate_greedy_matches_python(data_dir):
    os.environ["DDPS_NO_NATIVE"] = "1"
    try:
        # Force the Python path via a fresh import state.
        from domain_decomposed_pde_solver.models import assemble_heat_system
        from domain_decomposed_pde_solver.solvers.precond import amg as amg_mod

        mesh = read_exodus(str(data_dir / "brick.exo"))
        sys_ = assemble_heat_system(mesh)
        # Python reference (explicit re-implementation of the 3 passes).
        A = sys_.A
        indptr, indices = A.indptr, A.indices
        rows = np.repeat(np.arange(A.n_rows), A.row_lengths())
        strong = rows != indices
        s_counts = np.bincount(rows[strong], minlength=A.n_rows)
        s_indptr = np.concatenate([[0], np.cumsum(s_counts)]).astype(np.int64)
        s_indices = indices[strong]
    finally:
        del os.environ["DDPS_NO_NATIVE"]
    agg_native, n_agg = aggregate_greedy_native(s_indptr, s_indices, A.n_rows)

    agg_py = np.full(A.n_rows, -1, dtype=np.int64)
    nxt = 0
    for i in range(A.n_rows):
        if agg_py[i] != -1:
            continue
        nb = s_indices[s_indptr[i] : s_indptr[i + 1]]
        if (agg_py[nb] == -1).all():
            agg_py[i] = nxt
            agg_py[nb] = nxt
            nxt += 1
    for i in range(A.n_rows):
        if agg_py[i] != -1:
            continue
        nb = s_indices[s_indptr[i] : s_indptr[i + 1]]
        hit = nb[agg_py[nb] != -1]
        if hit.size:
            agg_py[i] = agg_py[hit[0]]
    for i in range(A.n_rows):
        if agg_py[i] == -1:
            agg_py[i] = nxt
            nxt += 1
    np.testing.assert_array_equal(agg_native, agg_py)
    assert n_agg == nxt


def test_rcm_reduces_bandwidth(data_dir):
    from domain_decomposed_pde_solver.models import assemble_heat_system

    mesh = read_exodus(str(data_dir / "brick.exo"))
    sys_ = assemble_heat_system(mesh)
    A = sys_.A
    rows = np.repeat(np.arange(A.n_rows), A.row_lengths())
    off = rows != A.indices
    perm = rcm_order_native(A.indptr, A.indices, A.n_rows)
    assert sorted(perm.tolist()) == list(range(A.n_rows))  # a permutation
    inv = np.zeros_like(perm)
    inv[perm] = np.arange(A.n_rows)
    bw_orig = int(np.abs(rows[off] - A.indices[off]).max())
    bw_rcm = int(np.abs(inv[rows[off]] - inv[A.indices[off]]).max())
    assert bw_rcm < bw_orig


def test_pack_ell_matches_scatter(data_dir):
    from domain_decomposed_pde_solver.models import assemble_heat_system

    mesh = read_exodus(str(data_dir / "2blocks.exo"))
    # 2blocks has no nodesets -> full Laplacian over all nodes
    from domain_decomposed_pde_solver.models import assemble_full_laplacian

    A = assemble_full_laplacian(mesh)
    n_pad, K = 40, A.max_row_nnz
    cols, vals = pack_ell_native(A.indptr, A.indices, A.data, A.n_rows, n_pad, K, np.float64)
    lens = A.row_lengths()
    rows = np.repeat(np.arange(A.n_rows), lens)
    slot = np.arange(A.nnz) - np.repeat(A.indptr[:-1], lens)
    cols_ref = np.zeros((n_pad, K), np.int32)
    vals_ref = np.zeros((n_pad, K), np.float64)
    cols_ref[rows, slot] = A.indices
    vals_ref[rows, slot] = A.data
    np.testing.assert_array_equal(cols, cols_ref)
    np.testing.assert_array_equal(vals, vals_ref)


def test_rap_single_pass_matches_scipy():
    import scipy.sparse as sp

    from domain_decomposed_pde_solver.utils.native import (
        native_available, rap_galerkin_native)

    if not native_available():
        import pytest

        pytest.skip("native library unavailable")
    rng_a = sp.random(400, 400, density=0.02, random_state=1, format="csr")
    A = (rng_a + rng_a.T).tocsr()
    A.setdiag(A.diagonal() + 5.0)
    A.sort_indices()
    P = sp.random(400, 50, density=0.05, random_state=2, format="csr")
    P.sort_indices()
    Cp, Ci, Cx = rap_galerkin_native(
        A.indptr, A.indices, A.data, P.indptr, P.indices, P.data, 400, 50
    )
    ref = (P.T @ A @ P).tocsr()
    ref.sort_indices()
    np.testing.assert_array_equal(Cp, ref.indptr)
    np.testing.assert_array_equal(Ci, ref.indices)
    np.testing.assert_allclose(Cx, ref.data, rtol=1e-12)


def test_gershgorin_bound_contains_lmax():
    import scipy.sparse as sp

    from domain_decomposed_pde_solver.utils.native import (
        gersh_dinv_native, native_available)

    if not native_available():
        import pytest

        pytest.skip("native library unavailable")
    rng_a = sp.random(200, 200, density=0.05, random_state=3, format="csr")
    A = (rng_a + rng_a.T).tocsr()
    A.setdiag(A.diagonal() + 4.0)
    A.sort_indices()
    g = gersh_dinv_native(np.asarray(A.indptr, np.int64), A.indices, A.data, 200)
    d = A.diagonal()
    ref = float(np.max(np.abs(A).sum(axis=1).A1 / np.abs(d)))
    assert abs(g - ref) < 1e-12
    lam = float(np.max(np.abs(np.linalg.eigvals((A.toarray().T / d).T))))
    assert g >= lam - 1e-9  # guaranteed containment


def test_sa_prolongator_i32_matches_i64():
    """The int32 ABI (used at 10M where the assembly emits int32 indices)
    must produce byte-identical structure and values to the int64 path and
    to the scipy formula P = (I - s D^-1 A) T."""
    import scipy.sparse as sp

    from domain_decomposed_pde_solver.utils.native import (
        sa_prolongator_native,
    )

    rng_a = sp.random(300, 300, density=0.03, random_state=7, format="csr")
    A = (rng_a + rng_a.T).tocsr()
    A.setdiag(A.diagonal() + 6.0)
    A.sort_indices()
    rng = np.random.default_rng(11)
    n_c = 40
    agg = rng.integers(0, n_c, size=300)
    counts = np.bincount(agg, minlength=n_c).astype(np.float64)
    tval = 1.0 / np.sqrt(np.maximum(counts, 1.0))
    d = A.diagonal()
    s_over_d = 0.9 / d

    outs = {}
    for idt in (np.int64, np.int32):
        Pp, Pi, Px = sa_prolongator_native(
            A.indptr, A.indices.astype(idt), A.data,
            agg.astype(idt), tval, s_over_d, 300, n_c,
        )
        assert Pi.dtype == np.dtype(idt)
        outs[idt] = (Pp, Pi.astype(np.int64), Px)
    np.testing.assert_array_equal(outs[np.int64][0], outs[np.int32][0])
    np.testing.assert_array_equal(outs[np.int64][1], outs[np.int32][1])
    np.testing.assert_array_equal(outs[np.int64][2], outs[np.int32][2])

    T = sp.csr_matrix(
        (tval[agg], (np.arange(300), agg)), shape=(300, n_c)
    )
    ref = (T - sp.diags(s_over_d) @ (A @ T)).tocsr()
    ref.sort_indices()
    Pp, Pi, Px = outs[np.int64]
    got = sp.csr_matrix((Px, Pi, Pp), shape=(300, n_c))
    np.testing.assert_array_equal(got.indptr, ref.indptr)
    np.testing.assert_array_equal(got.indices, ref.indices)
    np.testing.assert_allclose(got.data, ref.data, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize(
    "name", ["tet-cube-heat.exo", "brick.exo", "2blocks.exo"]
)
def test_assemble_from_conn_matches_two_kernel(data_dir, name):
    """The fused connectivity->reduced-system kernel must be byte-identical
    to the node_adjacency + assemble_reduced composition."""
    from domain_decomposed_pde_solver.models.heat import (
        _adjacency_csr_native,
    )
    from domain_decomposed_pde_solver.utils.native import (
        assemble_from_conn_native,
        assemble_reduced_native,
    )

    mesh = read_exodus(os.path.join(data_dir, name))
    n = mesh.num_nodes
    is_b, bval = mesh.boundary_value_per_node()
    free_mask = ~is_b
    ftn = np.nonzero(free_mask)[0].astype(np.int64)
    ntf = np.full(n, -1, dtype=np.int64)
    ntf[ftn] = np.arange(ftn.size)
    conns = [b_.conn for b_ in mesh.blocks]
    conn = np.concatenate(conns, axis=0) if len(conns) > 1 else conns[0]
    for idt in (np.int64, np.int32):
        fused = assemble_from_conn_native(
            conn.astype(idt), n, free_mask.astype(np.uint8), ntf,
            bval.astype(np.float64), ftn.size,
        )
        adj = _adjacency_csr_native(mesh.blocks, n)
        two = assemble_reduced_native(
            adj[0], adj[1], n, free_mask.astype(np.uint8), ntf,
            bval.astype(np.float64), ftn.size,
        )
        assert fused is not None and two is not None
        for a, b in zip(fused, two):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
