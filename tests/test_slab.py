"""Slab-sharded DIA operator tests (ppermute neighbor halo exchange)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from domain_decomposed_pde_solver.io import box_mesh, read_exodus
from domain_decomposed_pde_solver.models import assemble_heat_system
from domain_decomposed_pde_solver.parallel import (
    build_slab_plan,
    make_device_mesh,
    slab_cg_solve,
)
from domain_decomposed_pde_solver.parallel.sharded import AXIS
from domain_decomposed_pde_solver.parallel.slab import SlabDIAOperator


@pytest.fixture(scope="module")
def system():
    return assemble_heat_system(box_mesh(16, 16, 16, elem_type="TETRA4"))


@pytest.mark.parametrize(
    "nparts", [2, 4, pytest.param(8, marks=pytest.mark.slow)]
)
def test_slab_spmv_matches_host(system, nparts):
    plan = build_slab_plan(system.A, nparts, dtype=np.float64)
    assert plan is not None
    mesh = make_device_mesh(nparts)
    sh = NamedSharding(mesh, P(AXIS))
    x = np.random.default_rng(0).standard_normal(system.A.n_rows)
    data = jax.device_put(plan.data, sh)
    xs = jax.device_put(plan.scatter_vector(x, dtype=np.float64), sh)
    offsets, halo, slab = plan.offsets, plan.halo, plan.slab

    def body(d, xb):
        op = SlabDIAOperator(data=d[0], offsets=offsets, halo=halo, slab=slab)
        return op.matvec(xb[0])[None]

    y = jax.shard_map(
        body, mesh=mesh, in_specs=(P(AXIS), P(AXIS)), out_specs=P(AXIS),
        check_vma=False,
    )(data, xs)
    np.testing.assert_allclose(
        plan.gather_vector(np.asarray(y)), system.A.matvec(x), rtol=1e-12,
        atol=1e-10,
    )


def test_slab_cg_device_count_invariant(system):
    iters = []
    for nparts in (2, 8):
        plan = build_slab_plan(system.A, nparts, dtype=np.float64)
        x, res = slab_cg_solve(
            plan, system.b, np.zeros(system.A.n_rows), tol=1e-11, maxiter=3000
        )
        assert bool(res.converged)
        r = system.A.matvec(x) - system.b
        assert np.abs(r).max() / np.abs(system.b).max() < 1e-9
        iters.append(int(res.iterations))
    assert iters[0] == iters[1]


def test_slab_plan_refuses_unstructured(data_dir):
    sys_ = assemble_heat_system(read_exodus(str(data_dir / "brick.exo")))
    assert build_slab_plan(sys_.A, 4) is None


def test_slab_plan_invariant_and_refusal():
    """Any returned plan must satisfy slab >= halo (neighbor-only comm);
    oversharding a small problem must be refused."""
    sys_ = assemble_heat_system(box_mesh(8, 8, 8, elem_type="TETRA4"))
    plan = build_slab_plan(sys_.A, 4)
    if plan is not None:
        assert plan.slab >= plan.halo
    assert build_slab_plan(sys_.A, 64) is None


def test_slab_stencil_cg_matches_serial():
    """Distributed pattern-stencil CG (one-z-layer ppermute halos) gives the
    same answer and iteration count as the single-device solve."""
    import jax
    import jax.numpy as jnp

    from domain_decomposed_pde_solver.io.boxmesh import box_mesh
    from domain_decomposed_pde_solver.models import assemble_heat_system
    from domain_decomposed_pde_solver.ops import choose_operator
    from domain_decomposed_pde_solver.ops.stencil import StencilOperator
    from domain_decomposed_pde_solver.parallel import slab_stencil_cg_solve
    from domain_decomposed_pde_solver.solvers import (
        cg_solve,
        jacobi_preconditioner,
    )
    from domain_decomposed_pde_solver.solvers.precond.amg import (
        infer_free_grid,
    )

    if len(jax.devices()) < 4:
        pytest.skip("needs virtual devices")
    mesh = box_mesh(12, 12, 33, elem_type="TETRA4")
    sy = assemble_heat_system(mesh)
    dims = infer_free_grid(mesh, sy.free_to_node)
    S = choose_operator(sy.A, dtype=jnp.float32, grid_dims=dims)
    assert isinstance(S, StencilOperator)

    b = (sy.b / np.abs(sy.b).max()).astype(np.float32)
    bj = S.put_vector(b)
    ref = cg_solve(S, bj, jnp.zeros_like(bj),
                   precond=jacobi_preconditioner(S), tol=1e-6, maxiter=800)

    out = slab_stencil_cg_solve(S, 4, b, np.zeros_like(b), tol=1e-6, maxiter=800)
    assert out is not None
    x, res = out
    assert bool(res.converged)
    assert abs(int(res.iterations) - int(ref.iterations)) <= 2
    import scipy.sparse as sp

    M = sp.csr_matrix((sy.A.data, sy.A.indices, sy.A.indptr), shape=sy.A.shape)
    relres = np.linalg.norm(M @ x.astype(np.float64) - b) / np.linalg.norm(b)
    assert relres < 1e-5
