"""High-level session API: build once, solve many.

Production/serving-style entry point: the expensive artifacts (mesh read,
assembly, device operator, AMG hierarchy) are built once per mesh; repeated
solves — e.g. sweeping boundary temperatures, or re-solving as sensor data
updates — reuse them and warm-start from the previous solution.

    solver = SteadyHeatSolver.from_file("mesh.exo")
    u1 = solver.solve()                          # reference BC values
    u2 = solver.solve(bc={100: 80.0, 1000: 25.0})  # new temperatures, warm

The BC override exploits linearity: the RHS for arbitrary per-nodeset
Dirichlet values is reassembled in O(nnz) on the host (the matrix never
changes), so each new solve costs only a preconditioned CG from a warm
start.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from .io.mesh import MeshModel
from .models.heat import HeatSystem, assemble_heat_system

__all__ = ["SteadyHeatSolver"]


class SteadyHeatSolver:
    """Reusable steady-state heat solver bound to one mesh."""

    def __init__(
        self,
        mesh: MeshModel,
        dtype=None,
        precond: str = "amg",
    ):
        import jax.numpy as jnp

        from .ops.dia import choose_operator

        self.mesh = mesh
        self.dtype = dtype if dtype is not None else jnp.float64
        self.system: HeatSystem = assemble_heat_system(mesh)
        from .solvers.precond.amg import infer_free_grid

        # Format for the mesh class: pattern-broadcast stencil on
        # lexicographic grids, DIA/Split-ELL/ELL otherwise.
        self._grid_dims = infer_free_grid(mesh, self.system.free_to_node)
        self.operator = choose_operator(
            self.system.A, dtype=self.dtype, grid_dims=self._grid_dims
        )
        self._precond_kind = precond
        self._precond = self._build_precond(precond)
        self._last_x: Optional[np.ndarray] = None
        # Boundary-edge structure for fast RHS reassembly (cached by the
        # assembly; b[i] = sum over boundary neighbors c of value(c)).
        self._b_rows = self.system.bdry_rows
        self._b_cols = self.system.bdry_cols

    @classmethod
    def from_file(cls, path: str, **kw) -> "SteadyHeatSolver":
        from .io.exodus import read_exodus

        return cls(read_exodus(path), **kw)

    def _build_precond(self, kind: str):
        from .solvers.precond.jacobi import jacobi_preconditioner

        if kind == "jacobi":
            return jacobi_preconditioner(self.operator)
        if kind == "amg":
            from .solvers.precond.amg import smoothed_aggregation_setup

            return smoothed_aggregation_setup(
                self.system.A, dtype=self.dtype, grid_dims=self._grid_dims
            )
        if kind == "none":
            return None
        raise ValueError(kind)

    def rhs_for(self, bc: Optional[Dict[int, float]] = None) -> np.ndarray:
        """RHS for per-nodeset Dirichlet values.

        ``bc`` maps nodeset id -> temperature; omitted sets keep the
        reference convention (value = nodeset id, smallest id winning for
        multiply-set nodes, ``ExodusIO.hpp:675-682``)."""
        if not bc:
            return self.system.b
        self._check_bc_ids(bc)
        # Rebuild bval for ALL sets (descending-id overwrite => ascending-id
        # priority for multiply-set nodes, the reference's tie-break,
        # ``ExodusIO.hpp:675-682``); overridden sets substitute their value.
        bval = np.zeros(self.mesh.num_nodes)
        for ns in sorted(self.mesh.node_sets, key=lambda s: s.id, reverse=True):
            bval[ns.nodes.astype(np.int64)] = float(bc.get(ns.id, ns.id))
        b = np.zeros(self.system.n_free)
        np.add.at(b, self._b_rows, bval[self._b_cols])
        return b

    def _check_bc_ids(self, bc: Dict[int, float]) -> None:
        known = {ns.id for ns in self.mesh.node_sets}
        unknown = set(bc) - known
        if unknown:
            raise ValueError(
                f"bc references nodeset ids {sorted(unknown)} not present in "
                f"the mesh (available: {sorted(known)})"
            )

    def boundary_values_for(self, bc: Optional[Dict[int, float]] = None) -> np.ndarray:
        """Per-node values for Exodus timestep-0 output under ``bc``."""
        if bc:
            self._check_bc_ids(bc)
        vals = np.zeros(self.mesh.num_nodes)
        # Ascending-id overwrite => largest id wins for multiply-set nodes
        # (the reference's write-side tie-break, ``ExodusIO.hpp:1979-1989``);
        # all sets written so non-overridden ones keep their default.
        for ns in sorted(self.mesh.node_sets, key=lambda s: s.id):
            vals[ns.nodes.astype(np.int64)] = float(
                (bc or {}).get(ns.id, ns.id)
            )
        return vals

    def solve(
        self,
        bc: Optional[Dict[int, float]] = None,
        tol: float = 1e-10,
        maxiter: int = 1000,
        warm_start: bool = True,
    ):
        """Solve for the given boundary temperatures; returns
        (u_free, CGResult)."""
        import jax.numpy as jnp

        from .solvers.cg import cg_solve

        b_host = self.rhs_for(bc)
        b = self.operator.put_vector(b_host.astype(np.dtype(self.dtype)))
        if warm_start and self._last_x is not None:
            x0 = self.operator.put_vector(
                self._last_x.astype(np.dtype(self.dtype))
            )
        else:
            x0 = jnp.zeros_like(b)
        res = cg_solve(
            self.operator, b, x0, precond=self._precond, tol=tol,
            maxiter=maxiter,
        )
        u = self.operator.get_vector(res.x)
        self._last_x = np.array(u)
        return u, res

    def write_solution(self, path: str, u: np.ndarray,
                       bc: Optional[Dict[int, float]] = None,
                       timestep: int = 0) -> None:
        """Write ``u`` (free-node values) as an Exodus solution file."""
        from .io.exodus import ExodusSolutionWriter

        with ExodusSolutionWriter(
            path, self.mesh, boundary_values=self.boundary_values_for(bc)
        ) as w:
            w.write_solution(u, self.system.free_to_node, timestep)
