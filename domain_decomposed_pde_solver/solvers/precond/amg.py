"""Smoothed-aggregation algebraic multigrid (SA-AMG) preconditioner.

The component the reference *intended* to use: MueLu is linked but abandoned
("MueLu crashes in Amesos' 'transpose' function, so we use IFPACK2 instead",
``BelosMueLuSolver.cpp:11``).  Here SA-AMG is first-class:

- **Setup on host** (NumPy/scipy.sparse, runs once): strength graph →
  greedy aggregation → tentative prolongator → Jacobi-smoothed P →
  Galerkin triple product ``A_c = R A P`` — the standard Vanek-Mandel-Brezina
  construction.
- **Apply on device** (pure JAX, jittable): V-cycle with Chebyshev/Jacobi
  smoothers; every grid transfer and smoother application is an ELL SpMV,
  so the whole cycle is a fixed sequence of bandwidth-bound kernels with
  static shapes.  Level count is static — the recursion unrolls under jit.

Used as the preconditioner inside :func:`..cg.cg_solve` ("CG+AMG", the
BASELINE headline metric).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, List, Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from ...ops.csr import CSRMatrix
from ...ops.ell import ELLMatrix, ell_from_csr, pad_to
from ...ops.spmv import ell_spmv

__all__ = [
    "AMGLevel",
    "AMGPreconditioner",
    "smoothed_aggregation_setup",
    "smoothed_aggregation_preconditioner",
    "aggregate_greedy",
    "infer_free_grid",
    "BrickProlongator",
    "PadBrickProlongator",
    "brick_aggregate",
]


# ---------------------------------------------------------------------------
# Host-side setup
# ---------------------------------------------------------------------------


def _to_scipy(A: CSRMatrix):
    """Zero-copy scipy view of a canonical CSRMatrix (READ-ONLY use).

    The tuple constructor unifies index dtypes by copying data + indices —
    ~160 MB at 1M DOF / ~1.5 GB at 10M, which a fault-bound VM's page-
    fault rate turns into seconds (see ``utils/hostmem.py``).
    Assembly already emits canonical sorted CSR, so validation is skipped
    and the arrays are shared; only indptr is cast to the index dtype
    (n_rows * 4 bytes).  Callers must not mutate the result in place."""
    import scipy.sparse as sp

    nnz = int(A.indptr[-1])
    if A.indices.dtype == np.int32 and nnz <= np.iinfo(np.int32).max:
        idx_t = np.int32
        indices = A.indices
    else:
        idx_t = np.int64
        indices = (
            A.indices
            if A.indices.dtype == np.int64
            else A.indices.astype(np.int64)
        )
    indptr = A.indptr if A.indptr.dtype == idx_t else A.indptr.astype(idx_t)
    S = sp.csr_matrix(A.shape, dtype=A.data.dtype)
    S.data, S.indices, S.indptr = A.data, indices, indptr
    return S


def _from_scipy(S) -> CSRMatrix:
    S = S.tocsr()
    S.sort_indices()
    return CSRMatrix(
        indptr=S.indptr.astype(np.int64),
        indices=S.indices.astype(np.int64),
        data=S.data.astype(np.float64),
        shape=S.shape,
    )


def aggregate_greedy(A: CSRMatrix, theta: float = 0.0) -> np.ndarray:
    """Standard greedy aggregation on the strength graph.

    Returns ``agg[i]`` = aggregate id per node.  Three passes (Vanek et al.):
    root aggregates over fully-free neighborhoods, attachment of leftovers to
    adjacent aggregates, then singleton/new aggregates for stragglers.
    ``theta`` filters weak couplings |a_ij| < theta*sqrt(a_ii a_jj).
    """
    n = A.n_rows
    indptr, indices, data = A.indptr, A.indices, A.data
    diag = A.diagonal()

    # Native fast path: strength filter applied inline in C++ — no
    # materialized filtered graph (the numpy repeat/mask/bincount/gather
    # preamble alone cost ~5 s of the 6.35 s aggregation at 3.2M rows).
    from ...utils.native import aggregate_greedy_filtered_native

    res = aggregate_greedy_filtered_native(
        indptr, indices, data, diag, theta, n
    )
    if res is not None:
        return res[0]

    agg = np.full(n, -1, dtype=np.int64)
    # Strength filter mask per nonzero.
    rows = np.repeat(np.arange(n), np.diff(indptr))
    strong = (rows != indices) & (
        np.abs(data) >= theta * np.sqrt(np.abs(diag[rows] * diag[indices]) + 1e-300)
    )

    # Pass 1: roots with entirely unaggregated strong neighborhoods.
    next_agg = 0
    for i in range(n):
        if agg[i] != -1:
            continue
        lo, hi = indptr[i], indptr[i + 1]
        nbrs = indices[lo:hi][strong[lo:hi]]
        if (agg[nbrs] == -1).all():
            agg[i] = next_agg
            agg[nbrs] = next_agg
            next_agg += 1
    # Pass 2: attach leftovers to a neighboring aggregate.
    for i in range(n):
        if agg[i] != -1:
            continue
        lo, hi = indptr[i], indptr[i + 1]
        nbrs = indices[lo:hi][strong[lo:hi]]
        assigned = nbrs[agg[nbrs] != -1]
        if assigned.size:
            agg[i] = agg[assigned[0]]
    # Pass 3: new aggregates for isolated stragglers.
    for i in range(n):
        if agg[i] == -1:
            agg[i] = next_agg
            next_agg += 1
    return agg


def _filter_weak_entries(S, tol: float):
    """Drop off-diagonal |a_ij| < tol*sqrt(a_ii a_jj), lumping the dropped
    values into the diagonal (row sums preserved)."""
    import scipy.sparse as sp

    S = S.tocoo()
    d = np.abs(S.tocsr().diagonal())
    d = np.where(d != 0, d, 1.0)
    weak = (S.row != S.col) & (
        np.abs(S.data) < tol * np.sqrt(d[S.row] * d[S.col])
    )
    lump = np.zeros(S.shape[0])
    np.add.at(lump, S.row[weak], S.data[weak])
    keep = ~weak
    out = sp.csr_matrix(
        (S.data[keep], (S.row[keep], S.col[keep])), shape=S.shape
    )
    out = out + sp.diags(lump)
    out.sum_duplicates()
    return out.tocsr()


def _lmax_dinv_a_host(S) -> float:
    """Power-method estimate of lambda_max(D^-1 A) on the host CSR.

    D^-1 A is applied as matvec-then-divide — materializing ``Dinv @ S``
    as a scipy spgemm cost 0.5 s/level at 19M nnz.  Above 4M rows the
    matrix is recast to f32 values + int32 indices first (half the
    memory traffic of the 20 power matvecs; ~16 s -> ~9 s at 10M DOF) —
    gated so small hierarchies stay bit-identical.

    A round-5 commit briefly replaced the estimate above 1.5M rows with
    the native Gershgorin bound (one streaming pass) — REVERTED after an
    on-chip A/B at 3.2M-row refined lbracket: the bound (2.0) overshoots
    the actual top of the spectrum (power est. ~1.34 here — tet meshes
    are far from bipartite, where D^-1 A would reach 2), which both
    shrinks the prolongator smoothing weight omega/lmax and lifts the
    Chebyshev interval off the true spectrum.  Measured: CG+AMG(1e-6)
    49 iters / 1727 ms with Gershgorin vs 35 iters / 1168 ms with the
    power estimate.  Containment is the wrong objective for hierarchy
    QUALITY; the f32/int32 recast keeps the cost ~2 s at 3.2M rows."""
    if S.shape[0] > 1_500_000 and S.nnz < 2**31:
        import scipy.sparse as sp

        S = sp.csr_matrix(
            (
                S.data.astype(np.float32),
                S.indices.astype(np.int32),
                S.indptr.astype(np.int32),
            ),
            shape=S.shape,
        )
    d = S.diagonal()
    d = np.where(d != 0, d, 1.0)
    rng = np.random.default_rng(0)
    q = rng.uniform(size=S.shape[0])
    q /= np.linalg.norm(q)
    q = q.astype(S.dtype, copy=False)  # f64 q would upcast the matvec
    lam = 1.0
    for _ in range(20):
        z = (S @ q) / d  # one matvec per iteration: lam = q.z with unit q
        nz = np.linalg.norm(z)  # is the same Rayleigh estimate the old
        if nz == 0:  # two-matvec form computed, at half the cost
            return 1.0
        lam = q @ z
        q = z / nz
    # 5% safety factor: the power method underestimates lambda_max when the
    # top eigenvalues cluster (measured 6-8% short at 20^3 boxes with few
    # iterations); containment matters more than a slightly tighter
    # Chebyshev interval.
    return float(abs(lam)) * 1.05


def _count_diagonals_capped(csr, cap: int) -> int:
    """Number of distinct diagonals, early-exiting once > ``cap``.

    Replaces ``np.unique(indices - rows)`` whose nnz-sized sort cost
    seconds at 10M DOF; one chunked pass over a (2n+1)-slot bitmap."""
    n = csr.n_rows
    indptr = np.asarray(csr.indptr)
    indices = np.asarray(csr.indices)
    seen = np.zeros(2 * n + 1, dtype=bool)
    step = max(1, n // 16)
    count = 0
    for r0 in range(0, n, step):
        r1 = min(n, r0 + step)
        lo, hi = int(indptr[r0]), int(indptr[r1])
        rows_c = np.repeat(
            np.arange(r0, r1, dtype=np.int64), np.diff(indptr[r0 : r1 + 1])
        )
        seen[indices[lo:hi] - rows_c + n] = True
        count = int(seen.sum())
        if count > cap:
            return count
    return count


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["agg", "tval", "scale", "A"],
    meta_fields=["n_pad_c"],
)
@dataclasses.dataclass
class FactoredProlongator:
    """Smoothed prolongator applied in factored form.

    ``P = (I - (omega/lmax) D^-1 A) T`` with T the tentative (aggregate
    selection) operator.  Applying P explicitly as an ELL matrix costs
    ~9 gathers per fine row; the factored form costs ONE
    gather (the selection) plus a fine-level A matvec — a large win when A
    is DIA (gather-free).  Used for P and (via symmetry, A = A^T, D diag)
    for R = P^T: ``R r = T^T (r - omega D^-1 A r)`` with T^T a segment-sum.
    """

    agg: jax.Array  # (n_pad_f,) aggregate id per fine row (0 on padding)
    tval: jax.Array  # (n_pad_f,) tentative weight (0 on padding)
    scale: jax.Array  # (n_pad_f,) omega/lmax * 1/diag (0 on padding)
    A: object  # fine-level operator (DIA or ELL pytree with .matvec)
    n_pad_c: int  # padded coarse length

    def matvec(self, x_c: jax.Array) -> jax.Array:
        t = self.tval * jnp.take(x_c, self.agg, axis=0)
        return t - self.scale * self.A.matvec(t)

    def rmatvec(self, r: jax.Array) -> jax.Array:
        s = r - self.A.matvec(self.scale * r)
        return jax.ops.segment_sum(
            self.tval * s, self.agg, num_segments=self.n_pad_c
        )


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["P"],
    meta_fields=[],
)
@dataclasses.dataclass
class FactoredRestriction:
    """R = P^T for a factored prolongator (shares its arrays)."""

    P: object  # FactoredProlongator | BrickProlongator

    def matvec(self, r: jax.Array) -> jax.Array:
        return self.P.rmatvec(r)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["tval", "scale", "A"],
    meta_fields=["dims", "brick", "n_pad_c", "n_pad_f"],
)
@dataclasses.dataclass
class BrickProlongator:
    """Gather-free factored prolongator for lexicographic grids.

    Same semantics as :class:`FactoredProlongator` with the aggregate id
    fixed to bricks of ``brick^3`` grid nodes: the tentative transfer
    ``T x_c`` becomes reshape + ``jnp.repeat`` (static counts — pure
    broadcast, no gather) and ``T^T w`` becomes a reshape + block-sum
    reduction (no segment_sum/scatter), so the transfers stream instead of
    gathering.  ``dims = (mx, my, mz)`` with fine index
    ``ix + mx*(iy + my*iz)``.
    """

    tval: jax.Array  # (n_pad_f,) tentative weight (0 on padding)
    scale: jax.Array  # (n_pad_f,) omega/lmax * 1/diag (0 on padding)
    A: object  # fine-level operator (DIA pytree with .matvec)
    dims: Tuple[int, int, int]
    brick: int
    n_pad_c: int
    n_pad_f: int

    @property
    def coarse_dims(self) -> Tuple[int, int, int]:
        b = self.brick
        mx, my, mz = self.dims
        return (-(-mx // b), -(-my // b), -(-mz // b))

    def _t_apply(self, x_c: jax.Array) -> jax.Array:
        """T x_c: coarse vector -> fine vector (both padded)."""
        mx, my, mz = self.dims
        ncx, ncy, ncz = self.coarse_dims
        b = self.brick
        z = x_c[: ncx * ncy * ncz].reshape(ncz, ncy, ncx)
        z = jnp.repeat(z, b, axis=0)[:mz]
        z = jnp.repeat(z, b, axis=1)[:, :my]
        z = jnp.repeat(z, b, axis=2)[:, :, :mx]
        flat = z.reshape(-1)
        flat = jnp.pad(flat, (0, self.n_pad_f - mx * my * mz))
        return self.tval * flat

    def _t_transpose(self, w: jax.Array) -> jax.Array:
        """T^T w: fine vector -> coarse vector (both padded)."""
        mx, my, mz = self.dims
        ncx, ncy, ncz = self.coarse_dims
        b = self.brick
        tw = (self.tval * w)[: mx * my * mz].reshape(mz, my, mx)
        tw = jnp.pad(
            tw,
            ((0, ncz * b - mz), (0, ncy * b - my), (0, ncx * b - mx)),
        )
        c = tw.reshape(ncz, b, ncy, b, ncx, b).sum(axis=(1, 3, 5))
        flat = c.reshape(-1)
        return jnp.pad(flat, (0, self.n_pad_c - ncx * ncy * ncz))

    def matvec(self, x_c: jax.Array) -> jax.Array:
        t = self._t_apply(x_c)
        return t - self.scale * self.A.matvec(t)

    def rmatvec(self, r: jax.Array) -> jax.Array:
        s = r - self.A.matvec(self.scale * r)
        return self._t_transpose(s)


def brick_aggregate(dims: Tuple[int, int, int], brick: int) -> np.ndarray:
    """Host-side aggregate ids for :class:`BrickProlongator`'s bricks.

    Separable broadcast of three tiny axis arrays into ONE n-sized
    output — the earlier per-index form allocated seven n-sized int64
    temporaries, which page-faulted for ~33 s at 10M DOF on this host."""
    mx, my, mz = dims
    b = brick
    ncx, ncy = -(-mx // b), -(-my // b)
    ax = np.arange(mx, dtype=np.int64) // b
    ay = ncx * (np.arange(my, dtype=np.int64) // b)
    az = (ncx * ncy) * (np.arange(mz, dtype=np.int64) // b)
    return (
        az[:, None, None] + ay[None, :, None] + ax[None, None, :]
    ).reshape(-1)


def infer_free_grid(mesh, free_to_node) -> Optional[Tuple[int, int, int]]:
    """Detect a lexicographic free-node grid: returns (mx, my, mz) with
    free index == ix + mx*(iy + my*iz), or None for unstructured meshes.

    Host-side check over coordinate ranks (generated box meshes number
    nodes x-fastest and Dirichlet elimination preserves order, so free
    nodes of a box form exactly such a grid)."""
    c = np.asarray(mesh.coords)[np.asarray(free_to_node)]
    if c.shape[1] != 3:
        return None
    n = c.shape[0]
    ux, uy, uz = (np.unique(c[:, k]) for k in range(3))
    if ux.size * uy.size * uz.size != n:
        return None
    ix = np.searchsorted(ux, c[:, 0])
    iy = np.searchsorted(uy, c[:, 1])
    iz = np.searchsorted(uz, c[:, 2])
    mx, my = ux.size, uy.size
    if not np.array_equal(ix + mx * (iy + my * iz), np.arange(n)):
        return None
    return (int(ux.size), int(uy.size), int(uz.size))


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["A", "P", "R", "inv_diag", "lmax"],
    meta_fields=["n_rows"],
)
@dataclasses.dataclass
class AMGLevel:
    A: ELLMatrix  # operator at this level (padded)
    P: ELLMatrix  # prolongation: coarse -> this level
    R: ELLMatrix  # restriction: this level -> coarse (P^T)
    inv_diag: jax.Array  # 1/diag(A), padded with 1
    lmax: jax.Array  # lambda_max(D^-1 A) for Chebyshev smoothing (scalar)
    n_rows: int


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["levels", "coarse_inv"],
    meta_fields=["smoother", "smooth_steps", "cycles"],
)
@dataclasses.dataclass
class AMGPreconditioner:
    levels: List[AMGLevel]
    coarse_inv: jax.Array  # dense inverse of the coarsest operator (padded)
    smoother: str = "chebyshev"  # "chebyshev" | "jacobi"
    smooth_steps: int = 2
    cycles: int = 1  # V-cycles per apply

    @property
    def num_levels(self) -> int:
        return len(self.levels) + 1

    def __call__(self, r: jax.Array) -> jax.Array:
        x = self._vcycle(0, r)
        for _ in range(self.cycles - 1):
            x = x + self._vcycle(0, r - _apply_A(self.levels[0].A, x))
        return x

    # -- device-side V-cycle (unrolled: level count is static) ----------
    def _smooth(self, lvl: AMGLevel, x, b, x_zero: bool = False):
        # x_zero: the pre-smooth starts from x = 0; skipping A @ 0 drops
        # one full SpMV per level per V-cycle, bit-identically.
        if self.smoother == "jacobi":
            omega = 2.0 / 3.0
            for i in range(self.smooth_steps):
                r = b if (x_zero and i == 0) else b - _apply_A(lvl.A, x)
                x = x + omega * lvl.inv_diag * r
            return x
        # Chebyshev over [lmax/4, 1.1 lmax] of D^-1 A (standard SA range).
        from .cheby import chebyshev_smooth

        return chebyshev_smooth(
            lambda v: _apply_A(lvl.A, v), lvl.inv_diag, lvl.lmax,
            self.smooth_steps, x, b, x_zero=x_zero,
        )

    def _vcycle(self, k: int, b: jax.Array) -> jax.Array:
        if k == len(self.levels):
            if self.coarse_inv.ndim == 1:  # diagonal fallback (stalled agg)
                return self.coarse_inv * b
            return jnp.matmul(
                self.coarse_inv, b, precision=jax.lax.Precision.HIGHEST
            )
        lvl = self.levels[k]
        x = self._smooth(lvl, jnp.zeros_like(b), b, x_zero=True)
        r_c = lvl.R.matvec(b - _apply_A(lvl.A, x))
        x_c = self._vcycle(k + 1, r_c)
        x = x + lvl.P.matvec(x_c)
        return self._smooth(lvl, x, b)


def _apply_A(A, x):
    return A.matvec(x)


def smoothed_aggregation_setup(
    A: CSRMatrix,
    dtype=jnp.float32,
    theta: float = 0.0,
    omega: float = 4.0 / 3.0,
    max_levels: int = 10,
    coarse_size: int = 64,
    smoother: str = "chebyshev",
    smooth_steps: int = 2,
    factored_transfers: bool = True,
    filter_tol: float = 0.01,
    operator_format: str = "auto",
    aggressive_levels: Union[int, str] = "auto",
    grid_dims: Optional[Tuple[int, int, int]] = None,
    brick: int = 6,
    level_info_out: Optional[list] = None,
    timings_out: Optional[dict] = None,
) -> AMGPreconditioner:
    """Build the SA-AMG hierarchy from the host CSR operator.

    Grid-transfer shapes are padded so that every level's vector length is a
    multiple of 8 and P/R map padded->padded (padding slots carry zeros).

    ``aggressive_levels``: on the first k levels, compose TWO rounds of
    greedy aggregation (aggregate the aggregate graph), squaring the
    coarsening ratio (~15x -> ~200x in 3D).  The finest level smooths
    gather-free (DIA), but level 1 is an unstructured ELL whose gathers
    can dominate the V-cycle.  Skipping straight to a ~5k-row level 1
    trades a weaker coarse correction (more CG iterations) for a far
    cheaper cycle; pair
    with ``smooth_steps=3`` to claw back most of the iteration loss with
    cheap fine-level matvecs (MueLu's aggressive-coarsening +
    higher-degree-Chebyshev recipe).  ``"auto"`` (default) enables it for
    one level exactly when the tradeoff pays: the finest operator has DIA
    (stencil) structure and is large enough that level 1 would dominate
    the cycle.  At 1M DOF the hierarchy goes [1M, 69k, 1.2k] ->
    [1M, 3k, 140] and CG from 7 to 15 iterations.

    ``grid_dims``: if the fine free-node set is a lexicographic grid
    (``infer_free_grid``), the aggressive finest level uses ``brick^3``
    geometric aggregates and fully gather-free transfers
    (:class:`BrickProlongator`) instead of greedy aggregation — the
    transfer round trip becomes streaming reshapes instead of gathers.
    """
    import scipy.sparse as sp
    import time as _time

    # Cumulative per-phase wall seconds (``timings_out``).
    _tm = {} if timings_out is None else timings_out
    _last = [_time.perf_counter()]

    def _mark(name):
        now = _time.perf_counter()
        _tm[name] = _tm.get(name, 0.0) + (now - _last[0])
        _last[0] = now

    levels: List[AMGLevel] = []
    A_k = _to_scipy(A)
    n_pads = [pad_to(max(A.n_rows, 1))]

    if aggressive_levels == "auto":
        if (
            grid_dims is not None
            and int(np.prod(grid_dims)) == A.n_rows
        ):
            # Brick transfers replace level-0 greedy aggregation entirely,
            # and aggressive composing only ever applies at level 0 — the
            # diagonal-count probe (a full pass over 132M indices at 10M
            # DOF) would be wasted.
            aggressive_levels = 0
        elif operator_format != "ell" and A.n_rows > 200_000:
            ndiags = _count_diagonals_capped(A, 64)
            aggressive_levels = 1 if ndiags <= 64 else 0
        else:
            aggressive_levels = 0
    _mark("diag_probe")

    while A_k.shape[0] > coarse_size and len(levels) < max_levels - 1:
        # Level 0: reuse the caller's CSR — the scipy round-trip upcasts
        # indices int32 -> int64 and re-copies data (~3 GB of host traffic
        # and ~20 s of page faults at 10M DOF / 132M nnz).
        csr_k = A if len(levels) == 0 else _from_scipy(A_k)
        if (
            len(levels) == 0
            and grid_dims is not None
            and int(np.prod(grid_dims)) != A_k.shape[0]
        ):
            import warnings

            warnings.warn(
                f"grid_dims {tuple(grid_dims)} does not match the operator "
                f"size {A_k.shape[0]}; falling back to greedy aggregation "
                f"(gathered transfers)",
                stacklevel=2,
            )
        # grid_dims expresses explicit intent for brick transfers: honor it
        # whenever it matches the finest operator, independent of the
        # aggressive-coarsening auto-gate (which only governs the greedy
        # compose below) — otherwise a structured mesh under 200k rows that
        # wires grid_dims would silently get gathered transfers.
        use_brick = (
            len(levels) == 0
            and grid_dims is not None
            and int(np.prod(grid_dims)) == A_k.shape[0]
        )
        if use_brick:
            agg = brick_aggregate(grid_dims, brick)
        else:
            agg = aggregate_greedy(csr_k, theta=theta)
            if len(levels) < aggressive_levels:
                n_c1 = int(agg.max()) + 1 if agg.size else 0
                if 0 < n_c1 < A_k.shape[0]:
                    # Second round on the (unsmoothed) aggregate graph;
                    # compose.
                    from ...utils.native import rap_galerkin_native

                    T1 = sp.csr_matrix(
                        (
                            np.ones(A_k.shape[0]),
                            (np.arange(A_k.shape[0]), agg),
                        ),
                        shape=(A_k.shape[0], n_c1),
                    )
                    T1.sort_indices()
                    g = rap_galerkin_native(
                        A_k.indptr, A_k.indices, A_k.data,
                        T1.indptr, T1.indices, T1.data,
                        A_k.shape[0], n_c1,
                    )
                    if g is not None:
                        G = sp.csr_matrix(
                            (g[2], g[1], g[0]), shape=(n_c1, n_c1)
                        )
                    else:
                        G = (T1.T @ A_k @ T1).tocsr()
                    G.sum_duplicates()
                    agg2 = aggregate_greedy(_from_scipy(G), theta=theta)
                    agg = agg2[agg]
        n_c = int(agg.max()) + 1 if agg.size else 0
        _mark("aggregate")
        if n_c >= A_k.shape[0] or n_c == 0:
            break  # aggregation stalled
        # Smoothed prolongator P = (I - omega/lmax D^-1 A) T, where T is the
        # normalized piecewise-constant tentative prolongator.  Built
        # natively in one pass (ddps_native.cpp::sa_prolongator) — the
        # scipy chain (T build, A@T, Dinv@, subtract) dominated setup at
        # 1M+ DOF.  Same values up to f64 rounding.
        counts = np.bincount(agg, minlength=n_c).astype(np.float64)
        d = A_k.diagonal()
        d = np.where(d != 0, d, 1.0)
        # Host power method (f32 fast path above 4M rows inside).
        lmax = _lmax_dinv_a_host(A_k)
        _mark("lmax")
        if level_info_out is not None:
            # Distributed-hierarchy builders (parallel/haloamg.py,
            # parallel/slabamg.py) consume the raw per-level setup pieces.
            level_info_out.append(
                dict(
                    n=A_k.shape[0], agg=agg.copy(), counts=counts.copy(),
                    d=d.copy(), lmax=float(lmax), omega=float(omega),
                )
            )
        from ...utils.native import rap_galerkin_native, sa_prolongator_native

        tval = 1.0 / np.sqrt(counts)
        ps = sa_prolongator_native(
            A_k.indptr, A_k.indices, A_k.data, agg, tval,
            (omega / lmax) / d, A_k.shape[0], n_c,
        )
        if ps is not None:
            # Keep the raw (Pp, Pi, Px) arrays: routing them through
            # sp.csr_matrix here upcast int32 Pi to int64 (scipy unifies
            # indptr/indices dtypes), re-faulting hundreds of MB at 10M.
            # The scipy form is built lazily only where needed.
            Pp, Pi, Px = ps
            P = None
        else:
            T = sp.csr_matrix(
                (tval[agg], (np.arange(A_k.shape[0]), agg)),
                shape=(A_k.shape[0], n_c),
            )
            Dinv = sp.diags(1.0 / d)
            P = (T - (omega / lmax) * (Dinv @ (A_k @ T))).tocsr()
            P.sort_indices()
            Pp, Pi, Px = P.indptr, P.indices, P.data
        _mark("prolongator")
        # Galerkin product natively (fused Gustavson P^T A P,
        # ddps_native.cpp::rap_galerkin) — scipy's two spgemms dominated
        # setup at 1M+ DOF.  Results are identical up to f64 rounding.
        rap = rap_galerkin_native(
            A_k.indptr, A_k.indices, A_k.data,
            Pp, Pi, Px,
            A_k.shape[0], n_c,
        )
        if rap is not None:
            Cp, Ci, Cx = rap
            A_c = sp.csr_matrix((Cx, Ci, Cp), shape=(n_c, n_c))
        else:
            if P is None:
                P = sp.csr_matrix((Px, Pi, Pp), shape=(A_k.shape[0], n_c))
            A_c = (P.T.tocsr() @ (A_k @ P)).tocsr()
        A_c.sum_duplicates()
        if filter_tol > 0:
            # Galerkin products densify coarse operators (row width ~4x the
            # fine level), and every stored entry costs a gather, so drop
            # weak couplings |a_ij| < tol*sqrt(a_ii a_jj)
            # and lump them into the diagonal (preserves row sums, keeps
            # the operator an M-matrix-like Laplacian).  At 1M DOF f32,
            # tol=0.01 takes level-1 width 58->33 at 7 CG iterations;
            # tol>=0.05 over-weakens the hierarchy.
            A_c = _filter_weak_entries(A_c, filter_tol)
        _mark("rap")

        n_pad_f = n_pads[-1]
        n_pad_c = pad_to(max(n_c, 1))
        # Level operator: DIA when the level has stencil structure (the fine
        # level of generated/structured meshes) — gather-free smoothing.
        if operator_format == "ell":
            # Plain ELL only (the block-Schwarz stacker needs uniform
            # ELL structure across parts).
            lvl_A = ell_from_csr(csr_k, dtype=dtype)
        else:
            from ...ops.dia import choose_operator

            lvl_A = choose_operator(
                csr_k,
                dtype=dtype,
                grid_dims=grid_dims if len(levels) == 0 else None,
            )
        if isinstance(lvl_A, ELLMatrix):
            lvl_A = _repad(lvl_A, n_pad_f)
        _mark("level_op")
        from ...ops.dia import DIAMatrix
        from ...ops.stencil import StencilOperator

        if (
            isinstance(lvl_A, (DIAMatrix, StencilOperator))
            and factored_transfers
        ):
            # Factored transfers: P = (I - w D^-1 A) T applied as one
            # selection gather + a gather-free DIA matvec — ~9x fewer
            # memory ops than the explicit ELL P/R.
            n_f = A_k.shape[0]
            tval_pad = np.zeros(n_pad_f, dtype=np.dtype(dtype))
            tval_pad[:n_f] = 1.0 / np.sqrt(counts[agg])
            scale_pad = np.zeros(n_pad_f, dtype=np.dtype(dtype))
            scale_pad[:n_f] = (omega / lmax) / d
            if use_brick:
                # Geometric bricks: the selection gather/segment_sum
                # become static reshapes — fully gather-free transfers.
                P_fact = BrickProlongator(
                    tval=jnp.asarray(tval_pad),
                    scale=jnp.asarray(scale_pad),
                    A=lvl_A,
                    dims=tuple(int(v) for v in grid_dims),
                    brick=brick,
                    n_pad_c=n_pad_c,
                    n_pad_f=n_pad_f,
                )
            else:
                agg_pad = np.zeros(n_pad_f, dtype=np.int32)
                agg_pad[:n_f] = agg
                P_fact = FactoredProlongator(
                    agg=jnp.asarray(agg_pad),
                    tval=jnp.asarray(tval_pad),
                    scale=jnp.asarray(scale_pad),
                    A=lvl_A,
                    n_pad_c=n_pad_c,
                )
            P_op = P_fact
            R_op = FactoredRestriction(P=P_fact)
        else:
            # Pad transfer operators to (n_pad_f x n_pad_c) shapes.
            if P is None:
                P = sp.csr_matrix((Px, Pi, Pp), shape=(A_k.shape[0], n_c))
            R = P.T.tocsr()
            P_op = _repad(ell_from_csr(_from_scipy(P), dtype=dtype), n_pad_f)
            R_op = _repad(ell_from_csr(_from_scipy(R), dtype=dtype), n_pad_c)
        lvl = AMGLevel(
            A=lvl_A,
            P=P_op,
            R=R_op,
            inv_diag=_inv_diag_padded(csr_k, n_pad_f, dtype),
            lmax=jnp.asarray(lmax, dtype),
            n_rows=A_k.shape[0],
        )
        levels.append(lvl)
        A_k = A_c
        n_pads.append(n_pad_c)
        _mark("transfers")

    # Dense coarse solve, padded with identity outside the logical block.
    nc = A_k.shape[0]
    if nc > max(4 * coarse_size, 512):
        # Aggregation stalled before reaching the target size; a dense
        # inverse at this size would be prohibitive.  Fall back to a Jacobi
        # "coarse solve" stored as a 1-D inverse-diagonal vector (the
        # V-cycle applies it elementwise) — the cycle stays a valid
        # preconditioner, just weaker on the coarsest level.
        n_pad_c = n_pads[-1]
        d = A_k.diagonal()
        d = np.where(d != 0, d, 1.0)
        coarse_inv_diag = np.ones(n_pad_c)
        coarse_inv_diag[:nc] = 1.0 / d
        return AMGPreconditioner(
            levels=levels,
            coarse_inv=jnp.asarray(coarse_inv_diag.astype(np.dtype(dtype))),
            smoother=smoother,
            smooth_steps=smooth_steps,
        )
    n_pad_c = n_pads[-1]
    dense = np.eye(n_pad_c)
    dense[:nc, :nc] = A_k.toarray()
    coarse_inv = jnp.asarray(np.linalg.inv(dense).astype(np.dtype(dtype)))
    _mark("coarse")
    return AMGPreconditioner(
        levels=levels,
        coarse_inv=coarse_inv,
        smoother=smoother,
        smooth_steps=smooth_steps,
    )


def _repad(A: ELLMatrix, n_pad: int) -> ELLMatrix:
    """Grow the row padding of an ELL matrix to exactly n_pad rows."""
    cur = A.n_pad
    if cur == n_pad:
        return A
    assert n_pad > cur
    cols = jnp.zeros((n_pad, A.row_width), dtype=A.cols.dtype)
    vals = jnp.zeros((n_pad, A.row_width), dtype=A.vals.dtype)
    cols = cols.at[:cur].set(A.cols)
    vals = vals.at[:cur].set(A.vals)
    return ELLMatrix(cols=cols, vals=vals, n_rows=A.n_rows, n_cols=A.n_cols)


def _inv_diag_padded(A: CSRMatrix, n_pad: int, dtype) -> jax.Array:
    d = A.diagonal()
    d = np.where(d != 0, d, 1.0)
    out = np.ones(n_pad, dtype=np.dtype(dtype))
    out[: d.size] = (1.0 / d).astype(np.dtype(dtype))
    return jnp.asarray(out)


def smoothed_aggregation_preconditioner(A_ell: ELLMatrix, **kwargs):
    """Convenience: build SA-AMG directly from a device ELL operator by
    reconstructing the host CSR (used by the CLI; prefer passing the CSR)."""
    cols = np.asarray(A_ell.cols)
    vals = np.asarray(A_ell.vals)
    n = A_ell.n_rows
    rows = np.repeat(np.arange(cols.shape[0]), cols.shape[1])
    mask = vals.reshape(-1) != 0
    rows, cc, vv = rows[mask], cols.reshape(-1)[mask], vals.reshape(-1)[mask]
    keep = rows < n
    from ...ops.csr import coo_to_csr

    csr = coo_to_csr(rows[keep], cc[keep], vv[keep].astype(np.float64), (n, n))
    return smoothed_aggregation_setup(csr, dtype=A_ell.dtype, **kwargs)
