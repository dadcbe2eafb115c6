"""The one Chebyshev smoother every V-cycle in the package applies.

Chebyshev(1) iteration over ``[lmax/4, 1.1*lmax]`` of ``D^-1 A`` — the
standard smoothed-aggregation smoothing range.  Factored out because five
cycles share the identical algebra (single-device
:class:`.amg.AMGPreconditioner`, and the distributed halo / slab /
slab-brick / slab-pad hierarchies): a tweak here (interval bounds, step
recurrence) reaches all of them, and the distributed cycles stay
bit-compatible with the single-device hierarchy their P-independence
tests compare against.
"""

from __future__ import annotations

__all__ = ["chebyshev_smooth"]


def chebyshev_smooth(matvec, inv_diag, lmax, smooth_steps, x, b,
                     x_zero: bool = False):
    """Return the Chebyshev-smoothed iterate for ``A x = b``.

    ``matvec``: the level operator (may carry halo collectives inside).
    ``x_zero``: the pre-smooth starts from x = 0, but ``A @ 0`` through a
    sharded matvec with its halo exchange cannot be constant-folded by XLA — skipping it drops one full SpMV per level
    per V-cycle, bit-identically.
    """
    upper = 1.1 * lmax
    lower = lmax / 4.0
    theta = 0.5 * (upper + lower)
    delta = 0.5 * (upper - lower)
    r0 = b if x_zero else b - matvec(x)
    d = (1.0 / theta) * (inv_diag * r0)
    sigma = theta / delta
    rho = 1.0 / sigma
    for _ in range(smooth_steps):
        x = x + d
        res = inv_diag * (b - matvec(x))
        rho_new = 1.0 / (2.0 * sigma - rho)
        d = rho_new * rho * d + (2.0 * rho_new / delta) * res
        rho = rho_new
    return x + d
