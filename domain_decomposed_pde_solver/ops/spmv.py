"""SpMV kernels for the ELL format.

The hot operation of every Krylov iteration (the reference's
``Tpetra::CrsMatrix::apply`` inside Belos GMRES and the power method,
``ExodusMatrixTest.cpp:99-102``).  :func:`ell_spmv` is pure jnp: XLA fuses
gather x multiply x row-sum into one bandwidth-bound loop.  Padding slots are
exact zeros, so padded and logical results agree.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .ell import ELLMatrix

__all__ = ["ell_spmv", "spmv_bytes"]


def ell_spmv(A: ELLMatrix, x_padded: jax.Array) -> jax.Array:
    """y = A @ x with padded shapes: x_padded (n_pad,) -> y (n_pad,).

    Padding rows produce 0; gather of padding cols hits index 0 but is
    multiplied by a 0 value.
    """
    gathered = jnp.take(x_padded, A.cols, axis=0)  # (n_pad, K)
    return jnp.sum(A.vals * gathered, axis=1)


def spmv_bytes(A: ELLMatrix, dtype_bytes: int | None = None) -> int:
    """Minimum HBM traffic of one SpMV, for roofline accounting:
    read vals + cols + x once, write y once (perfect cache for x)."""
    vb = A.vals.dtype.itemsize if dtype_bytes is None else dtype_bytes
    n_pad, k = A.cols.shape
    return n_pad * k * (vb + A.cols.dtype.itemsize) + 2 * n_pad * vb
