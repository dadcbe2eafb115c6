"""Sparse formats and compute kernels (host CSR, device ELL, SpMV)."""

from .csr import CSRMatrix, coo_to_csr
from .ell import ELLMatrix, ell_from_csr, pad_to, pad_vector, unpad_vector
from .spmv import ell_spmv, spmv_bytes
from .dia import DIAMatrix, choose_operator, dia_from_csr, operator_bytes
from .hyb import HYBMatrix, hyb_from_csr, rcm_permute
from .splitell import SplitELLMatrix, splitell_from_csr
from .stencil import (
    StencilOperator,
    stencil_from_csr,
    stencil_from_dia,
    stencil_from_packed,
    stencil_from_parts,
    stencil_parts_from_packed,
)

__all__ = [
    "CSRMatrix",
    "coo_to_csr",
    "ELLMatrix",
    "ell_from_csr",
    "pad_to",
    "pad_vector",
    "unpad_vector",
    "ell_spmv",
    "spmv_bytes",
    "DIAMatrix",
    "dia_from_csr",
    "choose_operator",
    "operator_bytes",
    "HYBMatrix",
    "hyb_from_csr",
    "rcm_permute",
    "SplitELLMatrix",
    "splitell_from_csr",
    "StencilOperator",
    "stencil_from_csr",
    "stencil_from_dia",
    "stencil_from_packed",
    "stencil_from_parts",
    "stencil_parts_from_packed",
]
