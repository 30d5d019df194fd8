"""``paddle.linalg`` (counterpart of ``paddle_tpu/linalg_ns.py``): the
linear algebra of ``ops/linalg.py`` under the reference's names, and the
namespace's own tail.

Differences from the reference:

- ``svd_lowrank`` and ``pca_lowrank`` draw their test matrix from a
  ``torch.Generator`` seeded with 0 on the input's device (the reference
  keys ``PRNGKey(0)``): other numbers, the same factorisation up to the
  sketch's error;
- ``lu_unpack`` is ``torch.lu_unpack`` and ``ormqr`` ``torch.ormqr`` (the
  reference builds the permutation and Q itself; the results are the
  same matrices);
- ``fp8_fp8_half_gemm_fused`` multiplies e4m3 codes: on the card through
  ``torch._scaled_mm`` (``quant/gemm.py``), on the CPU through its plain
  version (the codes upcast to f32); the reference multiplies in bf16.
"""
from __future__ import annotations

import torch

from .core.dispatch import apply_op
from .ops.compat import matrix_transpose, vecdot  # noqa: F401
from .ops.linalg import (  # noqa: F401
    cholesky, cholesky_solve, cov, corrcoef, cross, det, dot, eig, eigh,
    eigvals, eigvalsh, householder_product, inv, lstsq, lu, matmul,
    matrix_norm, matrix_power, matrix_rank, multi_dot, norm, pinv, qr,
    slogdet, solve, svd, triangular_solve, vector_norm)

__all__ = [
    "cholesky", "cholesky_solve", "cov", "corrcoef", "det", "eig", "eigh",
    "eigvals", "eigvalsh", "inv", "lstsq", "lu", "matrix_norm",
    "matrix_power", "matrix_rank", "multi_dot", "norm", "pinv", "qr",
    "slogdet", "solve", "svd", "triangular_solve", "vector_norm",
    "householder_product", "matmul", "dot", "cholesky_inverse", "vecdot",
    "cond", "cross", "matrix_transpose", "svdvals", "diagonal",
    "matrix_exp", "svd_lowrank", "pca_lowrank", "lu_unpack", "ormqr",
    "fp8_fp8_half_gemm_fused"]


def cholesky_inverse(x, upper=False, name=None):
    return apply_op(lambda a: torch.cholesky_inverse(a, upper=upper), x,
                    _op_name="cholesky_inverse")


def cond(x, p=None, name=None):
    """Condition number: the ratio of extreme singular values for ``p``
    None or 2, else ``norm(x, p) * norm(inv(x), p)``."""
    def _cond(a):
        if p is None or p == 2:
            s = torch.linalg.svdvals(a)
            return s[..., 0] / s[..., -1]
        return (torch.linalg.matrix_norm(a, ord=p)
                * torch.linalg.matrix_norm(torch.linalg.inv(a), ord=p))

    return apply_op(_cond, x, _op_name="cond")


def svdvals(x, name=None):
    return apply_op(torch.linalg.svdvals, x, _op_name="svdvals")


def diagonal(x, offset=0, axis1=-2, axis2=-1, name=None):
    return apply_op(lambda a: torch.diagonal(a, offset, axis1, axis2), x,
                    _op_name="diagonal")


def matrix_exp(x, name=None):
    return apply_op(torch.linalg.matrix_exp, x, _op_name="matrix_exp")


def _randomized_svd(a, qq, niter):
    """Halko et al.'s randomized SVD, shared by ``svd_lowrank`` and
    ``pca_lowrank``."""
    g = torch.Generator(device=a.device).manual_seed(0)
    omega = torch.randn(a.shape[:-2] + (a.shape[-1], qq), generator=g,
                        dtype=a.dtype, device=a.device)
    y = a @ omega
    at = a.transpose(-1, -2)
    for _ in range(niter):
        y = a @ (at @ y)
    qmat, _ = torch.linalg.qr(y)
    u, s, vh = torch.linalg.svd(qmat.transpose(-1, -2) @ a,
                                full_matrices=False)
    return qmat @ u, s, vh.transpose(-1, -2)


def svd_lowrank(x, q=6, niter=2, M=None, name=None):
    def _svl(a, m):
        if m is not None:
            a = a - m
        return _randomized_svd(a, min(q, a.shape[-2], a.shape[-1]), niter)

    return apply_op(_svl, x, M, _op_name="svd_lowrank")


def pca_lowrank(x, q=None, center=True, niter=2, name=None):
    def _pca(a):
        if center:
            a = a - a.mean(dim=-2, keepdim=True)
        return _randomized_svd(a, q or min(6, a.shape[-2], a.shape[-1]),
                               niter)

    return apply_op(_pca, x, _op_name="pca_lowrank")


def lu_unpack(x, y, unpack_ludata=True, unpack_pivots=True, name=None):
    """``(P, L, U)`` of an LU factorisation and its 1-based pivots."""
    return apply_op(lambda lu_, piv: torch.lu_unpack(lu_, piv.to(torch.int32)),
                    x, y, _op_name="lu_unpack")


def ormqr(x, tau, y, left=True, transpose=False, name=None):
    """Q (from geqrf's reflectors and ``tau``) applied to y."""
    return apply_op(lambda a, t, o: torch.ormqr(a, t, o, left=left,
                                                transpose=transpose),
                    x, tau, y, _op_name="ormqr")


def fp8_fp8_half_gemm_fused(x, y, bias=None, transpose_x=False,
                            transpose_y=False, scale=1.0,
                            output_dtype="float16", name=None):
    """``(x @ y) * scale + bias`` over e4m3 codes of x and y (unit scales),
    in ``output_dtype``."""
    from .quant.gemm import _scaled_matmul_fwd

    out_t = torch.float16 if output_dtype == "float16" else torch.bfloat16

    def _g(a, b, c):
        if transpose_x:
            a = a.transpose(-1, -2)
        if transpose_y:
            b = b.transpose(-1, -2)
        a, b = a.float(), b.float()
        one = a.new_ones(())
        out = _scaled_matmul_fwd("fp8", a, b, one, one) * scale
        if c is not None:
            out = out + c
        return out.to(out_t)

    return apply_op(_g, x, y, bias, _op_name="fp8_gemm")
