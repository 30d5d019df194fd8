"""Linear algebra (counterpart of ``paddle_tpu/ops/linalg.py``).

``matmul`` is ``torch.matmul`` (cuBLAS on the card); the decompositions go
over ``torch.linalg``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.dispatch import apply_op


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    def _matmul(a, b):
        if transpose_x and a.dim() >= 2:
            a = a.transpose(-2, -1)
        if transpose_y and b.dim() >= 2:
            b = b.transpose(-2, -1)
        return torch.matmul(a, b)

    return apply_op(_matmul, x, y, _op_name="matmul")


mm = matmul


def bmm(x, y, name=None):
    return apply_op(torch.matmul, x, y, _op_name="bmm")


def dot(x, y, name=None):
    return apply_op(lambda a, b: torch.sum(a * b, -1), x, y, _op_name="dot")


def mv(x, vec, name=None):
    return apply_op(torch.matmul, x, vec, _op_name="mv")


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    return apply_op(lambda i, a, b: beta * i + alpha * torch.matmul(a, b),
                    input, x, y, _op_name="addmm")


def einsum(equation, *operands):
    return apply_op(lambda ops: torch.einsum(equation, *ops), list(operands),
                    _op_name="einsum")


def tensordot(x, y, axes=2, name=None):
    dims = axes if isinstance(axes, int) else [list(a) for a in axes]
    return apply_op(lambda a, b: torch.tensordot(a, b, dims=dims), x, y,
                    _op_name="tensordot")


def cross(x, y, axis=9, name=None):
    def _cross(a, b):
        ax = axis
        if ax == 9:
            ax = next(i for i, s in enumerate(a.shape) if s == 3)
        return torch.linalg.cross(a, b, dim=ax)

    return apply_op(_cross, x, y, _op_name="cross")


def _ax(axis):
    return tuple(axis) if isinstance(axis, (list, tuple)) else axis


def norm(x, p=None, axis=None, keepdim=False, name=None):
    """``jnp.linalg.norm``'s rules: with no axis the Frobenius norm (for
    ``p`` None or ``"fro"``) or the vector norm of the flattened tensor;
    with one axis a vector norm; with two a matrix norm."""
    def _norm(a):
        ax = _ax(axis)
        if p is None or p == "fro":
            if ax is None:
                return torch.sqrt(torch.sum(torch.square(torch.abs(a))))
            if isinstance(ax, tuple) and len(ax) == 2:
                return torch.linalg.matrix_norm(a, "fro", ax, keepdim)
            return torch.linalg.vector_norm(a, 2, ax, keepdim)
        if p == "nuc":
            return torch.linalg.matrix_norm(a, "nuc", ax or (-2, -1), keepdim)
        ordv = float("inf") if p == "inf" else p
        if ax is None:
            return torch.linalg.vector_norm(a.reshape(-1), ordv)
        if isinstance(ax, tuple) and len(ax) == 2:
            return torch.linalg.matrix_norm(a, ordv, ax, keepdim)
        return torch.linalg.vector_norm(a, ordv, ax, keepdim)

    return apply_op(_norm, x, _op_name="norm")


def vector_norm(x, p=2.0, axis=None, keepdim=False, name=None):
    return apply_op(lambda a: torch.linalg.vector_norm(a, p, _ax(axis),
                                                       keepdim), x,
                    _op_name="vector_norm")


def matrix_norm(x, p="fro", axis=(-2, -1), keepdim=False, name=None):
    return apply_op(lambda a: torch.linalg.matrix_norm(a, p, tuple(axis),
                                                       keepdim), x,
                    _op_name="matrix_norm")


def dist(x, y, p=2, name=None):
    return apply_op(lambda a, b: torch.linalg.vector_norm((a - b).reshape(-1),
                                                          p), x, y,
                    _op_name="dist")


def cdist(x, y, p=2.0, compute_mode="use_mm_for_euclid_dist_if_necessary",
          name=None):
    def _cdist(a, b):
        diff = a[..., :, None, :] - b[..., None, :, :]
        if p == 2.0:
            return torch.sqrt(torch.sum(diff * diff, -1) + 1e-30)
        return torch.sum(torch.abs(diff) ** p, -1) ** (1.0 / p)

    return apply_op(_cdist, x, y, _op_name="cdist")


def t(input, name=None):
    from .manipulation import t as _t

    return _t(input)


def transpose(x, perm, name=None):
    from .manipulation import transpose as _transpose

    return _transpose(x, perm)


def cholesky(x, upper=False, name=None):
    return apply_op(lambda a: torch.linalg.cholesky(a, upper=upper), x,
                    _op_name="cholesky")


def cholesky_solve(x, y, upper=False, name=None):
    return apply_op(lambda b, l: torch.cholesky_solve(b, l, upper), x, y,
                    _op_name="cholesky_solve")


def inverse(x, name=None):
    return apply_op(torch.linalg.inv, x, _op_name="inverse")


inv = inverse


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return apply_op(lambda a: torch.linalg.pinv(a, rtol=rcond,
                                                hermitian=hermitian), x,
                    _op_name="pinv")


def solve(x, y, name=None):
    return apply_op(torch.linalg.solve, x, y, _op_name="solve")


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    def _ts(a, b):
        if transpose:
            a, up = a.transpose(-2, -1), not upper
        else:
            up = upper
        return torch.linalg.solve_triangular(a, b, upper=up,
                                             unitriangular=unitriangular)

    return apply_op(_ts, x, y, _op_name="triangular_solve")


def lu(x, pivot=True, get_infos=False, name=None):
    def _lu(a):
        lu_mat, piv = torch.linalg.lu_factor(a, pivot=pivot)
        piv = piv.to(torch.int32)
        if get_infos:
            return lu_mat, piv, torch.zeros((), dtype=torch.int32,
                                            device=a.device)
        return lu_mat, piv

    return apply_op(_lu, x, _op_name="lu")


def svd(x, full_matrices=False, name=None):
    def _svd(a):
        u, s, vh = torch.linalg.svd(a, full_matrices=full_matrices)
        return u, s, vh.transpose(-2, -1)  # Paddle returns V, not V^H

    return apply_op(_svd, x, _op_name="svd")


def qr(x, mode="reduced", name=None):
    def _qr(a):
        q, r = torch.linalg.qr(a, mode=mode)
        return r if mode == "r" else (q, r)

    return apply_op(_qr, x, _op_name="qr")


def eig(x, name=None):
    return apply_op(lambda a: tuple(torch.linalg.eig(a)), x, _op_name="eig")


def eigh(x, UPLO="L", name=None):
    return apply_op(lambda a: tuple(torch.linalg.eigh(a, UPLO)), x,
                    _op_name="eigh")


def eigvals(x, name=None):
    return apply_op(torch.linalg.eigvals, x, _op_name="eigvals")


def eigvalsh(x, UPLO="L", name=None):
    return apply_op(lambda a: torch.linalg.eigvalsh(a, UPLO), x,
                    _op_name="eigvalsh")


def det(x, name=None):
    return apply_op(torch.linalg.det, x, _op_name="det")


def slogdet(x, name=None):
    def _slogdet(a):
        sign, logdet = torch.linalg.slogdet(a)
        return torch.stack([sign, logdet])

    return apply_op(_slogdet, x, _op_name="slogdet")


def matrix_power(x, n, name=None):
    return apply_op(lambda a: torch.linalg.matrix_power(a, n), x,
                    _op_name="matrix_power")


def matrix_rank(x, tol=None, hermitian=False, name=None):
    return apply_op(lambda a: torch.linalg.matrix_rank(
        a, rtol=tol, hermitian=hermitian).to(torch.int64), x,
        _op_name="matrix_rank")


def lstsq(x, y, rcond=None, driver=None, name=None):
    def _lstsq(a, b):
        sol, res, rank, sv = torch.linalg.lstsq(a, b, rcond=rcond,
                                                driver=driver)
        return sol, res, rank.to(torch.int64), sv

    return apply_op(_lstsq, x, y, _op_name="lstsq")


def multi_dot(x, name=None):
    return apply_op(torch.linalg.multi_dot, list(x), _op_name="multi_dot")


def corrcoef(x, rowvar=True, name=None):
    return apply_op(lambda a: torch.corrcoef(a if rowvar else a.T), x,
                    _op_name="corrcoef")


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    return apply_op(lambda a, fw, aw: torch.cov(
        a if rowvar else a.T, correction=int(bool(ddof)), fweights=fw,
        aweights=aw), x, fweights, aweights, _op_name="cov")


def histogram(input, bins=100, min=0, max=0, weight=None, density=False,
              name=None):
    """Counts over ``bins`` equal bins of ``[min, max]`` (the data's range
    when both are 0); int64 counts unless weighted or ``density``."""
    def _hist(a, w):
        a = a.reshape(-1)
        lo, hi = (min, max) if (min != 0 or max != 0) else (
            float(a.min()), float(a.max()))
        if w is None and not density:
            return torch.histc(a.float(), bins, lo, hi).to(torch.int64)
        h, _ = torch.histogram(a.float().cpu(), bins, range=(lo, hi),
                               weight=None if w is None
                               else w.reshape(-1).float().cpu(),
                               density=density)
        return h.to(a.device)

    return apply_op(_hist, input, weight, _op_name="histogram")


def histogramdd(x, bins=10, ranges=None, density=False, weights=None,
                name=None):
    def _histdd(a, w):
        h, edges = torch.histogramdd(
            a.float().cpu(), bins, range=None if ranges is None
            else [float(r) for r in np.asarray(ranges).reshape(-1)],
            weight=None if w is None else w.float().cpu(), density=density)
        return h.to(a.device), [e.to(a.device) for e in edges]

    return apply_op(_histdd, x, weights, _op_name="histogramdd")


def bincount(x, weights=None, minlength=0, name=None):
    return apply_op(lambda a, w: torch.bincount(a, w, minlength), x, weights,
                    _op_name="bincount")


def householder_product(x, tau, name=None):
    return apply_op(torch.linalg.householder_product, x, tau,
                    _op_name="householder_product")


__all__ = [n for n, v in list(globals().items())
           if not n.startswith("_") and callable(v)
           and getattr(v, "__module__", None) == __name__]
