"""Symmetric block-tridiagonal matrices in structured (square-root) form.

PyTorch counterpart of ``stoch_gpmp_tpu/gp/tridiag.py``:

- ``BlockTridiag``: blocks ``diag [..., T, d, d]`` and ``lower [..., T-1, d,
  d]`` (block ``(t+1, t)``); ``to_dense``, an O(T d^2) ``matvec`` and the
  O(T d^3) block ``cholesky`` that only ever factors ``d x d`` blocks, so
  float32 survives the extreme sigma ratios a dense factorization needs
  float64 for.
- ``BlockBidiagChol``: its lower block-bidiagonal factor with the
  structured triangular solves, ``solve`` and ``dense_inv_transpose``
  (``W = L^{-T}``, built once so that sampling is one matmul per iteration).

Leading batch dimensions on the blocks stand for the JAX package's ``vmap``
(one system per particle in the Gauss-Newton planner): the factor's solves
then take ``b [..., T, d]`` with the same leading dimensions. An unbatched
factor (``diag [T, d, d]``) solves against any ``b [..., T, d]``.

The JAX ``lax.scan`` recurrences are Python loops over the ``T`` blocks of
small batched operations. The prior runs them once at construction; the
Gauss-Newton planner's ``cholesky`` method runs them in every iteration.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch


def _tri_solve(a: torch.Tensor, b: torch.Tensor, *, trans: bool) -> torch.Tensor:
    """Solve ``a y = b`` (or ``a^T y = b``) for lower-triangular ``a``:
    ``a [d, d]`` against a batch ``b [..., d]``, or ``a [..., d, d]``
    against ``b [..., d]`` with the same leading dimensions."""
    if a.dim() > 2:
        rhs = b[..., None]
        y = (torch.linalg.solve_triangular(a.mT, rhs, upper=True) if trans
             else torch.linalg.solve_triangular(a, rhs, upper=False))
        return y[..., 0]
    batch_shape = b.shape[:-1]
    d = b.shape[-1]
    bt = b.reshape(-1, d).T  # [d, B]
    if trans:
        y = torch.linalg.solve_triangular(a.T, bt, upper=True)
    else:
        y = torch.linalg.solve_triangular(a, bt, upper=False)
    return y.T.reshape(*batch_shape, d)


def _block_apply(mat: torch.Tensor, y: torch.Tensor, *, trans: bool) -> torch.Tensor:
    """``mat y`` (or ``mat^T y``) for ``y [..., d]``: one ``[d, d]`` block
    for the whole batch, or ``[..., d, d]`` blocks per batch entry."""
    if mat.dim() > 2:
        return ((mat.mT if trans else mat) @ y[..., None])[..., 0]
    return y @ (mat if trans else mat.T)


def _scatter_blocks(dense, blocks, rows, cols, d):
    """Place ``blocks [..., k, d, d]`` at block coordinates ``(rows, cols)``
    of ``dense [..., T*d, T*d]``."""
    lead = dense.shape[:-2]
    t = dense.shape[-1] // d
    dense = dense.reshape(lead + (t, d, t, d))
    dense[..., rows, :, cols, :] = blocks.movedim(-3, 0)
    return dense.reshape(lead + (t * d, t * d))


@dataclass
class BlockBidiagChol:
    """Lower block-bidiagonal Cholesky factor ``L``: ``diag[..., t]`` lower
    triangular ``d x d``; ``lower[..., t]`` at block ``(t+1, t)``."""

    diag: torch.Tensor  # [..., T, d, d]
    lower: torch.Tensor  # [..., T-1, d, d]

    @property
    def num_blocks(self) -> int:
        return self.diag.shape[-3]

    @property
    def block_dim(self) -> int:
        return self.diag.shape[-1]

    def to_dense(self) -> torch.Tensor:
        t, d = self.num_blocks, self.block_dim
        dense = self.diag.new_zeros(self.diag.shape[:-3] + (t * d, t * d))
        idx = torch.arange(t, device=self.diag.device)
        dense = _scatter_blocks(dense, self.diag, idx, idx, d)
        if t > 1:
            dense = _scatter_blocks(dense, self.lower, idx[1:], idx[:-1], d)
        return dense

    def solve_L(self, b: torch.Tensor) -> torch.Tensor:
        """Forward substitution ``L y = b`` for ``b [..., T, d]``."""
        ys = [_tri_solve(self.diag[..., 0, :, :], b[..., 0, :], trans=False)]
        for t in range(1, self.num_blocks):
            rhs = b[..., t, :] - _block_apply(self.lower[..., t - 1, :, :], ys[-1], trans=False)
            ys.append(_tri_solve(self.diag[..., t, :, :], rhs, trans=False))
        return torch.stack(ys, dim=-2)

    def solve_LT(self, b: torch.Tensor) -> torch.Tensor:
        """Backward substitution ``L^T y = b`` for ``b [..., T, d]``."""
        t_last = self.num_blocks - 1
        ys = [_tri_solve(self.diag[..., t_last, :, :], b[..., t_last, :], trans=True)]
        for t in range(t_last - 1, -1, -1):
            rhs = b[..., t, :] - _block_apply(self.lower[..., t, :, :], ys[-1], trans=True)
            ys.append(_tri_solve(self.diag[..., t, :, :], rhs, trans=True))
        return torch.stack(ys[::-1], dim=-2)

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        """Solve ``(L L^T) x = b`` for ``b [..., T, d]``."""
        return self.solve_LT(self.solve_L(b))

    def logdet(self) -> torch.Tensor:
        """log-determinant of ``L L^T`` (unbatched factor)."""
        return 2.0 * torch.log(torch.diagonal(self.diag, dim1=-2, dim2=-1)).sum()

    def dense_inv_transpose(self) -> torch.Tensor:
        """Materialize ``W = L^{-T}`` as a dense ``[M, M]`` matrix
        (unbatched factor)."""
        t, d = self.num_blocks, self.block_dim
        m = t * d
        eye = torch.eye(m, dtype=self.diag.dtype, device=self.diag.device)
        cols = self.solve_LT(eye.reshape(m, t, d))  # column j solved for e_j
        return cols.reshape(m, m).T


@dataclass
class BlockTridiag:
    """Symmetric block-tridiagonal matrix: ``diag [..., T, d, d]`` and
    ``lower [..., T-1, d, d]`` at block ``(t+1, t)``."""

    diag: torch.Tensor
    lower: torch.Tensor

    @property
    def num_blocks(self) -> int:
        return self.diag.shape[-3]

    @property
    def block_dim(self) -> int:
        return self.diag.shape[-1]

    def to_dense(self) -> torch.Tensor:
        t, d = self.num_blocks, self.block_dim
        dense = self.diag.new_zeros(self.diag.shape[:-3] + (t * d, t * d))
        idx = torch.arange(t, device=self.diag.device)
        dense = _scatter_blocks(dense, self.diag, idx, idx, d)
        if t > 1:
            dense = _scatter_blocks(dense, self.lower, idx[1:], idx[:-1], d)
            dense = _scatter_blocks(dense, self.lower.mT, idx[:-1], idx[1:], d)
        return dense

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """Apply to ``x [..., T, d]`` in O(T d^2) (unbatched blocks):
        ``out_t = B_t x_t + C_t x_{t-1} + C_{t+1}^T x_{t+1}``."""
        out = torch.einsum("tij,...tj->...ti", self.diag, x)
        if self.num_blocks > 1:
            lo = torch.einsum("tij,...tj->...ti", self.lower, x[..., :-1, :])
            up = torch.einsum("tji,...tj->...ti", self.lower, x[..., 1:, :])
            out = out.clone()
            out[..., 1:, :] += lo
            out[..., :-1, :] += up
        return out

    def add_block_diag(self, blocks: torch.Tensor) -> "BlockTridiag":
        """Add per-step ``[..., T, d, d]`` (or broadcastable) blocks to the
        diagonal."""
        return replace(self, diag=self.diag + blocks)

    def add_jitter(self, eps: float) -> "BlockTridiag":
        eye = torch.eye(self.block_dim, dtype=self.diag.dtype, device=self.diag.device)
        return replace(self, diag=self.diag + eps * eye)

    def cholesky(self) -> BlockBidiagChol:
        """Block Cholesky ``A = L L^T``, batched over leading dimensions:
        per step ``L_t = C_t D_{t-1}^{-T}``, ``D_t D_t^T = B_t - L_t L_t^T``.
        A block that is not positive definite gives NaN, as in the JAX
        package, and nothing is read back from the device."""
        d_prev = cholesky_nan(self.diag[..., 0, :, :])
        ds, ls = [d_prev], []
        for t in range(1, self.num_blocks):
            c_t = self.lower[..., t - 1, :, :]
            l_t = torch.linalg.solve_triangular(d_prev, c_t.mT, upper=False).mT
            d_prev = cholesky_nan(self.diag[..., t, :, :] - l_t @ l_t.mT)
            ds.append(d_prev)
            ls.append(l_t)
        lower = (
            torch.stack(ls, dim=-3) if ls
            else self.diag.new_zeros(self.diag.shape[:-3] + (0,) + tuple(self.diag.shape[-2:]))
        )
        return BlockBidiagChol(diag=torch.stack(ds, dim=-3), lower=lower)


def cholesky_nan(a: torch.Tensor) -> torch.Tensor:
    """Cholesky factor of ``a [..., d, d]`` without a host check; NaN where
    a matrix is not positive definite."""
    chol, info = torch.linalg.cholesky_ex(a)
    bad = (info != 0)[..., None, None]
    return torch.where(bad, torch.full_like(chol, float("nan")), chol)
