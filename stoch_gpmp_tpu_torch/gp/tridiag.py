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
  On a CUDA tensor ``BlockTridiag.cholesky`` and ``cholesky_inverse`` (the
  factor and ``L^{-1} = W^T`` together) are one launch of kernel C1
  (``ops/kernels/block_chol.py``); on a CPU tensor they are the loops
  ``cholesky_loop`` and ``dense_inv_transpose``.
- ``ParallelBidiagSolver``: the same substitutions as affine recurrences
  over time whose transitions depend only on the factor, the long-horizon
  sampler. On a CUDA tensor each solve is one launch of kernel S1
  (``ops/kernels/bidiag_scan.py``); on a CPU tensor it is the log-step
  associative scan ``_affine_assoc_scan`` on per-dim time planes.

Leading batch dimensions on the blocks stand for the JAX package's ``vmap``
(one system per particle in the Gauss-Newton planner): the factor's solves
then take ``b [..., T, d]`` with the same leading dimensions. An unbatched
factor (``diag [T, d, d]``) solves against any ``b [..., T, d]``.

The JAX ``lax.scan`` recurrences are Python loops over the ``T`` blocks of
small batched operations. The prior factors once at construction; the
Gauss-Newton planner's ``cholesky`` method factors in every iteration and
runs the solves' loops.
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
        (unbatched factor) by ``M`` backward substitutions, a loop of ``T``
        steps: the inverse half of C1's plain version. The prior's build
        takes ``L^{-1}`` from ``BlockTridiag.cholesky_inverse``."""
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

    def matvec_planes(self, planes):
        """``matvec`` on per-dim time planes (tuple_d of ``[..., T]``),
        read as one ``[..., T, d]`` batch (``stack_planes``)."""
        return tuple(self.matvec(stack_planes(planes).movedim(0, -1)).unbind(-1))

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
        A block that is not positive definite gives NaN from there on, as in
        the JAX package, and nothing is read back from the device. One
        launch of kernel C1 on CUDA blocks (``ops/kernels/block_chol.py``),
        :meth:`cholesky_loop` on CPU ones."""
        from stoch_gpmp_tpu_torch.ops.kernels.block_chol import block_chol

        return block_chol(self)[0]

    def cholesky_inverse(self) -> tuple[BlockBidiagChol, torch.Tensor]:
        """The factor of :meth:`cholesky` and the dense ``L^{-1} [M, M]``
        (an unbatched system), from one C1 launch on the card."""
        from stoch_gpmp_tpu_torch.ops.kernels.block_chol import block_chol

        return block_chol(self, inverse=True)

    def cholesky_loop(self) -> BlockBidiagChol:
        """:meth:`cholesky` as a loop of ``T`` steps of batched ``d x d``
        operations (C1's plain version)."""
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


# --------------------------------------------------------------------------- #
# Per-dim time planes and the parallel-in-time triangular solves
# --------------------------------------------------------------------------- #


def plane_stride(planes) -> int | None:
    """The storage distance between consecutive planes when the d planes
    ``[..., T]`` are views of one storage with one shape, strides and dtype
    at a uniform positive stride (the plane path's ``[d, ...]`` samples,
    the stride-d planes of a ``[..., T, d]`` tensor); else None."""
    p0 = planes[0]
    if len(planes) == 1:
        return 0
    sp = planes[1].storage_offset() - p0.storage_offset()
    base = p0.untyped_storage().data_ptr()
    if sp <= 0 or any(
            p.shape != p0.shape or p.stride() != p0.stride() or p.dtype != p0.dtype
            or p.device != p0.device or p.untyped_storage().data_ptr() != base
            or p.storage_offset() - p0.storage_offset() != i * sp
            for i, p in enumerate(planes)):
        return None
    return sp


def stack_planes(planes) -> torch.Tensor:
    """The d planes ``[..., T]`` as one ``[d, ..., T]`` tensor: a view where
    they share a storage at a uniform stride (``plane_stride``), else a
    stacked copy."""
    sp = plane_stride(planes)
    if sp is None:
        return torch.stack(planes)
    p0 = planes[0]
    return p0.as_strided((len(planes),) + tuple(p0.shape), (sp,) + tuple(p0.stride()))


def _apply_tri(mats, planes, *, trans: bool):
    """Planes of ``D_t^{-1} b_t`` (``trans``: ``D_t^{-T} b_t``) for
    lower-triangular ``mats [T, d, d]``, skipping the structural zeros."""
    d = len(planes)
    out = []
    for i in range(d):
        acc = None
        for j in range(d):
            lo, hi = (j, i) if trans else (i, j)
            if lo < hi:
                continue
            term = mats[:, lo, hi] * planes[j]
            acc = term if acc is None else acc + term
        out.append(acc)
    return tuple(out)


def _affine_assoc_scan(a_planes, c_planes, d: int):
    """Prefix-compose ``y_t = A_t y_{t-1} + c_t`` over the last axis of the
    planes in ceil(log2 T) levels (Hillis-Steele; the JAX package runs
    ``jax.lax.associative_scan``, another tree of the same combine):
    ``(A2, c2) . (A1, c1) = (A2 A1, A2 c1 + c2)``, unrolled into
    elementwise plane products. ``a_planes``: d*d planes ``[T]`` (entry
    (i, j) at ``i*d + j``, batch-independent); ``c_planes``: d planes
    ``[B, T]``. With ``A_0 = 0`` the t-th prefix's offset is ``y_t``. The
    plain version of kernel S1."""
    a, c = list(a_planes), list(c_planes)
    t = c[0].shape[-1]
    step = 1
    while step < t:
        a_hi = [x[..., step:] for x in a]
        c_new = [
            torch.cat([c[i][..., :step], sum(a_hi[i * d + k] * c[k][..., :-step]
                                             for k in range(d)) + c[i][..., step:]], dim=-1)
            for i in range(d)
        ]
        a = [
            torch.cat([a[i * d + j][..., :step], sum(a_hi[i * d + k] * a[k * d + j][..., :-step]
                                                     for k in range(d))], dim=-1)
            for i in range(d) for j in range(d)
        ]
        c = c_new
        step *= 2
    return tuple(c)


@dataclass
class ParallelBidiagSolver:
    """Parallel-in-time solves for a ``BlockBidiagChol``: ``solve_L`` and
    ``solve_LT`` are the affine recurrences ``y_t = A_t y_{t-1} + D_t^{-1}
    b_t`` (forward) and ``y_t = A_t y_{t+1} + D_t^{-T} b_t`` (backward),
    whose transitions depend only on the factor and are built here once.

    The other fields are the tables kernel S1 reads, per direction
    (``ops/kernels/bidiag_scan.py``; none depends on the batch): ``phi``,
    the product of the transitions from the start of t's chunk of
    ``ops.kernels.bidiag_scan.CHUNK`` steps up to t (forward), or from t to
    the end of its chunk (backward); ``rec``, each step's triangle of
    ``D_t^{-1}`` (``D_t^{-T}`` backward) and ``A_t``, packed, and ``phr``,
    ``phi`` by rows, both padded to whole chunks of steps; ``psi``, the
    products of 1, 2, ..., 32 consecutive chunk transitions that the
    kernel's scan over chunks multiplies by."""

    dinv: torch.Tensor  # [T, d, d] = D_t^{-1} (lower triangular)
    a_fwd: torch.Tensor  # [T, d, d]: A_0 = 0, A_t = -D_t^{-1} L_t
    a_bwd: torch.Tensor  # [T, d, d]: A_{T-1} = 0, A_t = -D_t^{-T} L_{t+1}^T
    phi_fwd: torch.Tensor  # [T, d, d]
    phi_bwd: torch.Tensor  # [T, d, d]
    rec_fwd: torch.Tensor  # [CHUNK ceil(T / CHUNK), rec_width]
    rec_bwd: torch.Tensor  # [CHUNK ceil(T / CHUNK), rec_width]
    phr_fwd: torch.Tensor  # [CHUNK ceil(T / CHUNK), phi_width]
    phr_bwd: torch.Tensor  # [CHUNK ceil(T / CHUNK), phi_width]
    psi_fwd: torch.Tensor  # [SCAN_LEVELS, d * d, ceil(T / CHUNK)]
    psi_bwd: torch.Tensor  # [SCAN_LEVELS, d * d, ceil(T / CHUNK)]

    @property
    def num_blocks(self) -> int:
        return self.dinv.shape[0]

    @property
    def block_dim(self) -> int:
        return self.dinv.shape[-1]

    @classmethod
    def from_chol(cls, chol: BlockBidiagChol) -> "ParallelBidiagSolver":
        """The solver of ``chol``. ``D_t^{-1}`` and the transitions are
        formed in float64 and rounded to the factor's dtype: formed in
        float32 from a factor that is float32's rounding of the exact one,
        the long-horizon prior's transitions put the solves 2e-5 (T = 1024)
        to 6e-5 (T = 4096) of their largest entry from float64, against
        1e-6 formed in float64."""
        d, dtype = chol.block_dim, chol.diag.dtype
        diag, lower = chol.diag.double(), chol.lower.double()
        eye = torch.eye(d, dtype=diag.dtype, device=diag.device)
        dinv = torch.linalg.solve_triangular(diag, eye.expand_as(diag), upper=False)
        zero = diag.new_zeros((1, d, d))
        if chol.num_blocks == 1:
            return cls.from_tables(dinv.to(dtype), zero.to(dtype), zero.to(dtype))
        a_fwd = torch.cat([zero, -dinv[1:] @ lower], dim=0)
        a_bwd = torch.cat([-dinv[:-1].mT @ lower.mT, zero], dim=0)
        return cls.from_tables(dinv.to(dtype), a_fwd.to(dtype), a_bwd.to(dtype))

    @classmethod
    def from_tables(cls, dinv, a_fwd, a_bwd) -> "ParallelBidiagSolver":
        """The solver of ``dinv``, ``a_fwd`` and ``a_bwd``, with S1's chunk
        tables built from them."""
        from stoch_gpmp_tpu_torch.ops.kernels.bidiag_scan import (
            chunk_prefix,
            phi_records,
            scan_products,
            step_records,
        )

        dinv, a_fwd, a_bwd = dinv.contiguous(), a_fwd.contiguous(), a_bwd.contiguous()
        phi_fwd, phi_bwd = chunk_prefix(a_fwd, backward=False), chunk_prefix(a_bwd, backward=True)
        return cls(dinv=dinv, a_fwd=a_fwd, a_bwd=a_bwd, phi_fwd=phi_fwd, phi_bwd=phi_bwd,
                   rec_fwd=step_records(dinv, a_fwd, backward=False),
                   rec_bwd=step_records(dinv, a_bwd, backward=True),
                   phr_fwd=phi_records(phi_fwd), phr_bwd=phi_records(phi_bwd),
                   psi_fwd=scan_products(a_fwd, backward=False),
                   psi_bwd=scan_products(a_bwd, backward=True))

    # --- plane-native API: tuple_d of ``[..., T]`` in and out ----------- #
    def solve_L_planes(self, planes, out=None):
        """Forward substitution on per-dim time planes (one S1 launch on a
        CUDA tensor). The output planes are views of one ``[d, ..., T]``
        tensor, or ``out``'s planes when given."""
        from stoch_gpmp_tpu_torch.ops.kernels.bidiag_scan import bidiag_scan

        return bidiag_scan(self, planes, backward=False, out=out)

    def solve_LT_planes(self, planes, out=None):
        """Backward substitution on per-dim time planes (the sampling hot
        path; one S1 launch on a CUDA tensor)."""
        from stoch_gpmp_tpu_torch.ops.kernels.bidiag_scan import bidiag_scan

        return bidiag_scan(self, planes, backward=True, out=out)

    def _solve(self, b: torch.Tensor, *, backward: bool) -> torch.Tensor:
        """``b [..., T, d]`` through the plane solve: its planes are the
        stride-d views ``b[..., i]``, and the result is written into the
        planes of a ``[..., T, d]`` tensor (no copy on either side)."""
        from stoch_gpmp_tpu_torch.ops.kernels.bidiag_scan import bidiag_scan

        out = torch.empty(b.shape, dtype=b.dtype, device=b.device)
        d = self.block_dim
        bidiag_scan(self, tuple(b.unbind(-1)), backward=backward, out=tuple(out.unbind(-1)))
        return out

    def solve_L(self, b: torch.Tensor) -> torch.Tensor:
        """Forward substitution ``L y = b``, parallel in time."""
        return self._solve(b, backward=False)

    def solve_LT(self, b: torch.Tensor) -> torch.Tensor:
        """Backward substitution ``L^T y = b``, parallel in time (the
        sampling correction ``L^{-T} eps``)."""
        return self._solve(b, backward=True)

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        return self.solve_LT(self.solve_L(b))
