"""Kernel C1: the block Cholesky of a symmetric block-tridiagonal precision
and the dense inverse of its factor, in one launch.

``BlockTridiag.cholesky`` and ``BlockTridiag.cholesky_inverse``
(``gp/tridiag.py``), the GP prior's build and the Gauss-Newton planner's
solve, route here:

- ``block_chol`` launches ``csrc/block_chol.cu`` for a CUDA system: the
  factor ``L`` (``D_t``, ``L_t``; batched over leading dimensions, one CTA
  per entry) and, with ``inverse``, the dense ``L^{-1} [M, M]`` of an
  unbatched system from the same launch. It takes float32 or float64 blocks
  with d up to 16 and raises for any other system off the CPU (there is no
  second path on the card). The chain runs in
  float64 whatever the dtype; every entry above the diagonal of ``L^{-1}``
  is an exact 0; a block that is not positive definite makes its ``D_t``
  and every later one NaN, with nothing read back. d = 2, 4 and 14 are
  compiled in; any other d takes the runtime-d instantiation, counted in
  ``.generic_launches``.
- A CPU system takes the plain version, the Python loops of
  ``gp/tridiag.py`` (``cholesky_loop``, then ``dense_inv_transpose``).

Launches are counted in ``block_chol.launches``.
"""

from __future__ import annotations

import torch

from stoch_gpmp_tpu_torch.ops.kernels import _build

MAX_D = 16
# the block sizes csrc/block_chol.cu compiles in: the per-dof factor's, the
# planar robot's and the Panda's
UNROLLED = (2, 4, 14)


def check_blocks(t, d: int) -> None:
    """Raises unless C1 takes blocks like ``t`` of size ``d``: CUDA, float32
    or float64, d up to 16."""
    if (t.device.type != "cuda" or t.dtype not in (torch.float32, torch.float64)
            or not 1 <= d <= MAX_D):
        raise ValueError(f"C1 takes float32 or float64 CUDA blocks of size 1 to {MAX_D}, got "
                         f"{t.dtype} blocks of size {d} on {t.device}")


def block_chol_plain(system, *, inverse: bool = False):
    """The plain version of ``block_chol``: ``(factor, L^{-1} or None)`` by
    the loops of ``gp/tridiag.py``."""
    chol = system.cholesky_loop()
    return chol, chol.dense_inv_transpose().T if inverse else None


def block_chol(system, *, inverse: bool = False):
    """``system``'s (a ``BlockTridiag``) block Cholesky factor, a
    ``BlockBidiagChol``, and with ``inverse`` the dense ``L^{-1} [M, M]``
    (an unbatched system), else None: one C1 launch for a CUDA system, the
    plain version for a CPU one."""
    from stoch_gpmp_tpu_torch.gp.tridiag import BlockBidiagChol

    if system.diag.device.type == "cpu":
        return block_chol_plain(system, inverse=inverse)
    check_blocks(system.diag, system.block_dim)
    diag, lower = _blocks(system.diag, system.lower)
    dout, lout = torch.empty_like(diag), torch.empty_like(lower)
    linv = _launch(diag, lower, dout, lout, inverse)
    return BlockBidiagChol(diag=dout, lower=lout), linv


def _blocks(diag, lower):
    """``diag`` and ``lower`` with their leading dimensions broadcast to one
    shape, contiguous, as the kernel reads them."""
    if lower.dtype != diag.dtype or lower.device != diag.device:
        raise ValueError(f"C1 takes diag and lower of one dtype and device, got {diag.dtype} "
                         f"on {diag.device} and {lower.dtype} on {lower.device}")
    t, d = diag.shape[-3], diag.shape[-1]
    if diag.shape[-2] != d or tuple(lower.shape[-3:]) != (t - 1, d, d):
        raise ValueError(f"C1 takes diag [..., T, d, d] and lower [..., T-1, d, d], got "
                         f"{list(diag.shape)} and {list(lower.shape)}")
    if diag.shape[:-3] == lower.shape[:-3]:
        return diag.contiguous(), lower.contiguous()
    # torch.broadcast_shapes would import sympy (seconds) on its first call
    lead = torch.broadcast_tensors(diag[..., :1, :1, :1], lower[..., :1, :1, :1])[0].shape[:-3]
    return (diag.expand(lead + diag.shape[-3:]).contiguous(),
            lower.expand(lead + lower.shape[-3:]).contiguous())


def _launch(diag, lower, dout, lout, inverse):
    """One C1 launch on contiguous blocks; returns ``L^{-1}`` or None."""
    lead, t, d = diag.shape[:-3], diag.shape[-3], diag.shape[-1]
    if inverse and lead:
        raise ValueError(f"C1 builds L^{{-1}} of an unbatched system, got blocks "
                         f"{list(diag.shape)}")
    m = t * d
    linv = torch.empty((m, m), dtype=diag.dtype, device=diag.device) if inverse else None
    b = diag.numel() // max(t * d * d, 1)
    if b == 0 or t == 0:
        return linv
    err = _build.load_library().block_chol_launch(
        diag.data_ptr(), lower.data_ptr() if t > 1 else None, dout.data_ptr(),
        lout.data_ptr() if t > 1 else None, None if linv is None else linv.data_ptr(),
        b, t, d, int(diag.dtype == torch.float64), _build.stream_ptr(diag.device),
    )
    _build.check(err, "block_chol_launch")
    block_chol.launches += 1
    block_chol.generic_launches += int(d not in UNROLLED)
    return linv


block_chol.launches = 0
block_chol.generic_launches = 0
