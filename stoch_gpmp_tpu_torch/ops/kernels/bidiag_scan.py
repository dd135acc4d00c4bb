"""Kernel S1: the block-bidiagonal substitution on planes.

``ParallelBidiagSolver.solve_L_planes`` / ``solve_LT_planes`` (the
long-horizon sampler) solve ``L y = b`` or ``L^T y = b`` for a lower
block-bidiagonal ``L`` as the affine recurrence ``y_t = A_t y_{t-1} + c_t``
with ``c_t = D_t^{-1} b_t`` (forward), or ``y_t = A_t y_{t+1} + c_t`` with
``c_t = D_t^{-T} b_t`` (backward). The JAX package runs it as XLA's
``associative_scan`` (``stoch_gpmp_tpu/gp/tridiag.py:259``); no Pallas
kernel. Here:

- ``bidiag_scan`` launches ``csrc/bidiag_scan.cu`` for a CUDA tensor: one
  launch per solve, float32 or float64, d even up to 16, the d planes
  ``[..., T]`` read and written through their strides. A time chunk of
  ``CHUNK`` steps per thread runs the recurrence from a zero carry; the
  carries cross the chunks, and each chunk adds ``phi_t carry`` (see the
  source for the design; the launcher picks the launch shape). d = 4 and
  14 are compiled in; any other d takes the runtime-d instantiation,
  counted in ``.generic_launches``. A CPU tensor takes
  ``bidiag_scan_plain``.
- ``bidiag_scan_plain`` is the plain version: ``_apply_tri`` and the
  log-step ``_affine_assoc_scan`` of ``gp/tridiag.py`` (about
  ``log2 T (d^3 + d^2)`` elementwise plane operations per solve).
- ``chunk_prefix`` builds the ``phi`` tables the kernel reads, once per
  factor.

The kernel never gives way to the plain version: a dtype, a block size or a
device it does not take raises.
"""

from __future__ import annotations

import torch

from stoch_gpmp_tpu_torch.ops.kernels import _build

# time steps per chunk of the phi tables: csrc/bidiag_scan.cu kChunk (the
# launcher refuses tables of another chunk)
CHUNK = 32
# the block sizes csrc/bidiag_scan.cu compiles in (the planar robot's and
# the Panda's); any other takes its runtime-d instantiation
UNROLLED = (4, 14)


def chunk_prefix(a: torch.Tensor, *, backward: bool) -> torch.Tensor:
    """``phi [T, d, d]`` of the transitions ``a [T, d, d]``: with chunks of
    ``CHUNK`` steps, ``phi_t = A_t A_{t-1} ... A_{t0}`` from the start t0 of
    t's chunk (forward), or ``phi_t = A_t A_{t+1} ... A_{t1}`` to its end
    t1 (backward). A chunk's whole product is its transition: ``phi`` at
    its last step (forward) or its first (backward)."""
    t, d = a.shape[0], a.shape[-1]
    n = -(-t // CHUNK)
    eye = torch.eye(d, dtype=a.dtype, device=a.device)
    ap = torch.cat([a, eye.expand(n * CHUNK - t, d, d)]).reshape(n, CHUNK, d, d)
    phi = torch.empty_like(ap)
    order = range(CHUNK - 1, -1, -1) if backward else range(CHUNK)
    prev = None
    for j in order:
        prev = ap[:, j] if prev is None else ap[:, j] @ prev
        phi[:, j] = prev
    return phi.reshape(n * CHUNK, d, d)[:t].contiguous()


def bidiag_scan_plain(dinv, a, planes, *, backward: bool):
    """Plain PyTorch version: ``c = D^{-1} b`` (``D^{-T} b`` backward) and
    the log-step scan of ``y_t = A_t y_{t-+1} + c_t`` on the planes
    (backward: on reversed time). ``planes``: d planes ``[..., T]``;
    returns d planes of the same shape."""
    from stoch_gpmp_tpu_torch.gp.tridiag import _affine_assoc_scan, _apply_tri

    d = len(planes)
    shape = planes[0].shape
    flat = tuple(p.reshape(-1, shape[-1]) for p in planes)
    c = _apply_tri(dinv, flat, trans=backward)
    a_planes = tuple(a[:, i, j] for i in range(d) for j in range(d))
    if backward:
        c = tuple(torch.flip(p, dims=(-1,)) for p in c)
        a_planes = tuple(torch.flip(p, dims=(-1,)) for p in a_planes)
    y = _affine_assoc_scan(a_planes, c, d)
    if backward:
        y = tuple(torch.flip(p, dims=(-1,)) for p in y)
    return tuple(p.reshape(shape) for p in y)


def _layout(planes):
    """``(first plane, plane stride, batch stride, time stride, B, T)`` when
    the d planes ``[..., T]`` are views of one storage at a uniform plane
    stride (``gp.tridiag.plane_stride``) whose batch dimensions collapse to
    one stride; else None."""
    from stoch_gpmp_tpu_torch.gp.tridiag import plane_stride

    sp = plane_stride(planes)
    if sp is None:
        return None
    p0 = planes[0]
    shape, strides = p0.shape, p0.stride()
    t = shape[-1]
    dims = [(n, s) for n, s in zip(shape[:-1], strides[:-1]) if n != 1]
    b = 1
    for n, _ in dims:
        b *= n
    for (_, s_outer), (n_inner, s_inner) in zip(dims, dims[1:]):
        if s_outer != s_inner * n_inner:
            return None
    sb = dims[-1][1] if dims else t
    return p0, sp, sb, strides[-1], b, t


def bidiag_scan(solver, planes, *, backward: bool, out=None):
    """``solver``'s substitution on the d planes ``[..., T]`` (forward ``L y
    = b``, or ``backward`` ``L^T y = b``): kernel S1 for a CUDA tensor, the
    plain version for a CPU tensor. ``out``: d planes to write the result
    into (allocated as one ``[d, ..., T]`` tensor when None); returns the
    output planes."""
    d = solver.block_dim
    if len(planes) != d:
        raise ValueError(f"expected {d} planes, got {len(planes)}")
    if planes[0].device.type == "cpu":
        return plain_solve(solver, planes, backward=backward, out=out)
    return _launch(solver, planes, backward, out)


def plain_solve(solver, planes, *, backward: bool, out=None):
    """``bidiag_scan`` through the plain version, on any device."""
    a = solver.a_bwd if backward else solver.a_fwd
    y = bidiag_scan_plain(solver.dinv, a, planes, backward=backward)
    if out is None:
        return y
    for o, v in zip(out, y):
        o.copy_(v)
    return tuple(out)


def _launch(solver, planes, backward, out):
    x0 = planes[0]
    d, t = solver.block_dim, solver.num_blocks
    tables = (solver.dinv, solver.a_bwd if backward else solver.a_fwd,
              solver.phi_bwd if backward else solver.phi_fwd)
    if x0.device.type != "cuda" or x0.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"S1 takes float32 or float64 CUDA planes, got {x0.dtype} "
                         f"on {x0.device}")
    if d % 2 or not 2 <= d <= 16:
        raise ValueError(f"S1 takes an even block size up to 16, got d = {d}")
    if x0.shape[-1] != t or any(
            m.dtype != x0.dtype or m.device != x0.device or not m.is_contiguous()
            or m.shape != (t, d, d) for m in tables):
        raise ValueError(f"S1 takes planes [..., {t}] with contiguous [{t}, {d}, {d}] "
                         "tables of their dtype on their device")
    src = _layout(planes)
    if src is None:  # planes from separate tensors: one strided copy
        src = _layout(tuple(torch.stack(planes)))
    if out is None:
        buf = torch.empty((d,) + tuple(x0.shape), dtype=x0.dtype, device=x0.device)
        out = tuple(buf)
    dst = _layout(out)
    if dst is None or dst[4:] != src[4:] or dst[0].dtype != x0.dtype:
        raise ValueError("S1 writes d planes of the input's shape and dtype at one stride")
    b = src[4]
    if b == 0:
        return tuple(out)
    err = _build.load_library().bidiag_scan_launch(
        src[0].data_ptr(), *src[1:4], dst[0].data_ptr(), *dst[1:4],
        *(m.data_ptr() for m in tables), b, t, d, int(x0.dtype == torch.float64),
        int(backward), CHUNK, _build.stream_ptr(x0.device),
    )
    _build.check(err, "bidiag_scan_launch")
    bidiag_scan.launches += 1
    bidiag_scan.generic_launches += int(d not in UNROLLED)
    return tuple(out)


bidiag_scan.launches = 0
bidiag_scan.generic_launches = 0
