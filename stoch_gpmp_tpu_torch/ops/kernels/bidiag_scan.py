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
  ``CHUNK`` steps per lane runs the recurrence from a zero carry; the
  carries cross the chunks by a log-step scan, and each chunk adds ``phi_t
  carry`` (see the source for the design; the launcher picks the launch
  shape). The planes move by TMA where their layout allows it (time stride
  1, T a multiple of a 128-byte line, 16-byte strides and base); other
  layouts are staged by the kernel's own threads, counted in
  ``.staged_launches``. d = 4 and 14 are compiled in; any other d takes the
  runtime-d instantiation, counted in ``.generic_launches``. A CPU tensor
  takes ``bidiag_scan_plain``.
- ``bidiag_scan_plain`` is the plain version: ``_apply_tri`` and the
  log-step ``_affine_assoc_scan`` of ``gp/tridiag.py`` (about
  ``log2 T (d^3 + d^2)`` elementwise plane operations per solve).
- ``chunk_prefix``, ``step_records``, ``phi_records`` and ``scan_products``
  build the tables the kernel reads, once per factor
  (``ParallelBidiagSolver.from_tables``).

The kernel never gives way to the plain version: a dtype, a block size or a
device it does not take raises.
"""

from __future__ import annotations

import torch

from stoch_gpmp_tpu_torch.ops.kernels import _build

# time steps per chunk of the phi tables: csrc/bidiag_scan.cu kChunk (the
# launcher refuses tables of another chunk)
CHUNK = 16
# the block sizes csrc/bidiag_scan.cu compiles in (the planar robot's and
# the Panda's); any other takes its runtime-d instantiation
UNROLLED = (4, 14)
# levels of the scan_products tables: spans of 1, 2, ..., 32 chunks
# (csrc/bidiag_scan.cu kLevels; a warp scans at most 32 chunks)
SCAN_LEVELS = 6


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


def _odd_units(n: int, element_size: int) -> int:
    """n elements padded to an odd number of 16-byte units (the kernel's
    shared-memory entries then start on distinct banks across a warp's
    chunks; csrc/bidiag_scan.cu odd_units)."""
    v = 16 // element_size
    return (-(-n // v) | 1) * v


def rec_width(d: int, element_size: int) -> int:
    """Elements of a ``step_records`` row: the triangle and ``A_t``."""
    return _odd_units(d * (d + 1) // 2 + d * d, element_size)


def phi_width(d: int, element_size: int) -> int:
    """Elements of a ``phi_records`` row: ``phi_t`` (whole 16-byte units for
    an even d)."""
    return d * d


def _records(cols, width: int) -> torch.Tensor:
    """``[CHUNK n, width]``: the columns side by side, zero-padded to ``width``
    and to whole chunks of steps (the kernel's table boxes read whole
    chunks)."""
    t = cols[0].shape[0]
    out = cols[0].new_zeros((-(-t // CHUNK) * CHUNK, width))
    out[:t, :sum(c.shape[1] for c in cols)] = torch.cat(cols, dim=1)
    return out


def step_records(dinv: torch.Tensor, a: torch.Tensor, *, backward: bool) -> torch.Tensor:
    """``[CHUNK ceil(T / CHUNK), rec_width]``: per step the triangle of
    ``D_t^{-1}`` (forward: row i's entries ``dinv[t, i, :i + 1]``; backward,
    ``D_t^{-T}``: ``dinv[t, i:, i]``), then ``A_t`` by rows, zero-padded:
    what one step of the kernel's first phase reads, in the order it reads
    it."""
    t, d = dinv.shape[0], dinv.shape[-1]
    tri = [dinv[:, i:, i] if backward else dinv[:, i, :i + 1] for i in range(d)]
    return _records([*tri, a.reshape(t, d * d)], rec_width(d, dinv.element_size()))


def phi_records(phi: torch.Tensor) -> torch.Tensor:
    """``[CHUNK ceil(T / CHUNK), phi_width]``: ``phi_t`` by rows, zero-padded, what
    one step of the kernel's third phase reads."""
    t, d = phi.shape[0], phi.shape[-1]
    return _records([phi.reshape(t, d * d)], phi_width(d, phi.element_size()))


def scan_products(a: torch.Tensor, *, backward: bool) -> torch.Tensor:
    """``psi [SCAN_LEVELS, d * d, n]`` of the transitions ``a [T, d, d]``
    over the n chunks of ``CHUNK`` steps: with ``Psi_k`` chunk k's whole
    transition (``chunk_prefix`` at its last step, or its first backward),
    level l at chunk k is ``Psi_k Psi_{k-1} ... Psi_{k-2^l+1}`` (backward:
    ``Psi_k Psi_{k+1} ... Psi_{k+2^l-1}``), cut at the first (last) chunk;
    entry (i, j) at ``i * d + j``, chunks fastest. The products of the
    kernel's log-step scan over chunks; built in float64."""
    t, d = a.shape[0], a.shape[-1]
    n = -(-t // CHUNK)
    phi = chunk_prefix(a.double(), backward=backward)
    ends = torch.arange(n, device=a.device) * CHUNK + (0 if backward else CHUNK - 1)
    level = phi[ends.clamp_max(t - 1)]
    levels = [level]
    for lv in range(SCAN_LEVELS - 1):
        s, nxt = 1 << lv, level.clone()
        if s < n and backward:
            nxt[:n - s] = level[:n - s] @ level[s:]
        elif s < n:
            nxt[s:] = level[s:] @ level[:n - s]
        level = nxt
        levels.append(level)
    return torch.stack(levels).reshape(SCAN_LEVELS, n, d * d).transpose(1, 2).to(a.dtype).contiguous()


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


def tables(solver, backward: bool):
    """The direction's ``(rec, phr, psi)`` tables, as the kernel reads them."""
    if backward:
        return solver.rec_bwd, solver.phr_bwd, solver.psi_bwd
    return solver.rec_fwd, solver.phr_fwd, solver.psi_fwd


def _check_tables(solver, backward, x0):
    """The direction's tables; raises unless they are the kernel's (shapes,
    the dtype and device of ``x0``, contiguous)."""
    d, t = solver.block_dim, solver.num_blocks
    tabs = tables(solver, backward)
    n, size = -(-t // CHUNK), x0.element_size()
    shapes = ((n * CHUNK, rec_width(d, size)), (n * CHUNK, phi_width(d, size)),
              (SCAN_LEVELS, d * d, n))
    if any(m.dtype != x0.dtype or m.device != x0.device or not m.is_contiguous()
           or m.shape != shape for m, shape in zip(tabs, shapes)):
        raise ValueError(f"S1 takes planes [..., {t}] with contiguous tables {shapes} of "
                         "their dtype on their device")
    return tabs


def _launch(solver, planes, backward, out):
    x0 = planes[0]
    d, t = solver.block_dim, solver.num_blocks
    if d % 2 or not 2 <= d <= 16:
        raise ValueError(f"S1 takes an even block size up to 16, got d = {d}")
    if x0.shape[-1] != t:
        raise ValueError(f"S1 takes planes [..., {t}], got {list(x0.shape)}")
    rec, phr, psi = _check_tables(solver, backward, x0)
    if x0.device.type != "cuda" or x0.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"S1 takes float32 or float64 CUDA planes, got {x0.dtype} "
                         f"on {x0.device}")
    src = _layout(planes)
    if src is None:  # planes from separate tensors: one strided copy
        src = _layout(tuple(torch.stack(planes)))
    b = src[4]
    if out is None:  # one new [d, ..., T] tensor: its layout is known
        buf = torch.empty((d,) + tuple(x0.shape), dtype=x0.dtype, device=x0.device)
        out, dst = tuple(buf), (buf, b * t, t, 1, b, t)
    else:
        dst = _layout(out)
        if dst is None or dst[4:] != src[4:] or dst[0].dtype != x0.dtype:
            raise ValueError("S1 writes d planes of the input's shape and dtype at one stride")
    if b == 0:
        return tuple(out)
    err = _build.load_library().bidiag_scan_launch(
        src[0].data_ptr(), *src[1:4], dst[0].data_ptr(), *dst[1:4],
        rec.data_ptr(), phr.data_ptr(), psi.data_ptr(), b, t, d,
        int(x0.dtype == torch.float64), int(backward), CHUNK, SCAN_LEVELS,
        _build.stream_ptr(x0.device),
    )
    if err != -1:  # -1: launched, the planes staged by the kernel's threads
        _build.check(err, "bidiag_scan_launch")
    bidiag_scan.launches += 1
    bidiag_scan.generic_launches += int(d not in UNROLLED)
    bidiag_scan.staged_launches += int(err == -1)
    return tuple(out)


bidiag_scan.launches = 0
bidiag_scan.generic_launches = 0
bidiag_scan.staged_launches = 0
