"""The 2D collision fields: wrappers and plain versions of three CUDA kernels.

Each replaces a TPU kernel of ``stoch_gpmp_tpu/ops/pallas/fields.py``:

- ``raster_primitive_cost`` (K1, ``csrc/raster_field.cu``): the count of
  rasterized primitives covering each point's snapped cell;
- ``grid_lookup`` (K10, ``csrc/grid_lookup.cu``): the occupancy-grid read
  ``grid[cell(y), cell(x)]``;
- ``primitive_field_cost`` (K11, ``csrc/primitive_field.cu``): the count of
  analytic rectangles and circles containing each point.

All three read the points through their strides (the planner passes a
strided ``[B, L, 2]`` slice of its sample batch, so no copy is made),
several points per thread (K1 and K11 four, K10 two) with 32-bit indices
(``csrc/point_batch.cuh``). They are bound by memory and launch latency (12
bytes per point, ~121k points per call at the planar parity shape); see the
sources for the design. Their operands (the grid, the primitives) are
checked once per tensor while it does not change (``_check_once``).

Each wrapper launches its kernel for a CUDA tensor and runs its plain
version only for a CPU tensor. The fields are piecewise constant, so their
gradient with respect to the points is zero: the JAX package's ``jax.grad``
through the ``int32`` cell index or the comparisons gives exactly that. The
wrappers carry that zero backward (``_PiecewiseConstant``) on the CPU and
the card alike, so the Gauss-Newton field Jacobians are zero here too,
rather than an error or a graph cut silently by a raw pointer; a call whose
points need no gradient skips the ``autograd.Function``.
"""

from __future__ import annotations

import weakref
from functools import lru_cache

import torch

from stoch_gpmp_tpu_torch.ops.kernels import _build


@lru_cache(maxsize=64)
def inv_cell_size(cell_size: float, dtype) -> float:
    """``1 / cell_size`` rounded to ``dtype`` (memoised: a field passes the
    same cell size on every call)."""
    one = torch.ones((), dtype=dtype)
    return float(one / torch.full((), cell_size, dtype=dtype))


def snap_cells(v, cell_size: float, origin: int, n: int):
    """Clamped cell index ``clip(floor(v / cell_size + origin), 0, n-1)``.

    The JAX package writes ``floor(v / cell_size + origin)``, which XLA
    compiles as ``floor(fma(v, 1 / cell_size, origin))`` with the reciprocal
    rounded to the working precision; the port computes the same value, so
    points on cell edges land in the same cell. For float32 the fused
    multiply-add is exact through float64 (the product of two float32
    values is exact there; the sum rounds once more only far from a cell
    edge). PyTorch has no float64 fma, so float64 rounds the product and
    the sum apart, which differs from XLA only within an ulp of a cell edge.
    """
    inv = inv_cell_size(cell_size, v.dtype)
    if v.dtype == torch.float32:
        scaled = (v.double() * inv + origin).float()
    else:
        scaled = v * inv + origin
    return torch.floor(scaled).clamp(0, n - 1).to(torch.int32)


def raster_primitive_cost_plain(rect_bounds, circles, points, *, cell_size, nx, ny):
    """Plain PyTorch version: ``points [..., 2]`` -> ``[...]`` counts of
    primitives covering each point's snapped, clamped cell, in the points'
    dtype."""
    x, y = points[..., 0], points[..., 1]
    ox, oy = nx // 2, ny // 2
    jc = snap_cells(x, cell_size, ox, nx)
    ic = snap_cells(y, cell_size, oy, ny)
    acc = torch.zeros(x.shape, dtype=points.dtype, device=points.device)
    for r in range(int(rect_bounds.shape[0])):
        rb = rect_bounds[r]
        inside = (jc >= rb[0]) & (jc < rb[1]) & (ic >= rb[2]) & (ic < rb[3])
        acc = acc + inside.to(points.dtype)
    if int(circles.shape[0]):
        wx = (jc - ox).to(points.dtype) * cell_size
        wy = (ic - oy).to(points.dtype) * cell_size
        for c in range(int(circles.shape[0])):
            dx = wx - circles[c, 0]
            dy = wy - circles[c, 1]
            acc = acc + (torch.sqrt(dx * dx + dy * dy) <= circles[c, 2]).to(points.dtype)
    return acc


class _PiecewiseConstant(torch.autograd.Function):
    """``fn(points)`` with a zero gradient with respect to the points."""

    @staticmethod
    def forward(ctx, points, fn):
        ctx.meta = (points.shape, points.dtype, points.device)
        return fn(points)

    @staticmethod
    def backward(ctx, grad):
        shape, dtype, device = ctx.meta
        return torch.zeros(shape, dtype=dtype, device=device), None


def _piecewise_constant(points, fn):
    if torch.is_grad_enabled() and points.requires_grad:
        return _PiecewiseConstant.apply(points, fn)
    return fn(points)


def _check_points(points, name: str) -> None:
    """Raise unless ``points`` is a float32 ``[..., 2]`` CUDA tensor."""
    if points.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {points.device}")
    if points.dtype != torch.float32 or points.shape[-1] != 2:
        raise ValueError(
            f"{name} kernel takes float32 [..., 2] points, got "
            f"{points.dtype} {tuple(points.shape)}"
        )


def _as_bl2(points):
    """``points`` as a ``[B, L, 2]`` view (a copy only when it has neither
    three dimensions nor a flat layout)."""
    return points if points.dim() == 3 else points.reshape(-1, 1, 2)


def _points_view(points, name: str):
    """``points [..., 2]`` as a ``[B, L, 2]`` view (``_as_bl2``), checked to
    index in 32 bits, as the kernel ``name`` reads it."""
    pts = _as_bl2(points)
    _build.check_index_range(name, pts)
    return pts


_CHECKED: dict = {}  # per check and device: weakrefs to the tensors that passed, their state


def _check_once(check, device, *tensors) -> None:
    """``check(*tensors, device)``, once per tensors and device while none
    changes (its in-place version and its storage: a write, a resize, a
    restride or a ``.data`` swap for other storage checks again): a field
    passes the same operands on every call."""
    seen = _CHECKED.get((check, device))
    state = tuple((t._version, t.data_ptr()) for t in tensors)
    if (seen is None or seen[1] != state
            or any(ref() is not t for ref, t in zip(seen[0], tensors))):
        check(*tensors, device)
        _CHECKED[(check, device)] = (tuple(weakref.ref(t) for t in tensors), state)


def raster_primitive_cost(rect_bounds, circles, points, *, cell_size, nx, ny):
    """``RasterPrimitive2DField.compute_cost``: the CUDA kernel for a CUDA
    tensor (float32, any strides of a ``[B, L, 2]`` view), the plain version
    for a CPU tensor; zero gradient."""
    return _piecewise_constant(points, lambda pts: _raster_primitive_cost(
        rect_bounds, circles, pts, cell_size=cell_size, nx=nx, ny=ny))


def check_raster_primitives(rect_bounds, circles, device) -> None:
    """Raise unless ``rect_bounds [R, 4]`` (int32) and ``circles [C, 3]``
    (float32) are contiguous tensors on ``device``, as the raster-field
    kernel takes them."""
    if (rect_bounds.device != device or circles.device != device
            or rect_bounds.dtype != torch.int32 or circles.dtype != torch.float32
            or not rect_bounds.is_contiguous() or not circles.is_contiguous()
            or rect_bounds.dim() != 2 or circles.dim() != 2
            or rect_bounds.shape[-1] != 4 or circles.shape[-1] != 3):
        raise ValueError(
            "raster field kernel takes contiguous int32 [R, 4] rect_bounds and "
            "float32 [C, 3] circles on the points' device"
        )


def raster_points_view(points):
    """``points [..., 2]`` as the ``[B, L, 2]`` view K1 reads, checked to
    index in 32 bits."""
    return _points_view(points, "raster field kernel")


def _raster_primitive_cost(rect_bounds, circles, points, *, cell_size, nx, ny):
    if points.device.type == "cpu":
        return raster_primitive_cost_plain(
            rect_bounds, circles, points, cell_size=cell_size, nx=nx, ny=ny
        )
    _check_points(points, "raster field")
    _check_once(check_raster_primitives, points.device, rect_bounds, circles)
    out = torch.empty(points.shape[:-1], dtype=torch.float32, device=points.device)
    if out.numel() == 0:
        return out
    pts = raster_points_view(points)
    err = _build.load_library().raster_field_launch(
        pts.data_ptr(), pts.shape[0], pts.shape[1], *pts.stride(), rect_bounds.data_ptr(),
        rect_bounds.shape[0], circles.data_ptr(), circles.shape[0], float(cell_size),
        inv_cell_size(cell_size, torch.float32), nx, ny, out.data_ptr(),
        _build.stream_ptr(points.device),
    )
    _build.check(err, "raster_field_launch")
    raster_primitive_cost.launches += 1
    return out


raster_primitive_cost.launches = 0


def grid_lookup_plain(grid, points, cell_size: float):
    """Plain PyTorch version: ``grid [ny, nx]``, ``points [..., 2]`` ->
    ``grid[cell(y), cell(x)]`` of shape ``[...]``, with K1's snapped and
    clamped cell rule (``snap_cells``)."""
    ny, nx = grid.shape
    cx = snap_cells(points[..., 0], cell_size, nx // 2, nx).long()
    cy = snap_cells(points[..., 1], cell_size, ny // 2, ny).long()
    return grid[cy, cx]


def grid_lookup(grid, points, cell_size: float):
    """``OccupancyGridField.compute_cost``: the CUDA kernel for a CUDA
    tensor (float32 points, any strides of a ``[B, L, 2]`` view; a
    contiguous float32 grid), the plain version for a CPU tensor; zero
    gradient."""
    return _piecewise_constant(points, lambda pts: _grid_lookup(grid, pts, cell_size))


def check_grid(grid, device) -> None:
    """Raise unless ``grid [ny, nx]`` is a contiguous float32 tensor on
    ``device`` of fewer than 2^31 cells, as the grid-lookup kernel takes it."""
    if (grid.device != device or grid.dtype != torch.float32 or grid.dim() != 2
            or not grid.is_contiguous() or grid.numel() == 0
            or grid.numel() >= _build.INDEX_LIMIT):
        raise ValueError("grid lookup kernel takes a contiguous float32 [ny, nx] grid of "
                         "fewer than 2^31 cells on the points' device")


def grid_points_view(points):
    """``points [..., 2]`` as the ``[B, L, 2]`` view K10 reads, checked to
    index in 32 bits."""
    return _points_view(points, "grid lookup kernel")


def _grid_lookup(grid, points, cell_size):
    if points.device.type == "cpu":
        return grid_lookup_plain(grid, points, cell_size)
    _check_points(points, "grid lookup")
    _check_once(check_grid, points.device, grid)
    out = torch.empty(points.shape[:-1], dtype=torch.float32, device=points.device)
    if out.numel() == 0:
        return out
    pts = grid_points_view(points)
    ny, nx = grid.shape
    err = _build.load_library().grid_lookup_launch(
        grid.data_ptr(), nx, ny, pts.data_ptr(), pts.shape[0], pts.shape[1], *pts.stride(),
        inv_cell_size(cell_size, torch.float32), out.data_ptr(),
        _build.stream_ptr(points.device),
    )
    _build.check(err, "grid_lookup_launch")
    grid_lookup.launches += 1
    return out


grid_lookup.launches = 0


def primitive_field_cost_plain(rects, circles, points):
    """Plain PyTorch version: ``rects [R, 4]`` (cx, cy, w, h), ``circles
    [C, 3]`` (cx, cy, r), ``points [..., 2]`` -> ``[...]`` count of the
    primitives containing each point (boundaries included; circles by
    squared distance), in the points' dtype."""
    x, y = points[..., 0], points[..., 1]
    acc = torch.zeros(x.shape, dtype=points.dtype, device=points.device)
    for r in range(int(rects.shape[0])):
        cx, cy, w, h = rects[r]
        inside = ((x - cx).abs() <= 0.5 * w) & ((y - cy).abs() <= 0.5 * h)
        acc = acc + inside.to(points.dtype)
    for c in range(int(circles.shape[0])):
        cx, cy, rad = circles[c]
        dx, dy = x - cx, y - cy
        acc = acc + (dx * dx + dy * dy <= rad * rad).to(points.dtype)
    return acc


def check_primitives(rects, circles, device) -> None:
    """Raise unless ``rects [R, 4]`` and ``circles [C, 3]`` are contiguous
    float32 tensors on ``device``, as the primitive-field kernel takes them."""
    if (rects.device != device or circles.device != device
            or rects.dtype != torch.float32 or circles.dtype != torch.float32
            or not rects.is_contiguous() or not circles.is_contiguous()
            or rects.dim() != 2 or circles.dim() != 2
            or rects.shape[-1] != 4 or circles.shape[-1] != 3):
        raise ValueError("primitive field kernel takes contiguous float32 [R, 4] rects and "
                         "[C, 3] circles on the points' device")


def primitive_points_view(points):
    """``points [..., 2]`` as the ``[B, L, 2]`` view K11 reads, checked to
    index in 32 bits."""
    return _points_view(points, "primitive field kernel")


def primitive_field_cost(rects, circles, points):
    """``Primitive2DField.compute_cost``: the CUDA kernel for a CUDA tensor
    (float32 points, any strides of a ``[B, L, 2]`` view; R or C may be 0),
    the plain version for a CPU tensor; zero gradient."""
    return _piecewise_constant(points, lambda pts: _primitive_field_cost(rects, circles, pts))


def _primitive_field_cost(rects, circles, points):
    if points.device.type == "cpu":
        return primitive_field_cost_plain(rects, circles, points)
    _check_points(points, "primitive field")
    _check_once(check_primitives, points.device, rects, circles)
    out = torch.empty(points.shape[:-1], dtype=torch.float32, device=points.device)
    if out.numel() == 0:
        return out
    pts = primitive_points_view(points)
    err = _build.load_library().primitive_field_launch(
        pts.data_ptr(), pts.shape[0], pts.shape[1], *pts.stride(), rects.data_ptr(),
        rects.shape[0], circles.data_ptr(), circles.shape[0], out.data_ptr(),
        _build.stream_ptr(points.device),
    )
    _build.check(err, "primitive_field_launch")
    primitive_field_cost.launches += 1
    return out


primitive_field_cost.launches = 0
