"""Raster collision field: wrapper and plain version of the CUDA kernel.

Replaces the TPU kernel ``stoch_gpmp_tpu/ops/pallas/fields.py``
``raster_primitive_cost`` (``_raster_kernel``). The CUDA source is
``csrc/raster_field.cu``: one thread per point, points read through their
strides, primitives in shared memory. It is memory and launch-latency bound
(12 bytes per point, ~121k points per call at the planar parity shape); see
the source for the design.

``raster_primitive_cost`` launches the kernel for a CUDA tensor and runs
``raster_primitive_cost_plain`` only for a CPU tensor.
"""

from __future__ import annotations

import torch

from stoch_gpmp_tpu_torch.ops.kernels import _build


def inv_cell_size(cell_size: float, dtype) -> float:
    """``1 / cell_size`` rounded to ``dtype``."""
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


def raster_primitive_cost(rect_bounds, circles, points, *, cell_size, nx, ny):
    """``RasterPrimitive2DField.compute_cost``: the CUDA kernel for a CUDA
    tensor (float32, any strides of a ``[B, L, 2]`` view), the plain version
    for a CPU tensor."""
    if points.device.type == "cpu":
        return raster_primitive_cost_plain(
            rect_bounds, circles, points, cell_size=cell_size, nx=nx, ny=ny
        )
    if points.device.type != "cuda":
        raise ValueError(f"raster field: unsupported device {points.device}")
    if points.dtype != torch.float32 or points.shape[-1] != 2:
        raise ValueError(
            f"raster field kernel takes float32 [..., 2] points, got "
            f"{points.dtype} {tuple(points.shape)}"
        )
    if (rect_bounds.device != points.device or circles.device != points.device
            or rect_bounds.dtype != torch.int32 or circles.dtype != torch.float32
            or not rect_bounds.is_contiguous() or not circles.is_contiguous()
            or rect_bounds.shape[-1] != 4 or circles.shape[-1] != 3):
        raise ValueError(
            "raster field kernel takes contiguous int32 [R, 4] rect_bounds and "
            "float32 [C, 3] circles on the points' device"
        )
    batch_shape = points.shape[:-1]
    pts = points if points.dim() == 3 else points.reshape(-1, 1, 2)
    b, l = pts.shape[0], pts.shape[1]
    out = torch.empty((b, l), dtype=torch.float32, device=points.device)
    if b * l == 0:
        return out.reshape(batch_shape)
    lib = _build.load_library()
    err = lib.raster_field_launch(
        pts.data_ptr(), b, l, pts.stride(0), pts.stride(1), pts.stride(2),
        rect_bounds.data_ptr(), int(rect_bounds.shape[0]),
        circles.data_ptr(), int(circles.shape[0]),
        float(cell_size), inv_cell_size(cell_size, torch.float32), int(nx), int(ny),
        out.data_ptr(), _build.stream_ptr(points.device),
    )
    _build.check(err, "raster_field_launch")
    raster_primitive_cost.launches += 1
    return out.reshape(batch_shape)


raster_primitive_cost.launches = 0
