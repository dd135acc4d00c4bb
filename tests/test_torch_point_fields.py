"""The host side of the point-field kernels K7 (link fields at link
positions), K1 (raster field), K10 (occupancy-grid lookup) and K11
(analytic primitive field), on the CPU.

The kernels run only on the card (``tests/test_torch_cuda.py``); what
guards and feeds their launches is Python, held here: the 32-bit index
guard of the launchers, K7's sphere cache, the memoised ``inv_cell_size``,
the zero gradient of K1, K10 and K11, the check of their operands (once per
tensor while it does not change), and the wrappers on the CPU (their plain
versions) on the layouts the port passes. ``fused_link_fields_cost``
against JAX is in ``test_torch_panda_ref.py``, the 2D fields in
``test_torch_fields2d.py``.
"""

import numpy as np
import pytest
import torch

from stoch_gpmp_tpu_torch.ops.kernels import _build, fields
from stoch_gpmp_tpu_torch.ops.kernels.fields import (
    check_primitives,
    grid_lookup,
    grid_lookup_plain,
    grid_points_view,
    primitive_field_cost,
    primitive_field_cost_plain,
    primitive_points_view,
    raster_points_view,
    raster_primitive_cost,
    raster_primitive_cost_plain,
)
from stoch_gpmp_tpu_torch.ops.kernels.panda_fields import (
    fused_link_fields_cost,
    fused_link_fields_cost_plain,
    kernel_spheres,
    link_fields_view,
)

KW = dict(margin=0.03, w_self=1e4, w_obst=1e4)


def _meta(shape, strides):
    return torch.empty(0, device="meta").as_strided(shape, strides)


@pytest.mark.parametrize("view, shape, strides, fits", [
    (link_fields_view, (160, 64, 9, 3), (1728, 27, 3, 1), True),
    (link_fields_view, (2, 63, 9, 3), (2**31 - 2000, 27, 3, 1), True),  # last offset 2^31 - 272
    (link_fields_view, (2, 63, 9, 3), (2**31, 27, 3, 1), False),
    (link_fields_view, (2**16, 2**11, 9, 3), (2**11 * 27, 27, 3, 1), False),  # 2^32 elements
    (primitive_points_view, (1920, 63, 2), (256, 4, 1), True),
    (primitive_points_view, (2, 2, 2), (2**31 - 7, 4, 1), True),  # last offset 2^31 - 2
    (primitive_points_view, (2, 2, 2), (2**31, 4, 1), False),
    (primitive_points_view, (2**20, 2**10, 2), (2**11, 2, 1), False),  # 2^31 elements
    (grid_points_view, (1920, 63, 2), (256, 4, 1), True),
    (grid_points_view, (2, 2, 2), (2**31 - 7, 4, 1), True),
    (grid_points_view, (2, 2, 2), (2**31, 4, 1), False),
    (grid_points_view, (2**20, 2**10, 2), (2**11, 2, 1), False),
    (raster_points_view, (1920, 63, 2), (256, 4, 1), True),
    (raster_points_view, (2, 2, 2), (2**31 - 7, 4, 1), True),
    (raster_points_view, (2, 2, 2), (2**31, 4, 1), False),
    (raster_points_view, (2**20, 2**10, 2), (2**11, 2, 1), False),
])
def test_launchers_index_in_32_bits(view, shape, strides, fits):
    pts = _meta(shape, strides)
    if fits:
        assert view(pts).shape[:2] == shape[:2]
    else:
        with pytest.raises(ValueError, match="32 bits"):
            view(pts)


def test_index_guard_counts_elements_and_offsets():
    _build.check_index_range("t", _meta((2**31 - 1,), (1,)))
    with pytest.raises(ValueError):
        _build.check_index_range("t", _meta((2**31,), (1,)))
    with pytest.raises(ValueError):
        _build.check_index_range("t", _meta((2, 1), (2**31, 1)))


def test_link_fields_view_merges_and_pads_batch_axes():
    pos = torch.zeros((4, 5, 6, 9, 3))
    assert link_fields_view(pos).shape == (20, 6, 9, 3)
    assert link_fields_view(pos[0, 0]).shape == (1, 6, 9, 3)
    assert link_fields_view(pos[0, 0, 0]).shape == (1, 1, 9, 3)


def test_kernel_spheres_made_once_per_tensor_and_version():
    sp = torch.tensor(np.random.default_rng(0).uniform(0.1, 1.0, (1, 5, 4)))  # float64
    dev = torch.device("cpu")
    first = kernel_spheres(sp, dev)
    assert first.dtype == torch.float32 and first.shape == (5, 4) and first.is_contiguous()
    assert kernel_spheres(sp, dev) is first
    sp[0, 2, 0] += 1.0  # in place: a new version, a new copy
    again = kernel_spheres(sp, dev)
    assert again is not first and torch.equal(again, sp.reshape(5, 4).float())
    assert kernel_spheres(sp.clone(), dev) is not again  # another tensor
    assert kernel_spheres(None, dev).shape == (0, 4)


def test_kernel_spheres_follow_a_data_swap():
    """``.data = ...`` keeps the tensor and its version but not its storage:
    the spheres are made again."""
    sp = torch.tensor(np.random.default_rng(1).uniform(0.1, 1.0, (3, 4)))
    dev = torch.device("cpu")
    first = kernel_spheres(sp, dev)
    version = sp._version
    sp.data = sp.data + 1.0
    assert sp._version == version
    again = kernel_spheres(sp, dev)
    assert again is not first and torch.equal(again, sp.float())


def _panda_positions(n_rows, traj_len, seed):
    from stoch_gpmp_tpu_torch.kinematics import franka_panda

    chain = franka_panda()
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.uniform(-1.5, 1.5, (n_rows * traj_len, 7)))
    compact = chain.fk_compact(q).positions.reshape(n_rows, traj_len, -1, 3)
    homogeneous = chain.fk(q).reshape(n_rows, traj_len, -1, 4, 4)
    return compact, homogeneous


@pytest.mark.parametrize("layout", ["fk_compact [:, 1:]", "fk [..., :3, -1]"])
@pytest.mark.parametrize("n_links", [9, 5, 1])
@pytest.mark.parametrize("with_spheres", [True, False])
def test_link_fields_wrapper_on_cpu_is_the_plain_version(layout, n_links, with_spheres):
    compact, homogeneous = _panda_positions(4, 8, 1)
    pos = compact[:, 1:] if layout.startswith("fk_compact") else homogeneous[:, 1:, :, :3, -1]
    pos = pos[..., :n_links, :]
    assert pos.shape == (4, 7, n_links, 3) and not pos.is_contiguous()
    sp = torch.tensor([[0.5, 0.0, 0.5, 0.15], [0.3, 0.2, 0.8, 0.1]], dtype=torch.float64)
    sp = sp if with_spheres else None
    got = fused_link_fields_cost(pos, sp, **KW)
    want = fused_link_fields_cost_plain(pos, sp, **KW)
    assert got.shape == (4, 7) and torch.equal(got, want)


def _planar_points(shape, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(-11, 11, shape)).float()


def _primitives():
    rng = np.random.default_rng(3)
    rects = torch.from_numpy(np.c_[rng.uniform(-8, 8, (6, 2)), rng.uniform(1, 4, (6, 2))]).float()
    circles = torch.from_numpy(np.c_[rng.uniform(-8, 8, (5, 2)), rng.uniform(1, 3, 5)]).float()
    return rects, circles


def test_primitive_field_without_grad_is_the_plain_value():
    rects, circles = _primitives()
    pts = _planar_points((64, 64, 4), 0)[:, 1:, :2]
    got = primitive_field_cost(rects, circles, pts)
    assert got.grad_fn is None and not got.requires_grad
    assert torch.equal(got, primitive_field_cost_plain(rects, circles, pts))


def test_primitive_field_with_grad_is_zero_gradient():
    rects, circles = _primitives()
    pts = _planar_points((8, 16, 2), 1).requires_grad_(True)
    got = primitive_field_cost(rects, circles, pts)
    assert got.requires_grad
    assert torch.equal(got.detach(), primitive_field_cost_plain(rects, circles, pts.detach()))
    (grad,) = torch.autograd.grad(got.sum(), pts)
    assert grad.shape == pts.shape and not grad.any()
    with torch.no_grad():  # no graph without grad mode
        assert primitive_field_cost(rects, circles, pts).grad_fn is None


def test_primitive_field_checks_the_primitives():
    rects, circles = _primitives()
    cpu = torch.device("cpu")
    check_primitives(rects, circles, cpu)
    check_primitives(rects[:0], circles[:0], cpu)
    for bad in (rects.double(), rects.t().contiguous().t(), rects[:, :3], rects.to("meta")):
        with pytest.raises(ValueError, match="primitive field kernel"):
            check_primitives(bad, circles, cpu)


def test_primitive_field_of_a_field_on_cpu():
    from stoch_gpmp_tpu_torch.costs.fields import Primitive2DField

    rects, circles = _primitives()
    field = Primitive2DField(rects=rects, circles=circles)
    pts = _planar_points((32, 63, 2), 2)
    want = primitive_field_cost_plain(rects, circles, pts)
    assert torch.equal(field.compute_cost(pts), want)


def _raster_operands():
    rng = np.random.default_rng(4)
    lo = rng.integers(0, 150, (6, 2))
    rect_bounds = torch.tensor(np.c_[lo[:, 0], lo[:, 0] + 20, lo[:, 1], lo[:, 1] + 30],
                               dtype=torch.int32)
    circles = torch.from_numpy(np.c_[rng.uniform(-8, 8, (5, 2)), rng.uniform(1, 3, 5)]).float()
    return rect_bounds, circles


def _grid(shape=(5, 7), seed=5):
    return torch.from_numpy(np.random.default_rng(seed).uniform(0, 1, shape)).float()


# per kernel: its operands' check (a name in ``fields``), the operands, the error's words
OPERANDS = {
    "K11": ("check_primitives", _primitives, "primitive field kernel"),
    "K1": ("check_raster_primitives", _raster_operands, "raster field kernel"),
    "K10": ("check_grid", lambda: (_grid(),), "grid lookup kernel"),
}


def _spoil(kind, t):
    """Change ``t`` so that the kernel must not take it (a write: so that
    it must be checked again), keeping the tensor (and, for the ``.data``
    swaps, its version)."""
    if kind == "write":
        t.mul_(2)
    elif kind == "resize_":
        t.resize_(t.numel() + 1)
    elif kind == "t_":
        t.t_()
    elif kind == "as_strided_":
        t.as_strided_(t.shape, (1, t.shape[0]))
    elif kind == "data = float64":
        t.data = t.data.double()
    elif kind == "data = transposed copy":
        t.data = t.data.t().contiguous().t()


def _check_runs_again(kind, kernel, monkeypatch):
    """The wrapper checks its operands once per tensors and device while
    they do not change; a write checks again, and any change that could make
    the kernel misread them checks again, and raises."""
    name, operands, words = OPERANDS[kernel]
    calls = []
    real = getattr(fields, name)
    monkeypatch.setattr(fields, name, lambda *a: (calls.append(1), real(*a)))
    monkeypatch.setattr(fields, "_CHECKED", {})
    check, tensors, cpu = getattr(fields, name), operands(), torch.device("cpu")
    for _ in range(3):
        fields._check_once(check, cpu, *tensors)
    assert len(calls) == 1
    fields._check_once(check, cpu, tensors[0].clone(), *tensors[1:])  # another tensor
    assert len(calls) == 2
    for _ in range(2):  # back to the first: checked again, once
        fields._check_once(check, cpu, *tensors)
    assert len(calls) == 3
    _spoil(kind, tensors[0])
    if kind == "write":
        fields._check_once(check, cpu, *tensors)
    else:
        with pytest.raises(ValueError, match=words):
            fields._check_once(check, cpu, *tensors)
    assert len(calls) == 4


KINDS = ["resize_", "t_", "as_strided_", "data = float64", "data = transposed copy"]


@pytest.mark.parametrize("kind", KINDS + ["write"])
def test_primitive_check_runs_again_after_a_change(kind, monkeypatch):
    _check_runs_again(kind, "K11", monkeypatch)


@pytest.mark.parametrize("kernel", ["K1", "K10"])
@pytest.mark.parametrize("kind", KINDS + ["write"])
def test_raster_and_grid_checks_run_again_after_a_change(kind, kernel, monkeypatch):
    _check_runs_again(kind, kernel, monkeypatch)


def test_operand_checks_are_kept_per_kernel_and_device(monkeypatch):
    """One kernel's check does not stand for another's on the same tensor."""
    monkeypatch.setattr(fields, "_CHECKED", {})
    grid, cpu = _grid(), torch.device("cpu")
    fields._check_once(fields.check_grid, cpu, grid)
    with pytest.raises(ValueError, match="primitive field kernel"):
        fields._check_once(fields.check_primitives, cpu, grid, grid)
    with pytest.raises(ValueError, match="grid lookup kernel"):
        fields._check_once(fields.check_grid, torch.device("meta"), grid)


@pytest.mark.parametrize("bad", ["float64", "1-D", "transposed", "empty", "meta"])
def test_grid_check_refuses_what_the_kernel_misreads(bad):
    grid = _grid()
    grid = {"float64": grid.double(), "1-D": grid.reshape(-1), "transposed": grid.t(),
            "empty": grid[:0], "meta": grid.to("meta")}[bad]
    with pytest.raises(ValueError, match="grid lookup kernel"):
        fields.check_grid(grid, torch.device("cpu"))


@pytest.mark.parametrize("bad", ["rects float32", "rects [R, 3]", "rects 1-D",
                                 "circles float64", "circles transposed"])
def test_raster_check_refuses_what_the_kernel_misreads(bad):
    rb, ci = _raster_operands()
    rb, ci = {"rects float32": (rb.float(), ci), "rects [R, 3]": (rb[:, :3], ci),
              "rects 1-D": (rb.reshape(-1), ci), "circles float64": (rb, ci.double()),
              "circles transposed": (rb, ci.t().contiguous().t())}[bad]
    with pytest.raises(ValueError, match="raster field kernel"):
        fields.check_raster_primitives(rb, ci, torch.device("cpu"))


SWEEP = [0.1, 0.05, 0.025, 0.01, 0.2, 0.3, 1 / 3, 0.7, 1.0, 2.5, 0.123456789,
         *np.random.default_rng(6).uniform(1e-3, 10.0, 40).tolist()]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_inv_cell_size_memoised_is_a_fresh_computation(dtype):
    for cs in SWEEP:
        fresh = float(torch.ones((), dtype=dtype) / torch.full((), cs, dtype=dtype))
        assert fields.inv_cell_size(cs, dtype) == fresh
        assert fields.inv_cell_size(cs, dtype) == fresh  # from the memo
        if dtype == torch.float32:
            assert fresh == float(np.float32(1) / np.float32(cs))
        else:
            assert fresh == 1.0 / cs
    assert fields.inv_cell_size.cache_info().hits >= len(SWEEP)


GRID_VIEWS = {
    "planner's [B, 63, 2] of [B, 64, 4]": lambda: _planar_points((48, 64, 4), 7)[:, 1:, :2],
    "odd strides [.., 1:3] of [.., 5]": lambda: _planar_points((16, 63, 5), 8)[..., 1:3],
    "coordinate stride 2": lambda: _planar_points((8, 63, 6), 9)[..., 1:5:2],
    "[N, 2]": lambda: _planar_points((1001, 2), 10),
    "[2]": lambda: _planar_points((2,), 11),
}


@pytest.mark.parametrize("view", list(GRID_VIEWS))
@pytest.mark.parametrize("grid_shape", [(200, 200), (37, 200), (200, 37), (1, 1)])
def test_grid_lookup_wrapper_on_cpu_is_the_plain_version(view, grid_shape):
    pts, grid = GRID_VIEWS[view](), _grid(grid_shape, 12)
    got = grid_lookup(grid, pts, 0.1)
    assert got.shape == pts.shape[:-1]
    assert torch.equal(got, grid_lookup_plain(grid, pts.contiguous(), 0.1))


@pytest.mark.parametrize("view", list(GRID_VIEWS))
@pytest.mark.parametrize("operands", ["R, C", "R = 0", "C = 0", "R = C = 0"])
def test_raster_wrapper_on_cpu_is_the_plain_version(view, operands):
    rb, ci = _raster_operands()
    rb = rb[:0] if operands in ("R = 0", "R = C = 0") else rb
    ci = ci[:0] if operands in ("C = 0", "R = C = 0") else ci
    pts, kw = GRID_VIEWS[view](), dict(cell_size=0.1, nx=200, ny=200)
    got = raster_primitive_cost(rb, ci, pts, **kw)
    assert got.shape == pts.shape[:-1]
    assert torch.equal(got, raster_primitive_cost_plain(rb, ci, pts.contiguous(), **kw))


@pytest.mark.parametrize("kernel", ["K1", "K10"])
def test_raster_and_grid_with_grad_are_zero_gradient(kernel):
    rb, ci = _raster_operands()
    grid = _grid((200, 200), 13)
    kw = dict(cell_size=0.1, nx=200, ny=200)
    fn, plain = {
        "K1": (lambda x: raster_primitive_cost(rb, ci, x, **kw),
               lambda x: raster_primitive_cost_plain(rb, ci, x, **kw)),
        "K10": (lambda x: grid_lookup(grid, x, 0.1), lambda x: grid_lookup_plain(grid, x, 0.1)),
    }[kernel]
    pts = _planar_points((8, 16, 4), 14)[..., :2].requires_grad_(True)
    got = fn(pts)
    assert got.requires_grad
    assert torch.equal(got.detach(), plain(pts.detach()))
    (grad,) = torch.autograd.grad(got.sum(), pts)
    assert grad.shape == pts.shape and not grad.any()
    with torch.no_grad():  # no graph without grad mode
        assert fn(pts).grad_fn is None
    assert fn(pts.detach()).grad_fn is None
