"""The host side of the point-field kernels K7 (link fields at link
positions) and K11 (analytic primitive field), on the CPU.

The kernels run only on the card (``tests/test_torch_cuda.py``); what
guards and feeds their launches is Python, held here: the 32-bit index
guard of both launchers, K7's sphere cache, K11's zero gradient and the
primitives' check (once per tensor while it does not change), and both
wrappers on the CPU (their plain versions) on the layouts the port passes. ``fused_link_fields_cost``
against JAX is in ``test_torch_panda_ref.py``, ``primitive_field_cost`` in
``test_torch_fields2d.py``.
"""

import numpy as np
import pytest
import torch

from stoch_gpmp_tpu_torch.ops.kernels import _build, fields
from stoch_gpmp_tpu_torch.ops.kernels.fields import (
    check_primitives,
    primitive_field_cost,
    primitive_field_cost_plain,
    primitive_points_view,
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


def _spoil(kind, rects):
    """Change ``rects`` so that the kernel must not take it, keeping the
    tensor (and, for the ``.data`` swaps, its version)."""
    if kind == "resize_":
        rects.resize_(rects.shape[0], 3)
    elif kind == "t_":
        rects.t_()
    elif kind == "as_strided_":
        rects.as_strided_(rects.shape, (1, rects.shape[0]))
    elif kind == "data = float64":
        rects.data = rects.data.double()
    elif kind == "data = transposed copy":
        rects.data = rects.data.t().contiguous().t()


@pytest.mark.parametrize("kind", ["resize_", "t_", "as_strided_", "data = float64",
                                  "data = transposed copy"])
def test_primitive_check_runs_again_after_a_change(kind, monkeypatch):
    """The wrapper checks the primitives once per tensor and device while
    they do not change; any change that could make the kernel misread them
    checks again, and raises."""
    calls = []
    real = fields.check_primitives
    monkeypatch.setattr(fields, "check_primitives", lambda *a: (calls.append(1), real(*a)))
    monkeypatch.setattr(fields, "_CHECKED", {})
    rects, circles = _primitives()
    cpu = torch.device("cpu")
    for _ in range(3):
        fields._check_primitives_once(rects, circles, cpu)
    assert len(calls) == 1
    fields._check_primitives_once(rects.clone(), circles, cpu)  # another tensor
    assert len(calls) == 2
    _spoil(kind, rects)
    with pytest.raises(ValueError, match="primitive field kernel"):
        fields._check_primitives_once(rects, circles, cpu)
    assert len(calls) == 3
