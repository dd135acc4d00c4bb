"""Link RBF fields: FK + fields per trajectory (kernel K4), fields at given
link positions (K7) and FK + fields per configuration (K8); wrappers and
plain versions.

All three evaluate, at the link positions ``p_l`` of one configuration,

    w_self * (sum_{i < j} 2 exp(-|p_i - p_j|^2 / (2 margin^2)) + L)
  + w_obst * sum_{l, k} exp(-0.5 |p_l - c_k|^2 / r_k^2)

(the self field sums all ordered link pairs with the diagonal, as the
reference does), term by term in the TPU kernels' order.

- K4, ``fk_link_fields_cost_rows``: replaces the TPU kernel
  ``stoch_gpmp_tpu/ops/pallas/panda_fields.py fk_link_fields_cost_rows``
  (``_fk_fields_rows_kernel``), and the one-hot selection matmul of
  ``fk_link_fields_cost_flat`` in front of it. It reads the joint-angle
  planes ``q [d, B, T]`` through their strides, so the dof planes
  ``[d, B, 2T]`` and the flat ``[B, T, 2d]`` batch are both read in place,
  and sums the fields over ``t >= 1`` per trajectory. The CUDA source is
  ``csrc/fk_fields.cu`` with the chain walk in ``csrc/fk_chain.cuh``: one
  thread per ``(b, t)`` point, two trajectories per 256-thread block at T =
  128. It is bound by its arithmetic: ~1,200 FP32 operations and 81 ``exp2``
  per point.
- K7, ``fused_link_fields_cost``: replaces ``fused_link_fields_cost``
  (``_kernel``): the fields at link positions ``[..., L, 3]`` read through
  their strides (``csrc/link_fields.cu``): a CTA copies a tile of points
  into shared memory in coalesced words, and the Panda's 9 links are
  unrolled in registers, one thread per point. Bound by its bytes (108 B
  per point with 9 links) at large batches, by the launch at config 4's
  10,080 points.
- K8, ``fk_link_fields_cost``: replaces ``fk_link_fields_cost``
  (``_fk_fields_kernel``): FK + fields per row of ``q [N, d]``, read in
  place, one thread per row (the second entry of ``csrc/fk_fields.cu``).
  Bound as K4.

K4 and K8 (and K5, K6) walk the chain unrolled with the link positions in
registers where the chain has a spec compiled into the kernels (the Panda:
``csrc/fk_spec.h FkPanda``), and generically otherwise; :func:`fk_variant`
asks the kernels' own rule which walk a chain takes. K7 unrolls the
Panda's 9 links and takes any other count at run time. Each wrapper counts
its launches in ``.launches`` and, of those, the generic walk's (K7: the
runtime link count's) in ``.generic_launches``.

Each wrapper launches its kernel for a CUDA tensor and runs its plain
version only for a CPU tensor.
"""

from __future__ import annotations

import ctypes
import math
import weakref

import torch

from stoch_gpmp_tpu_torch.ops.kernels import _build

FK_MAX_JOINTS = 16  # csrc/fk_chain.cuh


class FkChainC(ctypes.Structure):
    """``struct FkChain`` of ``csrc/fk_chain.cuh``."""

    _fields_ = [
        ("n_joints", ctypes.c_int), ("n_links", ctypes.c_int),
        ("type", ctypes.c_int * FK_MAX_JOINTS), ("dof", ctypes.c_int * FK_MAX_JOINTS),
        ("slot", ctypes.c_int * FK_MAX_JOINTS),
        ("rot", ctypes.c_float * (9 * FK_MAX_JOINTS)),
        ("trans", ctypes.c_float * (3 * FK_MAX_JOINTS)),
        ("axis", ctypes.c_float * (3 * FK_MAX_JOINTS)),
    ]


_VARIANTS: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def fk_variant(chain, lib=None) -> int:
    """The FK walk the kernels take for ``chain``, as ``csrc/fk_spec.h``
    decides it (``fk_chain_variant``, the rule the launchers check): 1 the
    walk specialised for the Panda (``FkPanda``), 0 the generic walk. Asked
    once per chain; ``lib`` is a library that exports ``fk_chain_variant``
    (default the kernels')."""
    if chain not in _VARIANTS:
        lib = _build.load_library() if lib is None else lib
        _VARIANTS[chain] = int(lib.fk_chain_variant(ctypes.byref(fk_chain_c(chain))))
    return _VARIANTS[chain]


def _exp(v):
    """``exp`` of a tensor or of a Python float (a link position the FK
    folded to a constant)."""
    return torch.exp(v) if torch.is_tensor(v) else math.exp(v)


_TABLES: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def fk_chain_c(chain) -> FkChainC:
    """The chain's joint table as the kernels' ``FkChain`` (float32), built
    once per chain."""
    if chain not in _TABLES:
        tab = chain.joint_table()
        n = len(tab["type"])
        if n > FK_MAX_JOINTS:
            raise ValueError(f"FK kernels take at most {FK_MAX_JOINTS} joints, got {n}")
        c = FkChainC()
        c.n_joints, c.n_links = n, len(chain.link_names)
        for name in ("type", "dof", "slot"):
            getattr(c, name)[:n] = [int(v) for v in tab[name]]
        for name in ("rot", "trans", "axis"):
            flat = tab[name].reshape(n, -1).astype("float32").ravel().tolist()
            getattr(c, name)[: len(flat)] = flat
        _TABLES[chain] = c
    return _TABLES[chain]


def link_fields_plain(pos, spheres, *, margin: float, w_self: float, w_obst: float):
    """Self RBF + obstacle RBF at link positions ``pos`` (per link a
    ``[x, y, z]`` list of tensors or Python floats) with ``spheres [O, 4]``
    (or None); the formula of the module docstring, term by term in the TPU
    kernel's order."""
    n_links = len(pos)
    acc = 0.0
    if w_self != 0.0:
        inv = 1.0 / (2.0 * margin * margin)
        s = 0.0
        for i in range(n_links):
            for j in range(i + 1, n_links):
                dx = pos[i][0] - pos[j][0]
                dy = pos[i][1] - pos[j][1]
                dz = pos[i][2] - pos[j][2]
                s = s + 2.0 * _exp(-(dx * dx + dy * dy + dz * dz) * inv)
        acc = acc + w_self * (s + float(n_links))
    if w_obst != 0.0 and spheres is not None and spheres.shape[0]:
        o = 0.0
        for li in range(n_links):
            for k in range(spheres.shape[0]):
                dx = pos[li][0] - spheres[k, 0]
                dy = pos[li][1] - spheres[k, 1]
                dz = pos[li][2] - spheres[k, 2]
                r = spheres[k, 3]
                o = o + _exp(-0.5 * (dx * dx + dy * dy + dz * dz) / (r * r))
        acc = acc + w_obst * o
    return acc


def fk_link_fields_cost_rows_plain(chain, q, spheres, *, margin, w_self, w_obst):
    """Plain PyTorch version of K4: ``q [d, B, T]`` joint-angle planes (any
    strides) -> ``[B]``, the fields at ``t >= 1`` summed per trajectory,
    through the folded FK of ``chain.fk_planes_from_scalars``."""
    qs = [q[i, :, 1:] for i in range(chain.n_dofs)]
    pos = [p for _, p in chain.fk_planes_from_scalars(qs)]
    vals = link_fields_plain(pos, spheres, margin=margin, w_self=w_self, w_obst=w_obst)
    if not torch.is_tensor(vals):  # both weights zero
        return q.new_zeros(q.shape[1])
    return torch.sum(vals, dim=-1)


def _spheres(spheres, dev):
    if spheres is None:
        return torch.zeros((0, 4), dtype=torch.float32, device=dev)
    return spheres.reshape(-1, 4).to(device=dev, dtype=torch.float32).contiguous()


_SPHERES: dict = {}  # per device: (weakref to the caller's spheres or None, its state, copy)


def kernel_spheres(spheres, dev):
    """The kernels' contiguous float32 ``[O, 4]`` spheres on ``dev`` from
    ``[..., 4]`` spheres or None, made once per spheres tensor (its in-place
    version and its storage: a write, a resize or a ``.data`` swap for other
    storage makes a new copy) and device: a planner passes the same observation on every
    iteration."""
    ref, state, sp = _SPHERES.get(dev, (None, None, None))
    if spheres is None:
        if ref is not None or sp is None:
            sp = _spheres(None, dev)
            _SPHERES[dev] = (None, None, sp)
        return sp
    now = (spheres._version, spheres.data_ptr())
    if ref is None or ref() is not spheres or state != now:
        sp = _spheres(spheres, dev)
        _SPHERES[dev] = (weakref.ref(spheres), now, sp)
    return sp


def fk_link_fields_cost_rows(chain, q, spheres, *, margin, w_self, w_obst):
    """``q [d, B, T]`` joint-angle planes (any strides: a view of the dof
    planes or of a flat batch) -> ``[B]`` summed link fields: kernel K4 for
    a CUDA tensor (float32), the plain version for a CPU tensor.
    ``spheres``: ``[..., 4]`` obstacle spheres or None."""
    if q.device.type == "cpu":
        sp = None if spheres is None else spheres.reshape(-1, 4).to(q.dtype)
        return fk_link_fields_cost_rows_plain(chain, q, sp, margin=margin, w_self=w_self,
                                              w_obst=w_obst)
    if q.device.type != "cuda":
        raise ValueError(f"fk fields kernel: unsupported device {q.device}")
    d, b, t = q.shape
    if q.dtype != torch.float32 or d != chain.n_dofs:
        raise ValueError(f"fk fields kernel takes float32 [{chain.n_dofs}, B, T] joint "
                         f"planes, got {q.dtype} {tuple(q.shape)}")
    sp = kernel_spheres(spheres, q.device)
    out = torch.empty((b,), dtype=torch.float32, device=q.device)
    if b == 0:
        return out
    variant = fk_variant(chain)
    lib = _build.load_library()
    err = lib.fk_fields_launch(
        q.data_ptr(), q.stride(0), q.stride(1), q.stride(2), b, t,
        sp.data_ptr(), int(sp.shape[0]), 1.0 / (2.0 * margin * margin), float(w_self),
        float(w_obst), ctypes.byref(fk_chain_c(chain)), variant, out.data_ptr(),
        _build.stream_ptr(q.device),
    )
    _build.check(err, "fk_fields_launch")
    fk_link_fields_cost_rows.launches += 1
    fk_link_fields_cost_rows.generic_launches += int(variant == 0)
    return out


fk_link_fields_cost_rows.launches = 0
fk_link_fields_cost_rows.generic_launches = 0


def fused_link_fields_cost_plain(positions, spheres, *, margin, w_self, w_obst):
    """Plain PyTorch version of K7: link positions ``[..., L, 3]`` (any
    strides) -> ``[...]``."""
    pos = [[positions[..., l, c] for c in range(3)] for l in range(positions.shape[-2])]
    vals = link_fields_plain(pos, spheres, margin=margin, w_self=w_self, w_obst=w_obst)
    return vals + positions.new_zeros(positions.shape[:-2])


LINK_FIELDS_UNROLLED = 9  # the link count K7 unrolls (the Panda's: csrc/fk_spec.h FkPanda)


def link_fields_view(positions):
    """``positions [..., L, 3]`` as the ``[N0, N1, L, 3]`` view K7 reads
    through its strides (more batch axes are merged first, a copy only where
    they do not merge; fewer are padded), checked to index in 32 bits."""
    if positions.dim() == 4:
        pos = positions
    elif positions.dim() > 4:
        pos = positions.reshape((-1,) + positions.shape[-3:])
    else:
        pos = positions.reshape((1,) * (4 - positions.dim()) + positions.shape)
    _build.check_index_range("link fields kernel", pos)
    return pos


def fused_link_fields_cost(positions, spheres, *, margin, w_self, w_obst):
    """``w_self * LinkSelfDistanceField(margin) + w_obst *
    LinkDistanceField('rbf')`` at link positions ``[..., L, 3]`` (any
    strides) -> ``[...]``: kernel K7 for a CUDA tensor (float32), the plain
    version for a CPU tensor. ``spheres``: ``[..., 4]`` obstacle spheres or
    None. A link count other than the Panda's 9 runs the kernel's runtime-L
    instantiation, counted in ``.generic_launches``."""
    if positions.device.type == "cpu":
        sp = None if spheres is None else spheres.reshape(-1, 4).to(positions.dtype)
        return fused_link_fields_cost_plain(positions, sp, margin=margin, w_self=w_self,
                                            w_obst=w_obst)
    if positions.device.type != "cuda":
        raise ValueError(f"link fields kernel: unsupported device {positions.device}")
    if positions.dtype != torch.float32 or positions.dim() < 2 or positions.shape[-1] != 3:
        raise ValueError("link fields kernel takes float32 [..., L, 3] link positions, got "
                         f"{positions.dtype} {tuple(positions.shape)}")
    dev = positions.device
    out = torch.empty(positions.shape[:-2], dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    pos = link_fields_view(positions)
    sp = kernel_spheres(spheres, dev)
    n_links = pos.shape[2]
    err = _build.load_library().link_fields_launch(
        pos.data_ptr(), pos.shape[0], pos.shape[1], *pos.stride(), n_links,
        sp.data_ptr(), sp.shape[0], 1.0 / (2.0 * margin * margin), float(w_self),
        float(w_obst), out.data_ptr(), _build.stream_ptr(dev),
    )
    _build.check(err, "link_fields_launch")
    fused_link_fields_cost.launches += 1
    fused_link_fields_cost.generic_launches += int(n_links != LINK_FIELDS_UNROLLED)
    return out


fused_link_fields_cost.launches = 0
fused_link_fields_cost.generic_launches = 0


def fk_link_fields_cost_plain(chain, q, spheres, *, margin, w_self, w_obst):
    """Plain PyTorch version of K8: ``q [N, d]`` (any strides) -> ``[N]``,
    through the folded FK of ``chain.fk_planes_from_scalars``."""
    pos = [p for _, p in chain.fk_planes_from_scalars([q[:, i] for i in range(chain.n_dofs)])]
    vals = link_fields_plain(pos, spheres, margin=margin, w_self=w_self, w_obst=w_obst)
    return vals + q.new_zeros(q.shape[0])


def fk_link_fields_cost(chain, q, spheres, *, margin, w_self, w_obst):
    """FK + link fields per configuration, ``q [N, d]`` (any strides) ->
    ``[N]``: kernel K8 for a CUDA tensor (float32), the plain version for a
    CPU tensor. Equal to :func:`fused_link_fields_cost` on
    ``chain.fk_compact(q).positions`` up to float32 roundoff."""
    if q.device.type == "cpu":
        sp = None if spheres is None else spheres.reshape(-1, 4).to(q.dtype)
        return fk_link_fields_cost_plain(chain, q, sp, margin=margin, w_self=w_self,
                                         w_obst=w_obst)
    if q.device.type != "cuda":
        raise ValueError(f"fk point fields kernel: unsupported device {q.device}")
    if q.dtype != torch.float32 or q.dim() != 2 or q.shape[1] != chain.n_dofs:
        raise ValueError(f"fk point fields kernel takes float32 [N, {chain.n_dofs}] joint "
                         f"angles, got {q.dtype} {tuple(q.shape)}")
    out = torch.empty((q.shape[0],), dtype=torch.float32, device=q.device)
    if q.shape[0] == 0:
        return out
    sp = kernel_spheres(spheres, q.device)
    variant = fk_variant(chain)
    lib = _build.load_library()
    err = lib.fk_fields_points_launch(
        q.data_ptr(), q.stride(0), q.stride(1), q.shape[0], sp.data_ptr(), int(sp.shape[0]),
        1.0 / (2.0 * margin * margin), float(w_self), float(w_obst),
        ctypes.byref(fk_chain_c(chain)), variant, out.data_ptr(),
        _build.stream_ptr(q.device),
    )
    _build.check(err, "fk_fields_points_launch")
    fk_link_fields_cost.launches += 1
    fk_link_fields_cost.generic_launches += int(variant == 0)
    return out


fk_link_fields_cost.launches = 0
fk_link_fields_cost.generic_launches = 0
