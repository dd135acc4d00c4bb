"""The planner over a mesh of ``torch.distributed`` ranks.

PyTorch counterpart of ``stoch_gpmp_tpu/parallel/sharding.py``. The JAX
package keeps one global program and lets GSPMD place it; here each rank is
a process that holds its own block, and the collectives are explicit:

- ``p`` (goals x particles, data-parallel): rank ``(i, j)`` holds particles
  ``i * P / n_p .. (i + 1) * P / n_p`` (the means, their samples, their
  solves). A goal-dependent cost is viewed on that block
  (``particle_block``: one goal per local particle, its global goal), so a
  block that starts inside a goal scores every particle against its own
  goal.
- ``s`` (Monte-Carlo samples, reduction-parallel): rank ``(i, j)`` holds
  samples ``j * S / n_s .. (j + 1) * S / n_s`` of its particles. The
  softmax's max and sum and the weighted-mean update are all-reduced over
  the ranks of the same ``i`` (the ``s`` group).
- Gauss-Newton shards particles over ``p`` only; its trust-region damping,
  a mean over all particles, is all-reduced over the ranks of the same
  ``j`` (the ``p`` group).

Draws do not change with the mesh: every rank draws the global eps from its
generator (seeded alike on every rank) and keeps its block, so a sharded run
takes the single-process run's draws. An injected ``eps=`` is the global
draw, sliced the same way.

On CUDA tensors the collectives are ``all_reduce`` and nothing else, which
gloo and NCCL both take; a gather is an ``all_reduce`` into a zero-filled
global buffer. A collective over a group of one rank is the identity and is
skipped over gloo (where it would pass through the host); NCCL runs it.
"""

from __future__ import annotations

import copy
import types
from dataclasses import dataclass, is_dataclass, replace

import numpy as np
import torch
import torch.distributed as dist

from stoch_gpmp_tpu_torch.planners.stoch_gpmp import (
    StochGPMPState,
    stoch_gpmp_optimize,
)


@dataclass
class Mesh:
    """A ``(p, s)`` grid of the default process group's ranks: ``devices
    [n_p, n_s]`` holds the ranks (JAX: the devices), ``shape`` maps each
    axis name to its size, ``coords`` this rank's ``(i, j)`` (None outside
    the mesh), ``device`` the torch device its tensors live on. The groups
    are the ranks of this rank's row (``s_group``: the same ``i``), of its
    column (``p_group``: the same ``j``) and of the whole mesh."""

    devices: np.ndarray
    axis_names: tuple
    rank: int
    coords: tuple | None
    device: torch.device
    backend: str
    p_group: object = None
    s_group: object = None
    group: object = None

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def is_member(self) -> bool:
        return self.coords is not None


def rank_device(device=None) -> torch.device:
    """The device of this rank's tensors: ``device`` when given, else the
    rank's card (``cuda:(rank % device_count)``; raises without one)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the ranks on the CPU")
    rank = dist.get_rank() if dist.is_initialized() else 0
    return torch.device("cuda", rank % torch.cuda.device_count())


def mesh_layout(n: int, axis_shape=None) -> np.ndarray:
    """The ranks ``0 .. n - 1`` laid out on the mesh: ``(n // 2, 2)`` for
    even ``n > 1``, else ``(n, 1)``, unless ``axis_shape`` is given; rank
    ``r`` at ``(r // n_s, r % n_s)``, as JAX's reshape of its device list."""
    if axis_shape is None:
        axis_shape = (n // 2, 2) if n % 2 == 0 and n > 1 else (n, 1)
    return np.arange(n).reshape(axis_shape)


def make_mesh(n_devices: int | None = None, axis_shape=None, axis_names=("p", "s"), *,
              device=None) -> Mesh:
    """A mesh over the first ``n_devices`` ranks of the default process
    group (all of them by default). Default shape, as the JAX package's:
    ``(n // 2, 2)`` for even ``n > 1``, else ``(n, 1)``. Rank ``r`` sits at
    ``(r // n_s, r % n_s)``.

    A collective call: every rank of the process group calls it (also the
    ranks outside the mesh, which get ``coords`` None), in the same order,
    because each group is made by ``dist.new_group``."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed initialised "
                           "(stoch_gpmp_tpu_torch.parallel.launch starts the ranks)")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"a mesh of {n} ranks in a process group of {world}")
    ranks = mesh_layout(n, axis_shape)
    rank = dist.get_rank()
    rows = [dist.new_group(ranks[i].tolist()) for i in range(ranks.shape[0])]
    cols = [dist.new_group(ranks[:, j].tolist()) for j in range(ranks.shape[1])]
    whole = dist.new_group(ranks.reshape(-1).tolist())
    coords = None
    if rank < n:
        coords = (rank // ranks.shape[1], rank % ranks.shape[1])
    return Mesh(
        devices=ranks, axis_names=tuple(axis_names), rank=rank, coords=coords,
        device=rank_device(device), backend=dist.get_backend(),
        s_group=rows[coords[0]] if coords else None,
        p_group=cols[coords[1]] if coords else None,
        group=whole if coords else None,
    )


class Shard:
    """This rank's place in a mesh, passed to the planners as their
    ``shard_samples`` / ``shard_dof`` / ``shard_particles`` hook (in the JAX
    package a sharding constraint): it slices the global draw to the rank's
    block, views the costs on the rank's particles, and does the
    reductions across ranks."""

    def __init__(self, mesh: Mesh):
        if not mesh.is_member:
            raise ValueError(f"rank {mesh.rank} is not in the mesh {mesh.devices.tolist()}")
        self.mesh = mesh
        self.n_p, self.n_s = mesh.devices.shape
        self.i, self.j = mesh.coords
        self._views: dict = {}

    # --- sizes and blocks ---
    def particles(self, p_local: int) -> tuple[int, int]:
        """``(first particle, total)`` of a block of ``p_local``."""
        return self.i * p_local, self.n_p * p_local

    def local_samples(self, num_samples: int) -> int:
        """This rank's count of ``num_samples`` in all."""
        if num_samples % self.n_s:
            raise ValueError(f"{num_samples} samples over {self.n_s} ranks of the s axis")
        return num_samples // self.n_s

    def draw(self, generator, shape, p_dim: int, s_dim: int, *, dtype, device,
             eps=None) -> torch.Tensor:
        """This rank's block of the global draw of ``shape`` (the local
        shape: particles on ``p_dim``, samples on ``s_dim``): the injected
        global ``eps``, or a fresh global draw from ``generator``."""
        gshape = list(shape)
        gshape[p_dim] *= self.n_p
        gshape[s_dim] *= self.n_s
        if eps is None:
            eps = torch.randn(gshape, generator=generator, dtype=dtype, device=device)
        elif list(eps.shape) != gshape:
            raise ValueError(f"injected eps {list(eps.shape)}: the global draw is {gshape}")
        eps = eps.narrow(p_dim, self.i * shape[p_dim], shape[p_dim])
        return eps.narrow(s_dim, self.j * shape[s_dim], shape[s_dim]).to(device)

    # --- the cost on this rank's particles ---
    def rows(self, cost, p_local: int):
        """``cost`` viewed on this rank's ``p_local`` particles
        (:func:`shard_rows`), built once per cost."""
        key = (id(cost), p_local)
        if key not in self._views:
            start, total = self.particles(p_local)
            self._views[key] = (cost, shard_rows(cost, start, p_local, total))
        return self._views[key][1]

    # --- reductions ---
    def _reduce(self, x, group, size, op=dist.ReduceOp.SUM):
        if size > 1 or self.mesh.backend == "nccl":
            dist.all_reduce(x, op=op, group=group)
        return x

    def sum_samples(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the ranks of the ``s`` group (in place)."""
        return self._reduce(x.contiguous(), self.mesh.s_group, self.n_s)

    def softmax(self, logits: torch.Tensor) -> torch.Tensor:
        """Softmax over dim 1 of ``logits [P, S_local]`` across the ``s``
        group: the max, then the sum of ``exp``, each all-reduced; with one
        rank on the axis, ``torch.softmax``."""
        if self.n_s == 1:
            return torch.softmax(logits, dim=1)
        m = self._reduce(logits.max(dim=1, keepdim=True).values.contiguous(),
                         self.mesh.s_group, self.n_s, dist.ReduceOp.MAX)
        e = torch.exp(logits - m)
        return e / self.sum_samples(e.sum(dim=1, keepdim=True))

    def mean_particles(self, x: torch.Tensor) -> torch.Tensor:
        """The mean over all particles of this rank's ``x [P_local, ...]``:
        the local sum all-reduced over the ``p`` group."""
        if self.n_p == 1:  # the unsharded mean, bit for bit
            return self._reduce(x.mean(dim=0), self.mesh.p_group, 1)
        return self._reduce(x.sum(dim=0), self.mesh.p_group, self.n_p) / (x.shape[0] * self.n_p)

    def metrics(self, costs, weights, norms, step_size):
        """``IterMetrics`` of the global batch from this rank's ``costs,
        weights [P_local, S_local]`` and per-particle update norms
        ``norms [P_local]``."""
        from stoch_gpmp_tpu_torch.planners.stoch_gpmp import IterMetrics

        p_loc, s_loc = costs.shape
        p_tot, s_tot = p_loc * self.n_p, s_loc * self.n_s
        ent = -torch.sum(weights * torch.log(weights + 1e-30))
        sums = self._reduce(torch.stack([costs.sum(), ent]), self.mesh.group, self.mesh.size)
        cmin = self._reduce(costs.min().reshape(1), self.mesh.group, self.mesh.size,
                            dist.ReduceOp.MIN)
        nsum = self._reduce(norms.sum().reshape(1), self.mesh.p_group, self.n_p)
        return IterMetrics(cost_mean=sums[0] / (p_tot * s_tot), cost_min=cmin[0],
                           weight_entropy=sums[1] / p_tot,
                           update_norm=step_size * nsum[0] / p_tot)

    # --- gathers ---
    def gather_particles(self, x: torch.Tensor) -> torch.Tensor:
        """The global tensor of the blocks ``x [P_local, ...]`` (replicated
        over ``s``): an all-reduce over the ``p`` group into a zero-filled
        buffer."""
        return self._gather(x, ((0, self.i, self.n_p),), self.mesh.p_group, self.n_p)

    def gather_samples(self, x: torch.Tensor) -> torch.Tensor:
        """The global tensor of the blocks ``x [P_local, S_local, ...]``: an
        all-reduce over the mesh."""
        return self._gather(x, ((0, self.i, self.n_p), (1, self.j, self.n_s)),
                            self.mesh.group, self.mesh.size)

    def _gather(self, x, splits, group, size):
        shape = list(x.shape)
        for dim, _, n in splits:
            shape[dim] *= n
        out = x.new_zeros(shape)
        view = out
        for dim, k, _ in splits:
            view = view.narrow(dim, k * x.shape[dim], x.shape[dim])
        view.copy_(x)
        return self._reduce(out, group, size)


def shard_rows(cost, start: int, count: int, total: int):
    """``cost`` on particles ``start .. start + count`` of a goal-major batch
    of ``total``: every goal-dependent cost (``CostGoalPrior``,
    ``QuadraticCost``, ``DofQuadraticCost``, also inside a
    ``CostComposite``, and a ``WoodburyGN``) replaced by its
    ``particle_block`` view, the rest as they are."""
    if hasattr(cost, "particle_block"):
        return cost.particle_block(start, count, total)
    if hasattr(cost, "costs") and is_dataclass(cost):
        return replace(cost, costs=tuple(shard_rows(c, start, count, total) for c in cost.costs))
    return cost


def shard_planner_state(mesh: Mesh, state: StochGPMPState) -> StochGPMPState:
    """This rank's particle block ``[P / n_p, T, d]`` of the global means,
    on the mesh's device; the generator stays shared (every rank draws the
    global eps from it and keeps its block)."""
    means = state.particle_means
    n_p = mesh.devices.shape[0]
    if means.shape[0] % n_p:
        raise ValueError(f"{means.shape[0]} particles over {n_p} ranks of the p axis")
    p_loc = means.shape[0] // n_p
    block = means[mesh.coords[0] * p_loc:(mesh.coords[0] + 1) * p_loc]
    return replace(state, particle_means=block.to(mesh.device).contiguous())


def shard_gpmp_state(mesh: Mesh, state):
    """``shard_planner_state`` of a ``GPMPState``."""
    return shard_planner_state(mesh, state)


def replicate(mesh: Mesh, tree):
    """``tree`` (the sampler, the costs, an observation: dataclasses,
    containers, tensors, bound methods) with every tensor on the mesh's
    device."""
    return _to_device(tree, mesh.device, {})


def _to_device(obj, device, memo):
    if id(obj) in memo:
        return memo[id(obj)]
    if torch.is_tensor(obj):
        out = obj.to(device)
    elif isinstance(obj, (list, tuple)):
        out = type(obj)(_to_device(v, device, memo) for v in obj)
    elif isinstance(obj, dict):
        out = {k: _to_device(v, device, memo) for k, v in obj.items()}
    elif isinstance(obj, types.MethodType):
        out = types.MethodType(obj.__func__, _to_device(obj.__self__, device, memo))
    elif isinstance(obj, (torch.Generator, torch.device, torch.dtype, type)) or not hasattr(
            obj, "__dict__"):
        out = obj
    else:
        out = copy.copy(obj)
        memo[id(obj)] = out
        for k, v in vars(obj).items():
            object.__setattr__(out, k, _to_device(v, device, memo))
    memo[id(obj)] = out
    return out


def make_sharded_optimize(mesh: Mesh, layout: str = "flat", **static_kwargs):
    """A sharded ``stoch_gpmp_optimize``: means over ``p``, samples over
    ``(p, s)``, the softmax and the weighted mean reduced over ``s``.

    ``layout='dof'`` shards the dof-factored path (``[d, P, S, 2T]`` planes
    as ``(None, p, s, None)``; a dof-capable problem is required, as in the
    JAX package), with K3 on each rank's rows (``_make_shard_dof_quad``).

    Returns ``fn(sampler, cost, state, observation) -> (state, aux)`` (plus
    the metrics with ``collect_metrics``), where ``state`` is this rank's
    block (``shard_planner_state``) and so is what it returns: the means
    ``[P / n_p, T, d]``, and the samples, costs and weights of the rank's
    ``S / n_s`` samples; ``num_samples`` is the global count. ``eps=``
    takes the global draws."""
    shard = Shard(mesh)
    if layout == "dof":
        kwargs = dict(static_kwargs, sample_method="dof", shard_dof=shard,
                      shard_dof_quad=_make_shard_dof_quad(mesh))
    elif layout == "flat":
        kwargs = dict(static_kwargs, shard_samples=shard)
    else:
        raise ValueError(f"unknown layout: {layout}")

    def run(sampler, cost, state, observation, **call_kwargs):
        return stoch_gpmp_optimize(sampler, cost, state, observation,
                                   **dict(kwargs, **call_kwargs))

    run.shard = shard
    return run


def _make_shard_dof_quad(mesh: Mesh):
    """The sharded dof path's K3 call: ``stencil.dof_quad_eval`` (the same
    signature) on this rank's rows, K3 on a CUDA tensor (raising on what K3
    does not take, as unsharded), its plain version on a CPU tensor. ``dq``
    is the quadratic viewed on the rank's particles (the planner views its
    cost through ``Shard.rows``: one goal row per particle), so K3 reads
    ``rows_per_goal`` = the rank's samples and needs no anchors operand; no
    collective crosses it, as none crosses JAX's ``shard_map`` body."""
    del mesh  # per-rank: the view carries the rank's place

    def shard_dof_quad(dq, x_planes, *, pu, temperature, num_samples):
        from stoch_gpmp_tpu_torch.ops.kernels import stencil

        assert dq.num_goals * num_samples == x_planes.shape[1], (
            f"{dq.num_goals} goal rows for {x_planes.shape[1] // num_samples} particles: "
            "the quadratic is not viewed on the rank's particles (Shard.rows)")
        return stencil.dof_quad_eval(dq, x_planes, pu=pu, temperature=temperature,
                                     num_samples=num_samples)

    return shard_dof_quad


def make_sharded_gpmp_optimize(mesh: Mesh, **static_kwargs):
    """Sharded Gauss-Newton: each rank solves its particle block (over
    ``p``; replicated over ``s``), the trust-region damping's mean over all
    particles all-reduced over the ``p`` group. Returns ``fn(cost, state,
    observation) -> state`` on this rank's block (``shard_gpmp_state``)."""
    from stoch_gpmp_tpu_torch.planners.gpmp import gpmp_optimize

    shard = Shard(mesh)

    def run(cost, state, observation):
        return gpmp_optimize(cost, state, observation, shard_particles=shard, **static_kwargs)

    run.shard = shard
    return run


__all__ = [
    "Mesh",
    "Shard",
    "make_mesh",
    "make_sharded_gpmp_optimize",
    "make_sharded_optimize",
    "replicate",
    "shard_gpmp_state",
    "shard_planner_state",
    "shard_rows",
]
