"""The Panda problem of ``configs/panda-multigoal.json``: upstream's
``examples/panda_environment.py`` (the 7-DOF Franka Panda from its start
configuration towards an SE(3) target among five spheres) at the repo's
multi-goal scale, on the port's fast Panda stack,
``StochGPMP(fused_kernel=True)``: the fused kernel K5 runs ``iters - 1``
iterations of each ``optimize`` call, the dof route (K3, K4) the last.

Inputs. The goals and the target pose are the configuration's. The spheres
of a plan are drawn here from its scene seed by upstream's
``random_init_static_sphere`` rule, rounded to float32, and handed to the
program as the observation ``{"obstacle_spheres": [1, O, 4]}``.

The check (``judge``), besides ``portbench/check.py``'s ``init`` of each
plan: of each kept call's last iteration, which runs on the dof route and
returns its samples, ``draw`` (``x - mu`` whitened by the reference's
per-dof factor against the route's normals, redrawn from the generator as
the call found it, past the K5 loop's launch seeds; ``mu = (mu_out - a
sum_s w_s x_s) / (1 - a)`` with the weights of the program's costs),
``cost`` (the program's costs against the float64 reference's on the
program's samples, over the particle's median cost), ``scene`` (the same
gap in units of the scene's own term, below) and ``answer`` (the host
result against the sample ``get_traj('best')`` picks, the first largest
of the program's weights, exact). K5's
iterations never leave the device, so after the window the check replays
each kept call's K5 loop launch by launch through the planner's own step,
from the call's input means with the call's launch seeds; ``loop``
whitens the call's last samples against the means the replay reached. The
replay's first launch and one drawn from the seed are held against the
reference, which redraws K5's Philox normals (``reference/philox_dof.py``):
``k5_draw`` whitens the step ``(mu' - mu) / a`` against the draw weighted
by the program's costs, ``k5_cost`` recomputes the cost of the sample a
particle moved to, where one sample carries the whole weight, and
``k5_scene`` holds the scene's term as K5 computes it, the launch's costs
less those of the same launch with the step's spheres moved away, at each
particle's heaviest sample against the reference's at its redraw.

The scene numbers. The costs are ~1e9, and the quadratic and the SE(3)
goal make nearly all of it; the spheres add ~1e3 to ~1e6 a sample, as
little as float32's error on the sums (~1e3) where the spheres barely
reach the arm. So ``cost``, relative to the whole cost, cannot see a scene
that is ignored or stale; ``scene`` and ``k5_scene`` are errors over the
reference's obstacle term, counted no lower than ``SCENE_FLOOR`` of the
cost, so that a scene too far from the arm to matter reads as sound.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, replace

import numpy as np
import torch

from portbench import check
from portbench.reference.panda import F64, PandaProblem, planes
from portbench.reference.philox_dof import dof_normals_at

# a sample of smaller weight is left out of k5_draw's weighted draw: its
# share of the sum is below 1e-11
WEIGHT_FLOOR = 1e-12
# the scene numbers count the scene's term no lower than this share of the
# cost's norm: ~20 times float32's error on the sums (4.7e-7 of it)
SCENE_FLOOR = 1e-5
# a sphere moved this far leaves no trace in the obstacle term
FAR = 1e3


def make_spheres(cfg: dict, seed: int) -> np.ndarray:
    """The spheres of one scene, ``[O, 4]`` (centre, radius) float32-exact:
    upstream's ``random_init_static_sphere`` on ``default_rng(seed)``, a
    radius between the configuration's two, one coordinate interpolated in
    the spawn box and the others raw draws, x and y given random signs,
    each magnitude clipped to ``[offset, box max]``."""
    sc = cfg["spheres"]
    rng = np.random.default_rng(seed)
    lo, hi = (np.asarray(b, dtype=np.float64) for b in sc["box"])
    r_min, r_max = sc["radius"]
    out = np.zeros((sc["num"], 4))
    for i in range(sc["num"]):
        alpha = rng.uniform()
        radius = alpha * r_min + (1 - alpha) * r_max
        idx = rng.permutation([1, 0, 0])
        pos = rng.random(3)
        a = rng.random(1)
        pos[idx == 1] = a * lo[idx == 1] + (1 - a) * hi[idx == 1]
        pos[:-1] *= rng.integers(2, size=2) * 2 - 1
        out[i, :3] = np.sign(pos) * np.clip(np.abs(pos), sc["offset"], hi)
        out[i, 3] = radius
    return out.astype(np.float32).astype(np.float64)


def empty_scene(spheres):
    """Spheres ``[..., O, 4]`` (a tensor or an array) moved ``FAR`` away: the same
    count and radii, and no obstacle term."""
    far = spheres.clone() if torch.is_tensor(spheres) else spheres.copy()
    far[..., :3] += FAR
    return far


def scene_gap(d: torch.Tensor, scene: torch.Tensor, costs: torch.Tensor) -> float:
    """A cost error ``d`` in units of the scene's term: ``|d| / (|scene| +
    SCENE_FLOOR |costs|)``, norms over all entries."""
    return float(d.norm() / (scene.norm() + SCENE_FLOOR * costs.norm()))


def route_normals(call: check.Call, shape: tuple, dtype, seeds_before: int) -> torch.Tensor:
    """The normals of a call's last, dof-route iteration, ``[n, P, S, 2T]``
    on the planner's device, redrawn from its generator as it stood when
    the call began: past the ``seeds_before`` launch seeds of its fused
    loop, as ``StochGPMP.optimize`` draws them."""
    gen = torch.Generator(device=call.mu_in.device)
    gen.set_state(call.rng_state)
    if seeds_before:
        torch.randint(0, check.SEED_HIGH, (seeds_before,), generator=gen, device=gen.device)
    return torch.randn(shape, generator=gen, dtype=dtype, device=gen.device)


def philox_weighted_draw(w: torch.Tensor, seed: int, n: int, m: int) -> torch.Tensor:
    """``sum_s w_s eps_s`` of K5's draw for launch ``seed`` with weights
    ``w [P, S]``, ``[n, P, m]`` float64: the normals redrawn only for the
    sample pairs that carry weight."""
    p, s = w.shape
    wp = torch.nn.functional.pad(w.to(F64), (0, s % 2)).reshape(p, -1, 2)
    pp, jj = torch.nonzero(wp.amax(-1) > WEIGHT_FLOOR, as_tuple=True)
    z = torch.as_tensor(dof_normals_at(seed, n, m, pp.numpy(), jj.numpy()))  # [n, K, 2, m]
    part = torch.einsum("kh,dkhm->dkm", wp[pp, jj], z)
    return torch.zeros((n, p, m), dtype=F64).index_add_(1, pp, part)


def largest_gap(z: torch.Tensor, eps: torch.Tensor) -> float:
    """Largest ``|z - eps| / |eps|`` over rows."""
    return float(((z - eps).norm(dim=-1) / eps.norm(dim=-1)).max())


@dataclass
class Plan:
    """One planner, the spheres of its scene and their observation, its
    initial means and its generator's state before it drew them."""

    planner: object
    spheres: np.ndarray
    observation: dict
    init_means: torch.Tensor
    init_state: torch.Tensor


class Problem:
    """Builds plans of the configuration on ``device`` and judges calls."""

    def __init__(self, cfg: dict, device):
        self.cfg = cfg
        self.device = torch.device(device)
        self.dtype = getattr(torch, cfg["dtype"])
        self.num_particles = cfg["particles_per_goal"] * len(cfg["goals"])
        self._chain = self._ref = None

    def plan(self, scene_seed: int, planner_seed: int) -> Plan:
        """The program's cost stack and planner in a new scene (set-up of a
        plan)."""
        from stoch_gpmp_tpu_torch.costs import (
            CostComposite,
            CostGP,
            CostGoalPrior,
            PlaneFieldsCost,
            QuadraticCost,
        )
        from stoch_gpmp_tpu_torch.kinematics import franka_panda
        from stoch_gpmp_tpu_torch.planners import StochGPMP

        cfg, dev, dt = self.cfg, self.device, self.dtype
        if self._chain is None:
            self._chain = franka_panda(dt)
        spheres = make_spheres(cfg, scene_seed)
        n, t, c, f = cfg["n_dof"], cfg["traj_len"], cfg["cost"], cfg["fields"]
        cost_gp = CostGP.create(n, t, cfg["start"], cfg["dt"],
                                {"sigma_start": c["sigma_start"], "sigma_gp": c["sigma_gp"]},
                                dtype=dt, device=dev)
        cost_goal = CostGoalPrior.create(n, t, cfg["goals"], sigma_goal_prior=c["sigma_goal_prior"],
                                         dtype=dt, device=dev)
        target = torch.as_tensor(cfg["target_h"], dtype=dt, device=dev)
        cost = CostComposite.create(n, t, [
            QuadraticCost.from_gp_and_goal_prior(cost_gp, cost_goal, t),
            PlaneFieldsCost.create(n, t, self._chain, target, margin=f["margin"],
                                   sigma_self=f["sigma_self"], sigma_coll=f["sigma_coll"],
                                   sigma_goal=f["sigma_goal"]),
        ])
        si, ss = cfg["init_sigmas"], cfg["sample_sigmas"]
        planner = StochGPMP(
            num_particles_per_goal=cfg["particles_per_goal"], num_samples=cfg["num_samples"],
            traj_len=t, dt=cfg["dt"], n_dof=n, opt_iters=1, temperature=cfg["temperature"],
            start_state=cfg["start"], multi_goal_states=cfg["goals"], cost=cost,
            step_size=cfg["step_size"], sigma_start_init=si["start"], sigma_goal_init=si["goal"],
            sigma_gp_init=si["gp"], sigma_start_sample=ss["start"], sigma_goal_sample=ss["goal"],
            sigma_gp_sample=ss["gp"], seed=planner_seed, dtype=dt, device=dev, fused_kernel=True,
        )
        observation = {"obstacle_spheres": torch.as_tensor(spheres[None], dtype=dt, device=dev)}
        return Plan(planner=planner, spheres=spheres, observation=observation,
                    init_means=planner.particle_means,
                    init_state=torch.Generator(device=dev).manual_seed(planner_seed).get_state())

    @staticmethod
    def optimize(plan: Plan, iters: int) -> tuple:
        return plan.planner.optimize(opt_iters=iters, observation=plan.observation)

    @staticmethod
    def rng_state(plan: Plan) -> torch.Tensor:
        """The planner's generator state (read on the host)."""
        return plan.planner.generator.get_state()

    @staticmethod
    def means(plan: Plan) -> torch.Tensor:
        return plan.planner.particle_means

    @staticmethod
    def result(plan: Plan) -> np.ndarray:
        """The client's result: the best trajectory, on the host."""
        return plan.planner.get_traj().cpu().numpy()

    # --- the check -----------------------------------------------------------

    def reference(self) -> PandaProblem:
        if self._ref is None:
            self._ref = PandaProblem(self.cfg)
        return self._ref

    def judge(self, calls: list, probe_seeds: list) -> dict:
        """The compared numbers over the kept ``calls`` (each the largest
        over calls and particles); ``probe_seeds`` pick the fused launch
        judged besides the first, one per call."""
        ref = self.reference()
        nums = dict.fromkeys(("init", "draw", "loop", "cost", "scene", "answer", "k5_draw",
                              "k5_cost", "k5_scene"), 0.0)
        seen = set()
        for call, seed in zip(calls, probe_seeds):
            if id(call.plan) not in seen:
                seen.add(id(call.plan))
                nums["init"] = max(nums["init"], check.init_gap(
                    ref, call.plan.init_means, call.plan.init_state, len(self.cfg["goals"]),
                    self.cfg["particles_per_goal"]))
            mu_loop, fused = self._judge_fused(ref, call, seed)
            for k, v in {**self._judge_dof(ref, call, mu_loop), **fused}.items():
                nums[k] = max(nums[k], v)
        return nums

    def _judge_dof(self, ref: PandaProblem, call: check.Call, mu_loop: torch.Tensor) -> dict:
        """``draw``, ``loop``, ``cost``, ``scene`` and ``answer`` of the call's last
        iteration; ``mu_loop``, the dof planes the K5 loop should have
        left."""
        out = call.out
        p, s = out[4].shape
        n, t, a = ref.n, ref.T, ref.step_size
        with torch.no_grad():
            eps = route_normals(call, (n, p, s, 2 * t), self.dtype, call.iters - 1)
            x_prog = torch.cat([out[2], out[3]], -1).detach()
            x = planes(x_prog.to(F64))
            mu_out = planes(torch.cat([out[0], out[1]], -1).detach().to(F64))
            costs = out[4].detach().to(F64)
            w = ref.weights(costs)
            mu = (mu_out - a * torch.einsum("ps,dpsk->dpk", w, x)) / (1 - a)
            e = ref.rows(eps)
            draw = largest_gap(ref.whiten(x - mu[:, :, None]), e)
            loop = largest_gap(ref.whiten(x - mu_loop.to(F64)[:, :, None]), e)
            c_ref, o_ref = ref.costs_and_scene(x, mu, call.plan.spheres)
            scale = c_ref.abs().median(dim=1, keepdim=True).values
            cost = float(((costs - c_ref).abs() / scale).max())
            scene = scene_gap(costs - c_ref, o_ref, c_ref)
            answer = 0.0
            if call.result is not None:
                # get_traj('best'): the first largest of the program's own
                # weights, softmax of its float32 costs, over all samples
                w_prog = torch.softmax(-out[4].detach() / ref.temperature, dim=1)
                best = x_prog.reshape(p * s, t, 2 * n)[int(torch.argmax(w_prog.reshape(-1)))]
                res = torch.as_tensor(call.result, dtype=F64, device=x.device)
                answer = float((best.to(F64) - res).abs().max()
                               / res.abs().max().clamp(min=1e-30))
        return {"draw": draw, "loop": loop, "cost": cost, "scene": scene, "answer": answer}

    @staticmethod
    def k5_launch(call: check.Call, mu: torch.Tensor, seed: int, empty: bool = False) -> tuple:
        """One launch of the call's fused step, judged: ``(new_means,
        costs)``; with ``empty``, of the same step with its spheres moved
        away."""
        step = call.plan.planner._fused[1].step
        if empty:
            step = replace(step, spheres=empty_scene(step.spheres))
        return step(mu, seed=seed)

    def _judge_fused(self, ref: PandaProblem, call: check.Call, probe: int) -> tuple:
        """The dof planes the call's K5 loop should have left, by its
        replay, and ``k5_draw``, ``k5_cost``, ``k5_scene`` of the replay's
        first launch and one drawn from ``probe``."""
        from stoch_gpmp_tpu_torch.gp.dof_factored import to_dof_planes

        mu = to_dof_planes(call.mu_in)
        if call.iters < 2:
            return mu, {}
        step = call.plan.planner._fused[1].step
        seeds = check.launch_seeds(call, call.iters - 1)
        picked = {0, random.Random(probe).randrange(len(seeds))}
        nums = {"k5_draw": 0.0, "k5_cost": 0.0, "k5_scene": 0.0}
        with torch.no_grad():
            for i, seed in enumerate(seeds):
                if i in picked:
                    for k, v in self._judge_launch(ref, call, mu, seed).items():
                        nums[k] = max(nums[k], v)
                mu = step(mu, seed=seed)[0]
        return mu, nums

    @staticmethod
    def weighted_draw(w: torch.Tensor, seed: int, mu: torch.Tensor) -> torch.Tensor:
        """``sum_s w_s eps_s`` of a launch's draw from means ``mu [n, P,
        m]``, ``[n, P, m]`` float64 on ``mu``'s device: K5's Philox normals
        on the card, the plain version's generator on the CPU."""
        (n, _, m), (p, s) = mu.shape, w.shape
        if mu.device.type != "cpu":
            return philox_weighted_draw(w.cpu(), seed, n, m).to(mu.device)
        eps = torch.randn((n, p, s, m), generator=torch.Generator().manual_seed(int(seed)),
                          dtype=mu.dtype)
        return torch.einsum("ps,dpsm->dpm", w, eps.to(F64))

    def _judge_launch(self, ref: PandaProblem, call: check.Call, mu: torch.Tensor,
                      seed: int) -> dict:
        new_mu, costs = self.k5_launch(call, mu, seed)
        p = mu.shape[1]
        mu64 = mu.detach().to(F64)
        costs = costs.detach().to(F64)
        r = (new_mu.detach().to(F64) - mu64) / ref.step_size
        w = ref.weights(costs)
        target = self.weighted_draw(w, seed, mu)
        k5_draw = largest_gap(ref.whiten(r), ref.rows(target))
        # the cost of the sample each particle moved to, where one sample
        # carries the whole weight
        one = w.max(dim=1).values > 1 - 1e-9
        rows, best = torch.arange(p, device=costs.device), w.argmax(dim=1)
        k5_cost = 0.0
        if bool(one.any()):
            c_ref = ref.costs((mu64 + r)[:, :, None], mu64, call.plan.spheres)[:, 0]
            k5_cost = float(((costs[rows, best] - c_ref).abs() / c_ref.abs())[one].max())
        # the scene's term as K5 computes it, at each particle's heaviest
        # sample, against the reference's at its redraw of that sample
        _, bare = self.k5_launch(call, mu, seed, empty=True)
        pick = torch.zeros_like(w)
        pick[rows, best] = 1.0
        eps = self.weighted_draw(pick, seed, mu)  # [n, P, m]
        x = mu64 + eps @ ref.w_plane.to(eps.device)
        c_ref, o_ref = ref.costs_and_scene(x[:, :, None], mu64, call.plan.spheres)
        k5_scene = scene_gap((costs - bare.detach().to(F64))[rows, best] - o_ref[:, 0], o_ref,
                             c_ref)
        return {"k5_draw": k5_draw, "k5_cost": k5_cost, "k5_scene": k5_scene}
