"""The planar problem of ``configs/planar-env.json``: upstream's
``examples/planar_environment.py`` (a 2-DOF point robot, three goals, a
20 x 20 map of 15 obstacles) on the port's fast planar stack,
``StochGPMP(fused_kernel=True)``.

Inputs. The scene is drawn here from the seed, by upstream's rule (2 x 2
rectangles and circles of radius 1, each centre uniform in +-7.5 and
redrawn while the obstacle overlaps one already placed, up to 25 times),
with the configuration's fixed numbers of each kind in an order drawn from
the seed, and handed to the program as a list of obstacles; the reference
rasterises the same list itself.

The check (``judge``), besides ``portbench/check.py``'s ``init`` of each
plan and ``draw``, ``cost`` and ``answer`` of each kept call's last
iteration (which runs on the flat route and returns its samples): the fused
kernel's iterations never leave the device, so after the window the check
replays each kept call's fused loop launch by launch through the planner's
own step, from the call's input means with the call's launch seeds (redrawn
from its generator's state). ``loop``: the call's last samples against the
means the replay reached, whitened against their normals; a loop that kept
its state, skipped launches or drew other seeds moves it. The replay's
first launch and one drawn from the seed are held against the reference,
which redraws the kernel's Philox normals, whitens the step by its own
``L`` against the draw weighted by the program's costs (``k2_draw``: ``(mu'
- mu) / a @ L`` against ``sum_s w_s eps_s``), and recomputes the cost of
the sample a particle moved to (``k2_cost``; the fused kernel may leave out
the goal's constant term, which cancels in the softmax).
"""

from __future__ import annotations

import random
from dataclasses import dataclass

import numpy as np
import torch

from portbench import check
from portbench.reference import philox
from portbench.reference.planar import EDGE, F64, Grid, PlanarProblem


def make_scene(cfg: dict, seed: int) -> list:
    """The obstacle list of one scene: ``("rect", cx, cy, w, h)`` and
    ``("circle", cx, cy, r)`` with float32-exact centres."""
    sc = cfg["scene"]
    rng = np.random.default_rng(seed)
    grid = Grid(cfg["map_dim"], cfg["cell_size"])
    (x0, x1), (y0, y1) = sc["limits"]
    out = []
    kinds = rng.permutation([True] * sc["num_rects"] + [False] * sc["num_circles"])
    for is_rect in kinds:
        for _attempt in range(sc["max_attempts"] + 1):
            cx = float(np.float32(rng.uniform(x0, x1)))
            cy = float(np.float32(rng.uniform(y0, y1)))
            if is_rect:
                obst = ("rect", cx, cy, *sc["rect_shape"])
            else:
                obst = ("circle", cx, cy, sc["circle_radius"])
                _, _, dist = grid.circle_cells(cx, cy, sc["circle_radius"])
                if np.abs(dist - sc["circle_radius"]).min() < sc["edge_margin"]:
                    continue
            trial = Grid(cfg["map_dim"], cfg["cell_size"])
            trial.map = grid.map.copy()
            trial.add(obst)
            if trial.map.max() <= 1:
                grid = trial
                out.append(obst)
                break
    return out


@dataclass
class Plan:
    """One planner, the scene it plans in, its initial means and its
    generator's state before it drew them."""

    planner: object
    obstacles: list
    init_means: torch.Tensor
    init_state: torch.Tensor


class Problem:
    """Builds plans of the configuration on ``device`` and judges calls."""

    def __init__(self, cfg: dict, device):
        self.cfg = cfg
        self.device = torch.device(device)
        self.dtype = getattr(torch, cfg["dtype"])
        self.num_particles = cfg["particles_per_goal"] * len(cfg["goals"])

    def plan(self, scene_seed: int, planner_seed: int) -> Plan:
        """The program's scene, cost stack and planner (set-up of a plan)."""
        from stoch_gpmp_tpu_torch.costs import (
            CostCollision,
            CostComposite,
            CostGP,
            CostGoalPrior,
            QuadraticCost,
            RasterPrimitive2DField,
        )
        from stoch_gpmp_tpu_torch.envs import (
            ObstacleCircle,
            ObstacleRectangle,
            generate_obstacle_map,
        )
        from stoch_gpmp_tpu_torch.planners import StochGPMP

        cfg, dev, dt = self.cfg, self.device, self.dtype
        obstacles = make_scene(cfg, scene_seed)
        prims = [ObstacleRectangle(*o[1:]) if o[0] == "rect" else ObstacleCircle(*o[1:])
                 for o in obstacles]
        obst_map, prims = generate_obstacle_map(map_dim=tuple(cfg["map_dim"]), obst_list=prims,
                                                cell_size=cfg["cell_size"], dtype=dt, device=dev)
        field = RasterPrimitive2DField.from_map(obst_map, prims, dtype=dt, device=dev)
        n, t, c = cfg["n_dof"], cfg["traj_len"], cfg["cost"]
        cost_gp = CostGP.create(n, t, cfg["start"], cfg["dt"],
                                {"sigma_start": c["sigma_start"], "sigma_gp": c["sigma_gp"]},
                                dtype=dt, device=dev)
        cost_goal = CostGoalPrior.create(n, t, cfg["goals"], sigma_goal_prior=c["sigma_goal_prior"],
                                         dtype=dt, device=dev)
        cost = CostComposite.create(n, t, [
            QuadraticCost.from_gp_and_goal_prior(cost_gp, cost_goal, t),
            CostCollision.create(n, t, field, sigma_coll=c["sigma_coll"]),
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
        return Plan(planner=planner, obstacles=obstacles, init_means=planner.particle_means,
                    init_state=torch.Generator(device=dev).manual_seed(planner_seed).get_state())

    @staticmethod
    def optimize(plan: Plan, iters: int) -> tuple:
        return plan.planner.optimize(opt_iters=iters)

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

    def judge(self, calls: list, probe_seeds: list) -> dict:
        """The compared numbers over the kept ``calls`` (each the largest
        over calls and particles); ``probe_seeds`` pick the fused launch
        judged besides the first, one per call."""
        refs: dict = {}
        nums = {k: 0.0 for k in ("init", "draw", "loop", "cost", "answer", "k2_draw", "k2_cost")}
        for call, seed in zip(calls, probe_seeds):
            key = id(call.plan)
            if key not in refs:
                refs[key] = PlanarProblem(self.cfg, call.plan.obstacles)
                nums["init"] = max(nums["init"], check.init_gap(
                    refs[key], call.plan.init_means, call.plan.init_state, len(self.cfg["goals"]),
                    self.cfg["particles_per_goal"]))
            ref = refs[key]
            mu_loop, fused = self._judge_fused(ref, call, seed)
            for k, v in {**self._judge_flat(ref, call, mu_loop), **fused}.items():
                nums[k] = max(nums[k], v)
        return nums

    def _judge_flat(self, ref: PlanarProblem, call: check.Call, mu_loop: torch.Tensor) -> dict:
        out = call.out
        p, s = out[4].shape
        t, d = out[0].shape[1], 2 * self.cfg["n_dof"]
        # the fused loop draws its launch seeds, then the last iteration its normals
        eps = check.last_normals(call, p, s, t * d, self.dtype, 0, call.iters - 1)
        x = torch.cat([out[2], out[3]], -1).detach().cpu()
        mu_out = torch.cat([out[0], out[1]], -1).detach().cpu()
        return check.flat_step(ref, x, out[4].detach().cpu(), mu_out, eps, call.result,
                               mu_loop.detach().cpu())

    @staticmethod
    def k2_launch(call: check.Call, mu: torch.Tensor, seed: int) -> tuple:
        """One launch of the call's fused step, judged: ``(new_means,
        costs)``."""
        return call.plan.planner._fused[1].step(mu, seed=seed)

    def _judge_fused(self, ref: PlanarProblem, call: check.Call, probe: int) -> tuple:
        """The means the call's fused loop should have left, by its replay,
        and ``k2_draw``, ``k2_cost`` of the replay's first launch and one
        drawn from ``probe``."""
        mu = call.mu_in
        if call.iters < 2:
            return mu, {}
        step = call.plan.planner._fused[1].step
        seeds = check.launch_seeds(call, call.iters - 1)
        picked = {0, random.Random(probe).randrange(len(seeds))}
        nums = {"k2_draw": 0.0, "k2_cost": 0.0}
        with torch.no_grad():
            for i, seed in enumerate(seeds):
                if i in picked:
                    for k, v in self._judge_launch(ref, call, mu, seed).items():
                        nums[k] = max(nums[k], v)
                mu = step(mu, seed=seed)[0]
        return mu, nums

    def _judge_launch(self, ref: PlanarProblem, call: check.Call, mu: torch.Tensor,
                      seed: int) -> dict:
        new_mu, costs = self.k2_launch(call, mu, seed)
        p, t, d = mu.shape
        m, s = t * d, costs.shape[1]
        if mu.device.type == "cuda":
            eps = torch.as_tensor(philox.fused_normals(seed, p, s, m), dtype=F64)
        else:  # the plain version's draw on the CPU
            eps = torch.randn((p, s, m), generator=torch.Generator().manual_seed(int(seed)),
                              dtype=mu.dtype).to(F64)
        mu64 = mu.detach().cpu().to(F64)
        costs = costs.detach().cpu().to(F64)
        r = (new_mu.detach().cpu().to(F64) - mu64).reshape(p, m) / ref.step_size
        w = ref.weights(costs)
        k2_draw = check.whitened_gap(r, ref.chol, torch.einsum("ps,psm->pm", w, eps))
        # the cost of the sample each particle moved to, where one sample
        # carries the whole weight
        one = w.max(dim=1).values > 1 - 1e-9
        k2_cost = 0.0
        if bool(one.any()):
            x_sel = (mu64.reshape(p, m) + r).reshape(p, 1, t, d)
            rest, coll_lo, coll_hi = (c[:, 0] for c in ref.cost_terms(x_sel, mu64, EDGE))
            c_prog = costs[torch.arange(p), w.argmax(dim=1)]
            goals = ref.particle_goals(p)
            const = ref.k_start * (ref.start ** 2).sum() + ref.k_goal * (goals ** 2).sum(-1)

            def off(c):
                return torch.clamp(torch.maximum(c - rest - coll_hi, rest + coll_lo - c), min=0.0)

            gap = torch.minimum(off(c_prog), off(c_prog + const))
            k2_cost = float((gap / (rest.abs() + const))[one].max())
        return {"k2_draw": k2_draw, "k2_cost": k2_cost}
