"""Plain reference of the planar StochGPMP problem, float64 on the CPU.

Written from the upstream definitions (anindex/stoch_gpmp,
``examples/planar_environment.py`` and the constant-velocity GP prior it
builds): a point robot's state ``[x, y, vx, vy]`` at ``T`` steps of ``dt``,
flattened time-major into ``M = 4 T`` lanes.

- Prior precision: ``Lambda = A^T K A`` over the factors "start", the
  transitions ``e_t = x_{t+1} - Phi x_t`` with the CV-GP ``Q^{-1}`` and
  "goal", assembled as one dense ``[M, M]`` matrix; its lower Cholesky
  factor ``L`` gives the sampling map ``x = mu + eps @ L^{-1}``.
- Cost of a trajectory: the GP smoothness and start anchor, the goal anchor
  of its particle's goal, ``1 / sigma_coll^2`` times the occupancy of the
  map's cell at each step after the first, and the importance term
  ``tau x . Lambda_s mu`` of the sampling precision.
- One iteration: softmax of ``-cost / tau`` over a particle's samples and
  ``mu += step_size * sum_s w_s (x_s - mu)``.
"""

from __future__ import annotations

from math import ceil

import numpy as np
import torch

from portbench.reference.philox import fused_normals

F64 = torch.float64
# Cells of slack at a cell edge: the program snaps float32 positions, whose
# cell coordinate (up to ~200) it knows to half a float32 ulp, 7.6e-6 cells.
EDGE = 2e-5


def phi(dof: int, dt: float) -> torch.Tensor:
    """``[[I, dt I], [0, I]]``."""
    eye = torch.eye(dof, dtype=F64)
    return torch.cat([torch.cat([eye, dt * eye], 1),
                      torch.cat([torch.zeros(dof, dof, dtype=F64), eye], 1)], 0)


def q_inv(dof: int, dt: float, sigma: float) -> torch.Tensor:
    """The CV-GP transition's inverse covariance for white-noise
    acceleration of density ``sigma^2 I``: ``[[12/dt^3, -6/dt^2], [-6/dt^2,
    4/dt]] / sigma^2`` per degree of freedom."""
    blk = torch.tensor([[12.0 / dt**3, -6.0 / dt**2], [-6.0 / dt**2, 4.0 / dt]], dtype=F64)
    return torch.kron(blk, torch.eye(dof, dtype=F64)) / sigma**2


def precision(dof: int, traj_len: int, dt: float, sigma_start: float, sigma_gp: float,
              sigma_goal: float | None) -> torch.Tensor:
    """Dense ``[M, M]`` precision of the GP prior with start and goal
    anchors."""
    d = 2 * dof
    m = d * traj_len
    lam = torch.zeros(m, m, dtype=F64)
    lam[:d, :d] += torch.eye(d, dtype=F64) / sigma_start**2
    qi, ph = q_inv(dof, dt, sigma_gp), phi(dof, dt)
    rows = torch.cat([-ph, torch.eye(d, dtype=F64)], 1)  # e_t = [-Phi, I] [x_t; x_{t+1}]
    blk = rows.T @ qi @ rows
    for t in range(traj_len - 1):
        lam[t * d:(t + 2) * d, t * d:(t + 2) * d] += blk
    if sigma_goal is not None:
        lam[m - d:, m - d:] += torch.eye(d, dtype=F64) / sigma_goal**2
    return lam


def const_vel_means(start, goals, traj_len: int, dt: float, dof: int) -> torch.Tensor:
    """Straight lines from the start to each goal at constant velocity:
    ``[G, T, 2 dof]``."""
    start = torch.as_tensor(start, dtype=F64)
    out = []
    for g in torch.as_tensor(goals, dtype=F64):
        a = torch.linspace(0.0, 1.0, traj_len, dtype=F64)[:, None]
        pos = start[:dof] * (1 - a) + g[:dof] * a
        vel = ((g[:dof] - start[:dof]) / ((traj_len - 1) * dt)).expand(traj_len, dof)
        out.append(torch.cat([pos, vel], 1))
    return torch.stack(out)


class Grid:
    """The occupancy grid of a planar scene, rasterised as upstream's
    ``ObstacleMap`` does: a centred ``[ny, nx]`` grid of ``cell`` cells; a
    rectangle covers whole cells around its centre's cell, a circle the
    cells whose corner point lies within its radius. ``occupancy`` reads the
    cell ``floor(v / cell + origin)``, clamped to the grid, of each point."""

    def __init__(self, map_dim, cell: float):
        self.cell = cell
        self.nx, self.ny = ceil(map_dim[0] / cell), ceil(map_dim[1] / cell)
        self.ox, self.oy = self.nx // 2, self.ny // 2
        self.map = np.zeros((self.ny, self.nx))

    def rect_cells(self, cx, cy, w, h):
        cs = self.cell
        wc, hc, c_x, c_y = ceil(w / cs), ceil(h / cs), ceil(cx / cs), ceil(cy / cs)
        return (c_y - ceil(hc / 2.0) + self.oy, c_y + ceil(hc / 2.0) + self.oy,
                c_x - ceil(wc / 2.0) + self.ox, c_x + ceil(wc / 2.0) + self.ox)

    def circle_cells(self, cx, cy, r):
        """``(rows, cols, distance of each cell's corner from the centre)``
        over the circle's window of cells on the grid."""
        cs = self.cell
        c_r, c_x, c_y = ceil(r / cs), ceil(cx / cs), ceil(cy / cs)
        ii = np.arange(c_y - 2 * c_r + self.oy, c_y + 2 * c_r + self.oy)
        jj = np.arange(c_x - 2 * c_r + self.ox, c_x + 2 * c_r + self.ox)
        ii = ii[(ii >= 0) & (ii < self.ny)]
        jj = jj[(jj >= 0) & (jj < self.nx)]
        px, py = (jj - self.ox) * cs, (ii - self.oy) * cs
        dist = np.sqrt((px[None, :] - cx) ** 2 + (py[:, None] - cy) ** 2)
        return ii, jj, dist

    def add(self, obstacle) -> None:
        kind, *a = obstacle
        if kind == "rect":
            y0, y1, x0, x1 = self.rect_cells(*a)
            self.map[y0:y1, x0:x1] += 1
        else:
            ii, jj, dist = self.circle_cells(*a)
            self.map[np.ix_(ii, jj)] += dist <= a[2]

    def cells(self, points: torch.Tensor, shift: float = 0.0):
        """Clamped cell indices ``(i, j)`` of ``points [..., 2]`` moved by
        ``shift`` cells."""
        p = points.to(F64)
        j = torch.floor(p[..., 0] / self.cell + self.ox + shift).clamp(0, self.nx - 1).long()
        i = torch.floor(p[..., 1] / self.cell + self.oy + shift).clamp(0, self.ny - 1).long()
        return i, j

    def occupancy(self, points: torch.Tensor) -> torch.Tensor:
        """``points [..., 2]`` -> counts ``[...]`` (float64, on the points'
        device)."""
        i, j = self.cells(points)
        return torch.as_tensor(self.map, dtype=F64, device=points.device)[i, j]

    def occupancy_bounds(self, points: torch.Tensor, edge: float):
        """The least and the most count over the cells a point may be given
        when its cell coordinate is known only to ``edge`` cells: a float32
        position within rounding of a cell edge lands on either side."""
        grid = torch.as_tensor(self.map, dtype=F64, device=points.device)
        (i0, j0), (i1, j1) = self.cells(points, -edge), self.cells(points, edge)
        vals = torch.stack([grid[i0, j0], grid[i0, j1], grid[i1, j0], grid[i1, j1]])
        return vals.amin(0), vals.amax(0)


class PlanarProblem:
    """The reference's view of one planar problem: the configuration's
    sizes and sigmas, the scene's grid and the goals of the particles."""

    def __init__(self, cfg: dict, obstacles):
        self.cfg = cfg
        self.dof = cfg["n_dof"]
        self.d = 2 * self.dof
        self.T = cfg["traj_len"]
        self.dt = cfg["dt"]
        self.ppg = cfg["particles_per_goal"]
        self.start = torch.tensor(cfg["start"], dtype=F64)
        self.goals = torch.tensor(cfg["goals"], dtype=F64)
        self.grid = Grid(cfg["map_dim"], cfg["cell_size"])
        for o in obstacles:
            self.grid.add(o)
        s = cfg["sample_sigmas"]
        self.lam_sample = precision(self.dof, self.T, self.dt, s["start"], s["gp"], s["goal"])
        self.init_sigmas = cfg["init_sigmas"]
        self._wt = self._chol = None
        c = cfg["cost"]
        self.k_start = 1.0 / c["sigma_start"] ** 2
        self.q_inv = q_inv(self.dof, self.dt, c["sigma_gp"])
        self.phi = phi(self.dof, self.dt)
        self.k_goal = 1.0 / c["sigma_goal_prior"] ** 2
        self.k_coll = 1.0 / c["sigma_coll"] ** 2
        self.temperature = cfg["temperature"]
        self.step_size = cfg["step_size"]

    def init_means(self) -> torch.Tensor:
        """The init prior's mean per goal: ``[G, T, d]``."""
        return const_vel_means(self.start, self.goals, self.T, self.dt, self.dof)

    @property
    def chol_init(self) -> torch.Tensor:
        """The lower Cholesky factor of the init prior's precision."""
        s = self.init_sigmas
        return torch.linalg.cholesky(
            precision(self.dof, self.T, self.dt, s["start"], s["gp"], s["goal"]))

    @property
    def chol(self) -> torch.Tensor:
        """The lower Cholesky factor ``L`` of the sampling precision."""
        if self._chol is None:
            self._chol = torch.linalg.cholesky(self.lam_sample)
        return self._chol

    @property
    def wt(self) -> torch.Tensor:
        """The sampling map ``L^{-1}`` of the sampling precision."""
        if self._wt is None:
            self._wt = torch.linalg.solve_triangular(
                self.chol, torch.eye(self.lam_sample.shape[0], dtype=F64), upper=False)
        return self._wt

    def particle_goals(self, num_particles: int) -> torch.Tensor:
        return self.goals[torch.arange(num_particles) // self.ppg]

    def smooth_cost(self, x: torch.Tensor, goals: torch.Tensor) -> torch.Tensor:
        """Start anchor, GP smoothness and goal anchor of ``x [B, T, d]``
        with ``goals [B, d]``: ``[B]``, in ``x``'s dtype and device."""
        kw = dict(dtype=x.dtype, device=x.device)
        e0 = x[:, 0] - self.start.to(**kw)
        e = x[:, 1:] - x[:, :-1] @ self.phi.to(**kw).T
        eg = x[:, -1] - goals.to(**kw)
        return (self.k_start * (e0 * e0).sum(-1)
                + torch.einsum("bti,ij,btj->b", e, self.q_inv.to(**kw), e)
                + self.k_goal * (eg * eg).sum(-1))

    def cost_terms(self, x: torch.Tensor, mu: torch.Tensor, edge: float = 0.0, dtype=F64):
        """The planner's cost of samples ``x [P, S, T, d]`` around means
        ``mu [P, T, d]`` in ``dtype`` on ``x``'s device, in two parts: the
        smoothness, anchors and importance term ``[P, S]``, and the
        collision term's least and most value ``[P, S]`` over the cells of
        points within ``edge`` cells of a cell edge (equal for ``edge =
        0``)."""
        x, mu = x.to(dtype), mu.to(dtype)
        p, s = x.shape[:2]
        goals = self.particle_goals(p)[:, None].expand(p, s, self.d).reshape(p * s, self.d)
        smooth = self.smooth_cost(x.reshape(p * s, self.T, self.d), goals).reshape(p, s)
        lam = self.lam_sample.to(dtype=dtype, device=x.device)
        prec_u = mu.reshape(p, -1) @ lam  # Lambda_s is symmetric
        rest = smooth + self.temperature * (x.reshape(p, s, -1) * prec_u[:, None]).sum(-1)
        pts = x[:, :, 1:, :2]
        if edge <= 0:
            occ = self.grid.occupancy(pts).to(rest).sum(-1)
            return rest, self.k_coll * occ, self.k_coll * occ
        lo, hi = self.grid.occupancy_bounds(pts, edge)
        return rest, self.k_coll * lo.to(rest).sum(-1), self.k_coll * hi.to(rest).sum(-1)

    def cost_bounds(self, x: torch.Tensor, mu: torch.Tensor):
        """``(least, most, scale)`` of the costs of ``x`` ``[P, S]``: the
        collision term over the cells a float32 position within rounding of
        a cell edge may fall in; the scale, per particle, the median of the
        other terms (the collision term is whole multiples of ``1 /
        sigma_coll^2``)."""
        rest, lo, hi = self.cost_terms(x, mu, EDGE)
        return rest + lo, rest + hi, rest.abs().median(dim=1, keepdim=True).values

    def costs(self, x: torch.Tensor, mu: torch.Tensor, dtype=F64) -> torch.Tensor:
        """The planner's cost of samples ``x [P, S, T, d]`` around means
        ``mu [P, T, d]``: ``[P, S]``."""
        rest, coll, _ = self.cost_terms(x, mu, 0.0, dtype)
        return rest + coll

    def weights(self, costs: torch.Tensor) -> torch.Tensor:
        return torch.softmax(-costs.to(F64) / self.temperature, dim=1)

    def step(self, mu: torch.Tensor, eps: torch.Tensor):
        """One iteration from ``mu [P, T, d]`` with the draw ``eps [P, S,
        M]``: ``(new_mu, samples, costs)``."""
        p = mu.shape[0]
        x = (mu.reshape(p, 1, -1) + eps @ self.wt).reshape(p, -1, self.T, self.d)
        c = self.costs(x, mu)
        w = self.weights(c)
        grad = torch.einsum("ps,pstd->ptd", w, x - mu[:, None])
        return mu + self.step_size * grad, x, c


class FusedStepControl:
    """The reference in the fused kernel's place, as the precision control:
    one iteration from ``means [P, T, d]`` with the kernel's Philox draw for
    ``seed``, on the means' device in float32 with every product in TF32
    (the precision below the configuration's float32). Returns ``(new_means,
    costs)`` as the kernel does."""

    def __init__(self, problem: PlanarProblem, num_samples: int):
        self.pb = problem
        self.num_samples = num_samples

    def __call__(self, means: torch.Tensor, *, seed: int):
        pb, f32 = self.pb, torch.float32
        p, t, d = means.shape
        eps = torch.as_tensor(fused_normals(seed, p, self.num_samples, t * d), dtype=f32,
                              device=means.device)
        keep = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            mu = means.to(f32)
            x = (mu.reshape(p, 1, -1) + eps @ pb.wt.to(dtype=f32, device=means.device)
                 ).reshape(p, -1, t, d)
            c = pb.costs(x, mu, dtype=f32)
            w = torch.softmax(-c / pb.temperature, dim=1)
            new = mu + pb.step_size * torch.einsum("ps,pstd->ptd", w, x - mu[:, None])
        finally:
            torch.backends.cuda.matmul.allow_tf32 = keep
        return new, c
