"""Comparisons that every StochGPMP problem shares, on one reference
object ``ref`` of the problem (``portbench/reference``): its step size and
temperature, ``weights(costs)``, the Cholesky factors ``chol`` of the
sampling precision and ``chol_init`` of the init prior, ``init_means()``
per goal, and ``cost_bounds(x, mu)``, the least and most cost of samples
and a per-particle scale. All in float64 on the CPU.

The program's own states are followed, not replayed by the reference: its
iterations on a float32 factor of a precision with entries up to 1e6 are
chaotic, and two sound runs part within ten iterations. So each number
judges one step from the program's own input, in units that do not depend on how the factor was
built: draws are compared whitened by the reference's own ``L``, where the
float32 factor's build error (up to 0.4% of a column) is ~1e-3 and a TF32
product's rounding ~3e-2.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

F64 = torch.float64
# a fused loop draws all its launch seeds up front, in [0, SEED_HIGH)
SEED_HIGH = 2**63 - 1


@dataclass
class Call:
    """One ``optimize`` call as the window saw it: its plan (the problem's),
    the planner's means and generator state before it, its iterations, what
    it returned, and the result the client took to the host (or None)."""

    plan: object
    mu_in: torch.Tensor
    rng_state: torch.Tensor
    iters: int
    out: tuple
    result: np.ndarray | None


def whitened_gap(d: torch.Tensor, chol: torch.Tensor, eps: torch.Tensor) -> float:
    """Largest ``|d L - eps| / |eps|`` over rows of ``d [..., M]``."""
    z = d.to(F64) @ chol
    return float(((z - eps).norm(dim=-1) / eps.norm(dim=-1)).max())


def init_gap(ref, init_means: torch.Tensor, rng_state: torch.Tensor, goals: int,
             per_goal: int) -> float:
    """A planner's initial means against its init prior: whitened, against
    the normals ``StochGPMP.reset`` draws first, ``[G, K, T, d]``, from the
    planner's generator in ``rng_state``."""
    mu0 = init_means.detach()
    gen = torch.Generator(device=mu0.device)
    gen.set_state(rng_state)
    eps = torch.randn((goals, per_goal) + tuple(mu0.shape[1:]), generator=gen,
                      dtype=mu0.dtype, device=mu0.device).cpu().to(F64)
    d = mu0.cpu().to(F64).reshape(goals, per_goal, -1) - ref.init_means().reshape(goals, 1, -1)
    return whitened_gap(d, ref.chol_init, eps.reshape(goals, per_goal, -1))


def _generator(call) -> torch.Generator:
    """The planner's generator as it stood when ``call`` began."""
    gen = torch.Generator(device=call.mu_in.device)
    gen.set_state(call.rng_state)
    return gen


def launch_seeds(call, count: int) -> list:
    """The launch seeds of a call's fused loop of ``count`` launches,
    redrawn as ``StochGPMP.optimize`` draws them: one draw of ``count``
    int64s from the planner's generator, before anything else."""
    gen = _generator(call)
    return torch.randint(0, SEED_HIGH, (count,), generator=gen, device=gen.device).tolist()


def last_normals(call, p: int, s: int, m: int, dtype, draws_before: int,
                 seeds_before: int) -> torch.Tensor:
    """The normals ``[P, S, M]`` of a call's last iteration, redrawn from the
    planner's generator as it stood when the call began: past
    ``seeds_before`` launch seeds of a fused loop and ``draws_before``
    earlier flat iterations' normals, as ``StochGPMP.optimize`` draws
    them."""
    gen = _generator(call)
    if seeds_before:
        torch.randint(0, SEED_HIGH, (seeds_before,), generator=gen, device=gen.device)
    for _ in range(draws_before + 1):
        eps = torch.randn((p, s, m), generator=gen, dtype=dtype, device=gen.device)
    return eps.cpu().to(F64)


def flat_step(ref, x: torch.Tensor, costs: torch.Tensor, mu_out: torch.Tensor,
              eps: torch.Tensor, result: torch.Tensor | None,
              mu_loop: torch.Tensor) -> dict:
    """One flat iteration as the program returned it: samples ``x [P, S, T,
    d]``, costs ``[P, S]``, means after it ``[P, T, d]``, its normals, and
    the client's result (a trajectory ``[T, d]``, or None);
    ``mu_loop``, the means the call's earlier iterations should have left
    (its input where there were none).

    The means before it follow from the means after it and the weights of
    the program's costs: ``mu = (mu_out - a sum_s w_s x_s) / (1 - a)``; a
    step that left its state unchanged or left samples out of the update
    moves them. ``draw``: ``x - mu`` whitened against the normals; ``loop``:
    ``x - mu_loop`` whitened likewise, so a loop before it that left its
    state unchanged or ran other iterations moves it. ``cost``:
    the program's costs outside the reference's least and most cost, over the
    particle's scale. ``answer``: the result against the samples of highest
    weight (0 is exact)."""
    x, costs, mu_out = x.to(F64), costs.to(F64), mu_out.to(F64)
    p, s = costs.shape
    a = ref.step_size
    w = ref.weights(costs)
    mu = (mu_out - a * torch.einsum("ps,pstd->ptd", w, x)) / (1 - a)
    draw = whitened_gap((x - mu[:, None]).reshape(p, s, -1), ref.chol, eps)
    loop = whitened_gap((x - mu_loop.to(F64)[:, None]).reshape(p, s, -1), ref.chol, eps)
    lo, hi, scale = ref.cost_bounds(x, mu)
    off = torch.clamp(torch.maximum(costs - hi, lo - costs), min=0.0)
    cost = float((off / scale).max())
    answer = 0.0
    if result is not None:
        res = torch.as_tensor(result, dtype=F64)
        top = w.reshape(-1) >= w.max() * (1 - 1e-12)
        cand = x.reshape(p * s, *x.shape[2:])[top]
        gap = (cand - res).abs().reshape(cand.shape[0], -1).amax(dim=1).min()
        answer = float(gap / res.abs().max().clamp(min=1e-30))
    return {"draw": draw, "loop": loop, "cost": cost, "answer": answer}
