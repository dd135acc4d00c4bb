"""The check on the CPU: a sound run is correct, and each fault planted
under the timed path (a step or a fused loop that returns its state
unchanged, half of the samples left out of the update, an altered answer)
makes it not correct, in each cell's loop. The card's control runs are in
``test_portbench_cuda.py``."""

import pytest
import torch

from portbench.tests.helpers import run

SEED, SECONDS = 3_000_000_017, 1.0
QUICK = dict(warm_requests=1, trace_requests=1)
# each cell's loop, at the cell's sizes with fewer iterations, which the
# CPU runs in a second: 10-iteration refinements, plans of 2 x 5 iterations
CELLS = {
    "planar-env.refine": dict(iters_per_request=10),
    "planar-env.demo": dict(iters_per_plan=10, iters_per_call=5),
}


def _run(cell, monkeypatch):
    return run(cell, SEED, SECONDS, "cpu", monkeypatch, **QUICK, **CELLS[cell])


@pytest.mark.parametrize("cell", list(CELLS))
def test_sound_run_is_correct(monkeypatch, cell):
    out = _run(cell, monkeypatch)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0


def _half(costs, temperature):
    """The softmax over the first half of the samples only."""
    h = costs.shape[1] // 2
    w = torch.zeros_like(costs)
    w[:, :h] = torch.softmax(-costs[:, :h] / temperature, dim=1)
    return w


def fault_flat_unchanged(monkeypatch):
    from stoch_gpmp_tpu_torch.planners import stoch_gpmp as mod

    step = mod.stoch_gpmp_step

    def unchanged(sampler, cost, state, *a, **kw):
        return state, step(sampler, cost, state, *a, **kw)[1]

    monkeypatch.setattr(mod, "stoch_gpmp_step", unchanged)


def fault_flat_half(monkeypatch):
    from dataclasses import replace

    from stoch_gpmp_tpu_torch.planners import stoch_gpmp as mod

    step = mod.stoch_gpmp_step

    def half(sampler, cost, state, *a, **kw):
        new, aux = step(sampler, cost, state, *a, **kw)
        w = _half(aux.costs, kw["temperature"])
        grad = torch.einsum("ps,pstd->ptd", w, aux.samples - state.particle_means[:, None])
        means = state.particle_means + kw["step_size"] * grad
        return replace(new, particle_means=means), replace(aux, weights=w, grad=grad)

    monkeypatch.setattr(mod, "stoch_gpmp_step", half)


def fault_fused_unchanged(monkeypatch):
    from stoch_gpmp_tpu_torch.ops.kernels import fused_step as mod

    plain = mod.fused_planar_step_plain
    monkeypatch.setattr(mod, "fused_planar_step_plain",
                        lambda step, means, eps: (means, plain(step, means, eps)[1]))


def fault_fused_half(monkeypatch):
    from stoch_gpmp_tpu_torch.ops.kernels import fused_step as mod

    plain = mod.fused_planar_step_plain

    def half(step, means, eps):
        _, costs = plain(step, means, eps)
        x = means[:, None] + eps @ step.weight_t
        w = _half(costs, step.temperature)
        return means + step.step_size * torch.einsum("ps,psm->pm", w, x - means[:, None]), costs

    monkeypatch.setattr(mod, "fused_planar_step_plain", half)


def fault_fused_loop_unchanged(monkeypatch):
    """The fused loop runs its launches but keeps the means it was given."""
    from stoch_gpmp_tpu_torch.ops.kernels import fused_step as mod

    loop = mod.fused_planar_optimize_batched
    monkeypatch.setattr(mod, "fused_planar_optimize_batched",
                        lambda step, means, generator, n: (loop(step, means, generator, n), means)[1])


def fault_trajectory(monkeypatch):
    from stoch_gpmp_tpu_torch.planners import StochGPMP

    get = StochGPMP.get_traj
    monkeypatch.setattr(StochGPMP, "get_traj", lambda self, mode="best": get(self, mode) + 1e-3)


FAULTS = [(cell, f) for cell in CELLS
          for f in (fault_flat_unchanged, fault_flat_half, fault_fused_unchanged,
                    fault_fused_half, fault_fused_loop_unchanged, fault_trajectory)]


@pytest.mark.parametrize("cell,fault", FAULTS, ids=lambda v: v if isinstance(v, str)
                         else v.__name__[6:])
def test_fault_is_not_correct(monkeypatch, cell, fault):
    fault(monkeypatch)
    out = _run(cell, monkeypatch)
    print(cell, fault.__name__, {k: c["value"] for k, c in out["checks"].items()})
    assert not out["correct"], out["checks"]
