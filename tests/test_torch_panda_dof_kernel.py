"""The pieces K5 (the fused dof-factored Panda iteration) and the FK kernels
rely on, on the CPU: ``Sigma^{-1} mu`` on dof planes against the JAX
package, the zero pattern of ``W_dof``, the backward tables K5 draws its
samples with (``L^T y = eps`` on the prior's factor), the order of work
its threads take through them and through each row's quadratic term, the
tables a K5 step builds from each source of a prior, and the choice
between the specialised and the generic FK walk. Inputs come from numpy
with fixed seeds; each test states its tolerance. The kernels themselves
run on the card
(``tests/test_torch_cuda.py``).
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from stoch_gpmp_tpu_torch.gp.dof_factored import (  # noqa: E402
    _perm2,
    make_dof_factored_prior,
    plane_perm,
    prec_u_planes,
)
from stoch_gpmp_tpu_torch.gp.tridiag import BlockBidiagChol  # noqa: E402
from stoch_gpmp_tpu_torch.kinematics.panda_model import (  # noqa: E402
    PANDA_FK_LINKS,
    franka_panda,
)
from stoch_gpmp_tpu_torch.ops.kernels.panda_fields import fk_variant  # noqa: E402
from stoch_gpmp_tpu_torch.ops.kernels.panda_step_dof import (  # noqa: E402
    backward_tables,
    fused_panda_dof_step_plain,
    make_fused_panda_dof_step,
)
from stoch_gpmp_tpu_torch.ops.kernels.stencil import (  # noqa: E402
    dof_anchor_rows,
    dof_quad_eval_plain,
)

D, DT = 7, 0.05
# the Panda's sampling prior (chip_smoke.py, benchmarks/run.py config 5)
SIGMA_START, SIGMA_GP, SIGMA_GOAL = 1e-3, 0.1, 0.07
CH = 8  # csrc/fused_panda_dof_step.cu: time steps per chunk of the substitution


def _prior(t, dtype=torch.float64):
    return make_dof_factored_prior(t, DT, SIGMA_START, SIGMA_GP, SIGMA_GOAL, dtype=dtype,
                                   device="cpu")


@pytest.mark.parametrize("t", [64, 128])
def test_prec_u_planes_matches_jax_matvec_planes(t):
    """K5's plain ``Sigma^{-1} mu`` (``prec_u_planes``) against the JAX
    package's ``DofFactoredPrior.matvec_planes`` at d = 7 and the Panda
    sigmas, float64, on random planes ``[7, 6, 2T]`` of the size of joint
    angles and velocities: bit for bit (the same operations in the same
    order, with the JAX prior's own stencil weights)."""
    from stoch_gpmp_tpu.gp.dof_factored import make_dof_factored_prior as jax_prior

    jp = jax_prior(t, DT, SIGMA_START, SIGMA_GP, SIGMA_GOAL, dtype=jnp.float64)
    x = np.random.default_rng(t).normal(scale=1.5, size=(D, 6, 2 * t))
    want = np.asarray(jp.matvec_planes(jnp.asarray(x)))
    w = [torch.from_numpy(np.array(getattr(jp, k))) for k in ("q_i2", "k_s2", "k_g2")]
    got = prec_u_planes(torch.from_numpy(x), *w, jp.dt)
    np.testing.assert_array_equal(got.numpy(), want)
    # the port's own prior builds the same stencil weights
    tp = _prior(t)
    for k, v in zip(("q_i2", "k_s2", "k_g2"), w):
        np.testing.assert_array_equal(getattr(tp, k).numpy(), v.numpy())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("t", [64, 128])
def test_w_dof_is_lower_triangular_in_time(t, dtype):
    """``make_dof_factored_prior(...).w_dof`` (``L^{-1}`` in plane order) at
    the Panda sigmas has exact zeros wherever the row's time precedes the
    column's, ``t(k) < t(m)``, in each of its four ``T x T`` blocks, in
    float64 and in the float32 build K5 runs on; the rest (t(k) >= t(m))
    is where its non-zeros are, about half the entries."""
    w = _prior(t, dtype).w_dof.numpy()
    tk = np.arange(2 * t) % t
    below = tk[:, None] < tk[None, :]
    assert np.all(w[below] == 0.0)
    assert 0.45 < np.count_nonzero(w) / w.size <= 0.5 + 1.0 / t


def _substitute(tab, eps):
    """``L^T y = eps`` by the serial backward recurrence on dof planes
    ``eps [..., 2T]`` with K5's tables ``tab [7, T]``: ``y_t = D_t^{-T}
    eps_t + A_t y_{t+1}``, ``eps_t = (eps[t], eps[T + t])``."""
    t = tab.shape[1]
    y = torch.zeros_like(eps)
    yp = yv = torch.zeros_like(eps[..., 0])
    for s in range(t - 1, -1, -1):
        d00, d01, d11, a00, a01, a10, a11 = tab[:, s]
        ep, ev = eps[..., s], eps[..., t + s]
        yp, yv = d00 * ep + d01 * ev + a00 * yp + a01 * yv, d11 * ev + a10 * yp + a11 * yv
        y[..., s], y[..., t + s] = yp, yv
    return y


def _card_prior(t):
    """The float64 prior, and its factor and ``L^{-1}`` rounded to float32:
    what the card holds, since C1 runs the chain in float64 and rounds its
    results to float32."""
    p64 = _prior(t)
    chol32 = BlockBidiagChol(p64.chol.diag.float(), p64.chol.lower.float())
    return p64, chol32, p64.w_dof.float()


@pytest.mark.parametrize("t", [64, 128])
def test_backward_tables_equal_w_dof(t):
    """K5's tables of the prior's float64 factor, run as the serial
    recurrence on dof planes, equal ``eps @ w_dof`` (``L^{-1}`` in plane
    order) within 1e-12 of its largest entry; ``A_{T-1}`` is 0 and each
    ``D_t^{-T}`` is upper triangular by construction (3 entries kept)."""
    prior = _prior(t)
    tab = backward_tables(prior.chol)
    assert tab.shape == (7, t) and tab.dtype == torch.float64
    assert torch.all(tab[3:, -1] == 0)
    eps = torch.from_numpy(np.random.default_rng(t).normal(size=(D, 5, 2 * t)))
    want = eps @ prior.w_dof
    got = _substitute(tab, eps)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-12 * float(want.abs().max()))


@pytest.mark.parametrize("t", [64, 128])
def test_backward_tables_float32_whitened(t):
    """In float32, as the card runs them: the tables formed in float64 from
    the float32 factor and rounded, run on float32 normals, whiten (against
    the float64 factor, ``|y L - eps| / |eps|`` per row) no worse than the
    float32 product ``eps @ w_dof`` with the rounded ``L^{-1}``."""
    p64, chol32, w32 = _card_prior(t)
    tab = backward_tables(chol32)
    assert tab.dtype == torch.float32
    lp = _perm2(p64.chol.to_dense(), plane_perm(t))
    eps = torch.from_numpy(np.random.default_rng(t + 1).normal(size=(64, 2 * t)))
    e32 = eps.float()

    def whitened(y):
        return float(((y.double() @ lp - eps).norm(dim=-1) / eps.norm(dim=-1)).max())

    sub, dense = whitened(_substitute(tab, e32)), whitened(e32 @ w32)
    assert sub <= dense < 1e-3


def _chunked(tab, eps, ch=CH):
    """``L^T y = eps`` in K5's order of work: the time axis in chunks of
    ``ch`` steps, each run from a zero carry (pass 1); each chunk's
    transition ``Phi_c = A_{t0} ... A_{t0 + ch - 1}``; a Hillis-Steele
    suffix scan over the chunks of the affine maps ``y(t0) = z_c + Phi_c
    y(t0 + ch)``; then each chunk again with its carry's homogeneous part
    ``A_t ... A_{t0 + ch - 1} y(t0 + ch)`` added step by step (pass 2)."""
    t = tab.shape[1]
    nc = t // ch
    d00, d01, d11, a00, a01, a10, a11 = (r.reshape(nc, ch) for r in tab)
    ep = eps[..., :t].reshape(eps.shape[:-1] + (nc, ch))
    ev = eps[..., t:].reshape(ep.shape)
    zp, zv = torch.zeros_like(ep), torch.zeros_like(ep)
    yp = yv = torch.zeros_like(ep[..., 0])
    f = torch.eye(2, dtype=tab.dtype).expand(nc, 2, 2)
    for i in range(ch - 1, -1, -1):
        yp, yv = (d00[:, i] * ep[..., i] + d01[:, i] * ev[..., i] + a00[:, i] * yp
                  + a01[:, i] * yv, d11[:, i] * ev[..., i] + a10[:, i] * yp + a11[:, i] * yv)
        zp[..., i], zv[..., i] = yp, yv
        a = torch.stack([torch.stack([a00[:, i], a01[:, i]], -1),
                         torch.stack([a10[:, i], a11[:, i]], -1)], -2)
        f = a @ f
    o = 1
    while o < nc:  # lane c takes lane c + o's map where c + o < nc
        up, uv = yp[..., o:], yv[..., o:]
        g = f[o:]
        fc = f[:-o]
        yp = torch.cat([yp[..., :-o] + fc[:, 0, 0] * up + fc[:, 0, 1] * uv, yp[..., -o:]], -1)
        yv = torch.cat([yv[..., :-o] + fc[:, 1, 0] * up + fc[:, 1, 1] * uv, yv[..., -o:]], -1)
        f = torch.cat([fc @ g, f[-o:]])
        o *= 2
    zero = torch.zeros_like(yp[..., :1])
    hp, hv = torch.cat([yp[..., 1:], zero], -1), torch.cat([yv[..., 1:], zero], -1)
    for i in range(ch - 1, -1, -1):
        hp, hv = a00[:, i] * hp + a01[:, i] * hv, a10[:, i] * hp + a11[:, i] * hv
        zp[..., i] += hp
        zv[..., i] += hv
    return torch.cat([zp.flatten(-2), zv.flatten(-2)], -1)


@pytest.mark.parametrize("t", [64, 128, 224])
def test_chunked_order_equals_the_recurrence(t):
    """K5's order of work (chunks of 8 steps, the scan of the chunks'
    carries, the carries' homogeneous part) on the float64 tables equals the
    serial recurrence within 1e-12 of its largest entry, at T = 64 (8
    chunks), 128 (16) and 224 (28: not a power of two)."""
    tab = backward_tables(_prior(t).chol)
    eps = torch.from_numpy(np.random.default_rng(t + 2).normal(size=(3, 4, 2 * t)))
    want = _substitute(tab, eps)
    np.testing.assert_allclose(_chunked(tab, eps).numpy(), want.numpy(), rtol=0,
                               atol=1e-12 * float(want.abs().max()))


def _folded_row_sums(dq, x, pu, tau, ch=CH):
    """Each row's quadratic term of ``x [d, B, 2T]`` in K5's order of work:
    per chunk of ``ch`` steps its stencil residuals (step ``t0 + ch`` is the
    next chunk's first; none at ``T - 1``), the start anchor in the first
    chunk, the goal anchor in the last and ``tau x . pu`` over the chunk's
    lanes; then a Hillis-Steele suffix sum over the chunks, whose first
    lane holds the row's sum -> ``[d, B]``."""
    d, b, t2 = x.shape
    t = t2 // 2
    nc, s = t // ch, b // pu.shape[1]
    p, v = x[..., :t].reshape(d, b, nc, ch), x[..., t:].reshape(d, b, nc, ch)
    pn = torch.cat([p[..., 1:], p[..., :1].roll(-1, dims=2)], -1)  # step t + 1
    vn = torch.cat([v[..., 1:], v[..., :1].roll(-1, dims=2)], -1)
    q, ks, kg = dq.q_i2, dq.k_s2, dq.k_g2

    def quad(a, r, w):
        return a[0, 0] * r * r + 2.0 * a[0, 1] * r * w + a[1, 1] * w * w

    e = quad(q, p + dq.dt * v - pn, v - vn)
    e[..., -1, -1] = 0.0  # no residual past T - 1
    e = e.sum(-1)
    anch = dof_anchor_rows(dq, b)
    e[..., 0] += quad(ks, p[..., 0, 0] - anch[..., 0], v[..., 0, 0] - anch[..., 1])
    e[..., -1] += quad(kg, p[..., -1, -1] - anch[..., 2], v[..., -1, -1] - anch[..., 3])
    pur = pu[:, :, None].expand(d, pu.shape[1], s, t2).reshape(d, b, t2)
    e = e + tau * (x * pur).reshape(d, b, 2, nc, ch).sum((2, 4))
    o = 1
    while o < nc:  # lane c takes lane c + o's sum where c + o < nc
        e = torch.cat([e[..., :-o] + e[..., o:], e[..., -o:]], -1)
        o *= 2
    return e[..., 0]


@pytest.mark.parametrize("t,s", [(96, 4), (128, 3), (224, 4)])
def test_folded_row_sums_equal_the_plain_quadratic(t, s):
    """K5's row sums in its order of work (each chunk's residuals, anchors
    and importance, the suffix sum over the pair's chunks) equal the plain
    version's quadratic and importance term (``dof_quad_eval_plain`` with
    ``pu``) within 1e-12 relative, float64, on the Panda problem's stencil
    weights and anchors (2 goals x 2 particles), at T = 96 (12 chunks: not
    a power of two), 128 (16) and 224 (28), with an odd S."""
    from stoch_gpmp_tpu_torch.problems import build_panda_problem

    _, cost, *_ = build_panda_problem(num_goals=2, ppg=2, num_samples=s, dtype=torch.float64,
                                      device="cpu")
    dq = cost.costs[0].dof_form
    rng = np.random.default_rng(t + s)
    x = torch.from_numpy(rng.normal(size=(D, 4 * s, 2 * t)))
    pu = torch.from_numpy(rng.normal(size=(D, 4, 2 * t)))
    want = dof_quad_eval_plain(dq, x, pu=pu, temperature=0.7, num_samples=s)
    got = _folded_row_sums(dq, x, pu, 0.7).sum(0)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12)


def _sampling_prior(case):
    """The per-dof prior of ``case`` in float64 on the CPU, at the Panda's
    sampling sigmas: the planner's sampling prior (``make_gp_prior``'s, T =
    64, with goals and without), the port's ``make_dof_factored_prior`` at
    T = 64 and 224, and the JAX package's planner prior (T = 64, goals)
    carried over by ``convert.sampler_from_jax``."""
    from stoch_gpmp_tpu_torch.gp.prior import make_gp_prior
    from stoch_gpmp_tpu_torch.planners import SamplerModel

    if case.startswith("prior_"):
        return _prior(int(case[len("prior_"):]))
    start = torch.tensor([0.1] * D + [0.0] * D, dtype=torch.float64)
    goals = start[None] + 0.1
    sigmas = (SIGMA_START, SIGMA_GP, SIGMA_GOAL)
    if case.startswith("planner"):
        kw = {} if case == "planner_no_goals" else dict(goal_states=goals)
        return SamplerModel.from_prior(make_gp_prior(
            D, 64, DT, start, *sigmas, dtype=torch.float64, device="cpu", **kw)).dof
    from stoch_gpmp_tpu.gp.prior import make_gp_prior as jax_gp_prior
    from stoch_gpmp_tpu.planners.stoch_gpmp import SamplerModel as JaxSamplerModel

    from stoch_gpmp_tpu_torch import convert

    jprior = jax_gp_prior(D, 64, DT, jnp.asarray(start.numpy()), *sigmas,
                          goal_states=jnp.asarray(goals.numpy()), dtype=jnp.float64)
    return convert.sampler_from_jax(JaxSamplerModel.from_prior(jprior), device="cpu").dof


def _dof_step(dof_prior):
    """K5's step on the Panda problem's costs (2 goals x 2 particles, S = 4)
    in float64 on the CPU, sampling with ``dof_prior`` at its horizon; the
    means, straight start-to-goal planes ``[7, 4, 2T]``."""
    from stoch_gpmp_tpu_torch.gp.dof_factored import to_dof_planes
    from stoch_gpmp_tpu_torch.problems import build_panda_problem

    _, cost, state, obs, s = build_panda_problem(num_goals=2, ppg=2, num_samples=4,
                                                 dtype=torch.float64, device="cpu")
    quad, fields = cost.costs
    t = dof_prior.traj_len
    step = make_fused_panda_dof_step(
        chain=fields.chain, dof_prior=dof_prior, dof_quad=quad.dof_form, num_particles=4,
        spheres=obs["obstacle_spheres"], target_h=fields.target_h, n_dof=D, traj_len=t,
        num_samples=s, margin=fields.margin, w_self=1.0 / fields.sigma_self**2,
        w_obst=1.0 / fields.sigma_coll**2, w_goal=1.0 / fields.sigma_goal**2)
    return step, to_dof_planes(state.particle_means)


@pytest.mark.parametrize("case", ["planner_goals", "planner_no_goals", "prior_64", "prior_224",
                                  "from_jax", "zero_eps"])
def test_step_samples_with_the_prior_factor(case):
    """Every K5 step draws by substitution on its prior's factor: the tables
    the step builds equal ``backward_tables`` of the port's own per-dof
    factor at the same sigmas and horizon (``make_dof_factored_prior``,
    without the goal sigma where the prior has no goals) within 1e-12
    relative, float64, for each source of a sampling prior (the JAX
    package's keeps no per-dof factor: ``convert`` forms it from the
    stencil weights it carries). ``zero_eps``: the plain version with an eps
    of zeros (``y = L^{-T} 0``, the card's RNG-free check) returns the means
    unmoved, bit for bit, with finite costs."""
    if case == "zero_eps":
        step, means = _dof_step(_sampling_prior("planner_goals"))
        eps = torch.zeros((D, 4, step.num_samples, means.shape[-1]), dtype=torch.float64)
        new, costs = fused_panda_dof_step_plain(step, means, eps)
        assert torch.equal(new, means) and bool(torch.isfinite(costs).all())
        return
    prior = _sampling_prior(case)
    step, _ = _dof_step(prior)
    t = prior.traj_len
    native = make_dof_factored_prior(t, DT, SIGMA_START, SIGMA_GP,
                                     None if case == "planner_no_goals" else SIGMA_GOAL,
                                     dtype=torch.float64, device="cpu").chol
    assert step.tables.shape == (7, t) and step.tables.dtype == torch.float64
    np.testing.assert_allclose(step.tables.numpy(), backward_tables(native).numpy(), rtol=1e-12,
                               atol=0)


def _host_fk_rule(tmp_path):
    """``csrc/fk_spec.cpp``, the kernels' rule for the FK walk, built for the
    host with the C++ compiler (the kernels' build compiles the same file
    with nvcc)."""
    import ctypes
    import shutil
    import subprocess

    cxx = shutil.which("c++") or shutil.which("g++")
    assert cxx, "a C++17 compiler is needed to build csrc/fk_spec.cpp for the host"
    src = ROOT / "stoch_gpmp_tpu_torch" / "csrc" / "fk_spec.cpp"
    lib = tmp_path / "libfk_spec.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-o", str(lib), str(src)],
                   check=True, capture_output=True)
    rule = ctypes.CDLL(str(lib))
    rule.fk_chain_variant.argtypes = [ctypes.c_void_p]
    rule.fk_chain_variant.restype = ctypes.c_int
    return rule


def test_fk_dispatch_specialised_and_generic(tmp_path):
    """The FK walk the kernels take, by their own rule (``csrc/fk_spec.h``,
    built here for the host): the specialised one (variant 1) for
    ``franka_panda(link_names=PANDA_FK_LINKS)``; the generic one (0) for a chain that
    has a joint about x and a prismatic joint (``chip_smoke.generic_chain``,
    the chain the card holds the generic walk against its oracle on), and
    for the Panda with one link fewer selected or an origin rotation tilted
    off Rx(90 deg) (``chip_smoke.tilted_panda``)."""
    import chip_smoke

    from stoch_gpmp_tpu_torch.kinematics.chain import KinematicChain

    rule = _host_fk_rule(tmp_path)
    panda = franka_panda(link_names=PANDA_FK_LINKS)
    assert fk_variant(panda, rule) == 1
    chain = chip_smoke.generic_chain()
    tab = chain.joint_table()
    assert 2 in tab["type"].tolist()  # prismatic
    assert any(t == 1 and abs(a[2]) != 1.0 for t, a in zip(tab["type"], tab["axis"]))
    assert fk_variant(chain, rule) == 0
    assert fk_variant(KinematicChain(panda.model, PANDA_FK_LINKS[:-1]), rule) == 0
    assert fk_variant(chip_smoke.tilted_panda(), rule) == 0
