"""The pieces K5 (the fused dof-factored Panda iteration) and the FK kernels
rely on, on the CPU: ``Sigma^{-1} mu`` on dof planes against the JAX
package, the zero pattern of ``W_dof`` that K5 skips, the packed layout K5
reads it in, and the choice between the specialised and the generic FK walk.
Inputs come from numpy with fixed seeds; each test states its tolerance.
The kernels themselves run on the card (``tests/test_torch_cuda.py``).
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
    make_dof_factored_prior,
    prec_u_planes,
)
from stoch_gpmp_tpu_torch.kinematics.panda_model import (  # noqa: E402
    PANDA_FK_LINKS,
    franka_panda,
)
from stoch_gpmp_tpu_torch.ops.kernels.panda_fields import fk_variant  # noqa: E402
from stoch_gpmp_tpu_torch.ops.kernels.panda_step_dof import (  # noqa: E402
    pack_windows,
    time_lower_triangular,
)

D, DT = 7, 0.05
# the Panda's sampling prior (chip_smoke.py, benchmarks/run.py config 5)
SIGMA_START, SIGMA_GP, SIGMA_GOAL = 1e-3, 0.1, 0.07
WIN = 32  # csrc/fused_panda_dof_step.cu: columns per window


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
    assert time_lower_triangular(torch.from_numpy(w), t)


def test_zero_pattern_flag():
    """The flag the K5 wrapper computes once per step: true for the prior's
    ``W_dof`` and for zeros (the RNG-free check), false for a dense random
    override and for the prior's ``W`` with one entry above its time
    diagonal set."""
    t = 128
    w = _prior(t, torch.float32).w_dof
    assert time_lower_triangular(w, t)
    assert time_lower_triangular(torch.zeros_like(w), t)
    dense = torch.from_numpy(np.random.default_rng(1).normal(size=w.shape).astype(np.float32))
    assert not time_lower_triangular(dense, t)
    one = w.clone()
    one[3, t + 4] = 1e-30  # row time 3 < column time 4
    assert not time_lower_triangular(one, t)


@pytest.mark.parametrize("t", [64, 128])
def test_packed_windows_layout(t):
    """``pack_windows`` in the layout K5's product reads it: the window of
    plane ``h`` (positions 0, velocities 1) starting at time ``32 j`` sits
    at ``h T (T + 32) + 64 (j T - 16 j (j - 1))``, its row ``kh (T - 32 j) +
    k`` holds ``W[kh T + 32 j + k, h T + 32 j .. + 32]`` (exact); and the
    product of random eps rows through the windows, in the kernel's order
    of terms, equals ``eps @ W`` within float64 roundoff (rtol 1e-12)."""
    w = _prior(t).w_dof
    packed = pack_windows(w, t).numpy()
    wn = w.numpy()
    assert packed.shape == (2 * t * (t + WIN),)
    eps = np.random.default_rng(2).normal(size=(5, 2 * t))
    x = np.zeros((5, 2 * t))
    for h in range(2):
        for j in range(t // WIN):
            t0, n = WIN * j, t - WIN * j
            base = h * t * (t + WIN) + 2 * WIN * (j * t - WIN // 2 * j * (j - 1))
            win = packed[base: base + 2 * n * WIN].reshape(2, n, WIN)
            for kh in range(2):
                np.testing.assert_array_equal(
                    win[kh], wn[kh * t + t0: kh * t + t, h * t + t0: h * t + t0 + WIN])
                x[:, h * t + t0: h * t + t0 + WIN] += eps[:, kh * t + t0: kh * t + t] @ win[kh]
    want = eps @ wn
    np.testing.assert_allclose(x, want, rtol=0, atol=1e-12 * np.abs(want).max())


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
