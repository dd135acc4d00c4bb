"""The port's example twins (``stoch_gpmp_tpu_torch/examples``) run end to
end on the CPU at small sizes, under the gates of ``tests/test_examples.py``
(the JAX package's examples): they exit normally and print their final
distances."""

import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def test_panda_example(capsys, tmp_path):
    from stoch_gpmp_tpu_torch.examples import panda_environment

    panda_environment.main(["--iters", "20", "--seed", "0", "--device", "cpu", "--fast",
                            "--plot", str(tmp_path / "p.png")])
    out = capsys.readouterr().out
    assert "final EE->target distances" in out and "iter   20/20" in out
    assert (tmp_path / "p.png").exists()


def test_planar_sharded_example(capsys):
    """Four gloo ranks on the CPU, mesh (2, 2), reach the goals."""
    from stoch_gpmp_tpu_torch.examples import planar_sharded

    planar_sharded.main(["--devices", "4", "--iters", "40", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "over 4 ranks" in out and "mesh: (2, 2)" in out
    line = out.split("final distance to nearest goal per particle:")[1]
    dists = np.array(line.replace("[", " ").replace("]", " ").split(), dtype=float)
    assert dists.size == 18 and dists.max() < 0.3
