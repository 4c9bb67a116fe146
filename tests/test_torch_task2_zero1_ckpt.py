"""task2 ``--zero1 --ckpt_dir`` at world 2 (gloo) against JAX's task2.

JAX's task2 checkpoints a ZeRO-1 run at any world: its store gathers each
sharded optimizer leaf into the global flat-padded array. The port's
task2 saves through ``DataParallel.full_state`` (the ranks' chunks
all-gathered, rank 0 writing) and restores through ``load_full_state``:

- JAX's task2 at world 2 (2 CPU devices) trains one synthetic epoch (8
  steps, batch 256 a replica) under ``--zero1``, a checkpoint every 2
  steps;
- the port's task2 on two gloo ranks resumes from JAX's step-4 file and
  writes steps 6 and 8: every leaf (parameters, the gathered momentum,
  the step) equals JAX's checkpoint of the same steps at ``GRAD_TOL``
  (rtol 1e-4, atol 1e-6), and JAX's store restores the port's files;
- a second port run resumed from the first run's step 6 writes a step 8
  bitwise equal to the uninterrupted run's.
"""

import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import torch_dist_worker  # noqa: E402

GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
FLAGS = ["--dataset", "synthetic", "--epochs", "1", "--batch_size", "256", "--log_every",
         "0", "--zero1", "--ckpt_every", "2"]


def _leaves(step_dir) -> list:
    from tpudml_torch.checkpoint.store import _read_leaves, _read_manifest

    man = _read_manifest(str(step_dir))
    return [t.numpy() for t in _read_leaves(str(step_dir), man, man["num_leaves"], True)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import tasks.task2 as jax_task2

    job = tmp_path_factory.mktemp("task2_zero1_ckpt")
    jax_task2.main(FLAGS + ["--n_devices", "2", "--ckpt_dir", str(job / "jax_ckpt"),
                            "--log_dir", str(job / "jax_logs")])
    shutil.copytree(job / "jax_ckpt" / "step_4", job / "port_ckpt" / "step_4")
    return job, torch_dist_worker.spawn("task2_zero1_ckpt", job, 2)


@pytest.mark.parametrize("step", [6, 8])
def test_zero1_checkpoint_leaves_are_jax_s(runs, step):
    job, ranks = runs
    assert all(r["first"]["world"] == 2 for r in ranks)
    got = _leaves(job / "port_ckpt" / f"step_{step}")
    want = _leaves(job / "jax_ckpt" / f"step_{step}")
    assert [g.shape for g in got] == [w.shape for w in want]
    assert [g.dtype for g in got] == [w.dtype for w in want]
    assert int(got[-1]) == int(want[-1]) == step
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, err_msg=f"leaf {i}", **GRAD_TOL)


def test_jax_restores_the_port_s_zero1_checkpoint(runs):
    """JAX's store reads the port's step 8 into its own world-2 ZeRO-1
    TrainState (the gathered momentum is its flat-padded global leaf)."""
    import jax

    from tpudml.checkpoint.store import restore_checkpoint
    from tpudml.core.config import MeshConfig
    from tpudml.core.dist import make_mesh
    from tpudml.core.prng import seed_key
    from tpudml.models import LeNet
    from tpudml.optim import Sgd
    from tpudml.parallel.dp import DataParallel

    job, _ = runs
    mesh = make_mesh(MeshConfig({"data": 2}), jax.devices()[:2])
    dp = DataParallel(LeNet(), Sgd(lr=0.01, momentum=0.9), mesh, zero1=True,
                      stacked_batches=True)
    restored = restore_checkpoint(job / "port_ckpt" / "step_8", dp.create_state(seed_key(0)))
    assert int(restored.step) == 8
    flat = [np.asarray(x) for x in jax.tree.leaves(restored)]
    for i, (a, b) in enumerate(zip(flat, _leaves(job / "port_ckpt" / "step_8"))):
        assert np.array_equal(a, b), i


def test_resumed_run_is_bitwise_the_uninterrupted_one(runs):
    job, ranks = runs
    a = _leaves(job / "port_ckpt" / "step_8")
    b = _leaves(job / "resume_ckpt" / "step_8")
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), i
    for r in ranks:
        assert r["resumed"]["loss"] == r["first"]["loss"]
        assert r["resumed"]["test_accuracy"] == r["first"]["test_accuracy"]
