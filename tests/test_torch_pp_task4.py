"""task4 ``--schedule gpipe | 1f1b`` of the port against JAX's task4, on
the CPU: LeNet's conv/fc split as two pipeline stages at world 2 over
gloo (``tests/torch_dist_worker.py``'s ``pp_cli`` suite, spawned once),
one epoch of the synthetic set at the reference's settings (SGD lr 0.01,
no momentum, 128 steps of batch 32 in 4 micro-batches) from JAX's
initial rows, against JAX's task4 at ``--n_devices 2``: the loss logged
every 16 steps, the test accuracy, the run name ``task4-{schedule}2x1``;
only rank 0 writes. At world 1 the entry rejects an odd world and
``--accum_steps`` with JAX's wording.

Tolerances: the logged losses rtol 1e-5 (f32, after up to 128 steps);
the test accuracy within 0.5 points. (At lr 0.05 with momentum 0.9,
LeNet's stability edge, the two f32 trajectories agree to 8e-4 for 64
steps and then part in the jump of the loss from 2.2 to 0.2, as any two
f32 implementations do there.)
"""

import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import torch_dist_worker  # noqa: E402
from tasks import task4 as jax_task4  # noqa: E402
from tpudml.core.config import MeshConfig  # noqa: E402
from tpudml.core.dist import make_mesh  # noqa: E402
from tpudml.core.prng import seed_key  # noqa: E402
from tpudml.models.staged import lenet_stages as jax_lenet_stages  # noqa: E402
from tpudml.optim import make_optimizer  # noqa: E402
from tpudml.parallel.pp import HeteroPipeline as JaxHetero  # noqa: E402
from tpudml_torch.tasks import task4  # noqa: E402

FLAGS = ["--dataset", "synthetic", "--epochs", "1", "--log_every", "16"]
SCHEDULES = ("gpipe", "1f1b")


def _logged(path: Path) -> list[float]:
    return [r["value"] for r in map(json.loads, path.read_text().splitlines())
            if r["tag"] == "Train Loss"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    job = tmp_path_factory.mktemp("pp_task4")
    want = {}
    for s in SCHEDULES:
        want[s] = jax_task4.main(FLAGS + ["--n_devices", "2", "--schedule", s,
                                          "--log_dir", str(job / f"j{s}")])
        want[s]["logged"] = _logged(next((job / f"j{s}").rglob("metrics.jsonl")))
    # JAX's initial rows: its engine drawn from the config's seed (0).
    rows = JaxHetero([m for _, m in jax_lenet_stages().stages], n_microbatches=4,
                     mesh=make_mesh(MeshConfig({"stage": 2}), jax.devices()[:2]),
                     optimizer=make_optimizer("sgd", 0.05)).init_params(seed_key(0))["stages"]
    torch.save({"task4": SCHEDULES, "task4_flags": FLAGS + ["--device", "cpu"],
                "task4_rows": np.asarray(rows)}, job / "cases.pt")
    return want, torch_dist_worker.spawn("pp_cli", job, 2)


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_task4_pipeline_matches_jax_task4_at_world_2(runs, schedule):
    want, ranks = runs
    w = want[schedule]
    for got in ranks:
        m = got[f"task4_{schedule}"]
        assert m["world"] == 2 and m["schedule"] == schedule and m["steps"] == w["steps"]
        np.testing.assert_allclose(m["loss"], w["loss"], rtol=1e-5)
        assert abs(m["test_accuracy"] - w["test_accuracy"]) <= 0.005
    run_dir = Path(ranks[0][f"task4_{schedule}"]["run_dir"])
    assert run_dir.name.endswith(f"task4-{schedule}2x1")
    logged = _logged(run_dir / "metrics.jsonl")
    assert len(logged) == w["steps"] // 16
    np.testing.assert_allclose(logged, w["logged"], rtol=1e-5)
    assert "run_dir" not in ranks[1][f"task4_{schedule}"]  # only rank 0 writes


@pytest.mark.parametrize("flags,match", [
    ([], "needs a multiple of 2 devices, got 1"),
    (["--accum_steps", "2"], "does not support --accum_steps"),
])
def test_task4_pipeline_rejections(tmp_path, flags, match):
    with pytest.raises(ValueError, match=match):
        task4.main(FLAGS + ["--device", "cpu", "--schedule", "gpipe", "--log_dir",
                            str(tmp_path)] + flags)
