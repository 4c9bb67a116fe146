"""task5 ``--parallel pp --pp_data 2`` of the port against JAX's task5 at
world 4 (``{"data": 2, "stage": 2}``), on the CPU: four gloo ranks of
``tests/torch_dist_worker.py``'s ``pp_cli`` suite, spawned once, from
JAX's initial parameters (``--attn flash --fused_ln --rope``, Adam, 4
steps), ``--schedule gpipe`` and ``1f1b``: every step's loss equals JAX's
task5 engine's on four CPU devices, on every rank.

Tolerances: losses rtol 1e-5 (f32; the sums in another order than XLA's).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import torch_dist_worker  # noqa: E402
from test_torch_pp_cli import BASE, _jax_losses  # noqa: E402

RUNS = {"dp_gpipe": ["--schedule", "gpipe", "--pp_data", "2"],
        "dp_1f1b": ["--schedule", "1f1b", "--pp_data", "2"]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    job = tmp_path_factory.mktemp("pp_cli_dp")
    want, states = {}, {}
    for name, flags in RUNS.items():
        want[name], states[name] = _jax_losses(flags, job, n=4)
    torch.save({"base": BASE + ["--device", "cpu"], "task5": RUNS, "states": states},
               job / "cases.pt")
    return want, torch_dist_worker.spawn("pp_cli", job, 4)


@pytest.mark.parametrize("name", list(RUNS))
def test_task5_pp_data_matches_jax_task5_at_world_4(runs, name):
    want, ranks = runs
    for got in ranks:
        np.testing.assert_allclose(got[name]["losses"], want[name], rtol=1e-5)
