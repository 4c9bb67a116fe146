"""``--plan`` in the port's tasks and ``python -m tpudml_torch.plan
--check``, against the JAX package.

- ``config_from_args`` fills the knobs of a JAX-emitted ``plan.json``
  (``zero1``, ``accum_steps``, ``sentinel``, ``obs``, ``aggregation``)
  into ``TrainConfig`` exactly as JAX's does, explicit flags winning;
- task2 ``--plan`` at world 2 (a gloo job) builds its ``DataParallel``
  with the plan's knobs and trains what the same knobs given as flags
  train, bitwise; that engine's parity with JAX's is the lab and ZeRO-1
  parity (``tests/test_torch_labs_dp.py``'s ``accum2``,
  ``tests/test_torch_zero1.py``);
- ``--check`` plans and verifies the flagship spec in CPU jobs of 4 and 8
  ranks.
"""

import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

from tpudml.core.config import build_parser as jax_parser  # noqa: E402
from tpudml.core.config import config_from_args as jax_config  # noqa: E402
from tpudml.plan import flagship_lm as jax_flagship  # noqa: E402
from tpudml.plan import make_plan as jax_make_plan  # noqa: E402
from tpudml.plan import plan_to_json as jax_plan_to_json  # noqa: E402

from tests.torch_dist_worker import spawn  # noqa: E402
from tpudml_torch.core.config import PLAN_KNOBS, build_parser, config_from_args  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def check_run():
    """``python -m tpudml_torch.plan --check``, started when the module
    starts so that its two jobs run beside the module's other tests."""
    proc = subprocess.Popen([sys.executable, "-m", "tpudml_torch.plan", "--check"],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            cwd=REPO, env={**os.environ, "PYTHONPATH": REPO})
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def plan_paths(tmp_path_factory):
    """JAX's plans of the flagship at worlds 2 and 4 (both ZeRO-1 with
    accumulation 2), and one whose engine_config sets every knob."""
    out = {}
    root = tmp_path_factory.mktemp("plans")
    for w in (2, 4):
        plan = jax_make_plan(jax_flagship(), w, verify=False)
        assert plan["engine_config"]["zero1"] and plan["engine_config"]["accum_steps"] == 2
        out[w] = root / f"plan{w}.json"
        out[w].write_text(jax_plan_to_json(plan))
        if w == 4:
            plan["engine_config"].update(sentinel=True, obs=True, zero1=False,
                                         aggregation="allgather")
            out["all"] = root / "plan_all.json"
            out["all"].write_text(jax_plan_to_json(plan))
    return out


@pytest.mark.parametrize("plan", [2, 4, "all"])
@pytest.mark.parametrize("flags", [[], ["--accum_steps", "8"], ["--zero1"], ["--obs"],
                                   ["--aggregation", "reducescatter", "--sentinel"]])
def test_plan_fills_the_knobs_as_jax_does(plan_paths, plan, flags):
    argv = ["--plan", str(plan_paths[plan])] + flags
    want = jax_config(jax_parser().parse_args(argv))
    got = config_from_args(build_parser().parse_args(argv))
    for name in PLAN_KNOBS:
        assert getattr(got, name) == getattr(want, name), name
    if "--accum_steps" in flags:
        assert got.accum_steps == 8  # the explicit flag beats the plan


def test_task2_plan_at_world_two_trains_the_plan_s_engine(plan_paths, tmp_path):
    (tmp_path / "plan.json").write_text(plan_paths[2].read_text())
    ranks = spawn("plan_cli", tmp_path, world=2)
    for r in ranks:
        assert r["plan"]["engine"] == {"zero1": True, "accum_steps": 2,
                                       "aggregation": "allreduce", "sentinel": False}
        assert r["plan"] == dict(r["flags"])  # --plan trains what its flags train, bitwise
        assert r["plan_accum4"]["engine"]["accum_steps"] == 4  # explicit wins
        assert r["plan_accum4"]["engine"]["zero1"]
        assert r["plan"]["world"] == 2
    assert ranks[0]["plan"] == ranks[1]["plan"]


def test_plan_cli_check_smoke(check_run):
    """``python -m tpudml_torch.plan --check``: the flagship spec planned
    and verified in CPU jobs of 4 and 8 ranks, exit 0 with a verified
    winner at both."""
    out, err = check_run.communicate(timeout=600)
    assert check_run.returncode == 0, out[-4000:] + err[-4000:]
    assert "world=4: ok" in out
    assert "world=8: ok" in out
