"""task4 on the port (``tpudml_torch.tasks.task4``) against ``tasks/task4.py``,
on the CPU.

- the reference defaults equal JAX's (batch 32, SGD lr 0.01, momentum 0,
  one epoch);
- ``--schedule gspmd`` end to end at world 1: it learns the synthetic set
  (JAX's ``tests/test_mp.py:104`` settings: lr 0.05, momentum 0.9; test
  accuracy > 0.5), prints ``Test accuracy`` and writes its metrics under
  ``task4-stage1``;
- at world 2 (``tests/torch_dist_worker.py``'s ``task4`` suite, gloo) both
  ranks report the world-1 run's last loss and accuracy, bitwise (both on
  one intra-op thread): model parallelism gives single-device training's
  numbers;
- ``--schedule gpipe | 1f1b`` at world 1 raise JAX's error (two stages
  need two ranks; world 2: ``tests/test_torch_pp_task4.py``).
"""

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import torch_dist_worker  # noqa: E402
from tasks import task4 as jax_task4  # noqa: E402
from tpudml_torch.tasks import task4  # noqa: E402

FLAGS = ["--device", "cpu", "--dataset", "synthetic", "--epochs", "1", "--lr", "0.05",
         "--momentum", "0.9", "--log_every", "25"]


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    """The world-1 run on one intra-op thread, as the worker ranks run (the
    sums of a conv then take the same order)."""
    logs = tmp_path_factory.mktemp("task4") / "logs"
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return task4.main(FLAGS + ["--log_dir", str(logs)]), logs
    finally:
        torch.set_num_threads(n)


def test_reference_defaults_equal_jax():
    got, want = task4.reference_defaults(), jax_task4.reference_defaults()
    assert (got.epochs, got.optimizer, got.lr, got.momentum, got.data.batch_size) == (
        want.epochs, want.optimizer, want.lr, want.momentum, want.data.batch_size)


def test_gspmd_end_to_end_at_world_1(world1, capsys):
    m, logs = world1
    assert m["world"] == 1 and m["test_accuracy"] > 0.5
    assert m["steps"] == 4096 // 32
    runs = [p.parent.name for p in logs.rglob("metrics.jsonl")]
    assert runs and all(r.endswith("task4-stage1") for r in runs)


def test_world_2_is_world_1(world1, tmp_path):
    m, _ = world1
    ranks = torch_dist_worker.spawn("task4", tmp_path, 2)
    for got in ranks:
        assert got["world"] == 2
        assert got["test_accuracy"] == m["test_accuracy"]
        assert got["loss"] == m["loss"]


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_pipeline_schedules_need_two_stages(tmp_path, schedule):
    """The pipelines are ported (world 2 against JAX's task4:
    ``tests/test_torch_pp_task4.py``); one process is half a LeNet split,
    which JAX's entry rejects too, with this wording."""
    with pytest.raises(ValueError, match="needs a multiple of 2 devices, got 1"):
        task4.main(["--device", "cpu", "--dataset", "synthetic", "--schedule", schedule,
                    "--microbatches", "2", "--log_dir", str(tmp_path)])
