"""The host-infrastructure flags of the port's task CLIs, on the CPU at a
tiny size (no jax: the entries are the port's own; the parity of each
module against ``tpudml`` is in ``test_torch_checkpoint.py``,
``test_torch_sentinel.py``, ``test_torch_obs.py``, ``test_torch_launch.py``
and ``test_torch_profiler.py``).

- task5 ``--parallel dp --sentinel --ckpt_dir --ckpt_every 2``, then
  ``--resume``: the resumed run's losses and final checkpoint equal an
  uninterrupted run's bitwise (the loop counter is the global step and
  the row stream continues past the restored step);
- the same drill through the launcher: a run killed by ``rank_kill_hook``
  (rc 17, ``failed_rank`` 0), its newest checkpoint torn by the truncate
  vandal, the resume walking back to the step before;
- task5 ``--sentinel`` with ``--parallel single`` or ``ep`` raises JAX's
  message;
- task2 ``--obs --sentinel --profile --ckpt_dir`` (and ``--resume``),
  task1 ``--profile --ckpt_dir --resume``, task6 ``--obs`` (its trace
  byte-deterministic on the virtual clock), and ``obs_report`` on a run
  directory.
"""

import io
import json
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpudml_torch.checkpoint import CheckpointCorruptError, verify_checkpoint  # noqa: E402
from tpudml_torch.launch import ClusterSpec, launch  # noqa: E402
from tpudml_torch.obs import validate_chrome_trace  # noqa: E402
from tpudml_torch.resilience import vandalize  # noqa: E402
from tpudml_torch.tasks import task1, task2, task6_serve, task5_longcontext as task5  # noqa: E402
from tpudml_torch.tools import obs_report  # noqa: E402

TINY = ["--parallel", "dp", "--device", "cpu", "--vocab", "32", "--embed_dim", "32",
        "--num_heads", "4", "--num_layers", "2", "--seq_len", "16", "--batch_size", "4",
        "--lr", "0.01", "--attn", "flash", "--fused_ln", "--rope", "--log_every", "1"]


def _losses(log_dir) -> dict:
    out = {}
    for f in log_dir.rglob("metrics.jsonl"):
        for line in f.read_text().splitlines():
            rec = json.loads(line)
            if rec["tag"] == "Train Loss":
                out[rec["step"]] = rec["value"]
    return out


def _leaves(step_dir) -> list:
    with np.load(step_dir / "leaves.npz") as data:
        return [data[k] for k in sorted(data.files)]


def _same_state(a, b) -> bool:
    x, y = _leaves(a), _leaves(b)
    return len(x) == len(y) and all(np.array_equal(u, v) for u, v in zip(x, y))


def test_task5_sentinel_checkpoint_resume_bitwise(tmp_path, capsys):
    ref = task5.main(TINY + ["--sentinel", "--steps", "6", "--ckpt_dir", str(tmp_path / "ref"),
                             "--log_dir", str(tmp_path / "l_ref")])
    task5.main(TINY + ["--sentinel", "--steps", "4", "--ckpt_dir", str(tmp_path / "run"),
                       "--ckpt_every", "2", "--log_dir", str(tmp_path / "l_a")])
    assert sorted(p.name for p in (tmp_path / "run").iterdir()) == ["step_2", "step_4"]
    res = task5.main(TINY + ["--sentinel", "--steps", "6", "--ckpt_dir", str(tmp_path / "run"),
                             "--ckpt_every", "2", "--resume", "--log_dir", str(tmp_path / "l_b")])
    assert "resumed from step 4" in capsys.readouterr().out
    assert res["final_loss"] == ref["final_loss"] and res["steps_run"] == 6
    want, got = _losses(tmp_path / "l_ref"), _losses(tmp_path / "l_b")
    assert sorted(got) == [5, 6] and all(got[i] == want[i] for i in got)
    assert _same_state(tmp_path / "ref" / "step_6", tmp_path / "run" / "step_6")
    with pytest.raises(ValueError, match="nothing left to run"):
        task5.main(TINY + ["--sentinel", "--steps", "6", "--ckpt_dir", str(tmp_path / "run"),
                           "--resume", "--log_dir", str(tmp_path / "l_c")])


DRILL = """
import os, sys
from tpudml_torch.resilience import rank_kill_hook
from tpudml_torch.tasks import task5_longcontext as task5
task5.run(task5.parse_args(sys.argv[1:]),
          hooks=[rank_kill_hook(5, marker=os.environ["DRILL_MARKER"])])
"""


def test_launcher_kill_resume_drill(tmp_path):
    """tests/test_ckpt_resilience.py:209's drill through the launcher, at
    world 1: killed at step 5, step 4 torn, resumed from step 2."""
    flags = TINY + ["--steps", "6", "--ckpt_every", "2"]
    ref = task5.main(flags + ["--ckpt_dir", str(tmp_path / "ref"),
                              "--log_dir", str(tmp_path / "l_ref")])
    spec = ClusterSpec(num_processes=1, timeout_s=240, platform="cpu",
                       env={"DRILL_MARKER": str(tmp_path / "marker")})
    cmd = [sys.executable, "-c", DRILL, *flags, "--ckpt_dir", str(tmp_path / "run")]
    killed = launch(cmd + ["--log_dir", str(tmp_path / "l_a")], spec, sink=io.StringIO())
    assert killed.returncodes == [17] and killed.failed_rank == 0
    vandalize(str(tmp_path / "run"), "truncate")
    with pytest.raises(CheckpointCorruptError):
        verify_checkpoint(tmp_path / "run" / "step_4")
    sink = io.StringIO()
    resumed = launch(cmd + ["--resume", "--log_dir", str(tmp_path / "l_b")], spec, sink=sink)
    assert resumed.success and "resumed from step 2" in sink.getvalue()
    want, got = _losses(tmp_path / "l_ref"), _losses(tmp_path / "l_b")
    assert sorted(got) == [3, 4, 5, 6] and all(got[i] == want[i] for i in got)
    assert _same_state(tmp_path / "ref" / "step_6", tmp_path / "run" / "step_6")
    assert np.isfinite(ref["final_loss"])


@pytest.mark.parametrize("parallel", [["--parallel", "single"],
                                      ["--parallel", "ep", "--moe_experts", "4"]],
                         ids=["single", "ep"])
def test_task5_sentinel_composes_with_dp_only(tmp_path, parallel):
    with pytest.raises(ValueError, match="--sentinel composes with --parallel dp/fsdp/tp/pp, "
                                         f"not '{parallel[1]}'"):
        task5.main(TINY + parallel + ["--sentinel", "--steps", "1",
                                      "--log_dir", str(tmp_path)])


def test_task2_obs_sentinel_profile_checkpoint(tmp_path, capsys):
    flags = ["--device", "cpu", "--dataset", "synthetic", "--epochs", "1", "--batch_size", "256",
             "--log_every", "4", "--obs", "--sentinel", "--profile", "--ckpt_dir",
             str(tmp_path / "ck"), "--ckpt_every", "8", "--log_dir", str(tmp_path / "logs")]
    m = task2.main(flags)
    run_dir = Path(m["run_dir"])
    doc = json.loads((run_dir / "trace.json").read_text())
    validate_chrome_trace(doc)
    names = [e["name"] for e in doc["traceEvents"] if e["ph"] == "X"]
    assert names.count("train_step") == m["steps"] == 16
    assert names.count("checkpoint_save") == 2  # steps 8 and 16 (the final save skipped)
    assert (run_dir / "profile" / "profile_trace.rank0.json").is_file()
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == ["step_16", "step_8"]
    lines = (run_dir / "metrics.jsonl").read_text().splitlines()
    tags = {json.loads(line)["tag"] for line in lines}
    assert {"obs/grad_norm", "obs/sentinel_skips", "obs/comm_bytes"} <= tags
    assert m["step_stats"]["sentinel_skips"] == 0.0
    report = obs_report.report(run_dir)
    assert "step/train_step" in report and "checkpoint/checkpoint_save" in report
    assert obs_report.main([str(run_dir)]) == 0 and obs_report.main([str(tmp_path / "x")]) == 2
    capsys.readouterr()
    # --resume: the run starts from the saved step and has no epoch left.
    m2 = task2.main(flags + ["--resume", "--epochs", "1"])
    assert m2["steps"] == 16 and m2["test_accuracy"] == m["test_accuracy"]


def test_task1_profile_checkpoint_resume(tmp_path, capsys):
    flags = ["--device", "cpu", "--dataset", "synthetic", "--lr", "1e-3", "--batch_size", "512",
             "--log_every", "0", "--profile", "--ckpt_dir", str(tmp_path / "ck"),
             "--log_dir", str(tmp_path / "logs")]
    m = task1.main(flags)
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == ["step_8"]
    assert list((tmp_path / "logs").rglob("profile_trace.rank0.json"))
    m2 = task1.main(flags + ["--resume", "--epochs", "2"])
    assert m2["steps"] == 16
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == ["step_16", "step_8"]
    assert np.isfinite(m["loss"])


def test_task6_obs_trace_is_deterministic(tmp_path):
    argv = ["--device", "cpu", "--n_requests", "4", "--qps", "inf", "--embed_dim", "32",
            "--num_heads", "4", "--num_layers", "1", "--max_len", "64", "--prompt_len", "4", "8",
            "--new_tokens", "4", "8", "--step_time_s", "0.01", "--obs"]
    a = task6_serve.main(argv + ["--log_dir", str(tmp_path / "a")])
    b = task6_serve.main(argv + ["--log_dir", str(tmp_path / "b")])
    plain = task6_serve.main(argv[:-1] + ["--log_dir", str(tmp_path / "c")])
    ta, tb = (open(r["trace_path"], "rb").read() for r in (a, b))
    assert ta == tb and plain["trace_path"] is None and a["streams"] == plain["streams"]
    doc = json.loads(ta)
    validate_chrome_trace(doc)
    slots = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert sorted(e["args"]["rid"] for e in slots) == [0, 1, 2, 3]
