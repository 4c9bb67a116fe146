"""The port's launcher (``tpudml_torch.launch``) against ``tpudml.launch``,
on the CPU.

- the environment contract: the ``TPUDML_*`` rendezvous that
  ``DistributedConfig.from_env`` reads (the same keys and values JAX's
  spec exports), the bottleneck knobs, and the platform: the card by
  default, ``platform="cpu"`` hiding it and selecting the CPU (gloo);
- a rank that exits 17 ends the job at once, ``failed_rank`` set, the
  other rank terminated; the timeout and the SIGTERM → SIGKILL grace;
- ``restart_backoff`` equal to JAX's for the same spec and seed, and the
  whole-job restart loop;
- ``python -m tpudml_torch.launch --check`` with two gloo ranks.

Every subprocess runs under a deadline (the spec's ``timeout_s``, or the
test's ``subprocess.run`` timeout).
"""

import dataclasses
import io
import json
import random
import subprocess
import sys
import time
from pathlib import Path

import pytest

pytest.importorskip("torch")

from tpudml.launch import ClusterSpec as JaxSpec  # noqa: E402
from tpudml.launch.launcher import restart_backoff as jax_backoff  # noqa: E402
from tpudml_torch.core import DistributedConfig  # noqa: E402
from tpudml_torch.launch import ClusterSpec, launch, launch_once, restart_backoff  # noqa: E402
from tpudml_torch.launch.__main__ import main as launch_main  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
PY = sys.executable


def test_env_contract_matches_jax_and_from_env(monkeypatch):
    spec = ClusterSpec(num_processes=3, coordinator_port=29555, bottleneck_rank=1,
                       bottleneck_delay_s=0.25, env={"A": "1"}, rank_env={2: {"B": "2"}})
    jspec = JaxSpec(num_processes=3, coordinator_port=29555, bottleneck_rank=1,
                    bottleneck_delay_s=0.25, env={"A": "1"}, rank_env={2: {"B": "2"}})
    for rank in range(3):
        env, jenv = spec.environ_for_rank(rank), jspec.environ_for_rank(rank)
        keys = ("TPUDML_COORDINATOR", "TPUDML_NUM_PROCESSES", "TPUDML_PROCESS_ID",
                "TPUDML_BOTTLENECK_RANK", "TPUDML_BOTTLENECK_DELAY_S", "A")
        assert {k: env[k] for k in keys} == {k: jenv[k] for k in keys}
        assert env.get("B") == jenv.get("B")
        assert "CUDA_VISIBLE_DEVICES" not in spec.env  # the card by default
        for k in ("TPUDML_COORDINATOR", "TPUDML_NUM_PROCESSES", "TPUDML_PROCESS_ID"):
            monkeypatch.setenv(k, env[k])
        cfg = DistributedConfig.from_env()
        assert (cfg.coordinator_address, cfg.num_processes, cfg.process_id) == (
            "127.0.0.1:29555", 3, rank)
    cpu = ClusterSpec(num_processes=2, platform="cpu").environ_for_rank(0)
    assert cpu["CUDA_VISIBLE_DEVICES"] == "" and cpu["TPUDML_DEVICE"] == "cpu"
    assert "JAX_PLATFORMS" not in ClusterSpec(platform="cpu").env
    with pytest.raises(ValueError, match="one device a process"):
        ClusterSpec(devices_per_process=2).environ_for_rank(0)
    with pytest.raises(ValueError, match="platform"):
        ClusterSpec(platform="tpu").environ_for_rank(0)


def test_json_round_trip(tmp_path):
    spec = ClusterSpec(num_processes=4, timeout_s=9.0, rank_env={1: {"X": "y"}})
    spec.to_json(tmp_path / "c.json")
    assert ClusterSpec.from_json(tmp_path / "c.json") == spec
    raw = json.loads((tmp_path / "c.json").read_text())
    (tmp_path / "bad.json").write_text(json.dumps(dict(raw, nope=1)))
    with pytest.raises(ValueError, match="unknown ClusterSpec fields"):
        ClusterSpec.from_json(tmp_path / "bad.json")


def test_failed_rank_ends_the_job():
    code = ("import os, sys, time\n"
            "if os.environ['TPUDML_PROCESS_ID'] == '1': sys.exit(17)\n"
            "time.sleep(60)\n")
    sink = io.StringIO()
    t0 = time.monotonic()
    res = launch([PY, "-c", code], ClusterSpec(num_processes=2, timeout_s=60, grace_s=2),
                 sink=sink)
    assert time.monotonic() - t0 < 30
    assert res.failed_rank == 1 and res.returncodes[1] == 17
    assert res.returncodes[0] != 0 and not res.success and not res.timed_out


def test_rank_tagged_output_and_templating():
    sink = io.StringIO()
    res = launch_once([PY, "-c", "import sys; print(sys.argv[1])", "{rank}/{world}"],
                      ClusterSpec(num_processes=2, timeout_s=60), sink=sink)
    assert res.success
    assert sorted(sink.getvalue().splitlines()) == ["[rank 0] 0/2", "[rank 1] 1/2"]


def test_timeout_and_grace_kill():
    """A rank that ignores SIGTERM is killed after the grace."""
    code = ("import signal, time\n"
            "signal.signal(signal.SIGTERM, signal.SIG_IGN)\n"
            "print('up', flush=True)\n"
            "time.sleep(60)\n")
    t0 = time.monotonic()
    res = launch([PY, "-c", code], ClusterSpec(num_processes=1, timeout_s=3, grace_s=1),
                 sink=io.StringIO())
    elapsed = time.monotonic() - t0
    assert res.timed_out and res.failed_rank is None and not res.success
    assert res.returncodes == [-9]  # SIGKILL after the ignored SIGTERM
    assert 3 <= elapsed < 20


@pytest.mark.parametrize("kw", [
    dict(restart_backoff_s=0.5, restart_backoff_factor=2.0, restart_backoff_jitter=0.3,
         restart_backoff_seed=7),
    dict(restart_backoff_s=0.1, restart_backoff_factor=3.0, restart_backoff_jitter=0.0),
    dict(restart_backoff_s=0.0),
], ids=["jitter", "plain", "off"])
def test_restart_backoff_equals_jax(kw):
    spec, jspec = ClusterSpec(**kw), JaxSpec(**kw)
    rng, jrng = random.Random(spec.restart_backoff_seed), random.Random(jspec.restart_backoff_seed)
    got = [restart_backoff(spec, rng, a) for a in range(1, 6)]
    want = [jax_backoff(jspec, jrng, a) for a in range(1, 6)]
    assert got == want


def test_restarts_then_succeeds(tmp_path):
    """max_restarts relaunches the whole job: the first attempt fails, the
    second finds the marker and succeeds; the backoffs are the seeded
    schedule's."""
    marker = tmp_path / "m"
    code = (f"import os, sys\np = {str(marker)!r}\n"
            "if not os.path.exists(p):\n    open(p, 'w').close(); sys.exit(3)\n")
    spec = ClusterSpec(num_processes=1, timeout_s=60, max_restarts=2, restart_backoff_s=0.05,
                       restart_backoff_jitter=0.5, restart_backoff_seed=4)
    sink = io.StringIO()
    res = launch([PY, "-c", code], spec, sink=sink)
    assert res.success and res.attempts == 2
    assert res.backoffs_s == [restart_backoff(spec, random.Random(4), 1)]
    assert "restart 1/2" in sink.getvalue()
    assert dataclasses.asdict(spec)["coordinator_port"] == 0  # the caller's spec untouched


def test_check_with_two_gloo_ranks(capsys):
    assert launch_main(["--check", "-n", "2", "--timeout_s", "120"]) == 0
    assert "launch --check: OK (2-process gloo all_reduce" in capsys.readouterr().out


def test_cli_runs_a_command_and_reports_failure():
    out = subprocess.run([PY, "-m", "tpudml_torch.launch", "-n", "2", "--platform", "cpu",
                          "--timeout_s", "60", "--", PY, "-c",
                          "import os, sys; sys.exit(int(os.environ['TPUDML_PROCESS_ID']) * 5)"],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 1 and "rank 1 failed (rc=5)" in out.stderr
    with pytest.raises(SystemExit):
        launch_main([])
