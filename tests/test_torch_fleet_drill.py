"""The fleet's spawned drill (``tpudml_torch.serve.fleet.drill``) on the
CPU.

The drill itself — replica processes under the port's
``ElasticController``, the victim SIGKILLed mid-serve, every rank's tokens
held to an uninterrupted in-process reference by CRC — is ``slow``, as
JAX's ``test_fleet_drill_survives_sigkill`` is. In one process, without
spawning: the child's shard of the workload (JAX's prompts and arrivals,
split by rid modulo the world), the token CRC (JAX's function gives the
same number on the same report), and the artifacts a child writes
(``result_r{rank}.json`` with JAX's keys, a valid ``trace_r{rank}.json``
with the rank's pid) and that ``obs_report``'s fleet section renders.
"""

import json
from argparse import Namespace
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from tpudml.serve.fleet import drill as jax_drill  # noqa: E402
from tpudml_torch.serve.fleet import drill  # noqa: E402


def test_workload_and_shards_are_jax_s():
    """The drill's workload is JAX's request for request, and the shards
    split it by rid modulo the world: disjoint, covering, in order."""
    mine, theirs = drill._workload(10, 0), jax_drill._workload(10, 0)
    assert [(r.rid, r.prompt.tolist(), r.max_new_tokens, r.arrival_time) for r in mine] == \
        [(r.rid, r.prompt.tolist(), r.max_new_tokens, r.arrival_time) for r in theirs]
    for world in (1, 2, 3):
        shards = [drill._shard(mine, r, world) for r in range(world)]
        assert sorted(q.rid for s in shards for q in s) == [q.rid for q in mine]
        for rank, s in enumerate(shards):
            assert all(q.rid % world == rank for q in s)
            assert [q.rid for q in s] == [q.rid for q in jax_drill._shard(theirs, rank, world)]


def test_tokens_crc_is_jax_s_and_sees_every_token():
    report, shard = drill._serve_shard(0, 2, 8, 0, "cpu")
    assert report.generated_tokens == sum(r.max_new_tokens for r in shard)
    crc = drill._tokens_crc(report)
    assert crc == jax_drill._tokens_crc(report)
    st = next(iter(report.requests.values()))
    st.tokens[0] ^= 1
    assert drill._tokens_crc(report) != crc


def test_child_writes_jax_s_artifacts(tmp_path):
    """A surviving rank's child body, in process: its result row carries
    JAX's keys and the reference's CRC, its trace validates with the rank's
    pid, and the directory renders in ``obs_report``."""
    from tpudml_torch.obs.tracer import validate_chrome_trace
    from tpudml_torch.tools.obs_report import report as obs_report

    args = Namespace(dir=str(tmp_path), rank=1, world=2, kill_rank=0, requests=8, seed=0,
                     device="cpu")
    assert drill.child_main(args) == 0
    row = json.loads((tmp_path / "result_r1.json").read_text())
    assert set(row) == {"rank", "world", "round", "requests", "generated_tokens",
                        "tokens_crc", "decode_steps"}
    ref, shard = drill._serve_shard(1, 2, 8, 0, "cpu")
    assert row["tokens_crc"] == drill._tokens_crc(ref)
    assert row["requests"] == len(shard) and row["generated_tokens"] == ref.generated_tokens
    doc = json.loads((tmp_path / "trace_r1.json").read_text())
    validate_chrome_trace(doc)
    assert {e["pid"] for e in doc["traceEvents"]} == {1}
    assert not (tmp_path / "killed.marker").exists()
    (tmp_path / "fleet.json").write_text(json.dumps({
        "ok": True, "world": 2, "reforms": 0, "stop_reason": "success", "crc_ok": True,
        "ranks": {"1": dict(row, match=True)}, "merged_trace": None}))
    rendered = obs_report(tmp_path)
    assert "fleet.json (serving fleet)" in rendered
    assert f"{row['tokens_crc']:08x}" in rendered


@pytest.mark.slow
def test_fleet_drill_survives_sigkill(tmp_path):
    """Real processes, real SIGKILL: the victim replica dies mid-serve, the
    controller re-forms, and every rank's final tokens match an
    uninterrupted in-process reference. Also the merged per-replica trace
    and the obs_report fleet section."""
    from tpudml_torch.serve.fleet import run_fleet_drill
    from tpudml_torch.tools.obs_report import report as obs_report

    rep = run_fleet_drill(tmp_path, world=2, requests=8, kill_rank=1, seed=0,
                          timeout_s=240.0, device="cpu")
    assert rep["ok"], rep
    assert rep["reforms"] >= 1 and rep["crc_ok"]
    assert rep["restart_latency_s"] > 0 and rep["wall_s"] > rep["recovery_s"] > 0
    merged = Path(rep["merged_trace"])
    doc = json.loads(merged.read_text())
    assert {0, 1} <= {e.get("pid") for e in doc["traceEvents"]}
    for name in ("result_r0.json", "result_r1.json", "trace_r0.json", "trace_r1.json",
                 "trace_fleet.json", "fleet.json", "elastic.json"):
        assert (tmp_path / name).is_file(), name
    rendered = obs_report(tmp_path)
    assert "fleet.json (serving fleet)" in rendered
    assert "merged fleet trace" in rendered
