"""The fleet's spawned end-to-end drill: serving replicas as real OS
processes under ElasticController, one of them SIGKILLed mid-serve (the
port of ``tpudml/serve/fleet/drill.py``).

The deterministic router (``fleet/router.py``) proves the *scheduling*
story in-process; this drill proves the *supervision* story with real
processes: N replica children each serve a fixed workload shard, the
designated victim SIGKILLs itself after serving half its shard (marker-file
gated, so it dies exactly once), the controller contains the round and
re-forms, and the re-formed incarnation serves the full shard. The verdict
is the fleet analogue of the elastic drill's bit-exactness gate: every
replica's final token CRC must equal an uninterrupted in-process reference
run of the same shard — decode is a pure function of (seed, shard, config)
on one device type, so SIGKILL-grade death must be invisible in the
tokens.

The children run on ``device`` (default ``TPUDML_DEVICE``, else the card)
and form no process group: on one card every replica shares it, as the
MPMD drill's stage processes do. Each child turns TF32 off
(``device.no_tf32``) before it builds its model.

Artifacts land in the drill dir for ``tools/obs_report.py``:
``result_r{rank}.json`` (per-replica verdict inputs), ``trace_r{rank}.json``
(per-replica serve trace, pid = rank), ``trace_fleet.json`` (the
``merge_chrome_traces`` union — one pid track per replica), ``fleet.json``
(the drill report), ``elastic.json`` (the controller's reform history).

Run via ``python -m tpudml_torch.serve.fleet --drill`` or the ``slow``-marked
test; the child entry point is ``python -m tpudml_torch.serve.fleet --child``
(spawned by the controller, never by hand).
"""

from __future__ import annotations

import binascii
import json
import os
import signal
import sys
import tempfile
from pathlib import Path

import torch

# One model/workload shape shared by children, the parent's reference and
# the tests — small enough that each child starts in seconds: the drill's
# point is supervision.
MODEL_KW = dict(vocab_size=48, embed_dim=32, num_heads=4,
                num_kv_heads=2, num_layers=2, max_len=64)
SERVE_KW = dict(slots=2, max_len=64, prefill_chunk=8, step_time_s=0.01)


def _model(seed: int, device):
    from tpudml_torch.models.transformer import TransformerLM

    return TransformerLM(**MODEL_KW, device=device,
                         generator=torch.Generator().manual_seed(seed))


def _workload(n: int, seed: int):
    from tpudml_torch.serve.load import poisson_workload

    requests, _ = poisson_workload(
        n, 200.0, seed, vocab_size=MODEL_KW["vocab_size"],
        prompt_len=(4, 10), new_tokens=(4, 8),
    )
    return requests


def _shard(requests, rank: int, world: int):
    return [r for r in requests if r.rid % world == rank]


def _tokens_crc(report) -> int:
    doc = {str(rid): list(st.tokens) for rid, st in sorted(report.requests.items())}
    blob = json.dumps(doc, sort_keys=True, separators=(",", ":"))
    return binascii.crc32(blob.encode()) & 0xFFFFFFFF


def _serve_shard(rank: int, world: int, n_requests: int, seed: int, device,
                 requests=None):
    from tpudml_torch.serve.engine import ServeConfig, ServingEngine

    model = _model(seed, device)
    if requests is None:
        requests = _workload(n_requests, seed)
    shard = _shard(requests, rank, world)
    eng = ServingEngine(model, ServeConfig(**SERVE_KW), device=device)
    return eng.run(shard), shard


def child_main(args) -> int:
    """Replica child body (``python -m tpudml_torch.serve.fleet --child``).

    Serves its rid-modulo shard and writes ``result_r{rank}.json`` +
    ``trace_r{rank}.json`` atomically. The victim rank SIGKILLs itself
    after a half-shard warm-up run the first time through (the marker file
    is the "already died once" latch — written BEFORE the kill, so the
    re-formed incarnation runs to completion)."""
    from tpudml_torch.device import no_tf32, resolve_device

    device = resolve_device(args.device)
    no_tf32(device)
    base = Path(args.dir)
    rank, world = args.rank, args.world
    marker = base / "killed.marker"
    if rank == args.kill_rank and not marker.exists():
        # Mid-run death: serve half the shard so real decode state is live
        # when the SIGKILL lands, then die without cleanup.
        from tpudml_torch.serve.engine import ServeConfig, ServingEngine

        shard = _shard(_workload(args.requests, args.seed), rank, world)
        half = shard[: max(1, len(shard) // 2)]
        ServingEngine(_model(args.seed, device), ServeConfig(**SERVE_KW),
                      device=device).run(half)
        marker.write_text(f"rank {rank} died once\n")
        os.kill(os.getpid(), signal.SIGKILL)
    report, shard = _serve_shard(rank, world, args.requests, args.seed, device)
    result = {
        "rank": rank,
        "world": world,
        "round": os.environ.get("TPUDML_ELASTIC_ROUND"),
        "requests": len(shard),
        "generated_tokens": report.generated_tokens,
        "tokens_crc": _tokens_crc(report),
        "decode_steps": report.decode_steps,
    }
    from tpudml_torch.obs.convert import write_serve_trace

    write_serve_trace(report, base / f"trace_r{rank}.json",
                      step_time_s=SERVE_KW["step_time_s"], pid=rank)
    tmp = base / f".result_r{rank}.tmp"
    tmp.write_text(json.dumps(result, sort_keys=True))
    os.replace(tmp, base / f"result_r{rank}.json")
    print(f"[fleet-child] rank {rank}/{world} requests={len(shard)} "
          f"tokens_crc={result['tokens_crc']:08x}", file=sys.stderr)
    return 0


def run_fleet_drill(base_dir=None, *, world: int = 2, requests: int = 10,
                    kill_rank: int = 1, seed: int = 0,
                    timeout_s: float = 300.0, backoff_s: float = 0.25,
                    sink=None, device: str | None = None) -> dict:
    """Spawn the replica fleet under ElasticController on ``device``, let
    the victim die, verify the re-formed fleet's tokens against an
    uninterrupted in-process reference on the same device, and merge the
    per-replica traces. Besides JAX's keys, the report carries the
    controller's clock: ``restart_latency_s`` (the failed round's end to
    the re-formed round's spawn: backoff and fresh rendezvous),
    ``recovery_s`` (the failed round's end to the re-formed round's end:
    the victim's shard served in full) and ``wall_s`` (every round)."""
    from tpudml_torch.device import default_device
    from tpudml_torch.elastic.controller import ElasticController
    from tpudml_torch.launch.cluster import ClusterSpec
    from tpudml_torch.obs.tracer import dump_trace, merge_chrome_traces

    device = device or default_device()
    cpu = torch.device(device).type == "cpu"
    base = Path(base_dir or tempfile.mkdtemp(prefix="tpudml_fleet_"))
    base.mkdir(parents=True, exist_ok=True)
    cmd = [
        sys.executable, "-m", "tpudml_torch.serve.fleet", "--child",
        "--dir", str(base), "--rank", "{rank}", "--world", "{world}",
        "--kill_rank", str(kill_rank), "--requests", str(requests),
        "--seed", str(seed), "--device", str(device),
    ]
    spec = ClusterSpec(
        num_processes=world, platform="cpu" if cpu else None, timeout_s=timeout_s,
        restart_backoff_s=backoff_s, restart_backoff_seed=seed,
        env={"OMP_NUM_THREADS": "1"},
    )
    ctrl = ElasticController(cmd, spec, policy="restart", max_reforms=2, sink=sink)
    res = ctrl.run()
    (base / "elastic.json").write_text(json.dumps(res.to_dict(), sort_keys=True, indent=2))
    # Uninterrupted reference, in-process: per-rank expected token CRCs.
    reference = _workload(requests, seed)
    expected = {}
    for r in range(world):
        ref_report, _ = _serve_shard(r, world, requests, seed, device, requests=reference)
        expected[r] = _tokens_crc(ref_report)
    ranks = {}
    crc_ok = True
    for r in range(world):
        path = base / f"result_r{r}.json"
        if not path.is_file():
            ranks[r] = {"error": "missing result"}
            crc_ok = False
            continue
        row = json.loads(path.read_text())
        row["expected_crc"] = expected[r]
        row["match"] = row.get("tokens_crc") == expected[r]
        crc_ok = crc_ok and row["match"]
        ranks[r] = row
    # Merged fleet trace: one pid track per replica (latest incarnation
    # wins — each child overwrites its own trace file).
    docs = []
    for r in range(world):
        tpath = base / f"trace_r{r}.json"
        if tpath.is_file():
            docs.append(json.loads(tpath.read_text()))
    merged_path = None
    if docs:
        merged = merge_chrome_traces(docs)
        merged_path = base / "trace_fleet.json"
        merged_path.write_text(dump_trace(merged))
    recs = res.records
    report = {
        "ok": bool(res.success and crc_ok and res.reforms >= 1),
        "world": world,
        "reforms": res.reforms,
        "stop_reason": res.stop_reason,
        "crc_ok": crc_ok,
        "ranks": {str(r): ranks[r] for r in ranks},
        "merged_trace": str(merged_path) if merged_path else None,
        "dir": str(base),
        "restart_latency_s": recs[1].t_start - recs[0].t_end if len(recs) > 1 else None,
        "recovery_s": recs[-1].t_end - recs[0].t_end if len(recs) > 1 else None,
        "wall_s": res.total_elapsed_s,
    }
    (base / "fleet.json").write_text(json.dumps(report, sort_keys=True, indent=2))
    return report
