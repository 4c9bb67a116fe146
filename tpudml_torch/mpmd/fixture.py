"""Meshless MPMD replay: drive the re-mesh state machine from a
recorded membership/transfer event stream, with no processes, no sockets
and no device (the port of ``tpudml/mpmd/fixture.py``).

The e2e drill (``mpmd/drill.py``) proves the runtime against real
SIGKILLs but costs process spawns; this replay keeps the *semantics* in
tier-1 for free. A fixture file is a JSON document::

    {
      "version": 1,
      "pipeline": {... PipelineSpec.to_dict() ...},
      "engines": ["dp", "zero1"],        # planner lattice to consult
      "bytes_per_row": 64,               # boundary payload per batch row
      "events": [
        {"type": "step", "count": 3},    # run N pipeline steps
        {"type": "checkpoint"},          # all stages checkpoint now
        {"type": "kill", "slot": 3, "why": "sigkill"},
        {"type": "step", "count": 2}
      ],
      "expect": {"events_crc32": 1234}   # optional golden
    }

Replaying emits one canonical JSON line per simulated event — group
formation (fresh deterministic ports per round), per-step boundary
transfers priced by the shared wire model (``p2p_wire_bytes``), drains
in :func:`~tpudml_torch.mpmd.spec.drain_order`, the fail-open planner
consult (the port's :class:`~tpudml_torch.elastic.replan.Replanner`,
meshless), and the in-place reform or quorum halt. The log is
byte-deterministic: lines are sorted-keys/compact JSON, ports are a
counter, nothing reads a clock — so its CRC-32 is a golden the committed
fixtures pin.

The ``replan`` lines carry the winner's keys before and after, so a
golden holds only under the planner's constants it was made with. The
committed goldens were made under the JAX package's; the port's default
(``plan.score.DEFAULT_HARDWARE``) is the H100's, under which
``shrink_stage.json``'s re-plan names the winner without the fused head
(``f0`` for ``f1``), so its CRC differs (a defined difference). The tests
replay the goldens with JAX's constants passed in as ``hw``.
"""

from __future__ import annotations

import json
import zlib
from pathlib import Path

from tpudml_torch.comm.p2p import p2p_wire_bytes
from tpudml_torch.mpmd.spec import (
    PipelineSpec,
    StageQuorumError,
    boundary_plan,
    drain_order,
    replace_pipeline,
)

FIXTURE_VERSION = 1

#: Simulated port space — purely symbolic (never bound), but laid out
#: like the controller's reservations so "fresh ports per round" is a
#: checkable property of the log.
_PORT_BASE = 51000


def canonical_event(row: dict) -> str:
    return json.dumps(row, sort_keys=True, separators=(",", ":"))


def events_crc32(lines: list) -> int:
    return zlib.crc32("\n".join(lines).encode())


class _Ports:
    def __init__(self):
        self.next = _PORT_BASE

    def take(self, n: int) -> list:
        out = list(range(self.next, self.next + n))
        self.next += n
        return out


def _round_port_layout(pipeline: PipelineSpec, ports: _Ports) -> dict:
    """The controller's per-round reservation shape, simulated: one
    coordinator per stage, one boundary listener per downstream rank,
    one ctl hub per dp>1 stage."""
    coord = ports.take(len(pipeline.stages))
    boundary = {
        b: dict(zip(range(pipeline.stages[b + 1].dp),
                    ports.take(pipeline.stages[b + 1].dp)))
        for b in range(len(pipeline.stages) - 1)
    }
    ctl = {
        s: ports.take(1)[0]
        for s, st in enumerate(pipeline.stages) if st.dp > 1
    }
    return {"coordinator": coord, "boundary": boundary, "ctl": ctl}


def replay_fixture(fixture, *, replanner=None, emit=None, hw=None) -> dict:
    """Replay one fixture; returns the verdict dict.

    ``fixture`` is a path or an already-parsed dict. ``replanner``
    defaults to a fresh meshless :class:`Replanner` over the fixture's
    ``engines`` and the roofline constants ``hw`` (None: the card's);
    pass your own to replay against a live plan file (the
    vandalized-plan tests do). ``emit`` receives each canonical event
    line as it is produced (the CLI's ``[replay]`` stream).
    """
    if not isinstance(fixture, dict):
        fixture = json.loads(Path(fixture).read_text())
    if fixture.get("version") != FIXTURE_VERSION:
        raise ValueError(
            f"unsupported fixture version {fixture.get('version')!r} "
            f"(want {FIXTURE_VERSION})"
        )
    pipeline = PipelineSpec.from_dict(fixture["pipeline"])
    bytes_per_row = int(fixture.get("bytes_per_row", 64))
    if replanner is None:
        from tpudml_torch.elastic.replan import Replanner

        kw = {} if hw is None else {"hw": hw}
        replanner = Replanner(engines=fixture.get("engines"), verify=False, **kw)
    replanner.initial_plan(pipeline.total_slots)

    ports = _Ports()
    lines: list = []

    def record(row: dict) -> None:
        line = canonical_event(row)
        lines.append(line)
        if emit is not None:
            emit(line)

    def form(rnd: int, resume: int) -> None:
        layout = _round_port_layout(pipeline, ports)
        record({
            "event": "form",
            "round": rnd,
            "stage_worlds": [st.dp for st in pipeline.stages],
            "coordinator_ports": layout["coordinator"],
            "ctl_ports": layout["ctl"],
            "resume_step": resume,
        })

    rnd = 0
    step = 0
    last_ckpt = 0
    halted = None
    replans = 0
    form(rnd, 0)
    for ev in fixture.get("events", ()):
        if halted is not None:
            break
        kind = ev["type"]
        if kind == "step":
            for _ in range(int(ev.get("count", 1))):
                record({"event": "step", "step": step})
                for b in range(len(pipeline.stages) - 1):
                    for t in boundary_plan(pipeline, b):
                        nbytes = (t.rows[1] - t.rows[0]) * bytes_per_row
                        record({
                            "event": "transfer",
                            "step": step,
                            "index": t.index,
                            "edge": t.edge,
                            "bytes": nbytes,
                            "wire_bytes": p2p_wire_bytes(nbytes),
                        })
                step += 1
        elif kind == "checkpoint":
            last_ckpt = step
            record({"event": "checkpoint", "step": step})
        elif kind == "kill":
            slot = int(ev["slot"])
            s, r = pipeline.locate(slot)
            record({
                "event": "kill",
                "slot": slot,
                "stage": s,
                "rank": r,
                "why": ev.get("why", "sigkill"),
            })
            for ds, dr in drain_order(pipeline, {slot}):
                record({
                    "event": "drain",
                    "stage": ds,
                    "rank": dr,
                    "step": step,
                })
            surviving = pipeline.total_slots - 1
            try:
                rep = replanner.replan(
                    surviving, why=f"slot {slot} killed"
                )
                rep_d = (rep.to_dict() if hasattr(rep, "to_dict")
                         else dict(rep))
            except Exception as e:  # fail open, like the controller
                rep_d = {"switched": False, "error": f"{type(e).__name__}"}
            replans += 1
            record({
                "event": "replan",
                "world": surviving,
                "old_key": rep_d.get("old_key"),
                "new_key": rep_d.get("new_key"),
                "switched": bool(rep_d.get("switched")),
                "error": rep_d.get("error"),
            })
            try:
                pipeline, _slot_map = replace_pipeline(pipeline, {slot})
            except StageQuorumError:
                halted = "below_stage_quorum"
                record({"event": "halt", "reason": halted})
                continue
            except ValueError:
                halted = "infeasible_shrink"
                record({"event": "halt", "reason": halted})
                continue
            rnd += 1
            step = last_ckpt
            form(rnd, last_ckpt)
        else:
            raise ValueError(f"unknown fixture event type {kind!r}")

    crc = events_crc32(lines)
    expect = (fixture.get("expect") or {}).get("events_crc32")
    return {
        "ok": expect is None or crc == expect,
        "mode": "mpmd_replay",
        "events": len(lines),
        "events_crc32": crc,
        "expect_crc32": expect,
        "rounds": rnd + 1,
        "replans": replans,
        "halted": halted,
        "final_stage_worlds": [st.dp for st in pipeline.stages],
        "final_step": step,
        "lines": lines,
    }
