"""Pass 4 — cross-rank protocol analysis of the MPMD pipeline (P3xx); the
port of ``tpudml/analysis/protocol.py``, the same model and rules over the
port's ``mpmd.spec``.

Every other pass in this suite reasons about ONE program at a time; the
MPMD runtime's hardest invariants live *between* programs: S gloo stage
groups, ``(step, microbatch, edge)``-framed p2p transfers, ctl-star
drain votes, and heterogeneous 1F1B host loops that must compose into a
deadlock-free schedule. This module makes that composition a static
object. :func:`build_schedules` constructs, per (stage, rank), the
ordered list of *blocking events* the runtime will execute — exactly
mirroring ``StageWorker.run_step``:

1. ``warmup_microbatches`` forwards (each: recv acts in plan order,
   then send acts in plan order),
2. strict 1F1B forward/backward alternation, then the backward tail
   (each backward: the head sends cotangents up; interior stages recv
   cotangents from below, then send their own up),
3. the group drain vote (:class:`~tpudml_torch.comm.p2p.DrainBarrier`) when
   ``dp > 1``,
4. the stage-group gradient collective(s). The
   :class:`~tpudml_torch.mpmd.runtime.GroupReducer` issues one
   all-reduce, so the default model uses one symbolic
   ``("allreduce_sum", "data")`` event; pass ``stage_collectives``
   (:func:`traced_collective_events`: JAX takes them from the traced
   jaxpr, the port from one captured step) to check a stage's real
   collective sequence instead.

:func:`check_schedules` then verifies the composed system:

- **P300** (error) — frame multiset asymmetry: a ``(edge, mb, tag,
  rows)`` frame sent that no peer schedule receives, or received but
  never sent, or issued by a rank that is not the edge's endpoint.
- **P301** (error) — wait-for cycle: an exhaustive may-progress
  simulation (sends are buffered and non-blocking, recvs block on
  their channel, votes and collectives are stage-group barriers)
  either runs every schedule to completion or names the ranks left
  blocked — e.g. both edge endpoints parked in ``recv``, or a rank
  entering the gloo allreduce while a group peer still waits in a p2p
  recv. Per-channel frame-order mismatches (the runtime's
  ``FramingError``) are reported from the same simulation.
- **P302** (error) — ranks of one stage group issuing different
  ``(op, axis, shape)`` collective sequences: the cross-rank
  generalization of J102 (gloo deadlocks, it does not diagnose).
- **P303** (warn) — a schedule reaching a stage-group collective with
  no preceding drain vote: a membership event during the step would
  park the group in gloo instead of draining at the barrier.

(P304, the port-discipline lint, is source-level and lives in the AST
pass, ``analysis/ast_pass.py``.)

Findings carry ``entrypoint="protocol:<name>"`` and no file, as JAX's
do. The whole pass needs no device and runs in milliseconds,
which is why ``MPMDController`` can afford to run it as a pre-launch
gate on every (re-)meshed ``PipelineSpec``.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass
from pathlib import Path

from tpudml_torch.analysis.findings import Finding, sort_findings
from tpudml_torch.mpmd.spec import (
    PipelineSpec,
    StageQuorumError,
    StageSpec,
    boundary_plan,
    replace_pipeline,
    warmup_microbatches,
)

__all__ = [
    "Ev",
    "build_schedules",
    "check_schedules",
    "analyze_pipeline",
    "protocol_surface",
    "analyze_protocol_surface",
    "validate_fixture_events",
    "traced_collective_events",
]

#: Committed meshless fixtures double as protocol-surface specs.
FIXTURE_DIR = Path(__file__).resolve().parents[2] / "tests" / "mpmd_fixtures"

_EDGE_RE = re.compile(r"^s(\d+)r(\d+)->s(\d+)r(\d+)$")


@dataclass(frozen=True)
class Ev:
    """One blocking event in a rank's schedule.

    ``kind`` is ``send``/``recv`` (p2p frames: ``edge`` + the frame's
    ``mb`` = the boundary transfer's plan index, ``tag`` = ``act`` or
    ``grad``, ``rows`` = the global row interval — the payload size),
    ``vote`` (drain barrier), or ``collective`` (stage-group gloo op:
    ``op``/``axis``/``shape``).
    """

    kind: str
    edge: str = ""
    mb: int = -1
    tag: str = ""
    rows: tuple = ()
    op: str = ""
    axis: str = ""
    shape: tuple = ()

    def describe(self) -> str:
        if self.kind in ("send", "recv"):
            return (f"{self.kind}(edge={self.edge}, mb={self.mb}, "
                    f"tag={self.tag})")
        if self.kind == "vote":
            return "vote(drain barrier)"
        return f"collective({self.op}, axis={self.axis})"


def _edge_endpoints(edge: str):
    """``(src (stage, rank), dst (stage, rank))`` or None."""
    m = _EDGE_RE.match(edge)
    if not m:
        return None
    a, b, c, d = map(int, m.groups())
    return (a, b), (c, d)


# ------------------------------------------------------- schedule model


def build_schedules(spec: PipelineSpec, *, stage_collectives=None) -> dict:
    """``(stage, rank) -> [Ev, ...]`` for every rank of the pipeline.

    ``stage_collectives`` optionally maps ``stage`` (or ``(stage,
    rank)``, which wins) to an iterable of ``(op, axis, shape)`` tuples
    — the stage's traced collective sequence from
    :func:`traced_collective_events`. Without it, dp>1 stages get the
    single symbolic allreduce the GroupReducer compiles to.
    """
    n = len(spec.stages)
    plans = [boundary_plan(spec, b) for b in range(n - 1)]
    out: dict = {}
    for s, st in enumerate(spec.stages):
        for r in range(st.dp):
            in_plan: dict = {}
            if s > 0:
                for t in plans[s - 1]:
                    if t.dst_rank == r:
                        in_plan.setdefault(t.dst_microbatch, []).append(t)
            out_plan: dict = {}
            if s < n - 1:
                for t in plans[s]:
                    if t.src_rank == r:
                        out_plan.setdefault(t.src_microbatch, []).append(t)
            for lst in (*in_plan.values(), *out_plan.values()):
                lst.sort(key=lambda t: t.index)

            evs: list = []

            def forward(mb, evs=evs, s=s, in_plan=in_plan, out_plan=out_plan):
                for t in in_plan.get(mb, []):
                    evs.append(Ev("recv", edge=t.edge, mb=t.index,
                                  tag="act", rows=t.rows))
                if s < n - 1:
                    for t in out_plan.get(mb, []):
                        evs.append(Ev("send", edge=t.edge, mb=t.index,
                                      tag="act", rows=t.rows))

            def backward(mb, evs=evs, s=s, in_plan=in_plan,
                         out_plan=out_plan):
                if s == n - 1:
                    for t in in_plan.get(mb, []):
                        evs.append(Ev("send", edge=t.edge, mb=t.index,
                                      tag="grad", rows=t.rows))
                else:
                    for t in out_plan.get(mb, []):
                        evs.append(Ev("recv", edge=t.edge, mb=t.index,
                                      tag="grad", rows=t.rows))
                    if s > 0:
                        for t in in_plan.get(mb, []):
                            evs.append(Ev("send", edge=t.edge, mb=t.index,
                                          tag="grad", rows=t.rows))

            w, m = warmup_microbatches(spec, s), st.microbatches
            for k in range(w):
                forward(k)
            for i in range(m - w):
                forward(w + i)
                backward(i)
            for i in range(m - w, m):
                backward(i)

            if st.dp > 1:
                evs.append(Ev("vote", edge=f"ctl:s{s}", mb=r, tag="ctl"))
                colls = None
                if stage_collectives is not None:
                    colls = stage_collectives.get(
                        (s, r), stage_collectives.get(s))
                if colls is None:
                    colls = (("allreduce_sum", "data", ()),)
                for op, axis, shape in colls:
                    if isinstance(axis, (tuple, list)):
                        axis = ",".join(str(a) for a in axis)
                    evs.append(Ev("collective", op=str(op), axis=str(axis),
                                  shape=tuple(shape)))
            out[(s, r)] = evs
    return out


def traced_collective_events(fn, args) -> tuple:
    """``fn(*args)``'s ordered ``(op, axes, shape)`` collective sequence,
    under JAX's primitive names (``psum``, ``all_gather``, ``psum_scatter``,
    ``all_to_all``, ``ppermute``), for a stage's entry in
    ``build_schedules(stage_collectives=...)``: P302 then compares the
    group's real programs instead of the symbolic reducer. JAX reads it
    off the traced jaxpr; the port runs ``fn(*args)`` once under the graph
    pass's capture (:mod:`tpudml_torch.analysis.capture`), the default
    process group standing for the stage group's ``data`` axis. A step
    that raises raises here."""
    import torch.distributed as dist

    from tpudml_torch.analysis.capture import capture
    from tpudml_torch.analysis.graph_pass import collective_shape_signature

    axes = {"data": None} if dist.is_initialized() else {}
    cap = capture(fn, args, name="traced", axes=axes)
    if cap.error is not None:
        raise cap.error
    return collective_shape_signature(cap)


# ---------------------------------------------------------- the checks


def _frame_key(e: Ev) -> tuple:
    return (e.edge, e.mb, e.tag, tuple(e.rows))


def _check_frames(schedules: dict, entrypoint: str,
                  findings: list) -> None:
    """P300: every sent frame has exactly one receiver and vice versa,
    and p2p events are issued only by their edge's endpoints."""
    sends: dict = {}
    recvs: dict = {}
    for key in sorted(schedules):
        for e in schedules[key]:
            if e.kind not in ("send", "recv"):
                continue
            ends = _edge_endpoints(e.edge)
            if ends is not None:
                src, dst = ends
                sender, receiver = (src, dst) if e.tag == "act" else (dst, src)
                expected = sender if e.kind == "send" else receiver
                if key != expected:
                    findings.append(Finding(
                        "P300",
                        f"stage {key[0]} rank {key[1]} schedules "
                        f"{e.describe()} but is not the edge's "
                        f"{'sending' if e.kind == 'send' else 'receiving'} "
                        f"endpoint for tag={e.tag}",
                        entrypoint=entrypoint,
                    ))
                    continue
            bucket = sends if e.kind == "send" else recvs
            k = _frame_key(e)
            bucket[k] = bucket.get(k, 0) + 1
    for k in sorted(set(sends) | set(recvs), key=repr):
        ns, nr = sends.get(k, 0), recvs.get(k, 0)
        if ns != nr:
            edge, mb, tag, rows = k
            findings.append(Finding(
                "P300",
                f"frame (edge={edge}, mb={mb}, tag={tag}, rows={rows}) "
                f"sent {ns}x but received {nr}x — boundary schedule "
                f"asymmetry",
                entrypoint=entrypoint,
            ))


def _check_collective_agreement(spec: PipelineSpec, schedules: dict,
                                entrypoint: str, findings: list) -> None:
    """P302: every rank of a dp>1 stage group must issue the identical
    ordered (op, axis, shape) collective sequence."""
    def fmt(seq):
        return "[" + ", ".join(
            f"{op}@{axis}{list(shape)}" for op, axis, shape in seq) + "]"

    for s, st in enumerate(spec.stages):
        if st.dp < 2:
            continue
        seqs = {
            r: tuple((e.op, e.axis, e.shape)
                     for e in schedules.get((s, r), ())
                     if e.kind == "collective")
            for r in range(st.dp)
        }
        base = seqs[0]
        bad = sorted(r for r, q in seqs.items() if q != base)
        if bad:
            findings.append(Finding(
                "P302",
                f"stage {s} ({st.name}): rank(s) {bad} issue a different "
                f"(op, axis, shape) collective sequence than rank 0 — "
                f"rank 0: {fmt(base)} vs rank {bad[0]}: "
                f"{fmt(seqs[bad[0]])}; gloo will deadlock or corrupt, "
                f"not diagnose",
                entrypoint=entrypoint,
            ))


def _check_drain_votes(schedules: dict, entrypoint: str,
                       findings: list) -> None:
    """P303: the first stage-group collective on every rank must be
    preceded by a drain vote, else a membership event mid-step parks
    the group in gloo instead of draining."""
    for key in sorted(schedules):
        voted = False
        for e in schedules[key]:
            if e.kind == "vote":
                voted = True
            elif e.kind == "collective" and not voted:
                findings.append(Finding(
                    "P303",
                    f"stage {key[0]} rank {key[1]} reaches stage-group "
                    f"collective '{e.op}' with no preceding drain vote — "
                    f"a peer death mid-step would hang the allreduce "
                    f"instead of draining at the barrier",
                    entrypoint=entrypoint,
                ))
                break


def _simulate(schedules: dict, entrypoint: str) -> list:
    """P301: may-progress simulation of the composed schedules.

    Sends are buffered (the wire has a socket buffer; the runtime never
    blocks on send for drill-sized payloads), recvs block on their
    per-(edge, sender) FIFO and must match the channel head's
    ``(mb, tag)`` frame exactly (else the runtime raises FramingError),
    votes and collectives are stage-group barriers. Anything left
    unfinished when no rank can advance is a wait-for cycle.
    """
    keys = sorted(schedules)
    pc = {k: 0 for k in keys}
    queues: dict = {}
    groups: dict = {}
    for k in keys:
        groups.setdefault(k[0], []).append(k)

    def current(k):
        evs = schedules[k]
        return evs[pc[k]] if pc[k] < len(evs) else None

    progressed = True
    while progressed:
        progressed = False
        for k in keys:
            e = current(k)
            if e is None:
                continue
            if e.kind == "send":
                queues.setdefault((e.edge, k), []).append((e.mb, e.tag))
                pc[k] += 1
                progressed = True
            elif e.kind == "recv":
                ends = _edge_endpoints(e.edge)
                peer = None
                if ends is not None:
                    src, dst = ends
                    peer = src if k == dst else dst if k == src else None
                q = queues.get((e.edge, peer)) if peer is not None else None
                if not q:
                    continue
                if q[0] != (e.mb, e.tag):
                    return [Finding(
                        "P301",
                        f"stage {k[0]} rank {k[1]}: frames cross edge "
                        f"{e.edge} out of order — schedule expects "
                        f"(mb={e.mb}, tag={e.tag}) but the channel head "
                        f"is (mb={q[0][0]}, tag={q[0][1]}); at runtime "
                        f"this is a FramingError mid-step",
                        entrypoint=entrypoint,
                    )]
                q.pop(0)
                pc[k] += 1
                progressed = True
            else:  # vote / collective: stage-group barrier
                members = groups[k[0]]
                if all((c := current(m)) is not None and c.kind == e.kind
                       for m in members):
                    for m in members:
                        pc[m] += 1
                    progressed = True
    blocked = [k for k in keys if current(k) is not None]
    if not blocked:
        return []
    desc = "; ".join(
        f"stage {k[0]} rank {k[1]} blocked in {current(k).describe()}"
        for k in blocked
    )
    return [Finding(
        "P301",
        f"wait-for cycle across ranks — no schedule can advance: {desc}",
        entrypoint=entrypoint,
    )]


def check_schedules(spec: PipelineSpec, schedules: dict, *,
                    entrypoint: str = "pipeline") -> list:
    """Run P300–P303 over a schedule model (tamper-friendly: the fixture
    twins hand-mutate ``build_schedules`` output and call this)."""
    findings: list = []
    _check_frames(schedules, entrypoint, findings)
    _check_collective_agreement(spec, schedules, entrypoint, findings)
    _check_drain_votes(schedules, entrypoint, findings)
    findings.extend(_simulate(schedules, entrypoint))
    return sort_findings(findings)


def analyze_pipeline(spec: PipelineSpec, *, entrypoint: str = "pipeline",
                     stage_collectives=None) -> list:
    """Model + check one ``PipelineSpec`` — the MPMDController's
    pre-launch gate calls exactly this."""
    schedules = build_schedules(spec, stage_collectives=stage_collectives)
    return check_schedules(spec, schedules, entrypoint=entrypoint)


# ------------------------------------------------------ repo surface


def protocol_surface() -> dict:
    """``name -> PipelineSpec`` for every spec the repo actually runs:
    the e2e drill's [2,2] pipeline, a 3-stage [2,2,2] heterogeneous
    spec (the property tests' second subject), and the committed
    meshless fixtures — initial AND every post-kill shrink, so the gate
    and the goldens can never silently diverge."""
    from tpudml_torch.mpmd.drill import _drill_pipeline

    out = {"mpmd_drill": _drill_pipeline()}
    out["mpmd_3stage"] = PipelineSpec(
        stages=(
            StageSpec("s0", dp=2, microbatches=2, dtype="bfloat16"),
            StageSpec("s1", dp=2, microbatches=2, dtype="bfloat16"),
            StageSpec("s2", dp=2, microbatches=1, dtype="float32"),
        ),
        global_batch=8,
    )
    if FIXTURE_DIR.is_dir():
        for p in sorted(FIXTURE_DIR.glob("*.json")):
            doc = json.loads(p.read_text())
            pipeline = PipelineSpec.from_dict(doc["pipeline"])
            out[f"fixture:{p.stem}"] = pipeline
            for ev in doc.get("events", ()):
                if ev.get("type") != "kill":
                    continue
                try:
                    pipeline, _ = replace_pipeline(
                        pipeline, {int(ev["slot"])})
                except (StageQuorumError, ValueError):
                    break
                out[f"fixture:{p.stem}:after_kill{ev['slot']}"] = pipeline
    return out


def analyze_protocol_surface() -> list:
    """P300–P303 over :func:`protocol_surface` — the ``--protocol`` CLI
    body, also folded into the default full run / ``--strict``."""
    findings: list = []
    for name, spec in sorted(protocol_surface().items()):
        findings.extend(
            analyze_pipeline(spec, entrypoint=f"protocol:{name}"))
    return sort_findings(findings)


# ----------------------------------------------- fixture cross-check


def validate_fixture_events(fixture, *, lines=None) -> list:
    """Check a meshless fixture's replayed transfer stream against the
    schedule model: every ``transfer`` line must be a modeled act frame
    of the pipeline incarnation it ran under (same edge, same plan
    index, same byte count), and every step must replay the boundary
    frame set exactly. Mismatches are P300 findings — this is what pins
    fixture goldens and checker to one another.

    ``fixture`` is a path or parsed dict; ``lines`` overrides the
    replayed event lines (the tamper tests inject mutated streams).
    """
    if not isinstance(fixture, dict):
        fixture = json.loads(Path(fixture).read_text())
    name = fixture.get("name", "fixture")
    entrypoint = f"protocol:{name}"
    if lines is None:
        from tpudml_torch.mpmd.fixture import replay_fixture

        lines = replay_fixture(dict(fixture))["lines"]
    bytes_per_row = int(fixture.get("bytes_per_row", 64))

    def act_frames(pipeline: PipelineSpec) -> dict:
        frames: dict = {}
        for evs in build_schedules(pipeline).values():
            for e in evs:
                if e.kind == "send" and e.tag == "act":
                    frames[(e.edge, e.mb)] = (
                        (e.rows[1] - e.rows[0]) * bytes_per_row)
        return frames

    findings: list = []
    pipeline = PipelineSpec.from_dict(fixture["pipeline"])
    frames = act_frames(pipeline)
    pending = None  # pipeline awaiting its post-kill "form"
    seen_by_step: dict = {}

    def flush_steps():
        for step in sorted(seen_by_step):
            seen = seen_by_step[step]
            missing = sorted(set(frames) - set(seen), key=repr)
            if missing:
                findings.append(Finding(
                    "P300",
                    f"step {step}: replay omitted modeled frame(s) "
                    f"{missing} — fixture stream and schedule model "
                    f"disagree",
                    entrypoint=entrypoint,
                ))
        seen_by_step.clear()

    for line in lines:
        ev = json.loads(line)
        kind = ev.get("event")
        if kind == "kill":
            try:
                pending, _ = replace_pipeline(pipeline, {int(ev["slot"])})
            except (StageQuorumError, ValueError):
                pending = None
        elif kind == "form":
            flush_steps()
            if pending is not None:
                pipeline = pending
                frames = act_frames(pipeline)
                pending = None
        elif kind == "transfer":
            key = (ev["edge"], ev["index"])
            step = ev.get("step")
            if key not in frames:
                findings.append(Finding(
                    "P300",
                    f"replayed transfer step={step} edge={ev['edge']} "
                    f"index={ev['index']} matches no modeled act frame "
                    f"of the current pipeline",
                    entrypoint=entrypoint,
                ))
                continue
            if int(ev.get("bytes", -1)) != frames[key]:
                findings.append(Finding(
                    "P300",
                    f"replayed transfer step={step} edge={ev['edge']} "
                    f"index={ev['index']} carries {ev.get('bytes')} bytes "
                    f"but the modeled frame is {frames[key]} bytes",
                    entrypoint=entrypoint,
                ))
                continue
            seen_by_step.setdefault(step, set()).add(key)
    flush_steps()
    return sort_findings(findings)
