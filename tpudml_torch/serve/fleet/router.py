"""FleetRouter: one FIFO queue fronting N serving-engine replicas (the port
of ``tpudml/serve/fleet/router.py``).

The single engine is one process, one decode batch. The fleet tier scales
it OUT: N replicas, each an unmodified :class:`ServingEngine`, behind a
single router that owns the waiting line and places each admit with the
same :class:`DecodeCostModel` the single engine prices admission with —
per replica, so a quantized replica (smaller param-byte term) honestly
prices cheaper and attracts load.

Two execution forms share this module's scheduling core:

- **Deterministic in-process form** (this file): every replica is an
  engine instance driven EXTERNALLY — the router owns the per-slot
  decode state the engine's ``run()`` loop normally keeps in locals, and
  advances all replicas on one global virtual clock
  (``engine.step_time_s`` is mandatory). A run is a pure function of
  (workload, config, kill script): the fleet event log re-serializes
  byte-for-byte, which is what the committed fixtures pin and what
  ``--fixture`` replays without spawning anything.
- **Spawned form** (``fleet/drill.py``): the same replicas as real OS
  processes under :class:`ElasticController`, where SIGKILL is actual
  SIGKILL — the supervised end-to-end arm.

**Replica death is a membership event.** A kill drains the victim's
in-flight requests back into the queue as *continuations* — prompt =
original prompt + tokens generated so far, budget = what is still owed,
deadline still measured from the ORIGINAL arrival (partial tokens stay in
the ledger) — merged into the line in (arrival, rid) order, so an old
request re-enters ahead of younger arrivals (FIFO fairness survives the
failure). Greedy decode makes the continuation exact up to rounding: the
re-admitted prefill rebuilds the K/V prefix through the chunked prefill
(on the card, the flash kernel), where the uninterrupted run wrote those
rows one decode step at a time, so on the card a continuation may part
from the uninterrupted stream only at a near-tie of its top-2 logits. The
dead replica re-forms after ``reform_after_steps`` fleet steps with the
replan path consulted (duck-typed ``replanner.replan(world, why=...)``,
fail-open, receipts recorded) before it takes traffic again.

Event log: tuples ``(kind, rid, replica, slot, step)`` with kinds
``admit / evict / reject / expire / defer`` (the engine's vocabulary,
plus the replica column) and the membership kinds ``kill / drain /
reform`` (rid/slot −1 where not applicable). ``spec`` never appears:
fleet × spec_k is a capability-table rejection (``serve_fleet_spec``).

The port's replicas are built from a module that carries its weights:
``FleetRouter(model, cfg, *, device=...)`` takes no ``params``, as the
port's ``ServingEngine(model, config, *, device=...)`` takes none.
"""

from __future__ import annotations

import binascii
import json
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from tpudml_torch.capabilities import reject
from tpudml_torch.serve.engine import (
    RequestStats,
    ServeCompositionError,
    ServeConfig,
    ServingEngine,
)
from tpudml_torch.serve.load import Request
from tpudml_torch.serve.paged import PagePool


@dataclass(frozen=True)
class FleetConfig:
    """Fleet shape: N replicas of one engine template — or a heterogeneous
    mix.

    ``engine.step_time_s`` is REQUIRED — the fleet advances every replica
    on one global virtual clock (one fleet step = one decode step on every
    live replica), which is what makes a 2×-overload run with a mid-run
    kill a pure function of (workload, config, kill script). ``max_queue``
    bounds the router's single waiting line (the engine template's own
    ``max_queue`` is ignored: replicas never see a queue).
    ``reform_after_steps`` re-forms a killed replica that many fleet steps
    later (None: it stays dead).

    ``replica_engines`` makes the fleet heterogeneous: one
    :class:`ServeConfig` per replica (e.g. one ``weight_quant="int8"``
    replica among f32 ones). The template stays the ROUTER policy — clock
    (``step_time_s``), ``deadline_s``, ``eos_token`` — so every
    per-replica config must agree with it on ``step_time_s`` (one virtual
    clock) and each is priced by ITS OWN cost model: an int8 replica's
    smaller param-byte term makes it honestly cheaper under cache-bound
    load, and the router's cheapest-feasible placement routes traffic
    there without any special-casing."""

    engine: ServeConfig
    replicas: int = 2
    max_queue: int | None = None
    reform_after_steps: int | None = None
    replica_engines: tuple | None = None

    def __post_init__(self):
        if self.replicas < 1:
            raise ValueError("replicas must be >= 1")
        if self.engine.step_time_s is None:
            raise ValueError(
                "FleetConfig requires engine.step_time_s (the fleet "
                "schedules on the virtual clock; wall-clock replicas "
                "cannot replay deterministically)"
            )
        if self.engine.spec_k:
            reject("serve_fleet_spec", exc=ServeCompositionError)
        if self.max_queue is not None and self.max_queue < 1:
            raise ValueError("max_queue must be >= 1 (or None)")
        if self.reform_after_steps is not None and self.reform_after_steps < 1:
            raise ValueError("reform_after_steps must be >= 1 (or None)")
        if self.replica_engines is not None:
            object.__setattr__(self, "replica_engines", tuple(self.replica_engines))
            if len(self.replica_engines) != self.replicas:
                raise ValueError(
                    f"replica_engines has {len(self.replica_engines)} "
                    f"entries for {self.replicas} replicas"
                )
            for i, e in enumerate(self.replica_engines):
                if e.step_time_s != self.engine.step_time_s:
                    raise ValueError(
                        f"replica {i}: step_time_s {e.step_time_s} != "
                        f"template {self.engine.step_time_s} — the fleet "
                        "runs one virtual clock"
                    )
                if e.spec_k:
                    reject("serve_fleet_spec", exc=ServeCompositionError)

    def engine_for(self, i: int) -> ServeConfig:
        """Replica ``i``'s engine config (the template when the fleet is
        homogeneous)."""
        if self.replica_engines is not None:
            return self.replica_engines[i]
        return self.engine


@dataclass
class FleetRequestStats(RequestStats):
    """Per-request ledger across the whole fleet: the engine's fields plus
    which replicas served it. ``tokens``/``token_times`` span drains —
    partial tokens from a killed replica stay, continuation tokens append
    after re-admission."""

    replica: int | None = None  # last replica that held the request
    readmits: int = 0  # times drained off a killed replica and re-placed
    replicas_visited: list = field(default_factory=list)


class _Replica:
    """One engine instance plus the per-slot decode state the engine's
    ``run()`` keeps in locals — externalized so the router can stop,
    drain, and re-form the replica between any two steps."""

    def __init__(self, idx: int, model, ecfg: ServeConfig, device):
        self.idx = idx
        self.eng = ServingEngine(model, ecfg, device=device)
        self.alive = True
        self.killed_at: int | None = None
        self.reformed_at: int | None = None
        self.decode_steps = 0
        self.busy_slot_steps = 0
        self._reset_slots()

    def _reset_slots(self):
        b = self.eng.cfg.slots
        self.last = np.zeros(b, np.int64)
        self.pos = np.zeros(b, np.int64)
        self.remaining = np.zeros(b, np.int64)
        self.slot_rid = np.full(b, -1, np.int64)
        self.slot_deadline = np.full(b, np.inf)
        self.active = np.zeros(b, bool)
        self.slot_req: list[Request | None] = [None] * b

    # ------------------------------------------------------------ state

    def n_active(self) -> int:
        return int(self.active.sum())

    def free_slot(self) -> int | None:
        for i in range(self.eng.cfg.slots):
            if not self.active[i]:
                return i
        return None

    def admit_price(self) -> float:
        """Predicted step seconds with one more tenant (the tenant count
        without an SLO cost model — placement falls back to least-loaded)."""
        cost = self.eng._cost
        if cost is None:
            return float(self.n_active())
        return cost.step_seconds(self.n_active() + 1)

    def admit_ok(self) -> bool:
        cost = self.eng._cost
        return cost is None or cost.admit_ok(self.n_active())

    # ---------------------------------------------------------- actions

    def admit(self, slot: int, req: Request, st: FleetRequestStats,
              deadline_s: float | None) -> bool:
        """Prefill ``req`` into ``slot``; False iff the paged pool is
        starved (all-or-nothing: pool untouched, request stays queued)."""
        if self.eng._paged:
            admitted = self.eng._admit_paged(slot, req, st)
            if admitted is None:
                return False
        else:
            admitted = self.eng._admit(slot, req)
        self.pos[slot], self.last[slot] = admitted
        self.remaining[slot] = req.max_new_tokens
        self.slot_rid[slot] = req.rid
        self.slot_deadline[slot] = (
            req.arrival_time + deadline_s if deadline_s is not None else np.inf
        )
        self.active[slot] = True
        self.slot_req[slot] = req
        return True

    def decode(self) -> np.ndarray:
        """One decode step over ALL slots through the engine's own step;
        returns the emitted token per slot (inactive slots emit garbage —
        masked by the caller exactly as the engine's run loop does)."""
        emitted, _ = self.eng._step(self.last, self.pos)
        self.decode_steps += 1
        self.busy_slot_steps += self.n_active()
        return emitted[:, 0]

    def release(self, slot: int):
        self.eng._release_slot(slot)
        self.slot_rid[slot] = -1
        self.active[slot] = False
        self.slot_req[slot] = None

    def kill(self, step: int) -> list[Request]:
        """SIGKILL semantics: mark dead and hand back the in-flight
        requests for the router to drain. Cache contents are garbage from
        here until :meth:`reform` reinitializes them."""
        self.alive = False
        self.killed_at = step
        victims = [r for r in self.slot_req if r is not None]
        self._reset_slots()
        return victims

    def reform(self, step: int):
        """Re-form in place: fresh caches + allocator, the SAME engine and
        decode step (the weights never changed). The caches come from the
        engine's own model — a weight-quantized engine holds its own copy —
        on the engine's device."""
        eng, cfg = self.eng, self.eng.cfg
        model = eng.model
        if eng._paged:
            eng.caches = model.init_paged_cache(cfg.total_pages, cfg.page_size,
                                                cfg.cache_kind)
            eng._pool = PagePool(cfg.total_pages, cfg.page_size, cfg.prefix_sharing)
            eng._table = np.zeros((cfg.slots, cfg.max_pages), np.int32)
            eng._slot_pages = [[] for _ in range(cfg.slots)]
        else:
            eng.caches = model.init_decode_cache(cfg.slots, cfg.max_len, cfg.cache_kind)
        self._reset_slots()
        self.alive = True
        self.reformed_at = step


@dataclass
class FleetReport:
    """One fleet run's outcome: the per-request ledger, the
    byte-deterministic event log, and per-replica aggregates."""

    requests: dict
    events: list  # (kind, rid, replica, slot, step)
    steps: int
    wall_time: float
    replicas: int
    peak_queue_depth: int = 0
    queue_depth: list = field(default_factory=list)  # (step, depth) samples
    per_replica: list = field(default_factory=list)
    replans: list = field(default_factory=list)

    @property
    def generated_tokens(self) -> int:
        return sum(len(s.tokens) for s in self.requests.values())

    @property
    def rejected(self) -> int:
        return sum(1 for s in self.requests.values() if s.rejected is not None)

    @property
    def expired(self) -> int:
        return sum(1 for s in self.requests.values() if s.expired is not None)

    @property
    def finished(self) -> int:
        return sum(1 for s in self.requests.values() if s.finished is not None)

    @property
    def drains(self) -> int:
        return sum(1 for e in self.events if e[0] == "drain")

    @property
    def kills(self) -> int:
        return sum(1 for e in self.events if e[0] == "kill")

    @property
    def tokens_per_sec(self) -> float:
        """Tokens over the VIRTUAL clock's seconds (``wall_time`` is the
        virtual clock at the run's end)."""
        return self.generated_tokens / max(self.wall_time, 1e-9)

    def canonical_events(self) -> str:
        """The determinism contract: the event log as sorted canonical JSON
        (the serialization rules of ``obs.tracer.dump_trace``) — two runs of
        the same (workload, config, kill script) produce this string
        byte-for-byte, and the committed fixtures pin its CRC."""
        doc = {"fleet_events": [list(e) for e in self.events]}
        return json.dumps(doc, sort_keys=True, separators=(",", ":")) + "\n"

    def events_crc32(self) -> int:
        return binascii.crc32(self.canonical_events().encode()) & 0xFFFFFFFF

    def latency_summary(self) -> dict:
        """p50/p99 over FINISHED requests: ttft (arrival → first token),
        per-token cadence (consecutive token-timestamp gaps WITHIN a request
        — the admission gap is excluded because a drained request's
        re-admission would otherwise produce a negative seed gap),
        end-to-end latency."""
        gaps, e2e, ttft = [], [], []
        for s in self.requests.values():
            if s.finished is None:
                continue
            ts = s.token_times
            gaps += [b - a for a, b in zip(ts, ts[1:])]
            e2e.append(s.finished - s.arrival)
            ttft.append(s.first_token - s.arrival)

        def pct(xs, q):
            return float(np.percentile(np.asarray(xs), q)) if xs else float("nan")

        return {
            "per_token_p50_s": pct(gaps, 50),
            "per_token_p99_s": pct(gaps, 99),
            "e2e_p50_s": pct(e2e, 50),
            "e2e_p99_s": pct(e2e, 99),
            "ttft_p50_s": pct(ttft, 50),
            "ttft_p99_s": pct(ttft, 99),
        }

    def to_trace_docs(self, step_time_s: float | None = None) -> list[dict]:
        """Per-replica Chrome trace documents (pid = replica index, the
        engine's slot/queue tracks via ``obs.convert``) plus a router
        document (pid = ``replicas``) carrying queue-depth samples and the
        membership instants (kill/drain/reform) — ready for
        ``merge_chrome_traces``."""
        from tpudml_torch.obs.convert import serve_trace_events
        from tpudml_torch.obs.tracer import chrome_trace_doc

        engine_kinds = ("admit", "evict", "reject", "expire", "defer")
        docs = []
        for r in range(self.replicas):
            ev = [
                (k, rid, slot, step)
                for (k, rid, rep, slot, step) in self.events
                if rep == r and k in engine_kinds
            ]
            docs.append(chrome_trace_doc(serve_trace_events(ev, step_time_s=step_time_s),
                                         pid=r))

        def ts_us(step):
            if step_time_s is None:
                return int(step)
            return int(round(step * step_time_s * 1e6))

        router_events = []
        for step, depth in self.queue_depth:
            router_events.append({
                "name": "queue_depth", "cat": "fleet", "ph": "i",
                "ts": ts_us(step), "tid": 0, "s": "t",
                "args": {"depth": depth, "step": step},
            })
        for kind, rid, rep, slot, step in self.events:
            if kind in engine_kinds and kind != "defer":
                continue  # replica-track events; defer is router-side too
            router_events.append({
                "name": kind, "cat": "fleet", "ph": "i",
                "ts": ts_us(step), "tid": 1, "s": "t",
                "args": {"rid": rid, "replica": rep, "step": step},
            })
        docs.append(chrome_trace_doc(router_events, pid=self.replicas))
        return docs

    def to_dict(self) -> dict:
        """JSON-ready summary (``fleet.json`` — what ``tools/obs_report.py``'s
        fleet section reads). ``wall_time_s`` and ``tokens_per_sec`` are on
        the virtual clock."""
        return {
            "replicas": self.replicas,
            "steps": self.steps,
            "wall_time_s": self.wall_time,
            "generated_tokens": self.generated_tokens,
            "tokens_per_sec": self.tokens_per_sec,
            "finished": self.finished,
            "rejected": self.rejected,
            "expired": self.expired,
            "kills": self.kills,
            "drains": self.drains,
            "readmits": sum(s.readmits for s in self.requests.values()),
            "peak_queue_depth": self.peak_queue_depth,
            "events_crc32": self.events_crc32(),
            "latency": self.latency_summary(),
            "per_replica": self.per_replica,
            "replans": self.replans,
        }


class FleetRouter:
    """The deterministic in-process fleet: N externally-driven engine
    replicas of ``model`` on ``device`` behind one FIFO line — see the
    module docstring.

    ``replanner`` is the duck-typed re-plan hook: on every re-form the
    router calls ``replanner.replan(live_world, why=...)`` and records the
    decision (fail-open — a raising replanner never blocks the re-form,
    mirroring ``ElasticController``)."""

    def __init__(self, model, cfg: FleetConfig, *, device: str | torch.device = "cuda",
                 replanner=None):
        self.cfg = cfg
        self.model = model
        self.replanner = replanner
        self.replicas = [_Replica(i, model, cfg.engine_for(i), device)
                         for i in range(cfg.replicas)]

    # ------------------------------------------------------------- run

    def run(self, requests: list[Request],
            kills: list[tuple[int, int]] | None = None) -> FleetReport:
        """Serve ``requests`` to completion across the fleet.

        ``kills`` is the scripted failure injection: ``(step, replica)``
        pairs — at the START of fleet step ``step`` the replica is killed
        (drain → re-queue → eventual re-form). Every request ends in exactly
        one terminal state (finished / rejected / expired), with Σ tokens
        conserved across any number of drains — the exact-accounting
        invariant the fleet tests audit.
        """
        cfg = self.cfg
        ecfg = cfg.engine
        step_time = ecfg.step_time_s
        kill_script: dict[int, list[int]] = {}
        for step, rep in kills or ():
            if not 0 <= rep < cfg.replicas:
                raise ValueError(f"kill targets unknown replica {rep}")
            kill_script.setdefault(int(step), []).append(int(rep))
        arrivals = deque(sorted(requests, key=lambda r: (r.arrival_time, r.rid)))
        queue: deque[Request] = deque()
        stats = {
            r.rid: FleetRequestStats(
                rid=r.rid, prompt_len=len(r.prompt),
                max_new_tokens=r.max_new_tokens, arrival=r.arrival_time,
            )
            for r in requests
        }
        if len(stats) != len(requests):
            raise ValueError("duplicate request ids")
        base_prompt = {r.rid: np.asarray(r.prompt, np.int32) for r in requests}

        events: list = []
        replans: list = []
        queue_depth: list = []
        steps = 0
        peak_queue = 0
        v_extra = 0.0
        deferred_logged: set[int] = set()
        pending_reforms: list[tuple[int, int]] = []  # (due_step, replica)

        def now():
            return steps * step_time + v_extra

        def any_active():
            return any(r.alive and r.active.any() for r in self.replicas)

        def live():
            return [r for r in self.replicas if r.alive]

        while arrivals or queue or any_active() or pending_reforms:
            t = now()
            # --- membership: scripted kills fire at the step boundary.
            for rep_idx in kill_script.pop(steps, ()):
                rep = self.replicas[rep_idx]
                if not rep.alive:
                    continue
                victims = rep.kill(steps)
                events.append(("kill", -1, rep_idx, -1, steps))
                drained: list[Request] = []
                for req in victims:
                    st = stats[req.rid]
                    slot = st.slot if st.slot is not None else -1
                    events.append(("drain", req.rid, rep_idx, slot, steps))
                    owed = st.max_new_tokens - len(st.tokens)
                    if owed <= 0:
                        # The kill landed exactly on the finish boundary;
                        # nothing left to serve.
                        st.finished = t
                        continue
                    cont = Request(
                        rid=req.rid,
                        prompt=np.concatenate([
                            base_prompt[req.rid], np.asarray(st.tokens, np.int32),
                        ]),
                        max_new_tokens=owed,
                        arrival_time=st.arrival,
                    )
                    st.readmits += 1
                    st.slot = None
                    drained.append(cont)
                if drained:
                    # Merge by (arrival, rid): drained requests are the
                    # oldest admits, so they re-enter at the line's head —
                    # FIFO fairness survives the failure.
                    queue = deque(sorted(drained + list(queue),
                                         key=lambda r: (r.arrival_time, r.rid)))
                if cfg.reform_after_steps is not None:
                    pending_reforms.append((steps + cfg.reform_after_steps, rep_idx))
            # --- membership: due re-forms rejoin before admission.
            still_pending = []
            for due, rep_idx in pending_reforms:
                if steps < due:
                    still_pending.append((due, rep_idx))
                    continue
                rep = self.replicas[rep_idx]
                rep.reform(steps)
                events.append(("reform", -1, rep_idx, -1, steps))
                world = len(live())
                if self.replanner is not None:
                    receipt = {
                        "step": steps, "replica": rep_idx, "world": world,
                        "why": f"fleet-reform replica {rep_idx}",
                    }
                    try:
                        decision = self.replanner.replan(world, why=receipt["why"])
                        if hasattr(decision, "to_dict"):
                            receipt["decision"] = decision.to_dict()
                        elif isinstance(decision, dict):
                            receipt["decision"] = decision
                        else:
                            receipt["decision"] = repr(decision)
                    except Exception as e:  # fail-open, like the controller
                        receipt["error"] = f"{type(e).__name__}: {e}"
                    replans.append(receipt)
            pending_reforms = still_pending
            # --- stage arrivals; a full fleet line rejects at the door.
            while arrivals and arrivals[0].arrival_time <= t:
                req = arrivals.popleft()
                if cfg.max_queue is not None and len(queue) >= cfg.max_queue:
                    stats[req.rid].rejected = t
                    events.append(("reject", req.rid, -1, -1, steps))
                else:
                    queue.append(req)
            peak_queue = max(peak_queue, len(queue))
            # --- expire queued requests strictly past their deadline.
            if ecfg.deadline_s is not None:
                kept: deque[Request] = deque()
                while queue:
                    req = queue.popleft()
                    if t > req.arrival_time + ecfg.deadline_s:
                        stats[req.rid].expired = t
                        events.append(("expire", req.rid, -1, -1, steps))
                    else:
                        kept.append(req)
                queue = kept
            # --- placement: head-of-line only (FIFO — nothing behind the
            # head may overtake). Each candidate replica is priced with ITS
            # cost model; cheapest feasible wins, index tie-break.
            while queue:
                req = queue[0]
                candidates = []
                for rep in live():
                    slot = rep.free_slot()
                    if slot is None:
                        continue
                    if not rep.admit_ok():
                        continue
                    candidates.append((rep.admit_price(), rep.idx, rep, slot))
                if not candidates:
                    if (any(rep.free_slot() is not None for rep in live())
                            and req.rid not in deferred_logged):
                        # Free capacity exists but every priced replica
                        # defers — the SLO is the binding constraint.
                        deferred_logged.add(req.rid)
                        events.append(("defer", req.rid, -1, -1, steps))
                    break
                candidates.sort(key=lambda c: (c[0], c[1]))
                st = stats[req.rid]
                st.admit_start = now()
                placed = False
                starved = 0
                for price, rep_idx, rep, slot in candidates:
                    if rep.admit(slot, req, st, ecfg.deadline_s):
                        placed = True
                        break
                    starved += 1
                if not placed:
                    if starved == len(candidates) and not any_active():
                        raise ValueError(
                            f"request {req.rid} needs more pages than any "
                            f"replica's pool can ever supply"
                        )
                    if req.rid not in deferred_logged:
                        deferred_logged.add(req.rid)
                        events.append(("defer", req.rid, -1, -1, steps))
                    break
                queue.popleft()
                st.admitted = now()
                st.slot = slot
                st.replica = rep.idx
                st.replicas_visited.append(rep.idx)
                events.append(("admit", req.rid, rep.idx, slot, steps))
            queue_depth.append((steps, len(queue)))
            if not any_active():
                if not arrivals and not queue:
                    # Everything is served (a still-pending re-form nobody
                    # needs is not worth spinning for) — the loop exits.
                    pending_reforms = []
                    continue
                if pending_reforms:
                    # Idle but a re-form is due in a known number of steps:
                    # burn virtual steps toward it (queued work can expire
                    # on the way — deadlines keep ticking).
                    steps += 1
                    continue
                if arrivals:
                    gap = arrivals[0].arrival_time - now()
                    v_extra += max(gap, 0.0)
                    continue
                # Queue non-empty, fleet idle, nothing coming: with any live
                # replica the head must have been admissible (SLO admits
                # from idle; total pool starvation raised above).
                raise ValueError(
                    "fleet has queued work but no live replica and no "
                    "re-form scheduled (kill script killed everything "
                    "with reform_after_steps=None)"
                )
            # --- one decode step on every live replica with tenants.
            t_step = (steps + 1) * step_time + v_extra
            for rep in live():
                if not rep.active.any():
                    continue
                emitted = rep.decode()
                for i in range(rep.eng.cfg.slots):
                    if not rep.active[i]:
                        continue
                    st = stats[rep.slot_rid[i]]
                    tok = int(emitted[i])
                    st.tokens.append(tok)
                    st.token_times.append(t_step)
                    if st.first_token is None:
                        st.first_token = t_step
                    rep.pos[i] += 1
                    rep.last[i] = tok
                    rep.remaining[i] -= 1
                    done = rep.remaining[i] <= 0 or (
                        ecfg.eos_token is not None and tok == ecfg.eos_token
                    )
                    if done:
                        st.finished = t_step
                        events.append(("evict", int(rep.slot_rid[i]), rep.idx, i, steps + 1))
                        rep.release(i)
                    elif t_step > rep.slot_deadline[i]:
                        st.expired = t_step
                        events.append(("expire", int(rep.slot_rid[i]), rep.idx, i, steps + 1))
                        rep.release(i)
            steps += 1

        per_replica = []
        for rep in self.replicas:
            row = {
                "replica": rep.idx,
                "decode_steps": rep.decode_steps,
                "busy_slot_steps": rep.busy_slot_steps,
                "slots": rep.eng.cfg.slots,
                "killed_at": rep.killed_at,
                "reformed_at": rep.reformed_at,
            }
            if rep.eng._pool is not None:
                row["pool"] = {
                    "prefix_hits": rep.eng._pool.prefix_hits,
                    "pages_reused": rep.eng._pool.pages_reused,
                }
            per_replica.append(row)
        return FleetReport(
            requests=stats, events=events, steps=steps, wall_time=now(),
            replicas=cfg.replicas, peak_queue_depth=peak_queue,
            queue_depth=queue_depth, per_replica=per_replica, replans=replans,
        )


# --------------------------------------------------------------- fixtures

FLEET_FIXTURE_VERSION = 1


def replay_fleet_fixture(fixture: dict, sink=None, *,
                         device: str | torch.device = "cuda") -> dict:
    """Meshless replay (the fleet twin of ``tpudml_torch.elastic``'s
    ``replay_fixture``): rebuild the fleet from the fixture's config on
    ``device``, run the recorded workload + kill script on the virtual
    clock — no processes spawned — and verify the event log's CRC and the
    token accounting against the fixture's expectations.

    Fixture schema (version 1)::

        {"version": 1,
         "model":    {"vocab_size": ..., "embed_dim": ..., ...},
         "workload": {"n": ..., "qps": ..., "seed": ...,
                      "prompt_len": [lo, hi], "new_tokens": [lo, hi]},
         "fleet":    {"replicas": ..., "max_queue": ...,
                      "reform_after_steps": ...,
                      "engine": {ServeConfig kwargs}},
         "kills":    [[step, replica], ...],
         "expect":   {"events_crc32": ..., "generated_tokens": ...,
                      "finished": ..., "drains": ...}}

    The expectations are platform-portable on purpose: the event log and
    token COUNTS depend only on prompt lengths, budgets, and the scheduler
    (host arithmetic) — never on model weights, as no fixture sets
    ``eos_token`` — so the same fixture passes on the CPU and the card,
    with the port's weights (a ``torch.Generator`` seeded with the
    fixture's ``seed``) as with JAX's.
    """
    if fixture.get("version") != FLEET_FIXTURE_VERSION:
        raise ValueError(
            f"fixture version {fixture.get('version')!r} != {FLEET_FIXTURE_VERSION}"
        )

    def log(msg):
        if sink is not None:
            print(msg, file=sink)

    from tpudml_torch.models.transformer import TransformerLM
    from tpudml_torch.serve.load import poisson_workload

    mspec = dict(fixture["model"])
    model = TransformerLM(**mspec, device=device,
                          generator=torch.Generator().manual_seed(int(fixture.get("seed", 0))))
    w = dict(fixture["workload"])
    requests, _ = poisson_workload(
        w["n"], w["qps"], w.get("seed", 0),
        vocab_size=mspec.get("vocab_size", 64),
        prompt_len=tuple(w.get("prompt_len", (4, 8))),
        new_tokens=tuple(w.get("new_tokens", (4, 8))),
    )
    f = dict(fixture["fleet"])
    cfg = FleetConfig(
        engine=ServeConfig(**f.get("engine", {})),
        replicas=f.get("replicas", 2),
        max_queue=f.get("max_queue"),
        reform_after_steps=f.get("reform_after_steps"),
    )
    kills = [tuple(k) for k in fixture.get("kills", ())]
    log(f"[fleet-fixture] replicas={cfg.replicas} requests={len(requests)} kills={kills}")
    report = FleetRouter(model, cfg, device=device).run(requests, kills=kills)
    expect = fixture.get("expect", {})
    got = {
        "events_crc32": report.events_crc32(),
        "generated_tokens": report.generated_tokens,
        "finished": report.finished,
        "drains": report.drains,
    }
    mismatches = {
        k: {"expected": expect[k], "got": got[k]}
        for k in expect
        if k in got and got[k] != expect[k]
    }
    # Accounting invariants hold in every fixture, expected or not: a
    # finished request got EXACTLY its owed tokens, however many drains
    # interrupted it (fixtures never set eos_token).
    conserved = all(
        st.finished is None or len(st.tokens) == st.max_new_tokens
        for st in report.requests.values()
    )
    terminal = all(
        sum(x is not None for x in (st.finished, st.rejected, st.expired)) == 1
        or (st.finished is None and st.rejected is None
            and st.expired is None and not st.tokens)
        for st in report.requests.values()
    )
    ok = not mismatches and conserved and terminal
    for k, m in mismatches.items():
        log(f"[fleet-fixture] MISMATCH {k}: expected {m['expected']}, got {m['got']}")
    return {
        "ok": ok,
        "mismatches": mismatches,
        "kills": len(kills),
        "replicas": cfg.replicas,
        **got,
    }
