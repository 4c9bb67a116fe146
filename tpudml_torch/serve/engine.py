"""Prefill–decode serving engine with continuous batching: the port of
``tpudml/serve/engine.py`` (dense cache, one device).

A fixed decode batch of ``slots`` cache rows runs ONE decode step per
iteration, and the host-side scheduler rewrites rows — evicting finished
sequences and prefilling queued ones into the freed rows — between steps.

- **Decode** is ``TransformerLM.apply_decode`` (greedy argmax of the
  logits) or, with ``fused_head=True``, ``apply_decode_features`` into the
  fused decode-head kernel (``tpudml_torch.ops.decode_head``), which never
  writes the [slots, vocab] logits to device memory.
- **Prefill** fills a slot's cache in ``prefill_chunk``-token chunks via
  ``apply_prefill`` (on the card, the window attention runs the flash
  kernel). The prompt's last token is NOT prefilled: it feeds the first
  decode step, which emits the first generated token.
- **Scheduling** is FIFO by arrival time with slot-index tie-breaking, on
  the same clock and with the same event log as the JAX engine.

The caches are updated in place. Stale rows need no zeroing on eviction:
a slot's mask is ``k_pos <= pos``, and every position is written before
it is first unmasked.

Not ported yet (each raises ``NotImplementedError`` and never falls
back): the paged layout, speculative decoding, SLO admission and tensor
parallelism — ROADMAP.md queue 1, serving levers.
"""

from __future__ import annotations

import copy
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from tpudml_torch.device import resolve_device
from tpudml_torch.ops.decode_head import fused_decode_head, fused_decode_head_int8
from tpudml_torch.serve.cache import KINDS
from tpudml_torch.serve.load import Request

NOT_PORTED = "is not ported yet (ROADMAP.md queue 1, serving levers)"


def make_decode_step(model):
    """The decode step: (caches, tokens [B], pos [B]) -> (next greedy
    tokens [B] int32, logits [B, V]); the caches update in place."""

    @torch.inference_mode()
    def step(caches, tokens, pos):
        logits, _ = model.apply_decode(caches, tokens, pos)
        return torch.argmax(logits, dim=-1).to(torch.int32), logits

    return step


def make_fused_decode_step(model, head_q=None, head_scale=None):
    """The fused-tail twin of :func:`make_decode_step`: the trunk runs to
    post-``ln_f`` features and the head matmul, greedy pick and step
    statistics run in one kernel. Returns (next tokens [B],
    {"max_logit": [B], "lse": [B]}). With ``head_q``/``head_scale`` (int8
    mode) the kernel reads the int8 codes + scales and dequantizes per
    weight in the oracle's op order."""

    @torch.inference_mode()
    def step(caches, tokens, pos):
        h, _ = model.apply_decode_features(caches, tokens, pos)
        bias = model.head.bias
        if head_q is not None:
            tok, mx, lse = fused_decode_head_int8(h, head_q, head_scale, bias)
        else:
            tok, mx, lse = fused_decode_head(h, model.head.kernel, bias)
        return tok, {"max_logit": mx, "lse": lse}

    return step


@dataclass(frozen=True)
class ServeConfig:
    """Engine shape knobs. Every field of the JAX ``ServeConfig`` is kept
    so later slices fill them in; the ones not ported yet raise at engine
    init."""

    slots: int = 4  # fixed decode batch: concurrent in-flight sequences
    max_len: int = 256  # cache rows per slot (prompt + generation bound)
    prefill_chunk: int = 32
    cache_kind: str = "f32"  # f32 | bf16 | int8 (serve.cache)
    eos_token: int | None = None  # early-stop token id (None: run budget out)
    # Overload guard: a full bounded queue rejects at arrival; a request
    # past arrival + deadline_s expires (queued or at a step boundary).
    max_queue: int | None = None
    deadline_s: float | None = None
    # Virtual clock: with step_time_s set, "now" is decode_steps ×
    # step_time_s (+ idle skips), so the schedule is a pure function of
    # (workload seed, config).
    step_time_s: float | None = None
    cache_layout: str = "dense"  # "paged": not ported yet
    page_size: int = 16
    num_pages: int | None = None
    prefix_sharing: bool = False
    spec_k: int = 0  # speculative decoding: not ported yet
    slo: object | None = None  # SLO admission: not ported yet
    # "int8": per-output-channel int8 kernels + f32 scales, computing on
    # their dequantization; "int8_sim": the f32-storage oracle.
    weight_quant: str | None = None
    # Fused decode tail: head matmul + greedy pick + step stats in one
    # kernel (tpudml_torch.ops.decode_head).
    fused_head: bool = False

    def __post_init__(self):
        if self.slots < 1:
            raise ValueError("slots must be >= 1")
        if self.cache_kind not in KINDS:
            raise ValueError(f"cache_kind must be one of {KINDS}")
        if self.prefill_chunk < 1 or self.max_len % self.prefill_chunk:
            raise ValueError(
                f"prefill_chunk {self.prefill_chunk} must divide "
                f"max_len {self.max_len} (padded tail chunks stay in-bounds)"
            )
        if self.max_queue is not None and self.max_queue < 1:
            raise ValueError("max_queue must be >= 1 (or None for unbounded)")
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError("deadline_s must be > 0 (or None)")
        if self.step_time_s is not None and self.step_time_s <= 0:
            raise ValueError("step_time_s must be > 0 (or None)")
        if self.cache_layout not in ("dense", "paged"):
            raise ValueError(
                f"cache_layout must be 'dense' or 'paged', "
                f"got {self.cache_layout!r}"
            )
        if self.prefix_sharing and self.cache_layout != "paged":
            raise ValueError("prefix_sharing requires cache_layout='paged'")
        if self.spec_k < 0:
            raise ValueError("spec_k must be >= 0")
        if self.weight_quant not in (None, "int8", "int8_sim"):
            raise ValueError(
                f"weight_quant must be None, 'int8' or 'int8_sim', "
                f"got {self.weight_quant!r}"
            )


@dataclass
class RequestStats:
    """Per-request outcome + timing ledger (seconds from run start)."""

    rid: int
    prompt_len: int
    max_new_tokens: int
    arrival: float
    admit_start: float | None = None  # admission began (prefill starts)
    admitted: float | None = None  # prefill finished, slot occupied
    first_token: float | None = None
    finished: float | None = None
    rejected: float | None = None  # bounced at admission control (full queue)
    expired: float | None = None  # deadline passed (queued or mid-flight)
    slot: int | None = None
    tokens: list = field(default_factory=list)
    token_times: list = field(default_factory=list)

    @property
    def ttft_s(self) -> float | None:
        """Time-to-first-token: arrival -> first generated token."""
        if self.first_token is None:
            return None
        return self.first_token - self.arrival

    @property
    def tpot_s(self) -> float | None:
        """Mean time per output token AFTER the first; None until a
        request has at least two tokens."""
        if len(self.token_times) < 2:
            return None
        return (self.token_times[-1] - self.token_times[0]) / (
            len(self.token_times) - 1
        )


@dataclass
class ServeReport:
    """One run's outcome: per-request stats, the scheduler event log
    (the determinism contract), and aggregates."""

    requests: dict
    # ("admit"|"evict"|"reject"|"expire", rid, slot, step)
    events: list
    decode_steps: int
    wall_time: float
    peak_queue_depth: int = 0
    busy_slot_steps: int = 0
    slots: int = 0

    @property
    def generated_tokens(self) -> int:
        return sum(len(s.tokens) for s in self.requests.values())

    @property
    def occupancy(self) -> float:
        """Mean fraction of decode-slot-steps doing useful work."""
        denom = self.decode_steps * max(self.slots, 1)
        return self.busy_slot_steps / denom if denom else 0.0

    def annotate_ledger(self, ledger: dict[int, dict]) -> dict[int, dict]:
        """Fill the workload ledger's per-request ``ttft_s``/``tpot_s``
        from this run's stats, in place."""
        for rid, row in ledger.items():
            st = self.requests.get(rid)
            if st is not None:
                row["ttft_s"] = st.ttft_s
                row["tpot_s"] = st.tpot_s
        return ledger

    @property
    def rejected(self) -> int:
        return sum(1 for s in self.requests.values() if s.rejected is not None)

    @property
    def expired(self) -> int:
        return sum(1 for s in self.requests.values() if s.expired is not None)

    @property
    def tokens_per_sec(self) -> float:
        return self.generated_tokens / max(self.wall_time, 1e-9)

    def latency_summary(self) -> dict:
        """p50/p99 of per-token gaps (consecutive token timestamps within
        a request, seeded by the admit time), of end-to-end latency
        (arrival -> last token) and of time-to-first-token."""
        gaps, e2e, ttft = [], [], []
        for s in self.requests.values():
            if s.finished is None:
                continue
            prev = s.admitted
            for t in s.token_times:
                gaps.append(t - prev)
                prev = t
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


class ServingEngine:
    """Continuous-batching prefill/decode over a ``TransformerLM`` on one
    device. ``device`` (default "cuda") must be where the model's
    parameters live; asking for the card without one raises."""

    def __init__(self, model, config: ServeConfig | None = None, *,
                 device: str | torch.device = "cuda", mesh=None):
        self.device = resolve_device(device)
        self.cfg = config or ServeConfig()
        cfg = self.cfg
        if model.device.type != self.device.type:
            raise ValueError(
                f"model parameters are on {model.device}, engine device is "
                f"{self.device}; move the model first"
            )
        if mesh is not None:
            raise NotImplementedError(f"tensor-parallel serving {NOT_PORTED}")
        if cfg.cache_layout == "paged":
            raise NotImplementedError(f"cache_layout='paged' {NOT_PORTED}")
        if cfg.spec_k:
            raise NotImplementedError(f"speculative decoding (spec_k) {NOT_PORTED}")
        if cfg.slo is not None:
            raise NotImplementedError(f"SLO-priced admission {NOT_PORTED}")
        if not model.rope and cfg.max_len > model.max_len:
            raise ValueError(
                f"cache max_len {cfg.max_len} exceeds the position "
                f"table ({model.max_len}); only RoPE models extrapolate"
            )
        # Weight quantization happens ONCE at init, on a copy of the model:
        # decode computes on the dequantized weights (bitwise the int8_sim
        # oracle's), while "int8" keeps the int8 kernels + scales as the
        # params of record (what the fused head reads).
        self.quantized_params = None
        self.quant_scales = None
        if cfg.weight_quant is not None:
            from tpudml_torch.serve.fleet.quant import (
                dequantize_params,
                quantize_params,
                sim_quantize_params,
            )

            state = {k: v.detach() for k, v in model.state_dict().items()}
            if cfg.weight_quant == "int8":
                self.quantized_params, self.quant_scales = quantize_params(state)
                state = dequantize_params(self.quantized_params, self.quant_scales)
            else:
                state = sim_quantize_params(state)
            model = copy.deepcopy(model)
            model.load_state_dict(state)
        self.model = model
        self.caches = model.init_decode_cache(cfg.slots, cfg.max_len, cfg.cache_kind)
        if cfg.fused_head:
            hq = hs = None
            if self.quantized_params is not None:
                hq = self.quantized_params["head.kernel"]
                hs = self.quant_scales["head.kernel"]
            self._decode = make_fused_decode_step(model, head_q=hq, head_scale=hs)
        else:
            self._decode = make_decode_step(model)

    # ------------------------------------------------------------ prefill

    def _validate_request(self, req: Request) -> np.ndarray:
        prompt = np.asarray(req.prompt, np.int32)
        if prompt.ndim != 1 or prompt.size < 1:
            raise ValueError(f"request {req.rid}: prompt must be [L>=1]")
        total = prompt.size + req.max_new_tokens
        if total > self.cfg.max_len:
            raise ValueError(
                f"request {req.rid}: prompt {prompt.size} + "
                f"max_new_tokens {req.max_new_tokens} exceeds "
                f"cache max_len {self.cfg.max_len}"
            )
        return prompt

    @torch.inference_mode()
    def _admit(self, slot: int, req: Request) -> tuple[int, int]:
        """Prefill ``req``'s prompt (all but the last token) into a slot's
        cache rows; returns (pos, last_token) for the decode state. Chunk
        tails are padded — padded rows land at positions the mask
        excludes until decode overwrites them."""
        prompt = self._validate_request(req)
        p = prompt.size - 1
        c = self.cfg.prefill_chunk
        for s0 in range(0, p, c):
            chunk = np.zeros((1, c), np.int64)
            n = min(c, p - s0)
            chunk[0, :n] = prompt[s0:s0 + n]
            self.caches = self.model.apply_prefill(
                self.caches, torch.from_numpy(chunk).to(self.device), slot, s0
            )
        return p, int(prompt[-1])

    # ---------------------------------------------------------------- run

    def run(self, requests: list[Request]) -> ServeReport:
        """Serve a request stream to completion. Arrival times are honored
        open-loop, decode advances every occupied slot one token per step,
        finished slots are refilled mid-flight from the waiting queue.
        Every request ends in exactly one terminal state: finished,
        rejected (bounded queue full at arrival) or expired (deadline
        passed while queued or in flight)."""
        cfg = self.cfg
        b = cfg.slots
        arrivals = deque(sorted(requests, key=lambda r: (r.arrival_time, r.rid)))
        queue: deque[Request] = deque()  # arrived, not yet admitted
        stats = {
            r.rid: RequestStats(
                rid=r.rid, prompt_len=len(r.prompt),
                max_new_tokens=r.max_new_tokens, arrival=r.arrival_time,
            )
            for r in requests
        }
        if len(stats) != len(requests):
            raise ValueError("duplicate request ids")

        last = np.zeros(b, np.int64)
        pos = np.zeros(b, np.int64)
        remaining = np.zeros(b, np.int64)
        slot_rid = np.full(b, -1, np.int64)
        slot_deadline = np.full(b, np.inf)
        active = np.zeros(b, bool)
        events: list = []
        steps = 0
        peak_queue = 0
        busy_slot_steps = 0
        t0 = time.perf_counter()
        v_extra = 0.0  # virtual-clock idle skips (accumulated)
        if cfg.step_time_s is not None:
            now = lambda: steps * cfg.step_time_s + v_extra  # noqa: E731
        else:
            now = lambda: time.perf_counter() - t0  # noqa: E731

        while arrivals or queue or active.any():
            t = now()
            while arrivals and arrivals[0].arrival_time <= t:
                req = arrivals.popleft()
                if cfg.max_queue is not None and len(queue) >= cfg.max_queue:
                    stats[req.rid].rejected = t
                    events.append(("reject", req.rid, -1, steps))
                else:
                    queue.append(req)
            peak_queue = max(peak_queue, len(queue))
            if cfg.deadline_s is not None:
                kept: deque[Request] = deque()
                while queue:
                    req = queue.popleft()
                    if t > req.arrival_time + cfg.deadline_s:
                        stats[req.rid].expired = t
                        events.append(("expire", req.rid, -1, steps))
                    else:
                        kept.append(req)
                queue = kept
            # Admit: free slots in index order, queue in arrival order.
            for i in range(b):
                if active[i] or not queue:
                    continue
                req = queue[0]
                st = stats[req.rid]
                st.admit_start = now()
                admitted = self._admit(i, req)
                queue.popleft()
                pos[i], last[i] = admitted
                remaining[i] = req.max_new_tokens
                slot_rid[i] = req.rid
                slot_deadline[i] = (
                    req.arrival_time + cfg.deadline_s
                    if cfg.deadline_s is not None
                    else np.inf
                )
                active[i] = True
                st.admitted = now()
                st.slot = i
                events.append(("admit", req.rid, i, steps))
            if not active.any():
                if not arrivals:
                    continue  # queue drained by expiry; loop re-checks
                gap = arrivals[0].arrival_time - now()
                if cfg.step_time_s is not None:
                    v_extra += max(gap, 0.0)  # skip virtual time forward
                elif gap > 0:
                    time.sleep(min(gap, 0.05))
                continue
            # One decode step for ALL slots: inactive slots run garbage
            # tokens at stale positions (harmless by the mask argument), so
            # the step's shape never changes with occupancy.
            busy_slot_steps += int(active.sum())
            next_t, _ = self._decode(
                self.caches,
                torch.from_numpy(last).to(self.device),
                torch.from_numpy(pos).to(self.device),
            )
            emitted = next_t.cpu().numpy()
            steps += 1
            t_step = now()
            for i in range(b):
                if not active[i]:
                    continue
                st = stats[slot_rid[i]]
                tok = int(emitted[i])
                st.tokens.append(tok)
                st.token_times.append(t_step)
                if st.first_token is None:
                    st.first_token = t_step
                pos[i] += 1
                last[i] = tok
                remaining[i] -= 1
                done = remaining[i] <= 0 or (
                    cfg.eos_token is not None and tok == cfg.eos_token
                )
                if done:
                    st.finished = t_step
                    active[i] = False
                    events.append(("evict", int(slot_rid[i]), i, steps))
                    slot_rid[i] = -1
                elif t_step > slot_deadline[i]:
                    st.expired = t_step
                    active[i] = False
                    events.append(("expire", int(slot_rid[i]), i, steps))
                    slot_rid[i] = -1
        return ServeReport(
            requests=stats, events=events, decode_steps=steps,
            wall_time=now(), peak_queue_depth=peak_queue,
            busy_slot_steps=busy_slot_steps, slots=b,
        )
