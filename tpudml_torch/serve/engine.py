"""Prefill–decode serving engine with continuous batching: the port of
``tpudml/serve/engine.py`` (one device).

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

Three levers compose on top, each set in ``ServeConfig`` and each
greedy-exact against the dense path: ``cache_layout="paged"`` (+
``prefix_sharing``) swaps the cache for a page pool behind a slot→page
table (``serve/paged.py``; the paged prefill runs the flash kernel on the
card), ``spec_k > 0`` swaps the decode step for draft-then-verify
speculative decoding (``serve/spec.py``), and ``slo`` prices admission
with the static cost model (``serve/sched.py``). A ``compute_dtype=
torch.bfloat16`` model serves in bf16 on every path; its fused tail feeds
the bf16 features, widened exactly to f32, with the f32 head into the
decode-head kernel, as JAX's fused step does (its unfused step uses the
bf16 head). ``fused_head`` with paged or spec raises
``ServeCompositionError``.

``mesh={"model": W}`` serves tensor-parallel over the job's W ranks
(``serve/tp.py``): each rank holds its shard of the weights and the KV
cache, and every rank runs the same scheduler and the same steps. The
schedule must be the same on every rank, or the collectives inside the
steps fall out of step: under the virtual clock it is a pure function of
the inputs, and under the wall clock every reading of the clock is rank
0's, broadcast to the group. TP composes with the dense f32/bf16/int8
caches only: paged, spec, weight quantization and the fused head raise
``ServeCompositionError``.
"""

from __future__ import annotations

import copy
import math
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from tpudml_torch.capabilities import CompositionError, reject
from tpudml_torch.device import resolve_device
from tpudml_torch.markers import marked
from tpudml_torch.ops.decode_head import fused_decode_head, fused_decode_head_int8
from tpudml_torch.serve.cache import KINDS
from tpudml_torch.serve.load import Request
from tpudml_torch.serve.paged import PAGED_DECODE_MARKER, PagePool
from tpudml_torch.serve.sched import DecodeCostModel, SLOConfig
from tpudml_torch.serve.spec import draft_from_trunk, make_spec_decode_step


class ServeCompositionError(CompositionError):
    """Raised when serving levers are combined in a regime that has no
    correct path (the fused head × paged or spec; tensor parallelism ×
    paged or spec). Loud by contract: the alternative is a silently wrong
    answer path."""


# Every decode step runs as a region under JAX's jit name
# (tpudml/serve/engine.py:72): J110 and J119 read the body of that region.
SERVE_DECODE_MARKER = "_serve_decode_step"


def make_decode_step(model):
    """The decode step: (caches, tokens [B], pos [B]) -> (next greedy
    tokens [B] int32, logits [B, V]); the caches update in place."""

    @marked(SERVE_DECODE_MARKER)
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
    weight in the oracle's op order.

    The head is read uncast: under bf16 compute the bf16 features are
    widened to f32 (exact) and meet the f32 head weights at f32, which is
    what JAX's fused step computes (its kernel takes the bf16 features
    with the f32 head at ``preferred_element_type=f32``)."""

    @marked(SERVE_DECODE_MARKER)
    @torch.inference_mode()
    def step(caches, tokens, pos):
        h, _ = model.apply_decode_features(caches, tokens, pos)
        h = h.float()
        bias = model.head.bias
        if head_q is not None:
            tok, mx, lse = fused_decode_head_int8(h, head_q, head_scale, bias)
        else:
            tok, mx, lse = fused_decode_head(h, model.head.kernel, bias)
        return tok, {"max_logit": mx, "lse": lse}

    return step


def make_cacheless_decode_step(model):
    """The decode strategy the KV cache exists to remove: re-run the full
    forward over the whole history and keep the last row's greedy pick,
    tokens [B, T] -> next tokens [B] int32. The cache's A/B baseline."""

    @marked(SERVE_DECODE_MARKER)
    @torch.inference_mode()
    def step(tokens):
        return torch.argmax(model(tokens)[:, -1, :], dim=-1).to(torch.int32)

    return step


def make_paged_decode_step(model):
    """The paged twin of :func:`make_decode_step`: (pools, table [B,
    max_pages], tokens [B], pos [B]) -> (next greedy tokens [B] int32,
    logits [B, V]); the pools update in place. Page alloc/free between
    steps only rewrites the table."""

    @marked(PAGED_DECODE_MARKER)
    @torch.inference_mode()
    def step(caches, table, tokens, pos):
        logits, _ = model.apply_decode_paged(caches, table, tokens[:, None], pos)
        logits = logits[:, 0, :]
        return torch.argmax(logits, dim=-1).to(torch.int32), logits

    return step


@dataclass(frozen=True)
class ServeConfig:
    """Engine shape knobs, the JAX ``ServeConfig``'s fields."""

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
    # Cache layout: "dense" [slots, max_len] rows, or "paged": K/V in a
    # pool of [num_pages, page_size, ...] pages behind a [slots,
    # max_pages] table (serve/paged.py). num_pages=None sizes the pool to
    # dense capacity + the garbage page.
    cache_layout: str = "dense"
    page_size: int = 16
    num_pages: int | None = None
    # Prefix sharing (paged only): admit-time page reuse for equal prompt
    # heads; page_size must be a multiple of prefill_chunk.
    prefix_sharing: bool = False
    # Speculative decoding: draft spec_k tokens per target step (0: off).
    # Admission reserves spec_k rows of verify headroom per slot.
    spec_k: int = 0
    # SLO-aware admission: admit the queue head only while the priced
    # decode step (serve/sched.py) fits the per-token budget.
    slo: SLOConfig | None = None
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
        if self.cache_layout == "paged":
            if self.page_size < 1:
                raise ValueError("page_size must be >= 1")
            if self.num_pages is not None and self.num_pages < 2:
                raise ValueError(
                    "num_pages must be >= 2 (page 0 is the garbage sink)"
                )
            if self.prefix_sharing and self.page_size % self.prefill_chunk:
                raise ValueError(
                    f"prefix_sharing requires page_size "
                    f"{self.page_size} to be a multiple of prefill_chunk "
                    f"{self.prefill_chunk} (a shared head must end on a "
                    f"chunk boundary so fresh prefill never rewrites a "
                    f"shared page)"
                )
        elif self.prefix_sharing:
            raise ValueError("prefix_sharing requires cache_layout='paged'")
        if self.spec_k < 0:
            raise ValueError("spec_k must be >= 0")
        if self.weight_quant not in (None, "int8", "int8_sim"):
            raise ValueError(
                f"weight_quant must be None, 'int8' or 'int8_sim', "
                f"got {self.weight_quant!r}"
            )

    @property
    def max_pages(self) -> int:
        """Page-table width: pages covering one slot's max_len rows."""
        return math.ceil(self.max_len / self.page_size)

    @property
    def total_pages(self) -> int:
        """Pool size: ``num_pages``, by default dense capacity (slots ×
        max_pages) plus the garbage page."""
        if self.num_pages is not None:
            return self.num_pages
        return self.slots * self.max_pages + 1


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
    shared_pages: int = 0  # prefix-cache pages reused at admit (paged)

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
    # ("admit"|"evict"|"reject"|"expire"|"defer", rid, slot, step) plus
    # ("spec", rid, slot, step, accepted_len) when spec decoding is on.
    events: list
    decode_steps: int
    wall_time: float
    peak_queue_depth: int = 0
    busy_slot_steps: int = 0
    slots: int = 0
    pool_stats: dict | None = None  # paged only: prefix hits/evictions

    @property
    def generated_tokens(self) -> int:
        return sum(len(s.tokens) for s in self.requests.values())

    @property
    def occupancy(self) -> float:
        """Mean fraction of decode-slot-steps doing useful work."""
        denom = self.decode_steps * max(self.slots, 1)
        return self.busy_slot_steps / denom if denom else 0.0

    @property
    def mean_accepted_len(self) -> float:
        """Mean accepted draft tokens COMMITTED per spec step (0.0 without
        spec events); Σ(accepted_len + 1) is the generated token count."""
        ls = [e[4] for e in self.events if e[0] == "spec"]
        return float(np.mean(ls)) if ls else 0.0

    def to_trace_events(self, step_time_s: float | None = None) -> list[dict]:
        """This run's event log as Chrome trace events (the pure conversion
        of ``tpudml_torch.obs.convert``); pass the run's
        ``ServeConfig.step_time_s`` for virtual-clock timestamps."""
        from tpudml_torch.obs.convert import serve_trace_events

        return serve_trace_events(self.events, step_time_s=step_time_s)

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
    parameters live; asking for the card without one raises. With
    ``spec_k`` the draft is ``draft_model`` run with the weights
    ``draft_params`` (its state dict), or by default the target's lower
    ``draft_layers`` blocks (``draft_from_trunk``, num_layers // 2).
    ``mesh`` (``{axis_name: W}`` over the job's ranks) serves
    tensor-parallel (module docstring); ``model`` stays whole, and
    ``tp.local`` is this rank's shard."""

    def __init__(self, model, config: ServeConfig | None = None, *,
                 device: str | torch.device = "cuda", mesh=None, axis_name: str = "model",
                 draft_model=None, draft_params=None,
                 draft_layers: int | None = None):
        self.device = resolve_device(device)
        self.cfg = config or ServeConfig()
        cfg = self.cfg
        if model.device.type != self.device.type:
            raise ValueError(
                f"model parameters are on {model.device}, engine device is "
                f"{self.device}; move the model first"
            )
        self._paged = cfg.cache_layout == "paged"
        if mesh is not None and (self._paged or cfg.spec_k):
            # The TP steps know nothing of page tables or verify windows.
            reject("serve_tp_paged_spec", exc=ServeCompositionError)
        if mesh is not None and cfg.weight_quant is not None:
            # The shards are cut from f32 weights; int8 kernels and their
            # scale trees have no placement.
            reject("serve_tp_weight_quant", exc=ServeCompositionError)
        if cfg.fused_head and (mesh is not None or self._paged or cfg.spec_k):
            # The fused tail consumes the dense step's features and the
            # whole [d, V] head; the paged and spec steps consume full
            # logits windows, and TP shards the head.
            reject("serve_fused_head_dense", exc=ServeCompositionError)
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
        # Paged bookkeeping: the host-side allocator plus the [slots,
        # max_pages] table the decode step reads through.
        self._pool = None
        self._table = None
        self._slot_pages: list[list[int]] = [[] for _ in range(cfg.slots)]
        self.tp = None
        self._prefill = model.apply_prefill
        if mesh is not None:
            from tpudml_torch.serve.tp import TPServing

            self.tp = TPServing(model, mesh, axis_name, cfg)
            self.tp.shard_params()
            self.caches = self.tp.init_caches()
            self._decode = self.tp.decode_step
            self._prefill = self.tp.prefill
        elif self._paged:
            self.caches = model.init_paged_cache(cfg.total_pages, cfg.page_size,
                                                 cfg.cache_kind)
            self._decode = make_paged_decode_step(model)
            self._pool = PagePool(cfg.total_pages, cfg.page_size, cfg.prefix_sharing)
            self._table = np.zeros((cfg.slots, cfg.max_pages), np.int32)
        else:
            self.caches = model.init_decode_cache(cfg.slots, cfg.max_len, cfg.cache_kind)
            if cfg.fused_head:
                hq = hs = None
                if self.quantized_params is not None:
                    hq = self.quantized_params["head.kernel"]
                    hs = self.quant_scales["head.kernel"]
                self._decode = make_fused_decode_step(model, head_q=hq, head_scale=hs)
            else:
                self._decode = make_decode_step(model)
        # Speculative decoding: by default the target's lower trunk (no
        # extra weights); exactness never depends on the draft.
        self._spec = None
        self.draft_model = None
        if cfg.spec_k:
            if draft_model is None:
                n = draft_layers or max(1, model.num_layers // 2)
                draft_model, _ = draft_from_trunk(model, n)
            elif draft_params is None:
                raise ValueError("draft_model requires draft_params")
            else:
                draft_model.load_state_dict(draft_params)
            self.draft_model = draft_model
            # The draft cache stays dense in every mode: it is small and
            # only ever single-token-stepped.
            self._dcaches = draft_model.init_decode_cache(cfg.slots, cfg.max_len,
                                                          cfg.cache_kind)
            self._spec = make_spec_decode_step(model, draft_model, cfg.spec_k,
                                               paged=self._paged)
        # SLO admission pricing (deterministic, host-side).
        self._cost = None
        if cfg.slo is not None:
            self._cost = DecodeCostModel(model, cfg, cfg.slo,
                                         world=self.tp.world if self.tp is not None else 1,
                                         draft_model=self.draft_model)

    # ------------------------------------------------------------ prefill

    def _spec_headroom(self) -> int:
        return self.cfg.spec_k if self._spec is not None else 0

    def _validate_request(self, req: Request) -> np.ndarray:
        prompt = np.asarray(req.prompt, np.int32)
        if prompt.ndim != 1 or prompt.size < 1:
            raise ValueError(f"request {req.rid}: prompt must be [L>=1]")
        total = prompt.size + req.max_new_tokens + self._spec_headroom()
        if total > self.cfg.max_len:
            extra = (
                f" (+ spec_k {self.cfg.spec_k} verify headroom)"
                if self._spec_headroom() else ""
            )
            raise ValueError(
                f"request {req.rid}: prompt {prompt.size} + "
                f"max_new_tokens {req.max_new_tokens}{extra} exceeds "
                f"cache max_len {self.cfg.max_len}"
            )
        return prompt

    def _chunks(self, prompt: np.ndarray, start: int = 0):
        """(s0, chunk [1, C] on the device) of the prompt's prefilled
        positions [start, len - 1); the tail chunk is zero-padded (padded
        rows land at positions the mask excludes until decode overwrites
        them)."""
        p = prompt.size - 1
        c = self.cfg.prefill_chunk
        for s0 in range(start, p, c):
            chunk = np.zeros((1, c), np.int64)
            n = min(c, p - s0)
            chunk[0, :n] = prompt[s0:s0 + n]
            yield s0, torch.from_numpy(chunk).to(self.device)

    def _prefill_draft(self, slot: int, prompt: np.ndarray) -> None:
        """Spec only: the DRAFT cache needs the whole prompt too (it is per
        slot and dense, and never shares prefix pages)."""
        if self._spec is None:
            return
        for s0, chunk in self._chunks(prompt):
            self._dcaches = self.draft_model.apply_prefill(self._dcaches, chunk, slot, s0)

    @torch.inference_mode()
    def _admit(self, slot: int, req: Request) -> tuple[int, int]:
        """Prefill ``req``'s prompt (all but the last token) into a slot's
        cache rows; returns (pos, last_token) for the decode state."""
        prompt = self._validate_request(req)
        for s0, chunk in self._chunks(prompt):
            self.caches = self._prefill(self.caches, chunk, slot, s0)
        self._prefill_draft(slot, prompt)
        return prompt.size - 1, int(prompt[-1])

    @torch.inference_mode()
    def _admit_paged(self, slot: int, req: Request,
                     stats: RequestStats) -> tuple[int, int] | None:
        """Paged admission: map pages into the slot's table row — prefix
        hits first (refcounted, their prefill skipped), fresh pages for the
        rest — then prefill from the first unshared position. Returns None
        (the pool untouched, the request still queued) when the pool cannot
        supply the fresh pages."""
        cfg = self.cfg
        prompt = self._validate_request(req)
        total = prompt.size + req.max_new_tokens + self._spec_headroom()
        p = prompt.size - 1
        pool = self._pool
        needed = math.ceil(total / cfg.page_size)
        shared = pool.match_prefix(prompt)  # only pages ending before p
        # Acquire the matched pages BEFORE allocating fresh ones: a
        # pressured alloc_n could otherwise evict a page about to be mapped
        # as this slot's prefix (one pool page at two table rows).
        for pid in shared:
            pool.acquire(pid)
        fresh = pool.alloc_n(needed - len(shared))
        if fresh is None:
            for pid in shared:
                pool.release(pid)
            return None
        if shared:
            pool.prefix_hits += 1
            pool.pages_reused += len(shared)
        pages = shared + fresh
        row = np.zeros(cfg.max_pages, np.int32)
        row[: len(pages)] = pages
        self._table[slot] = row
        self._slot_pages[slot] = pages
        stats.shared_pages = len(shared)
        # Prefill [n_shared·P, p): chunk-aligned by page_size %
        # prefill_chunk == 0, so a fresh chunk never writes a shared page.
        row_t = torch.from_numpy(row).to(self.device)
        for s0, chunk in self._chunks(prompt, len(shared) * cfg.page_size):
            self.caches = self.model.apply_prefill_paged(self.caches, row_t, chunk, s0)
        if pool.prefix_sharing:
            # Publish the fully prefilled fresh pages: page j is shareable
            # iff it ends strictly before the first decode write at p.
            for j in range(len(shared), len(pages)):
                if (j + 1) * cfg.page_size <= p:
                    pool.register(pages[j], prompt, j)
        self._prefill_draft(slot, prompt)
        return p, int(prompt[-1])

    def _release_slot(self, slot: int) -> None:
        """Return a finished or expired slot's pages to the allocator and
        zero its table row (its don't-care writes go to the garbage page)."""
        if self._pool is None:
            return
        for pid in self._slot_pages[slot]:
            self._pool.release(pid)
        self._slot_pages[slot] = []
        self._table[slot] = 0

    def _step(self, last: np.ndarray, pos: np.ndarray):
        """One decode (or spec) step for all slots: (emitted [B, W] int,
        n_emit [B]) on the host, W = 1 or spec_k + 1."""
        tokens = torch.from_numpy(last).to(self.device)
        pos_t = torch.from_numpy(pos).to(self.device)
        table = () if self._table is None else (torch.from_numpy(self._table).to(self.device),)
        if self._spec is not None:
            emitted, n_emit, _ = self._spec(self.caches, self._dcaches, *table, tokens, pos_t)
            return emitted.cpu().numpy(), n_emit.cpu().numpy()
        next_t, _ = self._decode(self.caches, *table, tokens, pos_t)
        return next_t.cpu().numpy()[:, None], np.ones(len(last), np.int64)

    def _shared_clock(self, t: float) -> float:
        """Rank 0's reading ``t`` of the wall clock on every rank of the TP
        group (one broadcast): every scheduling decision then sees the same
        time on every rank, as JAX's one scheduler sees one clock."""
        reading = torch.tensor([t], dtype=torch.float64, device=self.device)
        torch.distributed.broadcast(reading, src=torch.distributed.get_global_rank(
            self.tp.group, 0), group=self.tp.group)
        return float(reading.item())

    # ---------------------------------------------------------------- run

    def run(self, requests: list[Request]) -> ServeReport:
        """Serve a request stream to completion. Arrival times are honored
        open-loop, decode advances every occupied slot each step, finished
        slots are refilled mid-flight from the waiting queue. Every request
        ends in exactly one terminal state: finished, rejected (bounded
        queue full at arrival) or expired (deadline passed while queued or
        in flight)."""
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
        deferred_logged: set[int] = set()  # one "defer" event per rid
        t0 = time.perf_counter()
        v_extra = 0.0  # virtual-clock idle skips (accumulated)
        if cfg.step_time_s is not None:
            now = lambda: steps * cfg.step_time_s + v_extra  # noqa: E731
        elif self.tp is not None:
            now = lambda: self._shared_clock(time.perf_counter() - t0)  # noqa: E731
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
            # Admit: free slots in index order, queue in arrival order. The
            # head is only PEEKED until admission succeeds: an SLO deferral
            # or a page-starved pool leaves it queued, and nothing behind
            # it overtakes.
            for i in range(b):
                if active[i] or not queue:
                    continue
                req = queue[0]
                if self._cost is not None and not self._cost.admit_ok(int(active.sum())):
                    if req.rid not in deferred_logged:
                        deferred_logged.add(req.rid)
                        events.append(("defer", req.rid, -1, steps))
                    break
                st = stats[req.rid]
                st.admit_start = now()
                if self._paged:
                    admitted = self._admit_paged(i, req, st)
                    if admitted is None:
                        if not active.any():
                            raise ValueError(
                                f"request {req.rid} needs more pages than the "
                                f"pool can ever supply ({cfg.total_pages} pages "
                                f"incl. the garbage page)"
                            )
                        if req.rid not in deferred_logged:
                            deferred_logged.add(req.rid)
                            events.append(("defer", req.rid, -1, steps))
                        break
                else:
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
            # One step for ALL slots: inactive slots run garbage tokens at
            # stale positions (harmless by the mask argument; paged, their
            # zero table rows send every write to the garbage page), so the
            # step's shape never changes with occupancy.
            busy_slot_steps += int(active.sum())
            emitted, n_emit = self._step(last, pos)
            steps += 1
            t_step = now()
            for i in range(b):
                if not active[i]:
                    continue
                st = stats[slot_rid[i]]
                done = False
                committed = 0
                for tok in emitted[i, : int(n_emit[i])]:
                    tok = int(tok)
                    st.tokens.append(tok)
                    st.token_times.append(t_step)
                    committed += 1
                    if st.first_token is None:
                        st.first_token = t_step
                    pos[i] += 1
                    last[i] = tok
                    remaining[i] -= 1
                    if remaining[i] <= 0 or (
                        cfg.eos_token is not None and tok == cfg.eos_token
                    ):
                        done = True
                        break
                if self._spec is not None:
                    # Draft tokens actually COMMITTED (the last commit is
                    # the target's bonus or correction token).
                    events.append(("spec", int(slot_rid[i]), i, steps, committed - 1))
                if done:
                    st.finished = t_step
                    active[i] = False
                    events.append(("evict", int(slot_rid[i]), i, steps))
                    slot_rid[i] = -1
                    self._release_slot(i)
                elif t_step > slot_deadline[i]:
                    st.expired = t_step
                    active[i] = False
                    events.append(("expire", int(slot_rid[i]), i, steps))
                    slot_rid[i] = -1
                    self._release_slot(i)
        pool_stats = None
        if self._pool is not None:
            pool_stats = {
                "prefix_hits": self._pool.prefix_hits,
                "pages_reused": self._pool.pages_reused,
                "retained_evictions": self._pool.retained_evictions,
            }
        return ServeReport(
            requests=stats, events=events, decode_steps=steps,
            wall_time=now(), peak_queue_depth=peak_queue,
            busy_slot_steps=busy_slot_steps, slots=b, pool_stats=pool_stats,
        )
