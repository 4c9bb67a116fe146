"""Roofline scoring of pruned candidates (the port of
``tpudml/plan/score.py``: the same terms, in the same order of
arithmetic, so that under equal constants the scores are JAX's to the
bit).

Three priced terms per candidate, all per device per optimizer step and
all for the *fixed global workload* (``spec.global_batch(world)`` rows —
accumulation splits that batch into micro-batches, it never adds rows):

- **compute**: dense-matmul FLOPs ``6·params·tokens`` plus the
  quadratic attention term, divided by every mesh axis that splits the
  work (data shards rows, model shards features, stage shards layers —
  the stage axis additionally pays the pipeline bubble ``(M+S-1)/M``);
- **memory**: weight streaming (fwd + bwd + update), optimizer-state
  update traffic (sharded 1/N under ZeRO-1/FSDP — the whole point of
  those regimes), and the logits round-trip the fused xent kernel
  avoids materializing;
- **comm**: explicit collectives priced on the shared ring wire model
  (``tpudml_torch.comm.timing.collective_wire_bytes`` — the same table
  the measured ``CommStats`` counters and the verification's
  ``wire_meter`` use), with
  overlap attribution: ZeRO-1's param all_gather counts as *hidden*
  when ``zero1_overlap`` double-buffers it behind the micro-batch scan
  (priced from the same exposed-vs-hidden split ``overlap_report()``
  measures), exposed otherwise.

``step_time = max(compute, memory) + exposed_comm`` — the roofline max
for the overlappable device work, plus the comm the schedule cannot
hide.  Ranking metric is per-token time so candidates with different
meshes stay comparable.

The constants (:data:`DEFAULT_HARDWARE`) are the card's: an H100 80GB
HBM3 (SXM, 700 W) from its data sheet. Absolute seconds are not the
contract — *rank order* is. ``score_candidate(hw=)`` takes other
constants (the tests score with the JAX package's to compare the two
planners byte for byte).
"""

from __future__ import annotations

from dataclasses import asdict, dataclass

from tpudml_torch.comm.timing import collective_wire_bytes
from tpudml_torch.parallel.overlap import OVERLAP_CHUNKS
from tpudml_torch.plan.space import Candidate, ModelSpec

#: Micro-batch count the planner assumes for PP×DP (GPipe) candidates.
PP_MICROBATCHES = 4

#: Fraction of optimizer-state bytes moved per update (read p/m/v,
#: write p/m/v, plus the gradient read) — AdamW-shaped.
_UPDATE_TRAFFIC_FACTOR = 7.0

#: Sentinel / obs knobs add a small in-graph overhead (an is-finite
#: reduction / telemetry counters) — real but tiny; priced as a
#: multiplicative epsilon so knob-on never beats knob-off on ties.
_SENTINEL_OVERHEAD = 0.01
_OBS_OVERHEAD = 0.005


@dataclass(frozen=True)
class Hardware:
    """The device constants the roofline divides by. The defaults are an
    H100 80GB HBM3 (SXM, 700 W) data sheet's: f32 outside the tensor
    cores (the port's f32 kernels use no TF32), HBM3, and NVLink 4 in
    one direction."""

    flops_per_s: float = 67e12
    hbm_bytes_per_s: float = 3.35e12
    ici_bytes_per_s: float = 4.5e11


DEFAULT_HARDWARE = Hardware()


@dataclass(frozen=True)
class Calibration:
    """Measured correction factors folded into the roofline terms.

    The self-calibrating half of the planner loop: when the drift
    monitor (``obs/drift.py``) observes measured comm or
    HBM deviating from the static model past the shared threshold, the
    re-plan re-scores the lattice with these scales applied — the cost
    model learns the constant it was wrong by instead of ranking with
    it forever.  ``basis`` keeps the drift records the scales were
    fitted from, so a plan's ``calibration`` block is auditable.
    """

    comm_scale: float = 1.0
    hbm_scale: float = 1.0
    source: str = "default"
    basis: tuple = ()  # tuple of drift-record dicts (sorted-key frozen)

    @classmethod
    def from_drift_records(cls, records, source: str = "obs/drift") -> "Calibration":
        """Fit ``comm_scale`` as the wire-byte-weighted measured/static
        ratio over the drift records — the single multiplicative
        constant that would zero the aggregate drift."""
        static = sum(float(r["static_wire_bytes"]) for r in records)
        measured = sum(float(r["measured_wire_bytes"]) for r in records)
        scale = measured / static if static > 0 else 1.0
        basis = tuple(
            {
                "entrypoint": r["entrypoint"],
                "static_wire_bytes": float(r["static_wire_bytes"]),
                "measured_wire_bytes": float(r["measured_wire_bytes"]),
                "rel_err": float(r["rel_err"]),
            }
            for r in records
        )
        return cls(comm_scale=scale, source=source, basis=basis)

    def to_dict(self) -> dict:
        return {
            "comm_scale": self.comm_scale,
            "hbm_scale": self.hbm_scale,
            "source": self.source,
            "basis": [dict(b) for b in self.basis],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Calibration":
        return cls(
            comm_scale=d["comm_scale"],
            hbm_scale=d["hbm_scale"],
            source=d["source"],
            basis=tuple(d.get("basis", ())),
        )


@dataclass(frozen=True)
class Score:
    """Priced candidate: the ranked table row and plan.json record."""

    step_time_s: float
    compute_s: float
    memory_s: float
    exposed_comm_s: float
    hidden_comm_s: float
    comm_wire_bytes: float
    est_hbm_bytes: int
    tokens_per_step: int

    @property
    def per_token_s(self) -> float:
        return self.step_time_s / self.tokens_per_step

    def to_dict(self) -> dict:
        d = asdict(self)
        d["per_token_s"] = self.per_token_s
        return d


def _axes(cand: Candidate) -> tuple:
    m = cand.mesh_dict
    return m.get("data", 1), m.get("model", 1), m.get("stage", 1)


def estimate_hbm(spec: ModelSpec, cand: Candidate) -> int:
    """Static per-chip peak-live estimate (the closed-form preview the
    prune pass can afford for every candidate; the verification step
    measures the allocator's peak on the card).

    params + grads + optimizer moments under the candidate's sharding,
    plus the live activation working set and — unless the fused kernel
    streams them — the materialized [B, T, V] logits.
    """
    data, model, stage = _axes(cand)
    p_bytes = spec.param_count() * spec.dtype_bytes
    # Parameter residency: TP/stage shard structurally; FSDP shards
    # over data too; ZeRO-1 shards only the optimizer moments.
    param_div = model * stage * (data if cand.engine in ("fsdp", "fsdp_tp") else 1)
    opt_div = model * stage * (
        data if (cand.zero1 or cand.engine in ("fsdp", "fsdp_tp")) else 1
    )
    params = p_bytes / param_div
    grads = p_bytes / param_div
    moments = 2 * p_bytes / opt_div
    rows = spec.global_batch(_world(cand)) // data
    micro_rows = max(1, rows // max(1, cand.accum_steps))
    if cand.engine == "pp_dp":
        micro_rows = max(1, rows // PP_MICROBATCHES)
    act = (
        spec.num_layers
        * micro_rows
        * spec.seq_len
        * spec.embed_dim
        * spec.dtype_bytes
        * 12  # qkv/attn/mlp residual working set per layer
    ) / (model * stage)
    logits = 0.0
    if not cand.fused_xent:
        logits = micro_rows * spec.seq_len * spec.vocab_size * spec.dtype_bytes / model
    return int(params + grads + moments + act + logits)


def _world(cand: Candidate) -> int:
    w = 1
    for _, s in cand.mesh:
        w *= s
    return w


def score_candidate(
    spec: ModelSpec,
    cand: Candidate,
    hw: Hardware = DEFAULT_HARDWARE,
    calibration: Calibration | None = None,
) -> Score:
    data, model, stage = _axes(cand)
    world = _world(cand)
    n_params = spec.param_count()
    p_bytes = n_params * spec.dtype_bytes
    rows = spec.global_batch(world)
    tokens = rows * spec.seq_len

    # ---- compute: every mesh axis divides the matmul work; the stage
    # axis pays the GPipe bubble on top.
    flops = 6.0 * n_params * tokens
    flops += 12.0 * spec.num_layers * rows * spec.seq_len**2 * spec.embed_dim
    flops /= data * model * stage
    compute_s = flops / hw.flops_per_s
    if stage > 1:
        m = PP_MICROBATCHES
        compute_s *= (m + stage - 1) / m

    # ---- memory: weight streaming + sharded update + logits traffic.
    weight_div = model * stage
    opt_div = model * stage * (
        data if (cand.zero1 or cand.engine in ("fsdp", "fsdp_tp")) else 1
    )
    traffic = 3.0 * p_bytes / weight_div  # fwd read, bwd read, grad write
    traffic += _UPDATE_TRAFFIC_FACTOR * 3.0 * p_bytes / opt_div
    if not cand.fused_xent:
        # materialize + re-read the [B, T, V] logits around the softmax
        traffic += 3.0 * (rows // data) * spec.seq_len * spec.vocab_size \
            * spec.dtype_bytes / model
    memory_s = traffic / hw.hbm_bytes_per_s

    # ---- comm: ring wire model, per device, with overlap attribution.
    exposed = 0.0
    hidden = 0.0
    accum = max(1, cand.accum_steps)
    if cand.engine == "dp":
        exposed += collective_wire_bytes("psum", p_bytes, data)
    elif cand.engine == "zero1":
        exposed += collective_wire_bytes("psum_scatter", p_bytes, data)
        gather = collective_wire_bytes("all_gather", p_bytes / data, data)
        if cand.zero1_overlap and accum >= 2:
            hidden += gather  # double-buffered behind the micro scan
        else:
            exposed += gather
    elif cand.engine in ("fsdp", "fsdp_tp"):
        shard = p_bytes / (model * data)
        # params re-gathered on use, per micro-batch, fwd + bwd
        exposed += 2 * accum * collective_wire_bytes("all_gather", shard, data)
        exposed += collective_wire_bytes("psum_scatter", p_bytes / model, data)
    elif cand.engine == "pp_dp":
        micro_rows = max(1, rows // data // PP_MICROBATCHES)
        boundary = micro_rows * spec.seq_len * spec.embed_dim * spec.dtype_bytes
        # activations fwd + grads bwd across each stage boundary
        exposed += 2 * PP_MICROBATCHES * (stage - 1) / stage \
            * collective_wire_bytes("ppermute", boundary, stage)
        exposed += collective_wire_bytes("psum", p_bytes / stage, data)
    if model > 1:
        # TP: two psums per block per direction of [B_dev, T, d] acts.
        act = (rows // data) * spec.seq_len * spec.embed_dim * spec.dtype_bytes
        tp_wire = 4 * spec.num_layers * collective_wire_bytes("psum", act, model)
        if cand.tp_overlap:
            # Chunked collective-matmul placement (parallel/overlap.py):
            # chunk i's psum rides under chunk i+1's matmul, so only the
            # last chunk's reduce (1/K of the wire) stays exposed — the
            # same exposed-vs-hidden attribution the zero1_overlap
            # branch uses for its double-buffered gather.
            exposed += tp_wire / OVERLAP_CHUNKS
            hidden += tp_wire * (OVERLAP_CHUNKS - 1) / OVERLAP_CHUNKS
        else:
            exposed += tp_wire
        if cand.fused_xent:
            # vocab-sharded head: online lse-merge statistics, [B_dev, T]
            stats = 3 * (rows // data) * spec.seq_len * spec.dtype_bytes
            exposed += collective_wire_bytes("psum", stats, model)
    comm_scale = calibration.comm_scale if calibration is not None else 1.0
    hbm_scale = calibration.hbm_scale if calibration is not None else 1.0
    exposed_s = exposed * comm_scale / hw.ici_bytes_per_s
    hidden_s = hidden * comm_scale / hw.ici_bytes_per_s

    step = max(compute_s, memory_s) + exposed_s
    if cand.sentinel:
        step *= 1.0 + _SENTINEL_OVERHEAD
    if cand.obs:
        step *= 1.0 + _OBS_OVERHEAD
    return Score(
        step_time_s=step,
        compute_s=compute_s,
        memory_s=memory_s,
        exposed_comm_s=exposed_s,
        hidden_comm_s=hidden_s,
        comm_wire_bytes=(exposed + hidden) * comm_scale,
        est_hbm_bytes=int(estimate_hbm(spec, cand) * hbm_scale),
        tokens_per_step=tokens,
    )
