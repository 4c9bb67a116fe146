"""The port's copy of the engine-composition rejections that its engines
raise (the rows of ``tpudml/capabilities.py`` that ``DataParallel``,
``GSPMDParallel``, the pipelines, ``ZeRO1``, ``tp_overlap_matmul``, task5
``--parallel ep`` and ``pp``, the serving engine and ``TPServing`` check, with the JAX wording; the
planner's full table is ROADMAP.md queue 1 item 10).

Guard sites call :func:`reject` with an entry's key instead of writing
the message; each entry keeps its ``when`` predicate over a flat
candidate dict, as in the JAX table. Stdlib only.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional


class CompositionError(ValueError):
    """An engine/knob combination that is rejected by design.

    Subclasses ``ValueError`` so every pre-existing ``pytest.raises``
    and caller-side ``except ValueError`` keeps working.
    """


# Engine families the predicates reason over. ``zero1`` is the DP
# engine with zero1=True; fsdp/tp/fsdp_tp all construct GSPMDParallel.
_DP_FAMILY = ("dp", "zero1")
_GSPMD_FAMILY = ("tp", "fsdp", "fsdp_tp")


def _g(c: dict, key: str, default=None):
    return c.get(key, default)


@dataclass(frozen=True)
class Capability:
    """One composition rejection: where it is enforced, the exact
    message the runtime raises, and (when statically decidable) the
    predicate the planner prunes with."""

    key: str
    owner: str  # module(s) whose constructor raises it
    message: str
    when: Optional[Callable[[dict], bool]] = None


_ENTRIES = (
    Capability(
        key="save_scores_needs_fused_xent",
        owner="tpudml_torch.parallel.dp",
        message="save_scores requires fused_xent=True",
        when=lambda c: bool(_g(c, "save_scores")) and not _g(c, "fused_xent"),
    ),
    Capability(
        key="dp_fused_xent_split_step",
        owner="tpudml_torch.parallel.dp",
        message=(
            "fused_xent composes with the fused step and the "
            "built-in cross-entropy only (measure_comm=False, "
            "default loss)"
        ),
        when=lambda c: _g(c, "engine") in _DP_FAMILY
        and bool(_g(c, "fused_xent"))
        and bool(_g(c, "measure_comm") or _g(c, "custom_loss")),
    ),
    Capability(
        key="gspmd_fused_xent_accum",
        owner="tpudml_torch.parallel.mp",
        message=(
            "fused_xent composes with the fused LM step and the built-in "
            "cross-entropy only (no accum_steps, no custom loss)"
        ),
        when=lambda c: _g(c, "engine") in _GSPMD_FAMILY
        and bool(_g(c, "fused_xent"))
        and _g(c, "schedule", "gpipe") == "gpipe",
    ),
    Capability(
        key="pp_zero1_needs_batch_axis",
        owner="tpudml_torch.parallel.pp",
        message=(
            "a ZeRO1 optimizer needs a data axis to shard the "
            "update over: pass batch_axis (PP×DP composition)"
        ),
        when=lambda c: _g(c, "engine") == "pp_dp"
        and bool(_g(c, "zero1"))
        and not _g(c, "mesh", {}).get("data"),
    ),
    Capability(
        key="pp_fused_xent",
        owner="tpudml_torch.tasks.task5_longcontext",
        message=(
            "--fused_xent does not compose with --parallel pp: the "
            "pipeline epilogue ships logits between stages, so there "
            "is no feature tensor for the fused head to consume"
        ),
        when=lambda c: _g(c, "engine") == "pp_dp" and bool(_g(c, "fused_xent")),
    ),
    Capability(
        key="pp_moe",
        owner="tpudml_torch.tasks.task5_longcontext",
        message="--parallel pp does not support --moe_experts",
        when=lambda c: _g(c, "engine") == "pp_dp"
        and bool(_g(c, "moe_experts")),
    ),
    Capability(
        key="gpipe_dropout",
        owner="tpudml_torch.parallel.pp",
        message=(
            "GPipe stages do not support dropout; use OneFOneB "
            "(schedule='1f1b') with rng_root for dropout pipelines"
        ),
        when=lambda c: _g(c, "engine") == "pp_dp"
        and bool(_g(c, "dropout"))
        and _g(c, "schedule", "gpipe") == "gpipe",
    ),
    Capability(
        key="zero1_stacked_clip",
        owner="tpudml_torch.optim.zero1",
        message=(
            "ZeRO1(stacked=...) cannot wrap a ClipByGlobalNorm chain: "
            "stage-stacked chunks shard over two mesh axes and the "
            "clip's single-psum norm would double-count or miss shards"
        ),
        when=lambda c: _g(c, "engine") == "pp_dp"
        and bool(_g(c, "zero1"))
        and bool(_g(c, "grad_clip")),
    ),
    Capability(
        key="zero1_overlap_needs_zero1",
        owner="tpudml_torch.parallel.dp",
        message="zero1_overlap requires zero1=True",
        when=lambda c: bool(_g(c, "zero1_overlap")) and not _g(c, "zero1"),
    ),
    Capability(
        key="zero1_replaces_aggregation",
        owner="tpudml_torch.parallel.dp",
        message=(
            "zero1=True replaces gradient aggregation with its own "
            "reduce-scatter; leave aggregation='allreduce' (the default)"
        ),
        when=lambda c: bool(_g(c, "zero1"))
        and _g(c, "aggregation", "allreduce") != "allreduce",
    ),
    Capability(
        key="zero1_overlap_needs_accum",
        owner="tpudml_torch.parallel.dp",
        message=(
            "zero1_overlap needs accum_steps >= 2: the overlap hides "
            "the param all_gather behind the micro-batch scan"
        ),
        when=lambda c: bool(_g(c, "zero1_overlap"))
        and bool(_g(c, "zero1"))
        and _g(c, "accum_steps", 1) < 2,
    ),
    Capability(
        key="zero1_overlap_measure_comm",
        owner="tpudml_torch.parallel.dp",
        message=(
            "measure_comm is unsupported with zero1_overlap (the "
            "split bracketing assumes the gather-at-end step layout); "
            "use overlap_report() for exposed/hidden attribution"
        ),
        when=lambda c: bool(_g(c, "zero1_overlap"))
        and bool(_g(c, "zero1"))
        and bool(_g(c, "measure_comm")),
    ),
    Capability(
        key="zero1_optimizer_needs_zero1",
        owner="tpudml_torch.parallel.dp",
        message=(
            "a ZeRO1-wrapped optimizer needs zero1=True (the "
            "engine must shard the optimizer state it creates)"
        ),
        when=None,  # constructor invariant: the planner never pre-wraps
    ),
    Capability(
        key="ep_dropout",
        owner="tpudml_torch.tasks.task5_longcontext",
        message="--parallel ep does not support --dropout",
        when=lambda c: _g(c, "engine") == "ep" and bool(_g(c, "dropout")),
    ),
    Capability(
        key="train_flash_attn_dense",
        owner="tpudml_torch.parallel.dp",
        message=(
            "flash_attn swaps the dense causal trunk onto the Pallas "
            "flash kernel; it requires impl='full' (ring/ulysses trunks "
            "already run fused sequence-sharded attention) and "
            "seq_sharded=False"
        ),
        when=lambda c: bool(_g(c, "flash_attn"))
        and (
            _g(c, "impl", "full") != "full" or bool(_g(c, "seq_sharded"))
        ),
    ),
    Capability(
        key="tp_overlap_needs_model_axis",
        owner="tpudml_torch.parallel.overlap",
        message=(
            "tp_overlap chunks a row-sharded matmul against its psum; "
            "without a model axis of size > 1 there is no reduce to "
            "hide — run the unchunked matmul"
        ),
        when=lambda c: bool(_g(c, "tp_overlap"))
        and _g(c, "mesh", {}).get("model", 1) <= 1,
    ),
    Capability(
        key="serve_fused_head_dense",
        owner="tpudml_torch.serve.engine",
        message=(
            "fused_head folds the greedy pick into the head matmul "
            "epilogue of the dense single-device decode step only: the "
            "paged/spec steps consume full logits windows and TP "
            "shards the head — run those unfused"
        ),
        when=lambda c: bool(_g(c, "serve_fused_head"))
        and (
            bool(_g(c, "serve_tp"))
            or _g(c, "serve_cache_layout", "dense") != "dense"
            or _g(c, "serve_spec_k", 0) > 0
        ),
    ),
    Capability(
        key="serve_tp_paged_spec",
        owner="tpudml_torch.serve.engine",
        message=(
            "tensor-parallel serving does not compose with "
            "cache_layout='paged' or spec_k>0 yet; run TP dense, or "
            "paged/spec single-device"
        ),
        when=lambda c: bool(_g(c, "serve_tp"))
        and (
            _g(c, "serve_cache_layout", "dense") == "paged"
            or _g(c, "serve_spec_k", 0) > 0
        ),
    ),
    Capability(
        key="serve_tp_weight_quant",
        owner="tpudml_torch.serve.engine",
        message=(
            "tensor-parallel serving does not compose with "
            "weight_quant: shard_params knows nothing of int8 kernels "
            "+ scale trees; quantize single-device replicas"
        ),
        when=lambda c: bool(_g(c, "serve_tp"))
        and _g(c, "serve_weight_quant") is not None,
    ),
    Capability(
        key="serve_tp_dense_only",
        owner="tpudml_torch.serve.tp",
        message=(
            "TPServing supports cache_layout='dense' with spec_k=0 "
            "only; paged/speculative serving is single-device"
        ),
        when=lambda c: bool(_g(c, "serve_tp"))
        and (
            _g(c, "serve_cache_layout", "dense") != "dense"
            or _g(c, "serve_spec_k", 0) > 0
        ),
    ),
)

TABLE: dict[str, Capability] = {e.key: e for e in _ENTRIES}
assert len(TABLE) == len(_ENTRIES), "duplicate capability keys"


def reject(key: str, exc: type = CompositionError):
    """Raise the capability table's rejection for ``key``.

    Guard sites call this instead of inlining the message; ``exc`` lets
    a site raise a subclass of :class:`CompositionError`.
    """
    raise exc(TABLE[key].message)
