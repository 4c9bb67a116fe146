"""Finding model and rule registry of the static-analysis suite (the port
of ``tpudml/analysis/findings.py``: the rule ids, severities, contracts
and hints are JAX's, so a finding of either package reads the same).

Every rule has a stable id (J1xx = jaxpr pass, A2xx = AST pass, P3xx =
cross-rank protocol pass — P304 is AST-hosted), a severity, and a
one-line contract. Findings carry file:line provenance —
the jaxpr pass pulls it from equation ``source_info`` (so a hazard inside
a traced step still points at the Python line that built it), the AST
pass from the node. The committed allowlist (``allowlist.toml``) matches
on (rule, path[, line]) and is how triaged true-but-accepted findings
stay visible without failing ``--strict`` CI.
"""

from __future__ import annotations

from dataclasses import dataclass


ERROR = "error"
WARN = "warn"
INFO = "info"

_SEV_ORDER = {ERROR: 0, WARN: 1, INFO: 2}

#: rule id -> (severity, one-line description)
RULES: dict[str, tuple[str, str]] = {
    "J100": (ERROR, "entrypoint failed to trace (abstract evaluation error)"),
    "J101": (ERROR, "collective axis name not bound by an enclosing "
                    "shard_map/pmap"),
    "J102": (WARN, "cond/switch branches issue different collective "
                   "sequences (multi-host deadlock hazard)"),
    "J103": (WARN, "host callback primitive inside a jitted step"),
    "J104": (INFO, "bf16 value upcast to f32 outside an accumulation site"),
    "J105": (WARN, "large constant (>1 MiB) captured by closure instead of "
                   "passed as an argument"),
    "J106": (WARN, "large training-state buffers are never donated"),
    "J107": (WARN, "unsharded fused cross-entropy head consumes a "
                   "vocab-sharded kernel (per-shard softmax is wrong)"),
    "J108": (INFO, "replicated (unsharded) optimizer update under shard_map "
                   "on a data axis with no reduce-scatter (every chip pays "
                   "the full update)"),
    "J109": (WARN, "ragged_dot's E-scaled grouped-transpose dW in the "
                   "backward (E× the dense dW FLOPs via masked [E, P, ·] "
                   "broadcasts)"),
    "J110": (WARN, "decode-marked program recomputes full-sequence "
                   "attention per emitted token (O(T²) softmax inside the "
                   "per-token step)"),
    "J111": (INFO, "optimizer update consumes gradients with no finiteness "
                   "predicate anywhere in the step (one NaN microbatch "
                   "poisons the weights unrecoverably)"),
    "J112": (ERROR, "shard_map output declared replicated over an axis the "
                    "body value varies on (missing psum / lost transpose "
                    "factor under check_rep=False)"),
    "J113": (ERROR, "while loop trip count varies per shard while its "
                    "body/cond issue collectives over the same axis "
                    "(collective imbalance: the slice deadlocks)"),
    "J114": (ERROR, "donated buffer consumed again after the donating call "
                    "(XLA may have aliased the memory away)"),
    "J115": (INFO, "allreduce (psum) whose result is consumed only by "
                   "per-shard slices (a psum_scatter moves ~half the "
                   "bytes)"),
    "J116": (WARN, "static peak-live-buffer estimate exceeds the configured "
                   "HBM budget"),
    "J117": (WARN, "paged-decode-marked program attends over the FULL page "
                   "pool per token (softmax keyed on num_pages·page_size "
                   "rows instead of the slot's max_pages table rows)"),
    "J118": (WARN, "traced collectives/HBM deviate >10% from the emitted "
                   "plan's predicted cost (the plan.json no longer "
                   "describes the program that runs)"),
    "J119": (WARN, "decode-marked program materializes the full-vocab "
                   "logits row and argmaxes it outside the head matmul "
                   "(the [B, V] tail round-trips HBM every token), or a "
                   "program claims psum-overlapped TP matmuls without the "
                   "overlap marker"),
    "P300": (ERROR, "p2p frame sent with (edge, mb, tag, rows) that no peer "
                    "schedule receives, or vice versa (boundary schedule "
                    "asymmetry)"),
    "P301": (ERROR, "wait-for cycle across ranks: the composed 1F1B/vote/"
                    "collective schedules cannot all run to completion "
                    "(cross-rank deadlock)"),
    "P302": (ERROR, "ranks of one stage group issue different (op, axis, "
                    "shape) collective sequences (cross-rank J102: gloo "
                    "deadlocks, it does not diagnose)"),
    "P303": (WARN, "schedule reaches a stage-group collective with no "
                   "preceding drain vote (a membership event mid-step parks "
                   "the group in gloo instead of draining)"),
    "P304": (INFO, "port-reservation discipline: bind-and-hold released "
                   "before the wiring is committed, or a listening socket "
                   "leaked on an error path"),
    "A201": (WARN, "Python for/if over a traced (jnp/lax) value"),
    "A202": (WARN, "jax.random key consumed more than once without split"),
    "A203": (WARN, "epoch loop iterates a loader without set_epoch"),
    "A204": (WARN, "host-clock timing without block_until_ready bracket"),
}

HINTS: dict[str, str] = {
    "J100": "run the entrypoint eagerly under JAX_PLATFORMS=cpu to reproduce",
    "J101": "name the axis in the enclosing shard_map mesh / pmap axis_name",
    "J102": "hoist the collective out of the branches (or issue it in both)",
    "J103": "drop jax.debug.* / callbacks from production steps; they "
            "force host sync every step",
    "J104": "cast back to bf16 after the reduction, or wrap the site in an "
            "explicit accumulation (this rule allowlists cleanly)",
    "J105": "pass the array as a (donated) argument so XLA can alias it",
    "J106": "jit the step with donate_argnums on the TrainState",
    "J107": "use sharded_linear_cross_entropy(axis_name=...) so per-shard "
            "(lse, picked) statistics merge before the loss",
    "J108": "shard the weight update: DataParallel(zero1=True) / "
            "optim.ZeRO1 reduce-scatters grads and updates a 1/N shard",
    "J109": "route the ragged FFN through ops.moe_kernel.ragged_ffn "
            "(MoELayer ragged_dw='grouped'): grouped-dW accumulates each "
            "expert's contiguous slab at cost ∝ tokens",
    "J110": "carry a KV cache through the decode loop "
            "(serve.ServingEngine / TransformerLM.apply_decode) so each "
            "step attends [B, H, 1, L] over cached K/V",
    "J111": "wrap the optimizer with resilience.attach_sentinel (engines: "
            "sentinel=True) so non-finite steps are skipped in-graph with "
            "the previous state carried forward bit-exactly",
    "J112": "reduce before returning: psum/all_gather the shard-local "
            "value over the axis (or declare the output sharded in "
            "out_specs if per-shard results are intended)",
    "J113": "derive the loop predicate from a reduced value (psum/pmax of "
            "the local condition) so every shard agrees on the trip count",
    "J114": "thread the updated value out of the donating call instead of "
            "reusing the donated input (donate_argnums aliases its buffer)",
    "J115": "replace psum+dynamic_slice(axis_index) with psum_scatter: "
            "each shard receives exactly the piece it keeps",
    "J116": "shard or rematerialize the largest live buffers, or raise "
            "--hbm_budget if the estimate is for a larger part",
    "J117": "gather K/V through the slot's page table "
            "(serve.paged.read_table: pool[table] → [B, max_pages·P, ...]) "
            "so attention cost scales with per-slot capacity, not pool "
            "size",
    "J118": "re-plan (python -m tpudml.plan) so plan.json matches the "
            "current program, or allowlist the entry with the reason the "
            "drift is intended",
    "J119": "serve with ServeConfig(fused_head=True) so the head matmul, "
            "greedy pick, and step stats run as one vocab-tiled program "
            "(ops.fused_decode_head); for the overlap half, route the "
            "claimed matmul through parallel.overlap.tp_overlap_matmul "
            "(which carries the marker) or drop the claim",
    "P300": "re-derive both sides from the same boundary_plan(spec, b) — "
            "the (step, mb, edge) framing only works when sender and "
            "receiver enumerate the identical transfer list",
    "P301": "keep per-channel sends/recvs in plan-index order and the "
            "vote+collective tail after all p2p (the StageWorker.run_step "
            "order); check warmup_microbatches feeds enough rows downstream",
    "P302": "trace every rank of the group from the same StageProgram — "
            "per-rank model code must keep the collective sequence "
            "identical (hoist divergent collectives out, as for J102)",
    "P303": "vote on the DrainBarrier before entering the GroupReducer "
            "allreduce so a dead peer drains the group at the barrier",
    "P304": "hold port reservations until write_wiring has committed the "
            "topology, and close (or hand off) listening sockets in a "
            "finally block",
    "A201": "use lax.cond/lax.fori_loop/jnp.where, or materialize with "
            "float(...) first if this is host-side code",
    "A202": "key, sub = jax.random.split(key) before the second use",
    "A203": "call loader.set_epoch(epoch) so shuffles differ per epoch",
    "A204": "jax.block_until_ready(...) before reading the second clock",
}


@dataclass(frozen=True)
class Finding:
    """One diagnostic: rule id + provenance + human-readable message."""

    rule: str
    message: str
    file: str = ""
    line: int = 0
    entrypoint: str = ""  # jaxpr pass: which traced step surfaced it

    @property
    def severity(self) -> str:
        return RULES.get(self.rule, (WARN, ""))[0]

    @property
    def hint(self) -> str:
        return HINTS.get(self.rule, "")

    def location(self) -> str:
        if self.file and self.line:
            return f"{self.file}:{self.line}"
        return self.file or (f"<{self.entrypoint}>" if self.entrypoint else "?")

    def format(self) -> str:
        ep = f" [{self.entrypoint}]" if self.entrypoint else ""
        out = (f"{self.rule} {self.severity:5s} {self.location()}{ep}: "
               f"{self.message}")
        if self.hint:
            out += f"\n      hint: {self.hint}"
        return out


def sort_findings(findings: list[Finding]) -> list[Finding]:
    return sorted(
        findings,
        key=lambda f: (_SEV_ORDER.get(f.severity, 9), f.rule, f.file, f.line),
    )
