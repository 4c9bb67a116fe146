"""Plan emission: rank the survivors, build and verify the winner,
serialize the runnable ``plan.json`` (v2 schema) (the port of
``tpudml/plan/emit.py``).

``make_plan`` is the whole pipeline. Self-verification is the
load-bearing part: the winning candidate is constructed as a *real*
engine of the port (the classes the tasks instantiate) in the job it
would run in, and one train step of it runs on the seeded batch. JAX
traces the step to a jaxpr and runs the dataflow rules J112–J116 over it;
the port's processes are real ranks and its steps are eager, so it
measures the step instead (:func:`verify_candidate`): the loss and every
updated parameter finite, every replicated parameter equal on every rank
after the step (a lost reduction shows here), and on the card the step's
allocator peak within the HBM budget. A winner with a finding is demoted
before it is ever emitted, and the next-ranked survivor is tried. The
step also stamps the plan's ``predicted`` block: the ring-model wire
bytes of the collectives the step issued (``comm.collectives.
wire_meter``) and the peak bytes.

plan.json v2 schema (all byte-deterministic — no timestamps, sorted
keys)::

    {
      "version": 2,
      "world": int,
      "spec": ModelSpec.to_dict(),
      "hbm_budget_bytes": int | null,
      "winner": {"candidate": {...}, "score": {...}},
      "engine_config": {... flat knobs train/task wiring consumes ...},
      "ranking": [{"candidate", "score"}, ...],          # survivors, best first
      "pruned": [{"candidate", "rule", "reason"}, ...],  # every drop, with why
      "predicted": {"comm_wire_bytes": float, "peak_hbm_bytes": int},
      "verification": {"entrypoint", "ok", "findings": [...],
                       "demoted": [...]},                # winners that failed
      "calibration": null | Calibration.to_dict(),       # measured constants
      "replan": null | {"trigger", "why", "old_world",   # re-plan provenance
                        "old_winner", "receipts": [...]}
    }

``calibration`` holds the measured scales a drift-triggered re-score
folded into the roofline (null for a plan scored on the nominal
constants) and ``replan`` the provenance of an adaptive re-plan (null for
a plan made fresh). ``load_plan`` still reads v1 files, upgrading them
in memory with both keys null. With ``verify=False`` a plan is the JAX
package's byte for byte under the same hardware constants.
"""

from __future__ import annotations

import gc
import json
import tempfile
import time
from contextlib import contextmanager

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from tpudml_torch.plan.prune import prune
from tpudml_torch.plan.score import (
    DEFAULT_HARDWARE, PP_MICROBATCHES, estimate_hbm, score_candidate,
)
from tpudml_torch.plan.space import Candidate, ModelSpec, enumerate_candidates

PLAN_VERSION = 2

#: Versions ``load_plan`` accepts; older ones are upgraded in-memory.
SUPPORTED_PLAN_VERSIONS = (1, 2)

#: The verification's finding rules (the port's stand-ins for J112–J116).
VERIFY_RULES = {
    "nonfinite_loss": "the step's loss is not finite",
    "nonfinite_param": "a parameter is not finite after the step",
    "replicas_differ": "a replicated parameter differs between ranks after the step",
    "over_hbm_budget": "the step's allocator peak exceeds the HBM budget",
}


def _world(cand: Candidate) -> int:
    w = 1
    for _, s in cand.mesh:
        w *= s
    return w


def _job_message(world: int, have: int) -> str:
    return (f"plan verification needs a job of {world} ranks, have {have} — run it in "
            f"one: python -m tpudml_torch.launch -n {world} [--platform cpu] -- "
            f"python -m tpudml_torch.plan --world {world}")


def _device(device) -> torch.device:
    from tpudml_torch.device import default_device, resolve_device

    return resolve_device(device if device is not None else default_device())


def _model(spec: ModelSpec, device: torch.device):
    from tpudml_torch.models import TransformerLM

    return TransformerLM(
        vocab_size=spec.vocab_size,
        embed_dim=spec.embed_dim,
        num_heads=spec.num_heads,
        num_layers=spec.num_layers,
        max_len=spec.seq_len,
        impl="full",
        rope=True,
        device=device,
        generator=torch.Generator().manual_seed(0),
    )


def _batch(spec: ModelSpec, world: int):
    rng = np.random.default_rng(0)
    rows = spec.global_batch(world)
    seqs = rng.integers(
        0, spec.vocab_size, size=(rows, spec.seq_len + 1)
    ).astype(np.int32)
    return seqs[:, :-1], seqs[:, 1:]


class _Blocks(nn.Module):
    """A pipeline stage of several decoder blocks (JAX's ``Sequential`` of
    blocks): each block's output tensor feeds the next."""

    def __init__(self, blocks):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x):
        for b in self.blocks:
            x = b(x)[0]
        return x


def build_candidate(spec: ModelSpec, cand: Candidate, device=None):
    """Instantiate the candidate as a real engine of the port, in the
    current job (whose world must be the candidate's).

    Returns ``(engine, train_state, step, (x, y))``: ``step(ts, x, y)`` is
    the engine's train step on the seeded global batch. The construction
    mirrors the task CLIs; if the candidate violated a composition rule
    the constructor would raise here, which is exactly the planner/runtime
    agreement the capability table guarantees never happens for a
    pruned-in candidate. On CUDA tensors the DP, FSDP and GSPMD engines
    are built with ``flash_attn=True`` (the trunk runs the flash kernels,
    as the port's tasks run it on the card); on the CPU the model is
    JAX's, ``impl="full"``.
    """
    from tpudml_torch.core.dist import process_count
    from tpudml_torch.optim import make_optimizer

    device = _device(device)
    world = _world(cand)
    if process_count() != world:
        raise RuntimeError(_job_message(world, process_count()))
    flash = device.type == "cuda"
    mesh_axes = cand.mesh_dict
    opt = make_optimizer("adamw", 3e-4)
    common = dict(
        fused_xent=cand.fused_xent,
        sentinel=cand.sentinel,
        obs=cand.obs,
    )
    if cand.engine in ("dp", "zero1"):
        from tpudml_torch.parallel import DataParallel
        from tpudml_torch.parallel.ep import mesh_groups

        eng = DataParallel(
            _model(spec, device), opt, mesh_groups(mesh_axes)["data"][0],
            stacked_batches=False,
            accum_steps=cand.accum_steps,
            zero1=cand.zero1,
            zero1_overlap=cand.zero1_overlap,
            flash_attn=flash,
            **common,
        )
    elif cand.engine in ("fsdp", "fsdp_tp"):
        from tpudml_torch.parallel import FSDP, tensor_parallel_rules

        eng = FSDP(
            _model(spec, device), opt, mesh_axes,
            base_rule=(
                tensor_parallel_rules("model")
                if cand.engine == "fsdp_tp" else None
            ),
            accum_steps=cand.accum_steps,
            flash_attn=flash,
            **common,
        )
    elif cand.engine == "tp":
        from tpudml_torch.parallel import GSPMDParallel, tensor_parallel_rules

        eng = GSPMDParallel(
            _model(spec, device), opt, mesh_axes,
            rule=tensor_parallel_rules("model"),
            axis_name="model",
            accum_steps=cand.accum_steps,
            flash_attn=flash,
            **common,
        )
    elif cand.engine == "pp_dp":
        from tpudml_torch.models import (
            TransformerBlock, TransformerEmbed, TransformerHead,
        )
        from tpudml_torch.parallel import GPipe

        per_stage = spec.num_layers // mesh_axes["stage"]
        g = torch.Generator().manual_seed(0)

        def block(gen):
            blocks = [TransformerBlock(spec.embed_dim, spec.num_heads, impl="full",
                                       rope=True, generator=gen)
                      for _ in range(per_stage)]
            return blocks[0] if per_stage == 1 else _Blocks(blocks)

        eng = GPipe(
            block,
            n_microbatches=PP_MICROBATCHES,
            mesh=mesh_axes,
            optimizer=opt,
            prologue=TransformerEmbed(
                spec.vocab_size, spec.embed_dim, spec.seq_len,
                use_pos_embed=False,  # blocks carry RoPE
                generator=g,
            ),
            epilogue=TransformerHead(spec.embed_dim, spec.vocab_size, generator=g),
            batch_axis="data",
            sentinel=cand.sentinel,
            obs=cand.obs,
            device=device,
        )
    else:
        raise ValueError(f"unknown engine {cand.engine!r}")
    ts = eng.create_state(0) if cand.engine == "pp_dp" else eng.create_state()
    step = eng.make_train_step()
    x, y = _batch(spec, world)
    return eng, ts, step, (x, y)


@contextmanager
def _job(world: int, device: torch.device):
    """The job a verification runs in: the process group already up (of
    ``world`` ranks), or at world 1 a one-rank group over a file store (NCCL
    on the card, gloo on the CPU), torn down after."""
    from tpudml_torch.core import DistributedConfig, process_group
    from tpudml_torch.core.dist import process_count

    if dist.is_initialized() or world != 1:
        if process_count() != world:
            raise RuntimeError(_job_message(world, process_count()))
        yield
        return
    with tempfile.TemporaryDirectory() as tmp, process_group(
            DistributedConfig(coordinator_address=f"file://{tmp}/store", num_processes=1),
            device=device):
        yield


def _full_params(eng, ts) -> dict:
    from tpudml_torch.parallel import DataParallel

    return eng.gather_params(ts) if isinstance(eng, DataParallel) else eng.gather_params()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def verify_candidate(
    spec: ModelSpec,
    cand: Candidate,
    hbm_budget_bytes: int | None = None,
    device=None,
) -> dict:
    """Build the candidate and run one train step of it on the seeded
    batch, in the job (at world 1 with no process group up, in a one-rank
    group it forms itself); every rank of the job calls it.

    Returns the plan's ``verification`` record (``entrypoint``, ``ok``,
    ``findings``) with the step's ``predicted`` costs and its wall
    (``step_wall_s``, the slowest rank's). ``ok`` is False when any
    finding fires (:data:`VERIFY_RULES`; every rank sees the same ones):
    the caller demotes the candidate and tries the next survivor.
    ``predicted.comm_wire_bytes`` is the ring-model wire bytes of the
    collectives the step issued (the busiest rank's);
    ``predicted.peak_hbm_bytes`` is ``torch.cuda.max_memory_allocated()``
    over the build and the step on the card, less what the process held
    before (from an allocator emptied of cached blocks and cuBLAS
    workspaces, so a repeat gives the same bytes), and on the CPU, which
    has no allocator peak, ``score.estimate_hbm``'s value. The wall is a
    cold step's: the allocator takes every block from the device anew.
    """
    from tpudml_torch.comm.collectives import wire_meter
    from tpudml_torch.core.dist import collective_device

    device = _device(device)
    cuda = device.type == "cuda"
    entrypoint = f"plan:{cand.key()}"
    with _job(_world(cand), device):
        if cuda:
            # cuBLAS keeps its workspaces from one call to the next: freed
            # here, every verification starts from the same allocator state
            # and its peak is the same on a repeat.
            gc.collect()
            torch._C._cuda_clearCublasWorkspaces()
            torch.cuda.empty_cache()
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
            held = torch.cuda.memory_allocated(device)  # the caller's, not the step's
        eng, ts, step, (x, y) = build_candidate(spec, cand, device)
        _sync(device)
        t0 = time.perf_counter()
        with wire_meter() as meter:
            ts, metrics = step(ts, x, y)
            _sync(device)
        wall = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated(device) - held if cuda
                else estimate_hbm(spec, cand))
        loss = torch.as_tensor(metrics["loss"]).detach().float().reshape(-1)
        params = _full_params(eng, ts)
        names = sorted(params)
        flags = [float(not torch.isfinite(loss).all())]
        flags += [float(not torch.isfinite(params[n]).all()) for n in names]
        for n in names:
            p = params[n].contiguous().reshape(-1)
            ref = p.clone()
            dist.broadcast(ref, src=0)
            flags.append(float(not torch.equal(ref.view(torch.uint8), p.view(torch.uint8))))
        values = torch.tensor(flags + [float(peak), meter.wire_bytes, wall],
                              dtype=torch.float64, device=collective_device())
        dist.all_reduce(values, op=dist.ReduceOp.MAX)
        values = values.cpu().tolist()
        del eng, ts, step, metrics, params
        if cuda:
            gc.collect()
            torch.cuda.empty_cache()
    n = len(names)
    bad = {"nonfinite_loss": [values[0] > 0],
           "nonfinite_param": values[1:1 + n],
           "replicas_differ": values[1 + n:1 + 2 * n]}
    peak, wire, wall = int(values[-3]), values[-2], values[-1]
    findings = []
    if bad["nonfinite_loss"][0]:
        findings.append(_finding("nonfinite_loss", entrypoint, VERIFY_RULES["nonfinite_loss"]))
    for rule in ("nonfinite_param", "replicas_differ"):
        for name, hit in zip(names, bad[rule]):
            if hit > 0:
                findings.append(_finding(rule, entrypoint,
                                         f"{VERIFY_RULES[rule]}: {name}"))
    if cuda and hbm_budget_bytes is not None and peak > hbm_budget_bytes:
        findings.append(_finding("over_hbm_budget", entrypoint,
                                 f"{VERIFY_RULES['over_hbm_budget']}: {peak} > "
                                 f"{hbm_budget_bytes} bytes"))
    return {
        "entrypoint": entrypoint,
        "ok": not findings,
        "findings": findings,
        "predicted": {
            "comm_wire_bytes": wire,
            "peak_hbm_bytes": peak,
        },
        "step_wall_s": wall,
    }


def _finding(rule: str, entrypoint: str, message: str) -> dict:
    return {"rule": rule, "severity": "error", "entrypoint": entrypoint,
            "message": message}


def plan_drift_findings(plan: dict) -> list:
    """Rule J118 (the code drifted from the plan's ``predicted`` block):
    JAX re-traces the winner for its static wire bytes and peak HBM, from
    the analyzers' dataflow and cost walks, which are not ported yet."""
    raise NotImplementedError(
        "plan_drift_findings (rule J118) needs the winner's static wire bytes and peak "
        "HBM from analysis/dataflow.py and cost.py, which are not ported yet (ROADMAP.md "
        "queue 1 item 11)")


def make_plan(
    spec: ModelSpec,
    world: int,
    hbm_budget_bytes: int | None = None,
    engines=None,
    verify: bool = True,
    calibration=None,
    replan: dict | None = None,
    hw=DEFAULT_HARDWARE,
    device=None,
    verify_log: list | None = None,
) -> dict:
    """enumerate → prune → score → verify-the-winner → plan dict.

    ``calibration`` (a :class:`tpudml_torch.plan.score.Calibration`)
    re-scores the lattice with measured constants — the drift-triggered
    re-plan path; ``replan`` is the provenance record an adaptive re-plan
    stamps (trigger + old winner + receipts), recorded verbatim. Both
    default to None, which is what the corresponding plan keys serialize
    as for a fresh plan. ``hw`` are the roofline's constants (the card's
    by default). ``verify=True`` runs :func:`verify_candidate` on
    ``device`` in the current job; ``verify_log``, when given, collects
    each verified candidate's key, verdict, ``predicted`` and step wall.
    """
    cands = enumerate_candidates(world, engines=engines)
    survivors, dropped = prune(spec, cands, hbm_budget_bytes)
    if not survivors:
        raise RuntimeError(
            f"no feasible candidate at world {world}: all "
            f"{len(cands)} pruned"
        )
    scored = [
        (score_candidate(spec, c, hw=hw, calibration=calibration), c)
        for c in survivors
    ]
    scored.sort(key=lambda sc: (sc[0].per_token_s, sc[1].key()))

    demoted = []
    verification = {"entrypoint": None, "ok": True, "findings": []}
    predicted = None
    winner_idx = 0
    if verify:
        for i, (_, cand) in enumerate(scored):
            v = verify_candidate(spec, cand, hbm_budget_bytes, device)
            wall = v.pop("step_wall_s")
            if verify_log is not None:
                verify_log.append({"key": cand.key(), "ok": v["ok"], "step_wall_s": wall,
                                   "predicted": dict(v["predicted"])})
            if v["ok"]:
                winner_idx = i
                predicted = v.pop("predicted")
                verification = v
                break
            demoted.append({
                "candidate": cand.to_dict(),
                "findings": v["findings"],
            })
        else:
            raise RuntimeError(
                f"every scored candidate at world {world} failed "
                f"verification ({len(demoted)} demoted)"
            )
    score, winner = scored[winner_idx]
    if predicted is None:
        # verify=False: fall back to the analytic estimates so the
        # schema stays total.
        predicted = {
            "comm_wire_bytes": score.comm_wire_bytes,
            "peak_hbm_bytes": score.est_hbm_bytes,
        }
    verification["demoted"] = demoted
    return {
        "version": PLAN_VERSION,
        "world": world,
        "spec": spec.to_dict(),
        "hbm_budget_bytes": hbm_budget_bytes,
        "winner": {
            "candidate": winner.to_dict(),
            "score": score.to_dict(),
        },
        "engine_config": engine_config(winner),
        "ranking": [
            {"candidate": c.to_dict(), "score": s.to_dict()}
            for s, c in scored
        ],
        "pruned": [r.to_dict() for r in dropped],
        "predicted": predicted,
        "verification": verification,
        "calibration": (
            calibration.to_dict() if calibration is not None else None
        ),
        "replan": replan,
    }


def engine_config(cand: Candidate) -> dict:
    """The flat runnable knob record ``--plan plan.json`` wiring
    consumes (core/config.py merges it into TrainConfig)."""
    return {
        "engine": cand.engine,
        "mesh": cand.mesh_dict,
        "zero1": cand.zero1,
        "zero1_overlap": cand.zero1_overlap,
        "accum_steps": cand.accum_steps,
        "fused_xent": cand.fused_xent,
        "sentinel": cand.sentinel,
        "obs": cand.obs,
        "tp_overlap": cand.tp_overlap,
        "aggregation": "allreduce",
    }


def plan_to_json(plan: dict) -> str:
    """Byte-deterministic serialization — the determinism test pins
    two same-input emissions to identical bytes."""
    return json.dumps(plan, indent=2, sort_keys=True) + "\n"


def load_plan(path: str) -> dict:
    """Read a plan.json, accepting every supported schema version.

    v1 files (pre-calibration) are upgraded in-memory: the v2-only keys
    are filled with their fresh-plan null values so downstream readers
    can rely on the total v2 schema. The on-disk file is never touched.
    """
    with open(path) as fh:
        plan = json.load(fh)
    ver = plan.get("version")
    if ver not in SUPPORTED_PLAN_VERSIONS:
        raise ValueError(
            f"{path}: plan version {ver!r} not in supported "
            f"{SUPPORTED_PLAN_VERSIONS}"
        )
    if ver < PLAN_VERSION:
        plan.setdefault("calibration", None)
        plan.setdefault("replan", None)
    return plan
