"""Registry of the real steps the graph pass captures (the port of
``tpudml/analysis/entrypoints.py``: the same 16 names).

Each ``build_*`` function constructs the port's REAL engine, the class the tasks
instantiate, around the tiny model JAX's registry uses, and returns the
step (the port's counterpart of JAX's jitted program) with its inputs.
:func:`analyze_entrypoint` captures one step of it
(:mod:`~tpudml_torch.analysis.capture`) and runs every rule of the graph
pass. The engines run at world 1 on the job's process group (a one-rank
group over a file store in a temporary directory when there is none, as
``core.process_group`` builds it), on the card unless the caller asks for
the CPU; the mesh axes they name stand for that group's ranks.

==================  ======================================  ==============
entrypoint          engine / step                           task analogue
==================  ======================================  ==============
task1_single        train.make_train_step (LeNet, SGD)      task1
task2_dp            parallel.DataParallel                   task2, task3
dp_zero1            DataParallel(zero1=True), Adam          task2 --zero1
dp_sentinel         dp_zero1 + the grad sentinel            task2 --sentinel
task4_mp            parallel.GSPMDParallel (stage rules)    task4
fsdp                parallel.FSDP (ForwardMLP, Adam)        task5 fsdp
tp_fused            GSPMDParallel(TP rules, fused_xent)     task5 tp --fused_xent
fsdp_fused          FSDP(fused_xent=True)                   task5 fsdp --fused_xent
pp_gpipe            parallel.GPipe                          task5 pp
cp_ring             parallel.ContextParallel (ring)         task5 cp
ep_moe              parallel.ExpertParallel                 task5 ep
moe_ragged          make_train_step, ragged MoE, Adam       task5 --moe_dispatch ragged
lm_bf16             make_train_step on a bf16 LM            task5 single
serve_decode        ServingEngine's decode step             task6
serve_paged_decode  the paged decode step                   task6 --paged
serve_fused         the decode step with the fused head     task6 --fused_head
==================  ======================================  ==============
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from tpudml_torch.analysis.capture import capture, error_anchor
from tpudml_torch.analysis.findings import Finding
from tpudml_torch.analysis.graph_pass import analyze_capture
from tpudml_torch.device import default_device, resolve_device

__all__ = ["ENTRYPOINTS", "Program", "analyze_entrypoint", "analyze_entrypoints",
           "capture_entrypoint", "entrypoint_group"]


@dataclass(frozen=True)
class Program:
    """One step to capture: the callable, its inputs, the modules whose
    parameters it updates, the process group of each mesh axis it names
    (None = the default group) and its sharded leaves (J107)."""

    name: str
    fn: Callable
    args: tuple
    expects_donation: bool = True
    axes: dict = field(default_factory=dict)
    modules: tuple = ()
    sharded: dict = field(default_factory=dict)


def _lenet_batch(n=4):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, size=(n,)).astype(np.int32)
    return x, y


def _lm_batch(b=2, t=8, vocab=32):
    rng = np.random.default_rng(0)
    seqs = rng.integers(0, vocab, size=(b, t + 1)).astype(np.int32)
    return seqs[:, :-1], seqs[:, 1:]


def _tiny_lm(device, **kw):
    from tpudml_torch.models import TransformerLM

    base = dict(vocab_size=32, embed_dim=16, num_heads=2, num_layers=1, max_len=8)
    base.update(kw)
    return TransformerLM(**base, device=device, generator=torch.Generator().manual_seed(0))


def _engine_axes(groups: dict) -> dict:
    return {axis: g for axis, (g, _, _) in groups.items()}


def _last_dim_sharded(engine) -> dict:
    """{parameter: the mesh axes of its last dim} from a GSPMD engine."""
    out = {}
    for name, spec in engine.param_specs.items():
        last = spec[-1] if spec else None
        axes = () if last is None else (tuple(last) if isinstance(last, tuple) else (last,))
        if axes:
            out[name] = axes
    return out


def _opt(name: str, lr: float):
    from tpudml_torch.optim import make_optimizer

    return make_optimizer(name, lr)


def build_task1_single(device) -> list[Program]:
    from tpudml_torch.models import LeNet
    from tpudml_torch.train import TrainState, make_train_step

    model, opt = LeNet(device=device), _opt("sgd", 0.01)
    ts = TrainState.create(model, opt)
    return [Program("task1_single", make_train_step(model, opt), (ts, *_lenet_batch()))]


def _dp(name: str, device, opt, **kw) -> list[Program]:
    from tpudml_torch.models import LeNet
    from tpudml_torch.parallel import DataParallel

    dp = DataParallel(LeNet(device=device), opt, **kw)
    ts = dp.create_state()
    return [Program(name, dp.make_train_step(), (ts, *_lenet_batch()),
                    axes={"data": dp.group})]


def build_task2_dp(device) -> list[Program]:
    return _dp("task2_dp", device, _opt("sgd", 0.01))


def build_dp_zero1(device) -> list[Program]:
    """ZeRO-1: the step reduce-scatters the gradients and gathers the
    parameters (J108 stays silent: the reduce-scatter is the point)."""
    return _dp("dp_zero1", device, _opt("adam", 1e-3), zero1=True)


def build_dp_sentinel(device) -> list[Program]:
    """ZeRO-1 with the grad sentinel: its finiteness check stands between
    the gradients and the update, so J111 stays silent here."""
    return _dp("dp_sentinel", device, _opt("adam", 1e-3), zero1=True, sentinel=True)


def _gspmd(name: str, eng, batch) -> list[Program]:
    ts = eng.create_state()
    return [Program(name, eng.make_train_step(), (ts, *batch),
                    axes=_engine_axes(eng.groups), sharded=_last_dim_sharded(eng))]


def build_task4_mp(device) -> list[Program]:
    from tpudml_torch.models import LeNet
    from tpudml_torch.parallel import GSPMDParallel

    eng = GSPMDParallel(LeNet(device=device), _opt("sgd", 0.01), {"stage": 1})
    return _gspmd("task4_mp", eng, _lenet_batch())


def build_fsdp(device) -> list[Program]:
    from tpudml_torch.models import ForwardMLP
    from tpudml_torch.parallel import FSDP

    eng = FSDP(ForwardMLP(device=device), _opt("adam", 1e-3), {"data": 1})
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 784)).astype(np.float32)
    y = rng.integers(0, 10, size=(4,)).astype(np.int32)
    return _gspmd("fsdp", eng, (x, y))


def build_tp_fused(device) -> list[Program]:
    """TP with the vocab-sharded fused head: the step runs the SHARDED
    head's region (J107 stays silent) and its statistics' sums."""
    from tpudml_torch.parallel import GSPMDParallel, tensor_parallel_rules

    eng = GSPMDParallel(_tiny_lm(device), _opt("sgd", 0.05), {"model": 1},
                        rule=tensor_parallel_rules("model"), axis_name="model",
                        fused_xent=True)
    return _gspmd("tp_fused", eng, _lm_batch())


def build_fsdp_fused(device) -> list[Program]:
    """1-D FSDP with the fused head: vocabulary and tokens share the data
    axis."""
    from tpudml_torch.parallel import FSDP

    eng = FSDP(_tiny_lm(device), _opt("sgd", 0.05), {"data": 1}, fused_xent=True)
    return _gspmd("fsdp_fused", eng, _lm_batch())


def build_pp_gpipe(device) -> list[Program]:
    from tpudml_torch.nn import Activation, Dense, Sequential
    from tpudml_torch.parallel import GPipe

    pipe = GPipe(lambda g: Sequential((Dense(8, 8, generator=g), Activation())),
                 n_microbatches=2, mesh={"stage": 1}, optimizer=_opt("sgd", 0.05),
                 prologue=Dense(4, 8, generator=torch.Generator().manual_seed(1)),
                 epilogue=Dense(8, 4, generator=torch.Generator().manual_seed(2)),
                 device=device)
    ts = pipe.create_state(0)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 4)).astype(np.float32)
    y = rng.integers(0, 4, size=(4,)).astype(np.int32)
    return [Program("pp_gpipe", pipe.make_train_step(), (ts, x, y),
                    axes={"stage": pipe.group})]


def build_cp_ring(device) -> list[Program]:
    from tpudml_torch.parallel import ContextParallel

    cp = ContextParallel(_tiny_lm(device, impl="ring", seq_sharded=True), _opt("sgd", 0.1),
                         {"seq": 1})
    ts = cp.create_state()
    return [Program("cp_ring", cp.make_train_step(), (ts, *_lm_batch()),
                    axes={"seq": cp.group})]


def build_ep_moe(device) -> list[Program]:
    from tpudml_torch.parallel import ExpertParallel

    ep = ExpertParallel(_tiny_lm(device, moe_experts=2, moe_axis="expert"), _opt("adam", 0.01),
                        {"expert": 1})
    ts = ep.create_state()
    return [Program("ep_moe", ep.make_train_step(), (ts, *_lm_batch()),
                    axes={"expert": ep.group})]


def _single(name: str, model, opt) -> list[Program]:
    from tpudml_torch.train import TrainState, make_train_step

    ts = TrainState.create(model, opt)
    return [Program(name, make_train_step(model, opt), (ts, *_lm_batch()))]


def build_moe_ragged(device) -> list[Program]:
    """Dropless ragged MoE on one card, the surface J109 guards; its
    backward runs the grouped-dW kernel's region."""
    return _single("moe_ragged", _tiny_lm(device, moe_experts=2, moe_dispatch="ragged"),
                   _opt("adam", 0.01))


def build_lm_bf16(device) -> list[Program]:
    return _single("lm_bf16", _tiny_lm(device, compute_dtype=torch.bfloat16),
                   _opt("sgd", 0.01))


def _decode(name: str, device, **cfg) -> list[Program]:
    from tpudml_torch.serve import ServeConfig, ServingEngine

    eng = ServingEngine(_tiny_lm(device, rope=True, num_kv_heads=1),
                        ServeConfig(slots=2, max_len=8, prefill_chunk=4, **cfg), device=device)
    dev = resolve_device(device)
    tokens = torch.zeros(2, dtype=torch.long, device=dev)
    pos = torch.zeros(2, dtype=torch.long, device=dev)
    table = ()
    if eng.cfg.cache_layout == "paged":
        table = (torch.zeros((2, eng.cfg.max_pages), dtype=torch.int32, device=dev),)
    # The caches are KiB at this size, under J106's threshold, as in JAX.
    return [Program(name, eng._decode, (eng.caches, *table, tokens, pos),
                    expects_donation=False, modules=(eng.model,))]


def build_serve_decode(device) -> list[Program]:
    """The decode step, the surface J110 guards (its softmax is [B, H, 1,
    L]); its unfused argmax tail is J119's firing case."""
    return _decode("serve_decode", device)


def build_serve_paged_decode(device) -> list[Program]:
    """The paged decode step, the surface J117 guards: a pool of 5 pages
    of 2 rows, above one slot's table of 4, so that pool rows and table
    rows cannot collide (the rule's bound, as in JAX)."""
    return _decode("serve_paged_decode", device, cache_layout="paged", page_size=2,
                   num_pages=5)


def build_serve_fused(device) -> list[Program]:
    """The decode step with the fused head: its greedy pick is inside the
    fused head's region, so J119 stays silent."""
    return _decode("serve_fused", device, fused_head=True)


#: name -> build function(device); order is reporting order.
ENTRYPOINTS: dict[str, Callable[[str], list[Program]]] = {
    "task1_single": build_task1_single,
    "task2_dp": build_task2_dp,
    "dp_zero1": build_dp_zero1,
    "dp_sentinel": build_dp_sentinel,
    "task4_mp": build_task4_mp,
    "fsdp": build_fsdp,
    "tp_fused": build_tp_fused,
    "fsdp_fused": build_fsdp_fused,
    "pp_gpipe": build_pp_gpipe,
    "cp_ring": build_cp_ring,
    "ep_moe": build_ep_moe,
    "moe_ragged": build_moe_ragged,
    "lm_bf16": build_lm_bf16,
    "serve_decode": build_serve_decode,
    "serve_paged_decode": build_serve_paged_decode,
    "serve_fused": build_serve_fused,
}


@contextlib.contextmanager
def entrypoint_group(device=None):
    """The process group the engines run on: the job's, else a one-rank
    group over a file store (``core.process_group``) on ``device``'s
    backend. Asking for the card without one raises."""
    from tpudml_torch.core import process_group

    dev = resolve_device(device or default_device())
    if dist.is_initialized():
        yield dev
        return
    with process_group(device=dev):
        yield dev


def capture_entrypoint(prog: Program):
    """One captured step of ``prog``."""
    return capture(prog.fn, prog.args, name=prog.name, modules=prog.modules, axes=prog.axes,
                   sharded=prog.sharded)


def analyze_entrypoint(name: str, device=None) -> list[Finding]:
    """Build one entrypoint on ``device`` (default: ``TPUDML_DEVICE``, else
    the card) and run every rule of the graph pass on one captured step of
    each of its programs. A build function that raises is a J100 finding, as a
    step that raises is: an entrypoint that cannot be built will not run.
    (JAX's ``hbm_budget_bytes`` arms J116, the next slice's.)"""
    with entrypoint_group(device) as dev:
        try:
            programs = ENTRYPOINTS[name](dev)
        except Exception as e:  # noqa: BLE001 - converted to a finding
            file, line = error_anchor(e)
            return [Finding("J100", f"entrypoint failed to build: {e!r}", file=file, line=line,
                            entrypoint=name)]
        findings: list[Finding] = []
        for prog in programs:
            findings.extend(analyze_capture(capture_entrypoint(prog), prog.name,
                                            expects_donation=prog.expects_donation))
        return findings


def analyze_entrypoints(names: list[str] | None = None, device=None) -> list[Finding]:
    findings: list[Finding] = []
    with entrypoint_group(device) as dev:
        for name in names or list(ENTRYPOINTS):
            findings.extend(analyze_entrypoint(name, dev))
    return findings
