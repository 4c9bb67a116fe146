"""Per-stage programs and the heterogeneous 1F1B host loop (the port of
``tpudml/mpmd/runtime.py``).

Each stage runs its *own* program (:class:`StageProgram`) and drives the
schedule as a host loop (:class:`StageWorker`): forward and backward are
per-microbatch calls on the stage's device, activations and cotangents
cross stage boundaries as host tensors over the ``comm/p2p`` wire, and
the only intra-stage collective is the step-end gradient sum over the
stage's data replicas (:class:`GroupReducer`).

Precision contract (what "a bf16 stage feeding an f32 head" means), JAX's:

- parameters are **f32 master copies** everywhere; a stage casts them
  (and its input) to its compute ``dtype`` at the entry, so the cast's
  backward returns the parameter gradients in f32;
- the wire carries activations in the *producer's* dtype and cotangents
  in that same dtype (the consumer's entry cast's backward returns its
  input gradient in the producer's dtype);
- the head's per-microbatch loss is ``sum(row CE) / global_batch``, a
  local, exact share of the global mean loss, so cotangents need no
  cross-stage rescaling and gradients accumulate as plain sums:
  microbatch sums on each rank, then one SUM over the stage group. This
  makes a 2-stage×2-dp MPMD step the single program of
  :func:`reference_step_fn` up to f32 summation order.

The backward recomputes the forward (``torch.autograd.grad`` over a
re-run of the stage's apply, as JAX takes the ``vjp`` of ``apply``), so
nothing of the forward is kept between a microbatch's two halves but its
input.

The worker runs two ways: in spawned children (``mpmd/drill.py``, one
process group a stage) and in threads of one process over ``socketpair``
channels (the parity tests, the card check): the same code path, only
the channels and the reducer's group differ.

**The reducer's group** is a gloo group of host tensors, whatever device
the stage computes on: the gradients come to the host and are summed
there, as JAX sums host arrays over a gloo world a stage. NCCL cannot put
two ranks of one stage on one card; gloo can, so the stage processes of
a pipeline can share the card (``chip_smoke.py``'s ``[mpmd]`` drill runs
four on one H100). This is a design choice, not a fallback: a child
brings its group up with ``distributed_init(cfg, device="cpu")`` while
its program runs on ``cuda``, and a failure raises.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from tpudml_torch.comm.p2p import TAG_ACT, TAG_GRAD, PeerDeadError, resolve_dtype
from tpudml_torch.device import resolve_device
from tpudml_torch.mpmd.spec import PipelineSpec, boundary_plan, warmup_microbatches

__all__ = [
    "DrainSignal",
    "StageProgram",
    "GroupReducer",
    "StageWorker",
    "run_stage_threads",
    "stage_layer_dims",
    "init_stage_params",
    "make_batch_fn",
    "reference_step_fn",
]


class DrainSignal(Exception):
    """A peer (or the group's drain barrier) declared this step dead:
    discard in-flight microbatches, do not touch params, exit the step
    loop cleanly. Carries the step it fired at."""

    def __init__(self, step: int, why: str):
        super().__init__(f"drain at step {step}: {why}")
        self.step = step
        self.why = why


# ------------------------------------------------------------ the model


def stage_layer_dims(feature_dim: int, hidden, classes: int, n_stages: int) -> list:
    """Split the MLP's layer chain ``[feature] + hidden + [classes]``
    contiguously across ``n_stages``: each stage gets a list of ``(d_in,
    d_out)`` pairs; the last stage owns the logits layer."""
    dims = [feature_dim, *hidden, classes]
    n_layers = len(dims) - 1
    if n_layers < n_stages:
        raise ValueError(f"{n_layers} layers cannot split over {n_stages} stages")
    splits = np.array_split(np.arange(n_layers), n_stages)
    return [[(dims[l], dims[l + 1]) for l in part] for part in splits]


def init_stage_params(stage: int, n_stages: int, feature_dim: int, hidden, classes: int,
                      seed: int) -> list:
    """Deterministic f32 numpy init, seeded per *global* layer index (JAX's
    generator and draws, so bitwise JAX's): the per-stage lists
    concatenate to the parameters the single-program reference starts
    from."""
    splits = np.array_split(np.arange(len([feature_dim, *hidden, classes]) - 1), n_stages)
    dims = stage_layer_dims(feature_dim, hidden, classes, n_stages)[stage]
    out = []
    for l, (din, dout) in zip(splits[stage], dims):
        rng = np.random.default_rng(seed * 7919 + int(l))
        out.append({
            "w": (rng.standard_normal((din, dout)) / math.sqrt(din)).astype(np.float32),
            "b": np.zeros((dout,), np.float32),
        })
    return out


def make_batch_fn(global_batch: int, feature_dim: int, classes: int, seed: int):
    """Teacher-labelled batches as a pure function of the step index: any
    incarnation at any world sees the same global rows for step k."""
    teacher = (np.random.default_rng(seed + 777)
               .standard_normal((feature_dim, classes)).astype(np.float32))

    def batch_for(step: int):
        rng = np.random.default_rng(seed * 1_000_003 + step)
        x = rng.standard_normal((global_batch, feature_dim)).astype(np.float32)
        y = np.argmax(x @ teacher, axis=1).astype(np.int32)
        return x, y

    return batch_for


def _apply(params: list, h: torch.Tensor, dtype: torch.dtype, head: bool) -> torch.Tensor:
    """One stage's MLP: the input and every parameter cast to ``dtype`` at
    the entry; ReLU after every layer but the head's last."""
    h = h.to(dtype)
    last = len(params) - 1
    for i, layer in enumerate(params):
        h = h @ layer["w"].to(dtype) + layer["b"].to(dtype)
        if not (head and i == last):
            h = torch.relu(h)
    return h


def _row_ce_sum(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Sum of the rows' cross-entropy, in f32."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(1, y.long()[:, None])[:, 0].sum()


def _leaves(params: list) -> list:
    """A stage's tensors in JAX's flatten order: each layer's ``b``, then
    ``w``."""
    return [layer[k] for layer in params for k in ("b", "w")]


def _unflatten(flat: list) -> list:
    return [{"b": flat[i], "w": flat[i + 1]} for i in range(0, len(flat), 2)]


class StageProgram:
    """One stage's programs on ``device``: forward, recompute-backward and,
    for the head stage, the fused loss and gradient. Parameters and the
    SGD momentum stay f32; the entry casts set the precision boundary."""

    def __init__(self, spec: PipelineSpec, stage: int, *, feature_dim: int, hidden,
                 classes: int, seed: int, lr: float, momentum: float,
                 device: str | torch.device = "cuda"):
        self.spec = spec
        self.stage = stage
        self.device = resolve_device(device)
        self.is_first = stage == 0
        self.is_head = stage == len(spec.stages) - 1
        self.dtype = resolve_dtype(spec.stages[stage].dtype)
        self.lr = lr
        self.momentum_coef = momentum
        self.params = [{k: torch.from_numpy(v).to(self.device) for k, v in layer.items()}
                       for layer in init_stage_params(stage, len(spec.stages), feature_dim,
                                                      hidden, classes, seed)]
        self.momentum = [{k: torch.zeros_like(v) for k, v in layer.items()}
                         for layer in self.params]
        self.out_features = stage_layer_dims(feature_dim, hidden, classes,
                                             len(spec.stages))[stage][-1][1]

    def _leaf_params(self) -> list:
        return _unflatten([t.detach().requires_grad_(True) for t in _leaves(self.params)])

    @torch.no_grad()
    def fwd(self, x: torch.Tensor) -> torch.Tensor:
        return _apply(self.params, x.to(self.device), self.dtype, self.is_head)

    def bwd(self, x: torch.Tensor, ct: torch.Tensor):
        """(parameter gradients in f32, the input's gradient in the input's
        dtype) of the stage's output against the cotangent ``ct``."""
        p = self._leaf_params()
        xx = x.to(self.device).detach().requires_grad_(True)
        with torch.enable_grad():
            out = _apply(p, xx, self.dtype, self.is_head)
            grads = torch.autograd.grad(out, [*_leaves(p), xx], ct.to(self.device))
        return _unflatten(list(grads[:-1])), grads[-1]

    def loss_bwd(self, a: torch.Tensor, y: torch.Tensor):
        """(the microbatch's share of the global mean loss, the parameter
        gradients, the input's gradient) of the head's fused loss."""
        p = self._leaf_params()
        aa = a.to(self.device).detach().requires_grad_(True)
        with torch.enable_grad():
            logits = _apply(p, aa, self.dtype, self.is_head)
            loss = _row_ce_sum(logits, y.to(self.device)) / self.spec.global_batch
            grads = torch.autograd.grad(loss, [*_leaves(p), aa])
        return float(loss.detach()), _unflatten(list(grads[:-1])), grads[-1]

    @torch.no_grad()
    def apply_update(self, grads: list) -> None:
        """SGD with momentum: ``m = μ·m + g``, ``p -= lr·m``."""
        for p_layer, m_layer, g_layer in zip(self.params, self.momentum, grads):
            for k in p_layer:
                m = self.momentum_coef * m_layer[k] + g_layer[k].to(self.device)
                m_layer[k] = m
                p_layer[k] = p_layer[k] - self.lr * m


class GroupReducer:
    """SUM-allreduce of a stage's host tensors over its data replicas.

    The sum runs over a **gloo** process group (``group``, default the
    process's default group) of CPU tensors, whatever device the stage
    computes on: one flat f32 buffer a call. World 1 is the identity and
    needs no group (the threaded runs)."""

    def __init__(self, dp: int, group=None):
        self.dp = int(dp)
        self.group = group
        if self.dp > 1:
            if not dist.is_initialized():
                raise RuntimeError(f"GroupReducer: dp {self.dp} needs the stage's process "
                                   "group (distributed_init(cfg, device='cpu'))")
            if dist.get_backend(group) != "gloo":
                raise RuntimeError(f"GroupReducer sums host tensors over gloo; the group's "
                                   f"backend is {dist.get_backend(group)}")
            if dist.get_world_size(group) != self.dp:
                raise ValueError(f"GroupReducer: group of {dist.get_world_size(group)} "
                                 f"ranks for dp {self.dp}")

    def sum(self, tensors: list) -> list:
        """The group's elementwise sum of ``tensors`` (f32), on the host."""
        if self.dp == 1:
            return tensors
        host = [t.detach().to("cpu", torch.float32) for t in tensors]
        flat = torch.cat([t.reshape(-1) for t in host])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self.group)
        return [piece.view_as(t) for piece, t in
                zip(flat.split([t.numel() for t in host]), host)]


@dataclass
class _BoundaryIO:
    """This rank's slice of one boundary plan, grouped by the microbatch
    index on this rank's side."""

    by_mb: dict = field(default_factory=dict)

    @classmethod
    def build(cls, transfers, *, key) -> "_BoundaryIO":
        out = cls()
        for t in transfers:
            out.by_mb.setdefault(key(t), []).append(t)
        for lst in out.by_mb.values():
            lst.sort(key=lambda t: t.index)
        return out


class StageWorker:
    """One rank of one stage: runs the heterogeneous 1F1B schedule.

    Per step: ``warmup_microbatches`` forwards, then strict
    forward/backward alternation, then the backward tail; then the group
    drain vote (:class:`~tpudml_torch.comm.p2p.DrainBarrier`), and only on
    a unanimous ``ok`` the gradient SUM and the replicated SGD momentum
    update. Any :class:`~tpudml_torch.comm.p2p.PeerDeadError` (or a
    ``drain`` verdict) raises :class:`DrainSignal` with the parameters
    left at the last completed step, the state the checkpoints resume.
    """

    def __init__(self, spec: PipelineSpec, stage: int, rank: int, *,
                 program: StageProgram, batch_for, up_features: int | None = None,
                 up_channels: dict | None = None, down_channels: dict | None = None,
                 barrier=None, reducer: GroupReducer | None = None):
        self.spec = spec
        self.stage = stage
        self.rank = rank
        self.program = program
        self.batch_for = batch_for
        self.up = dict(up_channels or {})      # edge -> Channel (to stage-1)
        self.down = dict(down_channels or {})  # edge -> Channel (to stage+1)
        self.barrier = barrier
        self.reducer = reducer or GroupReducer(1)
        st = spec.stages[stage]
        self.m = st.microbatches
        self.warmup = warmup_microbatches(spec, stage)
        self.in_plan = None
        self.out_plan = None
        if stage > 0:
            self.in_plan = _BoundaryIO.build(
                [t for t in boundary_plan(spec, stage - 1) if t.dst_rank == rank],
                key=lambda t: t.dst_microbatch)
            self.up_dtype = resolve_dtype(spec.stages[stage - 1].dtype)
            if up_features is None:
                raise ValueError("non-first stages need up_features (the upstream "
                                 "stage's output width)")
            self._up_features = int(up_features)
        if stage < len(spec.stages) - 1:
            self.out_plan = _BoundaryIO.build(
                [t for t in boundary_plan(spec, stage) if t.src_rank == rank],
                key=lambda t: t.src_microbatch)
        self.rows = spec.rows_per_rank(stage)
        self.losses: list = []

    # ------------------------------------------------------- microbatch

    def _input_for(self, step: int, mb: int) -> torch.Tensor:
        if self.stage == 0:
            x, _ = self.batch_for(step)
            lo, hi = self.spec.row_interval(0, mb, self.rank)
            return torch.from_numpy(np.ascontiguousarray(x[lo:hi]))
        arr = torch.zeros((self.rows, self._up_features), dtype=self.up_dtype)
        for t in self.in_plan.by_mb.get(mb, []):
            chunk = self.up[t.edge].recv(step=step, microbatch=t.index, tag=TAG_ACT)
            arr[t.dst_rows[0]: t.dst_rows[1]] = chunk
        return arr

    def _labels_for(self, step: int, mb: int) -> torch.Tensor:
        _, y = self.batch_for(step)
        lo, hi = self.spec.row_interval(self.stage, mb, self.rank)
        return torch.from_numpy(np.ascontiguousarray(y[lo:hi]))

    def _forward(self, step: int, mb: int, stash: dict) -> None:
        x = self._input_for(step, mb).to(self.program.device)
        stash[mb] = x
        if self.program.is_head:
            return  # the head's forward is fused into its loss program
        act = self.program.fwd(x).cpu()
        for t in self.out_plan.by_mb.get(mb, []):
            self.down[t.edge].send(act[t.src_rows[0]: t.src_rows[1]], step=step,
                                   microbatch=t.index, tag=TAG_ACT)

    def _send_up(self, step: int, mb: int, gx: torch.Tensor) -> None:
        gx = gx.cpu()
        for t in self.in_plan.by_mb.get(mb, []):
            self.up[t.edge].send(gx[t.dst_rows[0]: t.dst_rows[1]], step=step,
                                 microbatch=t.index, tag=TAG_GRAD)

    def _backward(self, step: int, mb: int, stash: dict, acc: dict) -> None:
        x = stash.pop(mb)
        if self.program.is_head:
            loss, gp, ga = self.program.loss_bwd(x, self._labels_for(step, mb))
            acc["loss"] += loss
            if self.stage > 0:
                self._send_up(step, mb, ga)
        else:
            ct = torch.zeros((self.rows, self.program.out_features), dtype=self.program.dtype)
            for t in self.out_plan.by_mb.get(mb, []):
                chunk = self.down[t.edge].recv(step=step, microbatch=t.index, tag=TAG_GRAD)
                ct[t.src_rows[0]: t.src_rows[1]] = chunk
            gp, gx = self.program.bwd(x, ct)
            if self.stage > 0:
                self._send_up(step, mb, gx)
        flat = _leaves(gp)
        acc["g"] = flat if acc["g"] is None else [a + g for a, g in zip(acc["g"], flat)]

    # -------------------------------------------------------------- step

    def run_step(self, step: int) -> float:
        """One full 1F1B step; returns the stage group's global loss (the
        head's mean CE; NaN elsewhere). Raises :class:`DrainSignal`
        instead of touching the parameters on any peer death or drain
        verdict."""
        stash: dict = {}
        acc = {"g": None, "loss": 0.0}
        w, m = self.warmup, self.m
        try:
            for k in range(w):
                self._forward(step, k, stash)
            for i in range(m - w):
                self._forward(step, w + i, stash)
                self._backward(step, i, stash, acc)
            for i in range(m - w, m):
                self._backward(step, i, stash, acc)
        except PeerDeadError as e:
            if self.barrier is not None:
                self.barrier.vote(step, ok=False)
            raise DrainSignal(step, f"peer dead on edge {e.edge}") from e
        if self.barrier is not None and not self.barrier.vote(step, ok=True):
            raise DrainSignal(step, "group drain verdict")
        loss_t = torch.tensor([np.float32(acc["loss"])], dtype=torch.float32)
        *grads, loss_sum = self.reducer.sum([*acc["g"], loss_t])
        self.program.apply_update(_unflatten(grads))
        loss = float(loss_sum.reshape(())) if self.program.is_head else float("nan")
        self.losses.append(np.float32(loss if loss == loss else 0.0))
        return loss


def run_stage_threads(workers: dict, steps, *, timeout_s: float = 600.0) -> dict:
    """Run ``steps`` on every worker of ``workers`` (name → worker) at
    once, one thread each: the stages of one pipeline in one process, over
    ``channel_pair`` channels (the parity tests, the card check). Returns
    each worker's ``run_step`` results by name. Re-raises the first error
    a worker raised; raises ``RuntimeError`` if a thread is still running
    after ``timeout_s`` (a deadlocked schedule)."""
    steps = list(steps)
    out: dict = {name: [] for name in workers}
    errors: list = []

    def drive(name, worker):
        try:
            for k in steps:
                out[name].append(worker.run_step(k))
        except BaseException as e:  # re-raised in the calling thread
            errors.append(e)

    ts = [threading.Thread(target=drive, args=item, daemon=True) for item in workers.items()]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=timeout_s)
    if any(t.is_alive() for t in ts):
        raise RuntimeError(f"stage threads still running after {timeout_s} s: "
                           "the pipeline deadlocked")
    if errors:
        raise errors[0]
    return out


# ---------------------------------------------- single-program reference


def reference_step_fn(spec: PipelineSpec, *, feature_dim: int, hidden, classes: int,
                      seed: int, lr: float, momentum: float,
                      device: str | torch.device = "cuda"):
    """The *equivalent single program* the heterogeneity test compares
    against: one step applying every stage's program with the SAME
    per-stage chunking and the SAME entry casts, on ``device`` — the trunk
    runs per trunk-microbatch chunk and concatenates, the head sums per
    head-microbatch loss contributions — so autograd reproduces the same
    per-chunk low-precision roundings and what is left against the MPMD
    run is f32 summation order.

    Returns ``(params, mom, step_fn)`` where ``step_fn(params, mom, x, y) ->
    (params, mom, loss, grads)``; ``x``, ``y`` are the global batch (numpy
    or tensors), the rest per stage lists of ``{"w", "b"}`` tensors."""
    n = len(spec.stages)
    programs = [StageProgram(spec, s, feature_dim=feature_dim, hidden=hidden,
                             classes=classes, seed=seed, lr=lr, momentum=momentum,
                             device=device) for s in range(n)]
    dev = programs[0].device
    params = [p.params for p in programs]
    mom = [p.momentum for p in programs]
    dtypes = [p.dtype for p in programs]
    gb = spec.global_batch

    def loss_fn(all_params, x, y):
        h = x
        for s in range(n - 1):
            chunks = h.split(h.shape[0] // spec.stages[s].microbatches)
            h = torch.cat([_apply(all_params[s], c, dtypes[s], False) for c in chunks])
        m = spec.stages[n - 1].microbatches
        loss = 0.0
        for c, yc in zip(h.split(h.shape[0] // m), y.split(y.shape[0] // m)):
            loss = loss + _row_ce_sum(_apply(all_params[n - 1], c, dtypes[n - 1], True),
                                      yc) / gb
        return loss

    def step_fn(all_params, all_mom, x, y):
        x = torch.as_tensor(x).to(dev)
        y = torch.as_tensor(y).to(dev)
        leaves = [[t.detach().requires_grad_(True) for t in _leaves(p)] for p in all_params]
        with torch.enable_grad():
            loss = loss_fn([_unflatten(lv) for lv in leaves], x, y)
            flat = torch.autograd.grad(loss, [t for lv in leaves for t in lv])
        grads, k = [], 0
        for lv in leaves:
            grads.append(_unflatten(list(flat[k:k + len(lv)])))
            k += len(lv)
        with torch.no_grad():
            new_mom = [[{key: momentum * mm[key] + gg[key] for key in mm}
                        for mm, gg in zip(ms, gs)] for ms, gs in zip(all_mom, grads)]
            new_params = [[{key: pp[key] - lr * mm[key] for key in pp}
                           for pp, mm in zip(ps, ms)] for ps, ms in zip(all_params, new_mom)]
        return new_params, new_mom, loss.detach(), grads

    return params, mom, step_fn
