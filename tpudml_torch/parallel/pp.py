"""Pipeline parallelism with micro-batching (the port of
``tpudml/parallel/pp.py``: ``GPipe``, ``OneFOneB``, ``HeteroPipeline``,
``HeteroOneFOneB``, ``Interleaved1F1B``).

JAX runs every schedule as ONE SPMD program over a mesh ``stage`` axis: a
``lax.scan`` over ticks in which every device computes (or skips a ghost
tick), ``lax.ppermute`` between neighbouring stages, and AD of the scan
for GPipe's backward. The port runs one process a stage. Each rank walks
the same static tick plan, computes only its live units, and at the end
of every tick posts its sends and receives of that tick in one
``batch_isend_irecv`` (``comm.collectives.stage_exchange``): both ends of
every message derive it from the plan, so the ranks never disagree on the
order. The backward is scheduled by hand, per micro-batch:

- **GPipe**: micro-batch m runs on stage s at tick s + m (ghost ticks
  skipped, as JAX's ``lax.cond`` skips them). Each rank keeps the autograd
  graph of each of its micro-batches (or, with ``remat``, only the input,
  through ``torch.utils.checkpoint``). The last stage's outputs are
  broadcast over the stage group and every rank runs the epilogue and the
  loss on the whole batch, as JAX does, so the metrics and the replicated
  epilogue stay in step. The backward then runs the ticks in reverse: the
  last stage seeds each micro-batch with its slice of the epilogue's input
  cotangent, every stage hands its input cotangent to the previous one,
  and stage 0 takes the prologue's gradient once, on the whole batch. JAX
  scales the broadcast's cotangent by 1/S because ``psum`` transposes to
  ``psum`` under ``shard_map``; the port's broadcast has no transpose (only
  the last stage's cotangent is used), so it needs no scale.
- **1F1B** (and its virtual-stage form, **interleaved**): the forward of
  micro m on virtual stage σ = v·S + s at tick σ + 2m and its backward at
  2·V·S − σ − 1 + 2m. The forward of every stage but the last runs without
  a graph and banks its input in a V·S-slot buffer; the backward recomputes
  the stage from the saved input and differentiates it
  (``torch.autograd.grad``); the last virtual stage runs its forward, the
  epilogue and the loss inside its backward tick with the cotangent 1/M.
  Dropout keys fold step, virtual stage and micro-batch (and the data
  index under PP×DP), and the recompute folds the same key.

Placement is JAX's: rank s holds its ``[1, ...]`` block of the
stage-stacked parameters (``[1, V, ...]`` under interleaved: block σ = v·S
+ s at ``[s, v]``); ``prologue`` and ``epilogue`` are replicated on every
rank. Parameter names are JAX's paths: ``prologue.<...>``,
``stages.<block's names>``, ``epilogue.<...>``. A rank's blocks are real
modules whose parameters are views of those stacked tensors, so the
optimizer's in-place update of a ``stages`` leaf is the block's update.
The heterogeneous engines keep each stage as its own module (parameters
``stages.<stage's names>``, different on every rank) and send each
stage's real activation shape, where JAX ravels every stage into one
padded ``[S, L]`` row and pads every activation to one width
(``interop.hetero_*`` carry parameters and optimizer state between the
two layouts; a defined difference, ROADMAP.md queue 3).

Gradients: prologue gradients exist on stage 0 only and are summed over
the stage group; GPipe's epilogue gradients are computed alike on every
rank, 1F1B's on the last stage and summed over the group. Under PP×DP
(``batch_axis`` on a ``{"data": D, "stage": S}`` mesh, laid out by
``parallel.ep.mesh_groups``) each data replica pipelines its rows of the
global batch, and gradients and metrics are averaged over the data group,
unless a ``ZeRO1`` over that axis does the gradients' mean itself. A
``ClipByGlobalNorm`` is rewrapped to sum the stage leaves' squares over
the stage group (``shard_aware_clip``); ``sentinel=`` attaches a
``GradSentinel`` over the stage group, ``obs=`` adds the ``train_step``
span and the step's ``StepStats``.

Bytes on the wire: each tick a rank sends only its live activations and
cotangents, one message a neighbour (several chunks' slots packed into
one). ``tick_bytes`` records what this rank sent in each tick of the last
step; JAX's ring ships a full activation buffer every tick, so the port's
count is at most JAX's.

On a CUDA device the group must be NCCL's (its communicator is made by a
collective on the stage group before the first send), on the CPU gloo's.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch
import torch.distributed as dist
import torch.utils.checkpoint
from torch import nn

from tpudml_torch.capabilities import reject
from tpudml_torch.comm.collectives import all_gather_tree, pmean_tree, psum_tree, stage_exchange
from tpudml_torch.core.dist import backend_for
from tpudml_torch.core.prng import Key, seed_key
from tpudml_torch.nn.layers import Dropout
from tpudml_torch.nn.losses import accuracy, softmax_cross_entropy
from tpudml_torch.nn.moe import MoELayer
from tpudml_torch.obs.stepstats import grad_normsq, make_step_stats
from tpudml_torch.obs.tracer import NULL_SPAN, Tracer
from tpudml_torch.optim import Optimizer, shard_aware_clip
from tpudml_torch.optim.zero1 import ZeRO1, stages_stacked, with_stacked, zero1_handles
from tpudml_torch.parallel.dp import shard_rows
from tpudml_torch.parallel.ep import mesh_groups
from tpudml_torch.resilience.sentinel import attach_sentinel, find_sentinel
from tpudml_torch.train import TrainState, params_of, to_device

FWD, BWD = 0, 1  # message kinds, in their order within a packed message


def _has_dropout(module: nn.Module) -> bool:
    """Active dropout anywhere in a module tree: a ``Dropout`` of nonzero
    rate or a nonzero ``dropout`` rate attribute (``TransformerBlock``)."""
    for m in module.modules():
        rate = m.rate if isinstance(m, Dropout) else getattr(m, "dropout", 0.0)
        if isinstance(rate, (int, float)) and rate:
            return True
    return False


def _is_stateful(module: nn.Module) -> bool:
    """A module with state beside its parameters: buffers (BatchNorm's
    running statistics) or a MoE layer (JAX keeps its aux term as state)."""
    return (any(True for _ in module.buffers())
            or any(isinstance(m, MoELayer) for m in module.modules()))


def _call(module: nn.Module, x: torch.Tensor, key: Key | None) -> torch.Tensor:
    """``module(x)`` (with ``key`` when one is given); the first item of a
    ``(y, aux)`` pair."""
    out = module(x) if key is None else module(x, key=key)
    return out[0] if isinstance(out, tuple) else out


def _probe(module: nn.Module | None, shape: tuple, dtype: torch.dtype):
    """(output shape, dtype) of ``module`` on a batch of two samples of
    ``shape``: one call on the meta device (no compute, no launch)."""
    if module is None:
        return (2, *shape), dtype
    meta = {n: torch.empty_like(t, device="meta") for n, t in
            [*module.named_parameters(), *module.named_buffers()]}
    x = torch.zeros((2, *shape), dtype=dtype, device="meta")
    mode = module.training
    module.eval()  # a dropout layer draws nothing in eval mode
    try:
        with torch.no_grad():
            y = torch.func.functional_call(module, meta, (x,))
    finally:
        module.train(mode)
    y = y[0] if isinstance(y, tuple) else y
    return tuple(y.shape), y.dtype


def _unit(dt: int, m_count: int) -> int | None:
    """The micro-batch of a 1F1B unit ``dt`` ticks past its first slot
    (live on even offsets below 2M), or None."""
    return dt // 2 if 0 <= dt < 2 * m_count and dt % 2 == 0 else None


def _register(root: nn.Module, name: str, param: nn.Parameter) -> None:
    """``param`` under the dotted ``name`` of ``root``, making the
    intermediate modules."""
    *path, leaf = name.split(".")
    m = root
    for p in path:
        if not hasattr(m, p):
            m.add_module(p, nn.Module())
        m = getattr(m, p)
    m.register_parameter(leaf, param)


def _rebind(module: nn.Module, name: str, param: nn.Parameter) -> None:
    mod_name, _, attr = name.rpartition(".")
    owner = module.get_submodule(mod_name) if mod_name else module
    setattr(owner, attr, param)


class _PipelineModel(nn.Module):
    """The parameters a rank holds, named as JAX's pipeline param tree:
    the replicated ``prologue`` and ``epilogue`` modules and the
    ``stages`` holder (this rank's stacked block parameters)."""

    def __init__(self, prologue, stages, epilogue):
        super().__init__()
        for name, m in (("prologue", prologue), ("stages", stages), ("epilogue", epilogue)):
            if m is not None:
                self.add_module(name, m)


class GPipe:
    """Micro-batched pipeline engine over a process group's ``stage`` axis.

    Usage::

        pipe = GPipe(lambda g: Sequential((Dense(32, 32, generator=g), Activation())),
                     n_microbatches=8, optimizer=opt, prologue=embed, epilogue=head)
        ts = pipe.create_state(0)
        step = pipe.make_train_step()      # (ts, x, labels) -> (ts, metrics)

    ``block`` builds one stage's block from a ``torch.Generator`` (JAX's
    block is a Module that ``init`` draws from a key): :meth:`create_state`
    draws block σ from ``key.fold_in(1).fold_in(σ)``, so every rank draws
    the same blocks and keeps its own. ``prologue`` and ``epilogue`` are
    built modules, replicated (every rank builds them from the same seed).
    Blocks must be shape-preserving and stateless. Batches are GLOBAL and
    the same on every rank. ``mesh`` is the axis sizes laid row-major over
    the job's ranks (default ``{axis_name: world}``); ``batch_axis`` names
    its data axis for PP×DP. ``device`` defaults to the prologue's (or the
    epilogue's) device, else the card.
    """

    #: blocks a stage holds (Interleaved1F1B: v_chunks)
    v_chunks = 1

    def __init__(self, block: Callable[[torch.Generator], nn.Module] | None, n_microbatches: int,
                 mesh: dict | None = None, optimizer: Optimizer | None = None,
                 axis_name: str = "stage", prologue: nn.Module | None = None,
                 epilogue: nn.Module | None = None, loss: Callable = softmax_cross_entropy,
                 remat: bool = False, batch_axis: str | None = None,
                 sentinel: bool | dict = False, obs=False,
                 device: str | torch.device | None = None):
        if not dist.is_initialized():
            raise RuntimeError(
                "pipeline engines need a process group: call "
                "tpudml_torch.core.distributed_init (or run inside process_group) first")
        mesh = dict(mesh) if mesh is not None else {axis_name: dist.get_world_size()}
        if axis_name not in mesh:
            raise ValueError(f"axis_name {axis_name!r} is not an axis of the mesh {mesh}")
        if batch_axis is not None and batch_axis not in mesh:
            raise ValueError(f"batch_axis {batch_axis!r} is not an axis of the mesh {mesh}")
        if set(mesh) - {axis_name, batch_axis}:
            raise ValueError(f"mesh {mesh} has axes beyond the stage axis and batch_axis")
        self.block = block
        self.n_microbatches = n_microbatches
        self.mesh = mesh
        self.axis_name = axis_name
        self.batch_axis = batch_axis
        self.n_stages = mesh[axis_name]
        self.prologue = prologue
        self.epilogue = epilogue
        self.loss = loss
        self.remat = remat
        if device is None:
            held = [p for m in (prologue, epilogue) if m is not None for p in m.parameters()]
            device = held[0].device if held else "cuda"
        self.device = torch.device(device)
        if dist.get_backend() != backend_for(self.device):
            raise RuntimeError(f"a {self.device.type} stage needs a "
                               f"{backend_for(self.device)} group; this one is "
                               f"{dist.get_backend()}")
        groups = mesh_groups(mesh)
        self.group, self.stage, _ = groups[axis_name]
        self.data_group, self.data_index, self.n_data = (
            groups[batch_axis] if batch_axis else (None, 0, 1))
        if self.n_stages > 1:
            # NCCL makes a group's communicator at its first collective; a
            # first batch_isend_irecv that not every rank joins may hang.
            dist.all_reduce(torch.zeros(1, device=self.device), group=self.group)
        for m in (prologue, epilogue):
            if m is not None:
                m.to(self.device)
        # The update runs on stage-local blocks: a global-norm clip sums the
        # stage leaves' squares over the stage group.
        self.optimizer = (shard_aware_clip(optimizer, (self.group,), stages_stacked)
                          if optimizer is not None else None)
        if isinstance(self.optimizer, ZeRO1):
            # PP×DP with ZeRO-1: the optimizer state chunks over the DATA
            # group on top of the stage layout.
            if batch_axis is None:
                reject("pp_zero1_needs_batch_axis")
            z = self.optimizer
            if z.axis_name != batch_axis or z.world != mesh[batch_axis]:
                raise ValueError(
                    f"ZeRO1(axis_name={z.axis_name!r}, world={z.world}) does not match "
                    f"batch_axis {batch_axis!r} of size {mesh[batch_axis]}")
            if z.group is None:
                z = dataclasses.replace(z, group=self.data_group)
            self.optimizer = with_stacked(z, stages_stacked)
        self.sentinel = None
        if sentinel:
            if self.optimizer is None:
                raise ValueError("sentinel needs an optimizer")
            kw = dict(sentinel) if isinstance(sentinel, dict) else {}
            self.optimizer = attach_sentinel(self.optimizer, (self.group,), **kw)
            self.sentinel = find_sentinel(self.optimizer)
        self.tracer: Tracer | None = None
        if obs:
            self.tracer = obs if isinstance(obs, Tracer) else Tracer()
        self.model: _PipelineModel | None = None
        self._chunks: list[nn.Module] = []
        self._plans: dict = {}
        self.tick_bytes: list[int] = []

    # ---------------------------------------------------------------- params

    def _validate_block(self, block: nn.Module) -> None:
        if _is_stateful(block):
            raise ValueError("pipeline blocks must be stateless (no BatchNorm)")
        if _has_dropout(block):
            # The GPipe schedule runs its blocks without dropout keys; a
            # silent no-op dropout would fake regularization.
            reject("gpipe_dropout")

    def _sigmas(self) -> list[int]:
        """The virtual stages this rank holds, chunk by chunk."""
        return [v * self.n_stages + self.stage for v in range(self.v_chunks)]

    def _draw_chunks(self, key: Key) -> list[nn.Module]:
        blocks = [self.block(key.fold_in(1).fold_in(sigma).generator()) for sigma in self._sigmas()]
        self._validate_block(blocks[0])
        return [b.to(self.device) for b in blocks]

    def _stage_holder(self, chunks: list[nn.Module]) -> nn.Module:
        """The ``stages`` leaves: each block parameter stacked ``[1, ...]``
        (``[1, V, ...]`` with chunks), the chunks' parameters rebound to
        views of them."""
        holder = nn.Module()
        chunked = isinstance(self, Interleaved1F1B)
        for name, _ in list(chunks[0].named_parameters()):
            parts = [c.get_parameter(name).detach() for c in chunks]
            stacked = (torch.stack(parts) if chunked else parts[0].clone()).unsqueeze(0)
            leaf = nn.Parameter(stacked)
            _register(holder, name, leaf)
            for v, c in enumerate(chunks):
                _rebind(c, name, nn.Parameter(leaf.data[0, v] if chunked else leaf.data[0]))
        return holder

    def init_params(self, key: Key | int = 0) -> dict[str, torch.Tensor]:
        """This rank's parameters by name (drawn once; module docstring)."""
        if self.model is None:
            key = key if isinstance(key, Key) else seed_key(key)
            self._chunks = self._draw_chunks(key)
            self.model = _PipelineModel(self.prologue, self._stage_holder(self._chunks),
                                        self.epilogue)
        return params_of(self.model)

    def param_specs(self) -> dict:
        """Prefix specs: stage leaves split over the stage axis on their
        leading dim, prologue and epilogue replicated."""
        return {"prologue": (), "stages": (self.axis_name,), "epilogue": ()}

    def create_state(self, key: Key | int = 0) -> TrainState:
        if self.optimizer is None:
            raise ValueError("create_state needs an optimizer")
        self.init_params(key)
        return TrainState.create(self.model, self.optimizer)

    def _named(self, part: str) -> list[tuple[str, nn.Parameter]]:
        m = getattr(self.model, part, None)
        return [] if m is None else [(f"{part}.{n}", p) for n, p in m.named_parameters()]

    # ----------------------------------------------------------- schedule hooks

    def _prep(self, x: torch.Tensor) -> torch.Tensor:
        """Raw rows -> the pipeline's input (stage 0 only)."""
        return self.prologue(x) if self.prologue is not None else x

    def _post(self, h: torch.Tensor) -> torch.Tensor:
        """The last stage's output -> logits."""
        return self.epilogue(h) if self.epilogue is not None else h

    def _run(self, v: int, x: torch.Tensor, key: Key | None = None) -> torch.Tensor:
        return _call(self._chunks[v], x, key)

    def _io_plan(self, x: torch.Tensor) -> list[tuple[tuple, torch.dtype]]:
        """(per-sample shape, dtype) at each of the V·S + 1 virtual-stage
        boundaries (the input of virtual stage σ, then the last output):
        all the prologue's output for shape-preserving blocks."""
        key = (tuple(x.shape[1:]), x.dtype)
        if key not in self._plans:
            shape, dtype = _probe(self.prologue, *key)
            self._plans[key] = [(shape[1:], dtype)] * (self.v_chunks * self.n_stages + 1)
        return self._plans[key]

    # ---------------------------------------------------------------- helpers

    def _micro_rows(self, batch: int) -> int:
        m = self.n_microbatches
        if batch % m:
            raise ValueError(f"batch {batch} not divisible by {m} microbatches")
        return batch // m

    def shard_batch(self, x, labels=None):
        """This rank's rows of a global batch on its device: all of them, or
        its data index's rows under ``batch_axis``."""
        if labels is None:
            labels = torch.zeros(len(x), dtype=torch.long)
        if self.batch_axis is not None:
            x, labels = shard_rows(x, labels, self.n_data, self.data_index, stacked=False)
        return to_device(x, self.device), to_device(labels, self.device)

    def _exchange(self, out_msgs: dict, in_specs: dict) -> dict:
        """One tick's traffic: ``out_msgs`` ``{peer: [(tag, tensor)]}``,
        ``in_specs`` ``{peer: [(tag, shape, dtype)]}`` (peers as stage
        indices, tags ``(kind, chunk)``); several tensors for one peer go
        as one flat message in tag order. Returns ``{tag: tensor}``."""
        got, sends, recvs, layout = {}, [], [], []
        for peer in sorted(out_msgs):
            msgs = sorted(out_msgs[peer], key=lambda m: m[0])
            if peer == self.stage:
                got.update(msgs)
            else:
                sends.append((peer, msgs[0][1] if len(msgs) == 1 else
                              torch.cat([t.reshape(-1) for _, t in msgs])))
        for peer in sorted(in_specs):
            specs = sorted(in_specs[peer], key=lambda s: s[0])
            if peer == self.stage:
                continue
            shape = specs[0][1] if len(specs) == 1 else (
                sum(torch.Size(s[1]).numel() for s in specs),)
            recvs.append((peer, shape, specs[0][2], self.device))
            layout.append(specs)
        for buf, specs in zip(stage_exchange(sends, recvs, self.group, self.tick_bytes), layout):
            if len(specs) == 1:
                got[specs[0][0]] = buf
            else:
                sizes = [torch.Size(s[1]).numel() for s in specs]
                got.update((s[0], piece.view(s[1])) for s, piece in zip(specs, buf.split(sizes)))
        return got

    def _stage_grads(self, g_ch: list[list[torch.Tensor]]) -> dict[str, torch.Tensor]:
        """The chunks' accumulated gradients as the ``stages`` leaves'."""
        chunked = isinstance(self, Interleaved1F1B)
        names = [n for n, _ in self._named("stages")]
        return {n: (torch.stack([g[i] for g in g_ch]) if chunked else g_ch[0][i]).unsqueeze(0)
                for i, n in enumerate(names)}

    @staticmethod
    def _accumulate(acc: list | None, new) -> list:
        return list(new) if acc is None else [a + b for a, b in zip(acc, new)]

    # --------------------------------------------------------------- schedule

    def _chunk_params(self, v: int) -> list[nn.Parameter]:
        return list(self._chunks[v].parameters())

    def _needs_dx(self, sigma: int) -> bool:
        """Whether virtual stage ``sigma`` owes its input a cotangent: to
        the previous stage, or, on the first, to the prologue."""
        return sigma > 0 or bool(self._named("prologue"))

    def _route(self, sigma: int, step: int) -> tuple[int, int]:
        """(stage, chunk) of virtual stage ``sigma + step``."""
        to = sigma + step
        return to % self.n_stages, to // self.n_stages

    def _forward_ticks(self, h_micro: list | None, plan, rows: int, grad: bool):
        """The all-forward ticks on this stage (micro m on virtual stage σ at
        tick σ + m): (inputs, outputs) by chunk and micro-batch, each output
        with its graph when ``grad`` (GPipe's forward; every schedule's
        :meth:`make_forward`)."""
        M, vs = self.n_microbatches, self.v_chunks * self.n_stages
        ins = [[None] * M for _ in range(self.v_chunks)]
        outs = [[None] * M for _ in range(self.v_chunks)]
        recv: dict = {}
        for t in range(M + vs - 1):
            out_msgs, in_specs = {}, {}
            for v, sigma in enumerate(self._sigmas()):
                m = t - sigma
                if 0 <= m < M:
                    x_in = (h_micro[m] if sigma == 0 else recv.pop((FWD, v))).detach()
                    x_in.requires_grad_(grad and self._needs_dx(sigma))
                    with torch.set_grad_enabled(grad):
                        if self.remat and grad:
                            out = torch.utils.checkpoint.checkpoint(self._run, v, x_in,
                                                                    use_reentrant=False)
                        else:
                            out = self._run(v, x_in)
                    ins[v][m], outs[v][m] = x_in, out
                    if sigma < vs - 1:
                        peer, chunk = self._route(sigma, 1)
                        out_msgs.setdefault(peer, []).append(((FWD, chunk), out.detach()))
                if sigma > 0 and 0 <= t - (sigma - 1) < M:
                    peer, _ = self._route(sigma, -1)
                    shape, dtype = plan[sigma]
                    in_specs.setdefault(peer, []).append(((FWD, v), (rows, *shape), dtype))
            recv = self._exchange(out_msgs, in_specs)
        return ins, outs

    def _gather_last(self, outs: list, plan, batch: int) -> torch.Tensor:
        """The last stage's outputs of every micro-batch, on every rank of
        the stage group (JAX's masked psum: a broadcast from the last)."""
        if self.stage == self.n_stages - 1:
            y = torch.cat(outs).detach()
        else:
            shape, dtype = plan[-1]
            y = torch.empty((batch, *shape), dtype=dtype, device=self.device)
        if self.n_stages > 1:
            dist.broadcast(y, src=dist.get_global_rank(self.group, self.n_stages - 1),
                           group=self.group)
        return y

    def _schedule(self, x: torch.Tensor, labels: torch.Tensor, step: int):
        """GPipe: (gradients by name, metrics) of this rank's rows."""
        s, S, M = self.stage, self.n_stages, self.n_microbatches
        rows = self._micro_rows(x.shape[0])
        plan = self._io_plan(x)
        self.tick_bytes = []
        pro = [p for _, p in self._named("prologue")]
        epi = [p for _, p in self._named("epilogue")]
        h = None
        if s == 0:
            with torch.enable_grad():
                h = self._prep(x)
        ins, outs = self._forward_ticks(None if h is None else list(h.split(rows)), plan, rows,
                                        grad=True)
        ins, outs = ins[0], outs[0]
        # Every rank: the epilogue and the loss on the whole batch.
        y = self._gather_last(outs, plan, x.shape[0]).requires_grad_(s == S - 1)
        with torch.enable_grad():
            logits = self._post(y)
            loss = self.loss(logits, labels)
        wrt = epi + ([y] if s == S - 1 else [])
        got = list(torch.autograd.grad(loss, wrt)) if wrt else []
        g_epi, dy = got[:len(epi)], (got[-1].split(rows) if s == S - 1 else None)
        metrics = {"loss": loss.detach(), "accuracy": accuracy(logits.detach(), labels)}
        del logits, y, loss
        # The backward ticks, in reverse.
        params = self._chunk_params(0)
        g_st, dxs, recv = None, [None] * M, None
        for t in reversed(range(M + S - 1)):
            m = t - s
            out_msgs, in_specs = {}, {}
            if 0 <= m < M:
                cot = dy[m] if s == S - 1 else recv
                wrt = params + ([ins[m]] if ins[m].requires_grad else [])
                d = torch.autograd.grad(outs[m], wrt, cot)
                outs[m] = ins[m] = None
                g_st = self._accumulate(g_st, d[:len(params)])
                if s > 0:
                    out_msgs[s - 1] = [((BWD, 0), d[-1])]
                elif pro:
                    dxs[m] = d[-1]
            if s < S - 1 and 0 <= t - (s + 1) < M:
                shape, dtype = plan[s + 1]
                in_specs[s + 1] = [((BWD, 0), (rows, *shape), dtype)]
            recv = self._exchange(out_msgs, in_specs).get((BWD, 0))
        g_pro = (list(torch.autograd.grad(h, pro, torch.cat(dxs))) if s == 0 and pro
                 else [torch.zeros_like(p) for p in pro])
        grads = {n: g for (n, _), g in zip(self._named("prologue"), g_pro)}
        if grads:  # stage 0's only; the sum replicates it
            grads = psum_tree(grads, self.group)
        grads.update(self._stage_grads([g_st]))
        grads.update((n, g) for (n, _), g in zip(self._named("epilogue"), g_epi))
        return grads, metrics

    # ------------------------------------------------------------ train step

    def _span(self):
        if self.tracer is None:
            return NULL_SPAN
        return self.tracer.span("train_step", cat="step", sync=self.device)

    def _step_stats(self, metrics: dict, grads: dict, opt_state, step: int):
        """The StepStats of the step: stage leaves' squares summed over the
        stage group, the replicated leaves' once; under ZeRO-1 PP×DP the
        data replicas' mean (JAX's convention)."""
        stage = {n: g for n, g in grads.items() if stages_stacked(n)}
        rest = [g for n, g in grads.items() if not stages_stacked(n)]
        normsq = psum_tree(grad_normsq(stage).to(self.device), self.group)
        normsq = normsq + grad_normsq(rest).to(self.device)
        if self.batch_axis and zero1_handles(self.optimizer, self.batch_axis):
            normsq = pmean_tree(normsq, self.data_group)
        return make_step_stats(metrics["loss"], normsq, opt_state, 0.0, step)

    def grads(self, x, labels, step: int = 0) -> tuple[dict, dict]:
        """(gradients by name, metrics) of one step on the global batch,
        without the update: the schedule, the stage group's sums and the
        means of PP×DP (the gradients as the optimizer gets them); ``step``
        folds the dropout keys. For holding a pipeline against a
        single-device step."""
        if self.model is None:
            raise RuntimeError("call create_state() before grads()")
        xb, yb = self.shard_batch(x, labels)
        grads, metrics = self._schedule(xb, yb, step)
        if self.batch_axis is not None:
            # PP×DP: each data replica pipelined its own rows.
            if not zero1_handles(self.optimizer, self.batch_axis):
                grads = pmean_tree(grads, self.data_group)
            metrics = pmean_tree(metrics, self.data_group)
        return grads, metrics

    def make_train_step(self) -> Callable:
        """(ts, x, labels) -> (ts, metrics): the schedule, the gradient and
        metric means of PP×DP, the update of this rank's leaves. Metrics:
        ``loss``, ``accuracy`` (and ``step_stats`` with obs)."""
        if self.optimizer is None:
            raise ValueError("make_train_step needs an optimizer")
        if self.model is None:
            raise RuntimeError("call create_state() before make_train_step()")

        def step(ts: TrainState, x, labels):
            with self._span():
                index = ts.step
                grads, metrics = self.grads(x, labels, index)
                _, ts.opt_state = self.optimizer.update(grads, ts.opt_state, params_of(ts.model))
                ts.step += 1
                if self.tracer is not None:
                    metrics = dict(metrics, step_stats=self._step_stats(metrics, grads,
                                                                        ts.opt_state, index))
            return ts, metrics

        return step

    # ---------------------------------------------------------------- forward

    def make_forward(self) -> Callable:
        """x (the global batch) -> logits of every row, on every rank: the
        pipeline forward without a graph (JAX's jitted ``make_forward``)."""
        if self.model is None:
            raise RuntimeError("call create_state() before make_forward()")

        @torch.no_grad()
        def forward(x):
            xb, _ = self.shard_batch(x)
            rows = self._micro_rows(xb.shape[0])
            plan = self._io_plan(xb)
            modes = [c.training for c in self._chunks]
            for c in self._chunks:
                c.eval()
            try:
                h = self._prep(xb).split(rows) if self.stage == 0 else None
                _, outs = self._forward_ticks(h, plan, rows, grad=False)
            finally:
                for c, mode in zip(self._chunks, modes):
                    c.train(mode)
            logits = self._post(self._gather_last(outs[-1], plan, xb.shape[0]))
            if self.batch_axis is not None:
                logits = all_gather_tree(logits, self.data_group, axis=0, tiled=True)
            return logits

        return forward

    def gather_params(self) -> dict[str, torch.Tensor]:
        """Every parameter whole (detached), the stage leaves all-gathered
        over the stage group to JAX's ``[S, ...]`` (call on every rank)."""
        params = {n: p.detach() for n, p in params_of(self.model).items()}
        stage = {n: p for n, p in params.items() if stages_stacked(n)}
        if stage:
            params.update(all_gather_tree(stage, self.group, axis=0, tiled=True))
        return params

    def sequential_forward(self, params: dict, x) -> torch.Tensor:
        """Single-device reference semantics on whole parameters (as
        :meth:`gather_params` returns them): prologue, the V·S blocks in
        virtual-stage order, epilogue. The pipeline must match it."""
        chunked = isinstance(self, Interleaved1F1B)
        x = to_device(x, self.device)
        with torch.no_grad():
            h = x if self.prologue is None else torch.func.functional_call(
                self.prologue, {n[9:]: t for n, t in params.items()
                                if n.startswith("prologue.")}, (x,))
            for sigma in range(self.v_chunks * self.n_stages):
                s, v = sigma % self.n_stages, sigma // self.n_stages
                local = {n[7:]: (t[s, v] if chunked else t[s]) for n, t in params.items()
                         if stages_stacked(n)}
                h = _call_with(self._chunks[0], local, h)
            if self.epilogue is not None:
                h = torch.func.functional_call(
                    self.epilogue, {n[9:]: t for n, t in params.items()
                                    if n.startswith("epilogue.")}, (h,))
        return h

    # ----------------------------------------------------------- checkpoints

    def _jax_layout(self, name: str, t: torch.Tensor, inverse: bool = False) -> torch.Tensor:
        """A conv kernel (4-D past the stacked stage dims) OIHW -> JAX's
        HWIO (``inverse``: back); every other leaf as it is."""
        k = (1 + isinstance(self, Interleaved1F1B)) if stages_stacked(name) else 0
        if not name.endswith("kernel") or t.dim() - k != 4:
            return t
        return t.permute(*range(k), *((k + 3, k + 2, k, k + 1) if inverse
                                      else (k + 2, k + 3, k + 1, k)))

    def _whole(self, state):
        """``state`` with each dict keyed by parameter names made whole: the
        stage leaves gathered over the stage group to ``[S, ...]``, conv
        kernels in JAX's layout; Python ints as int32."""
        import numpy as np

        names = set(params_of(self.model))
        if isinstance(state, dict):
            if state and set(state) <= names:
                out = {n: t.detach() for n, t in state.items()}
                stage = {n: t for n, t in out.items() if stages_stacked(n)}
                if stage:
                    out.update(all_gather_tree(stage, self.group, axis=0, tiled=True))
                return {n: self._jax_layout(n, t) for n, t in out.items()}
            return {k: self._whole(v) for k, v in state.items()}
        if isinstance(state, int) and not isinstance(state, bool):
            return np.int32(state)
        return state

    def full_state(self, ts: TrainState) -> list:
        """JAX's global view of ``ts`` for the base store (call on every
        rank): ``[params, model state, optimizer state, step]``, the stage
        leaves and their optimizer tensors gathered to ``[S, ...]``, conv
        kernels HWIO, Python ints as int32. Rank 0 writes it as JAX's task5
        writes its global arrays. (A ZeRO-1 state is chunked over the data
        group and is not gathered here.)"""
        import numpy as np

        if isinstance(self.optimizer, ZeRO1):
            raise NotImplementedError("full_state gathers the stage layout; a ZeRO-1 state "
                                      "is saved per rank")
        return [self._whole(params_of(ts.model)), {}, self._whole(ts.opt_state),
                np.int32(ts.step)]

    @torch.no_grad()
    def load_full_state(self, ts: TrainState, full: list) -> TrainState:
        """Write a :meth:`full_state` tree (whole leaves) back into ``ts`` in
        place: this rank's row of every stage leaf and of its optimizer
        tensors, the rest whole, the ints and the step as ints."""
        params, _, opt, step = full

        def local(name, t):
            t = self._jax_layout(name, torch.as_tensor(t), inverse=True)
            return t[self.stage:self.stage + 1] if stages_stacked(name) and t.dim() else t

        for n, p in params_of(ts.model).items():
            p.copy_(local(n, params[n]))

        def load(state, saved):
            for k, v in state.items():
                if isinstance(v, torch.Tensor):
                    v.copy_(local(k, saved[k]))
                elif isinstance(v, int) and not isinstance(v, bool):
                    state[k] = int(saved[k])
                elif isinstance(v, dict):
                    load(v, saved[k])

        load(ts.opt_state, opt)
        ts.step = int(step)
        return ts


def _call_with(module: nn.Module, params: dict, x: torch.Tensor) -> torch.Tensor:
    out = torch.func.functional_call(module, params, (x,))
    return out[0] if isinstance(out, tuple) else out


class OneFOneB(GPipe):
    """1F1B (one-forward-one-backward) schedule: at most V·S micro-batch
    inputs live a stage instead of GPipe's M graphs, and dropout works
    (``rng_root``: per-(virtual stage, micro) keys refolded in the
    recompute, so gradients are exact for the dropout-applied function).
    Module docstring for the tick plan."""

    def __init__(self, *args, rng_root: Key | None = None, **kwargs):
        self.rng_root = rng_root
        super().__init__(*args, **kwargs)

    def _validate_block(self, block: nn.Module) -> None:
        if _is_stateful(block):
            raise ValueError("pipeline blocks must be stateless (no BatchNorm)")
        if _has_dropout(block) and self.rng_root is None:
            raise ValueError("dropout pipeline stages need rng_root")

    def _prep_micro(self, xm: torch.Tensor) -> torch.Tensor:
        """Stage 0's input of one micro-batch (the prologue on its rows)."""
        return self._prep(xm)

    def _key_for(self, step_key: Key | None, sigma: int, m: int) -> Key | None:
        if step_key is None:
            return None
        key = step_key.fold_in(sigma).fold_in(m)
        if self.batch_axis:
            # Decorrelate the data replicas' masks (DataParallel's contract).
            key = key.fold_in(self.data_index)
        return key

    def _schedule(self, x: torch.Tensor, labels: torch.Tensor, step: int):
        V, M = self.v_chunks, self.n_microbatches
        vs = V * self.n_stages
        rows = self._micro_rows(x.shape[0])
        plan = self._io_plan(x)
        xs, ys = x.split(rows), labels.split(rows)
        train = self.rng_root is not None
        step_key = self.rng_root.fold_in(step) if train else None
        drop = train and _has_dropout(self._chunks[0])
        for c in self._chunks:
            c.train(train)
        pro = [p for _, p in self._named("prologue")]
        epi = [p for _, p in self._named("epilogue")]
        params = [self._chunk_params(v) for v in range(V)]
        acts = [[None] * vs for _ in range(V)]
        fwd_in, bwd_in = {}, {}
        g_ch, g_pro, g_epi = [None] * V, None, None
        loss_sum = torch.zeros((), device=self.device)
        acc_sum = torch.zeros((), device=self.device)
        self.tick_bytes = []
        for t in range(2 * (M + vs - 1)):
            out_msgs: dict = {}
            for v, sigma in enumerate(self._sigmas()):
                # ---------------------------------------------- forward unit
                mf = _unit(t - sigma, M)
                if mf is not None:
                    if sigma == 0:
                        with torch.no_grad():
                            x_in = self._prep_micro(xs[mf])
                    else:
                        x_in = fwd_in.pop((FWD, v))
                    acts[v][mf % vs] = x_in
                    # The last virtual stage's forward fuses into its
                    # backward tick; its forward unit only banks the input.
                    if sigma < vs - 1:
                        key_f = self._key_for(step_key, sigma, mf) if drop else None
                        with torch.no_grad():
                            y = self._run(v, x_in, key_f)
                        peer, chunk = self._route(sigma, 1)
                        out_msgs.setdefault(peer, []).append(((FWD, chunk), y))
                # --------------------------------------------- backward unit
                mb = _unit(t - (2 * vs - sigma - 1), M)
                if mb is None:
                    continue
                x_saved = acts[v][mb % vs].detach().requires_grad_(self._needs_dx(sigma))
                acts[v][mb % vs] = None
                key_b = self._key_for(step_key, sigma, mb) if drop else None
                dxs = [x_saved] if x_saved.requires_grad else []
                n = len(params[v])
                with torch.enable_grad():
                    out = self._run(v, x_saved, key_b)
                    if sigma == vs - 1:
                        logits = self._post(out)
                        loss_m = self.loss(logits, ys[mb])
                        d = torch.autograd.grad(loss_m, params[v] + epi + dxs,
                                                torch.full_like(loss_m, 1.0 / M))
                        g_epi = self._accumulate(g_epi, d[n:n + len(epi)])
                        loss_sum = loss_sum + loss_m.detach()
                        acc_sum = acc_sum + accuracy(logits.detach(), ys[mb])
                        del logits
                    else:
                        d = torch.autograd.grad(out, params[v] + dxs, bwd_in.pop((BWD, v)))
                d_ch, dx = d[:n], (d[-1] if dxs else None)
                del out
                g_ch[v] = self._accumulate(g_ch[v], d_ch)
                if sigma == 0:
                    # The model input is virtual stage 0: its cotangent goes
                    # through the prologue.
                    if pro:
                        with torch.enable_grad():
                            h = self._prep_micro(xs[mb])
                        g_pro = self._accumulate(g_pro, torch.autograd.grad(h, pro, dx))
                else:
                    peer, chunk = self._route(sigma, -1)
                    out_msgs.setdefault(peer, []).append(((BWD, chunk), dx))
            # ------------------------------------------------- the ring
            in_specs: dict = {}
            for v, sigma in enumerate(self._sigmas()):
                if sigma > 0 and _unit(t - (sigma - 1), M) is not None:
                    peer, _ = self._route(sigma, -1)
                    shape, dtype = plan[sigma]
                    in_specs.setdefault(peer, []).append(((FWD, v), (rows, *shape), dtype))
                if sigma < vs - 1 and _unit(t - (2 * vs - sigma - 2), M) is not None:
                    peer, _ = self._route(sigma, 1)
                    shape, dtype = plan[sigma + 1]
                    in_specs.setdefault(peer, []).append(((BWD, v), (rows, *shape), dtype))
            for tag, tensor in self._exchange(out_msgs, in_specs).items():
                (fwd_in if tag[0] == FWD else bwd_in)[tag] = tensor
        if g_pro is None:
            g_pro = [torch.zeros_like(p) for p in pro]
        if g_epi is None:
            g_epi = [torch.zeros_like(p) for p in epi]
        grads = {n: g for (n, _), g in zip(self._named("prologue"), g_pro)}
        grads.update((n, g) for (n, _), g in zip(self._named("epilogue"), g_epi))
        # Stage 0 holds the prologue's gradients, the last stage the
        # epilogue's and the loss: one sum replicates them all.
        summed = psum_tree({**grads, "_loss": loss_sum, "_acc": acc_sum}, self.group)
        metrics = {"loss": summed.pop("_loss") / M, "accuracy": summed.pop("_acc") / M}
        grads = dict(summed)
        grads.update(self._stage_grads(g_ch))
        return grads, metrics


class Interleaved1F1B(OneFOneB):
    """Interleaved (virtual-stage) 1F1B: each stage holds ``v_chunks``
    non-adjacent blocks, block σ = v·S + s on stage s, so the model is V·S
    blocks deep and a tick's unit is one block. The tick plan is
    OneFOneB's over virtual stages; the ring wraps from stage S − 1 to
    stage 0 at each chunk boundary. ``v_chunks=1`` is OneFOneB's
    schedule. A stage's forward output and input cotangent of several
    chunks that go to one neighbour in one tick travel as one message: at
    most V activation slots a tick, JAX's combined-buffer floor for even
    S, and under its 2·⌈V/2⌉ for odd S."""

    def __init__(self, *args, v_chunks: int = 2, rng_root: Key | None = None, **kwargs):
        if v_chunks < 1:
            raise ValueError(f"v_chunks {v_chunks} must be >= 1")
        self.v_chunks = v_chunks
        super().__init__(*args, rng_root=rng_root, **kwargs)


class HeteroPipeline(GPipe):
    """Micro-batched pipeline over HETEROGENEOUS stages: the reference's
    conv stage feeding its fc stage (codes/task4/model.py:18-47). Rank s
    holds ``stages[s]`` as its module (parameters ``stages.<its names>``)
    and sends its real activation shape, planned once per input shape on
    the meta device; stage 0 takes the raw rows (``nhwc_input``: NHWC
    images viewed NCHW-indexed, as ``StagedModel`` does) and the last
    stage's output is the logits. The stages come drawn (JAX draws them
    in ``init_params``). Stateless stages; dropout needs HeteroOneFOneB
    with ``rng_root``."""

    def __init__(self, stages: Sequence[nn.Module], n_microbatches: int,
                 mesh: dict | None = None, optimizer: Optimizer | None = None,
                 axis_name: str = "stage", loss: Callable = softmax_cross_entropy,
                 remat: bool = False, batch_axis: str | None = None,
                 nhwc_input: bool = False, **schedule_kw):
        width = (mesh or {axis_name: dist.get_world_size() if dist.is_initialized() else 1}
                 ).get(axis_name)
        if width != len(stages):
            raise ValueError(f"{len(stages)} stages need a {len(stages)}-wide {axis_name!r} "
                             f"mesh axis, got {width}")
        # No prologue/epilogue: stage 0 is the prologue and the last stage
        # the epilogue; accepting them would silently drop the user's layers.
        bad = set(schedule_kw) - {"rng_root"}
        if bad:
            raise TypeError(f"hetero pipelines do not take {sorted(bad)} (stage 0 is the "
                            "prologue, the last stage is the epilogue)")
        for i, st in enumerate(stages):
            if _has_dropout(st) and schedule_kw.get("rng_root") is None:
                raise ValueError(f"stage {i} has dropout; use HeteroOneFOneB with rng_root "
                                 "(the GPipe hetero schedule runs without rng)")
            if _is_stateful(st):
                raise ValueError(f"stage {i} is stateful (no BatchNorm in pipelines)")
        self.stages = tuple(stages)
        self.nhwc_input = nhwc_input
        device = next((p.device for st in stages for p in st.parameters()), None)
        super().__init__(None, n_microbatches, mesh=mesh, optimizer=optimizer,
                         axis_name=axis_name, loss=loss, remat=remat, batch_axis=batch_axis,
                         device=device, **schedule_kw)

    def _validate_block(self, block: nn.Module) -> None:
        pass  # the stages were checked at construction

    def _draw_chunks(self, key: Key) -> list[nn.Module]:
        return [self.stages[self.stage].to(self.device)]

    def _stage_holder(self, chunks: list[nn.Module]) -> nn.Module:
        return chunks[0]

    def _stage_grads(self, g_ch: list[list[torch.Tensor]]) -> dict[str, torch.Tensor]:
        return {n: g for (n, _), g in zip(self._named("stages"), g_ch[0])}

    def _prep(self, x: torch.Tensor) -> torch.Tensor:
        return x.permute(0, 3, 1, 2) if self.nhwc_input and x.dim() == 4 else x

    def _io_plan(self, x: torch.Tensor) -> list[tuple[tuple, torch.dtype]]:
        """(per-sample shape, dtype) of the input of each stage and of the
        last output, planned on the meta device; stages must be per-sample
        maps."""
        key = (tuple(x.shape[1:]), x.dtype)
        if key not in self._plans:
            shape, dtype = key
            if self.nhwc_input and len(shape) == 3:
                shape = (shape[2], shape[0], shape[1])
            plan = [(shape, dtype)]
            for i, st in enumerate(self.stages):
                out, dtype = _probe(st, plan[-1][0], plan[-1][1])
                if out[0] != 2:
                    raise ValueError(f"stage {i} changed the batch dim (2 -> {out[0]}); "
                                     "stages must be per-sample maps")
                plan.append((out[1:], dtype))
            self._plans[key] = plan
        return self._plans[key]

    def full_state(self, ts: TrainState) -> list:
        raise NotImplementedError(
            "a heterogeneous stage's leaves are its own (JAX ravels them into one [S, L] "
            "row: interop.hetero_stage_to_tpudml); save each rank's state")

    def sequential_forward(self, params: dict, x) -> torch.Tensor:
        """The stages in order on one device; ``params`` by stage index:
        ``{s: {name: tensor}}`` (each stage's own names)."""
        h = self._prep(to_device(x, self.device))
        with torch.no_grad():
            for s, st in enumerate(self.stages):
                h = _call_with(st, params[s], h) if s in params else _call(st, h, None)
        return h


class HeteroOneFOneB(HeteroPipeline, OneFOneB):
    """The 1F1B schedule over heterogeneous stages: S-bounded activation
    memory and dropout (``rng_root``) for the conv→fc split. HeteroPipeline
    contributes the stage modules and their IO plan, OneFOneB the tick
    schedule."""


__all__ = ["GPipe", "HeteroOneFOneB", "HeteroPipeline", "Interleaved1F1B", "OneFOneB"]
