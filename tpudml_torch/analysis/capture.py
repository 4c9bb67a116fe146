"""One recorded step: the port's counterpart of tracing a step to a jaxpr.

JAX's graph pass walks an abstract program. The port's records one REAL
step, eager, on the device its tensors lie on (tiny on the CPU, or at full
width on the card), and the rules of :mod:`~tpudml_torch.analysis.graph_pass`
read the record. :func:`capture` runs ``fn(*args)`` once with:

- a ``TorchDispatchMode`` that records every aten op (the backward's too:
  autograd carries the mode onto its device thread) with the serial, shape
  and dtype of each tensor it reads and writes, and whether a tensor is an
  argument of the step, a parameter or buffer of a module the step holds,
  made earlier in the step, or none of these (``external``: a constant the
  step closes over);
- the ``torch.distributed`` collectives wrapped, as
  ``comm.collectives.wire_meter`` wraps them, so that each is recorded
  under JAX's primitive name (``psum``, ``all_gather``, ``psum_scatter``,
  ``all_to_all``, ``ppermute``, ...) with its process group, the mesh axis
  that group stands for (``axes``) and its operand's shape;
- every kernel launch by name (``ops.cuda_lib.Kernel.launch`` calls
  :func:`tpudml_torch.markers.on_launch`, which costs a global read while
  no capture runs);
- the regions that ``tpudml_torch.markers`` opens, under JAX's marker
  strings, with their operands; a kernel wrapper's region and the fused
  heads' are opaque: the rules read each as one node, which holds the
  plain version's ops on the CPU and one launch on the card;
- every device→host read: ``.item()``/``bool()`` (``_local_scalar_dense``),
  ``.tolist()``, ``.cpu()``, ``.numpy()``, ``.to("cpu")``, a copy of a
  card tensor to the CPU, and the ops whose output shape depends on the
  data (``nonzero``, boolean-mask indexing, ...), which wait for the card.
  Python-level reads are taken by wrapping the ``Tensor`` methods, so the
  same step gives the same reads on both devices.

Each event carries the innermost stack frame inside ``tpudml_torch/`` (or
inside the file that defines ``fn``) as its ``file:line``. An op that
autograd runs on its own thread, where no Python frame of the package is,
takes the frame of the thread that started the backward.
"""

from __future__ import annotations

import inspect
import sys
import threading
import time
from collections import Counter
from dataclasses import dataclass, field, fields, is_dataclass
from pathlib import Path
from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.weak import WeakIdKeyDictionary

from tpudml_torch import markers
from tpudml_torch.ops.decode_head import FUSED_HEAD_INT8_MARKER, FUSED_HEAD_MARKER
from tpudml_torch.ops.xent_kernel import FUSED_XENT_MARKER, SHARDED_XENT_MARKER

PKG_DIR = Path(__file__).resolve().parent.parent
REPO_DIR = PKG_DIR.parent
# Frames never taken as an anchor: the capture's own machinery.
_SKIP_FILES = {str(PKG_DIR / "markers.py"), str(PKG_DIR / "ops" / "cuda_lib.py")}
_SKIP_DIRS = (str(PKG_DIR / "analysis") + "/",)

#: Regions the rules read as one node (module docstring): every kernel
#: wrapper's, and the composite heads whose CPU route is a plain version.
OPAQUE_MARKERS = frozenset({FUSED_XENT_MARKER, SHARDED_XENT_MARKER, FUSED_HEAD_MARKER,
                            FUSED_HEAD_INT8_MARKER})

# torch.distributed entry point -> (JAX's primitive, the payload argument).
_COLLECTIVES = {
    "all_reduce": ("psum", "tensor"),
    "broadcast": ("pbroadcast", "tensor"),
    "all_gather_into_tensor": ("all_gather", "input_tensor"),
    "all_gather": ("all_gather", "tensor"),
    "reduce_scatter_tensor": ("psum_scatter", "input"),
    "reduce_scatter": ("psum_scatter", "input_list"),
    "all_to_all_single": ("all_to_all", "input"),
    "all_to_all": ("all_to_all", "input_tensor_list"),
    "send": ("ppermute", "tensor"),
    "recv": ("ppermute", "tensor"),
    "isend": ("ppermute", "tensor"),
    "irecv": ("ppermute", "tensor"),
    "batch_isend_irecv": ("ppermute", "p2p_op_list"),
}
# The argument a collective writes its result into.
_COLLECTIVE_OUT = {"all_gather_into_tensor": "output_tensor", "all_gather": "tensor_list",
                   "reduce_scatter_tensor": "output", "reduce_scatter": "output",
                   "all_to_all_single": "output", "all_to_all": "output_tensor_list",
                   "all_reduce": "tensor", "broadcast": "tensor", "recv": "tensor",
                   "irecv": "tensor"}
# Namespaces of the dispatcher's own collective ops (taken at the
# torch.distributed call instead) and of the profiler's markers.
_SKIP_NAMESPACES = frozenset({"c10d", "_c10d_functional", "c10d_functional", "profiler"})
# Ops whose output shape depends on the data: on the card each waits for it.
_DATA_SHAPED = frozenset({"nonzero", "masked_select", "_unique2", "unique_dim",
                          "unique_consecutive", "_unique", "bincount"})
# Library functions that read the host for a range check on the CPU only
# (PyTorch skips it for CUDA tensors): their reads are not the step's.
_CPU_ONLY_CHECKS = ((torch.nn.functional, "one_hot"),)
_SYNC_METHODS = ("tolist", "cpu", "numpy", "to")


def is_opaque(name: str) -> bool:
    return name.startswith(markers.KERNEL_PREFIX) or name in OPAQUE_MARKERS


@dataclass(frozen=True)
class TensorInfo:
    """A tensor as the step saw it first."""

    serial: int
    shape: tuple
    dtype: str  # "float32", "bfloat16", ...
    nbytes: int
    kind: str  # arg | param | buffer | step | external
    device: str
    name: str = ""  # a parameter's or buffer's name


@dataclass
class Event:
    """One recorded op, collective, launch or host read."""

    index: int
    kind: str  # op | collective | launch | sync
    name: str  # aten op ("mul", "sub_", ...), JAX collective name, kernel name, read
    inputs: tuple = ()  # tensor serials read
    outputs: tuple = ()  # tensor serials written (new or in place)
    mutated: tuple = ()  # serials of the inputs written in place
    file: str = ""
    line: int = 0
    region: int | None = None  # innermost region (id)
    opaque: int | None = None  # outermost opaque region (id), if inside one
    thread: int = 0  # the recording thread (autograd runs a CUDA backward on its own)
    extra: dict = field(default_factory=dict)


@dataclass
class Region:
    """One entry into a marked region."""

    id: int
    name: str
    parent: int | None
    opaque: bool
    inputs: tuple  # tensor serials among its operands
    arg_shapes: tuple  # (shape, dtype) of each operand tensor, in order
    file: str = ""
    line: int = 0
    first: int = 0  # its events: [first, last)
    last: int = 0


@dataclass
class Capture:
    """What one recorded step did (module docstring)."""

    name: str = ""
    events: list = field(default_factory=list)
    regions: list = field(default_factory=list)
    tensors: dict = field(default_factory=dict)  # serial -> TensorInfo
    launches: Counter = field(default_factory=Counter)
    error: BaseException | None = None
    result: Any = None
    wall_s: float = 0.0
    sharded: dict = field(default_factory=dict)  # serial -> mesh axes of its last dim
    result_serials: tuple = ()  # the tensors the step returned
    error_at: tuple = ("", 0)  # (file, line) where the step raised

    def region_names(self) -> set:
        return {r.name for r in self.regions}

    def collectives(self) -> list:
        return [e for e in self.events if e.kind == "collective"]


class _RegionCtx:
    __slots__ = ("rec", "region", "stack", "tensors")

    def __init__(self, rec, region, stack, tensors):
        self.rec, self.region, self.stack, self.tensors = rec, region, stack, tensors

    def __enter__(self):
        self.stack.append(self.region)
        return self

    def __exit__(self, *exc):
        self.stack.pop()
        self.region.last = len(self.rec.cap.events)
        return False

    def outputs(self, out) -> None:
        """The region's result: autograd nodes between it and the region's
        operands belong to the region, so that the backward's ops they run
        (on the CPU: the plain version's) stay inside it."""
        if self.region.opaque and torch.is_grad_enabled():
            self.rec.claim_backward(self.region, self.tensors, out)


def _shape_key(t: torch.Tensor) -> tuple:
    return tuple(t.shape), str(t.dtype).replace("torch.", "")


class _Recorder(TorchDispatchMode):
    """The dispatch mode and every hook of one capture."""

    def __init__(self, cap: Capture, files: tuple, axes: dict, known: list,
                 thread: int):
        super().__init__()
        self.cap = cap
        self.ids = WeakIdKeyDictionary()
        self.keep: list = []  # registered tensors stay alive (their ids stay theirs)
        self.files = {str(Path(f).resolve()) for f in files}
        self.axes = axes  # id(group) -> axis name
        self.thread = thread
        self.stacks: dict = {}  # thread ident -> [Region]
        self.node_region: dict = {}  # id(autograd node) -> Region
        self.nodes: list = []  # the claimed nodes, kept alive so that their ids stay theirs
        self.rel: dict = {}
        self.quiet = threading.local()  # inside a wrapped host read
        self.mutating: dict = {}
        # Tensors that live on the step's device: its arguments, parameters
        # and everything computed from them. A host read of any other tensor
        # (a CPU scalar the step builds with torch.tensor) waits for nothing.
        self.device_born: set = set()
        self.in_collective = 0
        for obj, kind in known:
            self._register(obj, kind, set(), "")

    # -- tensors ------------------------------------------------------
    def _new(self, t: torch.Tensor, kind: str, name: str = "") -> int:
        serial = len(self.cap.tensors)
        self.ids[t] = serial
        if kind in ("arg", "param", "buffer") or t.device.type != "cpu":
            self.device_born.add(serial)
        shape, dtype = _shape_key(t)
        self.cap.tensors[serial] = TensorInfo(
            serial, shape, dtype, t.numel() * t.element_size(), kind, t.device.type, name)
        return serial

    def _register(self, obj, kind: str, seen: set, prefix: str) -> None:
        if id(obj) in seen:
            return
        seen.add(id(obj))
        if isinstance(obj, torch.nn.Module):
            for n, p in obj.named_parameters():
                if p not in self.ids:
                    self.keep.append(p)
                    self._new(p, "param", n)
            for n, b in obj.named_buffers():
                if b not in self.ids:
                    self.keep.append(b)
                    self._new(b, "buffer", n)
        elif isinstance(obj, torch.Tensor):
            if obj not in self.ids:
                self.keep.append(obj)
                self._new(obj, kind, prefix)
        elif isinstance(obj, dict):
            for k, v in obj.items():
                self._register(v, kind, seen, f"{prefix}.{k}" if prefix else str(k))
        elif isinstance(obj, (list, tuple)):
            for i, v in enumerate(obj):
                self._register(v, kind, seen, f"{prefix}[{i}]")
        elif is_dataclass(obj) and not isinstance(obj, type):
            for f in fields(obj):
                self._register(getattr(obj, f.name), kind, seen,
                               f"{prefix}.{f.name}" if prefix else f.name)

    def serial(self, t: torch.Tensor) -> int:
        s = self.ids.get(t)
        if s is None:  # a backend's own temporary, inside a collective, is the step's
            s = self._new(t, "step" if self.in_collective else "external")
        return s

    def serials(self, obj) -> tuple:
        return tuple(self.serial(t) for t in tree_flatten(obj)[0]
                     if isinstance(t, torch.Tensor))

    # -- where ---------------------------------------------------------
    def _rel_of(self, filename: str):
        r = self.rel.get(filename, 0)
        if r == 0:
            r = self.rel[filename] = anchor_path(filename, self.files)
        return r

    def _walk(self, f) -> tuple:
        while f is not None:
            r = self._rel_of(f.f_code.co_filename)
            if r is not None:
                return r, f.f_lineno
            f = f.f_back
        return None

    def anchor(self) -> tuple:
        hit = self._walk(sys._getframe(2))
        if hit is None and threading.get_ident() != self.thread:
            hit = self._walk(sys._current_frames().get(self.thread))
        return hit or ("", 0)

    def _stack(self) -> list:
        ident = threading.get_ident()
        s = self.stacks.get(ident)
        if s is None:
            s = self.stacks[ident] = []
        return s

    def _where(self) -> tuple:
        """(innermost region, outermost opaque region) of the current op."""
        stack = self._stack()
        inner = stack[-1].id if stack else None
        for r in stack:
            if r.opaque:
                return inner, r.id
        if self.node_region:
            node = torch._C._current_autograd_node()
            if node is not None:
                r = self.node_region.get(id(node))
                if r is not None:
                    return r.id if inner is None else inner, r.id
        return inner, None

    def record(self, kind: str, name: str, inputs=(), outputs=(), mutated=(), **extra):
        file, line = self.anchor()
        inner, opaque = self._where()
        ev = Event(len(self.cap.events), kind, name, tuple(inputs), tuple(outputs),
                   tuple(mutated), file, line, inner, opaque, threading.get_ident(), extra)
        self.cap.events.append(ev)
        return ev

    # -- regions --------------------------------------------------------
    def region(self, name: str, args) -> _RegionCtx:
        stack = self._stack()
        tensors = [t for t in tree_flatten(args)[0] if isinstance(t, torch.Tensor)]
        file, line = self.anchor()
        reg = Region(len(self.cap.regions), name, stack[-1].id if stack else None,
                     is_opaque(name), tuple(self.serial(t) for t in tensors),
                     tuple(_shape_key(t) for t in tensors), file, line,
                     len(self.cap.events), len(self.cap.events))
        self.cap.regions.append(reg)
        return _RegionCtx(self, reg, stack, tensors)

    def claim_backward(self, region: Region, tensors: list, out) -> None:
        stop = {id(t.grad_fn) for t in tensors if t.grad_fn is not None}
        todo = [t.grad_fn for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor) and t.grad_fn is not None]
        while todo:
            node = todo.pop()
            if node is None or id(node) in stop or id(node) in self.node_region:
                continue
            if type(node).__name__ == "AccumulateGrad":
                continue
            self.node_region[id(node)] = region
            self.nodes.append(node)
            todo.extend(n for n, _ in node.next_functions)

    def on_launch(self, kernel_name: str) -> None:
        self.cap.launches[kernel_name] += 1
        self.record("launch", kernel_name)

    # -- ops ------------------------------------------------------------
    def _mutated_args(self, func) -> tuple:
        m = self.mutating.get(func)
        if m is None:
            m = tuple(i for i, a in enumerate(func._schema.arguments)
                      if a.alias_info is not None and a.alias_info.is_write)
            self.mutating[func] = m
        return m

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = self.serials((args, kwargs))
        if func.namespace in _SKIP_NAMESPACES:
            # Not an event of its own (the collective is recorded at its
            # torch.distributed call), but what it makes is the step's.
            outs = [self._new(t, "step") if self.ids.get(t) is None else self.ids[t]
                    for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
            if any(s in self.device_born for s in ins):
                self.device_born.update(outs)
            return out
        name = func.overloadpacket.__name__
        mut_pos = self._mutated_args(func)
        mutated = tuple(self.serial(args[i]) for i in mut_pos
                        if i < len(args) and isinstance(args[i], torch.Tensor))
        outs = []
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                s = self.ids.get(t)
                outs.append(self._new(t, "step") if s is None else s)
        if any(s in self.device_born for s in ins):
            self.device_born.update(outs)
        extra = {}
        if name == "argmax":
            dim = args[1] if len(args) > 1 else kwargs.get("dim")
            extra = {"last_axis": dim is not None and dim in (-1, args[0].dim() - 1)}
        elif name == "_to_copy":
            src = args[0]
            extra = {"from": str(src.dtype).replace("torch.", ""),
                     "to": str(kwargs.get("dtype", src.dtype)).replace("torch.", ""),
                     "src_device": src.device.type,
                     "dst_device": torch.device(kwargs.get("device") or src.device).type}
        ev = self.record("op", name, ins, outs, mutated, **extra)
        if not getattr(self.quiet, "on", False) and any(s in self.device_born for s in ins):
            read = None
            if name == "_local_scalar_dense":
                read = ".item()"
            elif name in _DATA_SHAPED:
                read = f"{name} (its output shape waits for the data)"
            elif name == "index" and any(
                    isinstance(t, torch.Tensor) and t.dtype in (torch.bool, torch.uint8)
                    for t in tree_flatten(args[1:])[0]):
                read = "boolean-mask indexing (its output shape waits for the data)"
            elif (name == "_to_copy" and extra["src_device"] != "cpu"
                  and extra["dst_device"] == "cpu"):
                read = "a copy to the CPU"
            if read is not None:
                self.cap.events.append(Event(len(self.cap.events), "sync", read, ins, outs,
                                             (), ev.file, ev.line, ev.region, ev.opaque,
                                             ev.thread))
        return out

    # -- collectives and host reads ----------------------------------------
    def wrap_collective(self, fn_name: str, fn: Callable) -> Callable:
        prim, payload_arg = _COLLECTIVES[fn_name]
        sig = inspect.signature(fn)

        def call(*args, **kwargs):
            bound = sig.bind(*args, **kwargs).arguments
            payload = bound.get(payload_arg)
            group = bound.get("group")
            if fn_name == "batch_isend_irecv":
                group = payload[0].group if payload else None
                payload = [op.tensor for op in payload]
            tensors = [t for t in tree_flatten(payload)[0] if isinstance(t, torch.Tensor)]
            op = prim
            if fn_name == "all_reduce":
                red = bound.get("op", dist.ReduceOp.SUM)
                op = {dist.ReduceOp.MAX: "pmax", dist.ReduceOp.MIN: "pmin"}.get(red, "psum")
            grp = dist.group.WORLD if group is None else group
            member = grp is not None and grp != dist.GroupMember.NON_GROUP_MEMBER
            if member:
                try:
                    member = dist.get_rank(grp) >= 0
                except (RuntimeError, ValueError):
                    member = False
            axis = self.axes.get(id(grp))
            shape = tuple(tensors[0].shape) if tensors else ()
            ranks = None
            if member:
                try:
                    ranks = tuple(dist.get_process_group_ranks(grp))
                except (RuntimeError, ValueError):
                    ranks = None
            written = bound.get(_COLLECTIVE_OUT.get(fn_name, ""))
            outs = self.serials(written) if written is not None else ()
            self.record("collective", op, self.serials(tensors), outs, (),
                        call=fn_name, axis=axis, member=member, ranks=ranks, shape=shape,
                        nbytes=sum(t.numel() * t.element_size() for t in tensors))
            self.in_collective += 1
            try:
                return fn(*args, **kwargs)
            finally:
                self.in_collective -= 1

        return call

    def wrap_read(self, meth: str, fn: Callable) -> Callable:
        rec = self

        def call(t, *args, **kwargs):
            if meth == "to":
                targets = [a for a in (*args, kwargs.get("device")) if a is not None]
                explicit = any(isinstance(a, str) and a == "cpu" for a in targets)
                moved = t.device.type != "cpu" and any(
                    isinstance(a, (str, torch.device)) and torch.device(a).type == "cpu"
                    for a in targets)
                if not (explicit or moved):
                    return fn(t, *args, **kwargs)
            if getattr(rec.quiet, "on", False) or rec.serial(t) not in rec.device_born:
                return fn(t, *args, **kwargs)
            rec.record("sync", f".{meth}()", (rec.serial(t),))
            rec.quiet.on = True
            try:
                return fn(t, *args, **kwargs)
            finally:
                rec.quiet.on = False

        return call

    def wrap_quiet(self, fn: Callable) -> Callable:
        rec = self

        def call(*args, **kwargs):
            was = getattr(rec.quiet, "on", False)
            rec.quiet.on = True
            try:
                return fn(*args, **kwargs)
            finally:
                rec.quiet.on = was

        return call


def anchor_path(filename: str, files=()) -> str | None:
    """The repo-relative path of a frame's file if it may anchor a finding
    (inside the package but the capture's own machinery, or one of
    ``files``, resolved paths), else None."""
    path = str(Path(filename).resolve()) if filename[:1] != "<" else filename
    if path in files or (path.startswith(str(PKG_DIR) + "/") and path not in _SKIP_FILES
                         and not path.startswith(_SKIP_DIRS)):
        return _repo_rel(path)
    return None


def error_anchor(exc: BaseException, files=()) -> tuple:
    """(file, line) of the innermost traceback frame of ``exc`` that may
    anchor a finding, else ("", 0)."""
    hit = ("", 0)
    tb = exc.__traceback__
    while tb is not None:
        r = anchor_path(tb.tb_frame.f_code.co_filename, files)
        if r is not None:
            hit = (r, tb.tb_lineno)
        tb = tb.tb_next
    return hit


def _repo_rel(path: str) -> str:
    try:
        return str(Path(path).relative_to(REPO_DIR))
    except ValueError:
        return path


def group_axes(axes: dict | None) -> dict:
    """``{axis: group}`` (None = the default group) as ``{id(group): axis}``."""
    out = {}
    for axis, group in (axes or {}).items():
        grp = dist.group.WORLD if group is None else group
        out.setdefault(id(grp), axis)
    return out


def _fn_files(fn) -> tuple:
    code = getattr(inspect.unwrap(fn), "__code__", None)
    return (code.co_filename,) if code is not None else ()


def capture(fn: Callable, args: tuple, *, name: str = "", modules=(),
            axes: dict | None = None, sharded: dict | None = None) -> Capture:
    """Run ``fn(*args)`` once and record it (module docstring).

    ``modules`` (and any ``nn.Module`` inside ``args``) give the step's
    parameters and buffers. ``axes`` maps a mesh axis name to the process
    group that stands for it (None = the default group): a collective on
    any other group carries ``axis=None``. Frames of the file that defines
    ``fn`` may anchor an event, as the package's do. ``sharded`` maps a
    parameter (or one of ``args``, by position) to the mesh axes its LAST
    dimension is sharded over: the engine's local block of that leaf
    (J107). A step that raises is recorded up to the error, in ``error``.
    """
    cap = Capture(name=name)
    known = [(a, "arg") for a in args] + [(m, "param") for m in modules]
    if markers._capture is not None:
        raise RuntimeError("a capture is already running")
    rec = _Recorder(cap, _fn_files(fn), group_axes(axes), known, threading.get_ident())
    for key, spec in (sharded or {}).items():
        obj = args[key] if isinstance(key, int) else _param(modules, args, key)
        if isinstance(obj, torch.Tensor) and spec:
            cap.sharded[rec.serial(obj)] = tuple(spec)
    real_dist = {n: getattr(dist, n) for n in _COLLECTIVES if hasattr(dist, n)}
    real_reads = {m: getattr(torch.Tensor, m) for m in _SYNC_METHODS}
    real_checks = [(mod, n, getattr(mod, n)) for mod, n in _CPU_ONLY_CHECKS]
    t0 = time.perf_counter()
    markers._capture = rec
    try:
        for n, f in real_dist.items():
            setattr(dist, n, rec.wrap_collective(n, f))
        for m, f in real_reads.items():
            setattr(torch.Tensor, m, rec.wrap_read(m, f))
        for mod, n, f in real_checks:
            setattr(mod, n, rec.wrap_quiet(f))
        with rec:
            cap.result = fn(*args)
            if torch.cuda.is_available() and torch.cuda.is_initialized():
                torch.cuda.synchronize()  # the wall holds the step's device work
        cap.result_serials = tuple(
            s for s in (rec.ids.get(t) for t in tree_flatten(cap.result)[0]
                        if isinstance(t, torch.Tensor)) if s is not None)
    except Exception as e:  # noqa: BLE001 - the step's error is the J100 finding
        cap.error = e
        cap.error_at = error_anchor(e, rec.files)
    finally:
        markers._capture = None
        for n, f in real_dist.items():
            setattr(dist, n, f)
        for m, f in real_reads.items():
            setattr(torch.Tensor, m, f)
        for mod, n, f in real_checks:
            setattr(mod, n, f)
        cap.wall_s = time.perf_counter() - t0
        rec.nodes.clear()
        rec.node_region.clear()
    return cap


def _param(modules, args, name: str):
    for m in (*modules, *(a for a in args if isinstance(a, torch.nn.Module))):
        for n, p in m.named_parameters():
            if n == name:
                return p
    return None
