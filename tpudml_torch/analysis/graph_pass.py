"""The graph pass: JAX's jaxpr rules over one recorded step (the port of
``tpudml/analysis/jaxpr_pass.py``).

JAX traces a step to a jaxpr and walks its equations; the port records one
real step (:mod:`~tpudml_torch.analysis.capture`) and reads the record with
the same rule ids, severities and hints (``findings.RULES``), each rule
re-targeted to eager PyTorch:

- J100  the step raises while it is captured;
- J101  a collective on a process group that stands for none of the
        step's mesh axes (``axes``), or on a group this rank is not in;
- J103  a device→host read inside the step (``.item()``, ``.tolist()``,
        ``.cpu()``, a copy to the CPU, an op whose output shape waits for
        the data): each one stalls the host on the card;
- J104  a bf16→f32 ``_to_copy`` whose result feeds a non-accumulating
        consumer (views are looked through; reductions, products, casts,
        collectives and kernel regions accumulate);
- J105  a tensor over 1 MiB that the step reads but that is neither an
        argument, a registered parameter or buffer, nor made in the step:
        a constant the step closes over;
- J106  (steps that take their state, ``expects_donation``) state inputs
        of at least 1 MiB that the step replaces by new tensors of their
        shape and dtype instead of writing them in place (judged for each
        shape and dtype: in-place parameters do not hide replaced
        moments): that state is double-buffered every step;
- J107  the unsharded fused head's region (``FUSED_XENT_MARKER``) fed the
        local block of a leaf whose last (vocab) dimension is sharded;
- J108  gradient-sized all-reduces over a data axis that cover the
        parameters a step then updates in full, with no reduce-scatter:
        every rank pays the whole update;
- J109  the E-scaled grouped-transpose dW: a batched product of two
        ``[E, P, ·]`` range-masked broadcasts (``lax.ragged_dot``'s stock
        VJP; the port's ragged FFN never builds it, ROADMAP.md "Defined
        differences");
- J110  inside ``SERVE_DECODE_MARKER``: a softmax (or a flash kernel)
        whose query and key dims are both > 1: the per-token step
        recomputes full-sequence attention;
- J111  at least two subtractions from parameter tensors (``p.sub_``, also
        through the chunks ZeRO-1 cuts from them) in a step that runs no
        finiteness check (``train.FINITE_CHECK_MARKER``'s region: the
        sentinel's ``isfinite`` decomposes into elementwise ops);
- J117  inside ``PAGED_DECODE_MARKER``/``SPEC_DECODE_MARKER``: a softmax
        keyed on a page pool's total rows;
- J119  inside a decode region: an argmax over a matmul's full output
        width outside the fused head; or (``plan=``) a plan that claims
        ``tp_overlap`` for a step with no ``TP_OVERLAP_MARKER`` region.

J102 and the dataflow rules J112–J116, the cost reports (J116's budget)
and J118 are ROADMAP.md queue 1 item 11's next slice. The rules read an
opaque region (a kernel wrapper's, the fused heads') as one node, so that
a step gives the same findings on the CPU as on the card.
"""

from __future__ import annotations

import math
from typing import Callable

from tpudml_torch.analysis.capture import Capture, capture
from tpudml_torch.analysis.findings import Finding
from tpudml_torch.ops.xent_kernel import FUSED_XENT_MARKER
from tpudml_torch.parallel.overlap import TP_OVERLAP_MARKER
from tpudml_torch.serve.engine import SERVE_DECODE_MARKER
from tpudml_torch.serve.paged import PAGED_DECODE_MARKER
from tpudml_torch.serve.spec import SPEC_DECODE_MARKER
from tpudml_torch.train import FINITE_CHECK_MARKER

__all__ = [
    "CHECKED_RULES",
    "LARGE_CONST_BYTES",
    "analyze_callable",
    "analyze_capture",
    "collective_shape_signature",
]

#: The rules this pass checks so far (``--list-rules`` says which).
CHECKED_RULES = ("J100", "J101", "J103", "J104", "J105", "J106", "J107", "J108",
                 "J109", "J110", "J111", "J117", "J119")

LARGE_CONST_BYTES = 1 << 20  # 1 MiB

PAGED_DECODE_NAMES = (PAGED_DECODE_MARKER, SPEC_DECODE_MARKER)
_DECODE_TAIL_NAMES = (SERVE_DECODE_MARKER,) + PAGED_DECODE_NAMES
_DATA_AXIS_NAMES = frozenset({"data", "batch"})

# Direct consumers under which a bf16→f32 upcast is the accumulate-in-f32
# idiom (J104 stays silent): reductions, products, casts, collectives.
ACCUM_OK_OPS = frozenset({
    "sum", "mean", "nansum", "amax", "amin", "max", "min", "prod", "var", "var_mean",
    "std", "std_mean", "norm", "linalg_vector_norm", "_foreach_norm", "logsumexp",
    "mm", "addmm", "bmm", "baddbmm", "matmul", "dot", "mv", "addmv", "convolution",
    "_convolution", "cudnn_convolution", "cumsum", "cumprod", "logcumsumexp",
    "_to_copy", "copy_", "_native_batch_norm_legit", "native_batch_norm",
    "native_layer_norm",
})
# Views and aliases: J104 reads the consumers of the view instead.
_VIEWS = frozenset({
    "view", "_unsafe_view", "reshape", "t", "transpose", "permute", "expand",
    "unsqueeze", "squeeze", "select", "slice", "alias", "as_strided", "detach",
    "clone", "contiguous", "split", "split_with_sizes", "unbind", "chunk", "narrow",
})
# Ops through which "this is (a re-laid view of) a parameter" survives on the
# way to an update's subtraction (J111), as JAX's taint through reshape,
# concatenate, slice, convert and copy; compute ops kill it.
_PARAM_PRESERVING = _VIEWS | frozenset({"cat", "_to_copy", "constant_pad_nd", "copy_"})
# Under inference mode (the decode steps) the dispatcher shows composite ops
# undecomposed: softmax and matmul as such, not _softmax and mm.
_SOFTMAX_OPS = frozenset({"exp", "exp_", "_softmax", "_safe_softmax", "_log_softmax",
                          "softmax", "log_softmax", "logsumexp"})
_MATMUL_OPS = frozenset({"mm", "addmm", "bmm", "baddbmm", "matmul", "linear", "einsum"})
_FLASH_REGION = "kernel:flash_forward_lse"


def _mib(n: int) -> str:
    return f"{n / (1 << 20):.1f} MiB"


class _Graph:
    """Producers and readers of the step's tensors, over the ops outside
    opaque regions (a region, like a collective, only ever accumulates)."""

    def __init__(self, cap: Capture):
        self.producer: dict = {}
        self.readers: dict = {}
        for e in cap.events:
            if e.kind == "op" and e.opaque is None:
                for s in e.outputs:
                    if s not in e.mutated:
                        self.producer.setdefault(s, e)
                for s in set(e.inputs):
                    self.readers.setdefault(s, []).append(e)

    def consumers(self, serial: int, seen=None) -> list:
        """Names of the ops that read ``serial``, looking through views."""
        seen = seen if seen is not None else set()
        if serial in seen:
            return []
        seen.add(serial)
        out = []
        for e in self.readers.get(serial, ()):
            if e.name in _VIEWS:
                for s in e.outputs:
                    if s != serial:
                        out.extend(self.consumers(s, seen))
            else:
                out.append(e.name)
        return out

    def chase(self, serial: int, through: frozenset):
        e = self.producer.get(serial)
        while e is not None and e.name in through and e.inputs:
            e = self.producer.get(e.inputs[0])
        return e


def _in_region(cap: Capture, e, rid: int) -> bool:
    r = e.region
    while r is not None:
        if r == rid:
            return True
        r = cap.regions[r].parent
    return False


def _finding(rule: str, msg: str, e=None, entrypoint: str = "", where=None) -> Finding:
    file, line = where if where is not None else ((e.file, e.line) if e is not None
                                                   else ("", 0))
    return Finding(rule, msg, file=file, line=line, entrypoint=entrypoint)


# ------------------------------------------------------------------ rules


def _check_collectives(cap: Capture, ep: str, out: list) -> None:
    """J101."""
    for e in cap.collectives():
        if not e.extra.get("member"):
            out.append(_finding(
                "J101", f"{e.name} ({e.extra.get('call')}) on a process group this rank "
                        f"is not in", e, ep))
        elif e.extra.get("axis") is None:
            out.append(_finding(
                "J101", f"{e.name} ({e.extra.get('call')}) on a process group that stands "
                        f"for none of the step's mesh axes", e, ep))


def _check_host_reads(cap: Capture, ep: str, out: list) -> None:
    """J103: one finding a read site."""
    seen = set()
    for e in cap.events:
        if e.kind == "sync" and e.opaque is None and (e.file, e.line) not in seen:
            seen.add((e.file, e.line))
            out.append(_finding("J103", f"device→host read {e.name} inside the step", e, ep))


def _check_upcasts(cap: Capture, g: _Graph, ep: str, out: list) -> None:
    """J104."""
    for e in cap.events:
        if (e.kind != "op" or e.name != "_to_copy" or e.opaque is not None
                or e.extra.get("from") != "bfloat16" or e.extra.get("to") != "float32"):
            continue
        bad = sorted({n for s in e.outputs for n in g.consumers(s) if n not in ACCUM_OK_OPS})
        if bad:
            out.append(_finding(
                "J104", f"bf16 value upcast to f32 feeds non-accumulating consumer(s) {bad}",
                e, ep))


def _check_constants(cap: Capture, ep: str, out: list) -> None:
    """J105."""
    reads: dict = {}
    for e in cap.events:
        if e.kind in ("op", "collective") and e.opaque is None:
            for s in e.inputs:
                reads.setdefault(s, e)
    for r in cap.regions:
        if r.opaque:
            for s in r.inputs:
                reads.setdefault(s, r)
    for s, e in sorted(reads.items()):
        t = cap.tensors[s]
        if t.kind == "external" and t.nbytes > LARGE_CONST_BYTES:
            out.append(_finding(
                "J105", f"{_mib(t.nbytes)} constant ({t.dtype}{list(t.shape)}) captured by "
                        f"closure — pass it as a (donatable) argument instead",
                where=(e.file, e.line), entrypoint=ep))


def donation_findings(cap: Capture, entrypoint: str = "") -> list:
    """J106 (module docstring) from a capture, judged for each (shape,
    dtype) of its state inputs of 1 MiB or more: as many of them as are
    not written in place, up to the count of new tensors of that shape and
    dtype that the step returns, were replaced. One finding for the step,
    anchored where the first replacement is made."""
    written = {s for e in cap.events for s in e.mutated}
    kept: dict = {}
    for t in cap.tensors.values():
        if t.kind in ("arg", "param", "buffer") and t.nbytes >= LARGE_CONST_BYTES \
                and t.serial not in written:
            kept.setdefault((t.shape, t.dtype), []).append(t)
    fresh: dict = {}
    for s in cap.result_serials:
        t = cap.tensors[s]
        if t.kind == "step" and (t.shape, t.dtype) in kept:
            fresh.setdefault((t.shape, t.dtype), []).append(t)
    if not fresh:
        return []
    count = nbytes = 0
    for key, made in fresh.items():
        n = min(len(kept[key]), len(made))
        count += n
        nbytes += n * kept[key][0].nbytes
    first = min(t.serial for made in fresh.values() for t in made)
    where = next((e for e in cap.events if e.kind == "op" and first in e.outputs), None)
    return [_finding(
        "J106", f"{_mib(nbytes)} across {count} state input(s) replaced by new tensors of "
                f"their shape instead of written in place — params/opt-state double-buffer "
                f"every step", where, entrypoint)]


def _check_fused_xent(cap: Capture, ep: str, out: list) -> None:
    """J107: taint 'its last dim is sharded' from the declared leaves
    through casts, copies and last-dim-preserving re-layouts (and the flat
    buffers of gathers) to the w operand of the unsharded head's region."""
    tainted = dict(cap.sharded)
    flat: set = set()
    if not tainted:
        return
    for e in cap.events:
        if e.kind == "collective" and e.name == "all_gather":
            axes = next((tainted[s] for s in e.inputs if s in tainted), None)
            if axes:
                for s in e.outputs:
                    tainted[s] = axes
                    flat.add(s)
            continue
        if e.kind != "op" or e.opaque is not None or not e.inputs:
            continue
        axes = tainted.get(e.inputs[0])
        if not axes:
            continue
        src = cap.tensors[e.inputs[0]]
        for s in e.outputs:
            t = cap.tensors[s]
            keep = e.name in ("_to_copy", "clone", "detach", "alias", "contiguous")
            keep = keep or (e.name in _PARAM_PRESERVING and t.shape[-1:] == src.shape[-1:])
            keep = keep or (e.inputs[0] in flat and e.name in _VIEWS)
            if keep:
                tainted[s] = axes
    for r in cap.regions:
        if r.name != FUSED_XENT_MARKER or len(r.inputs) < 2:
            continue
        axes = tainted.get(r.inputs[1])
        if axes:
            out.append(_finding(
                "J107", f"fused cross-entropy head consumes a kernel whose vocab (last) dim "
                        f"is sharded over mesh axis {list(axes)} without the shard-merge "
                        f"wrapper — each shard normalizes over its local slice only; use "
                        f"sharded_linear_cross_entropy(group=...)",
                where=(r.file, r.line), entrypoint=ep))


def _param_update_subs(cap: Capture) -> tuple:
    """J111's count: subtractions whose minuend is a parameter or a
    re-laid view of one (ZeRO-1's chunks), with an output of its shape.
    Returns (count, {file: [count, first line]}, serials of the full
    parameters updated in place)."""
    tainted = {s for s, t in cap.tensors.items() if t.kind == "param"}
    count, by_file, full = 0, {}, set()
    for e in cap.events:
        if e.kind != "op" or e.opaque is not None or not e.inputs:
            continue
        if e.name in ("sub", "sub_"):
            m = e.inputs[0]
            if m in tainted and e.outputs and (cap.tensors[e.outputs[0]].shape
                                               == cap.tensors[m].shape):
                count += 1
                per = by_file.setdefault(e.file, [0, e.line])
                per[0] += 1
                if cap.tensors[m].kind == "param" and e.name == "sub_":
                    full.add(m)
            continue
        if e.name in _PARAM_PRESERVING and any(s in tainted for s in e.inputs[:1]) or (
                e.name == "cat" and any(s in tainted for s in e.inputs)):
            tainted.update(s for s in e.outputs if s not in e.mutated or e.name == "copy_")
    return count, by_file, full


def _check_unguarded_update(cap: Capture, subs: tuple, ep: str, out: list) -> None:
    """J111, anchored at the file with the most update subs (the
    optimizer), so that one allowlist entry covers every engine."""
    count, by_file, _ = subs
    if count < 2 or FINITE_CHECK_MARKER in cap.region_names():
        return
    f, (_, ln) = max(by_file.items(), key=lambda kv: kv[1][0])
    out.append(Finding(
        "J111", f"optimizer update writes {count} parameter tensors (subtractions from "
                f"parameters) but the step evaluates no is_finite predicate — a single "
                f"non-finite microbatch reaches the weights on every replica at once",
        file=f, line=ln, entrypoint=ep))


def _check_replicated_update(cap: Capture, subs: tuple, ep: str, out: list) -> None:
    """J108."""
    colls = [e for e in cap.collectives() if e.extra.get("axis") in _DATA_AXIS_NAMES]
    if any(e.name == "psum_scatter" for e in colls):
        return
    psums = [e for e in colls if e.name == "psum" and e.extra.get("shape")]
    if not psums:
        return
    full = subs[2]
    if len(full) < 2:
        return
    reduced = sum(math.prod(e.extra["shape"]) for e in psums)
    updated = sum(math.prod(cap.tensors[s].shape) for s in full)
    if reduced < updated:
        return
    axes = sorted({e.extra["axis"] for e in psums})
    out.append(_finding(
        "J108", f"replicated optimizer update over data axis {axes}: {len(full)} parameter "
                f"tensors are updated in full after all-reducing their gradients, with no "
                f"reduce-scatter — every rank applies the FULL weight update (N× optimizer "
                f"FLOPs and state memory); ZeRO-1 (optim.zero1) shards it", psums[0], ep))


def _check_ragged_transpose(cap: Capture, g: _Graph, ep: str, out: list) -> None:
    """J109: a bmm over two 3-D operands that both come (through views and
    casts) from a ``where`` that selects from a 2-D tensor expanded to
    ``[E, P, ·]``."""
    through = frozenset(_VIEWS | {"_to_copy"})

    def masked_bcast(serial) -> bool:
        e = g.chase(serial, through)
        if e is None or e.name != "where":
            return False
        for s in e.inputs:
            p = g.producer.get(s)
            if p is not None and p.name == "expand" and p.inputs and len(
                    cap.tensors[p.inputs[0]].shape) in (2, 3) and len(
                    cap.tensors[p.outputs[0]].shape) == 3:
                return True
        return False

    for e in cap.events:
        if e.kind != "op" or e.name != "bmm" or e.opaque is not None or len(e.inputs) < 2:
            continue
        a, b = (cap.tensors[s] for s in e.inputs[:2])
        if len(a.shape) != 3 or len(b.shape) != 3 or a.shape[0] != b.shape[0]:
            continue
        if masked_bcast(e.inputs[0]) and masked_bcast(e.inputs[1]):
            n = a.shape[0]
            out.append(_finding(
                "J109", f"grouped-transpose dW: batched product over two [{n}, P, ·] "
                        f"range-masked broadcasts — {n}× the dense dW FLOPs in the backward",
                e, ep))


def _region_events(cap: Capture, rid: int):
    r = cap.regions[rid]
    return [e for e in cap.events[r.first:r.last] if _in_region(cap, e, rid)]


def _check_decode(cap: Capture, ep: str, out: list) -> None:
    """J110, J117 and J119's tail half, once a marked region each."""
    for r in cap.regions:
        if r.name not in _DECODE_TAIL_NAMES:
            continue
        evs = _region_events(cap, r.id)
        inner = [x for x in cap.regions if x.parent is not None and r.first <= x.first < r.last]
        if r.name == SERVE_DECODE_MARKER:
            hit = None
            for e in evs:
                if e.kind == "op" and e.opaque is None and e.name in _SOFTMAX_OPS:
                    shape = cap.tensors[e.inputs[0]].shape
                    if len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1:
                        hit = (e.file, e.line), shape
                        break
            if hit is None:
                for x in inner:
                    if x.name == _FLASH_REGION and len(x.arg_shapes) >= 2:
                        (qs, _), (ks, _) = x.arg_shapes[:2]
                        if qs[1] > 1 and ks[1] > 1:
                            hit = (x.file, x.line), (qs[1], ks[1])
                            break
            if hit is not None:
                out.append(_finding(
                    "J110", f"decode step recomputes full-sequence attention per emitted "
                            f"token: softmax over {list(hit[1])} scores (query and key dims "
                            f"both > 1) inside the per-token program — O(T²) per token; "
                            f"carry a KV cache (tpudml_torch.serve) so decode attends "
                            f"[B, H, 1, L]", where=hit[0], entrypoint=ep))
        if r.name in PAGED_DECODE_NAMES:
            pools = {s[0] * s[1] for s, _ in r.arg_shapes if len(s) == 4 and s[0] > 1
                     and s[1] > 1}
            for e in evs:
                if pools and e.kind == "op" and e.opaque is None and e.name in _SOFTMAX_OPS:
                    shape = cap.tensors[e.inputs[0]].shape
                    if shape and shape[-1] in pools:
                        out.append(_finding(
                            "J117", f"paged decode step attends over the full page pool: "
                                    f"softmax over {list(shape)} scores whose key dim matches "
                                    f"a pool's total rows (num_pages·page_size) — per-token "
                                    f"cost scales with pool memory, not the slot's table "
                                    f"window", e, ep))
                        break
        dims: set = set()
        for e in evs:
            if e.kind != "op" or e.opaque is not None:
                continue
            if e.name in _MATMUL_OPS:
                for s in e.outputs:
                    shape = cap.tensors[s].shape
                    if shape:
                        dims.add(shape[-1])
            elif e.name == "argmax" and e.inputs:
                shape = cap.tensors[e.inputs[0]].shape
                if shape and shape[-1] > 1 and shape[-1] in dims and e.extra.get(
                        "last_axis", True):
                    out.append(_finding(
                        "J119", f"decode step materializes the full-vocab logits and argmaxes "
                                f"them outside the head matmul: argmax over {list(shape)} "
                                f"whose reduced dim matches a matmul output width — the "
                                f"[B, V] tail round-trips device memory every emitted token",
                        e, ep))
                    break


def analyze_capture(cap: Capture, entrypoint: str = "", *, expects_donation: bool = False,
                    plan: dict | None = None) -> list:
    """Every rule of this pass over one capture."""
    if cap.error is not None:
        file, line = cap.error_at
        return [Finding("J100", f"step failed: {cap.error!r}", file=file, line=line,
                        entrypoint=entrypoint)]
    out: list = []
    g = _Graph(cap)
    _check_collectives(cap, entrypoint, out)
    _check_host_reads(cap, entrypoint, out)
    _check_upcasts(cap, g, entrypoint, out)
    _check_constants(cap, entrypoint, out)
    if expects_donation:
        out.extend(donation_findings(cap, entrypoint))
    _check_fused_xent(cap, entrypoint, out)
    subs = _param_update_subs(cap)
    _check_replicated_update(cap, subs, entrypoint, out)
    _check_ragged_transpose(cap, g, entrypoint, out)
    _check_decode(cap, entrypoint, out)
    _check_unguarded_update(cap, subs, entrypoint, out)
    if plan is not None:
        cand = (plan.get("winner") or {}).get("candidate") or {}
        if cand.get("tp_overlap") and TP_OVERLAP_MARKER not in cap.region_names():
            exposed = next(iter(cap.collectives()), None)  # where the exposed wire time is
            out.append(_finding(
                "J119", f"plan winner {cand.get('key', '?')} claims psum-overlapped TP "
                        f"matmuls (tp_overlap) but the captured step runs no "
                        f"{TP_OVERLAP_MARKER} region — the wire time the plan priced as "
                        f"hidden is exposed on the critical path", exposed, entrypoint))
    return out


def collective_shape_signature(cap: Capture) -> tuple:
    """Ordered ``(primitive, axes, operand shape)`` of the collectives one
    captured step issued, under JAX's primitive names: what the protocol
    pass's P302 compares across the ranks of one stage group."""
    return tuple((e.name, (e.extra["axis"],) if e.extra.get("axis") else (),
                  tuple(e.extra.get("shape", ()))) for e in cap.collectives())


def _in_specs_sharding(in_specs) -> dict:
    """``in_specs`` (one spec a positional argument: a tuple of mesh axes,
    or of tuples of them, a dim each, or None) -> {arg index: the axes of
    its last dim}."""
    out = {}
    for i, spec in enumerate(in_specs or ()):
        if spec:
            last = spec[-1]
            if last:
                out[i] = tuple(last) if isinstance(last, (tuple, list)) else (last,)
    return out


def analyze_callable(fn: Callable, args: tuple, entrypoint: str = "",
                     expects_donation: bool = False, in_specs=None, plan: dict | None = None,
                     *, axes: dict | None = None, modules=()) -> list:
    """Capture ``fn(*args)`` once and run every rule of this pass on it.

    ``axes`` maps each mesh axis of the step to its process group (None =
    the default group): a collective on any other group is J101, as a
    collective over an unbound axis is in JAX. ``in_specs`` gives the
    positional arguments' placement, one spec an argument (J107 reads the
    axes of their last dims). ``plan`` arms J119's overlap half. A step that raises is J100.
    (JAX's ``mesh_axes`` and ``hbm_budget_bytes`` feed the dataflow and
    cost walks, the next slice's.)"""
    cap = capture(fn, args, name=entrypoint, modules=modules, axes=axes,
                  sharded=_in_specs_sharding(in_specs))
    return analyze_capture(cap, entrypoint, expects_donation=expects_donation, plan=plan)
