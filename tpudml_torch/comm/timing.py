"""Communication-time accounting (the port of ``tpudml/comm/timing.py``).

The reference brackets each step's all-reduce with ``time.time()`` and
sums ``comm_time_sum`` (codes/task2/model-mp.py:61-66, printed :79; the
GPU-accurate recipe synchronizes the device, sections/task2.tex:69-80).
The port's eager step has that span already: the DP engine's split step
(``measure_comm=True``) synchronizes the device, runs the aggregation
alone and synchronizes again (:func:`timed_call`); :func:`comm_time_trial`
times one aggregation strategy on its own.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch


# Ring-model wire bytes moved per device for one collective, as a
# function of the per-shard input payload P and the axis size N. psum is
# a ring allreduce (reduce-scatter + all-gather legs, 2·P·(N−1)/N);
# all_gather ships the local shard to the other N−1 devices;
# reduce_scatter/all_to_all move one (N−1)/N fraction; ppermute ships
# the whole buffer once.
_WIRE_MODEL = {
    "psum": lambda p, n: 2.0 * p * (n - 1) / n,
    "pmax": lambda p, n: 2.0 * p * (n - 1) / n,
    "pmin": lambda p, n: 2.0 * p * (n - 1) / n,
    "pbroadcast": lambda p, n: p * (n - 1) / n,
    "all_gather": lambda p, n: float(p * (n - 1)),
    "psum_scatter": lambda p, n: p * (n - 1) / n,
    "reduce_scatter": lambda p, n: p * (n - 1) / n,
    "all_to_all": lambda p, n: p * (n - 1) / n,
    "pgather": lambda p, n: p * (n - 1) / n,
    "ppermute": lambda p, n: float(p),
    # A stage-boundary edge: the payload crosses the wire once.
    "p2p": lambda p, n: float(p),
}


def collective_wire_bytes(kind: str, payload_bytes: float, world: int) -> float:
    """Ring-model bytes one device moves for a single ``kind`` collective
    over a group of ``world`` ranks, given per-rank input
    ``payload_bytes``. Unknown kinds ship the payload once."""
    if world <= 1:
        return 0.0
    fn = _WIRE_MODEL.get(kind)
    return float(fn(payload_bytes, world) if fn else payload_bytes)


@dataclass
class CommStats:
    """The reference's ``comm_time_sum`` (model-mp.py:48,79), with the
    per-call spans and the ring-model wire bytes each timed call moved.
    With a ``tpudml_torch.obs.Tracer`` in ``tracer`` (the engines' ``obs=``
    knob sets it), every timed call also lands on the trace as a complete
    span of category "comm", named ``label``, its bytes in its args."""

    comm_time_s: float = 0.0
    calls: int = 0
    per_call_s: list = field(default_factory=list)
    comm_bytes: float = 0.0
    tracer: Any = None
    label: str = "comm"

    def add(self, dt: float, nbytes: float = 0.0) -> None:
        self.comm_time_s += dt
        self.calls += 1
        self.per_call_s.append(dt)
        self.comm_bytes += nbytes
        if self.tracer is not None and self.tracer.enabled:
            dur_us = int(dt * 1e6)
            self.tracer.add_complete(
                self.label, cat="comm",
                ts_us=max(self.tracer.now_us() - dur_us, 0),
                dur_us=dur_us, args={"bytes": nbytes} if nbytes else None,
            )

    def percentiles(self) -> dict:
        """p50/p99 of the recorded per-call spans (empty without calls)."""
        if not self.per_call_s:
            return {}
        arr = np.asarray(self.per_call_s)
        return {
            "p50_s": float(np.percentile(arr, 50)),
            "p99_s": float(np.percentile(arr, 99)),
        }

    def report(self) -> str:
        # Reference print parity: "Total communication time:" (model-mp.py:79).
        line = f"Total communication time: {self.comm_time_s:.4f}s over {self.calls} calls"
        pct = self.percentiles()
        if pct:
            line += (
                f" (p50 {pct['p50_s'] * 1e3:.2f}ms,"
                f" p99 {pct['p99_s'] * 1e3:.2f}ms)"
            )
        if self.comm_bytes:
            line += f", {self.comm_bytes / 1e6:.2f} MB moved/device"
        return line


def synchronize(tree: Any) -> None:
    """Wait for the queued work of the card that holds ``tree`` (a tensor
    or a dict of tensors); nothing on the CPU, whose ops have finished
    when they return."""
    for t in tree.values() if isinstance(tree, dict) else [tree]:
        if isinstance(t, torch.Tensor) and t.is_cuda:
            torch.cuda.synchronize(t.device)
            return


def timed_call(stats: CommStats, fn: Callable, *args, nbytes: float = 0.0) -> Any:
    """Run ``fn`` and charge its span to ``stats``: the device is
    synchronized before the clock starts and after ``fn`` returns (the
    reference's Event recipe, sections/task2.tex:72-80), so the span holds
    the collective and only it. The device is the one of ``fn``'s first
    argument and of its result."""
    synchronize(args[0] if args else None)
    t0 = time.perf_counter()
    out = fn(*args)
    synchronize(out)
    stats.add(time.perf_counter() - t0, nbytes)
    return out


def comm_time_trial(
    group,
    grads_like: Any,
    aggregator: Callable,
    iters: int = 20,
    warmup: int = 3,
) -> dict:
    """Median/total wall time of one aggregation strategy alone over
    ``group`` on ``grads_like`` (a tensor or a dict of tensors on the
    group's device)."""
    for _ in range(warmup):
        synchronize(aggregator(grads_like, group))
    times = []
    for _ in range(iters):
        synchronize(grads_like)
        t0 = time.perf_counter()
        synchronize(aggregator(grads_like, group))
        times.append(time.perf_counter() - t0)
    times_arr = np.asarray(times)
    return {
        "median_s": float(np.median(times_arr)),
        "mean_s": float(times_arr.mean()),
        "total_s": float(times_arr.sum()),
        "iters": iters,
    }


def comm_time_table(
    group,
    grads_like: Any,
    strategies: dict | None = None,
    iters: int = 20,
    warmup: int = 3,
) -> dict:
    """:func:`comm_time_trial` over every aggregation strategy (default:
    allreduce / allgather / reducescatter), task2's comparison table."""
    from tpudml_torch.comm.collectives import AGGREGATORS

    strategies = AGGREGATORS if strategies is None else strategies
    return {
        name: comm_time_trial(group, grads_like, agg, iters=iters, warmup=warmup)
        for name, agg in strategies.items()
    }


def attribute_overlap(fused_s: float, compute_s: float, comm_s: float) -> dict:
    """Split a step's communication time into EXPOSED (the step waited on
    it) and HIDDEN (absorbed behind compute), from the fused step's span,
    the compute-only span and the comm-only span:
    ``exposed = clamp(fused − compute, 0, comm)``, ``hidden = comm −
    exposed``, ``overlap_frac`` = hidden/comm (0 when comm is 0)."""
    exposed = min(max(fused_s - compute_s, 0.0), comm_s)
    hidden = comm_s - exposed
    return {
        "fused_s": fused_s,
        "compute_s": compute_s,
        "comm_s": comm_s,
        "exposed_comm_s": exposed,
        "hidden_comm_s": hidden,
        "overlap_frac": (hidden / comm_s) if comm_s > 0 else 0.0,
    }
