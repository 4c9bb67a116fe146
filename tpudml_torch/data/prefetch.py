"""Device prefetch: overlap host-to-device copies with device compute (the
port of ``tpudml/data/prefetch.py``).

The reference hands each batch to ``.cuda()`` synchronously inside the
hot loop (codes/task1/pytorch/model.py:44-49). Here up to ``size`` batches
are in flight ahead of the consumer: each numpy array or tensor of an
item is staged in pinned host memory and copied with ``non_blocking=True``
on a side CUDA stream, and the consumer's stream waits for that copy
before the item is yielded, so batch N+1's copy runs while step N
computes. On the CPU the items are moved as they are.
"""

from __future__ import annotations

import collections
from typing import Iterable, Iterator

import numpy as np
import torch


def prefetch_to_device(iterator: Iterable, size: int = 2,
                       device: str | torch.device = "cuda") -> Iterator:
    """Yield the items of ``iterator`` (arrays, tensors, or tuples, lists
    and dicts of them) as tensors on ``device``, with up to ``size`` items
    copied ahead of the consumer. ``size`` is validated here, at the call,
    not at the first ``next``."""
    if size < 1:
        raise ValueError(f"prefetch size must be >= 1, got {size}")
    return _prefetch_gen(iterator, size, torch.device(device))


def _map(item, fn):
    if isinstance(item, (tuple, list)):
        return type(item)(_map(x, fn) for x in item)
    if isinstance(item, dict):
        return {k: _map(v, fn) for k, v in item.items()}
    return fn(item)


def _prefetch_gen(iterator, size: int, device: torch.device):
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def put(x):
        t = torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else x
        if stream is None:
            return t.to(device)
        if t.device.type == "cpu" and not t.is_pinned():
            t = t.pin_memory()
        return t.to(device, non_blocking=True)

    queue: collections.deque = collections.deque()
    it = iter(iterator)

    def enqueue(n: int) -> None:
        for _ in range(n):
            try:
                item = next(it)
            except StopIteration:
                return
            if stream is None:
                queue.append((_map(item, put), None))
                continue
            with torch.cuda.stream(stream):
                moved = _map(item, put)
                done = torch.cuda.Event()
                done.record(stream)
            queue.append((moved, done))

    enqueue(size)
    while queue:
        item, done = queue.popleft()
        if done is not None:
            torch.cuda.current_stream(device).wait_event(done)
            # The consumer's stream now owns the memory the side stream wrote.
            _map(item, lambda t: t.record_stream(torch.cuda.current_stream(device)))
        yield item
        enqueue(1)
