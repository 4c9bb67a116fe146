"""Seeded synthetic request streams for the serving engine (a copy of
``tpudml/serve/load.py``; numpy only, bitwise equal for the same seed).

A Poisson process (exponential inter-arrival gaps at a given QPS) with
per-request prompt/output lengths drawn uniformly from closed ranges: the
open-loop serving-benchmark shape, where arrival times are fixed by the
seed BEFORE the run, so a slow engine accumulates queue depth instead of
back-pressuring the generator. The returned ledger records what every
request is owed so the engine's token accounting can be audited.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


@dataclass
class Request:
    """One serving request: a prompt and a generation budget."""

    rid: int
    prompt: np.ndarray  # [L] int32 token ids, L >= 1
    max_new_tokens: int
    arrival_time: float = 0.0  # seconds from stream start


def poisson_workload(
    n_requests: int,
    qps: float,
    seed: int,
    *,
    vocab_size: int,
    prompt_len: tuple[int, int] = (4, 16),
    new_tokens: tuple[int, int] = (4, 16),
) -> tuple[list[Request], dict[int, dict]]:
    """Build ``n_requests`` requests arriving as a Poisson process at
    ``qps`` (``math.inf``: everything arrives at t=0). Lengths are uniform
    over the inclusive ranges. Returns ``(requests, ledger)`` where
    ``ledger[rid]`` records the prompt length and owed token count."""
    if n_requests < 1:
        raise ValueError("n_requests must be >= 1")
    if prompt_len[0] < 1:
        raise ValueError("prompts must have at least 1 token")
    if new_tokens[0] < 1:
        raise ValueError("each request must generate at least 1 token")
    rng = np.random.default_rng(seed)
    if math.isinf(qps):
        arrivals = np.zeros(n_requests)
    else:
        arrivals = np.cumsum(rng.exponential(1.0 / qps, n_requests))
    plens = rng.integers(prompt_len[0], prompt_len[1] + 1, n_requests)
    olens = rng.integers(new_tokens[0], new_tokens[1] + 1, n_requests)
    requests, ledger = [], {}
    for i in range(n_requests):
        prompt = rng.integers(0, vocab_size, int(plens[i])).astype(np.int32)
        requests.append(Request(
            rid=i,
            prompt=prompt,
            max_new_tokens=int(olens[i]),
            arrival_time=float(arrivals[i]),
        ))
        ledger[i] = {
            "prompt_len": int(plens[i]),
            "max_new_tokens": int(olens[i]),
            "arrival_time": float(arrivals[i]),
            # Filled by ServeReport.annotate_ledger after a run (None: the
            # request never reached that milestone).
            "ttft_s": None,
            "tpot_s": None,
        }
    return requests, ledger
