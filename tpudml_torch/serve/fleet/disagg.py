"""Disaggregated prefill/decode: KV handoff between specialist replicas
(the port of ``tpudml/serve/fleet/disagg.py``).

Prefill and decode want different machines: prefill is compute-bound (one
big attention pass over the prompt), decode is cache-bound (stream weights
+ KV per token). The fleet's disaggregated roles split them — a PREFILL
replica runs the prompt once and fills content-hashed pages; a DECODE
replica adopts those pages into its own ``PagePool`` and serves the tokens
without ever running the prompt's prefill.

The transport rides two existing invariants instead of new machinery:

- **Pages already have identity.** Prefix sharing keys a page by the
  byte-hash of the prompt head it covers (``PagePool._key``); a page is
  shareable iff it ends strictly before the first decode write, so its
  contents are a pure function of the token prefix. Shipping a page is
  therefore shipping (tokens-it-covers, K/V tensors) — the decode side
  re-registers it under the SAME content hash and ``match_prefix`` finds
  it exactly as if a local tenant had prefilled it.
- **The checkpoint store already does integrity.** The handoff file is a
  checkpoint (``tpudml_torch.checkpoint.store``, JAX's format 2): per-leaf
  CRC-32, atomic tmp+rename, and a loud ``CheckpointCorruptError`` on
  truncation/bitflip — so a vandalized handoff is REJECTED at adopt and
  the request falls back to local prefill (no prefix hit, same tokens,
  just slower). ``resilience.vandalize`` works on handoff directories
  unmodified. Both packages write format 2, so a handoff written by JAX
  adopts into the port and one written by the port into JAX.

Greedy parity is bitwise by construction: adopted pages hold the K/V local
prefill would have written (same weights, same prefill path, same
positions), so the decode replica's token stream equals the single-engine
stream token for token.
"""

from __future__ import annotations

import numpy as np
import torch

from tpudml_torch.checkpoint.store import (
    CheckpointCorruptError,
    _read_manifest,
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from tpudml_torch.serve.engine import RequestStats, ServeConfig, ServingEngine
from tpudml_torch.serve.load import Request

HANDOFF_VERSION = 1


def _require_paged_sharing(cfg: ServeConfig, who: str):
    if cfg.cache_layout != "paged" or not cfg.prefix_sharing:
        raise ValueError(
            f"{who} requires cache_layout='paged' with prefix_sharing=True "
            f"(content-hashed pages are the handoff unit)"
        )


def write_handoff(model, cfg: ServeConfig, prompt, directory, *,
                  device: str | torch.device = "cuda") -> dict:
    """PREFILL role: run ``prompt``'s prefill on a 1-slot paged engine over
    ``model`` on ``device`` and serialize its shareable pages (the
    whole-page prompt prefix) through the CRC-verified checkpoint format
    under ``directory``.

    Returns ``{"n_pages", "covered_tokens", "path"}`` — ``n_pages`` may be
    0 for a sub-page prompt (nothing shareable; adopt is a no-op and decode
    falls back to local prefill)."""
    _require_paged_sharing(cfg, "write_handoff")
    prompt = np.asarray(prompt, np.int32)
    if prompt.ndim != 1 or prompt.size < 1:
        raise ValueError("prompt must be [L>=1]")
    ecfg = ServeConfig(
        slots=1,
        max_len=cfg.max_len,
        prefill_chunk=cfg.prefill_chunk,
        cache_kind=cfg.cache_kind,
        cache_layout="paged",
        page_size=cfg.page_size,
        prefix_sharing=True,
        step_time_s=cfg.step_time_s,
        weight_quant=cfg.weight_quant,
    )
    if prompt.size + 1 > ecfg.max_len:
        raise ValueError(f"prompt {prompt.size} + 1 exceeds max_len {ecfg.max_len}")
    eng = ServingEngine(model, ecfg, device=device)
    st = RequestStats(rid=0, prompt_len=prompt.size, max_new_tokens=1, arrival=0.0)
    admitted = eng._admit_paged(0, Request(rid=0, prompt=prompt, max_new_tokens=1), st)
    assert admitted is not None  # a fresh pool cannot be starved
    p = prompt.size - 1  # first decode write position
    pages = eng._slot_pages[0]
    n = sum(1 for j in range(len(pages)) if (j + 1) * ecfg.page_size <= p)
    pids = torch.as_tensor(pages[:n], dtype=torch.long)
    kind = ecfg.cache_kind
    has_scales = kind == "int8"
    empty = torch.zeros((0,), dtype=torch.float32)

    def gather(field_name):
        if not n:
            return empty
        return torch.stack([getattr(c, field_name)[pids.to(c.k.device)].cpu()
                            for c in eng.caches])

    payload = {
        "prompt_head": prompt[: n * ecfg.page_size],
        "k": gather("k"),
        "v": gather("v"),
        "k_scale": gather("k_scale") if has_scales else empty,
        "v_scale": gather("v_scale") if has_scales else empty,
    }
    meta = {
        "fleet_handoff": HANDOFF_VERSION,
        "page_size": ecfg.page_size,
        "cache_kind": kind,
        "n_pages": int(n),
        "num_layers": len(eng.caches),
        "covered_tokens": int(n * ecfg.page_size),
    }
    path = save_checkpoint(directory, payload, 0, metadata=meta)
    return {"n_pages": int(n), "covered_tokens": meta["covered_tokens"], "path": path}


@torch.no_grad()
def adopt_handoff(engine: ServingEngine, directory, *, strict: bool = False) -> int:
    """DECODE role: verify + load a handoff directory and graft its pages
    into ``engine``'s pool under their content hashes; returns the number
    of pages adopted.

    0 means "serve without the handoff": a missing or empty handoff, a
    CRC-failed (vandalized) file, or a pool too full to take the pages —
    in every case the next matching request simply finds no prefix hit and
    prefills locally (correctness never depends on adoption; only prefill
    work does). ``strict=True`` re-raises the corruption instead, for
    callers that want the loud version. Config mismatches (page size /
    cache kind / layer count) always raise — that is a wiring bug, not a
    fault."""
    _require_paged_sharing(engine.cfg, "adopt_handoff")
    path = latest_checkpoint(directory)
    if path is None:
        if strict:
            raise CheckpointCorruptError(f"{directory}: no handoff found")
        return 0
    try:
        meta = _read_manifest(path).get("metadata", {})
    except CheckpointCorruptError:
        if strict:
            raise
        return 0
    if meta.get("fleet_handoff") != HANDOFF_VERSION:
        raise ValueError(
            f"handoff version {meta.get('fleet_handoff')!r} != {HANDOFF_VERSION}"
        )
    cfg = engine.cfg
    if (meta.get("page_size") != cfg.page_size
            or meta.get("cache_kind") != cfg.cache_kind
            or meta.get("num_layers") != len(engine.caches)):
        raise ValueError(
            f"handoff/engine mismatch: handoff (page_size="
            f"{meta.get('page_size')}, kind={meta.get('cache_kind')}, "
            f"layers={meta.get('num_layers')}) vs engine (page_size="
            f"{cfg.page_size}, kind={cfg.cache_kind}, "
            f"layers={len(engine.caches)})"
        )
    n = int(meta.get("n_pages", 0))
    if n == 0:
        return 0
    layers = len(engine.caches)
    c0 = engine.caches[0]
    _, psz, hkv, dh = c0.k.shape
    has_scales = cfg.cache_kind == "int8"
    empty = torch.zeros((0,), dtype=torch.float32)
    target = {
        "prompt_head": np.zeros(n * cfg.page_size, np.int32),
        "k": torch.zeros((layers, n, psz, hkv, dh), dtype=c0.k.dtype),
        "v": torch.zeros((layers, n, psz, hkv, dh), dtype=c0.v.dtype),
        "k_scale": torch.zeros((layers, n, psz, hkv)) if has_scales else empty,
        "v_scale": torch.zeros((layers, n, psz, hkv)) if has_scales else empty,
    }
    try:
        payload = restore_checkpoint(path, target, verify=True)
    except CheckpointCorruptError:
        if strict:
            raise
        return 0
    pool = engine._pool
    pids = pool.alloc_n(n)
    if pids is None:
        return 0  # pool under pressure; local prefill still works
    idx = torch.as_tensor(pids, dtype=torch.long, device=c0.k.device)
    for li, c in enumerate(engine.caches):
        c.k[idx] = payload["k"][li].to(c.k.device)
        c.v[idx] = payload["v"][li].to(c.v.device)
        if has_scales:
            c.k_scale[idx] = payload["k_scale"][li].to(c.k_scale.device)
            c.v_scale[idx] = payload["v_scale"][li].to(c.v_scale.device)
    prompt_head = np.asarray(payload["prompt_head"], np.int32)
    for j, pid in enumerate(pids):
        # Publish under the content hash, then release: a keyed page at
        # refcount 0 parks in the retained LRU — exactly the state a local
        # tenant's shareable pages reach after eviction, so ``match_prefix``
        # serves it to the next matching prompt.
        pool.register(pid, prompt_head, j)
        pool.release(pid)
    return n
