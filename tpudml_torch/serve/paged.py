"""Paged KV cache: a fixed page pool + slot→page table, with prefix
sharing. The port of ``tpudml/serve/paged.py``.

The dense cache (``serve.cache``) reserves ``max_len`` rows per slot; here
each layer's K/V live in one pool of ``[num_pages, page_size, kv_heads,
head_dim]`` pages, and each slot maps at most ``max_pages`` of them through
a ``[slots, max_pages]`` integer page table that the engine passes to every
decode step:

- **read**: gather the slot's table rows from the pool, flatten to a
  ``[slots, max_pages·page_size]`` key window whose flat index is the token
  position, and mask by position exactly like the dense path
  (``k_pos <= pos``). Attention cost scales with a slot's capacity, never
  with the pool's size.
- **write**: scatter the step's new K/V rows to ``(table[b, pos//P],
  pos % P)`` with ``index_put_``, in place. Page 0 is the garbage sink:
  inactive slots carry an all-zero table row, so their don't-care writes
  land there and never in a live request's pages. Several inactive slots
  write page 0 at the same offsets in one scatter, which leaves page 0's
  content unspecified (on CUDA and in JAX alike); no read ever gives it
  weight, and no check compares it.
- **alloc/free** is host-side bookkeeping between steps (``PagePool``), so
  the step's shapes never change with occupancy.

**Prefix sharing** (copy-on-write at page granularity): at admit time the
scheduler looks the prompt head up page by page (the key for page j is the
first ``(j+1)·page_size`` prompt tokens: K/V at a position depend only on
the tokens up to it) and maps already-resident pages into the new slot's
table with a refcount bump instead of prefilling them again. Only pages
that end strictly before the first decode-write position are registered,
so a shared page is written once in its life. Pages whose refcount drops
to zero but that carry a prefix key are RETAINED in LRU order and evicted
oldest-release-first only under pool pressure.
"""

from __future__ import annotations

import heapq
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch

from tpudml_torch.serve.cache import _STORE_DTYPE, KINDS, _dequant, _encode

#: Page 0 is never allocated: it is the scatter sink for inactive slots'
#: don't-care writes (their table rows are all zeros).
GARBAGE_PAGE = 0


@dataclass
class PagedKVCache:
    """One layer's page pool: K/V pages plus (int8 only) per-(page, row,
    head) scales."""

    k: torch.Tensor  # [N, P, Hkv, Dh] storage dtype
    v: torch.Tensor
    k_scale: torch.Tensor  # [N, P, Hkv] f32; shape [0] when unused
    v_scale: torch.Tensor
    kind: str

    @property
    def num_pages(self) -> int:
        return self.k.shape[0]

    @property
    def page_size(self) -> int:
        return self.k.shape[1]


def init_pool(num_pages: int, page_size: int, kv_heads: int, head_dim: int,
              kind: str = "f32", device: str | torch.device = "cpu") -> PagedKVCache:
    if kind not in KINDS:
        raise ValueError(f"unknown cache kind {kind!r}; one of {KINDS}")
    if num_pages < 2:
        raise ValueError("num_pages must be >= 2 (page 0 is the garbage sink)")
    shape = (num_pages, page_size, kv_heads, head_dim)
    sshape = (num_pages, page_size, kv_heads) if kind == "int8" else (0,)
    return PagedKVCache(
        k=torch.zeros(shape, dtype=_STORE_DTYPE[kind], device=device),
        v=torch.zeros(shape, dtype=_STORE_DTYPE[kind], device=device),
        k_scale=torch.zeros(sshape, dtype=torch.float32, device=device),
        v_scale=torch.zeros(sshape, dtype=torch.float32, device=device),
        kind=kind,
    )


def _addr(table: torch.Tensor, positions: torch.Tensor, page_size: int):
    """(pool page ids, in-page offsets) for flat ``positions`` [B, Q]
    through ``table`` [B, max_pages]. A position past the table (an
    inactive slot at a stale depth) clamps to the last table column, as
    JAX's gather clamps — for an inactive slot's all-zero row, the garbage
    page. Torch indexing raises out of range, so the clamp is explicit."""
    max_pages = table.shape[1]
    page_idx = torch.clamp(positions // page_size, 0, max_pages - 1)
    pages = torch.gather(table, 1, page_idx)
    return pages, positions % page_size


def _scatter(pool: PagedKVCache, pages, offs, ks, kscale, vs, vscale) -> None:
    pool.k.index_put_((pages, offs), ks)
    pool.v.index_put_((pages, offs), vs)
    if pool.kind == "int8":
        pool.k_scale.index_put_((pages, offs), kscale)
        pool.v_scale.index_put_((pages, offs), vscale)


def write_tokens(pool: PagedKVCache, k_new: torch.Tensor, v_new: torch.Tensor,
                 table: torch.Tensor, pos: torch.Tensor) -> PagedKVCache:
    """Scatter ``k_new``/``v_new`` [B, Q, Hkv, Dh] — Q consecutive tokens
    per slot from per-slot positions ``pos`` [B] — into the pages the table
    maps for those positions, in place. An active slot's target pages are
    its own (shared pages end before the first decode-write position)."""
    ks, kscale = _encode(k_new, pool.kind)
    vs, vscale = _encode(v_new, pool.kind)
    table = table.to(device=pool.k.device, dtype=torch.long)
    pos = pos.to(device=pool.k.device, dtype=torch.long)
    positions = pos[:, None] + torch.arange(ks.shape[1], device=pos.device)[None, :]
    pages, offs = _addr(table, positions, pool.page_size)
    _scatter(pool, pages, offs, ks, kscale, vs, vscale)
    return pool


def write_chunk(pool: PagedKVCache, k_new: torch.Tensor, v_new: torch.Tensor,
                table_row: torch.Tensor, start: int) -> PagedKVCache:
    """Prefill write: ``k_new``/``v_new`` [1, C, Hkv, Dh] at flat positions
    [start, start+C) of the one slot owning ``table_row`` [max_pages], in
    place."""
    ks, kscale = _encode(k_new, pool.kind)
    vs, vscale = _encode(v_new, pool.kind)
    table_row = table_row.to(device=pool.k.device, dtype=torch.long)
    flat = start + torch.arange(ks.shape[1], device=pool.k.device)
    pages = table_row[torch.clamp(flat // pool.page_size, 0, table_row.shape[0] - 1)]
    offs = flat % pool.page_size
    _scatter(pool, pages, offs, ks[0], None if kscale is None else kscale[0],
             vs[0], None if vscale is None else vscale[0])
    return pool


def read_table(pool: PagedKVCache, table: torch.Tensor,
               dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """Gather each slot's table rows from the pool and flatten them to a
    [B, max_pages·page_size, Hkv, Dh] key window whose flat index is the
    token position, in ``dtype`` (dequantized in the int8 case).
    Unallocated table entries point at page 0 but sit past the slot's
    length, where the decode mask gives them no weight."""
    table = table.to(device=pool.k.device, dtype=torch.long)
    b, m = table.shape
    p, h, d = pool.k.shape[1:]
    k = pool.k[table]  # [B, M, P, Hkv, Dh]
    v = pool.v[table]
    if pool.kind == "int8":
        k = _dequant(k, pool.k_scale[table])
        v = _dequant(v, pool.v_scale[table])
    return (k.reshape(b, m * p, h, d).to(dtype), v.reshape(b, m * p, h, d).to(dtype))


def read_row_prefix(pool: PagedKVCache, table_row: torch.Tensor, length: int,
                    dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """One slot's first ``length`` flat positions for a prefill chunk's
    attention window: [1, length, Hkv, Dh]. Gathers only the pages that
    cover them (the values JAX's whole-row gather puts there)."""
    p, h, d = pool.k.shape[1:]
    rows = table_row.to(device=pool.k.device, dtype=torch.long)[:-(-length // p)]
    k = pool.k[rows].reshape(-1, h, d)[:length]
    v = pool.v[rows].reshape(-1, h, d)[:length]
    if pool.kind == "int8":
        k = _dequant(k, pool.k_scale[rows].reshape(-1, h)[:length])
        v = _dequant(v, pool.v_scale[rows].reshape(-1, h)[:length])
    return k[None].to(dtype), v[None].to(dtype)


def pool_bytes(pool: PagedKVCache) -> int:
    """Total pool storage bytes (K + V + scales)."""
    return sum(x.numel() * x.element_size()
               for x in (pool.k, pool.v, pool.k_scale, pool.v_scale))


class PagePool:
    """Host-side page allocator + prefix index, between steps only. Every
    structure iterates in a deterministic order (min-heap free list,
    insertion-ordered LRU), so the scheduler's event log stays a function
    of (workload seed, config) and the page ids equal JAX's ``PagePool``'s
    for the same operations.

    Page lifecycle: free → allocated (refcount ≥ 1) → on last release,
    back to free (unregistered pages) or RETAINED (pages carrying a prefix
    key: still matchable, evicted oldest-first when the free heap runs
    dry). Page 0 never enters the allocator."""

    def __init__(self, num_pages: int, page_size: int, prefix_sharing: bool = False):
        if num_pages < 2:
            raise ValueError("num_pages must be >= 2")
        self.num_pages = num_pages
        self.page_size = page_size
        self.prefix_sharing = prefix_sharing
        self._free: list[int] = list(range(1, num_pages))
        heapq.heapify(self._free)
        self.refcount = [0] * num_pages
        self._retained: OrderedDict[int, None] = OrderedDict()
        self._key_to_page: dict[bytes, int] = {}
        self._page_key: dict[int, bytes] = {}
        # Counters for the report: admits that reused >= 1 page, pages
        # reused (prefill avoided), retained pages evicted.
        self.prefix_hits = 0
        self.pages_reused = 0
        self.retained_evictions = 0

    @property
    def available(self) -> int:
        """Pages an alloc could obtain right now (free + evictable)."""
        return len(self._free) + len(self._retained)

    @property
    def allocated(self) -> int:
        return (self.num_pages - 1) - self.available

    # ------------------------------------------------------------ sharing

    def _key(self, prompt: np.ndarray, j: int) -> bytes:
        return prompt[: (j + 1) * self.page_size].tobytes()

    def match_prefix(self, prompt: np.ndarray) -> list[int]:
        """Longest run of resident shared pages covering the prompt head.
        Page j matches only if it ends strictly before the first
        decode-write position ``len(prompt) - 1``. Side-effect-free: the
        caller bumps the counters once admission succeeds."""
        if not self.prefix_sharing:
            return []
        p = int(prompt.size) - 1  # prefilled positions are [0, p)
        pages: list[int] = []
        j = 0
        while (j + 1) * self.page_size <= p:
            pid = self._key_to_page.get(self._key(prompt, j))
            if pid is None:
                break
            pages.append(pid)
            j += 1
        return pages

    def register(self, pid: int, prompt: np.ndarray, j: int) -> None:
        """Publish page ``pid`` as holding prompt head page ``j``. The
        first resident writer wins."""
        key = self._key(prompt, j)
        if self._key_to_page.get(key, pid) != pid:
            return
        self._key_to_page[key] = pid
        self._page_key[pid] = key

    def _unregister(self, pid: int) -> None:
        key = self._page_key.pop(pid, None)
        if key is not None and self._key_to_page.get(key) == pid:
            del self._key_to_page[key]

    # ---------------------------------------------------------- lifecycle

    def acquire(self, pid: int) -> None:
        """Take a reference on an already-resident (shared) page."""
        if self.refcount[pid] == 0:
            self._retained.pop(pid, None)
        self.refcount[pid] += 1

    def alloc_n(self, n: int) -> list[int] | None:
        """n fresh pages, all or nothing (None leaves the pool exactly as
        it was). Fresh pages come from the free heap lowest id first, then
        from retained prefix pages oldest release first (their keys are
        unregistered). On failure, retained pages evicted mid-attempt get
        their keys, retained status and LRU positions back."""
        got: list[int] = []
        evicted: list[tuple[int, bytes]] = []  # (pid, key) in pop order
        for _ in range(n):
            if self._free:
                pid = heapq.heappop(self._free)
            elif self._retained:
                pid, _ = self._retained.popitem(last=False)
                evicted.append((pid, self._page_key[pid]))
                self._unregister(pid)
                self.retained_evictions += 1
            else:
                evicted_ids = {e for e, _ in evicted}
                for g in got:
                    self.refcount[g] = 0
                    if g not in evicted_ids:
                        heapq.heappush(self._free, g)
                # Back at the LRU head in reverse pop order: the original
                # oldest-release-first order is restored.
                for pid, key in reversed(evicted):
                    self._page_key[pid] = key
                    self._key_to_page[key] = pid
                    self._retained[pid] = None
                    self._retained.move_to_end(pid, last=False)
                self.retained_evictions -= len(evicted)
                return None
            self.refcount[pid] = 1
            got.append(pid)
        return got

    def release(self, pid: int) -> None:
        rc = self.refcount[pid] - 1
        if rc < 0:
            raise RuntimeError(f"page {pid} released more times than acquired")
        self.refcount[pid] = rc
        if rc == 0:
            if pid in self._page_key:
                self._retained[pid] = None  # newest retention at the LRU tail
            else:
                heapq.heappush(self._free, pid)
