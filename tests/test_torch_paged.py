"""The paged KV cache of the PyTorch port against ``tpudml.serve.paged``
and the JAX ``ServingEngine``, on the CPU.

- pool writes and reads: the same writes give the same pools outside the
  garbage page (f32 bitwise, bf16 at the JAX test's storage tolerance
  against the written values and bitwise against JAX, int8 codes and
  scales bitwise), and an inactive slot's all-zero table row sinks its
  writes into page 0. Page 0's content after a scatter with duplicate
  indices is unspecified on both sides, so no check compares it;
- ``PagePool``: seeded operation sequences give identical page ids,
  refcounts, retention, LRU evictions and counters, with the underflow and
  all-or-nothing behaviour;
- the paged decode step's logits against JAX's at rtol 1e-5 / atol 1e-6;
- engine runs under a virtual clock — paged, prefix sharing, prefix sharing
  under pool pressure, page-starved — give token streams, event logs,
  ``shared_pages`` and ``pool_stats`` identical to JAX's;
- the impossible page demand raises at idle; ``fused_head`` × paged raises
  ``ServeCompositionError``.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from tpudml.models import TransformerLM as JaxLM  # noqa: E402
from tpudml.serve import PagePool as JaxPagePool  # noqa: E402
from tpudml.serve import Request as JaxRequest  # noqa: E402
from tpudml.serve import ServeConfig as JaxServeConfig  # noqa: E402
from tpudml.serve import ServingEngine as JaxEngine  # noqa: E402
from tpudml.serve import paged as jpaged  # noqa: E402
from tpudml.serve import poisson_workload as jax_poisson  # noqa: E402
from tpudml.serve.engine import RequestStats as JaxStats  # noqa: E402
from tpudml_torch.interop import lm_params_from_tpudml  # noqa: E402
from tpudml_torch.models import TransformerLM  # noqa: E402
from tpudml_torch.serve import (  # noqa: E402
    PagePool, Request, ServeCompositionError, ServeConfig, ServingEngine,
    init_pool, pool_bytes,
)
from tpudml_torch.serve import paged as tpaged  # noqa: E402
from tpudml_torch.serve.engine import RequestStats  # noqa: E402

V, D, HEADS, LAYERS, MAX_LEN = 48, 32, 4, 2, 32
CFG = dict(vocab_size=V, embed_dim=D, num_heads=HEADS, num_layers=LAYERS,
           max_len=MAX_LEN, rope=True, num_kv_heads=2)
TOL = dict(rtol=1e-5, atol=1e-6)


def _pair(seed: int):
    jm = JaxLM(**CFG)
    params, _ = jm.init(jax.random.key(seed))
    tm = TransformerLM(**CFG, device="cpu")
    tm.load_state_dict(lm_params_from_tpudml(jax.tree.map(np.asarray, params)))
    return jm, params, tm


def _prompt(n=11, seed=3):
    return np.random.default_rng(seed).integers(0, V, n).astype(np.int32)


# ------------------------------------------------------ pool primitives


def _write_both(kind):
    """The JAX test's write sequence (two prefill chunks, then a two-row
    decode write) into a JAX pool and a port pool."""
    rng = np.random.default_rng(0)
    P, M, H, Dh = 4, 3, 2, 8
    row = np.array([2, 1, 3], np.int32)  # deliberately non-contiguous
    k_ref = rng.standard_normal((1, M * P, H, Dh)).astype(np.float32)
    v_ref = rng.standard_normal((1, M * P, H, Dh)).astype(np.float32)
    jp = jpaged.init_pool(6, P, H, Dh, kind)
    tp = init_pool(6, P, H, Dh, kind)
    for s0 in (0, 4):
        jp = jpaged.write_chunk(jp, jnp.asarray(k_ref[:, s0:s0 + 4]),
                                jnp.asarray(v_ref[:, s0:s0 + 4]), jnp.asarray(row), s0)
        tpaged.write_chunk(tp, torch.from_numpy(k_ref[:, s0:s0 + 4]),
                           torch.from_numpy(v_ref[:, s0:s0 + 4]), torch.from_numpy(row), s0)
    jp = jpaged.write_tokens(jp, jnp.asarray(k_ref[:, 8:10]), jnp.asarray(v_ref[:, 8:10]),
                             jnp.asarray(row[None, :]), jnp.asarray([8], jnp.int32))
    tpaged.write_tokens(tp, torch.from_numpy(k_ref[:, 8:10]), torch.from_numpy(v_ref[:, 8:10]),
                        torch.from_numpy(row[None, :]), torch.tensor([8]))
    return jp, tp, row, k_ref, v_ref


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("kind,tol", [("f32", 0.0), ("bf16", 2e-2), ("int8", 5e-2)])
def test_pool_write_read_matches_jax(kind, tol):
    jp, tp, row, k_ref, v_ref = _write_both(kind)
    # Storage bitwise equal to JAX's (int8: codes and scales).
    for name in ("k", "v", "k_scale", "v_scale"):
        a = np.asarray(getattr(jp, name)).astype(np.float32)
        b = _np(getattr(tp, name))
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(b, a)
    if kind == "int8":
        assert tp.k.dtype == torch.int8 and tp.k_scale.dtype == torch.float32
    k, v = tpaged.read_table(tp, torch.from_numpy(row[None, :]), torch.float32)
    jk, jv = jpaged.read_table(jp, jnp.asarray(row[None, :]), jnp.float32)
    np.testing.assert_array_equal(k.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_allclose(k[0, :10].numpy(), k_ref[0, :10], rtol=0, atol=tol)
    np.testing.assert_allclose(v[0, :10].numpy(), v_ref[0, :10], rtol=0, atol=tol)
    for length in (1, 4, 10, 12):
        pk, pv = tpaged.read_row_prefix(tp, torch.from_numpy(row), length, torch.float32)
        jk, jv = jpaged.read_row_prefix(jp, jnp.asarray(row), length, jnp.float32)
        np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    for pid in (4, 5):  # pages the table never mapped stay zero
        assert np.all(_np(tp.k[pid]) == 0)
    assert pool_bytes(tp) == jpaged.pool_bytes(jp)


def test_inactive_slot_writes_sink_to_garbage_page():
    pool = init_pool(4, 2, 1, 2, "f32")
    table = torch.tensor([[3, 1], [0, 0]])
    k = torch.ones((2, 1, 1, 2))
    tpaged.write_tokens(pool, k, k, table, torch.tensor([0, 5]))
    assert torch.all(pool.k[3, 0] == 1)  # the live slot landed
    assert torch.any(pool.k[tpaged.GARBAGE_PAGE] == 1)  # the sink took it
    assert torch.all(pool.k[2] == 0)  # an unmapped page untouched
    # Positions past the table clamp to its last column, as JAX's gather.
    pages, offs = tpaged._addr(table, torch.tensor([[0, 9], [5, 7]]), 2)
    jpages, joffs = jpaged._addr(jnp.asarray(table.numpy()),
                                 jnp.asarray([[0, 9], [5, 7]]), 2)
    np.testing.assert_array_equal(pages.numpy(), np.asarray(jpages))
    np.testing.assert_array_equal(offs.numpy(), np.asarray(joffs))


def test_pool_validation():
    with pytest.raises(ValueError, match="num_pages"):
        init_pool(1, 4, 2, 8)
    with pytest.raises(ValueError, match="cache kind"):
        init_pool(4, 4, 2, 8, "fp4")
    assert pool_bytes(init_pool(4, 8, 2, 8, "int8")) < pool_bytes(init_pool(4, 8, 2, 8)) / 2


# ------------------------------------------------------------ allocator


def _pool_state(pool):
    return (pool.refcount, list(pool._free), list(pool._retained), dict(pool._key_to_page),
            dict(pool._page_key), pool.available, pool.allocated, pool.prefix_hits,
            pool.pages_reused, pool.retained_evictions)


@pytest.mark.parametrize("seed", range(4))
def test_pagepool_sequences_match_jax(seed):
    """Seeded sequences of alloc_n, register, match/acquire and release
    leave both allocators in the same state after every operation."""
    rng = np.random.default_rng(seed)
    kw = dict(num_pages=7, page_size=2, prefix_sharing=True)
    a, b = PagePool(**kw), JaxPagePool(**kw)
    prompts = [rng.integers(0, 4, 7).astype(np.int32) for _ in range(3)]
    held: list[int] = []
    for _ in range(200):
        op = rng.integers(0, 4)
        if op == 0:
            n = int(rng.integers(0, 5))
            got = a.alloc_n(n)
            assert got == b.alloc_n(n)
            held += got or []
        elif op == 1 and held:
            pid = held[int(rng.integers(0, len(held)))]
            prompt = prompts[int(rng.integers(0, 3))]
            j = int(rng.integers(0, 3))
            a.register(pid, prompt, j)
            b.register(pid, prompt, j)
        elif op == 2:
            prompt = prompts[int(rng.integers(0, 3))]
            m = a.match_prefix(prompt)
            assert m == b.match_prefix(prompt)
            for pid in m:
                a.acquire(pid)
                b.acquire(pid)
            held += m
        elif op == 3 and held:
            pid = held.pop(int(rng.integers(0, len(held))))
            a.release(pid)
            b.release(pid)
        assert _pool_state(a) == _pool_state(b)


def test_pagepool_raises_and_all_or_nothing():
    pool = PagePool(num_pages=4, page_size=4)  # 3 allocatable pages
    assert pool.alloc_n(2) == [1, 2]
    before = _pool_state(pool)
    assert pool.alloc_n(2) is None  # needs 2, one left: nothing changes
    assert _pool_state(pool) == before
    pool.release(1)
    with pytest.raises(RuntimeError, match="released more"):
        pool.release(1)
    with pytest.raises(ValueError, match="num_pages"):
        PagePool(num_pages=1, page_size=4)
    # A failed alloc that evicted retained pages hands them back in order.
    pool = PagePool(num_pages=4, page_size=2, prefix_sharing=True)
    jpool = JaxPagePool(num_pages=4, page_size=2, prefix_sharing=True)
    prompt = np.arange(6, dtype=np.int32)
    for p in (pool, jpool):
        pages = p.alloc_n(3)
        p.register(pages[0], prompt, 0)
        p.register(pages[1], prompt, 1)
        for pid in pages:
            p.release(pid)
        assert p.alloc_n(4) is None
    assert _pool_state(pool) == _pool_state(jpool)
    assert pool.alloc_n(3) == jpool.alloc_n(3) == [3, 1, 2]


# ------------------------------------------------------- engine parity


def test_paged_decode_logits_match_jax():
    jm, params, tm = _pair(0)
    prompt = _prompt()
    kw = dict(slots=2, max_len=MAX_LEN, prefill_chunk=4, cache_layout="paged", page_size=4)
    jeng = JaxEngine(jm, params, JaxServeConfig(**kw))
    teng = ServingEngine(tm, ServeConfig(**kw), device="cpu")
    jst = JaxStats(rid=0, prompt_len=len(prompt), max_new_tokens=9, arrival=0.0)
    tst = RequestStats(rid=0, prompt_len=len(prompt), max_new_tokens=9, arrival=0.0)
    jpos, jlast = jeng._admit_paged(0, JaxRequest(rid=0, prompt=prompt, max_new_tokens=9), jst)
    tpos, tlast = teng._admit_paged(0, Request(rid=0, prompt=prompt, max_new_tokens=9), tst)
    assert (jpos, jlast) == (tpos, tlast)
    np.testing.assert_array_equal(teng._table, jeng._table)
    pos = np.array([tpos, 0])
    last = np.array([tlast, 0])
    for _ in range(9):
        jt, jlogits, jeng.caches = jeng._decode(
            jeng.params, jeng.caches, jnp.asarray(jeng._table),
            jnp.asarray(last, jnp.int32), jnp.asarray(pos, jnp.int32))
        tt, tlogits = teng._decode(teng.caches, torch.from_numpy(teng._table),
                                   torch.from_numpy(last), torch.from_numpy(pos))
        np.testing.assert_allclose(tlogits[0].numpy(), np.asarray(jlogits[0]), **TOL)
        assert int(tt[0]) == int(jt[0])
        last = np.array([int(tt[0]), 0])
        pos = pos + np.array([1, 0])
    for j, t in zip(jeng.caches, teng.caches):  # the pools outside page 0
        np.testing.assert_allclose(t.k[1:].numpy(), np.asarray(j.k)[1:], **TOL)
        np.testing.assert_allclose(t.v[1:].numpy(), np.asarray(j.v)[1:], **TOL)


def _run_both(seed, reqs_fn, **kw):
    jm, params, tm = _pair(seed)
    jrep = JaxEngine(jm, params, JaxServeConfig(**kw)).run(reqs_fn(JaxRequest))
    trep = ServingEngine(tm, ServeConfig(**kw), device="cpu").run(reqs_fn(Request))
    assert trep.events == jrep.events
    assert trep.decode_steps == jrep.decode_steps
    assert trep.pool_stats == jrep.pool_stats
    for rid, st in jrep.requests.items():
        got = trep.requests[rid]
        assert got.tokens == st.tokens
        assert got.shared_pages == st.shared_pages
        assert (got.first_token, got.finished) == (st.first_token, st.finished)
    return trep


def _poisson_reqs(req_cls):
    reqs, _ = jax_poisson(8, math.inf, 11, vocab_size=V, prompt_len=(2, 10),
                          new_tokens=(3, 6))
    return [req_cls(rid=r.rid, prompt=r.prompt, max_new_tokens=r.max_new_tokens,
                    arrival_time=r.arrival_time) for r in reqs]


def test_paged_run_matches_jax():
    rep = _run_both(1, _poisson_reqs, slots=3, max_len=MAX_LEN, prefill_chunk=4,
                    cache_layout="paged", page_size=4, step_time_s=0.01)
    assert rep.pool_stats == {"prefix_hits": 0, "pages_reused": 0, "retained_evictions": 0}


def test_prefix_sharing_run_matches_jax():
    head = _prompt(12, seed=21)

    def reqs(req_cls):
        return [req_cls(rid=i, prompt=np.concatenate([head, _prompt(3, seed=100 + i)]),
                        max_new_tokens=5, arrival_time=0.0) for i in range(4)]

    rep = _run_both(2, reqs, slots=2, max_len=MAX_LEN, prefill_chunk=4,
                    cache_layout="paged", page_size=4, prefix_sharing=True, step_time_s=0.01)
    assert rep.pool_stats["prefix_hits"] == 3
    assert [rep.requests[i].shared_pages for i in range(4)] == [0, 3, 3, 3]


def test_prefix_sharing_under_pool_pressure_matches_jax():
    head = _prompt(9, seed=31)

    def reqs(req_cls):
        return [
            req_cls(rid=0, prompt=head, max_new_tokens=2, arrival_time=0.0),
            req_cls(rid=1, prompt=_prompt(5, seed=32), max_new_tokens=3, arrival_time=0.0),
            req_cls(rid=2, prompt=np.concatenate([head[:8], _prompt(4, seed=33)]),
                    max_new_tokens=4, arrival_time=2.0),
        ]

    rep = _run_both(4, reqs, slots=2, max_len=MAX_LEN, prefill_chunk=4,
                    cache_layout="paged", page_size=4, prefix_sharing=True,
                    num_pages=6, step_time_s=1.0)
    assert ("defer", 2, -1, 2) in rep.events
    assert rep.requests[2].shared_pages == 2


def test_page_starved_run_matches_jax():
    def reqs(req_cls):
        return [req_cls(rid=i, prompt=_prompt(6, seed=50 + i), max_new_tokens=4,
                        arrival_time=0.0) for i in range(3)]

    rep = _run_both(4, reqs, slots=2, max_len=MAX_LEN, prefill_chunk=4,
                    cache_layout="paged", page_size=4, num_pages=5, step_time_s=0.01)
    assert any(e[0] == "defer" for e in rep.events)
    assert all(st.finished is not None and len(st.tokens) == 4
               for st in rep.requests.values())


def test_impossible_page_demand_raises_at_idle():
    tm = TransformerLM(**CFG, device="cpu")
    cfg = ServeConfig(slots=1, max_len=MAX_LEN, prefill_chunk=4, cache_layout="paged",
                      page_size=4, num_pages=3)
    big = Request(rid=0, prompt=_prompt(20, seed=9), max_new_tokens=8)
    with pytest.raises(ValueError, match="pool can ever supply"):
        ServingEngine(tm, cfg, device="cpu").run([big])


def test_paged_config_validation_and_fused_head_rejection():
    tm = TransformerLM(**CFG, device="cpu")
    with pytest.raises(ServeCompositionError, match="fused_head"):
        ServingEngine(tm, ServeConfig(slots=2, max_len=MAX_LEN, prefill_chunk=4,
                                      cache_layout="paged", fused_head=True), device="cpu")
    with pytest.raises(ValueError, match="multiple of prefill_chunk"):
        ServeConfig(max_len=MAX_LEN, prefill_chunk=8, cache_layout="paged", page_size=4,
                    prefix_sharing=True)
    with pytest.raises(ValueError, match="requires cache_layout='paged'"):
        ServeConfig(prefix_sharing=True)
    cfg = ServeConfig(slots=3, max_len=30, prefill_chunk=2, cache_layout="paged", page_size=4)
    assert (cfg.max_pages, cfg.total_pages) == (8, 25)
