"""Speculative decoding in the PyTorch port against ``tpudml.serve.spec``
and the JAX ``ServingEngine``, on the CPU.

- ``_verify`` keeps the longest agreeing draft prefix and emits the
  target's correction (the JAX unit cases, and a seeded sweep against
  JAX's ``_verify``);
- ``draft_from_trunk`` shares the target's storage (``data_ptr`` equal, no
  copy) and keeps JAX's bounds;
- spec streams, dense and paged, equal pure greedy and JAX's spec engine,
  with the ``("spec", ...)`` events' ``accepted_len`` identical;
- a perfect draft accepts every token; the verify headroom is reserved at
  admission; ``draft_model`` without ``draft_params`` raises; ``fused_head``
  × spec raises ``ServeCompositionError``.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from tpudml.models import TransformerLM as JaxLM  # noqa: E402
from tpudml.serve import Request as JaxRequest  # noqa: E402
from tpudml.serve import ServeConfig as JaxServeConfig  # noqa: E402
from tpudml.serve import ServingEngine as JaxEngine  # noqa: E402
from tpudml.serve import poisson_workload as jax_poisson  # noqa: E402
from tpudml.serve.spec import _verify as jax_verify  # noqa: E402
from tpudml_torch.interop import lm_params_from_tpudml  # noqa: E402
from tpudml_torch.models import TransformerLM  # noqa: E402
from tpudml_torch.serve import (  # noqa: E402
    Request, ServeCompositionError, ServeConfig, ServingEngine, draft_from_trunk,
    make_spec_decode_step,
)
from tpudml_torch.serve.spec import _verify  # noqa: E402

V, D, HEADS, LAYERS, MAX_LEN = 48, 32, 4, 2, 32
CFG = dict(vocab_size=V, embed_dim=D, num_heads=HEADS, num_layers=LAYERS,
           max_len=MAX_LEN, rope=True, num_kv_heads=2)


def _pair(seed: int):
    jm = JaxLM(**CFG)
    params, _ = jm.init(jax.random.key(seed))
    tm = TransformerLM(**CFG, device="cpu")
    tm.load_state_dict(lm_params_from_tpudml(jax.tree.map(np.asarray, params)))
    return jm, params, tm


def _onehot_logits(rows):
    out = np.zeros((len(rows), len(rows[0]), V), np.float32)
    for b, toks in enumerate(rows):
        for j, t in enumerate(toks):
            out[b, j, t] = 1.0
    return torch.from_numpy(out)


# ------------------------------------------------------------- verify


def test_verify_accepts_longest_agreeing_prefix():
    window = torch.tensor([[10, 5, 7, 9]] * 3)
    target = [[5, 7, 9, 3], [5, 8, 9, 3], [4, 7, 9, 3]]
    emitted, n_emit = _verify(window, _onehot_logits(target), 3)
    assert n_emit.tolist() == [4, 2, 1]
    assert emitted.tolist() == target
    emitted, n_emit = _verify(torch.tensor([[1, 2, 3]]), _onehot_logits([[7, 8, 9]]), 2)
    assert n_emit.tolist() == [1] and emitted[0, 0].item() == 7


@pytest.mark.parametrize("seed", range(3))
def test_verify_matches_jax(seed):
    """Windows and logits with many exact ties (small integer logits):
    both pick the first maximum, and the commit counts agree."""
    rng = np.random.default_rng(seed)
    k = 3
    logits = rng.integers(0, 3, (16, k + 1, 6)).astype(np.float32)
    window = rng.integers(0, 6, (16, k + 1)).astype(np.int32)
    window[:8, 1:] = np.argmax(logits[:8, :k], axis=-1)  # long accepts too
    emitted, n_emit = _verify(torch.from_numpy(window).long(), torch.from_numpy(logits), k)
    je, jn = jax_verify(jnp.asarray(window), jnp.asarray(logits), k)
    np.testing.assert_array_equal(emitted.numpy(), np.asarray(je))
    np.testing.assert_array_equal(n_emit.numpy(), np.asarray(jn))


# ------------------------------------------------------------ the draft


def test_draft_from_trunk_shares_the_targets_storage():
    tm = TransformerLM(**CFG, device="cpu")
    draft, dparams = draft_from_trunk(tm, 1)
    assert draft.num_layers == 1 and tm.num_layers == LAYERS
    assert len(draft.blocks()) == 1 and draft.block0 is tm.block0
    assert not hasattr(draft, "block1")
    assert draft.head is tm.head and draft.ln_f is tm.ln_f
    target = dict(tm.named_parameters())
    assert set(dparams) == {n for n in target if not n.startswith("block1.")}
    for name, p in dparams.items():
        assert p.data_ptr() == target[name].data_ptr(), name
    assert "pos_embed" in dict(draft_from_trunk(
        TransformerLM(**{**CFG, "rope": False}, device="cpu"), 1)[1])


def test_draft_from_trunk_validates_bounds():
    tm = TransformerLM(**CFG, device="cpu")
    for bad in (0, LAYERS, LAYERS + 1):
        with pytest.raises(ValueError, match="draft num_layers"):
            draft_from_trunk(tm, bad)
    with pytest.raises(ValueError, match="spec_k"):
        make_spec_decode_step(tm, tm, 0)


# --------------------------------------------- streams against JAX


def _poisson_reqs(req_cls):
    reqs, _ = jax_poisson(6, math.inf, 13, vocab_size=V, prompt_len=(2, 8),
                          new_tokens=(4, 7))
    return [req_cls(rid=r.rid, prompt=r.prompt, max_new_tokens=r.max_new_tokens,
                    arrival_time=r.arrival_time) for r in reqs]


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_spec_streams_match_greedy_and_jax(layout):
    """A weak 1-layer draft: the committed tokens equal pure greedy, and
    the spec engine's events (accepted_len included) equal JAX's."""
    jm, params, tm = _pair(1)
    paged = dict(cache_layout="paged", page_size=4) if layout == "paged" else {}
    kw = dict(slots=2, max_len=MAX_LEN, prefill_chunk=4, step_time_s=0.01, **paged)
    ref = ServingEngine(tm, ServeConfig(**kw), device="cpu").run(_poisson_reqs(Request))
    got = ServingEngine(tm, ServeConfig(spec_k=2, **kw), device="cpu",
                        draft_layers=1).run(_poisson_reqs(Request))
    jrep = JaxEngine(jm, params, JaxServeConfig(spec_k=2, **kw),
                     draft_layers=1).run(_poisson_reqs(JaxRequest))
    for rid, st in ref.requests.items():
        assert got.requests[rid].tokens == st.tokens
        assert got.requests[rid].tokens == jrep.requests[rid].tokens
    assert got.events == jrep.events
    assert got.decode_steps == jrep.decode_steps
    assert got.pool_stats == jrep.pool_stats
    specs = [e for e in got.events if e[0] == "spec"]
    assert specs and all(0 <= e[4] <= 2 for e in specs)
    assert sum(e[4] + 1 for e in specs) == got.generated_tokens
    assert got.mean_accepted_len == jrep.mean_accepted_len


def test_perfect_draft_accepts_every_token():
    tm = TransformerLM(**CFG, device="cpu", generator=torch.Generator().manual_seed(2))
    reqs = [Request(rid=0, prompt=np.arange(5, dtype=np.int32), max_new_tokens=9)]
    cfg = ServeConfig(slots=1, max_len=MAX_LEN, prefill_chunk=4, spec_k=2)
    rep = ServingEngine(tm, cfg, device="cpu", draft_model=tm,
                        draft_params=tm.state_dict()).run(reqs)
    assert all(e[4] == 2 for e in rep.events if e[0] == "spec")
    assert rep.mean_accepted_len == 2.0
    assert rep.decode_steps == 3  # ceil(9 / (K+1)) target steps, not 9
    ref = ServingEngine(tm, ServeConfig(slots=1, max_len=MAX_LEN, prefill_chunk=4),
                        device="cpu").run(reqs)
    assert rep.requests[0].tokens == ref.requests[0].tokens
    # A window truncated by the budget logs only what it committed.
    short = [Request(rid=0, prompt=np.arange(5, dtype=np.int32), max_new_tokens=4)]
    rep = ServingEngine(tm, cfg, device="cpu", draft_model=tm,
                        draft_params=tm.state_dict()).run(short)
    assert [e[4] for e in rep.events if e[0] == "spec"] == [2, 0]


def test_spec_headroom_reserved_at_admission():
    tm = TransformerLM(**CFG, device="cpu")
    cfg = ServeConfig(slots=1, max_len=MAX_LEN, prefill_chunk=4, spec_k=2)
    req = Request(rid=0, prompt=np.zeros(22, np.int32), max_new_tokens=9)  # 22+9+2 > 32
    with pytest.raises(ValueError, match="verify headroom"):
        ServingEngine(tm, cfg, device="cpu", draft_layers=1).run([req])
    rep = ServingEngine(tm, ServeConfig(slots=1, max_len=MAX_LEN, prefill_chunk=4),
                        device="cpu").run([req])
    assert rep.requests[0].finished is not None


def test_draft_model_needs_params_and_fused_head_rejects_spec():
    tm = TransformerLM(**CFG, device="cpu")
    cfg = ServeConfig(slots=1, max_len=MAX_LEN, prefill_chunk=4, spec_k=2)
    with pytest.raises(ValueError, match="draft_params"):
        ServingEngine(tm, cfg, device="cpu", draft_model=tm)
    with pytest.raises(ServeCompositionError, match="spec"):
        ServingEngine(tm, ServeConfig(slots=1, max_len=MAX_LEN, prefill_chunk=4,
                                      spec_k=2, fused_head=True), device="cpu")
