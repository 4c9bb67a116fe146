"""The disaggregated KV handoff (``tpudml_torch.serve.fleet.disagg``)
against ``tpudml.serve.fleet.disagg``, on the CPU.

The handoff cases of ``tests/test_fleet_disagg.py`` run on the port: a
decode engine that adopts a prefill engine's pages serves the stream of an
engine that prefilled locally, with the pages mapped instead of prefilled;
a truncated handoff is refused by the store's CRC (``strict=True`` raises)
and the request prefills locally with the same tokens; a page-size
mismatch always raises; the handoff needs paged prefix sharing; a
sub-page prompt hands off nothing.

Across packages, on JAX's weights (``lm_params_from_tpudml``), f32 and
int8 caches: both write format 2, so JAX's handoff adopts into the port
and the port's into JAX, each side's stream equal to its own local
prefill's and to the other side's; the pages the two packages write hold
the same K/V (f32 at rtol 1e-5, atol 1e-6; int8 codes within one step,
their scales at rtol 1e-5).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from tpudml.models import TransformerLM as JaxLM  # noqa: E402
from tpudml.serve import Request as JaxRequest  # noqa: E402
from tpudml.serve import ServeConfig as JaxServeConfig  # noqa: E402
from tpudml.serve import ServingEngine as JaxEngine  # noqa: E402
from tpudml.serve.fleet.disagg import adopt_handoff as jax_adopt  # noqa: E402
from tpudml.serve.fleet.disagg import write_handoff as jax_write  # noqa: E402
from tpudml_torch.checkpoint.store import CheckpointCorruptError  # noqa: E402
from tpudml_torch.interop import lm_params_from_tpudml  # noqa: E402
from tpudml_torch.models import TransformerLM  # noqa: E402
from tpudml_torch.resilience import vandalize  # noqa: E402
from tpudml_torch.serve import Request, ServeConfig, ServingEngine  # noqa: E402
from tpudml_torch.serve.fleet.disagg import adopt_handoff, write_handoff  # noqa: E402

V = 48
MODEL = dict(vocab_size=V, embed_dim=32, num_heads=4, num_kv_heads=2, num_layers=2,
             max_len=64)
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def pair():
    jm = JaxLM(**MODEL)
    params, _ = jm.init(jax.random.key(0))
    tm = TransformerLM(**MODEL, device="cpu")
    tm.load_state_dict(lm_params_from_tpudml(jax.tree.map(np.asarray, params)))
    return jm, params, tm


def _paged(cls=ServeConfig, **kw):
    base = dict(slots=2, max_len=64, prefill_chunk=8, cache_layout="paged", page_size=8,
                prefix_sharing=True)
    base.update(kw)
    return cls(**base)


def _serve(eng, prompt, n_new=6, req=Request):
    return eng.run([req(rid=0, prompt=prompt, max_new_tokens=n_new)]).requests[0]


def _prompt(seed, n=20):
    return np.random.default_rng(seed).integers(0, V, size=n).astype(np.int32)


# ------------------------------------------------------ KV handoff


def test_handoff_adopt_greedy_parity(pair, tmp_path):
    """Adopted pages ≡ local prefill: the same tokens, and the adopting
    engine's admit maps the shipped pages instead of prefilling them."""
    tm = pair[2]
    cfg = _paged()
    prompt = _prompt(0)
    info = write_handoff(tm, cfg, prompt, tmp_path, device="cpu")
    # 20 tokens, first decode write at 19 → pages 0..1 end before it.
    assert info["n_pages"] == 2 and info["covered_tokens"] == 16
    ref = _serve(ServingEngine(tm, cfg, device="cpu"), prompt)
    assert ref.shared_pages == 0
    eng = ServingEngine(tm, cfg, device="cpu")
    assert adopt_handoff(eng, tmp_path) == 2
    st = _serve(eng, prompt)
    assert st.tokens == ref.tokens
    assert st.shared_pages == 2


def test_vandalized_handoff_rejected_with_fallback(pair, tmp_path):
    tm = pair[2]
    cfg = _paged()
    prompt = _prompt(1)
    write_handoff(tm, cfg, prompt, tmp_path, device="cpu")
    ref = _serve(ServingEngine(tm, cfg, device="cpu"), prompt)
    vandalize(tmp_path, "truncate")
    eng = ServingEngine(tm, cfg, device="cpu")
    with pytest.raises(CheckpointCorruptError):
        adopt_handoff(eng, tmp_path, strict=True)
    assert adopt_handoff(eng, tmp_path) == 0
    st = _serve(eng, prompt)
    assert st.tokens == ref.tokens
    assert st.shared_pages == 0


def test_missing_handoff_is_no_handoff(pair, tmp_path):
    eng = ServingEngine(pair[2], _paged(), device="cpu")
    assert adopt_handoff(eng, tmp_path / "none") == 0
    with pytest.raises(CheckpointCorruptError, match="no handoff"):
        adopt_handoff(eng, tmp_path / "none", strict=True)


def test_handoff_config_mismatch_raises(pair, tmp_path):
    """A wrong page size at adopt is a wiring bug: always loud, with JAX's
    message."""
    tm = pair[2]
    write_handoff(tm, _paged(), np.arange(20, dtype=np.int32) % V, tmp_path, device="cpu")
    eng = ServingEngine(tm, _paged(page_size=16), device="cpu")
    with pytest.raises(ValueError, match="mismatch") as ei:
        adopt_handoff(eng, tmp_path)
    assert str(ei.value) == (
        "handoff/engine mismatch: handoff (page_size=8, kind=f32, layers=2) vs engine "
        "(page_size=16, kind=f32, layers=2)")


def test_handoff_requires_paged_sharing(pair, tmp_path):
    dense = ServeConfig(slots=2, max_len=64, prefill_chunk=8)
    with pytest.raises(ValueError, match="prefix_sharing"):
        write_handoff(pair[2], dense, np.arange(20, dtype=np.int32), tmp_path, device="cpu")


def test_sub_page_prompt_hands_off_nothing(pair, tmp_path):
    tm = pair[2]
    cfg = _paged()
    info = write_handoff(tm, cfg, np.arange(5, dtype=np.int32), tmp_path, device="cpu")
    assert info["n_pages"] == 0
    assert adopt_handoff(ServingEngine(tm, cfg, device="cpu"), tmp_path) == 0


# ------------------------------------------------ across packages


def _leaves(path):
    from tpudml_torch.checkpoint.store import _read_leaves, _read_manifest

    man = _read_manifest(path)
    keys = ["k", "k_scale", "prompt_head", "v", "v_scale"]  # the store's sorted order
    return dict(zip(keys, _read_leaves(path, man, man["num_leaves"], True)))


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_handoffs_cross_between_jax_and_the_port(pair, tmp_path, kind):
    """JAX's handoff adopts into the port, the port's into JAX: each adopted
    stream equals its own side's local prefill and the other side's, and
    the two packages' pages hold the same K/V."""
    jm, params, tm = pair
    prompt = _prompt(2, 26)  # 3 pages of 8 end before the first decode write at 25
    jcfg, tcfg = _paged(JaxServeConfig, cache_kind=kind), _paged(cache_kind=kind)
    jinfo = jax_write(jm, params, jcfg, prompt, tmp_path / "jax")
    tinfo = write_handoff(tm, tcfg, prompt, tmp_path / "port", device="cpu")
    assert jinfo["n_pages"] == tinfo["n_pages"] == 3

    jref = _serve(JaxEngine(jm, params, jcfg), prompt, req=JaxRequest)
    tref = _serve(ServingEngine(tm, tcfg, device="cpu"), prompt)
    assert tref.tokens == jref.tokens

    teng = ServingEngine(tm, tcfg, device="cpu")
    assert adopt_handoff(teng, tmp_path / "jax") == 3
    got = _serve(teng, prompt)
    assert got.tokens == tref.tokens and got.shared_pages == 3

    jeng = JaxEngine(jm, params, jcfg)
    assert jax_adopt(jeng, tmp_path / "port") == 3
    jgot = _serve(jeng, prompt, req=JaxRequest)
    assert jgot.tokens == jref.tokens and jgot.shared_pages == 3

    a, b = _leaves(jinfo["path"]), _leaves(tinfo["path"])
    assert a["prompt_head"].tolist() == b["prompt_head"].tolist() == prompt[:24].tolist()
    assert {n: (t.dtype, tuple(t.shape)) for n, t in a.items()} == \
        {n: (t.dtype, tuple(t.shape)) for n, t in b.items()}
    for n in ("k", "v"):
        if kind == "int8":
            assert (a[n].int() - b[n].int()).abs().max() <= 1, n
            np.testing.assert_allclose(b[f"{n}_scale"].numpy(), a[f"{n}_scale"].numpy(), **TOL)
        else:
            np.testing.assert_allclose(b[n].numpy(), a[n].numpy(), **TOL)
