"""SLO-priced admission in the PyTorch port against ``tpudml.serve.sched``
and the JAX ``ServingEngine``, on the CPU.

- ``DecodeCostModel.step_seconds(n)`` equal to JAX's (float equality) for
  n = 0..slots under the dense, paged, spec, fused-head and int8 configs,
  and ``admit_ok`` with it;
- the SLO deferral run (JAX's ``test_slo_admission_defers_deterministically``)
  and the paged + spec overload run under a bounded queue
  (``test_paged_spec_overload_run_is_byte_deterministic``): event logs
  byte-identical to JAX's, and to a second run of the port.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from tpudml.models import TransformerLM as JaxLM  # noqa: E402
from tpudml.serve import DecodeCostModel as JaxCost  # noqa: E402
from tpudml.serve import Request as JaxRequest  # noqa: E402
from tpudml.serve import ServeConfig as JaxServeConfig  # noqa: E402
from tpudml.serve import ServingEngine as JaxEngine  # noqa: E402
from tpudml.serve import SLOConfig as JaxSLO  # noqa: E402
from tpudml.serve import draft_from_trunk as jax_draft  # noqa: E402
from tpudml.serve import poisson_workload as jax_poisson  # noqa: E402
from tpudml_torch.interop import lm_params_from_tpudml  # noqa: E402
from tpudml_torch.models import TransformerLM  # noqa: E402
from tpudml_torch.serve import (  # noqa: E402
    DecodeCostModel, Request, ServeConfig, ServingEngine, SLOConfig, draft_from_trunk,
    poisson_workload,
)

V, D, HEADS, LAYERS, MAX_LEN = 48, 32, 4, 2, 32
CFG = dict(vocab_size=V, embed_dim=D, num_heads=HEADS, num_layers=LAYERS,
           max_len=MAX_LEN, rope=True, num_kv_heads=2)


def _pair(seed: int):
    jm = JaxLM(**CFG)
    params, _ = jm.init(jax.random.key(seed))
    tm = TransformerLM(**CFG, device="cpu")
    tm.load_state_dict(lm_params_from_tpudml(jax.tree.map(np.asarray, params)))
    return jm, params, tm


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(0, V, n).astype(np.int32)


@pytest.mark.parametrize("kw", [
    {},
    {"cache_layout": "paged", "page_size": 6},
    {"spec_k": 3},
    {"fused_head": True},
    {"cache_kind": "int8", "weight_quant": "int8"},
    {"cache_kind": "bf16", "cache_layout": "paged", "page_size": 4, "spec_k": 2},
], ids=["dense", "paged", "spec", "fused_head", "int8", "bf16_paged_spec"])
def test_step_seconds_match_jax(kw):
    jm, params, tm = _pair(0)
    base = dict(slots=5, max_len=MAX_LEN, prefill_chunk=4, **kw)
    slo = dict(tpot_budget_s=2e-5, hbm_gbps=3350.0)
    jdraft = tdraft = None
    if kw.get("spec_k"):
        jdraft, _ = jax_draft(jm, params, 1)
        tdraft, _ = draft_from_trunk(tm, 1)
    jcost = JaxCost(jm, JaxServeConfig(**base), JaxSLO(**slo), draft_model=jdraft)
    tcost = DecodeCostModel(tm, ServeConfig(**base), SLOConfig(**slo), draft_model=tdraft)
    for n in range(base["slots"] + 1):
        assert tcost.step_seconds(n) == jcost.step_seconds(n)
        assert tcost.admit_ok(n) == jcost.admit_ok(n)
    assert tcost.per_slot_bytes == jcost.per_slot_bytes
    assert tcost.params_bytes == jcost.params_bytes


def test_slo_validation():
    with pytest.raises(ValueError, match="tpot_budget_s"):
        SLOConfig(tpot_budget_s=0.0)
    with pytest.raises(ValueError, match="hbm_gbps"):
        SLOConfig(tpot_budget_s=1.0, hbm_gbps=0.0)


def test_slo_deferral_log_matches_jax():
    jm, params, tm = _pair(3)
    base = dict(slots=3, max_len=MAX_LEN, prefill_chunk=4, step_time_s=0.01)
    probe = DecodeCostModel(tm, ServeConfig(**base), SLOConfig(tpot_budget_s=1.0))
    budget = (probe.step_seconds(1) + probe.step_seconds(2)) / 2

    def reqs(req_cls):
        return [req_cls(rid=i, prompt=_prompt(6, i), max_new_tokens=4, arrival_time=0.0)
                for i in range(4)]

    jrep = JaxEngine(jm, params, JaxServeConfig(**base, slo=JaxSLO(tpot_budget_s=budget))
                     ).run(reqs(JaxRequest))
    cfg = ServeConfig(**base, slo=SLOConfig(tpot_budget_s=budget))
    runs = [ServingEngine(tm, cfg, device="cpu").run(reqs(Request)) for _ in range(2)]
    for rep in runs:
        assert repr(rep.events).encode() == repr(jrep.events).encode()
        for rid, st in jrep.requests.items():
            assert rep.requests[rid].tokens == st.tokens
    assert any(e[0] == "defer" for e in jrep.events)
    assert [e[1] for e in jrep.events if e[0] == "admit"] == [0, 1, 2, 3]


def test_paged_spec_overload_log_matches_jax():
    jm, params, tm = _pair(6)
    kw = dict(slots=1, max_len=MAX_LEN, prefill_chunk=4, cache_layout="paged",
              page_size=4, spec_k=2, max_queue=2, step_time_s=0.01)
    wl = dict(vocab_size=V, prompt_len=(2, 6), new_tokens=(8, 8))
    jrep = JaxEngine(jm, params, JaxServeConfig(**kw), draft_layers=1).run(
        jax_poisson(10, 40.0, seed=5, **wl)[0])
    runs = [ServingEngine(tm, ServeConfig(**kw), device="cpu", draft_layers=1).run(
        poisson_workload(10, 40.0, seed=5, **wl)[0]) for _ in range(2)]
    for rep in runs:
        assert repr(rep.events).encode() == repr(jrep.events).encode()
        assert rep.decode_steps == jrep.decode_steps
        assert rep.rejected == jrep.rejected > 0
        assert rep.pool_stats == jrep.pool_stats
        for rid, st in jrep.requests.items():
            assert rep.requests[rid].tokens == st.tokens
    assert any(e[0] == "spec" for e in jrep.events)
    assert not math.isnan(runs[0].latency_summary()["per_token_p50_s"])
