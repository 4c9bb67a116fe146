"""Tensor-parallel serving of the port (``ServingEngine(mesh=)``,
``serve/tp.py``, task6 ``--tp``) against ``tpudml``, on the CPU.

At world 2 over gloo (``tests/torch_dist_worker.py``'s ``serve_tp``
suite, spawned once), from JAX's parameters (V=48, d=32, H=4, L=2,
max_len 32, RoPE, as ``tests/test_serve.py``):

- the TP decode step's logits, step by step over six greedy steps after a
  chunked prefill, against JAX's ``TPServing`` at world 2 (configs
  ``rope_dense``, ``rope_gqa`` and ``rope_gqa`` with the int8 cache;
  rtol 1e-5, atol 1e-6) with equal tokens, and against the port's own
  unsharded full forward; each rank holds its 1/W blocks;
- task6 ``--tp 2`` under ``--step_time_s``: the event log identical on
  both ranks and equal to JAX's task6 ``--tp 2`` engine's on the same
  workload; under the wall clock (every reading rank 0's) the two ranks'
  event logs and streams identical.

In-process: the rejections with JAX's keys and texts (non-dividing
heads, paged, spec, weight quantization, the fused head, ``TPServing``'s
own guard), ``mesh={"model": 1}`` on a one-rank group against the dense
engine, and task6 ``--tp 2`` alone.
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

import torch_dist_worker  # noqa: E402
from tasks import task6_serve as jax_task6  # noqa: E402
from tpudml.capabilities import TABLE as JAX_TABLE  # noqa: E402
from tpudml.core.config import MeshConfig  # noqa: E402
from tpudml.core.dist import make_mesh  # noqa: E402
from tpudml.models import TransformerLM as JaxLM  # noqa: E402
from tpudml.serve import Request as JaxRequest  # noqa: E402
from tpudml.serve import ServeConfig as JaxServeConfig  # noqa: E402
from tpudml.serve import ServingEngine as JaxEngine  # noqa: E402
from tpudml.serve import poisson_workload as jax_poisson  # noqa: E402
from tpudml_torch.core import DistributedConfig, process_group  # noqa: E402
from tpudml_torch.interop import lm_params_from_tpudml  # noqa: E402
from tpudml_torch.models import TransformerLM  # noqa: E402
from tpudml_torch.serve import (  # noqa: E402
    ServeCompositionError, ServeConfig, ServingEngine, poisson_workload,
)
from tpudml_torch.serve.tp import TPServing  # noqa: E402
from tpudml_torch.tasks import task6_serve  # noqa: E402

MODEL = dict(vocab_size=48, embed_dim=32, num_heads=4, num_layers=2, max_len=32, rope=True)
CONFIGS = {"rope_dense": ({}, "f32"), "rope_gqa": ({"num_kv_heads": 2}, "f32"),
           "rope_gqa_int8": ({"num_kv_heads": 2}, "int8")}
STEPS = 6
TOL = dict(rtol=1e-5, atol=1e-6)
TASK6 = ["--tp", "2", "--n_requests", "6", "--qps", "40", "--vocab", "48", "--embed_dim",
         "32", "--num_heads", "4", "--num_kv_heads", "2", "--num_layers", "1", "--max_len",
         "64", "--slots", "2", "--prefill_chunk", "4", "--prompt_len", "4", "12",
         "--new_tokens", "3", "9"]
STEP_TIME = ["--step_time_s", "0.01"]


def _prompt(n=11, seed=9):
    return np.random.default_rng(seed).integers(0, MODEL["vocab_size"], n).astype(np.int32)


def _jax_decode(extra, kind):
    """JAX's TPServing at world 2: (params, slot-0 logits of each step,
    tokens), as ``tests/test_serve.py::test_tp_decode_logits_match_full_forward``
    drives it."""
    mesh = make_mesh(MeshConfig({"model": 2}), jax.devices()[:2])
    model = JaxLM(**MODEL, **extra)
    params, _ = model.init(jax.random.key(3))
    cfg = JaxServeConfig(slots=2, max_len=32, prefill_chunk=4, cache_kind=kind)
    eng = JaxEngine(model, params, cfg, mesh=mesh, axis_name="model")
    pos0, last0 = eng._admit(0, JaxRequest(rid=0, prompt=_prompt(), max_new_tokens=STEPS))
    pos, last = np.array([pos0, 0], np.int32), np.array([last0, 0], np.int32)
    logits, tokens = [], []
    for _ in range(STEPS):
        nxt, lg, eng.caches = eng._decode(eng.params, eng.caches, jnp.asarray(last),
                                          jnp.asarray(pos))
        logits.append(np.asarray(lg[0]))
        tokens.append(int(nxt[0]))
        last, pos = np.array([tokens[-1], 0], np.int32), pos + np.array([1, 0], np.int32)
    return jax.tree.map(np.asarray, params), logits, tokens


def _jax_task6_events(argv):
    args = jax_task6.parse_args(argv)
    engine = jax_task6.build_engine(args)
    requests, _ = jax_poisson(args.n_requests, float(args.qps), args.seed,
                              vocab_size=args.vocab, prompt_len=tuple(args.prompt_len),
                              new_tokens=tuple(args.new_tokens))
    return engine.run(requests).events


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    job = tmp_path_factory.mktemp("serve_tp")
    want, decode = {}, {}
    for name, (extra, kind) in CONFIGS.items():
        params, logits, tokens = _jax_decode(extra, kind)
        want[name] = (logits, tokens)
        decode[name] = {"model": dict(MODEL, **extra), "state": lm_params_from_tpudml(params),
                        "cfg": dict(slots=2, max_len=32, prefill_chunk=4, cache_kind=kind),
                        "prompt": _prompt(), "steps": STEPS}
    want["virtual"] = _jax_task6_events(TASK6 + STEP_TIME)
    cpu = ["--device", "cpu"]
    torch.save({"decode": decode, "task6": {"virtual": cpu + TASK6 + STEP_TIME,
                                            "wall": cpu + TASK6}}, job / "cases.pt")
    return want, decode, torch_dist_worker.spawn("serve_tp", job, 2)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_tp_decode_logits_match_jax_tpserving(runs, name):
    want, _, ranks = runs
    logits, tokens = want[name]
    for got in ranks:
        assert got[name]["tokens"] == tokens
        for g, w in zip(got[name]["logits"], logits):
            np.testing.assert_allclose(g.numpy(), w, **TOL)


@pytest.mark.parametrize("name", ["rope_dense", "rope_gqa"])
def test_tp_decode_matches_the_unsharded_full_forward(runs, name):
    """The same logits against the port's own full forward over the prompt
    and the emitted tokens (teacher forcing)."""
    _, decode, ranks = runs
    spec = decode[name]
    model = TransformerLM(**spec["model"], device="cpu")
    model.load_state_dict(spec["state"])
    got = ranks[0][name]
    seq = np.concatenate([spec["prompt"], got["tokens"][:-1]])
    with torch.no_grad():
        full = model(torch.from_numpy(seq[None]).long())[0]
    p = len(spec["prompt"]) - 1
    for i, g in enumerate(got["logits"]):
        np.testing.assert_allclose(g.numpy(), full[p + i].numpy(), **TOL)


def test_each_rank_holds_its_blocks(runs):
    """Every rank keeps 1/W of the heads, the MLP and the vocabulary (the
    rules' placement), and the norms, positions and row-parallel biases
    whole."""
    _, _, ranks = runs
    for got in ranks:
        held = got["rope_gqa"]["held"]
        assert held["tok_embed"] == (24, 32) and held["head.kernel"] == (32, 24)
        assert held["head.bias"] == (24,)
        assert held["block0.attn.q.kernel"] == (32, 16)
        assert held["block0.attn.k.kernel"] == (32, 8)  # kv_heads 2 over 2 ranks
        assert held["block0.attn.out.kernel"] == (16, 32)
        assert held["block0.attn.out.bias"] == (32,)
        assert held["block0.fc1.kernel"] == (32, 64) and held["block0.fc2.kernel"] == (64, 32)
        assert held["block0.ln1.scale"] == (32,)


def test_task6_tp2_virtual_clock_event_log_is_jax_s(runs):
    want, _, ranks = runs
    assert ranks[0]["virtual"]["events"] == ranks[1]["virtual"]["events"]
    assert ranks[0]["virtual"]["events"] == [tuple(e) for e in want["virtual"]]
    assert ranks[0]["virtual"]["streams"] == ranks[1]["virtual"]["streams"]
    assert any(e[0] == "admit" and e[3] > 0 for e in want["virtual"])  # mid-flight refills


def test_task6_tp2_wall_clock_ranks_agree(runs):
    """Under the wall clock each rank reads rank 0's clock: the two ranks
    take the same decisions (one event log) and emit the same streams."""
    _, _, ranks = runs
    a, b = ranks[0]["wall"], ranks[1]["wall"]
    assert a["events"] == b["events"] and a["streams"] == b["streams"]
    assert a["decode_steps"] == b["decode_steps"] and a["generated_tokens"] == b["generated_tokens"]


def _jax_msg(key):
    return re.escape(JAX_TABLE[key].message)


def test_tp_rejections_carry_jax_keys_and_texts():
    model = TransformerLM(**MODEL, num_kv_heads=2, device="cpu")
    base = dict(slots=2, max_len=32, prefill_chunk=4)
    mesh = {"model": 2}
    for kw, key in (({"cache_layout": "paged", "page_size": 4}, "serve_tp_paged_spec"),
                    ({"spec_k": 2}, "serve_tp_paged_spec"),
                    ({"weight_quant": "int8"}, "serve_tp_weight_quant"),
                    ({"fused_head": True}, "serve_fused_head_dense")):
        with pytest.raises(ServeCompositionError, match=_jax_msg(key)):
            ServingEngine(model, ServeConfig(**base, **kw), device="cpu", mesh=mesh)
    with pytest.raises(ServeCompositionError, match=_jax_msg("serve_tp_dense_only")):
        TPServing(model, mesh, "model", ServeConfig(**base, cache_layout="paged", page_size=4))
    odd = TransformerLM(**dict(MODEL, num_heads=3, embed_dim=36), num_kv_heads=3, device="cpu")
    with pytest.raises(ValueError, match="num_heads \\(3\\) divisible by the 'model' axis size"):
        ServingEngine(odd, ServeConfig(**base), device="cpu", mesh=mesh)


def test_mesh_model_1_equals_the_dense_engine(tmp_path):
    """``mesh={"model": 1}`` over a one-rank gloo group serves the dense
    engine's streams and event log (virtual clock)."""
    model = TransformerLM(**MODEL, num_kv_heads=2, device="cpu")
    requests, _ = poisson_workload(5, 50.0, 1, vocab_size=48, prompt_len=(3, 14),
                                   new_tokens=(2, 8))
    cfg = ServeConfig(slots=2, max_len=32, prefill_chunk=4, step_time_s=0.01)
    dense = ServingEngine(model, cfg, device="cpu").run(requests)
    with process_group(DistributedConfig(coordinator_address=f"file://{tmp_path}/store",
                                         num_processes=1), device="cpu"):
        tp = ServingEngine(model, cfg, device="cpu", mesh={"model": 1}).run(requests)
    assert tp.events == dense.events
    assert {r: s.tokens for r, s in tp.requests.items()} == \
        {r: s.tokens for r, s in dense.requests.items()}


def test_task6_tp_needs_its_ranks(tmp_path):
    """A process started alone is a one-rank group: ``--tp 2`` raises JAX's
    RuntimeError, ``--tp 1`` serves."""
    argv = ["--device", "cpu", "--n_requests", "2", "--embed_dim", "32", "--num_heads", "4",
            "--num_layers", "1", "--max_len", "64", "--prompt_len", "4", "8",
            "--new_tokens", "2", "4", "--log_dir", str(tmp_path)]
    with pytest.raises(RuntimeError, match="--tp 2 needs 2 devices, have 1"):
        task6_serve.main(argv + ["--tp", "2"])
    alone = task6_serve.main(argv + ["--tp", "1", "--step_time_s", "0.01"])
    dense = task6_serve.main(argv + ["--step_time_s", "0.01"])
    assert alone["events"] == dense["events"] and alone["streams"] == dense["streams"]
