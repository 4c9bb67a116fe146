"""The port's ``ContextParallel`` engine against ``tpudml``'s, on the CPU
over gloo (``tests/torch_dist_worker.py``'s ``cp`` suite at 4 ranks,
spawned once), from JAX's initial parameters, the cases of
``tests/test_cp.py`` and ``tests/test_gqa.py:59``:

- the ring trajectory on ``{"seq": 4}`` (SGD, four steps): every loss
  within rtol 1e-5 of JAX's engine's, the final parameters within
  GRAD_TOL (rtol 1e-4, atol 1e-6) of JAX's and of the port's own
  single-device training on the whole sequence;
- the striped ring with GQA and RoPE (Adam, five steps) against JAX's
  striped engine, and against the port's contiguous run;
- CP×DP on ``{"data": 2, "seq": 2}``, the batch over data and the time
  over seq (SGD, three steps), against JAX's 2-D engine;
- ``evaluate`` (token accuracy) and ``make_forward`` (the ring with GQA,
  Ulysses) against JAX's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

import torch_dist_worker  # noqa: E402
from tpudml.core.config import MeshConfig  # noqa: E402
from tpudml.core.dist import make_mesh  # noqa: E402
from tpudml.core.prng import seed_key  # noqa: E402
from tpudml.data.datasets import synthetic_lm  # noqa: E402
from tpudml.models import TransformerLM as JaxLM  # noqa: E402
from tpudml.optim import make_optimizer as jax_optimizer  # noqa: E402
from tpudml.parallel.cp import ContextParallel as JaxCP  # noqa: E402
from tpudml_torch.interop import lm_params_from_tpudml  # noqa: E402
from tpudml_torch.models import TransformerLM  # noqa: E402
from tpudml_torch.optim import make_optimizer  # noqa: E402
from tpudml_torch.train import TrainState, make_train_step  # noqa: E402

T = 32
LOSS_TOL = dict(rtol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _tokens(seed, b, vocab=50, t=T):
    tok = np.random.default_rng(seed).integers(0, vocab, size=(b, t + 1)).astype(np.int32)
    return tok[:, :-1], tok[:, 1:]


# name: (model, optimizer, lr, mesh, batch_axis, init seed, batches, steps, evaluate, forward)
def _cases():
    base = dict(vocab_size=50, embed_dim=32, num_heads=4, num_layers=2, max_len=T)
    seqs = synthetic_lm(4, 33, 32, seed=6)
    striped = dict(vocab_size=32, embed_dim=32, num_heads=4, num_kv_heads=2, num_layers=1,
                   max_len=64, rope=True, seq_layout="striped")
    gqa = dict(vocab_size=32, embed_dim=32, num_heads=4, num_layers=1, max_len=16,
               num_kv_heads=2)
    tok = np.random.default_rng(1).integers(0, 32, size=(2, 16)).astype(np.int32)
    return {
        "trajectory": (dict(base, impl="ring"), "sgd", 0.1, {"seq": 4}, None, 5,
                       [_tokens(4, 2)] * 4, 4, False, False),
        "striped_gqa_rope": (dict(striped, impl="ring"), "adam", 0.01, {"seq": 4}, None, 5,
                             [(seqs[:, :32], seqs[:, 1:33])] * 5, 5, False, False),
        "contiguous_gqa_rope": (dict(striped, impl="ring", seq_layout="contiguous"), "adam",
                                0.01, {"seq": 4}, None, 5,
                                [(seqs[:, :32], seqs[:, 1:33])] * 5, 5, False, False),
        "cp_dp": (dict(base, impl="ring"), "sgd", 0.1, {"data": 2, "seq": 2}, "data", 8,
                  [_tokens(7, 4)] * 3, 3, False, False),
        "evaluate": (dict(base, num_layers=1, impl="ring"), "sgd", 0.1, {"seq": 4}, None, 10,
                     [_tokens(9, 2)], 0, True, False),
        "forward_ring_gqa": (dict(gqa, impl="ring"), "sgd", 0.1, {"seq": 4}, None, 2,
                             [(tok, tok)], 0, False, True),
        "forward_ulysses": (dict(base, impl="ulysses"), "sgd", 0.1, {"seq": 4}, None, 0,
                            [_tokens(3, 2)], 0, False, True),
    }


def _jax_case(model, opt, lr, mesh, batch_axis, seed, batches, steps, evaluate, forward):
    devices = jax.devices()[:4]
    jmesh = make_mesh(MeshConfig(mesh), devices)
    layout = model.get("seq_layout", "contiguous")
    jm = JaxLM(**model, seq_sharded=True)
    eng = JaxCP(jm, jax_optimizer(opt, lr), jmesh, batch_axis=batch_axis, layout=layout)
    ts = eng.create_state(seed_key(seed))
    init = jax.tree.map(np.asarray, jax.device_get(ts.params))
    out = {"init": init}
    if forward:
        out["logits"] = np.asarray(eng.make_forward()(ts.params, jnp.asarray(batches[0][0])))
    if evaluate:
        out["accuracy"] = eng.evaluate(ts, batches)
    step = eng.make_train_step()
    out["losses"] = []
    for x, y in batches[:steps]:
        ts, m = step(ts, x, y)
        out["losses"].append(float(m["loss"]))
    out["params"] = lm_params_from_tpudml(jax.tree.map(np.asarray, jax.device_get(ts.params)))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    job = tmp_path_factory.mktemp("cp_engine")
    want, engine = {}, {}
    for name, case in _cases().items():
        model, opt, lr, mesh, batch_axis, _, batches, steps, evaluate, forward = case
        want[name] = _jax_case(*case)
        engine[name] = {"model": dict(model, seq_sharded=True), "opt": opt, "lr": lr,
                        "mesh": mesh, "batch_axis": batch_axis,
                        "state": lm_params_from_tpudml(want[name]["init"]),
                        "batches": batches, "steps": steps, "evaluate": evaluate,
                        "forward": forward}
    torch.save({"attn": {}, "engine": engine}, job / "cases.pt")
    return want, engine, torch_dist_worker.spawn("cp", job, 4)


def _close(got: dict, want: dict):
    assert set(got) == set(want)
    for n in want:
        np.testing.assert_allclose(got[n].numpy(), want[n].numpy(), **GRAD_TOL, err_msg=n)


@pytest.mark.parametrize("name", ["trajectory", "striped_gqa_rope", "cp_dp"])
def test_trajectory_matches_jax_engine(runs, name):
    want, _, ranks = runs
    for got in ranks:
        np.testing.assert_allclose(got[name]["losses"], want[name]["losses"], **LOSS_TOL)
        _close(got[name]["params"], want[name]["params"])
    assert want[name]["losses"][-1] < want[name]["losses"][0]


def test_trajectory_matches_single_device_training(runs):
    """The port's CP run against the port's own single-device training of
    the whole sequence (plain attention) from the same parameters."""
    _, engine, ranks = runs
    case = engine["trajectory"]
    model = TransformerLM(**dict(case["model"], impl="full", seq_sharded=False), device="cpu")
    model.load_state_dict(case["state"])
    opt = make_optimizer("sgd", 0.1)
    ts, step = TrainState.create(model, opt), make_train_step(model, opt)
    losses = []
    for x, y in case["batches"]:
        ts, m = step(ts, x, y)
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(ranks[0]["trajectory"]["losses"], losses, **LOSS_TOL)
    _close(ranks[0]["trajectory"]["params"],
           {n: p.detach() for n, p in model.named_parameters()})


def test_striped_equals_contiguous(runs):
    """The layout is invisible to the math: striped and contiguous runs of
    the GQA + RoPE model take the same losses (JAX's test, at its rtol
    2e-4; here within 1e-5)."""
    _, _, ranks = runs
    np.testing.assert_allclose(ranks[0]["striped_gqa_rope"]["losses"],
                               ranks[0]["contiguous_gqa_rope"]["losses"], rtol=1e-5)


def test_evaluate_matches_jax(runs):
    want, _, ranks = runs
    for got in ranks:
        assert got["evaluate"]["accuracy"] == pytest.approx(want["evaluate"]["accuracy"],
                                                            abs=1e-12)


@pytest.mark.parametrize("name", ["forward_ring_gqa", "forward_ulysses"])
def test_forward_matches_jax(runs, name):
    want, _, ranks = runs
    for got in ranks:
        np.testing.assert_allclose(got[name]["logits"].numpy(), want[name]["logits"],
                                   rtol=1e-5, atol=1e-6)
