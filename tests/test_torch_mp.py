"""Model parallelism (``tpudml_torch.parallel.mp``) against
``tpudml.parallel.mp``, on the CPU.

- the spec trees of ``apply_rules``: ``lenet_stages`` under the stage rule
  at 8 ranks (the demotions of ``tests/test_mp.py:43``) and a small
  ``TransformerLM`` under ``tensor_parallel_rules`` at 4, leaf for leaf
  equal to JAX's;
- ``GSPMDParallel`` at world 2 over gloo (``tests/torch_dist_worker.py``'s
  ``gspmd`` suite) against JAX's on 2 CPU devices, from the same
  parameters and batches: LeNet's stages with SGD (three steps) and the
  small LM under ``tensor_parallel_rules`` with SGD momentum (two steps:
  Adam would turn the attention key bias's gradient, 0 but for rounding,
  into ±lr steps); each
  rank holds only its block, e.g. (400, 60) of ``fc.layer0.kernel`` and
  its momentum (``tests/test_mp.py:66``);
- the 2-D ``{"data": 2, "stage": 2}`` run at world 4
  (``tests/test_mp.py:83``);
- at world 1 the engine is single-device training bitwise, and its
  rejections.

Tolerances (f32): losses rtol 1e-5; parameters ``GRAD_TOL`` (rtol 1e-4,
atol 1e-6: the convs' and matmuls' sums in another order than XLA's); the
two ranks agree bitwise.
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
from tpudml.models import TransformerLM as JaxLM  # noqa: E402
from tpudml.models import lenet_stages as jax_lenet_stages  # noqa: E402
from tpudml.optim import Sgd as JaxSgd  # noqa: E402
from tpudml.parallel import mp as jmp  # noqa: E402
from tpudml_torch.capabilities import CompositionError  # noqa: E402
from tpudml_torch.core import DistributedConfig, process_group  # noqa: E402
from tpudml_torch.data import synthetic_classification, synthetic_lm  # noqa: E402
from tpudml_torch.interop import lm_params_from_tpudml, staged_params_from_tpudml  # noqa: E402
from tpudml_torch.models import TransformerLM, lenet_stages  # noqa: E402
from tpudml_torch.optim import Sgd  # noqa: E402
from tpudml_torch.parallel import (  # noqa: E402
    GSPMDParallel, apply_rules, stage_sharding_rules, tensor_parallel_rules,
)
from tpudml_torch.train import TrainState, make_train_step  # noqa: E402

WORLD, STEPS = 2, 3
LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
LM = dict(vocab_size=32, embed_dim=32, num_heads=4, num_layers=1, max_len=8)


def _np(tree):
    return jax.tree.map(lambda a: np.array(a, copy=True), tree)


def _flat_specs(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_specs(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = tuple(v)
    return out


def _mesh(axes: dict):
    n = int(np.prod(list(axes.values())))
    return make_mesh(MeshConfig(axes), jax.devices()[:n])


def _jax_run(model, opt, axes, batches, **kw):
    mp = jmp.GSPMDParallel(model, opt, _mesh(axes), **kw)
    ts = mp.create_state(seed_key(0))
    step = mp.make_train_step()
    losses = []
    for x, y in batches:
        ts, m = step(ts, x, y)
        losses.append(float(m["loss"]))
    return ts, losses


@pytest.fixture(scope="module")
def batch():
    x, y = synthetic_classification(32, (28, 28, 1), 10, seed=11)
    return np.asarray(x), np.asarray(y)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, batch):
    job = tmp_path_factory.mktemp("gspmd")
    x, y = batch
    stages = jax_lenet_stages()
    params0, _ = stages.init(seed_key(0))  # the parameters JAX's create_state draws
    want = {}
    ts, want["sgd"] = _jax_run(stages, JaxSgd(lr=0.01), {"stage": WORLD}, [(x, y)] * STEPS)
    want["sgd_params"] = staged_params_from_tpudml(_np(ts.params))
    ts, _ = _jax_run(stages, JaxSgd(lr=0.01, momentum=0.9), {"stage": WORLD}, [(x, y)])
    want["momentum_spec"] = ts.opt_state["fc"]["layer0"]["kernel"].sharding.spec
    jm = JaxLM(**LM)
    lm0, _ = jm.init(seed_key(0))
    seqs = synthetic_lm(4, LM["max_len"], LM["vocab_size"], seed=3)
    tokens, labels = seqs[:, :-1], seqs[:, 1:]
    tp = dict(rule=jmp.tensor_parallel_rules("model"), axis_name="model")
    ts, want["tp"] = _jax_run(jm, JaxSgd(lr=0.1, momentum=0.9), {"model": WORLD},
                              [(tokens, labels)] * 2, **tp)
    want["tp_params"] = lm_params_from_tpudml(_np(ts.params))
    _, want["2d"] = _jax_run(stages, JaxSgd(lr=0.01), {"data": 2, "stage": 2},
                                [(x, y)] * 2, batch_axis="data")
    torch.save({"lenet": staged_params_from_tpudml(_np(params0)), "x": x, "y": y,
                "steps": STEPS, "lm": dict(LM), "lm_state": lm_params_from_tpudml(_np(lm0)),
                "tokens": tokens, "labels": labels}, job / "cases.pt")
    ranks = torch_dist_worker.spawn("gspmd", job, WORLD)
    ranks2d = torch_dist_worker.spawn("gspmd2d", job, 4)
    return want, ranks, ranks2d


def _close(got: dict, want: dict):
    assert set(got) == set(want)
    for n, w in want.items():
        np.testing.assert_allclose(got[n].numpy(), w.numpy(), err_msg=n, **GRAD_TOL)


# ------------------------------------------------------------------- rules


def test_lenet_stage_specs_equal_jax_at_8_ranks():
    """The stage rule's output dims, demoted where 8 does not divide them
    (conv 6 channels, the 10 classes), leaf for leaf as JAX's."""
    jparams, _ = jax_lenet_stages().init(seed_key(0))
    want = _flat_specs(jmp.apply_rules(jmp.stage_sharding_rules(), jparams, _mesh({"stage": 8})))
    got = apply_rules(stage_sharding_rules(), lenet_stages(device="cpu"), {"stage": 8})
    assert got == want
    assert got["fc.layer0.kernel"] == (None, "stage")
    assert got["conv.layer0.kernel"] == (None, None, None, None)
    assert got["fc.layer2.kernel"] == (None, None)


def test_transformer_tensor_parallel_specs_equal_jax():
    jparams, _ = JaxLM(**LM).init(seed_key(0))
    want = _flat_specs(jmp.apply_rules(jmp.tensor_parallel_rules("model"), jparams,
                                       _mesh({"model": 4})))
    got = apply_rules(tensor_parallel_rules("model"), TransformerLM(**LM, device="cpu"),
                      {"model": 4})
    assert got == want
    assert got["tok_embed"] == ("model", None)
    assert got["block0.attn.out.kernel"] == ("model", None)


# ------------------------------------------------------------- world 2


def test_gspmd_lenet_matches_jax_at_world_2(runs):
    want, ranks, *_ = runs
    for got in ranks:
        np.testing.assert_allclose(got["sgd"]["losses"], want["sgd"], rtol=LOSS_RTOL)
        _close(got["sgd"]["params"], want["sgd_params"])
    for n, t in ranks[0]["sgd"]["params"].items():
        assert torch.equal(t, ranks[1]["sgd"]["params"][n]), n


def test_each_rank_holds_only_its_block(runs):
    """(400, 60) of fc.layer0.kernel and its momentum on each rank, as JAX's
    shard; a conv kernel's output channels halved (OIHW here)."""
    want, ranks, *_ = runs
    assert tuple(want["momentum_spec"]) == (None, "stage")
    for got in ranks:
        run = got["momentum"]
        assert run["specs"]["fc.layer0.kernel"] == (None, "stage")
        assert run["local"]["fc.layer0.kernel"] == (400, 60)
        assert run["opt_local"]["fc.layer0.kernel"] == (400, 60)
        assert run["local"]["conv.layer0.kernel"] == (3, 1, 5, 5)
        assert run["local"]["fc.layer2.bias"] == (5,)


def test_gspmd_tensor_parallel_lm_matches_jax_at_world_2(runs):
    want, ranks, *_ = runs
    for got in ranks:
        np.testing.assert_allclose(got["tp"]["losses"], want["tp"], rtol=LOSS_RTOL)
        _close(got["tp"]["params"], want["tp_params"])
        assert got["tp"]["local"]["tok_embed"] == (16, 32)
        assert got["tp"]["local"]["block0.attn.out.kernel"] == (16, 32)


def test_gspmd_2d_data_stage_matches_jax(runs):
    want, _, ranks2d, *_ = runs
    for got in ranks2d:
        np.testing.assert_allclose(got["losses"], want["2d"], rtol=LOSS_RTOL)
        assert got["local"]["fc.layer0.kernel"] == (400, 60)


# ------------------------------------------------------------- world 1


def test_world_1_is_single_device_training_bitwise(tmp_path, batch):
    """Gathered weights at world 1 are the weights: every loss and
    parameter bitwise those of ``train.make_train_step``; evaluation
    counts the rows whose argmax is the label."""
    x, y = batch
    cfg = DistributedConfig(coordinator_address=f"file://{tmp_path}/store")
    with process_group(cfg, device="cpu"):
        m1, m2 = lenet_stages(device="cpu"), lenet_stages(device="cpu")
        mp = GSPMDParallel(m1, Sgd(lr=0.05, momentum=0.9))
        ts, step = mp.create_state(), mp.make_train_step()
        ts2 = TrainState.create(m2, Sgd(lr=0.05, momentum=0.9))
        step2 = make_train_step(m2, Sgd(lr=0.05, momentum=0.9))
        for _ in range(3):
            ts, a = step(ts, x, y)
            ts2, b = step2(ts2, x, y)
            assert float(a["loss"]) == float(b["loss"])
        for (n, p), q in zip(m1.named_parameters(), m2.parameters()):
            assert torch.equal(p, q), n
        specs = mp.state_specs()
        assert specs["params"] == specs["opt_state"] == apply_rules(
            stage_sharding_rules(), m2, {"stage": 1})
        assert specs["model_state"] == {} and specs["step"] == ()
        correct, count = mp.make_eval_step()(x, y)
        with torch.no_grad():
            want = int((m2(torch.from_numpy(x)).argmax(-1) == torch.from_numpy(y)).sum())
        assert (int(correct), int(count)) == (want, len(y))


def test_rejections(tmp_path):
    model = TransformerLM(**LM, device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        GSPMDParallel(model, Sgd())
    cfg = DistributedConfig(coordinator_address=f"file://{tmp_path}/store")
    with process_group(cfg, device="cpu"):
        fused = GSPMDParallel(model, Sgd(), fused_xent=True)  # the vocab-sharded head (7c)
        fused.create_state()
        fused.make_train_step()
        assert fused._fused_loss_fn.keep == {"head.kernel": (1,), "head.bias": (0,)}
        with pytest.raises(ValueError, match="fused_xent needs a model with a 'head'"):
            mp = GSPMDParallel(lenet_stages(device="cpu"), Sgd(), fused_xent=True)
            mp.create_state()
            mp.make_train_step()
        with pytest.raises(CompositionError, match="save_scores requires fused_xent"):
            GSPMDParallel(model, Sgd(), save_scores=True)
        with pytest.raises(CompositionError, match="no accum_steps"):
            GSPMDParallel(model, Sgd(), fused_xent=True, accum_steps=2)
        with pytest.raises(ValueError, match="not in mesh axes"):
            GSPMDParallel(model, Sgd(), {"stage": 1}, axis_name="model")
        with pytest.raises(ValueError, match="batch_axis"):
            GSPMDParallel(model, Sgd(), {"stage": 1}, batch_axis="data")
        mp = GSPMDParallel(model, Sgd(), {"stage": 1})
        with pytest.raises(RuntimeError, match="create_state"):
            mp.make_train_step()


def test_world_1_sentinel_obs_and_accumulation(tmp_path, batch):
    """``sentinel``, ``obs`` and ``accum_steps`` on the engine: a NaN step is
    skipped (parameters bitwise those before it, the poisoned micro-batch
    named), every step has its span and StepStats (the norm of the
    gathered gradient), and the clean steps are single-device training's
    with ``accum_steps=2``, bitwise."""
    from tpudml_torch.resilience import param_leaf_names, sentinel_stats

    x, y = batch
    xbad = x.copy()
    xbad[20, 3, 3, 0] = np.nan  # micro-batch 1 of 2
    cfg = DistributedConfig(coordinator_address=f"file://{tmp_path}/store")
    with process_group(cfg, device="cpu"):
        m1, m2 = lenet_stages(device="cpu"), lenet_stages(device="cpu")
        mp = GSPMDParallel(m1, Sgd(lr=0.05, momentum=0.9), sentinel=True, obs=True,
                           accum_steps=2)
        ts, step = mp.create_state(), mp.make_train_step()
        ts2 = TrainState.create(m2, Sgd(lr=0.05, momentum=0.9))
        step2 = make_train_step(m2, Sgd(lr=0.05, momentum=0.9), accum_steps=2)
        ts, a = step(ts, x, y)
        ts2, b = step2(ts2, x, y)
        assert float(a["loss"]) == float(b["loss"]) and int(a["bad_micro"]) == -1
        assert a["step_stats"].grad_norm > 0
        before = {n: p.detach().clone() for n, p in m1.named_parameters()}
        ts, a = step(ts, xbad, y)
        assert int(a["bad_micro"]) == 1
        st = sentinel_stats(ts.opt_state)
        assert st["skips"] == 1 and 0 <= st["bad_leaf"] < len(param_leaf_names(m1))
        assert all(torch.equal(p, before[n]) for n, p in m1.named_parameters())
        ts, a = step(ts, x, y)
        ts2, b = step2(ts2, x, y)
        assert float(a["loss"]) == float(b["loss"])
        for p, q in zip(m1.parameters(), m2.parameters()):
            assert torch.equal(p, q)
        assert [e.name for e in mp.tracer.events].count("train_step") == 3
