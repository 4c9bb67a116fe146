"""FSDP / ZeRO-3 (``tpudml_torch.parallel.fsdp``) against
``tpudml.parallel.fsdp``, on the CPU (``tests/test_fsdp.py``'s cases).

- ``fsdp_sharding_rules``: the largest divisible free dimension, ties
  toward the leading one, a base rule's dimensions left alone; the spec
  trees of ForwardMLP at 8 ranks (the odd head bias demoted) and of a
  small ``TransformerLM`` at 4, alone and over ``tensor_parallel_rules``
  on {data 2, model 2} and {data 2, model 4}, leaf for leaf equal to JAX's;
- ``FSDP`` at world 2 and 4 over gloo (``tests/torch_dist_worker.py``'s
  ``fsdp`` suite) against JAX's FSDP, DP and single-device training on
  ForwardMLP with SGD momentum (four steps, the same parameters and
  global batch); each rank holds 1/W of ``layer1.kernel`` and of its Adam
  moments;
- FSDP×TP {data 2, model 2} at world 4 against JAX's on the small LM,
  without and with a global-norm clip (each leaf's squares counted once);
- the block-then-mean gradient rule (each rank's block of its own
  gradient, then the data mean: the rule before the reduce-scatter) is
  wrong for FSDP and the reduce-scatter rule is right;
  the reduce-scatter equals its plain version, an all-reduce then a
  narrow;
- at world 1 FSDP is single-device training bitwise.

Tolerances (f32): losses rtol 1e-5; parameters ``GRAD_TOL`` (rtol 1e-4,
atol 1e-6); the reduce-scatter 1e-6 of its plain version (the same sums).
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
from tpudml.models import ForwardMLP as JaxMLP  # noqa: E402
from tpudml.models import TransformerLM as JaxLM  # noqa: E402
from tpudml.optim import ClipByGlobalNorm as JaxClip  # noqa: E402
from tpudml.optim import make_optimizer as jax_make_optimizer  # noqa: E402
from tpudml.parallel import mp as jmp  # noqa: E402
from tpudml.parallel.dp import DataParallel as JaxDP  # noqa: E402
from tpudml.parallel.fsdp import FSDP as JaxFSDP  # noqa: E402
from tpudml.parallel.fsdp import fsdp_sharding_rules as jax_fsdp_rules  # noqa: E402
from tpudml.train import TrainState as JaxTrainState  # noqa: E402
from tpudml.train import make_train_step as jax_make_train_step  # noqa: E402
from tpudml_torch.core import DistributedConfig, process_group  # noqa: E402
from tpudml_torch.data import synthetic_classification, synthetic_lm  # noqa: E402
from tpudml_torch.interop import lm_params_from_tpudml, sequential_params_from_tpudml  # noqa: E402
from tpudml_torch.models import ForwardMLP, TransformerLM  # noqa: E402
from tpudml_torch.optim import Sgd  # noqa: E402
from tpudml_torch.parallel import (  # noqa: E402
    FSDP, apply_rules, fsdp_sharding_rules, tensor_parallel_rules,
)
from tpudml_torch.parallel.mp import Leaf  # noqa: E402
from tpudml_torch.train import TrainState, make_train_step  # noqa: E402

STEPS = 4
LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
LM = dict(vocab_size=32, embed_dim=32, num_heads=4, num_layers=1, max_len=16)


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


def _jax_run(engine, batches):
    ts = engine.create_state(seed_key(1))
    step = engine.make_train_step()
    losses = []
    for x, y in batches:
        ts, m = step(ts, x, y)
        losses.append(float(m["loss"]))
    return losses, _np(ts.params)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    job = tmp_path_factory.mktemp("fsdp")
    x, y = synthetic_classification(32, (28, 28, 1), 10, seed=11)
    x, y = np.asarray(x), np.asarray(y)
    batches = [(x, y)] * STEPS
    mlp = JaxMLP()
    params0, _ = mlp.init(seed_key(1))  # what every engine's create_state(seed_key(1)) draws
    want = {}
    sgd = lambda: jax_make_optimizer("sgd", 0.05, momentum=0.9)  # noqa: E731
    for w in (2, 4):
        want[f"fsdp{w}"] = _jax_run(JaxFSDP(mlp, sgd(), _mesh({"data": w})), batches)
        want[f"dp{w}"] = _jax_run(JaxDP(mlp, sgd(), _mesh({"data": w})), batches)
    ts = JaxTrainState.create(mlp, sgd(), seed_key(1))
    step = jax_make_train_step(mlp, sgd())
    losses = []
    for bx, by in batches:
        ts, m = step(ts, bx, by)
        losses.append(float(m["loss"]))
    want["single"] = (losses, _np(ts.params))
    lm = JaxLM(**LM)
    lm0, _ = lm.init(seed_key(1))
    seqs = synthetic_lm(8, 16, 32, seed=3)
    tokens, labels = seqs[:, :-1], seqs[:, 1:]
    for key, opt in (("fsdp_tp", jax_make_optimizer("sgd", 0.1, momentum=0.9)),
                     ("fsdp_tp_clip", JaxClip(jax_make_optimizer("sgd", 0.1, momentum=0.9),
                                              max_norm=0.05))):
        want[key] = _jax_run(JaxFSDP(lm, opt, _mesh({"data": 2, "model": 2}),
                                     base_rule=jmp.tensor_parallel_rules("model")),
                             [(tokens, labels)] * 3)
    torch.save({"mlp": sequential_params_from_tpudml(_np(params0)), "x": x, "y": y,
                "steps": STEPS, "lm": dict(LM), "lm_state": lm_params_from_tpudml(_np(lm0)),
                "tokens": tokens, "labels": labels}, job / "cases.pt")
    ranks = {}
    for w in (2, 4):  # a job directory (store, rank files) for each world
        (job / f"w{w}").mkdir()
        (job / f"w{w}" / "cases.pt").write_bytes((job / "cases.pt").read_bytes())
        ranks[w] = torch_dist_worker.spawn("fsdp", job / f"w{w}", w)
    return want, ranks


def _close(got: dict, want: dict):
    assert set(got) == set(want)
    for n, w in want.items():
        np.testing.assert_allclose(got[n].numpy(), w.numpy(), err_msg=n, **GRAD_TOL)


# ------------------------------------------------------------------- rules


def test_rule_shards_largest_divisible_dim():
    rule = fsdp_sharding_rules("data", axis_size=8)
    jrule = jax_fsdp_rules("data", axis_size=8)
    leaves = {("fc1", "kernel"): (784, 512), ("fc1", "bias"): (512,), ("head", "bias"): (10,),
              ("w",): (8, 16, 8), ("sq",): (64, 64), ("odd",): (10, 6)}
    for path, shape in leaves.items():
        want = tuple(jrule(path, jax.ShapeDtypeStruct(shape, jnp.float32)))
        assert rule(path, Leaf(shape)) == want, path
    assert rule(("fc1", "kernel"), Leaf((784, 512))) == ("data",)
    assert rule(("head", "bias"), Leaf((10,))) == ()
    assert rule(("w",), Leaf((8, 16, 8))) == (None, "data")
    base = tensor_parallel_rules("model")
    rule2 = fsdp_sharding_rules("data", base=base, axis_size=8)
    spec = rule2(("block0", "attn", "q", "kernel"), Leaf((256, 256)))
    assert spec == ("data", "model")
    assert spec == tuple(jax_fsdp_rules("data", base=jmp.tensor_parallel_rules("model"),
                                        axis_size=8)(("block0", "attn", "q", "kernel"),
                                                     jax.ShapeDtypeStruct((256, 256),
                                                                          jnp.float32)))


@pytest.mark.parametrize("model,mesh,tp", [
    ("mlp", {"data": 8}, False), ("lm", {"data": 4}, False),
    ("lm", {"data": 2, "model": 2}, True), ("lm", {"data": 2, "model": 4}, True)],
    ids=["mlp_data8", "lm_data4", "lm_data2_model2", "lm_data2_model4"])
def test_spec_trees_equal_jax(model, mesh, tp):
    jmodel = JaxMLP() if model == "mlp" else JaxLM(**LM)
    port = ForwardMLP(device="cpu") if model == "mlp" else TransformerLM(**LM, device="cpu")
    jparams, _ = jmodel.init(seed_key(0))
    base, jbase = ((tensor_parallel_rules("model"), jmp.tensor_parallel_rules("model"))
                   if tp else (None, None))
    want = _flat_specs(jmp.apply_rules(jax_fsdp_rules("data", jbase, mesh["data"]), jparams,
                                       _mesh(mesh)))
    got = apply_rules(fsdp_sharding_rules("data", base, mesh["data"]), port, mesh)
    assert got == want
    if model == "mlp":
        assert got["layer1.kernel"] == ("data",) and got["layer11.bias"] == ()
    if tp:
        assert got["block0.attn.q.kernel"] == ("data", "model")
        assert got["head.kernel"] == ("data", "model")


# ------------------------------------------------------------- world 2, 4


@pytest.mark.parametrize("world", [2, 4])
def test_fsdp_matches_jax_fsdp_dp_and_single_device(runs, world):
    want, ranks = runs
    for got in ranks[world]:
        for ref in (f"fsdp{world}", f"dp{world}", "single"):
            np.testing.assert_allclose(got["sgd"]["losses"], want[ref][0], rtol=LOSS_RTOL,
                                       err_msg=ref)
            _close(got["sgd"]["params"], sequential_params_from_tpudml(want[ref][1]))
    for n, t in ranks[world][0]["sgd"]["params"].items():
        assert all(torch.equal(t, r["sgd"]["params"][n]) for r in ranks[world][1:]), n


@pytest.mark.parametrize("world", [2, 4])
def test_each_rank_holds_its_block_of_params_and_adam_moments(runs, world):
    """(784 / W, 512) of ``layer1.kernel`` and of both Adam moments on every
    rank; the head bias (10) whole at 4, as JAX's spec demotes it."""
    _, ranks = runs
    for got in ranks[world]:
        run = got["adam"]
        assert run["specs"]["layer1.kernel"] == ("data",)
        assert run["local"]["layer1.kernel"] == (784 // world, 512)
        assert run["opt_local"]["m.layer1.kernel"] == (784 // world, 512)
        assert run["opt_local"]["v.layer1.kernel"] == (784 // world, 512)
        assert run["local"]["layer11.bias"] == ((10,) if 10 % world else (10 // world,))
        local = sum(np.prod(s) for s in run["local"].values())
        total = sum(t.numel() for t in run["params"].values())
        assert local < total / (world / 2)  # well under 2/W of the model


def test_fsdp_tp_matches_jax_at_world_4(runs):
    want, ranks = runs
    for got in ranks[4]:
        run = got["fsdp_tp"]
        np.testing.assert_allclose(run["losses"], want["fsdp_tp"][0], rtol=LOSS_RTOL)
        _close(run["params"], lm_params_from_tpudml(want["fsdp_tp"][1]))
        assert run["specs"]["block0.attn.q.kernel"] == ("data", "model")
        assert run["local"]["block0.attn.q.kernel"] == (16, 16)


def test_fsdp_tp_clip_counts_each_block_once(runs):
    """A global-norm clip (max 0.05, below every step's norm) under FSDP×TP
    at world 4: each leaf's squares weighed by ``norm_share`` (a block
    split over one axis is held alike by the other axis's ranks), so the
    clip scale is JAX's and the run equals JAX's FSDP×TP with the clip."""
    want, ranks = runs
    assert want["fsdp_tp_clip"][0] != want["fsdp_tp"][0]  # the clip engaged
    for got in ranks[4]:
        run = got["fsdp_tp_clip"]
        np.testing.assert_allclose(run["losses"], want["fsdp_tp_clip"][0], rtol=LOSS_RTOL)
        _close(run["params"], lm_params_from_tpudml(want["fsdp_tp_clip"][1]))


@pytest.mark.parametrize("world", [2, 4])
def test_block_then_mean_gradient_rule_is_wrong_for_fsdp(runs, world):
    """The block-then-mean rule (each rank keeps its block of the gradient
    of ITS rows, then the data group averages) mixes rank 0's block with
    rank 1's rows: the parameters leave single-device training's after the
    first step.
    The reduce-scatter rule keeps them; it equals an all-reduce then a
    narrow."""
    want, ranks = runs
    single = sequential_params_from_tpudml(want["single"][1])
    for got in ranks[world]:
        assert got["rs_err"] <= 1e-6
        old = got["old_rule"]["params"]
        worst = max(float((old[n] - single[n]).abs().max()) for n in single)
        assert worst > 1e-3
        _close(got["sgd"]["params"], single)


# ------------------------------------------------------------- world 1


def test_world_1_is_single_device_training_bitwise(tmp_path):
    x, y = synthetic_classification(32, (28, 28, 1), 10, seed=11)
    cfg = DistributedConfig(coordinator_address=f"file://{tmp_path}/store")
    with process_group(cfg, device="cpu"):
        m1, m2 = ForwardMLP(device="cpu"), ForwardMLP(device="cpu")
        eng = FSDP(m1, Sgd(lr=0.05, momentum=0.9))
        ts, step = eng.create_state(), eng.make_train_step()
        assert eng.batch_axis == "data" and eng.param_specs["layer1.kernel"] == ("data",)
        ts2 = TrainState.create(m2, Sgd(lr=0.05, momentum=0.9))
        step2 = make_train_step(m2, Sgd(lr=0.05, momentum=0.9))
        for _ in range(3):
            ts, a = step(ts, x, y)
            ts2, b = step2(ts2, x, y)
            assert float(a["loss"]) == float(b["loss"])
        for (n, p), q in zip(m1.named_parameters(), m2.parameters()):
            assert torch.equal(p, q), n
        with pytest.raises(ValueError, match="FSDP axis 'data' not in mesh axes"):
            FSDP(ForwardMLP(device="cpu"), Sgd(), {"model": 1})
