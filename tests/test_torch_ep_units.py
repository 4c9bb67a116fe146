"""The pieces of the port's expert parallelism that run in one process,
on the CPU: ``Sequential``, ``Flatten`` and ``Activation`` against
``tpudml.nn``; ``ClipByGlobalNorm`` unsharded against ``tpudml.optim``'s
(scale, update, a clip under a clip) and ``shard_aware_clip``'s rewrap
through a ``.base`` chain; the differentiable ``all_to_all`` at world 1;
``ExpertParallel`` at world 1 (a one-rank gloo group) equal to the
single-card step bit for bit, its counting eval, interop and refusals;
and task5 ``--parallel ep``'s argument errors. The multi-rank parity runs
are ``tests/test_torch_ep.py``.

Tolerances (f32): forward rtol 1e-5 / atol 1e-6; gradients and updates
``GRAD_TOL`` (rtol 1e-4, atol 1e-6); a clip scale rtol 1e-6 (one f32
square root of sums in another order).
"""

import dataclasses
import re
from dataclasses import dataclass

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from tpudml.capabilities import TABLE as JAX_TABLE  # noqa: E402
from tpudml.core.prng import seed_key  # noqa: E402
from tpudml.models import TransformerLM as JaxLM  # noqa: E402
from tpudml.nn import Activation as JaxActivation  # noqa: E402
from tpudml.nn import Dense as JaxDense  # noqa: E402
from tpudml.nn import Flatten as JaxFlatten  # noqa: E402
from tpudml.nn import MoELayer as JaxMoE  # noqa: E402
from tpudml.nn import Sequential as JaxSequential  # noqa: E402
from tpudml.optim import ClipByGlobalNorm as JaxClip  # noqa: E402
from tpudml.optim import GradientDescent as JaxGD  # noqa: E402
from tpudml.parallel.ep import expert_specs as jax_expert_specs  # noqa: E402
from tpudml.train import make_loss_fn as jax_make_loss_fn  # noqa: E402
from tpudml_torch.capabilities import CompositionError  # noqa: E402
from tpudml_torch.comm import all_to_all  # noqa: E402
from tpudml_torch.core import DistributedConfig, process_group  # noqa: E402
from tpudml_torch.data import synthetic_classification, synthetic_lm  # noqa: E402
from tpudml_torch.interop import (  # noqa: E402
    ep_state_from_tpudml, lm_params_from_tpudml, sequential_params_from_tpudml,
)
from tpudml_torch.models import TransformerLM  # noqa: E402
from tpudml_torch.nn import Activation, Dense, Flatten, Sequential  # noqa: E402
from tpudml_torch.nn.moe import MoELayer  # noqa: E402
from tpudml_torch.optim import (  # noqa: E402
    Adam, ClipByGlobalNorm, GradientDescent, Optimizer, Sgd, shard_aware_clip,
)
from tpudml_torch.parallel import ExpertParallel, expert_specs, is_expert_param  # noqa: E402
from tpudml_torch.tasks import task5_longcontext as task5  # noqa: E402
from tpudml_torch.train import (  # noqa: E402
    TrainState, collect_aux_losses, make_loss_fn, make_train_step, model_has_moe,
)

D, E = 16, 4
OUT_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
LM = dict(vocab_size=32, embed_dim=16, num_heads=2, num_layers=2, max_len=8, rope=True,
          moe_experts=E)
TINY = ["--vocab", "32", "--embed_dim", "32", "--num_heads", "4", "--num_layers", "2",
        "--seq_len", "16", "--batch_size", "4", "--lr", "0.01", "--device", "cpu"]


@pytest.fixture
def one_rank(tmp_path):
    with process_group(DistributedConfig(coordinator_address=f"file://{tmp_path}/store"),
                       device="cpu") as group:
        yield group


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


# ------------------------------------------------------ Sequential & co


def _jax_classifier(moe: bool, act=jax.nn.relu):
    mid = JaxMoE(D, E, mlp_ratio=2, capacity_factor=2.0) if moe else JaxDense(D, D)
    return JaxSequential((JaxFlatten(), JaxDense(28 * 28, D), JaxActivation(act), mid,
                          JaxDense(D, 10)))


def _classifier(moe: bool, act=torch.relu):
    mid = MoELayer(D, E, mlp_ratio=2, capacity_factor=2.0) if moe else Dense(D, D)
    return Sequential((Flatten(), Dense(28 * 28, D), Activation(act), mid, Dense(D, 10)))


@pytest.mark.parametrize("moe,act", [(False, "relu"), (False, "tanh"), (True, "relu")])
def test_sequential_matches_jax(moe, act):
    """The chain's names are JAX's layer{i} keys; the forward, the aux term
    it threads (MoE: JAX's state aux_loss, read by collect_aux_losses) and
    the gradients of the training loss (α = 1e-2) agree."""
    jm = _jax_classifier(moe, getattr(jax.nn, act))
    params, state = jm.init(seed_key(0))
    tm = _classifier(moe, getattr(torch, act))
    tm.load_state_dict(sequential_params_from_tpudml(params))
    assert set(dict(tm.named_parameters())) == set(_flat(params))
    images, labels = synthetic_classification(12, (28, 28, 1), 10, seed=1)
    logits, new_state = jax.jit(lambda p, x: jm.apply(p, state, x, train=True))(
        params, jnp.asarray(images))
    got = tm(torch.from_numpy(images))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(logits), **OUT_TOL)
    if moe:
        np.testing.assert_allclose(collect_aux_losses(tm).item(),
                                   float(new_state["layer3"]["aux_loss"]), **OUT_TOL)
    else:
        assert tm.aux_loss is None and collect_aux_losses(tm).item() == 0.0
    assert model_has_moe(tm) == moe

    jloss = jax_make_loss_fn(jm, aux_loss_weight=1e-2)
    want = jax.jit(jax.grad(lambda p: jloss(p, state, jnp.asarray(images),
                                            jnp.asarray(labels))[0]))(params)
    loss, _ = make_loss_fn(tm, 1e-2)(torch.from_numpy(images),
                                     torch.from_numpy(labels).long())
    loss.backward()
    flat = _flat(want)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), flat[name], err_msg=name, **GRAD_TOL)


def test_flatten_and_activation_alone():
    x = np.random.default_rng(0).normal(size=(3, 4, 5, 2)).astype(np.float32)
    want = JaxFlatten().apply({}, {}, jnp.asarray(x))[0]
    np.testing.assert_array_equal(Flatten()(torch.from_numpy(x)).numpy(), np.asarray(want))
    want = JaxActivation().apply({}, {}, jnp.asarray(x))[0]
    np.testing.assert_array_equal(Activation()(torch.from_numpy(x)).numpy(), np.asarray(want))
    assert list(Sequential((Flatten(), Activation())).parameters()) == []


# ----------------------------------------------------------------- clip


def _grads(seed, scale):
    rng = np.random.default_rng(seed)
    return {"a": (rng.normal(size=(3, 4)) * scale).astype(np.float32),
            "b": (rng.normal(size=(5,)) * scale).astype(np.float32)}


def _updates(opt, jax_opt, grads):
    """The port's and JAX's new params from zeros after one update."""
    params = {k: torch.zeros(v.shape) for k, v in grads.items()}
    opt.update({k: torch.from_numpy(v) for k, v in grads.items()}, opt.init(params), params)
    jparams = {k: jnp.zeros(v.shape) for k, v in grads.items()}
    jnew, _ = jax_opt.update({k: jnp.asarray(v) for k, v in grads.items()},
                             jax_opt.init(jparams), jparams)
    return params, jnew


@pytest.mark.parametrize("max_norm,scale", [(1.0, 0.01), (1.0, 3.0), (0.5, 1.0)],
                         ids=["below", "above", "near"])
def test_clip_matches_jax(max_norm, scale):
    """One update of GD(lr=1) under the clip, from zero params: −scale·g, as
    JAX's; the scale itself against JAX's formula in f32."""
    grads = _grads(0, scale)
    opt = ClipByGlobalNorm(GradientDescent(lr=1.0), max_norm=max_norm)
    got, want = _updates(opt, JaxClip(JaxGD(lr=1.0), max_norm=max_norm), grads)
    for k in grads:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=0)
    norm = np.sqrt(sum(np.sum(np.square(g)) for g in grads.values()))
    want_scale = min(1.0, max_norm / max(norm, 1e-12))
    got_scale = opt.scale({k: torch.from_numpy(v) for k, v in grads.items()})
    np.testing.assert_allclose(got_scale.item(), want_scale, rtol=1e-6)
    assert got_scale.dtype == torch.float32


def test_clip_under_a_clip_matches_jax():
    grads = _grads(1, 2.0)
    opt = ClipByGlobalNorm(ClipByGlobalNorm(Sgd(lr=0.5), max_norm=0.3), max_norm=2.0)
    jopt = JaxClip(JaxClip(JaxGD(lr=0.5), max_norm=0.3), max_norm=2.0)
    got, want = _updates(opt, jopt, grads)
    for k in grads:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=0)


def test_clip_rescales_only_above_threshold():
    """tests/test_adamw_clip.py's case: norm 5 → 1."""
    params = {"a": torch.zeros(3), "b": torch.zeros(2)}
    opt = ClipByGlobalNorm(Sgd(lr=1.0), max_norm=1.0)
    big = {"a": torch.tensor([3.0, 0.0, 0.0]), "b": torch.tensor([0.0, 4.0])}
    opt.update(big, opt.init(params), params)
    flat = -torch.cat([params["a"], params["b"]])
    np.testing.assert_allclose(flat.numpy(), [0.6, 0, 0, 0, 0.8], rtol=1e-6)
    with pytest.raises(ValueError, match="base optimizer"):
        ClipByGlobalNorm(max_norm=1.0)


@dataclass(frozen=True)
class _Wrapper(Optimizer):
    """A wrapper with a ``.base``, as a schedule or a sentinel would be."""

    base: Optimizer = None

    def init(self, params):
        return self.base.init(params)

    def update(self, grads, state, params):
        return self.base.update(grads, state, params)


def test_shard_aware_clip_rewraps_down_the_base_chain(one_rank):
    """tests/test_adamw_clip.py's recursion: a clip that has axes keeps
    them, one below it (or below a wrapper) gets the engine's; the rest
    passes through unchanged."""
    is_shard = lambda name: name.startswith("s")  # noqa: E731
    nested = ClipByGlobalNorm(max_norm=5.0, axes=("stage",),
                              base=ClipByGlobalNorm(max_norm=1.0, base=Sgd(lr=0.1)))
    out = shard_aware_clip(nested, (one_rank,), is_shard)
    assert out.axes == ("stage",)
    assert out.base.axes == (one_rank,) and out.base.sharded is is_shard
    assert shard_aware_clip(out, ("data",), None).base.axes == (one_rank,)
    wrapped = shard_aware_clip(_Wrapper(ClipByGlobalNorm(Sgd(lr=0.1))), (one_rank,), None)
    assert wrapped.base.axes == (one_rank,)
    assert shard_aware_clip(Sgd(lr=0.1), (one_rank,), None) == Sgd(lr=0.1)


def test_sharded_clip_at_world_one_equals_the_plain_clip(one_rank):
    """tests/test_adamw_clip.py's sharded case at one rank: the sharded
    leaves' squares summed over the group, the replicated ones once."""
    grads = _grads(2, 3.0)
    plain = ClipByGlobalNorm(Sgd(lr=1.0), max_norm=0.5)
    sharded = dataclasses.replace(plain, axes=(one_rank,), sharded=lambda n: n == "a")
    t = {k: torch.from_numpy(v) for k, v in grads.items()}
    assert torch.equal(sharded.scale(t), plain.scale(t))


# ---------------------------------------------------------- all_to_all


@pytest.mark.parametrize("split,concat", [(0, 1), (1, 0)])
def test_all_to_all_at_world_one(one_rank, split, concat):
    """At one rank the tiled all_to_all returns its input ([E, C, d] ->
    [E/1, 1·C, d]); its backward (gradcheck in f64) is the inverse one."""
    x = torch.randn(4, 3, 2, dtype=torch.float64, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    y = all_to_all(x, one_rank, split_axis=split, concat_axis=concat)
    assert torch.equal(y, x)
    assert torch.autograd.gradcheck(
        lambda t: all_to_all(t, one_rank, split_axis=split, concat_axis=concat), (x,))


# ------------------------------------------------------ EP at world 1


def _lm(seed=3, **kw):
    return TransformerLM(**LM, **kw, device="cpu", generator=torch.Generator().manual_seed(seed))


def test_ep_at_world_one_equals_the_single_card_step(one_rank):
    """A one-rank group: three Adam steps of the MoE LM (flash attention,
    fused add+LN) through ExpertParallel equal the single-card step bit
    for bit (÷ 1 and the mean over one rank are exact); the counting eval
    agrees with the single model's argmax count."""
    seqs = synthetic_lm(16, 8, 32, seed=0)
    batches = [seqs[i:i + 4] for i in range(0, 12, 4)]
    single = _lm(impl="flash", fused_ln=True)
    opt = Adam(lr=0.01)
    step = make_train_step(single, opt)
    ts = TrainState.create(single, opt)
    want = [step(ts, b[:, :-1], b[:, 1:])[1]["loss"].item() for b in batches]

    model = _lm(impl="flash", fused_ln=True, moe_axis="expert")
    ep = ExpertParallel(model, Adam(lr=0.01))
    ts = ep.create_state()
    step = ep.make_train_step()
    got = []
    for b in batches:
        ts, m = step(ts, b[:, :-1], b[:, 1:])
        got.append(m["loss"].item())
        assert set(m) == {"loss", "accuracy"}
    assert got == want and ts.step == 3
    for (name, p), q in zip(model.named_parameters(), single.parameters()):
        assert torch.equal(p, q), name
    x, y = torch.from_numpy(seqs[:4, :-1]).long(), torch.from_numpy(seqs[:4, 1:]).long()
    with torch.no_grad():
        correct = int((single(x).argmax(-1) == y).sum())
    assert ep.evaluate(ts, [(x, y)]) == correct / y.numel()


def test_expert_specs_follow_jax():
    jm = JaxLM(**LM, moe_axis="expert")
    params, _ = jax.eval_shape(jm.init, seed_key(1))
    flat = _flat_specs(jax_expert_specs(params, "expert"))
    got = expert_specs(dict(_lm(moe_axis="expert").named_parameters()))
    assert set(got) == set(flat)
    for name, spec in got.items():
        assert (spec == "expert") == (flat[name] == jax.sharding.PartitionSpec("expert")), name
    assert sum(spec == "expert" for spec in got.values()) == 4 * LM["num_layers"]


def _flat_specs(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_specs(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def test_ep_state_from_tpudml_slices_the_experts():
    """Replicated leaves copied, expert leaves (params and Adam moments) cut
    to the rank's rows; Sgd's () passes through."""
    jm = JaxLM(**LM)
    params, _ = jm.init(seed_key(2))
    full = lm_params_from_tpudml(params)
    m = jax.tree.map(lambda a: np.asarray(a) + 1.0, params)
    v = jax.tree.map(lambda a: np.asarray(a) + 2.0, params)
    for index in (0, 1):
        state, opt = ep_state_from_tpudml(params, {"m": m, "v": v, "t": 5}, index, 2)
        assert set(state) == set(full) and opt["t"] == 5
        for name, t in state.items():
            want = full[name]
            if is_expert_param(name):
                want = want[2 * index:2 * index + 2]
            assert torch.equal(t, want), name
            assert torch.equal(opt["m"][name], want + 1.0), name
            assert torch.equal(opt["v"][name], want + 2.0), name
    _, opt = ep_state_from_tpudml(params, (), 1, 2)
    assert opt == ()
    with pytest.raises(ValueError, match="do not divide"):
        ep_state_from_tpudml(params, (), 0, 3)


def test_engine_keeps_the_rank_slice_of_the_same_draw():
    """A model with moe_axis draws the same parameters as without it (JAX's
    test_moe_transformer_dense_matches_sharded_init)."""
    for (name, p), q in zip(_lm(moe_axis="expert").named_parameters(), _lm().parameters()):
        assert torch.equal(p, q), name


def test_ep_refusals(one_rank, tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="single-shard"):
        MoELayer(D, E, dispatch="ragged", axis_name="expert")
    with pytest.raises(ValueError, match="single-shard"):
        _lm(moe_axis="expert", moe_dispatch="ragged")
    with pytest.raises(RuntimeError, match="bind its process group"):
        MoELayer(D, E, axis_name="expert")(torch.zeros(4, D))
    with pytest.raises(ValueError, match="build the model's MoE layers with axis_name"):
        ExpertParallel(_lm(), Sgd())
    with pytest.raises(ValueError, match="batch_axis 'data' must be a mesh axis distinct"):
        ExpertParallel(_lm(moe_axis="expert"), Sgd(), batch_axis="data")
    with pytest.raises(ValueError, match="does not lay out"):
        ExpertParallel(_lm(moe_axis="expert"), Sgd(), {"expert": 2})
    model = _lm(moe_axis="expert")
    ep = ExpertParallel(model, Sgd())
    with monkeypatch.context() as m:  # a CPU model on an NCCL group
        m.setattr(torch.distributed, "get_backend", lambda *a: "nccl")
        with pytest.raises(RuntimeError, match="cpu shard needs a gloo group; this one is nccl"):
            ExpertParallel(_lm(moe_axis="expert"), Sgd())
    model.block0.moe.num_experts = 2 * E  # as if its experts were a slice already
    with pytest.raises(ValueError, match="already sharded"):
        ep._keep_local_experts(model.block0.moe)


def test_ep_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        ExpertParallel(_lm(moe_axis="expert"), Sgd())


# ------------------------------------------------------ task5 --parallel ep


def test_task5_ep_at_world_one_equals_single(tmp_path, capsys):
    common = TINY + ["--steps", "3", "--log_every", "3", "--attn", "flash", "--fused_ln",
                     "--rope", "--moe_experts", "4", "--log_dir", str(tmp_path)]
    single = task5.main(common)
    ep = task5.main(common + ["--parallel", "ep", "--n_devices", "1"])
    assert "[ep/flash/cpu] 1 device(s)" in capsys.readouterr().out
    assert ep["devices"] == 1 and ep["final_loss"] == single["final_loss"]


@pytest.mark.parametrize("flags,exc,match", [
    (["--parallel", "ep"], ValueError, "--parallel ep needs --moe_experts N"),
    (["--parallel", "ep", "--moe_experts", "4", "--dropout", "0.1"], CompositionError,
     re.escape(JAX_TABLE["ep_dropout"].message)),
    (["--parallel", "ep", "--moe_experts", "4", "--moe_dispatch", "ragged"], ValueError,
     "single-shard"),
    (["--parallel", "ep", "--moe_experts", "4", "--fused_xent"], ValueError,
     "materialized logits"),
])
def test_task5_ep_argument_errors(tmp_path, flags, exc, match):
    with pytest.raises(exc, match=match):
        task5.main(TINY + flags + ["--steps", "1", "--log_dir", str(tmp_path)])


def test_task5_ep_experts_must_divide_the_world(monkeypatch):
    monkeypatch.setattr(task5, "process_count", lambda *a: 2)
    args = task5.parse_args(TINY + ["--parallel", "ep", "--moe_experts", "3"])
    with pytest.raises(ValueError, match="--moe_experts 3 must divide over 2 devices"):
        task5.build_engine(args, torch.device("cpu"))
