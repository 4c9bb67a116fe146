"""The port's ``ExpertParallel`` against ``tpudml``'s, on the CPU.

Ranks of the jax-free ``tests/torch_dist_worker.py`` (suite ``ep``) run
the port over gloo: two for EP, spawned once for the module, and four for
EP×DP on a {data: 2, expert: 2} layout, spawned once. JAX's engine runs in
this process on a CPU mesh of the same shape (``tests/conftest.py``
provisions 8 devices). Both start from JAX's parameters (and, for Adam,
its state after one step), carried with ``ep_state_from_tpudml``: each
rank keeps its slice of the experts. Both see the same global batches.

The cases follow ``tests/test_moe.py`` (D=16, E=8, 64 tokens, the
``Sequential(Flatten, Dense, Activation, MoELayer, Dense)`` classifier at
capacity 8, so that nothing drops) and ``tests/test_fused_compose.py``'s
MoE LM under EP (with RoPE, see ``LM``). Tolerances (f32) are the repo's: losses rtol 1e-5,
accuracies atol 1e-6, parameters after the steps and gradients at
``GRAD_TOL`` (rtol 1e-4, atol 1e-6), layer outputs at rtol 1e-5 / atol
1e-6. JAX's own EP tests hold EP against DENSE training at 2e-3 / 2e-5;
the port is held against JAX's EP run, whose routing, capacity and
reduction structure it shares, so it needs no more than the repo's
tolerances. The classifier runs with ``aux_loss_weight=0.0`` as JAX's
tests do; the clip case and the LM keep the default 1e-2.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import dataclasses  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402

import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import torch_dist_worker  # noqa: E402
from tpudml.core.config import MeshConfig  # noqa: E402
from tpudml.core.dist import make_mesh  # noqa: E402
from tpudml.core.prng import seed_key  # noqa: E402
from tpudml.data.datasets import synthetic_classification  # noqa: E402
from tpudml.models import TransformerLM as JaxLM  # noqa: E402
from tpudml.nn import Activation, Dense, Flatten, MoELayer, Sequential  # noqa: E402
from tpudml.optim import ClipByGlobalNorm, Optimizer, Sgd, make_optimizer  # noqa: E402
from tpudml.parallel.ep import ExpertParallel, expert_specs  # noqa: E402
from tpudml.parallel.sharding import shard_map_fn  # noqa: E402
from tpudml_torch.nn.moe import is_expert_param  # noqa: E402

D, E, W, G = 16, 8, 2, 64
LOSS_RTOL = 1e-5
ACC_ATOL = 1e-6
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
OUT_TOL = dict(rtol=1e-5, atol=1e-6)
ROUTER = "layer3.router.kernel"
# RoPE: with learned positions the keys' bias has a zero gradient up to
# rounding, which Adam's m/√v turns into lr-sized steps of noise.
LM = dict(vocab_size=32, embed_dim=16, num_heads=4, num_layers=2, max_len=16, rope=True,
          moe_experts=2, moe_capacity_factor=8.0)


def _np(tree):
    return jax.tree.map(lambda x: np.array(x, copy=True), tree)


def _mesh(axes):
    n = int(np.prod(list(axes.values())))
    return make_mesh(MeshConfig(axes), jax.devices()[:n])


def _classifier(axis_name=None):
    return Sequential((Flatten(), Dense(28 * 28, D), Activation(jax.nn.relu),
                       MoELayer(D, E, mlp_ratio=2, capacity_factor=8.0, axis_name=axis_name),
                       Dense(D, 10)))


@dataclass(frozen=True)
class _Tap(Optimizer):
    """Records the router's gradient (on every device) and defers to
    ``base``: around JAX's clip and under it, the two records' ratio is the
    scale JAX's clip applied."""

    base: Optimizer = None
    tag: str = ""
    seen: list = field(default_factory=list, compare=False)

    def init(self, params):
        return self.base.init(params)

    def init_spec(self, specs):
        return self.base.init_spec(specs)

    def update(self, grads, state, params):
        jax.debug.callback(lambda g: self.seen.append(np.array(g)),
                           grads["layer3"]["router"]["kernel"])
        return self.base.update(grads, state, params)


def _jax_train(engine, ts, batches):
    step = engine.make_train_step()
    losses, accs = [], []
    for x, y in batches:
        ts, m = step(ts, x, y)
        losses.append(float(m["loss"]))
        accs.append(float(m["accuracy"]))
    jax.effects_barrier()
    return ts, losses, accs


def _classifier_case(seed_images, seed_params, steps, opt, mesh_axes, **engine_kw):
    """(port spec, JAX's results) of one classifier EP run."""
    images, labels = synthetic_classification(G, (28, 28, 1), 10, seed=seed_images)
    batches = [(images, labels)] * steps
    ep = ExpertParallel(_classifier("expert"), opt, _mesh(mesh_axes), **engine_kw)
    ts = ep.create_state(seed_key(seed_params))
    params = _np(ts.params)
    ts, losses, accs = _jax_train(ep, ts, batches)
    want = dict(losses=losses, accs=accs, params=_np(ts.params),
                eval=ep.evaluate(ts, batches[:1]))
    engine = {"mesh": mesh_axes, "aux_loss_weight": engine_kw.get("aux_loss_weight", 1e-2)}
    if "batch_axis" in engine_kw:
        engine["batch_axis"] = engine_kw["batch_axis"]
    spec = dict(classifier=(D, E, 28 * 28), params=params, opt_state=(), engine=engine,
                batches=[(torch.from_numpy(images), torch.from_numpy(labels))] * steps)
    return spec, want


def _lm_case():
    """The MoE LM of tests/test_fused_compose.py under JAX's EP with fused
    add+LN (Adam 1e-2, the default aux weight): one warm step, then the
    carried params and Adam state train two more. The port runs it fused
    with flash attention and unfused (plain attention, unfused LN)."""
    rng = np.random.default_rng(3)
    batch = rng.integers(0, LM["vocab_size"], size=(4, 17)).astype(np.int32)
    x, y = batch[:, :-1], batch[:, 1:]
    ep = ExpertParallel(JaxLM(**LM, moe_axis="expert", fused_ln=True),
                        make_optimizer("adam", 1e-2), _mesh({"expert": W}))
    ts = ep.create_state(seed_key(0))
    ts, _, _ = _jax_train(ep, ts, [(x, y)])
    params, opt_state = _np(ts.params), _np(ts.opt_state)
    ts, losses, accs = _jax_train(ep, ts, [(x, y)] * 2)
    spec = dict(params=params, opt_state=opt_state, opt="adam", lr=1e-2,
                batches=[(torch.from_numpy(x), torch.from_numpy(y))] * 2)
    specs = {f"lm_{name}": dict(spec, lm=dict(LM, fused_ln=fused, impl=impl))
             for name, fused, impl in (("fused", True, "flash"), ("unfused", False, "full"))}
    return specs, dict(losses=losses, accs=accs, params=_np(ts.params))


def _layer_case(top_k, dispatch, seed):
    """JAX's EP forward of one MoE layer, and the dense layer's output and
    gradients of Σ y·cot (what the ranks' pieces must add up to)."""
    kw = dict(embed_dim=D, num_experts=E, mlp_ratio=2, capacity_factor=8.0, top_k=top_k,
              dispatch=dispatch)
    dense = MoELayer(**kw)
    params, _ = dense.init(seed_key(seed))
    tokens = jnp.asarray(np.random.default_rng(0).normal(size=(G, D)).astype(np.float32))
    cot = jnp.asarray(np.random.default_rng(2).normal(size=(G, D)).astype(np.float32))
    ep_layer = MoELayer(**kw, axis_name="expert")
    fwd = jax.jit(shard_map_fn(lambda p, x: ep_layer.apply(p, {}, x)[0],
                               _mesh({"expert": W}),
                               in_specs=(expert_specs(params, "expert"), P("expert")),
                               out_specs=P("expert")))

    def loss(p, x):
        return jnp.sum(dense.apply(p, {}, x)[0] * cot)

    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, tokens)
    spec = dict(layer=dict(embed_dim=D, num_experts=E, mlp_ratio=2, capacity_factor=8.0,
                           top_k=top_k, dispatch=dispatch),
                params=_np(params), tokens=torch.from_numpy(np.array(tokens)),
                cot=torch.from_numpy(np.array(cot)))
    return spec, dict(ep=np.asarray(fwd(params, tokens)),
                      dense=np.asarray(jax.jit(dense.apply)(params, {}, tokens)[0]),
                      grads=_flat(gp), dx=np.asarray(gx))


def _flat(tree, prefix=""):
    """A JAX tree's leaves by the port's dotted names."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _clip_case():
    """tests/test_moe.py's clip case: every step clips (max_norm 1e-2)."""
    raw = _Tap(tag="raw")
    inner = _Tap(base=Sgd(lr=0.1), tag="clipped")
    opt = dataclasses.replace(raw, base=ClipByGlobalNorm(inner, max_norm=1e-2))
    spec, want = _classifier_case(9, 1, 3, opt, {"expert": W})
    ratios = [float(np.vdot(c, r) / np.vdot(r, r)) for r, c in zip(raw.seen, inner.seen)]
    want["scales"] = ratios
    spec.update(opt="clip", lr=0.1, max_norm=1e-2, tap=ROUTER)
    return spec, want


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{case: JAX's results} and the two ranks' results."""
    job = tmp_path_factory.mktemp("ep")
    specs, want = {}, {}
    spec, want["train"] = _classifier_case(5, 3, 4, make_optimizer("sgd", 0.05),
                                           {"expert": W}, aux_loss_weight=0.0)
    specs["train"] = dict(spec, opt="sgd", lr=0.05)
    specs["clip"], want["clip"] = _clip_case()
    lm_specs, want["lm_fused"] = _lm_case()
    specs.update(lm_specs)
    layers, lwant = {}, {}
    for name, args in (("top1", (1, "gather", 1)), ("top2", (2, "gather", 5)),
                       ("einsum", (1, "einsum", 1))):
        layers[name], lwant[name] = _layer_case(*args)
    torch.save({"train": specs, "layer": layers}, job / "cases.pt")
    return {**want, **lwant}, torch_dist_worker.spawn("ep", job, W)


@pytest.fixture(scope="module")
def runs_dp(tmp_path_factory):
    """EP×DP: JAX's {data: 2, expert: 2} run and the four ranks'."""
    job = tmp_path_factory.mktemp("ep_dp")
    spec, want = _classifier_case(8, 3, 4, make_optimizer("sgd", 0.05),
                                  {"data": 2, "expert": 2}, aux_loss_weight=0.0,
                                  batch_axis="data")
    torch.save({"train": {"ep_dp": dict(spec, opt="sgd", lr=0.05)}}, job / "cases.pt")
    return want, torch_dist_worker.spawn("ep", job, 4)


def _gather_experts(ranks, case, world):
    """Every rank's parameters of ``case`` with the expert slices of the
    expert group's ranks concatenated in expert order (the global view)."""
    got = {}
    by_index = {r[case]["expert_index"]: r[case]["params"] for r in ranks}
    for name, p in ranks[0][case]["params"].items():
        got[name] = (torch.cat([by_index[i][name] for i in range(world)])
                     if is_expert_param(name) else p)
    return got


def _check_seeded_slices(ranks, case, world):
    """Before JAX's parameters are loaded, rank r (expert index r mod
    ``world``) holds rows [i·E/W, (i+1)·E/W) of every expert tensor of the
    model drawn from the same seed without EP."""
    for rank, got in enumerate(ranks):
        i = rank % world
        assert got[case]["expert_index"] == i
        assert set(got[case]["seeded"]) == set(got[case]["dense"]) != set()
        for name, full in got[case]["dense"].items():
            n = full.shape[0] // world
            assert got[case]["seeded"][name].shape[0] == n, name
            assert torch.equal(got[case]["seeded"][name], full[i * n:(i + 1) * n]), name


@pytest.mark.parametrize("case", ["train", "clip", "lm_fused", "lm_unfused",
                                  "top1", "top2", "einsum"])
def test_each_rank_keeps_its_rows_of_the_seeded_experts(runs, case):
    """ExpertParallel at world 2 cuts each rank's experts out of the one
    seeded draw: the port of JAX's create_state, which draws the model
    whole and shards it."""
    _, ranks = runs
    _check_seeded_slices(ranks, case, W)


def _check_training(ranks, want, case, world):
    for got in ranks:
        np.testing.assert_allclose(got[case]["losses"], want["losses"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(got[case]["accs"], want["accs"], atol=ACC_ATOL)
        if "eval" in want:
            np.testing.assert_allclose(got[case]["eval"], want["eval"], atol=ACC_ATOL)
    flat = _flat(want["params"])
    got = _gather_experts(ranks, case, world)
    assert set(got) == set(flat)
    for name, p in got.items():
        np.testing.assert_allclose(p.numpy(), flat[name], err_msg=name, **GRAD_TOL)
    for r in ranks[1:]:  # replicated leaves stay bitwise equal on every rank
        for name, p in r[case]["params"].items():
            if not is_expert_param(name):
                assert torch.equal(p, ranks[0][case]["params"][name]), name


@pytest.mark.parametrize("case", ["top1", "top2", "einsum"])
def test_ep_layer_matches_jax_ep_and_dense(runs, case):
    """test_ep_matches_dense / test_top2_ep_matches_dense: the ranks' rows
    of the EP layer's output equal JAX's EP output and the dense output;
    their gradients (the all_to_all's backward at world 2) add up to the
    dense layer's: token rows, the router summed over ranks, the experts
    concatenated."""
    want, ranks = runs
    y = torch.cat([r[case]["y"] for r in ranks]).numpy()
    np.testing.assert_allclose(y, want[case]["ep"], **OUT_TOL)
    np.testing.assert_allclose(y, want[case]["dense"], **OUT_TOL)
    dx = torch.cat([r[case]["dx"] for r in ranks]).numpy()
    np.testing.assert_allclose(dx, want[case]["dx"], **GRAD_TOL)
    for name, g in want[case]["grads"].items():
        parts = [r[case]["grads"][f"layer0.{name}"] for r in ranks]
        got = torch.cat(parts) if name.startswith("experts") else sum(parts)
        np.testing.assert_allclose(got.numpy(), g, err_msg=name, **GRAD_TOL)


def test_ep_training_matches_jax(runs):
    """test_ep_training_matches_dense: four SGD steps of the classifier."""
    want, ranks = runs
    _check_training(ranks, want["train"], "train", W)
    assert want["train"]["losses"][-1] < want["train"]["losses"][0]


def test_clip_in_ep_keeps_replicas_synced_and_scales_as_jax(runs):
    """test_clip_in_ep_keeps_replicas_synced: the engine rewraps the clip
    under a wrapper onto the expert group, every step clips by JAX's scale
    (taps around and under the clip), and the router stays bitwise equal
    across ranks."""
    want, ranks = runs
    _check_training(ranks, want["clip"], "clip", W)
    jax_scales = np.asarray(want["clip"]["scales"]).reshape(3, W)
    assert np.all(jax_scales == jax_scales[:, :1])  # every device, one scale
    for got in ranks:
        assert got["clip"]["clip_axes"]
        scales = [float(torch.vdot(c.flatten(), r.flatten()) / torch.vdot(r.flatten(),
                                                                           r.flatten()))
                  for r, c in zip(got["clip"]["raw"], got["clip"]["clipped"])]
        assert max(scales) < 1.0  # every step clipped
        np.testing.assert_allclose(scales, jax_scales[:, 0], rtol=LOSS_RTOL)
    assert torch.equal(ranks[0]["clip"]["params"][ROUTER], ranks[1]["clip"]["params"][ROUTER])


def test_moe_lm_under_ep_matches_jax(runs):
    """The MoE LM with fused add+LN and flash attention, from JAX's params
    and Adam state after one step: two more steps at the default aux
    weight 1e-2 against JAX's fused EP run."""
    want, ranks = runs
    _check_training(ranks, want["lm_fused"], "lm_fused", W)


def test_fused_ln_flash_lm_matches_unfused_under_ep(runs):
    """test_fused_ln_moe_matches_unfused_under_ep: the unfused trunk (plain
    attention, unfused LN) trains the fused one's trajectory under EP from
    the same carried state (JAX's _assert_tree_close: 1e-5 / 1e-6)."""
    _, ranks = runs
    for got in ranks:
        np.testing.assert_allclose(got["lm_fused"]["losses"], got["lm_unfused"]["losses"],
                                   rtol=LOSS_RTOL)
        for name, p in got["lm_fused"]["params"].items():
            np.testing.assert_allclose(p.numpy(), got["lm_unfused"]["params"][name].numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=name)


def test_all_to_all_and_its_backward_at_world_two(runs):
    """[E, C, d] -> [E/W, W·C, d] (split 0, concat 1) against numpy over the
    ranks' seeded inputs; its backward is the inverse all_to_all of the
    cotangent; the inverse brings the input back."""
    _, ranks = runs
    xs = [np.random.default_rng((7, r)).standard_normal((4 * W, 3, 2)) for r in range(W)]
    ws = [np.random.default_rng((8, r)).standard_normal((4, 3 * W, 2)) for r in range(W)]
    for r, got in enumerate(ranks):
        want_y = np.concatenate([xs[j][4 * r:4 * (r + 1)] for j in range(W)], axis=1)
        want_dx = np.concatenate([ws[j][:, 3 * r:3 * (r + 1)] for j in range(W)], axis=0)
        np.testing.assert_array_equal(got["a2a"]["y"].numpy(), want_y)
        np.testing.assert_array_equal(got["a2a"]["dx"].numpy(), want_dx)
        np.testing.assert_array_equal(got["a2a"]["back"].numpy(), xs[r])


def test_task5_parallel_ep_at_world_two(runs):
    """task5 --parallel ep over two gloo ranks: one run (both ranks report
    it), the loss falls; --moe_experts 3 does not divide over 2."""
    _, ranks = runs
    a, b = (r["task5"] for r in ranks)
    assert a["devices"] == b["devices"] == 2
    assert a["final_loss"] == b["final_loss"] and np.isfinite(a["final_loss"])
    for r in ranks:
        assert r["indivisible"] == "--moe_experts 3 must divide over 2 devices"


def test_ep_composes_with_dp(runs_dp):
    """test_ep_composes_with_dp at {data: 2, expert: 2}: four SGD steps,
    replicated leaves equal on all four ranks, experts on their data
    replicas, each rank's experts cut from the seeded draw by its expert
    index, and the counting eval's accuracy equals JAX's."""
    want, ranks = runs_dp
    _check_seeded_slices(ranks, "ep_dp", 2)
    _check_training(ranks, want, "ep_dp", 2)
    for r in (0, 1):  # ranks r and r + 2 hold the same experts
        a, b = ranks[r]["ep_dp"], ranks[r + 2]["ep_dp"]
        assert a["expert_index"] == b["expert_index"] == r
        for name, p in a["params"].items():
            assert torch.equal(p, b["params"][name]), name
