"""The port's step sentinel (``tpudml_torch.resilience``) against
``tpudml.resilience``, on the CPU.

- the NaN step on two gloo ranks (``tests/torch_dist_worker.py``'s
  ``sentinel`` suite: LeNet, Adam) against JAX's
  ``DataParallel(sentinel=True)`` on a 2-device CPU mesh: the same skipped
  step, the same counters and ``bad_leaf`` (by its JAX path), the
  parameters and Adam state of the skipped step bitwise those of the step
  before, the run after it bitwise equal to a run that never saw the
  poisoned batch, and parameters within ``GRAD_TOL`` of JAX's;
- under gradient accumulation the taint names the poisoned micro-batch,
  as JAX's (``tests/test_sentinel.py:129``);
- the optimizer-level guard: the spike test arms after warmup (counters
  and EMA as JAX's), a finite outlier passes without it;
- ``sentinel_hook`` escalates past the budget naming the leaf and the
  micro-batch, and is silent without a sentinel; constructor validation.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

import torch_dist_worker  # noqa: E402
from tpudml import resilience as jres  # noqa: E402
from tpudml.core.config import MeshConfig  # noqa: E402
from tpudml.core.dist import make_mesh  # noqa: E402
from tpudml.models import LeNet as JaxLeNet  # noqa: E402
from tpudml.optim import Adam as JaxAdam  # noqa: E402
from tpudml.optim import Sgd as JaxSgd  # noqa: E402
from tpudml.parallel.dp import DataParallel as JaxDP  # noqa: E402
from tpudml_torch.interop import sequential_params_from_tpudml  # noqa: E402
from tpudml_torch.optim import Sgd  # noqa: E402
from tpudml_torch.resilience import (  # noqa: E402
    GradSentinel, SentinelTripped, attach_sentinel, corrupt_microbatch, find_sentinel,
    find_sentinel_state, param_leaf_names, sentinel_hook, sentinel_stats,
)

WORLD, GLOBAL = 2, 16
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _np(tree):
    return jax.tree.map(lambda a: np.array(a, copy=True), tree)


def _jax_run(opt, batches, **kw):
    mesh = make_mesh(MeshConfig({"data": WORLD}), jax.devices()[:WORLD])
    dp = JaxDP(JaxLeNet(), opt, mesh, stacked_batches=False, **kw)
    ts = dp.create_state(jax.random.key(0))  # the parameters of JaxLeNet().init(key(0))
    step = dp.make_train_step()
    out = []
    for x, y in batches:
        ts, m = step(ts, x, y)
        out.append({"params": sequential_params_from_tpudml(_np(ts.params)),
                    "stats": jres.sentinel_stats(ts.opt_state),
                    "bad_micro": int(m["bad_micro"]), "loss": float(m["loss"])})
    return out, jres.param_leaf_names(ts.params)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    job = tmp_path_factory.mktemp("sentinel")
    rng = np.random.default_rng(0)
    x = rng.normal(size=(GLOBAL, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, size=(GLOBAL,)).astype(np.int32)
    xbad = jres.corrupt_microbatch(x, "nan", seed=1)
    np.testing.assert_array_equal(corrupt_microbatch(x, "nan", seed=1), xbad)
    xacc = x.copy()
    xacc[5, 3, 3, 0] = np.nan  # replica 0's rows [0:8]; its micro-batch 1 is [4:8]
    params, _ = JaxLeNet().init(jax.random.key(0))
    want = {"poisoned": _jax_run(JaxAdam(lr=1e-3), [(x, y), (xbad, y), (x, y)],
                                 sentinel={"skip_budget": 2}),
            "accum": _jax_run(JaxSgd(lr=0.01), [(x, y), (xacc, y)], sentinel=True,
                              accum_steps=2)}
    torch.save({"lenet": sequential_params_from_tpudml(_np(params)), "x": x, "y": y,
                "xbad": xbad, "xacc": xacc}, job / "cases.pt")
    return want, torch_dist_worker.spawn("sentinel", job, WORLD)


def test_nan_step_skipped_as_jax_at_world_2(runs):
    want, ranks = runs
    jsteps, jnames = want["poisoned"]
    for got in ranks:
        steps, names = got["poisoned"]["steps"], got["poisoned"]["names"]
        assert names == jnames
        assert [s["stats"]["skips"] for s in steps] == [s["stats"]["skips"] for s in jsteps]
        for s, js in zip(steps, jsteps):
            for k in ("skips", "consecutive", "good_steps", "bad_leaf"):
                assert s["stats"][k] == js["stats"][k], k
            np.testing.assert_allclose(s["stats"]["norm_ema"], js["stats"]["norm_ema"],
                                       rtol=1e-4)
            assert s["bad_micro"] == js["bad_micro"]
            for n, t in js["params"].items():
                np.testing.assert_allclose(s["params"][n].numpy(), t.numpy(), err_msg=n,
                                           **GRAD_TOL)
        assert steps[1]["stats"]["skips"] == 1 and steps[1]["stats"]["bad_leaf"] >= 0
        assert names[steps[1]["stats"]["bad_leaf"]] == jnames[jsteps[1]["stats"]["bad_leaf"]]
        # the skipped step carried parameters and Adam state forward bitwise
        for n, t in steps[0]["params"].items():
            assert torch.equal(steps[1]["params"][n], t), n
        for k in ("m", "v"):
            for n, t in steps[0]["base"][k].items():
                assert torch.equal(steps[1]["base"][k][n], t), (k, n)
        assert torch.equal(steps[1]["base"]["t"], steps[0]["base"]["t"])
        # ... and the run after it equals one that never saw the batch
        clean = got["clean"]["steps"][1]
        for n, t in clean["params"].items():
            assert torch.equal(steps[2]["params"][n], t), n
        assert steps[2]["stats"]["consecutive"] == 0
    assert all(torch.equal(ranks[0]["poisoned"]["steps"][2]["params"][n], t)
               for n, t in ranks[1]["poisoned"]["steps"][2]["params"].items())


def test_accum_taint_names_poisoned_microbatch(runs):
    want, ranks = runs
    jsteps, _ = want["accum"]
    for got in ranks:
        steps = got["accum"]["steps"]
        assert [s["bad_micro"] for s in steps] == [s["bad_micro"] for s in jsteps] == [-1, 1]
        assert steps[1]["stats"]["skips"] == jsteps[1]["stats"]["skips"] == 1


def _pair(**kw):
    return (GradSentinel(Sgd(lr=0.1), **kw),
            jres.GradSentinel(JaxSgd(lr=0.1), **kw))


def test_spike_guard_arms_after_warmup():
    """A spike during warmup passes; after two good steps the guard is armed
    and skips one, its EMA untouched; counters, EMA and parameters as
    JAX's at every step."""
    sent, jsent = _pair(spike_factor=5.0, warmup_steps=2, ema_decay=0.5)
    for seq, skips in (([100.0], 0), ([0.1, 0.1, 100.0], 1)):
        params, jparams = {"w": torch.ones(4)}, {"w": jnp.ones(4)}
        state, jstate = sent.init(params), jsent.init(jparams)
        for i, g in enumerate(seq):
            params, state = sent.update({"w": torch.full((4,), g)}, state, params)
            jparams, jstate = jsent.update({"w": jnp.full(4, g)}, jstate, jparams)
            st, jst = sentinel_stats(state), jres.sentinel_stats(jstate)
            keys = ("skips", "consecutive", "good_steps", "bad_leaf")
            assert {k: st[k] for k in keys} == {k: jst[k] for k in keys}, i
            np.testing.assert_allclose(st["norm_ema"], jst["norm_ema"], rtol=1e-6)
            np.testing.assert_allclose(params["w"].numpy(), np.asarray(jparams["w"]),
                                       rtol=1e-6)
        assert st["skips"] == skips and st["bad_leaf"] == -1  # a finite spike: no leaf


def test_outlier_passes_without_spike_guard():
    sent, _ = _pair()
    params = {"w": torch.ones(4)}
    _, s = sent.update({"w": torch.full((4,), 1e30)}, sent.init(params), params)
    assert int(s["skips"]) == 0


def test_bad_leaf_is_jax_leaf_order():
    """bad_leaf indexes the parameters in JAX's flatten order (dotted names
    as nested paths), whatever the module's registration order."""
    params = {"layer9.kernel": torch.ones(2), "layer10.bias": torch.ones(2),
              "layer0.kernel": torch.ones(2)}
    sent = GradSentinel(Sgd(lr=0.1))
    grads = {n: torch.ones(2) for n in params}
    grads["layer9.kernel"] = torch.tensor([1.0, float("nan")])
    _, st = sent.update(grads, sent.init(params), params)
    names = param_leaf_names(params)
    assert names == ["['layer0']['kernel']", "['layer10']['bias']", "['layer9']['kernel']"]
    jnames = jres.param_leaf_names({"layer9": {"kernel": 0}, "layer10": {"bias": 0},
                                    "layer0": {"kernel": 0}})
    assert names == jnames and names[int(st["bad_leaf"])] == "['layer9']['kernel']"


class _TS:
    def __init__(self, opt_state):
        self.opt_state = opt_state


def test_hook_escalates_past_budget():
    sent = attach_sentinel(Sgd(lr=0.1), skip_budget=1)
    assert find_sentinel(sent) is sent and sent.skip_budget == 1
    params = {"a": torch.ones(3), "b": torch.ones(3)}
    state = sent.init(params)
    hook = sentinel_hook(sent, params)
    bad = {"a": torch.ones(3), "b": torch.tensor([1.0, float("inf"), 1.0])}
    params, state = sent.update(bad, state, params)
    hook(step=1, train_state=_TS(state), metrics={"bad_micro": torch.tensor(0)})
    params, state = sent.update(bad, state, params)
    with pytest.raises(SentinelTripped, match="2 consecutive") as exc:
        hook(step=2, train_state=_TS(state), metrics={"bad_micro": torch.tensor(0)})
    assert "['b']" in str(exc.value) and "microbatch 0" in str(exc.value)
    assert find_sentinel_state({"outer": [state]}) is state


def test_hook_noop_without_sentinel():
    sent = GradSentinel(Sgd(lr=0.1), skip_budget=1)
    sentinel_hook(sent)(step=1, train_state=_TS({"m": {}}), metrics={})
    with pytest.raises(ValueError, match="no GradSentinel"):
        sentinel_stats({})


def test_constructor_validation_and_state_layout():
    with pytest.raises(ValueError, match="base optimizer"):
        GradSentinel()
    with pytest.raises(ValueError, match="skip_budget"):
        GradSentinel(Sgd(), skip_budget=0)
    with pytest.raises(ValueError, match="spike_factor"):
        GradSentinel(Sgd(), spike_factor=0.5)
    from tpudml_torch.optim import Adam

    state = GradSentinel(Adam()).init({"w": torch.ones(2)})
    jstate = jres.GradSentinel(JaxAdam()).init({"w": jnp.ones(2)})
    assert sorted(state) == sorted(jstate)
    for k in ("skips", "consecutive", "good_steps", "norm_ema", "bad_leaf"):
        assert str(state[k].dtype).split(".")[-1] == str(jstate[k].dtype), k
        assert float(state[k]) == float(jstate[k]), k
    assert state["base"]["t"].dtype == torch.int32  # held back without a host read
    scalars = [state[k] for k in ("skips", "consecutive", "good_steps")]
    assert len({id(t) for t in scalars}) == len(scalars)
