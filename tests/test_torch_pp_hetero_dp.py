"""Heterogeneous pipelines at world 4 on the port against
``tpudml.parallel.pp``, on the CPU (``tests/torch_dist_worker.py``'s
``pp`` suite over gloo, spawned once):

- the LeNet split under PP×DP on ``{"data": 2, "stage": 2}``
  (``tests/test_pp_hetero.py:77``): the loss against JAX's, each stage's
  update against the port's single-device step on the whole batch, the fc
  stage's also against JAX's (``tests/test_torch_pp_hetero.py`` says why
  not the conv stage's), both data replicas of a stage bitwise alike;
- four uneven MLP stages on four ranks (``tests/test_pp_hetero.py:98``):
  the forward against JAX's ``sequential_forward``, one SGD-momentum step
  against JAX's (Adam would turn a gradient element that rounds across 0
  into ±lr), and thirty Adam steps that halve the loss, as JAX's test
  asks. Each tick a rank sends at most its stage's real activation.

Tolerances (f32): the forward rtol 2e-5 / atol 2e-6; losses rtol 1e-5;
parameters after one update ``GRAD_TOL`` (rtol 1e-4, atol 1e-6).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

import torch_dist_worker  # noqa: E402
from test_torch_pp_hetero import _port_single_step  # noqa: E402
from tpudml.core.config import MeshConfig  # noqa: E402
from tpudml.core.dist import make_mesh  # noqa: E402
from tpudml.core.prng import seed_key  # noqa: E402
from tpudml.models.staged import lenet_stages as jax_lenet_stages  # noqa: E402
from tpudml.nn import Activation as JaxActivation  # noqa: E402
from tpudml.nn import Dense as JaxDense  # noqa: E402
from tpudml.nn import Sequential as JaxSequential  # noqa: E402
from tpudml.optim import make_optimizer  # noqa: E402
from tpudml.parallel.pp import HeteroPipeline as JaxHetero  # noqa: E402

LOSS_RTOL = 1e-5
FWD_TOL = dict(rtol=2e-5, atol=2e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
UNEVEN = [(12, 48, True, 0.0), (48, 20, True, 0.0), (20, 64, True, 0.0), (64, 10, False, 0.0)]


def _np(tree):
    return jax.tree.map(lambda a: np.array(a, copy=True), tree)


def _mesh(axes):
    n = int(np.prod(list(axes.values())))
    return make_mesh(MeshConfig(axes), jax.devices()[:n])


def _uneven():
    return [JaxSequential((JaxDense(i, o),) + ((JaxActivation(jax.nn.relu),) if relu else ()))
            for i, o, relu, _ in UNEVEN]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    job = tmp_path_factory.mktemp("pp_hetero_dp")
    want, cases = {}, {}
    rng = np.random.default_rng(3)
    x = rng.normal(size=(16, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, size=(16,)).astype(np.int32)
    d2 = {"data": 2, "stage": 2}
    pipe = JaxHetero([m for _, m in jax_lenet_stages().stages], n_microbatches=2,
                     mesh=_mesh(d2), optimizer=make_optimizer("sgd", 0.05, momentum=0.9),
                     batch_axis="data")
    ts = pipe.create_state(seed_key(1))
    p0 = _np(ts.params)
    ts, m = pipe.make_train_step()(ts, x, y)
    want["lenet"], want["lenet_rows"] = [float(m["loss"])], np.array(ts.params["stages"])
    want["lenet_port"] = _port_single_step(p0["stages"], x, y)
    cases["lenet"] = dict(engine="hetero", stages="lenet", mesh=d2, batch_axis="data",
                          opt=("sgd", 0.05, 0.9), M=2, params=p0, batches=[(x, y)])
    # Four uneven stages.
    rng = np.random.default_rng(5)
    xu = rng.normal(size=(8, 12)).astype(np.float32)
    yu = rng.integers(0, 10, size=(8,)).astype(np.int32)
    s4 = {"stage": 4}
    pipe = JaxHetero(_uneven(), n_microbatches=4, mesh=_mesh(s4),
                     optimizer=make_optimizer("sgd", 0.05, momentum=0.9))
    params = _np(pipe.init_params(seed_key(0)))
    want["uneven_fwd"] = np.asarray(pipe.sequential_forward(params, jnp.asarray(xu)))
    ts = pipe.create_state(seed_key(2))
    p0 = _np(ts.params)
    ts, m = pipe.make_train_step()(ts, xu, yu)
    want["uneven"], want["uneven_rows"] = [float(m["loss"])], np.array(ts.params["stages"])
    base = dict(engine="hetero", stages=UNEVEN, mesh=s4, M=4)
    cases["uneven_fwd"] = dict(base, opt=("sgd", 0.05, 0.9), params=params, forward_x=xu)
    cases["uneven"] = dict(base, opt=("sgd", 0.05, 0.9), params=p0, batches=[(xu, yu)])
    cases["uneven_adam"] = dict(base, opt=("adam", 1e-2), params=p0, batches=[(xu, yu)] * 30)
    torch.save({"pp": cases}, job / "cases.pt")
    return want, torch_dist_worker.spawn("pp", job, 4)


def test_lenet_pp_x_dp(runs):
    want, ranks = runs
    assert [r["lenet"]["stage"] for r in ranks] == [0, 1, 0, 1]
    for r in ranks:
        np.testing.assert_allclose(r["lenet"]["losses"], want["lenet"], rtol=LOSS_RTOL)
        s = r["lenet"]["stage"]
        np.testing.assert_allclose(r["lenet"]["row"], want["lenet_port"][s], **GRAD_TOL)
        if s == 1:
            np.testing.assert_allclose(r["lenet"]["row"], want["lenet_rows"][s], **GRAD_TOL)
    for a, b in ((0, 2), (1, 3)):
        np.testing.assert_array_equal(ranks[a]["lenet"]["row"], ranks[b]["lenet"]["row"])


def test_four_uneven_stages_forward(runs):
    want, ranks = runs
    for r in ranks:
        np.testing.assert_allclose(r["uneven_fwd"]["forward"].numpy(), want["uneven_fwd"],
                                   **FWD_TOL)


def test_four_uneven_stages_step_matches_jax(runs):
    want, ranks = runs
    for s, r in enumerate(ranks):
        assert r["uneven"]["stage"] == s
        np.testing.assert_allclose(r["uneven"]["losses"], want["uneven"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(r["uneven"]["row"], want["uneven_rows"][s], **GRAD_TOL)
        # Micro-batches of 2 rows: stage s sends [2, out_s] forward, and
        # [2, in_s] back.
        i, o = UNEVEN[s][:2]
        ticks = r["uneven"]["tick_bytes"][0]
        assert max(ticks) == 8 * max(o * (s < 3), i * (s > 0))


def test_four_uneven_stages_train(runs):
    _, ranks = runs
    losses = ranks[0]["uneven_adam"]["losses"]
    assert losses[-1] < 0.5 * losses[0]
    assert all(r["uneven_adam"]["losses"] == losses for r in ranks)
