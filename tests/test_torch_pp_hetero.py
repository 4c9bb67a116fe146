"""Heterogeneous pipelines on the port (``HeteroPipeline``,
``HeteroOneFOneB``) against ``tpudml.parallel.pp``, on the CPU: the
reference's LeNet conv/fc split as two pipeline stages.

World 2 over gloo (``tests/torch_dist_worker.py``'s ``pp`` suite, spawned
once). JAX ravels each stage into one padded f32 row of ``[S, L]``; each
port rank keeps its stage as the module (``stages.<its names>``) and
sends its real activation shape. ``interop.hetero_stage_from_tpudml``
cuts JAX's row into the stage's tensors (conv kernels HWIO -> OIHW) and
``hetero_stage_to_tpudml`` ravels them back, so each rank's stage after
the update is held against its row of JAX's:

- the forward at M = 1, 2, 8 against JAX's ``sequential_forward``
  (``tests/test_pp_hetero.py:48``), and the port's ``sequential_forward``
  on every stage's tensors from JAX's rows against it too;
- one GPipe step at M = 4 (``tests/test_pp_hetero.py:60``) and one 1F1B
  step (``tests/test_pp_hetero.py:156``): losses against JAX's engines,
  each stage's update against the port's single-device step and the fc
  stage's also against JAX's (the conv stage holds a ReLU input within
  rounding of 0 on this batch: ``test_hetero_step_matches_jax``);
- 1F1B with a dropout stage, on JAX's masks rebuilt at the port keys'
  fold paths (``tests/test_pp_hetero.py:193``);
- each tick's bytes: the conv stage's [2, 400] activation (its real
  width, JAX's padded buffer is [2, A] with A = 784) forward, its
  cotangent back.

At world 1: the validation errors with JAX's wording
(``tests/test_pp_hetero.py:126``) and the two layouts' round trip.

Tolerances (f32): the forward rtol 2e-5 / atol 2e-6; losses rtol 1e-5;
parameters after one update ``GRAD_TOL`` (rtol 1e-4, atol 1e-6).
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
from tpudml.models.staged import lenet_stages as jax_lenet_stages  # noqa: E402
from tpudml.nn import Activation as JaxActivation  # noqa: E402
from tpudml.nn import Dense as JaxDense  # noqa: E402
from tpudml.nn import Dropout as JaxDropout  # noqa: E402
from tpudml.nn import Sequential as JaxSequential  # noqa: E402
from tpudml.optim import make_optimizer  # noqa: E402
from tpudml.parallel.pp import HeteroOneFOneB as JaxHetero1F1B  # noqa: E402
from tpudml.parallel.pp import HeteroPipeline as JaxHetero  # noqa: E402
from tpudml_torch.core.prng import Key  # noqa: E402
from tpudml_torch.interop import hetero_stage_from_tpudml, hetero_stage_to_tpudml  # noqa: E402
from tpudml_torch.models import lenet_stages  # noqa: E402
from tpudml_torch.nn import BatchNorm, Dense, Dropout, Sequential  # noqa: E402
from tpudml_torch.optim import Sgd  # noqa: E402
from tpudml_torch.parallel import HeteroPipeline  # noqa: E402
from tpudml_torch.train import TrainState, make_train_step  # noqa: E402

LOSS_RTOL = 1e-5
FWD_TOL = dict(rtol=2e-5, atol=2e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
SGD = ("sgd", 0.05, 0.9)
DROP_STAGES = [(12, 48, True, 0.5), (48, 10, False, 0.0)]


def _np(tree):
    return jax.tree.map(lambda a: np.array(a, copy=True), tree)


def jax_key(key: Key):
    k = jax.random.key(key.seed)
    for entry in key.path:
        if entry[0] == "fold":
            k = jax.random.fold_in(k, np.uint32(entry[1]))
        else:
            k = jax.random.split(k, entry[1])[entry[2]]
    return k


def _mesh(n):
    return make_mesh(MeshConfig({"stage": n}), jax.devices()[:n])


def _jax_run(pipe, key, batches):
    ts = pipe.create_state(seed_key(key))
    params0 = _np(ts.params)
    step = pipe.make_train_step()
    losses = []
    for x, y in batches:
        ts, m = step(ts, x, y)
        losses.append(float(m["loss"]))
    return params0, losses, np.array(ts.params["stages"])


def _port_single_step(rows, x, y):
    """The port's single-device SGD-momentum step of the whole LeNet from
    JAX's rows: each stage's row after it."""
    model = lenet_stages(device="cpu")
    stages = [m for _, m in model.named_children()]
    for s, st in enumerate(stages):
        st.load_state_dict(hetero_stage_from_tpudml(rows[s], st))
    opt = Sgd(lr=0.05, momentum=0.9)
    make_train_step(model, opt)(TrainState.create(model, opt), x, y)
    return [hetero_stage_to_tpudml(dict(st.named_parameters()), st, rows.shape[1])
            for st in stages]


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(16, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, size=(16,)).astype(np.int32)
    return x, y


@pytest.fixture(scope="module")
def runs(tmp_path_factory, batch):
    x, y = batch
    job = tmp_path_factory.mktemp("pp_hetero")
    want, cases = {}, {}
    stages = [m for _, m in jax_lenet_stages().stages]
    sgd = make_optimizer("sgd", 0.05, momentum=0.9)
    pipe = JaxHetero(stages, n_microbatches=1, mesh=_mesh(2), optimizer=sgd)
    params = _np(pipe.init_params(seed_key(0)))
    want["sequential"] = np.asarray(pipe.sequential_forward(params, jnp.asarray(x)))
    base = dict(stages="lenet", mesh={"stage": 2}, opt=SGD)
    for m in (1, 2, 8):
        cases[f"fwd{m}"] = dict(base, engine="hetero", M=m, params=params, forward_x=x)
    for name, cls in (("gpipe", JaxHetero), ("1f1b", JaxHetero1F1B)):
        p0, want[name], want[f"{name}_rows"] = _jax_run(
            cls(stages, n_microbatches=4, mesh=_mesh(2), optimizer=sgd), 1, [(x, y)])
        cases[name] = dict(base, engine="hetero" if name == "gpipe" else "hetero_1f1b", M=4,
                           params=p0, batches=[(x, y)])
    want["port_rows"] = _port_single_step(p0["stages"], x, y)
    # 1F1B with a dropout stage, on JAX's masks.
    drop = [JaxSequential((JaxDense(12, 48), JaxActivation(jax.nn.relu), JaxDropout(0.5))),
            JaxSequential((JaxDense(48, 10),))]
    rng = np.random.default_rng(11)
    xd = rng.normal(size=(8, 12)).astype(np.float32)
    yd = rng.integers(0, 10, size=(8,)).astype(np.int32)
    p0, want["drop"], want["drop_rows"] = _jax_run(
        JaxHetero1F1B(drop, n_microbatches=4, mesh=_mesh(2), optimizer=make_optimizer(
            "sgd", 0.05), rng_root=jax_key(Key(7))), 3, [(xd, yd)])
    masks = {}
    for mi in range(4):
        key = Key(7).fold_in(0).fold_in(0).fold_in(mi).split(3, 2)
        masks[key.path] = np.array(jax.random.bernoulli(jax_key(key), 0.5, (2, 48)))
    cases["drop"] = dict(engine="hetero_1f1b", stages=DROP_STAGES, mesh={"stage": 2},
                         opt=("sgd", 0.05), M=4, params=p0, batches=[(xd, yd)],
                         rng_root=7, masks=masks)
    torch.save({"pp": cases}, job / "cases.pt")
    return want, torch_dist_worker.spawn("pp", job, 2)


@pytest.mark.parametrize("n_mb", [1, 2, 8])
def test_lenet_forward_matches_sequential(runs, n_mb):
    want, ranks = runs
    for r in ranks:
        np.testing.assert_allclose(r[f"fwd{n_mb}"]["forward"].numpy(), want["sequential"],
                                   **FWD_TOL)
        np.testing.assert_allclose(r[f"fwd{n_mb}"]["sequential"].numpy(), want["sequential"],
                                   **FWD_TOL)


@pytest.mark.parametrize("name", ["gpipe", "1f1b", "drop"])
def test_hetero_step_matches_jax(runs, name):
    """Losses against JAX's engine; each stage's update against the port's
    own single-device step of the whole LeNet (``StagedModel``, the same
    parameters and batch) and, but for the conv stage, against JAX's. On
    this batch one ReLU input of the conv stage is within rounding of 0
    (|x| ≈ 1e-8 in the port, 2e-9 in JAX), and the port's single-device
    step differs from JAX's there exactly as the pipeline does (3.4e-5 at
    most): a property of the f32 conv sums, not of the schedule."""
    want, ranks = runs
    for r in ranks:
        np.testing.assert_allclose(r[name]["losses"], want[name], rtol=LOSS_RTOL)
        s = r[name]["stage"]
        if name != "drop":
            np.testing.assert_allclose(r[name]["row"], want["port_rows"][s], **GRAD_TOL)
        if name == "drop" or s == 1:
            np.testing.assert_allclose(r[name]["row"], want[f"{name}_rows"][s], **GRAD_TOL)


def test_each_rank_holds_its_real_stage(runs):
    _, ranks = runs
    assert [r["gpipe"]["stage"] for r in ranks] == [0, 1]
    assert ranks[0]["gpipe"]["local"] == {
        "stages.layer0.kernel": (6, 1, 5, 5), "stages.layer0.bias": (6,),
        "stages.layer3.kernel": (16, 6, 5, 5), "stages.layer3.bias": (16,)}
    assert ranks[1]["gpipe"]["local"] == {
        "stages.layer0.kernel": (400, 120), "stages.layer0.bias": (120,),
        "stages.layer2.kernel": (120, 10), "stages.layer2.bias": (10,)}


def test_bytes_are_the_real_activation(runs):
    """Four micro-batches of 4 images: the conv stage sends each [4, 400]
    activation once (6400 bytes), the fc stage each cotangent back; JAX's
    buffer is [4, 784] (A = the widest boundary, the input)."""
    _, ranks = runs
    act = 4 * 400 * 4
    for name in ("gpipe", "1f1b"):
        for r in ranks:
            ticks = r[name]["tick_bytes"][0]
            assert max(ticks) == act < 4 * 784 * 4
            assert sum(ticks) == 4 * act


# ------------------------------------------------------------- world 1


def test_validation_errors():
    opt = Sgd(lr=0.1)
    mesh = {"stage": 2}
    with pytest.raises(ValueError, match="stages need"):
        HeteroPipeline([Dense(4, 4)], 2, mesh, opt)
    with pytest.raises(ValueError, match="dropout"):
        HeteroPipeline([Sequential((Dense(4, 4), Dropout(0.5))), Dense(4, 4)], 2, mesh, opt)
    with pytest.raises(ValueError, match="stateful"):
        HeteroPipeline([Sequential((Dense(4, 4), BatchNorm(4))), Dense(4, 4)], 2, mesh, opt)
    with pytest.raises(TypeError, match="prologue"):
        HeteroPipeline([Dense(4, 4), Dense(4, 4)], 2, mesh, opt, prologue=Dense(4, 4))


def test_layouts_round_trip_against_jax_ravel():
    """A stage's tensors from JAX's padded row and back: the row JAX's
    ``ravel_pytree`` makes of the stage's param tree, padded to L."""
    from jax.flatten_util import ravel_pytree

    stages = [m for _, m in jax_lenet_stages().stages]
    pipe = JaxHetero(stages, n_microbatches=1, mesh=_mesh(2), optimizer=make_optimizer("sgd", 1))
    rows = np.asarray(pipe.init_params(seed_key(0))["stages"])
    ours = [m for _, m in lenet_stages(device="cpu").named_children()]
    for s, stage in enumerate(ours):
        got = hetero_stage_from_tpudml(rows[s], stage)
        tree = pipe._unravel(s, jnp.asarray(rows[s]))
        conv = got.get("layer0.kernel")
        if s == 0:  # OIHW in the port, HWIO in JAX
            np.testing.assert_array_equal(conv.permute(2, 3, 1, 0).numpy(),
                                          np.asarray(tree["layer0"]["kernel"]))
        back = hetero_stage_to_tpudml(got, stage, rows.shape[1])
        np.testing.assert_array_equal(back, rows[s])
        np.testing.assert_array_equal(
            back[:len(ravel_pytree(tree)[0])], np.asarray(ravel_pytree(tree)[0]))
