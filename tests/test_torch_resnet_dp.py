"""The port's ``DataParallel`` on the north star's ResNet against
``tpudml``'s, on the CPU.

Two processes over gloo (``tests/torch_dist_worker.py``'s ``resnet``
suite) train the port's engine; the JAX engine runs in this process on a
2-device CPU mesh. Both start from the JAX parameters and BatchNorm state
of ``small_resnet`` (``tests/test_resnet.py``: stage_sizes (1, 1), width
8), carried with ``resnet_params_from_tpudml``, and train three steps of
SGD lr 0.05 momentum 0.9 on the stacked ``[2, 4, 32, 32, 3]`` global
batches of ``synthetic_classification`` (8 images a step, 4 a replica).
Each replica normalizes by its own rows' statistics (not SyncBN), and the
engines average the gradients and then the BatchNorm buffers over the
replicas after the local step.

Tolerances (f32): losses rtol 1e-5; parameters and the averaged buffers
rtol 1e-4 / atol 1e-6 (``GRAD_TOL``). As in ``tests/test_torch_resnet.py``
every ReLU's sign mask of each replica is held equal to JAX's first (a
flip moves a gradient past GRAD_TOL in any two f32 implementations);
JAX's masks come from its model's forward on the replica's rows with the
step's parameters. ``SEED`` is one where no ReLU input lies within f32
rounding of 0 (at seeds 1, 3 and 5 one element flips, and the parameters
then miss GRAD_TOL by up to 2e-6 in both tests together). At world 1 the
port's engine equals its single-card step bitwise.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

import torch_dist_worker  # noqa: E402
from test_resnet import small_resnet  # noqa: E402
from tpudml.core.config import MeshConfig  # noqa: E402
from tpudml.core.dist import make_mesh  # noqa: E402
from tpudml.core.prng import seed_key  # noqa: E402
from tpudml.optim import Sgd as JaxSgd  # noqa: E402
from tpudml.parallel.dp import DataParallel as JaxDP  # noqa: E402
from tpudml_torch.core import DistributedConfig, process_group  # noqa: E402
from tpudml_torch.data import synthetic_classification  # noqa: E402
from tpudml_torch.interop import resnet_params_from_tpudml  # noqa: E402
from tpudml_torch.models import ResNet  # noqa: E402
from tpudml_torch.optim import Sgd  # noqa: E402
from tpudml_torch.parallel import DataParallel  # noqa: E402
from tpudml_torch.train import TrainState, make_train_step  # noqa: E402

WORLD, B, STEPS, SEED = 2, 4, 3, 2
SGD = dict(lr=0.05, momentum=0.9)
MODEL = dict(stage_sizes=(1, 1), width=8)
LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _np(tree):
    return jax.tree.map(lambda a: np.array(a, copy=True), tree)


def _batches(seed: int = SEED):
    out = []
    for i in range(STEPS):
        x, y = synthetic_classification(WORLD * B, (32, 32, 3), 10, seed=seed + i)
        out.append((x.reshape(WORLD, B, 32, 32, 3), y.reshape(WORLD, B)))
    return out


def _jax_masks(jm, params, state, rows) -> list:
    """Each ReLU's ``x > 0`` in JAX's train-mode forward of ``rows``."""
    masks = []
    relu = jax.nn.relu

    def recording_relu(x):
        jax.debug.callback(lambda v: masks.append(np.asarray(v) > 0), x, ordered=True)
        return relu(x)

    jax.nn.relu = recording_relu
    try:
        jax.jit(lambda p, s, x: jm.apply(p, s, x, train=True))(params, state, rows)
        jax.effects_barrier()
    finally:
        jax.nn.relu = relu
    return masks


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX's losses, per-step per-replica masks and final state; the two
    port ranks' results)."""
    job = tmp_path_factory.mktemp("resnet_dp")
    jm = small_resnet()
    mesh = make_mesh(MeshConfig({"data": WORLD}), jax.devices()[:WORLD])
    dp = JaxDP(jm, JaxSgd(**SGD), mesh, stacked_batches=True)
    ts = dp.create_state(seed_key(SEED))
    state = resnet_params_from_tpudml(_np(ts.params), _np(ts.model_state))
    batches = _batches()
    torch.save({"model": MODEL, "state": state, "sgd": SGD, "batches": batches},
               job / "cases.pt")
    step = dp.make_train_step()
    losses, masks = [], []
    for images, labels in batches:
        params, model_state = _np(ts.params), _np(ts.model_state)  # off the mesh
        masks.append([_jax_masks(jm, params, model_state, images[r]) for r in range(WORLD)])
        ts, m = step(ts, images, labels)
        losses.append(float(m["loss"]))
    want = dict(losses=losses, masks=masks,
                state=resnet_params_from_tpudml(_np(ts.params), _np(ts.model_state)))
    return want, torch_dist_worker.spawn("resnet", job, WORLD)


def test_relu_signs_match_jax(runs):
    want, ranks = runs
    for r, got in enumerate(ranks):
        for k, (port, jax_) in enumerate(zip(got["masks"], want["masks"])):
            assert len(port) == len(jax_[r]) > 0
            flips = [int((a != b).sum()) for a, b in zip(port, jax_[r])]
            assert not any(flips), f"rank {r} step {k}: {flips}"


def test_resnet_dp_matches_jax(runs):
    """Three SGD-momentum steps of the 2-rank port against JAX's 2-device
    engine: losses, parameters and the averaged BatchNorm buffers; the
    replicas agree bitwise."""
    want, ranks = runs
    for got in ranks:
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)
        assert set(got["state"]) == set(want["state"])
        for name, value in want["state"].items():
            np.testing.assert_allclose(got["state"][name].numpy(), value.numpy(),
                                       err_msg=name, **GRAD_TOL)
    for name, value in ranks[0]["state"].items():
        assert torch.equal(value, ranks[1]["state"][name]), name


def test_resnet_world1_equals_single_card_step_bitwise(tmp_path):
    """A one-rank gloo group: three SGD-momentum steps of the engine on
    stacked [1, 8, ...] batches equal the port's single-card step on the
    same rows bit for bit: losses, parameters and BatchNorm buffers."""
    def model():
        return ResNet(**MODEL, device="cpu", generator=torch.Generator().manual_seed(4))

    batches = [(x.reshape(1, -1, 32, 32, 3), y.reshape(1, -1)) for x, y in _batches(seed=7)]
    single = model()
    opt = Sgd(**SGD)
    step = make_train_step(single, opt)
    ts = TrainState.create(single, opt)
    want = []
    for images, labels in batches:
        ts, m = step(ts, images[0], labels[0])
        want.append(m["loss"].item())
    with process_group(DistributedConfig(coordinator_address=f"file://{tmp_path}/store"),
                       device="cpu"):
        dp_model = model()
        dp = DataParallel(dp_model, Sgd(**SGD), stacked_batches=True)
        ts = dp.create_state()
        step = dp.make_train_step()
        got = []
        for images, labels in batches:
            ts, m = step(ts, images, labels)
            got.append(m["loss"].item())
    assert got == want
    single_state = single.state_dict()
    for name, value in dp_model.state_dict().items():
        assert torch.equal(value, single_state[name]), name
