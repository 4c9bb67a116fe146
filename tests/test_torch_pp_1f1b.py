"""1F1B and PP×DP on the port (``tpudml_torch.parallel.pp``) against
``tpudml.parallel.pp``, on the CPU.

World 4 over gloo (``tests/torch_dist_worker.py``'s ``pp`` suite, spawned
once), from the parameters JAX's ``create_state`` drew:

- ``OneFOneB`` at four stages and M = 2, 4, 8: one step against JAX's
  (``tests/test_pp_1f1b.py:52``), and twelve steps that descend;
- ``OneFOneB`` with a dropout block (``rng_root``): every mask is JAX's
  ``bernoulli`` at the key rebuilt from the port key's fold path (step,
  stage, micro-batch, then the ``Sequential``'s split), so the loss and
  the update equal JAX's on JAX's masks (``tests/test_pp_1f1b.py:98``);
- PP×DP on ``{"data": 2, "stage": 2}`` for GPipe and 1F1B
  (``tests/test_pp_dp.py:64``) with the stage rows bitwise alike on both
  data replicas, and PP×DP under ``ZeRO1`` (Adam) against the plain PP×DP
  update and JAX's ZeRO1 run (``tests/test_zero1.py:282``), the moments
  chunked ``[1, c]`` on every rank.

At world 1 in this process: 1F1B's memory bound
(``tests/test_pp_1f1b.py:192``, on saved-for-backward bytes instead of a
jaxpr): at a fixed micro-batch of 4 rows GPipe keeps more than twice the
bytes at M = 16 than at M = 4, 1F1B the same at both.

Tolerances (f32): losses rtol 1e-5; parameters after one update
``GRAD_TOL`` (rtol 1e-4, atol 1e-6); ZeRO-1 against plain PP×DP rtol
1e-4 / atol 1e-6 after three Adam steps (JAX's test's).
"""

import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import torch_dist_worker  # noqa: E402
from tpudml.core.config import MeshConfig  # noqa: E402
from tpudml.core.dist import make_mesh  # noqa: E402
from tpudml.core.prng import seed_key  # noqa: E402
from tpudml.nn import Activation as JaxActivation  # noqa: E402
from tpudml.nn import Dense as JaxDense  # noqa: E402
from tpudml.nn import Dropout as JaxDropout  # noqa: E402
from tpudml.nn import Sequential as JaxSequential  # noqa: E402
from tpudml.optim import ZeRO1 as JaxZeRO1  # noqa: E402
from tpudml.optim import make_optimizer  # noqa: E402
from tpudml.parallel.pp import GPipe as JaxGPipe  # noqa: E402
from tpudml.parallel.pp import OneFOneB as JaxOneFOneB  # noqa: E402
from tpudml_torch.core import DistributedConfig, process_group  # noqa: E402
from tpudml_torch.core.prng import Key  # noqa: E402
from tpudml_torch.nn import Activation, Dense, Sequential  # noqa: E402
from tpudml_torch.optim import Sgd  # noqa: E402
from tpudml_torch.parallel import GPipe, OneFOneB  # noqa: E402

WIDTH, BATCH = 32, 16
LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
SGD = ("sgd", 0.05, 0.9)
DROP_ROOT, DROP_M, DROP_RATE = 7, 4, 0.5


def _np(tree):
    return jax.tree.map(lambda a: np.array(a, copy=True), tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _mesh(axes):
    n = int(np.prod(list(axes.values())))
    return make_mesh(MeshConfig(axes), jax.devices()[:n])


def jax_key(key: Key):
    """JAX's key at the place in the program the port key's path names."""
    k = jax.random.key(key.seed)
    for entry in key.path:
        if entry[0] == "fold":
            k = jax.random.fold_in(k, np.uint32(entry[1]))
        else:
            k = jax.random.split(k, entry[1])[entry[2]]
    return k


def _jax_run(cls, n_mb, axes, opt, key, batches, dropout=0.0, **kw):
    layers = [JaxDense(WIDTH, WIDTH), JaxActivation(jax.nn.relu)]
    if dropout:
        layers.append(JaxDropout(dropout))
    pipe = cls(JaxSequential(tuple(layers)), n_microbatches=n_mb, mesh=_mesh(axes),
               optimizer=opt, prologue=JaxDense(16, WIDTH), epilogue=JaxDense(WIDTH, 10), **kw)
    ts = pipe.create_state(seed_key(key))
    params0 = _np(ts.params)
    step = pipe.make_train_step()
    losses = []
    for x, y in batches:
        ts, m = step(ts, x, y)
        losses.append(float(m["loss"]))
    return params0, losses, _flat(_np(ts.params))


def _spec(engine, n_mb, mesh, params, batches, **kw):
    return dict(engine=engine, block={"kind": "mlp", "width": WIDTH}, prologue=(16, WIDTH),
                epilogue=(WIDTH, 10), M=n_mb, mesh=mesh, opt=SGD, params=params,
                batches=list(batches), **kw)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(BATCH, 16)).astype(np.float32)
    y = rng.integers(0, 10, size=(BATCH,)).astype(np.int32)
    return x, y


@pytest.fixture(scope="module")
def runs(tmp_path_factory, batch):
    x, y = batch
    job = tmp_path_factory.mktemp("pp_1f1b")
    want, cases = {}, {}
    sgd = make_optimizer("sgd", 0.05, momentum=0.9)
    s4, d2 = {"stage": 4}, {"data": 2, "stage": 2}
    for m in (2, 4, 8):
        p0, want[f"m{m}"], want[f"m{m}_params"] = _jax_run(JaxOneFOneB, m, s4, sgd, 1, [(x, y)])
        cases[f"m{m}"] = _spec("1f1b", m, s4, p0, [(x, y)])
    cases["descend"] = _spec("1f1b", 8, s4, p0, [(x, y)] * 12)
    # Dropout: the port draws JAX's mask at each key it folds.
    p0, want["drop"], want["drop_params"] = _jax_run(
        JaxOneFOneB, DROP_M, s4, sgd, 3, [(x, y)], dropout=DROP_RATE,
        rng_root=jax_key(Key(DROP_ROOT)))
    masks = {}
    for stage in range(4):
        for mi in range(DROP_M):
            key = Key(DROP_ROOT).fold_in(0).fold_in(stage).fold_in(mi).split(3, 2)
            masks[key.path] = np.array(jax.random.bernoulli(
                jax_key(key), 1.0 - DROP_RATE, (BATCH // DROP_M, WIDTH)))
    cases["drop"] = dict(_spec("1f1b", DROP_M, s4, p0, [(x, y)], rng_root=DROP_ROOT,
                               masks=masks), block={"kind": "mlp", "width": WIDTH,
                                                    "dropout": DROP_RATE})
    # PP×DP, {data: 2, stage: 2}.
    for name, cls in (("dp_gpipe", JaxGPipe), ("dp_1f1b", JaxOneFOneB)):
        p0, want[name], want[f"{name}_params"] = _jax_run(cls, 4, d2, sgd, 1, [(x, y)],
                                                          batch_axis="data")
        cases[name] = _spec(name[3:], 4, d2, p0, [(x, y)], batch_axis="data")
    adam = ("adam", 1e-3)
    zero1 = JaxZeRO1(make_optimizer("adam", 1e-3), axis_name="data", world=2)
    p0, want["zero1"], _ = _jax_run(JaxGPipe, 2, d2, zero1, 1, [(x[:8], y[:8])] * 3,
                                    batch_axis="data")
    for name, z in (("zero1", True), ("plain_adam", False)):
        cases[name] = dict(_spec("gpipe", 2, d2, p0, [(x[:8], y[:8])] * 3, batch_axis="data"),
                           opt=adam, zero1=z)
    torch.save({"pp": cases}, job / "cases.pt")
    return want, torch_dist_worker.spawn("pp", job, 4)


def _close(got: dict, want: dict, tol=GRAD_TOL):
    assert set(got) == set(want)
    for n, w in want.items():
        np.testing.assert_allclose(got[n].numpy(), w, err_msg=n, **tol)


@pytest.mark.parametrize("n_mb", [2, 4, 8])
def test_1f1b_step_matches_jax(runs, n_mb):
    want, ranks = runs
    for r in ranks:
        np.testing.assert_allclose(r[f"m{n_mb}"]["losses"], want[f"m{n_mb}"], rtol=LOSS_RTOL)
        _close(r[f"m{n_mb}"]["params"], want[f"m{n_mb}_params"])


def test_1f1b_training_descends(runs):
    _, ranks = runs
    losses = ranks[0]["descend"]["losses"]
    assert losses[-1] < losses[0]
    assert all(r["descend"]["losses"] == losses for r in ranks)


def test_1f1b_dropout_grads_exact_on_jax_masks(runs):
    want, ranks = runs
    for r in ranks:
        np.testing.assert_allclose(r["drop"]["losses"], want["drop"], rtol=LOSS_RTOL)
        _close(r["drop"]["params"], want["drop_params"])


def test_1f1b_bytes_a_tick_at_most_jax(runs):
    """JAX's 1F1B ppermutes one activation each way every tick; the port's
    ticks carry at most one message, a live one."""
    _, ranks = runs
    act = BATCH // 8 * WIDTH * 4
    for r in ranks:
        ticks = r["m8"]["tick_bytes"][0]
        assert len(ticks) == 2 * (8 + 4 - 1) and max(ticks) <= act


@pytest.mark.parametrize("name", ["dp_gpipe", "dp_1f1b"])
def test_pp_dp_matches_jax_and_replicas_agree(runs, name):
    want, ranks = runs
    for r in ranks:
        np.testing.assert_allclose(r[name]["losses"], want[name], rtol=LOSS_RTOL)
        _close(r[name]["params"], want[f"{name}_params"])
    # Ranks 0, 2 hold stage 0 and ranks 1, 3 stage 1 (row-major {data, stage}).
    assert [r[name]["stage"] for r in ranks] == [0, 1, 0, 1]
    for a, b in ((0, 2), (1, 3)):
        for n, t in ranks[a][name]["params"].items():
            assert torch.equal(t, ranks[b][name]["params"][n]), n


def test_pp_dp_zero1_matches_plain_pp_dp_and_jax(runs):
    want, ranks = runs
    for r in ranks:
        np.testing.assert_allclose(r["zero1"]["losses"], r["plain_adam"]["losses"],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(r["zero1"]["losses"], want["zero1"], rtol=LOSS_RTOL)
        for n, t in r["plain_adam"]["params"].items():
            np.testing.assert_allclose(r["zero1"]["params"][n].numpy(), t.numpy(), err_msg=n,
                                       **GRAD_TOL)
        # The stage moments are [1, c] chunks of the data group: 32·32 / 2.
        assert r["zero1"]["opt_local"]["stages.layer0.kernel"] == (1, WIDTH * WIDTH // 2)
        assert r["plain_adam"]["opt_local"]["stages.layer0.kernel"] == (1, WIDTH, WIDTH)


# ------------------------------------------------------------- world 1


class _Box:
    def __init__(self, t):
        self.t = t


class _SavedBytes:
    """The peak bytes saved for backward and alive at once (autograd's
    saved-tensor hooks; a saved tensor dies with its graph)."""

    def __init__(self):
        self.live = self.peak = 0

    def pack(self, t):
        n = t.numel() * t.element_size()
        self.live += n
        self.peak = max(self.peak, self.live)
        box = _Box(t)
        weakref.finalize(box, self._drop, n)
        return box

    def _drop(self, n):
        self.live -= n

    @staticmethod
    def unpack(box):
        return box.t


def test_1f1b_memory_bounded_by_stages(tmp_path):
    def peak(cls, n_mb):
        pipe = cls(lambda g: Sequential((Dense(WIDTH, WIDTH, generator=g), Activation())), n_mb,
                   optimizer=Sgd(lr=0.05), prologue=Dense(16, WIDTH),
                   epilogue=Dense(WIDTH, 10))
        ts, step = pipe.create_state(0), pipe.make_train_step()
        rng = np.random.default_rng(3)
        x = rng.normal(size=(4 * n_mb, 16)).astype(np.float32)
        y = rng.integers(0, 10, size=(4 * n_mb,))
        meter = _SavedBytes()
        with torch.autograd.graph.saved_tensors_hooks(meter.pack, meter.unpack):
            step(ts, x, y)
        return meter.peak

    with process_group(DistributedConfig(coordinator_address=f"file://{tmp_path}/store",
                                         num_processes=1), device="cpu"):
        sizes = {"gpipe4": peak(GPipe, 4), "gpipe16": peak(GPipe, 16),
                 "f1b4": peak(OneFOneB, 4), "f1b16": peak(OneFOneB, 16)}
    assert sizes["gpipe16"] > 2 * sizes["gpipe4"], sizes
    assert sizes["f1b4"] == sizes["f1b16"] < sizes["gpipe4"], sizes
