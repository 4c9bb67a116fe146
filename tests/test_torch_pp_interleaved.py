"""Interleaved (virtual-stage) 1F1B on the port against
``tpudml.parallel.pp.Interleaved1F1B``, on the CPU, at an even number of
stages (four ranks over gloo, ``tests/torch_dist_worker.py``'s ``pp``
suite, spawned once; odd S: ``tests/test_torch_pp_interleaved_odd.py``).

Block σ = v·S + s lives on stage s as chunk v; each rank holds its
``[1, V, ...]`` row. From the parameters JAX's ``create_state`` drew:

- (S, V) = (4, 2) and (4, 3) at M = 4, and (4, 2) at M = 8: one step
  against JAX's (``tests/test_pp_interleaved.py:58``);
- the bytes a rank sends each tick: at most JAX's per-tick ppermute
  bytes, counted by ``tests/test_pp_interleaved.py``'s
  ``_step_ppermute_bytes`` (V activation slots a tick at even S);
- PP×DP on ``{"data": 2, "stage": 2}`` (``tests/test_pp_interleaved.py:
  213``);
- dropout (``rng_root``): eight steps that descend
  (``tests/test_pp_interleaved.py:187``); at world 1 a dropout block
  without ``rng_root`` is rejected with JAX's wording.

Tolerances (f32): losses rtol 1e-5; parameters after one update
``GRAD_TOL`` (rtol 1e-4, atol 1e-6).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import torch_dist_worker  # noqa: E402
from test_pp_interleaved import _step_ppermute_bytes  # noqa: E402
from tpudml.core.config import MeshConfig  # noqa: E402
from tpudml.core.dist import make_mesh  # noqa: E402
from tpudml.core.prng import seed_key  # noqa: E402
from tpudml.nn import Activation as JaxActivation  # noqa: E402
from tpudml.nn import Dense as JaxDense  # noqa: E402
from tpudml.nn import Sequential as JaxSequential  # noqa: E402
from tpudml.optim import make_optimizer  # noqa: E402
from tpudml.parallel.pp import Interleaved1F1B as JaxInterleaved  # noqa: E402
from tpudml_torch.core import DistributedConfig, process_group  # noqa: E402
from tpudml_torch.nn import Activation, Dense, Dropout, Sequential  # noqa: E402
from tpudml_torch.optim import Sgd  # noqa: E402
from tpudml_torch.parallel import Interleaved1F1B  # noqa: E402

WIDTH, BATCH = 24, 16
LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
SGD = ("sgd", 0.05, 0.9)


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


def jax_pipe(axes, n_mb, v, **kw):
    n = int(np.prod(list(axes.values())))
    return JaxInterleaved(JaxSequential((JaxDense(WIDTH, WIDTH), JaxActivation(jax.nn.relu))),
                          n_microbatches=n_mb, mesh=make_mesh(MeshConfig(axes), jax.devices()[:n]),
                          optimizer=make_optimizer("sgd", 0.05, momentum=0.9),
                          prologue=JaxDense(12, WIDTH), epilogue=JaxDense(WIDTH, 10),
                          v_chunks=v, **kw)


def jax_case(axes, n_mb, v, x, y, want, name, **kw):
    """Run JAX's step, record its loss, parameters and per-tick ppermute
    bytes in ``want``; return the port's case."""
    pipe = jax_pipe(axes, n_mb, v, **kw)
    ts = pipe.create_state(seed_key(1))
    p0 = _np(ts.params)
    ts, m = pipe.make_train_step()(ts, x, y)
    want[name] = [float(m["loss"])]
    want[f"{name}_params"] = _flat(_np(ts.params))
    if "batch_axis" not in kw:
        n_ticks = 2 * (n_mb + v * axes["stage"] - 1)
        want[f"{name}_tick"] = _step_ppermute_bytes(jax_pipe(axes, n_mb, v), x, y) / n_ticks
    return dict(engine="interleaved", block={"kind": "mlp", "width": WIDTH},
                prologue=(12, WIDTH), epilogue=(WIDTH, 10), M=n_mb, v=v, mesh=axes, opt=SGD,
                params=p0, batches=[(x, y)], **kw)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(11)
    x = rng.normal(size=(BATCH, 12)).astype(np.float32)
    y = rng.integers(0, 10, size=(BATCH,)).astype(np.int32)
    return x, y


@pytest.fixture(scope="module")
def runs(tmp_path_factory, batch):
    x, y = batch
    job = tmp_path_factory.mktemp("pp_interleaved")
    want, cases = {}, {}
    s4 = {"stage": 4}
    for n_mb, v in ((4, 2), (4, 3), (8, 2)):
        cases[f"m{n_mb}v{v}"] = jax_case(s4, n_mb, v, x, y, want, f"m{n_mb}v{v}")
    cases["dp"] = jax_case({"data": 2, "stage": 2}, 2, 2, x, y, want, "dp", batch_axis="data")
    cases["drop"] = dict(cases["m4v2"], block={"kind": "mlp", "width": WIDTH, "dropout": 0.2},
                         rng_root=7, batches=[(x, y)] * 8)
    torch.save({"pp": cases}, job / "cases.pt")
    return want, torch_dist_worker.spawn("pp", job, 4)


@pytest.mark.parametrize("name", ["m4v2", "m4v3", "m8v2", "dp"])
def test_update_matches_jax(runs, name):
    want, ranks = runs
    for r in ranks:
        np.testing.assert_allclose(r[name]["losses"], want[name], rtol=LOSS_RTOL)
        got = r[name]["params"]
        assert set(got) == set(want[f"{name}_params"])
        for n, w in want[f"{name}_params"].items():
            np.testing.assert_allclose(got[n].numpy(), w, err_msg=n, **GRAD_TOL)


def test_each_rank_holds_its_chunks(runs):
    _, ranks = runs
    for s, r in enumerate(ranks):
        assert r["m4v3"]["stage"] == s
        assert r["m4v3"]["local"]["stages.layer0.kernel"] == (1, 3, WIDTH, WIDTH)


@pytest.mark.parametrize("name", ["m4v2", "m4v3", "m8v2"])
def test_bytes_a_tick_at_most_jax(runs, name):
    """Every tick, every rank: at most what JAX's ppermutes carry (V
    activation slots at even S). The port sends live slots only."""
    want, ranks = runs
    n_mb, v = int(name[1]), int(name[3])
    act = BATCH // n_mb * WIDTH * 4
    assert want[f"{name}_tick"] == v * act
    for r in ranks:
        ticks = r[name]["tick_bytes"][0]
        assert len(ticks) == 2 * (n_mb + v * 4 - 1)
        assert max(ticks) <= want[f"{name}_tick"]


def test_training_descends_with_dropout(runs):
    _, ranks = runs
    losses = ranks[0]["drop"]["losses"]
    assert losses[-1] < losses[0]
    assert all(r["drop"]["losses"] == losses for r in ranks)


def test_dropout_without_rng_rejected(tmp_path):
    with process_group(DistributedConfig(coordinator_address=f"file://{tmp_path}/store",
                                         num_processes=1), device="cpu"):
        pipe = Interleaved1F1B(
            lambda g: Sequential((Dense(WIDTH, WIDTH, generator=g), Activation(), Dropout(0.5))),
            4, optimizer=Sgd(lr=0.05), prologue=Dense(12, WIDTH), epilogue=Dense(WIDTH, 10),
            v_chunks=2)
        with pytest.raises(ValueError, match="rng_root"):
            pipe.init_params(0)
        with pytest.raises(ValueError, match="v_chunks 0 must be >= 1"):
            Interleaved1F1B(lambda g: Dense(WIDTH, WIDTH, generator=g), 4, device="cpu",
                            v_chunks=0)
