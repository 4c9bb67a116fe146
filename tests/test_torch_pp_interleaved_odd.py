"""Interleaved 1F1B on the port at an ODD number of stages, against
``tpudml.parallel.pp.Interleaved1F1B`` on the CPU (gloo ranks of
``tests/torch_dist_worker.py``'s ``pp`` suite: one spawn at world 3 and
one at world 5).

JAX ships each direction's parity class of chunks at odd S (2·⌈V/2⌉
activation slots a tick, the ring wrap flipping the sender's parity); the
port sends the live slots of a tick to each neighbour as one message:

- (S, V) = (3, 2) and (5, 2) at M = 4: one step against JAX's
  (``tests/test_pp_interleaved.py:97``), and each tick's bytes at most
  JAX's per-tick ppermute bytes (``_step_ppermute_bytes`` of
  ``tests/test_pp_interleaved.py``);
- (3, 2) with a dropout block (``rng_root``): every mask is JAX's
  ``bernoulli`` at the key rebuilt from the port key's fold path (step,
  virtual stage σ = v·S + s, micro-batch, the ``Sequential``'s split), so
  the loss and the update equal JAX's on JAX's masks.

Tolerances (f32): losses rtol 1e-5; parameters after one update
``GRAD_TOL`` (rtol 1e-4, atol 1e-6).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import torch_dist_worker  # noqa: E402
from test_torch_pp_interleaved import BATCH, WIDTH, jax_case  # noqa: E402
from tpudml.core.config import MeshConfig  # noqa: E402
from tpudml.core.dist import make_mesh  # noqa: E402
from tpudml.core.prng import seed_key  # noqa: E402
from tpudml.nn import Activation as JaxActivation  # noqa: E402
from tpudml.nn import Dense as JaxDense  # noqa: E402
from tpudml.nn import Dropout as JaxDropout  # noqa: E402
from tpudml.nn import Sequential as JaxSequential  # noqa: E402
from tpudml.optim import make_optimizer  # noqa: E402
from tpudml.parallel.pp import Interleaved1F1B as JaxInterleaved  # noqa: E402
from tpudml_torch.core.prng import Key  # noqa: E402

LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
M = 4


def jax_key(key: Key):
    k = jax.random.key(key.seed)
    for entry in key.path:
        if entry[0] == "fold":
            k = jax.random.fold_in(k, np.uint32(entry[1]))
        else:
            k = jax.random.split(k, entry[1])[entry[2]]
    return k


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _dropout_case(x, y, want):
    """(3, 2) with Dropout(0.5) in the block: JAX's step, and the port's
    case drawing JAX's masks."""
    s, v = 3, 2
    pipe = JaxInterleaved(
        JaxSequential((JaxDense(WIDTH, WIDTH), JaxActivation(jax.nn.relu), JaxDropout(0.5))),
        n_microbatches=M, mesh=make_mesh(MeshConfig({"stage": s}), jax.devices()[:s]),
        optimizer=make_optimizer("sgd", 0.05, momentum=0.9), prologue=JaxDense(12, WIDTH),
        epilogue=JaxDense(WIDTH, 10), v_chunks=v, rng_root=jax_key(Key(7)))
    ts = pipe.create_state(seed_key(3))
    p0 = jax.tree.map(lambda a: np.array(a, copy=True), ts.params)
    ts, m = pipe.make_train_step()(ts, x, y)
    want["drop"] = [float(m["loss"])]
    want["drop_params"] = _flat(jax.tree.map(np.asarray, ts.params))
    masks = {}
    for sigma in range(s * v):
        for mi in range(M):
            key = Key(7).fold_in(0).fold_in(sigma).fold_in(mi).split(3, 2)
            masks[key.path] = np.array(jax.random.bernoulli(jax_key(key), 0.5,
                                                            (BATCH // M, WIDTH)))
    return dict(engine="interleaved", block={"kind": "mlp", "width": WIDTH, "dropout": 0.5},
                prologue=(12, WIDTH), epilogue=(WIDTH, 10), M=M, v=v, mesh={"stage": s},
                opt=("sgd", 0.05, 0.9), params=p0, batches=[(x, y)], rng_root=7, masks=masks)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    rng = np.random.default_rng(11)
    x = rng.normal(size=(BATCH, 12)).astype(np.float32)
    y = rng.integers(0, 10, size=(BATCH,)).astype(np.int32)
    want, out = {}, {}
    for world, grid in ((3, ((3, 2),)), (5, ((5, 2),))):
        job = tmp_path_factory.mktemp(f"pp_odd{world}")
        cases = {f"s{s}v{v}": jax_case({"stage": s}, M, v, x, y, want, f"s{s}v{v}")
                 for s, v in grid}
        if world == 3:
            cases["drop"] = _dropout_case(x, y, want)
        torch.save({"pp": cases}, job / "cases.pt")
        ranks = torch_dist_worker.spawn("pp", job, world)
        out.update((name, [r[name] for r in ranks]) for name in cases)
    return want, out


@pytest.mark.parametrize("name", ["s3v2", "s5v2", "drop"])
def test_update_matches_jax(runs, name):
    want, out = runs
    for s, r in enumerate(out[name]):
        assert r["stage"] == s
        np.testing.assert_allclose(r["losses"], want[name], rtol=LOSS_RTOL)
        for n, w in want[f"{name}_params"].items():
            np.testing.assert_allclose(r["params"][n].numpy(), w, err_msg=n, **GRAD_TOL)


@pytest.mark.parametrize("name", ["s3v2", "s5v2"])
def test_bytes_a_tick_at_most_jax(runs, name):
    """JAX: 2·⌈V/2⌉ activation slots a tick at odd S; the port: its live
    slots, never more."""
    want, out = runs
    s, v = int(name[1]), int(name[3])
    act = BATCH // M * WIDTH * 4
    assert want[f"{name}_tick"] == 2 * ((v + 1) // 2) * act
    for r in out[name]:
        ticks = r["tick_bytes"][0]
        assert len(ticks) == 2 * (M + v * s - 1)
        assert max(ticks) <= want[f"{name}_tick"]

