"""Gradient accumulation (``accum_steps``) against ``tpudml``'s
``accumulate_grads``, on the CPU.

The batch splits into ``accum_steps`` sequential micro-batches of
consecutive rows; gradients and metrics are their means; the model state
threads through them (BatchNorm's running statistics see every
micro-batch, in order); micro-batch ``i`` draws its dropout from the
step's key folded with ``i``. Held against JAX's step with the same
``accum_steps`` on LeNet (SGD, losses, accuracies and parameters), the
small ResNet (BatchNorm buffers), and the dropout LM (its JAX masks at
the keys ``root → step → micro → layer → salt``, as in
``tests/test_torch_dropout.py``); against the port's own full-batch step
(the same math in another summation order); and a batch that does not
divide raises JAX's ``ValueError``.

Tolerances (f32): losses rtol 1e-5; parameters and buffers ``GRAD_TOL``
(rtol 1e-4, atol 1e-6); accuracies exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from test_resnet import small_resnet  # noqa: E402
from test_torch_dropout import jax_key, jax_masks  # noqa: E402,F401
from tpudml.models import LeNet as JaxLeNet  # noqa: E402
from tpudml.models import TransformerLM as JaxLM  # noqa: E402
from tpudml.optim import Sgd as JaxSgd  # noqa: E402
from tpudml.train import TrainState as JaxTrainState  # noqa: E402
from tpudml.train import make_train_step as jax_make_train_step  # noqa: E402
from tpudml_torch.core import DistributedConfig, process_group  # noqa: E402
from tpudml_torch.core.prng import seed_key  # noqa: E402
from tpudml_torch.data import synthetic_classification, synthetic_lm  # noqa: E402
from tpudml_torch.interop import (  # noqa: E402
    lm_params_from_tpudml, resnet_params_from_tpudml, sequential_params_from_tpudml,
)
from tpudml_torch.models import LeNet, ResNet, TransformerLM  # noqa: E402
from tpudml_torch.optim import Sgd  # noqa: E402
from tpudml_torch.parallel import DataParallel  # noqa: E402
from tpudml_torch.train import TrainState, make_train_step, params_of  # noqa: E402

GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
SGD = dict(lr=0.05, momentum=0.9)

@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file's tiny tensors (several test
    workers share the machine's cores), restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _np(tree):
    return jax.tree.map(lambda a: np.array(a, copy=True), tree)


def _close(got: dict, want: dict):
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), err_msg=name,
                                   **GRAD_TOL)


def _run(jm, jparams, jstate, tm, accum, batches, rng_root=None):
    """Two SGD steps of JAX's and the port's step with ``accum``: the
    port's per-step metrics (checked against JAX's) and JAX's final
    state."""
    jts = JaxTrainState.create(jm, JaxSgd(**SGD), jax.random.key(0))
    jts = JaxTrainState(params=jparams, model_state=jstate, opt_state=jts.opt_state,
                        step=jts.step)
    jstep = jax_make_train_step(jm, JaxSgd(**SGD), accum_steps=accum,
                                rng_root=None if rng_root is None else jax_key(rng_root))
    opt = Sgd(**SGD)
    ts, step = TrainState.create(tm, opt), make_train_step(tm, opt, rng_root=rng_root,
                                                           accum_steps=accum)
    for x, y in batches:
        jts, jmet = jstep(jts, jnp.asarray(x), jnp.asarray(y))
        ts, met = step(ts, x, y)
        np.testing.assert_allclose(met["loss"].item(), float(jmet["loss"]), rtol=1e-5)
        if "accuracy" in jmet:
            assert met["accuracy"].item() == float(jmet["accuracy"])
    return jts


def _image_batches(n, shape, seed):
    return [synthetic_classification(16, shape, 10, seed=seed + i) for i in range(n)]


@pytest.mark.parametrize("accum", [1, 2, 4])
def test_lenet_accumulation_matches_jax(accum):
    jm = JaxLeNet()
    jparams, _ = jm.init(jax.random.key(4))
    tm = LeNet(device="cpu")
    tm.load_state_dict(sequential_params_from_tpudml(_np(jparams)))
    jts = _run(jm, jparams, {}, tm, accum, _image_batches(2, (28, 28, 1), seed=4))
    _close({n: p.detach() for n, p in params_of(tm).items()},
           sequential_params_from_tpudml(_np(jts.params)))


def test_accumulated_step_equals_the_full_batch_step():
    """accum_steps 4 and the one-shot step on the same 16 rows: the same
    mean gradient (another summation order), so the same update."""
    models = [LeNet(device="cpu", generator=torch.Generator().manual_seed(6)) for _ in range(2)]
    for m, accum in zip(models, (1, 4)):
        opt = Sgd(**SGD)
        ts, step = TrainState.create(m, opt), make_train_step(m, opt, accum_steps=accum)
        for x, y in _image_batches(2, (28, 28, 1), seed=6):
            ts, _ = step(ts, x, y)
    _close({n: p.detach() for n, p in params_of(models[1]).items()},
           {n: p.detach() for n, p in params_of(models[0]).items()})


BN_SEED = 0  # a seed where no ReLU input rounds to the other side of 0 (2, 3, 5 have one)


def test_batchnorm_state_threads_through_the_micro_batches(monkeypatch):
    """The small ResNet with accum_steps 2: each micro-batch normalizes by
    its own rows and moves BatchNorm's running statistics once, in order,
    as JAX's scan threads its model state. Every ReLU's sign is held
    equal to JAX's first (a flip moves a BatchNorm gradient past
    GRAD_TOL, as in ``tests/test_torch_resnet_dp.py``)."""
    jmasks, tmasks = [], []
    from tpudml_torch.nn import layers

    relu, trelu = jax.nn.relu, layers.relu

    def jrec(x):
        jax.debug.callback(lambda v: jmasks.append(np.asarray(v) > 0), x, ordered=True)
        return relu(x)

    def trec(x, *a, **kw):
        tmasks.append((x.detach() > 0).permute(0, 2, 3, 1).numpy())
        return trelu(x, *a, **kw)

    monkeypatch.setattr(jax.nn, "relu", jrec)
    monkeypatch.setattr(layers, "relu", trec)
    jm = small_resnet()
    jparams, jstate = jm.init(jax.random.key(BN_SEED))
    tm = ResNet(stage_sizes=(1, 1), width=8, device="cpu")
    tm.load_state_dict(resnet_params_from_tpudml(_np(jparams), _np(jstate)))
    jts = _run(jm, jparams, jstate, tm, 2, _image_batches(2, (32, 32, 3), seed=BN_SEED))
    jax.effects_barrier()
    assert len(tmasks) == len(jmasks) > 0
    assert not any(int((a != b).sum()) for a, b in zip(tmasks, jmasks))
    _close({k: v.detach() for k, v in tm.state_dict().items()},
           resnet_params_from_tpudml(_np(jts.params), _np(jts.model_state)))


def test_dropout_lm_accumulation_matches_jax(jax_masks):  # noqa: F811
    cfg = dict(vocab_size=64, embed_dim=32, num_heads=4, num_layers=2, max_len=16, rope=True,
               impl="flash", fused_ln=True, dropout=0.1)
    jm = JaxLM(**cfg)
    jparams, _ = jm.init(jax.random.key(5))
    tm = TransformerLM(**cfg, device="cpu")
    tm.load_state_dict(lm_params_from_tpudml(_np(jparams)))
    seqs = synthetic_lm(16, 16, 64, seed=5)
    batches = [(seqs[i:i + 4, :-1], seqs[i:i + 4, 1:]) for i in (0, 4)]
    root = seed_key(5).fold_in(0x0D0)
    jts = _run(jm, jparams, {}, tm, 2, batches, rng_root=root)
    assert [k.path for k in jax_masks[:8]] == [
        (("fold", 0x0D0), ("fold", 0), ("fold", micro), ("fold", layer), ("fold", salt))
        for micro in (0, 1) for layer in (0, 1) for salt in (1, 2)]
    _close({n: p.detach() for n, p in params_of(tm).items()},
           lm_params_from_tpudml(_np(jts.params)))


def test_indivisible_batch_raises_as_jax(tmp_path):
    x, y = synthetic_classification(10, (28, 28, 1), 10, seed=0)
    tm = LeNet(device="cpu")
    step = make_train_step(tm, Sgd(), accum_steps=4)
    with pytest.raises(ValueError, match="batch 10 not divisible by accum_steps 4"):
        step(TrainState.create(tm, Sgd()), x, y)
    with process_group(DistributedConfig(coordinator_address=f"file://{tmp_path}/store"),
                       device="cpu"):
        dp = DataParallel(tm, Sgd(), accum_steps=3, stacked_batches=False)
        with pytest.raises(ValueError, match="not divisible by accum_steps 3"):
            dp.make_train_step()(dp.create_state(), x, y)


def test_dp_world1_accumulation_equals_the_single_card_step(tmp_path):
    """DataParallel(accum_steps=2) at world 1 (a one-rank gloo group) equals
    the single-card accumulated step bitwise."""
    def model():
        return LeNet(device="cpu", generator=torch.Generator().manual_seed(8))

    single, batches = model(), _image_batches(2, (28, 28, 1), seed=8)
    opt = Sgd(**SGD)
    ts, step = TrainState.create(single, opt), make_train_step(single, opt, accum_steps=2)
    want = [step(ts, x, y)[1]["loss"].item() for x, y in batches]
    with process_group(DistributedConfig(coordinator_address=f"file://{tmp_path}/store"),
                       device="cpu"):
        m = model()
        dp = DataParallel(m, Sgd(**SGD), accum_steps=2, stacked_batches=False)
        ts, step = dp.create_state(), dp.make_train_step()
        got = [step(ts, x, y)[1]["loss"].item() for x, y in batches]
    assert got == want
    for (n, a), b in zip(params_of(m).items(), params_of(single).values()):
        assert torch.equal(a, b), n
