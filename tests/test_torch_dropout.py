"""Dropout and its keys against ``tpudml``, on the CPU.

The port draws every dropout mask through one function,
``tpudml_torch.nn.layers.dropout_mask``, from a generator seeded by the
key's fold path; JAX draws ``bernoulli`` from its threefry key. The
parity tests replace that one function by JAX's draw at the JAX key
rebuilt from the port key's path (:func:`jax_key`), so the port's masks
are JAX's, and hold to the f32 contract: the ``Dropout`` layer and its
per-layer key split in ``Sequential``; the transformer's branch dropout
(per-layer fold ``i``, salts 1 and 2) in the unfused trunk and in the
deferred fused add+LN trunk (the plain versions of kernels 1–3, 8, 9)
under the single-card step, the fused-head step and ``DataParallel`` at
world 1 (``tests/test_torch_labs_dp.py`` runs two ranks). The port's
own draws are held by their statistics and determinism.

Tolerances (f32): losses rtol 1e-5; outputs rtol 1e-5 / atol 1e-6;
gradients and parameters after three GD steps ``GRAD_TOL`` (rtol 1e-4,
atol 1e-6), the contract of ``tests/test_torch_train.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from tpudml.core.config import MeshConfig  # noqa: E402
from tpudml.core.dist import make_mesh  # noqa: E402
from tpudml.models import TransformerLM as JaxLM  # noqa: E402
from tpudml.nn import Dense as JaxDense  # noqa: E402
from tpudml.nn import Dropout as JaxDropout  # noqa: E402
from tpudml.nn import Sequential as JaxSequential  # noqa: E402
from tpudml.optim import GradientDescent as JaxGD  # noqa: E402
from tpudml.parallel.dp import DataParallel as JaxDP  # noqa: E402
from tpudml.train import TrainState as JaxTrainState  # noqa: E402
from tpudml.train import make_lm_fused_train_step as jax_fused_step  # noqa: E402
from tpudml.train import make_train_step as jax_make_train_step  # noqa: E402
from tpudml_torch.core import DistributedConfig, process_group  # noqa: E402
from tpudml_torch.core.prng import Key, seed_key  # noqa: E402
from tpudml_torch.data import synthetic_lm  # noqa: E402
from tpudml_torch.interop import lm_params_from_tpudml, sequential_params_from_tpudml  # noqa: E402
from tpudml_torch.models import TransformerLM  # noqa: E402
from tpudml_torch.nn import Dense, Dropout, Sequential, layers  # noqa: E402
from tpudml_torch.optim import GradientDescent  # noqa: E402
from tpudml_torch.parallel import DataParallel  # noqa: E402
from tpudml_torch.tasks import task5_longcontext as task5  # noqa: E402
from tpudml_torch.train import (  # noqa: E402
    TrainState, make_lm_fused_train_step, make_train_step, params_of,
)

CFG = dict(vocab_size=64, embed_dim=32, num_heads=4, num_layers=2, max_len=16, rope=True)
B, T, RATE = 4, 16, 0.1
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
OUT_TOL = dict(rtol=1e-5, atol=1e-6)

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


def jax_key(key: Key):
    """JAX's key at the place in the program the port key's path names."""
    k = jax.random.key(key.seed)
    for entry in key.path:
        if entry[0] == "fold":
            k = jax.random.fold_in(k, np.uint32(entry[1]))
        else:
            k = jax.random.split(k, entry[1])[entry[2]]
    return k


@pytest.fixture
def jax_masks(monkeypatch):
    """Every port mask is JAX's ``bernoulli`` at the rebuilt key; yields the
    keys drawn, in order."""
    drawn = []

    def mask(key, keep, shape, device):
        drawn.append(key)
        m = jax.random.bernoulli(jax_key(key), keep, tuple(shape))
        return torch.from_numpy(np.array(m)).to(device)

    monkeypatch.setattr(layers, "dropout_mask", mask)
    return drawn


# ------------------------------------------------------------- the layer


def test_dropout_layer_modes_and_missing_key():
    x = torch.randn(3, 5)
    d = Dropout(0.5)
    d.eval()
    assert d(x) is x
    d.train()
    assert Dropout(0.0)(x) is x
    with pytest.raises(ValueError, match="requires an rng"):
        d(x)
    y = d(x, key=seed_key(1))
    kept = y != 0
    torch.testing.assert_close(y[kept], (x / 0.5)[kept], rtol=0, atol=0)


def test_sequential_splits_its_key_per_layer_as_jax(jax_masks):
    """Dense → Dropout(0.3) → Dense → Dropout(0.5): each Dropout's key is
    ``split(key, 4)[i]``, so the forward and gradients are JAX's."""
    jm = JaxSequential((JaxDense(6, 8), JaxDropout(0.3), JaxDense(8, 5), JaxDropout(0.5)))
    params, _ = jm.init(jax.random.key(0))
    tm = Sequential([Dense(6, 8), Dropout(0.3), Dense(8, 5), Dropout(0.5)])
    tm.load_state_dict(sequential_params_from_tpudml(_np(params)))
    x = np.random.default_rng(0).normal(size=(7, 6)).astype(np.float32)
    key = seed_key(5).fold_in(3)

    def jloss(p):
        y = jm.apply(p, {}, jnp.asarray(x), train=True, rng=jax_key(key))[0]
        return jnp.sum(y * y), y

    (_, jy), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    y = tm(torch.from_numpy(x), key=key)
    grads = torch.autograd.grad((y * y).sum(), list(params_of(tm).values()))
    assert [k.path[-1] for k in jax_masks] == [("split", 4, 1), ("split", 4, 3)]
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **OUT_TOL)
    want = sequential_params_from_tpudml(_np(jg))
    for name, g in zip(params_of(tm), grads):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), err_msg=name, **GRAD_TOL)


# ------------------------------------------------------- the port's draws


def test_port_masks_keep_their_share_and_repeat():
    """The port's own draws (no patch): a key's mask repeats bitwise; the
    keep share of 10⁶ draws lies within 6σ of the binomial's; other
    steps, ranks and salts draw other masks."""
    shape, keep = (1000, 1000), 0.9
    key = seed_key(3).fold_in(0x0D0).fold_in(7)
    m = layers.dropout_mask(key, keep, shape, "cpu")
    assert m.dtype == torch.bool and m.shape == shape
    assert torch.equal(m, layers.dropout_mask(key, keep, shape, "cpu"))
    n = m.numel()
    sigma = (keep * (1 - keep) / n) ** 0.5
    assert abs(m.float().mean().item() - keep) < 6 * sigma
    for other in (key.fold_in(0), seed_key(3).fold_in(0x0D0).fold_in(8), key.fold_in(1)):
        assert not torch.equal(m, layers.dropout_mask(other, keep, shape, "cpu"))


# ---------------------------------------------------------- the LM steps


def _pair(impl, fused_ln, seed):
    jm = JaxLM(**CFG, impl=impl, fused_ln=fused_ln, dropout=RATE)
    params, _ = jm.init(jax.random.key(seed))
    tm = TransformerLM(**CFG, impl=impl, fused_ln=fused_ln, dropout=RATE, device="cpu")
    tm.load_state_dict(lm_params_from_tpudml(_np(params)))
    return jm, params, tm


def _batches(n, seed):
    seqs = synthetic_lm(4 * B, T, CFG["vocab_size"], seed=seed)
    rng = np.random.default_rng(seed)
    return [seqs[rng.integers(0, len(seqs), size=B)] for _ in range(n)]


def _gd_state(params):
    return JaxTrainState(params=params, model_state={}, opt_state=(),
                         step=jnp.zeros((), jnp.int32))


def _compare(tm, jts_params):
    want = lm_params_from_tpudml(_np(jts_params))
    for name, p in params_of(tm).items():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), err_msg=name,
                                   **GRAD_TOL)


TRUNKS = [("full", False), ("flash", True)]


@pytest.mark.parametrize("impl,fused_ln", TRUNKS, ids=["unfused", "fused_add_ln"])
@pytest.mark.parametrize("head", ["logits", "fused_xent"])
def test_single_card_dropout_steps_match_jax(jax_masks, impl, fused_ln, head):
    """Three GD steps with dropout 0.1 and task5's ``rng_root``
    (``key(seed ^ 0xD0)``): 2 layers × 2 salts = 4 masks a step, at the
    keys ``root → step → layer → salt``."""
    jm, params, tm = _pair(impl, fused_ln, seed=1)
    root = seed_key(1 ^ 0xD0)
    if head == "logits":
        jstep = jax_make_train_step(jm, JaxGD(lr=0.05), rng_root=jax_key(root))
        step = make_train_step(tm, GradientDescent(lr=0.05), rng_root=root)
    else:
        jstep = jax_fused_step(jm, JaxGD(lr=0.05), rng_root=jax_key(root))
        step = make_lm_fused_train_step(tm, GradientDescent(lr=0.05), rng_root=root)
    jts, ts = _gd_state(params), TrainState.create(tm, GradientDescent(lr=0.05))
    for batch in _batches(3, seed=1):
        jts, jmet = jstep(jts, jnp.asarray(batch[:, :-1]), jnp.asarray(batch[:, 1:]))
        ts, met = step(ts, batch[:, :-1], batch[:, 1:])
        np.testing.assert_allclose(met["loss"].item(), float(jmet["loss"]), rtol=1e-5)
    assert [k.path for k in jax_masks[:4]] == [
        (("fold", 0), ("fold", layer), ("fold", salt)) for layer in (0, 1) for salt in (1, 2)]
    assert len(jax_masks) == 12
    _compare(tm, jts.params)


def test_dropout_off_changes_nothing():
    """Dropout 0 with a key is the step without one, bitwise."""
    a = TransformerLM(**CFG, impl="flash", fused_ln=True, device="cpu")
    b = TransformerLM(**CFG, impl="flash", fused_ln=True, device="cpu")
    sa = make_train_step(a, GradientDescent(lr=0.05), rng_root=seed_key(0xD0))
    sb = make_train_step(b, GradientDescent(lr=0.05))
    ta, tb = TrainState.create(a, GradientDescent()), TrainState.create(b, GradientDescent())
    for batch in _batches(2, seed=2):
        ta, ma = sa(ta, batch[:, :-1], batch[:, 1:])
        tb, mb = sb(tb, batch[:, :-1], batch[:, 1:])
        assert ma["loss"].item() == mb["loss"].item()
    for (n, p), q in zip(params_of(a).items(), params_of(b).values()):
        assert torch.equal(p, q), n


def test_dp_world1_dropout_matches_jax(jax_masks, tmp_path):
    """DataParallel at world 1 with ``rng_root``: the replica's key is
    ``root → step → rank 0``, as JAX's one-device mesh folds its axis
    index."""
    jm, params, tm = _pair("flash", True, seed=3)
    root = seed_key(3 ^ 0xD0)
    mesh = make_mesh(MeshConfig({"data": 1}), jax.devices()[:1])
    jdp = JaxDP(jm, JaxGD(lr=0.05), mesh, rng_root=jax_key(root), stacked_batches=False)
    jts = _gd_state(params)
    jstep = jdp.make_train_step()
    with process_group(DistributedConfig(coordinator_address=f"file://{tmp_path}/store"),
                       device="cpu"):
        dp = DataParallel(tm, GradientDescent(lr=0.05), rng_root=root, stacked_batches=False)
        ts, step = dp.create_state(), dp.make_train_step()
        for batch in _batches(3, seed=3):
            jts, jmet = jstep(jts, batch[:, :-1], batch[:, 1:])
            ts, met = step(ts, batch[:, :-1], batch[:, 1:])
            np.testing.assert_allclose(met["loss"].item(), float(jmet["loss"]), rtol=1e-5)
    assert jax_masks[0].path == (("fold", 0), ("fold", 0), ("fold", 0), ("fold", 1))
    _compare(tm, jts.params)


def test_dropout_model_in_training_needs_a_key():
    tm = TransformerLM(**CFG, dropout=RATE, device="cpu")
    tokens = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="requires an rng"):
        tm(tokens)
    tm.eval()
    tm(tokens)  # evaluation draws nothing


def test_task5_dropout_cli_learns_and_off_is_unchanged(tmp_path, capsys):
    """task5 ``--dropout 0.1`` (single and a one-rank dp, whose replica
    folds its rank into the key and so draws other masks) learns the
    successor task; ``--dropout 0`` prints the loss it always did."""
    argv = ["--device", "cpu", "--vocab", "32", "--embed_dim", "32", "--num_heads", "4",
            "--num_layers", "2", "--seq_len", "32", "--steps", "60", "--lr", "0.01",
            "--attn", "flash", "--fused_ln", "--rope", "--log_dir", str(tmp_path)]
    single = task5.main(argv + ["--dropout", "0.1"])
    dp = task5.main(argv + ["--dropout", "0.1", "--parallel", "dp"])
    off = task5.main(argv)
    capsys.readouterr()
    assert single["final_loss"] < 0.5 and np.isfinite(single["final_loss"])
    assert dp["final_loss"] < 0.5 and dp["final_loss"] != single["final_loss"]
    assert f"{off['final_loss']:.4f}" == "0.0043"  # the documented run without dropout
    with pytest.raises(Exception, match="dropout"):
        task5.main(argv + ["--dropout", "0.1", "--parallel", "ep", "--moe_experts", "4"])
