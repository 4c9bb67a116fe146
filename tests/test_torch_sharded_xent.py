"""The vocab-sharded fused head (``sharded_linear_cross_entropy``,
``train.make_lm_fused_sharded_loss_fn``, ``GSPMDParallel(fused_xent=True)``)
against ``tpudml``, on the CPU (``tests/test_fused_compose.py``'s cases).

- World 4 over gloo (``tests/torch_dist_worker.py``'s ``sharded_xent``
  suite): the op under tensor parallelism {model 4}, 1-D FSDP {data 4}
  (the tokens gathered over the vocab axis first, dX reduce-scattered
  back) and FSDP×TP {data 2, model 2} (a data mean of the token means),
  saved scores and lean, one label out of range: the loss and the full
  dX, dW, db equal JAX's UNSHARDED ``linear_cross_entropy``. Both of the
  port's routes run: the plain one CPU tensors take
  (``sharded_xent_reference``) and the kernels' autograd function on their
  plain versions (the route CUDA tensors take, its merged lse and its
  gradient scale included).
- The engines fused against unfused on the small LM (SGD, three steps):
  TP, FSDP (at a vocabulary of 64, so that FSDP splits the head's
  vocabulary, not its width: the vocab axis is the batch axis), FSDP×TP
  and TP at a vocabulary of 34 that 4 does not divide (the head demoted,
  the plain fused kernel on the gathered head), through both routes;
  each run's wire bytes.
- ``save_s=None`` resolves on the LOCAL vocabulary.

Tolerances (f32): loss rtol 1e-6 and gradients rtol 1e-5 / atol 1e-6 for
the op (JAX's own sharded-kernel test's); the engines' losses rtol 1e-5
and parameters ``GRAD_TOL`` (rtol 1e-4, atol 1e-6).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

import torch_dist_worker  # noqa: E402
from tpudml.core.prng import seed_key  # noqa: E402
from tpudml.models import TransformerLM as JaxLM  # noqa: E402
from tpudml.ops.xent_kernel import linear_cross_entropy as jax_lxe  # noqa: E402
from tpudml_torch.core import DistributedConfig, process_group  # noqa: E402
from tpudml_torch.data import synthetic_lm  # noqa: E402
from tpudml_torch.interop import lm_params_from_tpudml  # noqa: E402
from tpudml_torch.ops import xent_kernel as xk  # noqa: E402

N, D, V = 16, 8, 64
LM = dict(vocab_size=32, embed_dim=32, num_heads=4, num_layers=1, max_len=16)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
OP_GRAD_TOL = dict(rtol=1e-5, atol=1e-6)


def _np(tree):
    return jax.tree.map(lambda a: np.array(a, copy=True), tree)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    job = tmp_path_factory.mktemp("sharded_xent")
    rng = np.random.default_rng(0)
    x = rng.normal(size=(N, D)).astype(np.float32)
    w = rng.normal(size=(D, V)).astype(np.float32)
    b = rng.normal(size=(V,)).astype(np.float32)
    labels = rng.integers(0, V, size=(N,)).astype(np.int32)
    labels[3] = V + 5  # out of range: the row's loss is its lse
    lr, gr = jax.value_and_grad(lambda x, w, b: jax_lxe(x, w, jnp.asarray(labels), b),
                                argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    case = {"x": x, "w": w, "b": b, "labels": labels.astype(np.int64)}
    for key, vocab in (("lm", 32), ("lm34", 34), ("lm64", 64)):
        cfg = dict(LM, vocab_size=vocab)
        params, _ = JaxLM(**cfg).init(seed_key(2))
        seqs = synthetic_lm(8, 16, vocab, seed=3)
        case.update({key: cfg, f"{key}_state": lm_params_from_tpudml(_np(params)),
                     f"{key}_tokens": seqs[:, :-1], f"{key}_labels": seqs[:, 1:]})
    torch.save(case, job / "cases.pt")
    ranks = torch_dist_worker.spawn("sharded_xent", job, 4)
    return (float(lr), [np.asarray(g) for g in gr]), ranks


@pytest.mark.parametrize("route", ["plain", "kernels"])
@pytest.mark.parametrize("save_s", [False, True], ids=["lean", "saved"])
@pytest.mark.parametrize("layout", ["tp", "fsdp", "fsdp_tp"])
def test_sharded_op_matches_jax_unsharded(runs, layout, save_s, route):
    (lr, gr), ranks = runs
    for got in ranks:
        loss, grads = got[f"{layout}/{route}/{save_s}"]
        np.testing.assert_allclose(loss, lr, rtol=1e-6)
        for g, want, name in zip(grads, gr, ("dx", "dw", "db")):
            np.testing.assert_allclose(g.numpy(), want, err_msg=name, **OP_GRAD_TOL)


@pytest.mark.parametrize("route", ["fused", "fused_kernels"])
@pytest.mark.parametrize("engine", ["tp", "fsdp", "fsdp_tp", "tp_v34"])
def test_engine_fused_trains_the_unfused_trajectory(runs, engine, route):
    _, ranks = runs
    for got in ranks:
        fused, unfused = got[f"engine/{engine}/{route}"], got[f"engine/{engine}/unfused"]
        np.testing.assert_allclose(fused["losses"], unfused["losses"], rtol=1e-5)
        for n, t in unfused["params"].items():
            np.testing.assert_allclose(fused["params"][n].numpy(), t.numpy(), err_msg=n,
                                       **GRAD_TOL)
    spec = ranks[0][f"engine/{engine}/{route}"]["head_spec"]
    assert spec == {"tp": (None, "model"), "fsdp": (None, "data"),
                    "fsdp_tp": ("data", "model"), "tp_v34": (None, None)}[engine]


def test_fused_head_wire_bytes(runs):
    """Ring-model bytes into a rank a step (``step_wire_bytes``), TP at world
    4: the fused head no longer gathers its [32, 8] kernel and [8] bias
    blocks (3 × 1024 + 3 × 32 bytes) and moves instead dX's all-reduce
    (128 rows × 32 × 4 bytes: 2 × 16384 × 3/4) and the three merges of
    the rows' statistics (3 × 2 × 512 × 3/4)."""
    _, ranks = runs
    for route in ("fused", "fused_kernels"):
        run = ranks[0][f"engine/tp/{route}"]
        assert run["head_wire"] == 24576 + 2304
        assert run["wire"] - ranks[0]["engine/tp/unfused"]["wire"] == 24576 + 2304 - 3072 - 96


def test_save_s_auto_resolves_on_the_local_vocab(tmp_path, monkeypatch):
    """A 16640 × 32768 head is lean unsharded (one padded block row past
    2 GiB) and saved at 4 shards of 8192 columns; the op hands the auto
    rule its LOCAL vocabulary (a one-rank group holding an 8-column
    shard)."""
    bn, bv = 256, 2048
    assert xk._auto_save_s(16640, 32768, bn, bv) is False
    _, _, n_pad, v_pad = xk._padded_dims(16640, 32768, bn, bv)
    assert (n_pad - bn) * v_pad * 4 == xk.SAVE_S_AUTO_MAX_BYTES
    assert xk._auto_save_s(16640, 32768 // 4, bn, bv) is True
    seen = []
    real = xk._auto_save_s
    monkeypatch.setattr(xk, "_auto_save_s",
                        lambda n, v, block_n, block_v: seen.append((n, v)) or real(n, v, block_n,
                                                                                   block_v))
    cfg = DistributedConfig(coordinator_address=f"file://{tmp_path}/store")
    with process_group(cfg, device="cpu"):
        loss = xk.sharded_linear_cross_entropy(torch.zeros(8, 4), torch.zeros(4, 8),
                                               torch.zeros(8, dtype=torch.long), group=None)
    assert seen == [(8, 8)] and float(loss) == pytest.approx(np.log(8))


@pytest.mark.parametrize("save_s", [False, True], ids=["lean", "saved"])
@pytest.mark.parametrize("shards", [2, 4])
def test_vocab_shards_in_one_process_match_jax_unsharded(runs, shards, save_s):
    """The op's per-shard halves composed in one process (what the card's
    check runs, here on the kernels' plain versions): shifted labels, one
    of them past V, the lse merged by logsumexp; loss, dX summed over the
    shards and dW, db concatenated equal JAX's unsharded head."""
    (lr, gr), _ = runs
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(N, D)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(D, V)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(V,)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, V, size=(N,)).astype(np.int32))
    labels[3] = V + 5
    loss, dx, dw, db = xk.sharded_xent_in_one_process(x, w, b, labels, shards, save_s)
    np.testing.assert_allclose(float(loss), lr, rtol=1e-6)
    for g, want, name in zip((dx, dw, db), gr, ("dx", "dw", "db")):
        np.testing.assert_allclose(g.numpy(), want, err_msg=name, **OP_GRAD_TOL)
