"""task2 and task3 on two ranks against ``tpudml``'s, on the CPU.

Two processes over gloo (``tests/torch_dist_worker.py``'s ``labs``
suite) train the port's ``DataParallel``; the JAX engine runs here on a
2-device CPU mesh, from the same parameters (carried with
``sequential_params_from_tpudml``) and global batches:

- task2's LeNet, SGD 0.01 momentum 0.9, three steps on stacked
  ``[2, 8, 28, 28, 1]`` batches, for each aggregation, and allreduce with
  ``accum_steps=2``;
- task3's samplers for each division: the index sets of both ranks in two
  epochs equal JAX's bitwise, and one epoch of the ``ShardedDataLoader``
  at task3's lr 0.001 matches JAX's;
- the dropout LM (fused add+LN trunk) with ``rng_root``: each replica
  draws at ``root → step → rank → layer → salt``; JAX's masks are drawn
  here for those keys and replayed on the ranks;
- the task2 entry itself at world 2: both ranks report the same accuracy.

Tolerances (f32): losses rtol 1e-5, accuracies exact, parameters
``GRAD_TOL`` (rtol 1e-4, atol 1e-6); the replicas agree bitwise.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

import torch_dist_worker  # noqa: E402
from tpudml.core.config import MeshConfig  # noqa: E402
from tpudml.core.dist import make_mesh  # noqa: E402
from tpudml.data import ArrayDataset as JaxDataset  # noqa: E402
from tpudml.data import ShardedDataLoader as JaxShardedLoader  # noqa: E402
from tpudml.data.sampler import make_sampler as jax_make_sampler  # noqa: E402
from tpudml.models import LeNet as JaxLeNet  # noqa: E402
from tpudml.models import TransformerLM as JaxLM  # noqa: E402
from tpudml.optim import GradientDescent as JaxGD  # noqa: E402
from tpudml.optim import Sgd as JaxSgd  # noqa: E402
from tpudml.parallel.dp import DataParallel as JaxDP  # noqa: E402
from test_torch_dropout import jax_key  # noqa: E402
from tpudml_torch.core.prng import seed_key  # noqa: E402
from tpudml_torch.data import synthetic_classification, synthetic_lm  # noqa: E402
from tpudml_torch.interop import lm_params_from_tpudml, sequential_params_from_tpudml  # noqa: E402

WORLD, B, STEPS, SEED = 2, 8, 3, 0
LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
SPECS = {
    "allreduce": dict(aggregation="allreduce", accum=1, sgd=dict(lr=0.01, momentum=0.9)),
    "allgather": dict(aggregation="allgather", accum=1, sgd=dict(lr=0.01, momentum=0.9)),
    "reducescatter": dict(aggregation="reducescatter", accum=1,
                          sgd=dict(lr=0.01, momentum=0.9)),
    "accum2": dict(aggregation="allreduce", accum=2, sgd=dict(lr=0.01, momentum=0.9)),
}
TASK3 = dict(aggregation="allreduce", accum=1, sgd=dict(lr=0.001, momentum=0.0))
N_TASK3, SAMPLER_SEED = 96, 5
LM = dict(vocab_size=64, embed_dim=32, num_heads=4, num_layers=2, max_len=16, rope=True,
          impl="flash", fused_ln=True, dropout=0.1)
LM_LR, LM_STEPS = 0.05, 2

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


def _jax_lenet(spec, batches):
    """JAX's engine from ``JaxLeNet().init(key(SEED))``, the parameters the
    ranks load."""
    mesh = make_mesh(MeshConfig({"data": WORLD}), jax.devices()[:WORLD])
    dp = JaxDP(JaxLeNet(), JaxSgd(**spec["sgd"]), mesh, aggregation=spec["aggregation"],
               accum_steps=spec["accum"], stacked_batches=True)
    ts = dp.create_state(jax.random.key(SEED))
    step = dp.make_train_step()
    losses, accs = [], []
    for images, labels in batches:
        ts, m = step(ts, images, labels)
        losses.append(float(m["loss"]))
        accs.append(float(m["accuracy"]))
    return {"losses": losses, "accs": accs,
            "params": sequential_params_from_tpudml(_np(ts.params))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    job = tmp_path_factory.mktemp("labs")
    params, _ = JaxLeNet().init(jax.random.key(SEED))
    batches = []
    for i in range(STEPS):
        x, y = synthetic_classification(WORLD * B, (28, 28, 1), 10, seed=10 + i)
        batches.append((x.reshape(WORLD, B, 28, 28, 1), y.reshape(WORLD, B)))
    want = {name: _jax_lenet(spec, batches) for name, spec in SPECS.items()}

    dataset = synthetic_classification(N_TASK3, (28, 28, 1), 10, seed=3, proto_seed=100)
    for division in ("partition", "sampling"):
        samplers = [jax_make_sampler(division, N_TASK3, WORLD, r, seed=SAMPLER_SEED)
                    for r in range(WORLD)]
        sets = []
        for epoch in (0, 1):
            for s in samplers:
                s.set_epoch(epoch)
            sets.append([list(iter(s)) for s in samplers])
        loader = JaxShardedLoader(JaxDataset(*dataset), B, samplers)
        loader.set_epoch(0)
        want[division] = dict(_jax_lenet(TASK3, list(loader)), index_sets=sets)

    jm = JaxLM(**LM)
    lm_params, _ = jm.init(jax.random.key(1))
    root = seed_key(1 ^ 0xD0)
    seqs = synthetic_lm(16, 16, 64, seed=4)
    lm_batches = [(seqs[i:i + 4, :-1], seqs[i:i + 4, 1:]) for i in range(0, 4 * LM_STEPS, 4)]
    masks = {}
    for s in range(LM_STEPS):
        for r in range(WORLD):
            for layer in range(LM["num_layers"]):
                for salt in (1, 2):
                    key = root.fold_in(s).fold_in(r).fold_in(layer).fold_in(salt)
                    masks[key.path] = np.array(jax.random.bernoulli(
                        jax_key(key), 1.0 - LM["dropout"], (4 // WORLD, 16, 32)))
    mesh = make_mesh(MeshConfig({"data": WORLD}), jax.devices()[:WORLD])
    jdp = JaxDP(jm, JaxGD(lr=LM_LR), mesh, rng_root=jax_key(root), stacked_batches=False)
    ts = jdp.create_state(jax.random.key(1))
    step = jdp.make_train_step()
    losses = []
    for tokens, labels in lm_batches:
        ts, m = step(ts, tokens, labels)
        losses.append(float(m["loss"]))
    want["dropout"] = {"losses": losses, "params": lm_params_from_tpudml(_np(ts.params))}

    torch.save({"lenet": sequential_params_from_tpudml(_np(params)), "specs": SPECS,
                "batches": batches, "dataset": dataset, "sampler_seed": SAMPLER_SEED,
                "task3_batch": B, "task3_spec": TASK3, "masks": masks, "lm_model": LM,
                "lm_state": lm_params_from_tpudml(_np(lm_params)), "lm_lr": LM_LR,
                "lm_root": root, "lm_batches": lm_batches}, job / "cases.pt")
    return want, torch_dist_worker.spawn("labs", job, WORLD)


def _check(want, ranks, case):
    for got in ranks:
        np.testing.assert_allclose(got[case]["losses"], want[case]["losses"], rtol=LOSS_RTOL)
        assert got[case].get("accs") == want[case].get("accs")
        assert set(got[case]["params"]) == set(want[case]["params"])
        for name, value in want[case]["params"].items():
            np.testing.assert_allclose(got[case]["params"][name].numpy(), value.numpy(),
                                       err_msg=name, **GRAD_TOL)
    for name, p in ranks[0][case]["params"].items():
        assert torch.equal(p, ranks[1][case]["params"][name]), name


@pytest.mark.parametrize("case", list(SPECS))
def test_task2_lenet_dp_matches_jax(runs, case):
    _check(*runs, case)


@pytest.mark.parametrize("division", ["partition", "sampling"])
def test_task3_divisions_match_jax(runs, division):
    want, ranks = runs
    for got in ranks:
        assert got[division]["index_sets"] == want[division]["index_sets"]
    _check(want, ranks, division)
    sets = want[division]["index_sets"][0]
    overlap = set(sets[0]) & set(sets[1])
    assert (not overlap) if division == "partition" else overlap


def test_dropout_rng_root_per_rank_matches_jax(runs):
    _check(*runs, "dropout")


def test_task2_entry_at_world_two(runs):
    _, ranks = runs
    assert [r["task2"]["world"] for r in ranks] == [2, 2]
    assert ranks[0]["task2"]["test_accuracy"] == ranks[1]["task2"]["test_accuracy"]
    assert ranks[0]["task2"]["loss"] == ranks[1]["task2"]["loss"]
